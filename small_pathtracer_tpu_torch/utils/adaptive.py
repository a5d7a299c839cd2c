"""Adaptive sampling: per-pixel sample budgets driven by the variance of
each pixel's running mean (the port of the JAX package's
``utils/adaptive.py``, rule for rule).

The render runs in waves. A wave renders samples [n_i, n_i + wave) of every
still-active pixel i through ``ops.megakernel.render_megakernel_budgets``:
the budget kernels on the card, their plain version on the CPU. Every draw
is a pure function of (seed, pixel, sample), so stopping changes which
samples are rendered, never their values.

- wave: ``max(8, spp // 8)`` by default, capped at spp; a pixel's budget in
  a wave is ``min(spp - n_i, wave)``.
- Welford over the luma of each full-size wave's mean (a short last wave
  would bias the variance) gives the standard error of the pixel's mean
  after K waves, sqrt(var / K). A pixel stops once K >= 2 and
  stderr <= tol * (luma + 0.02), or when it reaches spp.
- tol = 0 never stops early: the uniform image, summed wave by wave.

The statistics stay on the scene's device in float64; the host reads two
numbers a wave (the active count and the samples so far), never the sums.
On the card every division is by a device tensor: CUDA torch turns a
division by a Python number into a multiply by its reciprocal.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..ops.megakernel import render_megakernel_budgets
from ..scene.types import Scene

# Rec.709 luma weights, float32 values as in the JAX package.
LUMA = torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32).tolist()


@dataclasses.dataclass
class AdaptiveResult:
    image: torch.Tensor    # (h, w, 3) float32 mean, clamped to [0, 1]
    spp_map: torch.Tensor  # (h, w) int32 samples rendered
    traces: tuple[int, int]  # (extend, probe) totals
    waves: int
    total_samples: int     # sum of spp_map
    uniform_samples: int   # h * w * cfg.spp, what a uniform render costs


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Luma of (..., 3) radiance, summed in r, g, b order."""
    return LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1] + LUMA[2] * rgb[..., 2]


def adaptive_render(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                    tol: float = 0.01, wave: int = 0,
                    log=None) -> AdaptiveResult:
    """Adaptive render of up to cfg.spp samples a pixel on the scene's
    device. tol: the luma-relative standard error at which a pixel stops
    (0 = never early). wave: samples a wave (0 = auto). log: a file that
    gets one ``[adaptive] wave ...`` line a wave."""
    if tol < 0.0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    if wave <= 0:
        wave = max(8, cfg.spp // 8)
    wave = min(wave, cfg.spp)
    n_pix = cfg.width * cfg.height
    dev = scene.device
    f64 = torch.float64

    wave_t = torch.tensor(float(wave), dtype=f64, device=dev)
    n = torch.zeros(n_pix, dtype=torch.int64, device=dev)  # samples so far
    sum_rgb = torch.zeros((n_pix, 3), dtype=f64, device=dev)
    k = torch.zeros(n_pix, dtype=torch.int64, device=dev)  # full waves
    wmean = torch.zeros(n_pix, dtype=f64, device=dev)  # Welford mean
    wm2 = torch.zeros(n_pix, dtype=f64, device=dev)    # Welford M2
    active = torch.ones(n_pix, dtype=torch.bool, device=dev)
    traces = torch.zeros(2, dtype=torch.int64, device=dev)
    waves, n_active = 0, n_pix

    while n_active:
        budget = torch.where(active, torch.clamp(cfg.spp - n, max=wave), 0)
        s_start, s_stop = n, n + budget
        L, tr = render_megakernel_budgets(scene, cam, cfg, cfg.seed,
                                          s_start, s_stop)
        traces = traces + tr
        waves += 1
        # Pixels outside the wave rendered nothing: their L is 0.
        L = L.to(f64)
        sum_rgb = sum_rgb + L
        n = s_stop
        full = active & (budget == wave)
        lum = luma(L) / wave_t
        k_f = k + 1
        d = lum - wmean
        wmean_f = wmean + d / k_f.to(f64)
        wm2 = torch.where(full, wm2 + d * (lum - wmean_f), wm2)
        wmean = torch.where(full, wmean_f, wmean)
        k = torch.where(full, k_f, k)

        capped = n >= cfg.spp
        if tol > 0.0:
            k64 = k.to(f64)
            var_w = torch.where(k > 1, wm2 / torch.clamp(k64 - 1.0, min=1.0),
                                torch.inf)
            stderr = torch.sqrt(var_w / torch.clamp(k64, min=1.0))
            mean_luma = luma(sum_rgb) / torch.clamp(n.to(f64), min=1.0)
            done = (k >= 2) & (stderr <= tol * (mean_luma + 0.02))
            active = ~(done | capped)
        else:
            active = ~capped
        # The one host read of the wave.
        n_active, n_sum = torch.stack([active.sum(), n.sum()]).tolist()
        if log is not None:
            print(f"[adaptive] wave {waves}: active {n_active}/{n_pix}, "
                  f"mean spp {n_sum / n_pix:.1f}", file=log)

    mean = sum_rgb / torch.clamp(n.to(f64), min=1.0)[:, None]
    img = torch.clamp(mean, 0.0, 1.0).to(torch.float32)
    extend, probe = traces.tolist()
    return AdaptiveResult(
        image=img.reshape(cfg.height, cfg.width, 3),
        spp_map=n.to(torch.int32).reshape(cfg.height, cfg.width),
        traces=(extend, probe),
        waves=waves,
        total_samples=n_sum,
        uniform_samples=n_pix * cfg.spp,
    )
