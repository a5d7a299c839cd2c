"""First-hit AOV (arbitrary output variable) feature buffers: per-pixel
mean first-hit albedo, oriented shading normal, hit distance and coverage
(the port of the JAX package's ``utils/aov.py``).

They average over the renderer's own primary rays
(``camera.pinhole.primary_rays_cfg``, jitter at counters 0 and 1, the same
path ids), so their edges carry the beauty render's anti-aliasing. The
denoiser (``utils/denoise.py``) takes them as its edge stops. Misses add
zeros to every buffer: a feature buffer that reported the stale object 0
for an escaped ray would poison the denoiser's edge stops.

Plain torch: one nearest-hit query a sample, no bounces.
"""

from __future__ import annotations

import torch

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import rng
from ..geometry.intersect import shade_info, trace
from ..scene.types import Scene

# Rays a chunk, as the JAX package chunks its AOV pass.
CHUNK_RAYS = 1 << 22


def _aov_chunk(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
               s0: int, n_s: int):
    """Per-pixel sums over samples [s0, s0 + n_s): albedo (h*w, 3),
    oriented normal (h*w, 3), hit distance (h*w,) and hits (h*w,)."""
    n_pix = cfg.width * cfg.height
    dev = scene.device
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)[:, None]
    s = s0 + torch.arange(n_s, dtype=torch.int64, device=dev)[None, :]
    # Pixel-major, sample-minor path ids, as the renderer packs them.
    path_id = ((pix * cfg.spp + s) & rng.MASK32).reshape(-1)
    px = (pix % cfg.width).expand(n_pix, n_s).reshape(-1)
    py = torch.div(pix, cfg.width, rounding_mode="floor").expand(
        n_pix, n_s).reshape(-1)
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed)
    hit = trace(scene, o, d)
    sh = shade_info(scene, o, d, hit)
    m = hit.hit.to(o.dtype)
    alb = (sh.albedo * m[:, None]).reshape(n_pix, n_s, 3).sum(dim=1)
    nrm = (sh.n * m[:, None]).reshape(n_pix, n_s, 3).sum(dim=1)
    dep = (hit.t * m).reshape(n_pix, n_s).sum(dim=1)
    cov = m.reshape(n_pix, n_s).sum(dim=1)
    return alb, nrm, dep, cov


def render_aovs(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                seed=None, spp: int | None = None) -> dict[str, torch.Tensor]:
    """First-hit feature buffers of cfg's image on the scene's device.

    spp: primary samples to average (default min(cfg.spp, 64), at most
    cfg.spp); samples 0..spp-1 reuse the beauty render's jitter. Returns
    (h, w, ...) float32 tensors: "albedo" (h, w, 3) mean first-hit albedo;
    "normal" (h, w, 3) mean oriented normal, not renormalised (its length
    dips below 1 on edges); "depth" (h, w) mean hit distance over the
    samples that hit (0 if none); "coverage" (h, w) share of samples that
    hit anything."""
    seed = cfg.seed if seed is None else int(seed)
    n_total = max(1, min(cfg.spp, 64) if spp is None else min(spp, cfg.spp))
    w, h = cfg.width, cfg.height
    dev = scene.device
    budget = max(1, CHUNK_RAYS // max(1, w * h))
    alb = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    nrm = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    dep = torch.zeros(w * h, dtype=torch.float32, device=dev)
    cov = torch.zeros(w * h, dtype=torch.float32, device=dev)
    s0 = 0
    while s0 < n_total:
        n_s = min(budget, n_total - s0)
        a, n, t, c = _aov_chunk(scene, cam, cfg, seed, s0, n_s)
        alb, nrm, dep, cov = alb + a, nrm + n, dep + t, cov + c
        s0 += n_s
    # Divide by device tensors (see adaptive.py).
    hits = torch.clamp(cov, min=1.0)
    total = torch.tensor(float(n_total), device=dev)
    return {
        "albedo": (alb / hits[:, None]).reshape(h, w, 3),
        "normal": (nrm / hits[:, None]).reshape(h, w, 3),
        "depth": (dep / hits).reshape(h, w),
        "coverage": (cov / total).reshape(h, w),
    }
