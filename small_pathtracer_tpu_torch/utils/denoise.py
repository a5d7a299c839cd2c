"""Edge-aware a-trous wavelet denoiser (the port of the JAX package's
``utils/denoise.py``): Dammertz et al. 2010 with SVGF-style edge stops
(Schied et al. 2017), guided by the first-hit AOVs of ``utils/aov.py``.

- The image is demodulated by the first-hit albedo, so only illumination
  is filtered and albedo edges stay sharp.
- Each of ``iterations`` passes convolves with the 5x5 B3-spline kernel
  dilated by 2^i, each tap weighted by normal, depth, albedo-luma and
  luminance stops.
- The depth stop scales with the screen-space depth gradient, so slanted
  walls are not taken for silhouettes.
- The luminance stop scales with a 3x3 estimate of the local luminance
  noise, recomputed each pass.

Plain torch: a tap reads the image shifted by (dy, dx) with the edge
pixels replicated, taken as a slice of a padded copy; no gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 1D B3-spline coefficients; the 5x5 kernel is their outer product.
B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)

# Rec.709 luma weights on linear radiance.
LUMA = (0.2126, 0.7152, 0.0722)


def _luminance(img: torch.Tensor) -> torch.Tensor:
    return LUMA[0] * img[..., 0] + LUMA[1] * img[..., 1] + LUMA[2] * img[..., 2]


class _Padded:
    """An (h, w) or (h, w, c) image with its edge pixels replicated ``pad``
    deep on every side; ``shift(dy, dx)`` is the image read at (y + dy,
    x + dx), clamped to the edges, for |dy|, |dx| <= pad."""

    def __init__(self, img: torch.Tensor, pad: int):
        self.h, self.w, self.pad = img.shape[0], img.shape[1], pad
        chw = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
        # Replicate padding of any depth: edge rows and columns repeated.
        p = F.pad(chw, (pad, pad, pad, pad), mode="replicate")[0]
        self.padded = p[0] if img.dim() == 2 else p.permute(1, 2, 0)

    def shift(self, dy: int, dx: int) -> torch.Tensor:
        y0, x0 = self.pad + dy, self.pad + dx
        return self.padded[y0:y0 + self.h, x0:x0 + self.w]


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return _Padded(img, max(abs(dy), abs(dx))).shift(dy, dx)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box mean with the edges replicated."""
    xp = _Padded(x, 1)
    acc = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + xp.shift(dy, dx)
    return acc / torch.tensor(9.0, device=x.device)


def _atrous(illum, normal, depth, albedo, iterations: int, sigma_l: float,
            sigma_n: float, sigma_z: float, sigma_a: float):
    dev = illum.device

    def const(v):
        return torch.tensor(v, dtype=illum.dtype, device=dev)

    zgrad = torch.maximum(torch.abs(_shift2d(depth, 0, 1) - depth),
                          torch.abs(_shift2d(depth, 1, 0) - depth))
    lum_a = _luminance(albedo)
    # The normal stop compares directions (see the JAX module).
    n_len = torch.sqrt((normal * normal).sum(dim=-1, keepdim=True))
    n_unit = normal / torch.clamp(n_len, min=1e-6)
    sig_l, sig_n, sig_z = const(sigma_l), const(sigma_n), const(sigma_z)
    sig_a2 = const(sigma_a) * const(sigma_a)

    for it in range(iterations):
        step = 1 << it
        pad = 2 * step
        lum_c = _luminance(illum)
        sd = torch.sqrt(torch.clamp(
            _box3(lum_c * lum_c) - _box3(lum_c) ** 2, min=0.0))
        denom = sig_l * sd + 1e-3
        illum_p, n_p = _Padded(illum, pad), _Padded(n_unit, pad)
        depth_p, lum_a_p = _Padded(depth, pad), _Padded(lum_a, pad)
        lum_c_p = _Padded(lum_c, pad)
        acc = torch.zeros_like(illum)
        wsum = torch.zeros_like(lum_c)
        for j, hy in enumerate(B3):
            for i, hx in enumerate(B3):
                dy, dx = (j - 2) * step, (i - 2) * step
                ndot = (n_unit * n_p.shift(dy, dx)).sum(dim=-1)
                w_n = torch.clamp(ndot, min=0.0) ** sig_n
                dz = torch.abs(depth_p.shift(dy, dx) - depth)
                tap_len = float(max(abs(dy), abs(dx), 1))
                w_z = torch.exp(-dz / (sig_z * zgrad * tap_len + 1e-2))
                da = torch.abs(lum_a_p.shift(dy, dx) - lum_a)
                w_a = torch.exp(-(da * da) / sig_a2)
                dl = torch.abs(lum_c_p.shift(dy, dx) - lum_c)
                w_l = torch.exp(-dl / denom)
                w = (hy * hx) * w_n * w_z * w_a * w_l
                acc = acc + illum_p.shift(dy, dx) * w[..., None]
                wsum = wsum + w
        illum = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return illum


def denoise(color: torch.Tensor, aovs: dict, *, iterations: int = 3,
            sigma_l: float = 4.0, sigma_n: float = 64.0,
            sigma_z: float = 2.0, sigma_a: float = 0.15) -> torch.Tensor:
    """Filter a linear (h, w, 3) radiance image (before the tone map) with
    the feature buffers of ``utils.aov.render_aovs`` (albedo, normal,
    depth). iterations: a-trous passes (support 4 * 2^iterations + 1
    pixels); sigma_l: luminance stop in units of the local noise; sigma_n:
    normal stop exponent; sigma_z: depth stop in units of the local depth
    gradient; sigma_a: albedo-luma stop. Returns the filtered image."""
    albedo = aovs["albedo"]
    # Lights and misses (albedo ~ 0) pass through unscaled.
    safe = torch.where(albedo > 1e-3, albedo, 1.0)
    out = _atrous(color / safe, aovs["normal"], aovs["depth"], albedo,
                  iterations, sigma_l, sigma_n, sigma_z, sigma_a)
    return out * safe
