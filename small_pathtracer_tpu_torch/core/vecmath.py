"""Batched 3-vector math over (..., 3) float32 tensors.

Every sum is written out in the order x, y, z, and ``rsqrt`` is
``1 / sqrt``: the CUDA kernels (``csrc/megakernel.cu``) use the same
expressions, so the eager path and the kernel round alike.
"""

from __future__ import annotations

import torch


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), correctly rounded at each step (the kernel's form)."""
    return 1.0 / torch.sqrt(x)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3), (..., 3) -> (...,)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def norm(a: torch.Tensor) -> torch.Tensor:
    """Normalize over the trailing axis."""
    return a * rsqrt(dot(a, a))[..., None]


def magnitude(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection ``d - n*2*(n.d)``; the sign of n does not matter."""
    return d - n * (2.0 * dot(n, d))[..., None]


def orient_normal(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``n.d < 0 ? n : -n``; a zero dot yields -n, as in the reference."""
    return torch.where((dot(n, d) < 0.0)[..., None], n, -n)


def onb_from_w(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u = normalize(cross(|w.x| > .1 ? (0,1,0) : (1,0,0), w)), v = cross(w, u)."""
    pick = (torch.abs(w[..., 0]) > 0.1)[..., None]
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    u = norm(cross(torch.where(pick, e_y, e_x), w))
    return u, cross(w, u)


def _qsin(t: torch.Tensor) -> torch.Tensor:
    """sin(pi/2 * t) on [0, 1]: the JAX package's degree-9 odd polynomial."""
    t2 = t * t
    return t * (1.5707962973 + t2 * (-0.6459634395 + t2 * (
        0.0796887379 + t2 * (-0.0046725480 + t2 * 0.0001509561))))


def sincos_2pi(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of 2*pi*u for u in [0, 1), quarter-wave polynomial.

    The quadrant fold is exact for uniform draws; within a quadrant both
    values come from one polynomial (cos through the complementary angle)."""
    x4 = u.to(torch.float32) * 4.0
    qd = torch.floor(x4)
    f = x4 - qd
    s0 = _qsin(f)
    c0 = _qsin(1.0 - f)
    qi = qd.to(torch.int32) & 3
    swap = (qi & 1) == 1
    sb = torch.where(swap, c0, s0)
    cb = torch.where(swap, s0, c0)
    sin = torch.where(qi < 2, sb, -sb)
    cos = torch.where((qi == 0) | (qi == 3), cb, -cb)
    return sin, cos
