"""Batched 3-vector math over (..., 3) float32 tensors.

Every sum is written out in the order x, y, z, and ``rsqrt`` is
``1 / sqrt``: the CUDA kernels (``csrc/megakernel.cu``) use the same
expressions, so the eager path and the kernel round alike. The real powers
of path guiding (``pow_pos``) are built from the same IEEE operations on
both sides too, not from a library ``pow``.
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


def pow_const(x: torch.Tensor, k: float) -> torch.Tensor:
    """x ** k for a fixed exponent, the JAX package's ``vm.pow_const``: an
    integer k in [1, 64] is a squaring chain in its loop order (k = 8 is
    ((x*x)*(x*x))*((x*x)*(x*x))); any other k is ``pow_pos(x, k)``
    (x >= 0)."""
    kf = float(k)
    if kf.is_integer() and 1 <= kf <= 64:
        n = int(kf)
        result = None
        base = x
        while n:
            if n & 1:
                result = base if result is None else result * base
            n >>= 1
            if n:
                base = base * base
        return result
    return pow_pos(x, torch.tensor(kf, dtype=torch.float32, device=x.device))


# pow_pos: log2 of the mantissa m in [sqrt(1/2), sqrt(2)] from the atanh
# series in s = (m - 1) / (m + 1) (2 / ((2j + 1) ln 2), j = 0..4), and 2^f
# for f in [-1/2, 1/2] from the Taylor series ((ln 2)^j / j!, j = 0..7).
# Each coefficient is its float32 value; csrc/megakernel_lane.cuh holds
# the same literals.
_LOG2_C = (2.88539004, 0.961796701, 0.577078044, 0.412198573, 0.3205989)
_EXP2_C = (1.0, 0.693147182, 0.240226507, 0.0555041097, 0.00961812865,
           0.00133335579, 0.000154035297, 1.52527336e-05)
_SQRT2 = 1.41421354
_MIN_NORMAL = 2.0 ** -126


def pow_pos(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x ** p for float32 x >= 0 and a float32 tensor p > 0 (a scalar, or
    one exponent a lane), as exp2(p * log2(x)) from float32 +, -, *, / and
    bit operations only, in the order ``pow_pos`` in
    csrc/megakernel_lane.cuh computes them, so the kernels and this plain
    version give the same bits on any device (a library pow may round
    differently in each). For the lobe sample's u ** (1 / 9) it is within
    2 ulp of the float64 power (1.72 ulp at most on 1e6 uniforms,
    tests/test_torch_guiding.py); 0 where x or the result is below the
    smallest normal float (2^-126). Differentiable in x (the bit
    operations are not): d/dx = p y / x where y > 0, else 0, the geometry
    adjoint's (csrc/megakernel_geom.cuh ``pow_safe_vjp``); p is a
    constant."""
    if x.requires_grad:
        return _PowPos.apply(x, torch.as_tensor(p, dtype=x.dtype,
                                                device=x.device))
    return _pow_pos(x, p)


class _PowPos(torch.autograd.Function):
    """pow_pos with its derivative in x."""

    @staticmethod
    def forward(ctx, x, p):
        y = _pow_pos(x, p)
        ctx.save_for_backward(x, p, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, p, y = ctx.saved_tensors
        pos = y > 0.0
        return torch.where(pos, g * (p * y / torch.where(pos, x, 1.0)),
                           0.0), None


def _pow_pos(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    f32, i32 = torch.float32, torch.int32
    ok = x >= _MIN_NORMAL
    bits = torch.where(ok, x, 1.0).contiguous().view(i32)
    e = (bits >> 23) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(f32)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = torch.where(big, e + 1, e)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    poly = torch.full_like(s, _LOG2_C[4])
    for c in _LOG2_C[3::-1]:
        poly = poly * s2 + c
    t = (e.to(f32) + s * poly) * p
    n = torch.floor(t + 0.5)
    f = t - n
    q = torch.full_like(f, _EXP2_C[7])
    for c in _EXP2_C[6::-1]:
        q = q * f + c
    ok = ok & (n >= -126.0) & (n <= 127.0)
    n_i = torch.where(ok, n, 0.0).to(i32)
    scale = ((n_i + 127) << 23).view(f32)
    return torch.where(ok, q * scale, 0.0)
