"""Direction and light samplers. Randomness comes in as explicit uniforms so
the integrator controls the counter-RNG stream."""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm
from ..scene.types import LightSampler

# Shadow-ray origin lift of the light-list NEE path (not in this slice; kept
# so the constant has one home when light lists are ported).
SHADOW_EPS = 1e-3


def sample_cosine(nl: torch.Tensor, u1: torch.Tensor,
                  u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction around nl:
    u*cos(2 pi u1)*sqrt(u2) + v*sin(2 pi u1)*sqrt(u2) + w*sqrt(1 - u2),
    normalized."""
    sr1, cr1 = vm.sincos_2pi(u1)
    r2s = torch.sqrt(u2)
    u, v = vm.onb_from_w(nl)
    d = (
        u * (cr1 * r2s)[..., None]
        + v * (sr1 * r2s)[..., None]
        + nl * torch.sqrt(1.0 - u2)[..., None]
    )
    return vm.norm(d)


def sample_uniform(nl: torch.Tensor, u1: torch.Tensor,
                   u2: torch.Tensor) -> torch.Tensor:
    """Uniform hemisphere direction around nl (the reference's commented
    variant): cos(theta) = 1 - u2, u*cos(2 pi u1)*sqrt(u2*(2 - u2)) +
    v*sin(2 pi u1)*sqrt(u2*(2 - u2)) + nl*(1 - u2), normalized."""
    sr1, cr1 = vm.sincos_2pi(u1)
    sin_t = torch.sqrt(u2 * (2.0 - u2))
    u, v = vm.onb_from_w(nl)
    d = (
        u * (cr1 * sin_t)[..., None]
        + v * (sr1 * sin_t)[..., None]
        + nl * (1.0 - u2)[..., None]
    )
    return vm.norm(d)


def sample_power_cosine(mu: torch.Tensor, u1: torch.Tensor,
                        u2: torch.Tensor, inv_k1: torch.Tensor) -> torch.Tensor:
    """A cos^k lobe sample around the unit axis mu, inv_k1 = 1 / (k + 1) as
    a float32 tensor: cos(theta) = u2^(1/(k+1)) (``vm.pow_pos``), the pdf
    (k + 1) / (2 pi) cos^k; normalized. k = 1 is the cosine lobe."""
    uax, vax = vm.onb_from_w(mu)
    sr1, cr1 = vm.sincos_2pi(u1)
    wz = vm.pow_pos(u2, inv_k1)
    sin_t = torch.sqrt(torch.clamp(1.0 - wz * wz, min=0.0))
    d = (
        uax * (cr1 * sin_t)[..., None]
        + vax * (sr1 * sin_t)[..., None]
        + mu * wz[..., None]
    )
    return vm.norm(d)


# 1 / (2 pi), the Phong lobe's normalization (a float32 constant on both
# sides: csrc/megakernel_lane.cuh kInv2Pi).
INV_2PI = 1.0 / (2.0 * math.pi)


def sample_phong(mirror: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
                 n_exp: torch.Tensor) -> torch.Tensor:
    """The modified-Phong lobe around the unit ``mirror`` (the GLOS
    extension): cos(alpha) = u2^(1/(n+1)), phi = 2 pi u1 in mirror's
    frame, the exact sampler of the pdf (n+1)/(2 pi) cos^n(alpha). n_exp
    (N,) per lane; 1/(n+1) is a float32 divide and the power ``vm.pow_pos``,
    as the kernels compute them. A sample may fall below the surface
    (``phong_weight`` is 0 there)."""
    return sample_power_cosine(mirror, u1, u2, 1.0 / (n_exp + 1.0))


def pow_safe(base: torch.Tensor, n_exp: torch.Tensor) -> torch.Tensor:
    """max(base, 0)^n through ``vm.pow_pos`` (0 where base <= 0)."""
    pos = base > 0.0
    return torch.where(pos, vm.pow_pos(torch.where(pos, base, 1.0), n_exp),
                       0.0)


def phong_pdf(d: torch.Tensor, mirror: torch.Tensor,
              n_exp: torch.Tensor) -> torch.Tensor:
    """Solid-angle density of sample_phong at unit d:
    (n+1)/(2 pi) max(d . mirror, 0)^n."""
    return (n_exp + 1.0) * INV_2PI * pow_safe(vm.dot(d, mirror), n_exp)


def phong_brdf_over_albedo(d: torch.Tensor, mirror: torch.Tensor,
                           n_exp: torch.Tensor) -> torch.Tensor:
    """The modified-Phong BRDF over the albedo at unit d:
    (n+2)/(2 pi) max(d . mirror, 0)^n."""
    return (n_exp + 2.0) * INV_2PI * pow_safe(vm.dot(d, mirror), n_exp)


def phong_weight(d: torch.Tensor, nl: torch.Tensor,
                 n_exp: torch.Tensor) -> torch.Tensor:
    """Path weight f cos / (pdf albedo) of a sample_phong direction d:
    (n+2)/(n+1) max(d . nl, 0), the cos^n factors cancelled; 0 below the
    surface (the lane is absorbed)."""
    return ((n_exp + 2.0) / (n_exp + 1.0)) * torch.clamp(vm.dot(d, nl),
                                                         min=0.0)


def light_area_normal(light: LightSampler):
    """Area and unit normal of the NEE parallelogram (1296 and (0, -1, 0)
    for the Cornell light)."""
    c = vm.cross(light.edge_u, light.edge_v)
    area = vm.magnitude(c)
    area_safe = torch.where(area > 0.0, area, 1.0)
    return area, c / area_safe[..., None]


def sample_light_point(light: LightSampler, u1: torch.Tensor,
                       u2: torch.Tensor) -> torch.Tensor:
    """Uniform point on the NEE parallelogram. Returns (N, 3)."""
    return (
        light.corner
        + u1[..., None] * light.edge_u
        + u2[..., None] * light.edge_v
    )


# glibc's RAND_MAX and its reciprocal as float32 (the kernels' kInvRandMax).
_TWO_31 = 2147483648.0
_INV_RAND_MAX = 1.0 / 2147483647.0


def glibc_overflow_offset(u: torch.Tensor) -> torch.Tensor:
    """The reference's ``rand() * 36 / double(RAND_MAX)`` under glibc: the
    int product wraps, so the offset lies in (-1, 1) instead of [0, 36).
    u carries 24 random bits, so u * 2^31 is an exact integer below 2^31;
    its product by 36 is taken modulo 2^32 (int64 here, masked) and read
    as int32, then converted to float32 and scaled by 1 / RAND_MAX: the
    kernels' unsigned multiply, reinterpret and __int2float_rn."""
    r = (u * _TWO_31).to(torch.int64)
    wrapped = (r * 36) & 0xFFFFFFFF
    signed = torch.where(wrapped >= 2 ** 31, wrapped - 2 ** 32, wrapped)
    return signed.to(torch.int32).to(torch.float32) * _INV_RAND_MAX


def glibc_edge_dirs(light: LightSampler):
    """The light's unit edge directions (float32), along which glibc's
    offsets move in absolute scene units."""
    return (light.edge_u / vm.magnitude(light.edge_u),
            light.edge_v / vm.magnitude(light.edge_v))


def sample_light_point_glibc(light: LightSampler, u1: torch.Tensor,
                             u2: torch.Tensor) -> torch.Tensor:
    """The glibc build's light sample (C13a): the corner plus the wrapped
    offsets along the unit edges, a ~2x2 patch at the light's corner for
    the Cornell presets. Returns (N, 3)."""
    eu, ev = glibc_edge_dirs(light)
    return (
        light.corner
        + glibc_overflow_offset(u1)[..., None] * eu
        + glibc_overflow_offset(u2)[..., None] * ev
    )


def light_pdf_inv(light: LightSampler, d_hat: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """The inverse solid-angle density of the light sample toward unit
    d_hat at distance t: |area * (d_hat . n_light)| / t^2."""
    area, n_light = light_area_normal(light)
    return torch.abs(area * vm.dot(d_hat, n_light)) / (t * t)


def nee_weight(light: LightSampler, d_hat: torch.Tensor, nl: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """The reference's NEE path weight PDF_inverse * BRDF:
    |area * (d_hat . n_light)| / t^2 * |d_hat . nl| / pi."""
    brdf = torch.abs(vm.dot(d_hat, nl)) * (1.0 / math.pi)
    return light_pdf_inv(light, d_hat, t) * brdf
