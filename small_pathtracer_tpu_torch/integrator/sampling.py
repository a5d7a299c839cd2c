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


def nee_weight(light: LightSampler, d_hat: torch.Tensor, nl: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """The reference's NEE path weight PDF_inverse * BRDF:
    |area * (d_hat . n_light)| / t^2 * |d_hat . nl| / pi."""
    area, n_light = light_area_normal(light)
    pdf_inv = torch.abs(area * vm.dot(d_hat, n_light)) / (t * t)
    brdf = torch.abs(vm.dot(d_hat, nl)) * (1.0 / math.pi)
    return pdf_inv * brdf
