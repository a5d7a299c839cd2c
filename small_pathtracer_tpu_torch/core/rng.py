"""Counter-based RNG: every draw is a pure function of (seed, path_id, ctr).

The same murmur3_x86_32 hash over the two words (path_id, ctr) as the JAX
package's ``core/rng.py``, so both packages draw identical numbers. PyTorch
has no full uint32 arithmetic on the CPU (``<<``, ``>>`` and ``+`` raise), so
the hash runs on int64 tensors holding uint32 values and masks to 32 bits
after every step: an int64 product wraps modulo 2^64, and its low 32 bits
are the uint32 product.
"""

from __future__ import annotations

import torch

# Counters are packed as bounce * DRAWS_PER_BOUNCE + purpose.
DRAWS_PER_BOUNCE = 8

# Purpose slots within a bounce.
P_RR = 0          # Russian-roulette survival coin
P_LIGHT_U = 1     # light sample, u extent
P_LIGHT_V = 2     # light sample, v extent
P_SCATTER_U = 3   # hemisphere sample, angle
P_SCATTER_V = 4   # hemisphere sample, radius
P_MIX_COIN = 5    # NEE-vs-BSDF mixture coin
P_REFR_COIN = 6   # dielectric reflect/refract coin
P_LIGHT_SEL = 7   # light-list index draw

MASK32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / (1 << 24)


def _u32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * c) & MASK32


def hash_u32(seed, path_id, ctr) -> torch.Tensor:
    """murmur3_x86_32 over (path_id, ctr) with ``seed``.

    Inputs are ints or int64 tensors holding uint32 values; they broadcast.
    Returns an int64 tensor of uint32 values on ``path_id``'s device."""
    device = path_id.device if torch.is_tensor(path_id) else None
    h = _u32(seed, device)
    for block in (_u32(path_id, device), _u32(ctr, device)):
        k = _mul32(block, 0xCC9E2D51)
        k = _rotl32(k, 15)
        k = _mul32(k, 0x1B873593)
        h = h ^ k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & MASK32
    h = h ^ 8  # length in bytes
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_mix(seed, path_id, ctr) -> torch.Tensor:
    """float32 uniform in [0, 1): the top 24 bits of the hash."""
    return (hash_u32(seed, path_id, ctr) >> 8).to(torch.float32) * _INV_2_24
