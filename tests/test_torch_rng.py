"""The port's counter RNG against the JAX package's, bit for bit."""

import numpy as np
import torch

import jax

from small_pathtracer_tpu.core import rng as jrng
from small_pathtracer_tpu_torch.core import rng

N = 100_000


def _triples():
    r = np.random.default_rng(20261016)
    t = r.integers(0, 1 << 32, size=(3, N), dtype=np.uint64).astype(np.uint32)
    # Edge values, including every value >= 2^31 class boundary.
    edge = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                     (1 << 32) - 1], dtype=np.uint32)
    t[:, :edge.size] = edge
    t[:, edge.size:2 * edge.size] = edge[::-1]
    return t


def _jax(fn, t):
    return np.asarray(jax.block_until_ready(fn(t[0], t[1], t[2])))


def _torch(fn, t):
    s, p, c = (torch.from_numpy(x.astype(np.int64)) for x in t)
    return fn(s, p, c).numpy()


def test_hash_u32_bit_exact():
    t = _triples()
    assert (t >= (1 << 31)).any(axis=1).all()
    want = _jax(jrng.hash_u32, t).astype(np.int64)
    got = _torch(rng.hash_u32, t)
    np.testing.assert_array_equal(got, want)


def test_uniform_mix_bit_exact():
    t = _triples()
    want = _jax(jrng.uniform_mix, t)
    got = _torch(rng.uniform_mix, t)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_scalar_seed_and_counter_broadcast():
    t = _triples()
    pid = torch.from_numpy(t[1].astype(np.int64))
    want = np.asarray(jrng.uniform_mix(np.uint32(42), t[1], np.uint32(13)))
    np.testing.assert_array_equal(rng.uniform_mix(42, pid, 13).numpy(), want)


def test_purpose_layout_matches():
    for name in ("DRAWS_PER_BOUNCE", "P_RR", "P_LIGHT_U", "P_LIGHT_V",
                 "P_SCATTER_U", "P_SCATTER_V", "P_MIX_COIN", "P_REFR_COIN",
                 "P_LIGHT_SEL"):
        assert getattr(rng, name) == getattr(jrng, name), name
