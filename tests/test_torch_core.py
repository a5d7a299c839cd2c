"""The port's vector math, film and camera against the JAX package's.

torch runs single-threaded in these files: with jaxlib loaded in the same
process, the first float32 ``torch.sqrt`` on the CPU was seen to return
values about 3e-4 off in one worker thread's share of the elements (3 runs
in 12 with 8 threads, none in 16 with one thread; ROADMAP.md queue 3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu.camera import pinhole as jpinhole
from small_pathtracer_tpu.core import film as jfilm, vecmath as jvm
from small_pathtracer_tpu.integrator.wavefront import _spawn as jspawn
from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu_torch import RenderConfig
from small_pathtracer_tpu_torch.camera import pinhole
from small_pathtracer_tpu_torch.convert import camera_from_jax
from small_pathtracer_tpu_torch.core import film, vecmath as vm
from small_pathtracer_tpu_torch.integrator.wavefront import _spawn

torch.set_num_threads(1)

N = 100_000


def _np(x):
    return np.asarray(jax.block_until_ready(x))


def test_sincos_2pi():
    u = np.random.default_rng(1).random(N).astype(np.float32)
    u[:4] = [0.0, 0.25, 0.5, 0.75]
    js, jc = (_np(v) for v in jvm.sincos_2pi(jnp.asarray(u)))
    ts, tc = vm.sincos_2pi(torch.from_numpy(u))
    # Measured: bit-identical on all 1e5 draws (a polynomial of exact ops).
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=2e-7)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_onb_from_w():
    r = np.random.default_rng(2)
    w = r.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    # Axis normals (the Cornell box's) and the |w.x| = 0.1 switch.
    w[:6] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32)
    ju, jv = (_np(v) for v in jvm.onb_from_w(jnp.asarray(w)))
    tu, tv = (v.numpy() for v in vm.onb_from_w(torch.from_numpy(w)))
    # Exact on the axis normals; elsewhere jax.lax.rsqrt and 1/sqrt differ
    # by an ulp. Measured on these 1e5 frames: max |du| 1.8e-7, max |dv|
    # 2.4e-7 (2 ulp at 1.0), so v is held to 2.5e-7.
    np.testing.assert_array_equal(tu[:6], ju[:6])
    np.testing.assert_array_equal(tv[:6], jv[:6])
    np.testing.assert_allclose(tu, ju, rtol=0, atol=2e-7)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=2.5e-7)


def test_tonemap_u8_exact():
    lin = np.random.default_rng(3).uniform(-0.1, 1.3, (96, 128, 3))
    lin = lin.astype(np.float32)
    want = _np(jfilm.tonemap_u8(jnp.asarray(lin)))
    got = film.tonemap_u8(torch.from_numpy(lin))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_finalize_clamps():
    x = torch.tensor([-1.0, 0.25, 2.0])
    assert film.finalize(x).tolist() == [0.0, 0.25, 1.0]


def test_write_ppm_byte_identical(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (24, 32, 3)).astype(
        np.uint8)
    jfilm.write_ppm(str(tmp_path / "jax.ppm"), img)
    film.write_ppm(str(tmp_path / "torch.ppm"), img)
    assert (tmp_path / "torch.ppm").read_bytes() == (
        tmp_path / "jax.ppm").read_bytes()
    np.testing.assert_array_equal(film.read_ppm(str(tmp_path / "torch.ppm")),
                                  img)


@pytest.mark.parametrize("aspect", [1.0, 32 / 24, 1024 / 768])
def test_make_camera_exact(aspect):
    jc = jpinhole.make_camera(aspect=aspect)
    tc = pinhole.make_camera(aspect=aspect)
    for name in tc._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      _np(getattr(jc, name)), err_msg=name)


def test_primary_rays_32x24():
    w, h, spp, seed = 32, 24, 4, 7
    jcfg = JRenderConfig(width=w, height=h, spp=spp, seed=seed)
    cfg = RenderConfig(width=w, height=h, spp=spp, seed=seed)
    jcam = jpinhole.make_camera(aspect=w / h)
    pix = np.repeat(np.arange(w * h), spp)
    s = np.tile(np.arange(spp), w * h)
    jo, jd, jpid = (_np(v) for v in jspawn(
        jcam, jcfg, np.uint32(seed), (pix % w).astype(np.int32),
        (pix // w).astype(np.int32), (pix * spp).astype(np.uint32),
        s.astype(np.uint32)))
    pix_t = torch.from_numpy(pix)
    o, d, pid = _spawn(camera_from_jax(jcam), cfg, seed, pix_t % w,
                       pix_t // w, pix_t * spp, torch.from_numpy(s))
    np.testing.assert_array_equal(pid.numpy(), jpid.astype(np.int64))
    np.testing.assert_array_equal(o.numpy(), jo)
    # Measured: 59% of the components bit-identical, max |d - d_jax|
    # 1.2e-7 (one ulp: 1/sqrt here, jax.lax.rsqrt there).
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=1), 1.0,
                               atol=1e-6)

