"""The port's nearest-hit query and shading against the JAX package's, on
``cornell_box`` with 10^4 random rays from inside the box."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu.geometry import intersect as jintersect
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
from small_pathtracer_tpu_torch.convert import scene_from_jax
from small_pathtracer_tpu_torch.geometry import intersect
from small_pathtracer_tpu_torch.scene.presets import get_scene

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

N = 10_000


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(5)
    o = np.stack([r.uniform(1.5, 98.5, N), r.uniform(0.5, 81.0, N),
                  r.uniform(0.5, 169.5, N)], axis=1).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Axis-aligned directions: rays parallel to two of the three planes.
    d[:6] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32)
    js = jget_scene("cornell_box")
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jh = jintersect.trace(js, jo, jd)
    jsh = jintersect.shade_info(js, jo, jd, jh)
    jax.block_until_ready((jh, jsh))
    ts = jax.block_until_ready(jintersect.intersect_rects(js.rects, jo, jd))
    want = {k: np.asarray(v) for k, v in [*jh._asdict().items(),
                                            *jsh._asdict().items()]}
    want["ts"] = np.asarray(ts)
    scene = scene_from_jax(js, device="cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    h = intersect.trace(scene, to, td)
    sh = intersect.shade_info(scene, to, td, h)
    got = {k: v.numpy() for k, v in [*h._asdict().items(),
                                      *sh._asdict().items()]}
    got["ts"] = intersect.intersect_rects(scene.rects, to, td).numpy()
    return want, got


def _clear(ts):
    """Rays whose two nearest hits differ by more than 1e-4 relative."""
    two = np.sort(ts, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) > 1e-4 * np.abs(two[:, 0])


def test_trace_ids_and_t(case):
    want, got = case
    assert want["hit"].all() and got["hit"].all()  # a closed box
    clear = _clear(want["ts"])
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got["obj_id"][clear],
                                  want["obj_id"][clear])
    # Measured on these rays: every id equal and every t bit-identical
    # (the rect test is exact ops); rtol 1e-5 as the contract states.
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got["obj_id"], want["obj_id"])


def test_intersect_rects_all_objects(case):
    want, got = case
    np.testing.assert_allclose(got["ts"], want["ts"], rtol=1e-5, atol=0)


def test_shade_info(case):
    want, got = case
    same = got["obj_id"] == want["obj_id"]
    for k in ("n", "n_geom", "albedo", "emission", "refl"):
        np.testing.assert_array_equal(got[k][same], want[k][same], err_msg=k)
    np.testing.assert_allclose(got["x"], want["x"], rtol=1e-5, atol=1e-4)


def test_miss_shades_object_zero():
    scene = get_scene("cornell_box", device="cpu")
    o = torch.tensor([[50.0, 40.0, 500.0]])   # outside, pointing away
    d = torch.tensor([[0.0, 0.0, 1.0]])
    h = intersect.trace(scene, o, d)
    assert not bool(h.hit[0]) and int(h.obj_id[0]) == 0
    assert float(h.t[0]) == np.float32(intersect.MISS_T)
    sh = intersect.shade_info(scene, o, d, h)
    assert sh.x.tolist() == [[0.0, 0.0, 0.0]]
    assert sh.n.tolist() == [[0.0, 0.0, -1.0]]


def test_tie_goes_to_first_object():
    # Two coincident rects: the lower id wins the strict < scan.
    scene = get_scene("cornell_box", device="cpu")
    r = scene.rects
    rects = r._replace(**{f: torch.cat([getattr(r, f)[:1], getattr(r, f)])
                          for f in r._fields})
    scene = scene._replace(rects=rects)
    h = intersect.trace(scene, torch.tensor([[50.0, 40.0, 80.0]]),
                        torch.tensor([[0.0, 0.0, -1.0]]))
    assert int(h.obj_id[0]) == 0 and float(h.t[0]) == 80.0


def test_scene_leaves_match_jax():
    js = jget_scene("cornell_box")
    ours = get_scene("cornell_box", device="cpu")
    conv = scene_from_jax(js, device="cpu")
    for f in ours.rects._fields:
        np.testing.assert_array_equal(getattr(ours.rects, f).numpy(),
                                      getattr(conv.rects, f).numpy(), err_msg=f)
    for f in ("corner", "edge_u", "edge_v"):
        np.testing.assert_array_equal(getattr(ours.light, f).numpy(),
                                      getattr(conv.light, f).numpy())
    assert ours.light.light_obj_id == conv.light.light_obj_id == 6


@pytest.mark.parametrize("name", ["cornell_spheres", "smallpt_original_true",
                                  "cornell_twolights", "cornell_tilted_light"])
def test_convert_rejects_outside_slice(name):
    with pytest.raises(NotImplementedError):
        scene_from_jax(jget_scene(name), device="cpu")
    with pytest.raises(NotImplementedError):
        get_scene(name, device="cpu")
