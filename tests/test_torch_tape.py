"""Host-side checks of the two adjoint kernels' launches (megakernel_vjp and
the adjoint launch of megakernel_geom), whose per-lane tapes are sized at
compile time: no depth is refused on the way to the kernel, the scratch
and counters they are handed, and chip_smoke.py's bounds and ptxas report
for them. The kernels themselves run only on the card (chip_smoke.py); a
stand-in library records the arguments here. No JAX computation."""

from collections import Counter

import pytest
import torch

import chip_smoke
import small_pathtracer_tpu_torch as spt
from _recording_lib import install
from small_pathtracer_tpu_torch.ops import (
    megakernel, megakernel_geom as mgeo, megakernel_grad as mg,
)

torch.set_num_threads(1)

W, H, SPP = 16, 12, 4
# Both entry points take rect_geom, rect_axis and n_rects, then
# megakernel.launch_args, whose last value is max_bounces.
N_HEAD = 3
# Depths: within one segment of the tape (kSeg = 16 in
# csrc/megakernel_tape.cuh), one past it, and far beyond the checkpoints
# ((kCkpt + 1)·kSeg = 144). What the kernels do at such depths is checked
# on the card (chip_smoke.py's deep-path phase).
DEPTHS = (16, 17, 1_000_000)


@pytest.fixture
def lib(monkeypatch):
    return install(monkeypatch)


def _setup(name, max_bounces):
    sc = spt.get_scene(name, device="cpu")
    cam = spt.make_camera(aspect=W / H, device="cpu")
    cfg = spt.RenderConfig(width=W, height=H, spp=SPP, seed=3,
                           max_bounces=max_bounces)
    return sc, cam, cfg, megakernel.full_layout(cfg)


def _n_blocks(lay):
    return -(-lay.n_pix_loc * lay.g // mgeo.KERNEL_BLOCK)


def _geom_call(lib):
    """The one spt_megakernel_geom call (the sphere tree is built through
    spt_sphere_bvh first)."""
    calls = [c for c in lib.calls if c[0] != "spt_sphere_bvh"]
    assert [c[0] for c in lib.calls] == ["spt_sphere_bvh",
                                         "spt_megakernel_geom"]
    (name, args), = calls
    return name, args


def test_geom_adjoint_launch_takes_any_depth(lib):
    for max_bounces in DEPTHS:
        lib.calls.clear()
        megakernel.LAUNCHES.clear()
        _check_geom_launch(lib, max_bounces)


def _check_geom_launch(lib, max_bounces):
    sc, cam, cfg, lay = _setup("cornell_spheres", max_bounces)
    g_rows = torch.zeros((W * H, 3))
    out = mgeo._launch(sc, cam, cfg, 3, g_rows, lay, torch.device("cpu"),
                       None)
    name, args = _geom_call(lib)
    n_launch = len(megakernel.launch_args(megakernel.pack_geometry(sc, cam),
                                          cfg, 3, lay))
    assert name == "spt_megakernel_geom"
    assert args[N_HEAD + n_launch - 1] == max_bounces
    R, S = sc.rects.k.shape[0], sc.spheres.radius.shape[0]
    n_slots = 6 * (R + S) + 4 * S
    # After the launch settings: sph, S, bvh, root, alb, emi, refl, bk,
    # g_img, partials, n_partials.
    bk, n_partials = args[N_HEAD + n_launch + 7], args[N_HEAD + n_launch + 10]
    assert bk == 1
    assert n_partials >= _n_blocks(lay) * n_slots
    counts = out[4]
    assert counts.shape == (mgeo.N_COUNTS,) == (5,)
    assert megakernel.LAUNCHES == Counter({"megakernel_geom": 1})


def test_geom_image_launch_passes_no_cotangent(lib):
    sc, cam, cfg, lay = _setup("cornell_spheres", 256)
    mgeo._launch(sc, cam, cfg, 3, None, lay, torch.device("cpu"), None)
    _, args = _geom_call(lib)
    n_launch = len(megakernel.launch_args(megakernel.pack_geometry(sc, cam),
                                          cfg, 3, lay))
    bk, g_ptr = args[N_HEAD + n_launch + 7], args[N_HEAD + n_launch + 8]
    assert bk == 0 and g_ptr is None


def test_material_adjoint_launch_takes_any_depth(lib):
    for max_bounces in DEPTHS:
        lib.calls.clear()
        megakernel.LAUNCHES.clear()
        _check_material_launch(lib, max_bounces)


def _check_material_launch(lib, max_bounces):
    sc, cam, cfg, lay = _setup("cornell_box", max_bounces)
    alb, emi = mg.pack_materials(sc)
    galb, gemi = mg._launch_vjp(sc, cam, cfg, alb, emi, 3,
                                torch.zeros((W * H, 3)), lay,
                                torch.device("cpu"), None)
    (name, args), = lib.calls
    n_launch = len(megakernel.launch_args(megakernel.pack_geometry(sc, cam),
                                          cfg, 3, lay))
    assert name == "spt_megakernel_vjp"
    assert args[N_HEAD + n_launch - 1] == max_bounces
    # After the launch settings: alb, emi, g_img, partials, n_partials.
    R = sc.rects.k.shape[0]
    assert args[N_HEAD + n_launch + 4] >= _n_blocks(lay) * 6 * R
    assert galb.shape == gemi.shape == (R, 3)
    assert megakernel.LAUNCHES == Counter({"megakernel_vjp": 1})


def test_adjoint_bounds_split_function_and_algorithm():
    traces, n_samples, n_pix, k = [2_400_000, 1_400_000], 1_000_000, 250_000, 17
    fn = chip_smoke.vjp_bound(traces, n_samples, n_pix, k)
    alg = chip_smoke.vjp_bound(traces, n_samples, n_pix, k, True)
    # One trace and one update a bounce, not the two traces of a replay.
    fp = (traces[0] * (chip_smoke.query_ops(k) + chip_smoke.FP_SHADE
                       + chip_smoke.FP_PROBE + chip_smoke.FP_GRAD)
          + n_samples * chip_smoke.FP_SPAWN)
    assert fn[0] >= fp / chip_smoke.FP32_PER_S * 1e3
    # The tape: an entry a bounce, written once and read once.
    tape_ms = (2 * traces[0] * chip_smoke.VJP_ENTRY_BYTES
               / chip_smoke.BYTES_PER_S * 1e3)
    assert alg[0] >= max(tape_ms, fn[0])
    counts = [2_400_000, 1_400_000, 3_000, 2_400_000, 200]
    g_fn = chip_smoke.geom_bound(counts, n_samples, n_pix, 5, 3, 2_000)
    g_alg = chip_smoke.geom_bound(counts, n_samples, n_pix, 5, 3, 2_000, True)
    assert g_alg[0] > g_fn[0] > 0


def test_ptxas_report_reads_the_adjoints():
    out = "\n".join([
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_110bounce_vjpE",
        "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115megakernel_geomE6ParamsPK6float4' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_115megakernel_geomE6ParamsPK6float4",
        "    1856 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 118 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121megakernel_geom_imageE6Params' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_121megakernel_geom_imageE6Params",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 60 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114megakernel_vjpE6ParamsPKf' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_114megakernel_vjpE6ParamsPKf",
        "    1920 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 87 registers",
    ])
    assert chip_smoke.ptxas_report(out, ("megakernel_vjp", "megakernel_geom")) \
        == {"megakernel_geom": (118, 1856, 8, 4),
            "megakernel_vjp": (87, 1920, 0, 0)}


def test_ptxas_report_keys_scan_instances():
    """The geometry adjoint's linear and tree instances (a template on the
    sphere scan) are reported apart, as name<k>."""
    out = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115megakernel_geomILi1EEEv6Params' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_115megakernel_geomILi1EEEv6Params",
        "    2432 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 121 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115megakernel_geomILi2EEEv6Params' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_115megakernel_geomILi2EEEv6Params",
        "    2560 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 118 registers, used 1 barriers",
    ])
    assert chip_smoke.ptxas_report(out, ("megakernel_geom",)) == {
        "megakernel_geom<1>": (121, 2432, 0, 0),
        "megakernel_geom<2>": (118, 2560, 0, 0)}
