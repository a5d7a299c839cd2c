"""Rules of the port: it imports no JAX, and it never hides a missing card or
compiler behind a CPU fallback."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.ops import _build, megakernel

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "small_pathtracer_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_module_pulls_in_no_jax():
    mods = list(_modules())
    assert "small_pathtracer_tpu_torch.ops.megakernel" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'small_pathtracer_tpu' or "
        "m.startswith('small_pathtracer_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_kernels()


def test_render_megakernel_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = RenderConfig(width=8, height=6, spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        megakernel.render_megakernel(get_scene("cornell_box"),
                                     make_camera(aspect=8 / 6), cfg, 0,
                                     device="cuda")


def test_cli_render_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = tmp_path / "x.ppm"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["render", "--width", "8", "--height", "6", "--spp", "1",
                  "-o", str(out)])
    assert not out.exists()


def test_cli_render_cpu(tmp_path, capsys):
    out = tmp_path / "x.ppm"
    assert cli_main(["render", "--width", "8", "--height", "6", "--spp", "2",
                     "--device", "cpu", "-o", str(out)]) == 0
    assert out.read_bytes().startswith(b"P3\n8 6\n255\n")
    assert "traces=" in capsys.readouterr().err


def test_cli_bench_refuses_cpu():
    with pytest.raises(RuntimeError, match="card"):
        cli_main(["bench", "--width", "8", "--height", "6", "--spp", "1",
                  "--device", "cpu"])
