"""A stand-in for the port's kernel library, for CPU tests of the wrappers'
launches: ``install`` makes ``_build.build_kernels`` return a library that
records each entry point's arguments and returns cudaSuccess, with
``torch.cuda.device`` and ``current_stream`` made inert and a fresh
launch counter."""

import contextlib
from collections import Counter
from types import SimpleNamespace

import torch

from small_pathtracer_tpu_torch.ops import _build, megakernel


class RecordingLib:
    """Records each entry point's arguments and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def install(monkeypatch) -> RecordingLib:
    rec = RecordingLib()
    monkeypatch.setattr(_build, "build_kernels",
                        lambda: SimpleNamespace(lib=rec))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(megakernel, "LAUNCHES", Counter())
    return rec
