"""Render configuration (the port's copy of ``small_pathtracer_tpu.config``).

The field set and defaults are the JAX package's, minus ``use_pallas``: the
device of the scene tensors decides the path (``integrator.wavefront.
render_counts``). This slice of the port runs the ``nee`` estimator with the
hash sampler, the box filter and the pinhole camera on the regenerating
schedule; every other value of a field raises NotImplementedError naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

import dataclasses

ESTIMATORS = (
    "cosine",
    "uniform",
    "uniform_corrected",
    "nee",
    "mixture",
    "nee_textbook",
    "mis",
)

_LATER = "is not ported yet (ROADMAP.md queue 1, item {})"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 16
    estimator: str = "nee"
    mixture_q: float = 0.5
    light_sample_mode: str = "intended"
    light_select: str = "power"
    rr_start_depth: int = 5
    max_bounces: int = 256
    spp_chunk: int = 0
    regen_groups: int = 0
    seed: int = 0
    rng_backend: str = "mix"
    sampler: str = "random"
    wavefront: str = "regen"
    pixel_filter: str = "box"
    aperture: float = 0.0
    focus_dist: float = 163.0
    sphere_table: str = "auto"

    def __post_init__(self):
        if self.estimator not in ESTIMATORS:
            raise ValueError(
                f"unknown estimator {self.estimator!r}; one of {ESTIMATORS}"
            )
        if self.estimator != "nee":
            raise NotImplementedError(
                f"estimator {self.estimator!r} " + _LATER.format(10)
            )
        if self.light_sample_mode not in ("intended", "glibc_overflow"):
            raise ValueError(
                f"unknown light_sample_mode {self.light_sample_mode!r}"
            )
        if self.light_sample_mode != "intended":
            raise NotImplementedError(
                "light_sample_mode='glibc_overflow' " + _LATER.format(10)
            )
        if self.light_select not in ("power", "uniform"):
            raise ValueError(f"unknown light_select {self.light_select!r}")
        if self.rng_backend not in ("mix", "mix_packed", "threefry"):
            raise ValueError(f"unknown rng backend: {self.rng_backend!r}")
        if self.rng_backend != "mix":
            raise NotImplementedError(
                f"rng_backend {self.rng_backend!r} " + _LATER.format(13)
            )
        if self.sampler not in ("random", "sobol"):
            raise ValueError(
                f"unknown sampler {self.sampler!r}; random or sobol"
            )
        if self.sampler != "random":
            raise NotImplementedError("sampler='sobol' " + _LATER.format(13))
        if self.wavefront not in ("regen", "scan"):
            raise ValueError(f"unknown wavefront {self.wavefront!r}")
        if self.wavefront != "regen":
            raise NotImplementedError("wavefront='scan' " + _LATER.format(14))
        if self.pixel_filter not in ("box", "tent"):
            raise ValueError(
                f"unknown pixel_filter {self.pixel_filter!r}; box or tent"
            )
        if self.pixel_filter != "box":
            raise NotImplementedError(
                "pixel_filter='tent' " + _LATER.format(13)
            )
        if self.aperture < 0.0 or self.focus_dist <= 0.0:
            raise ValueError(
                "aperture must be >= 0 and focus_dist > 0 "
                f"(got {self.aperture}, {self.focus_dist})"
            )
        if self.aperture > 0.0:
            raise NotImplementedError(
                "the thin-lens camera (aperture > 0) " + _LATER.format(13)
            )
        if self.sphere_table not in ("auto", "on", "off", "cluster",
                                     "cluster_scratch"):
            raise ValueError(
                "sphere_table must be auto/on/off/cluster/cluster_scratch, "
                f"got {self.sphere_table!r}"
            )
        if self.sphere_table not in ("auto", "off"):
            raise NotImplementedError(
                f"sphere_table={self.sphere_table!r} " + _LATER.format(11)
            )
        if min(self.width, self.height, self.spp) < 1:
            raise ValueError("width, height and spp must be >= 1")

