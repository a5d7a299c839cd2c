"""small_pathtracer_tpu_torch: the PyTorch/CUDA port of small_pathtracer_tpu.

The JAX package beside it is the reference this port is tested against. This
package imports torch and numpy only.
"""

__version__ = "0.1.0"

from .config import ESTIMATORS, RenderConfig
from .camera.pinhole import CameraParams, make_camera
from .scene.presets import get_scene
from .scene.types import Scene
from .integrator.wavefront import render, render_counts

__all__ = [
    "ESTIMATORS",
    "RenderConfig",
    "CameraParams",
    "make_camera",
    "get_scene",
    "Scene",
    "render",
    "render_counts",
]
