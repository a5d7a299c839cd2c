"""Film: clamp, tone mapping, its approximate inverse and ASCII P3 PPM I/O.

The reference's output contract: the per-pixel mean is clamped to [0, 1]
before gamma; ``toInt(x) = int(pow(clamp(x), 1/2.2) * 255 + .5)``; the file
is ``P3\\n<w> <h>\\n255\\n`` followed by ``"%d %d %d "`` per pixel.
"""

from __future__ import annotations

import numpy as np
import torch

GAMMA = 2.2


def clamp01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def finalize(sample_mean: torch.Tensor) -> torch.Tensor:
    """Clamp the per-pixel mean (linear image in [0, 1])."""
    return clamp01(sample_mean)


def tonemap_u8(linear: torch.Tensor) -> torch.Tensor:
    """Clamp, gamma 1/2.2 and round half up to uint8."""
    v = torch.pow(clamp01(linear), 1.0 / GAMMA) * 255.0 + 0.5
    return torch.floor(v).to(torch.uint8)


def srgb_from_u8(img_u8) -> np.ndarray:
    """Invert the tone map approximately: uint8 -> linear float64 (a target
    image for ``fit --target``)."""
    return np.power(np.asarray(img_u8, dtype=np.float64) / 255.0, GAMMA)


def write_ppm(path: str, image_u8) -> None:
    """Write an (h, w, 3) uint8 image as ASCII P3, byte for byte the
    reference writer's format."""
    img = np.asarray(image_u8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (h, w, 3) image, got {img.shape}")
    h, w, _ = img.shape
    body = " ".join(map(str, img.astype(np.uint8).reshape(-1).tolist())) + " "
    with open(path, "wb") as f:
        f.write(f"P3\n{w} {h}\n255\n".encode())
        f.write(body.encode())


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM into an (h, w, 3) uint8 array."""
    with open(path, "r") as f:
        tokens = f.read().split()
    if not tokens or tokens[0] != "P3":
        raise ValueError(f"not an ASCII PPM: {path}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval}, expected 255")
    data = np.array(tokens[4:4 + w * h * 3], dtype=np.int64)
    return data.reshape(h, w, 3).astype(np.uint8)
