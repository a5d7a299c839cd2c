"""Image files: ASCII PPM (the reference's format, through ``core.film``)
and PNG, chosen by the extension.

PNG is written with the standard library alone (``zlib`` and ``struct``):
8-bit RGB, one IDAT chunk, filter type 0 on every row. The card's machine
has no Pillow, so there is one writer for every machine. ``read_image``
reads what ``write_image`` writes, and 8-bit RGB or RGBA PNGs from other
writers (any of the five filter types, no interlace).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import film

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image_u8) -> bytes:
    """An (h, w, 3) uint8 image as PNG bytes."""
    img = np.ascontiguousarray(image_u8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (h, w, 3) image, got {img.shape}")
    h, w, _ = img.shape
    # Each row: its filter type (0, none), then its bytes.
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + stride) scanline bytes."""
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:].astype(np.int64)
        if kind == 0:
            row = line
        elif kind == 2:
            row = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            row = line.copy()
            for x in range(0, stride, bpp):
                left = row[x - bpp:x] if x else np.zeros(bpp, np.int64)
                up = prev[x:x + bpp]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) >> 1
                else:
                    upleft = (prev[x - bpp:x] if x
                              else np.zeros(bpp, np.int64))
                    pred = _paeth(left, up, upleft)
                row[x:x + bpp] = (row[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prev = row
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB or RGBA, non-interlaced PNG bytes as (h, w, 3) uint8."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, hdr = len(PNG_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (2, 6) or interlace != 0:
        raise ValueError(
            f"only 8-bit RGB/RGBA non-interlaced PNGs are read (depth "
            f"{depth}, color type {color}, interlace {interlace})")
    bpp = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw.reshape(h, 1 + w * bpp), h, w * bpp, bpp)
    return rows.reshape(h, w, bpp)[..., :3].copy()


def write_image(path: str, image_u8) -> None:
    """Write an (h, w, 3) uint8 image: ASCII PPM for a ``.ppm`` path (byte
    for byte the reference's format), PNG for any other."""
    if path.endswith(".ppm"):
        film.write_ppm(path, image_u8)
        return
    with open(path, "wb") as f:
        f.write(encode_png(image_u8))


def read_image(path: str) -> np.ndarray:
    """Read a ``.ppm`` or PNG file into (h, w, 3) uint8."""
    if path.endswith(".ppm"):
        return film.read_ppm(path)
    with open(path, "rb") as f:
        return decode_png(f.read())
