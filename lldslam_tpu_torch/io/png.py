"""A PNG encoder on the standard library (zlib + struct).

Writes 8-bit grayscale (H, W) or RGB (H, W, 3) uint8 images, every
scanline with filter 0 (none), one IDAT chunk. The viewer writes its
renders with it, and io/synthetic.py its KITTI-layout sequences; the
port reads PNGs with its native decoder (lldslam_tpu_torch/native).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of an (H, W) or (H, W, 3) uint8 image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))
