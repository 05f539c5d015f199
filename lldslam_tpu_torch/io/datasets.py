"""Dataset loaders: KITTI odometry and EuRoC MAV stereo sequences.

Counterpart of lldslam_tpu/io/datasets.py. Images decode on the host with
PIL (where PIL is not installed, reading a frame raises) into float32
grayscale arrays in [0, 255]. The JAX package's native threaded PNG
prefetcher is not ported (ROADMAP queue 1 item 8): frames decode when
asked for.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


def load_gray(path: str | Path) -> np.ndarray:
    """Grayscale float32 image in [0, 255] (16-bit sources scaled down)."""
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("L", "I;16"):
        img = img.convert("L")
    arr = np.asarray(img, dtype=np.float32)
    if arr.max() > 255.0:
        arr = arr / 256.0
    return arr


@dataclass
class StereoSequence:
    """Lazy stereo sequence: paths + timestamps."""

    left: list
    right: list
    timestamps: np.ndarray

    def __len__(self) -> int:
        return len(self.left)

    def frame(self, i: int):
        return (load_gray(self.left[i]), load_gray(self.right[i]),
                float(self.timestamps[i]))


def load_kitti(seq_dir: str | Path) -> StereoSequence:
    """KITTI odometry layout: <seq>/times.txt, image_0/%06d.png (left),
    image_1/%06d.png (right)."""
    seq_dir = Path(seq_dir)
    times = np.loadtxt(seq_dir / "times.txt", dtype=np.float64).reshape(-1)
    n = len(times)
    left = [seq_dir / "image_0" / f"{i:06d}.png" for i in range(n)]
    right = [seq_dir / "image_1" / f"{i:06d}.png" for i in range(n)]
    return StereoSequence(left=left, right=right, timestamps=times)


def load_euroc(seq_dir: str | Path, times_file: str | Path) -> StereoSequence:
    """EuRoC MAV layout: mav0/cam{0,1}/data/<ns>.png, with a list file of
    nanosecond stamps."""
    seq_dir = Path(seq_dir)
    stamps = []
    for ln in Path(times_file).read_text().splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        stamps.append(ln.split(",")[0].split()[0])
    left = [seq_dir / "mav0" / "cam0" / "data" / f"{s}.png" for s in stamps]
    right = [seq_dir / "mav0" / "cam1" / "data" / f"{s}.png" for s in stamps]
    times = np.array([int(s) * 1e-9 for s in stamps], np.float64)
    return StereoSequence(left=left, right=right, timestamps=times)
