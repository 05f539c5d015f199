"""Dataset loaders: KITTI odometry and EuRoC MAV stereo sequences.

Counterpart of lldslam_tpu/io/datasets.py. Images decode on the host
through the port's native PNG decoder (lldslam_tpu_torch/native, 8-bit
grayscale, as KITTI and EuRoC store them) into float32 arrays in [0, 255].
`prefetch` wraps a sequence with the native threaded prefetcher, which
decodes frames ahead of the tracker on worker threads.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


def load_gray(path: str | Path) -> np.ndarray:
    """8-bit grayscale PNG as a float32 image in [0, 255]; any other format
    raises (native.read_png)."""
    from .. import native

    return native.read_png(path).astype(np.float32)


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


class PrefetchedStereoSequence:
    """A StereoSequence read through the native threaded prefetcher: each
    view's frames decode ahead of the consumer on worker threads; frames
    come back as uint8 images."""

    def __init__(self, seq: StereoSequence, window: int = 8,
                 n_threads: int = 2):
        from ..native import NativeImageLoader

        self._left = NativeImageLoader(seq.left, window, n_threads)
        self._right = NativeImageLoader(seq.right, window, n_threads)
        self.timestamps = seq.timestamps

    def __len__(self) -> int:
        return len(self._left)

    def frame(self, i: int):
        return (self._left.frame(i), self._right.frame(i),
                float(self.timestamps[i]))

    def close(self) -> None:
        self._left.close()
        self._right.close()


def prefetch(seq: StereoSequence, window: int = 8,
             n_threads: int = 2) -> PrefetchedStereoSequence:
    """`seq` behind the native prefetcher; raises where the native library
    cannot be built or a first frame cannot be read."""
    return PrefetchedStereoSequence(seq, window, n_threads)


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
