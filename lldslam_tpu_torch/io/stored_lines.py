"""Precomputed line detections on disk (the StoredLineExtractor contract).

Counterpart of lldslam_tpu/io/stored_lines.py: one `%06d.npz` per frame per
camera holding p1, p2 (L, 2), octave (L,) and desc (L, D) float32. A source
pads each frame to its capacity; a frame with more lines keeps the longest
ones (stable order) and counts the event (`cap_events` frames,
`cap_dropped` lines). `stage_stored_pair` sends both views of a frame to
the device. `precompute_sequence` writes such files for a whole sequence
with the native detector (frontend/line_extract.py).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..frontend.line_extract import KeyLines, LineDetConfig, detect_lines


def save_frame_lines(dir_path: str | Path, frame_id: int, p1, p2, octave,
                     desc, valid=None) -> None:
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    p1, p2 = np.asarray(p1), np.asarray(p2)
    octave, desc = np.asarray(octave), np.asarray(desc)
    if valid is not None:
        sel = np.asarray(valid)
        p1, p2, octave, desc = p1[sel], p2[sel], octave[sel], desc[sel]
    np.savez(dir_path / f"{frame_id:06d}.npz",
             p1=p1.astype(np.float32), p2=p2.astype(np.float32),
             octave=octave.astype(np.int32), desc=desc.astype(np.float32))


class StoredLineSource:
    """Per-frame line loader; `frame(i)` is a KeyLines padded to `cap`."""

    def __init__(self, dir_path: str | Path, cap: int = 256,
                 desc_dim: int = 40):
        self.dir = Path(dir_path)
        self.cap = cap
        self.desc_dim = desc_dim
        self.cap_events = 0      # frames that held more than `cap` lines
        self.cap_dropped = 0     # lines dropped from them

    def _frame_np(self, frame_id: int):
        """(p1, p2, octave, length, desc, valid) numpy arrays of one frame;
        all invalid when its file is absent."""
        path = self.dir / f"{frame_id:06d}.npz"
        cap, D = self.cap, self.desc_dim
        p1 = np.zeros((cap, 2), np.float32)
        p2 = np.zeros((cap, 2), np.float32)
        octave = np.zeros(cap, np.int32)
        desc = np.zeros((cap, D), np.float32)
        valid = np.zeros(cap, bool)
        if path.exists():
            z = np.load(path)
            n_file = len(z["p1"])
            if n_file > cap:
                # keep the longest lines, in file order
                ln = np.linalg.norm(np.asarray(z["p2"], np.float32)
                                    - np.asarray(z["p1"], np.float32),
                                    axis=-1)
                order = np.sort(np.argsort(-ln, kind="stable")[:cap])
                self.cap_events += 1
                self.cap_dropped += n_file - cap
                p1[:] = z["p1"][order]
                p2[:] = z["p2"][order]
                octave[:] = z["octave"][order]
                d = np.asarray(z["desc"])[order]
                desc[:, : min(D, d.shape[1])] = d[:, : min(D, d.shape[1])]
                valid[:] = True
                length = np.linalg.norm(p2 - p1, axis=-1).astype(np.float32)
                return p1, p2, octave, length, desc, valid
            n = n_file
            p1[:n] = z["p1"][:n]
            p2[:n] = z["p2"][:n]
            octave[:n] = z["octave"][:n]
            d = z["desc"][:n]
            desc[:n, : min(D, d.shape[1])] = d[:, : min(D, d.shape[1])]
            valid[:n] = True
        length = (np.linalg.norm(p2 - p1, axis=-1) * valid).astype(np.float32)
        return p1, p2, octave, length, desc, valid

    def frame(self, frame_id: int, device="cuda") -> KeyLines:
        t = lambda a: torch.from_numpy(a).to(device)
        return KeyLines(*(t(a) for a in self._frame_np(frame_id)))


def stage_stored_pair(left: StoredLineSource, right: StoredLineSource,
                      frame_id: int, device="cuda"):
    """Both views' detections of one frame on the device: each field of the
    two views stacked into one upload. Returns (KeyLines left, right)."""
    both = [torch.from_numpy(np.stack([a, b])).to(device) for a, b in zip(
        left._frame_np(frame_id), right._frame_np(frame_id))]
    return (KeyLines(*(x[0] for x in both)), KeyLines(*(x[1] for x in both)))


def precompute_sequence(seq, out_left: str | Path, out_right: str | Path,
                        cfg: LineDetConfig | None = None,
                        device="cuda") -> int:
    """Run the native detector over a StereoSequence (`frame(i)` -> left,
    right, timestamp) on `device` and store each view's valid detections
    (`save_frame_lines`, one file per frame and view). Returns the number
    of frames."""
    cfg = cfg or LineDetConfig()
    for i in range(len(seq)):
        img_l, img_r, _ = seq.frame(i)
        for img, out in ((img_l, out_left), (img_r, out_right)):
            kl = detect_lines(torch.from_numpy(np.ascontiguousarray(img))
                              .to(device), cfg)
            save_frame_lines(out, i, *(x.cpu().numpy() for x in (
                kl.p1, kl.p2, kl.octave, kl.desc, kl.valid)))
    return len(seq)
