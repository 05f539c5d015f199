"""The corridor world (`benchlib/world.py`): a KITTI-like stereo camera
moving along a textured corridor, rendered on the card from the seed.

A traffic mix that names `"world": "corridor"` sets:

    speeds_m_per_frame  one speed a sequence (m a frame), handed to the
                        sequences in an order drawn from the seed
    stripes             vertical wall stripes (the lines world)
    stored_lines        stored LBD-format line detections of the first
                        sequence, written under the run's scratch directory

`make` returns the world a schedule drives: the frames of each sequence
(uint8 (n, 2, H, W) in pinned host memory on the card's machine), the
generator's true T_cw and speed of each, the configuration groups the
world sets (the stored detections' directories), and the truth the check
reads (each stored detection's world segment).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from benchlib import world


def make(cam: dict, traffic: dict, seed: int, n_frames: int, device,
         scratch: Path) -> dict:
    rng = np.random.default_rng(world.seed_of(seed, 1 << 20))
    speeds = list(traffic["speeds_m_per_frame"])
    speeds = [speeds[i] for i in rng.permutation(len(speeds))]
    on_card = device.type == "cuda"
    frames, truths, lengths = [], [], []
    for s, speed in enumerate(speeds):
        f, t_cw, w = world.render_sequence(
            cam, n_frames, speed, world.seed_of(seed, s), traffic["stripes"],
            device, pin=on_card)
        frames.append(f)
        truths.append((t_cw, speed))
        lengths.append(w["length"])
    out = dict(frames=frames, truths=truths, config={}, line_truth=None)
    if traffic["stored_lines"]:
        dirs = (scratch / "left", scratch / "right")
        out["line_truth"] = world.stored_lines(
            cam, truths[0][0], lengths[0], world.seed_of(seed, 1 << 21),
            *dirs)
        out["config"] = {"line": dict(detections_path=str(dirs[0]),
                                      descriptors_path=str(dirs[1]))}
    return out


def sequences(traffic: dict) -> int:
    """How many sequences the mix renders."""
    return len(traffic["speeds_m_per_frame"])
