"""Device-resident ring cache of recent keyframes' feature tensors.

Counterpart of lldslam_tpu/pipeline/kf_cache.py. The keyframe-rate mapping
stages (triangulation, fusion, local BA) consume per-keyframe features that
were already on the device when the frame was tracked; the cache keeps the
last `n_slots` keyframes' features there, written in place at keyframe
creation, and the mapping code gathers them by slot index. Slots are
assigned round-robin; `slots_of` returns -1 for evicted keyframes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CacheArrays(NamedTuple):
    """Stacked per-slot feature tensors."""

    xy: torch.Tensor      # (S, N, 2) float32
    ur: torch.Tensor      # (S, N) float32
    octave: torch.Tensor  # (S, N) int32
    angle: torch.Tensor   # (S, N) float32
    desc: torch.Tensor    # (S, N, 8) int32
    valid: torch.Tensor   # (S, N) bool


class KfCache:
    def __init__(self, n_slots: int, n_kp: int, device="cuda"):
        self.n_slots = n_slots
        self.n_kp = n_kp
        S, N = n_slots, n_kp
        dev = torch.device(device)
        self.arrays = CacheArrays(
            xy=torch.zeros((S, N, 2), dtype=torch.float32, device=dev),
            ur=torch.full((S, N), -1.0, dtype=torch.float32, device=dev),
            octave=torch.zeros((S, N), dtype=torch.int32, device=dev),
            angle=torch.zeros((S, N), dtype=torch.float32, device=dev),
            desc=torch.zeros((S, N, 8), dtype=torch.int32, device=dev),
            valid=torch.zeros((S, N), dtype=torch.bool, device=dev),
        )
        self._slot_of: dict[int, int] = {}
        self._kf_in: list[int] = [-1] * S
        self._next = 0

    def put(self, kf_id: int, feats) -> int:
        """Write a keyframe's features (a FrameFeatures of device tensors)
        into its slot, in place. Re-putting a cached keyframe reuses its
        slot."""
        slot = self._slot_of.get(kf_id)
        if slot is None:
            slot = self._next
            self._next = (self._next + 1) % self.n_slots
            old = self._kf_in[slot]
            if old >= 0:
                self._slot_of.pop(old, None)
        self._kf_in[slot] = kf_id
        self._slot_of[kf_id] = slot
        for dst, src in zip(self.arrays, (feats.xy, feats.ur, feats.octave,
                                          feats.angle, feats.desc,
                                          feats.valid)):
            dst[slot] = src
        return slot

    def slots_of(self, kf_ids) -> np.ndarray:
        """Slot per keyframe id, -1 when evicted (or never cached)."""
        return np.array([self._slot_of.get(int(k), -1) for k in kf_ids],
                        np.int32)

    def clear(self) -> None:
        self._slot_of.clear()
        self._kf_in = [-1] * self.n_slots
        self._next = 0
