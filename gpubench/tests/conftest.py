"""Shared fixtures of the benchmark's own tests (CPU; the `cuda` ones skip
without a card).

    python -m pytest -p no:xdist -o addopts="" gpubench/tests
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

GPUBENCH = Path(__file__).resolve().parent.parent
ROOT = GPUBENCH.parent
for p in (str(GPUBENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a small camera and feature count: the CPU runs the program's plain
# versions, and a KITTI-size run is the card's
SMALL = dict(camera=dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                         width=640, height=240),
             orb=dict(n_features=512), tracking=dict(min_init_points=80))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card's machine)")
    return torch.device("cuda:0")
