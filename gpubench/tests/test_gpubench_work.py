"""The frozen work functions of the rooflines, on hand-counted cases."""
from __future__ import annotations

import numpy as np
import torch

from benchlib import reference as ref
from benchlib import work


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 0) == 1.0
    assert work.bound_s(0, 67e12) == 1.0
    assert work.bound_s(3.35e12, 134e12) == 2.0


def test_k1b_one_keypoint_inside_the_level():
    stack = torch.zeros((1, 2, 64, 96))
    one = lambda v: torch.tensor([[v]], dtype=torch.int32)
    n_bytes, n_ops = work.k1b(stack, [(64, 96)], one(0), one(40), one(30),
                              one(35))
    # an 11 x 11 left patch and an 11 x 21 right strip, each pixel once
    assert n_bytes == 4 * (121 + 231) + 16 + 12
    assert n_ops == 11 * 121 * 3


def test_k1b_clamped_windows_count_distinct_pixels():
    stack = torch.zeros((1, 2, 64, 96))
    one = lambda v: torch.tensor([[v]], dtype=torch.int32)
    # at the corner the patch rows and columns clamp to 0..5 and the strip
    # columns to 0..10: 6 x 6 and 6 x 11 distinct pixels
    n_bytes, _ = work.k1b(stack, [(64, 96)], one(0), one(0), one(0), one(0))
    assert n_bytes == 4 * (36 + 66) + 28


def test_k1a_one_keypoint_at_angle_zero():
    stack = torch.zeros((1, 1, 80, 80))
    xy = torch.tensor([[[40, 40]]], dtype=torch.int32)
    idx = torch.zeros((1, 1), dtype=torch.int32)
    n_bytes, n_ops = work.k1a(stack, xy, idx, [(80, 80)],
                              torch.zeros((1, 1)))
    pat = np.load(ref.PATTERN)
    brief = {(40 + int(x), 40 + int(y)) for x, y in pat.reshape(-1, 2)}
    # the 749 pixels of the radius-15 patch, the BRIEF taps once each
    assert n_bytes == 4 * (749 + len(brief)) + 12 + 36
    assert n_ops == 4 * 749 + 13 * 256


def test_k2g_counts_gated_pairs():
    f = lambda *v: torch.tensor([v], dtype=torch.float32)
    a = torch.zeros((1, 2, 8), dtype=torch.int32)
    b = torch.zeros((1, 3, 8), dtype=torch.int32)
    xy = torch.tensor([[[10.0, 10.0], [12.0, 10.0], [50.0, 50.0]]])
    n_bytes, n_ops = work.k2g(
        a, f(10.0, 100.0), f(10.0, 100.0), f(-1.0, -1.0), f(3.0, 3.0),
        torch.zeros((1, 2), dtype=torch.int32), torch.ones((1, 2), dtype=bool),
        b, xy, f(-1.0, -1.0, -1.0), torch.zeros((1, 3), dtype=torch.int32),
        torch.ones((1, 3), dtype=bool))
    # row 0 sees columns 0 and 1 (within 3 px); row 1 sees none
    assert n_ops == 3 * 2 * 3 + 23 * 2
    assert n_bytes == 2 * (32 + 16 + 4 + 1 + 16) + 3 * (32 + 8 + 4 + 4 + 1)
