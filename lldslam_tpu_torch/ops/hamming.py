"""Batched Hamming-distance machinery for 256-bit ORB descriptors.

Counterpart of lldslam_tpu/ops/hamming.py. Descriptors are (N, 8) int32
tensors holding the uint32 words (bit k of word w is descriptor bit 32w + k).
Thresholds: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 rotation bins. Every
function takes leading batch dimensions (the multi-sequence driver's
sequence axis) and works on each batch entry alone.
"""
from __future__ import annotations

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INF_DIST = 10_000  # sentinel > any possible 256-bit distance


def unpack_bits(a: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) int32 packed descriptors -> (..., N, 256) float32
    {0, 1} bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=a.device)
    bits = (a[..., None] >> shifts) & 1         # arithmetic shift: exact bits
    return bits.reshape(*a.shape[:-1], 256).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(n, 256) {0, 1} -> (n, 8) int32 words. Accumulates in int64 and
    wraps bit 31 into the int32 sign."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.to(torch.int64).reshape(-1, 8, 32) << shifts).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) -> (..., N, M) int32 Hamming distances via
    the bit-matmul identity popcount(a ^ b) = |a| + |b| - 2 A.B^T (exact in
    float32: integers <= 256 in any summation order)."""
    A = unpack_bits(a)
    B = unpack_bits(b)
    ab = A @ B.transpose(-1, -2)
    na = A.sum(dim=-1)
    nb = B.sum(dim=-1)
    return torch.round(na[..., :, None] + nb[..., None, :] - 2.0 * ab).to(
        torch.int32)


def distance_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rowwise distances for aligned pairs: (..., 8) x (..., 8) -> (...,)."""
    x = (a ^ b)[..., None] >> torch.arange(32, dtype=torch.int32,
                                           device=a.device)
    return (x & 1).sum(dim=(-1, -2)).to(torch.int32)


def masked_argmin(dist: torch.Tensor, mask: torch.Tensor):
    """Min + argmin per row (the last axis) with invalid entries masked
    out. Returns (best_idx (..., N), best_dist (..., N), second_dist
    (..., N)); rows with no valid entry get best_dist = INF_DIST."""
    d = torch.where(mask, dist, torch.full_like(dist, INF_DIST))
    best_idx = torch.argmin(d, dim=-1, keepdim=True)
    best = torch.gather(d, -1, best_idx)[..., 0]
    d.scatter_(-1, best_idx, INF_DIST)
    second = d.min(dim=-1).values
    return best_idx[..., 0], best, second


def _topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties broken by lower index first
    (lax.top_k semantics)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def rotation_consistency_mask(ang_a: torch.Tensor, ang_b: torch.Tensor,
                              match_idx: torch.Tensor, valid: torch.Tensor,
                              n_keep: int = 3) -> torch.Tensor:
    """Rotation-consistency histogram: keep matches whose angle difference
    falls into the top-`n_keep` of HISTO_LENGTH bins (one histogram per
    batch entry). Returns (..., N) bool."""
    diff = ang_a - torch.take_along_dim(ang_b, match_idx.long(), dim=-1)
    deg = torch.rad2deg(diff)
    deg = torch.where(deg < 0, deg + 360.0, deg)
    b = torch.round(deg * (HISTO_LENGTH / 360.0)).to(torch.int64)
    b = torch.where(b == HISTO_LENGTH, torch.zeros_like(b), b)
    counts = torch.zeros(*b.shape[:-1], HISTO_LENGTH, dtype=torch.int32,
                         device=b.device)
    counts.scatter_add_(-1, b, valid.to(torch.int32))
    top_bins = _topk_stable(counts, n_keep)
    return valid & (b[..., :, None] == top_bins[..., None, :]).any(dim=-1)


def match_descriptors(desc_a: torch.Tensor, valid_a: torch.Tensor,
                      desc_b: torch.Tensor, valid_b: torch.Tensor,
                      max_dist: int = TH_LOW, ratio: float = 1.0,
                      cand_mask: torch.Tensor | None = None,
                      mutual: bool = True):
    """Gated matcher: best masked candidate per `a` row, distance threshold,
    best/second ratio test, optional cross-check. Returns (idx (N,) into b,
    ok (N,) bool, dist (N,) int32)."""
    dist = distance_matrix(desc_a, desc_b)
    mask = valid_a[..., :, None] & valid_b[..., None, :]
    if cand_mask is not None:
        mask = mask & cand_mask
    idx, best, second = masked_argmin(dist, mask)
    ok = (best <= max_dist) & (best.to(torch.float32)
                               <= ratio * second.to(torch.float32))
    if mutual:
        idx_b, _, _ = masked_argmin(dist.transpose(-1, -2),
                                    mask.transpose(-1, -2))
        ok = ok & (torch.take_along_dim(idx_b, idx, dim=-1)
                   == torch.arange(idx.shape[-1], device=idx.device))
    return idx, ok, best
