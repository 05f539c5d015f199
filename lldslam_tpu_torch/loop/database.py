"""Keyframe database: BoW inverted file + loop/reloc candidate selection.

Counterpart of lldslam_tpu/loop/database.py, which is host numpy already;
copied with the port's `Vocabulary`. An inverted file word -> keyframes
with the reference's two-stage candidate logic:

- loop candidates: count shared words with every non-connected KF, keep
  those with > 0.8 * max shared words AND BoW score >= minScore; accumulate
  scores over covisibility groups; accept groups with accScore >
  0.75 * bestAccScore, returning each group's best KF.
- relocalization candidates: the same shape without the minScore gate.
"""
from __future__ import annotations

import numpy as np

from .bow import Vocabulary


def l1_score(ids_a, vals_a, ids_b, vals_b) -> float:
    """DBoW2 L1 scoring (ScoringObject.cpp:23):
    s = 2 * sum_{i in both} (|va| + |vb| - |va - vb|) / 2 ... normalized form
    used by the reference: 1 - 0.5 * |va/|va| - vb/|vb||_1, vectors already
    l1-normalized here, so s = 1 - 0.5 * sum|va - vb| over the union."""
    common_a = np.isin(ids_a, ids_b)
    common_b = np.isin(ids_b, ids_a)
    va = vals_a[common_a]
    # align b to a's order
    order = np.argsort(ids_b)
    ids_b_sorted = ids_b[order]
    vb_all = vals_b[order]
    pos = np.searchsorted(ids_b_sorted, ids_a[common_a])
    vb = vb_all[pos]
    # union L1 = sum|va-vb| (common) + sum va (a only) + sum vb (b only)
    l1 = np.abs(va - vb).sum() + vals_a[~common_a].sum() + vals_b[~common_b].sum()
    return float(1.0 - 0.5 * l1)


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.inv: list[list[int]] = [[] for _ in range(voc.n_words)]
        self.kf_words: dict[int, np.ndarray] = {}
        self.kf_vals: dict[int, np.ndarray] = {}

    def add(self, kf_id: int, word_ids: np.ndarray, vals: np.ndarray):
        self.kf_words[kf_id] = word_ids
        self.kf_vals[kf_id] = vals
        for w in word_ids:
            self.inv[int(w)].append(kf_id)

    def erase(self, kf_id: int):
        if kf_id not in self.kf_words:
            return
        for w in self.kf_words.pop(kf_id):
            lst = self.inv[int(w)]
            if kf_id in lst:
                lst.remove(kf_id)
        self.kf_vals.pop(kf_id, None)

    def score(self, a: int, b: int) -> float:
        return l1_score(self.kf_words[a], self.kf_vals[a],
                        self.kf_words[b], self.kf_vals[b])

    def score_vs(self, word_ids: np.ndarray, vals: np.ndarray, kf: int) -> float:
        return l1_score(word_ids, vals, self.kf_words[kf], self.kf_vals[kf])

    # ------------------------------------------------------------------

    def _shared_word_counts(self, word_ids: np.ndarray, exclude: set[int]):
        counts: dict[int, int] = {}
        for w in word_ids:
            for kf in self.inv[int(w)]:
                if kf not in exclude:
                    counts[kf] = counts.get(kf, 0) + 1
        return counts

    def detect_loop_candidates(
        self,
        query_kf: int,
        min_score: float,
        connected: set[int],
        covis_groups: dict[int, list[int]],
    ) -> list[int]:
        return self.detect_loop_candidates_vec(
            self.kf_words[query_kf], self.kf_vals[query_kf], min_score,
            set(connected) | {query_kf}, covis_groups)

    def detect_loop_candidates_vec(
        self,
        qw: np.ndarray,
        qv: np.ndarray,
        min_score: float,
        exclude: set[int],
        covis_groups,
    ) -> list[int]:
        """covis_groups: dict kf -> covisible group, or a callable kf ->
        group list (evaluated lazily, only for scored candidates — the
        all-KF eager version is O(K^2) host work). Mirrors
        KeyFrameDatabase.cc:152-186 score accumulation."""
        counts = self._shared_word_counts(qw, exclude)
        if not counts:
            return []
        groups_of = covis_groups.get if hasattr(covis_groups, "get") \
            else covis_groups
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored = {}
        for kf, c in counts.items():
            if c > min_common:
                s = l1_score(qw, qv, self.kf_words[kf], self.kf_vals[kf])
                if s >= min_score:
                    scored[kf] = s
        if not scored:
            return []
        # accumulate over covisibility groups
        acc = []
        best_acc = min_score
        for kf, s in scored.items():
            group = groups_of(kf) or [kf]
            acc_score, best_kf, best_s = s, kf, s
            for g in group:
                if g != kf and g in scored:
                    acc_score += scored[g]
                    if scored[g] > best_s:
                        best_kf, best_s = g, scored[g]
            acc.append((best_kf, acc_score))
            best_acc = max(best_acc, acc_score)
        th = 0.75 * best_acc
        out = []
        seen = set()
        for kf, a in acc:
            if a > th and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_reloc_candidates(self, word_ids: np.ndarray, vals: np.ndarray
                                ) -> list[int]:
        counts = self._shared_word_counts(word_ids, set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored = [
            (kf, l1_score(word_ids, vals, self.kf_words[kf], self.kf_vals[kf]))
            for kf, c in counts.items() if c > min_common
        ]
        if not scored:
            return []
        best = max(s for _, s in scored)
        return [kf for kf, s in scored if s > 0.75 * best]
