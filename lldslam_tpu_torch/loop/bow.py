"""Bag-of-binary-words place recognition: hierarchical vocabulary and its
batched tree descent.

Counterpart of lldslam_tpu/loop/bow.py: a k-ary vocabulary over 256-bit ORB
descriptors (DBoW2's TemplatedVocabulary), TF-IDF weights with L1 scoring.
The tree arrays are numpy; `Vocabulary` also keeps them as tensors on its
device, where `_descend` walks every descriptor down the L levels at once
(gather the children, popcount of the XORs, first argmin).

Sources: `load_npz`/`save_npz` (the shipped `vocab_synth.npz`), `load_text`
(the ORB-SLAM2 `ORBvoc.txt` format), `train` (host hierarchical binary
k-medians, used when no vocabulary is given) and `train_device` (the
offline trainer at ORBvoc scale: every node of a level split at once on the
device).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

# popcount of every byte value
_POPCOUNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                           axis=1).sum(1).astype(np.int32)
_FAR = 1 << 30      # distance of a childless slot


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    """Row-wise popcount of packed uint32 arrays."""
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) packed-uint32 Hamming distance matrix."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_center(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority 'mean' of packed descriptors (DBoW2 FORB::meanValue)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)
    maj = (bits.sum(0) * 2 >= len(bits)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _desc_tensor(descs, device) -> torch.Tensor:
    """(N, 8) uint32 numpy or int32 tensor -> int32 tensor on `device`."""
    if isinstance(descs, torch.Tensor):
        return descs.to(device=device, dtype=torch.int32)
    a = np.ascontiguousarray(descs, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


@dataclass
class Vocabulary:
    """Flat-array hierarchical vocabulary.

    node_children: (n_nodes, k) int32 child node id or -1,
    node_desc:     (n_nodes, 8) uint32,
    node_word:     (n_nodes,) int32 word id for leaves, -1 inside,
    word_weight:   (n_words,) float32 idf weights,
    k, L: branching factor and depth; `device` holds the tree tensors.
    """

    node_children: np.ndarray
    node_desc: np.ndarray
    node_word: np.ndarray
    word_weight: np.ndarray
    k: int
    L: int
    device: torch.device = field(default=torch.device("cpu"))
    _children: torch.Tensor = field(init=False, repr=False)
    _desc: torch.Tensor = field(init=False, repr=False)
    _word: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._children = torch.from_numpy(
            self.node_children.astype(np.int64)).to(self.device)
        self._desc = _desc_tensor(self.node_desc, self.device)
        self._word = torch.from_numpy(
            self.node_word.astype(np.int64)).to(self.device)

    @property
    def n_words(self) -> int:
        return len(self.word_weight)

    def to(self, device) -> "Vocabulary":
        """The same vocabulary with its tree tensors on `device`."""
        if torch.device(device) == self.device:
            return self
        return Vocabulary(self.node_children, self.node_desc, self.node_word,
                          self.word_weight, self.k, self.L, device)

    # ------------------------------------------------------------------

    @staticmethod
    def train(descs: np.ndarray, k: int = 10, L: int = 4, seed: int = 0,
              min_cluster: int = 2) -> "Vocabulary":
        """Hierarchical k-medians over packed uint32 descriptors (host,
        one-off): kmeans++ seeding, bit-majority centres, 8 Lloyd rounds."""
        rng = np.random.default_rng(seed)
        children: list[list[int]] = [[]]
        node_desc = [np.zeros(8, np.uint32)]
        node_word: list[int] = [-1]

        def kmeans(data: np.ndarray, kk: int):
            n = len(data)
            kk = min(kk, n)
            centers = [data[rng.integers(n)]]
            for _ in range(kk - 1):
                d = np.min(
                    np.stack([_popcount_rows(data ^ c[None]) for c in centers]),
                    axis=0).astype(np.float64)
                if d.sum() == 0:
                    centers.append(data[rng.integers(n)])
                    continue
                centers.append(data[rng.choice(n, p=d / d.sum())])
            centers = np.stack(centers)
            assign = np.zeros(n, np.int64)
            for _ in range(8):
                new_assign = _hamming_np(data, centers).argmin(1)
                if (new_assign == assign).all():
                    break
                assign = new_assign
                for c in range(len(centers)):
                    sel = data[assign == c]
                    if len(sel):
                        centers[c] = _majority_center(sel)
            return centers, assign

        def build(node: int, data: np.ndarray, level: int):
            if level == L or len(data) < min_cluster * 2:
                node_word[node] = 0  # provisional; renumbered below
                return
            centers, assign = kmeans(data, k)
            for c in range(len(centers)):
                sel = data[assign == c]
                if len(sel) == 0:
                    continue
                nid = len(node_desc)
                node_desc.append(centers[c])
                node_word.append(-1)
                children.append([])
                children[node].append(nid)
                build(nid, sel, level + 1)

        build(0, np.unique(descs, axis=0), 0)
        ch = np.full((len(node_desc), k), -1, np.int32)
        for i, c in enumerate(children):
            ch[i, : len(c)] = c
        nw = np.asarray(node_word, np.int32)
        leaves = np.nonzero(nw == 0)[0]
        nw[:] = -1
        nw[leaves] = np.arange(len(leaves), dtype=np.int32)
        voc = Vocabulary(node_children=ch, node_desc=np.stack(node_desc),
                         node_word=nw,
                         word_weight=np.ones(len(leaves), np.float32),
                         k=k, L=L)
        # idf weights from the training corpus
        words = voc.transform_words(descs)
        counts = np.bincount(words, minlength=voc.n_words)
        idf = np.log(max(len(descs), 1) / np.maximum(counts, 1))
        voc.word_weight = idf.astype(np.float32)
        return voc

    @staticmethod
    def train_device(descs: np.ndarray, k: int = 10, L: int = 5,
                     seed: int = 0, iters: int = 8,
                     doc_ids: np.ndarray | None = None,
                     device="cuda") -> "Vocabulary":
        """Hierarchical binary k-medians at ORBvoc scale (k=10, L=5: about
        10^5 leaves) with every node of a level split at once on `device`:
        per Lloyd iteration one (N, k) Hamming assignment (first child on a
        tie) and one bit-majority count per (node, child). The initial
        centres are k random members of each node, drawn with numpy from
        `seed`; empty children are pruned. The JAX package's
        `Vocabulary.train_device`, the same draws and arithmetic (integer
        counts, so the result does not depend on the summation order).

        descs: (N, 8) uint32 packed. doc_ids: (N,) document id of each
        descriptor for the idf weights (default: 500-descriptor chunks).
        Returns the vocabulary with its tree tensors on `device`."""
        dev = torch.device(device)
        rng = np.random.default_rng(seed)
        descs = np.unique(descs, axis=0) if doc_ids is None else descs
        N = len(descs)
        d_dev = _desc_tensor(descs, dev)
        bits_dev = torch.from_numpy(np.unpackbits(
            descs.view(np.uint8), axis=-1).astype(np.int32)).to(dev)
        lut = torch.from_numpy(_POPCOUNT8).to(dev)

        def assign(centers: np.ndarray, group: torch.Tensor) -> torch.Tensor:
            """centers (G, k, 8) uint32 -> each descriptor's nearest child
            of its group (N,) int64."""
            c = _desc_tensor(centers.reshape(-1, 8), dev).reshape(-1, k, 8)
            out = []
            for a in range(0, N, 1 << 16):
                x = c[group[a:a + (1 << 16)]] ^ d_dev[a:a + (1 << 16), None]
                dist = lut[x.contiguous().view(torch.uint8).long()].sum(-1)
                out.append(torch.argmin(dist, dim=-1))
            return torch.cat(out)

        def majority(gc: torch.Tensor, n: int):
            """Bit-majority centre (n, 8) uint32 and member count (n,) of
            each (group * k + child) id."""
            sums = torch.zeros((n, 256), dtype=torch.int32, device=dev)
            sums.index_add_(0, gc, bits_dev)
            cnt = torch.bincount(gc, minlength=n)
            maj = (2 * sums >= cnt[:, None]).cpu().numpy().astype(np.uint8)
            return (np.packbits(maj, axis=-1).view(np.uint32).reshape(-1, 8),
                    cnt.cpu().numpy())

        group = np.zeros(N, np.int64)   # node membership at the current level
        n_groups = 1
        node_desc = [np.zeros(8, np.uint32)]
        children: list[list[int]] = [[]]
        level_nodes = [np.array([0], np.int64)]
        for _ in range(L):
            # init: k random members per group (host, group-sorted CSR)
            order = np.argsort(group, kind="stable")
            starts = np.searchsorted(group[order], np.arange(n_groups + 1))
            counts = starts[1:] - starts[:-1]
            centers = np.zeros((n_groups, k, 8), np.uint32)
            for g in range(n_groups):
                c = counts[g]
                if c == 0:
                    continue
                pick = order[starts[g] + rng.choice(c, size=min(k, c),
                                                    replace=False)]
                centers[g, : len(pick)] = descs[pick]
                if c < k:  # duplicates fill the rest (empty children pruned)
                    centers[g, len(pick):] = descs[pick[0]]
            group_dev = torch.from_numpy(group).to(dev)
            child = assign(centers, group_dev)
            for _ in range(iters):
                new_centers, cnt = majority(group_dev * k + child,
                                            n_groups * k)
                new_centers = new_centers.reshape(n_groups, k, 8)
                keep = cnt.reshape(n_groups, k) > 0
                new_centers[~keep] = centers[~keep]  # empties keep theirs
                centers = new_centers
                new_child = assign(centers, group_dev)
                done = torch.equal(new_child, child)
                child = new_child
                if done:
                    break
            # this level's nodes, empty children pruned
            gc = group * k + child.cpu().numpy()
            occupied = np.unique(gc)
            remap = np.full(n_groups * k, -1, np.int64)
            base = len(node_desc)
            remap[occupied] = base + np.arange(len(occupied))
            for j, gc_id in enumerate(occupied):
                g, c = divmod(int(gc_id), k)
                node_desc.append(centers[g, c])
                children.append([])
                children[int(level_nodes[-1][g])].append(base + j)
            group = remap[gc] - base
            n_groups = len(occupied)
            level_nodes.append(np.arange(base, base + n_groups,
                                         dtype=np.int64))

        ch = np.full((len(node_desc), k), -1, np.int32)
        for i, c in enumerate(children):
            ch[i, : len(c)] = c[:k]
        node_word = np.full(len(node_desc), -1, np.int32)
        leaves = level_nodes[-1]
        node_word[leaves] = np.arange(len(leaves), dtype=np.int32)
        voc = Vocabulary(ch, np.stack(node_desc), node_word,
                         np.ones(len(leaves), np.float32), k, L, dev)
        # idf: log(n_docs / documents containing the word)
        words = voc.transform_words(descs)
        if doc_ids is None:
            doc_ids = np.arange(N) // 500
        n_docs = int(doc_ids.max()) + 1
        pair = np.unique(doc_ids.astype(np.int64) * voc.n_words + words)
        n_i = np.bincount((pair % voc.n_words).astype(np.int64),
                          minlength=voc.n_words)
        voc.word_weight = np.log(
            n_docs / np.maximum(n_i, 1e-9)).astype(np.float32)
        voc.word_weight[n_i == 0] = 0.0
        return voc

    def save_npz(self, path: str | Path) -> None:
        np.savez_compressed(
            path, node_children=self.node_children, node_desc=self.node_desc,
            node_word=self.node_word, word_weight=self.word_weight,
            k=self.k, L=self.L)

    @staticmethod
    def load_npz(path: str | Path, device="cpu") -> "Vocabulary":
        z = np.load(path)
        return Vocabulary(z["node_children"], z["node_desc"], z["node_word"],
                          z["word_weight"], int(z["k"]), int(z["L"]), device)

    @staticmethod
    def load_text(path: str | Path, device="cpu") -> "Vocabulary":
        """ORBvoc.txt loader: header `k L scoring weighting`, then one node
        per line `parent is_leaf d0..d31 weight`."""
        with open(path) as f:
            header = f.readline().split()
            k, L = int(header[0]), int(header[1])
            parents, leaves, descs, weights = [], [], [], []
            for line in f:
                parts = line.split()
                if len(parts) < 35:
                    continue
                parents.append(int(parts[0]))
                leaves.append(int(parts[1]))
                descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
                weights.append(float(parts[34]))
        n = len(parents) + 1
        node_desc = np.zeros((n, 8), np.uint32)
        node_desc[1:] = np.packbits(
            np.unpackbits(np.stack(descs), axis=-1), axis=-1
        ).view(np.uint32).reshape(-1, 8)
        children: list[list[int]] = [[] for _ in range(n)]
        for i, p in enumerate(parents):
            children[p].append(i + 1)
        ch = np.full((n, k), -1, np.int32)
        for i, c in enumerate(children):
            ch[i, : len(c)] = c[:k]
        node_word = np.full(n, -1, np.int32)
        leaf_ids = np.nonzero(np.array([0] + leaves, np.int32))[0]
        node_word[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
        w = np.array([0.0] + weights, np.float32)[leaf_ids]
        return Vocabulary(ch, node_desc, node_word, w, k, L, device)

    # ------------------------------------------------------------------

    def transform_words(self, descs, valid=None) -> np.ndarray:
        """Word id per descriptor (batched tree descent on the vocabulary's
        device); -1 where `valid` is False. `descs` is (N, 8) uint32 numpy
        or an int32 tensor."""
        words = _descend(self._children, self._desc, self._word,
                         _desc_tensor(descs, self.device), self.L)
        words = words.cpu().numpy().astype(np.int32)
        if valid is not None:
            valid = valid.cpu().numpy() if isinstance(valid, torch.Tensor) \
                else np.asarray(valid)
            words = np.where(valid, words, -1)
        return words

    def device_words(self, descs: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
        """`transform_words` left on the device (no read-back): (N,) int32
        word ids, -1 where `valid` is False."""
        words = _descend(self._children, self._desc, self._word,
                         _desc_tensor(descs, self.device), self.L)
        return torch.where(valid.to(self.device), words, -1).to(torch.int32)

    def bow_vector(self, descs, valid=None):
        """(word_ids sorted unique, l1-normalized tf-idf values)."""
        return self.vector_from_words(self.transform_words(descs, valid))

    def vector_from_words(self, words: np.ndarray):
        """tf-idf aggregation of per-descriptor word ids (-1 = invalid)."""
        words = words[words >= 0]
        ids, counts = np.unique(words, return_counts=True)
        vals = counts.astype(np.float32) * self.word_weight[ids]
        s = vals.sum()
        if s > 0:
            vals = vals / s
        return ids.astype(np.int32), vals


def _descend(node_children: torch.Tensor, node_desc: torch.Tensor,
             node_word: torch.Tensor, descs: torch.Tensor,
             L: int) -> torch.Tensor:
    """Batched tree descent: L levels of gather + Hamming argmin (the first
    child at a tie; childless slots at distance 1 << 30). descs (N, 8)
    int32. Returns (N,) int64 word ids (-1 if the walk ends on an inner
    node without children)."""
    lut = torch.from_numpy(_POPCOUNT8).to(descs.device)
    node = torch.zeros(descs.shape[0], dtype=torch.int64, device=descs.device)
    for _ in range(L):
        ch = node_children[node]                              # (N, k)
        x = node_desc[torch.clamp(ch, min=0)] ^ descs[:, None, :]
        dist = lut[x.contiguous().view(torch.uint8).long()].sum(-1)
        dist = torch.where(ch >= 0, dist, torch.full_like(dist, _FAR))
        nxt = torch.gather(ch, 1, torch.argmin(dist, dim=-1)[:, None])[:, 0]
        # stay put where there are no children (already at a leaf)
        node = torch.where(ch[:, 0] >= 0, nxt, node)
    return node_word[node]
