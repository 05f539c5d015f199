"""Host <-> device copies that do not make the host wait for the device.

The pipelined tracker (pipeline/tracker.py) dispatches frame i+1 before
frame i's results reach the host, so neither its uploads nor its read-backs
may synchronise the stream:

- `upload(a, device)`: a numpy array on the device. On a card the array is
  copied into pinned host memory and sent with `non_blocking=True` (a copy
  from pageable memory would wait for every queued kernel first); PyTorch's
  pinned-memory cache keeps the staging buffer until the copy has run. On
  the CPU the tensor shares the array's memory, as `torch.from_numpy` does.
- `HostCopy(tree)`: queues ONE `copy_(non_blocking=True)` of every tensor
  of `tree` (a dict or list of dicts of tensors, any dtypes and shapes)
  into one pinned host buffer, then records one CUDA event; `result()`
  waits on that event alone and returns the same tree of numpy arrays. A
  pinned buffer read before its event completes would hold garbage, so
  nothing reads it but `result()`. On the CPU the copy is taken at once.
"""
from __future__ import annotations

import numpy as np
import torch


def upload(a, device: torch.device) -> torch.Tensor:
    """numpy array (or scalar) -> tensor on `device`, without a stream sync
    on a card."""
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(x, it) for x in tree]
    return next(it)


class HostCopy:
    """One device-to-host copy of a tree of tensors, read after its event."""

    def __init__(self, tree):
        self._tree = tree
        leaves = _leaves(tree)
        self._meta = [(t.shape, t.dtype) for t in leaves]
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                for t in leaves]
        buf = torch.cat(flat) if flat else torch.zeros(0, dtype=torch.uint8)
        self._event = None
        if buf.device.type == "cuda":
            self._host = torch.empty(buf.shape, dtype=torch.uint8,
                                     pin_memory=True)
            self._host.copy_(buf, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = buf.clone()
        self._result = None

    def result(self):
        """The tree of numpy arrays (waits for the copy on a card)."""
        if self._result is None:
            if self._event is not None:
                self._event.synchronize()
            raw = self._host.numpy()
            out, o = [], 0
            for shape, dtype in self._meta:
                nd = torch.empty(0, dtype=dtype).numpy().dtype
                n = int(np.prod(shape)) * nd.itemsize
                out.append(raw[o:o + n].copy().view(nd).reshape(shape))
                o += n
            self._result = _rebuild(self._tree, iter(out))
            self._tree = self._host = None
        return self._result
