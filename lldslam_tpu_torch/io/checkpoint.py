"""Map checkpoint and restore.

Counterpart of lldslam_tpu/io/checkpoint.py, the same file format: one
compressed .npz holding every numpy array attribute of the MapStore (its
private observation-index caches included) plus the counters n_kf, n_pt and
n_ln under `__scalars__`. A map saved by either package loads into the
other's store; `extra_*` arrays the JAX package may add are skipped. Loading
marks the store's observation index stale, so it is rebuilt from the
restored observation table (the JAX package leaves a live store's flag as it
was).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..slammap.map_store import MapStore

_SCALARS = ("n_kf", "n_pt", "n_ln")


def save_map(store: MapStore, path: str | Path) -> None:
    arrays = {k: v for k, v in vars(store).items()
              if isinstance(v, np.ndarray)}
    np.savez_compressed(
        path, __scalars__=np.array([getattr(store, k) for k in _SCALARS],
                                   np.int64), **arrays)


def load_map(store: MapStore, path: str | Path) -> None:
    """Restore the arrays into an existing store: in place where the shape
    matches, else replacing the attribute (a store that grew)."""
    with np.load(path) as z:
        for k in z.files:
            if k == "__scalars__" or k.startswith("extra_"):
                continue
            dst = getattr(store, k, None)
            if isinstance(dst, np.ndarray) and dst.shape == z[k].shape:
                dst[...] = z[k]
            else:
                setattr(store, k, z[k])
        for name, val in zip(_SCALARS, z["__scalars__"]):
            setattr(store, name, int(val))
    store.mark_obs_dirty()
