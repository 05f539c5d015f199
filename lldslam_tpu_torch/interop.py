"""Carry state between the JAX package and this port, as numpy arrays.

The JAX package (lldslam_tpu) is the reference the port is held against; its
state converts here without importing JAX: every JAX array field is read
with `np.asarray`, and results go back as numpy arrays. uint32 descriptors
become int32 views (torch.uint32 has no bitwise ops on the CPU) and back.

Covered: FrameFeatures and FrameData, MapPointView, the MapStore arrays, and
StereoCamera / OrbConfig / SlamConfig given as field dicts.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .config import CameraConfig, LineConfig, SlamConfig, TrackingConfig
from .frontend.frame import FrameData
from .frontend.matching import FrameFeatures, MapPointView
from .geometry.camera import StereoCamera
from .ops.orb import Keypoints, OrbConfig
from .slammap.map_store import MapStore

_DESC_FIELDS = ("desc",)


def _to_tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _DESC_FIELDS and a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.int64 and name in ("octave",):
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in _DESC_FIELDS and a.dtype == np.int32:
        a = a.view(np.uint32)
    return a


def _convert(cls, src, device):
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k))
    return cls(**{k: _to_tensor(k, get(k), device) for k in cls._fields})


def frame_features(src, device="cpu") -> FrameFeatures:
    """JAX FrameFeatures (or a dict of its fields) -> port tensors."""
    return _convert(FrameFeatures, src, device)


def keypoints(src, device="cpu") -> Keypoints:
    """JAX orb.Keypoints (any leading view dims) -> port tensors."""
    return _convert(Keypoints, src, device)


def frame_data(src, device="cpu") -> FrameData:
    """JAX FrameData -> port FrameData. The JAX `right` holds one view's
    Keypoints, as the port's does."""
    return FrameData(feats=frame_features(src.feats, device),
                     depth=_to_tensor("depth", src.depth, device),
                     right=keypoints(src.right, device))


def map_point_view(src, device="cpu") -> MapPointView:
    """JAX MapPointView (or a dict of its fields) -> port tensors."""
    return _convert(MapPointView, src, device)


def to_numpy(nt) -> dict:
    """Port NamedTuple of tensors (nested NamedTuples allowed) -> dict of
    numpy arrays, descriptors as uint32."""
    out = {}
    for k, v in nt._asdict().items():
        out[k] = to_numpy(v) if hasattr(v, "_asdict") else _to_numpy(k, v)
    return out


def map_store(src, cam: StereoCamera, orb: OrbConfig) -> MapStore:
    """A port MapStore holding copies of every numpy array (and the counters)
    of a JAX MapStore."""
    dst = MapStore(cam, orb, max_kf=src.max_kf, max_pt=src.max_pt,
                   max_ln=src.max_ln, n_ln_det=src.n_ln_det,
                   ln_desc_dim=src.ln_desc.shape[1])
    for name, val in vars(dst).items():
        if isinstance(val, np.ndarray) and hasattr(src, name):
            setattr(dst, name, np.array(getattr(src, name), copy=True))
    for name in ("n_kf", "n_pt", "n_ln"):
        setattr(dst, name, int(getattr(src, name)))
    dst.loop_edges = list(src.loop_edges)
    dst.mark_obs_dirty()
    return dst


def map_store_arrays(store: MapStore) -> dict:
    """The numpy arrays of a (port) MapStore, for the way back."""
    return {k: v for k, v in vars(store).items() if isinstance(v, np.ndarray)
            and not k.startswith("_")}


def stereo_camera(d: dict) -> StereoCamera:
    return StereoCamera(**{k: d[k] for k in StereoCamera._fields})


def orb_config(d: dict) -> OrbConfig:
    return OrbConfig(**{f.name: d[f.name] for f in fields(OrbConfig)
                        if f.name in d})


def slam_config(d: dict) -> SlamConfig:
    """SlamConfig from a field dict whose sub-configs are field dicts too
    (e.g. dataclasses.asdict of the JAX package's SlamConfig)."""
    sub = lambda cls, x: cls(**{f.name: x[f.name] for f in fields(cls)
                                if f.name in x})
    return SlamConfig(camera=sub(CameraConfig, d["camera"]),
                      orb=orb_config(d["orb"]),
                      line=sub(LineConfig, d["line"]),
                      tracking=sub(TrackingConfig, d["tracking"]))
