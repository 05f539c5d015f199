"""Typed configuration covering the reference's full YAML key inventory.

Counterpart of lldslam_tpu/config.py (host-side Python, copied unchanged).

The reference reads one OpenCV `cv::FileStorage` YAML per sequence
(Tracking.cc:64-170; key inventory in SURVEY.md §5.6). This module provides
the same surface as a frozen dataclass tree plus a dependency-free parser for
those OpenCV-flavored YAML files (`%YAML:1.0` header, `!!opencv-matrix` tags),
so the reference's own config files (e.g. Examples/Stereo/KITTI04-12_LBD.yaml)
load unchanged.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from pathlib import Path

from .geometry.camera import StereoCamera
from .ops.orb import OrbConfig


@dataclass(frozen=True)
class CameraConfig:
    """Camera.* block (Tracking.cc:67-117)."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 386.1448
    fps: float = 10.0
    rgb: int = 1
    width: int = 1241
    height: int = 376

    def stereo_camera(self) -> StereoCamera:
        return StereoCamera(
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            bf=self.bf, width=self.width, height=self.height,
        )


@dataclass(frozen=True)
class LineConfig:
    """Line-feature block (Tracking.cc:162-169, KITTI04-12_LBD.yaml:70-77)."""

    ld_type: str = "empty"          # `LBDFloat` | `empty` (lines off)
    md_thr: float = 2.0             # descriptor distance gate (Tracking.cc:1092)
    gamma: float = 0.5              # line-vs-point weight (Optimizer.cc:702-708)
    min_line_len: float = 25.0      # px (TwoFrameLineMatcher.cc:86-91)
    max_in_cell: int = 5            # Hough grid cap (intent of D1, SURVEY.md §2.4)
    detections_path: str = ""       # stored-line dirs, `$SSS` seq substitution
    descriptors_path: str = ""
    mapping_thr: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.ld_type.lower() not in ("", "empty")


@dataclass(frozen=True)
class TrackingConfig:
    """Keyframe / depth policy (Tracking.cc:149, 1223-1310)."""

    th_depth: float = 35.0          # close-point threshold in baselines
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 10  # reference uses fps
    min_init_points: int = 250       # stereo init gate (Tracking.cc:523, tuned)
    min_track_inliers: int = 15      # TrackLocalMap pass (Tracking.cc:1206)
    min_motion_matches: int = 7      # motion-model success (Tracking.cc:992)


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    line: LineConfig = field(default_factory=LineConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)

    @property
    def close_depth(self) -> float:
        """mThDepth = bf * ThDepth / fx (Tracking.cc:149): meters."""
        return self.camera.bf * self.tracking.th_depth / self.camera.fx


# ---------------------------------------------------------------------------
# OpenCV FileStorage YAML parsing (no external deps)
# ---------------------------------------------------------------------------

def parse_opencv_yaml(path: str | Path) -> dict:
    """Parse the subset of OpenCV YAML the reference configs use: flat
    `Key.Sub: value` scalars plus `!!opencv-matrix` blocks with `data: [...]`.
    Returns a flat dict; matrix keys map to (rows, cols, list-of-floats)."""
    text = Path(path).read_text()
    out: dict = {}
    # matrix blocks: Key: !!opencv-matrix \n rows.. cols.. dt.. data: [ ... ]
    mat_re = re.compile(
        r"^(\w[\w.]*):\s*!!opencv-matrix\s*\n"
        r"\s*rows:\s*(\d+)\s*\n\s*cols:\s*(\d+)\s*\n\s*dt:\s*\w+\s*\n"
        r"\s*data:\s*\[([^\]]*)\]",
        re.M,
    )
    for m in mat_re.finditer(text):
        vals = [float(x) for x in m.group(4).replace("\n", " ").split(",") if x.strip()]
        out[m.group(1)] = (int(m.group(2)), int(m.group(3)), vals)
    text = mat_re.sub("", text)
    for line in text.splitlines():
        line = line.split("#", 1)[0].rstrip()
        m = re.match(r"^([\w][\w.]*):\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith('"') and val.endswith('"'):
            out[key] = val[1:-1]
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def load_config(path: str | Path, sequence: str | None = None) -> SlamConfig:
    """Build a SlamConfig from a reference-format YAML file.

    `sequence` substitutes `$SSS` in the stored-line paths
    (stereo_kitti.cc usage of lineDetectionsPath)."""
    d = parse_opencv_yaml(path)

    def g(key, default):
        return d.get(key, default)

    cam = CameraConfig(
        fx=float(g("Camera.fx", 718.856)), fy=float(g("Camera.fy", 718.856)),
        cx=float(g("Camera.cx", 607.1928)), cy=float(g("Camera.cy", 185.2157)),
        k1=float(g("Camera.k1", 0.0)), k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)), p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        bf=float(g("Camera.bf", 386.1448)), fps=float(g("Camera.fps", 10.0)),
        rgb=int(g("Camera.RGB", 1)),
        width=int(g("Camera.width", 1241)), height=int(g("Camera.height", 376)),
    )
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 2000)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        scale=float(g("ORBextractor.scaleFactor", 1.2)),
        ini_th=float(g("ORBextractor.iniThFAST", 20)),
        min_th=float(g("ORBextractor.minThFAST", 7)),
    )
    det = str(g("lineDetectionsPath", ""))
    desc = str(g("lineDescriptorsPath", ""))
    if sequence is not None:
        det = det.replace("$SSS", sequence)
        desc = desc.replace("$SSS", sequence)
    # relative stored-line paths resolve against the YAML's directory (lets
    # a sequence ship its settings + line files as one self-contained dir)
    base = Path(path).parent
    if det and not Path(det).is_absolute():
        det = str(base / det)
    if desc and not Path(desc).is_absolute():
        desc = str(base / desc)
    line = LineConfig(
        ld_type=str(g("ldType", "empty")),
        md_thr=float(g("mdThr", 2.0)),
        gamma=float(g("gamma", 0.5)),
        min_line_len=float(g("minLineLen", 25.0)),
        max_in_cell=int(g("maxInCell", 5)),
        detections_path=det,
        descriptors_path=desc,
        mapping_thr=float(g("mappingThr", 0.0)),
    )
    tracking = TrackingConfig(
        th_depth=float(g("ThDepth", 35.0)),
        max_frames_between_kf=int(g("Camera.fps", 10)),
        # extension keys (not in the reference YAMLs): small-resolution
        # sequences need smaller init/track gates than KITTI's defaults
        min_init_points=int(g("minInitPoints", 250)),
        min_track_inliers=int(g("minTrackInliers", 15)),
    )
    return SlamConfig(camera=cam, orb=orb, line=line, tracking=tracking)
