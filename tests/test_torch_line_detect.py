"""The port's native line detector (frontend/line_extract.py), its offline
writer (io/stored_lines.precompute_sequence) and the tracker's native line
route against the JAX package, on the CPU.

Inputs: the synthetic renders of tests/test_lines_frontend.py (512x384,
anti-aliased segments over noise) and, for the tracker, the seed-3 line
corridor of bench.py at 640x240.

What is exact and what is not:
- the Sobel taps are summed in XLA's order and every product is exact, so
  the gradients are bit-equal; `_bilinear` is bit-equal; `_lbd_descriptor`
  on the same inputs is within 1e-5;
- `atan2` differs from XLA's in the last ulp on about 13% of the pixels
  (26,449 of 196,608 on the first render). An ulp can move a pixel into
  another (rho, phi) bin, or across the support band of a line (the
  orientation gate of 2.5 bins). The test
  counts such flipped pixels and bounds them; only the lines a flipped
  pixel feeds may differ, to 0.5 px and a descriptor distance of 0.02;
- every other line keeps its slot, validity and length, endpoints within
  1e-3 px and descriptors within 1e-5 + 0.5 x its endpoint difference
  (px). The descriptor bound is not a flat 1e-5: the JAX package sums each
  line's support weights over all H*W pixels in float32, in XLA's order,
  which leaves its endpoints 1-2 ulp (up to 7.6e-5 px here) from the
  port's, and the band descriptor, sampled along the segment, moves by up
  to 2.3e-5 for that (the descriptor alone on equal endpoints agrees to
  7e-6).
"""
import math
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from bench import _make_sequence  # noqa: E402
from test_lines_frontend import CAM as RENDER_CAM  # noqa: E402
from test_lines_frontend import _render_segments, _segs3d  # noqa: E402
from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import LineConfig as JLineConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.config import TrackingConfig as JTrackingConfig  # noqa: E402
from lldslam_tpu.frontend import line_extract as jle  # noqa: E402
from lldslam_tpu.io import stored_lines as jsl  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.system import System as JSystem  # noqa: E402
from lldslam_tpu_torch.config import (CameraConfig, LineConfig,  # noqa: E402
                                      SlamConfig, TrackingConfig)
from lldslam_tpu_torch.frontend import line_extract as tle  # noqa: E402
from lldslam_tpu_torch.io import stored_lines as tsl  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.pipeline.tracker import StereoTracker  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402

torch.set_num_threads(2)

# a line's descriptor moves with the endpoints it samples along
STRICT_PX, DESC_BASE, DESC_PER_PX = 1e-3, 1e-5, 0.5
FED_PX, FED_DESC = 0.5, 0.02
MAX_FLIP_SHARE = 1e-3       # of the edge pixels


def _render(case):
    """The renders of tests/test_lines_frontend.py: its detection test
    (seed 5), the moved view of its descriptor test (seed 6) and the right
    view of its stereo test (seed 7)."""
    eye = np.eye(4, dtype=np.float32)
    if case == "segments":
        return _render_segments(_segs3d(np.random.default_rng(5)), eye)[0]
    if case == "moved":
        T1 = eye.copy()
        T1[:3, 3] = [0.05, 0.0, -0.1]
        return _render_segments(_segs3d(np.random.default_rng(6), 4), T1)[0]
    T_r = eye.copy()
    T_r[0, 3] = -RENDER_CAM.baseline
    return _render_segments(_segs3d(np.random.default_rng(7)), T_r)[0]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_pixels(img, cfg):
    """The JAX detector's per-pixel quantities and peaks (its lines 72-113
    and 115-116, jitted as the detector is): gradients, phi, edge mask,
    flat bins, top-k peak indices, peak lines and their support masks."""
    H, W = img.shape
    diag = float(np.hypot(H, W))
    n_rho = int(np.ceil(diag / cfg.rho_res))

    @jax.jit
    def f(img):
        gx, gy = jle._sobel(img)
        mag = jnp.hypot(gx, gy)
        edge = mag > cfg.mag_factor * jnp.mean(mag)
        ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                              jnp.arange(W, dtype=jnp.float32), indexing="ij")
        phi = jnp.arctan2(gy, gx)
        phi = jnp.where(phi < 0, phi + jnp.pi, phi)
        phi = jnp.where(phi >= jnp.pi, phi - jnp.pi, phi)
        rho = xs * jnp.cos(phi) + ys * jnp.sin(phi)
        pi_bin = jnp.clip((phi / jnp.pi * cfg.n_phi).astype(jnp.int32), 0,
                          cfg.n_phi - 1)
        r_bin = jnp.clip(((rho + diag) / cfg.rho_res / 2.0).astype(jnp.int32),
                         0, n_rho - 1)
        acc = jnp.zeros((n_rho, cfg.n_phi), jnp.float32).at[
            r_bin.reshape(-1), pi_bin.reshape(-1)].add(
            jnp.where(edge, mag, 0.0).reshape(-1))
        accp = jnp.pad(acc, ((1, 1), (0, 0)))
        accp = jnp.concatenate([accp[:, -1:], accp, accp[:, :1]], axis=1)
        win = jax.lax.reduce_window(accp, -jnp.inf, jax.lax.max, (3, 3),
                                    (1, 1), "VALID")
        peaks = jnp.where((acc >= win) & (acc >= cfg.min_support), acc, 0.0)
        _, flat_idx = jax.lax.top_k(peaks.reshape(-1), cfg.max_lines)
        rho_k = ((flat_idx // cfg.n_phi).astype(jnp.float32) + 0.5) \
            * cfg.rho_res * 2.0 - diag
        phi_k = ((flat_idx % cfg.n_phi).astype(jnp.float32) + 0.5) \
            * jnp.pi / cfg.n_phi
        d_line = (xs.reshape(-1)[None] * jnp.cos(phi_k)[:, None]
                  + ys.reshape(-1)[None] * jnp.sin(phi_k)[:, None]
                  - rho_k[:, None])
        dphi = jnp.abs(phi.reshape(-1)[None] - phi_k[:, None])
        dphi = jnp.minimum(dphi, jnp.pi - dphi)
        support = (jnp.abs(d_line) < 1.5 * cfg.rho_res) \
            & (dphi < 2.5 * jnp.pi / cfg.n_phi) & edge.reshape(-1)[None]
        return (gx, gy, phi, edge, r_bin * cfg.n_phi + pi_bin, flat_idx,
                rho_k, phi_k, support)
    return [np.asarray(x) for x in f(jnp.asarray(img))]


def _fed_lines(img, L):
    """Per slot: is the line fed by a pixel that an atan2 ulp moved into
    another bin or across its support band? Also the flipped-pixel count
    and the edge-pixel count."""
    cfg = tle.LineDetConfig(max_lines=L)
    (gx_j, gy_j, phi_j, edge_j, bins_j, flat_idx, rho_k, phi_k,
     sup_j) = _jax_pixels(img, jle.LineDetConfig(max_lines=L))
    gx, gy, _, edge, phi, bins, _ = tle._votes(_t(img), cfg)
    assert np.array_equal(gx.numpy(), gx_j) and np.array_equal(gy.numpy(),
                                                               gy_j)
    assert np.array_equal(edge.numpy(), edge_j)
    H, W = img.shape
    xs = torch.arange(W, dtype=torch.float32).repeat(H)[None]
    ys = torch.arange(H, dtype=torch.float32).repeat_interleave(W)[None]
    pk = _t(phi_k)
    sup_t = tle._support(xs, ys, phi.reshape(1, -1), edge.reshape(1, -1),
                         _t(rho_k), torch.cos(pk), torch.sin(pk), pk,
                         cfg).numpy()
    sup_flip = (sup_t != sup_j)
    fed = sup_flip.any(-1)
    moved = np.nonzero(edge_j & (bins.numpy() != bins_j))
    n_phi = cfg.n_phi
    for b in np.concatenate([bins_j[moved], bins.numpy()[moved]]):
        # a moved vote changes two bins, and with them the 3x3 NMS windows
        # and the top-k order around them
        dr = np.abs(flat_idx // n_phi - b // n_phi)
        dp = np.abs(flat_idx % n_phi - b % n_phi)
        fed |= (dr <= 1) & (np.minimum(dp, n_phi - dp) <= 1)
    n_flip = int(sup_flip.any(0).sum()) + len(moved[0])
    return fed, n_flip, int(edge_j.sum()), np.abs(phi.numpy() - phi_j).max()


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("case", ["segments", "moved", "right"])
def test_detect_lines_matches_jax(case, L):
    img = _render(case)
    kj = [np.asarray(x) for x in jle.detect_lines(
        jnp.asarray(img), jle.LineDetConfig(max_lines=L))]
    kt = [x.numpy() for x in tle.detect_lines(
        _t(img), tle.LineDetConfig(max_lines=L))]
    fed, n_flip, n_edge, dphi = _fed_lines(img, L)
    p1j, p2j, octj, lenj, descj, vj = kj
    p1t, p2t, octt, lent, desct, vt = kt
    ep = np.maximum(np.abs(p1t - p1j).max(-1), np.abs(p2t - p2j).max(-1))
    dd = np.abs(desct - descj).max(-1)
    dist = np.linalg.norm(desct - descj, axis=-1)
    print(f"{case} L={L}: {vj.sum()} lines; {n_flip} flipped of {n_edge} "
          f"edge pixels (phi within {dphi:.2e} rad); lines fed by one "
          f"{np.nonzero(fed & (vj | vt))[0].tolist()}; unfed: endpoints "
          f"within {ep[~fed].max():.2e} px, descriptors {dd[~fed].max():.2e}")
    assert vj.sum() >= 4
    assert n_flip <= MAX_FLIP_SHARE * n_edge
    assert np.array_equal(octt, octj)
    strict = ~fed
    assert np.array_equal(vt[strict], vj[strict])
    np.testing.assert_allclose(lent[strict], lenj[strict], rtol=0,
                               atol=STRICT_PX)
    assert ep[strict].max() <= STRICT_PX
    assert (dd[strict] <= DESC_BASE + DESC_PER_PX * ep[strict]).all()
    both = fed & vj & vt
    assert (ep[both] <= FED_PX).all() and (dist[both] <= FED_DESC).all()
    assert (fed & (vj != vt)).sum() <= 1


def test_sobel_bilinear_and_descriptor_match_jax():
    """`_sobel` and `_bilinear` bit-equal to the JAX functions;
    `_lbd_descriptor` within 1e-5 of the JAX one on the JAX detector's own
    endpoints and gradients."""
    img = _render("segments")
    cfg = jle.LineDetConfig(max_lines=64)
    gx, gy = jax.jit(jle._sobel)(jnp.asarray(img))
    tx, ty = tle._sobel(_t(img))
    assert np.array_equal(tx.numpy(), np.asarray(gx))
    assert np.array_equal(ty.numpy(), np.asarray(gy))
    rng = np.random.default_rng(0)
    x = rng.uniform(-3, 515, 4000).astype(np.float32)
    y = rng.uniform(-3, 387, 4000).astype(np.float32)
    assert np.array_equal(
        tle._bilinear(tx, _t(x), _t(y)).numpy(),
        np.asarray(jle._bilinear(gx, jnp.asarray(x), jnp.asarray(y))))
    kl = jle.detect_lines(jnp.asarray(img), cfg)
    dj = jax.jit(lambda *a: jle._lbd_descriptor(*a, cfg))(
        jnp.asarray(img), gx, gy, kl.p1, kl.p2)
    dt = tle._lbd_descriptor(_t(img), tx, ty, _t(kl.p1), _t(kl.p2),
                             tle.LineDetConfig(max_lines=64))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)


def test_support_chunks_change_nothing(monkeypatch):
    """The support pass in chunks of 32 (SUPPORT_CHUNK), 7 and all 64 peaks
    at once, alone and inside the detector: every output equal, bit for
    bit."""
    img = _t(_render("segments"))
    cfg = tle.LineDetConfig(max_lines=64)
    _, _, mag, edge, phi, _, _ = tle._votes(img, cfg)
    rng = np.random.default_rng(1)
    rho_k = _t(rng.uniform(-300, 300, 64).astype(np.float32))
    phi_k = _t(rng.uniform(0, math.pi, 64).astype(np.float32))
    # plus the detector's own peaks, whose supports are not empty
    kl = tle.detect_lines(img, cfg)
    assert kl.valid.sum() >= 4
    outs = [tle._support_fit(mag, edge, phi, rho_k, phi_k, cfg, c)
            for c in (32, 7, 64)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    monkeypatch.setattr(tle, "SUPPORT_CHUNK", 64)
    for a, b in zip(kl, tle.detect_lines(img, cfg)):
        assert torch.equal(a, b)


def test_top_k_orders_ties_by_index():
    """A crafted accumulator with runs of equal values and zeros: the port's
    `_top_k` gives jax.lax.top_k's values and indices (equal values by
    ascending index)."""
    x = np.zeros(600, np.float32)
    x[[5, 17, 40, 41, 300, 599]] = 7.5
    x[[3, 250, 251]] = 9.0
    x[[100, 7]] = 12.25
    x[500] = 3.0
    for k in (4, 9, 12, 64):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = tle._top_k(_t(x), k)
        assert np.array_equal(vt.numpy(), np.asarray(vj))
        assert np.array_equal(it.numpy(), np.asarray(ij)), (k, it, ij)


def test_accumulator_is_jax_scatter():
    """The vote on the CPU (`index_add_`, a serial loop) equals the JAX
    package's `.at[].add` on the same bins and weights, bit for bit."""
    img = _t(_render("moved"))
    cfg = tle.LineDetConfig()
    _, _, mag, edge, _, bins, n_rho = tle._votes(img, cfg)
    w = torch.where(edge, mag, 0.0).reshape(-1)
    n = n_rho * cfg.n_phi
    acc = tle._accumulate(bins.reshape(-1), w, n)
    want = jnp.zeros(n, jnp.float32).at[jnp.asarray(bins.reshape(-1).numpy())
                                        ].add(jnp.asarray(w.numpy()))
    assert np.array_equal(acc.numpy(), np.asarray(want))


class _Pairs:
    """A StereoSequence stand-in holding its frames."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return (*self.frames[i], 0.1 * i)


def test_precompute_sequence_matches_jax(tmp_path):
    """Both packages' `precompute_sequence` over two stereo render pairs:
    the files hold the same number of lines per view, within the detector's
    bounds; both packages' StoredLineSource read the port's files back to
    the port detector's own output exactly."""
    frames = [(_render("segments"), _render("right")),
              (_render("moved"), _render("segments"))]
    cfg = tle.LineDetConfig(max_lines=64)
    assert tsl.precompute_sequence(_Pairs(frames), tmp_path / "tl",
                                   tmp_path / "tr", cfg, device="cpu") == 2
    jsl.precompute_sequence(_Pairs(frames), tmp_path / "jl", tmp_path / "jr",
                            jle.LineDetConfig(max_lines=64))
    for f, (left, right) in enumerate(frames):
        for side, img in (("l", left), ("r", right)):
            zt = np.load(tmp_path / f"t{side}" / f"{f:06d}.npz")
            zj = np.load(tmp_path / f"j{side}" / f"{f:06d}.npz")
            assert len(zt["p1"]) == len(zj["p1"]) >= 4
            np.testing.assert_allclose(zt["p1"], zj["p1"], rtol=0,
                                       atol=STRICT_PX)
            ep = np.maximum(np.abs(zt["p1"] - zj["p1"]).max(-1),
                            np.abs(zt["p2"] - zj["p2"]).max(-1))
            assert (np.abs(zt["desc"] - zj["desc"]).max(-1)
                    <= DESC_BASE + DESC_PER_PX * ep).all()
            kl = tle.detect_lines(_t(img), cfg)
            valid = kl.valid.numpy()
            n = int(valid.sum())
            d = tmp_path / f"t{side}"
            for got in (tsl.StoredLineSource(d, cap=64).frame(f, "cpu"),
                        jsl.StoredLineSource(d, cap=64).frame(f)):
                got = [np.asarray(x) for x in got]
                assert got[5][:n].all() and got[5].sum() == n
                for k in (0, 1, 2, 4):      # p1, p2, octave, desc
                    np.testing.assert_array_equal(got[k][:n],
                                                  kl[k].numpy()[valid])


CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
           width=640, height=240)


def _port_cfg(md_thr, **kw):
    return SlamConfig(camera=CameraConfig(**CAM),
                      orb=OrbConfig(n_features=600), tracking=TrackingConfig(min_init_points=80),
                      line=LineConfig(ld_type="LBDFloat", md_thr=md_thr, **kw))


@pytest.mark.parametrize("md_thr,gate", [(4.0, 1.2), (0.6, 0.18)])
def test_native_route_maps_mdthr(md_thr, gate):
    """ldType LBDFloat without a detections path takes the native detector
    (no line source) with the JAX package's gate desc_thr * mdThr / 2 (the
    port of tests/test_stored_lines_route.py::test_native_route_maps_mdthr;
    mdThr 0.6 is mini KITTI's)."""
    tr = StereoTracker(_port_cfg(md_thr), enable_loops=False, device="cpu")
    assert tr._line_source is None
    assert tr.line_cfg.max_lines == tr.store.n_ln_det == 256
    assert tr._md_gate == pytest.approx(tr.line_cfg.desc_thr * md_thr / 2.0)
    assert tr._md_gate == pytest.approx(gate)


N_FRAMES = 8


def _count_detections(monkeypatch, module):
    """Wraps module.detect_lines; returns the list of valid counts."""
    fn, counts = module.detect_lines, []

    def wrapper(img, cfg):
        kl = fn(img, cfg)
        counts.append(int(np.asarray(kl.valid).sum()))
        return kl
    monkeypatch.setattr(module, "detect_lines", wrapper)
    return counts


def test_native_route_stereo_run_matches_jax(monkeypatch):
    """8 frames of the seed-3 line corridor (640x240, 600 features, loops
    off) through both Systems on the native detector route: every frame
    OK, the same keyframes, camera centres within 0.05 m, the detector's
    valid lines per view within 2 of JAX's, line matches per frame and
    valid map lines within 10% (tests/test_torch_lines_e2e.py's bounds)."""
    jcam = JCameraConfig(**CAM)
    frames, poses, _ = _make_sequence(jcam.stereo_camera(), N_FRAMES,
                                      n_per_m=25.0, seed=3, with_lines=True,
                                      return_poses=True)
    jcfg = JSlamConfig(camera=jcam, orb=JOrbConfig(n_features=600),
                       line=JLineConfig(ld_type="LBDFloat", md_thr=0.6),
                       tracking=JTrackingConfig(min_init_points=80))
    runs = []
    for make, module in ((lambda: JSystem(jcfg, enable_loops=False), jle),
                         (lambda: System(_port_cfg(0.6), enable_loops=False,
                                         device="cpu"), tle)):
        counts = _count_detections(monkeypatch, module)
        s = make()
        for i, (left, right) in enumerate(frames):
            s.track_stereo(left, right, timestamp=0.1 * i)
        tr = s.tracker
        assert tr._line_source is None
        runs.append(dict(
            T=tr.trajectory()[1], states=[m.state for m in tr.metrics],
            kfs=[m.frame_id for m in tr.metrics if m.new_kf],
            lm=np.array([m.n_line_matches for m in tr.metrics]),
            n_lines=int(np.asarray(s.map.ln_valid).sum()),
            det=np.array(counts)))
    j, t = runs
    dc = np.linalg.norm(t["T"][:, :3, 3] - j["T"][:, :3, 3], axis=-1)
    print(f"keyframes {j['kfs']} / {t['kfs']}; centres within {dc.max():.5f} "
          f"m; detections {j['det'].tolist()} / {t['det'].tolist()}; line "
          f"matches {j['lm'].tolist()} / {t['lm'].tolist()}; map lines "
          f"{j['n_lines']} / {t['n_lines']}")
    assert j["states"] == t["states"] == ["OK"] * N_FRAMES
    assert t["kfs"] == j["kfs"]
    assert dc.max() < 0.05
    assert len(t["det"]) == len(j["det"]) == 2 * N_FRAMES
    assert j["det"].min() >= 4
    assert np.abs(t["det"] - j["det"]).max() <= 2
    assert (np.abs(t["lm"] - j["lm"]) <= 0.10 * j["lm"]).all()
    assert abs(t["n_lines"] - j["n_lines"]) <= 0.10 * j["n_lines"]
