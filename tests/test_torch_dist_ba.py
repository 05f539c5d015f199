"""CPU parity of the port's distributed bundle adjustment with the JAX
package: the landmark-sharded Schur BA (`parallel/dist_schur.py`: layout,
point and joint point+line solves), the observation-sharded BA
(`parallel/sharded_ba.py`), the loop closer's distributed global BA and its
standalone line refinement, and the driver entry (`graft_entry.py`).

The port's mesh is a torch.distributed process group: a one-rank gloo
group in this process (`dist_schur.make_mesh(device="cpu")`), or two gloo
ranks spawned on the CPU (`parallel.ranks.run_ranks`). The JAX side runs on
the 8 virtual CPU devices of tests/conftest.py. Inputs are made with numpy
from seeds. Layouts are integer bookkeeping and held exactly; solver
results are held to the JAX package's own distributed-against-single bounds
(tests/test_parallel.py): float32 sums run in another order in the two
frameworks, and in another order across ranks.
"""
import copy
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_lines_ba import CAM as JLCAM, _make_problem  # noqa: E402
from test_parallel import CAM as JCAM, _problem  # noqa: E402
from test_torch_lines import RING_CFG, _loop_stores  # noqa: E402
from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.geometry import lines as jgl  # noqa: E402
from lldslam_tpu.loop import closing as jcl  # noqa: E402
from lldslam_tpu.loop.bow import Vocabulary as JVocabulary  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.parallel import dist_schur as jds  # noqa: E402
from lldslam_tpu.parallel import sharded_ba as jsb  # noqa: E402
from lldslam_tpu_torch import graft_entry, interop  # noqa: E402
from lldslam_tpu_torch.geometry import lines as tgl  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.loop import closing as tcl  # noqa: E402
from lldslam_tpu_torch.optim import ba as tba, lines_ba as tlb  # noqa: E402
from lldslam_tpu_torch.parallel import dist_schur as tds  # noqa: E402
from lldslam_tpu_torch.parallel import sharded_ba as tsb  # noqa: E402
from lldslam_tpu_torch.parallel.ranks import run_ranks  # noqa: E402

torch.set_num_threads(2)

CAM, LCAM = StereoCamera(*JCAM), StereoCamera(*JLCAM)
IT = dict(iters=3, cg_iters=16)     # tests/test_parallel.py's schedule
# tests/test_parallel.py:70-95, 249-290: poses, joint poses, points, chi2,
# line X0, 1 - |cos| of line directions
B = dict(pose=2e-4, pose_joint=3e-4, point=3e-3, chi2=5e-2, x0=5e-3,
         cos=1e-5)
# tests/test_parallel.py:242-247 (global BA): poses, points (m); line X0
# relative
GBA = dict(pose=2e-3, point=2e-2, x0=1e-3)
JCFG = JSlamConfig(camera=JCameraConfig(**RING_CFG),
                   orb=JOrbConfig(n_features=600))


@pytest.fixture(scope="module")
def group():
    """The one-rank gloo group of this process (torn down after the
    module if the module made it)."""
    made = not dist.is_initialized()
    g = tds.make_mesh(device="cpu")
    yield g
    if made:
        dist.destroy_process_group()


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _points_problem():
    """tests/test_parallel.py's dist problem, every 7th observation
    invalid (the layout drops it)."""
    problem, _ = _problem(O=768, K=8, P=160)
    valid = np.arange(768) % 7 != 0
    return problem._replace(obs=problem.obs._replace(
        valid=jnp.asarray(valid)))


def _joint_problem():
    problem, *_ = _make_problem(np.random.default_rng(3), K=6, P=48, L=10)
    return problem


def _equal_trees(got, want):
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _equal_trees(g, w)
        else:
            assert np.array_equal(_n(g), np.asarray(w)), (g, w)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_layout_matches_jax(n):
    """make_dist_problem and make_dist_joint_problem for n shards: every
    array (padded points and lines, rank-local indices, dropped invalid
    rows), obs_src and lobs_src exactly the JAX package's."""
    jp = _points_problem()
    jdp, jsrc = jds.make_dist_problem(jp, n)
    tdp, tsrc = tds.make_dist_problem(interop.ba_problem(jp), n)
    assert tdp.n_shards == n and np.array_equal(tsrc, jsrc)
    _equal_trees(tdp[:5], jdp)
    assert (jsrc < 0).sum() > 0 and len(jsrc) % (8 * n) == 0
    jj = _joint_problem()
    jdj, jos, jls = jds.make_dist_joint_problem(jj, n)
    tdj, tos, tls = tds.make_dist_joint_problem(interop.joint_problem(jj), n)
    assert np.array_equal(tos, jos) and np.array_equal(tls, jls)
    _equal_trees(tdj.base[:5], jdj.base)
    _equal_trees(tdj[1:], jdj[1:])


def _close(got, want, tol):
    err = np.abs(_n(got) - np.asarray(want)).max()
    assert err <= tol, (err, tol)


def _chi2_back(chi2, src, n_obs):
    out = np.zeros(n_obs, np.float32)
    m = src >= 0
    out[src[m]] = _n(chi2)[m]
    return out


def _same_lines(q, a, q_ref, a_ref, across: bool):
    """Line X0 within 5e-3 m of the reference (within one framework, the
    JAX package's bound) or within 1e-3 x max(1, |X0|) (across the two
    frameworks, the bound of tests/test_torch_lines.py's joint BA parity:
    at this 3 x 16 schedule the two packages' single-device joint solves
    already differ by more than 5e-3 m on the farther lines); directions
    within 1e-5 of parallel."""
    X0, d = (_n(x) for x in tgl.x0dir_from_minimal(torch.as_tensor(q),
                                                     torch.as_tensor(a)))
    X0r, dr = (np.asarray(x) for x in jgl.x0dir_from_minimal(
        jnp.asarray(q_ref), jnp.asarray(a_ref)))
    if across:
        scale = np.maximum(1.0, np.linalg.norm(X0r, axis=-1))
        err = (np.linalg.norm(X0 - X0r, axis=-1) / scale).max()
        assert err <= GBA["x0"], err
    else:
        _close(X0, X0r, B["x0"])
    assert np.abs(np.sum(d * dr, -1)).min() > 1 - B["cos"]


def _jax_points(n):
    jp = _points_problem()
    mesh = jds.make_mesh(n)
    jdp, src = jds.make_dist_problem(jp, n)
    poses, points, chi2 = jds.dist_ba_solve(
        JCAM, jds.place(jdp, mesh), mesh, **IT)
    return jp, src, np.asarray(poses), np.asarray(points), np.asarray(chi2)


def _jax_joint(n):
    jj = _joint_problem()
    mesh = jds.make_mesh(n)
    jdj, src, _ = jds.make_dist_joint_problem(jj, n)
    out = jds.dist_joint_ba_solve(JLCAM, jds.place_joint(jdj, mesh), mesh,
                                  **IT)
    return (jj, src, *map(np.asarray, out))


def _jax_sharded(n):
    jp = _points_problem()
    solved, chi2 = jsb.ba_solve_sharded(JCAM, jp, jsb.make_mesh(n), **IT)
    return np.asarray(solved.poses), np.asarray(solved.points)


def _check_points(jax_out, poses, points, chi2):
    jp, src, jposes, jpoints, jchi2 = jax_out
    P, O = jp.points.shape[0], jp.obs.k.shape[0]
    _close(poses, jposes, B["pose"])
    _close(_n(points)[:P], jpoints[:P], B["point"])
    _close(_chi2_back(chi2, src, O), _chi2_back(jchi2, src, O), B["chi2"])


def _check_joint(ref, poses, points, q, alpha, across=True):
    jj, _, jposes, jpoints, jq, ja, _ = ref
    P, L = jj.base.points.shape[0], jj.q.shape[0]
    _close(poses, jposes, B["pose_joint"])
    _close(_n(points)[:P], jpoints[:P], B["point"])
    _same_lines(_n(q)[:L], _n(alpha)[:L], jq[:L], ja[:L], across)


@pytest.mark.parametrize("solver", ["points", "joint", "sharded"])
def test_world_one_solvers_match_jax(group, solver):
    """At world 1 (a one-rank gloo group): dist_ba_solve, dist_joint_ba_solve
    and ba_solve_sharded against the JAX package's solvers on a one-device
    mesh, and against the port's single-device ba_solve /
    joint_ba_solve_cg, within the JAX package's bounds; the point solve
    makes 2 + 1 + 16 + 2 all_reduce calls an LM iteration."""
    if solver == "points":
        ref = _jax_points(1)
        tp = interop.ba_problem(ref[0])
        dp, src = tds.make_dist_problem(tp, 1)
        before = tds.all_reduce_calls
        poses, points, chi2 = tds.dist_ba_solve(
            CAM, tds.place(dp, group, "cpu"), group, **IT)
        assert tds.all_reduce_calls - before == 3 * 21
        _check_points(ref, poses, points, chi2)
        single, chi2_1 = tba.ba_solve(CAM, tp, **IT)
        _check_points((ref[0], src, _n(single.poses), _n(single.points),
                       _n(chi2_1)[np.maximum(src, 0)]), poses, points, chi2)
    elif solver == "joint":
        ref = _jax_joint(1)
        tj = interop.joint_problem(ref[0])
        djp, _, _ = tds.make_dist_joint_problem(tj, 1)
        poses, points, q, alpha, _ = tds.dist_joint_ba_solve(
            LCAM, tds.place_joint(djp, group, "cpu"), group, **IT)
        _check_joint(ref, poses, points, q, alpha)
        single, _, _ = tlb.joint_ba_solve_cg(LCAM, tj, **IT)
        _check_joint((*ref[:2], _n(single.base.poses), _n(single.base.points),
                      _n(single.q), _n(single.alpha), None),
                     poses, points, q, alpha, across=False)
    else:
        jposes, jpoints = _jax_sharded(1)
        solved, chi2 = tsb.ba_solve_sharded(
            CAM, interop.ba_problem(_points_problem()), group, **IT)
        _close(solved.poses, jposes, B["pose"])
        _close(solved.points, jpoints, B["point"])
        assert chi2.shape == (768,)


def _tree_np(nt):
    return type(nt)(*(_tree_np(x) if isinstance(x, tuple) else _n(x)
                      for x in nt))


def _tree_torch(nt):
    return type(nt)(*(_tree_torch(x) if isinstance(x, tuple)
                      else torch.from_numpy(x) for x in nt))


def _stores_state(s):
    return dict(poses=s.kf_pose[:s.n_kf].copy(),
                points=s.pt_pos[:s.n_pt].copy(),
                x0=s.ln_x0[:s.n_ln].copy(), d=s.ln_dir[:s.n_ln].copy())


def _loop_lines_closer(device):
    """The port's loop map with map lines (io.synthetic) and a loop closer
    on it; the closer's vocabulary is unused by global BA."""
    from lldslam_tpu_torch.config import CameraConfig, SlamConfig
    from lldslam_tpu_torch.io.synthetic import add_loop_lines, make_loop_map
    from lldslam_tpu_torch.ops.orb import OrbConfig
    from lldslam_tpu_torch.slammap.map_store import MapStore
    from lldslam_tpu_torch.system import _default_vocabulary

    cfg = SlamConfig(camera=CameraConfig(**RING_CFG),
                     orb=OrbConfig(n_features=600))
    store = MapStore(cfg.camera.stereo_camera(), cfg.orb, max_kf=64,
                     max_pt=20000)
    add_loop_lines(store, make_loop_map(store))
    return tcl.LoopCloser(store, _default_vocabulary(), cfg, device=device)


def _two_rank_worker(rank, device, problem, joint):
    """One of two gloo ranks: the three solvers on the given problems
    (results assembled on every rank), then the loop closer's global BA on
    the loop-lines map, routed by the world size."""
    torch.set_num_threads(2)
    problem, joint = _tree_torch(problem), _tree_torch(joint)
    group = tds.make_mesh(device=device)
    dp, _ = tds.make_dist_problem(problem, 2)
    poses, points, chi2 = tds.dist_ba_solve(
        CAM, tds.place(dp, group, device), group, **IT)
    points, chi2 = tds.assemble(group, points, chi2)
    djp, _, _ = tds.make_dist_joint_problem(joint, 2)
    jposes, jpoints, q, alpha, _ = tds.dist_joint_ba_solve(
        LCAM, tds.place_joint(djp, group, device), group, **IT)
    jpoints, q, alpha = tds.assemble(group, jpoints, q, alpha)
    solved, _ = tsb.ba_solve_sharded(CAM, problem, group, **IT)
    lc = _loop_lines_closer(device)
    lc.global_ba()
    return dict(points=tuple(map(_n, (poses, points, chi2))),
                joint=tuple(map(_n, (jposes, jpoints, q, alpha))),
                sharded=(_n(solved.poses), _n(solved.points)),
                gba=_stores_state(lc.store))


def _check_gba(got: dict, want: dict, x0_tol: float):
    _close(got["poses"], want["poses"], GBA["pose"])
    _close(got["points"], want["points"], GBA["point"])
    scale = np.maximum(1.0, np.linalg.norm(want["x0"], axis=-1))
    ex = np.linalg.norm(got["x0"] - want["x0"], axis=-1) / scale
    assert ex.max(initial=0.0) <= x0_tol, ex.max()
    ed = np.abs(np.abs(np.sum(got["d"] * want["d"], -1)) - 1.0)
    assert ed.max(initial=0.0) <= x0_tol, ed.max()


def test_two_ranks_match_jax_and_each_other():
    """Two gloo ranks spawned on the CPU: dist_ba_solve,
    dist_joint_ba_solve and ba_solve_sharded against the JAX package's
    solvers on a two-device mesh within its bounds, and
    LoopCloser.global_ba() on the loop-lines map, which takes the
    distributed route because the world has two ranks, against the single
    route in this process (global-BA bounds). Every result, poses
    included, is bit-equal across the ranks."""
    jp, jj = _points_problem(), _joint_problem()
    out = run_ranks(_two_rank_worker, 2, "cpu", args=(
        _tree_np(interop.ba_problem(jp)), _tree_np(interop.joint_problem(jj))),
        timeout_s=240.0)
    for key in ("points", "joint", "sharded"):
        for a, b in zip(out[0][key], out[1][key]):
            assert np.array_equal(a, b), key
    for k, v in out[0]["gba"].items():
        assert np.array_equal(v, out[1]["gba"][k]), k
    _check_points(_jax_points(2), *out[0]["points"])
    _check_joint(_jax_joint(2), *out[0]["joint"])
    jposes, jpoints = _jax_sharded(2)
    _close(out[0]["sharded"][0], jposes, B["pose"])
    _close(out[0]["sharded"][1], jpoints, B["point"])
    lc = _loop_lines_closer("cpu")
    before = _stores_state(lc.store)
    lc.global_ba(force_dist=False)
    single = _stores_state(lc.store)
    _check_gba(out[0]["gba"], single, GBA["x0"])
    assert np.abs(single["x0"] - before["x0"]).max() > 1e-3


@pytest.mark.parametrize("lines", [False, True])
def test_global_ba_dist_matches_jax(group, monkeypatch, lines):
    """LoopCloser.global_ba(force_dist=True) on the seeded loop map (with
    and without map lines) at world 1, against the JAX package's
    global_ba(force_dist=True) and against the port's single route: poses
    within 2e-3 m, points within 2e-2 m, lines within 1e-3 relative (X0)
    and 1e-3 (1 - |cos|). The JAX side runs on its 8-device mesh without
    lines and on 2 devices with them: on 8, whole shards of the JAX
    package's line bucket hold only padding lines (X0 = 0), whose padded
    observation rows at keyframe 0's identity pose give NaN residuals that
    the zero weight does not cancel, and its poses come back NaN (ROADMAP
    section 3)."""
    js, ts, _, cfg = _loop_stores(lines)
    jv = JVocabulary.train(js.kf_desc[:4][js.kf_kp_valid[:4]], k=8, L=3,
                           seed=0)
    tv = interop.vocabulary(jv)
    ts_single = copy.deepcopy(ts)
    assert len(jax.devices()) == 8
    if lines:
        mesh = jds.make_mesh(2)
        monkeypatch.setattr(jds, "make_mesh", lambda *a, **k: mesh)
    jcl.LoopCloser(js, jv, JCFG).global_ba(force_dist=True)
    before = tds.all_reduce_calls
    tcl.LoopCloser(ts, tv, cfg, device="cpu").global_ba(force_dist=True)
    assert tds.all_reduce_calls - before == 10 * 69
    tcl.LoopCloser(ts_single, tv, cfg, device="cpu").global_ba(
        force_dist=False)
    dist_ = _stores_state(ts)
    _check_gba(dist_, _stores_state(js), GBA["x0"])
    _check_gba(dist_, _stores_state(ts_single), GBA["x0"])
    assert (ts.n_ln > 0) == lines


def test_global_line_refine_matches_jax():
    """LoopCloser._global_line_refine (fixed-pose line Gauss-Newton over
    the lines with >= 4 observations) on the loop-lines map: every map line
    within 1e-3 relative (X0) and 1e-3 (1 - |cos|) of the JAX package's, and
    the refinement moved them."""
    js, ts, _, cfg = _loop_stores(True)
    jv = JVocabulary.train(js.kf_desc[:4][js.kf_kp_valid[:4]], k=8, L=3,
                           seed=0)
    before = ts.ln_x0[:ts.n_ln].copy()
    jcl.LoopCloser(js, jv, JCFG)._global_line_refine()
    tcl.LoopCloser(ts, interop.vocabulary(jv), cfg,
                   device="cpu")._global_line_refine()
    got, want = _stores_state(ts), _stores_state(js)
    _check_gba(got, want, GBA["x0"])
    assert np.abs(got["x0"] - before).max() > 1e-3


def test_graft_entry_dryrun_and_entry():
    """graft_entry.dryrun_multichip(2, device="cpu") runs its three solvers
    on two gloo ranks, each rank checking finite results bit-equal across
    the ranks; entry() builds on the card, so without one it raises, and
    entry("cpu") builds the zero KITTI pair on the CPU (no keypoints)."""
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert len(out) == 2
    for k in ("poses", "poses_joint", "poses_sharded"):
        assert np.array_equal(out[0][k], out[1][k])
        assert np.isfinite(out[0][k]).all()
    if torch.cuda.is_available():
        fn, args = graft_entry.entry()
        assert args[0].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            graft_entry.entry()
    fn, args = graft_entry.entry("cpu")
    fd = fn(*args)
    assert tuple(args[0].shape) == (2, 376, 1241)
    assert not bool(fd.feats.valid.any())
