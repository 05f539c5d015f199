"""The numbers that decide `correct`, each held to its cell's limit.

Every number is a count or a distance between what the timed path produced
and what the plain reference (`reference.py`, `solve.py`) works out from
the benchmark's own inputs. The calls checked are a sample drawn from the
seed over the whole window (`probes.Captures`).

    lost_frames     frames (all of the run's, after the flush) whose
                    tracking state is not OK; the corridor never loses
                    tracking
    pose_gap_m      the largest distance (m) between the camera centre of
                    a checked point step's pose (in the points cells the
                    pose handed back for the frame, in the lines cells the
                    point step's, which the line step starts from) and that
                    of the pose that minimises the step's own cost over its
                    inliers (float64 Gauss-Newton); a step followed from
                    the program's state
    line_pose_gap_m the median over the checked frames of a lines cell of
                    the distance (m) between the camera centre of the pose
                    handed back and that of the float64 minimum of the joint
                    point+line pose step's cost (the point step's inliers,
                    the step's line inliers with their map lines; two
                    rounds, each classified, as the program states them)
    ba_excess       the largest relative excess, over the checked local
                    BAs of the window, of the BA's cost (Huber, over the
                    observations the BA kept as inliers) at the map the
                    program wrote (poses, points and, in the lines cells,
                    map lines) over its cost at the reference's float64
                    minimum, from the same window state
    pyramid_px_off  pixels of the integer pyramid and the rounded blur that
                    K1a read, against the reference's, of the checked calls
    k1a_rows_off    keypoints whose angle or BRIEF descriptor from K1a
                    differs from the reference's on its own pyramid
    k1b_rows_off    keypoints whose SAD disparity, cost or parabola offset
                    from K1b differs from the reference's on its own pyramid
    k2g_rows_off    rows whose best-2 from K2g differs from the reference's
                    on the call's own inputs
    line_wrong      stereo line matches (lines cells) whose two detections
                    are of different world segments

`ate` (the worst sequence's RMSE of camera centres against the generator's
true poses) is printed beside them and not compared: the control does not
move it (PERF.md). With `dtype` set, the judged side is the reference itself
computed in that precision (the control), in place of the program's
outputs.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from . import reference as ref
from . import solve as sv


def _frames_of(kept, frames, device):
    """The raw (S, 2, H, W) frames of a kept batched call, or None when its
    batch was not the frames handed over."""
    cur, S = kept["frames"], kept["args"][0].shape[0]
    if cur is None or len(cur) != S:
        return None
    return torch.stack([frames[s][i] for s, i in cur]).to(device)


def kernel_numbers(captures, frames, orb, device, dtype=None) -> dict:
    """pyramid_px_off, k1a/k1b/k2g_rows_off and how many calls of each were
    checked."""
    out = dict(pyramid_px_off=0, k1a_rows_off=0, k1b_rows_off=0,
               k2g_rows_off=0, checked_k1a=0, checked_k1b=0, checked_k2g=0)
    f32 = torch.float32
    for key in ("k1a", "k1b"):
        for kept in captures.kept[key]:
            raw = _frames_of(kept, frames, device)
            if raw is None:
                continue
            pyr, blr, hw = ref.build_stacks(raw, orb.n_levels, orb.scale, f32)
            a = kept["args"]
            if key == "k1a":
                xy, idx, image_hw = a[2], a[3], a[4]
                want = ref.describe(pyr, blr, xy, idx, image_hw)
                if dtype is None:
                    got = kept["out"]
                    stacks = (a[0], a[1])
                else:
                    lo = ref.build_stacks(raw, orb.n_levels, orb.scale, dtype)
                    got = ref.describe(lo[0], lo[1], xy, idx, image_hw,
                                       dtype)
                    stacks = lo[:2]
                out["pyramid_px_off"] += int(
                    (stacks[0].float() != pyr).sum()
                    + (stacks[1].float() != blr).sum())
                out["k1a_rows_off"] += ref.rows_off(got, want)
            else:
                lvl, ul, vl, ur = a[2], a[3], a[4], a[5]
                want = ref.sad_refine(pyr, a[1], lvl, ul, vl, ur)
                if dtype is None:
                    got = kept["out"]
                else:
                    lo = ref.build_stacks(raw, orb.n_levels, orb.scale, dtype)
                    got = ref.sad_refine(lo[0], a[1], lvl, ul, vl, ur, dtype)
                out["k1b_rows_off"] += ref.rows_off(got, want)
            out[f"checked_{key}"] += 1
            del pyr, blr
    for kept in captures.kept["k2g"]:
        a = kept["args"]
        want = ref.gated_best2(*a[:12])
        got = kept["out"] if dtype is None else ref.gated_best2(*a[:12],
                                                               dtype=dtype)
        out["k2g_rows_off"] += ref.rows_off(got, want)
        out["checked_k2g"] += 1
    return out


def _handed_back(captures, k, T, trackers):
    """(T with each frame's handed-back pose in place, which frames have
    one), or None when the kept call's batch was not the frames handed
    over."""
    if k["frames"] is None or len(k["frames"]) != T.shape[0]:
        return None
    back = [captures.finals.get((trackers[s], i)) for s, i in k["frames"]]
    have = torch.tensor([b is not None for b in back], device=T.device)
    T = torch.stack([torch.as_tensor(b, device=T.device)
                     if b is not None else t for b, t in zip(back, T)])
    return T, have


def pose_gap(captures, cam: dict, scale: float, dtype=None,
             trackers=None) -> tuple[float | None, int]:
    """(the largest distance (m) between the camera centre of a checked
    frame's pose and that of the pose minimising its tracking step's own
    cost over the step's own inliers, how many frames were checked). The
    pose judged is the one the program handed back for the frame
    (`trackers`: id of each sequence's tracker), or, without `trackers`,
    the step's own (the lines cells, whose handed-back pose is the line
    step's). The control runs the minimisation in `dtype` and is judged
    against float64."""
    worst, n = 0.0, 0
    for k in captures.kept["pose"]:
        T, X, xy, ur, octv = k["T"], k["X"], k["xy"], k["ur"], k["octave"]
        inlier = k["inlier"]
        if T.dim() == 2:
            T, X, xy, ur, octv, inlier = (a[None] for a in (
                T, X, xy, ur, octv, inlier))
        obs = torch.cat([xy, ur[..., None]], -1)
        info = sv.point_info(octv, scale)
        keep = inlier.sum(-1) >= 10
        if trackers is not None:
            got = _handed_back(captures, k, T, trackers)
            if got is None:
                continue
            T, have = got
            keep &= have
        if not bool(keep.any()):
            continue
        args = (X, obs, info, ur >= 0, inlier)
        best = ref.pose_refine(cam, T, *args)
        got = T if dtype is None else ref.pose_refine(cam, T, *args,
                                                      dtype=dtype)
        gap = (ref.centres(got) - ref.centres(best)).norm(dim=-1)[keep]
        worst = max(worst, float(gap.max()))
        n += int(keep.sum())
    return (worst if n else None), n


def line_pose_problem(k, scale: float, gamma: float) -> sv.Problem:
    """The joint point+line pose step of a kept call as a `solve.Problem`
    (pose step semantics), from its predicted pose: the point step's
    inliers, and each line inlier's left view and, where it has one, its
    right view as edges of their own."""
    f64 = lambda t: t.to(sv.F64)
    dev = k["T_pred"].device
    pts = k["inlier"]
    n = pts.shape[0]
    li = torch.nonzero(k["ln_in"])[:, 0]
    L = li.shape[0]
    hr = k["has_r"][li]
    ri = torch.nonzero(hr)[:, 0]
    ll = torch.cat([torch.arange(L, device=dev), ri])
    lcam = torch.cat([torch.zeros(L, dtype=torch.bool, device=dev),
                      torch.ones(ri.shape[0], dtype=torch.bool, device=dev)])
    x1 = torch.cat([k["p1"][li], k["p1r"][li][ri]])
    x2 = torch.cat([k["p2"][li], k["p2r"][li][ri]])
    X0, d = f64(k["X0"][li]), f64(k["d"][li])
    loct = k["loct"][li][ll]
    return sv.Problem(
        poses=f64(k["T_pred"])[None], fixed=torch.zeros(1, dtype=torch.bool,
                                                         device=dev),
        points=f64(k["X"]), pvalid=torch.ones(n, dtype=torch.bool,
                                              device=dev),
        pk=torch.zeros(n, dtype=torch.long, device=dev),
        pp=torch.arange(n, device=dev),
        uvr=f64(torch.cat([k["xy"], k["ur"][:, None]], -1)),
        pinfo=sv.point_info(k["octave"], scale), stereo=k["ur"] >= 0,
        pobs=pts, A=X0, B=X0 + d, lvalid=torch.ones(L, dtype=torch.bool,
                                                    device=dev),
        lk=torch.zeros(ll.shape[0], dtype=torch.long, device=dev), ll=ll,
        x1l=f64(x1), x2l=f64(x2), x1r=f64(x1), x2r=f64(x2),
        linfo=sv.line_info(loct, gamma), has_r=hr[ll],
        lobs=torch.ones(ll.shape[0], dtype=torch.bool, device=dev),
        lcam=lcam, gamma=gamma, move_landmarks=False)


def line_pose_gap(captures, cam: dict, scale: float, gamma: float,
                  trackers, dtype=None) -> tuple[float | None, int,
                                                  float | None]:
    """(the median over the checked frames of a lines cell of the distance
    (m) between the camera centre of the pose handed back for the frame and
    that of the float64 minimum of its joint point+line pose step, frames
    checked, the largest such distance). The median, not the largest: the
    program's line step stops short of its cost's minimum by an amount
    that swings from frame to frame (PERF.md), while a step that is not
    taken moves every frame. The control solves the step in `dtype` in the
    program's place."""
    gaps = []
    for k in captures.kept["line_pose"]:
        got = _handed_back(captures, k, k["T"][None], trackers)
        if got is None or not bool(got[1].all()) or int(k["inlier"].sum()) \
                < 10:
            continue
        pr = line_pose_problem(k, scale, gamma)
        best = sv.pose_step(cam, pr).poses[0]
        T = got[0][0] if dtype is None else \
            sv.pose_step(cam, pr, dtype).poses[0]
        gaps.append(float((ref.centres(T) - ref.centres(best)).norm()))
    if not gaps:
        return None, 0, None
    return float(torch.tensor(gaps).median()), len(gaps), max(gaps)


def ba_problem(k, scale: float) -> sv.Problem:
    """A kept local BA as a `solve.Problem` at the window's state, over the
    observations the program's BA kept as inliers."""
    f64 = lambda t: t.to(sv.F64)
    n = k["n_obs"]
    ok, fe, op = (k[key][:n].long() for key in ("obs_k", "obs_fe", "obs_p"))
    ur = k["ur"][ok, fe]
    pr = sv.Problem(
        poses=f64(k["poses"]), fixed=k["fixed"], points=f64(k["points"]),
        pvalid=k["pvalid"], pk=ok, pp=op,
        uvr=f64(torch.cat([k["xy"][ok, fe], ur[:, None]], -1)),
        pinfo=sv.point_info(k["octave"][ok, fe], scale), stereo=ur >= 0,
        pobs=k["out_keep"][:n].bool())
    if "ln_x0" in k:
        lo = k["lobs"]
        v = lo["valid"]
        X0 = f64(k["ln_x0"])
        pr = replace(
            pr, A=X0, B=X0 + f64(k["ln_dir"]), lvalid=k["ln_valid"],
            lk=lo["k"][v].long(), ll=lo["l"][v].long(),
            x1l=f64(lo["x1l"][v]), x2l=f64(lo["x2l"][v]),
            x1r=f64(lo["x1r"][v]), x2r=f64(lo["x2r"][v]),
            linfo=sv.line_info(lo["octave"][v], k["gamma"]),
            has_r=lo["has_r"][v], lobs=k["out_keep_l"][v].bool(),
            gamma=k["gamma"])
    return pr


def ba_excess(captures, cam: dict, scale: float, dtype=None
              ) -> tuple[float | None, int, float | None]:
    """(the largest relative excess of a checked local BA's cost at the map
    the program wrote over the reference's float64 minimum of the same
    cost, BAs checked, the largest excess of the window's map as it was
    before the BA: what a BA that left the map unchanged would read). The
    cost is the BA's over the observations the program kept as inliers (a
    step followed from the program's state: which observations its first
    pass drops depends on where that unconverged pass stops, PERF.md). The
    control solves the BA in `dtype` in the program's place."""
    worst, unmoved, n = 0.0, 0.0, 0
    for k in captures.kept["ba"]:
        pr = ba_problem(k, scale)
        best = sv.solve(cam, pr, 30, sv.gnc(30))
        c_best = float(sv.cost(cam, best))
        if c_best <= 0:
            continue
        if dtype is None:
            A = B = None
            if pr.lines:
                A = k["out_X0"].to(sv.F64)
                B = A + k["out_d"].to(sv.F64)
            c = float(sv.cost(cam, best, k["out_poses"], k["out_points"],
                              A, B))
            # a map the program wrote with a non-finite entry where the
            # problem has a landmark or a free pose fails outright
            used = [k["out_poses"][~pr.fixed], k["out_points"][pr.pvalid]]
            if pr.lines:
                used += [A[pr.lvalid], B[pr.lvalid]]
            if not all(bool(torch.isfinite(u).all()) for u in used):
                c = float("inf")
        else:
            low = sv.solve(cam, pr, 30, sv.gnc(30), dtype)
            c = float(sv.cost(cam, best, low.poses, low.points, low.A,
                              low.B))
        c0 = float(sv.cost(cam, best, pr.poses, pr.points, pr.A, pr.B))
        worst = max(worst, (c - c_best) / c_best)
        unmoved = max(unmoved, (c0 - c_best) / c_best)
        n += 1
    return (worst if n else None), n, (unmoved if n else None)


def ate(trajs, truths) -> float:
    """The worst sequence's ATE; truths: per sequence (T_cw (n, 4, 4),
    speed)."""
    return max(ref.ate(est, ref.centres_true(t_cw)[idx])
               for (idx, est), (t_cw, _) in zip(trajs, truths))


def line_wrong(captures, line_truth, cap: int) -> tuple[int, int]:
    """(wrong stereo line matches, matches) over every window frame."""
    wrong = matched = 0
    for cur, r_idx in captures.lines:
        if cur is None or len(cur) != 1:
            continue
        _, i = cur[0]
        (ids_l, p1l, p2l), (ids_r, p1r, p2r) = line_truth[i]
        seg_l = ids_l[ref.kept_lines(p1l, p2l, cap)]
        seg_r = ids_r[ref.kept_lines(p1r, p2r, cap)]
        r_idx = r_idx.cpu().numpy()
        wrong += ref.wrong_line_matches(r_idx, seg_l, seg_r)
        matched += int((r_idx >= 0).sum())
    return wrong, matched


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and each number beside its limit. A number without a
    reading (None) fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v <= limit
        ok &= good
        checks[name] = dict(value=v, limit=limit)
    return ok, checks
