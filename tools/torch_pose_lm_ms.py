"""Device and host ms of the points-only pose LM on the card: the kernel
(`ops/pose_lm.pose_lm`, through `optim.pose_opt.optimize_pose`) beside the
plain LM (`optimize_pose_plain`) at the tracking step's shapes.

Usage (from the repository root; one card):

    python tools/torch_pose_lm_ms.py [--ptxas]

`--ptxas` first rebuilds the kernels with `-Xptxas -v` and prints each
kernel's registers, shared memory and spills. Then, at N = 2048 rows (the
2000-feature capacity) and 4 x 10 iterations, for S = 1 (one mono/stereo
mix with 20% outliers) and S = 4 (io.kernel_inputs.pose_lm_inputs' mix,
few, none, mix): the kernel and the plain LM once each on the same tensors
(poses apart, inlier rows apart, and a second kernel launch bit-equal),
then the kernel's device ms a call (chip_smoke.py `device_ms`: calls
queued behind a spin kernel, timed by CUDA events), the busy device ms a
call of each (the summed device time of the kernels it launches, one
torch.profiler session of three calls: the plain LM's 6,000 launches a
call overflow the launch queue that `device_ms` needs) and the host ms a
call of each (the median of 20 or 5 calls, synchronised after each),
kernel and plain in turns. Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def busy_ms(fn, calls: int = 3) -> float:
    """Device ms a call: the summed device time of every kernel fn
    launches, from one torch.profiler session of `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 / calls


def host_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from lldslam_tpu_torch.geometry.camera import StereoCamera
    from lldslam_tpu_torch.io import kernel_inputs
    from lldslam_tpu_torch.ops import cuda_build
    from lldslam_tpu_torch.optim import pose_opt

    if "--ptxas" in sys.argv:
        cuda_build.build(verbose=True)
    dev = torch.device("cuda", 0)
    cam = StereoCamera(**kernel_inputs.KITTI_CAM, width=1241, height=376)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    for S, kinds in ((1, ("mix",)), (4, ("mix", "few", "none", "mix"))):
        T0, obs = kernel_inputs.pose_lm_inputs(np.random.default_rng(7), dev,
                                               kinds)
        p = pose_opt.PointPoseObs(*obs)
        if S == 1:
            T0, p = T0[0], pose_opt.PointPoseObs(*(t[0] for t in p))
        kern = lambda: pose_opt.optimize_pose(cam, T0, p)
        plain = lambda: pose_opt.optimize_pose_plain(cam, T0, p)
        a, b, c = kern(), kern(), plain()
        torch.cuda.synchronize()
        dT = (a[0] - c[0]).double()
        row = dict(
            rows=int(p.X.shape[-2]), S=S,
            repeat_equal=all(torch.equal(x, y) for x, y in zip(a, b)),
            max_translation_gap_m=float(dT[..., :3, 3].norm(dim=-1).max()),
            max_rotation_entry_gap=float(dT[..., :3, :3].abs().max()),
            inlier_rows_apart=int((a[1] != c[1]).sum()),
            n_inliers=a[3].tolist(), n_inliers_plain=c[3].tolist())
        dk, bk, bp, hk, hp = [], [], [], [], []
        for _ in range(2):   # kernel and plain in turns
            dk.append(cs.device_ms(kern))
            bk.append(busy_ms(kern))
            bp.append(busy_ms(plain))
            hk.append(host_ms(kern))
            hp.append(host_ms(plain, reps=5))
        row.update(kernel_device_ms=dk, kernel_busy_ms=bk, plain_busy_ms=bp,
                   kernel_host_ms=hk, plain_host_ms=hp)
        out[f"S{S}"] = row
        print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
