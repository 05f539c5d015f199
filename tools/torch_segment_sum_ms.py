"""Device ms of the segment sums at the shapes of their call sites, on the
card, beside the atomic `index_add_`.

Usage (from the repository root; one card):

    python tools/torch_segment_sum_ms.py [CHECKOUT ...]

Each CHECKOUT (default `.`) is the root of a checkout of this repository
(an unpacked `git archive` of another commit, for one); they run in the
order given, each in its own process, so list them in turns (parent,
change, change, parent). A process times, with its checkout's
chip_smoke.py `device_ms` (a spin kernel holds the stream while the host
queues 20 calls; CUDA events time them), the checkout's `segment_sum_` and
the atomic `out.index_add_(0, index, src)` in turns on random layouts of
the sites' shapes (seeded): the ring map's global BA, 8,322 observation
rows over its 29 keyframes (36 and 6 columns) and over its 4,926 points
(9, 3 and 1), the pose graph's matvec (48 rows over 24 keyframes, 7) and
the joint BA's line side (623 rows over 268 lines, 4); every result is
held to CPU `index_add_` bit for bit (it raises otherwise). Then 29
segments of L rows each (L from 8 to 4,096; 6 and 36 columns), kernel and
atomic once each: the cost of a row of a long segment. Then the vote
on the left view of frame 0 of chip_smoke.py's lines world (1241x376,
seed 2): a whole `line_extract._accumulate` call, and where the checkout
has them its layout (`segment_sum.bin_layout`) and ordering sum
(`bin_reduce`) alone, against the atomic `index_add_` over every pixel,
the result held to CPU `index_add_`. Prints one JSON line per checkout:
ms per site, kernel over atomic, and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SITES = {  # name: (rows, segments, columns)
    "ring BA Hcc": (8322, 29, (6, 6)),
    "ring BA pose side": (8322, 29, (6,)),
    "ring BA Hpp": (8322, 4926, (3, 3)),
    "ring BA point side": (8322, 4926, (3,)),
    "ring BA seen": (8322, 4926, ()),
    "pose graph matvec": (48, 24, (7,)),
    "joint BA line side": (623, 268, (4,)),
}


def child(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from lldslam_tpu_torch.frontend import line_extract as le
    from lldslam_tpu_torch.io.synthetic import make_sequence
    from lldslam_tpu_torch.ops import segment_sum

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    out = {}
    for name, (O, n, cols) in SITES.items():
        idx = torch.from_numpy(rng.integers(0, n, O))
        src = torch.from_numpy(rng.normal(size=(O,) + cols).astype(
            np.float32))
        want = torch.zeros((n,) + cols).index_add_(0, idx, src)
        idx, src = idx.to(dev), src.to(dev)
        lay = segment_sum.segment_layout(idx, n)
        got = segment_sum.segment_sum_(torch.zeros((n,) + cols, device=dev),
                                       lay, src)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: differs from CPU index_add_")
        buf = torch.zeros((n,) + cols, device=dev)
        ms, atomic = [], []
        for _ in range(3):
            ms.append(cs.device_ms(
                lambda: segment_sum.segment_sum_(buf, lay, src)))
            atomic.append(cs.device_ms(lambda: buf.index_add_(0, idx, src)))
        out[name] = dict(ms=ms, atomic_ms=atomic,
                         factor=sorted(ms)[1] / sorted(atomic)[1])
    # rows a segment: 29 segments of L rows each, in random order
    sweep = {}
    for C in (6, 36):
        for L in (8, 32, 128, 287, 1024, 4096):
            idx = torch.from_numpy(rng.permutation(np.repeat(np.arange(29),
                                                             L))).to(dev)
            src = torch.randn(29 * L, C, device=dev)
            lay = segment_sum.segment_layout(idx, 29)
            buf = torch.zeros(29, C, device=dev)
            sweep[f"C={C} L={L}"] = dict(
                ms=cs.device_ms(
                    lambda: segment_sum.segment_sum_(buf, lay, src)),
                atomic_ms=cs.device_ms(lambda: buf.index_add_(0, idx, src)))
    out["rows_a_segment"] = sweep
    cam = cs.kitti_config().camera.stereo_camera()
    img = make_sequence(cam, 1, seed=2, with_lines=True)[0][0]
    cfg = le.LineDetConfig(max_lines=256)
    _, _, mag, edge, _, bins, n_rho = le._votes(
        torch.from_numpy(img).to(dev).float(), cfg)
    w, b = torch.where(edge, mag, 0.0).reshape(-1), bins.reshape(-1)
    n = n_rho * cfg.n_phi
    if not torch.equal(le._accumulate(b, w, n).cpu(),
                       le._accumulate(b.cpu(), w.cpu(), n)):
        raise AssertionError("vote: differs from CPU index_add_")
    acc = torch.zeros(n, device=dev)
    vote = dict(call_ms=[], atomic_ms=[])
    has_parts = hasattr(segment_sum, "bin_layout")
    if has_parts:
        lay = segment_sum.bin_layout(b, w, n)
        vote.update(layout_ms=[], kernel_ms=[])
    for _ in range(3):
        vote["call_ms"].append(cs.device_ms(lambda: le._accumulate(b, w, n)))
        vote["atomic_ms"].append(cs.device_ms(
            lambda: acc.index_add_(0, b, w)))
        if has_parts:
            vote["layout_ms"].append(cs.device_ms(
                lambda: segment_sum.bin_layout(b, w, n)))
            vote["kernel_ms"].append(cs.device_ms(
                lambda: segment_sum.bin_reduce(lay, w, n)))
    out["vote"] = vote
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return dict(checkout=root, card=smi, sites=out)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        print("RESULT " + json.dumps(child(args[1])), flush=True)
        return 0
    for root in args or ["."]:
        root = str(Path(root).resolve())
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", root],
            capture_output=True, text=True, cwd=root)
        lines = [ln[7:] for ln in res.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if res.returncode != 0 or not lines:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
