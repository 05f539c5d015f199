"""Host ms of each part of `System.warmup` in a fresh process, twice.

Usage (from the repository root; one card, or --device cpu to rehearse):

    python tools/torch_warmup_parts.py [--device D]

The process creates the CUDA context, then the System of chip_smoke.py's
main path (KITTI camera, 2000 features, loops on, the shipped vocabulary),
and runs the parts of `System.warmup` in its order, each timed with the card
synchronised before and after: `torch.func`'s first forward-mode pass, the
CUDA kernels' library, the (2, 4, 4) eigh, SVD, solve and inverse,
`LoopCloser.warmup`, `LocalMapper.warmup`, and
`pipeline.tracker.warmup_mono_programs` with its four steps timed inside it
(the initialization match, the H/F RANSACs, the homography and the
fundamental reconstruction). Then it does it all once more: the first pass
is what a process pays, the second what is left once everything is warm.
Prints one JSON line: the card's name and power limit and per pass the ms
of every part.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch_cold_start as tcs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from lldslam_tpu_torch.frontend import matching
    from lldslam_tpu_torch.ops import cuda_build
    from lldslam_tpu_torch.optim import initializer
    from lldslam_tpu_torch.pipeline import tracker
    from lldslam_tpu_torch.system import System

    tcs._timed(dev, lambda: torch.zeros(1, device=dev) + 1)   # the context
    sys_ = System(cs.kitti_config(), device=dev)
    tr = sys_.tracker
    ms: dict[str, float] = {}

    def step(mod, name, key):
        fn = getattr(mod, name)

        def timed(*args, **kw):
            t, out = tcs._timed(dev, lambda: fn(*args, **kw))
            ms[key] = t
            return out
        return timed

    for mod, name, key in ((matching, "search_for_initialization",
                            "mono: match"),
                           (initializer, "ransac_models", "mono: RANSACs"),
                           (initializer, "reconstruct_h", "mono: H"),
                           (initializer, "reconstruct_f", "mono: F")):
        setattr(mod, name, step(mod, name, key))
    eye = torch.eye(4, device=dev).expand(2, 4, 4)
    parts = [("jvp", lambda: torch.func.jvp(lambda x: x * 2, (eye,), (eye,)))]
    if dev.type == "cuda":
        parts += [("library", cuda_build.library),
                  ("eigh", lambda: torch.linalg.eigh(eye)),
                  ("svd", lambda: torch.linalg.svd(eye)),
                  ("solve", lambda: torch.linalg.solve_ex(eye, eye)),
                  ("inverse", lambda: torch.linalg.inv_ex(eye))]
    parts += [("loop", tr.loop_closer.warmup),
              ("mapper", lambda: tr.mapper.warmup(voc=tr.loop_closer.voc)),
              ("mono", lambda: tracker.warmup_mono_programs(
                  tr.cam, tr.store.n_kp, dev))]
    passes = []
    for _ in range(2):
        ms.clear()
        for key, fn in parts:
            ms[key] = tcs._timed(dev, fn)[0]
        passes.append({k: round(v, 2) for k, v in ms.items()})
    print(json.dumps(dict(card=tcs._card() if dev.type == "cuda" else None,
                          passes=passes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
