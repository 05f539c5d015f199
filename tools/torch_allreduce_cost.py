"""Host cost of one all_reduce on a one-rank process group, the collective
the port's distributed BA makes 690 times a global BA (10 LM iterations
of 64 CG steps).

Usage (from the repository root; one card):

    python tools/torch_allreduce_cost.py

Starts one process per configuration, so each makes its own default group
with `dist_schur.make_mesh`: NCCL on the card with the process's default
settings, NCCL with the NCCL flight recorder off (TORCH_FR_BUFFER_SIZE=0),
gloo with a CUDA tensor, gloo with a CPU tensor. Each times 690 calls on a
(29, 6) float32 tensor (the ring map's pose-space vector) after 50 warm
calls, host clock around the calls and a synchronisation, median of 5,
made from the top of a call stack and from 24 Python frames deeper (the
solver's calls sit about that deep); prints one JSON line per
configuration.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

CALLS = 690
DEPTHS = (0, 24)     # extra Python frames above each call


def measure(backend: str, device: str) -> dict:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.getcwd())
    from lldslam_tpu_torch.parallel import dist_schur

    dist_schur.make_mesh(device=device, backend=backend)
    x = torch.zeros((29, 6), device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def calls(n, depth):
        if depth:
            return calls(n, depth - 1)
        for _ in range(n):
            dist.all_reduce(x)

    calls(50, 0)
    sync()
    out = dict(backend=backend, device=device,
               fr_buffer=os.environ.get("TORCH_FR_BUFFER_SIZE"))
    for depth in DEPTHS:
        runs = []
        for _ in range(5):
            t = time.perf_counter()
            calls(CALLS, depth)
            sync()
            runs.append(1e6 * (time.perf_counter() - t) / CALLS)
        out[f"us_per_call_depth{depth}"] = statistics.median(runs)
    dist.destroy_process_group()
    return out


def main() -> int:
    if len(sys.argv) == 3:
        print(json.dumps(measure(sys.argv[1], sys.argv[2])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for backend, device, env in (
            ("nccl", "cuda", {}),
            ("nccl", "cuda", {"TORCH_FR_BUFFER_SIZE": "0"}),
            ("gloo", "cuda", {}), ("gloo", "cpu", {})):
        subprocess.run([sys.executable, __file__, backend, device],
                       env={**os.environ, **env}, check=True, timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
