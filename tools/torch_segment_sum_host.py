"""Host µs a call of the segment sum's wrapper and of its parts, on the card.

Usage (from the repository root; one card):

    python tools/torch_segment_sum_host.py [--calls N]

On a layout of the ring map's global BA (8,322 observation rows over 29
keyframes, 6 columns: the CG step's pose-side sum; and over 4,926 points,
3 columns: its point-side sum), times N back-to-back calls of each of:
the atomic `index_add_`, `index_put_(accumulate=True)`, `segment_sum_`
(the wrapper: input checks, launch), its launch alone (`cuda_build.call`
on the bound kernel with the same arguments), the bare ctypes call of the
kernel, the current stream's handle (`current_stream().cuda_stream`, and
the raw handle `torch._C._cuda_getCurrentRawStream`) and the current card
(`torch.cuda.current_device`, `torch._C._cuda_getDevice`). Host clock
around the N calls, the card synchronised before and after; each reading
is the median of 5 rounds, in µs a call; `above_index_add` is
`segment_sum` less `index_add`. Prints one JSON line with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from lldslam_tpu_torch.ops import cuda_build, segment_sum  # noqa: E402


def per_call_us(fn, calls: int, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append(1e6 * (time.perf_counter() - t) / calls)
        torch.cuda.synchronize()
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    calls = ap.parse_args().calls
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    res = {}
    for label, n, C in (("pose side", 29, 6), ("point side", 4926, 3)):
        idx = torch.randint(0, n, (8322,), generator=g).to(dev)
        src = torch.randn(8322, C, generator=g).to(dev)
        out = torch.zeros(n, C, device=dev)
        lay = segment_sum.segment_layout(idx, n)
        args = (src.data_ptr(), lay.perm.data_ptr(), lay.ordered.data_ptr(),
                lay.offsets.data_ptr(), out.data_ptr(), 8322, n, C)
        kernel = cuda_build.library().lld_segment_sum
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        r = res[label] = dict(
            index_add=per_call_us(lambda: out.index_add_(0, idx, src), calls),
            index_put=per_call_us(lambda: out.index_put_(
                (idx,), src, accumulate=True), max(1, calls // 10)),
            segment_sum=per_call_us(
                lambda: segment_sum.segment_sum_(out, lay, src), calls),
            launch=per_call_us(lambda: cuda_build.call(
                kernel, "segment_sum_ launch", 0, *args), calls),
            ctypes_call=per_call_us(lambda: kernel(*args, stream), calls),
            stream_handle=per_call_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream, calls),
            raw_stream=per_call_us(
                lambda: torch._C._cuda_getCurrentRawStream(0), calls),
            current_device=per_call_us(torch.cuda.current_device, calls),
            get_device=per_call_us(torch._C._cuda_getDevice, calls))
        r["above_index_add"] = r["segment_sum"] - r["index_add"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(card=smi, calls=calls, us_per_call=res)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
