"""Spawned ranks of one torch.distributed process group on this host.

`run_ranks(fn, n_ranks, device, args)` starts `n_ranks` processes with the
`spawn` start method (never `fork`: each rank makes its own CUDA context),
joins them into one default process group and returns what `fn(rank,
device, *args)` returned in each, in rank order. The group's address is a
TCPStore that the caller's process serves on 127.0.0.1 at a port the
operating system picks, so no port can be taken in between.

Devices: "cpu" gives gloo ranks on the CPU; "cuda" gives one card per rank
(cuda:<rank>) with NCCL, and raises when there are fewer cards than ranks;
an explicit card such as "cuda:0" puts every rank on that card, with gloo
(NCCL refuses two ranks on one card). Nothing falls back: a rank that
raises, a failed group init or a rank that outlives `timeout_s` makes
`run_ranks` stop every rank and raise.
"""
from __future__ import annotations

import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .dist_schur import GROUP_TIMEOUT


def _backend(device: str) -> str:
    """gloo for the CPU and for ranks sharing one named card; NCCL for one
    card per rank."""
    return "nccl" if device == "cuda" else "gloo"


def _rank_main(rank, n_ranks, port, device, fn, args, results):
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank)
        else:
            dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.TCPStore("127.0.0.1", port, n_ranks, is_master=False,
                              timeout=GROUP_TIMEOUT)
        kw = dict(device_id=dev) if _backend(device) == "nccl" else {}
        dist.init_process_group(_backend(device), store=store, rank=rank,
                                world_size=n_ranks, timeout=GROUP_TIMEOUT,
                                **kw)
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, n_ranks: int, device: str = "cuda", args=(),
              timeout_s: float = 600.0) -> list:
    """Runs fn(rank, device, *args) in `n_ranks` spawned ranks of one
    process group; returns their results in rank order. `fn` and `args`
    must pickle (a module-level function)."""
    if n_ranks < 1:
        raise ValueError(f"{n_ranks} ranks")
    if device == "cuda":
        if n_ranks > torch.cuda.device_count():
            raise RuntimeError(f"{n_ranks} ranks with one card each, "
                               f"{torch.cuda.device_count()} cards visible")
    elif device != "cpu" and not device.startswith("cuda:"):
        raise ValueError(f"device {device!r}: 'cpu', 'cuda' or 'cuda:<i>'")
    ctx = mp.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, n_ranks, is_master=True,
                          wait_for_workers=False, timeout=GROUP_TIMEOUT)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, store.port, device, fn, args,
                               results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < n_ranks:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    errors.append(f"a rank exited with code {dead[0]} "
                                  "without a result")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"ranks still running after {timeout_s} s")
                    break
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
        if not errors:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        del store
    if errors:
        raise RuntimeError("run_ranks failed: " + "\n".join(errors))
    return [got[r] for r in range(n_ranks)]
