"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Every `.cu` file in `lldslam_tpu_torch/csrc/` exposes a plain C interface.
They are compiled together by `nvcc` for Hopper (`sm_90a`) into one shared
library under `lldslam_tpu_torch/_build/` (a directory git ignores) the
first time a kernel is launched, and again whenever a source's content hash
changes. The library is loaded with `ctypes`; each kernel wrapper passes its
tensors' data pointers and the current CUDA stream as `c_void_p`.

Nothing here runs at import time, and there is no fallback: a missing `nvcc`
or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels of lldslam_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME or put nvcc on "
                       "PATH)")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into _build/liblldslam_kernels_<hash>.so unless that
    file exists. `verbose` adds `-Xptxas -v` and prints the compiler output
    (registers, shared memory and spills per kernel)."""
    global last_build_seconds
    out = BUILD_DIR / f"liblldslam_kernels_{_source_hash()}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(ctypes.c_int)
        lib.lld_orb_describe.argtypes = [vp, vp, i32, i32, i32, ints, ints,
                                         vp, vp, i32, vp, vp, vp]
        lib.lld_stereo_sad.argtypes = [vp, i32, i32, i32, ints, ints, vp, vp,
                                       vp, vp, i32, vp, vp, vp, vp]
        lib.lld_gated_best2.argtypes = [vp] * 7 + [i32] + [vp] * 5 + [i32,
                                                                      vp, vp]
        for fn in (lib.lld_orb_describe, lib.lld_stereo_sad,
                   lib.lld_gated_best2):
            fn.restype = i32
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        name = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
        raise RuntimeError(f"{what}: CUDA error {err} on {name}")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
