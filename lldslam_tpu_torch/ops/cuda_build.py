"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Every `.cu` file in `lldslam_tpu_torch/csrc/` exposes a plain C interface.
They are compiled by `nvcc` for Hopper (`sm_90a`), one compiler process per
source, all started together, and linked into one shared library under
`lldslam_tpu_torch/_build/` (a directory git ignores) the first time a
kernel is launched, and again whenever a source's content hash changes. The library is loaded with `ctypes`; each kernel wrapper passes its
tensors' data pointers as `c_void_p` through `launch`, which makes the
tensors' device current for the call and passes that device's current CUDA
stream, so the launch and its stream always agree (a `cuda:1` tensor with
`cuda:0` current launches on card 1).

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
              "-Xcompiler", "-fPIC")

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
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    logs = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    last_build_seconds = time.perf_counter() - t0
    if verbose:
        print("".join(logs), flush=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(ctypes.c_int)
        lib.lld_orb_describe.argtypes = [vp, vp, i32, i32, i32, i32, ints,
                                         ints, vp, vp, i32, vp, vp, vp]
        lib.lld_stereo_sad.argtypes = [vp, i32, i32, i32, i32, ints, ints, vp,
                                       vp, vp, vp, i32, vp, vp, vp, vp]
        lib.lld_gated_best2.argtypes = [vp] * 7 + [i32, i32] + [vp] * 5 + [
            i32, vp, vp]
        i64 = ctypes.c_longlong
        lib.lld_segment_sum.argtypes = [vp] * 5 + [i64, i32, i32, vp]
        lib.lld_bin_layout.argtypes = [vp] * 8 + [i64, i32, i32, vp]
        lib.lld_bin_reduce.argtypes = [vp] * 6 + [i64, i32, vp]
        for fn in (lib.lld_orb_describe, lib.lld_stereo_sad,
                   lib.lld_gated_best2, lib.lld_segment_sum,
                   lib.lld_bin_layout, lib.lld_bin_reduce):
            fn.restype = i32
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        name = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
        raise RuntimeError(f"{what}: CUDA error {err} on {name}")


def launch(fn: str, what: str, device: torch.device, *args) -> None:
    """Call the library's `fn` with `args` and the current stream of
    `device` (see `call`)."""
    current = torch._C._cuda_getDevice()
    call(getattr(library(), fn), what,
         current if device.index is None else device.index, *args)


def call(kernel, what: str, index: int, *args) -> None:
    """Call the bound library function `kernel` with `args` and the current
    stream of card `index`, with that card current for the call (the `.cu`
    launches use the current device: it is switched for the call when
    another one is current); raises on a nonzero CUDA error code. The
    stream's handle comes from `torch._C._cuda_getCurrentRawStream` and the
    current card from `torch._C._cuda_getDevice`, far cheaper on the host
    than a `torch.cuda.Stream` object or `torch.cuda.current_device`: the
    sparse solvers launch a kernel thousands of times a loop event."""
    if index == torch._C._cuda_getDevice():
        err = kernel(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = kernel(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        check(err, what)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
