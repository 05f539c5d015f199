"""Native (C++) host runtime of the port, loaded with ctypes.

Counterpart of lldslam_tpu/native: `loader.cpp` is a threaded PNG decoder
and prefetcher. It decodes 8-bit grayscale PNGs (KITTI image_0/1, EuRoC
cam0/1) with its own chunk parser and scanline filters over zlib; every
other format is refused with a message that names it.

The library is compiled with `g++` the first time it is needed, into
`lldslam_tpu_torch/_build/` (a directory git ignores), and again whenever
the source or the flags change (the file name carries their hash), as
ops/cuda_build.py does for the CUDA kernels. Nothing here runs at import
time, and there is no fallback: a missing compiler or zlib, or a failed
build or load, raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
COMPILER = "g++"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBS = ("-lz",)
STATUS = {0: "pending", -1: "cannot be opened", -2: "is not a PNG file",
          -3: "has a format this decoder does not read",
          -4: "is corrupt (chunk, CRC, zlib stream or scanline filter)",
          -5: "is larger than the buffer given"}
COLOR_TYPES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale+alpha",
               6: "RGBA"}

_lib: ctypes.CDLL | None = None


def _lib_path(build_dir: Path) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return build_dir / f"libloader_{h.hexdigest()[:16]}.so"


def build(build_dir: Path | None = None) -> Path:
    """Compile loader.cpp into `build_dir` (default BUILD_DIR) unless that
    build exists; raises when the compiler is missing or fails."""
    out = _lib_path(Path(build_dir or BUILD_DIR))
    if out.exists():
        return out
    cxx = shutil.which(COMPILER)
    if cxx is None:
        raise RuntimeError(f"{COMPILER} not found: the native PNG loader of "
                           f"lldslam_tpu_torch is compiled from {SRC.name} at "
                           f"first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *FLAGS, str(SRC), *LIBS, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native PNG loader failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded C library (built on first use); never None."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, sz, u8p = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p
        u32p = ctypes.POINTER(ctypes.c_uint32)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.loader_create.restype = vp
        lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), sz, sz,
                                      sz]
        lib.loader_get.restype = ctypes.c_int
        lib.loader_get.argtypes = [vp, sz, u8p, u32p, u32p, sz]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [vp]
        lib.loader_probe.restype = ctypes.c_int
        lib.loader_probe.argtypes = [ctypes.c_char_p, u32p, u32p, ip, ip, ip]
        lib.loader_read.restype = ctypes.c_int
        lib.loader_read.argtypes = [ctypes.c_char_p, u8p, u32p, u32p, sz]
        _lib = lib
    return _lib


def _error(path, rc: int) -> RuntimeError:
    msg = f"{path} {STATUS.get(rc, f'failed to decode (status {rc})')}"
    if rc == -3:
        w, h, depth, color, lace = probe(path)
        msg += (f": {depth}-bit {COLOR_TYPES.get(color, color)}"
                f"{', interlaced' if lace else ''}; the port reads 8-bit "
                f"grayscale PNGs that are not interlaced")
    return RuntimeError(msg)


def probe(path) -> tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) of a PNG file."""
    lib = get_lib()
    w, h = ctypes.c_uint32(), ctypes.c_uint32()
    d, c, i = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.loader_probe(str(path).encode(), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(d), ctypes.byref(c), ctypes.byref(i))
    if rc != 1:
        raise RuntimeError(f"{path} {STATUS.get(rc, f'status {rc}')}")
    return w.value, h.value, d.value, c.value, i.value


def read_png(path) -> np.ndarray:
    """One PNG decoded on the calling thread: (H, W) uint8."""
    lib = get_lib()
    w, h = probe(path)[:2]
    buf = np.empty((h, w), np.uint8)
    ww, hh = ctypes.c_uint32(), ctypes.c_uint32()
    rc = lib.loader_read(str(path).encode(), buf.ctypes.data, ctypes.byref(ww),
                         ctypes.byref(hh), buf.size)
    if rc != 1:
        raise _error(path, rc)
    return buf


class NativeImageLoader:
    """Threaded-prefetch grayscale PNG reader: `frame(i)` -> (H, W) uint8.
    `n_threads` workers decode up to `window` frames ahead of the last frame
    asked for; frames may be asked for in any order."""

    def __init__(self, paths, window: int = 8, n_threads: int = 2):
        if not paths:
            raise ValueError("NativeImageLoader needs at least one path")
        if window < 1 or n_threads < 1:
            raise ValueError(f"window {window} and n_threads {n_threads} must "
                             f"be at least 1")
        self._lib = get_lib()
        self.paths = [str(p) for p in paths]
        self.w, self.h = probe(self.paths[0])[:2]
        self._cpaths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self._lib.loader_create(self._cpaths, len(self.paths),
                                               window, n_threads)

    def __len__(self) -> int:
        return len(self.paths)

    def frame(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self.paths):
            raise IndexError(f"frame {i} of {len(self.paths)}")
        buf = np.empty(self.h * self.w, np.uint8)
        w, h = ctypes.c_uint32(), ctypes.c_uint32()
        rc = self._lib.loader_get(self._handle, i, buf.ctypes.data,
                                  ctypes.byref(w), ctypes.byref(h), buf.size)
        if rc != 1:
            raise _error(self.paths[i], rc)
        return buf[: w.value * h.value].reshape(h.value, w.value)

    def close(self) -> None:
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
