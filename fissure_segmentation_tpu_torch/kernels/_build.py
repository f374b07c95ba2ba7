"""Build and load the CUDA kernels (counterpart of ops/_config.py).

At first use every ``csrc/*.cu`` source is compiled by its own nvcc, all
started together, and the objects are linked into one shared library with a
plain C interface, which is then loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c -o <tmp>/<source>.o csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libfseg_kernels_<hash>.so <tmp>/*.o

The library name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source or header is never
served from a stale build. `-fmad=false` keeps nvcc from contracting
a*b+c into an FMA anywhere: the kernels must round every operation
exactly like their plain PyTorch versions (see kernels/knn.py).
No header of PyTorch is included, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked in {cand} and on PATH)")
    return found


def _lib_path(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libfseg_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless a build of exactly these sources exists;
    return the library path. Raises KernelBuildError with nvcc's stderr."""
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {_CSRC}")
    path = _lib_path(srcs)
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(src) + ".o")
                for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        try:
            errs = [proc.communicate(timeout=600)[1] for proc in procs]
        finally:
            for proc in procs:  # a timeout leaves the others running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for cmd, proc, err in zip(cmds, procs, errs):
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(cmd)}\n{err}")
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builders race safely
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            signatures = {
                "fseg_knn_f32": [vp, vp, vp, i32, i32, i32, i32, vp],
                "fseg_fps_f32": [vp, vp, vp, i32, i32, i32, i32, vp],
                "fseg_scatter_rows": [vp, vp, vp, vp, i64, i32, i32, vp],
                "fseg_scatter_routed": [vp, vp, vp, vp, vp, vp, i32, i32,
                                        i32, i32, i32, i32, vp],
                "fseg_scatter_count": [vp, vp, vp, i32, i64, i32, vp],
                "fseg_count_from_ptr": [vp, vp, i64, vp],
                "fseg_graph_transpose": [vp, vp, vp, vp, vp, i32, i64, i32,
                                         vp],
                "fseg_depthwise_conv3": [vp, vp, vp, i32, i32, i32, i32, i32,
                                         i32, i32, vp],
                "fseg_depthwise_wgrad": [vp, vp, vp, vp, i32, i32, i32, i32,
                                         i32, i32, i64, vp],
                "fseg_depthwise_wgrad_plan": [i32, i32, i32, i32, i32, i32,
                                              i32, ctypes.POINTER(i64)],
                "fseg_gather_reduce": [vp, vp, vp, vp, vp, vp, vp, vp, i32,
                                       i32, i32, i32, i32, i32, i32, i32,
                                       i32, vp],
                "fseg_gather_reduce_route": [i32, i32, i32, i32, i32, i32,
                                             ctypes.POINTER(i32)],
                "fseg_stream_sum": [vp, vp, vp, vp, vp, i64, i32, i32, i32,
                                    vp],
                "fseg_stream_occupancy": [i32, i32, i32, i32],
                "fseg_bin_extrema": [vp, vp, vp, i64, i64, i64, i32, i32,
                                     i32, vp],
                "fseg_select_rows": [vp, vp, vp, i64, i64, i64, i32, i32,
                                     i32, i32, i32, vp],
                "fseg_stream_sum_async": [vp, vp, vp, vp, vp, i64, i32, i32,
                                          i32, i32, i32, vp],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.restype = i32
                fn.argtypes = argtypes
            lib.fseg_transpose_scratch.restype = i64
            lib.fseg_transpose_scratch.argtypes = [i32, i64, i32]
            _lib = lib
        return _lib
