"""Build and load the port's CUDA kernels.

Each library is one ``csrc/<name>.cu`` file with a plain C interface
(warp_fwd: the multi-grid warp forward; warp_bwd: its dgrid and dx kernels;
warp_grid: the single-grid warp's forward, dgrid and dx kernels;
probe_gather, probe_warp: the kernels of the four probes in probes/), which
may include the shared ``csrc/*.cuh`` headers.  At first use it is compiled with
nvcc for sm_90a into a shared library under ``_build/`` (named by a hash of
the source, the headers and the flags, so an edit rebuilds)
and loaded with ctypes; load_all starts one nvcc per source at once;
function gives one C function with its signature, launch calls it and
raises on the cudaError_t it returns.
Nothing else is built or fetched.  Nothing here runs at import time: the CPU
tests import every module and have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LIBRARIES = ("warp_fwd", "warp_bwd", "warp_grid", "probe_gather", "probe_warp")

_lock = threading.Lock()           # guards _name_locks
_name_locks = {}
_libs = {}
_functions = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "ptxas": nvcc's register / spill report}
build_info = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the port's "
                           "kernels are built with nvcc at first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the library."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = SRC_DIR / f"{name}.cu"
        # the headers too: an edit of one rebuilds every library
        sources = [src, *sorted(SRC_DIR.glob("*.cuh"))]
        digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"{name}-{digest}.so"
        info = {"seconds": 0.0, "ptxas": ""}
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
            os.replace(tmp, so)
            info = {"seconds": time.perf_counter() - t0,
                    "ptxas": (res.stdout + res.stderr).strip()}
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        build_info[name] = info
        return lib


def load_all(names=LIBRARIES):
    """Build and load several libraries with one nvcc each, all at once."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))


def function(library: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of csrc/<library>.cu (built at first use),
    with its argument types; it returns a cudaError_t as an int."""
    if (library, symbol) not in _functions:
        fn = getattr(load(library), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _functions[library, symbol] = fn
    return _functions[library, symbol]


def launch(counts, name, fn, *args):
    """Call a kernel's C function; raise on the cudaError_t it returns (0 is
    success), else count the launch in counts[name]."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
    counts[name] += 1
