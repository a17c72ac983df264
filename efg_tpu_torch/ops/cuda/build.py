"""Build the port's CUDA C++ kernels with nvcc and bind them with ctypes.

Each `efg_tpu_torch/csrc/<stem>.cu` has a plain C interface and compiles
on its own into `efg_tpu_torch/build/lib<stem>-<hash>.so` (the directory
is git-ignored). The hash covers the sources and the flags, so an edited
source is rebuilt and a stale library is never loaded. `build()` starts
one nvcc per missing library, all at once, and waits for every one of
them; a failed compile raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# every kernel source of the port, csrc/<stem>.cu (bound in
# sparse_kernels.py and match_kernels.py)
SOURCES = ("rank_flags", "rank_flags_seq4", "rank_flags_hostwin", "gather_gemm",
           "gather_gemm_g3", "gather_dw", "device_match")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {path} and on PATH)")
    return found


def library_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build(stems: Iterable[str]) -> Dict[str, dict]:
    """Compile every library in `stems` that is not built yet, one nvcc
    process each, all started together. Returns {stem: {"seconds", "log"}}
    for the ones compiled here."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for stem in stems:
        out = library_path(stem)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[stem] = (proc, tmp, out, time.perf_counter())
    done, failed = {}, []
    for stem, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        done[stem] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {stem}.cu (rc={proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build_all() -> Dict[str, dict]:
    """`build` of every source in SOURCES (one nvcc each, in parallel)."""
    return build(SOURCES)


def load(stem: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load lib<stem>, declaring each C entry's
    argument types; every entry returns a cudaError_t as int."""
    lib = _LIBS.get(stem)
    if lib is None:
        build([stem])
        lib = ctypes.CDLL(str(library_path(stem)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.efg_error_string.argtypes = [ctypes.c_int]
        lib.efg_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.efg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
