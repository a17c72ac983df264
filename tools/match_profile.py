#!/usr/bin/env python3
"""Where a device_match.cu block spends its cycles, and which cost rows
its Dijkstra steps read, on ConQueR's and Mask2Former R-50's first
training solves, on one NVIDIA card.

Run from the root of a checkout: `python3 tools/match_profile.py [--out
FILE]` (needs one CUDA device; writes JSON lines to stdout and to FILE, by
default efg_tpu_torch/build/match_profile.jsonl). It

1. builds an instrumented copy of csrc/device_match.cu (thread 0 of each
   block reads clock64 at the phase boundaries named in ANCHORS; nothing
   else changes) into efg_tpu_torch/build/match_profile/;
2. captures the two solves as tools/port_kernel_sweep.py does;
3. runs the copy on each (held bit for bit against the plain version)
   and prints each block's cycles: staging (on the shared route, where
   no barrier follows it, counted in init), init (state and valid list),
   the rows' first steps, the rows' Dijkstra searches (first steps
   included), the rows' tails (the u update, the walk, the barrier), the
   total, with the block that took longest and the mean over blocks;
4. replays the plain algorithm on each problem recording the row each
   Dijkstra step reads, and prints the share of steps whose row is among
   the first N valid rows (what a shared-memory cache of N rows would
   serve) beside the rows that fit beside the workspace route's state.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import port_kernel_sweep as SW  # noqa: E402

OUT = os.path.join(HERE, "efg_tpu_torch", "build", "match_profile.jsonl")
PHASES = ("staging", "init", "first_steps", "dijkstra_rows", "row_tails", "total")
# (source text, its instrumented form): each must occur once in the kernel
ANCHORS = (
    ("  const float kInf = __int_as_float(0x7f800000);\n",
     "  const float kInf = __int_as_float(0x7f800000);\n"
     "  long long T0 = clock64(), Tstaged = 0, Tfirst = 0, Tdij = 0, Ttail = 0;\n"),
    ("    __syncthreads();  // the tiles share their shared memory with the state\n",
     "    __syncthreads();  // the tiles share their shared memory with the state\n"
     "    Tstaged = clock64();\n"),
    ("  const int nvalid = s_nvalid;\n",
     "  const int nvalid = s_nvalid;\n  if (!Tstaged) Tstaged = T0;\n  long long Tinit = clock64();\n"),
    ("    const int cur = vlist[n];\n", "    const int cur = vlist[n];\n    long long Tr = clock64();\n"),
    ("    int i = cur, sink = -1, steps = 0, nrem = q;\n",
     "    Tfirst += clock64() - Tr;\n    int i = cur, sink = -1, steps = 0, nrem = q;\n"),
    ("    if (warp == 0) {\n      __syncwarp();  // the lanes' spc and path",
     "    long long Tl = clock64();\n    Tdij += Tl - Tr;\n"
     "    if (warp == 0) {\n      __syncwarp();  // the lanes' spc and path"),
    ("    prev_min = min_val;\n    solve_sync(nwarps);\n  }\n",
     "    prev_min = min_val;\n    solve_sync(nwarps);\n    Ttail += clock64() - Tl;\n  }\n"
     "  if (tid == 0) {\n    long long* p = efg_prof + b * 6;\n    p[0] = Tstaged - T0;\n"
     "    p[1] = Tinit - Tstaged;\n    p[2] = Tfirst;\n    p[3] = Tdij;\n    p[4] = Ttail;\n"
     "    p[5] = clock64() - T0;\n  }\n"),
)
MAX_BLOCKS = 1024
CACHE_ROWS = (16, 32, 40, 48, 64)


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def instrumented_source() -> str:
    """csrc/device_match.cu with the clock64 reads of ANCHORS, a device
    array of MAX_BLOCKS × 6 cycle counts and a C entry that copies it out."""
    from efg_tpu_torch.ops.cuda import build as B

    text = (B.CSRC / "device_match.cu").read_text()
    for anchor, timed in ANCHORS:
        if text.count(anchor) != 1:
            raise AssertionError(f"anchor found {text.count(anchor)} times: {anchor!r}")
        text = text.replace(anchor, timed)
    text = text.replace("namespace {\n", f"__device__ long long efg_prof[{MAX_BLOCKS} * 6];\n"
                        "namespace {\n", 1)
    return text + ('\nextern "C" int efg_prof_get(void* dst) {\n'
                   "  return cudaMemcpyFromSymbol(dst, efg_prof, sizeof(efg_prof));\n}\n")


def build_instrumented():
    from efg_tpu_torch.ops.cuda import build as B
    from efg_tpu_torch.ops.cuda import match_kernels as MK

    d = B.BUILD_DIR / "match_profile"
    d.mkdir(parents=True, exist_ok=True)
    (d / "device_match.cu").write_text(instrumented_source())
    lib_path = d / "libdevice_match.so"
    cmd = [B.nvcc(), *B.NVCC_FLAGS, "-o", str(lib_path), str(d / "device_match.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in MK._SIGNATURES["device_match"].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.efg_error_string.argtypes = [ctypes.c_int]
    lib.efg_error_string.restype = ctypes.c_char_p
    return lib


def rows_read(cost, valid):
    """The row each Dijkstra step of the plain algorithm reads (in order),
    for one problem: cost [Q, G], valid [G]."""
    from efg_tpu_torch.ops.cuda import match_kernels as MK

    steps, rows = [], []
    MK._solve_one(cost, valid, steps, rows)
    return rows


def cache_shares(cost, mask):
    """Per problem: its steps, and the steps whose row is among the first N
    valid rows, N in CACHE_ROWS."""
    out = []
    for b in range(cost.shape[0]):
        rows = rows_read(cost[b], mask[b])
        order = {r: k for k, r in enumerate(mask[b].nonzero().flatten().tolist())}
        out.append({"steps": len(rows),
                    **{f"first{n}": sum(order[r] < n for r in rows) for n in CACHE_ROWS}})
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="the file the JSON lines go to")
    args = ap.parse_args()
    global OUT
    OUT = args.out or OUT
    if not torch.cuda.is_available():
        print("match_profile: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    import chip_smoke as CS
    from efg_tpu_torch.ops.cuda import match_kernels as MK

    lib = build_instrumented()
    card = CS.nvidia_smi_line()
    for label, cost, mask in SW.capture_match():
        ref = MK.device_match_plain(cost, mask)
        c, m = cost.float().cuda(), mask.bool().cuda()
        b, q, g = cost.shape
        if b > MAX_BLOCKS:
            raise AssertionError(f"{label}: {b} problems, the copy records {MAX_BLOCKS}")
        with SW.library("device_match", lib):
            got = MK.device_match(c, m)
            torch.cuda.synchronize()
            buf = np.zeros(MAX_BLOCKS * 6, np.int64)
            err = lib.efg_prof_get(buf.ctypes.data)
            plan = MK.kernel_plan(b, q, g)
        if err or not torch.equal(got.cpu(), ref):
            raise AssertionError(f"{label}: error {err} or the copy differs from plain")
        cycles = buf.reshape(MAX_BLOCKS, 6)[:b]
        worst = int(np.argmax(cycles[:, 5]))
        k = MK.source_constants()
        free = k["kSmemLimit"] - k["kStaticSmem"] - plan["smem_bytes"]
        emit({"card": card, "label": label, "plan": plan, "valid": int(mask.sum()),
              "cycles_longest_block": dict(zip(PHASES, cycles[worst].tolist())),
              "valid_rows_longest_block": int(mask[worst].sum()),
              "cycles_mean": dict(zip(PHASES, cycles.mean(0).tolist())),
              "cache_rows_that_fit": max(free, 0) // (4 * (q | 1)),
              "steps_served_by_a_cache_of_the_first_n_valid_rows": cache_shares(cost, mask)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
