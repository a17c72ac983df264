#!/usr/bin/env python3
"""Time plans of the port's g3 gather-GEMM, default rank kernel and dW
kernel, of gather_gemm.cu at 256 channels, of the assignment kernel, and
the rank kernel's wrapper, on one NVIDIA card.

Run from the root of a checkout: `python3 tools/port_kernel_sweep.py
[--parent DIR] [--only rank|g3|dw|wide|match] [--out FILE]` (needs one CUDA device;
writes its JSON lines to stdout and to FILE, by default
efg_tpu_torch/build/port_kernel_sweep.jsonl). It

1. builds the kernel sources, and `efg_tpu_torch/csrc/gather_gemm_g3.cu`,
   `rank_flags.cu` and `gather_dw.cu` once more for each plan in G3_PLANS,
   RANK_PLANS and DW_PLANS: the source with the `constexpr` lines that the
   plan names replaced, compiled into efg_tpu_torch/build/sweep/ (with
   `--parent DIR`, the sources of that checkout as plan "parent" too);
2. captures, from the flagship model of chip_smoke.py (weights from its
   seed), the gather-GEMM calls of one bs=4 serving forward and the stacked
   calls and conv backwards of one bs=4 training step, and the rank calls
   of both;
3. on every call that efg_tpu's g3 gate admits, times gather_gemm.cu (and
   the parent's) and each plan in turns (device ms from CUDA graphs of the call, as
   chip_smoke.py's `graph_device`), each plan held against the plain
   version (out within 1e-3·max|ref|, stacked taps bit for bit);
4. on every rank call, times each rank_flags.cu plan in turns beside
   torch.searchsorted, each held against the plain version, and splits the
   wrapper's host time per call into its parts;
5. on every conv backward's (features, rulebook, gradient), times each
   gather_dw.cu plan (and the parent's kernel, with the C entry it has) in
   turns, each held against the plain version (1e-3·max|ref|);
6. with `--only wide`, instead of 2-5: captures from ConQueR at bench.py's
   widths (chip_smoke.py's DETR, weights from its seed) the 5 gather-GEMM
   calls at 256 channels of one bs=2 forward and the 5 stacked calls at
   256 of one bs=2 training step, and times gather_gemm.cu under each plan
   in GEMM_PLANS (and the parent's) in turns, each held against the plain
   version (out within 1e-3·max|ref|, taps bit for bit);
7. with `--only match`, instead of 2-5: captures the first training solve
   of ConQueR at bench.py's widths (bs 2, as chip_smoke.py's phase
   detr_train does) and of Mask2Former R-50 as its COCO panoptic config is
   written (LSJ 1024², bs 2, on chip_smoke.py's COCO panoptic fixture and
   seeded R-50, as its phase panoptic does), and times device_match.cu
   under each thread plan in MATCH_PLANS (and the parent's kernel through
   the parent's wrapper) in turns: ms (CUDA events around the call) and
   device ms (CUDA graph of the call), each held against the plain version
   bit for bit; beside them each plan's block argmin step (a chain of
   chip_smoke.py's ARGMIN_CHAIN_ITERS) and the serial floor it gives.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402

# Plan-line replacements of gather_gemm_g3.cu, by plan name ("as_source"
# replaces nothing). "gemm" is gather_gemm.cu's own plan (a block per
# tile, its steps and rings), so that its row measures two builds of one
# plan; "persist" its steps in persistent blocks everywhere; "persist_b"
# that with the launch bound of gather_gemm.cu's register count at C ≤ 32
# (4 blocks an SM at C = 16, 3 at C = 32); "group" a δz-group a step
# wherever a two-slot ring of them fits (C = 16, and C = 32 at O ≤ 32).
G3_PLANS = {
    "as_source": {},
    "gemm": {"GROUP": "false", "PERSIST": "false"},
    "persist": {"GROUP": "false", "PERSIST": "true"},
    "persist_b": {"GROUP": "false", "PERSIST": "true",
                  "MIN_BLOCKS": "C == 16 && O <= 32 ? 4 : (C == 32 && O <= 32 ? 3 : 2)"},
    "group": {"GROUP": "C == 16 || (C == 32 && O <= 32)", "TAPS": "C == 64 && !GROUP ? 1 : 3",
              "PERSIST": "true"},
}
# constexpr replacements of rank_flags.cu, by plan name: "exact" searches
# the span's ends exactly; "p2" and "p8" give a warp 64 and 256 queries
# (a window of 128 and 512 keys)
RANK_PLANS = {
    "as_source": {},
    "exact": {"kSlack": "0"},
    "p2": {"kPerLane": "2", "kWindow": "128"},
    "p8": {"kPerLane": "8", "kWindow": "512"},
}
# Plan-line replacements of gather_dw.cu, by plan name: "mma" mma.sync at
# every width (no wgmma); "wg_s2" a two-slot ring for the wgmma plans;
# "wg_2blk" wgmma at C = O = 64 on 64-row steps, two slots and a launch
# bound of 2 blocks an SM; "waves2" row chunks for 2 blocks per resident
# block (fewer partials); "rows4k" 4096 rows a block at C = O = 16 too
DW_PLANS = {
    "as_source": {},
    "mma": {"WG": "0"},
    "wg_s2": {"STAGES": "WG ? 2 : (C == 16 && O <= 64 ? 3 : 2)"},
    "wg_2blk": {"TM": "C >= 64 && O == 64 ? 64 : 128",
                "STAGES": "WG ? 2 : (C == 16 && O <= 64 ? 3 : 2)",
                "MIN_BLOCKS": "C >= 64 && O == 128 ? 1 : 2"},
    "waves2": {"WAVES": "2"},
    "rows4k": {"ROWS": "4096"},
}
# Plan-line replacements of gather_gemm.cu, by plan name: "lag0" waits for
# each step's wgmma group before the next step (the copies of the 256-wide
# plans then run three steps ahead)
GEMM_PLANS = {
    "as_source": {},
    "lag0": {"LAG": "0"},
}
# Plan-line replacements of device_match.cu, by plan name: ConQueR's Q =
# 1000 on 128, 256 and 1024 solving threads ("t128", "t256", "t1024")
# against the source's 512; "c2" two columns a solving thread (Mask2Former's
# Q = 100 on 64 threads, not 128)
MATCH_PLANS = {
    "as_source": {},
    "t128": {"kMaxThreads": "128"},
    "t256": {"kMaxThreads": "256"},
    "t1024": {"kMaxThreads": "1024"},
    "c2": {"kCols": "2"},
}
# the C entry of a dW kernel from before the workspace (dw zeroed by the
# caller, no row chunks)
DW_ENTRY_ZEROED = [ctypes.c_int, *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 5, ctypes.c_void_p]
OUT = os.path.join(HERE, "efg_tpu_torch", "build", "port_kernel_sweep.jsonl")


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def plan_source(stem, name, lines):
    """csrc/<stem>.cu with the `constexpr` line of each member that the plan
    names given the plan's expression; each member must name exactly one
    line."""
    from efg_tpu_torch.ops.cuda import build as B

    text = (B.CSRC / f"{stem}.cu").read_text()
    for member, expr in lines.items():
        text, n = re.subn(rf"(constexpr \w+ {member} = )[^;]+;", rf"\g<1>{expr};", text)
        if n != 1:
            raise AssertionError(f"{stem} plan {name}: {n} lines for {member}, not 1")
    return text


@contextlib.contextmanager
def library(stem, lib):
    """The kernel wrappers of `stem` launch from `lib` inside the block
    (build.load's cache holds it), and from what the cache held before
    after it."""
    from efg_tpu_torch.ops.cuda import build as B

    had, before = stem in B._LIBS, B._LIBS.get(stem)
    B._LIBS[stem] = lib
    try:
        yield
    finally:
        if had:
            B._LIBS[stem] = before
        else:
            del B._LIBS[stem]


def build_variants(stem, plans, parent=None, signatures=None, parent_signatures=None):
    """Compile csrc/<stem>.cu once per plan (its `constexpr` lines that the
    plan names replaced) and, given a parent checkout, the parent's source,
    one nvcc each, all at once, into efg_tpu_torch/build/sweep/; returns
    ({name: ctypes.CDLL}, {name: ptxas lines}). The C entries take
    `signatures` (the parent's `parent_signatures`; by default
    sparse_kernels.py's)."""
    from efg_tpu_torch.ops.cuda import build as B
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    signatures = signatures or K._SIGNATURES[stem]

    sources = {name: (plan_source(stem, name, lines), B.CSRC) for name, lines in plans.items()}
    if parent:
        csrc = os.path.join(parent, "efg_tpu_torch", "csrc")
        with open(os.path.join(csrc, f"{stem}.cu")) as f:
            sources["parent"] = (f.read(), csrc)
    procs = {}
    for name, (text, headers) in sources.items():
        d = B.BUILD_DIR / "sweep" / stem / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in os.listdir(headers):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(headers, h), d / h)
        (d / f"{stem}.cu").write_text(text)
        lib = d / f"lib{stem}.so"
        cmd = [B.nvcc(), *B.NVCC_FLAGS, "-o", str(lib), str(d / f"{stem}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, logs = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem} plan {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        sigs = parent_signatures if name == "parent" and parent_signatures else signatures
        for entry, argtypes in sigs.items():
            if hasattr(cdll, entry):  # a parent may have fewer entries
                getattr(cdll, entry).argtypes = argtypes
                getattr(cdll, entry).restype = ctypes.c_int
        if stem == "gather_dw" and not hasattr(cdll, "efg_gather_dw_chunks"):
            cdll.efg_gather_dw.argtypes = DW_ENTRY_ZEROED
        cdll.efg_error_string.argtypes = [ctypes.c_int]
        cdll.efg_error_string.restype = ctypes.c_char_p
        libs[name], logs[name] = cdll, CS.ptxas_usage(log)
    return libs, logs


def capture():
    """(forward gather-GEMM calls with labels, stacked calls with labels,
    rank calls with labels, conv backwards with labels) of one bs=4 serving
    forward and one bs=4 training step of the flagship."""
    import torch

    from efg_tpu_torch.engine.trainer import eval_step, init_state, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    md, _ = CS.make_model(CS.FLAGSHIP, "cuda")
    batch = CS.flagship_batch(*CS.BATCHES[-1])
    with CS.Capture(K) as serve:
        eval_step(md, batch)
    tx = CS.make_solver()
    state = init_state(md, tx)
    tb = CS.train_batch(*CS.TRAIN_BATCH, "cuda")
    with CS.BackwardCapture(K) as train:
        train_step(md, tx, state, tb)
    torch.cuda.synchronize()
    fwd = [(CS.gemm_label(i), c) for i, c in enumerate(serve.gemm)]
    st = [(CS.backward_label(i, call[0], conv), call)
          for i, (call, conv) in enumerate(zip(train.stacked, train.convs))]
    rank = ([(f"serve {CS.RANK_LABELS[i]}", c) for i, c in enumerate(serve.rank)]
            + [(f"train {lbl}", c) for lbl, c in zip(CS.RANK_TRAIN_LABELS, train.rank)])
    convs = [(CS.backward_label(i, call[0], conv), conv)
             for i, (call, conv) in enumerate(zip(train.stacked, train.convs))]
    del md, state, tx
    return fwd, st, rank, convs


def sweep_gemm(libs, calls, emit_taps: bool, gemm_parent=None):
    """Each admitted call through gather_gemm.cu (and, given, the parent's
    gather_gemm.cu) and every plan, in turns (two rounds, the order reversed
    in the second); returns per-call rows."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    kernel = K.gather_gemm_stacked if emit_taps else K.fused_gather_gemm
    plain = K.gather_gemm_stacked_plain if emit_taps else K.gather_gemm_plain
    rows = []
    for label, (features, packed, weights) in calls:
        with CS.switches(K, g3=True):
            if not K.use_g3(features.shape[1], packed.shape[0]):
                continue
        f = features.to(torch.bfloat16).contiguous()
        w = weights.to(torch.bfloat16).contiguous()
        p = packed.contiguous()
        ref = plain(f, p, w)
        ref_out = ref[0] if emit_taps else ref

        def run(name):
            if name == "gather_gemm.cu":
                return kernel(f, p, w)
            if name == "gather_gemm.cu parent":
                with library("gather_gemm", gemm_parent):
                    return kernel(f, p, w)
            with library("gather_gemm_g3", libs[name]), CS.switches(K, g3=True):
                return kernel(f, p, w)

        names = ["gather_gemm.cu", *(["gather_gemm.cu parent"] if gemm_parent else []), *libs]
        times = {n: [] for n in names}
        for name in names:
            got = run(name)
            torch.cuda.synchronize()
            out, st = (got if emit_taps else (got, None))
            CS._gemm_agrees(f"{name} {label}", out, ref_out, st, ref[1] if emit_taps else None)
            del got, out, st
        for order in (names, names[::-1]):
            for name in order:
                dev = CS.graph_device(lambda: run(name))
                if (dev["kernels"], dev["nodes"]) != (1, 1):
                    raise AssertionError(f"{name} {label}: {dev}")
                times[name].append(dev["device_ms"])
        n_pairs, v_out = p.shape
        row = {"label": label, "C": f.shape[1], "O": w.shape[1], "P": n_pairs, "V_out": v_out,
               "found": CS._found(p), "device_ms": {n: statistics.median(t)
                                                    for n, t in times.items()},
               "device_ms_runs": times}
        emit({"sweep": "stacked" if emit_taps else "forward", **row})
        rows.append(row)
        del ref, ref_out
    return rows


def capture_wide():
    """(forward calls, stacked calls), each [(label, (features, packed,
    weights))], at 256 channels: ConQueR's res4 in one bs=2 serving forward
    and one bs=2 training step at bench.py's widths."""
    import torch

    from efg_tpu_torch.engine.trainer import eval_step, init_state, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    def wide(call):
        return max(call[0].shape[1], call[2].shape[1]) == 256

    md = CS.make_detr(CS.DETR, "cuda")
    with CS.Capture(K) as serve:
        eval_step(md, CS.detr_batch(*CS.DETR_BATCHES[-1]))
    fwd = list(zip(CS.DETR_256_LABELS, [c for c in serve.gemm if wide(c)]))
    del md, serve
    md, _ = CS.make_detr_train(CS.DETR, "cuda")
    tx = CS.detr_solver()
    state = init_state(md, tx)
    with CS.StackedCapture(K) as train:
        train_step(md, tx, state, CS.detr_train_batch(*CS.DETR_TRAIN_BATCH, "cuda"), seed=CS.SEED)
    torch.cuda.synchronize()
    st = [(f"stacked{j} C{c[0].shape[1]}xO{c[2].shape[1]} P{c[1].shape[0]}", c)
          for j, c in enumerate(train.stacked) if wide(c)]
    del md, state, tx, train
    torch.cuda.empty_cache()
    if len(fwd) != 5 or len(st) != 5:
        raise AssertionError(f"captured {len(fwd)} forward and {len(st)} stacked calls at 256")
    return fwd, st


def sweep_wide(libs, calls, emit_taps: bool):
    """Each call through gather_gemm.cu under every plan in `libs`, in turns
    (two rounds, the order reversed in the second), each held against the
    plain version; returns per-call rows."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    kernel = K.gather_gemm_stacked if emit_taps else K.fused_gather_gemm
    plain = K.gather_gemm_stacked_plain if emit_taps else K.gather_gemm_plain
    rows = []
    for label, (features, packed, weights) in calls:
        f = features.to(torch.bfloat16).contiguous()
        w = weights.to(torch.bfloat16).contiguous()
        p = packed.contiguous()
        ref = plain(f, p, w)

        def run(name):
            with library("gather_gemm", libs[name]):
                return kernel(f, p, w)

        errs = {}
        for name in libs:
            got = run(name)
            torch.cuda.synchronize()
            out, st = (got if emit_taps else (got, None))
            errs[name], _ = CS._gemm_agrees(f"{name} {label}", out, ref[0] if emit_taps else ref,
                                            st, ref[1] if emit_taps else None)
            del got, out, st
        times = {n: [] for n in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                dev = CS.graph_device(lambda: run(name))
                if (dev["kernels"], dev["nodes"]) != (1, 1):
                    raise AssertionError(f"{name} {label}: {dev}")
                times[name].append(dev["device_ms"])
        n_pairs, v_out = p.shape
        run_steps, skipped = CS._steps(p, f.shape[1])
        row = {"label": label, "C": f.shape[1], "O": w.shape[1], "P": n_pairs, "V_out": v_out,
               "found": CS._found(p), "steps_run": run_steps, "steps_skipped": skipped,
               "max_abs_err": errs, "device_ms": {n: statistics.median(t)
                                                  for n, t in times.items()},
               "device_ms_runs": times}
        emit({"sweep": "wide_stacked" if emit_taps else "wide_forward", **row})
        rows.append(row)
        del ref
    return rows


def sweep_rank(libs, calls):
    """Each captured rank call through every rank_flags.cu plan (and the
    parent's kernel), in turns (two rounds, the order reversed in the
    second), each held against the plain version bit for bit, beside
    torch.searchsorted; then the wrapper's host time split by part (median
    µs per call over 200 calls)."""
    import torch

    from efg_tpu_torch.ops.cuda import build as B
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    rows = []
    for label, (keys, queries) in calls:
        q = queries.to(torch.int32).contiguous()
        ref = K.rank_flags_plain(keys, q)
        kc = torch.clamp(keys, max=CS.CLAMP_Q)
        qc = torch.where(q >= CS.INVALID_Q, CS.CLAMP_Q, q)

        def run(name):
            with library("rank_flags", libs[name]):
                return K.merge_rank_flags(keys, q)

        times = {n: [] for n in libs}
        for name in libs:
            got = run(name)
            torch.cuda.synchronize()
            exact = torch.equal(got, ref) if name != "parent" else CS._rank_agrees(got, ref, q)
            if not exact:
                raise AssertionError(f"rank_flags.cu {name} {label}: differs from plain")
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                dev = CS.graph_device(lambda: run(name))
                if (dev["kernels"], dev["nodes"]) != (1, 1):
                    raise AssertionError(f"{name} {label}: {dev}")
                times[name].append(dev["device_ms"])
        with library("rank_flags", libs["as_source"]):
            ms = CS.timed(lambda: K.merge_rank_flags(keys, q))
        lib_dev = CS.graph_device(lambda: torch.searchsorted(kc, qc, out_int32=True))
        row = {"label": label, "P": q.shape[0], "Vq": q.shape[1], "Vk": keys.numel(),
               "device_ms": {n: statistics.median(t) for n, t in times.items()},
               "ms": ms, "library_ms": CS.timed(lambda: torch.searchsorted(kc, qc, out_int32=True)),
               "library_device_ms": lib_dev["device_ms"]}
        emit({"sweep": "rank", **row})
        rows.append(row)

    keys, queries = calls[0][1]
    q = queries.to(torch.int32).contiguous()
    lib = B.load("rank_flags", K._SIGNATURES["rank_flags"])
    out = torch.empty_like(q)
    dev = keys.device
    stream = K._stream(dev)
    parts = {
        "merge_rank_flags": lambda: K.merge_rank_flags(keys, q),
        "_rank_flags_cuda": lambda: K._rank_flags_cuda(keys, q),
        "_require x2": lambda: (K._require(keys, "keys", torch.int32, 1, dev),
                                K._require(q, "queries", torch.int32, 2, dev)),
        "empty_like": lambda: torch.empty_like(q),
        "_stream": lambda: K._stream(dev),
        "ctypes launch": lambda: lib.efg_rank_flags(0, keys.data_ptr(), keys.shape[0],
                                                    q.data_ptr(), q.numel(), out.data_ptr(),
                                                    stream),
    }
    host = {}
    for name, fn in parts.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        host[name] = statistics.median(ts)
    emit({"sweep": "rank_wrapper_host_us", "call": calls[0][0], **host})
    return rows


def _dw_zeroed(lib, f, p, g):
    """dW through a kernel with the zeroed-output entry (DW_ENTRY_ZEROED),
    at kernel widths."""
    import torch

    from efg_tpu_torch.ops.cuda import build as B
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    v_in, c = f.shape
    n_pairs, v_out = p.shape
    o = g.shape[1]
    assert c in K.GEMM_CHANNELS and o in K.GEMM_CHANNELS, (c, o)
    dw = torch.zeros(n_pairs * 3 * c, o, dtype=torch.float32, device=f.device)
    B.check(lib, lib.efg_gather_dw(f.device.index or 0, f.data_ptr(), p.data_ptr(), g.data_ptr(),
                                   dw.data_ptr(), v_in, v_out, n_pairs, c, o,
                                   K._stream(f.device)), "gather_dw (zeroed entry) launch")
    return dw


def sweep_dw(libs, convs):
    """Each conv backward's dW through every gather_dw.cu plan (and the
    parent's kernel), in turns (two rounds, the order reversed in the
    second), each held against the plain version within 1e-3·max|ref|;
    returns per-call rows."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    rows = []
    for label, conv in convs:
        f = conv["features"].to(torch.bfloat16).contiguous()
        p, g = conv["packed"].contiguous(), conv["g"].contiguous()
        ref = K.gather_dw_plain(f, p, g)
        scale = float(ref.abs().max())

        def run(name):
            lib = libs[name]
            if not hasattr(lib, "efg_gather_dw_chunks"):
                return _dw_zeroed(lib, f, p, g)
            with library("gather_dw", lib):
                return K.fused_gather_dw(f, p, g)

        errs = {}
        for name in libs:
            got = run(name)
            torch.cuda.synchronize()
            errs[name] = float((got - ref).abs().max())
            if not errs[name] <= 1e-3 * max(scale, 1e-6):
                raise AssertionError(f"gather_dw {name} {label}: max|Δ| {errs[name]} "
                                     f"(max|ref| {scale})")
            del got
        times = {n: [] for n in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(CS.graph_device(lambda: run(name))["device_ms"])
        n_pairs, v_out = p.shape
        row = {"label": label, "C": f.shape[1], "O": g.shape[1], "P": n_pairs, "V_out": v_out,
               "found": CS._found(p), "max_ref": scale, "max_abs_err": errs,
               "device_ms": {n: statistics.median(t) for n, t in times.items()},
               "device_ms_runs": times}
        emit({"sweep": "dw", **row})
        rows.append(row)
        del ref
    return rows


def capture_match():
    """[(label, cost, mask)] on the card: the first training solve of
    ConQueR (chip_smoke.py's DETR at bench.py's widths, bs 2, weights from
    its seed) and of Mask2Former R-50 (its COCO panoptic config as written,
    one iteration through the CLI on the COCO panoptic fixture with the
    seeded R-50), each captured by chip_smoke.py's MatcherProbe."""
    import tempfile

    import numpy as np
    import torch

    from efg_tpu_torch.cli.main import experiment_relpath
    from efg_tpu_torch.engine.trainer import init_state, train_step

    md, _ = CS.make_detr_train(CS.DETR, "cuda")
    tx = CS.detr_solver()
    state = init_state(md, tx)
    with CS.MatcherProbe(record=1) as probe:
        train_step(md, tx, state, CS.detr_train_batch(*CS.DETR_TRAIN_BATCH, "cuda"), seed=CS.SEED)
    torch.cuda.synchronize()
    calls = [("conquer", *probe.calls[0][:2])]
    del md, state, tx, probe
    torch.cuda.empty_cache()

    base = tempfile.mkdtemp(prefix="port_kernel_sweep_m2f_")
    old_env = {k: os.environ.get(k) for k in ("EFG_CACHE_DIR", "EFG_PATH")}
    os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")
    os.environ["EFG_PATH"] = HERE
    try:
        root = os.path.join(base, "coco")
        CS.write_coco_panoptic_fixture(root)
        weights = os.path.join(base, "R-50.pth")
        mean = np.asarray([123.675, 116.28, 103.53], np.float32)
        std = np.asarray([58.395, 57.12, 57.375], np.float32)
        CS.torchvision_resnet50(weights, CS.fixture_images(root, mean=mean, std=std))
        config = os.path.join(CS.PANOPTIC_COCO["res50"], "config.yaml")
        out_dir = os.path.join(base, "cache", "EFG_torch",
                               experiment_relpath(os.path.join(HERE, config)))
        os.makedirs(out_dir, exist_ok=True)
        argv = ["task=train", "trainer.log_interval=1", "trainer.window_size=1",
                "solver.lr_scheduler.max_iters=1", "solver.lr_scheduler.milestones=[1]",
                f"detection.source.local.root={root}", f"model.weights={weights}",
                "trainer.evaluators="]
        with CS.MatcherProbe(module="mask2former", sync=True, record=1) as probe:
            CS._engine_run(argv, out_dir, "cuda", config=config)
        calls.append(("mask2former_r50", *probe.calls[0][:2]))
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    return calls


def parent_match_module(parent):
    """The parent checkout's ops/cuda/match_kernels.py, loaded under its
    own name (its wrapper launches whatever library build.load's cache
    holds for device_match)."""
    import importlib.util

    path = os.path.join(parent, "efg_tpu_torch", "ops", "cuda", "match_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_match_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_match(libs, calls, parent_mod=None):
    """Each captured solve through every device_match.cu plan (and the
    parent's kernel through its wrapper), in turns (two rounds, the order
    reversed in the second): ms (median of chip_smoke.py's TIMED_RUNS
    CUDA-event runs around the call) and device ms (the CUDA graph of the
    call), each held against the plain version bit for bit; returns
    per-solve rows."""
    import torch

    from efg_tpu_torch.ops.cuda import match_kernels as MK

    rows = []
    for label, cost, mask in calls:
        steps = []
        ref = MK.device_match_plain(cost, mask, steps)
        cost, mask = cost.float().cuda().contiguous(), mask.bool().cuda().contiguous()
        b, q, g = cost.shape

        def run(name):
            with library("device_match", libs[name]):
                return (parent_mod if name == "parent" else MK).device_match(cost, mask)

        plans = {}
        for name in libs:
            got = run(name).cpu()
            if not torch.equal(got, ref):
                raise AssertionError(f"device_match {name} {label}: differs from plain")
            if name != "parent":
                with library("device_match", libs[name]):
                    plans[name] = MK.kernel_plan(b, q, g)
        ms, dev = {n: [] for n in libs}, {n: [] for n in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                ms[name].append(CS.timed(lambda: run(name)))
                d = CS.graph_device(lambda: run(name))
                if d["kernels"] != 1:
                    raise AssertionError(f"device_match {name} {label}: {d}")
                dev[name].append(d["device_ms"])
        row = {"label": label, "B": b, "Q": q, "G": g, "valid": int(mask.sum()),
               "dijkstra_steps": sum(sum(s) for s in steps),
               "max_steps_a_problem": max((sum(s) for s in steps), default=0), "plans": plans,
               "ms": {n: statistics.median(t) for n, t in ms.items()}, "ms_runs": ms,
               "device_ms": {n: statistics.median(t) for n, t in dev.items()},
               "device_ms_runs": dev}
        emit({"sweep": "match", **row})
        rows.append(row)
    return rows


def match_argmin_steps(libs, parent_mod=None):
    """Each plan's block argmin step (ms) at the threads it gives Q = 1000
    and Q = 100: a chain of chip_smoke.py's ARGMIN_CHAIN_ITERS in one
    block, median of 5 CUDA-event runs; the parent's through its wrapper."""
    from efg_tpu_torch.ops.cuda import match_kernels as MK

    out = {}
    for name in libs:
        mod = parent_mod if name == "parent" else MK
        with library("device_match", libs[name]):
            out[name] = {}
            for q in (1000, 100):
                t = mod.block_threads(q)
                out[name][str(t)] = CS.timed(
                    lambda: mod.argmin_chain(t, CS.ARGMIN_CHAIN_ITERS, "cuda"),
                    runs=5) / CS.ARGMIN_CHAIN_ITERS
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent tree: its kernels join the sweep")
    ap.add_argument("--only", choices=("rank", "g3", "dw", "wide", "match"),
                    help="sweep one kernel only")
    ap.add_argument("--out", help="the file the JSON lines go to")
    args = ap.parse_args()
    global OUT
    OUT = args.out or OUT
    if not torch.cuda.is_available():
        print("port_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    card = CS.nvidia_smi_line()
    t0 = time.perf_counter()
    built = K.build_kernels()
    if args.only == "match":
        from efg_tpu_torch.ops.cuda import match_kernels as MK

        parent_mod = parent_match_module(args.parent) if args.parent else None
        libs, logs = build_variants(
            "device_match", MATCH_PLANS, args.parent, signatures=MK._SIGNATURES["device_match"],
            parent_signatures=parent_mod._SIGNATURES["device_match"] if parent_mod else None)
        emit({"card": card, "build_seconds": time.perf_counter() - t0,
              "ptxas": {"device_match": logs}})
        calls = capture_match()
        steps = match_argmin_steps(libs, parent_mod)
        emit({"sweep": "match_argmin_step_ms", **steps})
        rows = sweep_match(libs, calls, parent_mod)
        summary = {"card": card, "argmin_step_ms": steps}
        for row in rows:
            t = {n: str(p["threads"]) for n, p in row["plans"].items()}
            summary[row["label"]] = {
                "ms": row["ms"], "device_ms": row["device_ms"],
                "serial_floor_ms": {n: row["max_steps_a_problem"] * steps[n][t[n]]
                                    for n in t}}
        emit({"sweep": "summary", **summary})
        return 0
    if args.only == "wide":
        libs, logs = build_variants("gather_gemm", GEMM_PLANS, args.parent)
        emit({"card": card, "build_seconds": time.perf_counter() - t0,
              "ptxas": {"gather_gemm": logs}})
        fwd, st = capture_wide()
        summary = {"card": card}
        for kind, calls, emit_taps in (("wide_forward", fwd, False), ("wide_stacked", st, True)):
            rows = sweep_wide(libs, calls, emit_taps)
            summary[kind] = {n: sum(r["device_ms"][n] for r in rows) for n in libs}
            summary[kind + "_runs"] = {n: [sum(r["device_ms_runs"][n][k] for r in rows)
                                           for k in range(2)] for n in libs}
        emit({"sweep": "summary", **summary})
        return 0

    def want(kernel):
        return args.only in (None, kernel)

    g3_libs, g3_logs = build_variants("gather_gemm_g3", G3_PLANS, args.parent) if want("g3") \
        else ({}, {})
    gemm_parent = (build_variants("gather_gemm", {}, args.parent)[0]["parent"]
                   if args.parent and want("g3") else None)
    rank_libs, rank_logs = build_variants("rank_flags", RANK_PLANS, args.parent) \
        if want("rank") else ({}, {})
    dw_libs, dw_logs = build_variants("gather_dw", DW_PLANS, args.parent) if want("dw") \
        else ({}, {})
    emit({"card": card, "build_seconds": time.perf_counter() - t0,
          "ptxas": {"gather_gemm_g3": g3_logs, "rank_flags": rank_logs, "gather_dw": dw_logs},
          "built_ptxas": {k: CS.ptxas_usage(v["log"]) for k, v in built.items()}})
    fwd, st, rank, convs = capture()
    summary = {"card": card}
    if dw_libs:
        rows = sweep_dw(dw_libs, convs)
        summary["dw"] = {n: sum(r["device_ms"][n] for r in rows) for n in dw_libs}
        summary["dw_calls"] = len(rows)
    if rank_libs:
        rows = sweep_rank(rank_libs, rank)
        summary["rank_train_step"] = {n: sum(r["device_ms"][n] for r in rows[8:])
                                      for n in rank_libs}
        summary["rank_serve"] = {n: sum(r["device_ms"][n] for r in rows[:8]) for n in rank_libs}
        summary["rank_library_train_step"] = sum(r["library_device_ms"] for r in rows[8:])
    for kind, calls, emit_taps in (("forward", fwd, False), ("stacked", st, True)):
        if not g3_libs:
            break
        rows = sweep_gemm(g3_libs, calls, emit_taps, gemm_parent)
        summary[kind] = {n: sum(r["device_ms"][n] for r in rows) for n in rows[0]["device_ms"]}
        summary[kind + "_calls"] = len(rows)
    emit({"sweep": "summary", **summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
