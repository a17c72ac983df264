#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (efg_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device and the repository beside it, and exits non-zero without
either. Phases (each prints JSON lines; any failure exits 1):

1. device  — card name and power limit, torch/CUDA versions, TF32 off,
             build both CUDA kernels from `efg_tpu_torch/csrc/` (parallel nvcc).
2. slice   — CenterPoint-VoxelNet at the flagship's full width (Waymo grid
             1504×1504×41, max_voxels 120000, stage caps 80k/50k/30k/25k,
             bf16 trunk activations, RPN (5,5)/(128,256)/(256,256), one task
             of 3 classes), weights from a fixed seed, serving batches of
             160k-point LiDAR-like clouds (bs 1 and 4) through the eval step
             with the flagship post-processing. Launch counts are reset
             before and read after each batch: the rank kernel must run 8
             times and the gather-GEMM 21 times per forward.
3. kernels — every kernel call of one bs=4 forward, captured with its real
             inputs, is rerun through the kernel and through its plain
             PyTorch version on the card: the rank kernel must agree
             exactly (count field everywhere, flags at valid queries), the
             gather-GEMM within 1e-3·max|ref|. Medians of 20 timed runs.
4. breakdown — one bs=4 step stage by stage (voxelize + VFE, sparse trunk,
             RPN, head, decode, post-processing, and the NMS IoU matrix and
             greedy loop), CUDA-event medians.
5. check   — a small model on the card against the same model on the CPU
             (plain versions): head maps within bf16 tolerance and equal
             NMS keep sets on identical maps.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
H100_F32_OPS = 67e12  # non-tensor f32 peak, used for the rank kernel's integer compares

FLAGSHIP = dict(
    pc_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
    voxel_size=(0.1, 0.1, 0.15),
    max_voxels=120000,
    stage_caps=(80000, 50000, 30000, 25000),
    act_dtype="bfloat16",
    neck_cfg=(("layer_nums", (5, 5)), ("ds_layer_strides", (1, 2)),
              ("ds_num_filters", (128, 256)), ("us_layer_strides", (1, 2)),
              ("us_num_filters", (256, 256))),
)
TASKS = ({"num_classes": 3, "class_names": ["VEHICLE", "PEDESTRIAN", "CYCLIST"]},)
COMMON_HEADS = (("reg", (2, 2)), ("height", (1, 2)), ("dim", (3, 2)), ("rot", (2, 2)))
POST_CFG = dict(  # the flagship config.yaml model.post_process
    post_center_limit_range=[-80, -80, -10.0, 80, 80, 10.0],
    nms=dict(nms_pre_max_size=4096, nms_post_max_size=300, nms_iou_threshold=0.7),
    score_threshold=0.1,
    out_size_factor=8,
)
BATCHES = ((1, 101), (1, 102), (4, 103), (4, 104))  # (batch size, cloud seed)
N_POINTS = 160000
TIMED_RUNS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def lidar_cloud(n_points: int, bsz: int, seed: int, pc: float = 70.0) -> np.ndarray:
    """LiDAR-like synthetic clouds [B, N, 5] (x, y, z, intensity,
    elongation): heavy-tailed radial ranges, most returns near the sensor,
    as on real spinning LiDAR."""
    rs = np.random.RandomState(seed)
    r = np.minimum(rs.exponential(scale=pc * 0.35, size=(bsz, n_points)), pc * 0.98) + 1.5
    theta = rs.uniform(-np.pi, np.pi, (bsz, n_points))
    x = (r * np.cos(theta)).astype(np.float32)
    y = (r * np.sin(theta)).astype(np.float32)
    z = (rs.randn(bsz, n_points) * 0.8).astype(np.float32)
    pts = np.stack([x, y, z], axis=-1)
    return np.concatenate([pts, rs.uniform(0, 1, (bsz, n_points, 2)).astype(np.float32)], -1)


def seeded_weights(model, seed: int) -> None:
    """Fill every parameter and BN statistic from one torch.Generator:
    He-uniform kernels, small biases, BN scale ≈ 1 and running stats near
    (0, 1), so activations stay O(1) through the trunk."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() >= 3:
                # sparse [K, Cin, Cout]: fan_in K·Cin; dense OIHW: I·kh·kw; ConvT IOhw: I·kh·kw·(1/s²)
                fan_in = t.shape[0] * t.shape[1] if t.dim() == 3 else t[0].numel()
                if "deconv" in name:
                    fan_in = t.shape[0]
                b = (6.0 / fan_in) ** 0.5
                new = uni(t.shape, -b, b)
            elif leaf == "weight":
                new = uni(t.shape, 0.8, 1.2)
            elif leaf == "bias":
                new = uni(t.shape, -0.1, 0.1)
                if name.endswith("hm_final.bias"):
                    new = new - 2.19
            elif leaf == "running_mean":
                new = uni(t.shape, -0.1, 0.1)
            elif leaf == "running_var":
                new = uni(t.shape, 0.8, 1.5)
            else:
                raise KeyError(f"no seeded init for {name}")
            t.copy_(new.to(t.dtype))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Capture:
    """Wraps the kernel wrappers' public entry points for one forward and
    records every call's real inputs (clones), then restores them."""

    def __init__(self, K):
        self.K = K
        self.rank, self.gemm = [], []

    def __enter__(self):
        K = self.K
        self._orig = (K.merge_rank_flags, K.fused_gather_gemm)
        rank0, gemm0 = self._orig

        def rank(keys, queries):
            self.rank.append((keys.clone(), queries.clone()))
            return rank0(keys, queries)

        def gemm(features, packed, weights):
            self.gemm.append((features.clone(), packed.clone(), weights.clone()))
            return gemm0(features, packed, weights)

        K.merge_rank_flags, K.fused_gather_gemm = rank, gemm
        return self

    def __exit__(self, *exc):
        self.K.merge_rank_flags, self.K.fused_gather_gemm = self._orig
        return False


def timed(fn, runs: int = TIMED_RUNS) -> float:
    """Median device milliseconds of `fn()` over `runs` launches (CUDA
    events, 3 warm-up runs)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device():
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = K.build_kernels()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "build_seconds": round(build_s, 3),
          "per_source_seconds": {k: round(v["seconds"], 3) for k, v in logs.items()},
          "ptxas": ptxas[:40]})
    return card


def make_model(kw, device):
    """(ModelDef with the flagship post-processing, model_cfg) for a
    VoxelNet of widths `kw`, weights from SEED."""
    import torch

    from efg_tpu_torch.engine.train_state import ModelDef
    from efg_tpu_torch.models import centerpoint as CP

    model = CP.VoxelNet(tasks=TASKS, common_heads=COMMON_HEADS, device="cpu", **kw)
    seeded_weights(model, SEED)
    model = model.to(torch.device(device))
    model_cfg = dict(pc_range=kw["pc_range"], voxel_size=kw["voxel_size"],
                     tasks=[dict(t) for t in TASKS], common_heads=COMMON_HEADS)
    md = ModelDef(
        model,
        lambda b: dict(points=b["points"], points_mask=b["points_mask"]),
        predict_fn=lambda preds, b: CP.predict(preds, post_cfg=POST_CFG, model_cfg=model_cfg),
    )
    return md, model_cfg


def flagship_batch(bsz: int, seed: int) -> dict:
    import torch

    pts = torch.from_numpy(lidar_cloud(N_POINTS, bsz, seed)).cuda()
    return dict(points=pts, points_mask=torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda"))


def phase_slice(md):
    """Serve the batches; returns the captured kernel inputs of the last
    (bs=4) forward and that forward's launch counts."""
    import torch

    from efg_tpu_torch.engine.trainer import eval_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    capture = counts = None
    for i, (bsz, seed) in enumerate(BATCHES):
        batch = flagship_batch(bsz, seed)
        torch.cuda.synchronize()
        last_bs4 = i == len(BATCHES) - 1
        K.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        if last_bs4:
            with Capture(K) as capture:
                out = eval_step(md, batch)
        else:
            out = eval_step(md, batch)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(K.launches)
        finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
        shapes_ok = (out["box3d"].shape == (bsz, POST_CFG["nms"]["nms_post_max_size"], 7))
        emit({"phase": "slice", "batch": i, "batch_size": bsz, "points_per_cloud": N_POINTS,
              "latency_ms_cuda_events": round(start.elapsed_time(end), 3),
              "latency_ms_host": round(wall_ms, 3), "first_request": i == 0,
              "valid_detections": int(out["valid"].sum()), "finite": finite,
              "launches": counts, "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
        if not (finite and shapes_ok):
            raise AssertionError(f"batch {i}: non-finite or misshapen outputs")
        if counts != {"rank_flags": 8, "gather_gemm": 21}:
            raise AssertionError(f"batch {i}: launches {counts}, expected rank 8 / gather-GEMM 21")
    return capture, counts


def phase_breakdown(md, model_cfg) -> None:
    """Where one bs=4 serving step spends its time: the eval step's stages
    called one after another, each timed with CUDA events (medians of 3
    runs), and the two halves of the rotated NMS on the same candidates."""
    import torch

    from efg_tpu_torch.modeling.heads.center_head import decode_boxes, post_process_sample
    from efg_tpu_torch.modeling.readers.voxel_reader import dynamic_mean_vfe
    from efg_tpu_torch.ops import nms
    from efg_tpu_torch.ops.iou_rotated import iou_bev

    m, nms_cfg = md.module, POST_CFG["nms"]
    batch = flagship_batch(*BATCHES[-1])
    stages = {}
    with torch.inference_mode():
        def stage(name, fn):
            stages[name] = timed(fn, runs=3)
            return fn()

        vox = stage("voxelize_vfe", lambda: dynamic_mean_vfe(
            batch["points"], batch["points_mask"], pc_range=m.pc_range,
            voxel_size=m.voxel_size, max_voxels=m.max_voxels,
            num_input_features=m.num_input_features))
        bev = stage("sparse_trunk", lambda: m.backbone(*vox))
        neck = stage("rpn", lambda: m.neck(bev))
        maps = stage("center_head", lambda: m.head(neck))
        boxes, scores = stage("decode", lambda: decode_boxes(
            maps[0], pc_range=model_cfg["pc_range"], voxel_size=model_cfg["voxel_size"],
            out_size_factor=POST_CFG["out_size_factor"], with_vel=False))
        stage("post_process_nms", lambda: post_process_sample(
            boxes, scores, score_threshold=POST_CFG["score_threshold"],
            post_center_range=POST_CFG["post_center_limit_range"],
            nms_iou_threshold=nms_cfg["nms_iou_threshold"],
            nms_pre_max_size=nms_cfg["nms_pre_max_size"],
            nms_post_max_size=nms_cfg["nms_post_max_size"]))
        _, top = nms._top_k(scores.max(-1).values, nms_cfg["nms_pre_max_size"])
        top_boxes = torch.gather(boxes, 1, top[..., None].expand(-1, -1, boxes.shape[-1]))
        over = stage("nms_iou_matrix", lambda: torch.stack(
            [iou_bev(b, b) > nms_cfg["nms_iou_threshold"] for b in top_boxes]))
        stage("nms_greedy_loop", lambda: nms._greedy_from_matrix(
            over, torch.ones(over.shape[:2], dtype=torch.bool, device=over.device)))
    emit({"phase": "breakdown", "batch_size": BATCHES[-1][0], "points_per_cloud": N_POINTS,
          "stage_ms_cuda_events": stages,
          "note": "nms_iou_matrix and nms_greedy_loop are the two halves of post_process_nms"})


def gemm_label(i: int) -> str:
    """Names of the 21 gather-GEMM calls of one forward, in call order."""
    names = ["conv_input"] + [f"res0{b}.conv{c}" for b in "ab" for c in (1, 2)]
    for s, down in ((1, "down1"), (2, "down2"), (3, "down3")):
        names += [down] + [f"res{s}{b}.conv{c}" for b in "ab" for c in (1, 2)]
    names.append("extra_conv")
    return names[i]


RANK_LABELS = ["subm0", "down1", "subm1", "down2", "subm2", "down3", "subm3", "extra_conv"]


def phase_kernels(capture, card: str, launches: dict):
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    rank_rows = []
    for i, (keys, queries) in enumerate(capture.rank):
        q = queries.to(torch.int32).contiguous()
        got = K.merge_rank_flags(keys, q)
        ref = K.rank_flags_plain(keys, q)
        torch.cuda.synchronize()
        valid = q < K.INVALID_Q
        count_ok = bool(torch.equal(got >> 3, ref >> 3))
        flags_ok = bool(torch.equal(got[valid], ref[valid]))
        err = int((got[valid] - ref[valid]).abs().max()) if valid.any() else 0
        if not (count_ok and flags_ok):
            raise AssertionError(f"rank_flags {RANK_LABELS[i]}: kernel disagrees with plain")
        kc = torch.clamp(keys, max=K.CLAMP_Q)
        qc = torch.where(q >= K.INVALID_Q, K.CLAMP_Q, q)
        n, vk = q.numel(), keys.numel()
        bytes_ = 4 * vk + 8 * n  # keys once, queries in, result out
        ops = n * (int(np.ceil(np.log2(max(vk, 2)))) + 3)  # binary search + 3 probes
        row = dict(label=RANK_LABELS[i], P=q.shape[0], Vq=q.shape[1], Vk=vk,
                   ms=timed(lambda: K.merge_rank_flags(keys, q)),
                   plain_ms=timed(lambda: K.rank_flags_plain(keys, q)),
                   library_ms=timed(lambda: torch.searchsorted(kc, qc, out_int32=True)),
                   bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S, ops_ms=1e3 * ops / H100_F32_OPS,
                   max_abs_err=err)
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        rank_rows.append(row)

    gemm_rows, gemm_errs = [], []
    for i, (features, packed, weights) in enumerate(capture.gemm):
        f = features.to(torch.bfloat16).contiguous()
        w = weights.to(torch.bfloat16).contiguous()
        p = packed.contiguous()
        got = K.fused_gather_gemm(f, p, w)
        ref = K.gather_gemm_plain(f, p, w)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        bound = 1e-3 * max(scale, 1e-6)
        if not err <= bound:
            raise AssertionError(f"gather_gemm {gemm_label(i)}: max|Δ| {err} > {bound}")
        gemm_errs.append(err / max(scale, 1e-30))
        v_in, c = f.shape
        n_pairs, v_out = p.shape
        o = w.shape[1]
        found = int(sum(((p >> s) & 1).sum() for s in range(3)))  # set tap flags
        bytes_ = 2 * v_in * c + 4 * n_pairs * v_out + 2 * w.numel() + 4 * v_out * o
        flops = 2 * found * c * o
        gemm_rows.append(dict(
            label=gemm_label(i), P=n_pairs, V_in=v_in, V_out=v_out, C=c, O=o, taps_found=found,
            ms=timed(lambda: K.fused_gather_gemm(f, p, w)),
            plain_ms=timed(lambda: K.gather_gemm_plain(f, p, w)),
            bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S, ops_ms=1e3 * flops / H100_BF16_FLOPS,
            max_abs_err=err, max_ref=scale))
        gemm_rows[-1]["bound_ms"] = max(gemm_rows[-1]["bytes_ms"], gemm_rows[-1]["ops_ms"])

    def total(rows, key):
        return round(sum(r[key] for r in rows), 6)

    def bound_by(rows):  # the side that dominates the summed bound
        return "bytes" if total(rows, "bytes_ms") >= total(rows, "ops_ms") else "operations"

    kernels = [
        {"name": "rank_flags", "route": "cuda", "source": "efg_tpu_torch/csrc/rank_flags.cu",
         "replaces": "efg_tpu/ops/pallas/sparse_kernels.py:882",
         "launches": launches["rank_flags"],
         "max_abs_err": max(r["max_abs_err"] for r in rank_rows),
         "ms": total(rank_rows, "ms"), "plain_ms": total(rank_rows, "plain_ms"),
         "bound_ms": total(rank_rows, "bound_ms"), "bound_by": bound_by(rank_rows),
         "library_ms": total(rank_rows, "library_ms"),
         "library_call": "torch.searchsorted (count field only)",
         "per": "sum over the 8 calls of one bs=4 forward", "tolerance": "exact",
         "card": card, "calls": rank_rows},
        {"name": "gather_gemm", "route": "cuda", "source": "efg_tpu_torch/csrc/gather_gemm.cu",
         "replaces": "efg_tpu/ops/pallas/sparse_kernels.py:259",
         "launches": launches["gather_gemm"],
         "max_abs_err": max(r["max_abs_err"] for r in gemm_rows),
         "ms": total(gemm_rows, "ms"), "plain_ms": total(gemm_rows, "plain_ms"),
         "bound_ms": total(gemm_rows, "bound_ms"), "bound_by": bound_by(gemm_rows),
         "library_ms": None, "max_rel_err": max(gemm_errs),
         "per": "sum over the 21 calls of one bs=4 forward", "tolerance": "1e-3 * max|ref|",
         "card": card, "calls": gemm_rows},
    ]
    return kernels


def phase_check():
    """Small model: the card (CUDA kernels) against the CPU (plain versions)."""
    import torch

    from efg_tpu_torch.engine.trainer import eval_step
    from efg_tpu_torch.models import centerpoint as CP

    small = dict(pc_range=(-12.8, -12.8, -2.0, 12.8, 12.8, 4.0), voxel_size=(0.1, 0.1, 0.15),
                 max_voxels=8192, stage_caps=(8192, 4096, 2048, 2048), act_dtype="bfloat16",
                 neck_cfg=(("layer_nums", (1, 1)), ("ds_layer_strides", (1, 2)),
                           ("ds_num_filters", (32, 64)), ("us_layer_strides", (1, 2)),
                           ("us_num_filters", (32, 32))))
    from efg_tpu_torch.engine.train_state import ModelDef

    (cpu, model_cfg), (gpu, _) = make_model(small, "cpu"), make_model(small, "cuda")
    pts = torch.from_numpy(lidar_cloud(20000, 2, 7, pc=12.0))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)

    def maps(md, dev):  # the eval step without predict: raw head maps
        return eval_step(ModelDef(md.module, md.apply_args),
                         dict(points=pts.to(dev), points_mask=mask.to(dev)))

    ref, got = maps(cpu, "cpu"), maps(gpu, "cuda")
    worst = 0.0
    for t_ref, t_got in zip(ref, got):
        for name in t_ref:
            a, b = t_ref[name], t_got[name].cpu()
            # bf16 activations: one rounding flip upstream moves a map value
            # by ~2^-8 of its scale, so compare at 3e-2 of each map's range
            err = float((a - b).abs().max() / max(float(a.abs().max()), 1.0))
            worst = max(worst, err)
            if not err <= 3e-2:
                raise AssertionError(f"head map {name}: card vs CPU rel err {err}")
    on_card = [{k: v.cuda() for k, v in t.items()} for t in ref]
    det_cpu = CP.predict(ref, post_cfg=POST_CFG, model_cfg=model_cfg)
    det_gpu = CP.predict(on_card, post_cfg=POST_CFG, model_cfg=model_cfg)
    same = all(torch.equal(det_cpu[k].cpu(), det_gpu[k].cpu()) for k in ("valid", "labels"))
    box_err = float((det_cpu["box3d"] - det_gpu["box3d"].cpu()).abs().max())
    emit({"phase": "check", "head_map_rel_err": worst, "predict_keep_equal": same,
          "box_max_abs_err": box_err, "valid_detections": int(det_cpu["valid"].sum())})
    if not same or box_err > 1e-4:
        raise AssertionError("predict on the card disagrees with the CPU on identical maps")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import efg_tpu_torch
    except ImportError:
        print("chip_smoke: efg_tpu_torch not found beside this script; run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(efg_tpu_torch.__file__))) != HERE:
        print(f"chip_smoke: efg_tpu_torch comes from {efg_tpu_torch.__file__}, not this "
              "checkout", file=sys.stderr)
        return 2
    try:
        card = phase_device()
        md, model_cfg = make_model(FLAGSHIP, "cuda")
        capture, launches = phase_slice(md)
        kernels = phase_kernels(capture, card, launches)
        phase_breakdown(md, model_cfg)
        phase_check()
    except Exception:  # report every phase failure and exit non-zero
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
