#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (efg_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device and the repository beside it, and exits non-zero without
either. Phases (each prints JSON lines; any failure exits 1):

1. device  — card name and power limit, torch/CUDA versions, TF32 off,
             build every CUDA kernel source in `efg_tpu_torch/csrc/`
             (one nvcc per source, all started together).
2. slice   — CenterPoint-VoxelNet at the flagship's full width (Waymo grid
             1504×1504×41, max_voxels 120000, stage caps 80k/50k/30k/25k,
             bf16 trunk activations, RPN (5,5)/(128,256)/(256,256), one task
             of 3 classes), weights from a fixed seed, serving batches of
             160k-point LiDAR-like clouds (bs 1 and 4) through the eval step
             with the flagship post-processing. Launch counts are reset
             before and read after each batch: the rank kernel must run 8
             times and the gather-GEMM 21 times per forward, the backward
             kernels never.
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
6. train   — the same flagship model trains on bs=4 clouds with ~160 GT
             boxes per frame (the flagship solver: clip 10, AdamW, OneCycle):
             one warm-up step, timed steps, then one step whose kernel
             calls are captured. Per step the launch counts are reset before and read
             after: rank 12 (8 forward + 4 inverse rulebooks), gather-GEMM
             21, its stacked variant 21 (one per conv backward), dW 0. Then
             one step timed part by part (forward, targets + loss,
             backward, optimizer).
7. train_kernels — every backward kernel call of the captured step rerun
             on its captured inputs through the kernel and its plain
             version: stacked gather-GEMM (taps bit-exact, out within
             1e-3·max|ref|), the dW kernel on every conv's (features,
             rulebook, gradient) against its plain version and against the
             dW the stacked path produced (1e-3·max|ref|), and the rank
             kernel on all 12 rulebook builds (exact). Medians of 20 runs.
             One stage-0 conv cut to C=5, O=8 runs the wrappers' padding
             branch through the dW kernel and the gather-GEMM.
8. train_profile — one more flagship training step under torch.profiler,
             its parts separated by device synchronization: per part the
             wall time, device busy time, idle share and kernel count; the
             kernels that take the most device time.
9. train_check — a small model trains 3 steps on the card and on the CPU
             (plain versions) from the same weights and batches: step 1's
             gradient of every parameter, and the losses and grad_norm of
             every step, within fixed bf16 tolerances; a third run on the
             card with a planted fault (one conv's dW doubled) must fail.

The second-to-last line lists every kernel as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import json
import os
import re
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
LOSS_CFG = dict(out_size_factor=8, gaussian_overlap=0.1, max_objs=500, min_radius=2,
                code_weights=[1.0] * 8, weight=2)  # the flagship config.yaml model.loss
# The flagship config.yaml solver. OneCycle needs max_iters, which the
# config derives from 36 epochs of Waymo frames; the frame count is not in
# the repository, so it is stated here (the steps run sit in the warm-up).
MAX_ITERS = 100_000
SOLVER = dict(
    scheduler=dict(type="OneCycle", lr=0.003, max_iters=MAX_ITERS, pct_start=0.4,
                   base_momentum=0.85, max_momentum=0.95, div_factor=10.0),
    optimizer=dict(type="AdamW", lr=0.003, weight_decay=0.01, betas=(0.9, 0.99)),
    grad_clipper=dict(enabled=True, clip_type="norm", params=dict(max_norm=10.0)),
)
TRAIN_BATCH = (4, 201)  # (batch size, seed)
MAX_GT = 500  # the flagship's dataset.max_gt
TRAIN_STEPS = 3  # timed, after one warm-up step
# launches per serving forward and per training step (21 sparse convs; 4
# of them strided, each with an inverse rulebook when trained; every conv's
# cout is a multiple of 16, so dW always comes from the stacked taps)
SERVE_LAUNCHES = {"rank_flags": 8, "gather_gemm": 21, "gather_gemm_stacked": 0, "gather_dw": 0}
TRAIN_LAUNCHES = {"rank_flags": 12, "gather_gemm": 21, "gather_gemm_stacked": 21, "gather_dw": 0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def lidar_frames(n_points: int, bsz: int, seed: int, pc: float = 70.0, max_gt: int = 0) -> dict:
    """LiDAR-like synthetic frames (a numpy copy of `__graft_entry__._batch`):
    clouds [B, N, 5] (x, y, z, intensity, elongation) with heavy-tailed
    radial ranges, most returns near the sensor, as on real spinning LiDAR;
    with `max_gt`, about 2.3·pc GT boxes per frame (161 at pc = 70) as
    gt_boxes [B, max_gt, 9], gt_classes (1-3, 0 = padding) and gt_mask."""
    rs = np.random.RandomState(seed)
    r = np.minimum(rs.exponential(scale=pc * 0.35, size=(bsz, n_points)), pc * 0.98) + 1.5
    theta = rs.uniform(-np.pi, np.pi, (bsz, n_points))
    x = (r * np.cos(theta)).astype(np.float32)
    y = (r * np.sin(theta)).astype(np.float32)
    z = (rs.randn(bsz, n_points) * 0.8).astype(np.float32)
    pts = np.stack([x, y, z], axis=-1)
    pts = np.concatenate([pts, rs.uniform(0, 1, (bsz, n_points, 2)).astype(np.float32)], -1)
    if not max_gt:
        return dict(points=pts)
    n_gt = min(max(4, min(max_gt, int(pc * 2.3))), max_gt)
    gt = np.zeros((bsz, max_gt, 9), np.float32)
    gt[:, :n_gt, :2] = rs.uniform(-pc * 0.9, pc * 0.9, (bsz, n_gt, 2))
    gt[:, :n_gt, 2] = rs.uniform(-1.0, 1.5, (bsz, n_gt))
    gt[:, :n_gt, 3:6] = rs.uniform(0.8, 5.5, (bsz, n_gt, 3))
    gt[:, :n_gt, 8] = rs.uniform(-np.pi, np.pi, (bsz, n_gt))
    cls = np.zeros((bsz, max_gt), np.int32)
    cls[:, :n_gt] = rs.randint(1, 4, (bsz, n_gt))
    mask = np.zeros((bsz, max_gt), bool)
    mask[:, :n_gt] = True
    return dict(points=pts, gt_boxes=gt, gt_classes=cls, gt_mask=mask)


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
    """(ModelDef with the flagship loss and post-processing, model_cfg) for
    a VoxelNet of widths `kw`, weights from SEED."""
    import torch

    from efg_tpu_torch.engine.train_state import ModelDef
    from efg_tpu_torch.models import centerpoint as CP

    model = CP.VoxelNet(tasks=TASKS, common_heads=COMMON_HEADS, device="cpu", **kw)
    seeded_weights(model, SEED)
    model = model.to(torch.device(device))
    model_cfg = dict(pc_range=kw["pc_range"], voxel_size=kw["voxel_size"],
                     tasks=[dict(t) for t in TASKS], common_heads=COMMON_HEADS, loss=LOSS_CFG)
    md = ModelDef(
        model,
        lambda b: dict(points=b["points"], points_mask=b["points_mask"]),
        loss_fn=lambda preds, b: CP.compute_loss(preds, b, model_cfg=model_cfg),
        predict_fn=lambda preds, b: CP.predict(preds, post_cfg=POST_CFG, model_cfg=model_cfg),
    )
    return md, model_cfg


def flagship_batch(bsz: int, seed: int) -> dict:
    import torch

    pts = torch.from_numpy(lidar_frames(N_POINTS, bsz, seed)["points"]).cuda()
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
        if counts != SERVE_LAUNCHES:
            raise AssertionError(f"batch {i}: launches {counts}, expected {SERVE_LAUNCHES}")
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
    """Every kernel call of the captured bs=4 serving forward, on the card,
    against its plain version; returns the kernel rows by name."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    rank_rows = [_rank_row(RANK_LABELS[i], k, q) for i, (k, q) in enumerate(capture.rank)]
    gemm_rows = []
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
        v_in, c = f.shape
        n_pairs, v_out = p.shape
        o = w.shape[1]
        found = _found(p)
        bytes_ = 2 * v_in * c + 4 * n_pairs * v_out + 2 * w.numel() + 4 * v_out * o
        gemm_rows.append(dict(
            label=gemm_label(i), P=n_pairs, V_in=v_in, V_out=v_out, C=c, O=o, taps_found=found,
            ms=timed(lambda: K.fused_gather_gemm(f, p, w)),
            plain_ms=timed(lambda: K.gather_gemm_plain(f, p, w)),
            bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S,
            ops_ms=1e3 * 2 * found * c * o / H100_BF16_FLOPS,
            max_abs_err=err, max_ref=scale))
        gemm_rows[-1]["bound_ms"] = max(gemm_rows[-1]["bytes_ms"], gemm_rows[-1]["ops_ms"])
    per = "sum over the {} calls of one bs=4 serving forward"
    rows = {
        "rank_flags": kernel_row("rank_flags", "rank_flags.cu", 882, launches["rank_flags"],
                                 rank_rows, library_call="torch.searchsorted (count field only)",
                                 tolerance="exact", per=per.format(8), card=card),
        "gather_gemm": kernel_row("gather_gemm", "gather_gemm.cu", 259, launches["gather_gemm"],
                                  gemm_rows, tolerance="1e-3 * max|ref|", per=per.format(21),
                                  card=card),
    }
    emit({"phase": "kernels", "summary": list(rows.values()), "rank_calls": rank_rows,
          "gemm_calls": gemm_rows})
    return rows


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
    pts = torch.from_numpy(lidar_frames(20000, 2, 7, pc=12.0)["points"])
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


def train_batch(bsz: int, seed: int, device, n_points: int = N_POINTS, pc: float = 70.0) -> dict:
    import torch

    frames = lidar_frames(n_points, bsz, seed, pc=pc, max_gt=MAX_GT)
    batch = {k: torch.from_numpy(v).to(device) for k, v in frames.items()}
    batch["points_mask"] = torch.ones(batch["points"].shape[:2], dtype=torch.bool, device=device)
    return batch


def make_solver():
    from efg_tpu_torch.solver.optimizers import build_optimizer
    from efg_tpu_torch.solver.schedulers import build_scheduler

    lr, mom = build_scheduler(SOLVER["scheduler"])
    return build_optimizer(SOLVER["optimizer"], lr, mom, grad_clip_cfg=SOLVER["grad_clipper"])


class BackwardCapture:
    """Records, during one training step, every rank-kernel call, every
    stacked gather-GEMM call and every sparse conv backward (its features,
    forward rulebook, masked output gradient and the dW it returned)."""

    def __init__(self, K):
        self.K = K
        self.rank, self.stacked, self.convs = [], [], []

    def __enter__(self):
        import torch

        K = self.K
        self._orig = (K.merge_rank_flags, K.gather_gemm_stacked, K.subm_conv9_backward,
                      K.strided_conv_backward)
        rank0, stacked0, subm0, strided0 = self._orig

        def rank(keys, queries):
            self.rank.append((keys.clone(), queries.clone()))
            return rank0(keys, queries)

        def stacked(features, packed, weights):
            self.stacked.append((features.clone(), packed.clone(), weights.clone()))
            return stacked0(features, packed, weights)

        def record(kind, features, packed, out_valid, g, dw):
            gm = (g * out_valid[:, None].to(g.dtype)).to(torch.bfloat16)
            self.convs.append(dict(kind=kind, features=features.detach().clone(), packed=packed,
                                   g=gm, dw=dw.reshape(-1, dw.shape[-1]).float().clone()))

        def subm(features, weights, packed, out_valid, g):
            d, dw = subm0(features, weights, packed, out_valid, g)
            record("subm", features, packed, out_valid, g, dw)
            return d, dw

        def strided(features, w2d, packed, out_valid, inv, kw3, g):
            d, dw = strided0(features, w2d, packed, out_valid, inv, kw3, g)
            record("strided", features, packed, out_valid, g, dw)
            return d, dw

        K.merge_rank_flags, K.gather_gemm_stacked = rank, stacked
        K.subm_conv9_backward, K.strided_conv_backward = subm, strided
        return self

    def __exit__(self, *exc):
        K = self.K
        (K.merge_rank_flags, K.gather_gemm_stacked, K.subm_conv9_backward,
         K.strided_conv_backward) = self._orig
        return False


def phase_train(md, card: str):
    """Train the flagship model: a warm-up step, TRAIN_STEPS timed steps,
    one step whose kernel calls are captured, then one step timed part by
    part. Returns the capture and the per-step launch counts."""
    import torch

    from efg_tpu_torch.engine.trainer import apply_grads, init_state, train_forward, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    tx = make_solver()
    state = init_state(md, tx)
    batch = train_batch(*TRAIN_BATCH, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    capture = counts = None
    for i in range(TRAIN_STEPS + 2):  # warm-up, timed steps, then one captured step
        captured = i == TRAIN_STEPS + 1
        K.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if captured:
            with BackwardCapture(K) as capture:
                metrics = train_step(md, tx, state, batch)
        else:
            metrics = train_step(md, tx, state, batch)
        end.record()
        torch.cuda.synchronize()
        counts = dict(K.launches)
        ms = start.elapsed_time(end)
        vals = {k: float(v) for k, v in metrics.items()}
        emit({"phase": "train", "step": i, "kind": "warm-up" if i == 0 else
              "captured" if captured else "timed", "batch_size": TRAIN_BATCH[0],
              "points_per_cloud": N_POINTS, "gt_boxes_per_frame": int(batch["gt_mask"][0].sum()),
              "step_ms_cuda_events": round(ms, 3),
              "train_frames_per_s": round(TRAIN_BATCH[0] / ms * 1e3, 3),
              "losses": vals, "launches": counts,
              "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2**30, 3), "card": card})
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: non-finite losses {vals}")
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"train step {i}: launches {counts}, expected {TRAIN_LAUNCHES}")
    if len(capture.convs) != 21 or len(capture.stacked) != 21:
        raise AssertionError(f"captured {len(capture.convs)} conv backwards and "
                             f"{len(capture.stacked)} stacked calls, expected 21 each")

    # one more step, split into the parts train_step runs
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    preds = train_forward(md, state, batch)
    ev[1].record()
    losses = md.loss_fn(preds, batch)
    ev[2].record()
    losses["loss"].backward()
    ev[3].record()
    apply_grads(tx, state)
    ev[4].record()
    torch.cuda.synchronize()
    parts = ("forward", "targets_and_loss", "backward", "optimizer")
    emit({"phase": "train_breakdown", "batch_size": TRAIN_BATCH[0],
          "part_ms_cuda_events": {n: round(ev[j].elapsed_time(ev[j + 1]), 3)
                                  for j, n in enumerate(parts)},
          "step_ms": round(ev[0].elapsed_time(ev[4]), 3), "loss": float(losses["loss"].detach()),
          "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2**30, 3), "card": card})
    return capture, counts


RANK_TRAIN_LABELS = ["subm0", "down1", "down1.inverse", "subm1", "down2", "down2.inverse",
                     "subm2", "down3", "down3.inverse", "subm3", "extra_conv", "extra_conv.inverse"]


def _rank_row(label, keys, queries):
    """Kernel vs plain on one captured rank call (exact), with times and
    bound."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    q = queries.to(torch.int32).contiguous()
    got = K.merge_rank_flags(keys, q)
    ref = K.rank_flags_plain(keys, q)
    torch.cuda.synchronize()
    valid = q < K.INVALID_Q
    if not (torch.equal(got >> 3, ref >> 3) and torch.equal(got[valid], ref[valid])):
        raise AssertionError(f"rank_flags {label}: kernel disagrees with plain")
    kc = torch.clamp(keys, max=K.CLAMP_Q)
    qc = torch.where(q >= K.INVALID_Q, K.CLAMP_Q, q)
    n, vk = q.numel(), keys.numel()
    bytes_ = 4 * vk + 8 * n  # keys once, queries in, result out
    ops = n * (int(np.ceil(np.log2(max(vk, 2)))) + 3)  # binary search + 3 probes
    row = dict(label=label, P=q.shape[0], Vq=q.shape[1], Vk=vk,
               ms=timed(lambda: K.merge_rank_flags(keys, q)),
               plain_ms=timed(lambda: K.rank_flags_plain(keys, q)),
               library_ms=timed(lambda: torch.searchsorted(kc, qc, out_int32=True)),
               bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S, ops_ms=1e3 * ops / H100_F32_OPS,
               max_abs_err=int((got[valid] - ref[valid]).abs().max()) if valid.any() else 0)
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    return row


def _found(packed):
    return int(sum(((packed >> s) & 1).sum() for s in range(3)))  # set tap flags


def phase_train_kernels(capture, card: str, launches: dict):
    """Every backward kernel call of the captured training step, on the
    card, against its plain version; returns the kernel rows."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    if len(capture.rank) != len(RANK_TRAIN_LABELS):
        raise AssertionError(f"captured {len(capture.rank)} rank calls, expected 12")
    rank_rows = [_rank_row(lbl, k, q) for lbl, (k, q) in zip(RANK_TRAIN_LABELS, capture.rank)]

    # each conv backward makes one stacked call, in the order autograd runs them
    st_rows, dw_rows = [], []
    for i, ((g, packed, w), conv) in enumerate(zip(capture.stacked, capture.convs)):
        label = f"backward {i}: {conv['kind']} C={conv['features'].shape[1]} O={g.shape[1]}"
        gb = g.to(torch.bfloat16).contiguous()
        wb = w.to(torch.bfloat16).contiguous()
        p = packed.contiguous()
        out, st = K.gather_gemm_stacked(gb, p, wb)
        ref_out, ref_st = K.gather_gemm_stacked_plain(gb, p, wb)
        torch.cuda.synchronize()
        scale = float(ref_out.abs().max())
        err = float((out - ref_out).abs().max())
        if not (torch.equal(st, ref_st) and err <= 1e-3 * max(scale, 1e-6)):
            raise AssertionError(f"gather_gemm_stacked {label}: taps equal "
                                 f"{torch.equal(st, ref_st)}, "
                                 f"out max|Δ| {err} (max|ref| {scale})")
        v_in, c = gb.shape
        n_pairs, v_out = p.shape
        o = wb.shape[1]
        found = _found(p)
        bytes_ = (2 * v_in * c + 4 * n_pairs * v_out + 2 * wb.numel() + 4 * v_out * o
                  + 2 * v_out * n_pairs * 3 * c)
        row = dict(label=label, P=n_pairs, V_in=v_in, V_out=v_out, C=c, O=o, taps_found=found,
                   ms=timed(lambda: K.gather_gemm_stacked(gb, p, wb)),
                   plain_ms=timed(lambda: K.gather_gemm_stacked_plain(gb, p, wb)),
                   bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S,
                   ops_ms=1e3 * 2 * found * c * o / H100_BF16_FLOPS,
                   max_abs_err=err, max_ref=scale, taps_bit_exact=True)
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        st_rows.append(row)

        # the dense dW of the stacked path: stackedᵀ @ features, f32 (library call)
        f = conv["features"].to(torch.bfloat16).contiguous()
        st_f32, f_f32 = st.float(), f.float()
        lib_ms = timed(lambda: torch.matmul(st_f32.t(), f_f32))

        # the dW kernel on the same conv: (features, forward rulebook, g)
        fp, gm, dw_stacked = conv["packed"].contiguous(), conv["g"].contiguous(), conv["dw"]
        dw = K.fused_gather_dw(f, fp, gm)
        ref_dw = K.gather_dw_plain(f, fp, gm)
        torch.cuda.synchronize()
        scale = float(ref_dw.abs().max())
        err_plain = float((dw - ref_dw).abs().max())
        err_stacked = float((dw - dw_stacked).abs().max())
        if not (err_plain <= 1e-3 * max(scale, 1e-6) and err_stacked <= 1e-3 * max(scale, 1e-6)):
            raise AssertionError(f"gather_dw {label}: max|Δ| {err_plain} vs plain, {err_stacked} "
                                 f"vs the stacked path (max|ref| {scale})")
        v_in, c = f.shape
        n_pairs, v_out = fp.shape
        o = gm.shape[1]
        found = _found(fp)
        bytes_ = 2 * v_in * c + 4 * n_pairs * v_out + 2 * v_out * o + 4 * n_pairs * 3 * c * o
        row = dict(label=label, P=n_pairs, V_in=v_in, V_out=v_out, C=c, O=o, taps_found=found,
                   ms=timed(lambda: K.fused_gather_dw(f, fp, gm)),
                   plain_ms=timed(lambda: K.gather_dw_plain(f, fp, gm)),
                   library_ms=lib_ms, bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S,
                   ops_ms=1e3 * 2 * found * c * o / H100_BF16_FLOPS,
                   max_abs_err=err_plain, max_abs_err_vs_stacked=err_stacked, max_ref=scale)
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        dw_rows.append(row)
        del st, st_f32, f_f32, ref_st

    emit({"phase": "train_kernels", "card": card, "rank_calls": rank_rows,
          "stacked_calls": st_rows, "dw_calls": dw_rows, "padding_cases": _padding_cases(capture)})
    per_step = "sum over the calls of one bs=4 training step"
    rows = [
        kernel_row("rank_flags", "rank_flags.cu", 882, launches["rank_flags"], rank_rows,
                   library_call="torch.searchsorted (count field only)", tolerance="exact",
                   per=per_step + " (8 forward + 4 inverse rulebooks)", card=card),
        kernel_row("gather_gemm_stacked", "gather_gemm.cu", 259, launches["gather_gemm_stacked"],
                   st_rows, tolerance="taps bit-exact, out 1e-3 * max|ref|",
                   per=per_step + " (one per conv backward)", card=card),
        kernel_row("gather_dw", "gather_dw.cu", 652, launches["gather_dw"], dw_rows,
                   library_call="torch.matmul of the stacked taps (the dense dW the stacked path "
                                "runs instead), f32 operands",
                   tolerance="1e-3 * max|ref| vs plain and vs the stacked path",
                   per="sum over the 21 conv backwards of one bs=4 training step (run on their "
                       "captured inputs; the training step itself takes dW from the stacked taps)",
                   card=card),
    ]
    return {r["name"]: r for r in rows}


def _padding_cases(capture):
    """The wrappers' padding branch, which the flagship never takes (its C
    and O are kernel widths) but which is the only case where efg_tpu runs
    its dW kernel (cout % 16 ≠ 0): a captured stage-0 SubM backward cut to
    conv_input's 5 input channels and 8 output channels, through the dW
    kernel and the gather-GEMM, each against its plain version within
    1e-3·max|ref|."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    conv = next(c for c in capture.convs if c["kind"] == "subm" and c["features"].shape[1] == 16)
    f = conv["features"][:, :5].to(torch.bfloat16).contiguous()
    g = conv["g"][:, :8].contiguous()
    p = conv["packed"].contiguous()
    gen = torch.Generator().manual_seed(SEED)
    w = (torch.randn(p.shape[0] * 3 * 5, 8, generator=gen) * 0.1).to("cuda", torch.bfloat16)
    rows = []
    for name, got, ref in (
            ("gather_dw C=5 O=8", K.fused_gather_dw(f, p, g), K.gather_dw_plain(f, p, g)),
            ("gather_gemm C=5 O=8", K.fused_gather_gemm(f, p, w), K.gather_gemm_plain(f, p, w))):
        torch.cuda.synchronize()
        scale, err = float(ref.abs().max()), float((got - ref).abs().max())
        rows.append({"label": name, "shape": list(got.shape), "max_abs_err": err, "max_ref": scale})
        if not (got.shape == ref.shape and err <= 1e-3 * max(scale, 1e-6)):
            raise AssertionError(f"{name}: max|Δ| {err} (max|ref| {scale}), shape {got.shape}")
    return rows


def kernel_row(name, source, replaces_line, launches, rows, *, tolerance, per, card,
               library_call=None):
    """One entry of the final kernels line, summed over `rows`."""
    def total(key):
        return round(sum(r[key] for r in rows), 6)

    row = {"name": name, "route": "cuda", "source": f"efg_tpu_torch/csrc/{source}",
           "replaces": f"efg_tpu/ops/pallas/sparse_kernels.py:{replaces_line}",
           "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
           "bound_by": "bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
           "library_ms": total("library_ms") if library_call else None,
           "per": per, "tolerance": tolerance, "card": card, "calls": len(rows)}
    if library_call:
        row["library_call"] = library_call
    return row


# conv biases that feed a train-mode BN: their true gradient is zero, and
# what the backward leaves there is rounding noise
ZERO_GRAD = re.compile(r"(conv[012]|shared_conv)\.bias$")
# train_check's fixed bf16 tolerances: per-leaf relative L2 error of step
# 1's gradients, and relative error of (loss and its parts, grad_norm) at
# step 1 and at steps 2-3. Set from the readings of an H100 run (PERF.md):
# leaves ≤ 0.465 (the planted fault reads 1.10), step 1 ≤ 2.4e-3 and
# 4.5e-3, steps 2-3 ≤ 5.9e-2 and 0.110
CHECK_LEAF_TOL = 0.8
CHECK_STEP_TOL = {False: (1e-2, 2e-2), True: (1.5e-1, 2.5e-1)}
CHECK_FAULT = "backbone.down1.weight"  # the planted fault doubles this gradient


def _check_readings(a_out, a_grads, b_out, b_grads):
    """Readings of run a against run b, each beside its tolerance, and the
    names of those above it."""
    readings, failed = [], []

    def hold(what, x, tol):
        readings.append({"what": what, "reading": x, "tolerance": tol})
        if not x <= tol:
            failed.append(what)

    for n, g in b_grads.items():
        if not ZERO_GRAD.search(n):
            hold(f"grad {n}", float((a_grads[n] - g).norm() / max(float(g.norm()), 1e-30)),
                 CHECK_LEAF_TOL)
    for i, (a, b) in enumerate(zip(a_out, b_out)):
        for k in ("loss", "0_hm_loss", "0_loc_loss", "grad_norm"):
            hold(f"step {i} {k}", abs(a[k] - b[k]) / abs(b[k]),
                 CHECK_STEP_TOL[i > 0][k == "grad_norm"])
    return readings, failed


def phase_train_check(device="cuda"):
    """A small model trains 3 steps on the card and on the CPU (plain
    versions) from the same weights and batches, then once more on the card
    with a planted fault (the strided conv down1's dW doubled), which the
    check must reject.

    Held at fixed bf16 tolerances: the relative L2 error of step 1's
    gradient of every parameter (CHECK_LEAF_TOL; the conv biases that feed
    a train-mode BN, whose true gradient is zero, excepted), and the loss,
    its parts and grad_norm per step (CHECK_STEP_TOL, tighter at step 1:
    after it, AdamW moves every weight by about ±lr whatever its gradient's
    size, so a gradient entry at rounding-noise level moves either way)."""
    import torch

    from efg_tpu_torch.engine.trainer import init_state, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    small = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 4.0), voxel_size=(0.1, 0.1, 0.15),
                 max_voxels=2048, stage_caps=(2048, 2048, 2048, 2048), act_dtype="bfloat16",
                 neck_cfg=(("layer_nums", (1, 1)), ("ds_layer_strides", (1, 2)),
                           ("ds_num_filters", (32, 64)), ("us_layer_strides", (1, 2)),
                           ("us_num_filters", (32, 32))))
    batches = [train_batch(2, 300 + i, "cpu", n_points=3000, pc=6.0) for i in range(3)]
    strided = K.strided_conv_backward

    def doubled_down1_dw(features, w2d, packed, out_valid, inv, kw3, g):
        d, dw = strided(features, w2d, packed, out_valid, inv, kw3, g)
        return d, dw * 2 if w2d.shape[1] == 32 else dw

    def run(device, fault=False):
        md, _ = make_model(small, device)
        tx = make_solver()
        state = init_state(md, tx)
        out, grads = [], None
        K.strided_conv_backward = doubled_down1_dw if fault else strided
        try:
            for b in batches:
                m = train_step(md, tx, state, {k: v.to(device) for k, v in b.items()})
                out.append({k: float(v) for k, v in m.items()})
                if grads is None:
                    grads = {n: p.grad.float().cpu() for n, p in md.module.named_parameters()}
        finally:
            K.strided_conv_backward = strided
        return out, grads

    cpu = run("cpu")
    readings, failed = _check_readings(*run(device), *cpu)
    fault_readings, fault_failed = _check_readings(*run(device, fault=True), *cpu)
    keys = ("loss", "0_hm_loss", "0_loc_loss", "grad_norm")
    emit({"phase": "train_check", "cpu": [{k: r[k] for k in keys} for r in cpu[0]],
          "grad_readings_worst": sorted((r for r in readings if r["what"].startswith("grad")),
                                        key=lambda r: -r["reading"])[:8],
          "grad_leaves": sum(r["what"].startswith("grad") for r in readings),
          "step_readings": [r for r in readings if r["what"].startswith("step")],
          "worst_reading_over_tolerance": max(r["reading"] / r["tolerance"] for r in readings),
          "planted_fault": {"leaf": CHECK_FAULT, "rejected_by": fault_failed,
                            "readings": [r for r in fault_readings
                                         if r["what"] == f"grad {CHECK_FAULT}"]}})
    if failed:
        raise AssertionError(f"train_check: above tolerance: {failed}")
    if f"grad {CHECK_FAULT}" not in fault_failed:
        raise AssertionError("train_check: the planted fault (down1's dW doubled) passed")


def phase_train_profile(md, card: str):
    """One flagship bs=4 training step (after a warm-up step) under
    torch.profiler, its four parts separated by device synchronization:
    per part the wall time, the device's busy time (union of its kernel and
    copy intervals), the idle share and the kernel count, and the kernels
    that take the most device time. The profiler adds host time per
    launch, so the idle shares it reads are an upper bound for the step run
    without it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from efg_tpu_torch.engine.trainer import apply_grads, init_state, train_forward, train_step

    tx = make_solver()
    state = init_state(md, tx)
    batch = train_batch(*TRAIN_BATCH, "cuda")
    train_step(md, tx, state, batch)
    torch.cuda.synchronize()

    def part(name, fn):
        with record_function(f"part:{name}"):
            out = fn()
            torch.cuda.synchronize()
        return out

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        preds = part("forward", lambda: train_forward(md, state, batch))
        losses = part("targets_and_loss", lambda: md.loss_fn(preds, batch))
        part("backward", lambda: losses["loss"].backward())
        part("optimizer", lambda: apply_grads(tx, state))
    events = prof.events()
    # device-side events, without the profiler's own range annotations
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and not e.name.startswith("part:")]
    if not device:
        raise AssertionError("train_profile: the profiler recorded no device activity")

    def busy_us(evs):
        total, end = 0.0, float("-inf")
        for e in sorted(evs, key=lambda e: e.time_range.start):
            s, t = e.time_range.start, e.time_range.end
            if t > end:
                total += t - max(s, end)
                end = t
        return total

    parts = {}
    for e in events:
        if e.name.startswith("part:") and e.device_type != DeviceType.CUDA:
            lo, hi = e.time_range.start, e.time_range.end
            inside = [d for d in device if lo <= d.time_range.start < hi]
            busy = busy_us(inside)
            parts[e.name[5:]] = {"wall_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
                                 "device_idle_share": 1 - busy / max(hi - lo, 1e-9),
                                 "device_events": len(inside)}
    wall = sum(p["wall_ms"] for p in parts.values())
    busy = sum(p["device_busy_ms"] for p in parts.values())
    per_kernel = {}
    for d in device:
        k = per_kernel.setdefault(d.name, [0, 0.0])
        k[0] += 1
        k[1] += (d.time_range.end - d.time_range.start) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    emit({"phase": "train_profile", "card": card, "batch_size": TRAIN_BATCH[0], "parts": parts,
          "step_wall_ms": wall, "step_device_busy_ms": busy,
          "step_device_idle_share": 1 - busy / wall,
          "device_events": len(device),
          "top_device_time": [{"name": n[:120], "count": c, "ms": ms} for n, (c, ms) in top]})


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
        serve = phase_kernels(capture, card, launches)
        del capture
        phase_breakdown(md, model_cfg)
        phase_check()
        capture, launches = phase_train(md, card)
        train = phase_train_kernels(capture, card, launches)
        del capture
        phase_train_profile(md, card)
        phase_train_check()
        # the rank kernel's row is the training step's (its forward rulebooks
        # and the inverse ones); the serving forward's is in the kernels line
        train["rank_flags"]["launches_serve"] = serve["rank_flags"]["launches"]
        kernels = [train["rank_flags"], serve["gather_gemm"], train["gather_gemm_stacked"],
                   train["gather_dw"]]
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
