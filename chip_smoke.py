#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (efg_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device and the repository beside it, and exits non-zero without
either. Phases (each prints JSON lines; any failure exits 1):

1. device  — card name and power limit, torch/CUDA versions, TF32 off,
             build every CUDA kernel source in `efg_tpu_torch/csrc/`
             (one nvcc per source, all started together); each kernel
             instantiation's registers and spills as ptxas prints them.
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
             gather-GEMM within 1e-3·max|ref|. Medians of 20 timed runs;
             each rank and gather-GEMM call is also captured in CUDA graphs
             for its device time and its kernel count (one), the rank calls
             beside torch.searchsorted's. The gather-GEMM's hazard cases
             GEMM_EDGE_CASES (every width up to 256) run through both
             entries of gather_gemm.cu, and of gather_gemm_g3.cu where its
             gate admits them, against the plain versions (out within
             1e-3·max|ref|, stacked taps bit for bit); the hazards at 256
             channels WIDE_EDGE_CASES (ragged V_out, an empty tile, flags on
             rows −1 and V_in, a flag-free pair) through both entries of
             gather_gemm.cu and through gather_dw.cu (twice, equal bits).
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
             1e-3·max|ref|, device time and one kernel a call from CUDA
             graphs), the dW kernel on every conv's (features,
             rulebook, gradient) against its plain version and against the
             dW the stacked path produced (1e-3·max|ref|), two calls equal
             bit for bit, its device time and two kernels a call (the
             blocks' partials, their sum over row chunks), and the rank
             kernel on all 12 rulebook builds (exact). Medians of 20 runs.
             Per conv, the two routes to its backward by device time: dW
             kernel + d_features gather without taps against stacked
             gather + dense f32 dW (`torch.matmul`), with their sums.
             One stage-0 conv cut to C=5, O=8 runs the wrappers' padding
             branch through the dW kernel (twice, equal bits) and the
             gather-GEMM.
8. variants — the kernels behind efg_tpu's switches (EFG_RANK_IMPL=seq4,
             `seq=False`, EFG_SPARSE_G3). First on the captured inputs of
             phases kernels and train_kernels: the seq4 and hostwin rank
             kernels on all 20 rank calls (exact, equal to rank_flags.cu,
             one device kernel a call), all three rank kernels on the
             hazard cases RANK_EDGE_CASES (exact), the g3 gather-GEMM on the
             16 forward and the 15 stacked calls its gate admits (out within
             1e-3·max|ref|, taps bit-exact), each beside gather_gemm.cu's
             times on the same call. Then the path under seq4 + g3: the flagship
             from the seeded weights serves two bs=4 requests (launches
             seq4 8, g3 16, gather-GEMM 5 per forward) and trains a warm-up
             and the timed steps (seq4 12, g3 16 + 5, stacked g3 15 + 6 per
             step), its rulebooks equal to the default kernel's, its head
             maps and step-1 loss and grad_norm within the tolerances of
             check and train_check against the default path.
9. train_profile — one more flagship training step under torch.profiler,
             its parts separated by device synchronization: per part the
             wall time, device busy time, idle share and kernel count; the
             kernels that take the most device time.
10. train_check — a small model trains 3 steps on the card and on the CPU
             (plain versions) from the same weights and batches: step 1's
             gradient of every parameter, and the losses and grad_norm of
             every step, within fixed bf16 tolerances; a third run on the
             card with a planted fault (one conv's dW doubled) must fail.
11. engine — the port's CLI (`efg_tpu_torch.cli.main`, task=train) in
             process, output under a temporary EFG_CACHE_DIR: the synthetic
             experiment as its config.yaml defines it (30 iterations,
             records 1-30 with finite and falling losses, the checkpoint
             after step 15 and model_final, launches 30 × phase train's
             per-step counts); a --resume run from that checkpoint (records
             16-30 within train_check's step tolerances of the first run);
             the flagship's full width through the same entry point (bs 4,
             160k-point synthetic scenes, 8 iterations, launches 8 × phase
             train's): the loop's iteration time (metrics.json), its step
             time (CUDA events) and data time (host), beside phase train's
             bare step and peak memory.
12. eval   — evaluation through the same CLI in process: the synthetic
             experiment as written, its WaymoDetEvaluator on (30
             iterations, EvalHook after iteration 15, the evaluation after
             training, a torch.profiler window of iterations 5-6 whose
             trace must name the `__global__` kernels of rank_flags.cu and
             gather_gemm.cu; launches 30 × phase train's + the eval
             batches × (8, 21)); task=val at the flagship's width (16
             frames of 160k points, bs 4, fresh weights: per batch the eval
             step by CUDA events, the data and evaluator time on the host,
             val frames/s; launches 4 × (8, 21)); the GT boxes of those
             frames as predictions through both metric cores (AP = APH =
             1.0 at L1 and L2).
13. detr   — ConQueR / Voxel-DETR serving at bench.py's widths (Waymo grid
             1504×1504×40, 120k voxels, stage caps 80k/60k/30k/15k,
             SparseResNet-18 with res4 at 256 channels, FPN p3, hidden 256,
             8 heads, 3 + 3 layers, FFN 1024, 1000 queries, top-300
             predict), weights from a seed, 160k-point clouds: the eval step
             at bs 1 and 2 (CUDA events, stage by stage, peak memory,
             launches per forward: rank 11, gather-GEMM 13 and 5 at 256);
             every gather-GEMM and rank call of a bs=2 forward against its
             plain version on the card (the 256-wide calls: their own
             kernel row, with the steps its one block a tile runs and
             skips); a small ConQueR on the card against the CPU
             (voxels and rulebooks equal, outputs within 3e-2 of range,
             top-k sets equal outside the tie band); one forward each under
             EFG_SPARSE_G3 and EFG_RANK_IMPL=seq4 against the default
             (rulebooks equal, outputs within 3e-2, launches counted);
             task=val of the synthetic ConQueR experiment through the CLI
             (finite waymo/* results, launches = batches × per forward).
14. detr_train — ConQueR trains at bench.py's widths with its loss and
             solver (CDN dn_number 3, the Hungarian matcher on the host, the
             momentum GT decoder, query contrast; clip 10 + AdamW 1e-3), bs 2
             of 160k-point clouds with 161 GT boxes a frame: a warm-up and 3
             timed steps (CUDA events; frames/s, peak memory, the matcher's
             host ms, launches a step: rank 18, gather-GEMM 13 + 5 at 256,
             stacked 12 + 5 at 256, dW 0); every stacked gather of one step
             against its plain version on the card (taps bit for bit, out
             within 1e-3·max|ref|; the 5 at 256 channels are the kernels
             line's `gather_gemm_stacked_256` row, beside the dense f32 dW
             after them), and the dW kernel on those 5 convs' captured
             (features, forward rulebook, masked gradient) against its
             plain version and the stacked route's dW (1e-3·max|ref|), two
             calls bit for bit and 2 kernels a call (the kernels line's
             `gather_dw_256` row); a small ConQueR one step on the card against the
             CPU from the same weights and noise (assignments equal up to
             ties, loss parts within 5e-2, step-1 gradients by direction,
             the EMA decoder exact); task=train of the synthetic ConQueR
             experiment through the CLI (20 iterations, finite losses,
             launches = 20 × per step, the EMA state in model_final).
15. ddp    — data parallelism: two ranks share the one card over gloo
             (NCCL refuses two ranks on one device), set up through
             parallel/ddp.py's explicit arguments. (a) The flagship at full
             width, 2 ranks × bs 2 of TRAIN_BATCH's frames: the first step's
             losses and grad_norm against one process's bs-4 step on the
             same frames at train_check's step tolerances, every leaf's
             gradient within max(0.8, 1.5 × the worst leaf of one process
             against itself with the frames reordered: at this width a BN
             scale's gradient is bf16 noise), the stage caps raised above
             these frames' occupancy (DDP_FLAGSHIP: a full stage is
             truncated over each rank's pool), then 3 timed steps (step
             time and peak memory per
             rank; two ranks on one card take turns, so these are not DDP's
             speed), launches per rank and step 12/21/21/0, parameters equal
             bit for bit across the ranks, each sparse stage's occupancy
             beside its capacity. (b) The synthetic experiment through
             `efg_run_torch --local-ranks 2` (engine/launch.py): 30
             iterations with the asynchronous checkpoint after step 15, a
             --resume from it held to the uninterrupted run, and task=val
             with GT boxes as detections gathered over both ranks (AP = APH
             = 1.0). (c) A small ConQueR (DETR_SMALL with its caps above
             occupancy), 2 ranks × bs 1 against one process at bs 2: loss
             parts within 5e-2, leaves by direction.
16. waymo  — the flagship config's own pipeline from Waymo-format files:
             frames in the decoder's pickle schema (160k-point clouds, boxes
             of the three classes with points inside) through the port's
             create_data (infos at 1 and 4 sweeps, the GT database); a
             reference-format CenterPoint checkpoint at the flagship's width
             imported through `model.weights` (`weights_format:
             centerpoint`; every tensor assigned, each kind read back);
             task=train of the flagship config as written (DatabaseSampling
             first; bs 5, as the config's 6 puts the grid's linear keys
             past the rank kernel's 2^29; 4 iterations: launches 12/21/21/0
             a step, GT pasted into every item, iteration, data and
             DatabaseSampling times, peak memory); the first step's rank,
             gather-GEMM and stacked calls against their plain versions
             (kernel rows `*@waymo`); task=val through WaymoDetEvaluator
             ((8, 21) a batch); forward_double_flip on a val batch (4 ×
             (8, 21), its time beside one forward's); the 4f config's val
             batch (4 sweeps, 6 features, 400000 points and voxels: (8,
             21), peak memory).
17. waymo_detr — the two Waymo DETR experiments' configs as written on
             phase waymo's frames: Voxel-DETR task=train (bs 2, 3
             iterations; launches 18/13+5/12+5/0 a step), its first step's
             5 forward and 5 stacked calls at 256 channels against their
             plain versions (kernel rows `*_256@waymo_detr`), task=val at
             bs 5 through WaymoDetEvaluator; ConQueR task=train (bs 2, its
             config including its sibling's, `trainer.fade` dropping the GT
             sampling at iteration 2).
18. track  — the tracking experiments. (a) The synthetic motion pretrain
             and trajectoryformer.synth as written through the CLI (20
             iterations each; the second grafts the first's encoder, the
             grafted tensors equal to the pretrain's bit for bit), its
             task=val through TrackingEvaluator (finite results), and the
             val frames' GT tracks through the evaluator (MOTA and
             tracking_official/MOTA_L2 exactly 1). (b) The Waymo
             TrajectoryFormer config as written on phase waymo's frames:
             its boxes pkls from the flagship config's eval step with
             seeded weights (bs 4, (8, 21) a batch; the first val batch's
             calls against their plain versions, kernel rows `*@track`),
             the synthetic pretrain grafted (the Waymo pretrain cannot
             run); task=train 4 iterations (bs 4, 180000 points, 128
             hypotheses, d_model 256, 3 layers: step ms, peak memory, no
             sparse launch), task=val through SeqInferenceSampler (eval
             step ms a frame, evaluator ms, val frames/s), then
             TrajectoryFormerTracker over the val sequence (ms a frame
             beside the 100 ms sweep; one frame's scoring call and its
             crop by CUDA events; that call card against CPU within
             1e-4 / 1e-3).
19. nusc   — nuScenes-format data (2 scenes of 4 key frames after 9 sweeps
             each, 30000 points a sweep) through the port's create_data,
             and a GT database chip_smoke writes (neither package writes
             one for nuScenes); centerpoint.nusc.voxelnet.cbgs.20e as
             written at bs 4 (task=train 4 iterations: launches 12/21/21/0
             a step; its first step's calls against their plain versions,
             kernel rows `*@nusc`; task=val through nuScenesDetEvaluator);
             centerpoint.pillar.nusc_mini.1sweep as written (task=train 4
             iterations and task=val, no sparse kernel launched); GT boxes
             as predictions through nuScenesDetEvaluator (the perfect mAP,
             translation, scale, orientation and velocity errors 0).
20. det2d  — 2D detection (no sparse kernel on its path; the launch
             counters read 0 over the phase). (a) The synthetic FCOS,
             RetinaNet and AutoAssign experiments as written (R-50, bs 2,
             256×256) through the CLI: task=train 20 iterations, task=val
             through COCOEvaluator. (b) The three COCO configs as written
             (bs 2, 800×1344 canvas, two loader threads) on a COCO-format
             fixture the phase writes (12 train and 8 val PNG images,
             480×640 / 640×480 / 427×640, 1-20 boxes each, some crowd,
             the 80 categories' real ids) with a seeded torchvision R-50
             .pth as model.weights: task=train 4 iterations (train_step
             by CUDA events, IterTimer's time, the prefetcher's next,
             peak memory), task=val (eval step ms, val frames/s); FCOS's
             eval step at bs 1 and 2 split into backbone + FPN, head,
             decode + NMS; GT as detections read AP = AP50 = AP75 = 1.
             (c) An FCOS forward card against CPU within 1e-4 and equal
             keep sets of predict on the same predictions.
21. panoptic — Mask2Former (no sparse kernel on its path; the launch
             counters read 0 over the phase). (a) The synthetic experiment
             as written (R-50, bs 2, 128×128) through the CLI: task=train
             12 iterations, task=val. (b) The golden's run
             (tests/goldens/mask2former_synth.json's overrides: R-18,
             96×96, bs 8, 120 iterations): its loss records beside the
             golden's, the golden's criterion (finite, tail-quarter mean
             under 0.8 × the first record). (c) Both COCO panoptic configs
             as written (R-50 and Swin-T; LSJ to 1024×1024, bs 2, two
             loader threads, 12544 points, 9 decoder layers; val 800×1344)
             on a COCO panoptic fixture the phase writes (8 train and 6
             val PNGs of 480×640 / 640×480 / 427×640, RGB-id PNGs, stuff
             bands and things, a crowd segment, the 133 categories' real
             ids), with the two overrides the configs' efg_tpu failures
             force (`milestones`, `trainer.evaluators=[PanopticEvaluator]`);
             R-50 from a seeded torchvision .pth (BN statistics measured on
             the fixture), Swin-T from a seeded mmdet-format .pth
             (`weights_format: swin`): task=train 4 iterations (train_step
             by CUDA events, IterTimer's time, the prefetcher's next, the
             matcher's host ms, peak memory), task=val (eval step ms, the
             val loader's and the evaluator's ms, val frames/s); the R-50
             eval step at bs 1 split into backbone, pixel decoder,
             transformer decoder and predict; the val images' GT segments
             as predictions read PQ = SQ = RQ = 1 exactly. (d) A
             Mask2Former forward card against CPU within 1e-4.

The second-to-last line lists every kernel as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# cout is a multiple of 16, so dW always comes from the stacked taps; no
# width is 256, and the switched kernels are off)
NO_VARIANTS = {"rank_flags_seq4": 0, "rank_flags_hostwin": 0, "gather_gemm_g3": 0,
               "gather_gemm_g3_stacked": 0, "gather_gemm_256": 0, "gather_gemm_stacked_256": 0,
               "gather_dw_256": 0}
SERVE_LAUNCHES = {"rank_flags": 8, "gather_gemm": 21, "gather_gemm_stacked": 0, "gather_dw": 0,
                  **NO_VARIANTS}
TRAIN_LAUNCHES = {"rank_flags": 12, "gather_gemm": 21, "gather_gemm_stacked": 21, "gather_dw": 0,
                  **NO_VARIANTS}
# the same under EFG_RANK_IMPL=seq4 and EFG_SPARSE_G3 (phase variants): every
# rulebook through the seq4 kernel; the gathers whose operand is at most 64
# channels wide over at least two δz-groups through the g3 kernel (forward:
# conv_input, res0-2, down1-3; backward: conv_input, res0-2 and the down1
# and down2 inverses; not res3, down3's inverse nor the (3,1,1) conv)
VARIANT_SERVE_LAUNCHES = {**SERVE_LAUNCHES, "rank_flags": 0, "rank_flags_seq4": 8,
                          "gather_gemm": 5, "gather_gemm_g3": 16}
VARIANT_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES, "rank_flags": 0, "rank_flags_seq4": 12,
                          "gather_gemm": 5, "gather_gemm_g3": 16, "gather_gemm_stacked": 6,
                          "gather_gemm_g3_stacked": 15}


# phase engine: the synthetic experiment through the port's CLI, as its
# config.yaml defines it (bs 2, 8192 points, 30 iterations, the
# SpMiddleResNetFHD trunk, RPN 64/128); only the evaluator is dropped, a
# checkpoint asked for after step 15 and a record written every step
ENGINE_CONFIG = "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/config.yaml"
ENGINE_RUN = ["trainer.evaluators=", "trainer.checkpoint_iter=15", "trainer.log_interval=1",
              "trainer.window_size=1"]
ENGINE_ITERS = 30
# the same entry point at the flagship's full width (FLAGSHIP, POST_CFG,
# LOSS_CFG's max_objs, MAX_GT) on 160k-point synthetic scenes, bs 4, 8
# iterations
ENGINE_FLAGSHIP = [
    "trainer.evaluators=", "trainer.log_interval=1", "trainer.window_size=1",
    "trainer.checkpoint_period=1000000", "solver.lr_scheduler.max_iters=8",
    "dataloader.batch_size=4", f"dataset.points_per_frame={N_POINTS}",
    f"dataset.processors.train[5].PadPoints.num_points={N_POINTS}", f"dataset.max_gt={MAX_GT}",
    *(f"{k}={json.dumps(v)}" for k, v in (
        ("dataset.pc_range", FLAGSHIP["pc_range"]),
        ("dataset.voxel_size", FLAGSHIP["voxel_size"]),
        ("model.max_voxels", FLAGSHIP["max_voxels"]),
        ("model.stage_caps", FLAGSHIP["stage_caps"]),
        *((f"model.neck.{k}", v) for k, v in FLAGSHIP["neck_cfg"]),
        ("model.post_process.post_center_limit_range", POST_CFG["post_center_limit_range"]),
        ("model.post_process.score_threshold", POST_CFG["score_threshold"]),
        *((f"model.post_process.nms.{k}", v) for k, v in POST_CFG["nms"].items()),
        ("model.loss.max_objs", LOSS_CFG["max_objs"]))),
    f"model.act_dtype={FLAGSHIP['act_dtype']}",
]
ENGINE_FLAGSHIP_ITERS = 8
# phase eval: the experiment as written through the CLI, evaluator on,
# EvalHook after half an epoch (iteration 15 of 30) and a profiler window
EVAL_RUN = ["trainer.eval_period=0.5", "trainer.profiler={start_iter: 5, num_iters: 2}",
            "trainer.log_interval=1", "trainer.window_size=1"]
# task=val at the flagship's width: phase engine's flagship overrides with
# the experiment's evaluator, the val split's PadPoints at 160k points and
# 16 frames (4 batches of 4), on fresh weights
EVAL_FLAGSHIP = [o for o in ENGINE_FLAGSHIP if not o.startswith("trainer.evaluators")] + [
    f"dataset.processors.val[1].PadPoints.num_points={N_POINTS}", "dataset.num_frames=16"]


# phase detr: ConQueR / Voxel-DETR serving at bench.py's widths (its
# bench_conquer: the Waymo grid 1504×1504×40, 120k voxels, stage caps
# 80k/60k/30k/15k per sample, SparseResNet-18 to res4 at 256 channels, FPN
# p3, hidden 256, 8 heads, 3 encoder + 3 decoder layers, FFN 1024, 1000
# queries), weights from DETR_SEED, 160k-point LiDAR-like clouds
DETR = dict(pc_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0), voxel_size=(0.1, 0.1, 0.15),
            max_voxels=120000, resnet_caps=(80000, 60000, 30000, 15000), depth=18,
            out_features=("res2", "res3", "res4"), fpn_levels=("p3",), hidden_dim=256,
            num_head=8, enc_layers=3, dec_layers=3, dim_feedforward=1024, num_queries=1000,
            num_classes=3)
DETR_SEED = 3
DETR_BATCHES = ((1, 301), (1, 302), (2, 303), (2, 304))  # (batch size, cloud seed)
# launches per ConQueR forward: 11 rulebooks (the stem's strided conv and
# SubM set, res2-res4's, the three (3,1,1) out convs) and 18 sparse convs,
# 5 of them at 256 channels (res4's strided conv C128·O256, its three SubM
# convs and its out conv at C256·O256)
DETR_SERVE_LAUNCHES = {**SERVE_LAUNCHES, "rank_flags": 11, "gather_gemm": 13,
                       "gather_gemm_256": 5}
# under EFG_SPARSE_G3 the gate admits the stem's three convs, res2's four,
# res3's strided conv (cin 64) and res2's out conv: 9 of the 13
DETR_G3_LAUNCHES = {**DETR_SERVE_LAUNCHES, "gather_gemm": 4, "gather_gemm_g3": 9}
DETR_SEQ4_LAUNCHES = {**DETR_SERVE_LAUNCHES, "rank_flags": 0, "rank_flags_seq4": 11}
DETR_256_LABELS = ("res4.down", "res4.b0_conv2", "res4.b1.conv1", "res4.b1.conv2", "res4_out")
# the card against the CPU: a small ConQueR (±12.8 m, hidden 64) on 20k points
DETR_SMALL = dict(DETR, pc_range=(-12.8, -12.8, -2.0, 12.8, 12.8, 4.0), max_voxels=8192,
                  resnet_caps=(8192, 4096, 2048, 2048), hidden_dim=64, num_head=4, enc_layers=1,
                  dec_layers=2, dim_feedforward=128, num_queries=64)
# bf16 sparse convs: another summation order flips some bf16 roundings, and
# the flips compound through 18 convs, the window ops and the decoder
# (phase check's tolerance on the same trunk)
DETR_TOL = 3e-2
DETR_CONFIG = "playground/detection.3d/synthetic/conquer.synth.res18/config.yaml"

# phase detr_train: bench.py bench_conquer's loss and solver (:129-138):
# CDN with dn_number 3, the Hungarian matcher, the momentum GT decoder and
# query contrast; clip 10 + AdamW 1e-3 (optax's defaults: betas (0.9,
# 0.999), eps 1e-8, weight decay 1e-4); bs 2 of the flagship's 160k-point
# clouds with 161 GT boxes a frame (max_gt 256, as __graft_entry__._batch)
DETR_TRAIN_CFG = dict(
    loss_weights={"class": 1.0, "bbox": 4.0, "giou": 2.0, "rad": 4.0},
    dn=dict(enabled=True, dn_number=3, dn_box_noise_scale=0.4, dn_label_noise_ratio=0.5),
    contrastive=dict(mom=0.999, dim=256, eqco=1000, tau=0.7, loss_coeff=0.2))
DETR_TRAIN_BATCH = (2, 311)  # (batch size, cloud seed)
DETR_TRAIN_MAX_GT = 256
DETR_TRAIN_STEPS = 3  # timed, after one warm-up step
# launches per ConQueR training step: the forward's (11 rulebooks, 13 + 5
# gather-GEMMs), 7 inverse rulebooks (the strided convs whose output gets
# a gradient: all but res2's out conv, which FPN p3 does not read) and a
# stacked gather per conv backward: 17 (res2_out has none), 5 of them at
# 256 channels (res4 `down` over its inverse rulebook at C256·O128; its
# three SubM convs and its out conv at C256·O256). No dW kernel: every
# cout is a multiple of 16.
DETR_TRAIN_LAUNCHES = {**DETR_SERVE_LAUNCHES, "rank_flags": 18, "gather_gemm_stacked": 12,
                       "gather_gemm_stacked_256": 5}
DETR_TRAIN_ITERS = 20  # the synthetic experiment's max_iters


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
    He-uniform kernels, Linear weights of variance 1/fan_in, small biases,
    norm scales ≈ 1 and running stats near (0, 1), so activations stay O(1)
    through the trunk."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() == 2:  # Linear [out, in]: variance 1/fan_in
                b = (3.0 / t.shape[1]) ** 0.5
                new = uni(t.shape, -b, b)
            elif leaf == "weight" and t.dim() >= 3:
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
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "build_seconds": round(build_s, 3),
          "per_source_seconds": {k: round(v["seconds"], 3) for k, v in logs.items()},
          "ptxas": {k: ptxas_usage(v["log"]) for k, v in logs.items()},
          "ptxas_warnings": {k: [ln.strip() for ln in v["log"].splitlines()
                                 if "arning" in ln or "Performance" in ln]
                             for k, v in logs.items()}})
    return card


def ptxas_usage(log: str) -> list:
    """Each kernel's registers, static shared memory and spills from
    `nvcc -Xptxas -v` output, as "kernel<template args>: Used ... | spills"."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()} | {spill}")
    return out


def _kernel_name(mangled: str) -> str:
    """`name<integer template arguments>` of a mangled kernel symbol: the
    shortest length-prefixed identifier that ends in "_kernel" (a digit run
    inside an enclosing namespace's name can prefix a longer one), and the
    literals of the template argument list after it."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for k in range(len(run)):  # the length prefix may follow other digits
            n = int(run[k:])
            ident = mangled[m.end():m.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                found.append((n, ident, m.end() + n))
    if not found:
        return mangled
    _, ident, end = min(found)
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[end:])
    lits = re.findall(r"L[a-z](\d+)E", args.group(1)) if args else []
    return ident + (f"<{','.join(lits)}>" if lits else "")


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
    rank_rows = [_rank_row(RANK_LABELS[i], k, q) for i, (k, q) in enumerate(capture.rank)]
    gemm_rows = [_gemm_row(gemm_label(i), *call)[0] for i, call in enumerate(capture.gemm)]
    edges, wide = gemm_edge_cases(), wide_edge_cases()
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
          "gemm_calls": gemm_rows, "gemm_edge_cases": edges, "wide_edge_cases": wide})
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
    part. Returns the capture, the per-step launch counts, the first
    step's losses and grad_norm, and the timed steps' milliseconds."""
    import torch

    from efg_tpu_torch.engine.trainer import apply_grads, init_state, train_forward, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    tx = make_solver()
    state = init_state(md, tx)
    batch = train_batch(*TRAIN_BATCH, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    capture = counts = first = None
    timed_ms = []
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
        if 0 < i <= TRAIN_STEPS:
            timed_ms.append(ms)
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
        first = first or vals  # step 1, from the seeded weights
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
    return capture, counts, first, timed_ms


def backward_label(i: int, g, conv) -> str:
    """Name of the i-th conv backward of a training step (autograd order)."""
    return f"backward {i}: {conv['kind']} C={conv['features'].shape[1]} O={g.shape[1]}"


RANK_TRAIN_LABELS = ["subm0", "down1", "down1.inverse", "subm1", "down2", "down2.inverse",
                     "subm2", "down3", "down3.inverse", "subm3", "extra_conv", "extra_conv.inverse"]

# The rank kernels' hazards (this script's own numpy copy of the case makers
# in tests/test_torch_sparse_variants.py, plus one past 2^20 keys): each
# (keys [Vk] int32 sorted, queries [P, Vq] int32, rows strictly increasing
# then padding), run through all three rank kernels in phase variants.
INVALID_Q, CLAMP_Q = 1 << 29, 1 << 30  # the rank contract's padding thresholds
I32_MAX = np.iinfo(np.int32).max


def _padded_case():
    rs = np.random.RandomState(7)
    keys = np.sort(rs.choice(40000, 3000, replace=False)).astype(np.int32)
    keys = np.pad(keys, (0, 7000), constant_values=I32_MAX)
    base = np.sort(rs.choice(42000, 600, replace=False)).astype(np.int32)
    tail = np.concatenate([base[:350], INVALID_Q + np.arange(250, dtype=np.int32)])
    return keys, np.stack([tail, np.full(600, CLAMP_Q, np.int32), base + 3])


def _boundary_case(chunk):
    keys = np.pad(np.arange(chunk, dtype=np.int32), (0, 64), constant_values=CLAMP_Q)
    return keys, (np.arange(64, dtype=np.int32) * 2 + chunk)[None]


def _vk1_case():
    row = np.array([-9, 0, 5, 6, 7, 8, 9, 40, INVALID_Q, CLAMP_Q], np.int32)
    return np.array([7], np.int32), np.stack([row, row + 1, np.full(10, INVALID_Q, np.int32)])


def _vk_mod4_case():
    rs = np.random.RandomState(11)
    keys = np.sort(rs.choice(3000, 1027, replace=False)).astype(np.int32)
    base = np.sort(rs.choice(np.arange(-40, 3100), 700, replace=False)).astype(np.int32)
    return keys, np.stack([base, base + 1, base + 2999])


def _all_padding_case():
    keys = np.concatenate([INVALID_Q + np.array([0, 5, 9]), np.full(100, CLAMP_Q),
                           np.full(100, I32_MAX)]).astype(np.int32)
    valid = np.arange(0, 600, 2)
    return keys, np.stack([valid, np.concatenate([valid[:200], INVALID_Q + np.arange(100)])]
                          ).astype(np.int32)


def _invalid_keys_case():
    rs = np.random.RandomState(12)
    keys = np.concatenate([np.sort(rs.choice(20000, 900, replace=False)),
                           INVALID_Q + np.sort(rs.choice(1000, 30, replace=False)),
                           np.full(100, CLAMP_Q)]).astype(np.int32)
    base = np.sort(rs.choice(21000, 800, replace=False))
    return keys, np.stack([base, np.concatenate([base[:500], INVALID_Q + np.arange(300)]),
                           np.concatenate([base[:64], np.full(736, CLAMP_Q)])]).astype(np.int32)


def _outside_case():
    rs = np.random.RandomState(13)
    keys = np.pad(np.sort(rs.choice(np.arange(10000, 20000), 1000, replace=False)), (0, 24),
                  constant_values=CLAMP_Q).astype(np.int32)
    below = np.sort(rs.choice(np.arange(-50000, 10000), 300, replace=False))
    above = np.sort(rs.choice(np.arange(20000, 400000), 300, replace=False))
    mixed = np.sort(np.concatenate([below[::2], above[::2]]))
    return keys, np.stack([below, above, mixed]).astype(np.int32)


def _long_case():
    rs = np.random.RandomState(14)
    keys = np.pad(np.sort(rs.choice(200000, 39000, replace=False)), (0, 1001),
                  constant_values=I32_MAX).astype(np.int32)
    base = np.sort(rs.choice(200000, 1500, replace=False))
    return keys, np.stack([base, np.concatenate([base[:1200] + 1, INVALID_Q + np.arange(300)]),
                           np.concatenate([base[::5], np.full(1200, CLAMP_Q)])]).astype(np.int32)


def _vk_2e20_case():
    """Vk = 2^20 + 3 (the warp search's fourth round), a padding tail, four
    rows of 5000 queries; the last row ends in padding."""
    rs = np.random.RandomState(15)
    keys = np.pad(np.sort(rs.choice(4 << 20, (1 << 20) - 997, replace=False)), (0, 1000),
                  constant_values=I32_MAX).astype(np.int32)
    base = np.sort(rs.choice(4 << 20, 5000, replace=False))
    tail = np.concatenate([base[:4000] + 7, INVALID_Q + np.arange(1000)])
    return keys, np.stack([base, base + 1, base - 4096, tail]).astype(np.int32)


RANK_EDGE_CASES = {
    "boundary_512": lambda: _boundary_case(512), "boundary_128": lambda: _boundary_case(128),
    "padded": _padded_case, "vk1": _vk1_case, "vk_mod4": _vk_mod4_case,
    "all_padding": _all_padding_case, "invalid_keys": _invalid_keys_case,
    "outside": _outside_case, "long": _long_case, "vk_2e20": _vk_2e20_case,
}

# The gather-GEMM's hazards (this script's own numpy copy of the case makers
# in tests/test_torch_sparse_gemm_cases.py): each (features [V_in, C] f32,
# packed [P, V_out] int32 with pos monotone per pair, weights [P·3·C, O]
# f32), run through both entries of gather_gemm.cu in phase kernels.
GEMM_TM = 128  # output rows per block of gather_gemm.cu (its kTM)


def _gemm_case(seed, v_out, c=32, o=32, n_pairs=9, v_in=None, density=0.3, edit=None):
    """A random rulebook whose set flags all name rows in [0, V_in), unless
    `edit(packed, v_in)` plants a hazard. No fm at pos = V_in: a padded
    sparse tensor's rulebook never has it, and efg_tpu's Pallas kernel reads
    that tap (row V_in − 1) as 0, where the contract reads the row."""
    rs = np.random.RandomState(seed)
    v_in = v_out if v_in is None else v_in
    pos = np.sort(rs.randint(0, v_in + 1, (n_pairs, v_out)), axis=1)
    fl = rs.rand(n_pairs, v_out, 3) < density
    fm = fl[..., 0] & (pos >= 1) & (pos < v_in)
    f0 = fl[..., 1] & (pos < v_in)
    fp = fl[..., 2] & (pos + f0 < v_in)
    packed = (pos * 8 + fm * 4 + f0 * 2 + fp).astype(np.int32)
    if edit is not None:
        packed = edit(packed, v_in).astype(np.int32)
    feats = rs.randn(v_in, c).astype(np.float32)
    w = (rs.randn(n_pairs * 3 * c, o) * 0.1).astype(np.float32)
    return feats, packed, w


def _tile_empty(packed, v_in):
    packed[:, GEMM_TM:2 * GEMM_TM] &= ~7  # the second tile has no flag
    return packed


def _all_off(packed, v_in):
    return packed & ~7


def _one_tap(packed, v_in):
    packed = packed & ~7
    r = int(np.argmax((packed[4] >> 3) < v_in))  # a row of pair 4 whose pos names a row
    packed[4, r] |= 2
    return packed


def _outside_rows(packed, v_in):
    """Set flags on rows −1 and V_in: pos 0 with fm (pair 0), pos V_in with
    f0 and fp (pair 1), pos V_in − 1 with all three (pair 2, fp at V_in)."""
    packed[0, :3] = 0 * 8 + 4 + 2
    packed[1, -3:] = v_in * 8 + 2 + 1
    pos2 = np.minimum(packed[2] >> 3, v_in - 1)
    packed[2] = pos2 * 8 + (packed[2] & 7)
    packed[2, -3:] = (v_in - 1) * 8 + 7
    return packed


def _pos_v_in_off(packed, v_in):
    packed[:, -40:] = v_in * 8  # pos = V_in, every flag off
    return packed


def _pair_no_flag(packed, v_in):
    packed = packed.copy()
    packed[4] &= ~7  # pair 4 has no flag in any row
    return packed


def _middle_only(packed, v_in):
    """Only the middle taps of pairs 3-5, as a (3, 1, 1) conv's rulebook:
    24 of the 27 taps empty in every tile."""
    keep = np.zeros_like(packed)
    keep[3:6] = 2
    return packed & (~7 | keep)


GEMM_EDGE_CASES = {
    **{f"v_out_{v}": functools.partial(_gemm_case, 30 + i, v)
       for i, v in enumerate((1, GEMM_TM - 1, GEMM_TM, GEMM_TM + 1, 3 * GEMM_TM + 5))},
    **{f"width_{c}x{o}": functools.partial(_gemm_case, 40 + 4 * i + j, 200, c, o)
       for i, c in enumerate((16, 32, 64, 128)) for j, o in enumerate((16, 32, 64, 128))},
    "width_128x256": functools.partial(_gemm_case, 56, 200, 128, 256),
    "width_256x256": functools.partial(_gemm_case, 57, 200, 256, 256),
    "pairs_1": functools.partial(_gemm_case, 60, 300, 16, 16, n_pairs=1),
    "pairs_18": functools.partial(_gemm_case, 61, 300, 64, 32, n_pairs=18, v_in=150),
    "pairs_18_c16": functools.partial(_gemm_case, 68, 300, 16, 16, n_pairs=18),
    "pairs_18_c32": functools.partial(_gemm_case, 69, 300, 32, 32, n_pairs=18, v_in=250),
    "pairs_7": functools.partial(_gemm_case, 70, 260, 32, 16, n_pairs=7),
    "tile_empty": functools.partial(_gemm_case, 62, 3 * GEMM_TM + 5, edit=_tile_empty),
    "all_off": functools.partial(_gemm_case, 63, 300, edit=_all_off),
    "one_tap": functools.partial(_gemm_case, 64, 300, 128, 64, edit=_one_tap),
    "outside_rows": functools.partial(_gemm_case, 65, 300, 16, 32, v_in=250, edit=_outside_rows),
    "pos_v_in_off": functools.partial(_gemm_case, 66, 300, 64, 64, v_in=120, edit=_pos_v_in_off),
    "middle_only": functools.partial(_gemm_case, 67, 300, 128, 128, density=0.6,
                                     edit=_middle_only),
}


# hazards at 256 channels, one at each corner of the widths the kernels take
# there (C256·O256, C128·O256, C256·O16, C16·O256): through both entries of
# gather_gemm.cu and through gather_dw.cu in phase kernels
WIDE_EDGE_CASES = {
    "wide_ragged_256x256": functools.partial(_gemm_case, 90, 2 * GEMM_TM + 37, 256, 256,
                                             density=0.2),
    "wide_tile_empty_128x256": functools.partial(_gemm_case, 91, 2 * GEMM_TM + 37, 128, 256,
                                                 edit=_tile_empty),
    "wide_outside_rows_256x16": functools.partial(_gemm_case, 92, 300, 256, 16, v_in=250,
                                                  edit=_outside_rows),
    "wide_pair_no_flag_16x256": functools.partial(_gemm_case, 93, 300, 16, 256,
                                                  edit=_pair_no_flag),
}


@contextlib.contextmanager
def switches(K, rank_impl: str = "seq", g3: bool = False):
    """Set the port's kernel switches (EFG_RANK_IMPL, EFG_SPARSE_G3) inside
    the block; the defaults come back whatever happens there."""
    saved = K._RANK_IMPL, K._G3
    K._RANK_IMPL, K._G3 = rank_impl, g3
    try:
        yield
    finally:
        K._RANK_IMPL, K._G3 = saved


def _rank_agrees(got, ref, q) -> bool:
    """The rank contract's equality: counts everywhere, flags at valid queries."""
    import torch

    valid = q < INVALID_Q
    return torch.equal(got >> 3, ref >> 3) and torch.equal(got[valid], ref[valid])


CU_GRAPH_NODE_TYPE_KERNEL = 0  # CUgraphNodeType of a kernel node (cuda.h)
GRAPH_REPS = 20  # calls in the graph that times one call's device work


def graph_nodes(graph) -> tuple:
    """(kernel nodes, all nodes) of a captured torch.cuda.CUDAGraph, read
    with cuGraphGetNodes / cuGraphNodeGetType from libcuda."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise AssertionError("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return sum(k == CU_GRAPH_NODE_TYPE_KERNEL for k in kinds), len(kinds)


def graph_device(fn) -> dict:
    """What one call of `fn` asks of the device, from CUDA graphs: the
    kernels (and all operations) a graph that captures one call holds, and
    its device time, the median CUDA-event time of replaying a graph of
    GRAPH_REPS calls over GRAPH_REPS (the device runs the calls back to
    back, so the host's time per call drops out). torch.profiler is not
    used for this: after the first phases of this script it recorded the
    device events of a short call only now and then."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    one, many = torch.cuda.CUDAGraph(keep_graph=True), torch.cuda.CUDAGraph()
    with torch.cuda.graph(one):
        fn()
    with torch.cuda.graph(many):
        for _ in range(GRAPH_REPS):
            fn()
    kernels, nodes = graph_nodes(one)
    ms = timed(many.replay) / GRAPH_REPS
    del one, many
    return {"device_ms": ms, "kernels": kernels, "nodes": nodes}


def _rank_row(label, keys, queries, impl="seq"):
    """Kernel vs plain on one captured rank call (exact), with times and
    bound, and from CUDA graphs of the call (`graph_device`) its device
    time and its device kernels (one, for each of the three kernels) beside
    torch.searchsorted's. A variant ("seq4", or "hostwin" through
    `seq=False`) is held against the default kernel's result as well."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    q = queries.to(torch.int32).contiguous()
    kc = torch.clamp(keys, max=CLAMP_Q)
    qc = torch.where(q >= INVALID_Q, CLAMP_Q, q)
    refs = {"plain": K.rank_flags_plain(keys, q)}
    if impl != "seq":
        refs["rank_flags.cu"] = K.merge_rank_flags(keys, q)
    run = functools.partial(K.merge_rank_flags, keys, q, seq=impl != "hostwin")
    library = functools.partial(torch.searchsorted, kc, qc, out_int32=True)
    with switches(K, rank_impl="seq4" if impl == "seq4" else "seq"):
        got = run()
        torch.cuda.synchronize()
        for name, r in refs.items():
            if not _rank_agrees(got, r, q):
                raise AssertionError(f"rank_flags ({impl}) {label}: kernel disagrees with {name}")
        ms = timed(run)
        dev = graph_device(run)
    lib_dev = graph_device(library)
    if (dev["kernels"], dev["nodes"]) != (1, 1):
        raise AssertionError(f"rank_flags ({impl}) {label}: one call is {dev['kernels']} kernels "
                             f"in {dev['nodes']} device operations, expected 1")
    n, vk = q.numel(), keys.numel()
    bytes_ = 4 * vk + 8 * n  # keys once, queries in, result out
    ops = n * (int(np.ceil(np.log2(max(vk, 2)))) + 3)  # binary search + 3 probes
    valid = q < INVALID_Q
    ref = refs["plain"]
    row = dict(label=label, P=q.shape[0], Vq=q.shape[1], Vk=vk, ms=ms,
               plain_ms=timed(lambda: K.rank_flags_plain(keys, q)), library_ms=timed(library),
               device_ms=dev["device_ms"], device_kernels=dev["kernels"],
               library_device_ms=lib_dev["device_ms"], library_device_kernels=lib_dev["kernels"],
               bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S, ops_ms=1e3 * ops / H100_F32_OPS,
               max_abs_err=int((got[valid] - ref[valid]).abs().max()) if valid.any() else 0)
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    return row


def rank_edge_cases():
    """RANK_EDGE_CASES on the card through rank_flags.cu, seq4 and hostwin,
    each against the plain version (counts everywhere, flags at valid
    queries); returns a row per case."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    if (K.INVALID_Q, K.CLAMP_Q) != (INVALID_Q, CLAMP_Q):
        raise AssertionError("the port's rank thresholds differ from this script's")
    rows = []
    for name, make in RANK_EDGE_CASES.items():
        keys, queries = (torch.from_numpy(a).cuda() for a in make())
        ref = K.rank_flags_plain(keys, queries)
        agree = {}
        for impl in ("seq", "seq4", "hostwin"):
            with switches(K, rank_impl="seq4" if impl == "seq4" else "seq"):
                got = K.merge_rank_flags(keys, queries, seq=impl != "hostwin")
            torch.cuda.synchronize()
            agree[impl] = _rank_agrees(got, ref, queries)
        rows.append({"case": name, "P": queries.shape[0], "Vq": queries.shape[1],
                     "Vk": keys.shape[0], "agree_with_plain": agree})
        if not all(agree.values()):
            raise AssertionError(f"rank edge case {name}: agreement with plain {agree}")
    return rows


def _gemm_row(label, features, packed, weights, *, emit=False, g3=False):
    """One captured gather-GEMM call on the card through its kernel (the
    stacked entry with `emit`, the g3 kernel with `g3`) against its plain
    version: out within 1e-3·max|ref|, stacked taps bit for bit. Returns
    (the row with times and bound, the kernel's stacked taps or None)."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    f = features.to(torch.bfloat16).contiguous()
    w = weights.to(torch.bfloat16).contiguous()
    p = packed.contiguous()
    kernel = K.gather_gemm_stacked if emit else K.fused_gather_gemm
    plain = K.gather_gemm_stacked_plain if emit else K.gather_gemm_plain
    run = functools.partial(kernel, f, p, w)
    if g3:
        def run():
            with switches(K, g3=True):
                return kernel(f, p, w)

    got, ref = run(), plain(f, p, w)
    torch.cuda.synchronize()
    (out, st), (ref_out, ref_st) = (got, ref) if emit else ((got, None), (ref, None))
    name = f"gather_gemm{'_g3' if g3 else ''}{'_stacked' if emit else ''} {label}"
    err, scale = _gemm_agrees(name, out, ref_out, st, ref_st)
    del got, out, ref, ref_out, ref_st
    v_in, c = f.shape
    n_pairs, v_out = p.shape
    o = w.shape[1]
    found = _found(p)
    bytes_ = (2 * v_in * c + 4 * n_pairs * v_out + 2 * w.numel() + 4 * v_out * o
              + (2 * v_out * n_pairs * 3 * c if emit else 0))  # the stacked taps written
    # The graph of GRAPH_REPS calls drops each call's outputs, so its private
    # pool hands the same blocks (2.76 GB of taps on down3's inverse) to the
    # next call: one call's outputs are live at a time.
    dev = graph_device(run)
    if (dev["kernels"], dev["nodes"]) != (1, 1):
        raise AssertionError(f"{name}: one call is {dev['kernels']} kernels in {dev['nodes']} "
                             "device operations, expected 1")
    row = dict(label=label, P=n_pairs, V_in=v_in, V_out=v_out, C=c, O=o, taps_found=found,
               ms=timed(run), device_ms=dev["device_ms"], device_kernels=dev["kernels"],
               plain_ms=timed(lambda: plain(f, p, w)),
               bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S,
               ops_ms=1e3 * 2 * found * c * o / H100_BF16_FLOPS,
               max_abs_err=err, max_ref=scale)
    if emit:
        row["taps_bit_exact"] = True
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    return row, st


def _gemm_agrees(name, out, ref_out, st=None, ref_st=None):
    """A gather-GEMM result against its plain version: out within
    1e-3·max|ref| (another summation order), stacked taps bit for bit.
    Returns (max|Δ| of out, max|ref|)."""
    import torch

    scale = float(ref_out.abs().max()) if ref_out.numel() else 0.0
    err = float((out - ref_out).abs().max()) if out.numel() else 0.0
    taps_equal = st is None or torch.equal(st, ref_st)
    if not (out.shape == ref_out.shape and taps_equal and err <= 1e-3 * max(scale, 1e-6)):
        raise AssertionError(f"{name}: taps equal {taps_equal}, out max|Δ| {err} "
                             f"(max|ref| {scale}), shape {tuple(out.shape)}")
    return err, scale


def gemm_edge_cases():
    """GEMM_EDGE_CASES on the card through both entries of gather_gemm.cu
    (the 256-wide cases too: one block a tile over all 256 columns), and of
    gather_gemm_g3.cu where
    efg_tpu's g3 gate admits the case, each against the plain versions;
    returns a row per case."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    rows = []
    for name, make in GEMM_EDGE_CASES.items():
        feats, packed, weights = make()
        f = torch.from_numpy(feats).to("cuda", torch.bfloat16)
        p = torch.from_numpy(packed).cuda()
        w = torch.from_numpy(weights).to("cuda", torch.bfloat16)
        ref_out, ref_st = K.gather_gemm_stacked_plain(f, p, w)
        row = {"case": name, "P": p.shape[0], "V_in": f.shape[0], "V_out": p.shape[1],
               "C": f.shape[1], "O": w.shape[1], "taps_found": _found(p), "max_ref": 0.0}
        with switches(K, g3=True):
            admitted = K.use_g3(f.shape[1], p.shape[0])
        for kernel, g3 in (("gather_gemm", False), ("gather_gemm_g3", True)):
            if g3 and not admitted:
                continue
            with switches(K, g3=g3):
                out = K.fused_gather_gemm(f, p, w)
                st_out, st = K.gather_gemm_stacked(f, p, w)
            torch.cuda.synchronize()
            err, scale = _gemm_agrees(f"{kernel} case {name}", out, ref_out)
            err_st, _ = _gemm_agrees(f"{kernel}_stacked case {name}", st_out, ref_out, st, ref_st)
            row[kernel] = {"max_abs_err": err, "max_abs_err_stacked": err_st,
                           "taps_bit_exact": True}
            row["max_ref"] = scale
        rows.append(row)
    return rows


def wide_edge_cases():
    """WIDE_EDGE_CASES on the card through both entries of gather_gemm.cu
    (one block a tile over all 256 columns) and through gather_dw.cu (two
    column blocks of 128 at O = 256; twice, equal bits), each
    against its plain version: out and dW within 1e-3·max|ref|, taps bit for
    bit. The g3 kernel takes no O of 256. Returns a row per case."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    rows = []
    for i, (name, make) in enumerate(WIDE_EDGE_CASES.items()):
        feats, packed, weights = make()
        f = torch.from_numpy(feats).to("cuda", torch.bfloat16)
        p = torch.from_numpy(packed).cuda()
        w = torch.from_numpy(weights).to("cuda", torch.bfloat16)
        g = torch.from_numpy(np.random.RandomState(700 + i).randn(p.shape[1], w.shape[1])
                             .astype(np.float32)).to("cuda", torch.bfloat16)
        ref_out, ref_st = K.gather_gemm_stacked_plain(f, p, w)
        ref_dw = K.gather_dw_plain(f, p, g)
        out = K.fused_gather_gemm(f, p, w)
        st_out, st = K.gather_gemm_stacked(f, p, w)
        dw, dw_again = K.fused_gather_dw(f, p, g), K.fused_gather_dw(f, p, g)
        torch.cuda.synchronize()
        err, scale = _gemm_agrees(f"gather_gemm case {name}", out, ref_out)
        err_st, _ = _gemm_agrees(f"gather_gemm_stacked case {name}", st_out, ref_out, st, ref_st)
        err_dw, scale_dw = _gemm_agrees(f"gather_dw case {name}", dw, ref_dw)
        if not torch.equal(dw, dw_again):
            raise AssertionError(f"gather_dw case {name}: two calls on the same inputs differ")
        run, skipped = _steps(p, f.shape[1])
        rows.append({"case": name, "P": p.shape[0], "V_in": f.shape[0], "V_out": p.shape[1],
                     "C": f.shape[1], "O": w.shape[1], "taps_found": _found(p),
                     "steps_run": run, "steps_skipped": skipped, "max_ref": scale,
                     "max_abs_err": err, "max_abs_err_stacked": err_st, "taps_bit_exact": True,
                     "dw_max_ref": scale_dw, "dw_max_abs_err": err_dw, "dw_bit_equal_twice": True})
    return rows


def _found(packed):
    return int(sum(((packed >> s) & 1).sum() for s in range(3)))  # set tap flags


def _steps(packed, c: int):
    """(steps run, steps skipped) of one block a tile of gather_gemm.cu on
    a rulebook: its steps (a whole pair at C ≤ 32, else a tap's 64-channel
    part) and its rule (a step runs where a row of the 128-row tile has a
    flag among the step's taps; the rest it skips)."""
    import torch

    n_pairs, v_out = packed.shape
    tiles = -(-v_out // GEMM_TM)
    pk = torch.zeros(n_pairs, tiles * GEMM_TM, dtype=packed.dtype, device=packed.device)
    pk[:, :v_out] = packed
    pk = pk.view(n_pairs, tiles, GEMM_TM)
    live = torch.stack([((pk >> s) & 1).amax(dim=2) for s in (2, 1, 0)], -1)  # [P, tiles, 3]
    if c <= 32:  # a pair a step
        run, total = int(live.amax(-1).sum()), n_pairs * tiles
    else:
        run, total = int(live.sum()) * (c // 64), n_pairs * tiles * 3 * (c // 64)
    return run, total - run


def phase_train_kernels(capture, card: str, launches: dict):
    """Every backward kernel call of the captured training step, on the
    card, against its plain version; returns the kernel rows."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    if len(capture.rank) != len(RANK_TRAIN_LABELS):
        raise AssertionError(f"captured {len(capture.rank)} rank calls, expected 12")
    rank_rows = [_rank_row(lbl, k, q) for lbl, (k, q) in zip(RANK_TRAIN_LABELS, capture.rank)]

    # each conv backward makes one stacked call, in the order autograd runs them
    st_rows, dw_rows, routes = [], [], []
    for i, ((g, packed, w), conv) in enumerate(zip(capture.stacked, capture.convs)):
        label = backward_label(i, g, conv)
        row, st = _gemm_row(label, g, packed, w, emit=True)
        st_rows.append(row)

        # the dense dW of the stacked path: stackedᵀ @ features, f32 (library call)
        f = conv["features"].to(torch.bfloat16).contiguous()
        st_f32, f_f32 = st.float(), f.float()
        matmul = functools.partial(torch.matmul, st_f32.t(), f_f32)
        lib_ms, lib_dev = timed(matmul), graph_device(matmul)

        # the dW kernel on the same conv: (features, forward rulebook, g)
        row = _dw_row(label, conv, lib_ms, lib_dev["device_ms"])
        dw_rows.append(row)
        routes.append(_route_row(label, row, st_rows[-1], g, packed, w))
        del st, st_f32, f_f32

    sums = {k: sum(r[k] for r in routes) for k in routes[0] if k.endswith("_ms")}
    emit({"phase": "train_kernels", "card": card, "rank_calls": rank_rows,
          "stacked_calls": st_rows, "dw_calls": dw_rows, "padding_cases": _padding_cases(capture),
          "dw_routes": {"calls": routes, "sums": sums}})
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
                   tolerance="1e-3 * max|ref| vs plain and vs the stacked path; two calls "
                             "bit for bit",
                   per="sum over the 21 conv backwards of one bs=4 training step (run on their "
                       "captured inputs; the training step itself takes dW from the stacked taps)",
                   card=card),
    ]
    return {r["name"]: r for r in rows}


def _dw_row(label, conv, library_ms, library_device_ms):
    """The dW kernel on one conv backward's captured (features, forward
    rulebook, masked gradient) against its plain version and against the
    dW the stacked route returned (1e-3·max|ref|), two calls bit for bit,
    two kernels a call in CUDA graphs (the blocks' partials, then their sum
    over row chunks); returns its row with times and bound, and as its
    library call the dense f32 dW of the stacked taps (timed by the
    caller)."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    f = conv["features"].to(torch.bfloat16).contiguous()
    fp, gm, dw_stacked = conv["packed"].contiguous(), conv["g"].contiguous(), conv["dw"]
    run = functools.partial(K.fused_gather_dw, f, fp, gm)
    dw, again = run(), run()
    ref_dw = K.gather_dw_plain(f, fp, gm)
    torch.cuda.synchronize()
    if not torch.equal(dw, again):
        raise AssertionError(f"gather_dw {label}: two calls on the same inputs differ")
    scale = float(ref_dw.abs().max())
    err_plain = float((dw - ref_dw).abs().max())
    err_stacked = float((dw - dw_stacked).abs().max())
    if not (err_plain <= 1e-3 * max(scale, 1e-6) and err_stacked <= 1e-3 * max(scale, 1e-6)):
        raise AssertionError(f"gather_dw {label}: max|Δ| {err_plain} vs plain, {err_stacked} "
                             f"vs the stacked path (max|ref| {scale})")
    del dw, again, ref_dw
    dev = graph_device(run)
    if (dev["kernels"], dev["nodes"]) != (2, 2):  # the blocks' partials, then their sum
        raise AssertionError(f"gather_dw {label}: one call is {dev['kernels']} kernels in "
                             f"{dev['nodes']} device operations, expected 2")
    v_in, c = f.shape
    n_pairs, v_out = fp.shape
    o = gm.shape[1]
    found = _found(fp)
    bytes_ = 2 * v_in * c + 4 * n_pairs * v_out + 2 * v_out * o + 4 * n_pairs * 3 * c * o
    row = dict(label=label, P=n_pairs, V_in=v_in, V_out=v_out, C=c, O=o, taps_found=found,
               ms=timed(run), device_ms=dev["device_ms"], device_kernels=dev["kernels"],
               plain_ms=timed(lambda: K.gather_dw_plain(f, fp, gm)),
               library_ms=library_ms, library_device_ms=library_device_ms,
               bytes_ms=1e3 * bytes_ / H100_BYTES_PER_S,
               ops_ms=1e3 * 2 * found * c * o / H100_BF16_FLOPS,
               max_abs_err=err_plain, max_abs_err_vs_stacked=err_stacked, max_ref=scale,
               bit_equal_twice=True)
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    return row


def _route_row(label, dw_row, st_row, g, packed, w):
    """The two ways to one conv's backward on its captured inputs, by
    device time (CUDA graphs): the dW kernel + the d_features gather without
    taps (`fused_gather_gemm`), against the stacked gather (which also
    writes the taps) + the dense f32 dW of the taps (`torch.matmul`)."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    gb, p = g.to(torch.bfloat16).contiguous(), packed.contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    run = functools.partial(K.fused_gather_gemm, gb, p, wb)
    out, (ref, _) = run(), K.gather_gemm_stacked(gb, p, wb)
    torch.cuda.synchronize()
    _gemm_agrees(f"gather_gemm d_features {label}", out, ref)
    gather = graph_device(run)["device_ms"]
    del out, ref
    row = {"label": label, "dw_kernel_ms": dw_row["device_ms"], "gather_ms": gather,
           "stacked_ms": st_row["device_ms"], "matmul_ms": dw_row["library_device_ms"]}
    row["kernel_route_ms"] = row["dw_kernel_ms"] + row["gather_ms"]
    row["stacked_route_ms"] = row["stacked_ms"] + row["matmul_ms"]
    return row


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
    w = (torch.randn(p.shape[0] * 3 * 5, 8, generator=gen) * 0.1).to(p.device, torch.bfloat16)
    rows = []
    dw, dw_again = K.fused_gather_dw(f, p, g), K.fused_gather_dw(f, p, g)
    torch.cuda.synchronize()
    if not torch.equal(dw, dw_again):
        raise AssertionError("gather_dw C=5 O=8: two calls on the same inputs differ")
    for name, got, ref in (
            ("gather_dw C=5 O=8", dw, K.gather_dw_plain(f, p, g)),
            ("gather_gemm C=5 O=8", K.fused_gather_gemm(f, p, w), K.gather_gemm_plain(f, p, w))):
        torch.cuda.synchronize()
        scale, err = float(ref.abs().max()), float((got - ref).abs().max())
        rows.append({"label": name, "shape": list(got.shape), "max_abs_err": err, "max_ref": scale})
        if not (got.shape == ref.shape and err <= 1e-3 * max(scale, 1e-6)):
            raise AssertionError(f"{name}: max|Δ| {err} (max|ref| {scale}), shape {got.shape}")
    return rows


def offload(capture, device):
    """Move a serving capture's tensors to `device` (the CPU between the
    serving phases and phase variants, so that the training phases' device
    memory is what it was)."""
    capture.rank = [tuple(t.to(device) for t in call) for call in capture.rank]
    capture.gemm = [tuple(t.to(device) for t in call) for call in capture.gemm]
    return capture


def _g3_rows(calls, labels, *, emit, conv_features=None):
    """The g3 kernel on every captured gather-GEMM call that `use_g3`
    admits (`_gemm_row`), each beside gather_gemm.cu's ms and device ms on
    the same call, timed just before it; the stacked rows also time the
    dense dW after the kernel (`torch.matmul`, f32) as their library call.
    Returns (rows, "admitted / calls")."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    rows = []
    for i, (features, packed, weights) in enumerate(calls):
        with switches(K, g3=True):
            if not K.use_g3(features.shape[1], packed.shape[0]):
                continue
        default, _ = _gemm_row(labels[i], features, packed, weights, emit=emit)
        row, st = _gemm_row(labels[i], features, packed, weights, emit=emit, g3=True)
        row.update(default_ms=default["ms"], default_device_ms=default["device_ms"])
        if emit:
            st_f32, f_f32 = st.float(), conv_features[i].to(torch.bfloat16).float()
            row["library_ms"] = timed(lambda: torch.matmul(st_f32.t(), f_f32))
            del st_f32, f_f32
        rows.append(row)
        del st
    return rows, f"{len(rows)} / {len(calls)}"


def phase_variant_kernels(serve, train, card: str):
    """Per-kernel part of phase `variants`: the seq4 and hostwin rank kernels
    on all 8 serving-forward and 12 training-step rank calls (counts equal
    everywhere to the plain version and to rank_flags.cu, flags equal at
    valid queries, one device kernel a call) and all three rank kernels on
    the hazard cases, the g3 kernel on every captured forward and stacked
    call its gate admits. Returns the kernel rows by name."""
    edges = rank_edge_cases()
    rank = {}
    for impl in ("seq4", "hostwin"):
        rank[impl] = {
            "serve": [_rank_row(RANK_LABELS[i], k, q, impl) for i, (k, q) in enumerate(serve.rank)],
            "train": [_rank_row(lbl, k, q, impl)
                      for lbl, (k, q) in zip(RANK_TRAIN_LABELS, train.rank)],
        }
    fwd_rows, fwd_admitted = _g3_rows(serve.gemm, [gemm_label(i) for i in range(21)], emit=False)
    st_rows, st_admitted = _g3_rows(
        train.stacked, [backward_label(i, call[0], conv)
                        for i, (call, conv) in enumerate(zip(train.stacked, train.convs))],
        emit=True, conv_features=[c["features"] for c in train.convs])
    emit({"phase": "variant_kernels", "card": card, "rank_edge_cases": edges,
          "rank_calls": {impl: rows for impl, rows in rank.items()},
          "g3_admitted": {"forward": fwd_admitted, "stacked": st_admitted},
          "g3_calls": fwd_rows, "g3_stacked_calls": st_rows})
    want = (VARIANT_SERVE_LAUNCHES["gather_gemm_g3"], VARIANT_TRAIN_LAUNCHES["gather_gemm_g3_stacked"])
    if (len(fwd_rows), len(st_rows)) != want:
        raise AssertionError(f"the g3 gate admits {fwd_admitted} forward and {st_admitted} "
                             f"stacked calls, expected {want}")
    per_step = "sum over the calls of one bs=4 training step"
    library = "torch.searchsorted (count field only)"
    rows = [
        kernel_row("rank_flags_seq4", "rank_flags_seq4.cu", 944, 0, rank["seq4"]["train"],
                   library_call=library, tolerance="exact, and equal to rank_flags.cu",
                   per=per_step + " (8 forward + 4 inverse rulebooks)", card=card),
        kernel_row("rank_flags_hostwin", "rank_flags_hostwin.cu", 842, 0, rank["hostwin"]["train"],
                   library_call=library, tolerance="exact, and equal to rank_flags.cu",
                   per=per_step + " (8 forward + 4 inverse rulebooks; efg_tpu runs its "
                       "counterpart on no model path, nor does the port)", card=card),
        kernel_row("gather_gemm_g3", "gather_gemm_g3.cu", 290, 0, fwd_rows,
                   tolerance="1e-3 * max|ref|",
                   per="sum over the 16 calls of one bs=4 serving forward that the gate admits",
                   card=card),
        kernel_row("gather_gemm_g3_stacked", "gather_gemm_g3.cu", 290, 0, st_rows,
                   tolerance="taps bit-exact, out 1e-3 * max|ref|",
                   library_call="torch.matmul of the stacked taps (the dense dW after the "
                                "kernel), f32 operands",
                   per=per_step + " (the 15 conv backwards the gate admits)", card=card),
    ]
    for r, calls in zip(rows[2:], (fwd_rows, st_rows)):  # gather_gemm.cu on the same calls
        r["default_ms"] = round(sum(x["default_ms"] for x in calls), 6)
        r["default_device_ms"] = round(sum(x["default_device_ms"] for x in calls), 6)
    for r, impl in zip(rows[:2], ("seq4", "hostwin")):
        r["serve_ms"] = round(sum(x["ms"] for x in rank[impl]["serve"]), 6)
        # against one torch.searchsorted on the same calls, in time and in device time
        r["ms_over_library"] = r["ms"] / r["library_ms"]
        r["device_ms_over_library"] = r["device_ms"] / r["library_device_ms"]
    return {r["name"]: r for r in rows}


class RuleCapture:
    """Records every rulebook built inside the block (builder, arguments,
    result), so that each can be built again under the default kernel."""

    BUILDERS = ("build_monotone_rule9", "build_monotone_rule_strided",
                "build_monotone_rule_strided_inverse")

    def __init__(self, K):
        self.K, self.calls = K, []

    def __enter__(self):
        self._orig = {n: getattr(self.K, n) for n in self.BUILDERS}
        for name, fn in self._orig.items():
            def spy(*args, fn=fn, **kw):
                out = fn(*args, **kw)
                self.calls.append((fn, args, kw, out))
                return out
            setattr(self.K, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.K, name, fn)
        return False

    def check_against_default(self, what: str) -> int:
        """Rebuild every recorded rulebook with the default rank kernel and
        require it bit for bit; returns the number compared."""
        import torch

        for fn, args, kw, out in self.calls:
            ref = fn(*args, **kw)
            got, want = (out, ref) if torch.is_tensor(out) else (out[0], ref[0])
            if not torch.equal(got, want) or (not torch.is_tensor(out) and out[1] != ref[1]):
                raise AssertionError(f"{what}: {fn.__name__} under seq4 differs from the default")
        return len(self.calls)


def phase_variants(card: str, default_step1: dict):
    """The path of phase `variants`: under EFG_RANK_IMPL=seq4 and
    EFG_SPARSE_G3, the full-width flagship (weights from SEED) serves two
    bs=4 requests and trains a warm-up step and TRAIN_STEPS timed steps on
    phase train's batch. Launches are reset before and read after each
    request and step. Held against the default path: every rulebook of the
    first request and of the first step bit for bit (rebuilt with
    rank_flags.cu), the head maps within phase check's tolerance, step 1's
    loss and grad_norm within train_check's step-1 tolerances."""
    import torch

    from efg_tpu_torch.engine.train_state import ModelDef
    from efg_tpu_torch.engine.trainer import eval_step, init_state, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    md, _ = make_model(FLAGSHIP, "cuda")
    n_rules, serve_counts = 0, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, (bsz, seed) in enumerate(BATCHES[2:]):
        batch = flagship_batch(bsz, seed)
        torch.cuda.synchronize()
        K.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        rules = RuleCapture(K)
        with switches(K, "seq4", True), (rules if i == 0 else contextlib.nullcontext()):
            start.record()
            out = eval_step(md, batch)
            end.record()
            torch.cuda.synchronize()
        counts = serve_counts = dict(K.launches)
        finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
        emit({"phase": "variants", "part": "serve", "request": i, "batch_size": bsz,
              "latency_ms_cuda_events": round(start.elapsed_time(end), 3),
              "valid_detections": int(out["valid"].sum()), "finite": finite, "launches": counts,
              "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2**30, 3), "card": card})
        if not finite or out["box3d"].shape != (bsz, POST_CFG["nms"]["nms_post_max_size"], 7):
            raise AssertionError(f"variants request {i}: non-finite or misshapen outputs")
        if counts != VARIANT_SERVE_LAUNCHES:
            raise AssertionError(f"variants request {i}: launches {counts}, "
                                 f"expected {VARIANT_SERVE_LAUNCHES}")
        n_rules += rules.check_against_default(f"variants request {i}")
        del rules

    raw = ModelDef(md.module, md.apply_args)  # the eval step without predict: head maps
    with switches(K, "seq4", True):
        got = eval_step(raw, batch)
    ref = eval_step(raw, batch)
    worst = 0.0
    for t_ref, t_got in zip(ref, got):
        for name in t_ref:
            a, b = t_ref[name].float(), t_got[name].float()
            err = float((a - b).abs().max() / max(float(a.abs().max()), 1.0))
            worst = max(worst, err)
            if not err <= 3e-2:  # phase check's tolerance
                raise AssertionError(f"variants head map {name}: rel err {err} vs the default")
    del got, ref, out, batch

    tx = make_solver()
    state = init_state(md, tx)
    batch = train_batch(*TRAIN_BATCH, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step1 = None
    for i in range(TRAIN_STEPS + 1):  # warm-up, then the timed steps
        K.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        rules = RuleCapture(K)
        with switches(K, "seq4", True), (rules if i == 0 else contextlib.nullcontext()):
            start.record()
            metrics = train_step(md, tx, state, batch)
            end.record()
            torch.cuda.synchronize()
        counts = dict(K.launches)
        ms = start.elapsed_time(end)
        vals = {k: float(v) for k, v in metrics.items()}
        step1 = step1 or vals
        emit({"phase": "variants", "part": "train", "step": i,
              "kind": "warm-up" if i == 0 else "timed", "batch_size": TRAIN_BATCH[0],
              "step_ms_cuda_events": round(ms, 3),
              "train_frames_per_s": round(TRAIN_BATCH[0] / ms * 1e3, 3), "losses": vals,
              "launches": counts,
              "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2**30, 3), "card": card})
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"variants train step {i}: non-finite losses {vals}")
        if counts != VARIANT_TRAIN_LAUNCHES:
            raise AssertionError(f"variants train step {i}: launches {counts}, "
                                 f"expected {VARIANT_TRAIN_LAUNCHES}")
        n_rules += rules.check_against_default(f"variants train step {i}")
        del rules
    readings = {k: abs(step1[k] - default_step1[k]) / abs(default_step1[k])
                for k in ("loss", "0_hm_loss", "0_loc_loss", "grad_norm")}
    emit({"phase": "variants", "part": "check", "rulebooks_equal_to_default": n_rules,
          "head_map_rel_err": worst, "step1_rel_err_vs_default": readings,
          "step1_tolerance": dict(zip(("losses", "grad_norm"), CHECK_STEP_TOL[False]))})
    for k, x in readings.items():
        if not x <= CHECK_STEP_TOL[False][k == "grad_norm"]:
            raise AssertionError(f"variants step 1 {k}: rel err {x} vs the default path")
    return serve_counts, counts


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
    if "device_ms" in rows[0]:  # device time and kernels from CUDA graphs
        row.update(device_ms=total("device_ms"),
                   device_kernels_per_call=max(r["device_kernels"] for r in rows))
    if "library_device_ms" in rows[0]:
        row["library_device_ms"] = total("library_device_ms")
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


def _check_readings(a_out, a_grads, b_out, b_grads, leaf_tols=None):
    """Readings of run a against run b, each beside its tolerance, and the
    names of those above it. A leaf is held at `leaf_tols[its reading's
    name]` where given, else at CHECK_LEAF_TOL."""
    readings, failed = [], []
    leaf_tols = leaf_tols or {}

    def hold(what, x, tol):
        readings.append({"what": what, "reading": x, "tolerance": tol})
        if not x <= tol:
            failed.append(what)

    for n, g in b_grads.items():
        if not ZERO_GRAD.search(n):
            hold(f"grad {n}", float((a_grads[n] - g).norm() / max(float(g.norm()), 1e-30)),
                 leaf_tols.get(f"grad {n}", CHECK_LEAF_TOL))
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
    emit({"phase": "train_profile", "card": card, "batch_size": TRAIN_BATCH[0],
          **profile_parts(prof)})


def profile_parts(prof, top_n=15) -> dict:
    """A torch.profiler run's `part:<name>` ranges (each ended by a device
    synchronization): per part the wall time, the device's busy time (union
    of its kernel and copy intervals), the idle share and the device event
    count; their sums; and the kernels that take the most device time."""
    from torch.autograd import DeviceType

    events = prof.events()
    # device-side events, without the profiler's own range annotations
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and not e.name.startswith("part:")]
    if not device:
        raise AssertionError("profile: the profiler recorded no device activity")

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
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:top_n]
    return {"parts": parts, "step_wall_ms": wall, "step_device_busy_ms": busy,
            "step_device_idle_share": 1 - busy / wall, "device_events": len(device),
            "top_device_time": [{"name": n[:120], "count": c, "ms": ms} for n, (c, ms) in top]}


class LoopProbe:
    """Wraps the trainer loop's `train_step` and its prefetcher's `next`
    for one CLI run: each step's CUDA-event milliseconds (from its first
    launch to its last kernel) and each batch's host seconds in `next`
    (building the batch, pinning it and starting its copy)."""

    def __init__(self):
        self.step_events, self.data_s = [], []

    def __enter__(self):
        import torch

        from efg_tpu_torch.data import prefetcher as P
        from efg_tpu_torch.engine import trainer as T

        self._orig = (T.train_step, P.DevicePrefetcher.__next__)
        step0, next0 = self._orig

        def step(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = step0(*args, **kwargs)
            b.record()
            self.step_events.append((a, b))
            return out

        def next_(it):
            t0 = time.perf_counter()
            out = next0(it)
            self.data_s.append(time.perf_counter() - t0)
            return out

        T.train_step, P.DevicePrefetcher.__next__ = step, next_
        return self

    def __exit__(self, *exc):
        from efg_tpu_torch.data import prefetcher as P
        from efg_tpu_torch.engine import trainer as T

        T.train_step, P.DevicePrefetcher.__next__ = self._orig
        return False

    def step_ms(self):
        return [a.elapsed_time(b) for a, b in self.step_events]


def _engine_run(argv, out_dir, device, config=ENGINE_CONFIG):
    """One in-process CLI run of `config` with the launch counts reset
    before it; returns (its metrics.json records from this run, launch
    counts, probe)."""
    from efg_tpu_torch.cli import main as cli
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    metrics = os.path.join(out_dir, "metrics.json")
    n_before = sum(1 for _ in open(metrics)) if os.path.exists(metrics) else 0
    K.reset_launches()
    with LoopProbe() as probe:
        rc = cli.main(["--config", os.path.join(HERE, config), "--device", device, *argv])
    counts = dict(K.launches)
    if rc != 0:
        raise AssertionError(f"engine: the CLI returned {rc} for {argv}")
    with open(metrics) as f:
        records = [json.loads(line) for line in f][n_before:]
    return records, counts, probe


def _losses(records, label="engine"):
    """{iteration: record} of the records that carry a loss; every loss
    part and the gradient norm must be finite."""
    out = {int(r["iteration"]): r for r in records if "loss" in r}
    bad = {it: k for it, r in out.items() for k, v in r.items()
           if ("loss" in k or k == "grad_norm") and not np.isfinite(v)}
    if bad:
        raise AssertionError(f"{label}: non-finite losses {bad}")
    return out


def _data_item_ms(opts, items=3):
    """Host milliseconds of one dataset item of the run `opts` configure,
    split into scene generation and each processor (medians over
    `items` items, each seeded as the loader seeds it)."""
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.data import build_dataset

    config = Configuration(config_file=os.path.join(HERE, ENGINE_CONFIG),
                           opts=["task=train", *opts]).get_config()
    ds = build_dataset(config)
    parts = {}
    for idx in range(items):
        np.random.seed(idx)
        t0 = time.perf_counter()
        points, boxes, names = ds._gen_scene(idx)
        parts.setdefault("scene", []).append(time.perf_counter() - t0)
        info = {"annotations": {"gt_boxes": boxes, "gt_names": names}, "sweeps": []}
        for proc in ds.transforms:
            t0 = time.perf_counter()
            points, info = proc(points, info)
            parts.setdefault(repr(proc), []).append(time.perf_counter() - t0)
    return {k: 1e3 * float(np.median(v)) for k, v in parts.items()}


def _steps_of(per_step: dict, steps: int) -> dict:
    return {k: v * steps for k, v in per_step.items()}


def phase_engine(card: str, bare_step_ms, device="cuda", small=()):
    """The port's CLI (`efg_tpu_torch.cli.main`) in process, output under a
    temporary EFG_CACHE_DIR:
    1. the synthetic experiment as written, 30 iterations: records 1-30
       with finite losses, the mean of the last 5 below the first 5's,
       model_0000014 (the checkpoint after step 15) and model_final, and
       the launch counts of 30 steps of phase train (the trainer's setup
       runs no kernel: torch modules are created without a forward);
    2. model_final removed, a --resume run from step 15: records 16-30
       within train_check's tolerances of run 1's (their largest relative
       difference and whether they are equal bit for bit are printed);
    3. the flagship's full width through the same entry point, 8
       iterations: launches per step as phase train, finite losses, the
       median iteration `time` (metrics.json), the loop's step and
       data time, the bare step of phase train, and peak memory.
    `small` overrides shrink every run for a rehearsal on the CPU."""
    import tempfile

    import torch

    cache = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    os.environ["EFG_CACHE_DIR"] = cache
    from efg_tpu_torch.cli.main import experiment_relpath

    out_dir = os.path.join(cache, "EFG_torch", experiment_relpath(ENGINE_CONFIG))
    try:
        records, counts, probe = _engine_run(["task=train", *ENGINE_RUN, *small], out_dir, device)
        run1 = _losses(records)
        expected = _steps_of(TRAIN_LAUNCHES, ENGINE_ITERS)
        setup_share = {k: counts[k] - expected[k] for k in counts}
        files = sorted(f for f in os.listdir(out_dir) if f.startswith("model_"))
        first5 = float(np.mean([run1[i]["loss"] for i in range(1, 6)]))
        last5 = float(np.mean([run1[i]["loss"] for i in range(ENGINE_ITERS - 4, ENGINE_ITERS + 1)]))
        emit({"phase": "engine", "part": "experiment", "card": card, "iterations": ENGINE_ITERS,
              "records": sorted(run1), "loss_first5_mean": first5, "loss_last5_mean": last5,
              "checkpoints": files, "launches": counts, "launches_expected": expected,
              "setup_share": setup_share,
              "iteration_time_ms_median": 1e3 * float(np.median(
                  [r["time"] for r in records if "time" in r and r["iteration"] < ENGINE_ITERS])),
              "loop_step_ms_cuda_events_median": float(np.median(probe.step_ms())),
              "data_time_ms_median": 1e3 * float(np.median(probe.data_s))})
        if sorted(run1) != list(range(1, ENGINE_ITERS + 1)):
            raise AssertionError(f"engine: records {sorted(run1)}, expected 1-{ENGINE_ITERS}")
        if not last5 < first5:
            raise AssertionError(f"engine: loss did not fall ({first5} → {last5})")
        if files != ["model_0000014", "model_final"]:
            raise AssertionError(f"engine: checkpoints {files}")
        if counts != expected:
            raise AssertionError(f"engine: launches {counts}, expected {expected}")

        os.remove(os.path.join(out_dir, "model_final"))
        records, counts, _ = _engine_run(["--resume", "task=train", *ENGINE_RUN, *small],
                                         out_dir, device)
        run2 = _losses(records)
        keys = ("loss", "0_hm_loss", "0_loc_loss", "grad_norm")
        rel = {it: {k: abs(run2[it][k] - run1[it][k]) / abs(run1[it][k]) for k in keys}
               for it in run2}
        worst = max(max(v.values()) for v in rel.values())
        worst_at = max(((it, k) for it, v in rel.items() for k in v), key=lambda ik: rel[ik[0]][ik[1]])
        bits = all(run2[it][k] == run1[it][k] for it in run2 for k in keys)
        expected = _steps_of(TRAIN_LAUNCHES, ENGINE_ITERS - 15)
        emit({"phase": "engine", "part": "resume", "card": card, "records": sorted(run2),
              "max_rel_diff_vs_run1": worst, "max_rel_diff_at": worst_at,
              # record 16 holds the loss of the first step after the
              # restore, computed on the restored weights before any update
              "max_rel_diff_by_record": {it: max(v.values()) for it, v in sorted(rel.items())},
              "equal_bit_for_bit": bits,
              "tolerance": dict(zip(("losses", "grad_norm"), CHECK_STEP_TOL[True])),
              "launches": counts, "launches_expected": expected})
        if sorted(run2) != list(range(16, ENGINE_ITERS + 1)):
            raise AssertionError(f"engine resume: records {sorted(run2)}, expected 16-30")
        over = [(it, k) for it, v in rel.items() for k, x in v.items()
                if not x <= CHECK_STEP_TOL[True][k == "grad_norm"]]
        if over:
            raise AssertionError(f"engine resume: above tolerance vs run 1: {over}")
        if counts != expected:
            raise AssertionError(f"engine resume: launches {counts}, expected {expected}")

        flag_cache = os.path.join(cache, "flagship")
        os.environ["EFG_CACHE_DIR"] = flag_cache
        flag_dir = out_dir.replace(cache, flag_cache, 1)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        records, counts, probe = _engine_run(["task=train", *ENGINE_FLAGSHIP, *small], flag_dir,
                                             device)
        run3 = _losses(records)
        expected = _steps_of(TRAIN_LAUNCHES, ENGINE_FLAGSHIP_ITERS)
        # IterTimer's "time" after its 3 warm-up iterations (the record
        # written after training repeats the last one)
        times = [r["time"] for r in records
                 if "time" in r and r["iteration"] < ENGINE_FLAGSHIP_ITERS]
        step_ms = probe.step_ms()
        out = {"phase": "engine", "part": "flagship", "card": card,
               "batch_size": 4, "points_per_cloud": N_POINTS,
               "iterations": ENGINE_FLAGSHIP_ITERS, "records": sorted(run3),
               "losses": [run3[i]["loss"] for i in sorted(run3)],
               "iteration_time_ms_median": 1e3 * float(np.median(times)) if times else None,
               "iteration_time_ms": [1e3 * t for t in times],
               "loop_step_ms_cuda_events_median": float(np.median(step_ms[1:])),
               "loop_step_ms_cuda_events": step_ms,
               "data_time_ms_median": 1e3 * float(np.median(probe.data_s[1:])),
               "data_time_ms": [1e3 * t for t in probe.data_s],
               "bare_train_step_ms_median": float(np.median(bare_step_ms)),
               "bare_train_step_ms": list(bare_step_ms),
               "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2**30, 3)
               if device == "cuda" else None,
               "launches": counts, "launches_expected": expected}
        out["data_item_ms"] = _data_item_ms([*ENGINE_FLAGSHIP, *small])
        emit(out)
        if sorted(run3) != list(range(1, ENGINE_FLAGSHIP_ITERS + 1)):
            raise AssertionError(f"engine flagship: records {sorted(run3)}")
        if counts != expected:
            raise AssertionError(f"engine flagship: launches {counts}, expected {expected}")
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        import shutil

        shutil.rmtree(cache, ignore_errors=True)


def _evaluator_classes():
    from efg_tpu_torch.evaluator.coco_evaluator import COCOEvaluator
    from efg_tpu_torch.evaluator.nuscenes_evaluator import nuScenesDetEvaluator
    from efg_tpu_torch.evaluator.panoptic_evaluator import PanopticEvaluator
    from efg_tpu_torch.evaluator.tracking_evaluator import TrackingEvaluator
    from efg_tpu_torch.evaluator.waymo_evaluator import WaymoDetEvaluator

    return [WaymoDetEvaluator, nuScenesDetEvaluator, TrackingEvaluator, COCOEvaluator,
            PanopticEvaluator]


class EvalProbe:
    """Wraps, for one CLI run, what `DefaultTrainer.evaluate` runs: each
    `evaluate` call (trainer iteration, results, host seconds), each
    `eval_step` (CUDA-event milliseconds, from its first launch to its last
    kernel), each eval batch's host seconds in the val loader's `next`, and
    the host seconds of the evaluators' `process` (per batch) and
    `evaluate` (WaymoDetEvaluator, nuScenesDetEvaluator). Training loaders
    (drop_last) are not timed."""

    def __init__(self):
        self.evaluations, self.step_events = [], []
        self.data_s, self.process_s, self.evaluator_s, self.batches = [], [], [], []

    def __enter__(self):
        import torch

        from efg_tpu_torch.data import builder as DB
        from efg_tpu_torch.engine import trainer as T

        self._orig = (T.eval_step, T.DefaultTrainer.evaluate, DB.DataLoader.__iter__)
        self._orig_ev = [(E, E.process, E.evaluate) for E in _evaluator_classes()]
        step0, evaluate0, iter0 = self._orig
        probe = self

        def step(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = step0(*args, **kwargs)
            b.record()
            probe.step_events.append((a, b))
            return out

        def evaluate(trainer, evaluators=None):
            t0 = time.perf_counter()
            res = evaluate0(trainer, evaluators)
            probe.evaluations.append((trainer.iter, res, time.perf_counter() - t0))
            return res

        def iter_(loader):
            it = iter0(loader)
            if loader.drop_last:
                yield from it
                return
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                probe.data_s.append(time.perf_counter() - t0)
                yield batch

        def wrap(process0, evaluate0):
            def process(ev, inputs, outputs):
                t0 = time.perf_counter()
                process0(ev, inputs, outputs)
                probe.process_s.append(time.perf_counter() - t0)
                probe.batches.append(inputs)

            def ev_evaluate(ev):
                t0 = time.perf_counter()
                res = evaluate0(ev)
                probe.evaluator_s.append(time.perf_counter() - t0)
                return res

            return process, ev_evaluate

        T.eval_step, T.DefaultTrainer.evaluate, DB.DataLoader.__iter__ = step, evaluate, iter_
        for E, process0, ev_evaluate0 in self._orig_ev:
            E.process, E.evaluate = wrap(process0, ev_evaluate0)
        return self

    def __exit__(self, *exc):
        from efg_tpu_torch.data import builder as DB
        from efg_tpu_torch.engine import trainer as T

        T.eval_step, T.DefaultTrainer.evaluate, DB.DataLoader.__iter__ = self._orig
        for E, process0, ev_evaluate0 in self._orig_ev:
            E.process, E.evaluate = process0, ev_evaluate0
        return False

    def step_ms(self):
        return [a.elapsed_time(b) for a, b in self.step_events]


def _cli_eval_run(argv, device, config=ENGINE_CONFIG):
    """One in-process CLI run of the experiment with the launch counts
    reset before it; returns (launch counts, probe)."""
    from efg_tpu_torch.cli import main as cli
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    K.reset_launches()
    with EvalProbe() as probe:
        rc = cli.main(["--config", os.path.join(HERE, config), "--device", device, *argv])
    counts = dict(K.launches)
    if rc != 0:
        raise AssertionError(f"eval: the CLI returned {rc} for {argv}")
    return counts, probe


def _check_waymo_results(label, res, classes):
    want = {f"waymo/{c}/{lvl}/{m}" for c in classes for lvl in ("L1", "L2")
            for m in ("AP", "APH")} | {"waymo/mAPH/L2"}
    if set(res) != want:
        raise AssertionError(f"eval {label}: result keys {sorted(res)}, expected {sorted(want)}")
    bad = {k: v for k, v in res.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"eval {label}: non-finite results {bad}")


def _global_kernels(*sources) -> list:
    """Names of the `__global__` functions defined in csrc sources."""
    names = []
    for src in sources:
        with open(os.path.join(HERE, "efg_tpu_torch", "csrc", src)) as f:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                f.read())
    return names


def _perfect_predictions(batches, k=300):
    """Each frame's GT boxes as the eval step's fixed-shape outputs: box3d
    [B, k, 9], scores 0.9, labels the GT classes, valid the GT rows."""
    box3d, scores, labels, valid = [], [], [], []
    for inputs in batches:
        for anno in inputs["annotations"]:
            g = np.asarray(anno["gt_boxes"], np.float32)
            n = len(g)
            b = np.zeros((k, 9), np.float32)
            b[:n] = g
            box3d.append(b)
            scores.append(np.where(np.arange(k) < n, 0.9, 0.0).astype(np.float32))
            labels.append(np.pad(np.asarray(anno["labels"], np.int32), (0, k - n)))
            valid.append(np.arange(k) < n)
    return dict(box3d=np.stack(box3d), scores=np.stack(scores), labels=np.stack(labels),
                valid=np.stack(valid))


def phase_eval(card: str, device="cuda", small=()):
    """Evaluation through the port's CLI in process, output under a
    temporary EFG_CACHE_DIR:
    (a) the synthetic experiment as written (its WaymoDetEvaluator on),
        30 iterations with `trainer.eval_period=0.5`: EvalHook evaluates
        once (iteration 15) and the CLI once after training; every result
        is a finite `waymo/*` value; launches = 30 × phase train's per
        step + the eval batches × (8, 21); the profiler's trace of
        iterations 5-6 names the `__global__` kernels of rank_flags.cu and
        gather_gemm.cu;
    (b) task=val at the flagship's width (16 frames of 160k points, bs 4,
        fresh weights): per batch the eval step (CUDA events), the data
        time and the evaluator's time (host), val frames/s over the whole
        `evaluate`; launches = 4 × (8, 21);
    (c) the GT boxes of (b)'s frames fed as predictions, moved through the
        card as the eval step's outputs are: AP = APH = 1.0 at L1 and L2
        for every class that has GT, with both metric cores.
    `small` overrides shrink every run for a rehearsal on the CPU."""
    import shutil
    import tempfile

    import torch

    from efg_tpu_torch.cli.main import experiment_relpath
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.engine.trainer import _to_numpy
    from efg_tpu_torch.evaluator.waymo_evaluator import WaymoDetEvaluator

    cache = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    try:
        # (a) the experiment as written, evaluating during and after training
        os.environ["EFG_CACHE_DIR"] = os.path.join(cache, "experiment")
        argv = ["task=train", *EVAL_RUN, *small]
        cfg = Configuration(config_file=os.path.join(HERE, ENGINE_CONFIG), opts=argv).get_config()
        iters = int(cfg.solver.lr_scheduler.max_iters)
        bs = int(cfg.dataloader.batch_size)
        period = int(float(cfg.trainer.eval_period) * (int(cfg.dataset.num_frames) // bs))
        per_eval = -(-int(cfg.dataset.num_frames) // bs)
        prof = dict(cfg.trainer.profiler)
        counts, probe = _cli_eval_run(argv, device)
        eval_iters = [it for it in range(iters - 1) if (it + 1) % period == 0] + [iters]
        n_eval = len(probe.step_events)
        expected = {k: iters * TRAIN_LAUNCHES[k] + n_eval * SERVE_LAUNCHES[k] for k in counts}
        out_dir = os.path.join(cache, "experiment", "EFG_torch", experiment_relpath(ENGINE_CONFIG))
        trace = os.path.join(out_dir, "profile",
                             f"trace_{prof['start_iter']}_{prof['start_iter'] + prof['num_iters']}.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        hand = {"rank_flags.cu": _global_kernels("rank_flags.cu"),
                "gather_gemm.cu": _global_kernels("gather_gemm.cu", "gather_gemm_core.cuh")}
        named = {src: sorted({g for g in names for k in kernels if g in k})
                 for src, names in hand.items()}
        emit({"phase": "eval", "part": "experiment", "card": card, "iterations": iters,
              "eval_period_iters": period, "evaluated_at_iter": [it for it, _, _ in probe.evaluations],
              "evaluated_at_iter_expected": eval_iters, "eval_batches": n_eval,
              "results": [res for _, res, _ in probe.evaluations],
              "evaluate_s": [s for _, _, s in probe.evaluations],
              "eval_step_ms_cuda_events_median": float(np.median(probe.step_ms())),
              "launches": counts, "launches_expected": expected,
              "trace": os.path.basename(trace), "trace_kernel_names": len(kernels),
              "trace_names_hand_kernels": named})
        if [it for it, _, _ in probe.evaluations] != eval_iters:
            raise AssertionError(f"eval: evaluated at {[it for it, _, _ in probe.evaluations]}, "
                                 f"expected {eval_iters}")
        if n_eval != per_eval * len(eval_iters):
            raise AssertionError(f"eval: {n_eval} eval batches, expected {per_eval} × "
                                 f"{len(eval_iters)}")
        for it, res, _ in probe.evaluations:
            _check_waymo_results(f"experiment at iteration {it}", res, list(cfg.dataset.classes))
        if counts != expected:
            raise AssertionError(f"eval: launches {counts}, expected {expected}")
        if device == "cuda" and not all(named.values()):
            raise AssertionError(f"eval: the profiler trace names {named} of the hand kernels "
                                 f"{hand} among {len(kernels)} kernels")

        # (b) task=val at the flagship's width
        os.environ["EFG_CACHE_DIR"] = os.path.join(cache, "flagship")
        argv = ["task=val", *EVAL_FLAGSHIP, *small]
        cfg = Configuration(config_file=os.path.join(HERE, ENGINE_CONFIG), opts=argv).get_config()
        counts, probe = _cli_eval_run(argv, device)
        frames = int(cfg.dataset.num_frames)
        n_batches = -(-frames // int(cfg.dataloader.batch_size))
        expected = {k: n_batches * SERVE_LAUNCHES[k] for k in counts}
        (_, res, evaluate_s), = probe.evaluations
        step_ms = probe.step_ms()
        emit({"phase": "eval", "part": "flagship_val", "card": card,
              "batch_size": int(cfg.dataloader.batch_size), "points_per_cloud": N_POINTS,
              "frames": frames, "weights": "fresh (misc.seed)",
              "batches": [{"eval_step_ms_cuda_events": m, "data_ms": 1e3 * d,
                           "evaluator_process_ms": 1e3 * p}
                          for m, d, p in zip(step_ms, probe.data_s, probe.process_s)],
              "evaluator_evaluate_ms": 1e3 * sum(probe.evaluator_s),
              "evaluate_s": evaluate_s, "val_frames_per_s": frames / evaluate_s,
              "results": res, "launches": counts, "launches_expected": expected})
        if len(step_ms) != n_batches:
            raise AssertionError(f"eval flagship: {len(step_ms)} eval steps, expected {n_batches}")
        _check_waymo_results("flagship", res, list(cfg.dataset.classes))
        if counts != expected:
            raise AssertionError(f"eval flagship: launches {counts}, expected {expected}")

        # (c) perfect predictions through the evaluators
        outputs = {k: torch.from_numpy(v).to(device) for k, v in
                   _perfect_predictions(probe.batches).items()}
        outputs = _to_numpy(outputs)
        inputs = {"annotations": [a for b in probe.batches for a in b["annotations"]]}
        has_gt = sorted({cfg.dataset.classes[int(c) - 1] for a in inputs["annotations"]
                         for c in a["labels"]})
        perfect = {}
        for core in ("official", "greedy"):
            cfg["trainer"]["waymo_metric"] = core
            ev = WaymoDetEvaluator(cfg, None)
            ev.process(inputs, outputs)
            perfect[core] = ev.evaluate()
        emit({"phase": "eval", "part": "perfect_predictions", "card": card,
              "frames": len(inputs["annotations"]), "classes_with_gt": has_gt,
              "results": perfect})
        for core, r in perfect.items():
            off = {k: r[k] for c in has_gt for lvl in ("L1", "L2") for m in ("AP", "APH")
                   for k in [f"waymo/{c}/{lvl}/{m}"] if not abs(r[k] - 1.0) <= 1e-6}
            if off or not has_gt:
                raise AssertionError(f"eval perfect ({core}): not 1.0: {off}, classes {has_gt}")
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(cache, ignore_errors=True)


class StageEvents:
    """CUDA events recorded on the stream before and after each stage of
    one Voxel-DETR forward (the sparse trunk, FPN, each encoder layer, the
    proposal head, the decoder), by module hooks, so the forward itself
    runs unchanged. `ms(start, end)` gives each stage's milliseconds and
    the rest between them ("voxelize_vfe" before the trunk; "input_proj"
    from the FPN to the first encoder layer; "topk" from the proposal head
    to the decoder; "predict" after it)."""

    def __init__(self, detr):
        self.parts = ["backbone", "fpn"] + [f"enc{i}" for i in range(detr.enc_layers)] + [
            "proposal_head", "decoder"]
        self.modules = [getattr(detr, p) for p in self.parts]
        self.events = []

    def _record(self, name):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def __enter__(self):
        self.hooks = []
        for name, m in zip(self.parts, self.modules):
            self.hooks.append(m.register_forward_pre_hook(
                lambda *_, n=name: self._record(n + ":start")))
            self.hooks.append(m.register_forward_hook(lambda *_, n=name: self._record(n + ":end")))
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        return False

    def ms(self, start, end) -> dict:
        gaps = {"backbone": "voxelize_vfe", "enc0": "input_proj", "decoder": "topk"}
        out, prev = {}, start
        for name, e in self.events:
            part, edge = name.split(":")
            if edge == "start":
                if part in gaps:
                    out[gaps[part]] = prev.elapsed_time(e)
                begin = e
            else:
                out[part] = begin.elapsed_time(e)
            prev = e
        out["predict"] = prev.elapsed_time(end)
        return out


def make_detr(kw, device, seed=DETR_SEED):
    """ConQueR's serving ModelDef (the port's make_model_def) for widths
    `kw`, every parameter and BN statistic drawn by `seeded_weights` from
    `seed` on the CPU, then moved to `device`."""
    import torch

    from efg_tpu_torch.models import conquer as CQ

    cfg = dict(pc_range=kw["pc_range"], voxel_size=kw["voxel_size"], contrastive={"dim": 256})
    md = CQ.make_model_def(kw, cfg, device="cpu")
    seeded_weights(md.module, seed)
    md.module.to(torch.device(device))
    return md


def detr_batch(bsz: int, seed: int, device="cuda", n_points: int = N_POINTS, pc: float = 70.0):
    import torch

    pts = torch.from_numpy(lidar_frames(n_points, bsz, seed, pc=pc)["points"]).to(device)
    return dict(points=pts, points_mask=torch.ones(pts.shape[:2], dtype=torch.bool, device=device))


def _detr_forward(md, batch):
    """The module's raw outputs (the eval step without predict)."""
    import torch

    md.module.eval()
    with torch.inference_mode():
        return md.module(**md.apply_args(batch))


def _detr_agrees(label, got, want, tol=DETR_TOL):
    """Two ConQueR forwards on the same inputs: the proposal logits and
    boxes within `tol` of their range; the top-k sets equal outside the tie
    band (twice the largest proposal-score difference: random weights leave
    scores within 1e-7 of each other, whose order either run may take); the
    decoder's logits and boxes within `tol`, slot by slot in cell order (the
    decoder is equivariant in its slots) for every sample whose top-k set is
    the other's. Returns the readings."""
    import torch

    def rel(a, b):
        return float((a.float().cpu() - b.float().cpu()).abs().max()
                     / max(float(b.float().abs().max()), 1.0))

    out = {k: rel(got[k], want[k]) for k in ("enc_logits", "enc_boxes")}
    pg, pw = (torch.sigmoid(x["enc_logits"][..., 0].double().cpu()) for x in (got, want))
    band = 2 * float((pg - pw).abs().max())
    k = want["topk_idx"].shape[1]
    same, outside_band = [], True
    for b in range(pw.shape[0]):
        s = torch.sort(pw[b], descending=True).values
        gi, wi = (set(x["topk_idx"][b].cpu().tolist()) for x in (got, want))
        sure_in = set(torch.nonzero(pw[b] > s[k - 1] + band).flatten().tolist())
        sure_out = set(torch.nonzero(pw[b] < s[k] - band).flatten().tolist())
        outside_band &= sure_in <= gi and not (sure_out & gi)
        if gi == wi:
            same.append(b)
    for key in ("dec_logits", "dec_boxes"):
        worst = 0.0
        for b in same:
            og, ow = (torch.argsort(x["topk_idx"][b].cpu()) for x in (got, want))
            worst = max(worst, rel(got[key][:, b].cpu()[:, og], want[key][:, b].cpu()[:, ow]))
        out[key] = worst
    out.update(topk_band=band, topk_sets_equal_outside_band=outside_band,
               samples_with_equal_topk=same,
               topk_equal=torch.equal(got["topk_idx"].cpu(), want["topk_idx"].cpu()))
    bad = {k_: v for k_, v in out.items() if isinstance(v, float) and k_ != "topk_band"
           and not v <= tol}
    if bad or not outside_band or not same:
        raise AssertionError(f"detr {label}: {out} (tolerance {tol})")
    return out


def phase_detr(card: str, device="cuda", kw=DETR, n_points=N_POINTS):
    """ConQueR / Voxel-DETR serving on the card (DETR: bench.py's widths):
    (a) the eval step on DETR_BATCHES (bs 1 and 2, two requests each) by
        CUDA events and the host clock, its stages (`StageEvents`), peak
        memory, launches per forward held to DETR_SERVE_LAUNCHES (rank 11,
        gather-GEMM 13 + 5 at 256);
    (b) the last request again with every gather-GEMM and rank call
        captured, each against its plain version on the card, with times,
        device times and bounds; the 5 calls at 256 channels are their own
        kernel row;
    (c) a small ConQueR on the card against the same weights on the CPU
        (plain versions): voxels and every rulebook equal, the outputs
        within DETR_TOL;
    (d) one bs=1 forward under EFG_SPARSE_G3 and one under
        EFG_RANK_IMPL=seq4: their rulebooks equal to the default forward's,
        outputs within DETR_TOL of it, launches as counted;
    (e) task=val of the synthetic ConQueR experiment through the CLI: its
        WaymoDetEvaluator's results finite, launches = batches × (a)'s.
    Returns the kernels-line row of the 256-wide calls. A rehearsal on the
    CPU (`device="cpu"`, smaller `kw` and `n_points`, torch.cuda.Event
    swapped for a host-clock stand-in, the DETR_* launch counts zeroed)
    runs (a), (d) and (e)."""
    import torch

    from efg_tpu_torch.engine.trainer import eval_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    on_card = device == "cuda"
    md = make_detr(kw, device)
    n_params = sum(p.numel() for p in md.module.parameters())
    for i, (bsz, seed) in enumerate(DETR_BATCHES):
        batch = detr_batch(bsz, seed, device, n_points)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with StageEvents(md.module.detr) as stages:
            out = eval_step(md, batch)
        end.record()
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(K.launches)
        finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
        emit({"phase": "detr", "part": "serve", "batch": i, "batch_size": bsz,
              "points_per_cloud": n_points, "parameters": n_params,
              "latency_ms_cuda_events": start.elapsed_time(end), "latency_ms_host": wall_ms,
              "first_request": i == 0, "finite": finite, "launches": counts,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
              "stage_ms_cuda_events": stages.ms(start, end)})
        top = min(300, kw["num_queries"] * kw["num_classes"])
        if not (finite and out["box3d"].shape == (bsz, top, 7)):
            raise AssertionError(f"detr batch {i}: non-finite or misshapen outputs")
        if counts != DETR_SERVE_LAUNCHES:
            raise AssertionError(f"detr batch {i}: launches {counts}, expected {DETR_SERVE_LAUNCHES}")

    if on_card:  # (b) the last request again, its kernel calls captured
        with Capture(K) as capture:
            eval_step(md, batch)
        row = phase_detr_kernels(capture, counts, card)
        del capture
        phase_detr_check()
    else:
        row = None

    # (d) the switched kernels on one bs=1 request
    batch = detr_batch(*DETR_BATCHES[0], device, n_points)
    switched = {}
    for name, switch, want in (("default", {}, DETR_SERVE_LAUNCHES),
                               ("g3", {"g3": True}, DETR_G3_LAUNCHES),
                               ("seq4", {"rank_impl": "seq4"}, DETR_SEQ4_LAUNCHES)):
        K.reset_launches()
        with switches(K, **switch), RuleCapture(K) as rules:
            out = _detr_forward(md, batch)
        got = dict(K.launches)
        if got != want:
            raise AssertionError(f"detr {name}: launches {got}, expected {want}")
        switched[name] = ([c[3] for c in rules.calls], out, got)
    rb0, out0, _ = switched.pop("default")
    for name, (rb, out, got) in switched.items():
        rb_equal = len(rb) == len(rb0) and all(torch.equal(a, b_) for a, b_ in zip(rb, rb0))
        readings = _detr_agrees(f"{name} vs default", out, out0)
        emit({"phase": "detr", "part": "variants", "switch": name, "launches": got,
              "rulebooks_equal_to_default": rb_equal, **readings, "tolerance": DETR_TOL})
        if not rb_equal:
            raise AssertionError(f"detr {name}: rulebooks differ from the default forward's")
    del switched, md

    # (e) task=val of the synthetic experiment through the CLI
    import shutil
    import tempfile

    from efg_tpu_torch.config import Configuration

    cache = tempfile.mkdtemp(prefix="chip_smoke_detr_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    try:
        os.environ["EFG_CACHE_DIR"] = cache
        argv = ["task=val"]
        cfg = Configuration(config_file=os.path.join(HERE, DETR_CONFIG), opts=argv).get_config()
        counts, probe = _cli_eval_run(argv, device, DETR_CONFIG)
        n_batches = -(-int(cfg.dataset.num_frames) // int(cfg.dataloader.batch_size))
        expected = {k: n_batches * DETR_SERVE_LAUNCHES[k] for k in counts}
        (_, res, evaluate_s), = probe.evaluations
        emit({"phase": "detr", "part": "cli_val", "card": card, "config": DETR_CONFIG,
              "frames": int(cfg.dataset.num_frames), "batches": n_batches,
              "eval_step_ms_cuda_events": probe.step_ms(), "evaluate_s": evaluate_s,
              "results": res, "launches": counts, "launches_expected": expected})
        _check_waymo_results("detr cli", res, list(cfg.dataset.classes))
        if counts != expected:
            raise AssertionError(f"detr cli: launches {counts}, expected {expected}")
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(cache, ignore_errors=True)
    return row


def phase_detr_kernels(capture, counts, card: str):
    """(b) of phase detr: every captured gather-GEMM and rank call of one
    bs=2 forward through its kernel and its plain version on the card;
    returns the kernels-line row of the 5 calls at 256 channels."""
    wide = [j for j, call in enumerate(capture.gemm) if wide_call(call)]
    if len(wide) != len(DETR_256_LABELS):
        raise AssertionError(f"detr: {len(wide)} gather-GEMM calls at 256 channels, expected 5")
    labels = iter(DETR_256_LABELS)
    gemm_rows = [_gemm_row(next(labels) if j in wide else f"call{j}", *call)[0]
                 for j, call in enumerate(capture.gemm)]
    rank_rows = [_rank_row(f"call{j}", *call) for j, call in enumerate(capture.rank)]
    rows_256 = [gemm_rows[j] for j in wide]
    for j in wide:  # the steps the one block a tile runs, and its products' time at peak
        f, packed, w = capture.gemm[j]
        c, o = f.shape[1], w.shape[1]
        run, skipped = _steps(packed, c)
        k = 3 * c if c <= 32 else 64  # K of a step
        gemm_rows[j].update(steps_run=run, steps_skipped=skipped,
                            step_ops_ms=1e3 * 2 * run * GEMM_TM * k * o / H100_BF16_FLOPS)
    row = kernel_row("gather_gemm_256", "gather_gemm.cu", 259, counts["gather_gemm_256"], rows_256,
                     tolerance="1e-3 * max|ref|", card=card,
                     per="sum over the 5 calls at 256 channels of one bs=2 ConQueR forward")
    emit({"phase": "detr", "part": "kernels", "summary": row,
          "gemm_256": [{k: r[k] for k in ("label", "C", "O", "V_in", "V_out", "taps_found",
                                          "steps_run", "steps_skipped", "step_ops_ms", "ms",
                                          "device_ms", "bound_ms", "bytes_ms", "ops_ms",
                                          "plain_ms", "max_abs_err")}
                       for r in rows_256],
          "gemm_calls": gemm_rows, "rank_calls": rank_rows,
          "gemm_le128_ms": sum(r["ms"] for j, r in enumerate(gemm_rows) if j not in wide),
          "gemm_le128_device_ms": sum(r["device_ms"] for j, r in enumerate(gemm_rows)
                                      if j not in wide),
          "rank_ms": sum(r["ms"] for r in rank_rows),
          "rank_device_ms": sum(r["device_ms"] for r in rank_rows)})
    return row


def phase_detr_check():
    """(c) of phase detr: a small ConQueR on the card against the same
    weights on the CPU (plain versions)."""
    import torch

    from efg_tpu_torch.modeling.readers.voxel_reader import dynamic_mean_vfe
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    small_md = {dev: make_detr(DETR_SMALL, dev) for dev in ("cpu", "cuda")}
    runs = {}
    for dev, m in small_md.items():
        b = detr_batch(2, 305, dev, n_points=20000, pc=12.0)
        vox = dynamic_mean_vfe(b["points"], b["points_mask"], pc_range=DETR_SMALL["pc_range"],
                               voxel_size=DETR_SMALL["voxel_size"],
                               max_voxels=DETR_SMALL["max_voxels"], num_input_features=5)
        with RuleCapture(K) as rules:
            out = _detr_forward(m, b)
        runs[dev] = (vox, [c[3].cpu() for c in rules.calls], out)
    (vox_c, rb_c, out_c), (vox_g, rb_g, out_g) = runs["cpu"], runs["cuda"]
    vox_equal = all(torch.equal(a.cpu(), b_.cpu()) for a, b_ in zip(vox_c[1:], vox_g[1:]))
    rb_equal = len(rb_c) == len(rb_g) == 11 and all(torch.equal(a, b_) for a, b_ in zip(rb_c, rb_g))
    readings = _detr_agrees("card vs CPU", out_g, out_c)
    emit({"phase": "detr", "part": "check", "voxels_equal": vox_equal,
          "rulebooks_equal": rb_equal, "rulebooks": len(rb_g), **readings,
          "tolerance": DETR_TOL})
    if not (vox_equal and rb_equal):
        raise AssertionError(f"detr check: voxels equal {vox_equal}, rulebooks equal {rb_equal}")


def make_detr_train(kw, device, seed=DETR_SEED):
    """ConQueR's training ModelDef (custom loss, EMA decoder) for widths
    `kw` with DETR_TRAIN_CFG, weights as `make_detr`'s."""
    import torch

    from efg_tpu_torch.models import conquer as CQ

    cfg = dict(DETR_TRAIN_CFG, pc_range=kw["pc_range"], voxel_size=kw["voxel_size"])
    md = CQ.make_model_def(kw, cfg, device="cpu")
    seeded_weights(md.module, seed)
    md.module.to(torch.device(device))
    return md, cfg


def detr_train_batch(bsz: int, seed: int, device="cuda", n_points: int = N_POINTS,
                     pc: float = 70.0, max_gt: int = DETR_TRAIN_MAX_GT) -> dict:
    import torch

    frames = lidar_frames(n_points, bsz, seed, pc=pc, max_gt=max_gt)
    batch = {k: torch.from_numpy(v).to(device) for k, v in frames.items()}
    batch["points_mask"] = torch.ones(batch["points"].shape[:2], dtype=torch.bool, device=device)
    return batch


def detr_solver():
    from efg_tpu_torch.solver.optimizers import AdamW

    return AdamW(lr_schedule=lambda k: 1e-3, weight_decay=1e-4, betas=(0.9, 0.999), eps=1e-8,
                 max_norm=10.0)


class MatcherProbe:
    """Wraps a model module's matcher (voxel_detr's unless `module` names
    another): the host milliseconds of every solve (the costs' copy to the
    host, scipy, the copy back; with `sync`, timed from when the card has
    finished the costs) and, with `record`, its inputs and assignment."""

    def __init__(self, record: bool = False, module: str = "voxel_detr", sync: bool = False):
        self.record, self.sync = record, sync
        self.module = importlib.import_module(f"efg_tpu_torch.models.{module}")
        self.ms, self.calls = [], []

    def __enter__(self):
        import torch

        self._orig = self.module.hungarian_match

        def match(cost, gt_mask):
            if self.sync and cost.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(cost, gt_mask)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if self.record:
                self.calls.append((cost.detach().float().cpu(), gt_mask.cpu(), out.cpu()))
            return out

        self.module.hungarian_match = match
        return self

    def __exit__(self, *exc):
        self.module.hungarian_match = self._orig
        return False


class StackedCapture(BackwardCapture):
    """BackwardCapture (every stacked gather-GEMM call of a backward and
    every conv backward: its features, forward rulebook, masked gradient
    and dW) and the features of the dense dW product after each stacked
    call (`stacked_weight_grad`, one a stacked call, in the same order)."""

    def __init__(self, K):
        super().__init__(K)
        self.dw_features = []

    def __enter__(self):
        super().__enter__()
        K = self.K
        self._dw0 = K.stacked_weight_grad

        def dw(st, features):
            self.dw_features.append(features.clone())
            return self._dw0(st, features)

        K.stacked_weight_grad = dw
        return self

    def __exit__(self, *exc):
        self.K.stacked_weight_grad = self._dw0
        return super().__exit__(*exc)


def phase_detr_train(card: str, device="cuda", kw=DETR, n_points=N_POINTS):
    """ConQueR / Voxel-DETR training on the card (DETR: bench.py's widths;
    DETR_TRAIN_CFG: its loss and solver):
    (a) a warm-up step and DETR_TRAIN_STEPS timed steps at bs 2 through
        `train_step` (CUDA events): frames/s, peak memory, the matcher's
        host ms a step, launches a step held to DETR_TRAIN_LAUNCHES; then
        one step timed part by part (forward with the matcher, losses and
        momentum decoder; backward; optimizer; EMA update);
    (b) one more step with its stacked gathers captured, each rerun through
        the kernel and its plain version (taps bit for bit, out within
        1e-3·max|ref|), with times, device times and bounds; the 5 at 256
        channels are the kernels line's `gather_gemm_stacked_256` row,
        beside the dense f32 dW after them (the library part of the route);
    (c) a small ConQueR trains one step on the card and on the CPU from the
        same weights, batch and denoising noise (`phase_detr_train_check`);
    (d) the synthetic ConQueR experiment through the CLI, task=train, its
        20 iterations (`phase_detr_cli_train`).
    Returns the kernels-line rows (none on the CPU). A rehearsal on the CPU
    (`device="cpu"`, smaller `kw` and `n_points`, torch.cuda.Event swapped
    for a host-clock stand-in, DETR_TRAIN_LAUNCHES zeroed) runs (a) and (d)."""
    import torch

    from efg_tpu_torch.engine.trainer import apply_grads, init_state, step_generator, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    on_card = device == "cuda"
    md, _ = make_detr_train(kw, device)
    tx = detr_solver()
    state = init_state(md, tx)
    batch = detr_train_batch(*DETR_TRAIN_BATCH, device, n_points)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    timed_ms, counts = [], None
    for i in range(DETR_TRAIN_STEPS + 1):
        K.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with MatcherProbe() as matcher:
            start.record()
            metrics = train_step(md, tx, state, batch, seed=SEED)
            end.record()
            if on_card:
                torch.cuda.synchronize()
        counts = dict(K.launches)
        ms = start.elapsed_time(end)
        if i > 0:
            timed_ms.append(ms)
        vals = {k: float(v) for k, v in metrics.items()}
        emit({"phase": "detr_train", "part": "step", "step": i,
              "kind": "warm-up" if i == 0 else "timed", "batch_size": DETR_TRAIN_BATCH[0],
              "points_per_cloud": n_points,
              "gt_boxes_per_frame": int(batch["gt_mask"][0].sum()),
              "step_ms_cuda_events": ms,
              "train_frames_per_s": DETR_TRAIN_BATCH[0] / ms * 1e3,
              "matcher_host_ms": sum(matcher.ms), "matcher_solves": len(matcher.ms),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
              "losses": vals, "launches": counts, "card": card})
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"detr_train step {i}: non-finite losses {vals}")
        if counts != DETR_TRAIN_LAUNCHES:
            raise AssertionError(f"detr_train step {i}: launches {counts}, "
                                 f"expected {DETR_TRAIN_LAUNCHES}")
    emit({"phase": "detr_train", "part": "summary", "batch_size": DETR_TRAIN_BATCH[0],
          "timed_step_ms": timed_ms, "median_step_ms": float(np.median(timed_ms)),
          "train_frames_per_s": DETR_TRAIN_BATCH[0] / float(np.median(timed_ms)) * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
          "launches_per_step": counts, "card": card})

    # one more step, split into the parts train_step runs
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    module = state.module
    for q in module.parameters():
        q.grad = None
    with MatcherProbe() as matcher:
        ev[0].record()
        _, losses = md.custom_loss(module, state.ema, batch,
                                   step_generator(SEED, state.step, batch["points"].device))
        ev[1].record()
    losses["loss"].backward()
    ev[2].record()
    apply_grads(tx, state)
    ev[3].record()
    md.ema_update(state.ema, module)
    ev[4].record()
    if on_card:
        torch.cuda.synchronize()
    parts = ("forward_matcher_losses", "backward", "optimizer", "ema_update")
    emit({"phase": "detr_train", "part": "breakdown", "batch_size": DETR_TRAIN_BATCH[0],
          "part_ms_cuda_events": {n: ev[j].elapsed_time(ev[j + 1]) for j, n in enumerate(parts)},
          "matcher_host_ms": sum(matcher.ms), "step_ms": ev[0].elapsed_time(ev[4]),
          "loss": float(losses["loss"].detach()), "card": card})

    rows = []
    if on_card:  # (b) one more step, its stacked gathers and conv backwards captured
        with StackedCapture(K) as capture:
            train_step(md, tx, state, batch, seed=SEED)
        del md, state, tx, batch
        rows = phase_detr_train_kernels(capture, counts, card)
        del capture
        torch.cuda.empty_cache()
        phase_detr_train_check()
    phase_detr_cli_train(card, device)
    return rows


def phase_detr_train_kernels(capture, counts, card: str):
    """(b) of phase detr_train: every stacked gather of one step through the
    kernel and its plain version on the card; the 256-wide ones also
    through the dense f32 dW product after them, and their convs' dW
    through the dW kernel on the captured (features, forward rulebook,
    masked gradient), against its plain version and the stacked route's dW
    (`_dw_row`). Returns the kernels-line rows of the 256-wide stacked calls
    and dW calls."""
    import torch

    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    n_wide = DETR_TRAIN_LAUNCHES["gather_gemm_stacked_256"]
    calls = capture.stacked
    if not len(calls) == len(capture.dw_features) == len(capture.convs) == (
            n_wide + DETR_TRAIN_LAUNCHES["gather_gemm_stacked"]):
        raise AssertionError(f"detr_train: {len(calls)} stacked calls, "
                             f"{len(capture.dw_features)} dense dW products and "
                             f"{len(capture.convs)} conv backwards captured")
    rows, rows_256, dw_256 = [], [], []
    for j, ((g, packed, w), feats, conv) in enumerate(zip(calls, capture.dw_features,
                                                           capture.convs)):
        label = f"stacked{j} C{g.shape[1]}xO{w.shape[1]} P{packed.shape[0]}"
        row, st = _gemm_row(label, g, packed, w, emit=True)
        if max(g.shape[1], w.shape[1]) == 256:
            dw = functools.partial(K.stacked_weight_grad, st, feats)
            row["library_ms"] = timed(dw)
            row["library_device_ms"] = graph_device(dw)["device_ms"]
            rows_256.append(row)
            del dw
            c, o = conv["features"].shape[1], conv["g"].shape[1]
            dw_256.append(_dw_row(f"dw{j} {conv['kind']} C{c}xO{o} P{conv['packed'].shape[0]}",
                                  conv, row["library_ms"], row["library_device_ms"]))
        rows.append(row)
        del st
        torch.cuda.empty_cache()
    if len(rows_256) != n_wide:
        raise AssertionError(f"detr_train: {len(rows_256)} stacked calls at 256 channels, "
                             f"expected {n_wide}")
    row = kernel_row("gather_gemm_stacked_256", "gather_gemm.cu", 259,
                     counts["gather_gemm_stacked_256"], rows_256,
                     tolerance="taps bit-exact, out 1e-3 * max|ref|", card=card,
                     per="sum over the 5 stacked calls at 256 channels of one bs=2 ConQueR "
                         "training step",
                     library_call="torch.matmul(stacked.t().float(), features.float()): the "
                                  "dense f32 dW after each call (K.stacked_weight_grad)")
    dw_row = kernel_row("gather_dw_256", "gather_dw.cu", 652, counts["gather_dw_256"], dw_256,
                        library_call="torch.matmul(stacked.t().float(), features.float()): the "
                                     "dense f32 dW the stacked route runs instead "
                                     "(K.stacked_weight_grad)",
                        tolerance="1e-3 * max|ref| vs plain and vs the stacked route's dW; two "
                                  "calls bit for bit",
                        per="sum over the 5 conv backwards at 256 channels of one bs=2 ConQueR "
                            "training step (run on their captured inputs; the step takes dW "
                            "from the stacked taps)", card=card)
    keys = ("label", "C", "O", "P", "V_in", "V_out", "taps_found", "ms", "device_ms",
            "bound_ms", "bytes_ms", "ops_ms", "plain_ms", "max_abs_err")
    emit({"phase": "detr_train", "part": "kernels", "summary": row, "summary_dw": dw_row,
          "stacked_256": [{k: r[k] for k in keys + ("library_ms", "library_device_ms")}
                          for r in rows_256],
          "dw_256": [{k: r[k] for k in keys + ("max_abs_err_vs_stacked", "device_kernels",
                                               "library_ms", "library_device_ms")}
                     for r in dw_256],
          "stacked_le128": [{k: r[k] for k in keys} for r in rows if r not in rows_256],
          "stacked_le128_ms": sum(r["ms"] for r in rows if r not in rows_256),
          "stacked_le128_device_ms": sum(r["device_ms"] for r in rows if r not in rows_256)})
    return [row, dw_row]


# leaves whose gradient is zero or rounding noise: conv biases before a
# train-mode BN, the attention key biases (softmax ignores a shift), the
# biases before a GroupNorm, and res2's out conv and FPN path (p3 reads
# neither)
DETR_ZERO_GRAD = re.compile(r"(\.b1\.conv[12]\.bias|input_proj_p3\.bias|output_res3_norm\.bias|"
                            r"self_attn\.key\.bias|res2_out|_res2|output_res4)")
DETR_TRAIN_TOL = 5e-2  # relative, the loss parts card vs CPU (bf16 trunk, DETR_TOL's roundings)


def phase_detr_train_check():
    """(c) of phase detr_train: DETR_SMALL trains one step on the card and on
    the CPU (plain versions) from the same weights, batch and denoising
    noise: the matcher's assignments (matched cells, through each layer's
    top-k) equal where the top-k sets are, and otherwise optimal within
    DETR_TRAIN_TOL under the CPU's costs; each loss part within
    DETR_TRAIN_TOL; step 1's gradient of every leaf by direction
    (CHECK_LEAF_TOL, as train_check); on the card the EMA decoder moves as
    e·mom + p·(1 − mom), bit for bit."""
    import torch

    from efg_tpu_torch.engine.train_state import ModelDef
    from efg_tpu_torch.engine.trainer import init_state, train_step
    from efg_tpu_torch.models import conquer as CQ
    from efg_tpu_torch.models import voxel_detr as VD

    b, g_max = 2, 64
    dn = DETR_TRAIN_CFG["dn"]["dn_number"]
    gen = torch.Generator().manual_seed(SEED)
    p = 2 * g_max * dn
    noise = dict(flip=torch.rand((b, p), generator=gen) < 0.25,
                 rand_lbl=torch.randint(0, 3, (b, p), generator=gen),
                 sign=torch.randint(0, 2, (b, p, 7), generator=gen).float() * 2 - 1,
                 rand=torch.rand((b, p, 7), generator=gen))
    runs = {}
    for dev in ("cpu", "cuda"):
        md, cfg = make_detr_train(DETR_SMALL, dev)
        nz = {k: v.to(dev) for k, v in noise.items()}
        topk = []
        compute_loss = VD.compute_loss

        def loss_capturing_topk(preds, batch, **kw):
            topk.append(preds["topk_idx"].cpu())
            return compute_loss(preds, batch, **kw)

        def custom_loss(mod, ema, batch, generator, cfg=cfg, nz=nz):
            return CQ.conquer_train_loss(mod, ema, batch, generator, model_cfg=cfg,
                                         noise_override=nz)

        md2 = ModelDef(md.module, md.apply_args, md.loss_fn, md.predict_fn,
                       custom_loss=custom_loss, ema_init=md.ema_init, ema_update=md.ema_update)
        state = init_state(md2, detr_solver())
        batch = detr_train_batch(b, 305, dev, n_points=20000, pc=12.0, max_gt=g_max)
        ema_before = {k: v.clone() for k, v in state.ema.items()}
        VD.compute_loss = loss_capturing_topk
        try:
            with MatcherProbe(record=True) as matcher:
                metrics = train_step(md2, detr_solver(), state, batch, seed=SEED)
        finally:
            VD.compute_loss = compute_loss
        grads = {n: q.grad.float().cpu() for n, q in md.module.named_parameters()
                 if q.grad is not None}
        ema_ok = all(torch.equal(e, ema_before[n] * DETR_TRAIN_CFG["contrastive"]["mom"]
                                 + dict(md.module.detr.decoder.named_parameters())[n]
                                 * (1.0 - DETR_TRAIN_CFG["contrastive"]["mom"]))
                     for n, e in state.ema.items())
        runs[dev] = dict(losses={k: float(v) for k, v in metrics.items()}, grads=grads,
                         matcher=matcher.calls, topk=topk[0], ema_ok=ema_ok)
    cpu, card = runs["cpu"], runs["cuda"]
    (cost_c, mask, a_c), = cpu["matcher"]
    (_, _, a_g), = card["matcher"]
    k_layers = a_c.shape[0] // b
    equal = near = compared = 0
    worst_gap = 0.0
    for k in range(k_layers):
        for s in range(b):
            i = k * b + s
            ok = mask[i]
            cells_c = cpu["topk"][s][a_c[i][ok]]
            cells_g = card["topk"][s][a_g[i][ok]]
            if set(cpu["topk"][s].tolist()) != set(card["topk"][s].tolist()):
                continue
            compared += 1
            if torch.equal(cells_c, cells_g):
                equal += 1
                continue
            # the card's matched cells as the CPU's query slots, costed under the CPU's costs
            slot = {int(c): j for j, c in enumerate(cpu["topk"][s])}
            a_alt = torch.tensor([slot[int(c)] for c in cells_g])
            cols = torch.nonzero(ok).flatten()
            c_cpu = float(cost_c[i][a_c[i][ok], cols].sum())
            c_alt = float(cost_c[i][a_alt, cols].sum())
            gap = (c_alt - c_cpu) / max(abs(c_cpu), 1e-6)
            worst_gap = max(worst_gap, gap)
            near += gap <= DETR_TRAIN_TOL
    loss_rel = {k: abs(card["losses"][k] - v) / max(abs(v), 1e-6)
                for k, v in cpu["losses"].items()}
    leaf_rel = {n: float((card["grads"][n] - gv).norm() / max(float(gv.norm()), 1e-30))
                for n, gv in cpu["grads"].items() if not DETR_ZERO_GRAD.search(n)}
    worst_leaves = sorted(leaf_rel.items(), key=lambda x: -x[1])[:8]
    emit({"phase": "detr_train", "part": "check", "assignments_compared": compared,
          "assignments_equal": equal, "assignments_optimal_within_tol": near,
          "worst_assignment_cost_gap": worst_gap, "loss_rel": loss_rel,
          "grad_leaves": len(leaf_rel), "grad_worst_rel_l2": worst_leaves,
          "ema_update_exact": card["ema_ok"], "tolerance": DETR_TRAIN_TOL,
          "leaf_tolerance": CHECK_LEAF_TOL})
    bad = [k for k, v in loss_rel.items() if k != "grad_norm" and not v <= DETR_TRAIN_TOL]
    if not compared or equal + near != compared or bad or not card["ema_ok"] \
            or set(card["grads"]) != set(cpu["grads"]) \
            or any(not v <= CHECK_LEAF_TOL for v in leaf_rel.values()):
        raise AssertionError(f"detr_train check: assignments {equal}+{near}/{compared}, losses "
                             f"above tolerance {bad}, EMA exact {card['ema_ok']}, leaves "
                             f"{worst_leaves[:3]}")


def phase_detr_cli_train(card: str, device="cuda", small=()):
    """(d) of phase detr_train: the synthetic ConQueR experiment through the
    CLI, task=train, its DETR_TRAIN_ITERS iterations (its evaluator off:
    phase detr evaluates it): records 1-20 with finite losses, launches =
    20 × DETR_TRAIN_LAUNCHES, model_final holding the EMA decoder."""
    import shutil
    import tempfile

    import torch

    from efg_tpu_torch.cli import main as cli
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    cache = tempfile.mkdtemp(prefix="chip_smoke_detr_train_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    try:
        os.environ["EFG_CACHE_DIR"] = cache
        argv = ["task=train", "trainer.evaluators=", "trainer.log_interval=1", *small]
        K.reset_launches()
        t0 = time.perf_counter()
        with LoopProbe() as probe:
            rc = cli.main(["--config", os.path.join(HERE, DETR_CONFIG), "--device", device,
                           *argv])
        wall_s = time.perf_counter() - t0
        counts = dict(K.launches)
        out = os.path.join(cache, "EFG_torch", os.path.dirname(DETR_CONFIG).split(
            "playground/", 1)[1])
        with open(os.path.join(out, "metrics.json")) as f:
            records = {int(r["iteration"]): r for r in map(json.loads, f) if "loss" in r}
        ckpt = torch.load(os.path.join(out, "model_final"), map_location="cpu",
                          weights_only=True)
        iters = len(records)
        expected = _steps_of(DETR_TRAIN_LAUNCHES, DETR_TRAIN_ITERS)
        finite = all(np.isfinite(r["loss"]) for r in records.values())
        emit({"phase": "detr_train", "part": "cli_train", "config": DETR_CONFIG, "rc": rc,
              "iterations": sorted(records), "wall_s": wall_s,
              "step_ms_cuda_events": probe.step_ms() if device == "cuda" else None,
              "data_ms": [1e3 * x for x in probe.data_s],
              "loss_first_last": [records[min(records)]["loss"], records[max(records)]["loss"]],
              "finite": finite, "checkpoint_ema_leaves": len(ckpt.get("ema", {})),
              "checkpoint_step": ckpt["step"], "launches": counts,
              "launches_expected": expected, "card": card})
        if rc != 0 or sorted(records) != list(range(1, DETR_TRAIN_ITERS + 1)) or not finite:
            raise AssertionError(f"detr cli train: rc {rc}, records {sorted(records)}, "
                                 f"finite {finite}")
        if not ckpt.get("ema") or ckpt["step"] != DETR_TRAIN_ITERS:
            raise AssertionError("detr cli train: model_final holds no EMA state or a wrong step")
        if counts != expected:
            raise AssertionError(f"detr cli train: launches {counts}, expected {expected}")
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(cache, ignore_errors=True)


# phase ddp: data parallelism. The machine has one card, so two ranks share
# it over gloo (NCCL refuses two ranks on one device), through
# parallel/ddp.py's explicit (backend, init method, rank, world, device):
# their step times are two processes taking turns on one card, not a
# figure of DDP's speed.
DDP_WORLD = 2
DDP_STEPS = 3  # timed, after the first step, which is held against one process
# (a)'s model: the flagship's widths with its stage caps raised above the
# occupancy of TRAIN_BATCH's frames. FLAGSHIP's bench-scale caps (80k / 50k
# / 30k / 25k a frame) are full at every downsample: the four frames hold
# 1178044 / 801505 / 264444 / 177894 rows after down1-3 and the extra conv
# (phase ddp prints the occupancy beside these caps). Two ranks truncate a
# full stage over their own pool and one process over the whole batch's
# (ROADMAP queue 3), so the two agree only below the caps.
DDP_FLAGSHIP = dict(FLAGSHIP, stage_caps=(360000, 250000, 80000, 56000))
DDP_VAL_FRAMES = 16  # the val split of (b)'s task=val: 8 batches of 2, a frame a rank
DDP_DETR_BATCH = (2, 305)  # (c): DETR_SMALL's check batch, a frame a rank
# (c)'s model: DETR_SMALL with its SparseResNet caps raised above the check
# batch's occupancy. Two ranks truncate a full stage over their own pool and
# one process over the whole batch's, so the two agree only below the caps;
# DETR_SMALL's own caps are full at the stem and res2 on that batch.
DDP_DETR = dict(DETR_SMALL, resnet_caps=(65536, 32768, 8192, 4096))
# (a)'s control: one process on TRAIN_BATCH's frames in this order against
# the same process in theirs. At the flagship's width a BN scale's or
# shift's gradient is a sum over ~10^6 bf16 rows that nearly cancels, so
# another summation order moves it by a large share of itself: each leaf
# of the 2-rank step is held within CHECK_LEAF_TOL or DDP_NOISE_FACTOR
# times the control's reading of that same leaf, whichever is larger. The
# conv and head weights stay at CHECK_LEAF_TOL, where train_check's
# planted fault (CHECK_FAULT's gradient doubled) reads about 1.0; phase
# ddp checks that its limits reject that fault in the ranks' gradients.
DDP_CONTROL_ORDER = (2, 3, 0, 1)
DDP_NOISE_FACTOR = 1.5


def _ddp_specs(device: str):
    """Two ranks on `device` (the card's index, or the CPU), over gloo."""
    from efg_tpu_torch.engine import launch
    from efg_tpu_torch.parallel.ddp import rank_device

    init = f"tcp://127.0.0.1:{launch.free_port()}"
    dev = str(rank_device(device, 0))
    return [launch.RankSpec(r, DDP_WORLD, r, DDP_WORLD, "gloo", init, dev)
            for r in range(DDP_WORLD)]


def _digest(module) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(module.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _occupancy(module) -> list:
    """Forward hooks noting [stage, valid rows, capacity] of every sparse
    stage of a VoxelNet trunk, one entry a forward."""
    seen = []
    for name in ("bn_input", "bn_down1", "bn_down2", "bn_down3", "bn_extra"):
        getattr(module.backbone, name).register_forward_hook(
            lambda m, i, o, name=name: seen.append([name, int(o.valid.sum()), o.valid.numel()]))
    return seen


def _ddp_first_steps(kw, n_points, pc, detr_kw, detr_points, device):
    """The one-process reference of phase ddp (a) and (c): the flagship's
    first step on TRAIN_BATCH's frames (bs 4) and DETR_SMALL's on its
    check batch (bs 2), from the seeded weights: (losses, gradients) each,
    the flagship's stage occupancy, and the flagship's control: the same
    first step on the same frames in another order (DDP_CONTROL_ORDER),
    which sums every BN statistic and loss in another order, as the ranks
    do."""
    import torch

    from efg_tpu_torch.engine.trainer import init_state, train_step

    batch = train_batch(*TRAIN_BATCH, device, n_points=n_points, pc=pc)
    flag = []
    for order in (None, DDP_CONTROL_ORDER):
        md, _ = make_model(kw, device)
        occupancy = _occupancy(md.module)
        tx = make_solver()
        state = init_state(md, tx)
        b = batch if order is None else {k: v[list(order)] for k, v in batch.items()}
        m = train_step(md, tx, state, b)
        flag.append(({k: float(v) for k, v in m.items()},
                     {n: q.grad.float().cpu() for n, q in md.module.named_parameters()},
                     occupancy))
        del md, state
    del batch
    dmd, _ = make_detr_train(detr_kw, device)
    dstate = init_state(dmd, detr_solver())
    dm = train_step(dmd, detr_solver(), dstate,
                    detr_train_batch(*DDP_DETR_BATCH, device, n_points=detr_points, pc=12.0,
                                     max_gt=64), seed=SEED)
    detr = ({k: float(v) for k, v in dm.items()},
            {n: q.grad.float().cpu() for n, q in dmd.module.named_parameters()
             if q.grad is not None})
    del dmd, dstate
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return flag, detr


def _ddp_rank(out_dir, kw, n_points, pc, detr_kw, detr_points, launches, device):
    """One rank of phase ddp (a) and (c), its readings pickled to
    `out_dir/rank{r}.pkl`: (a) the flagship from the seeded weights on its
    half of TRAIN_BATCH's frames, the first step (its losses summed over
    the ranks, its gradients after the sum) and DDP_STEPS timed steps, the
    launches of each, peak memory, the replicas checked equal after them;
    (c) DETR_SMALL one step on its frame of the check batch, the replicas
    and EMA checked equal after it."""
    import pickle

    import torch

    from efg_tpu_torch.engine.trainer import init_state, train_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K
    from efg_tpu_torch.parallel import ddp
    from efg_tpu_torch.utils import distributed as comm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, cuda = comm.get_rank(), device.type == "cuda"
    md, _ = make_model(kw, device)
    occupancy = _occupancy(md.module)
    tx = make_solver()
    state = init_state(md, tx)
    bsz, seed = TRAIN_BATCH
    per = bsz // DDP_WORLD
    full = train_batch(bsz, seed, "cpu", n_points=n_points, pc=pc)
    batch = {k: v[r * per:(r + 1) * per].to(device) for k, v in full.items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps, grads = [], None
    for i in range(DDP_STEPS + 1):
        K.reset_launches()
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        metrics = train_step(md, tx, state, batch)
        if cuda:
            b.record()
            b.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        steps.append(dict(step=i, launches=dict(K.launches), host_ms=host_ms,
                          ms_cuda_events=a.elapsed_time(b) if cuda else None,
                          losses={k: float(v) for k, v in metrics.items()}))
        if grads is None:
            grads = {n: q.grad.float().cpu() for n, q in md.module.named_parameters()}
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    ddp.check_replicas_equal(md.module, f"the flagship's replicas after {DDP_STEPS + 1} steps")
    res = dict(steps=steps, grads=grads, digest=_digest(md.module), peak_mem_gb=peak,
               batch_size=per, launches_expected=launches, occupancy=occupancy[:5])
    del md, state, batch
    if cuda:
        torch.cuda.empty_cache()

    dmd, _ = make_detr_train(detr_kw, device)
    dstate = init_state(dmd, detr_solver())
    dfull = detr_train_batch(*DDP_DETR_BATCH, "cpu", n_points=detr_points, pc=12.0, max_gt=64)
    dbatch = {k: v[r:r + 1].to(device) for k, v in dfull.items()}
    dm = train_step(dmd, detr_solver(), dstate, dbatch, seed=SEED)
    ddp.check_replicas_equal(dmd.module, "ConQueR's replicas after a step", dstate.ema)
    res["detr"] = dict(losses={k: float(v) for k, v in dm.items()},
                       grads={n: q.grad.float().cpu() for n, q in dmd.module.named_parameters()
                              if q.grad is not None},
                       digest=_digest(dmd.module))
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


def _ddp_val_rank(config, opts, out_dir, device):
    """One rank of phase ddp (b)'s task=val through the CLI's per-rank
    entry: the eval step replaced by each frame's GT boxes as its
    detections (`_perfect_predictions`); the results (rank 0) and the
    frames each rank's evaluator processed, written to `out_dir`."""
    import torch

    from efg_tpu_torch.cli import main as cli
    from efg_tpu_torch.engine import trainer as T
    from efg_tpu_torch.evaluator.waymo_evaluator import WaymoDetEvaluator
    from efg_tpu_torch.utils import distributed as comm

    seen = {}

    def perfect(model_def, batch):
        k = max([300] + [len(a["gt_boxes"]) for a in batch["annotations"]])
        return {n: torch.from_numpy(v).to(device)
                for n, v in _perfect_predictions([batch], k=k).items()}

    evaluate0, ev_evaluate0 = T.DefaultTrainer.evaluate, WaymoDetEvaluator.evaluate

    def evaluate(self, evaluators=None):
        seen["results"] = evaluate0(self, evaluators)
        return seen["results"]

    def ev_evaluate(self):
        seen["frames"] = len(self._frames)
        seen["gt_labels"] = sorted({int(c) for f in self._frames for c in f["gt_labels"]})
        return ev_evaluate0(self)

    T.eval_step, T.DefaultTrainer.evaluate, WaymoDetEvaluator.evaluate = (
        perfect, evaluate, ev_evaluate)
    rc = cli.run(cli.get_parser().parse_args(["--config", config, "task=val", *opts]), device)
    with open(os.path.join(out_dir, f"val{comm.get_rank()}.json"), "w") as f:
        json.dump({"rc": rc, **seen}, f)
    return rc


def phase_ddp(card: str, device="cuda", kw=DDP_FLAGSHIP, n_points=N_POINTS, pc=70.0,
              detr_kw=DDP_DETR, detr_points=20000, launches=None, small=()):
    """Data parallelism: two ranks on the one card (gloo), or on the CPU
    for a rehearsal (`device="cpu"`, a small `kw` with `pc` inside its
    range, `launches` zeroed, `small` engine overrides). Each sparse
    stage's occupancy is printed beside its capacity: the ranks truncate a
    full stage over their own pool, one process over the whole batch's,
    so the comparison holds while no stage is full.
    (a) the flagship at full width (its caps above occupancy,
        DDP_FLAGSHIP), each rank on 2 of TRAIN_BATCH's 4 frames (160k
        points, 161 GT boxes a frame): the first step's loss,
        its parts, grad_norm and every leaf's gradient against one
        process's bs-4 step on the same frames, run first in this process,
        at train_check's bf16 tolerances (CHECK_STEP_TOL; each leaf at
        CHECK_LEAF_TOL or DDP_NOISE_FACTOR × the same leaf's reading of
        one process against itself with the frames in DDP_CONTROL_ORDER,
        whichever is larger; those limits must reject train_check's
        planted fault, CHECK_FAULT's gradient doubled);
        then DDP_STEPS timed steps; launches per rank and step
        TRAIN_LAUNCHES (12/21/21/0), the replicas equal bit for bit after
        the steps, step time and peak memory per rank;
    (b) the synthetic experiment through `efg_run_torch --local-ranks 2
        --device cuda:0 --dist-backend gloo` (engine/launch.py spawns the
        ranks): 30 iterations with the asynchronous checkpoint after step
        15, then a --resume from it, held to the uninterrupted run as
        phase engine holds a one-process resume; task=val of
        DDP_VAL_FRAMES frames with each frame's GT boxes as its detections:
        the evaluator gathers both ranks' frames and scores AP = APH = 1.0;
    (c) DETR_SMALL (its caps above occupancy, DDP_DETR), 2 ranks × 1 frame
        against one process's bs-2 step on the card, the denoising noise
        drawn for the global batch: loss parts within DETR_TRAIN_TOL,
        leaves by direction (CHECK_LEAF_TOL)."""
    import pickle
    import shutil
    import tempfile

    import torch

    from efg_tpu_torch.engine import launch

    launches = TRAIN_LAUNCHES if launches is None else launches
    t_phase = time.perf_counter()
    flag, (detr_losses, detr_grads) = _ddp_first_steps(kw, n_points, pc, detr_kw, detr_points,
                                                       device)
    (flag_losses, flag_grads, occupancy), (ctrl_losses, ctrl_grads, _) = flag
    out = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    try:
        t0 = time.perf_counter()
        rc = launch.spawn(_ddp_rank, _ddp_specs(device),
                          (out, kw, n_points, pc, detr_kw, detr_points, launches))
        spawn_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"ddp: a rank failed (exit code {rc})")
        ranks = []
        for r in range(DDP_WORLD):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    r0, r1 = ranks
    control, _ = _check_readings([ctrl_losses], ctrl_grads, [flag_losses], flag_grads)
    leaf_tols = {x["what"]: max(CHECK_LEAF_TOL, DDP_NOISE_FACTOR * x["reading"])
                 for x in control if x["what"].startswith("grad")}
    readings, failed = _check_readings([r0["steps"][0]["losses"]], r0["grads"],
                                       [flag_losses], flag_grads, leaf_tols)
    fault = dict(r0["grads"], **{CHECK_FAULT: 2 * r0["grads"][CHECK_FAULT]})
    fault_readings, fault_failed = _check_readings(
        [r0["steps"][0]["losses"]], fault, [flag_losses], flag_grads, leaf_tols)
    widened = sorted((x for x in readings if x["tolerance"] > CHECK_LEAF_TOL),
                     key=lambda x: -x["tolerance"])
    same_grads = all(torch.equal(r0["grads"][n], r1["grads"][n]) for n in r0["grads"])
    steps = [{"rank": r, **{k: v for k, v in s.items() if k != "losses"},
              "loss": s["losses"]["loss"]} for r, g in enumerate(ranks) for s in g["steps"]]
    emit({"phase": "ddp", "part": "flagship", "card": card, "ranks": DDP_WORLD,
          "backend": "gloo", "ranks_share_one_card": device != "cpu",
          "note": "two ranks take turns on one card: the step times are not DDP's speed",
          "batch_per_rank": r0["batch_size"], "points_per_cloud": n_points,
          "one_process_step1": {k: flag_losses[k] for k in ("loss", "0_hm_loss", "0_loc_loss",
                                                             "grad_norm")},
          "step_readings": [x for x in readings if x["what"].startswith("step")],
          "grad_readings_worst": sorted((x for x in readings if x["what"].startswith("grad")),
                                        key=lambda x: -x["reading"])[:8],
          "grad_leaves": sum(x["what"].startswith("grad") for x in readings),
          "leaf_tolerance": CHECK_LEAF_TOL,
          "leaves_widened_by_control": [
              dict(x, control=next(c["reading"] for c in control if c["what"] == x["what"]))
              for x in widened],
          "control_frames_order": DDP_CONTROL_ORDER,
          "control_step_readings": [x for x in control if x["what"].startswith("step")],
          "control_grad_readings_worst": sorted(
              (x for x in control if x["what"].startswith("grad")),
              key=lambda x: -x["reading"])[:8],
          "planted_fault": {"leaf": CHECK_FAULT, "rejected_by": fault_failed,
                            "reading": [x for x in fault_readings
                                        if x["what"] == f"grad {CHECK_FAULT}"]},
          "ranks_grads_equal": same_grads,
          "occupancy_one_process": occupancy[:5],
          "occupancy_ranks_step1": [g["occupancy"] for g in ranks],
          "replicas_equal_after_steps": r0["digest"] == r1["digest"],
          "steps": steps, "launches_expected_per_rank_step": launches,
          "peak_mem_gb_per_rank": [g["peak_mem_gb"] for g in ranks],
          "spawn_and_ranks_s": spawn_s})
    if failed:
        raise AssertionError(f"ddp flagship: above tolerance vs one process: {failed}")
    if f"grad {CHECK_FAULT}" not in fault_failed:
        raise AssertionError(f"ddp flagship: the leaf limits pass {CHECK_FAULT}'s gradient "
                             "doubled")
    if not same_grads or r0["digest"] != r1["digest"]:
        raise AssertionError("ddp flagship: the ranks' gradients or parameters differ")
    bad = [(s["rank"], s["step"]) for s in steps if s["launches"] != launches]
    if bad:
        raise AssertionError(f"ddp flagship: launches differ from {launches} at {bad}")

    d0, d1 = r0["detr"], r1["detr"]
    loss_rel = {k: abs(d0["losses"][k] - v) / max(abs(v), 1e-6) for k, v in detr_losses.items()}
    leaf_rel = {n: float((d0["grads"][n] - g).norm() / max(float(g.norm()), 1e-30))
                for n, g in detr_grads.items() if not DETR_ZERO_GRAD.search(n)}
    worst = sorted(leaf_rel.items(), key=lambda x: -x[1])[:8]
    emit({"phase": "ddp", "part": "detr_small", "card": card, "ranks": DDP_WORLD,
          "loss_rel_vs_one_process": loss_rel, "grad_leaves": len(leaf_rel),
          "grad_worst_rel_l2": worst, "tolerance": DETR_TRAIN_TOL,
          "leaf_tolerance": CHECK_LEAF_TOL, "replicas_equal": d0["digest"] == d1["digest"]})
    over = [k for k, v in loss_rel.items() if k != "grad_norm" and not v <= DETR_TRAIN_TOL]
    # the ranks' sum gives every parameter a gradient: zeros where no rank had one
    extra = set(d0["grads"]) - set(detr_grads)
    if over or not set(detr_grads) <= set(d0["grads"]) or d0["digest"] != d1["digest"] \
            or any(bool(d0["grads"][n].any()) for n in extra) \
            or any(not v <= CHECK_LEAF_TOL for v in leaf_rel.values()):
        raise AssertionError(f"ddp detr: losses above tolerance {over}, leaves {worst[:3]}, "
                             f"replicas equal {d0['digest'] == d1['digest']}")

    _ddp_cli(card, device, small)
    emit({"phase": "ddp", "part": "total", "card": card,
          "phase_s": time.perf_counter() - t_phase})


def _ddp_cli(card: str, device: str, small=()):
    """(b) of phase ddp."""
    import shutil
    import tempfile

    from efg_tpu_torch.cli import main as cli
    from efg_tpu_torch.cli.main import experiment_relpath
    from efg_tpu_torch.engine import launch
    from efg_tpu_torch.parallel.ddp import rank_device

    cache = tempfile.mkdtemp(prefix="chip_smoke_ddp_cli_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    os.environ["EFG_CACHE_DIR"] = cache
    config = os.path.join(HERE, ENGINE_CONFIG)
    out_dir = os.path.join(cache, "EFG_torch", experiment_relpath(ENGINE_CONFIG))
    dev = str(rank_device(device, 0))
    argv = ["--config", config, "--device", dev, "--local-ranks", str(DDP_WORLD),
            "--dist-backend", "gloo"]
    try:
        def train(extra):
            metrics = os.path.join(out_dir, "metrics.json")
            n_before = sum(1 for _ in open(metrics)) if os.path.exists(metrics) else 0
            t0 = time.perf_counter()
            rc = cli.main(argv + extra + ["task=train", *ENGINE_RUN, *small])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"ddp cli: the launcher returned {rc} for {extra}")
            with open(metrics) as f:
                return _losses([json.loads(x) for x in f][n_before:]), wall

        run1, wall1 = train([])
        files = sorted(f for f in os.listdir(out_dir) if f.startswith("model_"))
        emit({"phase": "ddp", "part": "cli_train", "card": card, "ranks": DDP_WORLD,
              "records": sorted(run1), "checkpoints": files, "wall_s": wall1,
              "loss_first_last": [run1[min(run1)]["loss"], run1[max(run1)]["loss"]]})
        if sorted(run1) != list(range(1, ENGINE_ITERS + 1)):
            raise AssertionError(f"ddp cli: records {sorted(run1)}")
        if files != ["model_0000014", "model_final"]:
            raise AssertionError(f"ddp cli: checkpoints {files}")

        os.remove(os.path.join(out_dir, "model_final"))
        run2, wall2 = train(["--resume"])
        keys = ("loss", "0_hm_loss", "0_loc_loss", "grad_norm")
        rel = {it: {k: abs(run2[it][k] - run1[it][k]) / abs(run1[it][k]) for k in keys}
               for it in run2}
        bits = all(run2[it][k] == run1[it][k] for it in run2 for k in keys)
        emit({"phase": "ddp", "part": "cli_resume", "card": card, "records": sorted(run2),
              "max_rel_diff_vs_run1": max(max(v.values()) for v in rel.values()),
              "equal_bit_for_bit": bits, "wall_s": wall2,
              "tolerance": dict(zip(("losses", "grad_norm"), CHECK_STEP_TOL[True]))})
        if sorted(run2) != list(range(16, ENGINE_ITERS + 1)):
            raise AssertionError(f"ddp cli resume: records {sorted(run2)}")
        over = [(it, k) for it, v in rel.items() for k, x in v.items()
                if not x <= CHECK_STEP_TOL[True][k == "grad_norm"]]
        if over:
            raise AssertionError(f"ddp cli resume: above tolerance vs run 1: {over}")

        from efg_tpu_torch.config import Configuration

        opts = [f"dataset.num_frames={DDP_VAL_FRAMES}", *small]
        val_dir = tempfile.mkdtemp(prefix="val_", dir=cache)
        specs = _ddp_specs(device)
        rc = launch.spawn(_ddp_val_rank, specs, (config, opts, val_dir))
        if rc != 0:
            raise AssertionError(f"ddp val: a rank failed (exit code {rc})")
        vals = []
        for r in range(DDP_WORLD):
            with open(os.path.join(val_dir, f"val{r}.json")) as f:
                vals.append(json.load(f))
        res = vals[0]["results"]
        classes = list(Configuration(config_file=config, opts=["task=val", *opts])
                       .get_config().dataset.classes)
        has_gt = sorted({classes[c - 1] for v in vals for c in v["gt_labels"]})
        off = {k: res.get(k) for c in has_gt for lvl in ("L1", "L2") for m in ("AP", "APH")
               for k in [f"waymo/{c}/{lvl}/{m}"] if not abs(res.get(k, 0.0) - 1.0) <= 1e-6}
        emit({"phase": "ddp", "part": "cli_val_perfect", "card": card,
              "frames_per_rank": [v["frames"] for v in vals], "classes_with_gt": has_gt,
              "results": res})
        if sum(v["frames"] for v in vals) != DDP_VAL_FRAMES or off or not has_gt:
            raise AssertionError(f"ddp val: frames {[v['frames'] for v in vals]}, not 1.0: "
                                 f"{off}, classes {has_gt}")
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(cache, ignore_errors=True)


# phase waymo: the flagship config's own pipeline from Waymo-format files.
# Frames in the decoder's pickle schema (`lidar_frames` clouds at N_POINTS,
# pc 70, each with boxes of the three classes and points inside every box)
# go through the port's create_data; the flagship and 4f configs are read
# as written with their `dataset.source` written out (the Waymo configs do
# not resolve in either package as written).
WAYMO_DIR = "playground/detection.3d/waymo/center_point"
WAYMO_FLAGSHIP = "centerpoint.waymo.voxelnet.gt_aug.onecycle.adamw.bs48.36e"
WAYMO_4F = "centerpoint.waymo.voxelnet.4f.36e"
WAYMO_TRAIN = (2, 3)  # train split: 2 sequences of 3 frames
# val split: one sequence of 7 frames. create_data gives a sequence's first
# nsweeps - 1 frames fewer sweeps and WaymoDetectionDataset refuses those at
# nsweeps 4 (efg_tpu's too), so the 4f batch reads the last 4 frames' infos
WAYMO_VAL = 7
# (decoder label, boxes a frame, dims): below the config's sample_groups
# quotas (15 / 10 / 10), so DatabaseSampling tops every class up
WAYMO_OBJECTS = ((1, 8, (4.7, 2.1, 1.7)), (2, 4, (0.9, 0.85, 1.7)), (4, 4, (1.8, 0.8, 1.7)))
WAYMO_ITERS = 4
# The configs' batch_size 6 does not fit the rank kernel's keys on one card:
# 6 × 41 × 1504 × 1504 grid cells reach INVALID_Q = 2^29, which the port
# refuses (`_check_key_range`). 5 is the largest batch that fits; memory
# is not the limit (bs 4 trains in 11 GB).
WAYMO_BATCH = 5
WAYMO_REF_SEED = 17  # the reference-format checkpoint's values
WAYMO_TIMED = 3  # timed runs of a serving batch (post-processing of 6 frames takes seconds)


def write_waymo_frames(root, split, n_seq, n_frames, seed, n_points=N_POINTS, pc=70.0):
    """Frame and anno pickles in the schema the port's tfrecord_decoder
    writes: `lidar_frames` clouds, WAYMO_OBJECTS' boxes (velocity in
    [6:8], heading in [8]) each holding 30-150 of the cloud's points, and
    a pose that advances along the sequence."""
    import pickle

    for d in ("lidar", "annos"):
        os.makedirs(os.path.join(root, split, d), exist_ok=True)
    for s in range(n_seq):
        for f in range(n_frames):
            frame_seed = seed * 1000 + s * 100 + f
            pts = lidar_frames(n_points, 1, frame_seed, pc=pc)["points"][0]
            rs = np.random.RandomState(frame_seed + 7)
            objects, start = [], 0
            for label, count, dims in WAYMO_OBJECTS:
                for _ in range(count):
                    d = np.abs(np.asarray(dims) + rs.randn(3) * 0.1)
                    box = np.zeros(9, np.float32)
                    box[:2] = rs.uniform(-0.8 * pc, 0.8 * pc, 2)
                    box[2] = rs.uniform(-0.5, 1.0)
                    box[3:6] = d
                    box[6:8] = rs.randn(2)
                    box[8] = rs.uniform(-np.pi, np.pi)
                    n_in = int(rs.randint(30, 150))
                    local = rs.uniform(-0.45, 0.45, (n_in, 3)) * d
                    c, sn = np.cos(box[8]), np.sin(box[8])
                    pts[start:start + n_in, 0] = local[:, 0] * c - local[:, 1] * sn + box[0]
                    pts[start:start + n_in, 1] = local[:, 0] * sn + local[:, 1] * c + box[1]
                    pts[start:start + n_in, 2] = local[:, 2] + box[2]
                    start += n_in
                    objects.append({
                        "id": len(objects), "name": f"{split}-{s}-{f}-{len(objects)}",
                        "label": label, "box": box, "num_points": n_in,
                        "detection_difficulty_level": 0, "combined_difficulty_level": 1,
                        "global_speed": box[6:8].copy(), "global_accel": np.zeros(2, np.float32)})
            yaw = 0.3 * s + 0.05 * f
            pose = np.eye(4)
            pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
            pose[:3, 3] = [100.0 * s + 1.5 * f, 0.4 * f, 0.02 * f]
            name = f"seq_{s}_frame_{f}.pkl"
            head = {"scene_name": f"{split}{s}", "frame_name": f"{split}{s}_{f}", "frame_id": f}
            with open(os.path.join(root, split, "lidar", name), "wb") as fh:
                pickle.dump({**head, "lidars": {"points_xyz": np.ascontiguousarray(pts[:, :3]),
                                                "points_feature": np.ascontiguousarray(pts[:, 3:])}},
                            fh)
            with open(os.path.join(root, split, "annos", name), "wb") as fh:
                pickle.dump({**head, "veh_to_global": pose.reshape(-1), "objects": objects}, fh)


def prepare_waymo(root, n_points=N_POINTS, pc=70.0):
    """The fixture dataset through the port's create_data: the frames, the
    infos at 1 and 4 sweeps of both splits (the 4-sweep val infos keep the
    frames that have 3 sweeps) and the train split's GT database."""
    import pickle

    from efg_tpu_torch.cli.data_preparation.waymo import create_data

    write_waymo_frames(root, "train", *WAYMO_TRAIN, seed=1, n_points=n_points, pc=pc)
    write_waymo_frames(root, "val", 1, WAYMO_VAL, seed=2, n_points=n_points, pc=pc)
    out = {}
    for split in ("train", "val"):
        for nsweeps in (1, 4):
            infos = create_data.build_infos(root, split, nsweeps)
            if split == "val" and nsweeps == 4:
                infos = [i for i in infos if len(i["sweeps"]) == nsweeps - 1]
            with open(os.path.join(root, f"infos_{split}_{nsweeps:02d}sweeps_sampled.pkl"),
                      "wb") as fh:
                pickle.dump(infos, fh)
            out[f"{split}_{nsweeps:02d}sweeps"] = len(infos)
            if split == "train" and nsweeps == 1:
                db = create_data.build_gt_database(
                    root, infos, "gt_database_train_01sweeps_withvelo_sampled")
                out["gt_database"] = {k: len(v) for k, v in db.items()}
                out["gt_database_min_points"] = {k: min(i["num_points_in_gt"] for i in v)
                                                 for k, v in db.items()}
    return out


def waymo_config(out_root, exp, data_root, nsweeps, directory=WAYMO_DIR):
    """The experiment's config.yaml as written, its `dataset.source` written
    out and `misc.seed` set, at `<out_root>/playground/<its path>` (so the
    CLI finds the port's net.py)."""
    import yaml

    with open(os.path.join(HERE, directory, exp, "config.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("includes")
    cfg["dataset"]["source"] = {
        "root": data_root, "train": f"/infos_train_{nsweeps:02d}sweeps_sampled.pkl",
        "val": f"/infos_val_{nsweeps:02d}sweeps_sampled.pkl",
        "test": f"/infos_val_{nsweeps:02d}sweeps_sampled.pkl",
        "gt_database": "/gt_database_train_01sweeps_withvelo_sampled_infos"}
    cfg["misc"] = {"seed": 0}
    path = os.path.join(out_root, directory, exp, "config.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def reference_checkpoint(seed, neck_cfg, num_input=5, bev_channels=256, num_classes=3):
    """A reference-format CenterPoint VoxelNet state dict (the reference's
    key names, spconv 2.x sparse weights [Cout, kd, kh, kw, Cin], torch
    ConvTranspose2d [I, O, kh, kw]), values from a seeded numpy generator on
    the scales of `seeded_weights`: {name: numpy array}."""
    neck = dict(neck_cfg)
    rs = np.random.RandomState(seed)
    sd = {}

    def uni(shape, lo, hi):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def bn(prefix, c):
        sd.update({f"{prefix}.weight": uni(c, 0.8, 1.2), f"{prefix}.bias": uni(c, -0.1, 0.1),
                   f"{prefix}.running_mean": uni(c, -0.1, 0.1),
                   f"{prefix}.running_var": uni(c, 0.8, 1.5),
                   f"{prefix}.num_batches_tracked": np.array(1000, np.int64)})

    def he(name, shape, fan_in):
        b = (6.0 / fan_in) ** 0.5
        sd[name] = uni(shape, -b, b)

    def sparse(name, cin, cout, k):
        he(name, (cout, *k, cin), cin * int(np.prod(k)))

    def block(prefix, c):
        for j in (1, 2):
            sparse(f"{prefix}.conv{j}.weight", c, c, (3, 3, 3))
            sd[f"{prefix}.conv{j}.bias"] = uni(c, -0.1, 0.1)
            bn(f"{prefix}.bn{j}", c)

    sparse("backbone.conv_input.0.weight", num_input, 16, (3, 3, 3))
    bn("backbone.conv_input.1", 16)
    block("backbone.conv1.0", 16)
    block("backbone.conv1.1", 16)
    for s, (cin, cout) in enumerate(((16, 32), (32, 64), (64, 128)), start=2):
        sparse(f"backbone.conv{s}.0.weight", cin, cout, (3, 3, 3))
        bn(f"backbone.conv{s}.1", cout)
        block(f"backbone.conv{s}.3", cout)
        block(f"backbone.conv{s}.4", cout)
    sparse("backbone.extra_conv.0.weight", 128, 128, (3, 1, 1))
    bn("backbone.extra_conv.1", 128)
    cin = bev_channels
    for i, (n_layers, nf) in enumerate(zip(neck["layer_nums"], neck["ds_num_filters"])):
        he(f"neck.blocks.{i}.1.weight", (nf, cin, 3, 3), cin * 9)
        bn(f"neck.blocks.{i}.2", nf)
        for j in range(n_layers):
            he(f"neck.blocks.{i}.{4 + 3 * j}.weight", (nf, nf, 3, 3), nf * 9)
            bn(f"neck.blocks.{i}.{5 + 3 * j}", nf)
        stride, uf = neck["us_layer_strides"][i], neck["us_num_filters"][i]
        if stride > 1:
            he(f"neck.deblocks.{i}.0.weight", (nf, uf, stride, stride), nf)
        else:
            he(f"neck.deblocks.{i}.0.weight", (uf, nf, 1, 1), nf)
        bn(f"neck.deblocks.{i}.1", uf)
        cin = nf
    he("center_head.shared_conv.0.weight", (64, sum(neck["us_num_filters"]), 3, 3),
       sum(neck["us_num_filters"]) * 9)
    sd["center_head.shared_conv.0.bias"] = uni(64, -0.1, 0.1)
    bn("center_head.shared_conv.1", 64)
    for name, (ch, _) in (*COMMON_HEADS, ("hm", (num_classes, 2))):
        he(f"center_head.tasks.0.{name}.0.weight", (64, 64, 3, 3), 64 * 9)
        sd[f"center_head.tasks.0.{name}.0.bias"] = uni(64, -0.1, 0.1)
        bn(f"center_head.tasks.0.{name}.1", 64)
        he(f"center_head.tasks.0.{name}.3.weight", (ch, 64, 3, 3), 64 * 9)
        sd[f"center_head.tasks.0.{name}.3.bias"] = uni(ch, -0.1, 0.1) - (2.19 if name == "hm" else 0)
    return sd


# (port tensor, reference key, the layout map) read back after the import
def _sparse_map(w):
    w = w.transpose(1, 2, 3, 4, 0)  # spconv 2.x [Cout, kd, kh, kw, Cin] → [kd, kh, kw, Cin, Cout]
    return w.reshape(-1, w.shape[3], w.shape[4])


WAYMO_READ_BACK = (
    ("backbone.conv_input.weight", "backbone.conv_input.0.weight", _sparse_map),
    ("backbone.down1.weight", "backbone.conv2.0.weight", _sparse_map),
    ("backbone.res2b.conv2.weight", "backbone.conv3.4.conv2.weight", _sparse_map),
    ("backbone.extra_conv.weight", "backbone.extra_conv.0.weight", _sparse_map),
    ("backbone.res0a.conv1.bias", "backbone.conv1.0.conv1.bias", None),
    ("backbone.bn_down3.bn.running_var", "backbone.conv4.1.running_var", None),
    ("backbone.res3a.bn1.bn.weight", "backbone.conv4.3.bn1.weight", None),
    ("neck.block0_in.Conv_0.weight", "neck.blocks.0.1.weight", None),
    ("neck.block1_conv0.BatchNorm_0.running_mean", "neck.blocks.1.5.running_mean", None),
    ("neck.deblock0_conv.weight", "neck.deblocks.0.0.weight", None),
    ("neck.deblock1_deconv.weight", "neck.deblocks.1.0.weight", None),  # unflipped
    ("head.shared_conv.weight", "center_head.shared_conv.0.weight", None),
    ("head.task0.hm_bn0.bias", "center_head.tasks.0.hm.1.bias", None),
    ("head.task0.hm_final.bias", "center_head.tasks.0.hm.3.bias", None),
    ("head.task0.rot_final.weight", "center_head.tasks.0.rot.3.weight", None),
)


class ImportProbe:
    """Wraps the trainer's `.pth` import for one CLI run: the (count,
    skipped) it returns and the model's tensors right after it (on the
    host)."""

    def __enter__(self):
        from efg_tpu_torch.utils import torch_import as TI

        self.results, self.states = [], []
        self._orig = TI.import_centerpoint_voxelnet

        def imp(sd, module, **kw):
            res = self._orig(sd, module, **kw)
            self.results.append(res)
            self.states.append({k: v.detach().cpu().clone() for k, v in module.state_dict().items()})
            return res

        TI.import_centerpoint_voxelnet = imp
        return self

    def __exit__(self, *exc):
        from efg_tpu_torch.utils import torch_import as TI

        TI.import_centerpoint_voxelnet = self._orig
        return False


class SamplingProbe:
    """Wraps `DatabaseSampling` for one CLI run: each item's GT count before
    and after it and its host seconds (the loader's worker threads call
    it)."""

    def __enter__(self):
        from efg_tpu_torch.data.processors import extend_3d as E

        self.items = []
        self._orig = E.DatabaseSampling.__call__
        call0, items = self._orig, self.items

        def call(proc, points, info):
            n0 = len(info["annotations"]["gt_boxes"])
            t0 = time.perf_counter()
            points, info = call0(proc, points, info)
            items.append((n0, len(info["annotations"]["gt_boxes"]), time.perf_counter() - t0))
            return points, info

        E.DatabaseSampling.__call__ = call
        return self

    def __exit__(self, *exc):
        from efg_tpu_torch.data.processors import extend_3d as E

        E.DatabaseSampling.__call__ = self._orig
        return False


class FirstStepCapture:
    """Records, in the trainer loop's first `train_step`, the forward's
    gather-GEMM calls (`Capture`) and the rank and stacked calls and conv
    backwards (`BackwardCapture`)."""

    def __enter__(self):
        from efg_tpu_torch.engine import trainer as T
        from efg_tpu_torch.ops.cuda import sparse_kernels as K

        self.forward = self.backward = None
        self._orig = T.train_step
        step0 = self._orig

        def step(*args, **kwargs):
            if self.forward is not None:
                return step0(*args, **kwargs)
            with BackwardCapture(K) as backward, Capture(K) as forward:
                out = step0(*args, **kwargs)
            self.forward, self.backward = forward, backward
            return out

        T.train_step = step
        return self

    def __exit__(self, *exc):
        from efg_tpu_torch.engine import trainer as T

        T.train_step = self._orig
        return False


def _event_ms(fn, runs=WAYMO_TIMED):
    """CUDA-event milliseconds of `runs` calls of `fn` after one warm-up."""
    import torch

    fn()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def phase_waymo(card: str, device="cuda", n_points=N_POINTS, pc=70.0, small=(), small_4f=(),
                data_root=None):
    """The flagship config's own pipeline on the card, output under a
    temporary EFG_CACHE_DIR:
    1. Waymo-format frames through the port's create_data: 6 train frames
       in 2 sequences, 7 val frames in one, infos at 1 and 4 sweeps, the GT
       database (every class with crops of at least min_points 5);
    2. a reference-format CenterPoint checkpoint at the flagship's width
       (torch.save of numpy values) imported through `model.weights`
       (`weights_format: centerpoint`): every tensor assigned, nothing
       skipped, each kind read back against its layout map;
    3. task=train of the flagship config as written (DatabaseSampling →
       RandomFlip3D → GlobalRotation → GlobalScaling → FilterByRange →
       PointShuffle → PadPoints 180000; 2 loader threads) at bs
       WAYMO_BATCH (the config's 6 exceeds the rank kernel's keys) for
       WAYMO_ITERS iterations: launches 12/21/21/0 a step, finite losses,
       every item's GT count above its frame's and at most max_gt; the
       iteration, step and data times, DatabaseSampling's host time, peak
       memory;
    4. the first step's rank, gather-GEMM and stacked calls (augmented,
       GT-sampled clouds) through the kernels against their plain versions;
    5. task=val of the val frames through WaymoDetEvaluator: (8, 21) a
       batch, finite waymo/* metrics;
    6. forward_double_flip on one val batch from the trained weights:
       4 × (8, 21), finite merged maps, predict on them; its time beside
       one forward's;
    7. the 4f config's val split (4 sweeps, 6 features, 400000 padded
       points, 400000 voxels): one batch (4 frames), fresh weights,
       (8, 21), peak memory.
    Returns the kernel rows. `small` / `small_4f` overrides shrink the
    runs for a rehearsal on the CPU. With `data_root` the dataset is
    written there and left for phase waymo_detr."""
    import pickle
    import shutil
    import tempfile

    import torch

    from efg_tpu_torch.cli.main import experiment_relpath, load_experiment_module
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.data import build_dataloader, build_dataset
    from efg_tpu_torch.models import centerpoint as CP
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    base = tempfile.mkdtemp(prefix="chip_smoke_waymo_")
    old_cache, old_cwd = os.environ.get("EFG_CACHE_DIR"), os.getcwd()
    os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")
    try:
        # 1. the dataset
        root = data_root or os.path.join(base, "waymo")
        t0 = time.perf_counter()
        prepared = prepare_waymo(root, n_points=n_points, pc=pc)
        prep_s = time.perf_counter() - t0
        flag_cfg = waymo_config(os.path.join(base, "exp"), WAYMO_FLAGSHIP, root, 1)
        fourf_cfg = waymo_config(os.path.join(base, "exp"), WAYMO_4F, root, 4)
        emit({"phase": "waymo", "part": "data", "card": card, "prepare_s": prep_s,
              "points_per_frame": n_points, "prepared": prepared})
        if sorted(prepared["gt_database"]) != ["CYCLIST", "PEDESTRIAN", "VEHICLE"] or \
                min(prepared["gt_database_min_points"].values()) < 5:
            raise AssertionError(f"waymo: GT database {prepared}")

        # 2. + 3. the reference checkpoint, imported by task=train
        small = [f"dataloader.batch_size={WAYMO_BATCH}", *small]
        small_4f = [f"dataloader.batch_size={WAYMO_BATCH}", *small_4f]
        cfg = Configuration(config_file=flag_cfg, opts=["task=train", *small]).get_config()
        neck = tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in cfg.model.neck.items())
        sd = reference_checkpoint(WAYMO_REF_SEED, neck)
        pth = os.path.join(base, "centerpoint_voxelnet_ref.pth")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        out_dir = os.path.join(base, "cache", "EFG_torch", experiment_relpath(flag_cfg))
        os.makedirs(out_dir, exist_ok=True)
        argv = ["task=train", "trainer.evaluators=", f"solver.lr_scheduler.max_iters={WAYMO_ITERS}",
                "trainer.log_interval=1", "trainer.window_size=1",
                "trainer.checkpoint_epoch=1000", f"model.weights={pth}",
                "model.weights_format=centerpoint", *small]
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with ImportProbe() as imp, SamplingProbe() as sampling, FirstStepCapture() as first:
            records, counts, probe = _engine_run(argv, out_dir, device, config=flag_cfg)
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
        run = _losses(records)

        (n, skipped), = imp.results
        dropped = sum(k.endswith("num_batches_tracked") for k in sd)
        state = imp.states[0]
        read_back = {}
        for port, ref, layout in WAYMO_READ_BACK:
            want = sd[ref] if layout is None else layout(sd[ref])
            read_back[port] = bool(np.array_equal(state[port].float().numpy(), want))
        emit({"phase": "waymo", "part": "import", "card": card, "checkpoint_keys": len(sd),
              "assigned": n, "skipped": skipped, "num_batches_tracked_dropped": dropped,
              "port_tensors": len(state), "read_back_equal": read_back})
        if skipped or n != len(sd) or len(sd) - dropped != len(state) or not all(read_back.values()):
            raise AssertionError(f"waymo import: {n} of {len(sd)} assigned, skipped {skipped}, "
                                 f"{len(state)} port tensors, read back {read_back}")

        bs = int(cfg.dataloader.batch_size)
        expected = _steps_of(TRAIN_LAUNCHES, WAYMO_ITERS)
        times = [r["time"] for r in records if "time" in r and r["iteration"] < WAYMO_ITERS]
        items = sampling.items
        db_ms = [1e3 * s for _, _, s in items]
        emit({"phase": "waymo", "part": "train", "card": card, "batch_size": bs,
              "iterations": WAYMO_ITERS, "records": sorted(run),
              "losses": {i: {k: run[i][k] for k in ("loss", "0_hm_loss", "0_loc_loss", "grad_norm")}
                         for i in sorted(run)},
              "iteration_time_ms": [1e3 * t for t in times],
              "loop_step_ms_cuda_events": probe.step_ms(),
              "data_time_ms": [1e3 * t for t in probe.data_s],
              "database_sampling_ms_per_item": db_ms,
              "database_sampling_ms_per_batch_mean": float(np.mean(db_ms)) * bs if db_ms else None,
              "gt_per_item_before_after": [(a, b) for a, b, _ in items],
              "peak_mem_gb": peak, "launches": counts, "launches_expected": expected})
        if sorted(run) != list(range(1, WAYMO_ITERS + 1)):
            raise AssertionError(f"waymo train: records {sorted(run)}")
        if counts != expected:
            raise AssertionError(f"waymo train: launches {counts}, expected {expected}")
        max_gt = int(cfg.dataset.max_gt)
        if len(items) < WAYMO_ITERS * bs or not all(b > a and b <= max_gt for a, b, _ in items):
            raise AssertionError(f"waymo train: GT per item (frame, after sampling) "
                                 f"{[(a, b) for a, b, _ in items]}, max_gt {max_gt}")

        # 4. the first step's kernel calls against their plain versions
        per = (f"sum over the calls of the first bs={WAYMO_BATCH} training step of the flagship "
               "config's own pipeline (DatabaseSampling, augmentations) through the CLI, {}; "
               f"launches over its {WAYMO_ITERS} steps")
        rows = first_step_kernels("waymo", first.forward, first.backward, card, counts, per,
                                  device)
        del first

        # 5. task=val through WaymoDetEvaluator
        argv = ["task=val", *small]
        vcfg = Configuration(config_file=flag_cfg, opts=argv).get_config()
        counts, vprobe = _cli_eval_run(argv, device, config=flag_cfg)
        n_batches = -(-WAYMO_VAL // int(vcfg.dataloader.batch_size))
        expected = _steps_of(SERVE_LAUNCHES, n_batches)
        (_, res, evaluate_s), = vprobe.evaluations
        emit({"phase": "waymo", "part": "val", "card": card, "frames": WAYMO_VAL,
              "batch_size": int(vcfg.dataloader.batch_size), "weights": "trained (model_final)",
              "eval_step_ms_cuda_events": vprobe.step_ms(), "data_ms": [1e3 * d for d in vprobe.data_s],
              "evaluate_s": evaluate_s, "results": res, "launches": counts,
              "launches_expected": expected})
        _check_waymo_results("waymo val", res, list(vcfg.dataset.classes))
        if len(vprobe.step_ms()) != n_batches or counts != expected:
            raise AssertionError(f"waymo val: {len(vprobe.step_ms())} batches, launches {counts}, "
                                 f"expected {n_batches} and {expected}")

        # 6. double-flip serving of one val batch
        md = load_experiment_module(flag_cfg).build_model(vcfg, device=device)
        ckpt = torch.load(os.path.join(out_dir, "model_final"), map_location=device,
                          weights_only=True)
        md.module.load_state_dict(ckpt["model"])
        batch = next(iter(build_dataloader(vcfg, build_dataset(vcfg), train=False)))
        pts = torch.from_numpy(batch["points"]).to(device)
        mask = torch.from_numpy(batch["points_mask"]).to(device)
        with torch.no_grad():
            K.reset_launches()
            merged = CP.forward_double_flip(md.module, pts, mask)
            if device == "cuda":
                torch.cuda.synchronize()
            counts = dict(K.launches)
            finite = all(bool(torch.isfinite(v).all()) for t in merged for v in t.values())
            det = md.predict_fn(merged, None)
            n_det = int(det["valid"].sum())
            flip_ms = _event_ms(lambda: CP.forward_double_flip(md.module, pts, mask))
            one_ms = _event_ms(lambda: md.module(pts, mask))
            predict_ms = _event_ms(lambda: md.predict_fn(merged, None))
        expected = _steps_of(SERVE_LAUNCHES, 4)
        emit({"phase": "waymo", "part": "double_flip", "card": card, "batch_size": pts.shape[0],
              "double_flip_forward_ms": flip_ms, "one_forward_ms": one_ms,
              "predict_ms": predict_ms, "merged_finite": finite, "detections": n_det,
              "launches": counts, "launches_expected": expected})
        if counts != expected or not finite:
            raise AssertionError(f"waymo double flip: launches {counts}, expected {expected}; "
                                 f"finite {finite}")
        del md, merged, pts, mask

        # 7. the 4f widths: one val batch; sweep paths are relative to the root
        os.chdir(root)
        argv = ["task=val", *small_4f]
        fcfg = Configuration(config_file=fourf_cfg, opts=argv).get_config()
        with open(os.path.join(root, "infos_val_04sweeps_sampled.pkl"), "rb") as fh:
            frames = len(pickle.load(fh))
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        counts, fprobe = _cli_eval_run(argv, device, config=fourf_cfg)
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
        expected = _steps_of(SERVE_LAUNCHES, 1)
        (_, res, evaluate_s), = fprobe.evaluations
        shape = tuple(fprobe.batches[0]["points"].shape) if fprobe.batches else None
        emit({"phase": "waymo", "part": "val_4f", "card": card, "frames": frames,
              "batch_size": int(fcfg.dataloader.batch_size), "points_shape": shape,
              "max_voxels": int(fcfg.model.max_voxels), "stage_caps": list(fcfg.model.stage_caps),
              "weights": "fresh (misc.seed)", "eval_step_ms_cuda_events": fprobe.step_ms(),
              "data_ms": [1e3 * d for d in fprobe.data_s], "peak_mem_gb": peak, "results": res,
              "launches": counts, "launches_expected": expected})
        if frames != 4 or counts != expected or len(fprobe.step_ms()) != 1:
            raise AssertionError(f"waymo 4f: {frames} frames, launches {counts}, expected {expected}")
        if shape is not None and shape[2] != 6:
            raise AssertionError(f"waymo 4f: points {shape}, expected 6 features")
        _check_waymo_results("waymo 4f", res, list(fcfg.dataset.classes))
        return rows
    finally:
        os.chdir(old_cwd)
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(base, ignore_errors=True)


def wide_call(call) -> bool:
    """A gather-GEMM call (features, rulebook, weights) at 256 channels."""
    return max(call[0].shape[1], call[2].shape[1]) > 128


def first_step_kernels(tag, forward, backward, card: str, step_counts: dict, per: str,
                       device="cuda", keep=None, labels=None, suffix=""):
    """The captured calls of a config's first step through the kernels and
    their plain versions; returns their kernel rows `<kernel><suffix>@<tag>`.
    A training step (`backward` given): its 12 rank calls (8 forward + 4
    inverse rulebooks), its forward gather-GEMM calls and its stacked
    calls; a serving step (`backward` None): the forward's 8 rank and its
    gather-GEMM calls. `keep` filters the gather-GEMM and stacked calls and
    drops the rank calls (a DETR config's 256-wide rows: `wide_call`);
    `labels` names the kept forward calls (default: the VoxelNet trunk's
    21). `per` holds a `{}` for the calls a row sums."""
    if backward is None:
        rank, rank_labels, stacked = forward.rank, RANK_LABELS, []
    else:
        rank, rank_labels = backward.rank, RANK_TRAIN_LABELS
        stacked = list(zip(backward.stacked, backward.convs))
    gemm = forward.gemm
    if keep is not None:
        rank, rank_labels = [], []
        gemm = [c for c in gemm if keep(c)]
        stacked = [(call, conv) for call, conv in stacked if keep(call)]
    labels = list(labels or [gemm_label(i) for i in range(21)])
    want = (len(rank_labels), len(labels), 0 if backward is None else len(labels))
    if (len(rank), len(gemm), len(stacked)) != want:
        raise AssertionError(f"{tag}: captured {len(rank)} rank, {len(gemm)} gather-GEMM and "
                             f"{len(stacked)} stacked calls{suffix and ' (filtered)'}, "
                             f"expected {want}")
    if device != "cuda":
        return []
    rank_rows = [_rank_row(lbl, k, q) for lbl, (k, q) in zip(rank_labels, rank)]
    gemm_rows = [_gemm_row(lbl, *call)[0] for lbl, call in zip(labels, gemm)]
    st_rows = [_gemm_row(backward_label(i, call[0], conv), *call, emit=True)[0]
               for i, (call, conv) in enumerate(stacked)]
    emit({"phase": f"{tag}_kernels", "card": card, "rank_calls": rank_rows,
          "gemm_calls": gemm_rows, "stacked_calls": st_rows})
    rulebooks = "8 forward rulebooks" if backward is None else "8 forward + 4 inverse rulebooks"
    rows = [kernel_row(f"rank_flags@{tag}", "rank_flags.cu", 882, step_counts["rank_flags"],
                       rank_rows, library_call="torch.searchsorted (count field only)",
                       tolerance="exact", per=per.format(rulebooks), card=card)] if rank_rows else []
    rows.append(kernel_row(f"gather_gemm{suffix}@{tag}", "gather_gemm.cu", 259,
                           step_counts[f"gather_gemm{suffix}"], gemm_rows,
                           tolerance="1e-3 * max|ref|",
                           per=per.format(f"{len(labels)} forward convs"), card=card))
    if st_rows:
        rows.append(kernel_row(f"gather_gemm_stacked{suffix}@{tag}", "gather_gemm.cu", 259,
                               step_counts[f"gather_gemm_stacked{suffix}"], st_rows,
                               tolerance="taps bit-exact, out 1e-3 * max|ref|",
                               per=per.format("one per conv backward"), card=card))
    return rows


# phase waymo_detr: the Waymo DETR experiments' own configs on phase waymo's
# frames. Training runs bs 2: ConQueR's step at these widths peaks at 33.0 GB
# at bs 2 (phase detr_train). Val runs bs 5: 6 frames of the 1504×1504×40
# grid are 543M linear keys, past the rank kernel's INVALID_Q = 2^29.
DETR_WAYMO_DIR = "playground/detection.3d/waymo/conquer"
VOXELDETR_EXP = "voxeldetr.waymo.res18.p3.bs6.epoch6"
CONQUER_EXP = "conquer.waymo.res18.p3.dn3.tau07.bs6.epoch6"
WAYMO_DETR_TRAIN_BATCH = 2
WAYMO_DETR_VAL_BATCH = 5
WAYMO_DETR_ITERS = 3


def phase_waymo_detr(card: str, data_root: str, device="cuda", small=()):
    """The two Waymo DETR experiments through the CLI on phase waymo's
    Waymo-format frames, output under a temporary EFG_CACHE_DIR:
    1. voxeldetr.waymo.res18.p3.bs6.epoch6's config as written
       (DatabaseSampling first, PadPoints 180000, SparseResNet-18 to res4
       at 256 channels, 1000 queries; `dataset.source` written out),
       task=train at bs WAYMO_DETR_TRAIN_BATCH for WAYMO_DETR_ITERS
       iterations: launches 18/13+5/12+5/0 a step, finite losses, the loop
       step and iteration, peak memory; the first step's res4 calls (5
       forward, 5 stacked at 256 channels) through the kernels against
       their plain versions;
    2. its task=val at bs WAYMO_DETR_VAL_BATCH through WaymoDetEvaluator:
       launches 11/13+5 a batch, the eval step a batch, finite waymo/*;
    3. conquer.waymo.res18.p3.dn3.tau07.bs6.epoch6's config as written (it
       includes its sibling's config.yaml by a relative path), task=train
       likewise: denoising, the momentum decoder and the contrast losses,
       its `trainer.fade` dropping DatabaseSampling at iteration 2.
    Returns the kernel rows `gather_gemm_256@waymo_detr` and
    `gather_gemm_stacked_256@waymo_detr`."""
    import torch

    from efg_tpu_torch.cli.main import experiment_relpath

    base = tempfile.mkdtemp(prefix="chip_smoke_waymo_detr_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")
    try:
        exp_root = os.path.join(base, "exp")
        configs = {VOXELDETR_EXP: waymo_config(exp_root, VOXELDETR_EXP, data_root, 1,
                                               directory=DETR_WAYMO_DIR)}
        configs[CONQUER_EXP] = os.path.join(exp_root, DETR_WAYMO_DIR, CONQUER_EXP, "config.yaml")
        os.makedirs(os.path.dirname(configs[CONQUER_EXP]), exist_ok=True)
        shutil.copy(os.path.join(HERE, DETR_WAYMO_DIR, CONQUER_EXP, "config.yaml"),
                    configs[CONQUER_EXP])
        rows = []
        for exp, config in configs.items():
            out_dir = os.path.join(base, "cache", "EFG_torch", experiment_relpath(config))
            os.makedirs(out_dir, exist_ok=True)
            argv = ["task=train", "trainer.evaluators=",
                    f"solver.lr_scheduler.max_iters={WAYMO_DETR_ITERS}", "trainer.log_interval=1",
                    "trainer.window_size=1", "trainer.checkpoint_epoch=1000",
                    f"dataloader.batch_size={WAYMO_DETR_TRAIN_BATCH}", *small]
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            first_step = FirstStepCapture() if exp == VOXELDETR_EXP else contextlib.nullcontext()
            with first_step as first:
                records, counts, probe = _engine_run(argv, out_dir, device, config=config)
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
            run = _losses(records, f"waymo_detr {exp}")
            expected = _steps_of(DETR_TRAIN_LAUNCHES, WAYMO_DETR_ITERS)
            with open(os.path.join(out_dir, "log.txt.rank0")) as fh:
                faded = [ln.split("INFO: ", 1)[-1].strip() for ln in fh if "Aug fade" in ln]
            emit({"phase": "waymo_detr", "part": "train", "experiment": exp, "card": card,
                  "batch_size": WAYMO_DETR_TRAIN_BATCH, "iterations": sorted(run),
                  "losses": {i: {k: v for k, v in r.items() if k in ("loss", "loss_ce",
                                                                     "loss_bbox", "grad_norm")}
                             for i, r in run.items()},
                  "iteration_time_ms": [1e3 * r["time"] for r in records if "time" in r],
                  "loop_step_ms_cuda_events": probe.step_ms() if device == "cuda" else None,
                  "data_time_ms": [1e3 * t for t in probe.data_s], "peak_mem_gb": peak,
                  "fade": faded, "launches": counts, "launches_expected": expected})
            if sorted(run) != list(range(1, WAYMO_DETR_ITERS + 1)) or counts != expected:
                raise AssertionError(f"waymo_detr {exp}: records {sorted(run)}, launches "
                                     f"{counts}, expected {expected}")
            if faded != (["Aug fade at iter 2: dropped leading processor"]
                         if exp == CONQUER_EXP else []):
                raise AssertionError(f"waymo_detr {exp}: fade log {faded}")
            if exp == CONQUER_EXP:
                if not all(k in r for r in run.values() for k in ("loss_contrastive_dec_0",
                                                                   "loss_ce_dn")):
                    raise AssertionError(f"waymo_detr conquer: loss parts {sorted(run[1])}")
                continue
            per = (f"sum over the calls at 256 channels (res4) of the first bs="
                   f"{WAYMO_DETR_TRAIN_BATCH} training step of {VOXELDETR_EXP} as written "
                   f"through the CLI, {{}}; launches over its {WAYMO_DETR_ITERS} steps")
            rows = first_step_kernels("waymo_detr", first.forward, first.backward, card, counts,
                                      per, device, keep=wide_call, labels=DETR_256_LABELS,
                                      suffix="_256")
            del first

            argv = ["task=val", f"dataloader.batch_size={WAYMO_DETR_VAL_BATCH}", *small]
            counts, vprobe = _cli_eval_run(argv, device, config=config)
            n_batches = -(-WAYMO_VAL // WAYMO_DETR_VAL_BATCH)
            expected = _steps_of(DETR_SERVE_LAUNCHES, n_batches)
            (_, res, evaluate_s), = vprobe.evaluations
            emit({"phase": "waymo_detr", "part": "val", "experiment": exp, "card": card,
                  "frames": WAYMO_VAL, "batch_size": WAYMO_DETR_VAL_BATCH,
                  "weights": "trained (model_final)",
                  "eval_step_ms_cuda_events": vprobe.step_ms() if device == "cuda" else None,
                  "data_ms": [1e3 * d for d in vprobe.data_s], "evaluate_s": evaluate_s,
                  "val_frames_per_s": WAYMO_VAL / evaluate_s, "results": res,
                  "launches": counts, "launches_expected": expected})
            _check_waymo_results("waymo_detr val", res, ["VEHICLE", "PEDESTRIAN", "CYCLIST"])
            if len(vprobe.step_events) != n_batches or counts != expected:
                raise AssertionError(f"waymo_detr val: {len(vprobe.step_events)} batches, "
                                     f"launches {counts}, expected {n_batches} and {expected}")
        return rows
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(base, ignore_errors=True)


# phase track: the tracking experiments. (a) The two synthetic ones as
# written through efg_run_torch; (b) the Waymo TrajectoryFormer config as
# written at full width on phase waymo's frames, its detections from the
# flagship config's eval step over those frames.
TRACK_SYNTH_DIR = "playground/tracking.3d/synthetic"
TRACK_PRETRAIN = "trajectoryformer.motionpred.pretrain"
TRACK_SYNTH = "trajectoryformer.synth"
TRACK_WAYMO_DIR = "playground/tracking.3d/waymo/trajectoryformer"
TRACK_WAYMO = "trajectoryformer.centerpoint"
TRACK_ITERS = 4  # full-width training iterations
TRACK_DET_BATCH = 4  # the flagship's eval batch that writes the boxes pkl
TRACK_CPU_FRAME = 3  # the val frame whose scoring call is held card against CPU
TRACK_CPU_TOL = (1e-4, 1e-3)  # card vs CPU in f32 (TF32 off): scores, refined boxes
SWEEP_MS = 100.0  # the sweep period of a 10 Hz LiDAR


class GraftProbe:
    """Records each graft of a pretrained motion encoder
    (`models/trajectoryformer.py` `load_motion_encoder`): the checkpoint
    path and host copies of the tensors as grafted, before any step."""

    def __enter__(self):
        from efg_tpu_torch.models import trajectoryformer as TF

        self.grafts = []
        self._orig = graft0 = TF.load_motion_encoder

        def graft(module, path):
            out = graft0(module, path)
            self.grafts.append((path, {k: v.detach().cpu().clone() for k, v in out.items()}))
            return out

        TF.load_motion_encoder = graft
        return self

    def __exit__(self, *exc):
        from efg_tpu_torch.models import trajectoryformer as TF

        TF.load_motion_encoder = self._orig
        return False

    def check(self, pretrain_ckpt: str, label: str) -> int:
        """One graft, from `pretrain_ckpt`, every tensor equal bit for bit
        to the pretrain's encoder; returns the tensors grafted."""
        import torch

        src = torch.load(pretrain_ckpt, map_location="cpu", weights_only=True)["model"]
        if len(self.grafts) != 1 or os.path.abspath(self.grafts[0][0]) != os.path.abspath(
                pretrain_ckpt):
            raise AssertionError(f"{label}: grafts {[p for p, _ in self.grafts]}, expected one "
                                 f"from {pretrain_ckpt}")
        grafted = self.grafts[0][1]
        equal = {k: bool(torch.equal(v, src[k[len("core."):]])) for k, v in grafted.items()}
        n_src = sum(k.startswith("motion_encoder.") for k in src)
        if len(equal) != n_src or not all(equal.values()):
            raise AssertionError(f"{label}: grafted tensors not equal to the pretrain's: {equal}")
        return len(equal)


def _finite_results(label, res):
    bad = {k: v for k, v in res.items() if not np.isfinite(v)}
    if not res or bad:
        raise AssertionError(f"{label}: results {res if not res else bad}")


def _gt_tracks(batches):
    """Each val frame's GT as tracks: its boxes, track ids and classes."""
    return [[dict(translation=np.asarray(b[:3]).tolist(), tracking_id=int(i), label=int(c) - 1,
                  box=np.asarray(b), score=1.0)
             for b, i, c in zip(a["gt_boxes"], a["track_ids"], a["labels"])]
            for inputs in batches for a in inputs["annotations"]]


def track_config(out_root, data_root, boxes, motion_model):
    """The Waymo TrajectoryFormer experiment's config.yaml as written, its
    `dataset.source`, boxes pkls and `model.motion_model` written out, at
    `<out_root>/playground/<its path>` (so the CLI finds the port's net.py)."""
    import yaml

    with open(os.path.join(HERE, TRACK_WAYMO_DIR, TRACK_WAYMO, "config.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("includes")
    cfg["dataset"]["source"] = {"root": data_root, "train": "/infos_train_01sweeps_sampled.pkl",
                                "val": "/infos_val_01sweeps_sampled.pkl",
                                "test": "/infos_val_01sweeps_sampled.pkl"}
    cfg["dataset"]["train_boxes_path"], cfg["dataset"]["val_boxes_path"] = boxes
    cfg["model"]["motion_model"] = motion_model
    cfg["misc"] = {"seed": 0}
    path = os.path.join(out_root, TRACK_WAYMO_DIR, TRACK_WAYMO, "config.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def flagship_detections(flag_cfg, split, md, device, small=()):
    """The flagship config's eval step (its val pipeline) over a split's
    frames, each frame's boxes, scores and labels in the boxes-pkl format
    `WaymoTrackingDataset` reads; returns (frames, launch counts, eval step
    ms a batch, the first batch's captured kernel calls)."""
    import torch

    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.data import build_dataloader, build_dataset
    from efg_tpu_torch.engine.trainer import eval_step
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    cfg = Configuration(config_file=flag_cfg, opts=[
        "task=val", f"dataset.source.val=/infos_{split}_01sweeps_sampled.pkl",
        f"dataloader.batch_size={TRACK_DET_BATCH}", *small]).get_config()
    ds = build_dataset(cfg)
    frames, step_ms, capture = [], [], None
    K.reset_launches()
    for i, batch in enumerate(build_dataloader(cfg, ds, train=False)):
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
               if isinstance(v, np.ndarray)}
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with (Capture(K) if i == 0 else contextlib.nullcontext()) as cap:
            a.record()
            out = eval_step(md, dev)
            b.record()
        capture = capture or cap
        out = {k: v.cpu().numpy() for k, v in out.items()}
        step_ms.append(a.elapsed_time(b))
        for j, meta in enumerate(batch["metadata"]):
            v = out["valid"][j]
            frames.append({"token": meta["token"], "boxes3d": out["box3d"][j][v],
                           "scores": out["scores"][j][v], "labels": out["labels"][j][v]})
    return frames[:len(ds)], dict(K.launches), step_ms, capture


def phase_track(card: str, data_root: str, device="cuda", small=(), small_det=(),
                synth=()):
    """The tracking experiments through the CLI, output under a temporary
    EFG_CACHE_DIR:
    (a) the synthetic experiments as written: the motion pretrain
        task=train (20 iterations); trajectoryformer.synth task=train with
        `model.motion_model` naming that run's model_final (the grafted
        tensors equal the pretrain's bit for bit), then task=val through
        TrackingEvaluator (every result finite); the val frames' GT tracks
        through the evaluator read MOTA = 1 and tracking_official/MOTA_L2
        = 1 exactly;
    (b) the Waymo TrajectoryFormer config as written (bs 4, PadPoints
        180000, max_roi_num 128, d_model 256, 3 layers, 128 points a
        hypothesis, history 10) on phase waymo's frames: the boxes pkls
        from the flagship config's eval step over the train and val frames
        with seeded weights (the rank and gather-GEMM kernels, (8, 21) a
        batch; the first batch's calls against their plain versions, kernel
        rows `*@track`); the motion model is (a)'s synthetic pretrain (the
        Waymo pretrain cannot run); task=train TRACK_ITERS iterations (step
        ms by CUDA events, peak memory, no sparse kernel launched), task=val
        through SeqInferenceSampler and TrackingEvaluator (eval step ms a
        frame, evaluator ms, val frames/s); then TrajectoryFormerTracker
        over the val sequence frame by frame (ms a frame beside the 100 ms
        sweep), and one frame's scoring call on the card against the same
        call on the CPU. `small` / `small_det` / `synth` cut (b)'s
        tracking runs, its detection model and (a)'s runs for a rehearsal
        on the CPU. Returns the kernel rows."""
    import copy
    import pickle

    import torch

    from efg_tpu_torch.cli.main import experiment_relpath, load_experiment_module
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.data import build_dataloader, build_dataset
    from efg_tpu_torch.evaluator.tracking_evaluator import TrackingEvaluator
    from efg_tpu_torch.models import trajectoryformer as TF
    from efg_tpu_torch.tracking.tf_tracker import TrajectoryFormerTracker

    base = tempfile.mkdtemp(prefix="chip_smoke_track_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")

    def out_dir_of(config):
        d = os.path.join(base, "cache", "EFG_torch", experiment_relpath(config))
        os.makedirs(d, exist_ok=True)
        return d

    try:
        # (a) 1. the motion pretrain as written
        pre_cfg = os.path.join(TRACK_SYNTH_DIR, TRACK_PRETRAIN, "config.yaml")
        pre_out = out_dir_of(os.path.join(HERE, pre_cfg))
        logs = ["trainer.log_interval=1", "trainer.window_size=1"]  # a record every step
        records, counts, _ = _engine_run(["task=train", *logs, *synth], pre_out, device,
                                         config=pre_cfg)
        run = _losses(records, "track pretrain")
        pre_ckpt = os.path.join(pre_out, "model_final")
        iters = int(Configuration(config_file=os.path.join(HERE, pre_cfg),
                                  opts=list(synth)).get_config().solver.lr_scheduler.max_iters)
        emit({"phase": "track", "part": "synthetic_pretrain", "card": card,
              "iterations": sorted(run), "losses": {i: r["loss"] for i, r in run.items()},
              "launches": counts})
        if sorted(run) != list(range(1, iters + 1)) or not os.path.isfile(pre_ckpt) or any(
                counts.values()):
            raise AssertionError(f"track pretrain: records {sorted(run)}, launches {counts}")

        # (a) 2. the tracking experiment, grafted from it, then task=val
        syn_cfg = os.path.join(TRACK_SYNTH_DIR, TRACK_SYNTH, "config.yaml")
        syn_out = out_dir_of(os.path.join(HERE, syn_cfg))
        with GraftProbe() as graft:
            records, counts, _ = _engine_run(
                ["task=train", f"model.motion_model={pre_ckpt}", *logs, *synth], syn_out, device,
                config=syn_cfg)
        n_grafted = graft.check(pre_ckpt, "track synth")
        run = _losses(records, "track synth")
        counts_val, vprobe = _cli_eval_run(["task=val", *synth], device, config=syn_cfg)
        (_, res, evaluate_s), = vprobe.evaluations
        _finite_results("track synth val", res)
        # (a) 3. the val frames' GT tracks: perfect tracking
        tcfg = Configuration(config_file=os.path.join(HERE, syn_cfg)).get_config()
        perfect = TrackingEvaluator(tcfg, None)
        perfect.reset()
        for inputs, tracks in zip(vprobe.batches, _gt_tracks(vprobe.batches)):
            perfect.process(inputs, dict(tracks=[tracks]))
        pres = perfect.evaluate()
        emit({"phase": "track", "part": "synthetic", "card": card, "grafted_tensors": n_grafted,
              "graft_bit_exact": True, "iterations": sorted(run),
              "losses": {i: {k: r[k] for k in ("loss", "loss_cls", "loss_reg")}
                         for i, r in run.items()},
              "val_frames": len(vprobe.batches), "val_results": res, "evaluate_s": evaluate_s,
              "perfect_mota": pres["tracking/MOTA"],
              "perfect_mota_l2": pres["tracking_official/MOTA_L2"],
              "launches": {"train": counts, "val": counts_val}})
        if pres["tracking/MOTA"] != 1.0 or pres["tracking_official/MOTA_L2"] != 1.0:
            raise AssertionError(f"track synth: perfect tracks read {pres}")
        if any(counts.values()) or any(counts_val.values()):
            raise AssertionError(f"track synth: sparse kernels launched {counts} {counts_val}")

        # (b) 1. the detections: the flagship config's eval step
        exp_root = os.path.join(base, "exp")
        flag_cfg = waymo_config(exp_root, WAYMO_FLAGSHIP, data_root, 1)
        fcfg = Configuration(config_file=flag_cfg, opts=["task=val", *small_det]).get_config()
        det_md = load_experiment_module(flag_cfg).build_model(fcfg, device=device)
        seeded_weights(det_md.module, SEED)
        boxes, det_rows, det_counts, det_ms = [], [], {}, {}
        for split in ("train", "val"):
            frames, counts, ms, capture = flagship_detections(flag_cfg, split, det_md, device,
                                                              small_det)
            path = os.path.join(base, f"centerpoint_boxes_{split}.pkl")
            with open(path, "wb") as fh:
                pickle.dump(frames, fh)
            boxes.append(path)
            n_batches = -(-len(frames) // TRACK_DET_BATCH)
            expected = _steps_of(SERVE_LAUNCHES, n_batches)
            det_counts[split], det_ms[split] = counts, ms
            if counts != expected:
                raise AssertionError(f"track detections {split}: launches {counts}, "
                                     f"expected {expected}")
            if split == "val":
                per = (f"sum over the calls of the first bs={TRACK_DET_BATCH} eval step of the "
                       "flagship config over phase waymo's val frames (the detections "
                       f"{TRACK_WAYMO} tracks), {{}}; launches over its {n_batches} batches")
                det_rows = first_step_kernels("track", capture, None, card, counts, per, device)
            emit({"phase": "track", "part": "detections", "split": split, "card": card,
                  "frames": len(frames), "batch_size": TRACK_DET_BATCH,
                  "detections_per_frame": [len(f["scores"]) for f in frames],
                  "eval_step_ms_cuda_events": ms, "launches": counts,
                  "launches_expected": expected})
        del det_md

        # (b) 2. task=train of the Waymo config, grafted from (a)'s pretrain
        cfg_path = track_config(exp_root, data_root, boxes, pre_ckpt)
        cfg = Configuration(config_file=cfg_path, opts=["task=train", *small]).get_config()
        out_dir = out_dir_of(cfg_path)
        argv = ["task=train", "trainer.evaluators=", f"solver.lr_scheduler.max_iters={TRACK_ITERS}",
                "trainer.log_interval=1", "trainer.window_size=1",
                "trainer.checkpoint_epoch=1000", *small]
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with GraftProbe() as graft:
            records, counts, probe = _engine_run(argv, out_dir, device, config=cfg_path)
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
        n_grafted = graft.check(pre_ckpt, "track waymo")
        run = _losses(records, "track waymo")
        mc = cfg.model.trajectoryformer
        emit({"phase": "track", "part": "train", "card": card,
              "batch_size": int(cfg.dataloader.batch_size),
              "points": int(cfg.dataset.processors.train[-1]["PadPoints"]["num_points"]),
              "max_roi_num": int(cfg.dataset.max_roi_num), "d_model": int(mc.d_model),
              "num_layers": int(mc.num_layers), "num_points": int(mc.num_points),
              "history": int(mc.history), "grafted_tensors": n_grafted,
              "iterations": sorted(run),
              "losses": {i: {k: r[k] for k in ("loss", "loss_cls", "loss_reg", "num_pos",
                                               "grad_norm")} for i, r in run.items()},
              "iteration_time_ms": [1e3 * r["time"] for r in records if "time" in r],
              "loop_step_ms_cuda_events": probe.step_ms(),
              "data_time_ms": [1e3 * t for t in probe.data_s], "peak_mem_gb": peak,
              "launches": counts})
        if sorted(run) != list(range(1, TRACK_ITERS + 1)) or any(counts.values()):
            raise AssertionError(f"track waymo train: records {sorted(run)}, launches {counts}")

        # (b) 3. task=val through SeqInferenceSampler and TrackingEvaluator
        argv = ["task=val", *small]
        vcfg = Configuration(config_file=cfg_path, opts=argv).get_config()
        counts, vprobe = _cli_eval_run(argv, device, config=cfg_path)
        (_, res, evaluate_s), = vprobe.evaluations
        n_frames = len(vprobe.step_events)
        emit({"phase": "track", "part": "val", "card": card, "frames": n_frames,
              "sampler": vcfg.dataloader.eval_sampler,
              "eval_batch_size": int(vcfg.dataloader.eval_batch_size),
              "eval_step_ms_cuda_events": vprobe.step_ms(),
              "data_ms": [1e3 * d for d in vprobe.data_s],
              "evaluator_process_ms": [1e3 * d for d in vprobe.process_s],
              "evaluator_evaluate_ms": [1e3 * d for d in vprobe.evaluator_s],
              "evaluate_s": evaluate_s, "val_frames_per_s": n_frames / evaluate_s,
              "results": res, "launches": counts})
        _finite_results("track waymo val", res)
        if n_frames != WAYMO_VAL or any(counts.values()):
            raise AssertionError(f"track waymo val: {n_frames} frames, launches {counts}")

        # (b) 4. TrajectoryFormerTracker over the val sequence
        md = load_experiment_module(cfg_path).build_model(vcfg, device=device)
        ckpt = torch.load(os.path.join(out_dir, "model_final"), map_location=device,
                          weights_only=True)
        md.module.load_state_dict(ckpt["model"])
        core = md.module.core
        classes = list(vcfg.dataset.classes)
        kw = dict(class_names=classes, max_candidates=int(vcfg.dataset.max_roi_num),
                  history=int(vcfg.model.trajectoryformer.history),
                  num_points=int(vcfg.model.trajectoryformer.num_points))
        tracker = TrajectoryFormerTracker(core, **kw)
        ds = build_dataset(vcfg)
        order = list(build_dataloader(vcfg, ds, train=False).sampler)
        calls, frame_ms, n_tracks = [], [], []
        score0 = tracker.score

        def score(*args):
            out = score0(*args)
            calls.append((tuple(a.clone() for a in args), tuple(o.clone() for o in out)))
            return out

        tracker.score = score
        for idx in order:
            data, info = ds[idx]
            a = info["annotations"]
            dets = [dict(box=b, score=float(s), detection_name=classes[int(c) - 1],
                         translation=b[:3].tolist(), velocity=b[6:8].tolist())
                    for b, s, c in zip(a["det_boxes"], a["det_scores"], a["det_labels"])]
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracks = tracker.step(data["points"], data["points_mask"], dets)
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            n_tracks.append(len(tracks))
        args, (scores, refined) = calls[TRACK_CPU_FRAME]
        with torch.no_grad():  # that frame's scoring call, and its crop alone
            score_ms = _event_ms(lambda: score0(*args))
            crop_ms = _event_ms(lambda: TF.crop_hypothesis_points(
                args[0][None], args[1][None], args[2][None], num_points=kw["num_points"]))
        cpu = TrajectoryFormerTracker(copy.deepcopy(core).cpu(), **kw)
        c_scores, c_refined = cpu.score(*(t.cpu() for t in args))
        valid = args[-1].cpu()
        err = (float((scores.cpu() - c_scores)[valid].abs().max()),
               float((refined.cpu() - c_refined)[valid].abs().max()))
        emit({"phase": "track", "part": "tracker", "card": card, "frames": len(order),
              "max_candidates": kw["max_candidates"], "frame_ms_host": frame_ms,
              "sweep_ms": SWEEP_MS, "frames_within_sweep": sum(t < SWEEP_MS for t in frame_ms),
              "score_call_ms_cuda_events": score_ms, "crop_ms_cuda_events": crop_ms,
              "tracks_per_frame": n_tracks,
              "candidates_per_frame": [int(c[0][-1].sum()) for c in calls],
              "card_vs_cpu_frame": TRACK_CPU_FRAME,
              "card_vs_cpu_max_abs_err": {"scores": err[0], "refined_boxes": err[1]},
              "tolerance": {"scores": TRACK_CPU_TOL[0], "refined_boxes": TRACK_CPU_TOL[1]}})
        if len(calls) != len(order) or err[0] > TRACK_CPU_TOL[0] or err[1] > TRACK_CPU_TOL[1]:
            raise AssertionError(f"track tracker: {len(calls)} calls over {len(order)} frames, "
                                 f"card vs CPU {err}")
        return det_rows
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(base, ignore_errors=True)


# phase nusc: nuScenes-format data through the port's create_data, then the
# two nuScenes CenterPoint experiments as written. 2 scenes of 4 key frames,
# each after 9 sweeps, 30000 points a sweep within ±54 m.
NUSC_DIR = "playground/detection.3d/nuscenes/centerpoint"
NUSC_VOXEL = "centerpoint.nusc.voxelnet.cbgs.20e"
NUSC_PILLAR = "centerpoint.pillar.nusc_mini.1sweep"
NUSC_VERSION = "v1.0-trainval"
NUSC_SCENES, NUSC_KEYS, NUSC_SWEEPS, NUSC_POINTS = 2, 4, 9, 30000
NUSC_ITERS = 4
NUSC_CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                "motorcycle", "bicycle", "pedestrian", "traffic_cone"]
# (category, attribute, size w, l, h, instances a scene): every detection class
NUSC_OBJECTS = (("vehicle.car", "vehicle.moving", (1.9, 4.6, 1.7), 6),
                ("vehicle.truck", "vehicle.parked", (2.5, 6.9, 2.8), 2),
                ("vehicle.construction", "vehicle.parked", (2.8, 6.4, 3.2), 1),
                ("vehicle.bus.rigid", "vehicle.moving", (2.9, 11.0, 3.5), 1),
                ("vehicle.trailer", "vehicle.parked", (2.3, 10.0, 3.8), 1),
                ("movable_object.barrier", None, (2.5, 0.5, 1.0), 3),
                ("vehicle.motorcycle", "cycle.with_rider", (0.8, 2.1, 1.5), 2),
                ("vehicle.bicycle", "cycle.without_rider", (0.6, 1.7, 1.3), 2),
                ("human.pedestrian.adult", "pedestrian.moving", (0.7, 0.7, 1.8), 4),
                ("movable_object.trafficcone", None, (0.4, 0.4, 1.1), 3))
NUSC_DB_CROPS = 8  # GT-database crops a class
NO_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}  # PillarNet runs no sparse conv


def _quat_yaw(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def write_nuscenes(root, n_points=NUSC_POINTS, pc=54.0, seed=5):
    """nuScenes' on-disk format: the v1.0 JSON tables and `samples/` /
    `sweeps/` LIDAR_TOP `.bin` files of 5 float32 columns (`lidar_frames`
    clouds). Per scene NUSC_KEYS key frames 0.5 s apart, each after
    NUSC_SWEEPS sweeps 0.05 s apart on one sample_data chain; NUSC_OBJECTS'
    instances moving through the key frames (prev / next links for the
    velocities, attributes), poses advancing along the scene."""
    rs = np.random.RandomState(seed)
    tabs = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
                            "sample_annotation", "instance", "category", "attribute")}
    cats = [c for c, _, _, _ in NUSC_OBJECTS]
    attrs = sorted({a for _, a, _, _ in NUSC_OBJECTS if a})
    tabs["category"] = [dict(token=f"cat{i}", name=n) for i, n in enumerate(cats)]
    tabs["attribute"] = [dict(token=f"attr{i}", name=n) for i, n in enumerate(attrs)]
    for d in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP", NUSC_VERSION):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for s in range(NUSC_SCENES):
        keys = [f"s{s}_{k}" for k in range(NUSC_KEYS)]
        tabs["scene"].append(dict(token=f"sc{s}", name=f"scene-{s + 1:04d}",
                                  first_sample_token=keys[0], last_sample_token=keys[-1]))
        insts = []
        for cat, attr, size, count in NUSC_OBJECTS:
            for _ in range(count):
                tok = f"in{s}_{len(insts)}"
                tabs["instance"].append(dict(token=tok, category_token=f"cat{cats.index(cat)}"))
                insts.append((tok, attr, size, rs.uniform(-0.8 * pc, 0.8 * pc, 2),
                              rs.uniform(-3, 3, 2) * (attr in ("vehicle.moving", "cycle.with_rider",
                                                               "pedestrian.moving")),
                              rs.uniform(-np.pi, np.pi)))
        chain = []
        for k, key in enumerate(keys):
            tk = 1_500_000_000_000_000 + s * 100_000_000 + k * 500_000
            chain += [(f"sd{s}_{k}_{j}", key, False, tk - (NUSC_SWEEPS - j) * 50_000)
                      for j in range(NUSC_SWEEPS)]
            chain.append((f"sd{s}_{k}_key", key, True, tk))
            tabs["sample"].append(dict(
                token=key, scene_token=f"sc{s}", timestamp=tk,
                prev=keys[k - 1] if k else "", next=keys[k + 1] if k + 1 < NUSC_KEYS else "",
                anns=[f"a{s}_{k}_{o}" for o in range(len(insts))]))
            for o, (tok, attr, size, start, vel, yaw) in enumerate(insts):
                xy = start + vel * 0.5 * k
                tabs["sample_annotation"].append(dict(
                    token=f"a{s}_{k}_{o}", sample_token=key, instance_token=tok,
                    translation=[float(xy[0]), float(xy[1]), 1.0], size=list(size),
                    rotation=_quat_yaw(yaw), prev=f"a{s}_{k - 1}_{o}" if k else "",
                    next=f"a{s}_{k + 1}_{o}" if k + 1 < NUSC_KEYS else "",
                    attribute_tokens=[f"attr{attrs.index(attr)}"] if attr else []))
        for i, (tok, key, is_key, ts) in enumerate(chain):
            fname = f"{'samples' if is_key else 'sweeps'}/LIDAR_TOP/{tok}.pcd.bin"
            lidar_frames(n_points, 1, seed * 1000 + s * 100 + i, pc=pc)["points"][0].tofile(
                os.path.join(root, fname))
            tabs["sample_data"].append(dict(
                token=tok, sample_token=key, filename=fname, is_key_frame=is_key, timestamp=ts,
                channel="LIDAR_TOP", calibrated_sensor_token=f"cs{s}_{i}",
                ego_pose_token=f"ep{s}_{i}", prev=chain[i - 1][0] if i else "",
                next=chain[i + 1][0] if i + 1 < len(chain) else ""))
            tabs["ego_pose"].append(dict(token=f"ep{s}_{i}", rotation=_quat_yaw(0.01 * i),
                                         translation=[0.5 * i, 0.05 * i, 0.0]))
            tabs["calibrated_sensor"].append(dict(token=f"cs{s}_{i}", rotation=_quat_yaw(0.0),
                                                  translation=[0.9, 0.0, 1.8]))
    for name, rows in tabs.items():
        with open(os.path.join(root, NUSC_VERSION, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)


def prepare_nuscenes(root, n_points=NUSC_POINTS, pc=54.0):
    """The fixture dataset: the tables and clouds, the infos at 10 and 1
    sweeps through the port's create_data (train and val both hold every
    key frame, as its `main` writes them), and a GT database in the format
    the port's DataBaseSampler reads. Neither package's nuScenes
    preparation writes one: NUSC_DB_CROPS crops a class of 40-150 points
    inside a box of the class's size, at the origin."""
    import pickle

    from efg_tpu_torch.cli.data_preparation.nuscenes import create_data

    write_nuscenes(root, n_points=n_points, pc=pc)
    out = {}
    for ns in (10, 1):
        infos = create_data.build_infos(root, NUSC_VERSION, ns)
        for split in ("train", "val"):
            with open(os.path.join(root, f"infos_{split}_{ns:02d}sweeps_withvelo_filterZero.pkl"),
                      "wb") as fh:
                pickle.dump(infos, fh)
        out[f"infos_{ns:02d}sweeps"] = len(infos)
        out[f"sweeps_per_key_{ns:02d}"] = sorted({len(i["LIDAR_TOP"]["sweeps"]) for i in infos})
    rs = np.random.RandomState(9)
    db = {}
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    for (cat, _, (w, l, h), _), cls in zip(NUSC_OBJECTS, NUSC_CLASSES):
        for i in range(NUSC_DB_CROPS):
            n = int(rs.randint(40, 150))
            pts = np.concatenate([rs.uniform(-0.45, 0.45, (n, 3)) * [l, w, h],
                                  rs.uniform(0, 1, (n, 2))], 1).astype(np.float32)
            path = f"gt_database/{cls}_{i}.bin"
            pts.tofile(os.path.join(root, path))
            box = np.array([*rs.uniform(-0.8 * pc, 0.8 * pc, 2), 1.0, l, w, h,
                            *rs.uniform(-1, 1, 2), rs.uniform(-np.pi, np.pi)], np.float32)
            db.setdefault(cls, []).append(dict(name=cls, path=path, box3d_lidar=box,
                                               num_points_in_gt=n, difficulty=0))
    with open(os.path.join(root, "dbinfos_train_10sweeps_withvelo.pkl"), "wb") as fh:
        pickle.dump(db, fh)
    out["gt_database"] = {k: len(v) for k, v in db.items()}
    return out


def nusc_config(out_root, exp, data_root):
    """The experiment's config.yaml as written, its `dataset.source` and
    `eval_source` written out (the VoxelNet config does not resolve as
    written in either package) and `misc.seed` set, at
    `<out_root>/playground/<its path>`."""
    import yaml

    with open(os.path.join(HERE, NUSC_DIR, exp, "config.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("includes")
    ns = cfg["dataset"]["nsweeps"]
    cfg["dataset"]["source"] = cfg["dataset"]["eval_source"] = {
        "root": data_root, "train": f"/infos_train_{ns:02d}sweeps_withvelo_filterZero.pkl",
        "val": f"/infos_val_{ns:02d}sweeps_withvelo_filterZero.pkl",
        "gt_database": "/dbinfos_train_10sweeps_withvelo.pkl"}
    cfg["misc"] = {"seed": 0}
    path = os.path.join(out_root, NUSC_DIR, exp, "config.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


# a perfect detector's AP under the evaluator's normalisation: mean(prec −
# 0.1) / 0.9 over its 90 recall points of precision 1 (1 + 4.4e-16 in f64)
NUSC_PERFECT_AP = float(np.clip(np.ones(90) - 0.1, 0, None).mean() / 0.9)


def phase_nusc(card: str, device="cuda", n_points=NUSC_POINTS, pc=54.0, small=(),
               small_pillar=()):
    """The nuScenes CenterPoint experiments on nuScenes-format data written
    through the port's create_data, output under a temporary EFG_CACHE_DIR:
    1. the data (`prepare_nuscenes`): 8 key frames of 10 sweeps, infos at
       10 and 1 sweeps, a GT database of every class;
    2. centerpoint.nusc.voxelnet.cbgs.20e as written (10 sweeps, CBGS:
       its train list resampled past the 8 key frames, DatabaseSampling first, PadPoints 300000, grid 1440×1440×41, caps
       90k/60k/35k/30k, a 6-task head with velocity; bs 4, 2 loader
       threads), task=train for NUSC_ITERS iterations: launches 12/21/21/0
       a step, finite losses, the loop step and iteration, peak memory; its
       first step's rank, forward and stacked calls through the kernels
       against their plain versions;
    3. its task=val through nuScenesDetEvaluator: (8, 21) a batch, the eval
       step a batch, val frames/s, finite nusc/NDS;
    4. centerpoint.pillar.nusc_mini.1sweep as written (bs 2, 60000 points,
       512×512 pillars): task=train for NUSC_ITERS iterations and task=val,
       no sparse kernel launched, peak memory;
    5. the val items' GT boxes as predictions through nuScenesDetEvaluator:
       nusc/mAP the evaluator's perfect score exactly (NUSC_PERFECT_AP),
       mATE = mASE = mAOE = mAVE = 0.
    Returns the kernel rows `*@nusc`. `small` / `small_pillar` overrides
    shrink the runs for a rehearsal on the CPU."""
    from types import SimpleNamespace

    import torch

    from efg_tpu_torch.cli.main import experiment_relpath
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.data import build_dataset
    from efg_tpu_torch.evaluator.nuscenes_evaluator import nuScenesDetEvaluator

    base = tempfile.mkdtemp(prefix="chip_smoke_nusc_")
    old_cache = os.environ.get("EFG_CACHE_DIR")
    os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")
    try:
        root = os.path.join(base, "nuscenes")
        t0 = time.perf_counter()
        prepared = prepare_nuscenes(root, n_points=n_points, pc=pc)
        emit({"phase": "nusc", "part": "data", "card": card,
              "prepare_s": time.perf_counter() - t0, "points_per_sweep": n_points,
              "prepared": prepared, "gt_database": "written by chip_smoke (neither package's "
              "nuScenes preparation writes one), in the port's DataBaseSampler format"})
        if prepared["sweeps_per_key_10"] != [NUSC_SWEEPS]:
            raise AssertionError(f"nusc: sweeps per key frame {prepared}")
        frames = NUSC_SCENES * NUSC_KEYS
        rows = []
        for exp, opts in ((NUSC_VOXEL, list(small)), (NUSC_PILLAR, list(small_pillar))):
            config = nusc_config(os.path.join(base, "exp"), exp, root)
            cfg = Configuration(config_file=config, opts=["task=train", *opts]).get_config()
            bs = int(cfg.dataloader.batch_size)
            cbgs, n_train = bool(cfg.dataset.cbgs), len(build_dataset(cfg))
            if (n_train > frames) != cbgs:
                raise AssertionError(f"nusc {exp}: cbgs {cbgs}, {n_train} train infos from "
                                     f"{frames} key frames")
            out_dir = os.path.join(base, "cache", "EFG_torch", experiment_relpath(config))
            os.makedirs(out_dir, exist_ok=True)
            argv = ["task=train", "trainer.evaluators=",
                    f"solver.lr_scheduler.max_iters={NUSC_ITERS}", "trainer.log_interval=1",
                    "trainer.window_size=1", "trainer.checkpoint_epoch=1000", *opts]
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            with FirstStepCapture() as first:
                records, counts, probe = _engine_run(argv, out_dir, device, config=config)
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
            run = _losses(records, f"nusc {exp}")
            voxel = exp == NUSC_VOXEL
            expected = _steps_of(TRAIN_LAUNCHES if voxel else NO_LAUNCHES, NUSC_ITERS)
            emit({"phase": "nusc", "part": "train", "experiment": exp, "card": card,
                  "batch_size": bs, "cbgs": cbgs, "train_infos": n_train, "key_frames": frames,
                  "iterations": sorted(run),
                  "losses": {i: {k: r[k] for k in ("loss", "0_hm_loss", "0_loc_loss",
                                                    "grad_norm")} for i, r in run.items()},
                  "positives_per_task": {i: [r[f"{t}_num_positive"] for t in range(6)]
                                         for i, r in run.items()},
                  "iteration_time_ms": [1e3 * r["time"] for r in records if "time" in r],
                  "loop_step_ms_cuda_events": probe.step_ms() if device == "cuda" else None,
                  "data_time_ms": [1e3 * t for t in probe.data_s], "peak_mem_gb": peak,
                  "launches": counts, "launches_expected": expected})
            if sorted(run) != list(range(1, NUSC_ITERS + 1)) or counts != expected:
                raise AssertionError(f"nusc {exp}: records {sorted(run)}, launches {counts}, "
                                     f"expected {expected}")
            if voxel:
                per = (f"sum over the calls of the first bs={bs} training step of {NUSC_VOXEL} "
                       "as written (10 sweeps, CBGS, DatabaseSampling) through the CLI, {}; "
                       f"launches over its {NUSC_ITERS} steps")
                rows = first_step_kernels("nusc", first.forward, first.backward, card, counts,
                                          per, device)
            elif first.forward is not None and (first.forward.gemm or first.backward.rank):
                raise AssertionError("nusc pillar: a sparse kernel wrapper was called")
            del first

            argv = ["task=val", *opts]
            vcfg = Configuration(config_file=config, opts=argv).get_config()
            counts, vprobe = _cli_eval_run(argv, device, config=config)
            n_batches = -(-frames // int(vcfg.dataloader.batch_size))
            expected = _steps_of(SERVE_LAUNCHES if voxel else NO_LAUNCHES, n_batches)
            (_, res, evaluate_s), = vprobe.evaluations
            emit({"phase": "nusc", "part": "val", "experiment": exp, "card": card,
                  "frames": frames, "batch_size": int(vcfg.dataloader.batch_size),
                  "weights": "trained (model_final)",
                  "eval_step_ms_cuda_events": vprobe.step_ms() if device == "cuda" else None,
                  "data_ms": [1e3 * d for d in vprobe.data_s],
                  "evaluator_process_ms": [1e3 * d for d in vprobe.process_s],
                  "evaluator_evaluate_ms": [1e3 * d for d in vprobe.evaluator_s],
                  "evaluate_s": evaluate_s, "val_frames_per_s": frames / evaluate_s,
                  "results": res, "launches": counts, "launches_expected": expected})
            if len(vprobe.step_events) != n_batches or counts != expected or \
                    len(res) != len(NUSC_CLASSES) + 7 or not np.isfinite(res["nusc/NDS"]):
                raise AssertionError(f"nusc {exp} val: {len(vprobe.step_events)} batches, "
                                     f"launches {counts}, expected {n_batches} and {expected}; "
                                     f"results {res}")

        # 5. GT boxes as predictions
        vcfg = Configuration(config_file=nusc_config(os.path.join(base, "exp"), NUSC_VOXEL, root),
                             opts=["task=val", *small]).get_config()
        ds = build_dataset(vcfg)
        ev = nuScenesDetEvaluator(SimpleNamespace(dataset=SimpleNamespace(
            classes=NUSC_CLASSES)), ds)
        n_gt = 0
        for i in range(len(ds)):
            anno = ds[i][1]["annotations"]
            n = len(anno["labels"])
            n_gt += n
            ev.process({"annotations": [anno]},
                       {"box3d": anno["gt_boxes"][None], "scores": np.ones((1, n), np.float32),
                        "labels": anno["labels"][None], "valid": np.ones((1, n), bool)})
        res = ev.evaluate()
        errors = {k: res[f"nusc/{k}"] for k in ("mATE", "mASE", "mAOE", "mAVE")}
        emit({"phase": "nusc", "part": "gt_as_predictions", "frames": len(ds), "gt_boxes": n_gt,
              "mAP": res["nusc/mAP"], "perfect_ap": NUSC_PERFECT_AP, **errors,
              "NDS": res["nusc/NDS"], "mAAE": res["nusc/mAAE"]})
        if res["nusc/mAP"] != NUSC_PERFECT_AP or any(v != 0.0 for v in errors.values()) or \
                len(ds) != frames or not n_gt:
            raise AssertionError(f"nusc GT as predictions: {res}")
        return rows
    finally:
        if old_cache is None:
            os.environ.pop("EFG_CACHE_DIR", None)
        else:
            os.environ["EFG_CACHE_DIR"] = old_cache
        shutil.rmtree(base, ignore_errors=True)


DET2D_SYNTH_DIR = "playground/detection.2d/synthetic"
DET2D_SYNTH = ("fcos.synth.res50", "retinanet.synth.res50", "autoassign.synth.res50")
DET2D_COCO = {
    "fcos": "playground/detection.2d/coco/fcos/fcos.res50.fpn.coco.800size.1x",
    "retinanet": "playground/detection.2d/coco/retina_net/retinanet.res50.fpn.coco.multiscale.1x",
    "autoassign": "playground/detection.2d/coco/auto_assign/auto_assign.res50.fpn.coco.800size.1x",
}
DET2D_ITERS = 4  # full-width training iterations of each COCO config
DET2D_SIZES = ((480, 640), (640, 480), (427, 640))  # (h, w) of the fixture's images, in turn
DET2D_TRAIN, DET2D_VAL = 12, 8  # fixture images a split
DET2D_SEED = 21
DET2D_CHECK = (2, 256, 384)  # card vs CPU: batch, height, width
DET2D_CHECK_TOL = 1e-4  # of each output's max: f32 convs with TF32 off, summation order
DET2D_TIMED = 5  # timed runs of each eval-step part
# headline keys of a COCO result; the area-range ones are NaN where the
# val split holds no GT of that size
DET2D_KEYS = ("coco/AP", "coco/AP50", "coco/AP75", "coco/AR1", "coco/AR10", "coco/AR100")
COCO_CATEGORIES = (
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"), (5, "airplane"), (6, "bus"),
    (7, "train"), (8, "truck"), (9, "boat"), (10, "traffic light"), (11, "fire hydrant"),
    (13, "stop sign"), (14, "parking meter"), (15, "bench"), (16, "bird"), (17, "cat"),
    (18, "dog"), (19, "horse"), (20, "sheep"), (21, "cow"), (22, "elephant"), (23, "bear"),
    (24, "zebra"), (25, "giraffe"), (27, "backpack"), (28, "umbrella"), (31, "handbag"),
    (32, "tie"), (33, "suitcase"), (34, "frisbee"), (35, "skis"), (36, "snowboard"),
    (37, "sports ball"), (38, "kite"), (39, "baseball bat"), (40, "baseball glove"),
    (41, "skateboard"), (42, "surfboard"), (43, "tennis racket"), (44, "bottle"),
    (46, "wine glass"), (47, "cup"), (48, "fork"), (49, "knife"), (50, "spoon"), (51, "bowl"),
    (52, "banana"), (53, "apple"), (54, "sandwich"), (55, "orange"), (56, "broccoli"),
    (57, "carrot"), (58, "hot dog"), (59, "pizza"), (60, "donut"), (61, "cake"), (62, "chair"),
    (63, "couch"), (64, "potted plant"), (65, "bed"), (67, "dining table"), (70, "toilet"),
    (72, "tv"), (73, "laptop"), (74, "mouse"), (75, "remote"), (76, "keyboard"),
    (77, "cell phone"), (78, "microwave"), (79, "oven"), (80, "toaster"), (81, "sink"),
    (82, "refrigerator"), (84, "book"), (85, "clock"), (86, "vase"), (87, "scissors"),
    (88, "teddy bear"), (89, "hair drier"), (90, "toothbrush"),
)


def write_coco_fixture(root, seed=DET2D_SEED, n_train=DET2D_TRAIN, n_val=DET2D_VAL,
                       sizes=DET2D_SIZES):
    """A COCO 2017-format dataset under `root`: `train2017/` and `val2017/`
    PNG images (cv2) in turn of `sizes`, each with 1-20 boxes of random
    categories among the 80 (real, gapped ids), about one in eight
    `iscrowd`, and `annotations/instances_{train,val}2017.json`."""
    import cv2

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = [dict(id=c, name=n, supercategory="thing") for c, n in COCO_CATEGORIES]
    for split, n_images in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, f"{split}2017"), exist_ok=True)
        images, anns = [], []
        for i in range(n_images):
            h, w = sizes[i % len(sizes)]
            img_id = 100000 * (split == "val") + 37 * i + 9
            name = f"{img_id:012d}.png"
            pixels = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(rs.randint(1, 21)):
                bw, bh = rs.uniform(16, w * 0.5), rs.uniform(16, h * 0.5)
                x, y = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
                pixels[int(y):int(y + bh), int(x):int(x + bw)] = rs.randint(0, 256, 3)
                anns.append(dict(id=len(anns) + 1, image_id=img_id,
                                 category_id=COCO_CATEGORIES[rs.randint(80)][0],
                                 bbox=[float(x), float(y), float(bw), float(bh)],
                                 area=float(bw * bh), iscrowd=int(rs.rand() < 0.125)))
            if not cv2.imwrite(os.path.join(root, f"{split}2017", name), pixels):
                raise OSError(f"cv2 could not write {name}")
            images.append(dict(id=img_id, file_name=name, height=h, width=w))
        with open(os.path.join(root, "annotations", f"instances_{split}2017.json"), "w") as fh:
            json.dump(dict(images=images, annotations=anns, categories=cats), fh)


def _calibrate_bn(sd, images):
    """Set each BN's running statistics in the torchvision state dict `sd`
    to the per-channel mean and variance of its input on `images`, in
    forward order (the port's FrozenBN ResNet-50 runs `sd`), so that the
    trunk maps them to unit-scale channels as a pretrained one does."""
    import torch

    from efg_tpu_torch.modeling.backbones.resnet import FrozenBatchNorm, ResNet
    from efg_tpu_torch.utils import torch_import as TI

    net = ResNet(depth=50, freeze_at=0)
    TI.import_torchvision_resnet({k: v.numpy() for k, v in sd.items()}, net, "")

    def measure(mod, args):
        x = args[0]
        mod.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(measure) for m in net.modules()
             if isinstance(m, FrozenBatchNorm)]
    with torch.no_grad():
        net(images)
    for h in hooks:
        h.remove()
    state = net.state_dict()
    for k in sd:
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("running_mean", "running_var"):
            sd[k] = state[f"{TI._resnet_rename(k)}.{leaf}"].clone()


def fixture_images(root, n=4, size=(384, 512), mean=(103.53, 116.28, 123.675), std=(1.0, 1.0, 1.0)):
    """The first `n` train images of the fixture at `root`, resized to
    `size` (h, w) and normalised as a config's NormalizeImage does ((BGR −
    mean) / std; the default the detection configs'): [n, 3, h, w]."""
    import cv2
    import torch

    from efg_tpu_torch.data.image_io import read_image

    names = sorted(os.listdir(os.path.join(root, "train2017")))[:n]
    mean, std = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    imgs = [(cv2.resize(read_image(os.path.join(root, "train2017", f)), size[::-1],
                        interpolation=cv2.INTER_LINEAR) - mean) / std for f in names]
    return torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).contiguous()


def torchvision_resnet50(path, images, seed=DET2D_SEED):
    """A torchvision-format ResNet-50 state dict (conv1 / bn1, layer1-4 with
    downsample.0 / .1, fc; num_batches_tracked included) written by
    torch.save: seeded He-normal convs, BN scales near 1, and BN
    statistics measured on `images` (`_calibrate_bn`), as a pretrained
    checkpoint's are measured on its data (with statistics of 0 and 1, or
    of other data, the FrozenBN trunk grows its activations block by
    block). Returns its tensor count."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g) * (2.0 / (i * k * k)) ** 0.5

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=g) * 0.4 + 0.8
        sd[f"{name}.bias"] = torch.randn(c, generator=g) * 0.05
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g) * 0.05
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) * 0.5 + 1.0
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, n in enumerate((3, 4, 6, 3)):
        width = 64 * 2**s
        for b in range(n):
            pre = f"layer{s + 1}.{b}"
            conv(f"{pre}.conv1", width, cin, 1)
            bn(f"{pre}.bn1", width)
            conv(f"{pre}.conv2", width, width, 3)
            bn(f"{pre}.bn2", width)
            conv(f"{pre}.conv3", width * 4, width, 1)
            bn(f"{pre}.bn3", width * 4)
            if b == 0:
                conv(f"{pre}.downsample.0", width * 4, cin, 1)
                bn(f"{pre}.downsample.1", width * 4)
            cin = width * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    _calibrate_bn(sd, images)
    torch.save(sd, path)
    return len(sd)


def _coco_headline(label, res):
    """The headline COCO keys present and finite, each in [0, 1]."""
    bad = {k: res.get(k) for k in DET2D_KEYS
           if k not in res or not np.isfinite(res[k]) or not 0.0 <= res[k] <= 1.0}
    if bad:
        raise AssertionError(f"{label}: results {bad} of {res}")


def _perfect_2d(batches):
    """Each val image's non-crowd GT as the eval step's fixed-shape
    detections (boxes in the resized frame, as predict's)."""
    out = []
    for inputs in batches:
        annos = inputs["annotations"]
        k = max(1, max(int((a["iscrowd"] == 0).sum()) for a in annos))
        det = dict(boxes=np.zeros((len(annos), k, 4), np.float32),
                   scores=np.zeros((len(annos), k), np.float32),
                   labels=np.full((len(annos), k), -1, np.int64),
                   valid=np.zeros((len(annos), k), bool))
        for i, a in enumerate(annos):
            keep = a["iscrowd"] == 0
            n = int(keep.sum())
            det["boxes"][i, :n] = a["boxes2d"][keep]
            det["scores"][i, :n] = 0.9
            det["labels"][i, :n] = a["classes"][keep]
            det["valid"][i, :n] = True
        out.append(det)
    return out


def _fcos_parts_ms(md, batch):
    """The FCOS eval step on `batch` by CUDA events (DET2D_TIMED runs after
    a warm-up), whole and in parts: backbone + FPN, head (with the
    flattening), decode + NMS."""
    import torch

    from efg_tpu_torch.engine.trainer import eval_step

    m = md.module
    m.eval()
    images = batch["images"]
    with torch.inference_mode():
        levels = m.levels(images)
        preds = m(images)
        parts = {
            "eval_step": _event_ms(lambda: eval_step(md, batch), DET2D_TIMED),
            "backbone_fpn": _event_ms(lambda: m.levels(images), DET2D_TIMED),
            "head": _event_ms(lambda: m.head(levels), DET2D_TIMED),
            "forward": _event_ms(lambda: m(images), DET2D_TIMED),
            "decode_nms": _event_ms(lambda: md.predict_fn(preds, batch), DET2D_TIMED),
        }
    return {k: {"median": float(np.median(v)), "runs": v} for k, v in parts.items()}


def _det2d_card_vs_cpu(card):
    """One FCOS (R-50) forward at DET2D_CHECK on the card and on the CPU
    from the same seeded weights: logits, deltas and centerness within
    DET2D_CHECK_TOL of each one's max; `predict` on the CPU's predictions,
    on both devices, keeps the same detections (valid flags and labels
    equal, boxes and scores within 1e-5 of their max)."""
    import torch

    from efg_tpu_torch.models import fcos as F

    bsz, h, w = DET2D_CHECK
    images = torch.from_numpy(np.random.RandomState(DET2D_SEED).uniform(
        -120, 140, (bsz, h, w, 3)).astype(np.float32))
    out, models = {}, {}
    for dev in ("cpu", "cuda"):
        models[dev] = F.FCOS(num_classes=80, depth=50, device=dev,
                             generator=torch.Generator().manual_seed(DET2D_SEED))
        models[dev].eval()
        with torch.inference_mode():
            out[dev] = models[dev](images.to(dev))
    errs = {}
    for k in ("logits", "deltas", "centerness"):
        want = out["cpu"][k].double()
        scale = max(float(want.abs().max()), 1e-6)
        errs[k] = float((out["cuda"][k].cpu().double() - want).abs().max()) / scale
    cfg = dict(num_classes=80, fpn_strides=[8, 16, 32, 64, 128])
    with torch.inference_mode():
        det = {d: F.predict({k: (v.to(d) if torch.is_tensor(v) else v)
                             for k, v in out["cpu"].items()}, model_cfg=cfg)
               for d in ("cpu", "cuda")}
    got = {k: v.cpu() for k, v in det["cuda"].items()}
    same_keep = bool(torch.equal(got["valid"], det["cpu"]["valid"])
                     and torch.equal(got["labels"], det["cpu"]["labels"]))
    box_err = float((got["boxes"] - det["cpu"]["boxes"]).abs().max()) / max(
        float(det["cpu"]["boxes"].abs().max()), 1e-6)
    with torch.inference_mode():  # the card's own predictions, for the record
        own = {k: v.cpu() for k, v in F.predict(out["cuda"], model_cfg=cfg).items()}
    emit({"phase": "det2d", "part": "check", "card": card, "shape": list(DET2D_CHECK),
          "rel_err": errs, "tol": DET2D_CHECK_TOL, "kept": int(got["valid"].sum()),
          "keep_sets_equal": same_keep, "box_rel_err": box_err,
          "own_outputs_keep_sets_equal": bool(torch.equal(own["valid"], det["cpu"]["valid"])
                                              and torch.equal(own["labels"], det["cpu"]["labels"]))})
    if max(errs.values()) > DET2D_CHECK_TOL or not same_keep or box_err > 1e-5 \
            or int(got["valid"].sum()) == 0:
        raise AssertionError(f"det2d check: rel errs {errs}, keep sets equal {same_keep}, "
                             f"box err {box_err}")


def phase_det2d(card: str, device="cuda", synth=(), small_coco=()):
    """2D detection through the CLI, output under a temporary
    EFG_CACHE_DIR:
    (a) the three synthetic experiments as written (R-50, bs 2, 256×256):
        task=train (20 iterations), then task=val through COCOEvaluator
        (the headline results finite);
    (b) the three COCO configs as written (R-50, bs 2, 800×1344 canvas,
        two loader threads) on a COCO-format fixture this phase writes
        (`write_coco_fixture`; the data root by the dotlist
        detection.source.local.root, EFG_PATH at this checkout for the
        configs' gallery include), `model.weights` a seeded torchvision
        R-50 .pth imported by the default `resnet` format: task=train
        DET2D_ITERS iterations (the loop's train_step by CUDA events,
        IterTimer's time, the prefetcher's next, peak memory), task=val
        (eval step ms, val frames/s); FCOS's eval step at bs 1 and 2 by
        CUDA events, whole and split into backbone + FPN, head, and
        decode + NMS; the val images' GT as detections through
        COCOEvaluator read AP = AP50 = AP75 = 1 exactly;
    (c) one FCOS forward and predict on the card against the CPU
        (`_det2d_card_vs_cpu`), and the sparse kernels' launch counters,
        which no 2D path reaches, 0 over the phase.
    `synth` and `small_coco` cut the runs for a rehearsal on the CPU."""
    import torch

    from efg_tpu_torch.cli.main import experiment_relpath, load_experiment_module
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.evaluator.coco_evaluator import COCOEvaluator
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    base = tempfile.mkdtemp(prefix="chip_smoke_det2d_")
    old_env = {k: os.environ.get(k) for k in ("EFG_CACHE_DIR", "EFG_PATH")}
    os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")
    os.environ["EFG_PATH"] = HERE  # the COCO configs include the dataset gallery by it
    launches = {}

    def count(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def out_dir_of(config):
        d = os.path.join(base, "cache", "EFG_torch", experiment_relpath(os.path.join(HERE, config)))
        os.makedirs(d, exist_ok=True)
        return d

    logs = ["trainer.log_interval=1", "trainer.window_size=1"]
    try:
        # (a) the synthetic experiments as written
        for exp in DET2D_SYNTH:
            config = os.path.join(DET2D_SYNTH_DIR, exp, "config.yaml")
            records, counts, probe = _engine_run(["task=train", "trainer.evaluators=", *logs,
                                                  *synth], out_dir_of(config), device,
                                                 config=config)
            run = _losses(records, f"det2d {exp}")
            count(counts)
            counts_val, vprobe = _cli_eval_run(["task=val", *synth], device, config=config)
            count(counts_val)
            (_, res, evaluate_s), = vprobe.evaluations
            _coco_headline(f"det2d {exp} val", res)
            emit({"phase": "det2d", "part": "synthetic", "experiment": exp, "card": card,
                  "iterations": sorted(run), "losses": {i: r["loss"] for i, r in run.items()},
                  "loop_step_ms_cuda_events": probe.step_ms(),
                  "val_frames": sum(len(b["annotations"]) for b in vprobe.batches),
                  "eval_step_ms_cuda_events": vprobe.step_ms(), "evaluate_s": evaluate_s,
                  "results": res})

        # (b) the COCO configs at full width
        root = os.path.join(base, "coco")
        write_coco_fixture(root)
        weights = os.path.join(base, "R-50.pth")
        n_tensors = torchvision_resnet50(weights, fixture_images(root))
        common = [f"detection.source.local.root={root}", f"model.weights={weights}", *small_coco]
        for name, exp in DET2D_COCO.items():
            config = os.path.join(exp, "config.yaml")
            out_dir = out_dir_of(config)
            argv = ["task=train", "trainer.evaluators=", *logs,
                    f"solver.lr_scheduler.max_iters={DET2D_ITERS}", *common]
            cfg = Configuration(config_file=os.path.join(HERE, config), opts=argv).get_config()
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            records, counts, probe = _engine_run(argv, out_dir, device, config=config)
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
            count(counts)
            run = _losses(records, f"det2d coco {name}")
            with open(os.path.join(out_dir, "log.txt.rank0")) as fh:
                imported = re.findall(r"Imported (\d+) tensors from .*skipped (\d+)", fh.read())
            # every tensor but fc's 2 and the 53 num_batches_tracked lands
            if imported != [(str(n_tensors - 2 - 53), "53")] or sorted(run) != list(
                    range(1, DET2D_ITERS + 1)):
                raise AssertionError(f"det2d coco {name}: import {imported}, records {sorted(run)}")
            pad = cfg.dataset.processors.train[-1]["PadImage"]
            emit({"phase": "det2d", "part": "coco_train", "model": name, "card": card,
                  "batch_size": int(cfg.dataloader.batch_size),
                  "canvas": [int(pad["height"]), int(pad["width"])],
                  "num_workers": int(cfg.dataloader.num_workers),
                  "imported_tensors": int(imported[0][0]), "iterations": sorted(run),
                  "losses": {i: {k: v for k, v in r.items() if "loss" in k or k == "grad_norm"}
                             for i, r in run.items()},
                  "loop_step_ms_cuda_events": probe.step_ms(),
                  "iteration_time_ms": [1e3 * r["time"] for r in records if "time" in r],
                  "data_time_ms": [1e3 * t for t in probe.data_s], "peak_mem_gb": peak})

            counts_val, vprobe = _cli_eval_run(["task=val", *common], device, config=config)
            count(counts_val)
            (_, res, evaluate_s), = vprobe.evaluations
            n_frames = sum(len(b["annotations"]) for b in vprobe.batches)
            _coco_headline(f"det2d coco {name} val", res)
            emit({"phase": "det2d", "part": "coco_val", "model": name, "card": card,
                  "frames": n_frames, "eval_step_ms_cuda_events": vprobe.step_ms(),
                  "data_ms": [1e3 * d for d in vprobe.data_s],
                  "evaluator_process_ms": [1e3 * d for d in vprobe.process_s],
                  "evaluator_evaluate_ms": [1e3 * d for d in vprobe.evaluator_s],
                  "evaluate_s": evaluate_s, "val_frames_per_s": n_frames / evaluate_s,
                  "results": res})
            if n_frames != DET2D_VAL:
                raise AssertionError(f"det2d coco {name} val: {n_frames} frames")
            if name != "fcos":
                continue

            # the val images' GT as detections: a perfect detector
            vcfg = Configuration(config_file=os.path.join(HERE, config),
                                 opts=["task=val", *common]).get_config()
            perfect = COCOEvaluator(vcfg, type("DS", (), {"class_names": [
                n for _, n in COCO_CATEGORIES]})())
            perfect.reset()
            for inputs, det in zip(vprobe.batches, _perfect_2d(vprobe.batches)):
                perfect.process(inputs, det)
            pres = perfect.evaluate()
            emit({"phase": "det2d", "part": "perfect", "card": card,
                  "results": {k: pres[k] for k in ("coco/AP", "coco/AP50", "coco/AP75")}})
            if not pres["coco/AP"] == pres["coco/AP50"] == pres["coco/AP75"] == 1.0:
                raise AssertionError(f"det2d: perfect detections read {pres}")

            # FCOS's eval step at bs 1 and 2, by parts
            md = load_experiment_module(config).build_model(vcfg, device=device)
            ckpt = torch.load(os.path.join(out_dir, "model_final"), map_location=device,
                              weights_only=True)
            md.module.load_state_dict(ckpt["model"])
            host = vprobe.batches[0]
            timing = {}
            for bsz in (1, 2):
                batch = {k: torch.from_numpy(v[:bsz]).to(device) if isinstance(v, np.ndarray)
                         else v[:bsz] for k, v in host.items()}
                timing[bsz] = _fcos_parts_ms(md, batch)
            emit({"phase": "det2d", "part": "fcos_eval_step", "card": card,
                  "canvas": list(host["images"].shape[1:3]), "ms_cuda_events": timing})
            del md, ckpt

        # (c) card against CPU, and no sparse kernel launched
        K.reset_launches()
        if device == "cuda":
            _det2d_card_vs_cpu(card)
        count(dict(K.launches))
        emit({"phase": "det2d", "part": "launches", "card": card, "launches": launches})
        if any(launches.values()):
            raise AssertionError(f"det2d: sparse kernels launched {launches}")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(base, ignore_errors=True)


PANOPTIC_SYNTH = "playground/panoptic_seg/synthetic/mask2former.synth.res50"
PANOPTIC_COCO = {
    "res50": "playground/panoptic_seg/coco/mask2former/mask2former.pano_coco.res50.bs16.50e",
    "swin_t": "playground/panoptic_seg/coco/mask2former/mask2former.pano_coco.swin_t.bs16.50e",
}
PANOPTIC_GOLDEN = "tests/goldens/mask2former_synth.json"
PANOPTIC_ITERS = 4  # full-width training iterations of each COCO config
PANOPTIC_TRAIN, PANOPTIC_VAL = 8, 6  # fixture images a split
PANOPTIC_SEED = 23
PANOPTIC_CHECK = (1, 256, 384)  # card vs CPU: batch, height, width
PANOPTIC_CHECK_TOL = 1e-4  # of each output's max: f32 with TF32 off, summation order
PANOPTIC_TIMED = 5  # timed runs of each eval-step part
# COCO panoptic's 53 stuff categories (ids 92-200), after its 80 things
COCO_STUFF = (
    (92, "banner"), (93, "blanket"), (95, "bridge"), (100, "cardboard"), (107, "counter"),
    (109, "curtain"), (112, "door-stuff"), (118, "floor-wood"), (119, "flower"), (122, "fruit"),
    (125, "gravel"), (128, "house"), (130, "light"), (133, "mirror-stuff"), (138, "net"),
    (141, "pillow"), (144, "platform"), (145, "playingfield"), (147, "railroad"), (148, "river"),
    (149, "road"), (151, "roof"), (154, "sand"), (155, "sea"), (156, "shelf"), (159, "snow"),
    (161, "stairs"), (166, "tent"), (168, "towel"), (171, "wall-brick"), (175, "wall-stone"),
    (176, "wall-tile"), (177, "wall-wood"), (178, "water-other"), (180, "window-blind"),
    (181, "window-other"), (184, "tree-merged"), (185, "fence-merged"), (186, "ceiling-merged"),
    (187, "sky-other-merged"), (188, "cabinet-merged"), (189, "table-merged"),
    (190, "floor-other-merged"), (191, "pavement-merged"), (192, "mountain-merged"),
    (193, "grass-merged"), (194, "dirt-merged"), (195, "paper-merged"),
    (196, "food-other-merged"), (197, "building-other-merged"), (198, "rock-merged"),
    (199, "wall-other-merged"), (200, "rug-merged"),
)


def write_coco_panoptic_fixture(root, seed=PANOPTIC_SEED, n_train=PANOPTIC_TRAIN,
                                n_val=PANOPTIC_VAL, sizes=DET2D_SIZES):
    """A COCO panoptic 2017-format dataset under `root`: `{split}2017/` PNG
    images, `panoptic_{split}2017/` RGB-id PNGs (id = R + G·256 + B·256²,
    random 24-bit ids), `annotations/instances_{split}2017.json` (the
    things) and `annotations/panoptic_{split}2017.json` (`segments_info`,
    the 133 categories with `isthing`). Each image, in turn of `sizes`:
    2-4 horizontal stuff bands with a void strip, 2-12 thing rectangles
    over them; each split's first image's last thing is a crowd segment.
    Returns the segment count by split."""
    import cv2

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = ([dict(id=c, name=n, isthing=1, supercategory="thing") for c, n in COCO_CATEGORIES]
            + [dict(id=c, name=n, isthing=0, supercategory="stuff") for c, n in COCO_STUFF])
    counts = {}
    for split, n_images in (("train", n_train), ("val", n_val)):
        for d in (f"{split}2017", f"panoptic_{split}2017"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        images, inst, pano = [], [], []
        for i in range(n_images):
            h, w = sizes[i % len(sizes)]
            img_id = 100000 * (split == "val") + 41 * i + 5
            name = f"{img_id:012d}.png"
            ids = np.zeros((h, w), np.int64)
            pixels = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            segs, things = [], []
            cuts = np.sort(rs.choice(np.arange(h // 8, h - h // 8), rs.randint(1, 4), replace=False))
            for k, (y0, y1) in enumerate(zip([0, *cuts], [*cuts, h])):
                sid = int(rs.randint(1, 2 ** 24))
                ids[y0 + (2 if k else 0):y1] = sid  # two void rows under each cut
                segs.append(dict(id=sid, category_id=COCO_STUFF[rs.randint(53)][0], iscrowd=0))
            n_things = rs.randint(2, 13)
            for k in range(n_things):
                bw, bh = int(rs.uniform(16, w * 0.4)), int(rs.uniform(16, h * 0.4))
                x, y = int(rs.uniform(0, w - bw)), int(rs.uniform(0, h - bh))
                sid = int(rs.randint(1, 2 ** 24))
                ids[y:y + bh, x:x + bw] = sid
                pixels[y:y + bh, x:x + bw] = rs.randint(0, 256, 3)
                crowd = int(i == 0 and k == n_things - 1)
                segs.append(dict(id=sid, category_id=COCO_CATEGORIES[rs.randint(80)][0],
                                 iscrowd=crowd))
                things.append(sid)
            kept = []
            for s in segs:  # a segment drawn over whole is gone
                ys, xs = np.nonzero(ids == s["id"])
                if not len(ys):
                    continue
                s["bbox"] = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                             int(ys.max() - ys.min() + 1)]
                s["area"] = int(len(ys))
                kept.append(s)
                if s["id"] in things:
                    inst.append(dict(id=len(inst) + 1, image_id=img_id,
                                     category_id=s["category_id"],
                                     bbox=[float(v) for v in s["bbox"]], area=float(s["area"]),
                                     iscrowd=s["iscrowd"]))
            png = np.stack([ids // 256 ** 2, (ids // 256) % 256, ids % 256], -1).astype(np.uint8)
            for d, arr in ((f"panoptic_{split}2017", png), (f"{split}2017", pixels)):
                if not cv2.imwrite(os.path.join(root, d, name), arr):
                    raise OSError(f"cv2 could not write {d}/{name}")
            images.append(dict(id=img_id, file_name=name, height=h, width=w))
            pano.append(dict(image_id=img_id, file_name=name, segments_info=kept))
        counts[split] = sum(len(p["segments_info"]) for p in pano)
        for kind, body in (("instances", dict(images=images, annotations=inst,
                                              categories=cats[:80])),
                           ("panoptic", dict(images=images, annotations=pano, categories=cats))):
            with open(os.path.join(root, "annotations", f"{kind}_{split}2017.json"), "w") as fh:
                json.dump(body, fh)
    return counts


def mmdet_swin_tiny(path, seed=PANOPTIC_SEED):
    """A Swin-T state dict in the mmdet layout (patch_embed.proj / .norm,
    layers.{i}.blocks.{j}.{norm1, attn.{qkv, proj, relative_position_bias_table,
    relative_position_index}, norm2, mlp.fc1 / fc2}, layers.{i}.downsample.
    {norm, reduction}, norm{i}) of seeded values, written by torch.save:
    linear and conv weights N(0, 1/fan_in), norm scales near 1. Returns its
    tensor count and the count of buffers the import drops."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(name, o, i, bias=True):
        sd[f"{name}.weight"] = torch.randn(o, i, generator=g) / i ** 0.5
        if bias:
            sd[f"{name}.bias"] = torch.randn(o, generator=g) * 0.02

    def norm(name, c):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.bias"] = 0.02 * torch.randn(c, generator=g)

    sd["patch_embed.proj.weight"] = torch.randn(96, 3, 4, 4, generator=g) / 48 ** 0.5
    sd["patch_embed.proj.bias"] = torch.zeros(96)
    norm("patch_embed.norm", 96)
    dim, dropped = 96, 0
    for i, (depth, heads) in enumerate(zip((2, 2, 6, 2), (3, 6, 12, 24))):
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            norm(f"{p}.norm1", dim)
            lin(f"{p}.attn.qkv", 3 * dim, dim)
            lin(f"{p}.attn.proj", dim, dim)
            sd[f"{p}.attn.relative_position_bias_table"] = 0.02 * torch.randn(169, heads, generator=g)
            sd[f"{p}.attn.relative_position_index"] = torch.zeros(49, 49, dtype=torch.long)
            dropped += 1
            norm(f"{p}.norm2", dim)
            lin(f"{p}.mlp.fc1", 4 * dim, dim)
            lin(f"{p}.mlp.fc2", dim, 4 * dim)
        norm(f"norm{i}", dim)
        if i < 3:
            norm(f"layers.{i}.downsample.norm", 4 * dim)
            lin(f"layers.{i}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            dim *= 2
    torch.save(sd, path)
    return len(sd), dropped


def _panoptic_results(label, res):
    keys = {"panoptic/PQ", "panoptic/SQ", "panoptic/RQ", "panoptic/n_categories"}
    if set(res) != keys or not all(0.0 <= res[f"panoptic/{k}"] <= 1.0 for k in ("PQ", "SQ", "RQ")):
        raise AssertionError(f"{label}: results {res}")


def _m2f_parts_ms(md, batch):
    """The Mask2Former eval step on `batch` by CUDA events (PANOPTIC_TIMED
    runs after a warm-up), whole and in parts: backbone, pixel decoder,
    transformer decoder (with the heads), predict."""
    import torch

    from efg_tpu_torch.engine.trainer import eval_step

    m = md.module
    m.eval()
    images = batch["images"]
    with torch.inference_mode():
        feats = m.features(images)
        mask_features, scales = m.pixel_decoder(feats)
        preds = m.decode(mask_features, scales)
        parts = {
            "eval_step": _event_ms(lambda: eval_step(md, batch), PANOPTIC_TIMED),
            "backbone": _event_ms(lambda: m.features(images), PANOPTIC_TIMED),
            "pixel_decoder": _event_ms(lambda: m.pixel_decoder(feats), PANOPTIC_TIMED),
            "transformer_decoder": _event_ms(lambda: m.decode(mask_features, scales),
                                             PANOPTIC_TIMED),
            "predict": _event_ms(lambda: md.predict_fn(preds, batch), PANOPTIC_TIMED),
        }
    return {k: {"median": float(np.median(v)), "runs": v} for k, v in parts.items()}


def _m2f_step_profile(trainer, card: str, name: str):
    """One training step of a COCO panoptic config's trainer (after a
    warm-up step, on a batch from its own loader) under torch.profiler,
    split into the trunk, the pixel decoder, the transformer decoder, the
    loss (matcher and criterion), the backward and the optimizer, each
    ended by a device synchronization (`profile_parts`). The profiler adds
    host time a launch, so its idle shares bound the plain step's from
    above."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from efg_tpu_torch.engine.trainer import _train_mode, apply_grads, step_generator, train_step

    md, state, tx = trainer.model_def, trainer.state, trainer.tx
    dev = trainer.device
    host = next(iter(trainer.dataloader))
    batch = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
             for k, v in host.items()}
    train_step(md, tx, state, batch)
    torch.cuda.synchronize()

    def part(label, fn):
        with record_function(f"part:{label}"):
            out = fn()
            torch.cuda.synchronize()
        return out

    m = _train_mode(state)
    gen = step_generator(0, state.step, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        feats = part("backbone", lambda: m.features(batch["images"], gen))
        mf, scales = part("pixel_decoder", lambda: m.pixel_decoder(feats))
        preds = part("transformer_decoder", lambda: m.decode(mf, scales))
        losses = part("loss", lambda: md.loss_fn(preds, batch,
                                                 rng=step_generator(0, state.step, dev, 1)))
        part("backward", lambda: losses["loss"].backward())
        part("optimizer", lambda: apply_grads(tx, state))
    emit({"phase": "panoptic", "part": "train_profile", "model": name, "card": card,
          "batch_size": int(batch["images"].shape[0]),
          "canvas": list(batch["images"].shape[1:3]), **profile_parts(prof)})


def _m2f_card_vs_cpu(card, devices=("cpu", "cuda")):
    """One Mask2Former forward (R-50, d_model 256, 100 queries, 9 decoder
    layers, 133 classes: the COCO configs' model) at PANOPTIC_CHECK on the
    card and on the CPU from the same seeded weights. The masked attention
    thresholds σ(mask logit) at 0.5, so a bit whose value lies within the
    devices' rounding of 0.5 may differ and move every later layer; the
    card's forward therefore runs with the CPU's attention masks, and then
    every layer's class and mask logits must lie within
    PANOPTIC_CHECK_TOL of each output's max. The masks the card computes
    itself in that forward are held against the CPU's: a bit may differ
    only where the CPU's σ lies within PANOPTIC_CHECK_TOL of 0.5.
    `devices` (reference, checked) rehearse the check on the CPU."""
    import torch

    from efg_tpu_torch.models import mask2former as M
    from efg_tpu_torch.ops.resize import resize

    bsz, h, w = PANOPTIC_CHECK
    images = torch.from_numpy(np.random.RandomState(PANOPTIC_SEED).uniform(
        -2, 2, (bsz, h, w, 3)).astype(np.float32))
    forward0 = M.DecoderLayerM2F.forward
    cpu_masks, card_masks = [], []

    def record(self, queries, q_pos, memory, m_pos, attn_mask):
        cpu_masks.append(attn_mask.cpu())
        return forward0(self, queries, q_pos, memory, m_pos, attn_mask)

    def replay(self, queries, q_pos, memory, m_pos, attn_mask):
        card_masks.append(attn_mask.cpu())
        forced = cpu_masks[len(card_masks) - 1].to(attn_mask.device)
        return forward0(self, queries, q_pos, memory, m_pos, forced)

    out = {}
    try:
        for dev, fwd in zip(devices, (record, replay)):
            M.DecoderLayerM2F.forward = fwd
            m = M.Mask2Former(num_classes=133, num_queries=100, d_model=256, dec_layers=9,
                              depth=50, device=dev,
                              generator=torch.Generator().manual_seed(PANOPTIC_SEED))
            m.eval()
            with torch.inference_mode():
                out[dev] = {k: v.cpu().double() for k, v in m(images.to(dev)).items()}
            del m
    finally:
        M.DecoderLayerM2F.forward = forward0
    ref, got = (out[d] for d in devices)
    errs = {k: float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-6)
            for k in ref}
    # layer i attends by prediction i's mask logits shrunk to res5, res4,
    # res3 in turn (strides 32, 16, 8)
    flips, bits, far = 0, 0, 0.0
    logits = ref["mask_logits"].float()
    for i, (cm, gm) in enumerate(zip(cpu_masks, card_masks)):
        stride = (32, 16, 8)[i % 3]
        pre = torch.sigmoid(resize(logits[i], logits.shape[1:3] + (h // stride, w // stride),
                                   "bilinear")).reshape(cm.shape)
        diff = cm != gm
        bits += int(cm.numel())
        flips += int(diff.sum())
        if diff.any():
            far = max(far, float((pre[diff] - 0.5).abs().max()))
    emit({"phase": "panoptic", "part": "check", "card": card, "shape": list(PANOPTIC_CHECK),
          "rel_err_with_the_cpu_masks": errs, "tol": PANOPTIC_CHECK_TOL,
          "mask_bits": bits, "mask_bits_differing": flips,
          "their_max_distance_from_half": far})
    if max(errs.values()) > PANOPTIC_CHECK_TOL or far > PANOPTIC_CHECK_TOL:
        raise AssertionError(f"panoptic check: rel errs {errs}, a differing mask bit "
                             f"{far} from 0.5")


def phase_panoptic(card: str, device="cuda", synth=(), golden_iters=None, small_coco=()):
    """Panoptic segmentation through the CLI (no sparse kernel on its
    path), output under a temporary EFG_CACHE_DIR:
    (a) the synthetic Mask2Former experiment as written (R-50, bs 2,
        128×128, 12 iterations): task=train, then task=val;
    (b) the golden's run (`tests/goldens/mask2former_synth.json`: its
        overrides, R-18, 96×96, bs 8, 120 iterations): the loss records
        beside the golden's, finite, the last quarter's mean under 0.8 ×
        the first record (the golden's own criterion; the points come
        from another generator, so no replay);
    (c) both COCO panoptic configs as written (LSJ to 1024×1024, bs 2,
        two loader threads, 12544 points, 9 decoder layers; val 800×1344)
        on a COCO panoptic fixture this phase writes, with the two
        overrides efg_tpu's failures force (`milestones`,
        `trainer.evaluators=[PanopticEvaluator]`): R-50 from a seeded
        torchvision .pth (BN statistics measured on the fixture), Swin-T
        from a seeded mmdet-format .pth (`weights_format: swin`);
        task=train PANOPTIC_ITERS iterations (train_step by CUDA events,
        IterTimer's time, the prefetcher's next, the matcher's host ms,
        peak memory), then task=val (eval step ms, the val loader's and
        the evaluator's ms a batch, val frames/s); the R-50 eval step at
        bs 1 split into backbone, pixel decoder, transformer decoder and
        predict; the val images' GT segments as predictions read PQ = SQ
        = RQ = 1 exactly;
    (d) one Mask2Former forward card against CPU within 1e-4
        (`_m2f_card_vs_cpu`), and the sparse kernels' launch counters 0
        over the phase.
    `synth`, `golden_iters` and `small_coco` cut the runs for a rehearsal
    on the CPU."""
    import torch

    from efg_tpu_torch.cli.main import experiment_relpath, load_experiment_module
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.evaluator.panoptic_evaluator import PanopticEvaluator
    from efg_tpu_torch.ops.cuda import sparse_kernels as K

    base = tempfile.mkdtemp(prefix="chip_smoke_panoptic_")
    old_env = {k: os.environ.get(k) for k in ("EFG_CACHE_DIR", "EFG_PATH")}
    os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")
    os.environ["EFG_PATH"] = HERE  # the COCO configs include the dataset gallery by it
    launches = {}
    t_phase = time.perf_counter()

    def count(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def out_dir_of(config):
        d = os.path.join(base, "cache", "EFG_torch", experiment_relpath(os.path.join(HERE, config)))
        os.makedirs(d, exist_ok=True)
        return d

    logs = ["trainer.log_interval=1", "trainer.window_size=1"]
    try:
        # (a) the synthetic experiment as written
        config = os.path.join(PANOPTIC_SYNTH, "config.yaml")
        records, counts, probe = _engine_run(["task=train", *logs, *synth], out_dir_of(config),
                                             device, config=config)
        run = _losses(records, "panoptic synthetic")
        count(counts)
        counts_val, vprobe = _cli_eval_run(["task=val", *synth], device, config=config)
        count(counts_val)
        (_, res, evaluate_s), = vprobe.evaluations
        emit({"phase": "panoptic", "part": "synthetic", "card": card,
              "iterations": sorted(run), "losses": {i: r["loss"] for i, r in run.items()},
              "loop_step_ms_cuda_events": probe.step_ms(),
              "eval_step_ms_cuda_events": vprobe.step_ms(), "evaluate_s": evaluate_s,
              "results": res})
        if res != {} or not run:
            raise AssertionError(f"panoptic synthetic: records {sorted(run)}, val results {res}")

        # (b) the golden's run
        with open(os.path.join(HERE, PANOPTIC_GOLDEN)) as fh:
            golden = json.load(fh)
        gopts = list(golden["overrides"])
        if golden_iters:
            gopts.append(f"solver.lr_scheduler.max_iters={golden_iters}")
        gconfig = os.path.join(golden["experiment"], "config.yaml")
        gout = os.path.join(base, "golden_cache")
        os.environ["EFG_CACHE_DIR"] = gout
        grecords, counts, gprobe = _engine_run(
            ["task=train", *gopts], os.path.join(gout, "EFG_torch",
                                                 experiment_relpath(os.path.join(HERE, gconfig))),
            device, config=gconfig)
        os.environ["EFG_CACHE_DIR"] = os.path.join(base, "cache")
        count(counts)
        grun = _losses(grecords, "panoptic golden")
        losses = np.asarray([grun[i]["loss"] for i in sorted(grun)], np.float64)
        tail = float(losses[-max(1, len(losses) // 4):].mean())
        emit({"phase": "panoptic", "part": "golden", "card": card, "overrides": gopts,
              "iterations": sorted(grun), "losses": losses.tolist(),
              "golden_iterations": golden["iters"], "golden_losses": golden["losses"],
              "first": float(losses[0]), "tail_mean": tail, "limit": 0.8 * float(losses[0]),
              "loop_step_ms_cuda_events": gprobe.step_ms()})
        if not np.isfinite(losses).all() or len(losses) < 5 or not tail < 0.8 * losses[0]:
            raise AssertionError(f"panoptic golden: first {losses[0]}, tail mean {tail}")

        # (c) the COCO panoptic configs at full width
        root = os.path.join(base, "coco")
        segments = write_coco_panoptic_fixture(root)
        mean = np.asarray([123.675, 116.28, 103.53], np.float32)
        std = np.asarray([58.395, 57.12, 57.375], np.float32)
        weights = {"res50": os.path.join(base, "R-50.pth"),
                   "swin_t": os.path.join(base, "swin_tiny.pth")}
        n_tensors = {"res50": torchvision_resnet50(weights["res50"],
                                                   fixture_images(root, mean=mean, std=std))}
        n_swin, n_dropped = mmdet_swin_tiny(weights["swin_t"])
        for name, exp in PANOPTIC_COCO.items():
            config = os.path.join(exp, "config.yaml")
            out_dir = out_dir_of(config)
            # the two overrides efg_tpu's failures force, then the data root and weights
            common = [f"solver.lr_scheduler.milestones=[{PANOPTIC_ITERS}]",
                      "trainer.evaluators=[PanopticEvaluator]",
                      f"detection.source.local.root={root}", f"model.weights={weights[name]}",
                      *small_coco]
            argv = ["task=train", *logs, f"solver.lr_scheduler.max_iters={PANOPTIC_ITERS}",
                    *common]
            cfg = Configuration(config_file=os.path.join(HERE, config), opts=argv).get_config()
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            with MatcherProbe(module="mask2former", sync=True) as matcher:
                records, counts, probe = _engine_run(argv + ["trainer.evaluators="], out_dir,
                                                     device, config=config)
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
            count(counts)
            run = _losses(records, f"panoptic coco {name}")
            with open(os.path.join(out_dir, "log.txt.rank0")) as fh:
                imported = re.findall(r"Imported (\d+) tensors from .*skipped (\d+)", fh.read())
            # R-50: every tensor but fc's 2 and the 53 num_batches_tracked;
            # Swin-T: every tensor, its dropped buffers counted as imported
            want = [(str(n_tensors["res50"] - 2 - 53), "53")] if name == "res50" \
                else [(str(n_swin), "0")]
            if imported != want or sorted(run) != list(range(1, PANOPTIC_ITERS + 1)):
                raise AssertionError(f"panoptic coco {name}: import {imported} (want {want}), "
                                     f"records {sorted(run)}")
            pad = cfg.dataset.processors.train[-1]["PadImage"]
            mc = cfg.model.mask2former
            n_match = len(matcher.ms)
            emit({"phase": "panoptic", "part": "coco_train", "model": name, "card": card,
                  "batch_size": int(cfg.dataloader.batch_size),
                  "canvas": [int(pad["height"]), int(pad["width"])],
                  "num_workers": int(cfg.dataloader.num_workers),
                  "num_points": int(mc.num_points), "dec_layers": int(mc.dec_layers),
                  "imported_tensors": int(imported[0][0]),
                  "dropped_buffers": n_dropped if name == "swin_t" else 0,
                  "fixture_segments": segments, "iterations": sorted(run),
                  "losses": {i: r["loss"] for i, r in run.items()},
                  "loop_step_ms_cuda_events": probe.step_ms(),
                  "iteration_time_ms": [1e3 * r["time"] for r in records if "time" in r],
                  "data_time_ms": [1e3 * t for t in probe.data_s],
                  "matcher_host_ms_a_step": matcher.ms,
                  "matcher_calls": n_match, "peak_mem_gb": peak})
            if n_match != PANOPTIC_ITERS:  # one host solve a step, every layer's costs in it
                raise AssertionError(f"panoptic coco {name}: {n_match} matcher calls")

            counts_val, vprobe = _cli_eval_run(["task=val", *common], device, config=config)
            count(counts_val)
            (_, res, evaluate_s), = vprobe.evaluations
            n_frames = sum(len(b["annotations"]) for b in vprobe.batches)
            _panoptic_results(f"panoptic coco {name} val", res)
            emit({"phase": "panoptic", "part": "coco_val", "model": name, "card": card,
                  "frames": n_frames, "eval_step_ms_cuda_events": vprobe.step_ms(),
                  "data_ms": [1e3 * d for d in vprobe.data_s],
                  "evaluator_process_ms": [1e3 * d for d in vprobe.process_s],
                  "evaluator_evaluate_ms": [1e3 * d for d in vprobe.evaluator_s],
                  "evaluate_s": evaluate_s, "val_frames_per_s": n_frames / evaluate_s,
                  "results": res})
            if n_frames != PANOPTIC_VAL:
                raise AssertionError(f"panoptic coco {name} val: {n_frames} frames")
            if name != "res50":
                continue

            # the val images' GT segments as predictions: a perfect segmenter
            vcfg = Configuration(config_file=os.path.join(HERE, config),
                                 opts=["task=val", *common]).get_config()
            perfect = PanopticEvaluator(vcfg, None)
            perfect.reset()
            for inputs in vprobe.batches:
                annos = inputs["annotations"]
                perfect.process(inputs, dict(pan_pred=[a["pan_gt"] for a in annos],
                                             pred_segments=[a["gt_segments"] for a in annos]))
            pres = perfect.evaluate()
            emit({"phase": "panoptic", "part": "perfect", "card": card, "results": pres})
            if not pres["panoptic/PQ"] == pres["panoptic/SQ"] == pres["panoptic/RQ"] == 1.0:
                raise AssertionError(f"panoptic: perfect predictions read {pres}")

            # the R-50 eval step at bs 1, by parts
            md = load_experiment_module(config).build_model(vcfg, device=device)
            ckpt = torch.load(os.path.join(out_dir, "model_final"), map_location=device,
                              weights_only=True)
            md.module.load_state_dict(ckpt["model"])
            host = vprobe.batches[0]
            batch = {k: torch.from_numpy(v[:1]).to(device) if isinstance(v, np.ndarray)
                     else v[:1] for k, v in host.items()}
            emit({"phase": "panoptic", "part": "eval_step_parts", "card": card,
                  "canvas": list(host["images"].shape[1:3]), "batch_size": 1,
                  "ms_cuda_events": _m2f_parts_ms(md, batch)})
            del md, ckpt
            if device == "cuda":  # the train step by parts, under the profiler
                from efg_tpu_torch.engine.trainer import DefaultTrainer

                tcfg = Configuration(config_file=os.path.join(HERE, config),
                                     opts=argv + ["dataloader.num_workers=0"]).get_config()
                tcfg["trainer"]["output_dir"] = os.path.join(base, "profile")
                os.makedirs(tcfg["trainer"]["output_dir"], exist_ok=True)
                trainer = DefaultTrainer(tcfg, load_experiment_module(config).build_model,
                                         device=device)
                _m2f_step_profile(trainer, card, name)
                del trainer

        # (d) card against CPU, and no sparse kernel launched
        K.reset_launches()
        if device == "cuda":
            _m2f_card_vs_cpu(card)
        count(dict(K.launches))
        emit({"phase": "panoptic", "part": "launches", "card": card, "launches": launches,
              "phase_s": time.perf_counter() - t_phase})
        if any(launches.values()):
            raise AssertionError(f"panoptic: sparse kernels launched {launches}")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(base, ignore_errors=True)


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
        serve_capture = offload(capture, "cpu")  # for phase variants
        del capture
        phase_breakdown(md, model_cfg)
        phase_check()
        capture, launches, step1, bare_step_ms = phase_train(md, card)
        train = phase_train_kernels(capture, card, launches)
        variants = phase_variant_kernels(offload(serve_capture, "cuda"), capture, card)
        del capture, serve_capture
        serve_counts, train_counts = phase_variants(card, step1)
        phase_train_profile(md, card)
        phase_train_check()
        phase_engine(card, bare_step_ms)
        phase_eval(card)
        detr = phase_detr(card)
        detr_train = phase_detr_train(card)
        phase_ddp(card)
        data = tempfile.mkdtemp(prefix="chip_smoke_data_")
        try:  # phase waymo's frames serve phase waymo_detr
            waymo = phase_waymo(card, data_root=os.path.join(data, "waymo"))
            waymo_detr = phase_waymo_detr(card, os.path.join(data, "waymo"))
            track = phase_track(card, os.path.join(data, "waymo"))
        finally:
            shutil.rmtree(data, ignore_errors=True)
        nusc = phase_nusc(card)
        phase_det2d(card)
        phase_panoptic(card)
        # a rank kernel's row is the training step's (its forward rulebooks
        # and the inverse ones); the serving forward's is in the kernels line
        train["rank_flags"]["launches_serve"] = serve["rank_flags"]["launches"]
        for name, counts in (("rank_flags_seq4", train_counts), ("rank_flags_hostwin", train_counts),
                             ("gather_gemm_g3", serve_counts),
                             ("gather_gemm_g3_stacked", train_counts)):
            variants[name]["launches"] = counts[name]  # phase variants' path
        for name in ("rank_flags_seq4", "rank_flags_hostwin"):
            variants[name]["launches_serve"] = serve_counts[name]
        kernels = [train["rank_flags"], serve["gather_gemm"], detr, train["gather_gemm_stacked"],
                   *detr_train, train["gather_dw"], *variants.values(), *waymo, *waymo_detr,
                   *nusc, *track]
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
