"""Voxel-DETR: sparse voxel backbone + box-attention DETR for 3D detection
(port of `efg_tpu/models/voxel_detr.py`, forward and `predict`).

points → on-device voxelization and mean VFE → SparseResNet + FPN (p3) →
input projection + GroupNorm + sine position encoding → box-attention
encoder (window attention anchored at each cell) → one-class proposal head
→ top-k queries → decoder (self-attention + rotated box cross-attention
around each query's box) → per-layer detection heads. Parameter names are
the flax modules'; the flax `MultiHeadDotProductAttention` is written out
as its query / key / value / out projections. Training: the focal + L1 +
axis-aligned GIoU3D + rad set losses under Hungarian matching
(`compute_loss`: one solve for the encoder layer and every decoder layer
together, `ops/matcher.py`: the kernel on the card, scipy on the CPU). `detr_kwargs` and `model_cfg` read an
experiment's config for every DETR experiment (Voxel-DETR's and
ConQueR's), and `build_model` is the plain Voxel-DETR experiment's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.geometry.box_ops_torch import aligned_giou_3d_pairs, limit_period
from efg_tpu_torch.modeling.backbones.fpn import FPN, position_embedding_sine
from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.modeling.backbones.sparse_resnet import SparseResNet
from efg_tpu_torch.modeling.common.layers import FLAX_NORM_EPS, MultiHeadDotProductAttention, dense
from efg_tpu_torch.modeling.readers.voxel_reader import dynamic_mean_vfe
from efg_tpu_torch.models.centerpoint import resolve_device
from efg_tpu_torch.ops import box_attention as BA
from efg_tpu_torch.ops.matcher import hungarian_match
from efg_tpu_torch.ops.voxelize import grid_size
from efg_tpu_torch.parallel import ddp


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, 0, 1)
    return torch.log(torch.clamp(x, min=eps) / torch.clamp(1 - x, min=eps))


class VoxelBoxCoder3D:
    """Boxes normalized to the point-cloud range (reference
    `modules/box_coder.py`)."""

    def __init__(self, voxel_size, pc_range, z_normalizer: float = 10.0):
        self.pc_range = np.asarray(pc_range, np.float32)
        self.pc_size = self.pc_range[3:] - self.pc_range[:3]
        self.z = z_normalizer

    def encode(self, gt_boxes9: torch.Tensor) -> torch.Tensor:
        """[..., 9] raw (x, y, z, dx, dy, dz, vx, vy, yaw) → [..., 7] normalized."""
        r, s = self.pc_range, self.pc_size
        rad = limit_period(gt_boxes9[..., 8], offset=0.5, period=2 * np.pi)
        return torch.stack([
            (gt_boxes9[..., 0] - float(r[0])) / float(s[0]),
            (gt_boxes9[..., 1] - float(r[1])) / float(s[1]),
            (gt_boxes9[..., 2] + self.z) / (2 * self.z),
            gt_boxes9[..., 3] / float(s[0]),
            gt_boxes9[..., 4] / float(s[1]),
            gt_boxes9[..., 5] / (2 * self.z),
            (rad + np.pi) / (2 * np.pi),
        ], dim=-1)

    def decode(self, boxes7: torch.Tensor) -> torch.Tensor:
        r, s = self.pc_range, self.pc_size
        return torch.stack([
            boxes7[..., 0] * float(s[0]) + float(r[0]),
            boxes7[..., 1] * float(s[1]) + float(r[1]),
            boxes7[..., 2] * 2 * self.z - self.z,
            boxes7[..., 3] * float(s[0]),
            boxes7[..., 4] * float(s[1]),
            boxes7[..., 5] * 2 * self.z,
            boxes7[..., 6] * 2 * np.pi - np.pi,
        ], dim=-1)


class MLP(nn.Module):
    def __init__(self, cin: int, hidden_dim: int, out_dim: int, num_layers: int,
                 final_bias_init: float = 0.0, zero_final: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [cin] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            setattr(self, f"fc{i}", dense(dims[i], hidden_dim, generator=generator))
        setattr(self, f"fc{num_layers - 1}", dense(
            dims[-1], out_dim, kernel="zeros" if zero_final else "lecun",
            bias=final_bias_init, generator=generator))
        self.num_layers = num_layers

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.num_layers - 1}")(x)


class Box3dAttention(nn.Module):
    """Rotated-box sampling attention (reference `modules/box_attention.py`).
    backend "sample": exact bilinear sampling; "dense": window attention
    anchored at each query's own cell (encoder); "gather": window
    attention around each query's box centre (decoder). The window
    backends take one value level."""

    def __init__(self, d_model: int, num_level: int, num_head: int, with_rotation: bool = True,
                 kernel_size: int = 5, backend: str = "sample", window_radius: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_level, self.num_head = num_level, num_head
        self.with_rotation, self.kernel_size = with_rotation, kernel_size
        self.backend, self.window_radius = backend, window_radius
        nv = 5 if with_rotation else 4
        self.linear_box = dense(d_model, num_head * num_level * nv, kernel="zeros",
                                bias="uniform", generator=generator)
        self.linear_attn = dense(d_model, num_head * num_level * kernel_size ** 2,
                                 kernel="zeros", generator=generator)
        self.value_proj = dense(d_model, d_model, kernel="xavier", generator=generator)
        self.out_proj = dense(d_model, d_model, kernel="xavier", generator=generator)

    def forward(self, query, value_levels: Sequence[torch.Tensor], ref_windows):
        """query [B, L, C], value_levels [B, H, W, C] maps, ref_windows
        [B, L, 7] normalized → [B, L, C]."""
        nv = 5 if self.with_rotation else 4
        p = self.kernel_size ** 2
        b, l, _ = query.shape
        nh, nl = self.num_head, self.num_level
        off = self.linear_box(query).reshape(b, l, nh, nl, nv)
        attn = self.linear_attn(query).reshape(b, l, nh, nl * p)
        attn = torch.softmax(attn, dim=-1).reshape(b, l, nh, nl, p)
        values = [self.value_proj(v) for v in value_levels]

        ref = ref_windows[:, :, None, None, :]  # [B, L, 1, 1, 7]
        grids = BA.make_box_grids(
            ref[..., [0, 1, 3, 4]], ref[..., 6:7], off[..., :4],
            off[..., 4:5] if self.with_rotation else None,
            BA.kernel_indices(self.kernel_size, query.dtype, query.device),
        )  # [B, L, NH, NL, P, 2]
        if self.backend != "sample" and nl == 1:
            v = values[0]
            h, w = v.shape[1:3]
            base = torch.stack([
                torch.clamp((ref_windows[..., 1] * h).to(torch.int32), 0, h - 1),
                torch.clamp((ref_windows[..., 0] * w).to(torch.int32), 0, w - 1),
            ], dim=-1)
            coeffs = BA.bin_window_coeffs(grids, attn, base, h, w, self.window_radius)
            if self.backend == "dense":
                out = BA.box_attention_window_dense(v, coeffs, num_heads=nh,
                                                    radius=self.window_radius)
            else:
                out = BA.box_attention_window_gather(v, coeffs, base, num_heads=nh,
                                                     radius=self.window_radius)
        else:
            out = BA.box_attention_sample(values, grids, attn, num_heads=nh)
        return self.out_proj(out)


def _layer_norm(d_model: int) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)


class EncoderLayer(nn.Module):
    """Box self-attention (the window anchored at each cell, efg_tpu's
    default "window" backend) + FFN."""

    def __init__(self, d_model: int, num_head: int, num_level: int, dim_feedforward: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_attn = Box3dAttention(d_model, num_level, num_head, with_rotation=False,
                                        backend="dense", window_radius=4, generator=generator)
        self.norm1 = _layer_norm(d_model)
        self.linear1 = dense(d_model, dim_feedforward, generator=generator)
        self.linear2 = dense(dim_feedforward, d_model, generator=generator)
        self.norm2 = _layer_norm(d_model)

    def forward(self, src, pos, value_shapes, ref_windows):
        maps, start = [], 0
        for h, w in value_shapes:
            maps.append(src[:, start:start + h * w].reshape(src.shape[0], h, w, -1))
            start += h * w
        src = self.norm1(src + self.self_attn(src + pos, maps, ref_windows))
        ff = self.linear2(torch.relu(self.linear1(src)))
        return self.norm2(src + ff)


class DecoderLayer(nn.Module):
    """Self-attention over the queries + rotated box cross-attention (the
    window around each query's box, efg_tpu's default "window" backend) +
    FFN."""

    def __init__(self, d_model: int, num_head: int, num_level: int, dim_feedforward: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pos_embed = MLP(10, d_model, d_model, 3, generator=generator)
        self.self_attn = MultiHeadDotProductAttention(d_model, num_head, generator=generator)
        self.norm1 = _layer_norm(d_model)
        self.cross_attn = Box3dAttention(d_model, num_level, num_head, with_rotation=True,
                                         backend="gather", window_radius=8, generator=generator)
        self.norm2 = _layer_norm(d_model)
        self.linear1 = dense(d_model, dim_feedforward, generator=generator)
        self.linear2 = dense(dim_feedforward, d_model, generator=generator)
        self.norm3 = _layer_norm(d_model)

    def forward(self, idx: int, query, memory_levels, ref_windows, attn_mask=None):
        """ref_windows [B, Q, 10] (7 box + 3 probs); attn_mask [T, T] bool,
        True = may attend (flax's convention)."""
        query_pos = self.pos_embed(ref_windows)
        if idx == 0:
            query = query_pos
            q = k = query
        else:
            q = k = query + query_pos
        mask = None if attn_mask is None else attn_mask[None, None]
        query = self.norm1(query + self.self_attn(q, k, query, mask))
        cross = self.cross_attn(query + query_pos if idx > 0 else query, memory_levels,
                                ref_windows[..., :7])
        query = self.norm2(query + cross)
        ff = self.linear2(torch.relu(self.linear1(query)))
        return self.norm3(query + ff)


class DetHead(nn.Module):
    """Per-layer class / box embed (reference `Det3DHead.forward`)."""

    def __init__(self, hidden_dim: int, num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        prior = 0.01
        self.class_embed = MLP(hidden_dim, hidden_dim, num_classes, 3,
                               final_bias_init=-math.log((1 - prior) / prior),
                               generator=generator)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 7, 3, zero_final=True, generator=generator)

    def forward(self, embed, anchors):
        cls_logits = self.class_embed(embed)
        boxes = torch.sigmoid(self.bbox_embed(embed) + inverse_sigmoid(anchors))
        return cls_logits, boxes


class TransformerDecoder(nn.Module):
    """Decoder stack with per-layer detection heads and iterative
    ref-window refinement (reference `TransformerDecoder`)."""

    def __init__(self, hidden_dim: int, num_head: int, num_level: int, dim_feedforward: int,
                 dec_layers: int, num_classes: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim, self.dec_layers = hidden_dim, dec_layers
        for i in range(dec_layers):
            setattr(self, f"dec{i}", DecoderLayer(hidden_dim, num_head, num_level,
                                                  dim_feedforward, generator=generator))
            setattr(self, f"det_head{i}", DetHead(hidden_dim, num_classes, generator=generator))

    def forward(self, memory_levels, ref, attn_mask=None):
        """ref [B, T, 10]; attn_mask [T, T] bool, True = may attend →
        (logits [D, B, T, C], boxes [D, B, T, 7])."""
        b, t, _ = ref.shape
        query = ref.new_zeros(b, t, self.hidden_dim)
        all_logits, all_boxes = [], []
        for i in range(self.dec_layers):
            query = getattr(self, f"dec{i}")(i, query, memory_levels, ref, attn_mask=attn_mask)
            logits_i, boxes_i = getattr(self, f"det_head{i}")(query, ref[..., :7])
            all_logits.append(logits_i)
            all_boxes.append(boxes_i)
            ref = torch.cat([boxes_i.detach(), torch.sigmoid(logits_i).detach()], dim=-1)
        return torch.stack(all_logits), torch.stack(all_boxes)


class VoxelDETR(nn.Module):
    """End-to-end model; returns the raw pieces `predict` needs. Optional
    `dn_ref` [B, P, 10] (noised GT proposals + one-hot scores) and
    `dn_attn_mask` [P+Q, P+Q] (True = may attend) add ConQueR's denoising
    queries in front of the top-k ones. Parameters are created on `device`
    (default: the card), drawn on the CPU from `generator`."""

    def __init__(self, pc_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 voxel_size: Tuple[float, ...] = (0.1, 0.1, 0.15), max_voxels: int = 120000,
                 num_input_features: int = 5,
                 resnet_caps: Sequence[int] = (80000, 60000, 30000, 15000), depth: int = 18,
                 out_features: Sequence[str] = ("res2", "res3", "res4"),
                 fpn_levels: Sequence[str] = ("p3",), hidden_dim: int = 256, num_head: int = 8,
                 enc_layers: int = 3, dec_layers: int = 3, dim_feedforward: int = 1024,
                 num_queries: int = 300, num_classes: int = 3, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.pc_range, self.voxel_size = tuple(pc_range), tuple(voxel_size)
        self.max_voxels, self.num_input_features = max_voxels, num_input_features
        self.fpn_levels = tuple(fpn_levels)
        self.hidden_dim, self.num_queries, self.num_classes = hidden_dim, num_queries, num_classes
        self.enc_layers = enc_layers
        self.backbone = SparseResNet(
            depth=depth, num_input_features=num_input_features, out_features=tuple(out_features),
            grid_size=grid_size(pc_range, voxel_size),
            stage_caps=tuple(resnet_caps) + (resnet_caps[-1],), generator=generator)
        self.fpn = FPN(self.backbone.output_channels(), out_channels=hidden_dim,
                       generator=generator)
        for lf in self.fpn_levels:
            proj = Conv2d(hidden_dim, hidden_dim, 1, bias=True, dtype=None, generator=generator)
            with torch.no_grad():
                nn.init.xavier_uniform_(proj.weight, generator=generator)
            setattr(self, f"input_proj_{lf}", proj)
            setattr(self, f"input_gn_{lf}", nn.GroupNorm(32, hidden_dim, eps=FLAX_NORM_EPS))
        for i in range(enc_layers):
            setattr(self, f"enc{i}", EncoderLayer(hidden_dim, num_head, len(self.fpn_levels),
                                                  dim_feedforward, generator=generator))
        self.proposal_head = DetHead(hidden_dim, 1, generator=generator)
        self.decoder = TransformerDecoder(hidden_dim, num_head, len(self.fpn_levels),
                                          dim_feedforward, dec_layers, num_classes,
                                          generator=generator)
        self.to(device)

    def run_decoder(self, memory_levels, ref, attn_mask=None):
        """The decoder alone (ConQueR's momentum decoder runs it again, with
        its EMA weights, on GT proposals)."""
        return self.decoder(memory_levels, ref, attn_mask=attn_mask)

    def encode(self, points, points_mask):
        """points → (src [B, L, C], pos [B, L, C], level shapes): voxels,
        the sparse trunk, FPN, the input projections and position codes."""
        feats, coords, valid = dynamic_mean_vfe(
            points, points_mask, pc_range=self.pc_range, voxel_size=self.voxel_size,
            max_voxels=self.max_voxels, num_input_features=self.num_input_features)
        bev = self.backbone(feats.detach(), coords, valid)  # efg_tpu's stop_gradient
        fpn = self.fpn(bev, levels=self.fpn_levels)
        levels, pos_levels, shapes = [], [], []
        for lf in self.fpn_levels:
            x = getattr(self, f"input_proj_{lf}")(fpn[lf].permute(0, 3, 1, 2))
            x = getattr(self, f"input_gn_{lf}")(x).permute(0, 2, 3, 1)  # NHWC
            levels.append(x)
            pos_levels.append(position_embedding_sine(x, self.hidden_dim // 2))
            shapes.append(tuple(x.shape[1:3]))
        b = levels[0].shape[0]
        src = torch.cat([x.reshape(b, -1, self.hidden_dim) for x in levels], dim=1)
        pos = torch.cat([p.reshape(b, -1, self.hidden_dim) for p in pos_levels], dim=1)
        return src, pos, shapes

    @staticmethod
    def ref_windows(shapes, b: int, dtype, device) -> torch.Tensor:
        """Per-cell reference windows [B, L, 7] (reference
        `_create_ref_windows`): the cell centre, size 0.025, z 0.5, angle 0."""
        refs = []
        for h, w in shapes:
            ry, rx = torch.meshgrid((torch.arange(h, dtype=dtype, device=device) + 0.5) / h,
                                    (torch.arange(w, dtype=dtype, device=device) + 0.5) / w,
                                    indexing="ij")
            rxy = torch.stack([rx.reshape(-1), ry.reshape(-1)], dim=-1)
            n = h * w
            refs.append(torch.cat([rxy, rxy.new_full((n, 1), 0.5), rxy.new_full((n, 2), 0.025),
                                   rxy.new_full((n, 1), 0.5), rxy.new_zeros(n, 1)], dim=-1))
        r = torch.cat(refs, dim=0)
        return r[None].expand(b, *r.shape)

    def forward(self, points, points_mask, dn_ref=None, dn_attn_mask=None) -> Dict[str, Any]:
        src, pos, shapes = self.encode(points, points_mask)
        b = src.shape[0]
        ref_windows = self.ref_windows(shapes, b, src.dtype, src.device)
        memory = src
        for i in range(self.enc_layers):
            memory = getattr(self, f"enc{i}")(memory, pos, shapes, ref_windows)

        # proposal head (1 class) over all positions → top-k queries
        enc_logits, enc_boxes = self.proposal_head(memory, ref_windows)
        probs = torch.sigmoid(enc_logits[..., 0])
        topk_probs, topk_idx = torch.topk(probs, self.num_queries, dim=1)
        q_ref = torch.gather(enc_boxes, 1, topk_idx[..., None].expand(-1, -1, 7)).detach()
        probs3 = topk_probs[..., None].expand(-1, -1, 3).detach()
        dec_ref = torch.cat([q_ref, probs3], dim=-1)  # [B, Q, 10]

        memory_levels, start = [], 0
        for h, w in shapes:
            memory_levels.append(memory[:, start:start + h * w].reshape(b, h, w, -1))
            start += h * w
        ref = dec_ref if dn_ref is None else torch.cat([dn_ref, dec_ref], dim=1)
        all_logits, all_boxes = self.decoder(memory_levels, ref, attn_mask=dn_attn_mask)
        pad = 0 if dn_ref is None else dn_ref.shape[1]
        return dict(
            enc_logits=enc_logits,
            enc_boxes=enc_boxes,
            topk_idx=topk_idx,
            dec_logits=all_logits[:, :, pad:],  # [D, B, Q, C]
            dec_boxes=all_boxes[:, :, pad:],  # [D, B, Q, 7]
            dn_logits=all_logits[:, :, :pad] if pad else None,
            dn_boxes=all_boxes[:, :, :pad] if pad else None,
            memory_levels=memory_levels,
        )


# ---------------------------------------------------------------------------
# Losses (reference `losses.py` Det3DLoss + `modules/matcher.py`)
# ---------------------------------------------------------------------------


def _focal_cost_class(prob: torch.Tensor, labels: torch.Tensor, alpha: float = 0.25,
                      gamma: float = 2.0) -> torch.Tensor:
    """prob [..., Q, C], labels [..., G] → [..., Q, G] focal class cost."""
    neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    cost = pos - neg
    idx = labels.long()[..., None, :].expand(*cost.shape[:-1], labels.shape[-1])
    return torch.gather(cost, -1, idx)


def match_cost(pred_logits, pred_boxes, tgt_boxes, tgt_labels, tgt_mask, mw) -> torch.Tensor:
    """Cost matrix [..., Q, G] (reference matcher forward): pred_logits
    [..., Q, C], pred_boxes [..., Q, 7] against tgt_boxes [..., G, 7],
    tgt_labels and tgt_mask [..., G]; 1e8 at padded GT columns."""
    prob = torch.sigmoid(pred_logits)
    cost_class = _focal_cost_class(prob, tgt_labels)
    pb, tb = pred_boxes[..., :, None, :], tgt_boxes[..., None, :, :]
    cost_bbox = (pb[..., :6] - tb[..., :6]).abs().sum(-1)
    cost_rad = (pb[..., 6] - tb[..., 6]).abs()
    cost_giou = -aligned_giou_3d_pairs(pb, tb)
    c = (mw["bbox"] * cost_bbox + mw["class"] * cost_class + mw["giou"] * cost_giou
         + mw["rad"] * cost_rad)
    return torch.where(tgt_mask[..., None, :].bool(), c, torch.full_like(c, 1e8))


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss (reference `efg/modeling/losses/focal_loss.py:5`)."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, L, K] rows idx [B, G] → [B, G, K]."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def detr_set_loss(pred_logits, pred_boxes, tgt_boxes, tgt_labels, tgt_mask, num_boxes, mw, *,
                  full_logits=None, topk_idx=None, assign=None) -> Dict[str, torch.Tensor]:
    """Focal class loss + L1 + GIoU3D + rad of one layer's [B, Q, ·]
    predictions under the assignment [B, G] (matched here when None). With
    `full_logits` [B, L, C] the class loss runs over every position, the
    matched queries' positions taken through `topk_idx` [B, Q]."""
    if assign is None:
        assign = hungarian_match(
            match_cost(pred_logits, pred_boxes, tgt_boxes, tgt_labels, tgt_mask, mw), tgt_mask)
    ok = assign >= 0
    a = torch.where(ok, assign, torch.zeros_like(assign))
    if full_logits is not None:
        cls_logits, pos_idx = full_logits, torch.gather(topk_idx, 1, a)
    else:
        cls_logits, pos_idx = pred_logits, a
    b, l, c = cls_logits.shape
    flat = pos_idx * c + torch.clamp(tgt_labels.long(), 0, c - 1)
    onehot = cls_logits.new_zeros(b, l * c + 1)
    onehot.scatter_(1, torch.where(ok, flat, torch.full_like(flat, l * c)), 1.0)
    onehot = onehot[:, :l * c].reshape(b, l, c)
    loss_ce = sigmoid_focal_loss(cls_logits, onehot).sum() / num_boxes

    pb = _take_rows(pred_boxes, a)  # [B, G, 7]
    okf = ok[..., None].to(pred_boxes.dtype)
    loss_bbox = ((pb[..., :6] - tgt_boxes[..., :6]).abs() * okf).sum() / num_boxes
    loss_rad = ((pb[..., 6:] - tgt_boxes[..., 6:]).abs() * okf).sum() / num_boxes
    giou = aligned_giou_3d_pairs(pb, tgt_boxes)  # the diagonal of efg_tpu's matrix
    loss_giou = ((1 - giou) * ok.to(giou.dtype)).sum() / num_boxes
    return {"loss_ce": mw["class"] * loss_ce, "loss_bbox": mw["bbox"] * loss_bbox,
            "loss_giou": mw["giou"] * loss_giou, "loss_rad": mw["rad"] * loss_rad}


def targets(batch: Dict[str, Any], model_cfg: Dict[str, Any]):
    """(tgt_boxes [B, G, 7] normalized, tgt_labels [B, G] 0-based, tgt_mask
    [B, G], num_boxes = max(#GT, 1)); #GT over the global batch under data
    parallelism, so the ranks' losses add up to the global batch's."""
    coder = VoxelBoxCoder3D(model_cfg["voxel_size"], model_cfg["pc_range"])
    tgt_mask = batch["gt_mask"].bool()
    return (coder.encode(batch["gt_boxes"]), torch.clamp(batch["gt_classes"].long() - 1, min=0),
            tgt_mask, torch.clamp(ddp.global_sum(tgt_mask.sum().float()), min=1.0))


def compute_loss(preds: Dict[str, Any], batch: Dict[str, Any], *, model_cfg: Dict[str, Any],
                 return_assign: bool = False):
    """The set losses of the encoder's proposals (binary objectness over
    the full map) and of every decoder layer, their sum under "loss". One
    solve matches all 1 + D layers ([(1 + D)·B, Q, G] costs). With
    `return_assign`, also the last decoder layer's assignment [B, G]."""
    mw = model_cfg["loss_weights"]  # {"class": 1, "bbox": 4, "giou": 2, "rad": 4}
    tgt_boxes, tgt_labels, tgt_mask, num_boxes = targets(batch, model_cfg)
    topk = preds["topk_idx"]
    enc_logits_q = _take_rows(preds["enc_logits"], topk)
    enc_boxes_q = _take_rows(preds["enc_boxes"], topk)
    bin_labels = torch.zeros_like(tgt_labels)
    d = preds["dec_logits"].shape[0]
    layer_logits: List[torch.Tensor] = [enc_logits_q] + [preds["dec_logits"][i] for i in range(d)]
    layer_boxes: List[torch.Tensor] = [enc_boxes_q] + [preds["dec_boxes"][i] for i in range(d)]
    layer_labels = [bin_labels] + [tgt_labels] * d
    cost_all = torch.cat([match_cost(lg, bx, tgt_boxes, ll, tgt_mask, mw)
                          for lg, bx, ll in zip(layer_logits, layer_boxes, layer_labels)], dim=0)
    k = 1 + d
    b, g = tgt_mask.shape
    assign_all = hungarian_match(cost_all, tgt_mask.repeat(k, 1)).reshape(k, b, g)

    losses: Dict[str, torch.Tensor] = {}
    enc = detr_set_loss(enc_logits_q, enc_boxes_q, tgt_boxes, bin_labels, tgt_mask, num_boxes, mw,
                        full_logits=preds["enc_logits"], topk_idx=topk, assign=assign_all[0])
    losses.update({k_ + "_enc": v for k_, v in enc.items()})
    for i in range(d):
        li = detr_set_loss(preds["dec_logits"][i], preds["dec_boxes"][i], tgt_boxes, tgt_labels,
                           tgt_mask, num_boxes, mw, assign=assign_all[1 + i])
        suffix = "" if i == d - 1 else f"_{i}"
        losses.update({k_ + suffix: v for k_, v in li.items()})
    losses["loss"] = sum(losses.values())
    if return_assign:
        return losses, assign_all[-1]
    return losses


def predict(preds: Dict[str, Any], *, model_cfg: Dict[str, Any],
            top_k: int = 300) -> Dict[str, torch.Tensor]:
    """Top-300 over Q×C sigmoid scores of the last decoder layer, decoded
    (reference eval path); labels are 1-based."""
    coder = VoxelBoxCoder3D(model_cfg["voxel_size"], model_cfg["pc_range"])
    logits = preds["dec_logits"][-1]  # [B, Q, C]
    boxes = coder.decode(preds["dec_boxes"][-1])  # [B, Q, 7]
    b, q, c = logits.shape
    prob = torch.sigmoid(logits).reshape(b, q * c)
    scores, idx = torch.topk(prob, min(top_k, q * c), dim=1)
    qidx = torch.div(idx, c, rounding_mode="floor")
    labels = idx % c + 1
    out_boxes = torch.gather(boxes, 1, qidx[..., None].expand(-1, -1, 7))
    return dict(box3d=out_boxes, scores=scores, labels=labels,
                valid=torch.ones_like(labels, dtype=torch.bool))


# ---------------------------------------------------------------------------
# The experiments' config → model (efg_tpu's Waymo Voxel-DETR `net.py`)
# ---------------------------------------------------------------------------


def detr_kwargs(config) -> Dict[str, Any]:
    """VoxelDETR's keyword arguments from an experiment's config."""
    m = config.model
    return dict(
        pc_range=tuple(config.dataset.pc_range),
        voxel_size=tuple(config.dataset.voxel_size),
        max_voxels=int(m.max_voxels),
        resnet_caps=tuple(m.resnet_caps),
        depth=int(m.sparse_resnet.depth),
        out_features=tuple(m.sparse_resnet.out_features),
        fpn_levels=tuple(m.fpn_levels),
        hidden_dim=int(m.hidden_dim),
        num_head=int(m.transformer.nhead),
        enc_layers=int(m.transformer.enc_layers),
        dec_layers=int(m.transformer.dec_layers),
        dim_feedforward=int(m.transformer.dim_feedforward),
        num_queries=int(m.transformer.num_queries),
        num_classes=len(config.dataset.classes),
    )


def model_cfg(config) -> Dict[str, Any]:
    """The loss and decode settings from an experiment's config."""
    lw = config.model.loss
    return dict(
        pc_range=tuple(config.dataset.pc_range),
        voxel_size=tuple(config.dataset.voxel_size),
        loss_weights={
            "class": float(lw.class_loss_coef),
            "bbox": float(lw.bbox_loss_coef),
            "giou": float(lw.giou_loss_coef),
            "rad": float(lw.rad_loss_coef),
        },
    )


def make_model_def(kwargs: Dict[str, Any], cfg: Dict[str, Any], *, device="cuda",
                   generator: Optional[torch.Generator] = None) -> ModelDef:
    """The plain Voxel-DETR ModelDef: the set losses of `compute_loss`
    (no denoising, contrast or EMA decoder) and `predict`."""
    module = VoxelDETR(**kwargs, device=device, generator=generator)

    def apply_args(batch):
        return dict(points=batch["points"], points_mask=batch["points_mask"])

    def loss_fn(preds, batch):
        return compute_loss(preds, batch, model_cfg=cfg)

    def predict_fn(preds, batch):
        return predict(preds, model_cfg=cfg)

    return ModelDef(module, apply_args, loss_fn, predict_fn)


def build_model(config, device="cuda", generator=None) -> ModelDef:
    """The `build_model` of the Voxel-DETR experiment's `net.py`, on
    `device`, its initial weights drawn from `generator`."""
    return make_model_def(detr_kwargs(config), model_cfg(config), device=device,
                          generator=generator)
