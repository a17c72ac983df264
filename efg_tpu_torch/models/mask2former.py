"""Mask2Former: universal segmentation, panoptic / instance / semantic
(port of `efg_tpu/models/mask2former.py`).

ResNet or Swin trunk → MSDeformAttn pixel decoder (a deformable encoder
over res3-res5, then an FPN fuse up to res2) → per-pixel mask features
at 1/4 → masked-attention transformer decoder: Q learnable queries cycle
through the three scales (res5, res4, res3), each query's
cross-attention limited to where its current mask logits, resized to the
scale, read sigmoid > 0.5 (everywhere when that is nowhere). Outputs are
stacked over the initial prediction and every decoder layer:
`cls_logits` [D+1, B, Q, C+1], `mask_logits` [D+1, B, Q, H/4, W/4].

The module takes the batch's NHWC images; the trunk and the convs run
NCHW, the encoder and the decoder on flattened [B, L, C] tokens. Every
LayerNorm and GroupNorm here is flax's default (eps 1e-6); Swin's are
torch's (`modeling/backbones/swin.py`). Resizes are `jax.image.resize`'s
(`ops/resize.py`): the antialiased bilinear shrink of the mask logits and
the half-pixel nearest 2× upsample of the pixel decoder.

The set criterion (`compute_loss`): per decoder layer, Hungarian matching
on class probability + point-sampled BCE + dice over one shared uniform
point set, then the class CE (no-object weight) and the point-sampled
mask BCE and dice over PointRend importance-sampled points per matched
pair. Each layer's cost depends only on its own predictions and the
shared points, so all D+1 layers' costs are solved together: one host
copy through `ops/matcher.py`. The randomness (the shared points, each
layer's candidate and top-up points) is drawn from the generator the
loss is given, the training step's; a test can pass efg_tpu's draws in.
efg_tpu's `top_k` keeps the lower index first on ties; the port takes a
stable descending sort, which does the same on either device.

`predict_instance`, `predict_panoptic` and `predict_semantic` are
efg_tpu's inference heads; `evaluator/panoptic_evaluator.py` assembles
the panoptic segments on the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.modeling.backbones.fpn import position_embedding_sine
from efg_tpu_torch.modeling.backbones.resnet import ResNet
from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.modeling.backbones.swin import SwinTransformer
from efg_tpu_torch.modeling.common.layers import FLAX_NORM_EPS, MultiHeadDotProductAttention, dense
from efg_tpu_torch.models.centerpoint import resolve_device
from efg_tpu_torch.ops.box_attention import bilinear_taps
from efg_tpu_torch.ops.matcher import hungarian_match
from efg_tpu_torch.ops.ms_deform_attn import ms_deform_attn_sample
from efg_tpu_torch.ops.resize import resize
from efg_tpu_torch.parallel import ddp

SCALES = ("res3", "res4", "res5")  # the encoder's levels, high → low resolution


def _ln(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=FLAX_NORM_EPS)


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=FLAX_NORM_EPS)


def _conv(cin: int, cout: int, kernel: int, generator: Optional[torch.Generator] = None) -> Conv2d:
    """flax `nn.Conv` as the pixel decoder uses it: f32, bias, padding
    k // 2, lecun-normal kernel."""
    conv = Conv2d(cin, cout, kernel, padding=kernel // 2, bias=True, dtype=None,
                  generator=generator)
    std = math.sqrt(1.0 / (cin * kernel * kernel)) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    return conv


def _normal(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    """flax `initializers.normal(1.0)`."""
    return nn.Parameter(torch.randn(shape, generator=generator))


class MSDeformAttnLayer(nn.Module):
    def __init__(self, d_model: int = 256, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4, dim_feedforward: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.sampling_offsets = dense(d_model, num_heads * num_levels * num_points * 2,
                                      kernel="zeros", generator=g)
        self.attention_weights = dense(d_model, num_heads * num_levels * num_points,
                                       kernel="zeros", generator=g)
        self.value_proj = dense(d_model, d_model, kernel="xavier", generator=g)
        self.output_proj = dense(d_model, d_model, kernel="xavier", generator=g)
        self.norm1 = _ln(d_model)
        self.linear1 = dense(d_model, dim_feedforward, generator=g)
        self.linear2 = dense(dim_feedforward, d_model, generator=g)
        self.norm2 = _ln(d_model)

    def forward(self, src, pos, shapes: Sequence[Tuple[int, int]], ref_points):
        """src, pos [B, L, C] over the flattened levels; ref_points [L, 2]
        normalized (x, y)."""
        b, l, _ = src.shape
        nh, nl, np_ = self.num_heads, self.num_levels, self.num_points
        q = src + pos
        off = self.sampling_offsets(q).reshape(b, l, nh, nl, np_, 2)
        attn = torch.softmax(self.attention_weights(q).reshape(b, l, nh, nl * np_), dim=-1)
        attn = attn.reshape(b, l, nh, nl, np_)
        value = self.value_proj(src)
        wh = torch.tensor([[w, h] for (h, w) in shapes], dtype=torch.float32, device=src.device)
        loc = ref_points[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
        levels, start = [], 0
        for h, w in shapes:
            levels.append(value[:, start:start + h * w].reshape(b, h, w, -1))
            start += h * w
        sampled = self.output_proj(ms_deform_attn_sample(levels, loc, attn, num_heads=nh))
        src = self.norm1(src + sampled)
        ff = self.linear2(torch.relu(self.linear1(src)))
        return self.norm2(src + ff)


def reference_points(shapes: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """Each level's cell centres, normalized (x, y), levels one after
    another: [Σ h·w, 2]."""
    refs = []
    for h, w in shapes:
        ry, rx = torch.meshgrid((torch.arange(h, device=device) + 0.5) / h,
                                (torch.arange(w, device=device) + 0.5) / w, indexing="ij")
        refs.append(torch.stack([rx.reshape(-1), ry.reshape(-1)], dim=-1))
    return torch.cat(refs, dim=0).float()


class PixelDecoder(nn.Module):
    """MSDeformAttn encoder over res3-res5 + FPN fuse to res2."""

    def __init__(self, in_channels: Dict[str, int], d_model: int = 256, num_layers: int = 6,
                 mask_dim: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.d_model, self.num_layers = d_model, num_layers
        for f in SCALES:
            setattr(self, f"input_proj_{f}", _conv(in_channels[f], d_model, 1, g))
            setattr(self, f"input_gn_{f}", _gn(d_model))
        self.level_embed = _normal((3, d_model), g)
        self.flax_params = ("level_embed",)
        for i in range(num_layers):
            setattr(self, f"layer{i}", MSDeformAttnLayer(d_model, generator=g))
        self.adapter_res2 = _conv(in_channels["res2"], d_model, 1, g)
        self.adapter_gn = _gn(d_model)
        self.fuse_res2 = _conv(d_model, d_model, 3, g)
        self.fuse_gn = _gn(d_model)
        self.mask_features = _conv(d_model, mask_dim, 3, g)

    def forward(self, feats: Dict[str, torch.Tensor]):
        """feats {res_k: NCHW} → (mask features [B, D, H/4, W/4] NCHW, the
        encoder's res3-res5 outputs as NHWC maps [B, h, w, d])."""
        d = self.d_model
        levels, poss, shapes = [], [], []
        for f in SCALES:
            x = getattr(self, f"input_gn_{f}")(getattr(self, f"input_proj_{f}")(feats[f]))
            x = x.permute(0, 2, 3, 1)  # NHWC
            levels.append(x)
            poss.append(position_embedding_sine(x, d // 2))
            shapes.append(tuple(x.shape[1:3]))
        b = levels[0].shape[0]
        src = torch.cat([x.reshape(b, -1, d) for x in levels], dim=1)
        pos = torch.cat([p.reshape(b, -1, d) for p in poss], dim=1)
        pos = pos + torch.cat([self.level_embed[i].expand(h * w, d)
                               for i, (h, w) in enumerate(shapes)], dim=0)[None]
        ref = reference_points(shapes, src.device).to(src.dtype)
        for i in range(self.num_layers):
            src = getattr(self, f"layer{i}")(src, pos, shapes, ref)
        outs, start = [], 0
        for h, w in shapes:
            outs.append(src[:, start:start + h * w].reshape(b, h, w, d))
            start += h * w
        lat = self.adapter_gn(self.adapter_res2(feats["res2"]))
        up = resize(outs[0].permute(0, 3, 1, 2), lat.shape, "nearest")
        y = torch.relu(self.fuse_gn(self.fuse_res2(lat + up)))
        return self.mask_features(y), outs


class DecoderLayerM2F(nn.Module):
    """Masked cross-attention → self-attention → FFN, each followed by its
    residual and LayerNorm."""

    def __init__(self, d_model: int = 256, num_heads: int = 8, dim_feedforward: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cross_attn = MultiHeadDotProductAttention(d_model, num_heads, generator=g)
        self.norm1 = _ln(d_model)
        self.self_attn = MultiHeadDotProductAttention(d_model, num_heads, generator=g)
        self.norm2 = _ln(d_model)
        self.linear1 = dense(d_model, dim_feedforward, generator=g)
        self.linear2 = dense(dim_feedforward, d_model, generator=g)
        self.norm3 = _ln(d_model)

    def forward(self, queries, q_pos, memory, m_pos, attn_mask):
        x = self.cross_attn(queries + q_pos, memory + m_pos, memory, mask=attn_mask)
        queries = self.norm1(queries + x)
        qp = queries + q_pos
        queries = self.norm2(queries + self.self_attn(qp, qp, queries))
        ff = self.linear2(torch.relu(self.linear1(queries)))
        return self.norm3(queries + ff)


class Mask2Former(nn.Module):
    """Built on `device` (default: the card), its initial weights drawn on
    the CPU from `generator`. `backbone` "resnet" (FrozenBN ResNet of
    `depth`) or "swin" (`swin_cfg`: SwinTransformer's keyword arguments)."""

    def __init__(self, num_classes: int = 80, num_queries: int = 100, d_model: int = 256,
                 dec_layers: int = 9, depth: int = 50, freeze_at: int = 0,
                 mask_threshold_for_attn: float = 0.5, backbone: str = "resnet",
                 swin_cfg: Optional[Dict[str, Any]] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator
        self.num_classes, self.num_queries, self.d_model = num_classes, num_queries, d_model
        self.dec_layers, self.mask_threshold_for_attn = dec_layers, mask_threshold_for_attn
        out = ("res2", "res3", "res4", "res5")
        if backbone == "swin":
            self.backbone = SwinTransformer(out_features=out, generator=g, **dict(swin_cfg or {}))
        else:
            self.backbone = ResNet(depth=depth, out_features=out, freeze_at=freeze_at,
                                   generator=g)
        self.pixel_decoder = PixelDecoder(self.backbone.out_channels, d_model, mask_dim=d_model,
                                          generator=g)
        self.query_feat = _normal((num_queries, d_model), g)
        self.query_embed = _normal((num_queries, d_model), g)
        self.flax_params = ("query_feat", "query_embed")
        self.decoder_norm = _ln(d_model)
        self.class_embed = dense(d_model, num_classes + 1, generator=g)
        for i in range(3):
            setattr(self, f"mask_embed{i}", dense(d_model, d_model, generator=g))
        for i in range(dec_layers):
            setattr(self, f"dec{i}", DecoderLayerM2F(d_model, generator=g))
        self.to(device)

    def features(self, images: torch.Tensor, generator: Optional[torch.Generator] = None):
        """NHWC images → the trunk's {res2..res5} NCHW maps."""
        x = images.permute(0, 3, 1, 2).contiguous()
        if isinstance(self.backbone, SwinTransformer):
            return self.backbone(x, generator)
        return self.backbone(x)

    def predict_heads(self, queries, mask_features):
        x = self.decoder_norm(queries)
        cls = self.class_embed(x)
        memb = torch.relu(self.mask_embed0(x))
        memb = self.mask_embed2(torch.relu(self.mask_embed1(memb)))
        return cls, torch.einsum("bqc,bchw->bqhw", memb, mask_features)

    def decode(self, mask_features: torch.Tensor, scales: List[torch.Tensor]) -> Dict[str, Any]:
        """The masked-attention decoder over the pixel decoder's outputs."""
        b, d, q = mask_features.shape[0], self.d_model, self.num_queries
        queries = self.query_feat[None].expand(b, q, d)
        q_pos = self.query_embed[None].expand(b, q, d)
        cls, masks = self.predict_heads(queries, mask_features)
        all_cls, all_masks = [cls], [masks]
        mems, mposs, mshapes = [], [], []
        for x in reversed(scales):  # res5, res4, res3
            mems.append(x.reshape(b, -1, d))
            mposs.append(position_embedding_sine(x, d // 2).reshape(b, -1, d))
            mshapes.append(tuple(x.shape[1:3]))
        for i in range(self.dec_layers):
            s = i % 3
            h, w = mshapes[s]
            with torch.no_grad():
                am = resize(masks.detach(), (b, q, h, w), "bilinear")
                am = (torch.sigmoid(am) > self.mask_threshold_for_attn).reshape(b, 1, q, h * w)
                am = am | ~am.any(dim=-1, keepdim=True)
            queries = getattr(self, f"dec{i}")(queries, q_pos, mems[s], mposs[s], am)
            cls, masks = self.predict_heads(queries, mask_features)
            all_cls.append(cls)
            all_masks.append(masks)
        return dict(cls_logits=torch.stack(all_cls), mask_logits=torch.stack(all_masks))

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        mask_features, scales = self.pixel_decoder(self.features(images, generator))
        return self.decode(mask_features, scales)


# ---------------------------------------------------------------------------
# Criterion
# ---------------------------------------------------------------------------


def _taps(points: torch.Tensor, h: int, w: int):
    """The four bilinear taps of normalized (x, y) points [..., K, 2]
    (align_corners False): `bilinear_taps`' (flat index, weight) pairs
    [..., K]."""
    return bilinear_taps(points[..., 0] * w - 0.5, points[..., 1] * h - 0.5, h, w)


def sample_points(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """masks [..., H, W], one point set [K, 2] normalized (x, y) → [..., K]:
    bilinear, zero-padded (the reference `point_sample`)."""
    h, w = masks.shape[-2:]
    flat = masks.reshape(masks.shape[:-2] + (h * w,))
    out = 0.0
    for idx, wgt in _taps(points, h, w):
        out = out + flat[..., idx] * wgt
    return out


def sample_points_each(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """masks [N, H, W], a point set each [N, K, 2] → [N, K]."""
    h, w = masks.shape[-2:]
    flat = masks.reshape(masks.shape[0], h * w)
    out = 0.0
    for idx, wgt in _taps(points, h, w):
        out = out + torch.gather(flat, 1, idx) * wgt
    return out


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest of each row, the lower index first on
    ties (`jax.lax.top_k`'s order): a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def uncertainty_point_coords(generator: Optional[torch.Generator], coarse_logits: torch.Tensor, *,
                             num_points: int, oversample_ratio: float,
                             importance_sample_ratio: float, cand: Optional[torch.Tensor] = None,
                             rand_points: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PointRend importance sampling: num_points·oversample uniform
    candidates per prediction [..., H, W], the importance_ratio·num_points
    most uncertain (−|logit| sampled there) kept, topped up with fresh
    uniform points → [..., num_points, 2]. `cand` [..., n_over, 2] and
    `rand_points` [N, n_rand, 2] replace the draws."""
    lead = coarse_logits.shape[:-2]
    dev = coarse_logits.device
    n_over = int(num_points * oversample_ratio)
    n_imp = int(num_points * importance_sample_ratio)
    n_rand = num_points - n_imp
    if cand is None:
        cand = torch.rand(lead + (n_over, 2), generator=generator, device=dev)
    flat_masks = coarse_logits.reshape((-1,) + coarse_logits.shape[-2:])
    flat_cand = cand.reshape(-1, n_over, 2)
    unc = -torch.abs(sample_points_each(flat_masks, flat_cand))
    idx = top_k_indices(unc, n_imp)
    out = torch.gather(flat_cand, 1, idx[..., None].expand(-1, -1, 2))
    if n_rand > 0:
        if rand_points is None:
            rand_points = torch.rand((flat_cand.shape[0], n_rand, 2), generator=generator,
                                     device=dev)
        out = torch.cat([out, rand_points.reshape(-1, n_rand, 2)], dim=1)
    return out.reshape(lead + (num_points, 2))


def _bce_logits(logits, targets):
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def _dice_loss(inputs, targets, eps: float = 1.0):
    num = 2 * (inputs * targets).sum(-1)
    den = inputs.sum(-1) + targets.sum(-1)
    return 1 - (num + eps) / (den + eps)


def query_targets(assign: torch.Tensor, ok: torch.Tensor, gt_cls: torch.Tensor, num_queries: int,
                  num_classes: int) -> torch.Tensor:
    """Each query's target class [B, Q]: efg_tpu's scatter `tgt.at[b, a]
    .set(where(ok, gt_cls, num_classes))` with a = where(ok, assign, 0).
    Its padding slots write `num_classes` to query 0 too; where slots
    collide, the last slot's write stands, as XLA's CPU scatter applies
    them in order (so a query 0 matched to a GT reads no-object whenever a
    padding slot follows; ROADMAP lists it among efg_tpu's behaviours).
    Written without a scatter, whose order on the card is not defined."""
    a = torch.where(ok, assign, torch.zeros_like(assign))
    vals = torch.where(ok, gt_cls, torch.full_like(gt_cls, num_classes))
    g = a.shape[1]
    hit = a[:, :, None] == torch.arange(num_queries, device=a.device)  # [B, G, Q]
    slot = torch.arange(g, device=a.device)[None, :, None]
    last = torch.where(hit, slot, torch.full_like(slot, -1)).amax(dim=1)  # [B, Q]
    written = torch.gather(vals, 1, last.clamp(min=0))
    return torch.where(last >= 0, written, torch.full_like(written, num_classes))


def classification_loss(cls_logits, assign, ok, gt_cls, *, num_classes, no_obj):
    """Matched queries take their GT's class, the rest no-object; the CE
    weighted (no-object: `no_obj`) and divided by the global batch's
    weight sum."""
    b, qn, _ = cls_logits.shape
    tgt = query_targets(assign, ok, gt_cls, qn, num_classes)
    weights = torch.where(tgt == num_classes, no_obj, 1.0).to(cls_logits.dtype)
    ce = -torch.gather(torch.log_softmax(cls_logits, dim=-1), -1, tgt[..., None])[..., 0]
    return (ce * weights).sum() / ddp.global_sum(weights.sum())


def point_mask_losses(mp, gt_p, ok, *, num_points, num_boxes):
    """Point-sampled BCE and dice over the matched pairs: per pair
    point-mean BCE and dice, summed and divided by the GT count."""
    okf = ok[..., None].to(mp.dtype)
    loss_bce = (_bce_logits(mp, gt_p) * okf).sum() / (num_points * num_boxes)
    loss_dice = (_dice_loss(torch.sigmoid(mp), gt_p) * ok.to(mp.dtype)).sum() / num_boxes
    return loss_bce, loss_dice


def matcher_cost(prob, pred_pts, gt_cls, gt_pts, gt_ok, *, w_ce, w_bce, w_dice, num_points):
    """The Hungarian cost [..., Q, G] of predictions prob [..., Q, C+1] and
    pred_pts [..., Q, K] against the GT gt_cls [B, G], gt_pts [B, G, K]
    (leading axes broadcast over the batch's): −prob at the GT class,
    point-mean BCE and dice over the shared points; 1e8 at padding."""
    q = prob.shape[-2]
    cols = gt_cls.long()[..., None, :].expand(prob.shape[:-2] + (q, gt_cls.shape[-1]))
    cost_cls = -torch.gather(prob, -1, cols)
    bce_pos = _bce_logits(pred_pts, torch.ones_like(pred_pts))
    bce_neg = _bce_logits(pred_pts, torch.zeros_like(pred_pts))
    gt_t = gt_pts.transpose(-1, -2)
    cost_bce = (bce_pos @ gt_t + bce_neg @ (1 - gt_t)) / num_points
    sig = torch.sigmoid(pred_pts)
    num = 2 * (sig @ gt_t)
    den = sig.sum(-1, keepdim=True) + gt_pts.sum(-1)[..., None, :]
    cost_dice = 1 - (num + 1) / (den + 1)
    c = w_ce * cost_cls + w_bce * cost_bce + w_dice * cost_dice
    return torch.where(gt_ok[..., None, :], c, torch.full_like(c, 1e8))


@torch.no_grad()
def match_layers(cls_all, masks_all, gt_cls, gt_pts, gt_ok, pts, *, w_ce, w_bce, w_dice):
    """Every layer's Hungarian assignment [D, B, G] (query per GT, −1 at
    padding) of the stacked predictions cls_all [D, B, Q, C+1], masks_all
    [D, B, Q, h, w] against the GT's points gt_pts [B, G, K] at the shared
    points pts [K, 2]: the D·B cost matrices solved in one host call."""
    d, b = cls_all.shape[:2]
    cost = matcher_cost(torch.softmax(cls_all, dim=-1), sample_points(masks_all, pts), gt_cls,
                        gt_pts, gt_ok, w_ce=w_ce, w_bce=w_bce, w_dice=w_dice,
                        num_points=pts.shape[0])  # [D, B, Q, G]
    assign = hungarian_match(cost.reshape((d * b,) + cost.shape[2:]), gt_ok.repeat(d, 1))
    return assign.reshape(d, b, gt_ok.shape[1])


def pair_draws(generator: torch.Generator, b: int, g: int, num_points: int, oversample_ratio: float,
               importance_sample_ratio: float, device):
    """One layer's candidate [b, g, n_over, 2] and top-up [b·g, n_rand, 2]
    points for b images of g GT slots, drawn at the global batch (the
    ranks' rows of one draw under data parallelism)."""
    n_over = int(num_points * oversample_ratio)
    n_rand = num_points - int(num_points * importance_sample_ratio)
    bg, r0 = ddp.global_batch(b)
    cand = torch.rand((bg, g, n_over, 2), generator=generator, device=device)[r0:r0 + b]
    rand = torch.rand((bg, g, n_rand, 2), generator=generator, device=device)[r0:r0 + b]
    return cand, rand.reshape(b * g, n_rand, 2)


def compute_loss(preds: Dict[str, Any], batch: Dict[str, Any], *, model_cfg: Dict[str, Any],
                 generator: Optional[torch.Generator] = None,
                 points: Optional[torch.Tensor] = None,
                 cand: Optional[Sequence[torch.Tensor]] = None,
                 rand_points: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """batch: gt_masks [B, G, H/4, W/4] float at mask scale, gt_classes_seg
    [B, G] 0-based, gt_mask_valid [B, G]. Draws the shared points [K, 2]
    and, layer by layer, the candidate and top-up points from `generator`
    (one seeded 0 on the predictions' device when None; `pair_draws`);
    `points` and per-layer `cand` / `rand_points` lists replace the draws
    (efg_tpu's: `uniform(rng)` and `split(fold_in(rng, li + 1))`)."""
    num_classes = model_cfg["num_classes"]
    num_points = int(model_cfg.get("num_points", 4096))
    w_ce = model_cfg.get("class_weight", 2.0)
    w_bce = model_cfg.get("mask_weight", 5.0)
    w_dice = model_cfg.get("dice_weight", 5.0)
    no_obj = model_cfg.get("no_object_weight", 0.1)
    over = model_cfg.get("oversample_ratio", 3.0)
    imp = model_cfg.get("importance_sample_ratio", 0.75)

    cls_all, masks_all = preds["cls_logits"], preds["mask_logits"]
    dev = masks_all.device
    gt_masks = batch["gt_masks"].float()
    gt_cls = batch["gt_classes_seg"].long()
    gt_ok = batch["gt_mask_valid"].bool()
    num_boxes = torch.clamp(ddp.global_sum(gt_ok.sum().float()), min=1.0)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pts = points if points is not None else torch.rand((num_points, 2), generator=generator,
                                                        device=dev)
    gt_pts = sample_points(gt_masks, pts)  # [B, G, K]

    d, b = cls_all.shape[:2]
    g = gt_ok.shape[1]
    assign_all = match_layers(cls_all, masks_all, gt_cls, gt_pts, gt_ok, pts,
                              w_ce=w_ce, w_bce=w_bce, w_dice=w_dice)

    losses: Dict[str, torch.Tensor] = {}
    for li in range(d):
        cls_logits, mask_logits = cls_all[li], masks_all[li]
        assign = assign_all[li]
        ok = assign >= 0
        a = torch.where(ok, assign, torch.zeros_like(assign))
        loss_ce = classification_loss(cls_logits, assign, ok, gt_cls, num_classes=num_classes,
                                      no_obj=no_obj)
        hw = mask_logits.shape[-2:]
        matched = torch.gather(mask_logits, 1, a[:, :, None, None].expand((b, g) + hw))
        with torch.no_grad():
            if cand is None:  # drawn at the global batch, this rank's rows kept
                c_li, r_li = pair_draws(generator, b, g, num_points, over, imp, dev)
            else:
                c_li, r_li = cand[li], rand_points[li]
            coords = uncertainty_point_coords(
                generator, matched.detach(), num_points=num_points, oversample_ratio=over,
                importance_sample_ratio=imp, cand=c_li, rand_points=r_li)
            gt_p = sample_points_each(gt_masks.reshape((-1,) + gt_masks.shape[2:]),
                                      coords.reshape(b * g, num_points, 2)).reshape(b, g, -1)
        mp = sample_points_each(matched.reshape((-1,) + hw),
                                coords.reshape(b * g, num_points, 2)).reshape(b, g, -1)
        loss_bce, loss_dice = point_mask_losses(mp, gt_p, ok, num_points=num_points,
                                                num_boxes=num_boxes)
        sfx = "" if li == d - 1 else f"_{li}"
        losses[f"loss_ce{sfx}"] = w_ce * loss_ce
        losses[f"loss_mask{sfx}"] = w_bce * loss_bce
        losses[f"loss_dice{sfx}"] = w_dice * loss_dice
    losses["loss"] = sum(losses.values())
    return losses


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def predict_instance(preds, *, model_cfg, top_k: int = 100):
    """The top_k (query, class) pairs by class probability, their masks
    (logit > 0), scores rescored by the mean mask probability inside the
    mask."""
    num_classes = model_cfg["num_classes"]
    cls_logits, mask_logits = preds["cls_logits"][-1], preds["mask_logits"][-1]
    scores_all = torch.softmax(cls_logits, dim=-1)[..., :num_classes]
    b, qn, c = scores_all.shape
    flat = scores_all.reshape(b, qn * c)
    idx = top_k_indices(flat, min(top_k, qn * c))
    scores = torch.gather(flat, 1, idx)
    qidx, labels = idx // c, idx % c
    masks = torch.gather(mask_logits, 1, qidx[:, :, None, None].expand(
        (b, idx.shape[1]) + mask_logits.shape[-2:]))
    mask_bin = masks > 0
    quality = (torch.sigmoid(masks) * mask_bin).sum((-2, -1)) / torch.clamp(
        mask_bin.sum((-2, -1)), min=1)
    return dict(scores=scores * quality, labels=labels, masks=mask_bin,
                valid=torch.ones_like(labels, dtype=torch.bool))


def predict_panoptic(preds, *, model_cfg, object_mask_threshold: float = 0.8,
                     overlap_threshold: float = 0.8):
    """The per-pixel winning query (`pan_seg` [B, h, w]: query index + 1,
    0 void), each query's best class score and label, and `pan_keep`: the
    queries confident enough whose mask survives the overlap filter. The
    host assembles segments from these (`assemble_panoptic`)."""
    num_classes = model_cfg["num_classes"]
    cls_logits, mask_logits = preds["cls_logits"][-1], preds["mask_logits"][-1]
    probs = torch.softmax(cls_logits, dim=-1)
    scores = probs[..., :num_classes].amax(dim=-1)
    labels = probs[..., :num_classes].argmax(dim=-1)  # the first best class, as jnp.argmax
    keep = (labels != num_classes) & (scores > object_mask_threshold)
    mask_probs = torch.sigmoid(mask_logits)
    weighted = mask_probs * torch.where(keep, scores, torch.zeros_like(scores))[:, :, None, None]
    winner = weighted.argmax(dim=1)  # the first best query, as jnp.argmax
    winner_prob = weighted.amax(dim=1)
    win_mask_prob = torch.gather(mask_probs, 1, winner[:, None])[:, 0]
    valid_px = (winner_prob > 0) & (win_mask_prob >= 0.5)
    pan_seg = torch.where(valid_px, winner + 1, torch.zeros_like(winner))
    b, qn = keep.shape
    orig_area = (mask_probs >= 0.5).sum((-2, -1))
    final_area = torch.stack([torch.bincount(pan_seg[i].reshape(-1), minlength=qn + 1)[1:]
                              for i in range(b)])
    survive = final_area / torch.clamp(orig_area, min=1)
    keep = keep & (survive > overlap_threshold) & (final_area > 0)
    return dict(pan_seg=pan_seg, pan_scores=scores, pan_labels=labels, pan_keep=keep)


def predict_semantic(preds, *, model_cfg):
    """softmax(cls) ⊗ sigmoid(mask) → [B, C, h, w]."""
    num_classes = model_cfg["num_classes"]
    cls_prob = torch.softmax(preds["cls_logits"][-1], dim=-1)[..., :num_classes]
    mask_prob = torch.sigmoid(preds["mask_logits"][-1])
    return torch.einsum("bqc,bqhw->bchw", cls_prob, mask_prob)


def _model_def(config, device, generator, panoptic: bool) -> ModelDef:
    mc = config.model.mask2former
    cfg = dict(mc)
    swin_cfg = {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                for k, v in dict(mc.get("swin_cfg", {}) or {}).items()}
    module = Mask2Former(
        num_classes=int(mc.num_classes), num_queries=int(mc.num_queries),
        d_model=int(mc.d_model), dec_layers=int(mc.dec_layers), depth=int(mc.depth),
        freeze_at=int(mc.freeze_at), backbone=str(mc.get("backbone", "resnet")),
        swin_cfg=swin_cfg, device=device, generator=generator)

    def loss_fn(preds, batch, rng=None):
        return compute_loss(preds, batch, model_cfg=cfg, generator=rng)

    def predict_fn(preds, batch):
        out = predict_instance(preds, model_cfg=cfg)
        if panoptic:
            out.update(predict_panoptic(preds, model_cfg=cfg))
        return out

    return ModelDef(module, lambda batch: dict(images=batch["images"]), loss_fn, predict_fn)


def build_model(config, device="cuda", generator=None) -> ModelDef:
    """The synthetic experiment's `build_model`: Mask2Former from the
    config's `model.mask2former`, `predict_instance` as its predict_fn.
    Its loss declares `rng`, so the trainer hands it the step's
    generator."""
    return _model_def(config, device, generator, panoptic=False)


def build_panoptic_model(config, device="cuda", generator=None) -> ModelDef:
    """The COCO panoptic experiments' `build_model` (ResNet or Swin trunk):
    as `build_model`, with `predict_panoptic`'s outputs beside
    `predict_instance`'s."""
    return _model_def(config, device, generator, panoptic=True)
