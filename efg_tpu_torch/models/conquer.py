"""ConQueR: Voxel-DETR + contrastive denoising + momentum GT decoder +
query-contrast InfoNCE (port of `efg_tpu/models/conquer.py`).

`ConQueRModule` holds the Voxel-DETR trunk and the contrastive projector
and predictor, with efg_tpu's parameter names (`detr`, `projector`,
`predictor`), so a flax ConQueR tree maps onto it leaf for leaf. Serving
runs the trunk and `predict`. Training (`conquer_train_loss`, the
ModelDef's `custom_loss`) adds `dn_number` groups of noised GT queries in
front of the top-k ones, each group 2·G_max slots (G_max positives, then
G_max negatives; invalid GT slots masked out of the losses), runs the
decoder a second time with its EMA ("momentum") weights on the clean and
positive-noised GT proposals, and adds the denoising and query-contrast
losses to Voxel-DETR's. As efg_tpu, every valid GT is matched by its
denoising queries (the reference drops the last one, `losses.py:160`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.geometry.box_ops_torch import aligned_giou_3d_pairs
from efg_tpu_torch.models import voxel_detr as VD
from efg_tpu_torch.parallel import ddp


class _ProjMLP(nn.Module):
    """Linear-ReLU-Linear projector / predictor."""

    def __init__(self, cin: int, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = VD.dense(cin, dim, generator=generator)
        self.fc1 = VD.dense(dim, dim, generator=generator)

    def forward(self, x):
        return self.fc1(torch.relu(self.fc0(x)))


class ConQueRModule(nn.Module):
    """The DETR trunk plus the contrastive projector / predictor."""

    def __init__(self, detr: VD.VoxelDETR, contras_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.detr = detr
        device = next(detr.parameters()).device
        self.projector = _ProjMLP(detr.num_classes + 7, contras_dim, generator).to(device)
        self.predictor = _ProjMLP(contras_dim, contras_dim, generator).to(device)

    def forward(self, points, points_mask, dn_ref=None, dn_attn_mask=None) -> Dict[str, Any]:
        return self.detr(points, points_mask, dn_ref=dn_ref, dn_attn_mask=dn_attn_mask)


# ---------------------------------------------------------------------------
# Contrastive denoising query construction (reference `cdn.py:5-139`)
# ---------------------------------------------------------------------------


def prepare_cdn(gt_boxes_norm: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None, *, dn_number: int,
                label_noise_ratio: float, box_noise_scale: float, num_classes: int,
                num_queries: int, noise_override: Optional[Dict[str, torch.Tensor]] = None):
    """gt_boxes_norm [B, G, 7], gt_labels [B, G] 0-based, gt_mask [B, G] →
    (dn_ref [B, P, 10] with P = 2·G·dn_number, attn_mask [P+Q, P+Q] bool,
    True = may attend, dn_valid [B, P]).

    The noise is drawn from `generator`, on the boxes' device: flip [B, P]
    (a label replaced w.p. ratio/2), rand_lbl [B, P], sign [B, P, 7] ±1 and
    rand [B, P, 7] uniform. Under data parallelism each is drawn for the
    global batch and this rank's rows are taken, so rank r gets the r-th
    slice of what one process draws for the whole batch. `noise_override` (tests) gives those four
    tensors instead, so the construction can be held bit for bit against
    efg_tpu's under its own draws."""
    b, g, _ = gt_boxes_norm.shape
    p = 2 * g * dn_number
    dev, dtype = gt_boxes_norm.device, gt_boxes_norm.dtype
    boxes = gt_boxes_norm.repeat(1, 2 * dn_number, 1)  # groups × (pos, neg) × G
    labels = gt_labels.repeat(1, 2 * dn_number)
    valid = gt_mask.repeat(1, 2 * dn_number)
    half = torch.cat([torch.zeros(g, dtype=torch.bool, device=dev),
                      torch.ones(g, dtype=torch.bool, device=dev)])
    is_neg = half.repeat(dn_number)[None, :]  # [1, P]: the second half of each group

    if noise_override is not None:
        flip, rand_lbl = noise_override["flip"], noise_override["rand_lbl"]
        sign, rand = noise_override["sign"].to(dtype), noise_override["rand"]
    else:
        bg, r0 = ddp.global_batch(b)
        rows = slice(r0, r0 + b)
        flip = (torch.rand((bg, p), generator=generator, device=dev)[rows]
                < label_noise_ratio * 0.5)
        rand_lbl = torch.randint(0, num_classes, (bg, p), generator=generator, device=dev)[rows]
        sign = (torch.randint(0, 2, (bg, p, 7), generator=generator, device=dev)[rows].to(dtype)
                * 2 - 1)
        rand = torch.rand((bg, p, 7), generator=generator, device=dev, dtype=dtype)[rows]
    noised_labels = torch.where(flip.bool(), rand_lbl.to(labels.dtype), labels)

    # box noise in corner form for xyz, direct for the rest; negatives pushed out
    lo = boxes[..., :3] - boxes[..., 3:6] / 2
    hi = boxes[..., :3] + boxes[..., 3:6] / 2
    diff = torch.cat([boxes[..., 3:6] / 2, boxes[..., 3:6] / 2,
                      torch.full_like(boxes[..., 6:7], 0.1)], dim=-1)
    rand = rand + is_neg[..., None].to(rand.dtype)
    noise = sign * rand * diff * box_noise_scale
    corner = torch.clamp(torch.cat([lo, hi, boxes[..., 6:7]], dim=-1) + noise, 0.0, 1.0)
    noised = torch.cat([(corner[..., :3] + corner[..., 3:6]) / 2,
                        corner[..., 3:6] - corner[..., :3], corner[..., 6:7]], dim=-1)

    onehot = nn.functional.one_hot(noised_labels.long(), num_classes).to(dtype)
    dn_ref = torch.cat([noised, onehot], dim=-1) * valid[..., None].to(dtype)

    # attention mask: groups see only themselves; queries see only queries
    t = torch.arange(p + num_queries, device=dev)
    group = torch.where(t >= p, torch.full_like(t, dn_number), t // (2 * g))
    return dn_ref, group[:, None] == group[None, :], valid


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def dn_loss(dn_logits: torch.Tensor, dn_boxes: torch.Tensor, tgt_boxes: torch.Tensor,
            tgt_labels: torch.Tensor, tgt_mask: torch.Tensor, num_boxes: torch.Tensor,
            mw: Dict[str, float], dn_number: int) -> Dict[str, torch.Tensor]:
    """Denoising loss: identity matching — positive slot i of every group
    reconstructs GT i (reference `Det3DLoss.forward`, dn branch).
    dn_logits [D, B, P, C], dn_boxes [D, B, P, 7]."""
    d, b, p, c = dn_logits.shape
    g = p // (2 * dn_number)
    dev = dn_logits.device
    pos_slots = (torch.arange(dn_number, device=dev)[:, None] * 2 * g
                 + torch.arange(g, device=dev)[None, :]).reshape(-1)  # [dn·G]
    norm = num_boxes * dn_number
    tiled_boxes = tgt_boxes.repeat(1, dn_number, 1)
    tiled_labels = torch.clamp(tgt_labels.long().repeat(1, dn_number), 0, c - 1)
    tiled_mask = tgt_mask.repeat(1, dn_number)
    rows = torch.arange(b, device=dev)[:, None]
    losses: Dict[str, torch.Tensor] = {}
    for li in range(d):
        logits, boxes = dn_logits[li], dn_boxes[li]
        onehot = logits.new_zeros(b, p, c)
        onehot[rows, pos_slots[None, :], tiled_labels] = tiled_mask.to(logits.dtype)
        loss_ce = VD.sigmoid_focal_loss(logits, onehot).sum() / norm

        pb = boxes[:, pos_slots]  # [B, dn·G, 7]
        okf = tiled_mask[..., None].to(boxes.dtype)
        loss_bbox = ((pb[..., :6] - tiled_boxes[..., :6]).abs() * okf).sum() / norm
        loss_rad = ((pb[..., 6:] - tiled_boxes[..., 6:]).abs() * okf).sum() / norm
        giou = aligned_giou_3d_pairs(pb, tiled_boxes)
        loss_giou = ((1 - giou) * tiled_mask.to(giou.dtype)).sum() / norm

        sfx = "_dn" if li == d - 1 else f"_dn_{li}"
        losses["loss_ce" + sfx] = mw["class"] * loss_ce
        losses["loss_bbox" + sfx] = mw["bbox"] * loss_bbox
        losses["loss_giou" + sfx] = mw["giou"] * loss_giou
        losses["loss_rad" + sfx] = mw["rad"] * loss_rad
    return losses


def query_contrast_loss(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                        gt_logits: torch.Tensor, gt_boxes_out: torch.Tensor,
                        assign: torch.Tensor, gt_mask: torch.Tensor, *, projector: nn.Module,
                        predictor: nn.Module, tau: float, dn_number: int) -> torch.Tensor:
    """InfoNCE between the momentum decoder's GT embeddings (positives: the
    noised copies of the same GT) and the matched queries' embeddings
    (reference `voxel_detr.py:222-254`). pred_* [B, Q, ·] of one decoder
    layer, gt_* [B, (dn+1)·G, ·], assign [B, G] (−1 at padding). The GT
    branch's input is detached; the projector still learns from it. The
    sum is over the global batch's GT count (`ddp.global_sum`)."""
    b, q, _ = pred_logits.shape
    g = assign.shape[1]
    gt_proj = projector(torch.cat([gt_logits, gt_boxes_out], dim=-1).detach())
    pred_proj = predictor(projector(torch.cat([pred_logits, pred_boxes], dim=-1)))

    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)

    sim = torch.einsum("bld,bqd->blq", unit(gt_proj), unit(pred_proj)) / tau  # [B, L, Q]
    ok = assign >= 0
    a = torch.where(ok, assign, torch.zeros_like(assign))
    # negatives: the queries matched to no GT of the sample
    matched = torch.zeros(b, q + 1, dtype=torch.bool, device=sim.device)
    matched[torch.arange(b, device=sim.device)[:, None], torch.where(ok, a, q)] = True
    neg_mask = ~matched[:, :q]

    total = sim.new_zeros(())
    for pi in range(1, dn_number + 1):  # the positive (noised) groups
        row = sim[:, pi * g:(pi + 1) * g]  # [B, G, Q]
        pos = torch.gather(row, 2, a[..., None])[..., 0]  # [B, G]
        neg_exp = (torch.exp(row) * neg_mask[:, None, :].to(row.dtype)).sum(-1)
        loss = torch.log(torch.exp(pos) + neg_exp) - pos
        total = total + (loss * ok.to(loss.dtype)).sum() / dn_number
    return total / torch.clamp(ddp.global_sum(gt_mask.sum().to(sim.dtype)), min=1.0)


# ---------------------------------------------------------------------------
# The full training loss (the ModelDef's custom_loss)
# ---------------------------------------------------------------------------


def conquer_train_loss(module: ConQueRModule, ema: Optional[Dict[str, torch.Tensor]],
                       batch: Dict[str, Any], generator: Optional[torch.Generator] = None, *,
                       model_cfg: Dict[str, Any],
                       noise_override: Optional[Dict[str, torch.Tensor]] = None):
    """The forward with denoising queries, the momentum decoder (the EMA
    decoder weights `ema`, or the decoder's own where None) on the clean +
    positive-noised GT proposals, and the loss: Voxel-DETR's set losses +
    the denoising losses + query contrast per decoder layer. Returns
    (loss, losses with "loss"); the module must be in train mode."""
    cfg_dn, cfg_ct = model_cfg["dn"], model_cfg["contrastive"]
    mw = model_cfg["loss_weights"]
    detr = module.detr
    dn_number = int(cfg_dn["dn_number"])
    tgt_boxes, tgt_labels, tgt_mask, num_boxes = VD.targets(batch, model_cfg)
    dn_ref, attn_mask, _ = prepare_cdn(
        tgt_boxes, tgt_labels, tgt_mask, generator, dn_number=dn_number,
        label_noise_ratio=cfg_dn["dn_label_noise_ratio"],
        box_noise_scale=cfg_dn["dn_box_noise_scale"], num_classes=detr.num_classes,
        num_queries=detr.num_queries, noise_override=noise_override)
    preds = detr(batch["points"], batch["points_mask"], dn_ref=dn_ref, dn_attn_mask=attn_mask)

    losses, final_assign = VD.compute_loss(preds, batch, model_cfg=model_cfg, return_assign=True)
    losses.pop("loss")
    losses.update(dn_loss(preds["dn_logits"], preds["dn_boxes"], tgt_boxes, tgt_labels, tgt_mask,
                          num_boxes, mw, dn_number))

    # momentum GT decoder: the clean GT boxes, then each group's positives
    g = tgt_mask.shape[1]
    onehot_gt = nn.functional.one_hot(tgt_labels, detr.num_classes).to(tgt_boxes.dtype)
    clean_ref = torch.cat([tgt_boxes, onehot_gt], dim=-1) * tgt_mask[..., None].to(tgt_boxes.dtype)
    gt_proposals = torch.cat([clean_ref] + [dn_ref[:, 2 * g * gi:2 * g * gi + g]
                                            for gi in range(dn_number)], dim=1)
    grp = torch.arange((dn_number + 1) * g, device=tgt_boxes.device) // g
    gt_attn = grp[:, None] == grp[None, :]
    memory = [m.detach() for m in preds["memory_levels"]]
    with torch.no_grad():
        if ema is None:
            gt_logits, gt_boxes_out = detr.run_decoder(memory, gt_proposals, attn_mask=gt_attn)
        else:
            gt_logits, gt_boxes_out = functional_call(detr.decoder, ema, (memory, gt_proposals),
                                                      {"attn_mask": gt_attn})

    # the final layer's assignment (solved in compute_loss) serves every layer
    for li in range(preds["dec_logits"].shape[0]):
        closs = query_contrast_loss(
            preds["dec_logits"][li], preds["dec_boxes"][li], gt_logits[li], gt_boxes_out[li],
            final_assign, tgt_mask, projector=module.projector, predictor=module.predictor,
            tau=cfg_ct["tau"], dn_number=dn_number)
        losses[f"loss_contrastive_dec_{li}"] = cfg_ct["loss_coeff"] * closs
    loss = sum(losses.values())
    losses["loss"] = loss
    return loss, losses


# ---------------------------------------------------------------------------
# ModelDef builder
# ---------------------------------------------------------------------------


def make_model_def(detr_kwargs: Dict[str, Any], model_cfg: Dict[str, Any], *,
                   device="cuda", generator: Optional[torch.Generator] = None) -> ModelDef:
    """The ConQueR ModelDef: module, apply_args, `compute_loss` as loss_fn
    (eval paths), predict_fn, and for training the custom loss and the EMA
    momentum decoder (reference `_momentum_update_gt_decoder`,
    `transformer.py:83-89`). `model_cfg` holds pc_range, voxel_size and
    contrastive; training also loss_weights and dn."""
    detr = VD.VoxelDETR(**detr_kwargs, device=device, generator=generator)
    module = ConQueRModule(detr, contras_dim=int(model_cfg["contrastive"].get("dim", 256)),
                           generator=generator)
    mom = float(model_cfg["contrastive"].get("mom", 0.999))

    def apply_args(batch):
        return dict(points=batch["points"], points_mask=batch["points_mask"])

    def custom_loss(mod, ema, batch, generator):
        return conquer_train_loss(mod, ema, batch, generator, model_cfg=model_cfg)

    def loss_fn(preds, batch):
        return VD.compute_loss(preds, batch, model_cfg=model_cfg)

    def predict_fn(preds, batch):
        return VD.predict(preds, model_cfg=model_cfg)

    def ema_init(mod) -> Dict[str, torch.Tensor]:
        """Copies of the decoder's parameters, by their names in it."""
        return {n: p.detach().clone() for n, p in mod.detr.decoder.named_parameters()}

    @torch.no_grad()
    def ema_update(ema: Dict[str, torch.Tensor], mod) -> None:
        """e ← e·mom + p·(1 − mom) from the updated parameters, in place."""
        for n, p in mod.detr.decoder.named_parameters():
            e = ema[n]
            e.copy_(e * mom + p * (1.0 - mom))

    return ModelDef(module, apply_args, loss_fn, predict_fn, custom_loss=custom_loss,
                    ema_init=ema_init, ema_update=ema_update)


def build_model(config, device="cuda", generator=None) -> ModelDef:
    """The `build_model` of the ConQueR experiments' `net.py` (the
    synthetic one and the Waymo one): Voxel-DETR's config helpers plus the
    config's `model.dn` and `model.contrastive`."""
    cfg = VD.model_cfg(config)
    cfg["dn"] = dict(config.model.dn)
    cfg["contrastive"] = dict(config.model.contrastive)
    return make_model_def(VD.detr_kwargs(config), cfg, device=device, generator=generator)
