"""`build_model` of the experiment
`playground/detection.3d/synthetic/conquer.synth.res18` for the port (the
counterpart of its `net.py`): the ConQueR ModelDef (serving, and training
with its denoising queries, momentum decoder and losses) from the
experiment's config, on `device`, its initial weights drawn from
`generator`."""

from efg_tpu_torch.models import conquer as CQ


def _detr_kwargs(config):
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


def build_model(config, device="cuda", generator=None):
    lw = config.model.loss
    cfg = dict(
        pc_range=tuple(config.dataset.pc_range),
        voxel_size=tuple(config.dataset.voxel_size),
        loss_weights={
            "class": float(lw.class_loss_coef),
            "bbox": float(lw.bbox_loss_coef),
            "giou": float(lw.giou_loss_coef),
            "rad": float(lw.rad_loss_coef),
        },
        dn=dict(config.model.dn),
        contrastive=dict(config.model.contrastive),
    )
    return CQ.make_model_def(_detr_kwargs(config), cfg, device=device, generator=generator)
