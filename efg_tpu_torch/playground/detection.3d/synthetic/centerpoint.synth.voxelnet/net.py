"""`build_model` of the experiment
`playground/detection.3d/synthetic/centerpoint.synth.voxelnet` for the port
(the counterpart of its `net.py`): a CenterPoint VoxelNet from the
experiment's config, as a ModelDef on `device`, its initial weights drawn
from `generator`."""

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.models import centerpoint as CP


def _model_cfg(config):
    m = config.model
    return dict(
        pc_range=tuple(config.dataset.pc_range),
        voxel_size=tuple(config.dataset.voxel_size),
        tasks=[dict(t) for t in m.head.tasks],
        common_heads=tuple((k, tuple(v)) for k, v in m.head.common_heads.items()),
        loss=dict(m.loss),
    )


def build_model(config, device="cuda", generator=None):
    cfg = _model_cfg(config)
    module = CP.VoxelNet(
        pc_range=cfg["pc_range"],
        voxel_size=cfg["voxel_size"],
        max_voxels=int(config.model.max_voxels),
        num_input_features=int(config.model.reader.num_input_features),
        stage_caps=tuple(config.model.stage_caps),
        act_dtype=str(config.model.get("act_dtype", "")),
        tasks=tuple(cfg["tasks"]),
        common_heads=cfg["common_heads"],
        neck_cfg=tuple((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in config.model.neck.items()),
        device=device,
        generator=generator,
    )

    def apply_args(batch):
        return dict(points=batch["points"], points_mask=batch["points_mask"])

    def loss_fn(preds, batch):
        return CP.compute_loss(preds, batch, model_cfg=cfg)

    def predict_fn(preds, batch):
        return CP.predict(preds, post_cfg=dict(config.model.post_process), model_cfg=cfg)

    return ModelDef(module, apply_args, loss_fn, predict_fn)
