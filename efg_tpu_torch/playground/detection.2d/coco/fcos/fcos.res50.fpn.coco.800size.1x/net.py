"""`build_model` of the experiment
`playground/detection.2d/coco/fcos/fcos.res50.fpn.coco.800size.1x` for the port
(the counterpart of its `net.py`): `models/fcos.py` `build_model`, the FCOS
ModelDef from the config's `model.fcos`, on `device`, its initial weights
drawn from `generator`."""

from efg_tpu_torch.models.fcos import build_model  # noqa: F401
