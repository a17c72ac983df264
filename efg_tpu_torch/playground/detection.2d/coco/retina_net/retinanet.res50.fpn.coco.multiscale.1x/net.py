"""`build_model` of the experiment
`playground/detection.2d/coco/retina_net/retinanet.res50.fpn.coco.multiscale.1x` for the port
(the counterpart of its `net.py`): `models/retinanet.py` `build_model`, the RetinaNet
ModelDef from the config's `model.retinanet`, on `device`, its initial weights
drawn from `generator`."""

from efg_tpu_torch.models.retinanet import build_model  # noqa: F401
