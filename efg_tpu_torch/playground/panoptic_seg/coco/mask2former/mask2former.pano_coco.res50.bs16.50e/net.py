"""`build_model` of the experiment
`playground/panoptic_seg/coco/mask2former/mask2former.pano_coco.res50.bs16.50e`
for the port (the counterpart of its `net.py`): `models/mask2former.py`
`build_panoptic_model`, Mask2Former from the config's `model.mask2former`
with `predict_instance`'s and `predict_panoptic`'s outputs, on `device`,
its initial weights drawn from `generator`."""

from efg_tpu_torch.models.mask2former import build_panoptic_model as build_model  # noqa: F401
