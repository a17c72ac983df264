"""`build_model` of the experiment
`playground/detection.3d/waymo/conquer/voxeldetr.waymo.res18.p3.bs6.epoch6`
for the port (the counterpart of its `net.py`): `models/voxel_detr.py`
`build_model`, the plain Voxel-DETR ModelDef."""

from efg_tpu_torch.models.voxel_detr import build_model  # noqa: F401
