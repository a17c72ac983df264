"""`build_model` of the experiment
`playground/detection.3d/waymo/conquer/conquer.waymo.res18.p3.dn3.tau07.bs6.epoch6`
for the port (the counterpart of its `net.py`, which takes its sibling
Voxel-DETR experiment's config helpers): `models/conquer.py`
`build_model`."""

from efg_tpu_torch.models.conquer import build_model  # noqa: F401
