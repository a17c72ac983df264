"""`build_model` of the experiment
`playground/detection.3d/nuscenes/centerpoint/centerpoint.nusc.voxelnet.cbgs.20e`
for the port (the counterpart of its `net.py`, which is the same body as
efg_tpu's other CenterPoint VoxelNet experiments'): `models/centerpoint.py`
`build_model`."""

from efg_tpu_torch.models.centerpoint import build_model  # noqa: F401
