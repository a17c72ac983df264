"""`build_model` of the experiment
`playground/detection.3d/nuscenes/centerpoint/centerpoint.pillar.nusc_mini.1sweep`
for the port (the counterpart of its `net.py`): `models/centerpoint.py`
`build_pillar_model`, CenterPoint-Pillar."""

from efg_tpu_torch.models.centerpoint import build_pillar_model as build_model  # noqa: F401
