"""`build_model` of the experiment
`playground/tracking.3d/waymo/trajectoryformer/trajectoryformer.centerpoint`
for the port (the counterpart of its `net.py`): `models/trajectoryformer.py`
`build_model`, the TrajectoryFormer detection form with the graft of
`model.motion_model` when the config names one."""

from efg_tpu_torch.models.trajectoryformer import build_model  # noqa: F401
