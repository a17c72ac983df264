"""`build_model` of the experiment
`playground/tracking.3d/waymo/trajectoryformer/trajectoryformer.motionpred.pretrain`
for the port (the counterpart of its `net.py`): `models/trajectoryformer.py`
`build_pretrain_model`, the motion-prediction pretrain."""

from efg_tpu_torch.models.trajectoryformer import build_pretrain_model as build_model  # noqa: F401
