"""`build_model` of the experiment
`playground/detection.2d/synthetic/autoassign.synth.res50` for the port
(the counterpart of its `net.py`): `models/autoassign.py` `build_model`, the AutoAssign
ModelDef from the config's `model.autoassign`, on `device`, its initial weights
drawn from `generator`."""

from efg_tpu_torch.models.autoassign import build_model  # noqa: F401
