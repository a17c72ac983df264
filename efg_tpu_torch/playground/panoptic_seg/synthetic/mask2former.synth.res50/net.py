"""`build_model` of the experiment
`playground/panoptic_seg/synthetic/mask2former.synth.res50` for the port
(the counterpart of its `net.py`): `models/mask2former.py` `build_model`,
Mask2Former from the config's `model.mask2former` with `predict_instance`
as its predict_fn, on `device`, its initial weights drawn from
`generator`."""

from efg_tpu_torch.models.mask2former import build_model  # noqa: F401
