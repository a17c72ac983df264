"""`build_model` of the experiment
`playground/detection.3d/synthetic/conquer.synth.res18` for the port (the
counterpart of its `net.py`): `models/conquer.py` `build_model`, the
ConQueR ModelDef (serving, and training with its denoising queries,
momentum decoder and losses) from the experiment's config, on `device`,
its initial weights drawn from `generator`."""

from efg_tpu_torch.models.conquer import build_model  # noqa: F401
