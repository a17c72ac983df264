"""The Waymo DETR experiments (`playground/detection.3d/waymo/conquer`) in
the port against efg_tpu's `net.py` files, on the CPU: the shared config
helpers and the ConQueR experiment's model arguments; the plain Voxel-DETR
ModelDef from the same config (widths shrunk by dotlist) from the same
weights, its step-1 loss parts in f32 and `predict`. Both experiments
through the port's CLI: tests/test_torch_waymo_detr_cli.py."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.models import conquer as JCQ
from efg_tpu.ops import box_attention as JBA
from efg_tpu.ops import sparse as JS
from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.models import conquer as TCQ
from efg_tpu_torch.models import voxel_detr as TVD
from efg_tpu_torch.ops import box_attention as TBA
from efg_tpu_torch.ops.cuda import sparse_kernels as K
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_conquer import KW, _cloud
from test_torch_conquer_ops import fill_variables
from test_torch_conquer_train import LOSS_TOL, WEIGHT_SEED, _gt, _rel
from test_torch_waymo_data import prepare_waymo

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DETR_DIR = "playground/detection.3d/waymo/conquer"
VOXELDETR = "voxeldetr.waymo.res18.p3.bs6.epoch6"
CONQUER = "conquer.waymo.res18.p3.dn3.tau07.bs6.epoch6"
# the tiny Voxel-DETR of test_torch_conquer.py (KW) by dotlist
SHRINK = [f"dataset.pc_range=[{','.join(str(v) for v in KW['pc_range'])}]",
          f"model.max_voxels={KW['max_voxels']}",
          f"model.resnet_caps=[{','.join(str(v) for v in KW['resnet_caps'])}]",
          f"model.hidden_dim={KW['hidden_dim']}", f"model.transformer.nhead={KW['num_head']}",
          f"model.transformer.enc_layers={KW['enc_layers']}",
          f"model.transformer.dec_layers={KW['dec_layers']}",
          f"model.transformer.dim_feedforward={KW['dim_feedforward']}",
          f"model.transformer.num_queries={KW['num_queries']}"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def detr_config_files(out_root, data_root):
    """Both experiments' config.yaml under `<out_root>/playground/...`: the
    Voxel-DETR one with its `dataset.source` written out (the Waymo configs
    do not resolve as written in either package) and a `misc.seed`, and
    the ConQueR one as written, which includes its sibling by a relative
    path. Returns {experiment: path}."""
    with open(ROOT / DETR_DIR / VOXELDETR / "config.yaml") as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("includes")
    cfg["dataset"]["source"] = {
        "root": data_root, "train": "/infos_train_01sweeps_sampled.pkl",
        "val": "/infos_val_01sweeps_sampled.pkl", "test": "/infos_val_01sweeps_sampled.pkl",
        "gt_database": "/gt_database_train_01sweeps_withvelo_sampled_infos"}
    cfg["misc"] = {"seed": 42}
    paths = {}
    for exp in (VOXELDETR, CONQUER):
        paths[exp] = Path(out_root) / DETR_DIR / exp / "config.yaml"
        paths[exp].parent.mkdir(parents=True, exist_ok=True)
    paths[VOXELDETR].write_text(yaml.safe_dump(cfg))
    paths[CONQUER].write_text((ROOT / DETR_DIR / CONQUER / "config.yaml").read_text())
    return {k: str(v) for k, v in paths.items()}


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    base = tmp_path_factory.mktemp("waymo_detr")
    root = str(base / "waymo")
    prepare_waymo(root)
    return detr_config_files(str(base / "exp"), root)


def _jax_net(exp):
    """efg_tpu's `net.py` of the experiment, loaded by path."""
    path = ROOT / DETR_DIR / exp / "net.py"
    spec = importlib.util.spec_from_file_location(f"jax_net_{exp.split('.')[0]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configs(path, opts):
    return (JConfiguration(config_file=path, opts=list(opts)).get_config(),
            Configuration(config_file=path, opts=list(opts)).get_config())


def test_config_helpers_and_conquer_arguments_equal(experiments, monkeypatch):
    """`detr_kwargs` / `model_cfg` against efg_tpu's Voxel-DETR net.py, and
    the arguments each package's ConQueR net.py hands `make_model_def`
    (the sibling's helpers, the config's dn and contrastive), as written
    and shrunk."""
    jnet = _jax_net(VOXELDETR)
    for opts in ([], SHRINK):
        jc, tc = _configs(experiments[VOXELDETR], ["task=train", *opts])
        assert TVD.detr_kwargs(tc) == jnet.detr_kwargs(jc)
        assert TVD.model_cfg(tc) == jnet.model_cfg(jc)
    calls = []
    monkeypatch.setattr(JCQ, "make_model_def", lambda *a, **k: calls.append(("jax", a, k)))
    monkeypatch.setattr(TCQ, "make_model_def", lambda *a, **k: calls.append(("torch", a, k)))
    jc, tc = _configs(experiments[CONQUER], ["task=train"])
    _jax_net(CONQUER).build_model(jc)
    cli.load_experiment_module(experiments[CONQUER]).build_model(tc, device="cpu")
    (_, ja, jk), (_, ta, tk) = calls
    assert ta == ja and jk == {} and tk == {"device": "cpu", "generator": None}
    assert ta[1]["dn"]["dn_number"] == 3 and ta[1]["contrastive"]["tau"] == 0.7
    assert ta[0]["hidden_dim"] == 256 and ta[0]["num_queries"] == 1000
    assert tc.trainer.fade == jc.trainer.fade == 0.166666


def test_voxeldetr_modeldef_matches_efg_tpu(experiments):
    """The two packages' ModelDefs from the experiment's net.py on the
    shrunk config and the same weights, in f32 (sparse convs and window
    ops, as tests/test_torch_conquer_train.py runs them): the training
    forward's set-loss parts (encoder proposals and both decoder layers)
    within its LOSS_TOL; `predict` on efg_tpu's decoder outputs exactly
    efg_tpu's."""
    jc, tc = _configs(experiments[VOXELDETR], ["task=train", *SHRINK])
    pts, mask = _cloud(0)
    gt, cls, gm = _gt(20)
    batch = dict(points=pts, points_mask=mask, gt_boxes=gt, gt_classes=cls, gt_mask=gm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBA, "box_attention_window_dense_mxu", JBA.box_attention_window_dense)
        mp.setattr(JBA, "box_attention_window_gather",
                   functools.partial(JBA.box_attention_window_gather, runs=False))
        JS.set_compute_dtype(jnp.float32)
        try:
            jmd = _jax_net(VOXELDETR).build_model(jc)
            shapes = jax.eval_shape(lambda: jmd.module.init(
                jax.random.key(0), jb["points"], jb["points_mask"], True))
            variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, WEIGHT_SEED))

            @jax.jit
            def run(v, b):
                preds, _ = jmd.module.apply(v, b["points"], b["points_mask"], True,
                                            mutable=["batch_stats"])
                return jmd.loss_fn(preds, b), {k: preds[k] for k in ("dec_logits", "dec_boxes")}

            want, dec = jax.device_get(run(variables, jb))
            want_det = jax.device_get(jmd.predict_fn(dec, None))
        finally:
            JS.set_compute_dtype(jnp.bfloat16)
    tmd = cli.load_experiment_module(experiments[VOXELDETR]).build_model(tc, device="cpu")
    assert tmd.custom_loss is None and tmd.ema_init is None
    tmd.module.load_state_dict(flax_to_state_dict(tmd.module, variables))
    tmd.module.train()
    old = K.COMPUTE_DTYPE, TBA.WINDOW_DTYPE, TBA.GATHER_DOT_DTYPE
    K.COMPUTE_DTYPE = TBA.WINDOW_DTYPE = TBA.GATHER_DOT_DTYPE = torch.float32
    try:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        got = tmd.loss_fn(tmd.module(**tmd.apply_args(tb)), tb)
    finally:
        K.COMPUTE_DTYPE, TBA.WINDOW_DTYPE, TBA.GATHER_DOT_DTYPE = old
    assert set(got) == set(want) and len(got) == 4 * 3 + 1
    for k in want:
        assert _rel(got[k], want[k]) <= LOSS_TOL, (k, float(got[k]), float(want[k]))
    det = tmd.predict_fn({k: torch.from_numpy(np.array(v)) for k, v in dec.items()}, None)
    assert det["scores"].shape == (2, KW["num_queries"] * 3)
    for k in ("labels", "valid", "scores", "box3d"):
        np.testing.assert_array_equal(det[k].numpy(), want_det[k], err_msg=k)
