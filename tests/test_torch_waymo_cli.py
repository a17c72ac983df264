"""The flagship config's own pipeline through the port's CLI on the CPU, at
the tests' widths: Waymo-format files written by the port's `create_data`,
a reference-format CenterPoint `.pth` imported through `model.weights`
(`weights_format: centerpoint`), `task=train` with `DatabaseSampling`
pasting GT crops, then `task=val` through `WaymoDetEvaluator`; and a
`detectron2://` `.pkl` taken from the download cache by the trainer."""

import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import torch

import efg_tpu_torch.data  # noqa: F401  (registrations)
from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data.processors import extend_3d as TE
from efg_tpu_torch.engine import trainer as T
from efg_tpu_torch.utils import torch_import as TTI
from efg_tpu_torch.utils.catalog import Detectron2Handler, PathManager

from test_torch_waymo_data import prepare_waymo, waymo_config_file
from test_torch_weight_import import reference_state_dict

NECK = (("layer_nums", (1, 1)), ("ds_layer_strides", (1, 2)), ("ds_num_filters", (32, 64)),
        ("us_layer_strides", (1, 2)), ("us_num_filters", (32, 32)))  # the fixture config's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    base = tmp_path_factory.mktemp("waymo_cli")
    root = str(base / "waymo")
    prepare_waymo(root)
    return str(base), waymo_config_file(str(base / "exp"), root)


def _expected_state(module, sd):
    """The module's tensors after the import, mapped by hand from `sd`."""
    want = {k: v.clone() for k, v in module.state_dict().items()}
    n, skipped = TTI.import_centerpoint_voxelnet(sd, module)
    assert (n, skipped) == (len(sd), [])
    out = {k: v.clone() for k, v in module.state_dict().items()}
    assert any(not torch.equal(out[k], want[k]) for k in want)
    return out


def test_cli_train_then_val_with_database_sampling(experiment, tmp_path, monkeypatch):
    base, config = experiment
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path / "cache"))
    sd = reference_state_dict(11, neck=NECK)
    pth = tmp_path / "centerpoint_ref.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iter": 7}, pth)

    imported, counts = [], []
    import_weights = T.DefaultTrainer._import_weights
    sampling = TE.DatabaseSampling.__call__

    def probe_import(trainer, path):
        import_weights(trainer, path)
        imported.append({k: v.clone() for k, v in trainer.state.module.state_dict().items()})

    def probe_sampling(self, points, info):
        before = len(info["annotations"]["gt_boxes"])
        points, info = sampling(self, points, info)
        counts.append((before, len(info["annotations"]["gt_boxes"])))
        return points, info

    monkeypatch.setattr(T.DefaultTrainer, "_import_weights", probe_import)
    monkeypatch.setattr(TE.DatabaseSampling, "__call__", probe_sampling)
    rc = cli.main(["--config", config, "--device", "cpu", "task=train", "trainer.evaluators=",
                   "solver.lr_scheduler.max_iters=2", f"model.weights={pth}",
                   "model.weights_format=centerpoint"])
    assert rc == 0
    out = os.path.join(str(tmp_path / "cache"), "EFG_torch", cli.experiment_relpath(config))
    with open(os.path.join(out, "metrics.json")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r for r in recs if "loss" in r]
    assert [r["iteration"] for r in losses] == [1, 2]
    assert np.isfinite([r[k] for r in losses for k in ("loss", "0_hm_loss", "grad_norm")]).all()
    assert "model_final" in os.listdir(out)

    # the import wrote every reference tensor into the model, mapped by kind
    cfg = Configuration(config_file=config, opts=["task=train"]).get_config()
    want = _expected_state(cli.load_experiment_module(config).build_model(cfg, device="cpu").module, sd)
    assert len(imported) == 1 and set(imported[0]) == set(want)
    for k, v in want.items():
        assert torch.equal(imported[0][k], v), k

    # DatabaseSampling pasted crops into every item (7 class boxes a frame);
    # the prefetcher reads a batch ahead of the 2 steps
    assert len(counts) == 6 and all(after > before == 7 for before, after in counts), counts

    evaluations = []
    evaluate = T.DefaultTrainer.evaluate

    def probe_evaluate(trainer, evaluators=None):
        res = evaluate(trainer, evaluators)
        evaluations.append(res)
        return res

    monkeypatch.setattr(T.DefaultTrainer, "evaluate", probe_evaluate)
    assert cli.main(["--config", config, "--device", "cpu", "task=val"]) == 0
    (res,) = evaluations
    want_keys = {f"waymo/{c}/{lvl}/{m}" for c in ("VEHICLE", "PEDESTRIAN", "CYCLIST")
                 for lvl in ("L1", "L2") for m in ("AP", "APH")} | {"waymo/mAPH/L2"}
    assert set(res) == want_keys and np.isfinite(list(res.values())).all()


def _flax_skeleton(module):
    """A flax-style variable tree with the module's flax paths
    (`utils/jax_import.py` `flax_names`) and its tensors' shapes: the tree
    efg_tpu's name maps walk."""
    from efg_tpu_torch.utils.jax_import import flax_names

    tree = {"params": {}, "batch_stats": {}}
    state = module.state_dict()
    for key, (coll, path) in flax_names(module).items():
        node = tree[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(tuple(state[key].shape), np.float32)
    return tree


@pytest.mark.parametrize("fmt,item", [("resnet", 10), ("swin", 11)])
def test_other_weight_formats_refused(experiment, tmp_path, monkeypatch, fmt, item):
    """efg_tpu's other two formats (ResNet, item 10; Swin, item 11; both
    ported) read a seeded file of their layout. Into the CenterPoint model,
    which holds neither trunk under `backbone`, each lands nowhere, as
    efg_tpu's: the ResNet import takes 0 tensors and skips every key but
    `fc.`'s; the Swin import counts its dropped buffers
    (relative_position_index, attn_mask) as imported and skips every other
    key, the counts and skipped keys of efg_tpu's `import_swin` on the same
    tree; the weights stay as they were."""
    from efg_tpu.utils import torch_import as JTI

    _, config = experiment
    path = tmp_path / "backbone.pth"
    g = torch.Generator().manual_seed(item)
    if fmt == "resnet":
        torch.save({"conv1.weight": torch.randn(64, 3, 7, 7, generator=g),
                    "bn1.weight": torch.rand(64, generator=g), "bn1.bias": torch.zeros(64),
                    "bn1.running_mean": torch.zeros(64), "bn1.running_var": torch.ones(64),
                    "layer1.0.conv1.weight": torch.randn(64, 64, 1, 1, generator=g),
                    "fc.weight": torch.randn(10, 512, generator=g)}, path)
    else:
        torch.save({"patch_embed.proj.weight": torch.randn(96, 3, 4, 4, generator=g),
                    "patch_embed.norm.weight": torch.ones(96),
                    "layers.0.blocks.0.attn.qkv.weight": torch.randn(288, 96, generator=g),
                    "layers.0.blocks.0.attn.relative_position_index": torch.zeros(49, 49).long(),
                    "layers.0.blocks.1.attn_mask": torch.zeros(64, 49, 49),
                    "layers.0.downsample.reduction.weight": torch.randn(192, 384, generator=g),
                    "norm0.weight": torch.ones(96)}, path)
    cfg = Configuration(config_file=config, opts=[
        "task=train", f"model.weights={path}", f"model.weights_format={fmt}"]).get_config()
    cfg["trainer"]["output_dir"] = str(tmp_path / "out")
    trainer = T.DefaultTrainer(cfg, cli.load_experiment_module(config).build_model, device="cpu")
    before = {k: v.clone() for k, v in trainer.state.module.state_dict().items()}
    calls = []
    name = "import_torchvision_resnet" if fmt == "resnet" else "import_swin"
    imp = getattr(TTI, name)

    def spy(sd, module, prefix):
        calls.append(imp(sd, module, prefix))
        return calls[-1]

    monkeypatch.setattr(TTI, name, spy)
    trainer.resume_or_load(resume=False)
    ((n, skipped),) = calls
    if fmt == "resnet":
        assert n == 0 and sorted(skipped) == sorted(
            ["conv1.weight", "bn1.weight", "bn1.bias", "bn1.running_mean", "bn1.running_var",
             "layer1.0.conv1.weight"])
    else:
        sd = TTI.load_state_dict(str(path))
        _, jn, jskipped = JTI.import_swin(sd, _flax_skeleton(trainer.state.module), "backbone")
        assert (n, sorted(skipped)) == (jn, sorted(jskipped)) == (2, sorted(
            k for k in sd if not k.endswith(("relative_position_index", "attn_mask"))))
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trainer.start_iter == 0


def test_zoo_uri_weights_load_from_the_cache(experiment, tmp_path, monkeypatch):
    """`model.weights=detectron2://...pkl` resolves through the catalog
    handlers to the download cache, where a file is used as it is."""
    _, config = experiment
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path / "cache"))
    uri = "detectron2://ref/centerpoint_voxelnet.pkl"
    url = Detectron2Handler.S3_DETECTRON2_PREFIX + "ref/centerpoint_voxelnet.pkl"
    # the cache path, put in place first: a file missing there is fetched
    local = str(tmp_path / "cache" / "downloads" / hashlib.sha1(url.encode()).hexdigest()[:16]
                / "centerpoint_voxelnet.pkl")
    os.makedirs(os.path.dirname(local))
    sd = reference_state_dict(12, neck=NECK)
    with open(local, "wb") as f:
        pickle.dump({"model": sd}, f)
    assert PathManager.get_local_path(uri) == local
    assert Detectron2Handler().get_local_path(uri) == local
    cfg = Configuration(config_file=config, opts=[
        "task=train", f"model.weights={uri}", "model.weights_format=centerpoint"]).get_config()
    cfg["trainer"]["output_dir"] = str(tmp_path / "out")
    os.makedirs(cfg.trainer.output_dir)
    build = cli.load_experiment_module(config).build_model
    trainer = T.DefaultTrainer(cfg, build, device="cpu")
    trainer.resume_or_load(resume=False)
    want = _expected_state(build(cfg, device="cpu").module, sd)
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert trainer.start_iter == 0
