"""Port parity: the config engine (efg_tpu_torch.config vs efg_tpu.config).

Every playground experiment config resolves to the same dict in both
packages; the cases of tests/test_config.py run through the port; the
port's default.yaml is efg_tpu's as a dict."""

import os
import textwrap
from pathlib import Path

import pytest

from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.config import load_yaml as j_load_yaml
from efg_tpu_torch.config import Config, Configuration, load_yaml
from efg_tpu_torch.config.config import apply_overrides, resolve_interpolations

ROOT = Path(__file__).resolve().parents[1]
PLAYGROUND_CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "playground").rglob("config.yaml"))


def _write(tmp_path, name, content):
    p = tmp_path / name
    p.write_text(textwrap.dedent(content))
    return str(p)


def test_playground_configs_found(monkeypatch):
    """Most experiments resolve in efg_tpu (the parity test below compares
    dicts for those)."""
    monkeypatch.setenv("EFG_PATH", str(ROOT))
    resolved = 0
    for rel in PLAYGROUND_CONFIGS:
        try:
            JConfiguration(config_file=str(ROOT / rel))
            resolved += 1
        except KeyError:
            pass
    assert len(PLAYGROUND_CONFIGS) >= 20 and resolved >= len(PLAYGROUND_CONFIGS) - 5
    assert "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/config.yaml" in PLAYGROUND_CONFIGS


@pytest.mark.parametrize("rel", PLAYGROUND_CONFIGS)
def test_playground_config_resolves_like_efg_tpu(rel, monkeypatch):
    monkeypatch.setenv("EFG_PATH", str(ROOT))
    monkeypatch.setenv("EFG_CACHE_DIR", "/efg-cache")
    opts = ["trainer.evaluators=", "solver.lr_scheduler.max_iters=7"]
    try:
        want = JConfiguration(config_file=str(ROOT / rel), opts=list(opts)).get_config().to_dict()
    except KeyError as e:
        # a few experiments interpolate through an interpolation
        # (${dataset.source.root} with dataset.source itself "${...}"),
        # which efg_tpu's lookup does not resolve: the port must refuse
        # them with the same error
        with pytest.raises(KeyError) as got:
            Configuration(config_file=str(ROOT / rel), opts=list(opts))
        assert str(got.value) == str(e)
        return
    got = Configuration(config_file=str(ROOT / rel), opts=list(opts)).get_config()
    assert isinstance(got, Config)
    assert got.to_dict() == want
    assert got.trainer.output_dir == "/efg-cache"


def test_default_yaml_equals_efg_tpu():
    assert load_yaml(str(ROOT / "efg_tpu_torch/config/default.yaml")) == \
        j_load_yaml(str(ROOT / "efg_tpu/config/default.yaml"))


def test_includes_merge_and_override(tmp_path):
    _write(tmp_path, "base.yaml", """
        dataset:
          classes: [a, b]
          nsweeps: 1
        model:
          lr: 0.1
        """)
    cfg = load_yaml(_write(tmp_path, "exp.yaml", """
        includes:
          - base.yaml
        dataset:
          nsweeps: 4
        """))
    assert cfg["dataset"]["nsweeps"] == 4
    assert cfg["dataset"]["classes"] == ["a", "b"]
    assert cfg["model"]["lr"] == 0.1
    assert "includes" not in cfg


def test_env_resolver_in_include_path(tmp_path, monkeypatch):
    sub = tmp_path / "gallery"
    sub.mkdir()
    (sub / "ds.yaml").write_text("source: {root: /data}\n")
    monkeypatch.setenv("MY_GALLERY", str(sub))
    cfg = load_yaml(_write(tmp_path, "exp.yaml", """
        includes:
          - ${oc.env:MY_GALLERY}/ds.yaml
        task: train
        """))
    assert cfg["source"]["root"] == "/data"


def test_interpolation_preserves_type():
    cfg = {
        "dataset": {"pc_range": [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0], "n": 5},
        "model": {"post": {"pc_range": "${dataset.pc_range}", "text": "n is ${dataset.n}"}},
    }
    resolve_interpolations(cfg)
    assert cfg["model"]["post"]["pc_range"] == [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0]
    assert cfg["model"]["post"]["text"] == "n is 5"


def test_env_interpolation_with_default(monkeypatch):
    monkeypatch.delenv("EFG_NOPE", raising=False)
    cfg = {"out": "${oc.env:EFG_NOPE,/tmp/x}", "out2": "${env:EFG_NOPE,/tmp/y}"}
    resolve_interpolations(cfg)
    assert cfg == {"out": "/tmp/x", "out2": "/tmp/y"}
    with pytest.raises(KeyError):
        resolve_interpolations({"out": "${oc.env:EFG_NOPE}"})


def test_device_count_resolver_reads_torch(monkeypatch):
    """`${device_count:}` counts the devices the run uses: 1, whatever
    torch.cuda.device_count() says (0 on the CPU), as efg_tpu's
    `jax.local_device_count()` reads 1 on one CPU device (the tests' conftest
    forces 8 host devices, so it is not called here)."""
    import torch

    cfg = {"n": "${device_count:}"}
    resolve_interpolations(cfg)
    assert cfg["n"] == 1
    for count in (0, 3):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        cfg = {"n": "${device_count:}"}
        resolve_interpolations(cfg)
        assert cfg["n"] == 1


def test_dotlist_overrides():
    cfg = {"solver": {"optimizer": {"lr": 0.1}}, "dataset": {"voxel_size": [0.1, 0.1, 0.15]}}
    apply_overrides(cfg, ["solver.optimizer.lr", "0.003", "dataset.voxel_size[2]=0.2", "task=val",
                          "trainer.evaluators=", "model.stage_caps=[1,2]", "misc.flag=true"])
    assert cfg["solver"]["optimizer"]["lr"] == 0.003
    assert cfg["dataset"]["voxel_size"][2] == 0.2
    assert cfg["task"] == "val"
    assert cfg["trainer"]["evaluators"] is None
    assert cfg["model"]["stage_caps"] == [1, 2]
    assert cfg["misc"]["flag"] is True
    with pytest.raises(ValueError):
        apply_overrides(cfg, ["dangling.key"])


def test_configuration_defaults(tmp_path):
    cfg = Configuration(config_file=_write(tmp_path, "exp.yaml", """
        dataset:
          type: Synthetic3D
        trainer:
          log_interval: 7
        """)).get_config()
    assert cfg.task == "train"
    assert cfg.trainer.log_interval == 7
    assert cfg.trainer.window_size == 7  # interpolated from default.yaml
    assert cfg.dataset.type == "Synthetic3D"


def test_config_attribute_access_and_errors():
    c = Config({"a": {"b": [1, {"c": 2}]}})
    assert c.a.b[1].c == 2
    with pytest.raises(AttributeError):
        _ = c.nope
    assert c.get("nope", 3) == 3


def test_backbones_gallery_include(tmp_path, monkeypatch):
    monkeypatch.setenv("EFG_PATH", str(ROOT))
    cfg = load_yaml(_write(tmp_path, "exp.yaml", """
        includes:
          - ${oc.env:EFG_PATH}/efg_tpu/config/gallary/backbones.yaml
        model:
          resnets:
            depth: 18
          fcos:
            depth: ${model.resnets.depth}
            freeze_at: ${model.resnets.freeze_at}
        """))
    resolve_interpolations(cfg)
    assert cfg["model"]["resnets"]["depth"] == 18
    assert cfg["model"]["resnets"]["norm"] == "FrozenBN"
    assert cfg["model"]["fcos"]["depth"] == 18
    assert cfg["model"]["fcos"]["freeze_at"] == 2
