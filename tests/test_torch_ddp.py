"""Data parallelism on the CPU: two gloo ranks against efg_tpu's global batch.

One module fixture starts one 2-rank gloo group (`engine/launch.py`
`spawn`, one intra-op thread a rank) and runs every check in it; the
readings come back as pickles and the tests hold them against efg_tpu on
the concatenated batch, computed in this process:

- `MaskedBatchNorm` and the dense `BatchNorm` in train mode, each rank on
  its half of the rows (or of the batch): outputs, input gradients, the
  parameters' gradients summed by `ddp.reduce_gradients` and the running
  statistics against efg_tpu's `MaskedBatchNorm` / flax `nn.BatchNorm` at
  1e-5;
- CenterPoint's `compute_loss` (its `fast_focal_loss` and `reg_loss`), a
  sample a rank: the ranks' losses summed, `ddp.sum_metrics` and the maps'
  gradients against efg_tpu's `compute_loss` of both samples at 1e-5, also
  when one rank holds no GT box;
- the loader's slices against one process's batches bit for bit, from the
  start and after `start_batch`, and the eval loader's padding;
- `all_gather`, `gather`, `shared_random_seed`, `any_rank`, the barrier,
  `replicas_differ` and `global_batch`.

The mesh checks, the launcher's cluster resolution and its rank plan are
pure functions, checked here without a group.
"""

import argparse
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import efg_tpu_torch.data  # noqa: F401  (registrations)
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data.builder import build_dataloader, build_dataset
from efg_tpu_torch.engine import launch
from efg_tpu_torch.modeling.common.norms import BatchNorm, MaskedBatchNorm
from efg_tpu_torch.models import centerpoint as TCP
from efg_tpu_torch.parallel import ddp
from efg_tpu_torch.utils import distributed as comm

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/config.yaml")
DATA = ["trainer.evaluators=", "dataset.points_per_frame=2048",
        "dataset.processors.train[5].PadPoints.num_points=2048",
        "dataset.processors.val[1].PadPoints.num_points=2048", "dataset.num_frames=5",
        "dataloader.eval_batch_size=3"]
WORLD = 2
TRAIN_BATCHES = 3  # machine batches read from the start, then from start_batch
START_BATCH = 3
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner runs several files at once on the same cores, where
    torch's OpenMP threads oversubscribe them: one intra-op thread in this
    process (the ranks hold themselves to one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn_case(seed, n=64, c=8):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, c) * 3 + 1).astype(np.float32)
    return dict(x=x, cot=rs.randn(n, c).astype(np.float32),
                scale=rs.uniform(0.5, 1.5, c).astype(np.float32),
                bias=rs.uniform(-0.5, 0.5, c).astype(np.float32),
                mask=np.arange(n) % 5 != 0)


def _loss_case(seed, empty_sample=None):
    """Random head maps of two tasks (2 and 1 classes) on a 16×16 BEV and
    GT boxes for a batch of 2; `empty_sample` drops every GT of one."""
    from test_torch_train import MODEL_CFG, gt_batch

    boxes, cls, mask = gt_batch(seed)
    if empty_sample is not None:
        cls[empty_sample] = 0
        mask[empty_sample] = False
    rs = np.random.RandomState(seed + 1)
    maps = [{k: rs.randn(2, 16, 16, n).astype(np.float32)
             for k, n in (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("hm", c))}
            for c in (2, 1)]
    return dict(maps=maps, batch=dict(gt_boxes=boxes, gt_classes=cls, gt_mask=mask),
                model_cfg=MODEL_CFG)


# ---------------------------------------------------------------- the ranks

def _bn_rank(case, masked):
    r = comm.get_rank()
    rows = slice(r * 32, (r + 1) * 32)  # 64 rows; dense: 4 maps of 4×4, 2 a rank
    m = MaskedBatchNorm(8) if masked else BatchNorm(8)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(case["scale"]))
        m.bias.copy_(torch.from_numpy(case["bias"]))
        m.running_mean.fill_(0.1)
        m.running_var.fill_(2.0)
    m.train()
    if masked:
        x = torch.from_numpy(case["x"][rows]).requires_grad_()
        y = m(x, torch.from_numpy(case["mask"][rows]))
        y.backward(torch.from_numpy(case["cot"][rows]))
        dx = x.grad
    else:
        nhwc = case["x"].reshape(4, 4, 4, 8)[2 * r:2 * r + 2]
        x = torch.from_numpy(np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2))).requires_grad_()
        y = m(x).permute(0, 2, 3, 1)
        y.backward(torch.from_numpy(case["cot"].reshape(4, 4, 4, 8)[2 * r:2 * r + 2]))
        dx = x.grad.permute(0, 2, 3, 1)
    ddp.reduce_gradients(m)
    return dict(y=y.detach().numpy(), dx=dx.numpy(), dscale=m.weight.grad.numpy(),
                dbias=m.bias.grad.numpy(), mean=m.running_mean.numpy(),
                var=m.running_var.numpy())


def _loss_rank(case):
    r = comm.get_rank()
    maps = [{k: torch.from_numpy(v[r:r + 1]).requires_grad_() for k, v in t.items()}
            for t in case["maps"]]
    batch = {k: torch.from_numpy(v[r:r + 1]) for k, v in case["batch"].items()}
    losses = TCP.compute_loss(maps, batch, model_cfg=case["model_cfg"])
    losses["loss"].backward()
    return dict(losses={k: float(v.detach()) for k, v in losses.items()},
                summed={k: float(v) for k, v in ddp.sum_metrics(losses).items()},
                grads=[{k: v.grad.numpy() for k, v in t.items()} for t in maps])


def _loader_rank():
    out = {}
    for task in ("train", "val"):
        cfg = Configuration(config_file=CONFIG, opts=DATA + [f"task={task}"]).get_config()
        ds = build_dataset(cfg)
        if task == "train":
            for start in (0, START_BATCH):
                loader = build_dataloader(cfg, ds, train=True)
                loader.start_batch = start
                it = iter(loader)
                out[("train", start)] = [next(it) for _ in range(TRAIN_BATCHES)]
        else:
            loader = build_dataloader(cfg, ds, train=False)
            out["val"] = list(loader)
            out["val_slice"] = (loader.local_batch, loader.local_valid, len(loader))
    return out


def _ranks(out_dir, bn_case, loss_cases, device):
    torch.set_num_threads(1)
    r = comm.get_rank()
    res = dict(
        identity=(comm.get_world_size(), r, comm.get_local_rank(), comm.get_local_size(),
                  comm.get_machine_rank(), comm.get_num_machines(), comm.is_main_process(),
                  ddp.active(), str(device)),
        all_gather=comm.all_gather({"rank": r, "a": np.arange(r + 2)}),
        gather=comm.gather(10 * r + 1, dst=1),
        seed=comm.shared_random_seed(),
        any=(comm.any_rank(r == 1), comm.any_rank(False)),
        global_batch=ddp.global_batch(3),
        differ=ddp.replicas_differ({"same": torch.arange(4.0),
                                    "other": torch.tensor([0.0, float(r)]),
                                    "signed_zero": torch.tensor([0.0 if r == 0 else -0.0])}),
        bn={masked: _bn_rank(bn_case, masked) for masked in (True, False)},
        loss=[_loss_rank(c) for c in loss_cases],
        loader=_loader_rank(),
    )
    comm.synchronize()
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' readings, from one spawned 2-rank gloo group."""
    out = tmp_path_factory.mktemp("ddp")
    bn_case = _bn_case(6)
    loss_cases = [_loss_case(1), _loss_case(3, empty_sample=1)]
    init = f"tcp://127.0.0.1:{launch.free_port()}"
    specs = [launch.RankSpec(r, WORLD, r, WORLD, "gloo", init, "cpu") for r in range(WORLD)]
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rc = launch.spawn(_ranks, specs, (str(out), bn_case, loss_cases))
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    assert rc == 0
    got = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return dict(got=got, bn_case=bn_case, loss_cases=loss_cases)


# ---------------------------------------------------------------- the tests

def test_identity_and_object_collectives(ranks):
    got = ranks["got"]
    for r, g in enumerate(got):
        assert g["identity"] == (2, r, r, 2, 0, 1, r == 0, True, "cpu")
        assert [x["rank"] for x in g["all_gather"]] == [0, 1]
        np.testing.assert_array_equal(g["all_gather"][1]["a"], np.arange(3))
        assert g["gather"] == ([1, 11] if r == 1 else [])
        assert g["any"] == (True, False)
        assert g["global_batch"] == (6, 3 * r)
        assert g["differ"] == ["other", "signed_zero"]
    assert got[0]["seed"] == got[1]["seed"]


@pytest.mark.parametrize("masked", [True, False])
def test_global_batch_norm_matches_efg_tpu(ranks, masked):
    """BN over the two ranks' rows equals efg_tpu's BN over all of them:
    output, d input, d scale and d bias (summed over the ranks) and the
    running statistics (the same on both ranks) within 1e-5."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from efg_tpu.modeling.common.norms import MaskedBatchNorm as JMBN

    c = ranks["bn_case"]
    stats = {"mean": np.full(8, 0.1, np.float32), "var": np.full(8, 2.0, np.float32)}
    params = {"scale": c["scale"], "bias": c["bias"]}
    if masked:
        jm, x, cot = JMBN(), c["x"], c["cot"]
        fwd = lambda v, xx: jm.apply(v, xx, jnp.asarray(c["mask"]), False, mutable=["batch_stats"])
    else:
        jm = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
        x, cot = c["x"].reshape(4, 4, 4, 8), c["cot"].reshape(4, 4, 4, 8)
        fwd = lambda v, xx: jm.apply(v, xx, mutable=["batch_stats"])
    out, new = fwd({"params": params, "batch_stats": stats}, jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, xx: fwd({"params": p, "batch_stats": stats}, xx)[0],
                     params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(cot))
    g0, g1 = (g["bn"][masked] for g in ranks["got"])
    for k in ("dscale", "dbias", "mean", "var"):
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    for g, w, what in ((np.concatenate([g0["y"], g1["y"]]), out, "out"),
                       (np.concatenate([g0["dx"], g1["dx"]]), dx, "d x"),
                       (g0["dscale"], dp["scale"], "d scale"), (g0["dbias"], dp["bias"], "d bias"),
                       (g0["mean"], new["batch_stats"]["mean"], "running mean"),
                       (g0["var"], new["batch_stats"]["var"], "running var")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("case", [0, 1], ids=["both_samples_with_gt", "rank1_without_gt"])
def test_loss_normalisers_are_global(ranks, case):
    """Each rank's `compute_loss` on its sample, summed over the ranks, is
    efg_tpu's `compute_loss` of the batch of both (1e-5 relative), and so
    is `ddp.sum_metrics` on every rank (`{t}_num_positive` exactly); the
    maps' gradients, concatenated, are efg_tpu's at 1e-5 · max|ref|. The
    second case leaves rank 1 without a GT box: its heatmap loss still
    divides by the global positive count."""
    import jax
    import jax.numpy as jnp

    from efg_tpu.models import centerpoint as JCP

    c = ranks["loss_cases"][case]

    def total(maps):
        out = JCP.compute_loss(maps, {k: jnp.asarray(v) for k, v in c["batch"].items()},
                               model_cfg=c["model_cfg"])
        return out["loss"], out

    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in c["maps"]])
    got = [g["loss"][case] for g in ranks["got"]]
    assert set(got[0]["losses"]) == set(want)
    if case == 1:
        assert got[1]["losses"]["0_num_positive"] == 0 and got[1]["losses"]["0_hm_loss"] > 0
    for k, w in want.items():
        w = float(w)
        summed = got[0]["losses"][k] + got[1]["losses"][k]
        if k.endswith("num_positive"):
            assert summed == got[0]["summed"][k] == got[1]["summed"][k] == w > 0, k
            continue
        np.testing.assert_allclose(summed, w, rtol=TOL, err_msg=k)
        for g in got:
            np.testing.assert_allclose(g["summed"][k], w, rtol=TOL, err_msg=k)
    for t, want_t in enumerate(grads):
        for k, ref in want_t.items():
            ref = np.asarray(ref)
            g = np.concatenate([got[0]["grads"][t][k], got[1]["grads"][t][k]])
            np.testing.assert_allclose(g, ref, rtol=0, atol=TOL * np.abs(ref).max() + 1e-12,
                                       err_msg=f"task {t} {k}")


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _rows(batch, rows):
    return {k: [v[i] for i in rows] if isinstance(v, list) else v[list(rows)]
            for k, v in batch.items()}


def test_loader_slices_equal_one_process_batches(ranks):
    """Local rank l's train batch is rows [l, l+1) of one process's bs-2
    batch, bit for bit (augmentations included), from the start and after
    `start_batch`. The eval loader (bs 3 over 5 frames: batches [0, 1, 2]
    and [3, 4, 4], the tail padded as one process pads it) gives rank 0
    rows 0-1 of each batch and rank 1 row 2 and a pad row repeating it,
    with `local_valid` 2 and 1."""
    got = [g["loader"] for g in ranks["got"]]
    for task in ("train", "val"):
        cfg = Configuration(config_file=CONFIG, opts=DATA + [f"task={task}"]).get_config()
        ds = build_dataset(cfg)
        if task == "train":
            for start in (0, START_BATCH):
                loader = build_dataloader(cfg, ds, train=True)
                loader.start_batch = start
                it = iter(loader)
                want = [next(it) for _ in range(TRAIN_BATCHES)]
                for r in range(WORLD):
                    for i, w in enumerate(want):
                        _equal(got[r][("train", start)][i], _rows(w, range(r, r + 1)),
                               f"train start {start} batch {i} rank {r}")
        else:
            want = list(build_dataloader(cfg, ds, train=False))
            assert len(want) == 2 and all(len(w["metadata"]) == 3 for w in want)
            assert got[0]["val_slice"] == (2, 2, 2) and got[1]["val_slice"] == (2, 1, 2)
            for i, w in enumerate(want):
                _equal(got[0]["val"][i], _rows(w, range(2)), f"val batch {i} rank 0")
                padded = _rows(w, [2, 2])  # row 2, then the pad: the batch's last frame
                _equal(got[1]["val"][i], padded, f"val batch {i} rank 1")


# ------------------------------------------------- pure functions, no group

@pytest.mark.parametrize("shape, world, want", [
    ([-1, 1], 2, {"data": 2, "model": 1}),
    ([2, 1], 2, {"data": 2, "model": 1}),
    ([-1, 1], 1, {"data": 1, "model": 1}),
    ([2, 1], 1, AssertionError),
    ([4, 1], 2, AssertionError),
    ([1, 2], 2, NotImplementedError),
])
def test_mesh_against_the_world(shape, world, want):
    cfg = {"axes": ["data", "model"], "shape": shape}
    if isinstance(want, dict):
        assert ddp.mesh_shape(cfg, world) == want
    else:
        with pytest.raises(want):
            ddp.mesh_shape(cfg, world)
    assert ddp.mesh_shape(None, 3) == {"data": 3, "model": 1}


def _args(**kw):
    base = dict(num_machines=1, machine_rank=0, dist_url=None, local_ranks=None,
                dist_backend=None, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_two_machine_batch_check_deviates_from_efg_tpu():
    """Two machines of two local ranks: the port checks a machine's batch
    against its 2 ranks, efg_tpu (`engine/trainer.py:86-90`) against its
    data axis of all 4 devices. batch_size 2 a machine runs in the port,
    where efg_tpu's check refuses it; 3 is refused, the error naming the
    deviation."""
    from efg_tpu_torch.engine.trainer import check_machine_batch

    specs, spawn = launch.plan(_args(num_machines=2, machine_rank=0, dist_url="h0:29500",
                                     local_ranks=2), {})
    assert spawn and [(s.rank, s.local_size, s.world_size) for s in specs] == [(0, 2, 4),
                                                                                (1, 2, 4)]
    local, data_devices = specs[0].local_size, specs[0].world_size
    check_machine_batch(2, local)
    assert 2 % data_devices != 0  # efg_tpu's assertion would fail here
    with pytest.raises(ValueError, match=r"batch_size=3 .*efg_tpu checks it against every "
                                         r"machine's devices, the port against this machine's"):
        check_machine_batch(3, local)


def test_cluster_resolution_follows_efg_tpu():
    """efg_tpu's priority (flags, SLURM, torchrun's env), copied: the same
    answers as efg_tpu's `resolve_distributed_env` on each source."""
    sys.path.insert(0, str(ROOT))
    try:
        from cli.main import _slurm_first_host as j_first, resolve_distributed_env as j_resolve
    finally:
        sys.path.remove(str(ROOT))
    envs = [{}, {"SLURM_PROCID": "1", "SLURM_NTASKS": "4", "SLURM_NODELIST": "gpu[003-006,9]"},
            {"SLURM_PROCID": "0", "SLURM_NTASKS": "1"},
            {"RANK": "2", "WORLD_SIZE": "4", "MASTER_ADDR": "h0", "MASTER_PORT": "1234"},
            {"RANK": "0", "WORLD_SIZE": "1"}]
    for args in (_args(), _args(num_machines=3, machine_rank=2, dist_url="h:5")):
        for env in envs:
            assert launch.resolve_distributed_env(args, env) == j_resolve(args, env)
    for nodes in ("a,b", "n[001-004,007]", "p[3]s", "x[1,2],y"):
        assert launch._slurm_first_host(nodes) == j_first(nodes)


def test_rank_plan():
    """A world of one spawns nothing; local ranks are spawned with a free
    local port; machines from the flags make global ranks m·L + l; torchrun
    ranks run in place; a missing --dist-url and nccl on the CPU raise."""
    assert launch.plan(_args(), {}) == ([], False)
    specs, spawn = launch.plan(_args(local_ranks=2), {})
    assert spawn and [(s.rank, s.world_size, s.local_rank, s.local_size, s.backend, s.device)
                      for s in specs] == [(0, 2, 0, 2, "gloo", "cpu"), (1, 2, 1, 2, "gloo", "cpu")]
    assert specs[0].init_method.startswith("tcp://127.0.0.1:")
    specs, spawn = launch.plan(_args(num_machines=2, machine_rank=1, dist_url="h0:29500",
                                     local_ranks=2), {})
    assert spawn and [s.rank for s in specs] == [2, 3] and specs[0].world_size == 4
    assert specs[0].init_method == "tcp://h0:29500"
    specs, spawn = launch.plan(_args(num_machines=2, machine_rank=1, dist_url="tcp://h0:1"), {})
    assert not spawn and [(s.rank, s.world_size) for s in specs] == [(1, 2)]
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
           "MASTER_ADDR": "m", "MASTER_PORT": "7"}
    specs, spawn = launch.plan(_args(), env)
    assert not spawn and specs == [launch.RankSpec(3, 4, 1, 2, "gloo", "tcp://m:7", "cpu")]
    with pytest.raises(ValueError, match="needs --dist-url"):
        launch.plan(_args(num_machines=2), {})
    with pytest.raises(ValueError, match="nccl needs a card"):
        ddp.init_process_group("nccl", "tcp://127.0.0.1:1", 0, 2, "cpu")
    assert str(ddp.rank_device("cuda", 3)) == "cuda:3"
    assert str(ddp.rank_device("cuda:0", 3)) == "cuda:0"
