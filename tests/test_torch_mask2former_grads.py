"""Port parity of Mask2Former's step-1 gradients (efg_tpu_torch vs
efg_tpu), on `test_torch_mask2former.py`'s tiny model, batch, variables
and draws: `jax.grad` of efg_tpu's `compute_loss` after the train
forward, compiled once and run with ReLU and with every ReLU a GELU,
against the port's backward from the same variables and draws.

- every gradient leaf within 1e-4 of its max in the GELU run: with ReLU
  some encoder FFN inputs lie within the forward's rounding of the kink
  (`test_relu_gradients_cross_a_kink`). The leaves whose gradient is 0 in
  exact arithmetic (an attention key's bias, a conv bias ahead of a
  GroupNorm) are rounding noise on both sides and are held against their
  layer's weight gradient.
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.models import mask2former as JM
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_mask2former import CFG, SEED, _port_run, jax_draws, jax_setup, lower_smooth

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

GRAD_TOL = 1e-4
# gradients that are 0 in exact arithmetic: an attention key's bias shifts
# every logit of a query alike, a conv bias ahead of a GroupNorm is removed
# by it
ZERO_GRAD = re.compile(r"(attn\.key\.bias|input_proj_res\d\.bias|adapter_res2\.bias|"
                       r"fuse_res2\.bias)$")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def m2f():
    """efg_tpu's step-1 gradients with ReLU and with every ReLU a GELU
    (one compile), and the port's two runs."""
    batch, jbatch, jm, variables = jax_setup()
    rng = jax.random.key(SEED)
    cfg = dict(CFG)

    def loss(params):
        preds = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                         jbatch["images"], True)
        return JM.compute_loss(preds, jbatch, model_cfg=cfg, rng=rng)["loss"]

    step = lower_smooth(jax.grad(loss), variables["params"])
    draws = jax_draws(rng, 2, 4, CFG["num_points"])
    return {smooth: dict(
        grads=jax.tree_util.tree_map(np.asarray, step(variables["params"], jnp.asarray(smooth))),
        port=_port_run(variables, batch, draws, smooth), batch_stats=variables["batch_stats"])
        for smooth in (False, True)}


def _grad_errors(run):
    """Each parameter's gradient error relative to efg_tpu's leaf max; a
    ZERO_GRAD leaf's (rounding noise on both sides) relative to the max of
    its own layer's weight gradient."""
    tm = run["port"]["tm"]
    want = flax_to_state_dict(tm, {"params": run["grads"], "batch_stats": run["batch_stats"]})
    errs = {}
    for name, p in tm.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want[name].numpy().astype(np.float64)
        scale = want[name.rsplit(".", 1)[0] + ".weight"] if ZERO_GRAD.search(name) else w
        errs[name] = float(np.abs(g - w).max()) / max(float(np.abs(scale).max()), 1e-30)
    return errs


def test_gradients_match(m2f):
    """Step-1 gradients with every ReLU a GELU (no kink): each leaf within
    GRAD_TOL of its max (a ZERO_GRAD leaf: of its layer's weight
    gradient's max)."""
    errs = _grad_errors(m2f[True])
    assert len(errs) > 150
    bad = {n: e for n, e in errs.items() if e > GRAD_TOL}
    assert not bad, bad


def test_relu_gradients_cross_a_kink(m2f):
    """The witness for `test_gradients_match`'s GELU: with ReLU, some
    encoder FFN inputs lie within the forward's rounding of 0 (the least
    |input| of a pixel-decoder `linear1` reads 7.0e-7 on these weights),
    and the gradients downstream of such a flip move by more than 1e-3 of
    a leaf's max; the smooth run holds them at GRAD_TOL."""
    errs = _grad_errors(m2f[False])
    worst = max((e, n) for n, e in errs.items())
    assert worst[0] > 1e-3 and "linear1" in worst[1], worst


