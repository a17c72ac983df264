"""Flax variables → the port's state_dict (the weight mapper).

Takes efg_tpu's `{"params": ..., "batch_stats": ...}` as nested dicts of
numpy arrays (e.g. `jax.device_get(variables)` or a loaded checkpoint) and
returns a state_dict for the matching efg_tpu_torch module. Never imports
jax. The port names its submodules like the flax modules, so every layer's
flax path is its torch module path:

- sparse conv kernels [K, Cin, Cout] are taken as they are;
- dense conv kernels HWIO → OIHW;
- transposed-conv kernels HWIO → torch's [I, O, kh, kw] with a spatial
  flip: flax's ConvTranspose does not flip its kernel and torch's does;
- BatchNorm scale / bias / mean / var → weight / bias / running_mean /
  running_var;
- Dense kernels [in, out] → Linear weights [out, in]; the projections of
  a `MultiHeadDotProductAttention`, whose query / key / value kernels are
  [C, NH, hd] (bias [NH, hd]) and whose out kernel is [NH, hd, C], fold
  their head axes into the Linear's;
- LayerNorm and GroupNorm scale / bias → weight / bias;
- FrozenBatchNorm like BatchNorm (its scale / bias are flax params,
  mean / var batch_stats);
- a parameter a module holds itself (its `flax_params`: FCOS's head
  `scales`, AutoAssign's `mu` / `sigma`) is taken as it is.

`flax_names` gives each torch tensor's flax path, which the optimizers'
weight-decay mask reads (`solver/optimizers.py`).

The mapping is strict: every flax leaf is used once and every torch
parameter and buffer is filled once, with its own shape; anything else
raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from efg_tpu_torch.modeling.backbones.resnet import FrozenBatchNorm
from efg_tpu_torch.modeling.backbones.rpn import Conv2d, ConvTranspose2d
from efg_tpu_torch.modeling.backbones.sparse_net import SparseConvDown, SubMConv
from efg_tpu_torch.modeling.common.norms import BatchNorm, MaskedBatchNorm
from efg_tpu_torch.modeling.common.layers import MultiHeadDotProductAttention


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _entries(module: nn.Module):
    """(torch state key, flax collection, flax path, convert) for every
    tensor of `module` that has a flax leaf; `convert` maps the leaf (an
    f32 numpy array) to the torch value."""
    heads = {}  # Linear module name → the head split of its MHA's kernels
    for name, mod in module.named_modules():
        if isinstance(mod, MultiHeadDotProductAttention):
            d = mod.query.in_features
            nh = mod.num_heads
            for proj in ("query", "key", "value"):
                heads[f"{name}.{proj}"] = ((d, nh, d // nh), (nh, d // nh))
            heads[f"{name}.out"] = ((nh, d // nh, d), (d,))

    def same(v):
        return v

    def shaped(path, shape, then):
        def convert(v):
            if v.shape != tuple(shape):
                raise ValueError(f"flax params/{'/'.join(path)}: shape {v.shape}, "
                                 f"expected {tuple(shape)}")
            return then(v)
        return convert

    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.Linear):
            k_shape, b_shape = heads.get(name, ((mod.in_features, mod.out_features),
                                                (mod.out_features,)))
            i, o = mod.in_features, mod.out_features
            yield (pre + "weight", "params", path + ("kernel",),
                   shaped(path + ("kernel",), k_shape, lambda v, i=i, o=o: v.reshape(i, o).T))
            if mod.bias is not None:  # a flax Dense with use_bias=False has none
                yield (pre + "bias", "params", path + ("bias",),
                       shaped(path + ("bias",), b_shape, lambda v: v.reshape(-1)))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            yield pre + "weight", "params", path + ("scale",), same
            yield pre + "bias", "params", path + ("bias",), same
        elif isinstance(mod, (SubMConv, SparseConvDown)):
            yield pre + "weight", "params", path + ("kernel",), same
            if getattr(mod, "bias", None) is not None:
                yield pre + "bias", "params", path + ("bias",), same
        elif isinstance(mod, Conv2d):
            yield pre + "weight", "params", path + ("kernel",), lambda v: v.transpose(3, 2, 0, 1)
            if mod.bias is not None:
                yield pre + "bias", "params", path + ("bias",), same
        elif isinstance(mod, ConvTranspose2d):
            yield (pre + "weight", "params", path + ("kernel",),
                   lambda v: v[::-1, ::-1].transpose(2, 3, 0, 1))
        elif isinstance(mod, (MaskedBatchNorm, BatchNorm, FrozenBatchNorm)):
            yield pre + "weight", "params", path + ("scale",), same
            yield pre + "bias", "params", path + ("bias",), same
            yield pre + "running_mean", "batch_stats", path + ("mean",), same
            yield pre + "running_var", "batch_stats", path + ("var",), same
        # parameters a module holds itself (flax `self.param` leaves),
        # taken as they are: FCOS's `scales`, AutoAssign's `mu` / `sigma`
        for leaf in getattr(mod, "flax_params", ()):
            yield pre + leaf, "params", path + (leaf,), same


def flax_names(module: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """torch state key → (flax collection, flax path) of its leaf."""
    return {key: (coll, path) for key, coll, path, _ in _entries(module)}


def flax_to_state_dict(module: nn.Module, variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    colls = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    extra = set(variables) - set(colls)
    if extra:
        raise KeyError(f"unexpected flax collections: {sorted(extra)}")
    used = set()

    def take(coll: str, path: Tuple[str, ...]) -> np.ndarray:
        node = colls[coll]
        for part in path:
            if not isinstance(node, Mapping) or part not in node:
                raise KeyError(f"flax {coll}/{'/'.join(path)} not found")
            node = node[part]
        if (coll, path) in used:
            raise KeyError(f"flax {coll}/{'/'.join(path)} used twice")
        used.add((coll, path))
        return np.asarray(node, dtype=np.float32)

    sd: Dict[str, np.ndarray] = {}
    for key, coll, path, convert in _entries(module):
        if key in sd:
            raise KeyError(f"{key} filled twice")
        sd[key] = convert(take(coll, path))

    target = module.state_dict()
    missing = sorted(set(target) - set(sd))
    if missing:
        raise KeyError(f"torch state not filled from flax: {missing}")
    unused = sorted(
        f"{coll}/{'/'.join(p)}" for coll, tree in colls.items() for p in _leaves(tree)
        if (coll, p) not in used
    )
    if unused:
        raise KeyError(f"flax leaves with no torch counterpart: {unused}")
    out = {}
    for key, value in sd.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: flax shape {value.shape} != torch {tuple(target[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(target[key].dtype)
    return out
