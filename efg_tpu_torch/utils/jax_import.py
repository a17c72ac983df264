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
- LayerNorm and GroupNorm scale / bias → weight / bias.

The mapping is strict: every flax leaf is used once and every torch
parameter and buffer is filled once, with its own shape; anything else
raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d, ConvTranspose2d
from efg_tpu_torch.modeling.backbones.sparse_net import SparseConvDown, SubMConv
from efg_tpu_torch.modeling.common.norms import BatchNorm, MaskedBatchNorm
from efg_tpu_torch.models.voxel_detr import MultiHeadDotProductAttention


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


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

    def put(key: str, value: np.ndarray) -> None:
        if key in sd:
            raise KeyError(f"{key} filled twice")
        sd[key] = value

    def take_shaped(path, leaf, shape):
        value = take("params", path + (leaf,))
        if value.shape != tuple(shape):
            raise ValueError(f"flax params/{'/'.join(path + (leaf,))}: shape {value.shape}, "
                             f"expected {tuple(shape)}")
        return value

    heads = {}  # Linear module name → the head split of its MHA's kernels
    for name, mod in module.named_modules():
        if isinstance(mod, MultiHeadDotProductAttention):
            d = mod.query.in_features
            nh = mod.num_heads
            for proj in ("query", "key", "value"):
                heads[f"{name}.{proj}"] = ((d, nh, d // nh), (nh, d // nh))
            heads[f"{name}.out"] = ((nh, d // nh, d), (d,))

    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.Linear):
            k_shape, b_shape = heads.get(name, ((mod.in_features, mod.out_features),
                                                (mod.out_features,)))
            k = take_shaped(path, "kernel", k_shape)
            put(pre + "weight", k.reshape(mod.in_features, mod.out_features).T)
            if mod.bias is not None:  # a flax Dense with use_bias=False has none
                put(pre + "bias", take_shaped(path, "bias", b_shape).reshape(-1))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            put(pre + "weight", take("params", path + ("scale",)))
            put(pre + "bias", take("params", path + ("bias",)))
        elif isinstance(mod, (SubMConv, SparseConvDown)):
            put(pre + "weight", take("params", path + ("kernel",)))
            if getattr(mod, "bias", None) is not None:
                put(pre + "bias", take("params", path + ("bias",)))
        elif isinstance(mod, Conv2d):
            put(pre + "weight", take("params", path + ("kernel",)).transpose(3, 2, 0, 1))
            if mod.bias is not None:
                put(pre + "bias", take("params", path + ("bias",)))
        elif isinstance(mod, ConvTranspose2d):
            k = take("params", path + ("kernel",))
            put(pre + "weight", k[::-1, ::-1].transpose(2, 3, 0, 1))
        elif isinstance(mod, (MaskedBatchNorm, BatchNorm)):
            put(pre + "weight", take("params", path + ("scale",)))
            put(pre + "bias", take("params", path + ("bias",)))
            put(pre + "running_mean", take("batch_stats", path + ("mean",)))
            put(pre + "running_var", take("batch_stats", path + ("var",)))

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
