"""Reference checkpoint import (port of `efg_tpu/utils/torch_import.py`, its
CenterPoint format).

Loads a `.pth` / `.pkl` state dict into numpy arrays, strips DDP's
`module.` prefix, and writes a reference-format CenterPoint VoxelNet state
dict into the port's `VoxelNet` by module name. efg_tpu maps the same
names into flax variables; the port names its modules like those flax
modules, so each reference key lands on the parameter or buffer that
`utils/jax_import.py` fills from efg_tpu's leaf:

- sparse conv weights: spconv 2.x `[Cout, kd, kh, kw, Cin]` or spconv 1.x
  `[kd, kh, kw, Cin, Cout]` → `[K, Cin, Cout]`, offsets in (δz, δy, δx)
  raster;
- dense conv weights `[O, I, kh, kw]` and biases as they are;
- `ConvTranspose2d` weights `[I, O, kh, kw]` as they are: the port's
  deconv is torch's (`F.conv_transpose2d`), where efg_tpu flips the
  kernel spatially for flax;
- BatchNorm weight / bias / running_mean / running_var as they are;
  `num_batches_tracked` is counted and dropped, as in efg_tpu.

The torchvision ResNet format (`import_torchvision_resnet`, efg_tpu's
default) writes a torchvision-style ResNet state dict into the port's
`ResNet` under a prefix (the 2D detectors' `backbone`): conv1 / bn1 →
stem_conv1 / stem_norm, layer{i}.{b} → res{i+1}_block{b}, conv{j} /
bn{j} → conv{j} / norm{j}, downsample.0 / .1 → shortcut /
shortcut_norm. Conv weights are OIHW on both sides and are taken as
they are.

The Swin format (`import_swin`) writes an mmdet / official Swin state dict
into the port's `SwinTransformer` under a prefix (Mask2Former's
`backbone`), by efg_tpu's `import_swin` names: patch_embed.proj / .norm →
patch_embed / patch_norm, layers.{i}.blocks.{j} → stage{i}_block{j}
(norm1, attn.qkv, attn.proj, attn.relative_position_bias_table, norm2,
mlp.fc1 / fc2 → fc1 / fc2), layers.{i}.downsample → merge{i}, norm{i} →
out_norm{i}, absolute_pos_embed in either layout. Linear weights are
[out, in] on both sides; the merge's norm and reduction take efg_tpu's
permutation of their 4C input channels.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch `.pth` or a detectron2 `.pkl` → {name: numpy array}.

    `.pth` files are read with `torch.load(weights_only=False)`, as efg_tpu
    reads them: reference checkpoints hold non-tensor objects beside the
    weights (the optimizer and scheduler state, the iteration, the config),
    which the weights-only unpickler refuses. Load only checkpoints whose
    origin you trust. `.pkl` files are Caffe2/detectron2 pickles of numpy
    arrays written by Python 2, read as latin1."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        sd = data.get("model", data)
        return {k: np.asarray(v) for k, v in sd.items() if isinstance(v, np.ndarray)}
    data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data.get("model", data.get("state_dict", data))
    return {k: v.detach().numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str = "module.") -> Dict[str, np.ndarray]:
    """Strip DDP 'module.' prefixes (when every key has one)."""
    if all(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def sparse_weight(v: np.ndarray, layout: str) -> np.ndarray:
    """spconv weight → the port's [K, Cin, Cout] (offsets row-major over
    (kd, kh, kw)). spconv 2.x stores [Cout, kd, kh, kw, Cin]; spconv 1.x
    [kd, kh, kw, Cin, Cout]."""
    if v.ndim != 5:
        raise ValueError(f"expected 5-dim sparse conv weight, got {v.shape}")
    if layout == "spconv2":
        v = v.transpose(1, 2, 3, 4, 0)
    elif layout != "spconv1":
        raise ValueError(f"sparse_layout={layout!r}: expected spconv1|spconv2")
    return np.ascontiguousarray(v.reshape(-1, v.shape[3], v.shape[4]))


# reference BN leaf → the port's (torch's) leaf
_BN_LEAF = {"weight": "weight", "bias": "bias",
            "running_mean": "running_mean", "running_var": "running_var"}


def _block_inner(base: str, rest: list) -> Optional[Tuple[str, str]]:
    """SparseBasicBlock member → (port module path, kind)."""
    name, leaf = rest[0], rest[1]
    if name in ("conv1", "conv2"):
        return f"{base}.{name}", "sparse" if leaf == "weight" else "plain"
    if name == "bn1":
        return f"{base}.bn1.bn", "bn"
    if name == "bn2":
        return f"{base}.bn2", "bn"
    return None


def _rename(key: str, head_max: Dict[Tuple[str, str], int], neck: nn.Module):
    """Reference key → (port module path, kind), ("", "drop") or None.

    Reference naming: trunk SpMiddleResNetFHD (`conv_input` / `conv1..4`
    SparseSequentials / `extra_conv`); neck `blocks.{i}` (ZeroPad, Conv,
    BN, ReLU, then 3 entries a layer) and `deblocks.{i}` (ConvTranspose2d
    or Conv2d, BN, ReLU); head `shared_conv` and `tasks.{t}.{head}` SepHead
    Sequentials whose last index is the final conv, hidden convs at 3j and
    their BNs at 3j+1."""
    parts = key.split(".")
    if parts[-1] == "num_batches_tracked":
        return "", "drop"
    if parts[0] == "backbone":
        p = parts[1:]
        if p[0] == "conv_input":
            return ("backbone.conv_input", "sparse") if p[1] == "0" else ("backbone.bn_input.bn", "bn")
        if p[0] == "extra_conv":
            return ("backbone.extra_conv", "sparse") if p[1] == "0" else ("backbone.bn_extra.bn", "bn")
        if p[0] == "conv1":  # stage 0: blocks only
            return _block_inner(f"backbone.res0{'ab'[int(p[1])]}", p[2:])
        if p[0] in ("conv2", "conv3", "conv4"):
            s = int(p[0][4:]) - 1
            idx = int(p[1])
            if idx == 0:
                return f"backbone.down{s}", "sparse"
            if idx == 1:
                return f"backbone.bn_down{s}.bn", "bn"
            if idx in (3, 4):
                return _block_inner(f"backbone.res{s}{'ab'[idx - 3]}", p[2:])
        return None
    if parts[0] == "neck":
        p = parts[1:]
        if p[0] == "blocks":
            i, j = int(p[1]), int(p[2])
            if j == 1:
                return f"neck.block{i}_in.Conv_0", "plain"
            if j == 2:
                return f"neck.block{i}_in.BatchNorm_0", "bn"
            if j >= 4 and (j - 4) % 3 == 0:
                return f"neck.block{i}_conv{(j - 4) // 3}.Conv_0", "plain"
            if j >= 5 and (j - 5) % 3 == 0:
                return f"neck.block{i}_conv{(j - 5) // 3}.BatchNorm_0", "bn"
        if p[0] == "deblocks":
            i, j = int(p[1]), int(p[2])
            if j == 0:  # stride > 1: ConvTranspose2d; else a plain Conv2d
                if hasattr(neck, f"deblock{i}_deconv"):
                    return f"neck.deblock{i}_deconv", "plain"
                return f"neck.deblock{i}_conv", "plain"
            if j == 1:
                return f"neck.deblock{i}_bn", "bn"
        return None
    if parts[0] == "center_head":
        p = parts[1:]
        if p[0] == "shared_conv":
            return ("head.shared_conv", "plain") if p[1] == "0" else ("head.shared_bn", "bn")
        if p[0] == "tasks":
            t, h, idx = p[1], p[2], int(p[3])
            if idx == head_max[(t, h)]:
                return f"head.task{t}.{h}_final", "plain"
            if idx % 3 == 0:
                return f"head.task{t}.{h}_conv{idx // 3}", "plain"
            if idx % 3 == 1:
                return f"head.task{t}.{h}_bn{idx // 3}", "bn"
    return None


def import_centerpoint_voxelnet(
    sd: Dict[str, np.ndarray], module: nn.Module, *, sparse_layout: str = "spconv2",
) -> Tuple[int, list]:
    """Write a reference-format CenterPoint VoxelNet state dict into the
    port's `VoxelNet` `module` in place. A key that maps to no tensor of
    the module, or to one of another shape, is skipped (efg_tpu's
    `assign_into_tree`). Returns (n_assigned, skipped_keys); the dropped
    `num_batches_tracked` keys count as assigned, as in efg_tpu."""
    sd = strip_prefix(sd)
    head_max: Dict[Tuple[str, str], int] = {}
    for key in sd:
        parts = key.split(".")
        if len(parts) >= 5 and parts[0] == "center_head" and parts[1] == "tasks":
            t, h = parts[2], parts[3]
            head_max[(t, h)] = max(head_max.get((t, h), -1), int(parts[4]))

    target = module.state_dict()
    n, skipped = 0, []
    for key, val in sd.items():
        r = _rename(key, head_max, module.neck)
        if r is None:
            skipped.append(key)
            continue
        base, kind = r
        if kind == "drop":
            n += 1
            continue
        leaf = key.split(".")[-1]
        if kind == "bn":
            leaf = _BN_LEAF.get(leaf)
        elif kind == "sparse":
            val = sparse_weight(val, sparse_layout)
        name = f"{base}.{leaf}"
        t = target.get(name) if leaf else None
        if t is None or tuple(t.shape) != tuple(val.shape):
            skipped.append(key)
            continue
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(val)).to(t.dtype))
        n += 1
    return n, skipped


# ---------------------------------------------------------------------------
# torchvision ResNet
# ---------------------------------------------------------------------------

# efg_tpu's leaf kind (`convert_tensor`) → the port's tensor name
_RESNET_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}


def _resnet_rename(key: str) -> str:
    """torchvision ResNet key → the port's ResNet module path ("" when it
    has none): efg_tpu's `_resnet_rename`."""
    if key.startswith("backbone."):
        key = key[len("backbone."):]
    if key.startswith("conv1."):
        return "stem_conv1"
    if key.startswith("bn1."):
        return "stem_norm"
    if key.startswith("layer"):
        parts = key.split(".")
        base = f"res{int(parts[0][len('layer'):]) + 1}_block{parts[1]}"
        rest = parts[2]
        if rest.startswith("conv"):
            return f"{base}.conv{rest[4:]}"
        if rest.startswith("bn"):
            return f"{base}.norm{rest[2:]}"
        if rest == "downsample":
            return f"{base}.shortcut" if parts[3] == "0" else f"{base}.shortcut_norm"
    return ""


def _leaf_kind(name: str, value: np.ndarray) -> str:
    """efg_tpu's `convert_tensor` kind of a torch tensor name."""
    if name.endswith(".weight"):
        return {4: "kernel", 2: "kernel", 1: "scale"}.get(value.ndim, "raw")
    if name.endswith(".bias"):
        return "bias"
    if name.endswith(".running_mean"):
        return "mean"
    if name.endswith(".running_var"):
        return "var"
    return "raw"


def import_torchvision_resnet(sd: Dict[str, np.ndarray], module: nn.Module,
                              prefix: str = "backbone") -> Tuple[int, list]:
    """Write a torchvision-style ResNet state dict into the port's `ResNet`
    found at `prefix` in `module` ("" for the module itself), in place.
    `fc.` keys are dropped; a key that maps to no tensor of the module, or
    to one of another shape (`num_batches_tracked` among them), is
    skipped, as in efg_tpu. Returns (n_assigned, skipped_keys)."""
    target = module.state_dict()
    n, skipped = 0, []
    for key, val in strip_prefix(sd).items():
        if key.startswith("fc."):
            continue
        base = _resnet_rename(key)
        leaf = _RESNET_LEAF.get(_leaf_kind(key, val))
        name = ".".join(p for p in (prefix, base, leaf) if p) if base and leaf else None
        t = target.get(name) if name else None
        if t is None or tuple(t.shape) != tuple(val.shape):
            skipped.append(key)
            continue
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(val)).to(t.dtype))
        n += 1
    return n, skipped


# ---------------------------------------------------------------------------
# Swin Transformer (mmdet / official layout)
# ---------------------------------------------------------------------------


def _merge_perm(c4: int) -> np.ndarray:
    """The reference's 2×2 sub-grid order (00, 10, 01, 11) → the port's
    (00, 01, 10, 11), over 4C channels (efg_tpu's `_merge_perm`)."""
    c = c4 // 4
    g = np.arange(c)
    return np.concatenate([g, g + 2 * c, g + c, g + 3 * c])


def _swin_rename(key: str, val: np.ndarray):
    """A reference Swin key → (the port's tensor path, value), "drop" (the
    buffers efg_tpu drops and counts: relative_position_index,
    num_batches_tracked, attn_mask) or None (no counterpart)."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf in ("relative_position_index", "num_batches_tracked", "attn_mask"):
        return "drop"
    if key == "absolute_pos_embed":
        if val.ndim == 4:  # mmdet [1, C, H, W] → NHWC
            return "absolute_pos_embed", val.transpose(0, 2, 3, 1)
        if val.ndim == 3:  # official classification [1, N, C]
            side = int(round(val.shape[1] ** 0.5))
            return "absolute_pos_embed", val.reshape(1, side, side, -1)
        return None
    if parts[0] == "patch_embed":
        if parts[1] == "proj":
            return f"patch_embed.{leaf}", val
        if parts[1] == "norm":
            return f"patch_norm.{leaf}", val
        return None
    if parts[0].startswith("norm") and len(parts) == 2:
        return f"out_norm{int(parts[0][4:])}.{leaf}", val
    if parts[0] != "layers":
        return None
    i = int(parts[1])
    if parts[2] == "downsample":
        perm = _merge_perm(val.shape[-1] if leaf == "weight" and val.ndim == 2 else val.shape[0])
        if parts[3] == "norm":
            return f"merge{i}.norm.{leaf}", val[perm]
        if parts[3] == "reduction":
            return f"merge{i}.reduction.{leaf}", val[:, perm]
        return None
    if parts[2] == "blocks":
        base = f"stage{i}_block{int(parts[3])}"
        rest = parts[4:]
        if rest[0] in ("norm1", "norm2"):
            return f"{base}.{rest[0]}.{leaf}", val
        if rest[0] == "attn":
            if rest[1] == "relative_position_bias_table":
                return f"{base}.attn.relative_position_bias_table", val
            if rest[1] in ("qkv", "proj"):
                return f"{base}.attn.{rest[1]}.{leaf}", val
            return None
        if rest[0] == "mlp" and rest[1] in ("fc1", "fc2"):
            return f"{base}.{rest[1]}.{leaf}", val
    return None


def import_swin(sd: Dict[str, np.ndarray], module: nn.Module,
                prefix: str = "backbone") -> Tuple[int, list]:
    """Write a reference / mmdet-format Swin state dict into the port's
    `SwinTransformer` found at `prefix` in `module` ("" for the module
    itself), in place. As efg_tpu's `import_swin`: a dropped buffer counts
    as imported; a key with no counterpart, or one of another shape, is
    skipped. Returns (n, skipped_keys)."""
    target = module.state_dict()
    n, skipped = 0, []
    for key, val in strip_prefix(sd).items():
        r = _swin_rename(key, val)
        if r == "drop":
            n += 1
            continue
        if r is None:
            skipped.append(key)
            continue
        path, arr = r
        name = f"{prefix}.{path}" if prefix else path
        t = target.get(name)
        if t is None or tuple(t.shape) != tuple(arr.shape):
            skipped.append(key)
            continue
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype))
        n += 1
    return n, skipped
