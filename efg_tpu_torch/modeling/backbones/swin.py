"""Swin Transformer backbone (port of `efg_tpu/modeling/backbones/swin.py`).

Patch embed, shifted-window attention with a relative position bias,
patch merging, four stages emitting res2..res5 maps. Inside, the maps
are NHWC like efg_tpu's (the LayerNorms normalise the last axis); the
module takes NCHW images and returns NCHW maps, the contract of the
port's `ResNet`, so Mask2Former's pixel decoder reads either trunk.

efg_tpu's choices that this keeps:

- every block keeps the configured window size and shift at every map
  size: the map is padded to window multiples, attended, and cut back;
  the shifted blocks' −100 mask is built over the padded map;
- `PatchMerging` pads odd maps and concatenates the 2×2 sub-grids in
  (00, 01, 10, 11) order (the reference's checkpoints use (00, 10, 01,
  11); `utils/torch_import.py` `import_swin` permutes them);
- LayerNorm eps 1e-5 (torch's, where flax's default is 1e-6);
- the patch embed is flax's `Conv` with SAME padding;
- the absolute position embedding lives NHWC at the pretrain patch grid
  and is resized to the map with `jax.image.resize`'s Keys cubic
  (`ops/resize.py`);
- stochastic depth on a linear schedule over the block index; in train
  mode `DropPath` draws its per-sample keep mask from the generator the
  forward is given (the training step's), as efg_tpu's from its dropout
  rng.

Parameter names are the flax modules' (`stage{s}_block{b}.attn.qkv`,
`merge{s}.reduction`, `out_norm{s}`, ...), so `utils/jax_import.py` maps
efg_tpu's variables by path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.ops.resize import resize
from efg_tpu_torch.parallel import ddp

LN_EPS = 1e-5  # torch's LayerNorm epsilon, as efg_tpu's Swin sets it
TRUNC_STD = 0.02


def _trunc_(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `truncated_normal(0.02)`: N(0, 0.02) cut at ±2σ, in place."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=TRUNC_STD, a=-2 * TRUNC_STD, b=2 * TRUNC_STD,
                                     generator=generator)


def _linear(cin: int, cout: int, bias: bool = True,
            generator: Optional[torch.Generator] = None) -> nn.Linear:
    lin = nn.Linear(cin, cout, bias=bias)
    _trunc_(lin.weight, generator)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


def _ln(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, ws², C], windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws², ws²] index into the (2ws−1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """The additive mask [nW, ws², ws²] of a shifted block over the padded
    map: −100 between cells of different regions of the rolled map."""
    img_mask = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img_mask), ws)[..., 0].numpy()  # [nW, ws²]
    return np.where(mw[:, :, None] != mw[:, None, :], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    flax_params = ("relative_position_bias_table",)

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.qkv = _linear(dim, 3 * dim, generator=generator)
        self.proj = _linear(dim, dim, generator=generator)
        self.relative_position_bias_table = nn.Parameter(
            _trunc_(torch.empty((2 * window_size - 1) ** 2, num_heads), generator))
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [nW·B, ws², C]; mask [nW, ws², ws²] additive or None."""
        bw, n, _ = x.shape
        nh = self.num_heads
        hd = self.dim // nh
        qkv = self.qkv(x).reshape(bw, n, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [bw, NH, n, hd]
        attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        bias = self.relative_position_bias_table[self.rel_index].reshape(n, n, nh)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(bw, nh, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, self.dim)
        return self.proj(out)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in train mode with rate > 0, each sample
    is kept with probability 1 − rate (and scaled by 1 / (1 − rate)), the
    keep mask drawn from `generator` (torch's global stream when None)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        b = x.shape[0]
        bg, r0 = ddp.global_batch(b)  # one draw over the global batch, this rank's rows
        mask = torch.rand((bg,), generator=generator, device=x.device)[r0:r0 + b] < keep
        mask = mask.reshape((b,) + (1,) * (x.ndim - 1))
        return x * mask.to(x.dtype) / keep


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = _ln(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, generator)
        self.drop_path = DropPath(drop_path)
        self.norm2 = _ln(dim)
        self.fc1 = _linear(dim, int(dim * mlp_ratio), generator=generator)
        self.fc2 = _linear(int(dim * mlp_ratio), dim, generator=generator)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_mask(hp, wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        ws, shift = self.window_size, self.shift
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        shortcut = x
        x = F.pad(self.norm1(x), (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, x.device)
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :h, :w], generator)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + self.drop_path(y, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = _ln(4 * dim)
        self.reduction = _linear(4 * dim, 2 * dim, bias=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // 2, w // 2, 4 * c)
        return self.reduction(self.norm(x))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA SAME padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SwinTransformer(nn.Module):
    """Swin-T by default (embed 96, depths 2/2/6/2, heads 3/6/12/24). Built
    on the CPU; the caller moves it."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 patch_size: int = 4, drop_path_rate: float = 0.0,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 ape: bool = False, pretrain_img_size: int = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depths, self.patch_size, self.ape = tuple(depths), patch_size, ape
        self.out_features = tuple(out_features)
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size, bias=True,
                                  dtype=None, generator=generator)
        _trunc_(self.patch_embed.weight, generator)
        self.patch_norm = _ln(embed_dim)
        self.flax_params = ()
        if ape:
            hp0 = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(
                _trunc_(torch.empty(1, hp0, hp0, embed_dim), generator))
            self.flax_params = ("absolute_pos_embed",)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        dim, blk_i = embed_dim, 0
        self.out_channels: Dict[str, int] = {}
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            for blk in range(depth):
                setattr(self, f"stage{stage}_block{blk}", SwinBlock(
                    dim, heads, window_size, shift=0 if blk % 2 == 0 else window_size // 2,
                    drop_path=dpr[blk_i], generator=generator))
                blk_i += 1
            name = f"res{stage + 2}"
            if name in self.out_features:
                setattr(self, f"out_norm{stage}", _ln(dim))
                self.out_channels[name] = dim
            if stage < len(depths) - 1:
                setattr(self, f"merge{stage}", PatchMerging(dim, generator))
                dim *= 2

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """NCHW images [B, 3, H, W] → {res_k: NCHW map} for `out_features`."""
        p = self.patch_size
        ph, pw = same_pads(images.shape[2], p, p), same_pads(images.shape[3], p, p)
        x = self.patch_embed(F.pad(images, (*pw, *ph))).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        if self.ape:
            pos = self.absolute_pos_embed
            if pos.shape[1:3] != x.shape[1:3]:
                pos = resize(pos, (1, x.shape[1], x.shape[2], pos.shape[3]), "cubic")
            x = x + pos
        outputs: Dict[str, torch.Tensor] = {}
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, generator)
            name = f"res{stage + 2}"
            if name in self.out_features:
                outputs[name] = getattr(self, f"out_norm{stage}")(x).permute(0, 3, 1, 2)
            if stage < len(self.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return outputs
