"""Deformable convolution v1 / v2 as a bilinear gather and a matrix product
(port of `efg_tpu/ops/deform_conv.py`).

For every output location and kernel tap the input is sampled at the tap's
place plus its learned offset, bilinearly from the four neighbouring
pixels (a neighbour off the map reads 0); v2 multiplies each sample by
σ(modulation). The taps × channels are then contracted with the kernel.
efg_tpu writes this as a `jnp` gather and einsum (no Pallas kernel), and
so does the port: plain PyTorch, its gradients by autograd (the gather's
backward is a scatter-add).

`deform_conv2d` keeps efg_tpu's layouts (NHWC input, [B, Ho, Wo, 2K]
offsets as (dy, dx) per tap, HWIO kernel); `DeformConv`, the layer of the
NCHW ResNet, runs the same sampling on NCHW maps with an OIHW `weight`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d


def _sample(x: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] sampled at (gy, gx) [B, K, Ho, Wo] → [B, C, K, Ho, Wo]:
    the four neighbours (dy outer, dx inner, summed in that order), each
    weighted (1 − |y − yi|)(1 − |x − xi|) and 0 off the map."""
    b, c, h, w = x.shape
    flat = x.reshape(b, c, h * w)
    y0, x0 = torch.floor(gy), torch.floor(gx)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            wgt = (1 - torch.abs(gy - yi)) * (1 - torch.abs(gx - xi))
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            yc = torch.clamp(yi, 0, h - 1).long()
            xc = torch.clamp(xi, 0, w - 1).long()
            idx = (yc * w + xc).reshape(b, 1, -1).expand(b, c, -1)
            px = torch.gather(flat, 2, idx).reshape(b, c, *gy.shape[1:])
            out = out + px * (wgt * ok)[:, None]
    return out


def deform_conv2d_nchw(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, *,
                       stride: int = 1, padding: int = 1,
                       modulation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, Cin, H, W], offsets [B, 2K, Ho, Wo] ((dy, dx) per tap),
    weight [Cout, Cin, kh, kw], modulation [B, K, Ho, Wo] (v2) →
    [B, Cout, Ho, Wo], in x's dtype with an f32 product."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    dev, dt = x.device, x.dtype
    oy = torch.arange(ho, dtype=dt, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=dt, device=dev) * stride - padding
    ky, kx = torch.meshgrid(torch.arange(kh, dtype=dt, device=dev),
                            torch.arange(kw, dtype=dt, device=dev), indexing="ij")
    base_y = ky.reshape(k, 1, 1) + oy.reshape(1, ho, 1)  # [K, Ho, 1]
    base_x = kx.reshape(k, 1, 1) + ox.reshape(1, 1, wo)  # [K, 1, Wo]
    off = offsets.reshape(b, k, 2, ho, wo)
    sampled = _sample(x, base_y + off[:, :, 0], base_x + off[:, :, 1])  # [B, Cin, K, Ho, Wo]
    if modulation is not None:
        sampled = sampled * torch.sigmoid(modulation)[:, None]
    wk = weight.reshape(cout, cin, k).to(torch.float32)
    out = torch.einsum("ock,bckp->bop", wk, sampled.reshape(b, cin, k, ho * wo).float())
    return out.reshape(b, cout, ho, wo).to(dt)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor, *,
                  stride: int = 1, padding: int = 1,
                  modulation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """efg_tpu's `deform_conv2d` in its layouts: x [B, H, W, Cin], offsets
    [B, Ho, Wo, 2K], weights [kh, kw, Cin, Cout], modulation [B, Ho, Wo, K]
    → [B, Ho, Wo, Cout]."""
    out = deform_conv2d_nchw(
        x.permute(0, 3, 1, 2), offsets.permute(0, 3, 1, 2), weights.permute(3, 2, 0, 1),
        stride=stride, padding=padding,
        modulation=None if modulation is None else modulation.permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1)


class DeformConv(nn.Module):
    """efg_tpu's `DeformConv` on NCHW maps: `offset_conv` (a k×k conv with
    bias, zero-initialised, stride and padding of the layer) gives 2K
    offsets, and with `modulated` (v2, efg_tpu's `ModulatedDeformConv`) K
    modulation logits after them; `weight` [O, I, k, k] is drawn as flax's
    variance_scaling(1/3, fan_in, uniform). No bias."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 modulated: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size ** 2
        self.stride, self.padding, self.modulated, self.k = stride, kernel_size // 2, modulated, k
        self.offset_conv = Conv2d(cin, 3 * k if modulated else 2 * k, kernel_size, stride=stride,
                                  padding=kernel_size // 2, bias=True, dtype=None,
                                  generator=generator)
        nn.init.zeros_(self.offset_conv.weight)
        bound = 1.0 / math.sqrt(cin * k)
        self.weight = nn.Parameter(torch.empty(features, cin, kernel_size, kernel_size)
                                   .uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        off = self.offset_conv(x)
        offsets, mask = (off[:, :2 * self.k], off[:, 2 * self.k:]) if self.modulated \
            else (off, None)
        return deform_conv2d_nchw(x, offsets, self.weight, stride=self.stride,
                                  padding=self.padding, modulation=mask)


def ModulatedDeformConv(cin: int, features: int, **kw) -> DeformConv:  # noqa: N802
    """efg_tpu's `ModulatedDeformConv`: DeformConv with `modulated=True`."""
    return DeformConv(cin, features, modulated=True, **kw)
