"""Box attention: rotated-box sampling grids, bilinear sampling and the
window attention of Voxel-DETR (port of `efg_tpu/ops/box_attention.py`).

Every function here is the function of its efg_tpu counterpart, not its
TPU tiling: `box_attention_window_dense_mxu` (tile-local dense attention
through two MXU matmuls) and `box_attention_window_gather` (one 2-D slice
per query window, chunked with `lax.map`) both compute

    out[q, c] = Σ_o A[q, head(c), o] · V[base(q) + off(o), c],

zero outside the map, with base(q) the query's own cell (dense) or its
anchor cell (gather) and off(o) the (2R+1)² integer offsets. Each keeps
its op's roundings: the dense op rounds V and A to bf16 and sums in f32;
the gather op rounds V to bf16 and A to `GATHER_DOT_DTYPE`, the type of
efg_tpu's `_dot_dtype()` on the device it runs on (bf16 on an
accelerator, f32 on the CPU), and sums in f32. The products of two bf16
values are exact in f32, so f32 arithmetic on the rounded operands is
efg_tpu's bf16 product with an f32 accumulator.

Gradients are plain autograd, as efg_tpu's are for the dense op (its
roundings are casts, so dV and dA come back rounded to bf16 there too).
efg_tpu gives the gather op a custom VJP (`_window_gather_runs`) whose dV
and dA are f32 sums (of the rounded operands' products); the port's
gather op rounds V and A with an identity gradient (`_rounded`), so its
autograd computes the same.
`WINDOW_DTYPE` is the type both ops round V (and the encoder's A) to:
bf16, as efg_tpu's ops; tests that hold the port against efg_tpu's f32
forms of the ops (`box_attention_window_dense`, the gather's `runs=False`)
set it to f32.

Maps are NHWC [B, H, W, C]; a head's channels are the contiguous slice
[h·hd, (h+1)·hd) of C; grid coordinates are normalized [0, 1] per level.
These are plain PyTorch: efg_tpu has no Pallas kernel for them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# The type the gather op rounds the binned coefficients to before its
# products: efg_tpu's `_dot_dtype()` on an accelerator. Its CPU run keeps
# f32 there; tests that hold the port against it on the CPU switch this.
GATHER_DOT_DTYPE = torch.bfloat16
WINDOW_DTYPE = torch.bfloat16


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and back, with the identity as its gradient."""
    return x + (x.to(dtype).to(x.dtype) - x).detach()


def kernel_indices(kernel_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[P, 2] (x, y) grid offsets in box-fraction units (reference
    `_create_kernel_indices`)."""
    if kernel_size % 2 == 0:
        start, end = -kernel_size // 2 + 0.5, kernel_size // 2 - 0.5
    else:
        start, end = -(kernel_size - 1) // 2, (kernel_size - 1) // 2
    idx = torch.linspace(start, end, kernel_size, dtype=dtype, device=device)
    i, j = torch.meshgrid(idx, idx, indexing="ij")
    return torch.stack([j, i], dim=-1).reshape(-1, 2) / kernel_size


def make_box_grids(ref_boxes: torch.Tensor, ref_angles: torch.Tensor,
                   offset_boxes: torch.Tensor, offset_angles: Optional[torch.Tensor],
                   kernel_idx: torch.Tensor) -> torch.Tensor:
    """Normalized sampling grids (reference `_where_to_attend`).

    ref_boxes [B, L, 1|NH, NL, 4] (cx, cy, w, h in [0, 1]), ref_angles
    [B, L, 1|NH, NL, 1] (angle / 2π), offset_boxes [B, L, NH, NL, 4],
    offset_angles the same or None, kernel_idx [P, 2] → grids
    [B, L, NH, NL, P, 2]."""
    if offset_angles is not None:
        angles = (ref_angles + offset_angles / 16.0) * 2.0 * math.pi
    else:
        angles = ref_angles * 2.0 * math.pi
    boxes = ref_boxes + offset_boxes / 8.0 * ref_boxes[..., [2, 3, 2, 3]]
    center, size = boxes[..., :2], boxes[..., 2:]
    cos_a, sin_a = torch.cos(angles), torch.sin(angles)  # [..., 1]
    grid = kernel_idx * torch.relu(size)[..., None, :]  # [..., P, 2]
    # row-vector rotation (reference rot_matrix [[c, -s], [s, c]] · grid)
    gx = grid[..., 0] * cos_a - grid[..., 1] * sin_a
    gy = grid[..., 0] * sin_a + grid[..., 1] * cos_a
    return center[..., None, :] + torch.stack([gx, gy], dim=-1)


def bilinear_taps(gx: torch.Tensor, gy: torch.Tensor, h: int, w: int):
    """The four bilinear taps of pixel coordinates gx / gy on an H×W map:
    (flat index, weight) pairs of gx's shape, a tap outside the map
    weighted 0 and its index clamped into the map."""
    x0, y0 = torch.floor(gx), torch.floor(gy)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (1 - torch.abs(gx - xi)) * (1 - torch.abs(gy - yi))
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        yield (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).long(), wgt * ok


def _bilinear_gather(flat: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    """flat [B, H·W, C] (head-major channels), gx / gy [B, L, NH] pixel
    coordinates → [B, L, NH, hd]: each head reads its own channel slice;
    taps outside the map contribute zero."""
    b, _, c = flat.shape
    nh = gx.shape[-1]
    vv = flat.reshape(b, h * w, nh, c // nh)
    bidx = torch.arange(b, device=flat.device)[:, None, None]
    hidx = torch.arange(nh, device=flat.device)[None, None, :]
    out = None
    for idx, wgt in bilinear_taps(gx, gy, h, w):  # idx [B, L, NH]
        contrib = vv[bidx, idx, hidx] * wgt[..., None].to(flat.dtype)  # [B, L, NH, hd]
        out = contrib if out is None else out + contrib
    return out


def box_attention_sample(value_levels: Sequence[torch.Tensor], grids: torch.Tensor,
                         attn_weights: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """Exact bilinear sampling and weighted sum (the reference CUDA
    kernel's semantics). value_levels: [B, H_l, W_l, C] maps; grids
    [B, L, NH, NL, P, 2]; attn_weights [B, L, NH, NL, P] → [B, L, C]."""
    b, l, nh, _, p, _ = grids.shape
    c = value_levels[0].shape[-1]
    out = value_levels[0].new_zeros(b, l, nh, c // num_heads)
    for lvl, vmap in enumerate(value_levels):
        h, w = vmap.shape[1:3]
        flat = vmap.reshape(b, h * w, c)
        for pi in range(p):
            gx = grids[:, :, :, lvl, pi, 0] * w - 0.5
            gy = grids[:, :, :, lvl, pi, 1] * h - 0.5
            sampled = _bilinear_gather(flat, gx, gy, h, w)
            out = out + sampled * attn_weights[:, :, :, lvl, pi, None].to(out.dtype)
    return out.reshape(b, l, c)


def bin_window_coeffs(grids: torch.Tensor, attn_weights: torch.Tensor, base_yx: torch.Tensor,
                      h: int, w: int, radius: int) -> torch.Tensor:
    """Bin every bilinear tap of every sample point into the integer-offset
    window around the query's anchor cell: a tap at (dy, dx) from the anchor,
    clamped into ±radius, adds its bilinear × attention weight to bin
    (dy+R)·(2R+1) + (dx+R); taps outside the map add zero.

    grids [B, L, NH, 1, P, 2], attn_weights [B, L, NH, 1, P], base_yx
    [B, L, 2] int (y, x) → A [B, L, NH, (2R+1)²] f32."""
    b, l, nh, nlvl, p, _ = grids.shape
    if nlvl != 1:
        raise ValueError("the window path takes a single value level")
    s = 2 * radius + 1
    gx = grids[..., 0, :, 0] * w - 0.5  # [B, L, NH, P]
    gy = grids[..., 0, :, 1] * h - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    bx = base_yx[..., 1][:, :, None, None].to(torch.int32)
    by = base_yx[..., 0][:, :, None, None].to(torch.int32)
    aw = attn_weights[..., 0, :]
    acc = torch.zeros(b, l, nh, s * s, dtype=torch.float32, device=grids.device)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wt = (fx if dx == 1 else 1 - fx) * (fy if dy == 1 else 1 - fy)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        rx = torch.clamp(xi.to(torch.int32) - bx, -radius, radius)
        ry = torch.clamp(yi.to(torch.int32) - by, -radius, radius)
        o = ((ry + radius) * s + (rx + radius)).long()
        acc.scatter_add_(-1, o, (wt * aw * ok).to(torch.float32))
    return acc


def _head_expand(a: torch.Tensor, hd: int) -> torch.Tensor:
    """[..., NH] per-head coefficients → [..., NH·hd] head-major channels."""
    return a.repeat_interleave(hd, dim=-1)


def box_attention_window_dense(value: torch.Tensor, coeffs: torch.Tensor, *,
                               num_heads: int, radius: int) -> torch.Tensor:
    """Window self-attention with every query anchored at its own cell (the
    encoder; efg_tpu's `box_attention_window_dense_mxu`): V and A rounded to
    WINDOW_DTYPE, sums in f32, one shifted slice of the zero-padded map per offset.
    value [B, H, W, C], coeffs [B, H·W, NH, (2R+1)²] → [B, H·W, C] in
    value's dtype."""
    b, h, w, c = value.shape
    hd = c // num_heads
    s = 2 * radius + 1
    vp = torch.nn.functional.pad(value.to(WINDOW_DTYPE).float(),
                                 (0, 0, radius, radius, radius, radius))
    a = coeffs.reshape(b, h, w, num_heads, s * s).to(WINDOW_DTYPE).float()
    out = torch.zeros(b, h, w, c, dtype=torch.float32, device=value.device)
    for o in range(s * s):
        dy, dx = divmod(o, s)
        out += _head_expand(a[..., o], hd) * vp[:, dy:dy + h, dx:dx + w]
    return out.reshape(b, h * w, c).to(value.dtype)


def box_attention_window_gather(value: torch.Tensor, coeffs: torch.Tensor,
                                base_yx: torch.Tensor, *, num_heads: int, radius: int,
                                chunk: int = 512) -> torch.Tensor:
    """Window attention around each query's anchor cell (decoder
    cross-attention; efg_tpu's `box_attention_window_gather`): the
    (2R+1)² cells of the window gathered from the zero-padded map, V
    rounded to WINDOW_DTYPE and A to GATHER_DOT_DTYPE, sums in f32. value
    [B, H, W, C], coeffs [B, L, NH, (2R+1)²], base_yx [B, L, 2] (clamped
    into the map, as efg_tpu clamps it) → [B, L, C] in value's dtype.
    Queries go in chunks of `chunk` to bound the gathered windows."""
    b, h, w, c = value.shape
    hd = c // num_heads
    s = 2 * radius + 1
    l = coeffs.shape[1]
    dev = value.device
    y = torch.clamp(base_yx[..., 0].long(), 0, h - 1)
    x = torch.clamp(base_yx[..., 1].long(), 0, w - 1)
    wp = w + 2 * radius
    vp = torch.nn.functional.pad(_rounded(value.float(), WINDOW_DTYPE),
                                 (0, 0, radius, radius, radius, radius))
    vflat = vp.reshape(b, (h + 2 * radius) * wp, c)
    oy = torch.arange(s, device=dev).repeat_interleave(s)  # window row, then column
    ox = torch.arange(s, device=dev).repeat(s)
    bidx = torch.arange(b, device=dev)[:, None, None]
    outs = []
    for q0 in range(0, l, chunk):
        # padded coords of window cell (oy, ox) of a query at (y, x): (y + oy, x + ox)
        rows = (y[:, q0:q0 + chunk, None] + oy) * wp + (x[:, q0:q0 + chunk, None] + ox)
        patch = vflat[bidx, rows]  # [B, q, S², C]
        patch = patch.reshape(*patch.shape[:3], num_heads, hd)
        a = _rounded(coeffs[:, q0:q0 + chunk].float(), GATHER_DOT_DTYPE)  # [B, q, NH, S²]
        outs.append(torch.einsum("bqno,bqonh->bqnh", a, patch).reshape(b, -1, c))
    return torch.cat(outs, dim=1).to(value.dtype)
