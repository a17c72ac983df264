"""Sparse 3D convolution on sorted-key rulebooks (port of the forward of
`efg_tpu/ops/sparse.py`).

A `SparseTensor` is a fixed-capacity array of voxel rows sorted by their
linearized (b, z, y, x) keys, with a validity mask. Every conv here runs on
the packed anchor rulebook of `ops/cuda/sparse_kernels.py` (the JAX
`backend="pallas"` branch): the rank kernel builds the rulebooks and the
gather-GEMM kernel runs the contraction. The JAX XLA-backend rulebooks
(`build_subm_rulebook9`, `gather_gemm9`, the table / search strided paths)
are a second implementation of the same convs and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from efg_tpu_torch.ops.cuda import sparse_kernels as K

SENTINEL = torch.iinfo(torch.int32).max

# Above this many output cells the strided conv dedups candidate sites by
# sorting instead of marking a dense grid (same limit as efg_tpu).
DENSE_GRID_LIMIT = 600_000_000


def _as3(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 values, got {v}")
    return t


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """Fixed-capacity batched sparse voxel tensor (rows sorted by key)."""

    features: torch.Tensor  # [V, C]
    coords: torch.Tensor  # [V, 4] int32 (b, z, y, x); zeros where invalid
    keys: torch.Tensor  # [V] int32 sorted; SENTINEL where invalid
    valid: torch.Tensor  # [V] bool
    spatial_shape: Tuple[int, int, int]  # (D, H, W)
    batch_size: int

    @property
    def num_channels(self) -> int:
        return self.features.shape[1]

    def replace_features(self, features: torch.Tensor) -> "SparseTensor":
        return dataclasses.replace(self, features=features)


def linear_key(coords: torch.Tensor, spatial_shape: Sequence[int], valid: torch.Tensor) -> torch.Tensor:
    """(b, z, y, x) → sorted-friendly int32 key; invalid rows → SENTINEL."""
    d, h, w = spatial_shape
    b, z, y, x = coords[..., 0], coords[..., 1], coords[..., 2], coords[..., 3]
    key = ((b * d + z) * h + y) * w + x
    return torch.where(valid, key, SENTINEL)


def from_batched_voxels(
    features: torch.Tensor,
    coords_zyx: torch.Tensor,
    valid: torch.Tensor,
    spatial_shape: Sequence[int],
) -> SparseTensor:
    """Build a SparseTensor from per-sample voxelizer output.

    features [B, V, C], coords_zyx [B, V, 3], valid [B, V]. Padding rows
    sit between samples after flattening, so one stable global key sort
    restores the sorted-keys invariant (all padding compacts to the tail)."""
    bsz, cap = features.shape[0], features.shape[1]
    d, h, w = (int(s) for s in spatial_shape)
    if bsz * d * h * w >= 2**31:
        raise ValueError("linear key overflows int32; shard the batch")
    dev = features.device
    batch_idx = torch.arange(bsz, dtype=torch.int32, device=dev)[:, None].expand(bsz, cap)
    coords = torch.cat([batch_idx[..., None], coords_zyx.to(torch.int32)], dim=-1)
    coords = coords.reshape(bsz * cap, 4)
    valid = valid.reshape(bsz * cap)
    feats = features.reshape(bsz * cap, features.shape[-1])
    coords = coords * valid[:, None].to(torch.int32)
    keys = linear_key(coords, (d, h, w), valid)
    keys, order = torch.sort(keys, stable=True)
    return SparseTensor(feats[order], coords[order], keys, valid[order], (d, h, w), bsz)


def build_rulebook(st: SparseTensor, kernel_size: int = 3) -> torch.Tensor:
    """The packed SubM rulebook [9, V] shared by every SubM layer on `st`'s
    coordinate set (the spconv `indice_key` analog)."""
    return K.build_monotone_rule9(st, kernel_size)


def subm_conv(
    st: SparseTensor,
    weights: torch.Tensor,
    rulebook: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> SparseTensor:
    """Submanifold conv: output sites == input sites. weights [27, Cin,
    Cout] in (δz, δy, δx) raster; `rulebook` from `build_rulebook`."""
    out = K.subm_conv9(st.features, rulebook, weights, st.valid)
    if bias is not None:
        out = (out + bias) * st.valid[:, None].to(out.dtype)
    return st.replace_features(out)


def _downsample_shape(shape, kernel, stride, padding) -> Tuple[int, int, int]:
    return tuple(
        (shape[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1 for i in range(3)
    )


def downsample_sites(st: SparseTensor, *, kernel_size, stride, padding, max_out: int):
    """Output sites of a strided (generative) conv: every site whose kernel
    window touches ≥1 input voxel, deduplicated, truncated first-come in key
    order to `max_out` over the whole batch. Returns (out_keys [max_out],
    out_valid, out_coords [max_out, 4], out spatial shape)."""
    ks, s, p = _as3(kernel_size), _as3(stride), _as3(padding)
    d, h, w = st.spatial_shape
    od, oh, ow = _downsample_shape((d, h, w), ks, s, p)
    bsz = st.batch_size
    if bsz * od * oh * ow >= 2**31:
        raise ValueError("output linear key overflows int32")
    dev = st.keys.device
    out_shape = (od, oh, ow)

    # --- 1. candidate output sites: o = (i + p - κ) / s, κ ∈ [0, k) ---------
    ncand = [-(-ks[i] // s[i]) for i in range(3)]  # ceil(k/s) per dim

    def dim_candidates(i_coord, dim_i):
        # o in [ceil((i + p - k + 1)/s), floor((i + p)/s)], clipped to grid
        lo = -(-(i_coord + p[dim_i] - ks[dim_i] + 1) // s[dim_i])
        hi = (i_coord + p[dim_i]) // s[dim_i]
        offs = torch.arange(ncand[dim_i], dtype=torch.int32, device=dev)
        cand = lo[:, None] + offs[None, :]
        ok = (cand <= hi[:, None]) & (cand >= 0) & (cand < out_shape[dim_i])
        return cand, ok  # [V, ncand]

    cz, okz = dim_candidates(st.coords[:, 1], 0)
    cy, oky = dim_candidates(st.coords[:, 2], 1)
    cx, okx = dim_candidates(st.coords[:, 3], 2)
    ok = (
        okz[:, :, None, None]
        & oky[:, None, :, None]
        & okx[:, None, None, :]
        & st.valid[:, None, None, None]
    )
    b = st.coords[:, 0, None, None, None]
    cand_key = ((b * od + cz[:, :, None, None]) * oh + cy[:, None, :, None]) * ow + cx[:, None, None, :]
    cand_key = torch.where(ok, cand_key, SENTINEL).reshape(-1)

    # --- 2. dedup + truncate to max_out ------------------------------------
    out_keys = torch.full((max_out + 1,), SENTINEL, dtype=torch.int32, device=dev)
    out_cells = bsz * od * oh * ow
    if out_cells <= DENSE_GRID_LIMIT:
        # dense-grid dedup: mark + cumsum; grid raster order IS key order,
        # so out_keys come out sorted
        valid_cand = cand_key != SENTINEL
        mark = torch.zeros(out_cells + 1, dtype=torch.int32, device=dev)
        mark[torch.where(valid_cand, cand_key, out_cells).long()] = 1
        slot_of_cell = torch.cumsum(mark[:out_cells], 0, dtype=torch.int32) - 1
        slot = slot_of_cell[torch.clamp(cand_key, 0, out_cells - 1).long()]
        write = torch.where(valid_cand & (slot >= 0) & (slot < max_out), slot, max_out)
        out_keys.scatter_reduce_(0, write.long(), cand_key, "amin")
    else:
        sorted_keys = torch.sort(cand_key).values
        uniq_first = torch.cat(
            [sorted_keys[:1] != SENTINEL, sorted_keys[1:] != sorted_keys[:-1]]
        ) & (sorted_keys != SENTINEL)
        slot = torch.cumsum(uniq_first.to(torch.int32), 0, dtype=torch.int32) - 1
        write = torch.where(uniq_first & (slot < max_out), slot, max_out)
        out_keys.scatter_reduce_(0, write.long(), sorted_keys, "amin")
    out_keys = out_keys[:max_out]
    out_valid = out_keys != SENTINEL
    key_safe = torch.where(out_valid, out_keys, 0)
    ob = key_safe // (od * oh * ow)
    ozc = (key_safe // (oh * ow)) % od
    oyc = (key_safe // ow) % oh
    oxc = key_safe % ow
    out_coords = torch.stack([ob, ozc, oyc, oxc], dim=-1) * out_valid[:, None].to(torch.int32)
    return out_keys, out_valid, out_coords, out_shape


def spconv_downsample(
    st: SparseTensor,
    weights: torch.Tensor,
    *,
    kernel_size,
    stride,
    padding,
    max_out: int,
    bias: Optional[torch.Tensor] = None,
) -> SparseTensor:
    """Strided (generative) sparse conv, reference SparseConv3d semantics.

    weights [K, Cin, Cout] with K = prod(kernel_size), offsets in
    (dz, dy, dx) raster order from the kernel origin (not centered). The
    packed rulebook takes kw ∈ {1, 3} with kh == 3, or a (k, 1, 1) kernel."""
    ks, s, p = _as3(kernel_size), _as3(stride), _as3(padding)
    kd, kh, kw = ks
    if not (kw in (1, 3) and (kh == 3 or (kw == 1 and kh == 1))):
        raise ValueError(f"no packed rulebook for kernel {ks}")
    out_keys, out_valid, out_coords, out_shape = downsample_sites(
        st, kernel_size=ks, stride=s, padding=p, max_out=max_out
    )
    packed = K.build_monotone_rule_strided(
        st, out_coords[:, 0], out_coords[:, 1], out_coords[:, 2], out_coords[:, 3],
        out_valid, ks, s, p,
    )
    if kh == 1:
        # the builder expanded each κz pair to its own group of 3: zero-pad
        # the weight pairs to match [κ0, 0, 0, κ1, 0, 0, …]
        w_eff = weights.new_zeros(3 * kd, weights.shape[1], weights.shape[2])
        w_eff[::3] = weights
        weights = w_eff
    out_feats = K.strided_conv_packed(st.features, packed, weights, out_valid, kw3=kw)
    if bias is not None:
        out_feats = (out_feats + bias) * out_valid[:, None].to(out_feats.dtype)
    return SparseTensor(out_feats, out_coords, out_keys, out_valid, out_shape, st.batch_size)


def to_dense(st: SparseTensor) -> torch.Tensor:
    """SparseTensor → dense [B, D, H, W, C] (channels last)."""
    d, h, w = st.spatial_shape
    b, c = st.batch_size, st.num_channels
    cells = b * d * h * w
    flat_idx = torch.where(st.valid, st.keys, cells).long()
    dense = st.features.new_zeros(cells + 1, c)
    dense[flat_idx] = torch.where(st.valid[:, None], st.features, 0)
    return dense[:cells].reshape(b, d, h, w, c)


def bev_dense(st: SparseTensor) -> torch.Tensor:
    """SparseTensor → BEV map [B, H, W, C·D], channel index c·D + d (the
    `.dense()` + reshape of `SpMiddleResNetFHD.forward`)."""
    dense = to_dense(st)  # [B, D, H, W, C]
    b, d, h, w, c = dense.shape
    return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)
