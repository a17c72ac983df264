"""Hopper kernels for the sparse conv (port of the forward subset of
`efg_tpu/ops/pallas/sparse_kernels.py`).

Two hand-written CUDA C++ kernels carry the sparse trunk's forward:

- `merge_rank_flags` → `csrc/rank_flags.cu` (replaces `_rank_kernel_seq`):
  ranks P monotone query rows against one sorted key array; every SubM and
  strided rulebook is built from it.
- `fused_gather_gemm` → `csrc/gather_gemm.cu` (replaces `_fwd_kernel`): the
  packed-rulebook gather + GEMM that runs every sparse conv.

Each wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain PyTorch version beside it.
There is no fallback from a failed build or launch. `launches` counts the
kernel launches (CPU calls never count).

Packed rulebook ("anchor" convention, shared by SubM and strided convs):
  packed[p, v] = pos·8 + fm·4 + f0·2 + fp, where pos is the insertion
  position of the MIDDLE tap's query key in the sorted input keys (monotone
  in v per pair) and (fm, f0, fp) flag the (δx=-1, 0, +1) tap neighbours.
  Tap rows are (pos-1, pos, pos+f0).

The TPU tiling machinery (`_prep`, `_feat3`, `PreppedRule`, pack2, tile /
band / wslack) is a Mosaic workaround and has no counterpart here: the
kernels take the raw [P, V_out] rulebook and the input row count.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from efg_tpu_torch.ops.cuda import build as _build

# Query values at or above this threshold are treated as +inf (padding).
INVALID_Q = 1 << 29
CLAMP_Q = 1 << 30  # canonical +inf value keys/queries are clamped to

GEMM_CHANNELS = (16, 32, 64, 128)  # C and O the gather-GEMM kernel takes

launches: Dict[str, int] = {"rank_flags": 0, "gather_gemm": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "rank_flags": {"efg_rank_flags": [_I, _P, _I, _P, _L, _P, _P]},
    "gather_gemm": {"efg_gather_gemm": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
}
KERNEL_SOURCES = tuple(_SIGNATURES)  # csrc/<stem>.cu for each kernel


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build_kernels() -> Dict[str, dict]:
    """Compile both kernels in parallel (nvcc per source); returns the
    per-source build seconds and compiler logs of what was compiled."""
    return _build.build(KERNEL_SOURCES)


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no sparse kernel for device {t.device}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# kernel A: merge-join rank / flags
# ---------------------------------------------------------------------------


def rank_flags_plain(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the rank kernel: searchsorted for the count
    plus the three membership probes at pos−1, pos and pos+f0."""
    vk = keys.shape[0]
    kc = torch.clamp(keys, max=CLAMP_Q).contiguous()
    qc = torch.where(queries >= INVALID_Q, CLAMP_Q, queries).to(torch.int32)
    pos = torch.searchsorted(kc, qc, side="left", out_int32=True)

    def at(i):
        return kc[torch.clamp(i, 0, vk - 1).long()]

    fm = (pos > 0) & (at(pos - 1) == qc - 1)
    f0 = (pos < vk) & (at(pos) == qc)
    ip = pos + f0.to(torch.int32)
    fp = (ip < vk) & (at(ip) == qc + 1)
    return (pos * 8 + fm * 4 + f0 * 2 + fp.to(torch.int32)).to(torch.int32)


def _rank_flags_cuda(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    dev = keys.device
    _require(keys, "keys", torch.int32, 1, dev)
    _require(queries, "queries", torch.int32, 2, dev)
    out = torch.empty_like(queries)
    lib = _build.load("rank_flags", _SIGNATURES["rank_flags"])
    err = lib.efg_rank_flags(
        dev.index or 0, keys.data_ptr(), keys.shape[0], queries.data_ptr(),
        queries.numel(), out.data_ptr(), _stream(dev),
    )
    _build.check(lib, err, "rank_flags launch")
    launches["rank_flags"] += 1
    return out


def merge_rank_flags(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """keys [Vk] int32 sorted ascending (entries ≥ INVALID_Q = padding);
    queries [P, Vq] int32, non-decreasing per row (≥ INVALID_Q = padding).
    Returns packed [P, Vq] int32 = count(keys < q)·8 + (q−1∈keys)·4 +
    (q∈keys)·2 + (q+1∈keys). Flags at padding queries are garbage by
    contract — the caller masks them."""
    if _on_card(keys):
        return _rank_flags_cuda(keys.contiguous(), queries.to(torch.int32).contiguous())
    return rank_flags_plain(keys, queries)


# ---------------------------------------------------------------------------
# kernel B: fused gather-GEMM over the packed rulebook
# ---------------------------------------------------------------------------


def _taps(packed: torch.Tensor):
    """[(row, flag)] for the (δx = −1, 0, +1) taps of a packed rulebook."""
    pos = packed >> 3
    fm, f0, fp = (packed >> 2) & 1, (packed >> 1) & 1, packed & 1
    return ((pos - 1, fm), (pos, f0), (pos + f0, fp))


def gather_gemm_plain(features: torch.Tensor, packed: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather-GEMM: the same bf16-rounded
    inputs, products and sums in f32."""
    v_in, c = features.shape
    n_pairs, v_out = packed.shape
    f = features.to(torch.bfloat16).float()
    w = weights.to(torch.bfloat16).float().reshape(n_pairs, 3, c, -1)
    out = torch.zeros(v_out, w.shape[-1], dtype=torch.float32, device=features.device)
    for p in range(n_pairs):
        for t, (row, flag) in enumerate(_taps(packed[p])):
            on = (flag > 0) & (row >= 0) & (row < v_in)
            g = torch.where(on[:, None], f[torch.clamp(row, 0, v_in - 1).long()], 0.0)
            out += g @ w[p, t]
    return out


def _gather_gemm_cuda(features, packed, weights) -> torch.Tensor:
    dev = features.device
    v_in, c = features.shape
    n_pairs, v_out = packed.shape
    o = weights.shape[1]
    _require(features, "features", torch.bfloat16, 2, dev)
    _require(packed, "packed", torch.int32, 2, dev)
    _require(weights, "weights", torch.bfloat16, 2, dev)
    if c not in GEMM_CHANNELS or o not in GEMM_CHANNELS:
        raise ValueError(f"gather_gemm takes C, O in {GEMM_CHANNELS}; got C={c}, O={o}")
    if weights.shape[0] != n_pairs * 3 * c:
        raise ValueError(f"weights rows {weights.shape[0]} != P·3·C = {n_pairs * 3 * c}")
    out = torch.empty(v_out, o, dtype=torch.float32, device=dev)
    lib = _build.load("gather_gemm", _SIGNATURES["gather_gemm"])
    err = lib.efg_gather_gemm(
        dev.index or 0, features.data_ptr(), packed.data_ptr(), weights.data_ptr(),
        out.data_ptr(), v_in, v_out, n_pairs, c, o, _stream(dev),
    )
    _build.check(lib, err, "gather_gemm launch")
    launches["gather_gemm"] += 1
    return out


def fused_gather_gemm(features: torch.Tensor, packed: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """out [V_out, O] f32 = Σ_p Σ_t flag_t · f[row_t] @ W[p, t] over the
    packed rulebook [P, V_out]; features [V_in, C] and weights
    [P·3·C, O] (rows (pair, tap, channel)) are rounded to bf16.
    V_in == V_out for SubM convs; strided convs index input rows from the
    output sites."""
    if _on_card(features):
        return _gather_gemm_cuda(
            features.to(torch.bfloat16).contiguous(), packed.contiguous(),
            weights.to(torch.bfloat16).contiguous(),
        )
    return gather_gemm_plain(features, packed, weights)


# ---------------------------------------------------------------------------
# conv ops over the packed rulebook (forward)
# ---------------------------------------------------------------------------


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_channels(features, weights, cin):
    cin0 = weights.shape[1]
    if cin != cin0:
        features = torch.nn.functional.pad(features, (0, cin - cin0))
        weights = torch.nn.functional.pad(weights, (0, 0, 0, cin - cin0))
    return features, weights


def subm_conv9(features: torch.Tensor, packed: torch.Tensor, weights: torch.Tensor,
               out_valid: torch.Tensor) -> torch.Tensor:
    """SubM rule9 conv, out [V, O] f32. `weights` [K = 27, C, O] in (pair,
    δx) raster order; channels pad to a multiple of 16."""
    k3, cin0, cout = weights.shape
    features, weights = _pad_channels(features, weights, _rup(cin0, 16))
    out = fused_gather_gemm(features, packed, weights.reshape(-1, cout))
    return out * out_valid[:, None].to(torch.float32)


def strided_conv_packed(features: torch.Tensor, packed: torch.Tensor,
                        weights: torch.Tensor, out_valid: torch.Tensor, *,
                        kw3: int) -> torch.Tensor:
    """Strided-conv forward over the packed rulebook from
    `build_monotone_rule_strided`. weights [K, C, O] in (κz, κy, κx)
    raster; kw=1 kernels place their single tap in the middle (δx=0) block
    and zero the m/p blocks."""
    k, cin0, cout = weights.shape
    n_pairs = k // kw3
    cin = _rup(cin0, 16)
    features, weights = _pad_channels(features, weights, cin)
    if kw3 == 1:
        wtap = weights.new_zeros(n_pairs, 3, cin, cout)
        wtap[:, 1] = weights.reshape(n_pairs, cin, cout)
    else:
        wtap = weights.reshape(n_pairs, 3, cin, cout)
    out = fused_gather_gemm(features, packed, wtap.reshape(-1, cout))
    return out * out_valid[:, None].to(torch.float32)


# ---------------------------------------------------------------------------
# monotone rulebook builders (packed anchor format)
# ---------------------------------------------------------------------------


def _mask_flags(packed, okm, ok0, okp):
    """Clear the flags of taps that leave the grid (or come from padding
    rows); pos stays as the rank kernel produced it."""
    return (
        (packed & ~7)
        | (((packed >> 2) & 1) & okm.to(torch.int32)) * 4
        | (((packed >> 1) & 1) & ok0.to(torch.int32)) * 2
        | ((packed & 1) & okp.to(torch.int32))
    )


def _check_key_range(batch_size: int, spatial_shape) -> None:
    d, h, w = spatial_shape
    if batch_size * d * h * w >= INVALID_Q:
        raise ValueError(
            f"linear keys of a {batch_size}×{d}×{h}×{w} grid reach INVALID_Q = 2^29"
        )


def build_monotone_rule9(st, kernel_size=3) -> torch.Tensor:
    """SubM rulebook, packed anchor format: [P, V] int32, P = kd·kh, pos
    monotone in v per pair.

    Queries for pair (δz, δy) are `keys + Δ` (monotone), ranked against the
    sorted keys by the rank kernel; boundary masks (grid edges in z/y, x
    wrap) are applied to the flags afterwards. The (δz=0, δy=0) pair is
    analytic and needs no kernel call."""
    kd, kh, kw = (kernel_size,) * 3 if isinstance(kernel_size, int) else kernel_size
    if kw != 3:
        raise ValueError("rule9 requires a 3-wide x kernel")
    _check_key_range(st.batch_size, st.spatial_shape)
    d, h, w = st.spatial_shape
    x = st.coords[:, 3]

    # invalid rows → +inf tail; CLAMP_Q (not INVALID_Q) so that adding a
    # negative Δ keeps the query ≥ INVALID_Q (still treated as padding)
    key_base = torch.where(st.valid, st.keys, CLAMP_Q)
    queries, masks = [], []
    center = None
    for dz in range(-(kd - 1) // 2, (kd - 1) // 2 + 1):
        for dy in range(-(kh - 1) // 2, (kh - 1) // 2 + 1):
            delta = (dz * h + dy) * w
            nz = st.coords[:, 1] + dz
            ny = st.coords[:, 2] + dy
            ok0 = st.valid & (nz >= 0) & (nz < d) & (ny >= 0) & (ny < h)
            if delta == 0:
                center = len(queries)
            queries.append(key_base + delta)
            masks.append(ok0)
    if center is not None:
        # the (δz=0, δy=0) pair queries the keys themselves (distinct and
        # sorted): pos = iota, middle tap = self, x±1 taps = the adjacent
        # sorted key differs by exactly 1
        v = st.keys.shape[0]
        iota = torch.arange(v, dtype=torch.int32, device=st.keys.device)
        nine = key_base.new_full((1,), -9)
        km = torch.cat([nine, key_base[:-1]])
        kp = torch.cat([key_base[1:], nine])
        row_c = (
            iota * 8
            + (key_base - km == 1).to(torch.int32) * 4
            + st.valid.to(torch.int32) * 2
            + (kp - key_base == 1).to(torch.int32)
        )
        others = queries[:center] + queries[center + 1:]
        packed8 = merge_rank_flags(st.keys, torch.stack(others))
        packed = torch.cat([packed8[:center], row_c[None], packed8[center:]], dim=0)
    else:
        packed = merge_rank_flags(st.keys, torch.stack(queries))
    ok0 = torch.stack(masks)
    okm = ok0 & (x - 1 >= 0)[None]
    okp = ok0 & (x + 1 < w)[None]
    return _mask_flags(packed, okm, ok0, okp)


def build_monotone_rule_strided(st_in, ob, oz, oy, ox, out_valid, kernel_size,
                                stride, padding) -> torch.Tensor:
    """Packed anchor rulebook [kd·kh, V_out] for a strided (generative) conv.

    Queries `in = o·s − p + κ` are linear in the output's sorted (b, oz,
    oy, ox) order, hence monotone per pair; for kw=3 the three κx taps hit
    input keys (q−1, q, q+1) around the middle-tap query q. kw=1 emits
    middle-only flags and, since the kernel works on pairs in groups of 3,
    each κz pair is followed by two zero-flag dummies sharing its positions
    (the caller zero-pads the weights to match)."""
    kd, kh, kw3 = kernel_size
    sd, sh, sw = stride
    pd, ph, pw = padding
    if kw3 not in (1, 3):
        raise ValueError(f"strided rulebook needs kw in (1, 3), got {kw3}")
    _check_key_range(st_in.batch_size, st_in.spatial_shape)
    d, h, w = st_in.spatial_shape

    queries, mm, m0, mp = [], [], [], []
    for kz in range(kd):
        for ky in range(kh):
            iz = oz * sd - pd + kz
            iy = oy * sh - ph + ky
            ok_zy = out_valid & (iz >= 0) & (iz < d) & (iy >= 0) & (iy < h)
            ix_mid = ox * sw - pw + (1 if kw3 == 3 else 0)
            if kw3 == 3:
                okm = ok_zy & (ix_mid - 1 >= 0) & (ix_mid - 1 < w)
                okp = ok_zy & (ix_mid + 1 >= 0) & (ix_mid + 1 < w)
            else:
                okm = okp = torch.zeros_like(ok_zy)
            ok0 = ok_zy & (ix_mid >= 0) & (ix_mid < w)
            q0 = ((ob * d + iz) * h + iy) * w + ix_mid
            queries.append(torch.where(out_valid, q0, CLAMP_Q))
            mm.append(okm)
            m0.append(ok0)
            mp.append(okp)
    packed = merge_rank_flags(st_in.keys, torch.stack(queries))
    rows = list(_mask_flags(packed, torch.stack(mm), torch.stack(m0), torch.stack(mp)))
    if kh == 1:
        expanded = []
        for r in rows:
            dummy = (r >> 3) * 8
            expanded += [r, dummy, dummy]
        rows = expanded
    return torch.stack(rows)  # [P, V_out]
