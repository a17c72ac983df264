"""Hopper kernels for the sparse conv (port of
`efg_tpu/ops/pallas/sparse_kernels.py`).

Three hand-written CUDA C++ kernels carry the sparse trunk, forward and
backward:

- `merge_rank_flags` → `csrc/rank_flags.cu` (replaces `_rank_kernel_seq`):
  ranks P monotone query rows against one sorted key array; every SubM and
  strided rulebook, and the strided convs' inverse rulebooks, are built
  from it.
- `fused_gather_gemm` → `csrc/gather_gemm.cu` (replaces `_fwd_kernel`): the
  packed-rulebook gather + GEMM that runs every sparse conv's forward;
  `gather_gemm_stacked` is its `emit_stacked` variant, which also returns
  the gathered taps, and runs every backward's d_features pass.
- `fused_gather_dw` → `csrc/gather_dw.cu` (replaces `_dw_kernel`): dW by
  re-gathering the inputs, where the stacked taps do not apply.

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

# Input rounding of the plain versions: bf16, as the kernels take. f32 only
# for oracle comparisons against efg_tpu's f32 XLA path
# (`efg_tpu.ops.sparse.set_compute_dtype`); the kernels refuse it.
COMPUTE_DTYPE = torch.bfloat16

launches: Dict[str, int] = {
    "rank_flags": 0, "gather_gemm": 0, "gather_gemm_stacked": 0, "gather_dw": 0,
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # csrc/<stem>.cu → its C entries
    "rank_flags": {"efg_rank_flags": [_I, _P, _I, _P, _L, _P, _P]},
    "gather_gemm": {
        "efg_gather_gemm": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "efg_gather_gemm_stacked": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "gather_dw": {"efg_gather_dw": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
}
KERNEL_SOURCES = tuple(_SIGNATURES)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build_kernels() -> Dict[str, dict]:
    """Compile every kernel source in parallel (nvcc per source); returns the
    per-source build seconds and compiler logs of what was compiled."""
    return _build.build(KERNEL_SOURCES)


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        if COMPUTE_DTYPE != torch.bfloat16:
            raise ValueError(f"the sparse kernels compute in bf16, not {COMPUTE_DTYPE}")
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
# kernel B: fused gather-GEMM over the packed rulebook (and its stacked variant)
# ---------------------------------------------------------------------------


def _taps(packed: torch.Tensor):
    """[(row, flag)] for the (δx = −1, 0, +1) taps of a packed rulebook."""
    pos = packed >> 3
    fm, f0, fp = (packed >> 2) & 1, (packed >> 1) & 1, packed & 1
    return ((pos - 1, fm), (pos, f0), (pos + f0, fp))


def _tap_rows(f: torch.Tensor, row: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """f[row] where the flag is set and the row lies in [0, V_in), else 0."""
    v_in = f.shape[0]
    on = (flag > 0) & (row >= 0) & (row < v_in)
    return torch.where(on[:, None], f[torch.clamp(row, 0, v_in - 1).long()], 0)


def gather_gemm_plain(features: torch.Tensor, packed: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather-GEMM: the same inputs rounded to
    COMPUTE_DTYPE (bf16, as the kernel), products and sums in f32."""
    c = features.shape[1]
    n_pairs, v_out = packed.shape
    f = features.to(COMPUTE_DTYPE).float()
    w = weights.to(COMPUTE_DTYPE).float().reshape(n_pairs, 3, c, -1)
    out = torch.zeros(v_out, w.shape[-1], dtype=torch.float32, device=features.device)
    for p in range(n_pairs):
        for t, (row, flag) in enumerate(_taps(packed[p])):
            out += _tap_rows(f, row, flag) @ w[p, t]
    return out


def gather_gemm_stacked_plain(features: torch.Tensor, packed: torch.Tensor,
                              weights: torch.Tensor):
    """Plain PyTorch version of the stacked variant: (out [V_out, O] f32,
    stacked [V_out, P·3·C] bf16), the taps of every (pair, tap) side by
    side and `out` = stacked @ weights in f32."""
    f = features.to(COMPUTE_DTYPE)
    stacked = torch.cat(
        [_tap_rows(f, row, flag) for p in range(packed.shape[0]) for row, flag in _taps(packed[p])],
        dim=1,
    )
    return stacked.float() @ weights.to(COMPUTE_DTYPE).float(), stacked


def _width(n: int) -> int:
    """The kernel channel width (one of GEMM_CHANNELS) that holds n."""
    for w in GEMM_CHANNELS:
        if n <= w:
            return w
    raise ValueError(f"the sparse kernels take at most {GEMM_CHANNELS[-1]} channels, got {n}")


def _pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])) if t.shape[-1] != width else t


def _gather_gemm_cuda(features, packed, weights, emit: bool):
    dev = features.device
    v_in, c = features.shape
    n_pairs, v_out = packed.shape
    o = weights.shape[1]
    if weights.shape[0] != n_pairs * 3 * c:
        raise ValueError(f"weights rows {weights.shape[0]} != P·3·C = {n_pairs * 3 * c}")
    # other widths run zero-padded to the kernel's: zero channels add nothing
    cw, ow = _width(c), _width(o)
    f = _pad_cols(features.to(torch.bfloat16), cw).contiguous()
    w = weights.to(torch.bfloat16).reshape(n_pairs * 3, c, o)
    w = _pad_cols(torch.nn.functional.pad(w, (0, 0, 0, cw - c)), ow).reshape(-1, ow).contiguous()
    packed = packed.to(torch.int32).contiguous()
    _require(f, "features", torch.bfloat16, 2, dev)
    _require(packed, "packed", torch.int32, 2, dev)
    _require(w, "weights", torch.bfloat16, 2, dev)
    out = torch.empty(v_out, ow, dtype=torch.float32, device=dev)
    lib = _build.load("gather_gemm", _SIGNATURES["gather_gemm"])
    if emit:
        stacked = torch.empty(v_out, n_pairs * 3 * cw, dtype=torch.bfloat16, device=dev)
        err = lib.efg_gather_gemm_stacked(
            dev.index or 0, f.data_ptr(), packed.data_ptr(), w.data_ptr(), out.data_ptr(),
            stacked.data_ptr(), v_in, v_out, n_pairs, cw, ow, _stream(dev),
        )
        _build.check(lib, err, "gather_gemm_stacked launch")
        launches["gather_gemm_stacked"] += 1
        if cw != c:
            stacked = stacked.view(v_out, n_pairs * 3, cw)[..., :c].reshape(v_out, -1)
        return out[:, :o], stacked
    err = lib.efg_gather_gemm(
        dev.index or 0, f.data_ptr(), packed.data_ptr(), w.data_ptr(),
        out.data_ptr(), v_in, v_out, n_pairs, cw, ow, _stream(dev),
    )
    _build.check(lib, err, "gather_gemm launch")
    launches["gather_gemm"] += 1
    return out[:, :o]


def fused_gather_gemm(features: torch.Tensor, packed: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """out [V_out, O] f32 = Σ_p Σ_t flag_t · f[row_t] @ W[p, t] over the
    packed rulebook [P, V_out]; features [V_in, C] and weights
    [P·3·C, O] (rows (pair, tap, channel)) are rounded to bf16.
    V_in == V_out for SubM convs; strided convs index input rows from the
    output sites. C, O ≤ 128."""
    if _on_card(features):
        return _gather_gemm_cuda(features, packed, weights, emit=False)
    return gather_gemm_plain(features, packed, weights)


def gather_gemm_stacked(features: torch.Tensor, packed: torch.Tensor,
                        weights: torch.Tensor):
    """`fused_gather_gemm` that also returns the gathered taps (the JAX
    `emit_stacked=True`): (out [V_out, O] f32, stacked [V_out, P·3·C]
    bf16) with stacked[v, (p·3 + t)·C + c] = flag_t · f[row_t(v), c].
    The layout is the transpose of efg_tpu's [P·3·C, vt] buffer, without
    its tile padding."""
    if _on_card(features):
        return _gather_gemm_cuda(features, packed, weights, emit=True)
    return gather_gemm_stacked_plain(features, packed, weights)


def stacked_weight_grad(stacked: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """stackedᵀ @ features [P·3·C_s, C_f] f32: the one dense product that
    turns a stacked tap buffer into dW (efg_tpu's `dot_general` after
    `emit_stacked`). bf16 operands are taken to f32 first, so the products
    are exact and the sums f32 (TF32 off), as `preferred_element_type=f32`."""
    return torch.matmul(stacked.t().float(), features.to(COMPUTE_DTYPE).float())


# ---------------------------------------------------------------------------
# kernel C: dW by re-gathering the inputs
# ---------------------------------------------------------------------------


def gather_dw_plain(features: torch.Tensor, packed: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dW kernel: dW [P·3·C, O] f32, the bf16
    taps of every (pair, tap) contracted with the bf16 gradient, sums f32."""
    f = features.to(COMPUTE_DTYPE).float()
    gb = g.to(COMPUTE_DTYPE).float()
    return torch.cat(
        [_tap_rows(f, row, flag).t() @ gb
         for p in range(packed.shape[0]) for row, flag in _taps(packed[p])],
        dim=0,
    )


def _gather_dw_cuda(features, packed, g) -> torch.Tensor:
    dev = features.device
    v_in, c = features.shape
    n_pairs, v_out = packed.shape
    o = g.shape[1]
    if g.shape[0] != v_out:
        raise ValueError(f"g rows {g.shape[0]} != rulebook width {v_out}")
    cw, ow = _width(c), _width(o)
    f = _pad_cols(features.to(torch.bfloat16), cw).contiguous()
    gb = _pad_cols(g.to(torch.bfloat16), ow).contiguous()
    packed = packed.to(torch.int32).contiguous()
    _require(f, "features", torch.bfloat16, 2, dev)
    _require(packed, "packed", torch.int32, 2, dev)
    _require(gb, "g", torch.bfloat16, 2, dev)
    dw = torch.zeros(n_pairs * 3 * cw, ow, dtype=torch.float32, device=dev)
    lib = _build.load("gather_dw", _SIGNATURES["gather_dw"])
    err = lib.efg_gather_dw(
        dev.index or 0, f.data_ptr(), packed.data_ptr(), gb.data_ptr(), dw.data_ptr(),
        v_in, v_out, n_pairs, cw, ow, _stream(dev),
    )
    _build.check(lib, err, "gather_dw launch")
    launches["gather_dw"] += 1
    return dw.view(n_pairs * 3, cw, ow)[:, :c, :o].reshape(-1, o)


def fused_gather_dw(features: torch.Tensor, packed: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """dW [P·3·C, O] f32 of the packed contraction (rows (pair, tap, c)):
    Σ_v flag_t · f[row_t(v)]ᵀ g[v], with features [V_in, C] and the
    upstream gradient g [V_out, O] (pre-masked by out_valid) rounded to
    bf16. On the card the sum over V is reduced with f32 atomics, in no
    fixed order: compare at f32-accumulation tolerance (~1e-5 of max|dW|),
    never bit for bit."""
    if _on_card(features):
        return _gather_dw_cuda(features, packed, g)
    return gather_dw_plain(features, packed, g)


# ---------------------------------------------------------------------------
# conv ops over the packed rulebook, with their backward
# ---------------------------------------------------------------------------


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_channels(features, weights, cin):
    cin0 = weights.shape[1]
    if cin != cin0:
        features = torch.nn.functional.pad(features, (0, cin - cin0))
        weights = torch.nn.functional.pad(weights, (0, 0, 0, cin - cin0))
    return features, weights


def subm_conv9_backward(features, weights, packed, out_valid, g):
    """(d_features, dW) of `subm_conv9` (efg_tpu `subm_conv9`'s bwd).

    d_features is another gather-GEMM over the same rulebook with the
    27-raster reversal of the weights (pairs and taps flipped jointly,
    C and O swapped). With cout % 16 == 0 that gather also emits its taps
    stacked_g[u, κ·O + o] = flag_κ(u)·ĝ[r_κ(u), o], and dW is one dense
    product: dW[κ] = (stacked_gᵀ f)[flip(κ)]ᵀ. Otherwise dW comes from the
    dW kernel. Padding rows of f are zero, so flags there cancel."""
    k3, cin, cout = weights.shape
    g = g * out_valid[:, None].to(g.dtype)
    w_flip = weights.flip(0).transpose(1, 2).reshape(k3 * cout, cin)
    if cout % 16 == 0:
        d_feats, stacked = gather_gemm_stacked(g, packed, w_flip)
        dw = stacked_weight_grad(stacked, features).reshape(k3, cout, cin)
        dw = dw.flip(0).transpose(1, 2)
    else:
        d_feats = fused_gather_gemm(g, packed, w_flip)
        dw = fused_gather_dw(features, packed, g).reshape(k3, cin, cout)
    return d_feats.to(features.dtype), dw.to(weights.dtype)


class _SubMConv9(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, weights, packed, out_valid):
        k3, cin, cout = weights.shape
        ctx.save_for_backward(features, weights, packed, out_valid)
        out = fused_gather_gemm(features, packed, weights.reshape(k3 * cin, cout))
        return out * out_valid[:, None].to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        d_feats, dw = subm_conv9_backward(*ctx.saved_tensors, g)
        return d_feats, dw, None, None


def subm_conv9(features: torch.Tensor, packed: torch.Tensor, weights: torch.Tensor,
               out_valid: torch.Tensor) -> torch.Tensor:
    """SubM rule9 conv, out [V, O] f32, differentiable in features and
    weights. `weights` [K = 27, C, O] in (pair, δx) raster order; channels
    pad to a multiple of 16 (the padded rows get no gradient)."""
    cin0 = weights.shape[1]
    features, weights = _pad_channels(features, weights, _rup(cin0, 16))
    return _SubMConv9.apply(features, weights, packed, out_valid)


def _strided_d_feats(w2d, g, inv, n_pairs: int, kw3: int, features=None):
    """d_features of a strided conv as a gather-GEMM over its inverse
    rulebook: the gather source is the output-row gradient, the weights are
    the transposed κ blocks that `wmap` routes to each (pseudo-pair, tap).
    With `features`, the gather also emits its taps and dW comes back as one
    dense product routed by `wmap` (no raster flip: the inverse rulebook
    already encodes v = out_κ(u)); returns (d_features, dW [P·3·C, O])."""
    packed_inv, wmap = inv
    cin, cout = w2d.shape[0] // (n_pairs * 3), w2d.shape[1]
    # w2d rows are ((κz·kh + κy), κx-tap, c); flat κ = pair·kw3 + κx
    wk = w2d.reshape(n_pairs, 3, cin, cout)
    if kw3 == 1:
        wk = wk[:, 1:2]  # the single real tap
    wk = wk.reshape(n_pairs * kw3, cin, cout)
    zero = w2d.new_zeros(cout, cin)
    w_inv = torch.stack(
        [wk[ki].t() if ki >= 0 else zero for taps in wmap for ki in taps]
    ).reshape(len(wmap) * 3 * cout, cin)
    if features is None:
        return fused_gather_gemm(g, packed_inv, w_inv)
    d_feats, stacked = gather_gemm_stacked(g, packed_inv, w_inv)
    g2 = stacked_weight_grad(stacked, features).reshape(len(wmap), 3, cout, cin)
    dwk = g2.new_zeros(n_pairs * kw3, cin, cout)
    for pp, taps in enumerate(wmap):
        for t, ki in enumerate(taps):
            if ki >= 0:
                dwk[ki] += g2[pp, t].t()
    if kw3 == 1:  # zero m/p tap blocks around the real one
        dw = torch.nn.functional.pad(dwk.reshape(n_pairs, 1, cin, cout), (0, 0, 0, 0, 1, 1))
    else:
        dw = dwk.reshape(n_pairs, 3, cin, cout)
    return d_feats, dw.reshape(n_pairs * 3 * cin, cout)


def strided_conv_backward(features, w2d, packed, out_valid, inv, kw3: int, g):
    """(d_features, dW [P·3·C, O]) of `strided_conv_packed` (efg_tpu
    `strided_conv_packed`'s bwd): d_features over the inverse rulebook; dW
    from its stacked taps when cout % 16 == 0, else from the dW kernel over
    the forward rulebook. efg_tpu's `_d_feats_xla`, taken only without an
    inverse rulebook, has no counterpart: the port always builds one for a
    conv that needs a gradient."""
    cin, cout = features.shape[1], w2d.shape[1]
    n_pairs = w2d.shape[0] // (3 * cin)
    g = g * out_valid[:, None].to(g.dtype)
    if cout % 16 == 0:
        d_feats, dw = _strided_d_feats(w2d, g, inv, n_pairs, kw3, features)
    else:
        d_feats = _strided_d_feats(w2d, g, inv, n_pairs, kw3)
        dw = fused_gather_dw(features, packed, g)
    return d_feats.to(features.dtype), dw.to(w2d.dtype)


class _StridedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, w2d, packed, out_valid, packed_inv, wmap, kw3):
        ctx.save_for_backward(features, w2d, packed, out_valid, packed_inv)
        ctx.wmap, ctx.kw3 = wmap, kw3
        out = fused_gather_gemm(features, packed, w2d)
        return out * out_valid[:, None].to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        features, w2d, packed, out_valid, packed_inv = ctx.saved_tensors
        if packed_inv is None:
            raise RuntimeError(
                "strided conv backward needs the inverse rulebook: pass "
                "inv=build_monotone_rule_strided_inverse(...)"
            )
        d_feats, dw = strided_conv_backward(
            features, w2d, packed, out_valid, (packed_inv, ctx.wmap), ctx.kw3, g
        )
        return d_feats, dw, None, None, None, None, None


def strided_conv_packed(features: torch.Tensor, packed: torch.Tensor,
                        weights: torch.Tensor, out_valid: torch.Tensor, *,
                        kw3: int, inv=None) -> torch.Tensor:
    """Strided-conv forward over the packed rulebook from
    `build_monotone_rule_strided`, differentiable in features and weights
    when `inv` = (packed_inv, wmap) from `build_monotone_rule_strided_inverse`
    is given. weights [K, C, O] in (κz, κy, κx) raster; kw=1 kernels place
    their single tap in the middle (δx=0) block and zero the m/p blocks."""
    k, cin0, cout = weights.shape
    n_pairs = k // kw3
    cin = _rup(cin0, 16)
    features, weights = _pad_channels(features, weights, cin)
    if kw3 == 1:
        wtap = weights.new_zeros(n_pairs, 3, cin, cout)
        wtap[:, 1] = weights.reshape(n_pairs, cin, cout)
    else:
        wtap = weights.reshape(n_pairs, 3, cin, cout)
    packed_inv, wmap = inv if inv is not None else (None, None)
    return _StridedConv.apply(features, wtap.reshape(-1, cout), packed, out_valid,
                              packed_inv, wmap, kw3)


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


def build_monotone_rule_strided_inverse(st_in, out_keys, out_spatial, kernel_size,
                                        stride, padding):
    """Inverse packed rulebook of a strided conv, for its d_features: for
    each INPUT row, which OUTPUT rows consume it and through which kernel
    offset. Returns (packed_inv [P₂, V_in], wmap), wmap[pp] giving the flat
    κ = (κz·kh + κy)·kw + κx that feeds each of the pseudo-pair's 3 tap
    slots (−1 = zero weight).

    Under x-stride 2 an input row feeds ≤ 2 outputs whose κx depends on the
    x parity, so each (κz, κy) splits into parity pseudo-pairs:
      · sw=2, kw=3: A (x+pw even): taps (·, κx=2, κx=0) at output keys
        (q, q+1); B (x+pw odd): tap (·, κx=1, ·). One ranked query row
        serves both (the merged query is monotone); flags split after.
      · sw=1, kw=3: one pair, taps (κx=2, κx=1, κx=0) at (q−1, q, q+1).
      · kw=1: one pair, middle tap only.
    A query row is monotone only over the rows whose (z, y) parities match
    the pair, so the other rows are backfilled with a running max; all
    pairs are ranked by one rank-kernel call. (k, 1, 1) kernels give each
    κz its own group of 3 (real pair + two zero-flag dummies, the weights'
    κz at slot 3·κz), and pairs pad with empty rows to a multiple of 3."""
    kd, kh, kw3 = kernel_size
    sd, sh, sw = stride
    pd, ph, pw = padding
    if kw3 not in (1, 3) or sw not in (1, 2):
        raise ValueError(f"inverse rulebook needs kw in (1, 3) and x-stride in (1, 2), "
                         f"got kw={kw3}, stride={stride}")
    od, oh, ow = out_spatial
    v_out = out_keys.shape[0]
    if st_in.batch_size * od * oh * ow >= 2**31:
        raise ValueError("output linear key overflows int32")
    b, z, y, x = st_in.coords.unbind(1)
    int_min = torch.iinfo(torch.int32).min

    queries, mm, m0, mp = [], [], [], []

    def lookup3(q, okm, ok0, okp):
        ok_any = okm | ok0 | okp
        qv = torch.clamp(torch.cummax(torch.where(ok_any, q, int_min), 0).values, min=0)
        queries.append(torch.where(st_in.valid, qv, CLAMP_Q))
        mm.append(okm)
        m0.append(ok0)
        mp.append(okp)

    splits, wmap = [], []  # per query row: its pseudo-pairs' (tap-0 mask, mask of f0)
    none = torch.zeros_like(st_in.valid)
    for kz in range(kd):
        for ky in range(kh):
            ozn = z + pd - kz
            oyn = y + ph - ky
            oz = ozn // sd
            oy = oyn // sh
            okzy = (st_in.valid & (ozn % sd == 0) & (oz >= 0) & (oz < od)
                    & (oyn % sh == 0) & (oy >= 0) & (oy < oh))
            kflat = (kz * kh + ky) * kw3
            base = ((b * od + oz) * oh + oy) * ow
            if kw3 == 3 and sw == 2:
                par_even = (x + pw) % 2 == 0
                oxa = (x + pw) // 2 - 1  # A: κx=2 output; κx=0 at oxa+1
                oxb = (x + pw - 1) // 2  # B: κx=1 output
                oxm = torch.where(par_even, oxa, oxb)
                ok_a, ok_b = okzy & par_even, okzy & ~par_even
                lookup3(base + oxm, none, okzy & (oxm >= 0) & (oxm < ow),
                        ok_a & (oxm + 1 >= 0) & (oxm + 1 < ow))
                splits.append((ok_a, ok_b))
                wmap += [(-1, kflat + 2, kflat + 0), (-1, kflat + 1, -1)]
            elif kw3 == 3:
                oxm = x + pw - 1  # κx=1 output; κx=2 at oxm−1, κx=0 at oxm+1
                lookup3(base + oxm, okzy & (oxm - 1 >= 0) & (oxm - 1 < ow),
                        okzy & (oxm >= 0) & (oxm < ow), okzy & (oxm + 1 >= 0) & (oxm + 1 < ow))
                splits.append(None)
                wmap.append((kflat + 2, kflat + 1, kflat + 0))
            else:
                oxn = x + pw
                ox = oxn // sw
                ok = okzy & (oxn % sw == 0) & (ox >= 0) & (ox < ow)
                lookup3(base + ox, none, ok, none)
                splits.append(None)
                wmap.append((-1, kflat, -1))

    ranked = _mask_flags(merge_rank_flags(out_keys, torch.stack(queries)),
                         torch.stack(mm), torch.stack(m0), torch.stack(mp))
    rows = []
    for pk, split in zip(ranked, splits):
        if split is None:
            rows.append(pk)
            continue
        ok_a, ok_b = (s.to(torch.int32) for s in split)
        pos8, f0, fp = (pk >> 3) * 8, (pk >> 1) & 1, pk & 1
        rows += [pos8 + (f0 & ok_a) * 2 + fp, pos8 + (f0 & ok_b) * 2]
    if kh == 1 and kd > 1:
        rows = [r2 for r in rows for r2 in (r, (r >> 3) * 8, (r >> 3) * 8)]
        wmap = [m2 for m in wmap
                for m2 in (tuple(3 * k if k >= 0 else -1 for k in m), (-1, -1, -1), (-1, -1, -1))]
    while len(rows) % 3:  # efg_tpu's layout (its kernel's group of 3); empty rows add 0
        rows.append(torch.full_like(rows[0], v_out * 8))
        wmap.append((-1, -1, -1))
    return torch.stack(rows), tuple(wmap)
