"""`jax.image.resize` in PyTorch (the resizes of Mask2Former and Swin).

efg_tpu resizes with `jax.image.resize`, whose arithmetic differs from
`F.interpolate`'s defaults in three ways that matter here:

- `bilinear` (and `cubic`) downsampling is antialiased: the kernel is
  widened by the factor, so every output cell averages a triangle of
  input cells (the masked attention shrinks 1/4-scale mask logits to
  1/8, 1/16 and 1/32);
- `cubic` is Keys' kernel with a = −0.5, where torch's `bicubic` uses
  a = −0.75 (Swin's absolute position embedding);
- `nearest` takes input cell ⌊(i + ½)·in/out⌋ (half-pixel centres).

Each resized axis is one contraction with JAX's weight matrix
(`compute_weight_mat`: sample positions (j + ½)·in/out − ½, the kernel
of |position − input cell| / max(in/out, 1), columns normalised to sum
1, zero where the position falls outside the input), built in f32 as
JAX builds it and kept per (sizes, method, device, dtype). `nearest` is
a gather along the axis.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_CACHE: Dict[Tuple, torch.Tensor] = {}


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _fma(a, b, c) -> np.ndarray:
    """a·b + c rounded once to f32 (the product of two f32 is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = −0.5, as JAX writes it and as
    XLA's CPU compiler evaluates it under jit: each Horner step one fused
    multiply-add."""
    f = np.float32
    near = _fma(_fma(f(1.5), x, -2.5) * x, x, 1.0)
    far = _fma(_fma(_fma(f(-0.5), x, 2.5), x, -4.0), x, 2.0)
    out = np.where(x >= f(1.0), far, near)
    return np.where(x >= f(2.0), f(0.0), out).astype(np.float32)


_KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """JAX's antialiased `compute_weight_mat` for a resize of one axis
    from `in_size` to `out_size` cells: [in_size, out_size] f32."""
    kernel = _KERNELS[method]
    f = np.float32
    inv_scale = f(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f(1.0))
    sample_f = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.0) * inv_scale - f(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f)[:, None]) / kernel_scale
    w = kernel(x.astype(f)).astype(f)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0)).astype(f)
    inside = (sample_f >= f(-0.5)) & (sample_f <= f(in_size) - f(0.5))
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """JAX's nearest source cell of each output cell: ⌊(i + ½)·in/out⌋ in f32."""
    f = np.float32
    return np.floor((np.arange(out_size, dtype=f) + f(0.5)) * f(in_size) / f(out_size)).astype(np.int64)


def _cached(key, make, device, dtype=None) -> torch.Tensor:
    key = key + (str(device), dtype)
    t = _CACHE.get(key)
    if t is None:
        t = torch.from_numpy(make()).to(device=device, dtype=dtype)
        _CACHE[key] = t
    return t


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """`jax.image.resize(x, shape, method)` (antialiased, as every efg_tpu
    call leaves it): every axis whose size differs from `shape` is resized
    (methods `nearest`, `bilinear`, `cubic`); floating inputs only, except
    for `nearest`."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"resize: shape {shape} has not the rank of {tuple(x.shape)}")
    if method != "nearest" and method not in _KERNELS:
        raise ValueError(f"resize: method {method!r} is not ported")
    for d in range(x.ndim):
        n_in, n_out = x.shape[d], shape[d]
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = _cached(("nearest", n_in, n_out), lambda: nearest_indices(n_in, n_out), x.device)
            x = torch.index_select(x, d, idx)
            continue
        w = _cached((method, n_in, n_out), lambda: weight_matrix(n_in, n_out, method),
                    x.device, x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
