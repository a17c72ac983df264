"""CenterNet gaussian heatmap rendering (port of `efg_tpu/ops/gaussian.py`).

Every GT center splats a (2r+1)² gaussian window onto the heatmap through
one scatter-max, batched over samples.
"""

from __future__ import annotations

import torch


def gaussian_radius(length: torch.Tensor, width: torch.Tensor, min_overlap: float) -> torch.Tensor:
    """Per-object CenterNet radius, elementwise (efg_tpu `gaussian_radius_jnp`)."""
    h, w = length, width
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1**2 - 4 * c1, min=0.0))) / 2

    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2**2 - 4 * 4.0 * c2, min=0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3**2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def splat_gaussians(centers_int: torch.Tensor, radii: torch.Tensor, cats: torch.Tensor,
                    mask: torch.Tensor, *, shape, r_cap: int = 12) -> torch.Tensor:
    """Max-combined gaussians on a heatmap per sample.

    centers_int [B, G, 2] int (x, y) in feature-map pixels, radii [B, G]
    int, cats [B, G] class channel, mask [B, G] valid; shape = (H, W, C).
    Returns [B, H, W, C] f32. Radii clip to `r_cap`; value =
    exp(−(dx² + dy²) / (2σ²)), σ = (2r + 1)/6, window |dx|, |dy| ≤ r."""
    h, w, c = shape
    bsz = radii.shape[0]
    dev = radii.device
    r = torch.clamp(radii, 0, r_cap)[..., None, None]  # [B, G, 1, 1]
    d = torch.arange(-r_cap, r_cap + 1, dtype=torch.int32, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")  # [win, win]

    sigma = (2 * r + 1).to(torch.float32) / 6.0
    val = torch.exp((-(dx**2 + dy**2)).to(torch.float32) / (2.0 * sigma**2))  # [B, G, win, win]
    inside = (dx.abs() <= r) & (dy.abs() <= r)
    px = centers_int[..., 0, None, None] + dx
    py = centers_int[..., 1, None, None] + dy
    ok = inside & mask[..., None, None] & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    b = torch.arange(bsz, device=dev)[:, None, None, None]
    cells = bsz * h * w * c
    flat = torch.where(ok, ((b * h + py) * w + px) * c + cats[..., None, None], cells)
    hm = torch.zeros(cells + 1, dtype=torch.float32, device=dev)
    hm.scatter_reduce_(0, flat.reshape(-1).long(), torch.where(ok, val, 0.0).reshape(-1), "amax")
    return hm[:cells].reshape(bsz, h, w, c)
