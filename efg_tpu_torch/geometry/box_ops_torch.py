"""Device-side box geometry (port of `efg_tpu/geometry/box_ops_jnp.py`).

Box convention: ``[x, y, z, dx, dy, dz, (vx, vy,) yaw]``, yaw CCW about +z.
"""

from __future__ import annotations

import torch


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7+] boxes → [..., 4, 2] BEV corners (CCW)."""
    template = torch.tensor(
        [[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=boxes.dtype, device=boxes.device
    ) / 2.0
    local = boxes[..., None, 3:5] * template
    yaw = boxes[..., -1]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = local[..., 0] * c[..., None] - local[..., 1] * s[..., None]
    y = local[..., 0] * s[..., None] + local[..., 1] * c[..., None]
    return torch.stack([x, y], dim=-1) + boxes[..., None, :2]
