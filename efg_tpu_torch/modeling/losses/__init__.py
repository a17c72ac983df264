from efg_tpu_torch.modeling.losses.common import (
    giou_loss_2d,
    iou_loss_2d,
    rotated_giou_3d_loss,
    sigmoid_focal_loss,
    sigmoid_focal_loss_star,
    smooth_l1_loss,
)

__all__ = ["sigmoid_focal_loss", "sigmoid_focal_loss_star", "smooth_l1_loss", "iou_loss_2d",
           "giou_loss_2d", "rotated_giou_3d_loss"]
