from efg_tpu_torch.modeling.registry import BACKBONES, HEADS, LAYERS, LOSSES, READERS


def _register_defaults():
    """Fill the registries with the built-in components under efg_tpu's
    names (`efg_tpu/modeling/__init__.py`), on first call: registering at
    the definition sites would import every backbone with the package."""
    from efg_tpu_torch.modeling.backbones.fpn import FPN
    from efg_tpu_torch.modeling.backbones.resnet import ResNet
    from efg_tpu_torch.modeling.backbones.rpn import RPN, RPNFixBNMom
    from efg_tpu_torch.modeling.backbones.sparse_net import SpMiddleResNetFHD
    from efg_tpu_torch.modeling.backbones.sparse_resnet import SparseResNet
    from efg_tpu_torch.modeling.backbones.swin import SwinTransformer
    from efg_tpu_torch.modeling.heads.center_head import CenterHead, SepHead
    from efg_tpu_torch.modeling.heads.multigroup_head import MultiGroupHead
    from efg_tpu_torch.modeling.losses import (
        giou_loss_2d,
        iou_loss_2d,
        rotated_giou_3d_loss,
        sigmoid_focal_loss,
        sigmoid_focal_loss_star,
        smooth_l1_loss,
    )
    from efg_tpu_torch.modeling.readers.voxel_reader import PillarFeatureNet, dynamic_mean_vfe

    for b in (SpMiddleResNetFHD, SparseResNet, RPN, RPNFixBNMom, ResNet, FPN, SwinTransformer):
        if b.__name__ not in BACKBONES:
            BACKBONES.register(b)
    for h in (CenterHead, SepHead, MultiGroupHead):
        if h.__name__ not in HEADS:
            HEADS.register(h)
    for fn in (sigmoid_focal_loss, sigmoid_focal_loss_star, smooth_l1_loss, iou_loss_2d,
               giou_loss_2d, rotated_giou_3d_loss):
        if fn.__name__ not in LOSSES:
            LOSSES.register(fn)
    if "PillarFeatureNet" not in READERS:
        READERS.register(PillarFeatureNet)
        READERS.register(dynamic_mean_vfe, name="DynamicMeanVFE")


__all__ = ["BACKBONES", "READERS", "HEADS", "LOSSES", "LAYERS", "_register_defaults"]
