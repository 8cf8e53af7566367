"""Model registry (``hourglass``, ``pose_hrnet``, ``pose_resnet`` and
``vit_pose``).

The hourglass returns one heatmap tensor per stack, HRNet, PoseResNet and
ViTPose a single heatmap tensor; :func:`is_multi_output` tells callers
which.  ViTPose's forward also takes the drop-path keep flags
(``models/vit_pose.py``).
"""

from __future__ import annotations

from . import hourglass, pose_hrnet, pose_resnet, vit_pose
from .common import param_count

_REGISTRY = {"hourglass": hourglass.get_pose_net,
             "pose_hrnet": pose_hrnet.get_pose_net,
             "pose_resnet": pose_resnet.get_pose_net,
             "vit_pose": vit_pose.get_pose_net}


def get_pose_net(cfg):
    name = cfg.MODEL.NAME
    if name not in _REGISTRY:
        raise KeyError(f"unknown MODEL.NAME '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)


def is_multi_output(model) -> bool:
    """True for models emitting per-stack heatmaps (stacked hourglass)."""
    return isinstance(model, hourglass.HourglassNet)


__all__ = ["get_pose_net", "is_multi_output", "param_count", "hourglass",
           "pose_hrnet", "pose_resnet", "vit_pose"]
