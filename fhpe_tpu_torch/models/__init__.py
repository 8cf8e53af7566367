"""Model registry (``hourglass`` only so far)."""

from __future__ import annotations

from . import hourglass
from .common import param_count

_REGISTRY = {"hourglass": hourglass.get_pose_net}
_NOT_PORTED = {
    "pose_hrnet": "ROADMAP.md queue A, item 9 (HRNet / PoseResNet)",
    "pose_resnet": "ROADMAP.md queue A, item 9 (HRNet / PoseResNet)",
}


def get_pose_net(cfg):
    name = cfg.MODEL.NAME
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"MODEL.NAME '{name}' is not ported yet: {_NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown MODEL.NAME '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)


__all__ = ["get_pose_net", "param_count", "hourglass"]
