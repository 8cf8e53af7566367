"""Model registry (``hourglass`` and ``pose_hrnet`` so far).

The hourglass returns one heatmap tensor per stack, HRNet a single
heatmap tensor; :func:`is_multi_output` tells callers which.
"""

from __future__ import annotations

from . import hourglass, pose_hrnet
from .common import param_count

_REGISTRY = {"hourglass": hourglass.get_pose_net,
             "pose_hrnet": pose_hrnet.get_pose_net}
_NOT_PORTED = {
    "pose_resnet": "ROADMAP.md queue A, item 9 (PoseResNet)",
}


def get_pose_net(cfg):
    name = cfg.MODEL.NAME
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"MODEL.NAME '{name}' is not ported yet: {_NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown MODEL.NAME '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)


def is_multi_output(model) -> bool:
    """True for models emitting per-stack heatmaps (stacked hourglass)."""
    return isinstance(model, hourglass.HourglassNet)


__all__ = ["get_pose_net", "is_multi_output", "param_count", "hourglass",
           "pose_hrnet"]
