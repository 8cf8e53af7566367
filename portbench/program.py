"""The program under test, as the benchmark builds it: the port's
configuration from a configuration file's groups, and the port's networks
holding the weights the benchmark made."""

from __future__ import annotations

import copy
import os
import tempfile

import torch
import yaml


def merged(base: dict, over: dict) -> dict:
    """``over``'s groups laid over a copy of ``base`` (as the FPD CLI lays
    the teacher's file over the student's configuration)."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else copy.deepcopy(v)
    return out


def port_cfg(groups: dict):
    """``fhpe_tpu_torch.config.load_config`` of ``groups`` (the port's
    defaults under them), through a YAML file in the run's temporary
    directory."""
    from fhpe_tpu_torch.config import load_config
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cfg.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(groups, f)
        return load_config(path)


def port_model(cfg, state_dict: dict, device):
    """The port's network of ``cfg`` on ``device`` with ``state_dict``."""
    from fhpe_tpu_torch.models import get_pose_net
    with torch.device("meta"):
        model = get_pose_net(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict)
    return model


def on_host(state_dict: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}


def release(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
