"""Train state, optimizer, and learning-rate schedule.

Counterpart of ``fhpe_tpu/train/state.py`` (optax) with ``torch.optim``:

* adam: betas 0.9/0.999, eps 1e-8, no weight decay (reference
  ``lib/utils/utils.py:59-75``);
* sgd: momentum, nesterov, L2 weight decay added to the gradient before
  the momentum update, dampening 0: optax's ``add_decayed_weights`` +
  ``sgd``, which is torch's SGD.

The learning rate is set per epoch from :func:`lr_for_epoch` with
:func:`set_lr`, not by a stock scheduler.  On a CUDA device Adam is
``capturable`` (its step count and bias correction on the device, in
float32) with its rate a 0-d float32 tensor on the device, so that a
captured train step (``utils/graph.py``) reads the rate :func:`set_lr`
writes in place.  SGD takes its rate as a host float, which a captured
step bakes in; the step captures again when the rate changes.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..models import get_pose_net
from ..parallel import resolve_num_devices
from ..utils.dtype import compute_dtype


@dataclass
class TrainState:
    """The student being trained, its optimizer, and the optimizer steps
    taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def lr_for_epoch(cfg, epoch: int) -> float:
    """LR * LR_FACTOR ** (#LR_STEP milestones <= epoch + 1).

    The ``+ 1`` is the reference's effective (historically accidental)
    schedule: MultiStepLR's constructor performs an initial ``step()`` and
    ``tools/train.py:209-210`` steps again at the top of EVERY epoch
    including the first, so by the time epoch ``e`` trains the scheduler's
    ``last_epoch`` is ``e + 1`` — a milestone at epoch ``m`` takes effect
    from trained epoch ``m - 1``.  Verified empirically against torch
    (both the 2.x recursive and the closed-form semantics agree) and
    pinned end-to-end by tests/test_trajectory_parity.py.
    """
    steps = sorted(cfg.TRAIN.LR_STEP)
    return float(cfg.TRAIN.LR) * float(cfg.TRAIN.LR_FACTOR) ** bisect.bisect_right(
        steps, epoch + 1)


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    """``TRAIN.OPTIMIZER`` over ``params`` at ``TRAIN.LR``; Adam over CUDA
    parameters is capturable, its rate a tensor on their device."""
    name = cfg.TRAIN.OPTIMIZER
    lr = float(cfg.TRAIN.LR)
    params = list(params)
    if name == "adam":
        on_card = bool(params) and params[0].device.type == "cuda"
        if on_card:
            lr = torch.tensor(lr, dtype=torch.float32,
                              device=params[0].device)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0, capturable=on_card)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(cfg.TRAIN.MOMENTUM),
                               dampening=0.0,
                               weight_decay=float(cfg.TRAIN.WD),
                               nesterov=bool(cfg.TRAIN.NESTEROV))
    raise ValueError(f"unknown TRAIN.OPTIMIZER '{name}'")


def set_lr(state: TrainState, lr: float) -> TrainState:
    """Set every parameter group's learning rate (epoch boundary); a
    tensor rate is written in place, so a captured step reads it."""
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
    return state


def param_dtype(cfg, device) -> torch.dtype:
    """Parameters are float32, float64 in the CPU parity mode; bf16
    compute runs under autocast on float32 parameters."""
    return torch.float64 if compute_dtype(cfg, device) == torch.float64 \
        else torch.float32


def create_train_state(cfg, model: Optional[nn.Module] = None, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"
                       ) -> TrainState:
    """Put ``model`` (or a fresh ``get_pose_net(cfg)``, initialised from
    ``seed``) on ``device`` in train mode, with a fresh optimizer.
    Parameters are float32 (float64 in the CPU parity mode); bf16 compute
    runs under autocast.  ``TPU.NUM_DEVICES`` must fit the process group
    (``parallel.resolve_num_devices``); every rank draws the same
    initialisation from ``seed`` on the CPU, so the ranks start equal."""
    resolve_num_devices(cfg)
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = get_pose_net(cfg)
    device = torch.device(device)
    model = model.to(device=device, dtype=param_dtype(cfg, device))
    model.train()
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, model.parameters()))
