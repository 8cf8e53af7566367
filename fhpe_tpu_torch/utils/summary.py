"""Model summary: parameters and FLOPs.

Counterpart of ``fhpe_tpu/utils/summary.py`` (the reference's
forward-hook counter, ``lib/utils/utils.py:86-202``).  Parameters come
from the module; FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
over one forward of a copy on the CPU, in total and per module at depth 2
for the table.

The count runs on the CPU, never on the card: there the kernels'
wrappers take their plain versions, whose convs the counter sees.  On the
card P4, P5 and conv3x3_fwd are custom launches that it does not see
(HRNet-W32's 26 branch chains would drop out of the count).  The copy is
the module's structure with zeroed float32 tensors (a count does not
depend on values), made without moving the module or reading its
weights, so a model on the card, or on the ``meta`` device, is counted
where it stays, as ``fhpe_tpu`` lowers on the CPU beside the TPU.  The
counter charges every conv at its full kernel, 2 FLOPs per multiply-add:
2.7-4.0% above XLA's ``cost_analysis`` on the same configs
(``tests/test_torch_summary.py``).  ``fhpe_tpu``'s ``dump_hlo`` (XLA's
lowered text) has no counterpart.
"""

from __future__ import annotations

import copy
import itertools
import logging
import time

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..models import param_count

logger = logging.getLogger(__name__)


def _cpu_copy(model: nn.Module) -> nn.Module:
    """``model`` deep-copied with every parameter and buffer replaced by
    zeros on the CPU (float32 for floating tensors)."""
    memo = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        z = torch.zeros(t.shape, dtype=torch.float32 if t.is_floating_point()
                        else t.dtype)
        memo[id(t)] = (nn.Parameter(z, requires_grad=False)
                       if isinstance(t, nn.Parameter) else z)
    return copy.deepcopy(model, memo)


def module_param_table(model: nn.Module) -> list:
    """``[(name, n_params), ...]`` per top-level submodule, sorted by name
    (``fhpe_tpu``'s rows are its top-level flax submodules)."""
    return sorted((name, param_count(m))
                  for name, m in model.named_children())


def count_flops(model: nn.Module, x: torch.Tensor, train: bool = False):
    """(total FLOPs, {module path: FLOPs}) of ``model(x)`` on a CPU copy
    (``x`` is taken on the CPU); the paths are ``named_modules``' names,
    ``""`` the model itself."""
    net = _cpu_copy(model).train(train)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(x.to(device="cpu", dtype=torch.float32))
    per = {}
    for key, ops in counter.get_flop_counts().items():
        if key != "Global":
            # keys are "<model class>[.<path>]"
            per[key.partition(".")[2]] = sum(ops.values())
    return counter.get_total_flops(), per


def _module_flops(per: dict, name: str) -> int:
    """FLOPs of the module ``name``: its own count, or for a container
    that is never called (a ``ModuleList``) the sum over its outermost
    descendants that are."""
    if name in per:
        return per[name]
    total = 0
    for key, flops in per.items():
        if key.startswith(name + "."):
            parts = key.split(".")
            if not any(".".join(parts[:i]) in per
                       for i in range(name.count(".") + 2, len(parts))):
                total += flops
    return total


def _flops_table(model: nn.Module, per: dict, depth: int) -> str:
    rows = [(name or type(model).__name__, param_count(m),
             _module_flops(per, name))
            for name, m in model.named_modules()
            if name == "" or name.count(".") < depth - 1]
    name_w = max(len(r[0]) for r in rows)
    lines = [f"{'Module':<{name_w}}  {'Params':>12}  {'GFLOPs':>10}",
             "-" * (name_w + 26)]
    lines += [f"{n:<{name_w}}  {p:>12,}  {f / 1e9:>10.4f}"
              for n, p, f in rows]
    return "\n".join(lines)


def per_module_flops_table(model: nn.Module, x: torch.Tensor,
                           train: bool = False, depth: int = 2
                           ) -> str | None:
    """Per-module name/params/FLOPs table down to ``depth`` (the model is
    depth 1; the reference's per-module rows,
    ``lib/utils/utils.py:170-199``) from one counted forward on a CPU
    copy.  Best-effort: returns None, with a logged warning, if the count
    fails."""
    try:
        return _flops_table(model, count_flops(model, x, train)[1], depth)
    except Exception as e:  # noqa: BLE001 — observability must not kill runs
        logger.warning("per-module FLOPs table unavailable: %r", e)
        return None


def get_model_summary(model: nn.Module, input_hw, batch: int = 1,
                      train: bool = False, per_module_flops: bool = True):
    """dict with ``params``, ``flops`` (forward, per batch of ``batch``
    images of ``input_hw`` (H, W)), ``modules`` (:func:`module_param_table`),
    ``module_flops_table``, ``seconds`` (the count's) and ``text``, a
    printable table (reference ``get_model_summary``,
    ``lib/utils/utils.py:86-202``).  A count that fails logs a warning and
    leaves ``flops`` None."""
    n_params = param_count(model)
    rows = module_param_table(model)
    x = torch.zeros(batch, 3, int(input_hw[0]), int(input_hw[1]))
    flops = per = None
    t0 = time.perf_counter()
    try:
        flops, per = count_flops(model, x, train)
    except Exception as e:  # noqa: BLE001 — observability must not kill runs
        logger.warning("whole-model FLOPs unavailable (FlopCounterMode on a "
                       "CPU copy failed): %r", e)
    seconds = time.perf_counter() - t0

    name_w = max([len(r[0]) for r in rows] + [len("Module")])
    lines = [
        f"Model: {type(model).__name__}",
        f"{'Module':<{name_w}}  {'Params':>12}  {'Share':>6}",
        "-" * (name_w + 22),
    ]
    for name, n in rows:
        share = 100.0 * n / max(n_params, 1)
        lines.append(f"{name:<{name_w}}  {n:>12,}  {share:>5.1f}%")
    lines.append("-" * (name_w + 22))
    lines.append(f"Total Parameters: {n_params:,}")
    if flops is not None:
        lines.append(f"Forward GFLOPs (batch={batch}, FlopCounterMode on a "
                     f"CPU copy, {seconds:.2f} s): {flops / 1e9:.4g}")
    else:
        lines.append("Forward GFLOPs: unavailable (see warning log)")
    module_table = None
    if per_module_flops and per is not None:
        module_table = _flops_table(model, per, depth=2)
        lines.append(module_table)
    return {"params": n_params, "flops": flops, "modules": rows,
            "module_flops_table": module_table, "seconds": seconds,
            "text": "\n".join(lines)}
