"""One rank of a data-parallel parity run of the port's train steps.

    torchrun --standalone --nproc_per_node 2 \\
        -m fhpe_tpu_torch.tools.ddp_parity --cases CASES.pt --out DIR

Every rank joins the process group (``parallel.initialize``: gloo, on the
CPU, where ``fhpe_tpu``'s steps are its reference), builds each case's student (and teacher) from the
weights in ``CASES.pt``, and runs the case's steps
(``make_train_step`` or ``make_fpd_train_step``, ``TPU.BN_STATS`` from the
case's config) on its contiguous slice of each global batch, as
``BatchLoader`` slices one.  It writes ``DIR/rank<r>.pt``:

* ``"created"``: the student ``create_train_state`` makes from seed 0
  (every rank must draw the same one);
* ``"refusal"``: the message ``create_train_state`` raises for a
  ``TPU.NUM_DEVICES`` of world size + 1;
* per case, per step: the metrics, the model's ``state_dict`` and the
  optimizer's.

``CASES.pt`` (``torch.save``): ``{"cases": [{"name", "student": (yaml,
opts), "teacher": (yaml, opts) or None, "student_weights",
"teacher_weights" (state_dicts), "batches": [{"image", "target",
"target_weight"}, ...]}]}``.  ``tests/test_torch_parallel.py`` writes it
and holds the ranks' files to each other and to ``fhpe_tpu``'s steps on a
2-device mesh.
"""

from __future__ import annotations

import argparse
import copy
from pathlib import Path

import torch

from ..config import load_config
from ..models import get_pose_net
from ..parallel import initialize, process_count, process_index, shutdown
from ..train import (create_train_state, make_fpd_train_step,
                     make_train_step, param_dtype)


def _slice(batch: dict, device) -> dict:
    """This rank's contiguous slice of a global batch."""
    n = next(iter(batch.values())).shape[0] // process_count()
    lo = process_index() * n
    return {k: v[lo:lo + n].to(device) for k, v in batch.items()}


def _model(cfg, weights, device):
    model = get_pose_net(cfg).to(dtype=param_dtype(cfg, device))
    model.load_state_dict(weights)
    return model.to(device)


def run_case(case: dict, device) -> list:
    cfg = load_config(*case["student"])
    state = create_train_state(
        cfg, _model(cfg, case["student_weights"], device), device=device)
    if case["teacher"] is None:
        step = make_train_step(cfg)
    else:
        tcfg = load_config(*case["teacher"])
        teacher = _model(tcfg, case["teacher_weights"], device)
        teacher.eval().requires_grad_(False)
        step = make_fpd_train_step(cfg, teacher, teacher_cfg=tcfg)
    out = []
    for batch in case["batches"]:
        state, metrics = step(state, _slice(batch, device))
        out.append({"metrics": {k: v.cpu() for k, v in metrics.items()},
                    "model": copy.deepcopy(state.model.state_dict()),
                    "optimizer": copy.deepcopy(
                        state.optimizer.state_dict())})
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cases", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    device = initialize("cpu")
    if device is None:
        raise SystemExit("ddp_parity runs under torchrun")
    try:
        cases = torch.load(args.cases, weights_only=True)["cases"]
        cfg = load_config(*cases[0]["student"])
        result = {"created": create_train_state(
            cfg, seed=0, device=device).model.state_dict()}
        cfg.defrost()
        cfg.TPU.NUM_DEVICES = process_count() + 1
        try:
            create_train_state(cfg, device=device)
        except ValueError as e:
            result["refusal"] = str(e)
        for case in cases:
            result[case["name"]] = run_case(case, device)
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        torch.save(result, out / f"rank{process_index()}.pt")
    finally:
        shutdown()


if __name__ == "__main__":
    main()
