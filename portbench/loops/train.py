"""Traffic of kind ``train``: FPD distillation steps fed as the training
CLI feeds them.

Set-up builds one training state (the student, Adam, the frozen teacher)
and ``make_fpd_train_step`` with the device preprocessing, as
``cli.fpd_train`` does, and drives it through ``cli.train.run_epoch``
(``device_batch``'s upload of every host batch, then the step) for the
first three steps, on three distinct seeded batches.  Before them a
call on a fourth batch, which the reference never sees, runs the step
eagerly and captures its graph, and the state is then put back in place
as the seed made it (parameters, BatchNorm statistics, Adam's moments
and step count), so that the compared steps, like every step of the
window, are replays of that graph.  The window hands the same state to
``run_epoch`` again, fed host batches in the loader's layout, cycled from
a pool made in set-up, until ``--seconds`` have passed; the epoch ends
with the card's synchronise.  The reference follows the first three
steps from the same weights and batches.  A traced run profiles
``trace_steps`` steps from the one after the window's second meters'
read (``PRINT_FREQ``), so that no read of the card falls inside them.
"""

from __future__ import annotations

import logging
import statistics
import time

import numpy as np
import torch

from .. import inputs, program
from ..reference import train as ref_train
from ..reference.precision import strict_float32

FIRST_STEPS = 3
BETA1 = 0.9
# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone (a conv bias before a BatchNorm)
NOUGHT = 1e-3


class Feed:
    """What ``run_epoch`` iterates: batches of ``pool`` from index
    ``start``, ``count`` of them or until the host clock passes
    ``stop_at``; ``on_next(i)`` runs before the i-th is handed out."""

    def __init__(self, pool, start=0, count=None, stop_at=None,
                 on_next=None):
        self.pool, self.start, self.count = pool, start, count
        self.stop_at, self.on_next = stop_at, on_next
        self.handed = 0

    def __len__(self):
        return self.count if self.count is not None else 10 ** 9

    def __iter__(self):
        while True:
            if self.count is not None and self.handed >= self.count:
                return
            if self.stop_at is not None and time.perf_counter() >= self.stop_at:
                return
            if self.on_next is not None:
                self.on_next(self.handed)
            yield self.pool[(self.start + self.handed) % len(self.pool)]
            self.handed += 1


def _norms(tensors) -> np.ndarray:
    return torch.stack(torch._foreach_norm(tensors)).double().cpu().numpy()


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.fault = fault
        self.batch = int(cfg["student"]["TRAIN"]["BATCH_SIZE_PER_GPU"])

    # -- set-up --------------------------------------------------------

    def setup(self) -> None:
        from fhpe_tpu_torch.cli.fpd_train import FPD_METERS, FPD_TB_NAMES
        from fhpe_tpu_torch.cli.train import run_epoch
        from fhpe_tpu_torch.data import dataset_meta
        from fhpe_tpu_torch.train import (create_train_state, lr_for_epoch,
                                          make_batch_preprocessor,
                                          make_fpd_train_step, set_lr)
        s_groups = self.cfg["student"]
        t_groups = program.merged(s_groups, self.cfg["teacher"])
        dev, seed = self.device, self.seed
        student_sd = inputs.seeded_state_dict(
            s_groups["MODEL"], seed, inputs.WEIGHTS_STUDENT, dev, False)
        teacher_sd = inputs.seeded_state_dict(
            t_groups["MODEL"], seed, inputs.WEIGHTS_TEACHER, dev, True)
        self.host_student, self.host_teacher = (program.on_host(student_sd),
                                                program.on_host(teacher_sd))
        self.pool = inputs.train_batches(
            s_groups["MODEL"], self.batch, int(self.traffic["pool_batches"]),
            seed, dev)
        self.scfg = program.port_cfg(s_groups)
        tcfg = program.port_cfg(t_groups)
        student = program.port_model(self.scfg, student_sd, dev)
        teacher = program.port_model(tcfg, teacher_sd, dev)
        teacher = teacher.eval().requires_grad_(False)
        del student_sd, teacher_sd
        program.release(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        self.state = create_train_state(self.scfg, student, device=dev)
        prepare = make_batch_preprocessor(
            self.scfg, dataset_meta(self.scfg.DATASET.DATASET)["joints_weight"])
        if self.fault is not None:
            prepare = self.fault.train(self.state, prepare)
        self.step = make_fpd_train_step(self.scfg, teacher, teacher_cfg=tcfg,
                                        prepare=prepare)
        self.state = set_lr(self.state, lr_for_epoch(self.scfg, 0))
        self._teacher = teacher
        self._run_epoch = run_epoch
        self._meters = (FPD_METERS, FPD_TB_NAMES)
        self._logger = logging.getLogger("portbench.program")
        self._logger.setLevel(logging.WARNING)
        self._capture()
        self._first_steps()

    def _epoch(self, feed, step, epoch: int) -> None:
        self.state, _ = self._run_epoch(
            self.scfg, feed, step, self.state, self.device, epoch,
            self._logger, None, 0, *self._meters)

    def _capture(self) -> None:
        """The step's first call, which runs eagerly and captures the
        graph, on a batch the compared steps do not use; then the state
        as it was before it, written back into the same storage, which
        the graph reads."""
        model = self.state.model
        tensors = [*model.parameters(), *model.buffers()]
        kept = [t.detach().clone() for t in tensors]
        self._epoch(Feed(self.pool, FIRST_STEPS, 1), self.step, 0)
        with torch.no_grad():
            for t, k in zip(tensors, kept):
                t.copy_(k)
            for st in self.state.optimizer.state.values():
                for v in st.values():
                    if isinstance(v, torch.Tensor):
                        v.zero_()
        self.state.step = 0

    def _first_steps(self) -> None:
        """Steps 1-3 through ``run_epoch``, each a replay on the card:
        each step's loss, the first gradient's norm per leaf read from
        Adam's first moment after step 1, the change of each leaf after
        step 3."""
        model, opt = self.state.model, self.state.optimizer
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        start = [p.detach().clone() for p in params]
        losses, seen = [], {}
        captures = self.step.captured.captures

        def keep_loss(state, batch):
            state, metrics = self.step(state, batch)
            losses.append(metrics["loss"])
            return state, metrics

        def on_next(i):
            if i == 1:      # an optimizer that kept no moment moved nothing
                seen["grad"] = _norms([opt.state[p].get(
                    "exp_avg", torch.zeros_like(p)) for p in params]) / (1 - BETA1)

        self._epoch(Feed(self.pool, 0, FIRST_STEPS, on_next=on_next),
                    keep_loss, 0)
        if self.step.captured.captures != captures:
            raise RuntimeError("a compared step captured its graph anew "
                               "instead of replaying it")
        seen["delta"] = _norms(torch._foreach_sub(
            [p.detach() for p in params], start))
        self.program = {"loss": [float(v) for v in losses],
                        "grad": dict(zip(names, seen["grad"])),
                        "delta": dict(zip(names, seen["delta"]))}

    # -- the measured window -------------------------------------------

    def window(self, seconds: float, tracer=None) -> dict:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        # steps first .. last - 1 lie between two meters' reads
        every, count = int(self.scfg.PRINT_FREQ), int(
            self.traffic["trace_steps"])
        assert count < every, "trace_steps has to be under PRINT_FREQ"
        first = every + 1
        last = first + count

        def on_next(i):
            if tracer is not None and i == first:
                tracer.start()
            elif tracer is not None and i == last and tracer.active:
                tracer.stop()

        feed = Feed(self.pool, FIRST_STEPS, stop_at=deadline,
                    on_next=on_next)
        self._epoch(feed, self.step, 1)
        t1 = time.perf_counter()
        if tracer is not None and tracer.active:
            tracer.stop()
        steps = feed.handed
        self.traced_steps = max(0, min(steps, last) - first)
        return {"e2e": {"train_img_s": steps * self.batch / (t1 - t0)},
                "attempted": steps, "failed": 0}

    def trace_context(self) -> dict:
        from .. import roofline
        s = self.cfg["student"]["MODEL"]
        t = program.merged(self.cfg["student"], self.cfg["teacher"])["MODEL"]
        n, b = self.traced_steps, self.batch
        return {"steps": n, "items": n * b,
                "flop_per_item": (roofline.forward_flop(t)
                                  + roofline.train_flop(s)),
                "p4_bound_s": n * roofline.p4_step_s(s, b),
                "p5_bound_s": n * (roofline.chain_forward_s(t, b, False)
                                   + roofline.chain_forward_s(s, b, True))}

    def free(self) -> None:
        del self.state, self.step, self._teacher
        program.release(self.device)

    # -- correctness ---------------------------------------------------

    def reference(self, precision: str = "float32") -> dict:
        with strict_float32():
            return ref_train.fpd_steps(
                self.cfg, self.host_student, self.host_teacher,
                self.pool[:FIRST_STEPS], self.device, precision)

    def check(self, limits: dict) -> dict:
        return gaps(self.program, self.reference())

    def control(self, limits: dict) -> dict:
        """The readings of the reference in fp8 put in the program's
        place."""
        want = self.reference()
        return gaps(self.reference("fp8"), want)


def _leaf_gaps(got: dict, want: dict, keep) -> list:
    median = statistics.median(want.values())
    return [abs(got[n] - want[n]) / max(want[n], median) for n in keep]


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared: the worst step's loss against the
    reference's; the worst leaf's norm of the first gradient and of the
    change after the last step, each against the reference's norm of that
    leaf or of the median leaf, whichever is larger; and the median leaf's
    gap of the first gradient, which holds steady where one small leaf's
    round-off sets the worst (PERF.md).  Leaves whose reference gradient
    is under ``NOUGHT`` of the median leaf's are left out."""
    grad_median = statistics.median(want["grad"].values())
    keep = [n for n, v in want["grad"].items() if v >= NOUGHT * grad_median]
    grad = _leaf_gaps(got["grad"], want["grad"], keep)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["loss"], want["loss"])),
            "grad_gap": max(grad),
            "grad_median_gap": statistics.median(grad),
            "delta_gap": max(_leaf_gaps(got["delta"], want["delta"], keep))}
