"""Traffic of kind ``train_vit``: the ``train`` kind (``loops/train.py``) on
ViTPose, whose student takes each sample's drop-path keep flags.

The same ``run_epoch`` feed, capture on a batch the reference never sees,
restored state, three compared replays and measured window as the
``train`` kind; what differs is the ViT's: its seeded weights and batches
(``vit_inputs.py``, the keep flags among the host arrays ``device_batch``
uploads), its reference (``reference/vit_pose.py``: AdamW with layer
decay, the clipped gradient), and the trace's counts
(``roofline/vit.py``): the step's FLOPs, and the least time of its
attention calls and block linears.
"""

from __future__ import annotations

import logging

import torch

from .. import program, vit_inputs
from ..reference import vit_pose as ref_vit
from ..reference.precision import strict_float32
from . import train


class Loop(train.Loop):
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
        student_sd = vit_inputs.seeded_state_dict(
            s_groups["MODEL"], seed, vit_inputs.inputs.WEIGHTS_STUDENT, dev,
            False)
        teacher_sd = vit_inputs.seeded_state_dict(
            t_groups["MODEL"], seed, vit_inputs.inputs.WEIGHTS_TEACHER, dev,
            True)
        self.host_student, self.host_teacher = (program.on_host(student_sd),
                                                program.on_host(teacher_sd))
        self.pool = vit_inputs.train_batches(
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

    def trace_context(self) -> dict:
        from ..roofline import vit
        s = self.cfg["student"]["MODEL"]
        t = program.merged(self.cfg["student"], self.cfg["teacher"])["MODEL"]
        n, b = self.traced_steps, self.batch
        return {"steps": n, "items": n * b,
                "flop_per_item": vit.forward_flop(t) + vit.train_flop(s),
                "attn_bound_s": n * vit.attention_step_s(t, s, b),
                "gemm_bound_s": n * vit.gemm_step_s(t, s, b)}

    def reference(self, precision: str = "float32") -> dict:
        cfg = {"student": self.cfg["student"],
               "teacher": program.merged(self.cfg["student"],
                                         self.cfg["teacher"])}
        with strict_float32():
            return ref_vit.fpd_steps(
                cfg, self.host_student, self.host_teacher,
                self.pool[:train.FIRST_STEPS], self.device, precision)
