"""What the two serving kinds share: the served student
(``serve/predictor.py::Predictor``, one replica, the configuration's batch
and flip test) holding the benchmark's seeded weights, warmed up in
set-up, and the reference's heatmaps of crops."""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs, program
from ..reference import models as ref_models
from ..reference import serve as ref_serve
from ..reference.precision import strict_float32

REF_BLOCK = 64      # crops per reference forward


class Serving:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.fault = fault
        self.model_cfg = cfg["student"]["MODEL"]
        self.size = tuple(self.model_cfg["IMAGE_SIZE"])    # (w, h)
        self.hm_size = tuple(self.model_cfg["HEATMAP_SIZE"])

    def setup_predictor(self):
        from fhpe_tpu_torch.serve import Predictor
        dev = self.device
        sd = inputs.seeded_state_dict(self.model_cfg, self.seed,
                                      inputs.WEIGHTS_STUDENT, dev, True)
        self.host_sd = program.on_host(sd)
        self.scfg = program.port_cfg(self.cfg["student"])
        model = program.port_model(self.scfg, sd, dev)
        del sd
        program.release(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.predictor = Predictor(self.scfg, model, device=[dev])
        if self.fault is not None:
            self.fault.serve(self.predictor)
        self.predictor.warmup()
        return self.predictor

    def free(self) -> None:
        del self.predictor
        program.release(self.device)

    def reference_model(self, precision: str = "float32"):
        model = ref_models.set_precision(ref_models.build(self.model_cfg),
                                         precision)
        model.load_state_dict(self.host_sd)
        return model.to(self.device).eval()

    def heatmaps(self, model, crops: torch.Tensor) -> np.ndarray:
        """The reference's flip-test heatmaps of (N, h, w, 3) uint8 crops
        on the device, in blocks, as float32 numpy."""
        test = self.cfg["student"]["TEST"]
        out = []
        with strict_float32():
            for lo in range(0, len(crops), REF_BLOCK):
                out.append(ref_serve.merged_heatmaps(
                    model, crops[lo:lo + REF_BLOCK], self.cfg["flip_pairs"],
                    bool(test["SHIFT_HEATMAP"])).cpu().numpy())
        return np.concatenate(out)
