"""Traffic of kind ``crops``: offline pose labelling over a detector's
boxes, a closed loop of ``Predictor.predict_crops`` calls.

Each call serves ``crops_per_call`` seeded uint8 crops with their centres
and scales, one request of a pool of ``pool_calls`` made in set-up, in
turn; the next call starts when the last returned its keypoints.  After
the window, ``sample_crops`` of the answers, drawn from the seed, are held
to the reference's heatmaps of the same crops.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..reference import serve as ref_serve
from .serving import Serving

ASPECT = 0.75       # the crops' width over height


class Loop(Serving):
    def setup(self) -> None:
        pred = self.setup_predictor()
        n = int(self.traffic["crops_per_call"])
        count = int(self.traffic["pool_calls"])
        w, h = self.size
        gen = inputs.generator(self.seed, inputs.CROPS, self.device)
        crops = inputs.smooth_images(gen, n * count, h, w,
                                     self.device).cpu().numpy()
        self.crops = crops
        rng = inputs.numpy_rng(self.seed, inputs.CROPS)
        heights = rng.uniform(80, 600, n * count) * 1.25 / 200
        centers = rng.uniform((100, 100), (1180, 620), (n * count, 2))
        scales = np.stack([heights * ASPECT, heights], -1)
        self.requests = [(crops[i * n:(i + 1) * n],
                          centers[i * n:(i + 1) * n].astype(np.float32),
                          scales[i * n:(i + 1) * n].astype(np.float32))
                         for i in range(count)]
        pred.predict_crops(*self.requests[0])

    def window(self, seconds: float, tracer=None) -> dict:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.answers = []
        traced_from = None
        while time.perf_counter() < deadline:
            if (tracer is not None and traced_from is None and
                    time.perf_counter() >= deadline
                    - self.traffic["trace_seconds"]):
                tracer.start()
                traced_from = len(self.answers)
            req = self.requests[len(self.answers) % len(self.requests)]
            self.answers.append(self.predictor.predict_crops(*req))
        t1 = time.perf_counter()
        if tracer is not None and tracer.active:
            tracer.stop()
        calls = len(self.answers)
        n = len(self.requests[0][0])
        self.traced_calls = calls - (calls if traced_from is None
                                     else traced_from)
        return {"e2e": {"serve_persons_s": calls * n / (t1 - t0)},
                "attempted": calls, "failed": 0}

    def trace_context(self) -> dict:
        from .. import roofline
        n = len(self.requests[0][0])
        batch = self.predictor.batch_size
        chunks = self.traced_calls * -(-n // batch)
        return {"steps": chunks, "items": self.traced_calls * n,
                "flop_per_item": 2 * roofline.forward_flop(self.model_cfg),
                "p5_bound_s": chunks * 2 * roofline.chain_forward_s(
                    self.model_cfg, batch, False)}

    def _sample(self):
        """(call, row) pairs of the window's answers, drawn from the
        seed."""
        n = len(self.requests[0][0])
        total = len(self.answers) * n
        rng = inputs.numpy_rng(self.seed, inputs.SAMPLE)
        picks = rng.choice(total, min(int(self.traffic["sample_crops"]),
                                      total), replace=False)
        return [(int(p) // n, int(p) % n) for p in sorted(picks)]

    def _reference_heatmaps(self, picks, precision):
        model = self.reference_model(precision)
        n = len(self.requests[0][0])
        rows = [(call % len(self.requests)) * n + row for call, row in picks]
        crops = torch.from_numpy(self.crops[rows]).to(self.device)
        return self.heatmaps(model, crops)

    def check(self, limits: dict) -> dict:
        picks = self._sample()
        hm = self._reference_heatmaps(picks, "float32")
        preds = np.stack([self.answers[c][0][r] for c, r in picks])
        maxvals = np.stack([self.answers[c][1][r] for c, r in picks])
        return self._gaps(picks, hm, preds, maxvals, limits["coord_tie"])

    def control(self, limits: dict) -> dict:
        """The readings of the reference in fp8 put in the program's place,
        on the same sample."""
        picks = self._sample()
        hm = self._reference_heatmaps(picks, "float32")
        low = self._reference_heatmaps(picks, "fp8")
        centers, scales = self._geometry(picks)
        preds, maxvals = ref_serve.decode(low, centers, scales)
        return self._gaps(picks, hm, preds, maxvals, limits["coord_tie"])

    def _geometry(self, picks):
        req = self.requests
        centers = np.stack([req[c % len(req)][1][r] for c, r in picks])
        scales = np.stack([req[c % len(req)][2][r] for c, r in picks])
        return centers, scales

    def _gaps(self, picks, hm, preds, maxvals, tie):
        centers, scales = self._geometry(picks)
        return ref_serve.keypoint_gaps(hm, preds, maxvals, centers, scales,
                                       tie)
