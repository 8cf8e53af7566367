"""Faults planted in the program under test, to show that a run's
comparison with the reference catches them (the tests under this folder
and ``controls.py``; the benchmark's own runs plant none).

* ``unchanged``: the optimizer's step does nothing, so a training step
  returns its state as it found it;
* ``half_batch``: the step sees the first half of its batch's rows; a
  training step's loss is the mean over those, a serving step answers the
  second half with the first half's rows;
* ``altered``: each served crop's keypoints come out one joint along
  (``preds`` and ``maxvals`` rolled), as a wrong answer made where it is
  produced.
"""

from __future__ import annotations

import torch


class Unchanged:
    kinds = ("train",)

    def train(self, state, prepare):
        state.optimizer.step = lambda *args, **kwargs: None
        return prepare


class HalfBatch:
    kinds = ("train", "crops")

    def train(self, state, prepare):
        def half(batch):
            out = prepare(batch)
            n = out["image"].shape[0] // 2
            return {k: v[:n] for k, v in out.items()}
        return half

    def serve(self, predictor):
        for step in predictor.steps:
            body = step.eager

            def half(model, batch, body=body):
                n = batch["image"].shape[0] // 2
                return body(model, {k: torch.cat([v[:n], v[:n]])
                                    for k, v in batch.items()})
            step.eager = half


class Altered:
    kinds = ("crops",)

    def serve(self, predictor):
        for step in predictor.steps:
            body = step.eager

            def rolled(model, batch, body=body):
                out = body(model, batch)
                return {k: v.roll(1, dims=1) for k, v in out.items()}
            step.eager = rolled


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch, "altered": Altered}
