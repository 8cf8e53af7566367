"""The port's spans (``fhpe_tpu_torch/utils/spans.py``) under the CPU
profiler: the no-op with the profiler off, the kind of event recorded, and
the spans of the train loop, of a captured step and of serving, each in
its parent on the calling thread."""

import logging

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from fhpe_tpu_torch.cli.common import build_loaders
from fhpe_tpu_torch.cli.train import run_epoch
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.serve import Predictor
from fhpe_tpu_torch.train import (create_train_state,
                                  make_batch_preprocessor, make_train_step)
from fhpe_tpu_torch.utils import spans
from fhpe_tpu_torch.utils.graph import CapturedStep

HG = {"NAME": "hourglass", "NUM_JOINTS": 16, "IMAGE_SIZE": [64, 64],
      "HEATMAP_SIZE": [16, 16], "SIGMA": 2, "PRETRAINED": "",
      "INIT_WEIGHTS": False, "TARGET_TYPE": "gaussian",
      "EXTRA": {"NUM_FEATURES": 16, "NUM_STACKS": 1, "NUM_BLOCKS": 1}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models: two intra-op threads run them as fast as all cores do
    and spare the other test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(tmp_path, **over):
    cfg = {"OUTPUT_DIR": str(tmp_path / "out"),
           "LOG_DIR": str(tmp_path / "log"), "PRINT_FREQ": 2, "WORKERS": 2,
           "DATASET": {"DATASET": "synthetic",
                       "ROOT": str(tmp_path / "data"), "TEST_SET": "valid",
                       "TRAIN_SET": "train", "SYNTH_SIZE": 12},
           "MODEL": HG,
           "TRAIN": {"BATCH_SIZE_PER_GPU": 4, "END_EPOCH": 1, "LR": 0.001},
           "TEST": {"BATCH_SIZE_PER_GPU": 4, "FLIP_TEST": True,
                    "POST_PROCESS": True, "SHIFT_HEATMAP": True},
           "TPU": {"COMPUTE_DTYPE": "float32"},
           "DEBUG": {"DEBUG": False}, **over}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return load_config(str(path))


def _events(prof):
    """The recorded ``fhpe.`` spans as dicts, in order of start."""
    out = [{"name": e.name(), "lo": e.start_ns(), "hi": e.end_ns(),
            "tid": e.start_thread_id(), "annotation": e.is_user_annotation()}
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("fhpe.")]
    return sorted(out, key=lambda e: (e["lo"], -e["hi"]))


def _inside(child, parent):
    return parent["lo"] <= child["lo"] and child["hi"] <= parent["hi"]


def _names(events):
    return [e["name"] for e in events]


def test_off_span_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    one, two = spans.span("fhpe.a"), spans.span("fhpe.b")
    assert one is two is spans._OFF
    # entered with the profiler off, it records nothing once it is on
    with spans.span("fhpe.off") as got:
        assert got is None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(2).add_(1)
    assert _events(prof) == []


def test_span_is_a_host_event_not_a_user_annotation():
    """``_RecordFunctionFast`` records an ordinary host event: a torch that
    drops it, or makes its events user annotations (which the CUDA
    profiler mirrors onto the device), fails here."""
    assert hasattr(torch._C._profiler, "_RecordFunctionFast")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("fhpe.outer"):
            with spans.span("fhpe.inner"):
                torch.ones(3).add_(1)
    outer, inner = _events(prof)
    assert (outer["name"], inner["name"]) == ("fhpe.outer", "fhpe.inner")
    assert _inside(inner, outer)
    assert not outer["annotation"] and not inner["annotation"]

    @spans.spanned("fhpe.call")
    def call(x):
        return x + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert call(1) == 2
    assert _names(_events(prof)) == ["fhpe.call"]


def test_run_epoch_records_a_step_span_per_step(tmp_path):
    cfg = _cfg(tmp_path)
    loader, val_loader, meta = build_loaders(cfg)
    try:
        state = create_train_state(cfg, seed=0, device="cpu")
        prepare = (make_batch_preprocessor(cfg, meta["joints_weight"])
                   if cfg.TPU.DEVICE_PREPROCESS else None)
        step = make_train_step(cfg, prepare=prepare)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run_epoch(cfg, loader, step, state, torch.device("cpu"), 0,
                      logging.getLogger("test_torch_spans"), None, 0)
    finally:
        loader.close()
        val_loader.close()
    events = _events(prof)
    steps = [e for e in events if e["name"] == "fhpe.train.step"]
    assert len(steps) == len(loader) == 3
    assert {e["tid"] for e in events} == {steps[0]["tid"]}
    for root in steps:
        inner = _names(e for e in events if e is not root
                       and _inside(e, root))
        # on the CPU the captured step runs its body after the lookup
        assert inner == ["fhpe.train.upload", "fhpe.train.modes",
                         "fhpe.graph.lookup", "fhpe.train.meters"]


def test_captured_step_spans():
    """The stand-in capture: ``fhpe.graph.capture`` on the first call, then
    a lookup and a replay on each later one."""
    def capture(run):
        out = run()
        return (lambda: None), out

    captured = CapturedStep(lambda owner, batch: {"y": batch["x"] * 2},
                            lambda owner: (), capture=capture)
    x = {"x": torch.ones(3)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            captured(None, x)
    assert _names(_events(prof)) == [
        "fhpe.graph.lookup", "fhpe.graph.capture",
        "fhpe.graph.lookup", "fhpe.graph.replay",
        "fhpe.graph.lookup", "fhpe.graph.replay"]


def test_predict_crops_spans_on_the_calling_thread(tmp_path):
    """70 crops at batch 32: one request holding one plan, three reads
    and the waits for the prefetch thread's fills, all on this thread
    (the prefetch thread's own work is not recorded)."""
    cfg = _cfg(tmp_path, DATASET={"DATASET": "mpii"})
    torch.manual_seed(0)
    pred = Predictor(cfg, get_pose_net(cfg), batch_size=32, device="cpu")
    rng = np.random.RandomState(0)
    crops = rng.randint(0, 256, size=(70, 64, 64, 3)).astype(np.uint8)
    centers = rng.uniform(100, 300, size=(70, 2))
    scales = rng.uniform(0.8, 1.6, size=(70, 2))
    pred.predict_crops(crops[:2], centers[:2], scales[:2])   # the threads
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        preds, _ = pred.predict_crops(crops, centers, scales)
    assert preds.shape == (70, 16, 2)
    events = _events(prof)
    (root,) = [e for e in events if e["name"] == "fhpe.serve.request"]
    assert all(_inside(e, root) for e in events)
    assert {e["tid"] for e in events} == {root["tid"]}
    named = _names(events)
    assert named.count("fhpe.serve.plan") == 1
    assert named.count("fhpe.serve.readback") == 3
    assert named.count("fhpe.serve.wait_fill") == 3
    assert named.count("fhpe.graph.lookup") == 3
    assert named[:3] == ["fhpe.serve.request", "fhpe.serve.plan",
                         "fhpe.serve.wait_fill"]
