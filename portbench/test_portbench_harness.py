"""CPU tests of the harness: the manifest's names, finding files by name,
seeded inputs, the metric arithmetic, the roofline figures, the reference
against the port, and the reference's imports."""

import ast
import json
import re
import shutil
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, inputs, roofline, trace
from portbench.reference import models as ref_models
from portbench.reference import serve as ref_serve

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny_hourglass(stacks=2, features=16):
    return {"NAME": "hourglass", "NUM_JOINTS": 16, "IMAGE_SIZE": [64, 64],
            "HEATMAP_SIZE": [16, 16], "SIGMA": 2,
            "EXTRA": {"NUM_STACKS": stacks, "NUM_BLOCKS": 1,
                      "NUM_FEATURES": features}}


def tiny_hrnet(width=8):
    def stage(s):
        return {"NUM_MODULES": 1, "NUM_BRANCHES": s, "BLOCK": "BASIC",
                "NUM_BLOCKS": [2] * s, "FUSE_METHOD": "SUM",
                "NUM_CHANNELS": [width * 2 ** i for i in range(s)]}
    return {"NAME": "pose_hrnet", "NUM_JOINTS": 17, "IMAGE_SIZE": [96, 128],
            "HEATMAP_SIZE": [24, 32], "SIGMA": 2,
            "EXTRA": {"FINAL_CONV_KERNEL": 1, "STAGE2": stage(2),
                      "STAGE3": stage(3), "STAGE4": stage(4)}}


# -- the manifest ---------------------------------------------------------

def test_manifest_names_units_and_files():
    m = harness.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in m["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in {c["name"] for c in m["configs"]}
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200
    for c in m["configs"]:
        assert (HERE.parent / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for p in m["per_layer"]:
        assert p["moves"] in e2e
        assert (HERE / "metrics" / f"{p['name']}.py").is_file()
        for w in p["workloads"]:      # each cell listed reports `moves`
            assert p["moves"] in {e["name"] for e in harness.end_to_end(m, w)}
    for w in m["workloads"]:          # every cell: setup_s, one more, a layer
        assert len(harness.end_to_end(m, w["name"])) >= 2
        assert harness.per_layer(m, w["name"])
    assert len(json.dumps(m)) < 64 * 1024


def test_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a traffic mix and a metric added as files are found
    by their names, with no file of the harness edited."""
    root = tmp_path / "portbench"
    shutil.copytree(HERE / "metrics", root / "metrics")
    (root / "traffic").mkdir()
    (root / "configs").mkdir()
    (root / "traffic" / "new_mix.json").write_text('{"kind": "crops"}')
    (root / "configs" / "new_model.json").write_text('{"student": {}}')
    (root / "metrics" / "new_metric.x.py").write_text(
        "from ._shares import per_step\n\ndef read(r):\n"
        "    return per_step(r, 6.0)\n")
    monkeypatch.setattr(harness, "HERE", root)
    assert harness.data("traffic", "new_mix") == {"kind": "crops"}
    assert harness.data("configs", "new_model") == {"student": {}}
    assert harness.reader("new_metric.x")({"steps": 3}) == 2.0
    assert harness.loop_class("crops").__module__ == "portbench.loops.crops"


# -- seeded inputs ----------------------------------------------------------

def test_traffic_is_the_same_for_a_seed():
    big = 2 ** 31 + 12345
    crops = [inputs.smooth_images(inputs.generator(s, inputs.CROPS, "cpu"),
                                  2, 64, 48, "cpu")
             for s in (big, big, big + 1)]
    assert torch.equal(crops[0], crops[1])
    assert not torch.equal(crops[0], crops[2])
    cfg = tiny_hourglass()
    one = inputs.train_batches(cfg, 2, 2, big, "cpu")
    two = inputs.train_batches(cfg, 2, 2, big, "cpu")
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(one, two)
               for k in x)
    assert not np.array_equal(one[0]["image"], one[1]["image"])
    sd = inputs.seeded_state_dict(cfg, big, 0, "cpu", calibrate=True)
    sd2 = inputs.seeded_state_dict(cfg, big, 0, "cpu", calibrate=True)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


# -- metric arithmetic --------------------------------------------------------

def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "tid": 1}


def test_idle_share_launches_and_breakdown():
    events = [ev("kernel", "void wgrad_bf16<1>(x)", 0, 100),
              ev("kernel", "cudnn_conv", 50, 100),          # overlaps
              ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 300, 50),
              ev("gpu_memset", "Memset (Device)", 500, 100),
              ev("cuda_runtime", "cudaGraphLaunch", 0, 5),
              ev("cuda_runtime", "cudaMemcpyAsync", 290, 5),
              ev("cuda_runtime", "cudaStreamSynchronize", 360, 130),
              ev("cuda_runtime", "cudaLaunchKernel", 495, 5),
              ev("cpu_op", "aten::copy_", 150, 200)]
    assert trace.busy_s(events) == pytest.approx(300e-6)
    assert trace.idle_share(events, 1e-3) == pytest.approx(70.0)
    assert trace.launches(events) == 3
    assert trace.copy_s(events, "HtoD") == pytest.approx(50e-6)
    assert trace.kernel_s(events, r"wgrad_(partial|reduce|bf16)") == \
        pytest.approx(100e-6)
    assert trace.top_ops(events, 2)[0] == ["void wgrad_bf16<1>(x)", 1e-4]
    gaps = trace.idle_gaps(events)
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(150e-6)]
    assert gaps[1] == ["aten::copy_", pytest.approx(150e-6)]
    assert trace.category("Memcpy HtoD (Pageable -> Device)", True) == \
        "gpu_memcpy"
    assert trace.category("cudaGraphLaunch", False) == "cuda_runtime"
    assert trace.category("aten::copy_", False) == "cpu_op"
    lone = [ev("kernel", "k", 0, 10), ev("kernel", "k", 100, 10),
            ev("cpu_op", "aten::add", 20, 5), ev("cpu_op", "aten::mul", 90, 5)]
    assert trace.idle_gaps(lone) == [["python between aten::add and aten::mul",
                                      pytest.approx(90e-6)]]
    r = {"events": events, "window_s": 1e-3, "steps": 2, "items": 64,
         "flop_per_item": 1e9, "p4_bound_s": 50e-6}
    assert harness.reader("device_idle.train")(r) == pytest.approx(70.0)
    assert harness.reader("launches_per_step.train")(r) == 1.5
    assert harness.reader("h2d_ms.train")(r) == pytest.approx(0.025)
    assert harness.reader("p4_roofline.train")(r) == pytest.approx(50.0)
    assert harness.reader("p5_roofline.train")(r) is None     # no P5 ran
    assert harness.reader("step_mfu.train")(r) == pytest.approx(
        100 * 64e9 / 1e-3 / 989e12)
    assert harness.reader("device_idle.train")(
        {"events": [], "window_s": 1.0}) is None


# -- roofline -----------------------------------------------------------------

def test_roofline_figures():
    """The P4, P5e and P5t figures of the port's kernel table, from the
    benchmark's own functions."""
    cfgs = {c: harness.data("configs", c)
            for c in ("hg_fpd_mpii", "hrnet_fpd_coco")}
    nbytes, ops = roofline.p4_call(32, 64, 64, 64)
    assert 33.5e6 < nbytes < 33.8e6 and ops == pytest.approx(9.66e9, 1e-3)
    assert roofline.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0101, 1e-2)
    hr = cfgs["hrnet_fpd_coco"]
    w32, w48 = hr["student"]["MODEL"], hr["teacher"]["MODEL"]
    e_bytes, e_ops = roofline.chain_call(32, 32, 64, 48, 4, train=False)
    assert e_ops == pytest.approx(14.5e9, 1e-2)
    assert roofline.bound_s(e_bytes, e_ops) * 1e3 == pytest.approx(0.0147,
                                                                   1e-2)
    t_bytes, t_ops = roofline.chain_call(32, 32, 64, 48, 4, train=True)
    assert t_bytes == pytest.approx(82e6, 1e-2)
    assert roofline.bound_s(t_bytes, t_ops) * 1e3 == pytest.approx(0.0245,
                                                                   1e-2)
    hg = roofline.conv3x3_shapes(cfgs["hg_fpd_mpii"]["student"]["MODEL"], 32)
    assert len(hg) == 59
    assert roofline.p4_step_s(cfgs["hg_fpd_mpii"]["student"]["MODEL"],
                              32) * 1e3 == pytest.approx(0.163, 1e-2)
    w32_p4 = roofline.conv3x3_shapes(w32, 32)
    assert len(w32_p4) == 212
    # the kernel table's 0.485 ms is the set's bytes over the memory rate;
    # the benchmark sums each call's own bound, which is larger
    assert sum(roofline.p4_call(*s)[0] for s in w32_p4) \
        / roofline.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.485, 1e-2)
    assert roofline.p4_step_s(w32, 32) * 1e3 == pytest.approx(0.541, 1e-2)
    assert len(roofline.chain_shapes(w32, 32)) == 26
    chains = (roofline.chain_forward_s(w48, 32, False)
              + roofline.chain_forward_s(w32, 32, True))
    assert chains * 1e3 == pytest.approx(1.317, 1e-2)
    assert roofline.forward_flop(w32) / 1e9 == pytest.approx(15.29, 1e-3)
    assert roofline.forward_flop(w48) / 1e9 == pytest.approx(31.38, 1e-3)
    assert roofline.train_flop(w32) == pytest.approx(
        3 * roofline.forward_flop(w32), 1e-2)


# -- the reference ------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "fhpe_tpu", "fhpe_tpu_torch"}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_forbidden_modules_compared_by_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "fhpe_tpu_torch_like",
                        types.ModuleType("fhpe_tpu_torch_like"))
    assert "fhpe_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fhpe_tpu.ops", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["fhpe_tpu"]


@pytest.mark.parametrize("model_cfg", [tiny_hourglass(), tiny_hrnet()],
                         ids=["hourglass", "hrnet"])
def test_reference_matches_the_port(model_cfg):
    """The reference networks and the port's hold the same seeded weights
    and give the same heatmaps in float32, in eval and in train mode."""
    from portbench import program
    groups = {"MODEL": dict(model_cfg, INIT_WEIGHTS=False,
                            TARGET_TYPE="gaussian"),
              "TPU": {"COMPUTE_DTYPE": "float32"}}
    sd = inputs.seeded_state_dict(model_cfg, 7, 0, "cpu", calibrate=True)
    port = program.port_model(program.port_cfg(groups), sd, "cpu")
    ref = ref_models.build(model_cfg)
    ref.load_state_dict(sd)
    assert set(port.state_dict()) == set(ref.state_dict())
    w, h = model_cfg["IMAGE_SIZE"]
    images = inputs.smooth_images(inputs.generator(7, 1, "cpu"), 2, h, w,
                                  "cpu")
    x = ref_serve.normalize(images)
    for train in (False, True):
        port.train(train)
        ref.train(train)
        with torch.no_grad():
            out = port(x)
            got = out[-1] if ref.multi_output else out
            want = ref_models.final_heatmaps(ref, x)
        scale = want.abs().max()
        assert float((got - want).abs().max() / scale) < 1e-4


def test_keypoint_gaps_of_the_reference_decode():
    """The reference's own decode of its heatmaps reads no gap; a joint
    moved to another joint's place does."""
    rng = np.random.default_rng(3)
    hm = rng.normal(size=(4, 3, 16, 12)).astype(np.float32)
    centers = rng.uniform(100, 500, (4, 2))
    scales = np.stack([rng.uniform(0.5, 2, 4) * 0.75,
                       rng.uniform(0.5, 2, 4)], -1)
    preds, maxvals = ref_serve.decode(hm, centers, scales)
    gaps = ref_serve.keypoint_gaps(hm, preds, maxvals, centers, scales, 0.0)
    assert gaps["peak_gap"] == 0 and gaps["conf_gap"] == 0
    assert gaps["coord_gap"] < 1e-9
    rolled = ref_serve.keypoint_gaps(hm, np.roll(preds, 1, 1),
                                     np.roll(maxvals, 1, 1), centers, scales,
                                     0.0)
    assert rolled["peak_gap"] > 0.1


def test_leaf_rule_keeps_moving_leaves():
    from portbench.loops.train import NOUGHT, gaps
    want = {"loss": [1.0], "grad": {"a": 1.0, "b": 2.0, "bias": 1e-9},
            "delta": {"a": 1.0, "b": 1.0, "bias": 1.0}}
    got = {"loss": [1.0], "grad": {"a": 1.0, "b": 2.0, "bias": 5.0},
           "delta": {"a": 1.0, "b": 1.0, "bias": 0.0}}
    assert NOUGHT * statistics.median(want["grad"].values()) > 1e-9
    assert gaps(got, want) == {"loss_gap": 0.0, "grad_gap": 0.0,
                               "grad_median_gap": 0.0, "delta_gap": 0.0}
    got["delta"]["a"] = 0.0
    got["grad"]["b"] = 1.0
    out = gaps(got, want)
    assert out["delta_gap"] == 1.0 and out["grad_gap"] == 0.5
    assert out["grad_median_gap"] == 0.25
