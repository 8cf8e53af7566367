"""The port's model summary (``fhpe_tpu_torch/utils/summary.py``) against
``fhpe_tpu.utils.summary`` on the CPU, on narrow configs.

Parameters must equal ``fhpe_tpu``'s exactly, and the per-module rows
sum to the total.  FLOPs are held to XLA's ``cost_analysis`` within
``FLOPS_RATIO``: the two count differently.  ``FlopCounterMode`` charges
every conv at its full kernel, padding taps included, and counts no
elementwise op; XLA counts only the taps inside the image and counts the
elementwise ops (BatchNorm, ReLU, adds, upsampling).  The first effect
wins where convs dominate (1.027-1.040 at the published widths, measured
when the summary was ported); narrower nets or smaller images tip it
either way (a 16-feature hourglass at 64x64 reads 0.923, ResNet-18 at
128x96 1.145), so the configs here are narrow but keep convs dominant.
"""

import jax
import pytest
import torch

from fhpe_tpu.config import load_config as load_config_jax
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.utils import summary as summary_jax
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.models import get_pose_net, param_count
from fhpe_tpu_torch.tools.train_parity import (HRNET_STUDENT_YAML,
                                               hrnet_fpd_cfgs)
from fhpe_tpu_torch.utils import summary

from torch_threads import torch_threads  # noqa: F401

FLOPS_RATIO = (1.00, 1.05)      # port / XLA
HG_YAML = "experiments/mpii/hourglass/hg4_128_student.yaml"
RN_YAML = "experiments/coco/resnet/res50_256x192.yaml"
CONFIGS = {
    # 1 stack x 64 features at 64x64 (231,664 parameters)
    "hourglass": (HG_YAML, [
        "MODEL.IMAGE_SIZE", "[64,64]", "MODEL.HEATMAP_SIZE", "[16,16]",
        "MODEL.EXTRA.NUM_STACKS", "1", "MODEL.EXTRA.NUM_FEATURES", "64"]),
    # ResNet-50 at 192x144 with 64-filter deconvs
    "pose_resnet": (RN_YAML, [
        "MODEL.IMAGE_SIZE", "[144,192]", "MODEL.HEATMAP_SIZE", "[36,48]",
        "MODEL.EXTRA.NUM_DECONV_FILTERS", "[64,64,64]"]),
    # tools/train_parity.py::hrnet_fpd_cfgs(width=8, blocks=1, modules=1,
    # image_size=128): W8, one block per branch, one module per stage,
    # 128x96
    "hrnet": (str(HRNET_STUDENT_YAML), [
        "MODEL.IMAGE_SIZE", "[96,128]", "MODEL.HEATMAP_SIZE", "[24,32]",
        *[o for s in (2, 3, 4) for o in (
            f"MODEL.EXTRA.STAGE{s}.NUM_CHANNELS",
            str([8 * 2 ** i for i in range(s)]),
            f"MODEL.EXTRA.STAGE{s}.NUM_BLOCKS", str([1] * s),
            f"MODEL.EXTRA.STAGE{s}.NUM_MODULES", "1")]]),
}


def _cfgs(name):
    path, opts = CONFIGS[name]
    return load_config_jax(path, opts), load_config(path, opts)


def _hw(cfg):
    return int(cfg.MODEL.IMAGE_SIZE[1]), int(cfg.MODEL.IMAGE_SIZE[0])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_summary_matches_fhpe_tpu(name):
    cfg_j, cfg = _cfgs(name)
    assert cfg_j.MODEL.to_dict() == cfg.MODEL.to_dict()
    if name == "hrnet":
        assert cfg.MODEL.to_dict() == hrnet_fpd_cfgs(
            "float32", width=8, blocks=1, modules=1,
            image_size=128)[0].MODEL.to_dict()
    ref = summary_jax.get_model_summary(
        get_pose_net_jax(cfg_j, dtype=jax.numpy.float32), _hw(cfg_j),
        per_module_flops=False)
    torch.manual_seed(0)
    model = get_pose_net(cfg)
    got = summary.get_model_summary(model, _hw(cfg))

    assert got["params"] == ref["params"] == param_count(model)
    assert sum(n for _, n in got["modules"]) == got["params"]
    assert [n for n, _ in got["modules"]] == sorted(
        n for n, _ in model.named_children())
    ratio = got["flops"] / ref["flops"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio
    text = got["text"]
    assert f"Total Parameters: {got['params']:,}" in text
    assert f"): {got['flops'] / 1e9:.4g}" in text
    # the per-module table: the model's row, then one per child, whose
    # FLOPs add up to the model's (every op runs inside a child)
    table = got["module_flops_table"].splitlines()[2:]
    assert len(table) == 1 + len(list(model.named_children()))
    gflops = [float(row.split()[-1]) for row in table]
    assert gflops[0] == pytest.approx(got["flops"] / 1e9, abs=1e-4)
    assert sum(gflops[1:]) == pytest.approx(gflops[0], abs=1e-3)


def test_counted_on_a_cpu_copy():
    """A model off the CPU (here on the ``meta`` device, which holds no
    data, as a card's model stands in this process) is counted on a CPU
    copy and left where it is: the same parameters and FLOPs as on the
    CPU, the table as for the CPU model, and the model's tensors still
    its own.  The count reads no value: zeroed weights count the same."""
    _, cfg = _cfgs("hourglass")
    torch.manual_seed(0)
    model = get_pose_net(cfg)
    on_cpu = summary.get_model_summary(model, _hw(cfg))
    far = model.to("meta")
    params = [id(p) for p in far.parameters()]
    got = summary.get_model_summary(far, _hw(cfg))
    for key in ("params", "flops", "modules", "module_flops_table"):
        assert got[key] == on_cpu[key], key
    assert [id(p) for p in far.parameters()] == params
    assert all(p.device.type == "meta" for p in far.parameters())
    total, per = summary.count_flops(far, torch.zeros(2, 3, 64, 64),
                                     train=True)
    assert total == 2 * on_cpu["flops"] and per[""] == total


def test_failed_count_warns_and_goes_on(caplog):
    """A count that fails logs a warning; the summary keeps the
    parameters and says the FLOPs are unavailable."""
    _, cfg = _cfgs("hourglass")
    model = get_pose_net(cfg)
    got = summary.get_model_summary(model, (7, 9))      # not a multiple
    assert got["flops"] is None and got["module_flops_table"] is None
    assert got["params"] == param_count(model)
    assert "Forward GFLOPs: unavailable" in got["text"]
    assert "FLOPs unavailable" in caplog.text
    assert summary.per_module_flops_table(model, torch.zeros(1, 3, 7, 9)) \
        is None
    assert "per-module FLOPs table unavailable" in caplog.text
