"""Port Predictor against the fhpe_tpu Predictor on the same weights.

float32 on the CPU, flip test + SHIFT_HEATMAP + POST_PROCESS on, a
non-square input (W 64 x H 128), and 13 crops through a batch of 8, so the
run pads and takes two chunks.  The port decodes with the plain version
of the CUDA kernel here.
"""

import numpy as np
import pytest
import torch

from fhpe_tpu.serve import Predictor as PredictorJax
from fhpe_tpu_torch.ops import decode
from fhpe_tpu_torch.ops.decode_cases import decision_margin
from fhpe_tpu_torch.serve import Predictor
from fhpe_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_hourglass import _cfg, _jax_variables

W, H = 64, 128
N = 13


def _serve_cfg():
    cfg = _cfg(2, 32, joints=16)
    cfg.DATASET.DATASET = "mpii"
    cfg.MODEL.IMAGE_SIZE = [W, H]
    cfg.MODEL.HEATMAP_SIZE = [W // 4, H // 4]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.TEST.POST_PROCESS = True
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = _serve_cfg()
    _, variables = _jax_variables(cfg, (H, W), seed=3)
    rng = np.random.RandomState(0)
    crops = rng.randint(0, 256, size=(N, H, W, 3)).astype(np.uint8)
    centers = rng.uniform(100, 300, size=(N, 2))
    scales = rng.uniform(0.8, 1.6, size=(N, 2))
    port = Predictor(cfg, state_dict_from_jax(cfg, variables), batch_size=8,
                     device="cpu")
    return cfg, variables, port, (crops, centers, scales)


def test_predict_crops_matches_jax_predictor(setup):
    """preds within 1e-3 px, maxvals within 1e-4.

    The forwards differ by float32 rounding (< 1e-4, see
    test_torch_hourglass); the seed is fixed so that every decision the
    decode takes on the merged heatmaps (top-2 gap, neighbour signs,
    peak > 0) has a margin above that, which the test checks first.
    """
    cfg, variables, port, (crops, centers, scales) = setup
    hm = port.merged_heatmaps(torch.from_numpy(crops)).numpy()
    assert decision_margin(hm).min() > 1e-4

    launches = decode.decode_kernel_launches
    preds, maxvals = port.predict_crops(crops, centers, scales)
    assert decode.decode_kernel_launches == launches   # CPU: plain version
    ref = PredictorJax(cfg, variables, batch_size=8, n_devices=1)
    ref_preds, ref_maxvals = ref.predict_crops(crops, centers, scales)

    assert preds.shape == (N, 16, 2) and preds.dtype == np.float32
    assert maxvals.shape == (N, 16) and maxvals.dtype == np.float32
    np.testing.assert_allclose(preds, ref_preds, rtol=0, atol=1e-3)
    np.testing.assert_allclose(maxvals, ref_maxvals, rtol=0, atol=1e-4)


def test_predict_crops_rejects_bad_input(setup):
    _, _, port, (crops, centers, scales) = setup
    with pytest.raises(ValueError, match="uint8"):
        port.predict_crops(crops.astype(np.float32), centers, scales)
    with pytest.raises(ValueError, match="must be"):
        port.predict_crops(crops[:, :, :W // 2], centers, scales)
    with pytest.raises(ValueError, match="must be"):
        port.predict_crops(crops[0], centers, scales)
    with pytest.raises(ValueError, match="one center and scale per crop"):
        port.predict_crops(crops, centers[:-1], scales)


@pytest.mark.parametrize("layout", ["raw", "module", "state_dict",
                                    "best_state_dict"])
def test_from_checkpoint_layouts(setup, tmp_path, layout):
    cfg, _, port, _ = setup
    sd = port.model.state_dict()
    obj = {"raw": sd,
           "module": {"module." + k: v for k, v in sd.items()},
           "state_dict": {"state_dict": sd, "epoch": 3},
           "best_state_dict": {"best_state_dict": sd, "perf": 0.5}}[layout]
    path = tmp_path / "model.pth"
    torch.save(obj, path)
    loaded = Predictor.from_checkpoint(cfg, str(path), batch_size=8,
                                       device="cpu")
    for k, v in sd.items():
        assert torch.equal(loaded.model.state_dict()[k], v), k


def test_multi_device_serving_not_ported(setup):
    cfg = _serve_cfg()
    cfg.TPU.NUM_DEVICES = 2
    with pytest.raises(NotImplementedError):
        Predictor(cfg, setup[2].model, device="cpu")
