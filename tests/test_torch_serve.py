"""Port Predictor against the fhpe_tpu Predictor on the same weights.

float32 on the CPU, flip test + SHIFT_HEATMAP + POST_PROCESS on, a
non-square input (W 64 x H 128), and 13 crops (or boxes of one frame)
through a batch of 8, so the run pads and takes two chunks.  The port
decodes with the plain version of the CUDA kernel here, and runs its
double-buffered chunk pipeline without streams or pinned memory.
``fhpe_tpu``'s config sets ``TPU.NATIVE_WARP``, so its ``crop`` takes the
C warp the port's crop shares.

Serving over several devices: two CPU replicas with a global batch of 8
against ``fhpe_tpu``'s Predictor on a 2-device slice of the tests' CPU
mesh, built by its ``from_checkpoint`` from the ``final_state.msgpack``
that ``fhpe_tpu``'s checkpoint writer made of the same weights.
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fhpe_tpu.serve import Predictor as PredictorJax
from fhpe_tpu.serve.predictor import \
    xywh_to_center_scale as xywh_to_center_scale_jax
from fhpe_tpu.utils.checkpoint import FINAL_NAME as FINAL_NAME_JAX
from fhpe_tpu.utils.checkpoint import \
    save_final_state as save_final_state_jax
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.ops import decode
from fhpe_tpu_torch.ops.decode import make_inverse_transforms
from fhpe_tpu_torch.ops.decode_cases import decision_margin
from fhpe_tpu_torch.serve import Predictor
from fhpe_tpu_torch.serve.predictor import (replica_devices,
                                            xywh_to_center_scale)
from fhpe_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_hourglass import _cfg, _jax_variables
from torch_threads import torch_threads  # noqa: F401

W, H = 64, 128
N = 13
FRAME_HW = (180, 240)


def _serve_cfg():
    cfg = _cfg(2, 32, joints=16)
    cfg.DATASET.DATASET = "mpii"
    cfg.MODEL.IMAGE_SIZE = [W, H]
    cfg.MODEL.HEATMAP_SIZE = [W // 4, H // 4]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.TEST.POST_PROCESS = True
    cfg.TPU.NATIVE_WARP = True
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


@pytest.fixture(scope="module")
def ref(setup):
    """fhpe_tpu's Predictor on the same weights (one jit for the module)."""
    cfg, variables = setup[:2]
    return PredictorJax(cfg, variables, batch_size=8, n_devices=1)


@pytest.fixture(scope="module")
def frame():
    """A noise frame and N person boxes near the crop's own scale, some
    across the frame's left and top borders.  Seeded so that the decode's
    decisions on the crops keep a margin (see the crops test)."""
    rng = np.random.RandomState(2)
    image = rng.randint(0, 256, size=FRAME_HW + (3,)).astype(np.uint8)
    h, w = FRAME_HW
    boxes = [(rng.uniform(-10, w - 40), rng.uniform(-10, h - 80),
              rng.uniform(40, 56), rng.uniform(80, 110)) for _ in range(N)]
    return image, boxes


def test_predict_crops_matches_jax_predictor(setup, ref):
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
                                    "best_state_dict", "numpy_perf"])
def test_from_checkpoint_layouts(setup, tmp_path, layout):
    """Every ``.pth`` layout, the reference's checkpoint with a numpy
    ``perf`` among them (torch's weights-only unpickler refuses that
    scalar unless it is allowed, as ``load_model_weights`` allows it)."""
    cfg, _, port, _ = setup
    sd = port.model.state_dict()
    obj = {"raw": sd,
           "module": {"module." + k: v for k, v in sd.items()},
           "state_dict": {"state_dict": sd, "epoch": 3},
           "best_state_dict": {"best_state_dict": sd, "perf": 0.5},
           "numpy_perf": {"epoch": 3, "state_dict": sd,
                          "perf": np.float64(0.5)}}[layout]
    path = tmp_path / "model.pth"
    torch.save(obj, path)
    loaded = Predictor.from_checkpoint(cfg, str(path), batch_size=8,
                                       device="cpu")
    for k, v in sd.items():
        assert torch.equal(loaded.model.state_dict()[k], v), k


@pytest.fixture(scope="module")
def jax_file(setup, tmp_path_factory):
    """``fhpe_tpu``'s ``final_state.msgpack`` of the module's weights."""
    out = tmp_path_factory.mktemp("jax_run")
    variables = setup[1]
    save_final_state_jax(str(out), SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]))
    return str(out / FINAL_NAME_JAX)


@pytest.fixture(scope="module")
def ref2(setup, jax_file):
    """fhpe_tpu's Predictor over 2 devices, from its own file."""
    return PredictorJax.from_checkpoint(setup[0], jax_file, batch_size=8,
                                        n_devices=2)


@pytest.fixture(scope="module")
def port2(setup):
    """Two CPU replicas, global batch 8, from the state_dict."""
    cfg, variables = setup[:2]
    return Predictor(cfg, state_dict_from_jax(cfg, variables), batch_size=8,
                     device="cpu", n_devices=2)


def test_two_replicas_predict_crops(setup, ref2, port2):
    """13 crops through a global batch of 8 on two replicas (4 rows each,
    two chunks; replica 1's second shard one crop and three rows of
    padding): within the crops test's bars of fhpe_tpu's 2-device
    Predictor, and bit-equal to one replica of batch 4, which runs the
    same rows in the same batches."""
    cfg, _, port, (crops, centers, scales) = setup
    assert port2.devices == [torch.device("cpu")] * 2
    assert port2.models[1] is not port2.models[0]
    assert len(port2.steps) == 2 and port2.step is port2.steps[0]
    preds, maxvals = port2.predict_crops(crops, centers, scales)
    ref_preds, ref_maxvals = ref2.predict_crops(crops, centers, scales)
    assert preds.shape == (N, 16, 2) and maxvals.shape == (N, 16)
    np.testing.assert_allclose(preds, ref_preds, rtol=0, atol=1e-3)
    np.testing.assert_allclose(maxvals, ref_maxvals, rtol=0, atol=1e-4)

    one = Predictor(cfg, port.model, batch_size=4, device="cpu")
    one_preds, one_maxvals = one.predict_crops(crops, centers, scales)
    np.testing.assert_array_equal(preds, one_preds)
    np.testing.assert_array_equal(maxvals, one_maxvals)


def test_two_replicas_predict(setup, ref2, port2, frame):
    """``predict`` on a frame, two replicas against fhpe_tpu's 2-device
    Predictor (the crops test's bars) and bit-equal to one replica of
    batch 4."""
    image, boxes = frame
    got = port2.predict(image, boxes)
    want = ref2.predict(image, boxes)
    assert got.shape == (N, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-4)
    one = Predictor(setup[0], setup[2].model, batch_size=4, device="cpu")
    np.testing.assert_array_equal(got, one.predict(image, boxes))


def test_from_checkpoint_msgpack(setup, ref2, port2, jax_file):
    """``Predictor.from_checkpoint`` on the ``.msgpack`` fhpe_tpu wrote:
    the weights of the state_dict exactly, so the predictions of the
    Predictor built from it bit for bit, and fhpe_tpu's own
    ``from_checkpoint`` on the same file within the crops test's bars."""
    cfg, _, _, (crops, centers, scales) = setup
    loaded = Predictor.from_checkpoint(cfg, jax_file, batch_size=8,
                                       device="cpu", n_devices=2)
    want = port2.model.state_dict()
    got = loaded.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    preds, maxvals = loaded.predict_crops(crops, centers, scales)
    p2, v2 = port2.predict_crops(crops, centers, scales)
    np.testing.assert_array_equal(preds, p2)
    np.testing.assert_array_equal(maxvals, v2)
    ref_preds, ref_maxvals = ref2.predict_crops(crops, centers, scales)
    np.testing.assert_allclose(preds, ref_preds, rtol=0, atol=1e-3)
    np.testing.assert_allclose(maxvals, ref_maxvals, rtol=0, atol=1e-4)


@pytest.mark.parametrize("max_in_flight", [0, 1, 2])
def test_two_replicas_reuse_slots(setup, max_in_flight):
    """Two replicas of 2 rows each (global batch 4): 13 crops take 4
    chunks through at most 3 host slots, under fast thread switching,
    bit-equal to one replica of batch 2 whatever the number of results
    left waiting."""
    cfg, _, port, (crops, centers, scales) = setup
    two = Predictor(cfg, port.model, batch_size=4, device="cpu",
                    n_devices=2)
    one = Predictor(cfg, port.model, batch_size=2, device="cpu")
    want = one.predict_crops(crops, centers, scales)
    two.max_in_flight = max_in_flight
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = two.predict_crops(crops, centers, scales)
    finally:
        sys.setswitchinterval(interval)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_batch_must_divide_over_devices(setup):
    """The text of fhpe_tpu's refusal."""
    cfg, variables, port, _ = setup
    with pytest.raises(ValueError, match="must divide") as e:
        Predictor(cfg, port.model, batch_size=7, device="cpu", n_devices=2)
    with pytest.raises(ValueError) as e_jax:
        PredictorJax(cfg, variables, batch_size=7, n_devices=2)
    assert str(e.value) == str(e_jax.value)


@pytest.mark.parametrize("num_devices,device,n_devices,want", [
    (-1, "cpu", None, ["cpu"]),
    (2, "cpu", None, ["cpu", "cpu"]),
    (-1, "cpu", 3, ["cpu"] * 3),
    (-1, "cuda:1", None, ["cuda:1"]),
    (3, "cuda", None, ["cuda:0", "cuda:1", "cuda:2"]),
    (2, "cuda:1", None, ["cuda:1", "cuda:2"]),
    (4, ["cuda:0", "cuda:0"], None, ["cuda:0", "cuda:0"]),
])
def test_replica_devices(num_devices, device, n_devices, want):
    """``n_devices``, else ``TPU.NUM_DEVICES`` when > 0; a sequence means
    exactly its devices."""
    cfg = _serve_cfg()
    cfg.TPU.NUM_DEVICES = num_devices
    got = replica_devices(cfg, device, n_devices)
    assert got == [torch.device(d) for d in want]


def test_replica_devices_refusals(monkeypatch):
    cfg = _serve_cfg()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no device"):
        replica_devices(cfg, "cuda")            # every visible GPU: none
    with pytest.raises(ValueError, match="one kind of device"):
        replica_devices(cfg, ["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="n_devices 3"):
        replica_devices(cfg, ["cpu", "cpu"], 3)


def test_num_devices_default(setup):
    """``TPU.NUM_DEVICES`` -1 on the CPU: one replica of
    ``TEST.BATCH_SIZE_PER_GPU``; 2: two, and the global batch doubles."""
    cfg = _serve_cfg()
    per = int(cfg.TEST.BATCH_SIZE_PER_GPU)
    assert int(cfg.TPU.NUM_DEVICES) == -1
    p = Predictor(cfg, setup[2].model, device="cpu")
    assert len(p.devices) == 1 and p.batch_size == per
    cfg.TPU.NUM_DEVICES = 2
    p = Predictor(cfg, setup[2].model, device="cpu")
    assert len(p.models) == 2 and p.batch_size == 2 * per


def test_xywh_to_center_scale_matches_jax():
    for box in [(10, 20, 100, 50), (0, 0, 30, 300), (5, 5, 64, 64),
                (-12.5, 3.25, 7, 9)]:
        for got, want in zip(xywh_to_center_scale(box, W / H),
                             xywh_to_center_scale_jax(box, W / H)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_crop_bit_equal_to_jax(setup, ref, frame):
    """``crop`` against fhpe_tpu's ``TPU.NATIVE_WARP`` crop: bit-equal,
    boxes across the frame's borders included."""
    port = setup[2]
    image, boxes = frame
    for box in boxes:
        c, s = xywh_to_center_scale(box, port.aspect_ratio)
        got = port.crop(image, c, s)
        assert got.shape == (H, W, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref.crop(image, c, s))


def test_predict_matches_jax_predictor(setup, ref, frame):
    """``predict`` on a frame against fhpe_tpu's: preds within 1e-3 px,
    confidences within 1e-4 (the bars of the crops test, with its
    decision-margin check first), and equal to ``predict_crops`` of
    ``crop``'s crops, which crops everything first."""
    cfg, _, port, _ = setup
    image, boxes = frame
    cs = [xywh_to_center_scale(b, port.aspect_ratio) for b in boxes]
    centers = np.stack([c for c, _ in cs])
    scales = np.stack([s for _, s in cs])
    crops = np.stack([port.crop(image, c, s) for c, s in cs])
    hm = port.merged_heatmaps(torch.from_numpy(crops)).numpy()
    assert decision_margin(hm).min() > 1e-4

    got = port.predict(image, boxes)
    assert got.shape == (N, 16, 3) and got.dtype == np.float32
    preds, maxvals = port.predict_crops(crops, centers, scales)
    np.testing.assert_array_equal(got[..., :2], preds)
    np.testing.assert_array_equal(got[..., 2], maxvals)
    want = ref.predict(image, boxes)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-4)


def test_predict_empty_and_bad_frames(setup):
    port = setup[2]
    image = np.zeros(FRAME_HW + (3,), np.uint8)
    out = port.predict(image, [])
    assert out.shape == (0, 16, 3) and out.dtype == np.float32
    preds, maxvals = port.predict_crops(np.zeros((0, H, W, 3), np.uint8),
                                        np.zeros((0, 2)), np.zeros((0, 2)))
    assert preds.shape == (0, 16, 2) and maxvals.shape == (0, 16)
    with pytest.raises(ValueError, match="uint8"):
        port.predict(image.astype(np.float32), [(0, 0, 10, 10)])
    with pytest.raises(ValueError, match="uint8"):
        port.predict(image[..., 0], [(0, 0, 10, 10)])


@pytest.mark.parametrize("batch,max_in_flight",
                         [(8, 1), (8, 2), (2, 1), (8, 0), (2, 0)])
def test_pipelined_predict_crops_equals_serial_steps(setup, batch,
                                                     max_in_flight):
    """The double-buffered pipeline against the step run chunk by chunk on
    zero-padded batches (the loop it replaced): bit-equal, N = 13, whatever
    the number of results left waiting.  Batch 2 reuses each of its two
    slots three times; the interpreter switches threads every 10 us, so
    that a slot refilled before its chunk was read would show."""
    cfg, _, port, (crops, centers, scales) = setup
    port = Predictor(cfg, port.model, batch_size=batch, device="cpu")
    inv = make_inverse_transforms(centers, scales, port.heatmap_size)
    serial_p, serial_v = [], []
    for lo in range(0, N, batch):
        hi = min(lo + batch, N)
        img = torch.zeros((batch, H, W, 3), dtype=torch.uint8)
        itr = torch.zeros((batch, 2, 3), dtype=torch.float32)
        img[:hi - lo] = torch.from_numpy(crops[lo:hi])
        itr[:hi - lo] = torch.from_numpy(inv[lo:hi])
        out = port.step(port.model, {"image": img, "inv_trans": itr})
        serial_p.append(out["preds"][:hi - lo])
        serial_v.append(out["maxvals"][:hi - lo])
    port.max_in_flight = max_in_flight
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        preds, maxvals = port.predict_crops(crops, centers, scales)
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(preds, torch.cat(serial_p).numpy())
    np.testing.assert_array_equal(maxvals, torch.cat(serial_v).numpy())


def test_flip_pairs_argument(setup):
    """A joint layout outside the registry: both packages refuse it with
    the same text unless ``flip_pairs=`` is given; given, the flip test
    swaps those pairs."""
    cfg = _serve_cfg()
    cfg.MODEL.NUM_JOINTS = 5
    model = get_pose_net(cfg)
    with pytest.raises(ValueError, match="pass flip_pairs= explicitly") as e:
        Predictor(cfg, model, batch_size=8, device="cpu")
    with pytest.raises(ValueError) as e_jax:
        PredictorJax(cfg, {}, batch_size=8, n_devices=1)
    assert str(e.value) == str(e_jax.value)
    port = Predictor(cfg, model, batch_size=8, device="cpu",
                     flip_pairs=[[0, 1], [2, 4]])
    assert port._perm.tolist() == [1, 0, 4, 3, 2]
    hm = port.merged_heatmaps(torch.from_numpy(setup[3][0][:2]))
    assert hm.shape == (2, 5, H // 4, W // 4)
