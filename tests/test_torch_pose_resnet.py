"""Port PoseResNet against fhpe_tpu on the CPU: parameter counts, the
weight-name contract (``import_pose_resnet`` round trip), the eval and
train-mode forwards with the running statistics, one plain train step
(``make_train_step``, Adam lr 1e-3), the eval step, the Predictor with
COCO evaluation, and the bf16 dtype flow.

PoseResNet-50's trunk at full width (its 3x3 stride-1 convs go through
the conv3x3_fwd wrapper, which takes its plain version here) with narrow
deconvs (32 filters), ``res50_256x192_d256x3_adam_lr1e-3.yaml`` otherwise,
at 96 x 64 (the trunk halves each side five times, so both sides are
multiples of 32) and batch 2.  He-scale weights with BN statistics from
one batch (``he_scale_weights``), carried to fhpe_tpu by
``import_pose_resnet``.  Forwards and the train step compare in float64
on both sides, as ``test_torch_train.py`` does and for its reason; the
serving and eval paths in float32.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhpe_tpu.cli.common import make_evaluate_fn as make_evaluate_fn_jax
from fhpe_tpu.config import load_config as load_config_jax
from fhpe_tpu.geometry.flip import flip_pair_permutation
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.parallel.mesh import shard_batch
from fhpe_tpu.serve import Predictor as PredictorJax
from fhpe_tpu.train import step as step_jax
from fhpe_tpu.utils.torch_import import import_pose_resnet
from fhpe_tpu_torch.cli.common import make_evaluate_fn
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.data import COCO_FLIP_PAIRS
from fhpe_tpu_torch.data.coco_synthetic import (gt_boxes, synthetic_coco_gt,
                                                synthetic_train_batch,
                                                write_coco_gt)
from fhpe_tpu_torch.models import (get_pose_net, is_multi_output,
                                   param_count)
from fhpe_tpu_torch.models import common
from fhpe_tpu_torch.models.common import bf16_flow_violations, he_scale_weights
from fhpe_tpu_torch.ops.decode_cases import decision_margin
from fhpe_tpu_torch.serve import Predictor
from fhpe_tpu_torch.train import (create_train_state, make_batch_preprocessor,
                                  make_eval_step, make_train_step)
from fhpe_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_train import (SMALL_GRAD, X64_RTOL, _check_stats, _f64,
                              _held, _jax_state, _nchw, _nchw_batch,
                              _port_model, _to_torch, _torch_sd, mesh,
                              x64)  # noqa: F401
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RN50_YAML = os.path.join(
    REPO, "experiments/coco/resnet/res50_256x192_d256x3_adam_lr1e-3.yaml")
H, W, B, J = 96, 64, 2, 17
IMAGE_SET = "val2017"
# float32 forwards: two convolution libraries sum in another order; the
# heatmaps of ~50 layers then differ by a few 1e-6 of their largest value.
F32_HM_RTOL = 5e-5
# Adam's first step moves a parameter by lr * g / (|g| + 1e-8): where |g|
# is near 1e-8 (live elements reach 1e-6 of a tensor's max|g|) it turns an
# absolute difference d in g into up to lr * d / 1e-8.  RN-50's float64
# gradients differ by ~1e-17 there (moments within X64_RTOL), so updated
# parameters are held to 1e-7 of lr (measured 2.3e-9).
X64_PARAM_RTOL = 1e-7


def _opts(layers, dtype):
    return ["MODEL.IMAGE_SIZE", f"[{W},{H}]",
            "MODEL.HEATMAP_SIZE", f"[{W // 4},{H // 4}]",
            "MODEL.EXTRA.NUM_LAYERS", str(layers),
            "MODEL.EXTRA.NUM_DECONV_FILTERS", "[32,32,32]",
            "TPU.COMPUTE_DTYPE", dtype, "TPU.NUM_DEVICES", "1"]


def _both(layers=50, dtype="float64"):
    """(fhpe_tpu config, port config) of the RN-50 yaml cut to narrow
    deconvs at 96 x 64."""
    return tuple(load(RN50_YAML, _opts(layers, dtype))
                 for load in (load_config_jax, load_config))


def _weights(cfg_t, seed):
    """He-scale weights as a port state_dict and as fhpe_tpu variables."""
    sd = he_scale_weights(get_pose_net(cfg_t), seed, (H, W))
    extra = cfg_t.MODEL.EXTRA
    return sd, import_pose_resnet({k: v.numpy() for k, v in sd.items()},
                                  extra.NUM_LAYERS, extra.NUM_DECONV_LAYERS,
                                  extra.DECONV_WITH_BIAS)


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- structure ------------------------------------------------------------------

@pytest.mark.parametrize("layers", [18, 34, 50, 101, 152])
def test_param_count_matches_jax(layers):
    """The port's count equals fhpe_tpu's for every depth at the configs'
    full width (33,999,697 for RN-50, the number tests/test_models.py
    pins); the reference's state_dict names; one heatmap tensor."""
    cfg = load_config(RN50_YAML, ["MODEL.EXTRA.NUM_LAYERS", str(layers)])
    with torch.device("meta"):
        model = get_pose_net(cfg)
    shapes = jax.eval_shape(lambda: get_pose_net_jax(
        cfg, dtype=jnp.float32).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3)), train=False))
    ref = sum(int(np.prod(s.shape))
              for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert param_count(model) == ref
    if layers == 50:
        assert ref == 33_999_697
    keys = set(model.state_dict())
    assert {"conv1.weight", "bn1.running_var",
            "layer4.0.downsample.1.running_mean", "deconv_layers.0.weight",
            "deconv_layers.7.bias", "final_layer.bias"} <= keys
    # layer1 projects 64 -> 256 channels in Bottleneck nets only
    assert ("layer1.0.downsample.0.weight" in keys) == (layers >= 50)
    assert not any(k.startswith("deconv_layers.2.") for k in keys)
    assert not is_multi_output(model)


@pytest.mark.parametrize("layers", [18, 50])
def test_state_dict_round_trip(layers):
    """import_pose_resnet(port.state_dict()) consumes every key and
    rebuilds the flax tree exactly; state_dict_from_jax inverts it exactly
    (strict), transposed-conv kernels included."""
    _, cfg = _both(layers, "float32")
    model = get_pose_net_jax(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), train=False))
    rng = np.random.RandomState(layers)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))
    port = get_pose_net(cfg)
    port.load_state_dict(state_dict_from_jax(cfg, variables))   # strict
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _leaves_equal(import_pose_resnet(sd, layers), variables)

    fresh = he_scale_weights(port, 1, (H, W))
    back = state_dict_from_jax(cfg, import_pose_resnet(
        {k: v.numpy() for k, v in fresh.items()}, layers))
    assert back.keys() == fresh.keys()
    for k in fresh:
        assert torch.equal(back[k], fresh[k]), k


def test_reference_init():
    """normal(0, 0.001) conv and transposed-conv kernels, zero final bias,
    BN 1 / 0."""
    port = get_pose_net(_both(18, "float32")[1])
    w = torch.cat([m.weight.flatten() for m in port.modules()
                   if isinstance(m, (torch.nn.Conv2d,
                                     torch.nn.ConvTranspose2d))])
    assert 0.0008 < w.std().item() < 0.0012
    assert torch.equal(port.final_layer.bias, torch.zeros(J))
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))


# -- forwards ----------------------------------------------------------------------

def test_rn50_eval_and_train_forward_match_jax(x64):
    """float64: the eval-mode heatmaps, then one train-mode forward's
    heatmaps and every running statistic (Bessel-corrected variance,
    momentum 0.1), held to X64_RTOL of each tensor's max; the 13 stride-1
    3x3 convs run through the conv3x3_fwd wrapper in both."""
    cfg_j, cfg_t = _both()
    sd, variables = _weights(cfg_t, 5)
    variables = _f64(variables)
    x = np.random.RandomState(6).randn(B, H, W, 3)
    model_j = get_pose_net_jax(cfg_j, dtype=jnp.float64)
    tree = jax.tree_util.tree_map(jnp.asarray, variables)
    ref_eval = model_j.apply(tree, jnp.asarray(x), train=False)
    ref_train, mutated = model_j.apply(tree, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])

    model = _port_model(cfg_t, variables, torch.float64)
    xt = torch.from_numpy(_nchw(x).copy())
    with mock.patch.object(common, "conv3x3_fwd",
                           wraps=common.conv3x3_fwd) as fwd, torch.no_grad():
        out_eval = model.eval()(xt)
        out_train = model.train()(xt)
    assert fwd.call_count == 2 * 13
    assert out_eval.shape == (B, J, H // 4, W // 4)
    assert out_eval.dtype == torch.float64
    scale = float(np.abs(np.asarray(ref_eval)).max())
    assert 1e-2 < scale < 1e3     # not ~0 (reference init), not blown up
    _held(out_eval, torch.from_numpy(_nchw(ref_eval).copy()), X64_RTOL,
          "eval heatmaps")
    _held(out_train, torch.from_numpy(_nchw(ref_train).copy()), X64_RTOL,
          "train heatmaps")
    _check_stats(cfg_t, model, variables["params"], mutated["batch_stats"])


def test_rn18_eval_forward_matches_jax():
    """BASIC blocks (RN-18), float32, eval mode: heatmaps within
    F32_HM_RTOL of the largest."""
    _, cfg_t = _both(18, "float32")
    sd, variables = _weights(cfg_t, 7)
    x = np.random.RandomState(8).randn(B, H, W, 3).astype(np.float32)
    ref = np.asarray(get_pose_net_jax(cfg_t, dtype=jnp.float32).apply(
        variables, jnp.asarray(x), train=False))
    port = get_pose_net(cfg_t).eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        out = port(torch.from_numpy(_nchw(x).copy()))
    scale = np.abs(ref).max()
    assert 1e-2 < scale < 1e3
    np.testing.assert_allclose(out.numpy(), _nchw(ref), rtol=0,
                               atol=F32_HM_RTOL * scale)


def test_bf16_dtype_flow():
    """Under the port's bf16 autocast every conv (the routed 3x3s too),
    transposed conv, BN and block takes and emits bf16 (the stem conv
    takes the float32 image); the heatmaps come out float32."""
    _, cfg = _both(50, "bfloat16")
    port = get_pose_net(cfg).eval()
    checked, bad = bf16_flow_violations(port, torch.randn(B, 3, H, W))
    assert checked == 1 + sum(isinstance(m, (
        torch.nn.Conv2d, torch.nn.BatchNorm2d, *port.flow_blocks))
        for m in port.modules())
    assert bad == []


# -- the plain train step -------------------------------------------------------------

def test_rn50_train_step_matches_jax(mesh, x64):
    """One float64 make_train_step (Adam lr 1e-3, joints MSE with target
    weights) from the same weights and batch: loss, accuracy and per-joint
    accuracy, BN running statistics, Adam's moments and the updated
    parameters."""
    cfg_j, cfg_t = _both()
    assert cfg_t.TRAIN.OPTIMIZER == "adam" and float(cfg_t.TRAIN.LR) == 1e-3
    _, variables = _weights(cfg_t, 11)
    variables = _f64(variables)
    batch = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(v)
         for k, v in synthetic_train_batch(B, 12, (W, H)).items()})
    batch = {k: np.asarray(batch[k])
             for k in ("image", "target", "target_weight")}

    model_j, state_j = _jax_state(cfg_j, variables, jnp.float64)
    step_j = step_jax.make_train_step(model_j, cfg_j, mesh, False,
                                      debug_outputs=True)
    state_j, m_j = step_j(state_j, shard_batch(
        mesh, {k: jnp.asarray(v) for k, v in batch.items()}))

    state_t = create_train_state(
        cfg_t, _port_model(cfg_t, variables, torch.float64), device="cpu")
    state_t, m_t = make_train_step(cfg_t)(state_t, _nchw_batch(batch))
    assert state_t.step == int(state_j.step) == 1

    np.testing.assert_allclose(m_t["loss"].item(), float(m_j["loss"]),
                               rtol=X64_RTOL)
    assert decision_margin(_nchw(m_j["output"])).min() > 1e-6
    np.testing.assert_array_equal(m_t["per_joint_acc"].numpy(),
                                  np.asarray(m_j["per_joint_acc"]))
    assert m_t["acc"].item() == pytest.approx(float(m_j["acc"]), abs=1e-6)
    _check_stats(cfg_t, state_t.model, state_j.params, state_j.batch_stats)

    inner = state_j.opt_state.inner_state[0]
    mu, nu = (_torch_sd(cfg_t, jax.tree_util.tree_map(np.asarray, m),
                        state_j.batch_stats) for m in (inner.mu, inner.nu))
    p_ref = _torch_sd(cfg_t, state_j.params, state_j.batch_stats)
    opt = state_t.optimizer.state_dict()["state"]
    lr = float(cfg_t.TRAIN.LR)
    for i, (name, p) in enumerate(state_t.model.named_parameters()):
        assert float(opt[i]["step"]) == int(inner.count) == 1
        _held(opt[i]["exp_avg"], mu[name], X64_RTOL, f"{name} exp_avg")
        _held(opt[i]["exp_avg_sq"], nu[name], X64_RTOL, f"{name} exp_avg_sq")
        live = mu[name].abs() >= SMALL_GRAD * mu[name].abs().max()
        assert live.any(), name
        diff = (p.detach() - p_ref[name]).abs()[live]
        assert (diff <= X64_PARAM_RTOL * lr).all(), (name, diff.max().item())


def test_create_train_state_for_rn50():
    cfg = load_config(RN50_YAML)
    state = create_train_state(cfg, seed=0, device="cpu")
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.optimizer.defaults["lr"] == pytest.approx(1e-3)
    assert state.model.training and state.step == 0
    assert sum(getattr(m, "fwd_kernel", False)
               for m in state.model.modules()) == 13


# -- evaluation and serving ---------------------------------------------------------

def test_rn50_eval_step_matches_jax(mesh):
    """float32, flip test with COCO's flip pairs, SHIFT_HEATMAP and
    POST_PROCESS, a padded tail (the last row invalid): preds, maxvals,
    loss, hits, valids."""
    cfg_j, cfg_t = _both(50, "float32")
    sd, variables = _weights(cfg_t, 44)
    raw = synthetic_train_batch(3, 34, (W, H))
    inv = np.tile(np.array([[2.0, 0.1, 0.0], [-0.1, 2.0, 0.0]], np.float32),
                  (3, 1, 1))
    inv[:, :, 2] = np.random.RandomState(33).uniform(0, 100, (3, 2))
    valid = np.array([1, 1, 0], np.float32)
    perm = flip_pair_permutation(J, COCO_FLIP_PAIRS)

    batch_j = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(v) for k, v in raw.items()})
    batch_j.update(inv_trans=jnp.asarray(inv), valid=jnp.asarray(valid))
    out_j = step_jax.make_eval_step(
        get_pose_net_jax(cfg_j, dtype=jnp.float32), cfg_j, mesh, False, perm,
        debug_outputs=True)(variables, shard_batch(mesh, {
            k: np.asarray(v) for k, v in batch_j.items()}))

    model = get_pose_net(cfg_t)
    model.load_state_dict(sd)
    batch_t = dict(_to_torch(raw), inv_trans=torch.from_numpy(inv),
                   valid=torch.from_numpy(valid))
    out_t = make_eval_step(cfg_t, perm, prepare=make_batch_preprocessor(
        cfg_t))(model, batch_t)
    assert decision_margin(_nchw(out_j["output"])).min() > 1e-4
    np.testing.assert_allclose(out_t["preds"].numpy(),
                               np.asarray(out_j["preds"]), rtol=0, atol=1e-3)
    scale = np.abs(np.asarray(out_j["maxvals"])).max()
    np.testing.assert_allclose(out_t["maxvals"].numpy(),
                               np.asarray(out_j["maxvals"]), rtol=0,
                               atol=F32_HM_RTOL * scale)
    np.testing.assert_allclose(out_t["loss"].item(), float(out_j["loss"]),
                               rtol=1e-4)
    for key in ("hits", "valids"):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]))


def test_predictor_and_coco_eval_match_jax(tmp_path):
    """float32, flip test on, one crop per ground-truth person of a
    synthetic COCO set at its box, through a batch of 4 (so the last
    chunk pads): the JAX Predictor and the port's give preds within 1e-3
    px and maxvals within F32_HM_RTOL of the largest, and each package's
    make_evaluate_fn the same 10 stats.  The ground truth is the JAX
    Predictor's keypoints plus 3 px of noise, so the stats lie between 0
    and 1 and turn on the predictions."""
    _, cfg = _both(50, "float32")
    cfg.defrost()
    cfg.DATASET.ROOT = str(tmp_path / "coco")
    cfg.DATASET.TEST_SET = IMAGE_SET
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.TEST.POST_PROCESS = True
    sd, variables = _weights(cfg, 4)
    gt = synthetic_coco_gt(4, seed=2)
    write_coco_gt(cfg.DATASET.ROOT, IMAGE_SET, gt)
    boxes, paths = gt_boxes(gt, cfg.DATASET.ROOT, IMAGE_SET, W / H)
    crops = np.random.RandomState(5).randint(
        0, 256, size=(len(boxes), H, W, 3)).astype(np.uint8)

    port = Predictor(cfg, sd, batch_size=4, device="cpu")
    hm = port.merged_heatmaps(torch.from_numpy(crops)).numpy()
    assert decision_margin(hm).min() > 1e-4
    preds, maxvals = port.predict_crops(crops, boxes[:, :2], boxes[:, 2:4])
    ref = PredictorJax(cfg, variables, batch_size=4, n_devices=1)
    ref_preds, ref_maxvals = ref.predict_crops(crops, boxes[:, :2],
                                               boxes[:, 2:4])
    assert len(boxes) % 4 != 0
    np.testing.assert_allclose(preds, ref_preds, rtol=0, atol=1e-3)
    np.testing.assert_allclose(maxvals, ref_maxvals, rtol=0,
                               atol=F32_HM_RTOL * np.abs(ref_maxvals).max())

    truth = json.loads(json.dumps(gt))
    noise = np.random.RandomState(6).normal(scale=3.0, size=ref_preds.shape)
    for a, kp in zip(truth["annotations"], ref_preds + noise):
        g = np.asarray(a["keypoints"]).reshape(-1, 3)
        g[:, :2] = np.where(g[:, 2:] > 0, kp, 0)
        a["keypoints"] = g.reshape(-1).tolist()
    write_coco_gt(cfg.DATASET.ROOT, IMAGE_SET, truth)
    nv, _ = make_evaluate_fn(cfg, device="cpu")(
        cfg, np.concatenate([preds, maxvals[..., None]], -1),
        str(tmp_path / "port"), boxes, paths)
    nv_ref, _ = make_evaluate_fn_jax(cfg)(
        cfg, np.concatenate([ref_preds, ref_maxvals[..., None]], -1),
        str(tmp_path / "jax"), boxes, paths)
    assert len(nv) == 10 and list(nv.items()) == list(nv_ref.items())
    assert 0.05 < nv["AP"] < 1.0
