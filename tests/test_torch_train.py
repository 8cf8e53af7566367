"""The port's training path against fhpe_tpu's on the CPU: losses, the
LR schedule, device preprocessing (targets), one float32 FPD step, one
OHKM + SGD-nesterov step, the eval step, and train-mode BatchNorm.

Tiny hourglasses (student 2 stacks x 16 features, teacher 2 x 32, 64x64
input, 16 MPII joints), the JAX side on a 1-device mesh; inputs and
weights are drawn with numpy and handed to both.  The steps' wgrad and
decode wrappers take their plain versions here (CPU tensors).

The training steps are compared in float64 on both sides (the JAX
package's own parity mode, ``jax.enable_x64``, as
tests/test_trajectory_parity.py does): in float32, train-mode BatchNorm
over a small batch amplifies reduction-order rounding until one step's
gradients are a few percent off (``python3 -m
fhpe_tpu_torch.tools.train_parity --device cpu`` shows it against
float64), so float32 could only be held loosely.  The eval step
(BatchNorm on running statistics) is compared in float32.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhpe_tpu.config import load_config as load_config_jax
from fhpe_tpu.geometry.flip import flip_pair_permutation
from fhpe_tpu.geometry.targets import generate_target_jax
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.parallel.mesh import get_mesh, shard_batch
from fhpe_tpu.train import loss as loss_jax
from fhpe_tpu.train import state as state_jax
from fhpe_tpu.train import step as step_jax
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.data import MPII_FLIP_PAIRS
from fhpe_tpu_torch.geometry.targets import generate_target_torch
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.ops.decode_cases import decision_margin
from fhpe_tpu_torch.train import (create_train_state, lr_for_epoch,
                                  make_batch_preprocessor, make_eval_step,
                                  make_fpd_train_step, make_train_step,
                                  set_lr)
from fhpe_tpu_torch.train import loss as loss_port
from fhpe_tpu_torch.utils.convert import (adam_state_from_jax,
                                          state_dict_from_jax)

from test_torch_hourglass import _jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT_YAML = os.path.join(
    REPO, "experiments/fpd_mpii/hourglass/hg4_128_fpd_student.yaml")
TEACHER_YAML = os.path.join(
    REPO, "experiments/mpii/hourglass/hg8_256x256_teacher.yaml")
EXPERIMENTS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "experiments", "**", "*.yaml"), recursive=True))
HW, J, B = 64, 16, 4

LOSS_RTOL = 1e-5          # float32 loss functions on the same inputs
EVAL_LOSS_RTOL = 1e-4     # float32 eval step: heatmaps differ by ~1e-5
# float64 train steps: sums in another order, ~1e-15 relative per
# reduction, grown through ~60 layers, their backward and train-mode
# BatchNorm; each tensor is held relative to its own max.
X64_RTOL = 1e-9
# Adam's first step moves a parameter by ~lr * sign(g) whatever |g| is, so
# an element whose gradient is a rounding-level near-zero may move the
# other way; parameters are held to X64_RTOL of lr on all but such
# elements (|g| below 1e-6 of the tensor's max|g|, from the JAX side).
SMALL_GRAD = 1e-6


def _cfgs(module, stacks, feats, dtype, yaml):
    """The student yaml (or ``yaml``) cut to a tiny net: same optimizer,
    loss and KD settings; ``DEAD_BIAS_SKIP`` on as ``bench.py`` trains."""
    cfg = module(yaml, [
        "MODEL.IMAGE_SIZE", f"[{HW},{HW}]",
        "MODEL.HEATMAP_SIZE", f"[{HW // 4},{HW // 4}]",
        "MODEL.EXTRA.NUM_STACKS", str(stacks),
        "MODEL.EXTRA.NUM_FEATURES", str(feats),
        "TPU.COMPUTE_DTYPE", dtype, "TPU.DEAD_BIAS_SKIP", "True",
        "TPU.NUM_DEVICES", "1"])
    return cfg


def _both(stacks, feats, yaml=STUDENT_YAML, dtype="float32", **opts):
    cfgs = []
    for load in (load_config_jax, load_config):
        cfg = _cfgs(load, stacks, feats, dtype, yaml)
        cfg.defrost()
        for key, value in opts.items():
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = value
        cfg.freeze()
        cfgs.append(cfg)
    return cfgs


def _raw_batch(seed, b=B):
    """A DEVICE_PREPROCESS batch: uint8 crops, joints (some off the image,
    some invisible), joints_vis."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(-6, HW + 6, (b, J, 2)).astype(np.float32)
    vis = (rng.uniform(size=(b, J)) > 0.15).astype(np.float32)
    image = rng.randint(0, 256, (b, HW, HW, 3)).astype(np.uint8)
    return {"image": image, "joints": joints, "joints_vis": vis}


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


def _nchw_batch(batch):
    """An NHWC {image, target, target_weight} batch as the port takes it."""
    return {"image": torch.from_numpy(_nchw(batch["image"]).copy()),
            "target": torch.from_numpy(_nchw(batch["target"]).copy()),
            "target_weight": torch.tensor(batch["target_weight"])}


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("tw_pose,tw_kd", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_losses_match_jax(tw_pose, tw_kd):
    rng = np.random.RandomState(int(tw_pose) * 2 + int(tw_kd))
    out = rng.rand(3, B, J, 8, 6).astype(np.float32)        # (S, B, J, H, W)
    tgt = rng.rand(B, J, 8, 6).astype(np.float32)
    teacher = rng.rand(B, J, 8, 6).astype(np.float32)
    tw = (rng.rand(B, J) > 0.3).astype(np.float32)
    o, t, tt = (torch.from_numpy(a) for a in (out, tgt, teacher))
    w = torch.from_numpy(tw)
    oj, tj, ttj = (jnp.asarray(np.moveaxis(a, -3, -1))
                   for a in (out, tgt, teacher))
    wj = jnp.asarray(tw)

    def close(got, ref):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=LOSS_RTOL, atol=0)

    got = loss_port.fpd_loss(o, tt, t, w, 0.5, tw_pose, tw_kd)
    ref = loss_jax.fpd_loss(oj, ttj, tj, wj, 0.5, tw_pose, tw_kd)
    for g, r in zip(got, ref):
        close(g, r)
    close(loss_port.stacked_mse_loss(o[0], t, w),
          loss_jax.stacked_mse_loss(oj[0], tj, wj))
    close(loss_port.joints_mse_loss(o, t, None),
          loss_jax.joints_mse_loss(oj, tj, None))
    for topk in (1, 8, J):
        close(loss_port.stacked_ohkm_loss(o, t, w, topk),
              loss_jax.stacked_ohkm_loss(oj, tj, wj, topk))
        close(loss_port.joints_ohkm_mse_loss(o[1], t, None, topk),
              loss_jax.joints_ohkm_mse_loss(oj[1], tj, None, topk))


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_lr_for_epoch_matches_jax(path):
    cfg = load_config(os.path.join(REPO, path))
    ref = load_config_jax(os.path.join(REPO, path))
    got = [lr_for_epoch(cfg, e) for e in range(cfg.TRAIN.END_EPOCH + 2)]
    assert got == [state_jax.lr_for_epoch(ref, e)
                   for e in range(cfg.TRAIN.END_EPOCH + 2)]


# -- targets and preprocessing ---------------------------------------------

@pytest.mark.parametrize("diff_weight", [False, True])
def test_targets_and_preprocessor_match_jax(diff_weight):
    raw = _raw_batch(seed=5, b=6)
    raw["joints"][0, :4] = [[-7, 3], [70, 70], [0, 0], [63.9, 31.5]]
    jw = np.linspace(0.5, 1.5, J).astype(np.float32).reshape(J, 1)
    cfg_j, cfg_t = _both(1, 16, **{
        "LOSS.USE_DIFFERENT_JOINTS_WEIGHT": diff_weight})

    t_port, w_port = generate_target_torch(
        torch.from_numpy(raw["joints"]), torch.from_numpy(raw["joints_vis"]),
        (16, 16), (HW, HW), 2, jw.reshape(-1), diff_weight)
    t_ref, w_ref = generate_target_jax(
        jnp.asarray(raw["joints"]), jnp.asarray(raw["joints_vis"]),
        (16, 16), (HW, HW), 2, jw.reshape(-1), diff_weight)
    np.testing.assert_array_equal(w_port.numpy(), np.asarray(w_ref))
    np.testing.assert_allclose(t_port.numpy(), np.asarray(t_ref), rtol=0,
                               atol=1e-6)
    assert (w_port == 0).any() and (w_port > 0).any()

    got = make_batch_preprocessor(cfg_t, jw)(_to_torch(raw))
    ref = step_jax.make_batch_preprocessor(cfg_j, jw)(
        {k: jnp.asarray(v) for k, v in raw.items()})
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  np.asarray(ref["target_weight"]))
    np.testing.assert_allclose(got["target"].numpy(), _nchw(ref["target"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["image"].numpy(), _nchw(ref["image"]),
                               rtol=0, atol=1e-6)
    # TPU.DEVICE_WARP: the crops as canvases with identity matrices give
    # the same image and targets (the warp is held in
    # tests/test_torch_device_warp.py)
    canvas = make_batch_preprocessor(cfg_t, jw)(dict(
        _to_torch({k: raw[k] for k in ("joints", "joints_vis")}),
        canvas=torch.from_numpy(raw["image"]),
        warp_inv=torch.tensor([[1.0, 0, 0], [0, 1, 0]]).expand(6, 2, 3)))
    for k in ("image", "target", "target_weight"):
        assert torch.equal(canvas[k], got[k]), k
    with pytest.raises(ValueError, match="integer"):
        generate_target_torch(torch.zeros(1, J, 2), torch.ones(1, J),
                              (16, 16), (HW, HW), 1.5)


# -- steps --------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return get_mesh(1)


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _f64(variables):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float64), variables)


def _jax_state(cfg_j, variables, dtype):
    model = get_pose_net_jax(cfg_j, dtype=dtype)
    state = state_jax.create_train_state(
        cfg_j, model, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=state.tx.init(params))
    return model, state


def _port_model(cfg_t, variables, dtype=torch.float32):
    model = get_pose_net(cfg_t).to(dtype)
    model.load_state_dict(state_dict_from_jax(cfg_t, variables))
    return model


def _torch_sd(cfg_t, params, stats):
    return state_dict_from_jax(cfg_t, {"params": params,
                                       "batch_stats": stats})


def _held(got, ref, rtol, what):
    scale = ref.abs().max().item()
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=0,
                               atol=rtol * scale, err_msg=what)


def _check_stats(cfg_t, model, params_j, stats_j, rtol=X64_RTOL):
    ref = _torch_sd(cfg_t, params_j, stats_j)
    got = model.state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        _held(got[k], ref[k], rtol, k)


def _check_adam(cfg_t, state_t, state_j, lr):
    """Moments (mu = 0.1 g, nu = 0.001 g^2 after one step) and the
    updated parameters."""
    inner = state_j.opt_state.inner_state[0]
    mu = jax.tree_util.tree_map(np.asarray, inner.mu)
    ref = adam_state_from_jax(cfg_t, state_t.optimizer, state_t.model,
                              int(inner.count), mu,
                              jax.tree_util.tree_map(np.asarray, inner.nu))
    got = state_t.optimizer.state_dict()
    assert got["state"].keys() == ref["state"].keys()
    for i, r in ref["state"].items():
        s = got["state"][i]
        assert float(s["step"]) == float(r["step"]) == 1.0
        for key in ("exp_avg", "exp_avg_sq"):
            _held(s[key], r[key], X64_RTOL, f"{i} {key}")

    p_ref = _torch_sd(cfg_t, state_j.params, state_j.batch_stats)
    g = _torch_sd(cfg_t, mu, state_j.batch_stats)     # 0.1 g
    for name, p in state_t.model.named_parameters():
        live = g[name].abs() >= SMALL_GRAD * g[name].abs().max()
        diff = (p.detach() - p_ref[name]).abs()
        assert (diff[live] <= X64_RTOL * lr).all(), \
            (name, diff[live].max().item())
        assert live.any(), name


def test_fpd_step_matches_jax(mesh, x64):
    """One float64 FPD step (Adam, MSE, KD alpha 0.5) from the same
    weights and batch: loss, pose, KD, acc and per-joint acc,
    BN running stats, Adam moments, updated parameters.

    ``DEAD_BIAS_SKIP`` is on, as ``bench.py`` trains: a conv bias that
    feeds a BatchNorm has a gradient that is 0 in exact arithmetic and
    rounding noise in practice, which Adam's first step turns into +-lr,
    so with those biases the two frameworks would legitimately differ by
    up to 2 lr there.  The other parameters' gradients are compared
    through the moments (mu = 0.1 g after one step)."""
    cfg_j, cfg_t = _both(2, 16, dtype="float64")
    tcfg_j, tcfg_t = _both(2, 32, yaml=TEACHER_YAML, dtype="float64")
    svars = _f64(_jax_variables(cfg_j, (HW, HW), seed=11)[1])
    tvars = _f64(_jax_variables(tcfg_j, (HW, HW), seed=12)[1])
    # one batch for both: the JAX preprocessor's normalized image and
    # targets (the two exp implementations differ by float32 ulps; the
    # preprocessors are held to each other above)
    batch = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(v) for k, v in _raw_batch(seed=13).items()})
    batch = {k: np.asarray(batch[k])
             for k in ("image", "target", "target_weight")}

    smodel_j, state_j = _jax_state(cfg_j, svars, jnp.float64)
    tmodel_j = get_pose_net_jax(tcfg_j, dtype=jnp.float64)
    step_j = step_jax.make_fpd_train_step(
        smodel_j, tmodel_j, cfg_j, mesh, True, True, debug_outputs=True,
        teacher_cfg=tcfg_j)
    state_j, m_j = step_j(state_j, jax.tree_util.tree_map(jnp.asarray, tvars),
                          shard_batch(mesh, {k: jnp.asarray(v)
                                             for k, v in batch.items()}))

    state_t = create_train_state(
        cfg_t, _port_model(cfg_t, svars, torch.float64), device="cpu")
    teacher = _port_model(tcfg_t, tvars, torch.float64)
    step_t = make_fpd_train_step(cfg_t, teacher, tcfg_t)
    state_t, m_t = step_t(state_t, _nchw_batch(batch))
    assert state_t.step == int(state_j.step) == 1

    for key in ("loss", "pose_loss", "kd_loss"):
        np.testing.assert_allclose(m_t[key].item(), float(m_j[key]),
                                   rtol=X64_RTOL, err_msg=key)
    # PCK decides by argmax: first make sure no decision is a near-tie
    assert decision_margin(_nchw(m_j["output"])).min() > 1e-6
    np.testing.assert_array_equal(m_t["per_joint_acc"].numpy(),
                                  np.asarray(m_j["per_joint_acc"]))
    assert m_t["acc"].item() == pytest.approx(float(m_j["acc"]), abs=1e-6)
    assert int(m_t["acc_cnt"]) == int(m_j["acc_cnt"])

    _check_stats(cfg_t, state_t.model, state_j.params, state_j.batch_stats)
    _check_adam(cfg_t, state_t, state_j, float(cfg_t.TRAIN.LR))
    # the teacher is frozen
    for k, v in _port_model(tcfg_t, tvars, torch.float64
                            ).state_dict().items():
        assert torch.equal(teacher.state_dict()[k], v), k


def test_ohkm_sgd_nesterov_step_matches_jax(mesh, x64):
    """Two float64 make_train_steps with OHKM (top 8) and SGD (momentum
    0.9, nesterov, weight decay 1e-4), targets given, the LR set per
    epoch (0, then 130: past both milestones): losses, updated parameters
    and BN running stats."""
    cfg_j, cfg_t = _both(1, 16, dtype="float64", **{
        "LOSS.USE_OHKM": True, "TRAIN.OPTIMIZER": "sgd",
        "TRAIN.NESTEROV": True, "TRAIN.LR": 0.01})
    svars = _f64(_jax_variables(cfg_j, (HW, HW), seed=21)[1])
    rng = np.random.RandomState(22)
    batch = {"image": rng.randn(B, HW, HW, 3),
             "target": rng.rand(B, 16, 16, J).astype(np.float32),
             "target_weight": (rng.rand(B, J) > 0.2).astype(np.float32)}

    smodel_j, state_j = _jax_state(cfg_j, svars, jnp.float64)
    step_j = step_jax.make_train_step(smodel_j, cfg_j, mesh, True)
    state_t = create_train_state(
        cfg_t, _port_model(cfg_t, svars, torch.float64), device="cpu")
    step_t = make_train_step(cfg_t)
    batch_t = _nchw_batch(batch)
    for epoch in (0, 130):
        lr = lr_for_epoch(cfg_t, epoch)
        state_j = state_jax.set_lr(state_j, lr)
        set_lr(state_t, lr)
        state_j, m_j = step_j(state_j, shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in batch.items()}))
        state_t, m_t = step_t(state_t, batch_t)
        np.testing.assert_allclose(m_t["loss"].item(), float(m_j["loss"]),
                                   rtol=X64_RTOL)
    assert state_t.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    ref = _torch_sd(cfg_t, state_j.params, state_j.batch_stats)
    for name, p in state_t.model.named_parameters():
        _held(p, ref[name], X64_RTOL, name)
    _check_stats(cfg_t, state_t.model, state_j.params, state_j.batch_stats)


def test_eval_step_matches_jax(mesh):
    """float32, flip test with SHIFT_HEATMAP and POST_PROCESS, a padded
    tail (the last two rows marked invalid): preds, maxvals, loss, hits,
    valids."""
    cfg_j, cfg_t = _both(2, 16)
    variables = _jax_variables(cfg_j, (HW, HW), seed=44)[1]
    raw = _raw_batch(seed=34, b=6)
    rng = np.random.RandomState(33)
    inv = np.tile(np.array([[2.0, 0.1, 0.0], [-0.1, 2.0, 0.0]], np.float32),
                  (6, 1, 1))
    inv[:, :, 2] = rng.uniform(0, 100, (6, 2))
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    perm = flip_pair_permutation(J, MPII_FLIP_PAIRS)

    prep_j = step_jax.make_batch_preprocessor(cfg_j)
    batch_j = prep_j({k: jnp.asarray(v) for k, v in raw.items()})
    batch_j.update(inv_trans=jnp.asarray(inv), valid=jnp.asarray(valid))
    smodel_j = get_pose_net_jax(cfg_j, dtype=jnp.float32)
    out_j = step_jax.make_eval_step(smodel_j, cfg_j, mesh, True, perm,
                                    debug_outputs=True)(
        variables, shard_batch(mesh, batch_j))

    model = _port_model(cfg_t, variables)
    batch_t = dict(_to_torch(raw), inv_trans=torch.from_numpy(inv),
                   valid=torch.from_numpy(valid))
    out_t = make_eval_step(cfg_t, perm,
                           prepare=make_batch_preprocessor(cfg_t))(model,
                                                                   batch_t)
    # the decode decides by argmax and neighbour signs: no near-ties
    assert decision_margin(_nchw(out_j["output"])).min() > 1e-4
    np.testing.assert_allclose(out_t["preds"].numpy(),
                               np.asarray(out_j["preds"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(out_t["maxvals"].numpy(),
                               np.asarray(out_j["maxvals"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out_t["loss"].item(), float(out_j["loss"]),
                               rtol=EVAL_LOSS_RTOL)
    for key in ("hits", "valids"):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]))
    assert int(out_t["valids"].sum()) < 4 * J       # the tail is masked
    with pytest.raises(ValueError, match="flip_perm"):
        make_eval_step(cfg_t)


def test_train_mode_batchnorm_matches_jax(x64):
    """Running statistics after one float64 train-mode forward (torch
    keeps the Bessel-corrected variance with momentum 0.1, as fhpe_tpu's
    ``_TorchBatchNorm`` does), and the train-mode heatmaps."""
    cfg_j, cfg_t = _both(2, 16, dtype="float64")
    variables = _f64(_jax_variables(cfg_j, (HW, HW), seed=41)[1])
    model_j = get_pose_net_jax(cfg_j, dtype=jnp.float64)
    x = np.random.RandomState(42).randn(3, HW, HW, 3)
    out_j, mutated = model_j.apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
        train=True, mutable=["batch_stats"])
    model = _port_model(cfg_t, variables, torch.float64).train()
    with torch.no_grad():
        out_t = model(torch.from_numpy(_nchw(x).copy()))
    for s, o in enumerate(out_t):
        _held(o, torch.from_numpy(_nchw(out_j[s]).copy()), X64_RTOL,
              f"stack {s}")
    _check_stats(cfg_t, model, variables["params"], mutated["batch_stats"])


def test_create_train_state():
    cfg = _both(1, 16)[1]
    a = create_train_state(cfg, seed=3, device="cpu")
    b = create_train_state(cfg, seed=3, device="cpu")
    assert a.model.training and a.step == 0
    assert isinstance(a.optimizer, torch.optim.Adam)
    assert a.optimizer.defaults["lr"] == pytest.approx(2.5e-4)
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k
    cfg.defrost()
    cfg.TPU.NUM_DEVICES = 4
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        create_train_state(cfg, device="cpu")
