"""FPD training of HRNet on COCO in the port against fhpe_tpu on the CPU:
HRNet's train-mode forward and running statistics (its branch chains
through ``BranchChainFn``), one FPD step of a W32-shaped student by a
W48-shaped teacher, the COCO training batch through both preprocessors,
and the HRNet eval step with COCO's flip pairs.

Narrow nets (student widths 8/16/32/64, teacher 12/24/48/96, the
``w32_fpd_student.yaml`` / ``w48_256x192_teacher.yaml`` settings
otherwise, one module per stage, two blocks per branch in stage 2) at
128 x 96, COCO's 4:3 (HRNet halves each side five times, so 64 x 48
cannot run), batch 4.  He-scale weights with BN statistics from one
batch (``he_scale_weights``), carried to fhpe_tpu by ``import_hrnet``.
Train steps compare in float64 on both sides, as ``test_torch_train.py``
does and for its reason; the eval step in float32.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhpe_tpu.config import load_config as load_config_jax
from fhpe_tpu.geometry.flip import flip_pair_permutation
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.parallel.mesh import shard_batch
from fhpe_tpu.train import step as step_jax
from fhpe_tpu.utils.torch_import import import_hrnet
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.data import COCO_FLIP_PAIRS
from fhpe_tpu_torch.data.coco_synthetic import synthetic_train_batch
from fhpe_tpu_torch.models import get_pose_net, pose_hrnet
from fhpe_tpu_torch.models.common import he_scale_weights
from fhpe_tpu_torch.models.pose_hrnet import BranchChain
from fhpe_tpu_torch.ops import decode
from fhpe_tpu_torch.ops.decode_cases import decision_margin
from fhpe_tpu_torch.train import (create_train_state, make_batch_preprocessor,
                                  make_eval_step, make_fpd_train_step)

from test_torch_train import (X64_RTOL, _check_adam, _check_stats, _f64,
                              _held, _jax_state, _nchw, _nchw_batch,
                              _port_model, _to_torch, mesh, x64)  # noqa: F401
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT_YAML = os.path.join(
    REPO, "experiments/fpd_coco/hrnet/w32_fpd_student.yaml")
TEACHER_YAML = os.path.join(
    REPO, "experiments/coco/hrnet/w48_256x192_teacher.yaml")
H, W, B, J = 128, 96, 4, 17


def _opts(width, dtype):
    opts = ["MODEL.IMAGE_SIZE", f"[{W},{H}]",
            "MODEL.HEATMAP_SIZE", f"[{W // 4},{H // 4}]",
            "TPU.COMPUTE_DTYPE", dtype, "TPU.NUM_DEVICES", "1"]
    for s in (2, 3, 4):
        opts += [f"MODEL.EXTRA.STAGE{s}.NUM_CHANNELS",
                 str([width * 2 ** i for i in range(s)]),
                 f"MODEL.EXTRA.STAGE{s}.NUM_MODULES", "1",
                 f"MODEL.EXTRA.STAGE{s}.NUM_BLOCKS",
                 str([2 if s == 2 else 1] * s)]
    return opts


def _both(width, yaml=STUDENT_YAML, dtype="float64"):
    """(fhpe_tpu config, port config) of the yaml cut to a narrow net."""
    return tuple(load(yaml, _opts(width, dtype))
                 for load in (load_config_jax, load_config))


def _weights(cfg_t, seed):
    """He-scale weights as a port state_dict and as fhpe_tpu variables."""
    sd = he_scale_weights(get_pose_net(cfg_t), seed, (H, W))
    stages = {k: dict(cfg_t.MODEL.EXTRA[k])
              for k in ("STAGE2", "STAGE3", "STAGE4")}
    return sd, import_hrnet({k: v.numpy() for k, v in sd.items()}, stages)


def _batch(seed, b=B):
    return synthetic_train_batch(b, seed, (W, H))


def _shard(mesh, batch):
    return shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})


# -- the COCO training batch -------------------------------------------------

def test_synthetic_train_batch():
    a, b = _batch(3), _batch(3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["image"].shape == (B, H, W, 3) and a["image"].dtype == np.uint8
    assert a["joints"].shape == (B, J, 2) and a["joints"].dtype == np.float32
    assert a["joints_vis"].shape == (B, J)
    hidden = a["joints_vis"] == 0
    assert hidden.any() and (~hidden).any()
    assert (a["joints"][hidden] == 0).all()
    big = synthetic_train_batch(64, 0)
    assert big["image"].shape == (64, 256, 192, 3)
    assert 0.1 < (big["joints_vis"] == 0).mean() < 0.25


@pytest.mark.parametrize("size", [(W, H), (192, 256)])
def test_coco_preprocessor_matches_jax(size):
    """synthetic_train_batch through make_batch_preprocessor on both sides:
    normalized image, 17 Gaussian targets at a quarter of the crop, target
    weights (no config sets USE_DIFFERENT_JOINTS_WEIGHT)."""
    opts = ["MODEL.IMAGE_SIZE", f"[{size[0]},{size[1]}]",
            "MODEL.HEATMAP_SIZE", f"[{size[0] // 4},{size[1] // 4}]"]
    cfg_j = load_config_jax(STUDENT_YAML, opts)
    cfg_t = load_config(STUDENT_YAML, opts)
    assert not cfg_t.LOSS.USE_DIFFERENT_JOINTS_WEIGHT
    raw = synthetic_train_batch(2, 21, size)
    got = make_batch_preprocessor(cfg_t)(_to_torch(raw))
    ref = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(v) for k, v in raw.items()})
    assert got["target"].shape == (2, J, size[1] // 4, size[0] // 4)
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  np.asarray(ref["target_weight"]))
    np.testing.assert_allclose(got["target"].numpy(), _nchw(ref["target"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["image"].numpy(), _nchw(ref["image"]),
                               rtol=0, atol=1e-6)


# -- train mode ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_hrnet_train_forward_matches_jax(x64, seed):
    """One float64 train-mode forward: heatmaps and every running statistic
    (Bessel-corrected variance, momentum 0.1), with every branch chain
    going through BranchChainFn."""
    cfg_j, cfg_t = _both(8)
    sd, variables = _weights(cfg_t, seed)
    x = np.random.RandomState(seed + 20).randn(3, H, W, 3)
    out_j, mutated = get_pose_net_jax(cfg_j, dtype=jnp.float64).apply(
        jax.tree_util.tree_map(jnp.asarray, _f64(variables)), jnp.asarray(x),
        train=True, mutable=["batch_stats"])
    model = _port_model(cfg_t, _f64(variables), torch.float64).train()
    assert sum(isinstance(m, BranchChain) and m.fused
               for m in model.modules()) == 9
    with torch.no_grad():
        out_t = model(torch.from_numpy(_nchw(x).copy()))
    _held(out_t, torch.from_numpy(_nchw(out_j).copy()), X64_RTOL, "heatmaps")
    _check_stats(cfg_t, model, variables["params"], mutated["batch_stats"])


def test_hrnet_fpd_step_matches_jax(mesh, x64):
    """One float64 FPD step (W32-shaped student, W48-shaped teacher in eval
    mode, Adam lr 1e-3, KD alpha 0.5) from the same weights and batch:
    loss, pose and KD loss, accuracy and per-joint accuracy, BN running
    statistics, Adam's moments (``adam_state_from_jax`` over HRNet's
    parameter order) and the updated parameters; the teacher stays
    frozen."""
    cfg_j, cfg_t = _both(8)
    tcfg_j, tcfg_t = _both(12, TEACHER_YAML)
    assert float(cfg_t.KD.ALPHA) == 0.5 and cfg_t.TRAIN.OPTIMIZER == "adam"
    _, svars = _weights(cfg_t, 11)
    _, tvars = _weights(tcfg_t, 12)
    svars, tvars = _f64(svars), _f64(tvars)
    batch = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(v) for k, v in _batch(13).items()})
    batch = {k: np.asarray(batch[k])
             for k in ("image", "target", "target_weight")}

    smodel_j, state_j = _jax_state(cfg_j, svars, jnp.float64)
    tmodel_j = get_pose_net_jax(tcfg_j, dtype=jnp.float64)
    step_j = step_jax.make_fpd_train_step(
        smodel_j, tmodel_j, cfg_j, mesh, False, False, debug_outputs=True,
        teacher_cfg=tcfg_j)
    state_j, m_j = step_j(state_j, jax.tree_util.tree_map(jnp.asarray, tvars),
                          _shard(mesh, batch))

    state_t = create_train_state(
        cfg_t, _port_model(cfg_t, svars, torch.float64), device="cpu")
    teacher = _port_model(tcfg_t, tvars, torch.float64)
    step_t = make_fpd_train_step(cfg_t, teacher, tcfg_t)
    state_t, m_t = step_t(state_t, _nchw_batch(batch))
    assert state_t.step == int(state_j.step) == 1

    for key in ("loss", "pose_loss", "kd_loss"):
        np.testing.assert_allclose(m_t[key].item(), float(m_j[key]),
                                   rtol=X64_RTOL, err_msg=key)
    assert decision_margin(_nchw(m_j["output"])).min() > 1e-6
    np.testing.assert_array_equal(m_t["per_joint_acc"].numpy(),
                                  np.asarray(m_j["per_joint_acc"]))
    assert m_t["acc"].item() == pytest.approx(float(m_j["acc"]), abs=1e-6)
    assert int(m_t["acc_cnt"]) == int(m_j["acc_cnt"])

    _check_stats(cfg_t, state_t.model, state_j.params, state_j.batch_stats)
    _check_adam(cfg_t, state_t, state_j, float(cfg_t.TRAIN.LR))
    for k, v in _port_model(tcfg_t, tvars, torch.float64
                            ).state_dict().items():
        assert torch.equal(teacher.state_dict()[k], v), k


def test_hrnet_eval_step_matches_jax(mesh):
    """float32, flip test with COCO's flip pairs, SHIFT_HEATMAP and
    POST_PROCESS, a padded tail (the last row invalid): preds, maxvals,
    loss, hits, valids; the chains run through branch_chain_eval."""
    cfg_j, cfg_t = _both(8, dtype="float32")
    sd, variables = _weights(cfg_t, 44)
    raw = _batch(34, b=5)
    rng = np.random.RandomState(33)
    inv = np.tile(np.array([[2.0, 0.1, 0.0], [-0.1, 2.0, 0.0]], np.float32),
                  (5, 1, 1))
    inv[:, :, 2] = rng.uniform(0, 100, (5, 2))
    valid = np.array([1, 1, 1, 1, 0], np.float32)
    perm = flip_pair_permutation(J, COCO_FLIP_PAIRS)

    batch_j = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(v) for k, v in raw.items()})
    batch_j.update(inv_trans=jnp.asarray(inv), valid=jnp.asarray(valid))
    out_j = step_jax.make_eval_step(
        get_pose_net_jax(cfg_j, dtype=jnp.float32), cfg_j, mesh, False, perm,
        debug_outputs=True)(variables, _shard(mesh, {
            k: np.asarray(v) for k, v in batch_j.items()}))

    model = get_pose_net(cfg_t)
    model.load_state_dict(sd)
    batch_t = dict(_to_torch(raw), inv_trans=torch.from_numpy(inv),
                   valid=torch.from_numpy(valid))
    with mock.patch.object(pose_hrnet, "branch_chain_eval",
                           wraps=pose_hrnet.branch_chain_eval) as chains:
        out_t = make_eval_step(cfg_t, perm,
                               prepare=make_batch_preprocessor(cfg_t))(
            model, batch_t)
    assert chains.call_count == 2 * 9   # every chain, in both flip forwards
    assert decision_margin(_nchw(out_j["output"])).min() > 1e-4
    np.testing.assert_allclose(out_t["preds"].numpy(),
                               np.asarray(out_j["preds"]), rtol=0, atol=1e-3)
    scale = np.abs(np.asarray(out_j["maxvals"])).max()
    np.testing.assert_allclose(out_t["maxvals"].numpy(),
                               np.asarray(out_j["maxvals"]), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(out_t["loss"].item(), float(out_j["loss"]),
                               rtol=1e-4)
    for key in ("hits", "valids"):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]))
    assert decode.decode_kernel_launches == 0   # CPU: the plain version


def test_create_train_state_for_the_coco_student():
    """W32 FPD student: Adam at lr 1e-3 over every parameter, train mode,
    every branch chain routed to P5; several devices only under
    torchrun."""
    cfg = load_config(STUDENT_YAML)
    state = create_train_state(cfg, seed=0, device="cpu")
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.optimizer.defaults["lr"] == pytest.approx(1e-3)
    assert state.model.training and state.step == 0
    assert len(state.optimizer.param_groups[0]["params"]) == \
        len(list(state.model.parameters()))
    assert sum(isinstance(m, BranchChain) and m.fused
               for m in state.model.modules()) == 26
    cfg.defrost()
    cfg.TPU.NUM_DEVICES = 4
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        create_train_state(cfg, device="cpu")
