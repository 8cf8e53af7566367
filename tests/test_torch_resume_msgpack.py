"""AUTO_RESUME of a run directory that ``fhpe_tpu`` wrote: its
``checkpoint.msgpack`` (the whole ``TrainState``: step, weights, BatchNorm
statistics and optax state, with epoch and perf) read by the port.

``fhpe_tpu`` trains a tiny hourglass (1 stack x 16 features, 64x64, 16
MPII joints, ``DEAD_BIAS_SKIP`` on) ``K`` steps with its own
``make_train_step`` on a 1-device mesh and writes the checkpoint with its
own ``save_checkpoint``; then both packages resume from that directory and
take ``K`` more steps on the same seeded batches, in float64 on both
sides (``jax.enable_x64``, port ``TPU.COMPUTE_DTYPE float64``), for Adam
and for SGD (momentum 0.9, nesterov, weight decay 1e-4).

* The port's restored state equals ``fhpe_tpu``'s exactly (a float64
  transpose copies bits): parameters, BatchNorm statistics, Adam's
  moments and count or SGD's trace, the step, epoch and perf.
* After ``K`` more steps each tensor is held to ``X64_RTOL`` of its own
  largest element (``tests/test_torch_train.py``'s float64 bar: the two
  frameworks sum in other orders).  Adam's parameters are held on the
  elements whose first moment is not rounding noise (``SMALL_GRAD`` of
  the tensor's largest), where a near-zero gradient of either sign moves
  a parameter by about the rate; SGD's on every element.
* ``checkpoint.pth`` wins where both files are; an optimizer state of
  the other kind is refused, naming both.
* ``convert.checkpoint_tree_from_state`` writes a port state in
  ``fhpe_tpu``'s layout, which is what the card's machine (no JAX) writes
  for ``chip_smoke.py`` phase 33: its tree has the keys, shapes and dtypes
  of the file ``fhpe_tpu`` wrote, and ``fhpe_tpu`` restores it.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhpe_tpu.parallel.mesh import get_mesh, shard_batch
from fhpe_tpu.train import state as state_jax
from fhpe_tpu.train import step as step_jax
from fhpe_tpu.utils import checkpoint as ck_jax
from fhpe_tpu_torch.train import create_train_state, make_train_step, set_lr
from fhpe_tpu_torch.utils import checkpoint as ck
from fhpe_tpu_torch.utils import msgpack
from fhpe_tpu_torch.utils.convert import (_param_tensors,
                                          checkpoint_tree_from_state,
                                          state_dict_from_jax)

from test_torch_hourglass import _jax_variables
from test_torch_train import (HW, J, SMALL_GRAD, X64_RTOL, _both, _f64,
                              _jax_state, _nchw_batch)
from torch_threads import torch_threads  # noqa: F401

B, K = 4, 2
EPOCH, PERF = 1, 0.625
SGD = {"TRAIN.OPTIMIZER": "sgd", "TRAIN.NESTEROV": True,
       "TRAIN.MOMENTUM": 0.9, "TRAIN.WD": 1e-4, "TRAIN.LR": 0.01}


def _batches(n, seed):
    """Normalized images and targets, NHWC numpy: a plain train step's
    batch (no device preprocessing)."""
    out = []
    for s in range(n):
        rng = np.random.RandomState(seed + s)
        out.append({"image": rng.randn(B, HW, HW, 3),
                    "target": rng.rand(B, HW // 4, HW // 4, J
                                       ).astype(np.float32),
                    "target_weight": (rng.rand(B, J) > 0.2
                                      ).astype(np.float32)})
    return out


def _optax_node(state_j, kind):
    """optax's Adam (count, mu, nu) or SGD (trace) state of a JAX
    ``TrainState``, found in the tree as ``fhpe_tpu``'s optimizers
    build it."""
    inner = state_j.opt_state.inner_state
    return inner[0] if kind == "adam" else inner[1][0]


def _torch_tree(cfg_t, tree):
    """A tree shaped like flax ``params`` -> torch parameter name ->
    tensor."""
    return _param_tensors(cfg_t, jax.tree_util.tree_map(np.asarray, tree))


def _same_as_jax(cfg_t, state_t, state_j, kind, rtol, live_only):
    """The port's state against the JAX one: every tensor within ``rtol``
    of its own largest element (0: bit-equal)."""
    def held(got, ref, what, mask=None):
        got, ref = got.detach(), ref.detach()
        diff = (got - ref).abs()
        if mask is not None:
            assert mask.any(), what
            diff = diff[mask]
        bound = rtol * ref.abs().max().item()
        assert diff.max().item() <= bound, (what, diff.max().item(), bound)

    ref = state_dict_from_jax(cfg_t, {
        "params": jax.tree_util.tree_map(np.asarray, state_j.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              state_j.batch_stats)})
    node = _optax_node(state_j, kind)
    moments = {"adam": ("exp_avg", "mu"), "sgd": ("momentum_buffer",
                                                  "trace")}[kind]
    first = _torch_tree(cfg_t, getattr(node, moments[1]))
    sd = state_t.model.state_dict()
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        live = None
        if live_only and k in first:
            live = first[k].abs() >= SMALL_GRAD * first[k].abs().max()
        held(v, ref[k], k, live)
    assert sd.keys() - ref.keys() <= {k for k in sd
                                      if k.endswith("num_batches_tracked")}
    opt = state_t.optimizer.state_dict()["state"]
    names = [n for n, _ in state_t.model.named_parameters()]
    assert sorted(opt) == list(range(len(names)))
    pairs = [moments]
    if kind == "adam":
        pairs.append(("exp_avg_sq", "nu"))
        assert {float(s["step"]) for s in opt.values()} == {
            float(node.count)}
    for tkey, jkey in pairs:
        tree = _torch_tree(cfg_t, getattr(node, jkey))
        for i, name in enumerate(names):
            held(opt[i][tkey], tree[name], f"{name} {tkey}")
    assert state_t.step == int(state_j.step)


@pytest.fixture(scope="module", params=["adam", "sgd"])
def jax_run(request, tmp_path_factory):
    """``fhpe_tpu``: K steps, ``save_checkpoint`` (synchronous), then a
    resume from that directory and K more steps.  Returns what the port
    side needs."""
    kind = request.param
    opts = SGD if kind == "sgd" else {}
    run_dir = tmp_path_factory.mktemp(f"fhpe_tpu_{kind}")
    batches = _batches(2 * K, seed=40)
    mesh = get_mesh(1)
    with jax.enable_x64(True):
        cfg_j, cfg_t = _both(1, 16, dtype="float64", **opts)
        svars = _f64(_jax_variables(cfg_j, (HW, HW), seed=41)[1])
        model_j, state_j = _jax_state(cfg_j, svars, jnp.float64)
        step_j = step_jax.make_train_step(model_j, cfg_j, mesh, True)
        lr = state_jax.lr_for_epoch(cfg_j, EPOCH)

        def steps(state, part):
            state = state_jax.set_lr(state, lr)
            for b in part:
                state, _ = step_j(state, shard_batch(
                    mesh, {k: jnp.asarray(v) for k, v in b.items()}))
            return state

        state_j = steps(state_j, batches[:K])
        ck_jax.save_checkpoint(str(run_dir), state_j, EPOCH, PERF,
                               is_best=False, async_write=False)
        saved = jax.tree_util.tree_map(np.asarray, state_j)
        # a fresh template with other weights, as a restarted run has
        zeros = jax.tree_util.tree_map(np.zeros_like, svars)
        template = _jax_state(cfg_j, zeros, jnp.float64)[1]
        resumed, epoch, perf = ck_jax.auto_resume(str(run_dir), template)
        assert (epoch, perf) == (EPOCH, PERF)
        final = jax.tree_util.tree_map(np.asarray,
                                       steps(resumed, batches[K:]))
    return {"kind": kind, "cfg_t": cfg_t, "dir": run_dir, "lr": lr,
            "batches": batches, "saved": saved, "final": final}


def _port_state(cfg_t, seed=43):
    """A fresh port state with other weights than the checkpoint's, as a
    restarted run has."""
    return create_train_state(cfg_t, seed=seed, device="cpu")


def test_port_resumes_fhpe_tpu_checkpoint(jax_run, caplog):
    """Restored bit-equal to what ``fhpe_tpu`` wrote; K more port steps on
    the same batches agree with ``fhpe_tpu``'s K more steps."""
    cfg_t, kind = jax_run["cfg_t"], jax_run["kind"]
    state = _port_state(cfg_t)
    with caplog.at_level(logging.INFO, logger=ck.__name__):
        state, epoch, perf = ck.auto_resume(str(jax_run["dir"]), state,
                                            cfg_t)
    assert (epoch, perf) == (EPOCH, PERF)
    assert any(ck.JAX_CKPT_NAME in r.getMessage() for r in caplog.records)
    _same_as_jax(cfg_t, state, jax_run["saved"], kind, 0.0, False)

    step = make_train_step(cfg_t)
    set_lr(state, jax_run["lr"])
    for b in jax_run["batches"][K:]:
        state, _ = step(state, _nchw_batch(b))
    _same_as_jax(cfg_t, state, jax_run["final"], kind, X64_RTOL,
                 kind == "adam")


def test_pth_wins_and_port_layout_restores_in_fhpe_tpu(jax_run, tmp_path,
                                                       caplog):
    """The port's writer in ``fhpe_tpu``'s layout (what phase 33 writes on
    the card): the same tree as ``fhpe_tpu``'s file, restored by
    ``fhpe_tpu`` bit-equal; beside a ``checkpoint.pth`` the ``.pth`` is
    read."""
    cfg_t, kind = jax_run["cfg_t"], jax_run["kind"]
    state, _, _ = ck.auto_resume(str(jax_run["dir"]), _port_state(cfg_t),
                                 cfg_t)
    payload = checkpoint_tree_from_state(cfg_t, state.model, state.optimizer,
                                         state.step, EPOCH, PERF)
    path = tmp_path / ck.JAX_CKPT_NAME
    path.write_bytes(msgpack.packb(payload))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), str(tree.dtype))
        return type(tree).__name__

    with open(jax_run["dir"] / ck_jax.CKPT_NAME, "rb") as f:
        written = msgpack.unpackb(f.read())
    assert shapes(msgpack.unpackb(path.read_bytes())) == shapes(written)

    with jax.enable_x64(True):
        cfg_j = _both(1, 16, dtype="float64",
                      **(SGD if kind == "sgd" else {}))[0]
        zeros = jax.tree_util.tree_map(np.zeros_like, {
            "params": jax_run["saved"].params,
            "batch_stats": jax_run["saved"].batch_stats})
        template = _jax_state(cfg_j, zeros, jnp.float64)[1]
        back, epoch, perf = ck_jax.auto_resume(str(tmp_path), template)
        back = jax.tree_util.tree_map(np.asarray, back)
    assert (epoch, perf) == (EPOCH, PERF)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jax_run["saved"])):
        np.testing.assert_array_equal(a, b)

    # a checkpoint.pth beside it is what a resume reads
    state.step += 1
    ck.save_checkpoint(str(tmp_path), state, EPOCH + 1, PERF, False)
    ck.flush_pending(str(tmp_path))
    with caplog.at_level(logging.INFO, logger=ck.__name__):
        _, epoch, _ = ck.auto_resume(str(tmp_path), _port_state(cfg_t),
                                     cfg_t)
    assert epoch == EPOCH + 1
    read = [r.getMessage() for r in caplog.records
            if "resume checkpoint" in r.getMessage()]
    assert read[-1].endswith(ck.CKPT_NAME), read


def test_other_optimizer_refused(jax_run):
    """Adam's state with ``TRAIN.OPTIMIZER sgd``, and the other way round,
    is refused naming both; nothing is restored in part."""
    other = {} if jax_run["kind"] == "sgd" else SGD
    cfg_t = _both(1, 16, dtype="float64", **other)[1]
    want = cfg_t.TRAIN.OPTIMIZER
    with pytest.raises(ValueError, match=f"holds {jax_run['kind']}'s "
                       f"optimizer state, but TRAIN.OPTIMIZER is {want}"):
        ck.auto_resume(str(jax_run["dir"]), _port_state(cfg_t), cfg_t)
    with pytest.raises(ValueError, match="needs the run's config"):
        ck.auto_resume(str(jax_run["dir"]), _port_state(cfg_t))
