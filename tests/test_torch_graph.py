"""The port's compiled steps (``fhpe_tpu_torch/utils/graph.py``) on the
CPU.

* Capture safety: the train, FPD and eval step bodies and the Predictor's
  serve step (merged heatmaps plus the decode) run, after their first
  call, under a dispatch mode that fails on what a CUDA graph cannot
  hold: a read of a device value (``aten._local_scalar_dense``), a tensor
  made from host data (``aten.lift_fresh``) and a data-dependent shape
  (``aten.nonzero``).  The CPU optimizer's own step is left out: it reads
  its step count by design, and on the card Adam is capturable.
* ``CapturedStep``'s plumbing apart from ``torch.cuda.graph`` itself,
  through a stand-in capture passed explicitly: the first call is a real
  step, outputs never alias the graph's, a new signature or replaced
  storage captures again, and the kernels' launch counts follow replays.
* ``set_lr`` on a tensor rate, and a checkpoint's optimizer state across
  devices.

Tiny models: a 1-stack, 16-feature hourglass at 64 x 64, a narrow HRNet
(widths 8/16/32/64, one block per branch, one module per stage) at 128 x
96 and an RN-18 PoseResNet at 96 x 64 with 32 deconv filters, batch 4.
The same steps are held against ``fhpe_tpu`` by the parity tests
(``test_torch_train.py``, ``test_torch_hrnet_train.py``,
``test_torch_pose_resnet.py``, ``test_torch_serve.py``).
"""

import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from fhpe_tpu_torch.data import dataset_meta
from fhpe_tpu_torch.geometry.flip import flip_pair_permutation
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.models.common import he_scale_weights
from fhpe_tpu_torch.ops import decode
from fhpe_tpu_torch.serve import Predictor
from fhpe_tpu_torch.tools.train_parity import (fpd_cfgs, hrnet_fpd_cfgs,
                                               rn50_cfg, train_batch)
from fhpe_tpu_torch.train import (TrainState, create_train_state,
                                  make_batch_preprocessor, make_eval_step,
                                  make_fpd_train_step, make_optimizer,
                                  make_train_step, set_lr)
from fhpe_tpu_torch.utils import checkpoint as ck
from fhpe_tpu_torch.utils.graph import (CapturedStep, constant,
                                        storage_fingerprint)
from fhpe_tpu_torch.utils.logger import WindowedMeters

from torch_threads import torch_threads  # noqa: F401

B = 4
CPU = torch.device("cpu")
aten = torch.ops.aten
HOST_TRAFFIC = (aten._local_scalar_dense, aten.lift_fresh, aten.nonzero)


class NoHostTraffic(TorchDispatchMode):
    """Fails on an op a CUDA graph cannot capture."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_TRAFFIC:
            raise AssertionError(f"{func} in a step body")
        return func(*args, **(kwargs or {}))


def _hourglass():
    return fpd_cfgs("float32", 1, 16, 64, 1, 16)


def _hrnet():
    return hrnet_fpd_cfgs("float32", 8, 8, 128, 1, 1)


def _rn18():
    cfg = rn50_cfg("float32")
    cfg.defrost()
    cfg.merge_from_list(["MODEL.EXTRA.NUM_LAYERS", 18,
                         "MODEL.IMAGE_SIZE", [64, 96],
                         "MODEL.HEATMAP_SIZE", [16, 24],
                         "MODEL.EXTRA.NUM_DECONV_FILTERS", [32, 32, 32],
                         "TEST.BATCH_SIZE_PER_GPU", B])
    cfg.freeze()
    return cfg


def _model(cfg, seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_pose_net(cfg)
    if cfg.MODEL.NAME == "pose_hrnet":
        w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
        he_scale_weights(model, seed, (h, w))
    return model


def _optimizer_outside(state):
    """The CPU optimizer's step runs with the dispatch mode off."""
    inner = state.optimizer.step

    def step(*a, **k):
        with _disable_current_modes():
            return inner(*a, **k)
    state.optimizer.step = step


def _eval_batch(cfg, seed):
    batch = train_batch(cfg, B, seed, CPU)
    rng = np.random.RandomState(seed)
    batch["inv_trans"] = torch.from_numpy(
        rng.uniform(-2, 2, (B, 2, 3)).astype(np.float32))
    batch["valid"] = torch.tensor([1.0] * (B - 1) + [0.0])
    return batch


def _train_case(cfg_fn, fpd):
    scfg, tcfg = cfg_fn() if fpd else (cfg_fn(), None)
    state = create_train_state(scfg, _model(scfg, 0), device=CPU)
    prepare = make_batch_preprocessor(scfg)
    if fpd:
        step = make_fpd_train_step(scfg, _model(tcfg, 100).eval(), tcfg,
                                   prepare=prepare)
    else:
        step = make_train_step(scfg, prepare=prepare)
    _optimizer_outside(state)
    return (lambda seed: train_batch(scfg, B, seed, CPU),
            lambda batch: step(state, batch))


def _eval_case(cfg_fn):
    cfg = cfg_fn()
    cfg = cfg[0] if isinstance(cfg, tuple) else cfg
    meta = dataset_meta(cfg.DATASET.DATASET)
    step = make_eval_step(
        cfg, flip_perm=flip_pair_permutation(meta["num_joints"],
                                             meta["flip_pairs"]),
        prepare=make_batch_preprocessor(cfg))
    model = _model(cfg, 0)
    return (lambda seed: _eval_batch(cfg, seed),
            lambda batch: step(model, batch))


def _serve_case(cfg_fn):
    cfg = cfg_fn()
    cfg = cfg[0] if isinstance(cfg, tuple) else cfg
    p = Predictor(cfg, _model(cfg, 0), batch_size=B, device="cpu")

    def batch(seed):
        b = _eval_batch(cfg, seed)
        return {"image": b["image"], "inv_trans": b["inv_trans"]}
    return batch, lambda b: p.step(p.model, b)


CASES = {
    "train-rn18": lambda: _train_case(_rn18, False),
    "fpd-hourglass": lambda: _train_case(_hourglass, True),
    "fpd-hrnet": lambda: _train_case(_hrnet, True),
    "eval-hourglass": lambda: _eval_case(_hourglass),
    "eval-hrnet": lambda: _eval_case(_hrnet),
    "eval-rn18": lambda: _eval_case(_rn18),
    "serve-hourglass": lambda: _serve_case(_hourglass),
    "serve-hrnet": lambda: _serve_case(_hrnet),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_bodies_are_capture_safe(case):
    """After its first call (which may build its constants), a step body
    copies no host data to the device, reads no device value and makes
    no data-dependent shape: forward, loss, backward, metrics, decode."""
    make_batch, run = CASES[case]()
    run(make_batch(1))
    batch = make_batch(2)
    with NoHostTraffic():
        out = run(batch)
    metrics = out[1] if isinstance(out, tuple) else out
    assert all(torch.isfinite(v.float()).all() for v in metrics.values())


def test_dispatch_mode_catches_host_traffic():
    """The mode above sees each of the three ops."""
    t = torch.ones(3)
    for fn in (lambda: t.sum().item(), lambda: torch.tensor([1.0, 2.0]),
               lambda: torch.nonzero(t)):
        with pytest.raises(AssertionError, match="in a step body"):
            with NoHostTraffic():
                fn()


# -- CapturedStep's plumbing through a stand-in capture ----------------------

def _state_tensors(state):
    return [*state.model.parameters(), *state.model.buffers(),
            *(v for st in state.optimizer.state.values()
              for v in st.values() if isinstance(v, torch.Tensor))]


def stand_in(tensors):
    """A capture that records ``run`` without changing state, as
    ``torch.cuda.graph`` does: it runs the body once for its output
    tensors and puts ``tensors()`` back.  Its replay runs the body again
    and writes the results into those same output tensors, as a graph
    rewrites its outputs."""
    calls = []

    def capture(run):
        saved = [t.detach().clone() for t in tensors()]
        out = run()
        with torch.no_grad():
            for t, v in zip(tensors(), saved):
                t.copy_(v)
        calls.append(run)

        def replay():
            new = run()
            with torch.no_grad():
                for k, v in new.items():
                    out[k].copy_(v)
        return replay, out
    capture.calls = calls
    return capture


def _hourglass_train():
    scfg, tcfg = _hourglass()
    state = create_train_state(scfg, _model(scfg, 0), device=CPU)
    step = make_fpd_train_step(scfg, _model(tcfg, 100).eval(), tcfg,
                               prepare=make_batch_preprocessor(scfg))
    return scfg, state, step


def _captured(state, step, capture):
    state.model.train()
    return CapturedStep(step.captured.eager,
                        lambda s: storage_fingerprint((s.model,),
                                                      s.optimizer),
                        capture=capture)


def test_first_call_and_replays_are_real_steps():
    """The first call runs the body as a real step and the capture changes
    nothing; each later call replays and equals the eager body step for
    step, from the same state."""
    scfg, state, step = _hourglass_train()
    ref = copy.deepcopy(state)
    capture = stand_in(lambda: _state_tensors(state))
    captured = _captured(state, step, capture)
    batches = [train_batch(scfg, B, seed, CPU) for seed in range(3)]
    for i, batch in enumerate(batches):
        got = captured(state, batch)
        ref, want = step.eager(ref, batch)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        for a, b in zip(_state_tensors(state), _state_tensors(ref)):
            assert torch.equal(a, b), i
    assert captured.captures == len(capture.calls) == 1


def test_outputs_never_alias_the_graph():
    """Metrics a caller keeps for a PRINT_FREQ window stay each step's
    own: 3 steps pushed into WindowedMeters give 3 different losses."""
    scfg, state, step = _hourglass_train()
    captured = _captured(state, step, stand_in(lambda: _state_tensors(state)))
    meters = WindowedMeters(value_keys=("loss",))
    kept = []
    for seed in range(3):
        metrics = captured(state, train_batch(scfg, B, seed, CPU))
        meters.push(metrics, B)
        kept.append(metrics["loss"])
    assert len({float(v) for v in kept}) == 3
    meters.drain()
    assert meters["loss"].count == 3 * B
    assert meters["loss"].avg == pytest.approx(
        float(sum(float(v) for v in kept) / 3))


def test_new_signature_captures_again():
    scfg, state, step = _hourglass_train()
    captured = _captured(state, step, stand_in(lambda: _state_tensors(state)))
    captured(state, train_batch(scfg, B, 0, CPU))
    captured(state, train_batch(scfg, B, 1, CPU))
    assert captured.captures == 1
    captured(state, train_batch(scfg, 2, 2, CPU))
    assert captured.captures == 2
    captured(state, train_batch(scfg, B, 3, CPU))      # its graph is kept
    assert captured.captures == 2


@pytest.mark.parametrize("replace", ["optimizer_load_state_dict",
                                     "model_load_state_dict_assign",
                                     "parameter_data", "new_optimizer",
                                     "eval_mode"])
def test_replaced_storage_captures_again(replace):
    """A graph never replays stale pointers: replaced parameter, buffer or
    optimizer storage (or a module switched to eval) captures again,
    and the step after it is the eager body's step."""
    scfg, state, step = _hourglass_train()
    captured = _captured(state, step, stand_in(lambda: _state_tensors(state)))
    for seed in range(2):
        captured(state, train_batch(scfg, B, seed, CPU))
    assert captured.captures == 1
    if replace == "optimizer_load_state_dict":
        # as from a file: new tensors (the live ones would load in place)
        state.optimizer.load_state_dict(
            copy.deepcopy(state.optimizer.state_dict()))
    elif replace == "model_load_state_dict_assign":
        state.model.load_state_dict(
            {k: v.clone() for k, v in state.model.state_dict().items()},
            assign=True)
        state.optimizer = make_optimizer(scfg, state.model)
    elif replace == "parameter_data":
        p = next(state.model.parameters())
        p.data = p.data.clone()
    elif replace == "new_optimizer":
        state.optimizer = make_optimizer(scfg, state.model)
    else:
        state.model.eval()
    ref = copy.deepcopy(state)
    batch = train_batch(scfg, B, 5, CPU)
    got = captured(state, batch)
    assert captured.captures == 2
    ref, want = step.eager(ref, batch)
    if replace == "eval_mode":      # step.eager puts the student in train()
        return
    assert torch.equal(got["loss"], want["loss"])


def test_replays_count_kernel_launches(monkeypatch):
    """The kernels' counts follow what the device runs: the first call's
    eager launches count, the capture's do not, and every replay adds what
    its capture recorded."""
    monkeypatch.setattr(decode, "decode_kernel_launches", 0)

    def body(owner, batch):
        decode.decode_kernel_launches += 2     # as two kernel calls would
        return {"y": batch["x"] * 2}

    replays = []

    def capture(run):
        out = run()
        return (lambda: replays.append(1)), out

    captured = CapturedStep(body, lambda owner: (), capture=capture)
    x = {"x": torch.ones(3)}
    captured(None, x)
    assert decode.decode_kernel_launches == 2
    for _ in range(3):
        captured(None, x)
    assert len(replays) == 3
    assert decode.decode_kernel_launches == 2 + 3 * 2


def test_cpu_batch_runs_the_body():
    """Without a stand-in, a CPU batch runs the body as it is: no
    capture."""
    calls = []

    def body(owner, batch):
        calls.append(1)
        return {"y": batch["x"] + 1}

    captured = CapturedStep(body, lambda owner: ())
    for _ in range(2):
        assert torch.equal(captured(None, {"x": torch.zeros(2)})["y"],
                           torch.ones(2))
    assert len(calls) == 2 and captured.captures == 0


def test_step_makers_keep_the_eager_body():
    """Each maker's step has ``.eager`` and ``.captured``; on the CPU the
    step and its eager body give the same numbers, and ``state.step``
    counts on the host."""
    scfg, state, step = _hourglass_train()
    ref = copy.deepcopy(state)
    batch = train_batch(scfg, B, 0, CPU)
    state, a = step(state, batch)
    ref, b = step.eager(ref, batch)
    assert state.step == ref.step == 1
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert isinstance(step.captured, CapturedStep)
    assert step.captured.captures == 0


def test_constant_is_made_once():
    a = constant((0.485, 0.456, 0.406), torch.float32, CPU)
    assert constant((0.485, 0.456, 0.406), torch.float32, CPU) is a
    assert torch.equal(a, torch.tensor([0.485, 0.456, 0.406]))
    perm = np.array([1, 0, 2])
    assert constant(perm, torch.int64, CPU).dtype == torch.int64
    assert constant(perm, torch.int64, CPU) is not constant(
        np.array([0, 1, 2]), torch.int64, CPU)


# -- the learning rate and the optimizer state ------------------------------

def test_set_lr_writes_a_tensor_rate_in_place():
    """A tensor rate (capturable Adam's on the card) keeps its object, so
    a captured step reads the new value; a float rate is replaced."""
    model = torch.nn.Linear(2, 2)
    rate = torch.tensor(1e-3)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=rate))
    set_lr(state, 2.5e-4)
    assert state.optimizer.param_groups[0]["lr"] is rate
    assert float(rate) == pytest.approx(2.5e-4)
    model(torch.ones(1, 2)).sum().backward()
    state.optimizer.step()          # CPU Adam takes the tensor rate
    floats = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    set_lr(floats, 5e-4)
    assert floats.optimizer.param_groups[0]["lr"] == 5e-4


def test_cpu_adam_is_not_capturable():
    """On the CPU the optimizer is as before (capturable Adam asserts on
    CPU parameters): a float rate."""
    cfg = _hourglass()[0]
    opt = create_train_state(cfg, _model(cfg, 0), device=CPU).optimizer
    group = opt.param_groups[0]
    assert group["capturable"] is False and isinstance(group["lr"], float)


def test_resume_keeps_the_device_optimizer(tmp_path):
    """A checkpoint whose optimizer was written on the card (capturable,
    a tensor rate) resumes on the CPU with this device's settings and the
    saved rate and moments."""
    cfg = _hourglass()[0]
    state = create_train_state(cfg, _model(cfg, 0), device=CPU)
    step = make_train_step(cfg, prepare=make_batch_preprocessor(cfg))
    state, _ = step(state, train_batch(cfg, B, 0, CPU))
    saved = copy.deepcopy(state.optimizer.state_dict())
    for g in saved["param_groups"]:
        g.update(capturable=True, lr=torch.tensor(2e-4))
    ck.save_checkpoint(str(tmp_path), TrainState(
        state.model, state.optimizer, state.step), 1, 0.5, False)
    payload = ck.load_checkpoint_file(str(tmp_path / ck.CKPT_NAME))
    payload["optimizer"] = saved
    torch.save(payload, tmp_path / ck.CKPT_NAME)

    fresh = create_train_state(cfg, _model(cfg, 0), device=CPU)
    fresh, epoch, _ = ck.auto_resume(str(tmp_path), fresh)
    group = fresh.optimizer.param_groups[0]
    assert epoch == 1 and group["capturable"] is False
    assert isinstance(group["lr"], float)
    assert group["lr"] == pytest.approx(2e-4)
    for p, q in zip(fresh.model.parameters(), state.model.parameters()):
        a, b = fresh.optimizer.state[p], state.optimizer.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"])
    fresh, _ = step(fresh, train_batch(cfg, B, 1, CPU))   # it steps
