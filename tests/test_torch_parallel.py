"""The port's data-parallel training (``fhpe_tpu_torch.parallel``, one
process per device under ``torchrun``) on the CPU, with gloo.

* (a) One ``torchrun --nproc_per_node 2`` launch of
  ``fhpe_tpu_torch.tools.ddp_parity`` runs three cases, two steps each,
  in float64: the plain step with SGD-nesterov and ``TPU.BN_STATS``
  ``device0``, the same with ``mean``, and the FPD step with Adam and
  ``device0``.  Each is held against ``fhpe_tpu``'s SPMD step on a
  2-device mesh (``get_mesh(2)``) fed the same global batch and weights:
  loss, parameters, BN running statistics and the PCK counts.  The two
  ranks must be bit-equal to each other after every step, and after
  ``create_train_state``.
* (b) ``cli.fpd_train --device cpu`` under ``torchrun`` with 2 ranks: one
  epoch, then a second launch resumes (``tests/test_multihost.py``'s
  checks): the ranks log the same losses, rank 0 alone validates and
  writes the run directory, and both resume to the same epoch, best perf
  and parameters.
* (c) At world size 1 in this process (gloo, a ``FileStore``) the FPD
  step equals the step without a process group, bit for bit.
* (d) The loader's process slices, concatenated, are the global batch.
* (e) What is refused: ``TPU.NUM_DEVICES`` above 1 outside ``torchrun``,
  one that is not the world size (from the launch of (a)), a bad
  ``TPU.BN_STATS`` (the text of ``fhpe_tpu``'s refusal).

Tolerances: float64 on both sides, each tensor held to ``X64_RTOL`` of
its own max (``tests/test_torch_train.py``); with Adam a parameter whose
gradient is a rounding-level near-zero at either step (below
``SMALL_GRAD`` of its tensor's max) may move the other way, so those are
left out, and the rest are held to ``X64_RTOL`` of lr per step.
"""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from fhpe_tpu.config import load_config as load_config_jax
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.parallel.mesh import get_mesh, replicated, shard_batch
from fhpe_tpu.train import step as step_jax
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.data import (BatchLoader, PoseDataSource, dataset_meta,
                                 make_synthetic_db, make_synthetic_mpii)
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.ops.decode_cases import decision_margin
from fhpe_tpu_torch.train import (create_train_state, make_fpd_train_step,
                                  make_train_step)
from fhpe_tpu_torch.utils import checkpoint as ck
from fhpe_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_device_warp import _jax_train_state, _seeded_variables
from test_torch_train import (SMALL_GRAD, STUDENT_YAML, TEACHER_YAML,
                              X64_RTOL, _held, _nchw, _raw_batch)
from torch_threads import child_env, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, J, B, STEPS = 64, 16, 4, 2
LAUNCH_TIMEOUT_S = 120
SGD = ["TRAIN.OPTIMIZER", "sgd", "TRAIN.NESTEROV", "True",
       "TRAIN.MOMENTUM", "0.9", "TRAIN.WD", "0.0001", "TRAIN.LR", "0.01"]


def _opts(stacks, feats, extra=()):
    return ["MODEL.IMAGE_SIZE", f"[{HW},{HW}]",
            "MODEL.HEATMAP_SIZE", f"[{HW // 4},{HW // 4}]",
            "MODEL.EXTRA.NUM_STACKS", str(stacks),
            "MODEL.EXTRA.NUM_FEATURES", str(feats),
            "TPU.COMPUTE_DTYPE", "float64", "TPU.DEAD_BIAS_SKIP", "True",
            *extra]


def _torchrun(args, env=None):
    """``torchrun --standalone --nproc_per_node 2 <args>``, started in a
    session of its own so that a timeout kills its children too."""
    env = child_env(dict(os.environ, **(env or {})))
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(proc) -> str:
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-6000:]
    return out


# -- (a) the steps against fhpe_tpu's on a 2-device mesh ----------------------

def _batches(cfg_j, seed):
    """Global batches through fhpe_tpu's preprocessor (normalized images,
    Gaussian targets), NHWC numpy."""
    prep = step_jax.make_batch_preprocessor(cfg_j)
    out = []
    for s in range(STEPS):
        b = prep({k: jnp.asarray(v)
                  for k, v in _raw_batch(seed=seed + s).items()})
        out.append({k: np.asarray(b[k], np.float64) if k == "image"
                    else np.asarray(b[k])
                    for k in ("image", "target", "target_weight")})
    return out


def _nchw_torch(batch):
    return {"image": torch.from_numpy(_nchw(batch["image"]).copy()),
            "target": torch.from_numpy(_nchw(batch["target"]).copy()),
            "target_weight": torch.from_numpy(
                np.array(batch["target_weight"]))}


CASES = {
    # name: (student opts, teacher or None, weight seeds, batch seed)
    "plain_device0": (SGD + ["TPU.BN_STATS", "device0"], False, 61, 71),
    "plain_mean": (SGD + ["TPU.BN_STATS", "mean"], False, 62, 72),
    "fpd_device0": (["TPU.BN_STATS", "device0"], True, 63, 73),
}


def _case(name):
    """A case's configs (both packages), float64 weights (the port's
    hourglass from a seed, imported by ``fhpe_tpu``'s importer: no JAX
    init) and global batches."""
    extra, fpd, wseed, bseed = CASES[name]
    opts = _opts(1, 16, extra)
    cfg_j = load_config_jax(str(STUDENT_YAML), opts)
    case = {"name": name, "student": (str(STUDENT_YAML), opts),
            "teacher": None, "cfg_j": cfg_j,
            "svars": _seeded_variables(
                load_config(str(STUDENT_YAML), opts), wseed),
            "batches": _batches(cfg_j, bseed)}
    if fpd:
        topts = _opts(1, 16)
        case.update(teacher=(str(TEACHER_YAML), topts),
                    tcfg_j=load_config_jax(str(TEACHER_YAML), topts),
                    tvars=_seeded_variables(
                        load_config(str(TEACHER_YAML), topts), wseed + 100))
    return case


def _copy_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_run(case):
    """fhpe_tpu's step on get_mesh(2): per step {loss..., per_joint_acc,
    acc, acc_cnt, output, params, stats, mu} as numpy copies (the step
    donates its state)."""
    mesh = get_mesh(2)
    cfg_j = case["cfg_j"]
    smodel = get_pose_net_jax(cfg_j, dtype=jnp.float64)
    # placed as the step returns it, so that its second call does not
    # compile again for another input sharding
    state = jax.device_put(_jax_train_state(cfg_j, case["svars"]),
                           replicated(mesh))
    if case["teacher"] is None:
        step = step_jax.make_train_step(smodel, cfg_j, mesh, True,
                                        debug_outputs=True)
        extra = ()
    else:
        tmodel = get_pose_net_jax(case["tcfg_j"], dtype=jnp.float64)
        step = step_jax.make_fpd_train_step(
            smodel, tmodel, cfg_j, mesh, True, True, debug_outputs=True,
            teacher_cfg=case["tcfg_j"])
        extra = (jax.device_put(case["tvars"], replicated(mesh)),)
    out = []
    for batch in case["batches"]:
        state, m = step(state, *extra, shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in batch.items()}))
        rec = {k: np.array(v) for k, v in m.items()}
        rec.update(params=_copy_tree(state.params),
                   stats=_copy_tree(state.batch_stats))
        if case["teacher"] is not None:
            rec["mu"] = _copy_tree(state.opt_state.inner_state[0].mu)
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """The 2-rank launch (started first, so that it runs while JAX
    compiles its side) and fhpe_tpu's runs of the same cases."""
    tmp = tmp_path_factory.mktemp("ddp")
    with jax.enable_x64(True):
        cases = [_case(name) for name in CASES]
        torch.save({"cases": [{
            "name": c["name"], "student": c["student"],
            "teacher": c["teacher"],
            "student_weights": state_dict_from_jax(
                load_config(*c["student"]), c["svars"]),
            "teacher_weights": None if c["teacher"] is None else
            state_dict_from_jax(load_config(*c["teacher"]), c["tvars"]),
            "batches": [_nchw_torch(b) for b in c["batches"]]}
            for c in cases]}, tmp / "cases.pt")
        proc = _torchrun(["-m", "fhpe_tpu_torch.tools.ddp_parity",
                          "--cases", str(tmp / "cases.pt"),
                          "--out", str(tmp / "out")])
        try:
            ref = {c["name"]: _jax_run(c) for c in cases}
        except BaseException:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
        _finish(proc)
    ranks = [torch.load(tmp / "out" / f"rank{r}.pt", weights_only=True)
             for r in (0, 1)]
    return {c["name"]: c for c in cases}, ref, ranks


def _assert_bit_equal(a: dict, b: dict, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], dict):
            _assert_bit_equal(a[k], b[k], f"{what} {k}")
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), f"{what} {k}"
        else:
            assert a[k] == b[k], f"{what} {k}"


def test_ranks_start_equal_and_refuse_other_device_counts(ddp_run):
    ranks = ddp_run[2]
    _assert_bit_equal(ranks[0]["created"], ranks[1]["created"], "created")
    for r in ranks:
        assert r["refusal"] == ("TPU.NUM_DEVICES 3 but the world size is "
                                "2; set it to -1 or 2")


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_steps_match_fhpe_tpu_mesh(ddp_run, name):
    cases, refs, ranks = ddp_run
    case, ref = cases[name], refs[name]
    cfg_t = load_config(*case["student"])
    lr = float(cfg_t.TRAIN.LR)
    live = None
    for s in range(STEPS):
        got = ranks[0][name][s]
        for key in ("metrics", "model", "optimizer"):
            _assert_bit_equal(got[key], ranks[1][name][s][key],
                              f"{name} step {s} rank 0 vs 1 {key}")
        m, r = got["metrics"], ref[s]
        keys = ("loss",) if case["teacher"] is None else (
            "loss", "pose_loss", "kd_loss")
        for k in keys:
            np.testing.assert_allclose(m[k].item(), float(r[k]),
                                       rtol=X64_RTOL, err_msg=f"{s} {k}")
        # the PCK counts decide by argmax: no near-tie in the outputs
        assert decision_margin(_nchw(r["output"])).min() > 1e-6
        np.testing.assert_array_equal(
            m["per_joint_acc"].numpy(),
            r["per_joint_acc"].astype(m["per_joint_acc"].numpy().dtype))
        assert m["acc"].item() == pytest.approx(float(r["acc"]), abs=1e-6)
        assert int(m["acc_cnt"]) == int(r["acc_cnt"])

        sd = got["model"]
        want = state_dict_from_jax(cfg_t, {"params": r["params"],
                                           "batch_stats": r["stats"]})
        stats = [k for k in want
                 if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            _held(sd[k], want[k], X64_RTOL, f"{s} {k}")
        params = [k for k in want if k not in stats
                  and not k.endswith("num_batches_tracked")]
        if case["teacher"] is None:        # SGD: linear in the gradient
            for k in params:
                _held(sd[k], want[k], X64_RTOL, f"{s} {k}")
            continue
        # Adam: the gradient of this step from the moments (mu = 0.9 mu'
        # + 0.1 g); elements near zero at any step so far are left out
        mu = state_dict_from_jax(cfg_t, {"params": r["mu"],
                                         "batch_stats": r["stats"]})
        prev = (state_dict_from_jax(cfg_t, {"params": ref[s - 1]["mu"],
                                            "batch_stats": r["stats"]})
                if s else None)
        step_live = {}
        for k in params:
            g = (mu[k] - (0.9 * prev[k] if s else 0)) / 0.1
            step_live[k] = g.abs() >= SMALL_GRAD * g.abs().max()
        live = step_live if live is None else {
            k: live[k] & step_live[k] for k in params}
        for k in params:
            assert live[k].any(), k
            diff = (sd[k] - want[k]).abs()[live[k]]
            assert (diff <= X64_RTOL * lr * (s + 1)).all(), \
                (s, k, diff.max().item())


# -- (b) cli.fpd_train under torchrun, then a resume --------------------------

def _rank_lines(out: str, log: str):
    """(rank 0's lines from its running.log, rank 1's from the console),
    each without its timestamp."""
    def strip(lines):
        return [ln.split(" ", 2)[2] for ln in lines if ln.count(" ") >= 2]
    r1 = [ln.split("[rank 1] ", 1)[1] for ln in out.splitlines()
          if "[rank 1] " in ln]
    return strip(log.splitlines()), r1


def _losses(lines):
    """What each train log line says past its timing: the losses and the
    accuracy."""
    return [ln.split("samples/s", 1)[1] for ln in lines
            if ln.startswith("Epoch: [") and "Loss" in ln]


def test_two_rank_fpd_cli_and_resume(tmp_path):
    root = tmp_path / "mpii"
    make_synthetic_mpii(str(root), "train", 8, (96, 96), seed=1)
    make_synthetic_mpii(str(root), "valid", 6, (96, 96), seed=2)
    from test_torch_cli import _fpd_yamls
    scfg, tcfg = _fpd_yamls(tmp_path, str(root), teacher_features=16)
    torch.manual_seed(7)
    teacher = str(tmp_path / "teacher.pth")
    ck.save_weights(teacher, get_pose_net(load_config(tcfg)))
    argv = ["-m", "fhpe_tpu_torch.cli.fpd_train", "--cfg", scfg,
            "--tcfg", tcfg, "--device", "cpu", "KD.TEACHER", teacher,
            "TRAIN.BATCH_SIZE_PER_GPU", "2", "TPU.NUM_DEVICES", "2",
            "AUTO_RESUME", "True"]
    env = {"FHPE_RUN_TAG": "ddp"}

    out = _finish(_torchrun(argv + ["TRAIN.END_EPOCH", "1"], env))
    (run,) = (tmp_path / "out" / "mpii" / "hourglass").iterdir()
    assert sorted(p.name for p in run.iterdir()) == sorted([
        ck.CKPT_NAME, ck.BEST_NAME, ck.FINAL_NAME, ck.META_NAME,
        "config.yaml", "teacher_config.yaml", "running.log", "pred.mat"])
    r0, r1 = _rank_lines(out, (run / "running.log").read_text())
    assert "device: cpu, rank 0 of world size 2, backend gloo" in r0
    assert "device: cpu, rank 1 of world size 2, backend gloo" in r1
    # a global batch of 4 over 8 images: 2 steps, logged alike by both
    assert len(_losses(r0)) == 2 and _losses(r0) == _losses(r1)
    # rank 0 alone validates (teacher, student, after the epoch) and saves
    assert sum(ln.startswith("Test: loss") for ln in r0) == 3
    assert not any(ln.startswith(("Test", "=> saving", "=> saved"))
                   for ln in r1)
    saved = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert (saved["epoch"], saved["step"]) == (1, 2)

    out = _finish(_torchrun(argv + ["TRAIN.END_EPOCH", "2"], env))
    r0, r1 = _rank_lines(out, (run / "running.log").read_text())
    resumed = [[ln for ln in lines if ln.startswith("=> auto-resumed")]
               for lines in (r0, r1)]
    assert len(resumed[0]) == len(resumed[1]) == 1
    assert resumed[0] == resumed[1]
    assert re.match(r"=> auto-resumed from epoch 1 \(best perf \S+, step 2, "
                    r"parameter sum \S+\)$", resumed[0][0])
    # rank 0's log holds both launches: the resumed epoch's 2 steps last
    assert _losses(r0)[-2:] == _losses(r1)[-2:]
    assert len(_losses(r1)) == 2
    saved = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert (saved["epoch"], saved["step"]) == (2, 4)


# -- (c) world size 1 in this process ----------------------------------------

def test_world_size_one_step_equals_no_group(tmp_path):
    """FPD steps with every collective run on a 1-rank gloo group (both
    BN_STATS modes) against the same steps without a group: bit-equal
    metrics, weights, BN buffers and Adam state."""
    scfg = load_config(str(STUDENT_YAML), _opts(
        1, 16, ["TPU.COMPUTE_DTYPE", "float32"]))
    tcfg = load_config(str(TEACHER_YAML), _opts(
        1, 16, ["TPU.COMPUTE_DTYPE", "float32"]))
    torch.manual_seed(3)
    teacher = get_pose_net(tcfg).eval().requires_grad_(False)
    batches = [_nchw_torch({k: np.asarray(v, np.float32) for k, v in
                            b.items()})
               for b in _batches(load_config_jax(str(STUDENT_YAML),
                                                 _opts(1, 16)), 81)]

    def run(bn_stats):
        state = create_train_state(scfg, seed=5, device="cpu")
        step = make_fpd_train_step(scfg, teacher, tcfg, bn_stats=bn_stats)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append(m)
        return out, state

    plain = run("device0")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        grouped = {mode: run(mode) for mode in ("device0", "mean")}
    finally:
        dist.destroy_process_group()
    for mode, (metrics, state) in grouped.items():
        for s, (a, b) in enumerate(zip(metrics, plain[0])):
            _assert_bit_equal(a, b, f"{mode} step {s}")
        _assert_bit_equal(state.model.state_dict(),
                          plain[1].model.state_dict(), mode)
        _assert_bit_equal(state.optimizer.state_dict()["state"],
                          plain[1].optimizer.state_dict()["state"], mode)
        assert state.step == plain[1].step == STEPS


# -- (d) the loader's process slices ----------------------------------------

def test_loader_slices_concatenate_to_the_global_batch(tmp_path):
    """Two ``BatchLoader``s at process_index 0 and 1 of 2 (global batch 4,
    shuffled from one seed): each yields 2 rows of every global batch, and
    the two slices, concatenated, are the single-process batch."""
    cfg = load_config(str(STUDENT_YAML), _opts(1, 16))
    db = make_synthetic_db(str(tmp_path), num_samples=10, image_hw=(80, 96))
    meta = dataset_meta("mpii")

    def batches(index, count):
        src = PoseDataSource(cfg, db, is_train=False,
                             flip_pairs=meta["flip_pairs"],
                             upper_body_ids=meta["upper_body_ids"])
        loader = BatchLoader(src, batch_size=4, shuffle=True, drop_last=True,
                             host_targets=True, num_threads=2, seed=3,
                             process_index=index, process_count=count)
        try:
            return list(loader)
        finally:
            loader.close()

    whole = batches(0, 1)
    parts = [batches(i, 2) for i in (0, 1)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for full, a, b in zip(whole, *parts):
        assert a["image"].shape[0] == b["image"].shape[0] == 2
        assert a["image_path"] + b["image_path"] == full["image_path"]
        for key in ("image", "joints", "joints_vis", "target",
                    "target_weight", "center", "scale"):
            np.testing.assert_array_equal(
                np.concatenate([a[key], b[key]]), full[key], err_msg=key)


# -- (e) refusals ------------------------------------------------------------

def test_refusals(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = load_config(str(STUDENT_YAML), _opts(
        1, 16, ["TPU.COMPUTE_DTYPE", "float32", "TPU.NUM_DEVICES", "2"]))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        create_train_state(cfg, device="cpu")
    for ok in ("-1", "1"):
        cfg.defrost()
        cfg.TPU.NUM_DEVICES = int(ok)
        create_train_state(cfg, device="cpu")
    cfg.TPU.BN_STATS = "local"
    cfg_j = load_config_jax(str(STUDENT_YAML), ["TPU.BN_STATS", "local"])
    with pytest.raises(ValueError) as ref:
        step_jax._resolve_bn_stats(cfg_j, None)
    for make in (lambda: make_train_step(cfg),
                 lambda: make_fpd_train_step(cfg, get_pose_net(cfg))):
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(ref.value)
