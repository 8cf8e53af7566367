"""Carry ``fhpe_tpu`` (flax) weights over to the port.

:func:`state_dict_from_jax` is the inverse of
``fhpe_tpu.utils.torch_import.import_hourglass``, ``import_hrnet`` and
``import_pose_resnet``: it walks the same name mapping the other way, so
one weight set drives both forwards.  :func:`variables_from_state_dict`
walks it back, a state_dict to ``fhpe_tpu``'s tree (what its
``.msgpack`` weight files hold).
:func:`adam_state_from_jax` carries optax Adam's moments over by the same
mapping, and :func:`optimizer_state_from_jax` Adam's or SGD's state as
``fhpe_tpu``'s checkpoints hold it; :func:`checkpoint_tree_from_state`
writes a port train state in that checkpoint's layout.  All take or give
the flax trees as numpy and need no JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..models.pose_resnet import RESNET_SPEC


def _bottleneck(tprefix: str, path: Tuple[str, ...], downsample: bool):
    for bn in ("bn1", "bn2", "bn3"):
        yield "bn", f"{tprefix}.{bn}", path + (bn,)
    for cv in ("conv1", "conv2", "conv3"):
        yield "conv", f"{tprefix}.{cv}", path + (cv,)
    if downsample:
        yield "conv", f"{tprefix}.downsample.0", path + ("downsample",)


def _hourglass_layers(num_stacks: int, num_blocks: int,
                      depth: int = 4) -> Iterator[Tuple[str, str, tuple]]:
    """(kind, torch prefix, flax path) for every conv / BN of the hourglass.

    Mirrors ``import_hourglass`` (``fhpe_tpu/utils/torch_import.py``):
    ``hg.{s}.hg.{n}.{j}.{b}`` with ``n = level - 1`` and ``j`` 0 = up1,
    1 = low1, 2 = low3, 3 = low2 (innermost only).  Only the first block
    of layer1 and layer2 changes the channel count.
    """
    yield "conv", "conv1", ("conv1",)
    yield "bn", "bn1", ("bn1",)
    for k in (1, 2, 3):
        yield from _bottleneck(f"layer{k}.0", (f"layer{k}", "block0"),
                               downsample=k < 3)
    jmap = {0: "up1", 1: "low1", 2: "low3"}
    for s in range(num_stacks):
        for n in range(depth):
            for j, stem in jmap.items():
                for b in range(num_blocks):
                    yield from _bottleneck(
                        f"hg.{s}.hg.{n}.{j}.{b}",
                        (f"hg{s}", f"{stem}_{n + 1}", f"block{b}"), False)
        for b in range(num_blocks):
            yield from _bottleneck(f"hg.{s}.hg.0.3.{b}",
                                   (f"hg{s}", "low2_base", f"block{b}"), False)
        for b in range(num_blocks):
            yield from _bottleneck(f"res.{s}.{b}", (f"res{s}", f"block{b}"),
                                   False)
        yield "conv", f"fc.{s}.0", (f"fc{s}_conv",)
        yield "bn", f"fc.{s}.1", (f"fc{s}_bn",)
        yield "conv", f"score.{s}", (f"score{s}",)
        if s < num_stacks - 1:
            yield "conv", f"fc_.{s}", (f"fc_{s}",)
            yield "conv", f"score_.{s}", (f"score_{s}",)


def _postact_block(tprefix: str, path: Tuple[str, ...], kind: str,
                   downsample: bool):
    """HRNet BasicBlock / Bottleneck, as ``_import_block_postact``."""
    n = 2 if kind == "BASIC" else 3
    for k in range(1, n + 1):
        yield "conv", f"{tprefix}.conv{k}", path + (f"conv{k}",)
        yield "bn", f"{tprefix}.bn{k}", path + (f"bn{k}",)
    if downsample:
        yield "conv", f"{tprefix}.downsample.0", path + ("ds_conv",)
        yield "bn", f"{tprefix}.downsample.1", path + ("ds_bn",)


def _hrnet_layers(extra) -> Iterator[Tuple[str, str, tuple]]:
    """(kind, torch prefix, flax path) for every conv / BN of HRNet.

    Mirrors ``import_hrnet`` (``fhpe_tpu/utils/torch_import.py``): torch
    ``transition{s-1}`` builds stage ``s``'s inputs (flax
    ``transition{s}``), ``stage{s}.{m}`` is flax ``stage{s}_m{m}``, and the
    last stage-4 module fuses into branch 0 only.
    """
    yield "conv", "conv1", ("conv1",)
    yield "bn", "bn1", ("bn1",)
    yield "conv", "conv2", ("conv2",)
    yield "bn", "bn2", ("bn2",)
    for b in range(4):
        yield from _postact_block(f"layer1.{b}", ("layer1", f"b{b}"),
                                  "BOTTLENECK", downsample=b == 0)
    prev = [256]
    for s in (2, 3, 4):
        scfg = extra[f"STAGE{s}"]
        kind = scfg["BLOCK"]
        exp = 1 if kind == "BASIC" else 4
        cur = [c * exp for c in scfg["NUM_CHANNELS"]]
        tn, tpath = f"transition{s - 1}", f"transition{s}"
        for i, ch in enumerate(cur):
            if i < len(prev):
                if ch != prev[i]:
                    yield "conv", f"{tn}.{i}.0", (tpath, f"t{i}_conv")
                    yield "bn", f"{tn}.{i}.1", (tpath, f"t{i}_bn")
                continue
            for k in range(i + 1 - len(prev)):
                yield "conv", f"{tn}.{i}.{k}.0", (tpath, f"t{i}_conv{k}")
                yield "bn", f"{tn}.{i}.{k}.1", (tpath, f"t{i}_bn{k}")
        nb, n = len(cur), scfg["NUM_MODULES"]
        for m in range(n):
            mpath = f"stage{s}_m{m}"
            for b in range(nb):
                for blk in range(scfg["NUM_BLOCKS"][b]):
                    yield from _postact_block(
                        f"stage{s}.{m}.branches.{b}.{blk}",
                        (mpath, f"branch{b}", f"b{blk}"), kind, False)
            n_out = 1 if s == 4 and m == n - 1 else nb
            for i in range(n_out if nb > 1 else 0):
                for j in range(nb):
                    base, fpath = (f"stage{s}.{m}.fuse_layers.{i}.{j}",
                                   (mpath, f"fuse{i}_{j}"))
                    if j > i:
                        yield "conv", f"{base}.0", fpath + ("conv",)
                        yield "bn", f"{base}.1", fpath + ("bn",)
                    for k in range(i - j):
                        yield "conv", f"{base}.{k}.0", fpath + (f"conv{k}",)
                        yield "bn", f"{base}.{k}.1", fpath + (f"bn{k}",)
        prev = cur
    yield "conv", "final_layer", ("final_layer",)


def _pose_resnet_layers(extra) -> Iterator[Tuple[str, str, tuple]]:
    """(kind, torch prefix, flax path) for every conv, transposed conv and
    BN of PoseResNet.

    Mirrors ``import_pose_resnet`` (``fhpe_tpu/utils/torch_import.py``):
    ``layer{i}.{b}`` is flax ``layer{i}/b{b}``, the first block of a layer
    projects where the stride or the width changes, and torch
    ``deconv_layers.{3i,3i+1}`` are flax ``deconv{i}`` / ``deconv{i}_bn``.
    """
    block, layers = RESNET_SPEC[extra.NUM_LAYERS]
    exp = block.expansion
    kind = "BASIC" if exp == 1 else "BOTTLENECK"
    yield "conv", "conv1", ("conv1",)
    yield "bn", "bn1", ("bn1",)
    inplanes = 64
    for li, n in enumerate(layers):
        planes = 64 * 2 ** li
        for b in range(n):
            yield from _postact_block(
                f"layer{li + 1}.{b}", (f"layer{li + 1}", f"b{b}"), kind,
                downsample=b == 0 and (li > 0 or inplanes != planes * exp))
        inplanes = planes * exp
    for i in range(extra.NUM_DECONV_LAYERS):
        yield "deconv", f"deconv_layers.{3 * i}", (f"deconv{i}",)
        yield "bn", f"deconv_layers.{3 * i + 1}", (f"deconv{i}_bn",)
    yield "conv", "final_layer", ("final_layer",)


def _get(tree: dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _layers(cfg) -> Iterator[Tuple[str, str, tuple]]:
    extra = cfg.MODEL.EXTRA
    if cfg.MODEL.NAME == "hourglass":
        return _hourglass_layers(extra.NUM_STACKS, extra.NUM_BLOCKS)
    if cfg.MODEL.NAME == "pose_hrnet":
        return _hrnet_layers(extra)
    if cfg.MODEL.NAME == "pose_resnet":
        return _pose_resnet_layers(extra)
    raise KeyError(f"state_dict_from_jax: unknown MODEL.NAME "
                   f"'{cfg.MODEL.NAME}'")


def _t(a) -> torch.Tensor:
    """float32, or float64 for float64 leaves (parity runs), in memory of
    its own (``torch.tensor`` of a transposed array copies element by
    element: seconds for a full-width model)."""
    a = np.asarray(a)
    dtype = np.float64 if a.dtype == np.float64 else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, order="C", copy=True))


def _param_tensors(cfg, params: dict) -> Dict[str, torch.Tensor]:
    """A tree shaped like flax ``params`` (the parameters, or an optimizer
    moment of them) -> torch parameter name -> tensor."""
    out: Dict[str, torch.Tensor] = {}
    for kind, tkey, path in _layers(cfg):
        if kind == "conv":
            leaf = _get(params, path + ("Conv_0",))
            out[f"{tkey}.weight"] = _t(np.transpose(leaf["kernel"],
                                                    (3, 2, 0, 1)))
            if "bias" in leaf:
                out[f"{tkey}.bias"] = _t(leaf["bias"])
        elif kind == "deconv":
            # flax ConvTranspose (KH, KW, I, O) with the kernel flipped in
            # KH and KW (torch_import._deconv_w) -> torch (I, O, KH, KW)
            leaf = _get(params, path + ("ConvTranspose_0",))
            out[f"{tkey}.weight"] = _t(np.ascontiguousarray(np.transpose(
                np.asarray(leaf["kernel"])[::-1, ::-1], (2, 3, 0, 1))))
            if "bias" in leaf:
                out[f"{tkey}.bias"] = _t(leaf["bias"])
        else:
            leaf = _get(params, path + ("BatchNorm_0",))
            out[f"{tkey}.weight"] = _t(leaf["scale"])
            out[f"{tkey}.bias"] = _t(leaf["bias"])
    return out


def state_dict_from_jax(cfg, variables: dict) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree (numpy leaves) -> state_dict.

    Conv kernels HWIO -> OIHW; transposed-conv kernels flipped back and
    (KH, KW, I, O) -> (I, O, KH, KW); BN ``scale/bias/mean/var`` ->
    ``weight/bias/running_mean/running_var``; ``num_batches_tracked`` = 0.
    A conv without a bias in the tree (``TPU.DEAD_BIAS_SKIP``) gets none.
    """
    sd = _param_tensors(cfg, variables["params"])
    stats = variables["batch_stats"]
    for kind, tkey, path in _layers(cfg):
        if kind == "bn":
            s = _get(stats, path + ("BatchNorm_0",))
            sd[f"{tkey}.running_mean"] = _t(s["mean"])
            sd[f"{tkey}.running_var"] = _t(s["var"])
            sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _put(tree: dict, path: Tuple[str, ...], leaf: dict) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def _param_tree(cfg, tensors) -> dict:
    """torch parameter name -> tensor (the parameters, or an optimizer
    moment of them) -> a tree shaped like flax ``params``, the inverse of
    :func:`_param_tensors`."""
    params: dict = {}
    for kind, tkey, path in _layers(cfg):
        if kind == "bn":
            _put(params, path + ("BatchNorm_0",), {
                "scale": _np(tensors[f"{tkey}.weight"]),
                "bias": _np(tensors[f"{tkey}.bias"])})
            continue
        w = _np(tensors[f"{tkey}.weight"])
        if kind == "conv":
            leaf = {"kernel": np.ascontiguousarray(np.transpose(w,
                                                                (2, 3, 1, 0)))}
            name = "Conv_0"
        else:
            leaf = {"kernel": np.ascontiguousarray(
                np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])}
            name = "ConvTranspose_0"
        if f"{tkey}.bias" in tensors:
            leaf["bias"] = _np(tensors[f"{tkey}.bias"])
        _put(params, path + (name,), leaf)
    return params


def variables_from_state_dict(cfg, state_dict) -> dict:
    """state_dict -> flax ``{"params", "batch_stats"}`` (numpy leaves), the
    inverse of :func:`state_dict_from_jax`.

    Conv kernels OIHW -> HWIO; transposed-conv kernels (I, O, KH, KW) ->
    (KH, KW, I, O) flipped in KH and KW; BN ``weight/bias`` -> ``scale/bias``
    in ``params`` and ``running_mean/running_var`` -> ``mean/var`` in
    ``batch_stats``; ``num_batches_tracked`` is dropped.  A conv without a
    bias in the state_dict gets none in the tree.
    """
    stats: dict = {}
    for kind, tkey, path in _layers(cfg):
        if kind == "bn":
            _put(stats, path + ("BatchNorm_0",), {
                "mean": _np(state_dict[f"{tkey}.running_mean"]),
                "var": _np(state_dict[f"{tkey}.running_var"])})
    return {"params": _param_tree(cfg, state_dict), "batch_stats": stats}


def _moments(cfg, model: torch.nn.Module, tree: dict) -> list:
    """A tree shaped like flax ``params`` -> one tensor per parameter of
    ``model``, in ``model.parameters()`` order; zeros for a conv bias the
    tree lacks (``TPU.DEAD_BIAS_SKIP``), as :func:`state_dict_from_jax`'s
    readers give the weight itself."""
    named = _param_tensors(cfg, tree)
    dtype = next(iter(named.values())).dtype
    return [named[n] if n in named else torch.zeros(p.shape, dtype=dtype)
            for n, p in model.named_parameters()]


def adam_state_from_jax(cfg, optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module, count: int, mu: dict,
                        nu: dict) -> dict:
    """optax Adam's state (``count`` and the ``mu``/``nu`` trees, numpy
    leaves) -> a ``state_dict`` for ``optimizer``, a ``torch.optim.Adam``
    over ``model.parameters()``: ``exp_avg`` = mu, ``exp_avg_sq`` = nu,
    ``step`` = count, by the parameter name mapping of
    :func:`state_dict_from_jax`.  Load it with
    ``optimizer.load_state_dict``."""
    m, v = _moments(cfg, model, mu), _moments(cfg, model, nu)
    state = {i: {"step": torch.tensor(float(count)), "exp_avg": m[i],
                 "exp_avg_sq": v[i]} for i in range(len(m))}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


# The nodes of optax's state that ``fhpe_tpu``'s optimizers keep
# (``fhpe_tpu/train/state.py::make_optimizer``), by their fields: Adam's
# ``ScaleByAdamState`` and SGD's momentum ``TraceState``.  They are found
# by these keys wherever they sit: flax's ``to_state_dict`` names a named
# tuple's fields and numbers a tuple's items, and where the
# ``inject_hyperparams`` and ``chain`` wrappers put them is optax's own
# affair.
_OPTAX_NODES = {"adam": ("count", "mu", "nu"), "sgd": ("trace",)}


def _find_nodes(tree, keys) -> list:
    """Every dict in ``tree`` that holds all of ``keys``."""
    if not isinstance(tree, dict):
        return []
    found = [tree] if all(k in tree for k in keys) else []
    for v in tree.values():
        found += _find_nodes(v, keys)
    return found


def _optax_kind(opt_state: dict) -> str:
    """``"adam"`` or ``"sgd"``: which of ``fhpe_tpu``'s optimizers wrote
    ``opt_state`` (flax's ``to_state_dict`` of its optax state); raises
    where it is neither, or both."""
    kinds = {k: len(_find_nodes(opt_state, keys))
             for k, keys in _OPTAX_NODES.items()}
    found = [k for k, n in kinds.items() if n]
    if len(found) != 1 or kinds[found[0]] != 1:
        raise ValueError(f"an optax state with {kinds} of the nodes "
                         f"{_OPTAX_NODES}: not one of fhpe_tpu's optimizers")
    return found[0]


def optimizer_state_from_jax(cfg, optimizer: torch.optim.Optimizer,
                             model: torch.nn.Module, opt_state: dict) -> dict:
    """``fhpe_tpu``'s optax state (flax's ``to_state_dict`` of it, numpy
    leaves) -> a ``state_dict`` for ``optimizer`` over
    ``model.parameters()``, the optimizer ``cfg.TRAIN.OPTIMIZER`` names.

    Adam: ``exp_avg`` / ``exp_avg_sq`` / ``step`` are optax's ``mu`` /
    ``nu`` / ``count`` (:func:`adam_state_from_jax`).  SGD:
    ``momentum_buffer`` is optax's ``trace``, which with dampening 0 is
    torch's buffer, nesterov or not (``t = g + momentum * t`` on the
    decayed gradient in both).  A state of the other optimizer is
    refused, naming both."""
    kind, want = _optax_kind(opt_state), cfg.TRAIN.OPTIMIZER
    if kind != want:
        raise ValueError(f"the checkpoint holds {kind}'s optimizer state, "
                         f"but TRAIN.OPTIMIZER is {want}: resume with the "
                         f"optimizer the run was trained with")
    (node,) = _find_nodes(opt_state, _OPTAX_NODES[kind])
    if kind == "adam":
        return adam_state_from_jax(cfg, optimizer, model, int(node["count"]),
                                   node["mu"], node["nu"])
    trace = _moments(cfg, model, node["trace"])
    return {"state": {i: {"momentum_buffer": t} for i, t in enumerate(trace)},
            "param_groups": optimizer.state_dict()["param_groups"]}


def checkpoint_tree_from_state(cfg, model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer, step: int,
                               epoch: int, perf: float) -> dict:
    """A port train state as ``fhpe_tpu``'s ``checkpoint.msgpack`` payload
    (``fhpe_tpu/utils/checkpoint.py::save_checkpoint``: ``{epoch, perf,
    state: {step, params, batch_stats, opt_state}}``, numpy leaves), the
    inverse of what AUTO_RESUME reads from it; write it with
    ``utils/msgpack.packb``.  ``opt_state`` is flax's ``to_state_dict`` of
    ``fhpe_tpu``'s ``inject_hyperparams`` optax state for
    ``cfg.TRAIN.OPTIMIZER`` (held to the layout ``fhpe_tpu`` writes by
    ``tests/test_torch_resume_msgpack.py``), its rate the first group's,
    float64 where the parameters are (``fhpe_tpu`` under
    ``jax_enable_x64``).  BatchNorm's ``num_batches_tracked`` has no place
    in it."""
    variables = variables_from_state_dict(cfg, model.state_dict())
    saved = optimizer.state_dict()["state"]

    def tree(key):
        return _param_tree(cfg, {
            n: saved[i][key] if i in saved else torch.zeros(p.shape)
            for i, (n, p) in enumerate(model.named_parameters())})

    def i32(v):
        return np.asarray(int(v), np.int32)

    if cfg.TRAIN.OPTIMIZER == "adam":
        count = float(saved[0]["step"]) if 0 in saved else 0
        inner = {"0": {"count": i32(count), "mu": tree("exp_avg"),
                       "nu": tree("exp_avg_sq")}, "1": {}}
    else:
        inner = {"0": {}, "1": {"0": {"trace": tree("momentum_buffer")},
                                "1": {}}}
    wide = next(model.parameters()).dtype == torch.float64
    lr = np.asarray(float(optimizer.param_groups[0]["lr"]),
                    np.float64 if wide else np.float32)
    opt_state = {"count": i32(step), "hyperparams": {"learning_rate": lr},
                 "hyperparams_states": {}, "inner_state": inner}
    return {"epoch": int(epoch), "perf": float(perf),
            "state": {"step": i32(step), **variables,
                      "opt_state": opt_state}}
