"""Carry ``fhpe_tpu`` (flax) weights over to the port.

:func:`state_dict_from_jax` is the inverse of
``fhpe_tpu.utils.torch_import.import_hourglass``, ``import_hrnet`` and
``import_pose_resnet``: it walks the same name mapping the other way, so
one weight set drives both forwards.
:func:`adam_state_from_jax` carries optax Adam's moments over by the same
mapping.  Both take the flax trees as numpy and need no JAX.
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
    """float32, or float64 for float64 leaves (parity runs)."""
    a = np.asarray(a)
    return torch.tensor(a if a.dtype == np.float64 else a.astype(np.float32))


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


def adam_state_from_jax(cfg, optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module, count: int, mu: dict,
                        nu: dict) -> dict:
    """optax Adam's state (``count`` and the ``mu``/``nu`` trees, numpy
    leaves) -> a ``state_dict`` for ``optimizer``, a ``torch.optim.Adam``
    over ``model.parameters()``: ``exp_avg`` = mu, ``exp_avg_sq`` = nu,
    ``step`` = count, by the parameter name mapping of
    :func:`state_dict_from_jax`.  Load it with
    ``optimizer.load_state_dict``."""
    m, v = _param_tensors(cfg, mu), _param_tensors(cfg, nu)
    state = {i: {"step": torch.tensor(float(count)), "exp_avg": m[name],
                 "exp_avg_sq": v[name]}
             for i, (name, _) in enumerate(model.named_parameters())}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}
