"""Carry ``fhpe_tpu`` (flax) weights over to the port.

:func:`state_dict_from_jax` is the inverse of
``fhpe_tpu.utils.torch_import.import_hourglass``: it walks the same name
mapping the other way, so one weight set drives both forwards.  It takes
the flax tree as numpy and needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


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


def _get(tree: dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_jax(cfg, variables: dict) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree (numpy leaves) -> state_dict.

    Conv kernels HWIO -> OIHW; BN ``scale/bias/mean/var`` ->
    ``weight/bias/running_mean/running_var``; ``num_batches_tracked`` = 0.
    A conv without a bias in the tree (``TPU.DEAD_BIAS_SKIP``) gets none.
    """
    if cfg.MODEL.NAME != "hourglass":
        raise NotImplementedError(
            f"state_dict_from_jax: MODEL.NAME '{cfg.MODEL.NAME}' is not "
            f"ported yet (ROADMAP.md queue A, item 9)")
    params, stats = variables["params"], variables["batch_stats"]
    extra = cfg.MODEL.EXTRA

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for kind, tkey, path in _hourglass_layers(extra.NUM_STACKS,
                                              extra.NUM_BLOCKS):
        if kind == "conv":
            leaf = _get(params, path + ("Conv_0",))
            sd[f"{tkey}.weight"] = t(np.transpose(leaf["kernel"],
                                                  (3, 2, 0, 1)))
            if "bias" in leaf:
                sd[f"{tkey}.bias"] = t(leaf["bias"])
        else:
            p = _get(params, path + ("BatchNorm_0",))
            s = _get(stats, path + ("BatchNorm_0",))
            sd[f"{tkey}.weight"] = t(p["scale"])
            sd[f"{tkey}.bias"] = t(p["bias"])
            sd[f"{tkey}.running_mean"] = t(s["mean"])
            sd[f"{tkey}.running_var"] = t(s["var"])
            sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0)
    return sd
