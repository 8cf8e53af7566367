"""``MODEL.PRETRAINED``: an ImageNet trunk under a freshly built model.

Counterpart of ``fhpe_tpu/utils/torch_import.py::load_pretrained``
(reference ``init_weights``, pose_resnet.py:209-249,
pose_hrnet.py:462-492).  The port's modules carry the reference's torch
names, so the trunk checkpoint loads by name, ``load_state_dict(...,
strict=False)``, with no importer in between.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .checkpoint import load_model_weights


# a copy of fhpe_tpu's, pinned by tests/test_torch_port_hygiene.py
def filter_pretrained_layers(sd: Dict[str, np.ndarray], layers) -> dict:
    """HRNet PRETRAINED_LAYERS filter: keep torch keys whose first dotted
    component is listed, or everything if the list starts with '*'
    (reference pose_hrnet.py:484-489)."""
    if layers and layers[0] == "*":
        return dict(sd)
    keep = set(layers)
    return {k: v for k, v in sd.items() if k.split(".")[0] in keep}


def load_pretrained(cfg, model, logger=None) -> int:
    """Load ``cfg.MODEL.PRETRAINED`` into ``model`` where a key of the same
    name and shape exists; everything else keeps its fresh init.  HRNet
    keeps only the checkpoint keys under ``MODEL.EXTRA.PRETRAINED_LAYERS``
    first.  Does nothing when ``MODEL.INIT_WEIGHTS`` is off, the path is
    empty, or the model is the hourglass (the reference's has no pretrained
    path); a missing file logs a warning and does nothing (``fhpe_tpu``'s
    deviation from HRNet's ValueError, so synthetic runs of reference
    YAMLs proceed from random init).

    Returns the number of tensors loaded, counted as ``fhpe_tpu`` counts
    them: weights, biases and BN statistics, not ``num_batches_tracked``
    (which loads too)."""
    path = cfg.MODEL.PRETRAINED
    if not (cfg.MODEL.INIT_WEIGHTS and path):
        return 0
    if cfg.MODEL.NAME == "hourglass":
        return 0
    if not os.path.isfile(path):
        if logger:
            logger.warning(
                f"=> MODEL.PRETRAINED '{path}' not found — training from "
                f"RANDOM INIT. The reference relies on ImageNet-pretrained "
                f"trunks for its published accuracy; expect several AP/PCKh "
                f"points lower without them (pose_hrnet.py:490-492).")
        return 0
    if cfg.MODEL.NAME not in ("pose_hrnet", "pose_resnet"):
        raise KeyError(
            f"MODEL.PRETRAINED is not supported for '{cfg.MODEL.NAME}' (the "
            f"reference's hourglass has no pretrained path either, "
            f"hourglass.py:195)")
    sd = load_model_weights(path)
    if cfg.MODEL.NAME == "pose_hrnet":
        sd = filter_pretrained_layers(sd,
                                      list(cfg.MODEL.EXTRA.PRETRAINED_LAYERS))
    own = model.state_dict()
    match = {k: v for k, v in sd.items()
             if k in own and tuple(own[k].shape) == tuple(v.shape)}
    model.load_state_dict(match, strict=False)
    counted = [k for k in match if not k.endswith("num_batches_tracked")]
    if logger:
        logger.info(f"=> loaded {len(counted)} pretrained tensors from "
                    f"{path} ({len(sd) - len(match)} skipped)")
    return len(counted)
