"""Stochastic depth's keep flags, drawn on the host with the batches.

ViTPose (``models/vit_pose.py``) drops each block's two residual branches
per sample with a probability rising linearly over the blocks, from 0 to
``MODEL.EXTRA.DROP_PATH_RATE``.  The draws are made here, on the thread
that iterates the loader, in batch order, as the augmentation draws are
(``BatchLoader._submit``): a train step then takes them as a batch input
(``drop_path_keep``, uploaded with the rest by ``cli/common.py::
device_batch``), its captured graph holds no random state, and a
reference can be handed the same flags.
"""

from __future__ import annotations

import numpy as np

from ..models.common import drop_rates

KEY = "drop_path_keep"


def drop_path_rate(cfg) -> float:
    """``MODEL.EXTRA.DROP_PATH_RATE``, 0 where the model has none."""
    return float(cfg.MODEL.EXTRA.get("DROP_PATH_RATE", 0.0))


def draw_keep(rng: np.random.RandomState, n: int, rates) -> np.ndarray:
    """(n, depth, 2) float32 flags, 1 where a sample keeps a block's
    branch (the attention's, then the MLP's), each kept with probability
    ``1 - rates[block]``."""
    rates = np.asarray(rates, np.float64)
    return (rng.random_sample((n, len(rates), 2))
            >= rates[None, :, None]).astype(np.float32)


class KeepFlags:
    """``loader``'s batches, each with its :data:`KEY` flags for the
    ``cfg``'s depth and rate.  Every process draws the flags of the whole
    global batch from ``seed`` and keeps the rows of its own slice, as
    every process draws the same sample order; the loader's length, source
    and ``close`` are its own."""

    def __init__(self, loader, cfg, seed: int = 0):
        self.loader = loader
        self.source = loader.source
        self.rates = drop_rates(int(cfg.MODEL.EXTRA.DEPTH),
                                drop_path_rate(cfg))
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.loader)

    def close(self):
        self.loader.close()

    def __iter__(self):
        loader = self.loader
        local = loader.batch_size // loader.process_count
        lo = loader.process_index * local
        for batch in loader:
            flags = draw_keep(self.rng, loader.batch_size, self.rates)
            n = len(batch["joints"])
            yield {**batch, KEY: flags[lo:lo + n]}
