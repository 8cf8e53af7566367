"""``cli/common.py::device_batch``'s upload: the ring of pinned staging
slots that a CUDA device takes (``PinnedRing``), driven on the CPU with
stand-in events and allocation, the CPU path's zero-copy views, the
upload counters, and on a card the ring against the pageable copy while
the stream is held back.

The card test runs where there is a card, from the repo root:
``python3 -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_upload_ring.py -q``; this file imports no JAX.
"""

import numpy as np
import pytest
import torch

from fhpe_tpu_torch.cli import common
from fhpe_tpu_torch.config import get_default_config

from torch_threads import torch_threads  # noqa: F401

B, H, W, J = 4, 8, 6, 16


def _host(seed, b=B, image_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (b, H, W, 3)).astype(image_dtype)
    return {"image": image,
            "joints": rng.uniform(-8, 64, (b, J, 2)).astype(np.float32),
            "joints_vis": (rng.uniform(size=(b, J)) > 0.1).astype(np.float32)}


class Log:
    """What the stand-ins did, in order: ("pin", id of the slot's event,
    shape), ("record", id), ("wait", id)."""

    def __init__(self, pending: bool):
        self.pending = pending      # whether every recorded copy is pending
        self.calls = []
        self.events = 0

    def pin(self, array, device):
        dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
        self.calls.append(("pin", self.events, array.shape))
        return torch.empty(array.shape, dtype=dtype)

    def event(self, device):
        log, eid = self, self.events
        self.events += 1

        class Event:
            recorded = False

            def record(self):
                self.recorded = True
                log.calls.append(("record", eid))

            def query(self):
                return not (self.recorded and log.pending)

            def synchronize(self):
                log.calls.append(("wait", eid))

        return Event()

    def of(self, kind):
        return [c[1] for c in self.calls if c[0] == kind]


def _ring(slots, pending):
    log = Log(pending)
    return common.PinnedRing(slots, pin=log.pin, event=log.event), log


def _cfg(preprocess=True):
    cfg = get_default_config()
    cfg.defrost()
    cfg.TPU.DEVICE_PREPROCESS = preprocess
    return cfg


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_slots_are_used_in_turn(slots):
    ring, log = _ring(slots, pending=False)
    n = 2 * slots + 1
    for i in range(n):
        ring.upload(_host(i), torch.device("cpu"))
    assert log.of("record") == [i % slots for i in range(n)]
    # each slot's buffers are made once, three arrays a slot
    assert len(log.of("pin")) == 3 * slots


@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("pending", [True, False])
def test_a_slot_waits_for_its_own_copy_before_it_is_restaged(slots,
                                                             pending):
    ring, log = _ring(slots, pending)
    waits = common.ring_waits
    n = 3 * slots
    for i in range(n):
        ring.upload(_host(i), torch.device("cpu"))
    restages = n - slots
    if not pending:
        assert log.of("wait") == [] and common.ring_waits == waits
        return
    # slot s waits after its own record and before its next one, and only
    # when it is restaged
    order = [c[:2] for c in log.calls if c[0] in ("record", "wait")]
    assert order == [x for i in range(n) for x in
                     ([("wait", i % slots)] if i >= slots else [])
                     + [("record", i % slots)]]
    assert common.ring_waits - waits == restages


@pytest.mark.parametrize("change", ["short_batch", "float_image",
                                    "eval_keys", "none"])
def test_a_slot_is_made_again_on_a_new_signature(change):
    ring, log = _ring(2, pending=True)
    cpu = torch.device("cpu")
    for i in range(2):
        ring.upload(_host(i), cpu)
    other = {"short_batch": _host(7, b=B - 1),
             "float_image": _host(7, image_dtype=np.float32),
             "eval_keys": {**_host(7), "inv_trans": np.zeros((B, 2, 3),
                                                             np.float32)},
             "none": _host(7)}[change]
    before = len(log.of("pin"))
    got = ring.upload(other, cpu)
    made = len(log.of("pin")) - before
    assert made == (0 if change == "none" else len(other))
    # the old slot 0's copy was waited for before its buffers were dropped
    assert log.calls[-made - 2] == ("wait", 0)
    for k, v in other.items():
        assert np.array_equal(got[k].numpy(), v) and got[k].dtype == \
            torch.from_numpy(v).dtype


@pytest.mark.parametrize("slots", [1, 2])
def test_uploads_equal_their_sources_and_alias_no_slot(slots):
    """Each upload returns fresh tensors equal to its own arrays, though
    the arrays are overwritten and the slots restaged after it."""
    ring, _ = _ring(slots, pending=False)
    sources, got = [_host(i) for i in range(3 * slots)], []
    want = [{k: v.copy() for k, v in s.items()} for s in sources]
    for s in sources:
        got.append(ring.upload(s, torch.device("cpu")))
        for v in s.values():
            v += 1
    buffers = {b.data_ptr() for slot in ring._slots
               for b in slot.buffers.values()}
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert np.array_equal(g[k].numpy(), w[k])
            assert g[k].data_ptr() not in buffers


@pytest.mark.parametrize("for_eval", [False, True])
@pytest.mark.parametrize("preprocess", [True, False])
def test_cpu_path_returns_zero_copy_views(for_eval, preprocess):
    cfg = _cfg(preprocess)
    b = _host(3)
    rng = np.random.default_rng(4)
    b.update(target=rng.uniform(size=(B, J, 16, 16)).astype(np.float32),
             target_weight=np.ones((B, J, 1), np.float32),
             center=rng.uniform(20, 40, (B, 2)).astype(np.float32),
             scale=rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32),
             valid=np.ones(B, bool))
    counts = (common.ring_uploads, common.cpu_uploads, common.ring_waits)
    got = common.device_batch(cfg, b, torch.device("cpu"), for_eval)
    assert (common.ring_uploads, common.cpu_uploads, common.ring_waits) \
        == (counts[0], counts[1] + 1, counts[2])
    keys = ["image"] + (["joints", "joints_vis"] if preprocess
                        else ["target", "target_weight"])
    assert list(got) == keys + (["inv_trans", "valid"] if for_eval else [])
    for k in keys:
        assert got[k].device.type == "cpu"
        assert np.shares_memory(got[k].numpy(), b[k])
        assert np.array_equal(got[k].numpy(), b[k])
    if for_eval:
        assert np.array_equal(got["valid"].numpy(), np.ones(B, np.float32))


@pytest.mark.parametrize("pending", [True, False])
def test_counters_count_ring_uploads_and_waits(pending):
    ring, log = _ring(2, pending)
    counts = (common.ring_uploads, common.cpu_uploads, common.ring_waits)
    for i in range(5):
        ring.upload(_host(i), torch.device("cpu"))
    assert (common.ring_uploads - counts[0], common.cpu_uploads - counts[1],
            common.ring_waits - counts[2]) == (5, 0, 3 if pending else 0)
    assert len(log.of("wait")) == common.ring_waits - counts[2]


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none (decided when the
    test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.card
def test_ring_on_the_card_equals_the_pageable_copy(card):
    """The stream held back by a device sleep while more batches than
    slots are uploaded, each from its own host arrays, overwritten after
    each call: every device batch is its own source, bit for bit against
    a pageable copy, in device memory of its own; the host waited on a
    pending slot."""
    cfg = _cfg()
    rng = np.random.default_rng(11)
    n = 2 * common.RING_SLOTS + 1
    sources = [{"image": rng.integers(0, 256, (32, 256, 256, 3),
                                      dtype=np.uint8),
                "joints": rng.uniform(-8, 264, (32, 16, 2)).astype(
                    np.float32),
                "joints_vis": (rng.uniform(size=(32, 16)) > 0.1).astype(
                    np.float32)} for _ in range(n)]
    want = [{k: torch.from_numpy(v.copy()).to(card) for k, v in s.items()}
            for s in sources]
    torch.cuda.synchronize(card)
    counts = (common.ring_uploads, common.ring_waits)
    torch.cuda._sleep(200_000_000)          # ~0.1 s of the card's clock
    got = []
    for s in sources:
        got.append(common.device_batch(cfg, s, card))
        for v in s.values():
            v += 1
    torch.cuda.synchronize(card)
    assert common.ring_uploads - counts[0] == n
    assert common.ring_waits > counts[1]
    slots = [(b.data_ptr(), b.data_ptr() + b.numel() * b.element_size())
             for slot in common._ring._slots for b in slot.buffers.values()]
    for g, w in zip(got, want):
        for k in w:
            t = g[k]
            assert t.device == card and not t.is_pinned()
            assert not any(lo <= t.data_ptr() < hi for lo, hi in slots)
            assert torch.equal(t, w[k])
