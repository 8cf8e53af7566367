"""Port NMS against fhpe_tpu: the pairwise OKS matrix (plain version of
the K2 port) against ``pairwise_oks_pallas`` and ``pairwise_oks_jnp``, the
greedy mask against ``greedy_nms_mask``, the segmented OKS-NMS's plain
version against ``oks_nms_device`` image by image, and the drop-ins
``oks_nms_device`` / ``oks_nms_device_batched`` / ``box_nms_device``
against the JAX ones and the host ``oks_nms`` / ``nms``.  On the CPU each
wrapper runs its plain version; a torch emulation of the kernels' ranked
bitmask scan is held to the plain greedy loop."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhpe_tpu.ops import nms as nms_jax_host
from fhpe_tpu.ops.nms_jax import (box_nms_device as box_nms_device_jax,
                                  greedy_nms_mask as greedy_nms_mask_jax,
                                  oks_nms_device as oks_nms_device_jax,
                                  pairwise_iou_jnp, pairwise_oks_jnp,
                                  pairwise_oks_pallas)
from fhpe_tpu_torch.ops import nms_torch
from fhpe_tpu_torch.ops.nms import nms, oks_nms
from fhpe_tpu_torch.ops.nms_cases import (planted_nms_cases,
                                          ragged_nms_images)
from fhpe_tpu_torch.ops.nms_torch import (box_nms_device, greedy_nms_mask,
                                          greedy_nms_mask_plain, keep_lists,
                                          oks_nms_device,
                                          oks_nms_device_batched,
                                          oks_nms_segments,
                                          oks_nms_segments_plain,
                                          pairwise_iou_torch, pairwise_oks,
                                          pairwise_oks_plain)

from torch_threads import torch_threads  # noqa: F401

NMS_CU = Path(nms_torch.__file__).parent / "csrc" / "nms.cu"

# The JAX package's own bar for K2 against pairwise_oks_jnp
# (tests/test_native_nms.py:90): float32 rounding of 17 exp terms.
RTOL, ATOL = 1e-5, 1e-6


def _random_kpts_db(rng, n, j=17):
    db = []
    for _ in range(n):
        base = rng.uniform(50, 400, size=(1, 2))
        kp = np.zeros((j, 3))
        kp[:, :2] = base + rng.normal(scale=rng.uniform(2, 60), size=(j, 2))
        kp[:, 2] = rng.uniform(0, 1, size=j)
        db.append({"keypoints": kp, "score": rng.uniform(0.1, 1.0),
                   "area": rng.uniform(1e3, 1e5)})
    return db


def _random_dets(rng, n):
    xy = rng.uniform(0, 400, size=(n, 2))
    wh = rng.uniform(20, 150, size=(n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1))], axis=1)


@pytest.mark.parametrize("n", [128, 256])
def test_pairwise_oks_plain_matches_pallas_and_jnp(n):
    """Within rtol 1e-5 / atol 1e-6 of K2 (interpret mode on the CPU, as
    tests/test_native_nms.py runs it) and of the jnp expression; on the
    planted cases too, whose clusters put OKS near 1."""
    rng = np.random.RandomState(n)
    sets = [(rng.uniform(0, 400, (n, 17)).astype(np.float32),
             rng.uniform(0, 400, (n, 17)).astype(np.float32),
             rng.uniform(1e3, 1e5, n).astype(np.float32))]
    sets += [c[1:4] for c in planted_nms_cases(n, seed=n)[::4]]
    for xs, ys, areas in sets:
        args = [jnp.asarray(a) for a in (xs, ys, areas)]
        got = pairwise_oks(*(torch.from_numpy(a) for a in (xs, ys, areas)))
        assert got.dtype == torch.float32 and got.shape == (n, n)
        for ref in (pairwise_oks_pallas(*args), pairwise_oks_jnp(*args)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=ATOL)


def test_pairwise_oks_plain_matches_host_oks_iou():
    rng = np.random.RandomState(3)
    db = _random_kpts_db(rng, 6)
    kpts = np.array([k["keypoints"].flatten() for k in db])
    areas = np.array([k["area"] for k in db])
    mat = pairwise_oks_plain(torch.tensor(kpts[:, 0::3], dtype=torch.float32),
                             torch.tensor(kpts[:, 1::3], dtype=torch.float32),
                             torch.tensor(areas, dtype=torch.float32)).numpy()
    for i in range(6):
        ref = nms_jax_host.oks_iou(kpts[i], np.delete(kpts, i, 0), areas[i],
                                   np.delete(areas, i))
        np.testing.assert_allclose(np.delete(mat[i], i), ref, rtol=1e-5)


@pytest.mark.parametrize("n", [128, 256, 1152])
@pytest.mark.parametrize("thresh", [0.5, 0.9])
def test_greedy_plain_bit_equal_to_jax(n, thresh):
    """The planted cases (ties, padding anywhere, nothing valid, one
    cluster): the keep mask equals fhpe_tpu's ``greedy_nms_mask`` bit for
    bit on the same similarity matrix."""
    launches = nms_torch.greedy_nms_launches
    for name, xs, ys, areas, scores, valid in planted_nms_cases(n, seed=7):
        sim = np.array(pairwise_oks_jnp(jnp.asarray(xs), jnp.asarray(ys),
                                        jnp.asarray(areas)))
        ref = np.asarray(greedy_nms_mask_jax(
            jnp.asarray(sim), jnp.asarray(scores), jnp.asarray(valid),
            thresh))
        got = greedy_nms_mask(torch.from_numpy(sim), torch.from_numpy(scores),
                              torch.from_numpy(valid), thresh)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        if name == "no valid":
            assert not ref.any()
        if name in ("one valid", "one cluster"):
            assert ref.sum() == 1
    assert nms_torch.greedy_nms_launches == launches   # CPU: plain version


def test_greedy_plain_ties_go_to_the_larger_index():
    sim = torch.zeros(4, 4)
    sim[3, 1] = sim[1, 3] = 1.0          # 1 and 3 suppress each other
    scores = torch.tensor([0.5, 0.9, 0.2, 0.9])
    keep = greedy_nms_mask(sim, scores, torch.ones(4, dtype=torch.bool), 0.5)
    assert keep.tolist() == [True, False, True, True]
    scores[0] = float("nan")             # NaN counts as -inf: still kept
    keep = greedy_nms_mask(sim, scores, torch.ones(4, dtype=torch.bool), 0.5)
    assert keep.tolist() == [True, False, True, True]


@pytest.mark.parametrize("seed,n", [(0, 25), (1, 25), (2, 150)])
def test_oks_nms_device_matches_jax_and_host(seed, n):
    """Keep-lists (descending score) equal fhpe_tpu's device drop-in and
    the host ``oks_nms``; n = 150 pads to 256."""
    db = _random_kpts_db(np.random.RandomState(seed), n)
    for thresh in (0.5, 0.9):
        got = oks_nms_device(db, thresh, device="cpu")
        assert got == oks_nms_device_jax(db, thresh)
        assert got == oks_nms(db, thresh) == nms_jax_host.oks_nms(db, thresh)
    assert oks_nms_device([], 0.9, device="cpu") == []


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 40), (2, 130)])
def test_box_nms_device_matches_jax_and_host(seed, n):
    dets = _random_dets(np.random.RandomState(seed), n)
    for thresh in (0.3, 0.6):
        got = box_nms_device(dets, thresh, device="cpu")
        assert got == box_nms_device_jax(dets, thresh)
        assert got == nms(dets, thresh) == nms_jax_host.nms(dets, thresh)
    np.testing.assert_allclose(
        pairwise_iou_torch(torch.tensor(dets[:, :4], dtype=torch.float32)),
        np.asarray(pairwise_iou_jnp(jnp.asarray(dets[:, :4], jnp.float32))),
        rtol=1e-6)
    assert box_nms_device(np.zeros((0, 5)), 0.5, device="cpu") == []


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 17)
    with pytest.raises(ValueError, match="float32"):
        pairwise_oks(x.double(), x.double(), torch.ones(4).double())
    with pytest.raises(ValueError, match=r"\(N, J\)"):
        pairwise_oks(x, x[:3], torch.ones(4))
    with pytest.raises(ValueError, match="bool valid"):
        greedy_nms_mask(torch.zeros(4, 4), torch.zeros(4), torch.ones(4), 0.5)
    with pytest.raises(ValueError, match=r"sim \(N, N\)"):
        greedy_nms_mask(torch.zeros(4, 3), torch.zeros(4),
                        torch.ones(4, dtype=torch.bool), 0.5)


# -- the kernels' ranked bitmask scan, emulated --------------------------------

def _scan_emulation(sim, scores, valid, thresh, by_rank=False):
    """The greedy and segmented kernels' algorithm (ops/csrc/nms.cu) in
    torch: rank by count (descending key, NaN as -inf, equal keys to the
    larger index, padding unranked); the bits as 32-bit words, bit b of
    word w set when sim > thresh in float32, in index space (the greedy
    kernel: row i, column 32w + b) or in rank space (the segmented kernel:
    row r, column s = 32w + b of the ranks, only s > r set, and the words
    before row r's own left as garbage the scan must not read); then one
    walk over the ranks with the removed mask as words."""
    n = scores.shape[0]
    t = torch.tensor(np.float32(thresh))
    key = torch.where(torch.isnan(scores), float("-inf"), scores)
    idx = torch.arange(n)[valid]
    k = key[idx]
    ranks = ((k[None, :] > k[:, None])
             | ((k[None, :] == k[:, None]) & (idx[None, :] > idx[:, None]))
             ).sum(1)
    order = torch.full((n,), -1, dtype=torch.long)
    order[ranks] = idx
    words = -(-n // 32)
    hits = sim > t
    if by_rank:
        ranked = order[:len(idx)]
        hits = torch.zeros(n, n, dtype=torch.bool)
        hits[:len(idx), :len(idx)] = torch.triu(
            sim[ranked][:, ranked] > t, diagonal=1)
    hits = torch.nn.functional.pad(hits, (0, 32 * words - n))
    bits = (hits.view(n, words, 32).long() << torch.arange(32)).sum(-1)
    if by_rank:
        for r in range(n):
            bits[r, :r >> 5] = 0xFFFFFFFF     # never written, never read
    removed = torch.zeros(words, dtype=torch.long)
    keep = torch.zeros(n, dtype=torch.bool)
    for r in range(n):
        i = int(order[r])
        if i < 0:
            break
        p = r if by_rank else i
        if (int(removed[p >> 5]) >> (p & 31)) & 1:
            continue
        keep[i] = True
        first = p >> 5 if by_rank else 0
        removed[first:] |= bits[p, first:]
    return keep


def _random_scan_case(kind, n, seed):
    rng = np.random.RandomState(seed)
    sim = torch.from_numpy(rng.uniform(0, 1, (n, n)).astype(np.float32))
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    if kind == "equal scores":
        scores[:] = 0.5
    elif kind == "three levels":
        scores = rng.choice(np.float32([0.2, 0.5, 0.9]), n)
    elif kind == "nan and -inf":
        scores[rng.uniform(size=n) < 0.2] = np.nan
        scores[rng.uniform(size=n) < 0.2] = -np.inf
    elif kind == "no valid":
        valid[:] = False
    elif kind == "all valid":
        valid[:] = True
    return sim, torch.from_numpy(scores), torch.from_numpy(valid)


@pytest.mark.parametrize("n", [128, 512, 513, 1152])
@pytest.mark.parametrize("thresh", [0.5, 0.9])
def test_scan_emulation_bit_equal_to_greedy_on_planted_cases(n, thresh):
    """The ranked scan, in index space and in rank space, gives the greedy
    loop's keep mask bit for bit on the planted cases, on both sides of
    the kernels' shared-memory cap (512)."""
    assert nms_torch.SCAN_SHMEM_MAX_N == 512
    for name, xs, ys, areas, scores, valid in planted_nms_cases(n, seed=n):
        sim = pairwise_oks_plain(*(torch.from_numpy(a)
                                   for a in (xs, ys, areas)))
        ref = greedy_nms_mask_plain(sim, torch.from_numpy(scores),
                                    torch.from_numpy(valid), thresh)
        for by_rank in (False, True):
            got = _scan_emulation(sim, torch.from_numpy(scores),
                                  torch.from_numpy(valid), thresh, by_rank)
            assert torch.equal(got, ref), (name, by_rank)


@pytest.mark.parametrize("kind,n", [
    ("equal scores", 70), ("three levels", 200), ("nan and -inf", 90),
    ("no valid", 40), ("all valid", 1), ("all valid", 33),
    ("nan and -inf", 513)])
def test_scan_emulation_bit_equal_to_greedy_on_random_cases(kind, n):
    """Random similarities (not symmetric), many equal scores, NaN and
    -inf scores, nothing valid, N = 1 and N on a word's edge."""
    for seed in range(3):
        sim, scores, valid = _random_scan_case(kind, n, seed)
        ref = greedy_nms_mask_plain(sim, scores, valid, 0.5)
        for by_rank in (False, True):
            got = _scan_emulation(sim, scores, valid, 0.5, by_rank)
            assert torch.equal(got, ref), (kind, seed, by_rank)
        if kind == "no valid":
            assert not ref.any()


def _pack(images):
    xs = torch.from_numpy(np.concatenate([im[1] for im in images]))
    ys = torch.from_numpy(np.concatenate([im[2] for im in images]))
    areas = torch.from_numpy(np.concatenate([im[3] for im in images]))
    scores = torch.from_numpy(np.concatenate([im[4] for im in images]))
    offsets = np.concatenate([[0], np.cumsum([len(im[4]) for im in images])])
    return xs, ys, areas, scores, torch.from_numpy(offsets.astype(np.int32))


def _kpts_db(xs, ys, areas, scores):
    kp = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    return [{"keypoints": kp[i], "area": float(areas[i]),
             "score": float(scores[i])} for i in range(len(scores))]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_oks_nms_segments_plain_matches_jax_per_image(use_pallas):
    """A ragged pack (empty images, one detection, clusters, equal and
    three-level scores, one image above the cap): the plain segmented
    keep mask, image by image, equals ``fhpe_tpu``'s ``oks_nms_device``
    with the jnp OKS and with K2 in interpret mode.  (NaN and -inf scores
    are left out here: ``fhpe_tpu``'s loop does not end on them; the
    emulation tests above cover them against the plain loop.)"""
    images = [im for im in ragged_nms_images(seed=5)
              if not np.isnan(im[4]).any() and not np.isinf(im[4]).any()
              and (not use_pallas or len(im[4]) <= 130)]
    xs, ys, areas, scores, offsets = _pack(images)
    launches = nms_torch.oks_nms_segment_launches
    keep = oks_nms_segments(xs, ys, areas, scores, offsets, 0.9)
    assert torch.equal(keep, oks_nms_segments_plain(xs, ys, areas, scores,
                                                    offsets, 0.9))
    assert nms_torch.oks_nms_segment_launches == launches   # CPU: plain
    lists = keep_lists(keep.numpy(), scores.numpy(), offsets.numpy())
    assert len(lists) == len(images) and lists[0] == [] and lists[3] == []
    for (name, *arrays), got in zip(images, lists):
        ref = oks_nms_device_jax(_kpts_db(*arrays), 0.9,
                                 use_pallas=use_pallas)
        assert got == ref, name


def test_oks_nms_device_batched_lists_equal_per_image():
    """``oks_nms_device_batched`` on the CPU returns per image the lists of
    ``oks_nms_device`` and of ``fhpe_tpu``'s drop-in, equal scores in
    ascending index (the scan walks them in descending index); and on
    the images of distinct scores, the host float64 ``oks_nms``'s lists
    (its unstable ``argsort`` visits equal scores in no set order)."""
    images = [im for im in ragged_nms_images(seed=6)
              if not np.isnan(im[4]).any() and not np.isinf(im[4]).any()]
    groups = [_kpts_db(*im[1:]) for im in images]
    for thresh in (0.5, 0.9):
        got = oks_nms_device_batched(groups, thresh, device="cpu")
        assert len(got) == len(groups)
        for g, lst in zip(groups, got):
            assert lst == oks_nms_device(g, thresh, device="cpu")
            assert lst == oks_nms_device_jax(g, thresh)
            if len({k["score"] for k in g}) == len(g):
                assert lst == oks_nms(g, thresh)
        ties = got[[im[0] for im in images].index("equal scores")]
        assert ties == sorted(ties) and len(ties) > 1
    assert oks_nms_device_batched([], 0.9, device="cpu") == []
    assert oks_nms_device_batched([[], []], 0.9, device="cpu") == [[], []]


def test_scan_limits_match_the_kernel_source():
    """The wrapper's shared-memory cap and scratch limit are the kernel's
    constants (ops/csrc/nms.cu), and the wrappers raise above the limit."""
    src = NMS_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kShmemMaxN") == nms_torch.SCAN_SHMEM_MAX_N
    assert const("kScanSlots") == nms_torch.SCAN_SLOTS
    assert "kMaxScanN = 32 * 32 * kScanSlots;" in src
    assert nms_torch.MAX_SCAN_N == 32 * 32 * nms_torch.SCAN_SLOTS == 8192
    n = nms_torch.MAX_SCAN_N + 1
    with pytest.raises(ValueError, match="at most 8192"):
        greedy_nms_mask(torch.zeros(1).expand(n, n), torch.zeros(n),
                        torch.ones(n, dtype=torch.bool), 0.5)
    x = torch.zeros(n, 17)
    with pytest.raises(ValueError, match="at most 8192"):
        oks_nms_segments(x, x, torch.ones(n), torch.zeros(n),
                         torch.tensor([0, n], dtype=torch.int32), 0.5)


def test_oks_nms_segments_rejects_bad_offsets():
    x, a = torch.zeros(4, 17), torch.ones(4)
    for bad in ([0, 5], [1, 4], [0, 3, 2, 4]):
        with pytest.raises(ValueError, match="offsets must rise"):
            oks_nms_segments(x, x, a, a, torch.tensor(bad, dtype=torch.int32),
                             0.5)
    with pytest.raises(ValueError, match="int32 offsets"):
        oks_nms_segments(x, x, a, a, torch.tensor([0, 4]), 0.5)


def test_oks_nms_device_batched_keypoint_shapes():
    """Keypoints all (J, 3) or all (3 J,) give the same lists; a set that
    mixes the two shapes raises, naming the rule."""
    images = [im for im in ragged_nms_images(seed=6) if len(im[1])]
    groups = [_kpts_db(*im[1:]) for im in images]
    flat = [[dict(k, keypoints=k["keypoints"].reshape(-1)) for k in g]
            for g in groups]
    assert oks_nms_device_batched(flat, 0.9, device="cpu") == \
        oks_nms_device_batched(groups, 0.9, device="cpu")
    mixed = [flat[0]] + groups[1:]
    with pytest.raises(ValueError, match="one shape"):
        oks_nms_device_batched(mixed, 0.9, device="cpu")
