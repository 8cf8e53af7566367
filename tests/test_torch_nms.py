"""Port NMS against fhpe_tpu: the pairwise OKS matrix (plain version of
the K2 port) against ``pairwise_oks_pallas`` and ``pairwise_oks_jnp``, the
greedy mask against ``greedy_nms_mask``, and the drop-ins
``oks_nms_device`` / ``box_nms_device`` against the JAX ones and the host
``oks_nms`` / ``nms``.  On the CPU each wrapper runs its plain version."""

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
from fhpe_tpu_torch.ops.nms_cases import planted_nms_cases
from fhpe_tpu_torch.ops.nms_torch import (box_nms_device, greedy_nms_mask,
                                          oks_nms_device, pairwise_iou_torch,
                                          pairwise_oks, pairwise_oks_plain)

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
