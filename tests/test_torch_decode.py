"""Port decode (plain PyTorch version of the CUDA kernel) against fhpe_tpu.

The argmax, the <= 0 mask and the quarter offset give exact integers and
quarter steps, so the port is held BIT-equal to both the XLA form
(``get_max_preds_jax`` + ``quarter_offset_jax``) and the Pallas kernel K1
(``decode_pallas``, interpret mode on the CPU).  The CUDA kernel itself
is held bit-equal to the same plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhpe_tpu.ops.decode import (decode_heatmaps_jax, get_max_preds_jax,
                                 quarter_offset_jax)
from fhpe_tpu.ops.decode_pallas import decode_pallas
from fhpe_tpu_torch.ops.decode import (decode_argmax, decode_heatmaps,
                                       get_max_preds_torch,
                                       make_inverse_transforms)
from fhpe_tpu_torch.ops.decode_cases import planted_heatmaps

from torch_threads import torch_threads  # noqa: F401

# (B, J, H, W): non-square 64x48 (COCO), square 64x64 (MPII), and a ragged
# 7x9 map whose rows are not a multiple of 4 floats
SHAPES = [(6, 17, 64, 48), (2, 16, 64, 64), (3, 5, 7, 9)]


def _jax_decode(hm_nchw, post_process):
    hmj = jnp.asarray(hm_nchw.transpose(0, 2, 3, 1))
    coords, maxvals = get_max_preds_jax(hmj)
    if post_process:
        coords = quarter_offset_jax(coords, hmj)
    return np.asarray(coords), np.asarray(maxvals)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("post_process", [True, False])
def test_plain_decode_bit_equal_to_xla_form(shape, post_process):
    hm = planted_heatmaps(*shape, seed=1)
    got_c, got_v = decode_argmax(torch.from_numpy(hm), post_process)
    ref_c, ref_v = _jax_decode(hm, post_process)
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_decode_bit_equal_to_pallas_kernel(shape):
    hm = planted_heatmaps(*shape, seed=2)
    got_c, got_v = decode_argmax(torch.from_numpy(hm), True)
    ref_c, ref_v = decode_pallas(jnp.asarray(hm.transpose(0, 2, 3, 1)),
                                 interpret=True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def test_planted_cases_decode_as_specified():
    """The planted rows exercise what they claim (guards the generator)."""
    b, j, h, w = 6, 17, 64, 48
    hm = planted_heatmaps(b, j, h, w, seed=3)
    c, v = get_max_preds_torch(torch.from_numpy(hm))
    c = c.reshape(-1, 2).numpy()
    v = v.reshape(-1).numpy()
    np.testing.assert_array_equal(c[:3], 0.0)        # ties / masked rows
    assert v[0] == 0.0 and v[1] == 0.5 and v[2] <= 0.0
    np.testing.assert_array_equal(c[3], [w // 3, h // 3])   # plateau: first
    np.testing.assert_array_equal(c[4], [1, 1])             # twin peaks
    cq, _ = decode_argmax(torch.from_numpy(hm), True)
    np.testing.assert_array_equal(cq.reshape(-1, 2).numpy()[5],
                                  [w // 2, h // 2])         # sign(0) = 0
    borders = c[6:22]
    assert {tuple(p) for p in borders} == {
        (x, y) for y in (0, 1, h - 2, h - 1) for x in (0, 1, w - 2, w - 1)}


@pytest.mark.parametrize("post_process", [True, False])
def test_decode_with_inverse_affine_matches_jax(post_process):
    """Source-frame preds within 1e-4 px: the port maps with float32
    mul-adds, JAX with an einsum, so the sums round in another order
    (coordinates stay below 512 px, where a float32 ulp is 3e-5)."""
    b, j, h, w = 5, 16, 64, 48
    hm = planted_heatmaps(b, j, h, w, seed=4)
    rng = np.random.RandomState(5)
    centers = rng.uniform(100, 300, size=(b, 2))
    scales = rng.uniform(0.8, 1.6, size=(b, 2))
    inv = make_inverse_transforms(centers, scales, (w, h))

    got_p, got_v = decode_heatmaps(torch.from_numpy(hm),
                                   torch.from_numpy(inv), post_process)
    ref_p, ref_v = decode_heatmaps_jax(jnp.asarray(hm.transpose(0, 2, 3, 1)),
                                       jnp.asarray(inv), post_process)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def test_decode_rejects_bad_input():
    with pytest.raises(ValueError):
        decode_argmax(torch.zeros(4, 64, 64))
    with pytest.raises(ValueError):
        decode_argmax(torch.zeros(1, 2, 0, 4))
