"""The port's MessagePack reader and writer (``fhpe_tpu_torch/utils/
msgpack.py``) against ``flax.serialization`` and the ``msgpack`` package,
and ``fhpe_tpu``'s ``.msgpack`` weight files loaded into the port's
models.

The files are the three ``fhpe_tpu/utils/checkpoint.py`` writes
(``final_state``, ``model_best``, and the full ``checkpoint`` with optax
Adam's state), for a tiny hourglass, HRNet and PoseResNet.  Their
weights and Adam's moments and step count are random numpy leaves in the
shapes of ``fhpe_tpu``'s trees (``jax.eval_shape``: no JAX init or
update runs).
"""

import math
import os
from types import SimpleNamespace

import msgpack as msgpack_ref
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import jax
import jax.numpy as jnp

from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.train.state import TrainState, make_optimizer
from fhpe_tpu.utils import checkpoint as ck_jax
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.utils import checkpoint as ck
from fhpe_tpu_torch.utils import msgpack
from fhpe_tpu_torch.utils.convert import (state_dict_from_jax,
                                          variables_from_state_dict)

from test_torch_hourglass import _cfg as hourglass_cfg
from test_torch_hrnet import hrnet_cfg
from test_torch_pose_resnet import _both as pose_resnet_cfgs
from torch_threads import torch_threads  # noqa: F401

FAMILIES = ("hourglass", "hourglass_dead_bias", "hrnet", "pose_resnet")
FILES = (ck_jax.FINAL_NAME, ck_jax.BEST_NAME, ck_jax.CKPT_NAME)


def family_cfg(name):
    """(config, input (H, W)) of a tiny model of the family."""
    if name.startswith("hourglass"):
        return hourglass_cfg(1, 16, joints=4,
                             dead_bias_skip=name.endswith("dead_bias")), \
            (64, 64)
    if name == "hrnet":
        return hrnet_cfg(), (96, 64)
    return pose_resnet_cfgs(18, "float32")[1], (96, 64)


def random_leaves(shapes, rng):
    """numpy leaves of ``shapes``' shapes and dtypes: floats in [0.5, 1.5),
    ints in [1, 100)."""
    def leaf(s):
        if np.issubdtype(s.dtype, np.floating):
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        return rng.randint(1, 100, s.shape).astype(s.dtype)
    return jax.tree_util.tree_map(leaf, shapes)


def random_variables(cfg, hw, seed=0):
    """Random float32 leaves in the shapes of fhpe_tpu's tree."""
    model = get_pose_net_jax(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,)), train=False))
    return random_leaves(dict(shapes), np.random.RandomState(seed))


_RUNS = {}


def jax_run(name, tmp_path_factory):
    """(cfg, hw, variables, run dir) with the three files fhpe_tpu writes
    for a TrainState of those variables and random Adam state: its
    checkpoint, model_best and final state."""
    if name not in _RUNS:
        cfg, hw = family_cfg(name)
        v = random_variables(cfg, hw)
        tx = make_optimizer(cfg)
        rng = np.random.RandomState(1)
        state = TrainState(
            step=np.asarray(7, np.int32), params=v["params"],
            batch_stats=v["batch_stats"], tx=tx, opt_state=random_leaves(
                jax.eval_shape(tx.init, v["params"]), rng))
        out = str(tmp_path_factory.mktemp(name))
        ck_jax.save_checkpoint(out, state, epoch=3, perf=0.5, is_best=True,
                               async_write=False)
        ck_jax.save_final_state(out, state)
        _RUNS[name] = (cfg, hw, v, out)
    return _RUNS[name]


def assert_same_tree(ours, theirs, path="/", ordered=True):
    """``unpackb``'s tree against flax's: the same keys (in the same order
    if ``ordered``), tensors equal to the arrays in dtype, shape and every
    bit, numbers equal."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict), path
        if ordered:
            assert list(ours) == list(theirs), path
        assert set(ours) == set(theirs), path
        for k in theirs:
            assert_same_tree(ours[k], theirs[k], f"{path}{k}/", ordered)
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_tree(a, b, f"{path}{i}/", ordered)
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, torch.Tensor), path
        if theirs.dtype.name == "bfloat16":
            assert ours.dtype == torch.bfloat16, path
            ours, theirs = ours.view(torch.int16), theirs.view(np.int16)
        assert ours.numpy().dtype == theirs.dtype, path
        assert ours.shape == theirs.shape, path
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=path)
    elif isinstance(theirs, np.generic):
        assert type(ours) is type(theirs.item()), path
        assert ours == theirs.item() or (
            math.isnan(ours) and math.isnan(theirs.item())), path
    else:
        assert type(ours) is type(theirs) and ours == theirs, path


# -- fhpe_tpu's files ---------------------------------------------------------

@pytest.mark.parametrize("file", FILES)
@pytest.mark.parametrize("family", FAMILIES)
def test_unpackb_equals_flax_on_fhpe_tpu_files(family, file,
                                               tmp_path_factory):
    _, _, _, out = jax_run(family, tmp_path_factory)
    with open(os.path.join(out, file), "rb") as f:
        data = f.read()
    assert_same_tree(msgpack.unpackb(data),
                     serialization.msgpack_restore(data))


@pytest.mark.parametrize("file", FILES)
@pytest.mark.parametrize("family", FAMILIES)
def test_load_model_weights_msgpack(family, file, tmp_path_factory):
    """Each file loads (strict) into the port's model for its config, with
    ``state_dict_from_jax``'s tensors of the same variables, and the two
    models' forwards are bit-equal."""
    cfg, hw, variables, out = jax_run(family, tmp_path_factory)
    got = ck.load_model_weights(os.path.join(out, file), cfg)
    want = state_dict_from_jax(cfg, variables)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = get_pose_net(cfg).eval(), get_pose_net(cfg).eval()
    a.load_state_dict(got)
    b.load_state_dict(want)
    x = torch.from_numpy(np.random.RandomState(2).normal(
        size=(1, 3) + hw).astype(np.float32))
    with torch.no_grad():
        ya, yb = a(x), b(x)
    for u, v in zip(ya if isinstance(ya, list) else [ya],
                    yb if isinstance(yb, list) else [yb]):
        assert torch.equal(u, v)


def test_msgpack_needs_the_config(tmp_path_factory):
    _, _, _, out = jax_run("hourglass", tmp_path_factory)
    with pytest.raises(ValueError, match="needs the model's config"):
        ck.load_model_weights(os.path.join(out, ck_jax.FINAL_NAME))


def test_dead_bias_tree_loads_with_zero_biases(tmp_path_factory):
    """A tree trained with ``TPU.DEAD_BIAS_SKIP`` (no bias on the convs a
    BatchNorm follows) into the model of a config without it: those
    biases load as zeros, and the forward is bit-equal to the bias-free
    model's."""
    cfg_skip, hw, variables, out = jax_run("hourglass_dead_bias",
                                           tmp_path_factory)
    cfg = cfg_skip.clone()
    cfg.TPU.DEAD_BIAS_SKIP = False
    biased = get_pose_net(cfg).eval()
    with pytest.raises(RuntimeError, match="Missing key"):
        biased.load_state_dict(state_dict_from_jax(cfg, variables))
    sd = ck.load_model_weights(os.path.join(out, ck_jax.FINAL_NAME), cfg)
    biased.load_state_dict(sd)                              # strict
    free = get_pose_net(cfg_skip).eval()
    free.load_state_dict(state_dict_from_jax(cfg_skip, variables))
    zeros = sorted(set(biased.state_dict()) - set(free.state_dict()))
    assert zeros and all(k.endswith(".bias") and not sd[k].any()
                         for k in zeros)
    x = torch.from_numpy(np.random.RandomState(3).normal(
        size=(1, 3) + hw).astype(np.float32))
    with torch.no_grad():
        for u, v in zip(biased(x), free(x)):
            assert torch.equal(u, v)


@pytest.mark.parametrize("family", FAMILIES)
def test_variables_from_state_dict_inverts(family):
    """``variables_from_state_dict`` after ``state_dict_from_jax`` gives
    fhpe_tpu's tree back bit for bit, and the other way round the port's
    state_dict (``num_batches_tracked`` is not in the tree)."""
    cfg, hw = family_cfg(family)
    v = random_variables(cfg, hw, seed=4)
    back = variables_from_state_dict(cfg, state_dict_from_jax(cfg, v))
    assert_same_tree(msgpack.unpackb(msgpack.packb(back)),
                     serialization.msgpack_restore(
                         serialization.msgpack_serialize(v)), ordered=False)
    torch.manual_seed(5)
    sd = get_pose_net(cfg).state_dict()
    again = state_dict_from_jax(cfg, variables_from_state_dict(cfg, sd))
    assert again.keys() == sd.keys()
    for k in sd:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again[k], sd[k]), k


def test_packb_writes_what_flax_writes():
    """The final_state layout from the port's weights: ``packb`` of the
    tensors gives flax's bytes for the same tree in numpy, and flax reads
    it back to that tree."""
    cfg, _ = family_cfg("pose_resnet")
    torch.manual_seed(6)
    tree = variables_from_state_dict(cfg, get_pose_net(cfg).state_dict())
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, tree)
    data = msgpack.packb(as_tensors)
    assert data == serialization.msgpack_serialize(tree)
    assert_same_tree(msgpack.unpackb(data),
                     serialization.msgpack_restore(data))


# -- the format, case by case ---------------------------------------------------

PLAIN_CASES = {
    "nil_bool": [None, True, False],
    "fixint": [0, 127, -1, -32],
    "uint": [128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1],
    "int": [-33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
            -2 ** 63],
    "float64": [0.0, -0.0, 1.5, 1e300, -math.inf],
    "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
            "f" * 65536],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536],
    "array": [list(range(15)), list(range(16)), list(range(65536)),
              [[[]]]],
    "map": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
            {str(i): i for i in range(65536)}, {1: "int key", b"b": None}],
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_types_against_msgpack(case):
    """Every int width and sign, float64, str / bin / array / map in their
    fix, 8, 16 and 32 forms: ``packb`` writes the msgpack package's bytes
    and ``unpackb`` reads them as it does."""
    for v in PLAIN_CASES[case]:
        data = msgpack_ref.packb(v, use_bin_type=True)
        assert msgpack.packb(v) == data, repr(v)[:60]
        assert msgpack.unpackb(data) == msgpack_ref.unpackb(
            data, raw=False, strict_map_key=False), repr(v)[:60]


def test_float32_and_str32_read():
    """Forms ``packb`` never writes: float32, and str32 / array32 / map32
    headers on short bodies."""
    data = msgpack_ref.packb([1.5, -2.25], use_single_float=True)
    assert msgpack.unpackb(data) == [1.5, -2.25]
    assert msgpack.unpackb(b"\xdb\x00\x00\x00\x02hi") == "hi"
    assert msgpack.unpackb(b"\xdd\x00\x00\x00\x01\x07") == [7]
    assert msgpack.unpackb(b"\xdf\x00\x00\x00\x01\xa1k\xc0") == {"k": None}
    assert msgpack.unpackb(b"\xc6\x00\x00\x00\x01\x00") == b"\x00"


EXT_CASES = {
    "bfloat16": jnp.asarray([[1.0, -2.5], [3.0, 1e-3]], jnp.bfloat16),
    "bfloat16_0d": jnp.asarray(7.0, jnp.bfloat16),
    "float32_0d": np.asarray(3.25, np.float32),
    "int_arrays": [np.asarray([-(2 ** 62), 2 ** 62], np.int64),
                   np.arange(-4, 4, dtype=np.int8),
                   np.asarray([0, 65535], np.uint16),
                   np.asarray([2 ** 64 - 1], np.uint64)],
    "empty_and_bool": [np.zeros((0, 3), np.float64),
                       np.asarray([True, False])],
    "numpy_scalars": [np.float16(1.5), np.float32(-0.25), np.float64(1e-300),
                      np.int8(-128), np.int16(-3), np.int32(7),
                      np.int64(-2 ** 40), np.uint8(255), np.uint32(2 ** 31),
                      np.uint64(2 ** 63), np.bool_(True)],
    "complex_arrays": [np.asarray([1 + 2j], np.complex64),
                       np.zeros((2, 2), np.complex128)],
    "fixext_sizes": [np.zeros(1, np.uint8), np.zeros(2, np.uint8),
                     np.zeros(200, np.uint8), np.zeros(70000, np.uint8)],
}


@pytest.mark.parametrize("case", sorted(EXT_CASES))
def test_ext_types_against_flax(case):
    """flax's ndarray and numpy-scalar ext types: bfloat16, 0-d and
    complex arrays, numpy scalars (Python numbers here), payloads of every
    fixext size and of ext 8/16/32 length: read as flax reads them, and
    written as flax writes them (a jax array as the numpy array of its
    values)."""
    obj = {"v": EXT_CASES[case]}
    data = serialization.msgpack_serialize(obj)
    assert_same_tree(msgpack.unpackb(data),
                     serialization.msgpack_restore(data))
    as_numpy = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, obj)
    assert msgpack.packb(as_numpy) == data


def test_refusals(monkeypatch):
    """A chunked array (flax's MAX_CHUNK_SIZE lowered so that it writes
    one), another ext type (flax's Python complex, ext 2), truncated data
    and trailing bytes are refused; ``packb`` refuses an array above the
    chunk size and a Python complex."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    data = serialization.msgpack_serialize({"w": np.zeros(10, np.float32)})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        msgpack.unpackb(data)
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(TypeError, match="complex"):
        msgpack.packb({"c": 1 + 2j})
    whole = msgpack.packb({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(whole[:-1])
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpackb(whole + b"\xc0")
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 16)
    with pytest.raises(ValueError, match="above 16"):
        msgpack.packb({"w": torch.zeros(10)})


# -- random trees ----------------------------------------------------------------

LEAVES = (st.none() | st.booleans()
          | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
          | st.floats(allow_nan=False) | st.text(max_size=40)
          | st.binary(max_size=300))
TREES = st.recursive(
    LEAVES, lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20),
    max_leaves=60)
ARRAYS = hnp.arrays(
    st.sampled_from([np.float32, np.float64, np.int8, np.int32, np.int64,
                     np.uint8, np.uint16, np.bool_]),
    hnp.array_shapes(min_dims=0, max_dims=3, max_side=5))


@settings(max_examples=40, deadline=None, database=None)
@given(TREES)
def test_random_trees_against_msgpack(tree):
    data = msgpack_ref.packb(tree, use_bin_type=True)
    assert msgpack.packb(tree) == data
    assert msgpack.unpackb(data) == msgpack_ref.unpackb(
        data, raw=False, strict_map_key=False)


@settings(max_examples=40, deadline=None, database=None)
@given(st.dictionaries(st.text(min_size=1, max_size=8), ARRAYS, max_size=6))
def test_random_array_trees_against_flax(tree):
    """flax's writer copies the tree through ``jax.tree_util``, which
    sorts dict keys; ``packb`` keeps the order it is given."""
    tree = dict(sorted(tree.items()))
    data = serialization.msgpack_serialize(tree)
    assert msgpack.packb(tree) == data
    assert_same_tree(msgpack.unpackb(data),
                     serialization.msgpack_restore(data))
