"""The port stands without JAX, and its copies of fhpe_tpu's host code
(config, affine geometry, dataset constants) stay equal to the originals."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from fhpe_tpu import config as config_jax
from fhpe_tpu.data import dataset_meta as dataset_meta_jax
from fhpe_tpu.geometry import affine as affine_jax
from fhpe_tpu_torch import config
from fhpe_tpu_torch.data import dataset_meta
from fhpe_tpu_torch.geometry import affine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "experiments", "**", "*.yaml"), recursive=True))


def test_port_imports_no_jax():
    """In a fresh interpreter (this one already holds JAX via conftest),
    with ``FHPE_PLATFORM`` set: ``import fhpe_tpu`` imports JAX then, so
    the port must not touch the JAX package at all."""
    code = ("import sys\n"
            "import fhpe_tpu_torch, fhpe_tpu_torch.serve, "
            "fhpe_tpu_torch.ops.decode, fhpe_tpu_torch.config, "
            "fhpe_tpu_torch.utils.convert\n"
            "fhpe_tpu_torch.config.load_config("
            "'experiments/mpii/hourglass/hg4_128_student.yaml')\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'fhpe_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, FHPE_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_config_copy_equal(path):
    got = config.load_config(os.path.join(REPO, path)).to_dict()
    assert got == config_jax.load_config(os.path.join(REPO, path)).to_dict()


def test_config_defaults_and_overrides_equal():
    assert config.get_default_config().to_dict() == \
        config_jax.get_default_config().to_dict()
    assert config.MODEL_EXTRAS.keys() == config_jax.MODEL_EXTRAS.keys()
    for name, make in config.MODEL_EXTRAS.items():
        assert make().to_dict() == config_jax.MODEL_EXTRAS[name]().to_dict()
    path = os.path.join(REPO, "experiments/mpii/hourglass/"
                        "hg4_128_student.yaml")
    opts = ["TEST.FLIP_TEST", "True", "GPUS", "(0,1)",
            "TPU.COMPUTE_DTYPE", "float32", "MODEL.IMAGE_SIZE", "[128,256]"]
    got = config.load_config(path, opts, data_dir="data")
    assert got.to_dict() == config_jax.load_config(path, opts,
                                                   data_dir="data").to_dict()
    assert got.is_frozen()
    with pytest.raises(KeyError):
        config.load_config(path, ["TEST.NO_SUCH_KEY", "1"])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_affine_copy_bit_equal(dtype):
    rng = np.random.RandomState(0)
    for _ in range(200):
        center = rng.uniform(0, 640, 2).astype(dtype)
        scale = rng.uniform(0.3, 3.0, 2).astype(dtype)
        rot = float(rng.uniform(-45, 45))
        size = (int(rng.choice([48, 64, 192, 256])),
                int(rng.choice([64, 256, 384])))
        for inv in (False, True):
            np.testing.assert_array_equal(
                affine.get_affine_transform(center, scale, rot, size, inv=inv),
                affine_jax.get_affine_transform(center, scale, rot, size,
                                                inv=inv))
        t = affine.get_affine_transform(center, scale, rot, size)
        pts = rng.uniform(0, 64, (17, 2))
        np.testing.assert_array_equal(affine.affine_transform(pts[0], t),
                                      affine_jax.affine_transform(pts[0], t))
        np.testing.assert_array_equal(
            affine.transform_preds(pts, center, scale, size),
            affine_jax.transform_preds(pts, center, scale, size))


@pytest.mark.parametrize("name", ["mpii", "coco", "synthetic"])
def test_dataset_meta_copy_equal(name):
    got, ref = dataset_meta(name), dataset_meta_jax(name)
    assert got.keys() == {"num_joints", "flip_pairs"}
    for k in got:
        assert got[k] == ref[k], k
    with pytest.raises(KeyError):
        dataset_meta("lsp")
