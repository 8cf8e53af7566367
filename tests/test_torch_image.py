"""The port's image library (``fhpe_tpu_torch/ops/native_image.py``)
against cv2 and ``fhpe_tpu``'s library, on this machine's ``libjpeg``
route.

* decode: bit-equal to ``cv2.imdecode`` (the cases of
  ``tests/test_native_image.py``: quality, progressive, odd sizes,
  grayscale source), BGR and RGB;
* encode: byte-equal to ``cv2.imencode`` / ``cv2.imwrite`` (quality 95
  baseline by default, other qualities, grayscale);
* warp: bit-equal to ``fhpe_tpu``'s ``warp_affine_native`` (the same C
  text), within ``tests/test_native_image.py``'s tie budget of
  ``cv2.warpAffine``, ``flip_src`` bit-equal to warping ``img[:, ::-1]``;
* disk: equal to ``cv2.circle(img, c, 6, color, -1)``, edges included;
* the synthetic writers: ``fhpe_tpu``'s records, pre-encode pixels and
  files;
* the build: route choice and a race of parallel builds.
"""

import json
import threading
import zipfile

import numpy as np
import pytest
from scipy.io import loadmat

from fhpe_tpu.data import synthetic as synthetic_jax
from fhpe_tpu.geometry.affine import get_affine_transform
from fhpe_tpu.ops import native_image as ni_jax
from fhpe_tpu_torch.data import synthetic
from fhpe_tpu_torch.ops import native_image as ni
from fhpe_tpu_torch.utils import zipreader

from torch_threads import torch_threads  # noqa: F401

cv2 = pytest.importorskip("cv2")

COLOR = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION


def _tie_close(ref, got, tie_budget=4):
    """Equality up to +-1 at isolated rounding ties
    (``tests/test_native_image.py::_warp_close``)."""
    d = np.abs(ref.astype(np.int32) - got.astype(np.int32))
    assert d.max() <= 1, f"maxdiff {d.max()} > 1"
    assert (d > 0).sum() <= tie_budget, \
        f"{(d > 0).sum()} differing values (allowed {tie_budget})"


def test_route_is_libjpeg_here():
    assert ni.route() == "libjpeg"
    assert ni.probe()["jpeglib_h"]


@pytest.mark.parametrize("hw,quality,progressive", [
    ((64, 96), 90, False),
    ((123, 77), 75, False),     # odd dims exercise chroma edge handling
    ((200, 151), 95, True),     # progressive scan path
    ((33, 41), 100, False),
])
def test_decode_bit_equal_cv2(hw, quality, progressive):
    rng = np.random.RandomState(sum(hw) + quality)
    img = rng.randint(0, 256, (*hw, 3), np.uint8)
    flags = [int(cv2.IMWRITE_JPEG_QUALITY), quality]
    if progressive:
        flags += [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1]
    buf = cv2.imencode(".jpg", img, flags)[1]
    ref = cv2.imdecode(buf, COLOR)
    np.testing.assert_array_equal(ni.decode_jpeg_bytes(buf.tobytes()), ref)
    np.testing.assert_array_equal(
        ni.decode_jpeg_bytes(buf.tobytes(), bgr=False), ref[:, :, ::-1])


def test_decode_grayscale_source_and_files(tmp_path):
    rng = np.random.RandomState(9)
    gray = rng.randint(0, 256, (50, 70), np.uint8)
    buf = cv2.imencode(".jpg", gray)[1]
    np.testing.assert_array_equal(ni.decode_jpeg_bytes(buf.tobytes()),
                                  cv2.imdecode(buf, COLOR))
    img = rng.randint(0, 256, (40, 60, 3), np.uint8)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(ni.imread(path), cv2.imread(path, COLOR))
    zpath = tmp_path / "imgs.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.write(path, "sub/a.jpg")
    np.testing.assert_array_equal(zipreader.imread(f"{zpath}@/sub/a.jpg"),
                                  cv2.imread(path, COLOR))


def test_not_a_jpeg_raises(tmp_path):
    png = cv2.imencode(".png", np.zeros((8, 8, 3), np.uint8))[1].tobytes()
    with pytest.raises(ValueError, match="not a JPEG"):
        ni.decode_jpeg_bytes(png, name="x.png")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff garbage")
    with pytest.raises(ValueError, match="bad.jpg"):
        ni.imread(str(bad))
    with pytest.raises(OSError):
        ni.imread(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("quality", [95, 75, 100])
def test_encode_bytes_equal_cv2(quality):
    rng = np.random.RandomState(quality)
    for hw in [(64, 64), (123, 77), (33, 41)]:
        img = rng.randint(0, 40, (*hw, 3), np.uint8)
        cv2.circle(img, (20, 20), 6, (100, 200, 200), -1)
        ref = cv2.imencode(".jpg", img,
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])[1]
        assert ni.encode_jpeg(img, quality) == ref.tobytes(), hw
        # RGB input with bgr=False is the same stream
        assert ni.encode_jpeg(img[:, :, ::-1], quality, bgr=False) == \
            ref.tobytes()
    gray = rng.randint(0, 256, (50, 70), np.uint8)
    assert ni.encode_jpeg(gray, quality) == cv2.imencode(
        ".jpg", gray, [int(cv2.IMWRITE_JPEG_QUALITY), quality])[1].tobytes()


def test_imwrite_file_equal_cv2(tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (256, 256, 3), np.uint8)
    ni.imwrite(str(tmp_path / "port.jpg"), img)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), img)
    assert (tmp_path / "port.jpg").read_bytes() == \
        (tmp_path / "cv2.jpg").read_bytes()


def test_warp_equal_fhpe_tpu_and_cv2():
    rng = np.random.RandomState(1)
    for i in range(12):
        h, w = rng.randint(8, 240), rng.randint(8, 240)
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        if i % 2:   # a pose crop, as the loader makes
            c = np.array([rng.uniform(-50, w + 50), rng.uniform(-50, h + 50)])
            s = rng.uniform(0.2, 3.0, 2)
            M = get_affine_transform(c, s, rng.uniform(-90, 90),
                                     np.array([128, 96]))
            dsize = (128, 96)
        else:
            M = rng.uniform(-2, 2, (2, 3))
            M[:, 2] = rng.uniform(-100, 100, 2)
            dsize = (rng.randint(4, 128), rng.randint(4, 128))
        got = ni.warp_affine(img, M, dsize)
        np.testing.assert_array_equal(
            got, ni_jax.warp_affine_native(img, M, dsize))
        _tie_close(cv2.warpAffine(img, M, dsize, flags=cv2.INTER_LINEAR),
                   got)
        np.testing.assert_array_equal(
            ni.warp_affine(img, M, dsize, flip_src=True),
            ni.warp_affine(np.ascontiguousarray(img[:, ::-1]), M, dsize))
    gray = rng.randint(0, 256, (64, 48), np.uint8)
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    np.testing.assert_array_equal(ni.warp_affine(gray, eye, (48, 64)), gray)


def test_disk_equals_cv2_circle():
    """The 13 x 13 mask, and painting it over a noisy image at random
    centres, edges and corners included, with later disks on top."""
    ref = np.zeros((13, 13), np.uint8)
    cv2.circle(ref, (6, 6), 6, 1, -1)
    np.testing.assert_array_equal(ni.DISK, ref.astype(bool))
    rng = np.random.RandomState(4)
    img = rng.randint(0, 40, (60, 80, 3), np.uint8)
    want = img.copy()
    centers = [(0, 0), (79, 59), (3, 57), (78, 1)] + [
        (int(rng.randint(-5, 85)), int(rng.randint(-5, 65)))
        for _ in range(20)]
    for j, c in enumerate(centers):
        color = (int(80 + 10 * j), int(255 - 10 * j), 200)
        cv2.circle(want, c, 6, color, -1)
        ni.fill_disk(img, c, color)
    np.testing.assert_array_equal(img, want)


def _capture(monkeypatch, module, attr):
    """Record the arrays handed to ``module.attr`` (an image writer)."""
    seen = []
    orig = getattr(module, attr)

    def write(path, img, *args):
        seen.append((str(path).rsplit("/", 1)[-1], img.copy()))
        return orig(path, img, *args)

    monkeypatch.setattr(module, attr, write)
    return seen


def test_synthetic_writers_match_fhpe_tpu(tmp_path, monkeypatch):
    """The same records, the same pixels before encoding and the same
    files, for all three writers."""
    port_px = _capture(monkeypatch, synthetic, "imwrite")
    ref_px = _capture(monkeypatch, cv2, "imwrite")
    a, b = tmp_path / "port", tmp_path / "ref"
    for root in (a, b):
        mod = synthetic if root == a else synthetic_jax
        ann = mod.make_synthetic_mpii(str(root / "mpii"), "synval", 6,
                                      (96, 128), seed=0)
        coco = mod.make_synthetic_coco(str(root / "coco"), "syn2017", 5,
                                       (80, 64), seed=1)
        db = mod.make_synthetic_db(str(root / "db"), 4, 16, (64, 72), seed=2)
        if root == a:
            port = (ann, coco, db)
        else:
            ref = (ann, coco, db)
    assert len(port_px) == len(ref_px) == 15
    for (name, got), (name_ref, want) in zip(port_px, ref_px):
        assert name == name_ref
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port[2], ref[2]):
        assert got.keys() == want.keys()
        for k in got:
            if k == "image":
                assert got[k].replace(str(a), str(b)) == want[k]
            else:
                np.testing.assert_array_equal(got[k], want[k])
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    for port_file, ref_file in zip(port[:2], ref[:2]):
        assert json.load(open(port_file)) == json.load(open(ref_file))
    mat = [loadmat(str(r / "mpii/annot/gt_synval.mat")) for r in (a, b)]
    for k in ("jnt_missing", "pos_gt_src", "headboxes_src",
              "dataset_joints"):
        np.testing.assert_array_equal(mat[0][k], mat[1][k])
    jpgs = sorted(p.relative_to(b) for p in b.rglob("*.jpg"))
    assert len(jpgs) == 15
    for rel in jpgs:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_route_choice_and_commands():
    assert ni.choose_route({"jpeglib_h": True, "nvjpeg_h": True,
                            "libnvjpeg": True}) == "libjpeg"
    assert ni.choose_route({"jpeglib_h": False, "nvjpeg_h": True,
                            "libnvjpeg": True}) == "nvjpeg"
    with pytest.raises(RuntimeError, match="no JPEG codec"):
        ni.choose_route({"jpeglib_h": False, "nvjpeg_h": True,
                         "libnvjpeg": False})
    cmd = ni._command("nvjpeg", "out.so")
    assert "-DFHPE_NO_LIBJPEG" in cmd and "-lnvjpeg" in cmd
    assert any(c.endswith("jpeg_nvjpeg.cpp") for c in cmd)
    assert "-ffp-contract=off" in ni._command("libjpeg", "out.so")
    assert ni.library_path("libjpeg") != ni.library_path("nvjpeg")
    with pytest.raises(ValueError, match="route"):
        ni._command("png", "out.so")


def test_parallel_builds_never_expose_a_partial_library(tmp_path,
                                                        monkeypatch):
    """Four threads build at once into an empty build root (as ``pytest -n``
    workers do): each gets the finished library and it loads."""
    import ctypes
    monkeypatch.setattr(ni, "_BUILD_ROOT", tmp_path)
    paths, errors = [], []

    def go():
        try:
            paths.append(ni.build("libjpeg"))
            ctypes.CDLL(str(paths[-1])).fhpe_warp_affine_u8
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(paths)) == 1 and paths[0].parent.parent == tmp_path
    assert [p.name for p in paths[0].parent.iterdir()] == [ni.LIB_NAME]


def test_jpeg_route_tool_round_trip_and_check(tmp_path):
    """``tools/jpeg_route.py`` on this route: its kept files decode back
    to the kept pixels exactly (color and grayscale), and its round trip
    is cv2's (same bytes, same decode)."""
    from fhpe_tpu_torch.tools import jpeg_route

    out = jpeg_route.main(["--images", "3", "--size", "64", "--write",
                           str(tmp_path), "--check", str(tmp_path)])
    for key in ("vs_kept_decode", "gray_vs_kept_decode"):
        assert out[key]["files"] == 3 and out[key]["max_abs"] == 0, key
    images = jpeg_route.draw_images(3, 64)
    want = [cv2.imdecode(cv2.imencode(".jpg", img)[1], COLOR)
            for img in images]
    assert out["vs_encoded"] == jpeg_route._diff(want, images)
