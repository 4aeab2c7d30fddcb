"""The port's Oxford export and image I/O (hesaff_tpu_torch.sift_io and
.native) against the JAX package's.

The features are the 200x160 oracle golden's affine shapes and
descriptors.  Files must be byte-equal across the JAX writer, the
port's native writer and its Python writer; decoders equal (same C++
sources, so exactly); the loader keeps input order.
"""

import os

import numpy as np
import pytest
import torch

from hesaff_tpu import native as jnative
from hesaff_tpu import sift_io as jsio
from hesaff_tpu.utils.fleet import pad_to_bucket
from hesaff_tpu_torch import native, sift_io

PIL = pytest.importorskip("PIL.Image")
MR = 3.0 * 3.0 ** 0.5


def golden_features(golden, dtype=np.float32):
    """(x, y, s, a11, a12, a21, a22, desc) from the golden's affine
    shapes (x, y, s, pd, u11, u12, u21, u22, ...) and descriptors."""
    a = golden["affine_shapes"].astype(dtype)
    n = len(golden["descriptors"])
    cols = [a[:n, i] for i in (0, 1, 2, 4, 5, 6, 7)]
    return (*cols, golden["descriptors"].astype(np.uint8))


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_ellipse_abc_equals_jax(golden_small):
    x, y, s, a11, a12, a21, a22, _ = golden_features(golden_small,
                                                     np.float64)
    for mine, ref in zip(sift_io.ellipse_abc(a11, a12, a21, a22, s, MR),
                         jsio.ellipse_abc(a11, a12, a21, a22, s, MR)):
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("dtype", ["float32", "float64", "tensor"])
def test_write_sift_file_byte_equal(tmp_path, golden_small, dtype):
    """JAX writer == port native writer == port Python writer, from
    numpy float32 / float64 features and from tensors."""
    feats = golden_features(golden_small,
                            np.float64 if dtype == "float64" else np.float32)
    ref = str(tmp_path / "jax.sift")
    jsio.write_sift_file(ref, *feats, MR)
    arg = ([torch.from_numpy(np.array(a)) for a in feats]
           if dtype == "tensor" else feats)
    nat = str(tmp_path / "native.sift")
    assert native.available(), "the native library did not build"
    sift_io.write_sift_file(nat, *arg, MR)
    x, y, s, a11, a12, a21, a22, desc = feats
    e = sift_io.ellipse_abc(*(np.asarray(a, np.float64)
                              for a in (a11, a12, a21, a22, s)), MR)
    py = str(tmp_path / "python.sift")
    sift_io.write_sift_python(py, x, y, *e, desc)
    assert read(nat) == read(ref)
    assert read(py) == read(ref)
    assert read(ref).startswith(b"128\n55\n")


def test_native_path_taken(tmp_path, golden_small, monkeypatch):
    """Where g++ exists the native writer and reader run: with the
    Python ones made to fail, writing and reading still succeed."""
    def fail(*a, **k):
        raise AssertionError("the Python fallback ran")

    monkeypatch.setattr(sift_io, "write_sift_python", fail)
    monkeypatch.setattr(sift_io, "read_sift_python", fail)
    path = str(tmp_path / "out.sift")
    sift_io.write_sift_file(path, *golden_features(golden_small), MR)
    assert len(sift_io.read_sift_file(path)["u"]) == 55


def test_read_sift_file_round_trip(tmp_path, golden_small):
    feats = golden_features(golden_small)
    path = str(tmp_path / "out.sift")
    sift_io.write_sift_file(path, *feats, MR)
    nat = sift_io.read_sift_file(path)
    py = sift_io.read_sift_python(path)
    ref = jsio.read_sift_file(path)
    assert set(nat) == set(py) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(nat[k], ref[k])
        np.testing.assert_array_equal(py[k], ref[k])
    np.testing.assert_array_equal(nat["desc"], feats[-1])
    np.testing.assert_allclose(nat["u"], feats[0], rtol=1e-5)
    # the oracle's own file reads back as the JAX reader reads it
    raw = str(tmp_path / "golden.sift")
    with open(raw, "wb") as f:
        f.write(bytes(golden_small["sift_file"]))
    for k, v in jsio.read_sift_file(raw).items():
        np.testing.assert_array_equal(sift_io.read_sift_file(raw)[k], v)


def test_native_library_is_the_ports(tmp_path, monkeypatch):
    """The port builds its own library under its build directory, keyed
    by the sources, with g++ writing nowhere else: never the JAX
    package's native/libhesaff_io.so."""
    calls = []
    run = native.subprocess.run

    def record(cmd, **kw):
        calls.append(list(cmd))
        return run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", record)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available()
    so = native.library_path()
    assert so.parent == tmp_path / "build" and so.exists()
    assert so.name.startswith("libhesaff_io-") and so.suffix == ".so"
    assert len(calls) == 1 and calls[0][0] == "g++"
    out = calls[0][calls[0].index("-o") + 1]
    assert os.path.dirname(out) == str(tmp_path / "build")
    assert not out.endswith(os.path.join("native", "libhesaff_io.so"))
    assert sorted(os.listdir(tmp_path / "build")) == [so.name]


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P"])
def test_png_decoder_equals_jax(tmp_path, mode):
    rng = np.random.RandomState(3)
    arr = rng.randint(0, 256, (37, 53, 3), np.uint8)
    path = str(tmp_path / f"img_{mode}.png")
    PIL.fromarray(arr, "RGB").convert(mode).save(path)
    data = read(path)
    mine = native.decode_png_gray(data)
    assert mine is not None
    np.testing.assert_array_equal(mine, jnative.decode_png_gray(data))
    np.testing.assert_array_equal(sift_io.load_image_gray(path),
                                  jsio.load_image_gray(path))


def test_png16_decoder_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    img16 = rng.integers(0, 65536, (33, 47), np.uint16)
    path = str(tmp_path / "img16.png")
    PIL.fromarray(img16.astype(np.int32), mode="I").convert(
        "I;16").save(path)
    data = read(path)
    mine = native.decode_png_gray(data)
    assert mine is not None
    np.testing.assert_array_equal(mine, jnative.decode_png_gray(data))


@pytest.mark.parametrize("mode,sub,q,prog", [
    ("RGB", 0, 95, False), ("RGB", 2, 85, False), ("L", 0, 90, False),
    ("RGB", 2, 75, True),
])
def test_jpeg_decoder_equals_jax(tmp_path, mode, sub, q, prog):
    rng = np.random.RandomState(11)
    a = rng.normal(128, 50, (61, 97, 3)).astype(np.float32)
    for _ in range(6):
        for ax in (0, 1):
            a = (a + np.roll(a, 1, ax)) * 0.5
    a = np.clip(a, 0, 255).astype(np.uint8)
    path = str(tmp_path / "img.jpg")
    kw = {"quality": q, "progressive": prog}
    if mode == "RGB":
        kw["subsampling"] = sub
    PIL.fromarray(a if mode == "RGB" else a[..., 0], mode).save(
        path, "JPEG", **kw)
    data = read(path)
    mine = native.decode_jpeg_gray(data)
    assert mine is not None
    np.testing.assert_array_equal(mine, jnative.decode_jpeg_gray(data))
    np.testing.assert_array_equal(sift_io.load_image_gray(path), mine)


@pytest.mark.parametrize("magic", [b"P6", b"P5"])
def test_pnm_decoder_equals_jax(tmp_path, magic):
    rng = np.random.RandomState(4)
    ch = 3 if magic == b"P6" else 1
    pix = rng.randint(0, 256, (21, 31, ch), np.uint8)
    path = str(tmp_path / "img.pnm")
    with open(path, "wb") as f:
        f.write(magic + b"\n# a comment\n31 21\n255\n" + pix.tobytes())
    data = read(path)
    mine = native.decode_pnm_gray(data)
    np.testing.assert_array_equal(mine, jnative.decode_pnm_gray(data))
    np.testing.assert_array_equal(sift_io._load_pnm_gray(path), mine)
    np.testing.assert_array_equal(sift_io.load_image_gray(path),
                                  jsio.load_image_gray(path))


def test_prefetch_loader_keeps_order(tmp_path):
    """Input order, a None for an undecodable file, and the JAX loader's
    padded images, for PNM, PNG and JPEG inputs."""
    rng = np.random.RandomState(7)
    paths = []
    for i in range(7):
        h, w = int(rng.randint(40, 140)), int(rng.randint(40, 140))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ext = ("ppm", "png", "jpg")[i % 3]
        p = str(tmp_path / f"im{i}.{ext}")
        if ext == "ppm":
            with open(p, "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (w, h) + img.tobytes())
        else:
            PIL.fromarray(img).save(p)
        paths.append(p)
    bad = str(tmp_path / "bad.ppm")
    with open(bad, "wb") as f:
        f.write(b"P6 garbage")
    paths.insert(3, bad)
    with native.PrefetchLoader(paths, threads=3, queue_cap=2) as loader:
        out = list(loader)
    with jnative.PrefetchLoader(paths, threads=1) as loader:
        ref = list(loader)
    assert [p for p, _, _ in out] == paths
    for (p, img, hw), (_, rimg, rhw) in zip(out, ref):
        if p == bad:
            assert img is None and rimg is None
            continue
        assert hw == rhw
        np.testing.assert_array_equal(img, rimg)
        padded, phw = pad_to_bucket(sift_io.load_image_gray(p))
        assert phw == hw
        np.testing.assert_array_equal(img, padded)
