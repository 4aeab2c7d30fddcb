"""The port's Oxford export at descriptor widths other than 128.

At spatial_bins=3 a descriptor is 3*3*8 = 72 bytes wide.  The port
writes such a set with its true width in the header, through the Python
writer (the native one takes 128-wide rows only and raises at any other
width instead of reading past the buffer), and reads it back through
read_sift_file (where the native reader refuses dim != 128) and
read_sift_python.  The default 4x4x8 file stays byte-equal to the JAX
writer's.  An empty batch has the width of a non-empty one.  The JAX
package still writes "128" (no file of it changes), so only the port
is held to the round trip.
"""

import dataclasses

import numpy as np
import pytest

from hesaff_tpu import sift_io as jsio
from hesaff_tpu_torch import HesaffConfig, extract, extract_batch, native
from hesaff_tpu_torch import sift_io

CFG = HesaffConfig()
CFG72 = dataclasses.replace(CFG, spatial_bins=3)
FIELDS = ("x", "y", "s", "a11", "a12", "a21", "a22")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def feats72(golden_small):
    f = extract(golden_small["gray"], CFG72, device="cpu")
    assert f.desc.shape == (f.n, 72) and f.n > 40
    return f


@pytest.mark.parametrize("reader", ["read_sift_file", "read_sift_python"])
def test_width_72_round_trip(tmp_path, feats72, reader):
    f = feats72
    path = str(tmp_path / "w72.sift")
    sift_io.write_sift_file(path, *(getattr(f, k) for k in FIELDS), f.desc,
                            CFG72.mr_size)
    assert _read(path).startswith(f"72\n{f.n}\n".encode())
    back = getattr(sift_io, reader)(path)
    np.testing.assert_array_equal(back["desc"], f.desc)
    np.testing.assert_allclose(back["u"], f.x, rtol=1e-5)
    np.testing.assert_allclose(back["v"], f.y, rtol=1e-5)
    e = sift_io.ellipse_abc(*(np.asarray(getattr(f, k), np.float64)
                              for k in ("a11", "a12", "a21", "a22", "s")),
                            CFG72.mr_size)
    for k, want in zip(("e00", "e01", "e11"), e):
        np.testing.assert_allclose(back[k], want, rtol=1e-5, atol=1e-12)
    # the native reader takes 128-wide files only
    assert native.read_sift(path) is None


def test_native_writer_rejects_other_widths(tmp_path):
    z = np.zeros(3)
    with pytest.raises(ValueError, match="128"):
        native.write_sift(str(tmp_path / "x.sift"), z, z, z, z, z,
                          np.full((3, 72), 7, np.uint8))
    assert not (tmp_path / "x.sift").exists()


def test_default_width_byte_equal_to_jax(tmp_path, golden_small):
    f = extract(golden_small["gray"], CFG, device="cpu")
    args = [getattr(f, k) for k in FIELDS] + [f.desc]
    mine, ref = str(tmp_path / "port.sift"), str(tmp_path / "jax.sift")
    sift_io.write_sift_file(mine, *args, CFG.mr_size)
    jsio.write_sift_file(ref, *args, CFG.mr_size)
    assert _read(mine) == _read(ref)
    assert _read(mine).startswith(f"128\n{f.n}\n".encode())


@pytest.mark.parametrize("cfg,width", [(CFG, 128), (CFG72, 72),
                                       (dataclasses.replace(
                                           CFG, orientation_bins=6), 96)])
def test_empty_batch_has_the_descriptor_width(cfg, width):
    feats = extract_batch(np.zeros((2, 48, 56), np.float32), cfg,
                          device="cpu")
    assert [f.desc.shape for f in feats] == [(0, width)] * 2
