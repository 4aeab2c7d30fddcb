"""Oxford ".hesaff.sift" text format + image loading.

The port's copy of ``hesaff_tpu/sift_io.py``: the same functions, held
equal to the JAX package's by ``tests/test_torch_config.py`` and
``tests/test_torch_io.py``.  Format (the perdoch/hesaff reference's
export)::

    D
    m
    u v a b c d0 .. d(D-1)   (m lines)

where the ellipse a(x-u)^2 + 2b(x-u)(y-v) + c(y-v)^2 = 1 has
[[a,b],[b,c]] = (A A^T)^(-1) / (mrSize*s)^2, in closed form.
Descriptor entries are quantized uint8 printed as ints.  D is 128 at
the default 4x4x8 bins; the port writes the true width sb*sb*ob of
other bin layouts (see write_sift_file).

``write_sift_file`` takes numpy arrays or tensors on any device: each
tensor is copied to the host once, and the geometry is widened to
float64 there, exactly as the JAX writer does, so the two write the
same bytes for the same features.
"""

from __future__ import annotations

import numpy as np
import torch


def ellipse_abc(a11, a12, a21, a22, s, mr_size: float):
    """Closed-form E = (A A^T)^(-1) / (mrSize*s)^2 -> (E00, E01, E11).

    A has det 1 (rectified), so (A A^T)^(-1) = adj(A A^T).
    """
    sc = mr_size * np.asarray(s, np.float64)
    sc2 = sc * sc
    m00 = a11 * a11 + a12 * a12
    m01 = a11 * a21 + a12 * a22
    m11 = a21 * a21 + a22 * a22
    det = m00 * m11 - m01 * m01
    e00 = m11 / (det * sc2)
    e01 = -m01 / (det * sc2)
    e11 = m00 / (det * sc2)
    return e00, e01, e11


def format_float(v: float) -> str:
    """C++ default ostream formatting: 6 significant digits."""
    return f"{v:.6g}"


def _host(a) -> np.ndarray:
    """A numpy array of `a`; a tensor is copied to the host once."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_sift_file(path: str, x, y, s, a11, a12, a21, a22, desc,
                    mr_size: float) -> None:
    """Write keypoints in the Oxford format (arrays or tensors of
    shape (N, ...)).

    desc is (N, D): the header gives D, the descriptor's true width.
    Here the port departs from the JAX package, whose writer always
    writes "128" and reads 128 bytes a row, so a 3x3x8 (72-wide) set
    round-trips only through the port (read_sift_file reads any D).
    """
    x, y, s, a11, a12, a21, a22, desc = map(
        _host, (x, y, s, a11, a12, a21, a22, desc))
    e00, e01, e11 = ellipse_abc(
        np.asarray(a11, np.float64),
        np.asarray(a12, np.float64),
        np.asarray(a21, np.float64),
        np.asarray(a22, np.float64),
        np.asarray(s, np.float64),
        mr_size,
    )
    write_sift(path, x, y, e00, e01, e11, desc)


def write_sift(path: str, u, v, e00, e01, e11, desc) -> None:
    """Low-level writer: already-computed ellipse params + uint8 desc.

    Prefers the native C++ writer (hesaff_tpu_torch.native), which
    writes 128-wide rows only; descriptors of any other width, and any
    width where the native library cannot be built, take the Python
    writer.
    """
    from hesaff_tpu_torch import native

    desc = np.asarray(desc, np.uint8)
    if desc.shape[1] == 128 and native.write_sift(path, u, v, e00, e01,
                                                  e11, desc):
        return
    write_sift_python(path, u, v, e00, e01, e11, desc)


def write_sift_python(path: str, u, v, e00, e01, e11, desc) -> None:
    """The pure-Python writer (byte-equal to the native one at width
    128; the header gives desc's width D)."""
    desc = np.asarray(desc, np.int64)
    n = len(u)
    lines = [str(desc.shape[1]), str(n)]
    for i in range(n):
        head = " ".join(
            format_float(float(t)) for t in (u[i], v[i], e00[i], e01[i], e11[i])
        )
        lines.append(head + " " + " ".join(str(int(t)) for t in desc[i]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_sift_file(path: str):
    """Parse a .hesaff.sift file -> dict of numpy arrays.  The native
    reader takes width 128 only; other widths are read by the Python
    reader."""
    from hesaff_tpu_torch import native

    out = native.read_sift(path)
    if out is not None:
        return out
    return read_sift_python(path)


def read_sift_python(path: str):
    """The pure-Python reader."""
    with open(path) as f:
        toks = f.read().split()
    dim = int(toks[0])
    n = int(toks[1])
    body = np.asarray(toks[2:], dtype=np.float64).reshape(n, 5 + dim)
    return {
        "u": body[:, 0],
        "v": body[:, 1],
        "e00": body[:, 2],
        "e01": body[:, 3],
        "e11": body[:, 4],
        "desc": body[:, 5:].astype(np.uint8),
    }


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def load_image_gray(path: str) -> np.ndarray:
    """Load an image and convert to float32 gray as (B+G+R)/3.

    Equal-weight conversion is parity-critical (the reference divides
    by 3, not by luma weights).  PNM (P6/P5), 8/16-bit PNG and JPEG are
    decoded natively; other formats go through PIL if available.
    """
    from hesaff_tpu_torch import native

    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"P6", b"P5"):
        out = native.decode_pnm_gray(_read_bytes(path))
        if out is not None:
            return out
        return _load_pnm_gray(path)
    if magic == b"\x89P":
        out = native.decode_png_gray(_read_bytes(path))
        if out is not None:
            return out
        # unsupported PNG variant (interlaced) -> PIL below
    if magic == b"\xff\xd8":
        out = native.decode_jpeg_gray(_read_bytes(path))
        if out is not None:
            return out
        # CMYK / 12-bit / arithmetic JPEG -> PIL below
    try:
        from PIL import Image  # optional: exotic formats (TIFF...)
    except ImportError as e:  # pragma: no cover
        raise ValueError(
            f"cannot decode {path!r}: native decoders cover PNM, PNG and "
            "baseline/progressive JPEG; install pillow for other formats"
        ) from e

    img = np.asarray(Image.open(path).convert("RGB"), np.float32)
    return img.mean(axis=-1)


def _load_pnm_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval separated by whitespace/comments
    pos = 0
    fields = []
    while len(fields) < 4:
        # skip whitespace and comments
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    magic, w, h = fields[0], int(fields[1]), int(fields[2])
    maxval = int(fields[3])
    if maxval > 255:
        raise ValueError(
            f"16-bit PNM not supported (maxval={maxval}); convert to 8-bit"
        )
    raw = np.frombuffer(data, np.uint8, offset=pos)
    if magic == b"P6":
        rgb = raw[: w * h * 3].reshape(h, w, 3).astype(np.float32)
        return (rgb[..., 0] + rgb[..., 1] + rgb[..., 2]) / 3.0
    return raw[: w * h].reshape(h, w).astype(np.float32)
