"""The port's CLI (python -m hesaff_tpu_torch.cli) on the CPU: the slice
as a whole, from an image to an Oxford file, a verified match, a
repeatability line and a ranked list.

The extracted file passes the 200x160 oracle golden's sift_file gate,
the one the JAX package's extraction passes (>= 97% of the oracle's
keypoints within 0.5 px, ellipse rel < 0.02, descriptor L1 < 0.5, count
within max(2, 2%)); every summary line has the JAX CLI's format.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (two torch threads a worker)
from hesaff_tpu_torch import cli, extract
from hesaff_tpu_torch.sift_io import load_image_gray, read_sift_file
from tests.conftest import parse_sift_bytes
from tests.golden.gen_images import synth_image, write_ppm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = os.path.join(ROOT, "tests", "golden", "data", "synth_200x160.ppm")
FLOAT = r"[0-9.e+-]+"


def test_cli_extract_passes_the_golden_gate(tmp_path, golden_small):
    out = str(tmp_path / "cli.sift")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "hesaff_tpu_torch.cli", "extract", IMG,
         "-o", out, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert re.fullmatch(rf"Detected \d+ keypoints and (\d+) affine shapes "
                        rf"in {FLOAT} sec\.\n", r.stdout), r.stdout
    gu, gv, ge, gdesc = parse_sift_bytes(golden_small["sift_file"])
    back = read_sift_file(out)
    n = len(back["u"])
    assert int(re.search(r"and (\d+) affine", r.stdout).group(1)) == n
    assert abs(n - len(gu)) <= max(2, 0.02 * len(gu))
    ell = np.stack([back["e00"], back["e01"], back["e11"]], 1)
    matched = 0
    for i in range(len(gu)):
        dd = np.hypot(back["u"] - gu[i], back["v"] - gv[i])
        j = int(dd.argmin())
        if dd[j] < 0.5:
            matched += 1
            rel = np.abs(ell[j] - ge[i]).max() / max(np.abs(ge[i]).max(),
                                                      1e-12)
            assert rel < 0.02, f"ellipse mismatch at oracle kp {i}"
            l1 = np.abs(back["desc"][j].astype(np.int32) - gdesc[i]).mean()
            assert l1 < 0.5, f"descriptor mismatch at oracle kp {i}"
    assert matched >= 0.97 * len(gu)


@pytest.mark.parametrize("verify", ["fundamental", "homography"])
def test_cli_match_self(tmp_path, capsys, verify):
    out = str(tmp_path / "pairs.npz")
    rc = cli.main(["match", IMG, IMG, "--device", "cpu", "--verify", verify,
                   "-o", out])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    m = re.fullmatch(r"(\d+) x (\d+) features -> (\d+) tentative matches",
                     lines[0])
    assert m and m.group(1) == m.group(2) == m.group(3), lines
    n = int(m.group(1))
    assert n > 8
    r = re.fullmatch(rf"RANSAC \({verify}\): (\d+) inliers", lines[1])
    assert r and int(r.group(1)) == n, lines
    pairs = np.load(out)
    np.testing.assert_array_equal(pairs["idx1"], np.arange(n))
    np.testing.assert_array_equal(pairs["idx2"], np.arange(n))


def test_cli_eval_self(capsys):
    assert cli.main(["eval", IMG, IMG, "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    m = re.fullmatch(r"n1=(\d+) n2=(\d+) correspondences=(\d+) "
                     r"repeatability=([0-9.]+) matches=(\d+) "
                     r"matching_score=([0-9.]+)", line)
    assert m, line
    assert m.group(1) == m.group(2) == m.group(3) == m.group(5)
    assert m.group(4) == "1.000" and m.group(6) == "1.000"


def test_cli_retrieve_self_top1(tmp_path, capsys):
    """Three .npz feature files made by the port's extraction; querying
    with one of their images ranks its own file first."""
    db = tmp_path / "feats"
    db.mkdir()
    paths = []
    for i in range(3):
        p = str(tmp_path / f"db{i}.ppm")
        write_ppm(p, synth_image(96, 80, seed=i))
        paths.append(p)
        np.savez(db / f"db{i}.npz",
                 desc=extract(load_image_gray(p), device="cpu").desc)
    rc = cli.main(["retrieve", paths[1], "--db", str(db), "--topk", "3",
                   "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and all(re.fullmatch(r"db\d \d+", ln) for ln in lines)
    assert lines[0].split()[0] == "db1"
    assert int(lines[0].split()[1]) > int(lines[-1].split()[1]) \
        or len(lines) == 1


def test_cli_retrieve_empty_db(tmp_path, capsys):
    assert cli.main(["retrieve", IMG, "--db", str(tmp_path),
                     "--device", "cpu"]) == 1
    assert "no .npz feature files" in capsys.readouterr().err
