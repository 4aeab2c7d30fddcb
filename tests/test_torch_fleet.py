"""Fleet extraction of the PyTorch port, on the CPU: checkpoints, resume,
per-image failure isolation (tests/test_fleet.py's cases), the .npz
fields equal to the port's own padded extract_batch, `cli fleet` then
`cli retrieve` over its output, and utils/profiling's stage times and
trace."""

import json
import os

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (two torch threads a worker)
from hesaff_tpu_torch import cli
from hesaff_tpu_torch.batch import extract_batch
from hesaff_tpu_torch.sift_io import load_image_gray
from hesaff_tpu_torch.utils.fleet import extract_fleet, pad_to_bucket
from tests.golden.gen_images import synth_image, write_ppm

FIELDS = ("x", "y", "s", "a11", "a12", "a21", "a22", "response", "type",
          "desc")


def _write_images(tmp_path, sizes):
    paths = []
    for i, (w, h) in enumerate(sizes):
        p = str(tmp_path / f"img{i}.ppm")
        write_ppm(p, synth_image(w, h, seed=i))
        paths.append(p)
    return paths


def _quiet(_):
    pass


def test_fleet_extract_and_resume(tmp_path):
    paths = _write_images(tmp_path, [(96, 80)] * 3)
    out = str(tmp_path / "out")
    cursor = extract_fleet(paths, out, batch_size=2, log=_quiet,
                           device="cpu")
    assert len(cursor["done"]) == 3
    assert not cursor["failed"]
    for p in paths:
        base = os.path.splitext(os.path.basename(p))[0]
        d = np.load(os.path.join(out, base + ".npz"))
        assert d["desc"].shape[1] == 128
    # resume: nothing left to do, cursor unchanged
    cursor2 = extract_fleet(paths, out, batch_size=2, log=_quiet,
                            device="cpu")
    assert sorted(cursor2["done"]) == sorted(cursor["done"])


def test_fleet_isolates_bad_image(tmp_path):
    paths = _write_images(tmp_path, [(96, 80)] * 2)
    bad = str(tmp_path / "corrupt.ppm")
    with open(bad, "wb") as f:
        f.write(b"P6\n10 10\n255\nshort")  # truncated payload
    all_paths = [paths[0], bad, paths[1]]
    out = str(tmp_path / "out")
    cursor = extract_fleet(all_paths, out, batch_size=3, log=_quiet,
                           device="cpu")
    assert sorted(cursor["done"]) == sorted(paths)
    assert bad in cursor["failed"]
    with open(os.path.join(out, "cursor.json")) as f:
        saved = json.load(f)
    assert bad in saved["failed"]


def test_fleet_npz_equals_padded_extract_batch(tmp_path):
    """Mixed sizes: two share a 64-px bucket (one padded chunk), one
    rides alone; each file holds the port's padded extract_batch of its
    image, field for field."""
    paths = _write_images(tmp_path, [(96, 80), (90, 70), (130, 70)])
    out = str(tmp_path / "out")
    cursor = extract_fleet(paths, out, batch_size=3, log=_quiet,
                           device="cpu")
    assert sorted(cursor["done"]) == sorted(paths)
    shapes = {pad_to_bucket(load_image_gray(p))[0].shape for p in paths}
    assert len(shapes) == 2
    for p in paths:
        img, hw = pad_to_bucket(load_image_gray(p))
        want = extract_batch(img[None], valid_hw=np.asarray([hw], np.int32),
                             device="cpu")[0]
        d = np.load(os.path.join(out, os.path.splitext(
            os.path.basename(p))[0] + ".npz"))
        assert want.n > 0
        for k in FIELDS:
            np.testing.assert_array_equal(d[k], getattr(want, k), err_msg=k)


def test_cli_fleet_then_retrieve(tmp_path, capsys):
    paths = _write_images(tmp_path, [(96, 80), (96, 80), (112, 90)])
    bad = str(tmp_path / "corrupt.ppm")
    with open(bad, "wb") as f:
        f.write(b"P6\n10 10\n255\nshort")
    out = str(tmp_path / "db")
    rc = cli.main(["fleet", *paths, "--out-dir", out, "--batch-size", "2",
                   "--device", "cpu"])
    assert "done=3 failed=0" in capsys.readouterr().out
    assert rc == 0
    rc = cli.main(["fleet", *paths, bad, "--out-dir", out, "--device",
                   "cpu"])
    assert "done=3 failed=1" in capsys.readouterr().out
    assert rc == 1
    rc = cli.main(["retrieve", paths[2], "--db", out, "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[0] == "img2"


def test_fleet_without_device_needs_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fleet runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        extract_fleet([], str(tmp_path / "out"))


def test_stage_times_and_trace(tmp_path):
    """utils/profiling: stages accumulate wall time under their names and
    rates; trace_to writes a Chrome trace holding the stage's span."""
    import torch

    from hesaff_tpu_torch.utils.profiling import StageTimes, trace_to

    st = StageTimes()
    logdir = str(tmp_path / "trace")
    with trace_to(logdir):
        for _ in range(2):
            with st.stage("detect"):
                torch.ones(64, 64).sum()
    assert st.counts["detect"] == 2 and st.times["detect"] > 0
    rep = st.report({"detect": 10})
    assert rep.startswith("detect") and "(2x)" in rep and "/s" in rep
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        assert '"detect"' in f.read()
