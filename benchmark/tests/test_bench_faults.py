"""The comparison that decides `correct` fails the control and every
fault a cell can have.

Each fault test drives a whole run on the CPU at a small size (the
look for a card skipped) with the timed path broken underneath, and
sees `correct` come out false.  The control test reads the reference in
the precision below float32 (reference/precision.py) in the program's
place and sees it fail a limit the program meets.
"""

import numpy as np
import pytest
import torch

from bench_sizes import BATCH, QUERY, SMALL
from benchmark import control, harness
from benchmark import run as bench_run

SEED = 2**31 + 29


def limits(cell):
    return harness.load_json(harness.HERE / "workloads" /
                             f"{cell}.json")["limits"]


@pytest.mark.parametrize("cell", [BATCH, QUERY])
def test_control_fails_and_program_passes(cell):
    r = control.readings(cell, SEED, None, True, device="cpu",
                         overrides=SMALL[cell])
    lim = limits(cell)
    assert all(r["program"][k] <= v for k, v in lim.items())
    assert any(v > lim[k] for k, v in r["control"].items())


def broken_call(transform):
    """A driver hook that passes every answer of the timed path through
    transform(driver, answer)."""
    def hook(driver):
        inner = driver.call

        def call(i):
            items, answer = inner(i)
            return items, transform(driver, answer)

        driver.call = call
    return hook


def keep(feats, m):
    return {k: (v[m] if k != "overflow" else v) for k, v in feats.items()}


def half_batch_left_out(driver, answer):
    return keep(answer, answer["img"] < driver.B // 2)


def descriptors_altered(driver, answer):
    return dict(answer, desc=np.roll(answer["desc"], 1, axis=1))


def geometry_altered(driver, answer):
    return dict(answer, x=answer["x"] + 0.5)


def capacities_shrunk(driver):
    """The program's group table shrunk to 1/256 of its capacities, at
    least 8 slots a group (at the test's size the first group then holds
    fewer slots than its keypoints): the program drops keypoints, the
    reference keeps its own table."""
    driver.groups = tuple((b, max(8, c // 256)) for b, c in driver.groups)


@pytest.mark.parametrize("hook", [
    broken_call(half_batch_left_out), broken_call(descriptors_altered),
    broken_call(geometry_altered), capacities_shrunk])
def test_batch_fault_fails(hook):
    result, _ = bench_run.execute(BATCH, SEED, 0.5, False, device="cpu",
                                  overrides=SMALL[BATCH], driver_hook=hook)
    assert result["failed"] == 0 and result["correct"] is False


def half_query_left_out(driver):
    inner = driver._extract

    def extract(image):
        feats, q = inner(image)
        n = len(feats["x"]) // 2
        m = np.arange(len(feats["x"])) < n
        return keep(feats, m), q[:n]

    driver._extract = extract


def ranked_altered(driver, answer):
    r = list(answer["ranked"])
    r[0] = (r[0][0] + 1, r[0][1])
    return dict(answer, ranked=r)


def knn2_altered(monkeypatch):
    """The program's 2-NN gives each query row the next database row as
    its nearest, where its 2-NN is produced (under rank_images and
    query_votes alike)."""
    from hesaff_tpu_torch import retrieval

    inner = retrieval.knn2

    def knn2(query, db, *args, **kwargs):
        m = inner(query, db, *args, **kwargs)
        return m._replace(idx=(m.idx + 1) % len(db))

    monkeypatch.setattr(retrieval, "knn2", knn2)


@pytest.mark.parametrize("plant", [
    lambda mp: half_query_left_out, lambda mp: broken_call(ranked_altered),
    knn2_altered], ids=["half_query_left_out", "ranked_altered",
                        "knn2_altered"])
def test_query_fault_fails(plant, monkeypatch):
    hook = plant(monkeypatch)
    result, _ = bench_run.execute(QUERY, SEED, 0.5, False, device="cpu",
                                  overrides=SMALL[QUERY], driver_hook=hook)
    assert result["failed"] == 0 and result["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [BATCH, QUERY])
def test_control_fails_on_the_card(cell):
    """The control with TF32 products on the card, at the small size."""
    r = control.readings(cell, SEED, None, True, device="cuda",
                         overrides=SMALL[cell])
    lim = limits(cell)
    assert all(r["program"][k] <= v for k, v in lim.items())
    assert any(v > lim[k] for k, v in r["control"].items())
    torch.cuda.empty_cache()
