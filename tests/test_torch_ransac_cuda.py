"""The K8 kernel (ops/cuda_ransac: every F hypothesis' inlier count under
the Sampson distance) against the benchmark's plain reference, on a GPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is
false.  They need neither JAX nor the golden fixtures, so on a GPU host
they run as

    python -m pytest tests/test_torch_ransac_cuda.py --noconftest -q

K8's counts equal those of benchmark/reference/pairs.sampson (float32,
TF32 off) under the threshold bit for bit: at hypothesis and match
counts that fill no whole CTA or tile, at 8 matches and at a 24 MP
pair's ~51,000; for a NaN model (no inlier), a model whose denominator
is clamped at 1e-12 and the zero model; and at thresholds set to a
distance and one float32 ulp either side of it.  ransac_fundamental on
the card launches K8 once, picks the hypothesis the reference's counts
pick and ends on the model and inliers that its refits give from there;
the scoring stores no (H, N) value.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
# the benchmark's sequential-matching cell: 6048x4032 frames, 4 px
WIDTH, HEIGHT, FOCAL, THRESHOLD = 6048, 4032, 3400.0, 16.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def two_view(n, seed, dev, outlier_frac=0.3):
    """n correspondences (float32 (n, 2) pixel positions on `dev`) of two
    6048x4032 views 7.5 degrees apart round a scene 6-12 units away,
    with 0.5 px noise; the first outlier_frac of the second view's
    points moved anywhere in the frame."""
    rng = np.random.default_rng(seed)
    K = np.array([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]])
    a = np.radians(7.5)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-0.9, 0.03, 0.1])
    X = rng.uniform([-3, -2, 6], [3, 2, 12], (n, 3))
    project = lambda P: (P / P[:, 2:3]) @ K.T
    p1 = project(X)[:, :2] + rng.normal(0, 0.5, (n, 2))
    p2 = project(X @ R.T + t)[:, :2] + rng.normal(0, 0.5, (n, 2))
    out = int(n * outlier_frac)
    p2[:out] = rng.uniform([0, 0], [WIDTH, HEIGHT], (out, 2))
    on = lambda p: torch.as_tensor(p, dtype=torch.float32, device=dev)
    return on(p1), on(p2)


def hypotheses(p1, p2, h, seed):
    """The program's draws and 8-point solves of h hypotheses (seeded),
    the first three replaced by a NaN model, a model whose denominator
    falls under 1e-12 and the zero model."""
    from hesaff_tpu_torch import ransac
    from hesaff_tpu_torch.match import full_f32

    g = torch.Generator(device=p1.device).manual_seed(seed)
    sel = ransac.draw_minimal_sets(len(p1), h, 8, g)
    with full_f32():
        models = ransac._solve_f_8pt(p1[sel], p2[sel])
    specials = [torch.full((3, 3), float("nan"), device=p1.device),
                models[-1] * 1e-9, torch.zeros_like(models[0])]
    k = min(3, h)
    models[:k] = torch.stack(specials[:k])
    return models.contiguous()


def reference_counts(models, p1, p2, threshold):
    """(H,) int64 counts of pairs.sampson under the threshold, 1,024
    hypotheses at a time."""
    from benchmark.reference import pairs

    return torch.cat([(pairs.sampson(models[i:i + pairs.CHUNK], p1, p2)
                       < threshold).sum(1)
                      for i in range(0, len(models), pairs.CHUNK)])


def denominators(F, p1, p2):
    """The Sampson denominator a a + b b + at at + bt bt of one F."""
    x, y, u, v = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
    a = F[0, 0] * x + F[0, 1] * y + F[0, 2]
    b = F[1, 0] * x + F[1, 1] * y + F[1, 2]
    at = F[0, 0] * u + F[1, 0] * v + F[2, 0]
    bt = F[0, 1] * u + F[1, 1] * v + F[2, 1]
    return a * a + b * b + at * at + bt * bt


@pytest.mark.parametrize("h,n", [(1000, 8), (513, 257), (700, 1400),
                                 (10000, 51000)])
def test_counts_equal_reference(dev, h, n):
    from hesaff_tpu_torch.ops import cuda_ransac

    p1, p2 = two_view(n, h + n, dev)
    models = hypotheses(p1, p2, h, n)
    before = cuda_ransac.LAUNCHES
    counts = cuda_ransac.sampson_counts(models, p1, p2, THRESHOLD)
    assert cuda_ransac.LAUNCHES == before + 1
    assert counts.dtype == torch.int32 and counts.shape == (h,)
    ref = reference_counts(models, p1, p2, THRESHOLD)
    assert torch.equal(counts.long(), ref)
    assert int(counts[0]) == 0
    assert bool((denominators(models[1], p1, p2) < 1e-12).all())
    assert int(counts[2]) == n                  # 0 / 1e-12 < threshold
    assert int(counts[3:].max()) > 0.5 * n      # the scene's inliers


def test_counts_at_threshold_neighbours(dev):
    """Thresholds at a match's distance (the match is out) and one ulp
    either side of it: K8 counts what the reference counts."""
    from benchmark.reference import pairs
    from hesaff_tpu_torch.ops import cuda_ransac

    p1, p2 = two_view(1000, 5, dev)
    models = hypotheses(p1, p2, 37, 5)
    d = pairs.sampson(models, p1, p2)
    picks = [(h, j) for h in (1, 3, 10, 36) for j in (0, 400, 999)]
    for h, j in picks:
        q = d[h, j]
        assert bool(q.isfinite())
        for thr in (q, torch.nextafter(q, q.new_tensor(float("inf"))),
                    torch.nextafter(q, q.new_tensor(-float("inf")))):
            thr = float(thr)
            counts = cuda_ransac.sampson_counts(models, p1, p2, thr)
            assert torch.equal(counts.long(), (d < thr).sum(1)), (h, j, thr)
        at = cuda_ransac.sampson_counts(models, p1, p2, float(q))
        up = cuda_ransac.sampson_counts(
            models, p1, p2,
            float(torch.nextafter(q, q.new_tensor(float("inf")))))
        assert int(up[h]) >= int(at[h]) + 1


def test_ransac_fundamental_scores_with_k8(dev):
    """One launch a call; the best hypothesis is the one the reference's
    counts of the same draws pick, and the result is that hypothesis
    refit as the program refits (each round kept where it loses no
    inlier)."""
    from hesaff_tpu_torch import ransac
    from hesaff_tpu_torch.match import full_f32
    from hesaff_tpu_torch.ops import cuda_ransac

    p1, p2 = two_view(5000, 11, dev)
    for seed in (0, 2**31 + 7):
        before = cuda_ransac.LAUNCHES
        res = ransac.ransac_fundamental(p1, p2, threshold=THRESHOLD,
                                        num_hypotheses=2000, seed=seed,
                                        device=dev)
        assert cuda_ransac.LAUNCHES == before + 1
        g = torch.Generator(device=dev).manual_seed(seed)
        sel = ransac.draw_minimal_sets(len(p1), 2000, 8, g)
        with full_f32():
            models = ransac._solve_f_8pt(p1[sel], p2[sel])
            M = models[reference_counts(models, p1, p2, THRESHOLD).argmax()]
            inl = ransac._f_residuals(M, p1, p2) < THRESHOLD
            for _ in range(2):
                M_new = ransac._refit_f(p1, p2, inl.to(torch.float32))
                inl_new = ransac._f_residuals(M_new, p1, p2) < THRESHOLD
                if int(inl_new.sum()) >= int(inl.sum()):
                    M, inl = M_new, inl_new
        assert torch.equal(res.model, M)
        assert torch.equal(res.inliers, inl)
        assert int(res.num_inliers) == int(inl.sum()) > 3000


def test_scoring_stores_no_plane(dev):
    """At a 24 MP pair's shape (10,000 hypotheses, 51,000 matches) the
    call allocates the packed matches and the counts, no (H, N) value
    (one float32 plane would be 2 GB)."""
    from hesaff_tpu_torch.ops import cuda_ransac

    p1, p2 = two_view(51000, 3, dev)
    models = hypotheses(p1, p2, 10000, 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counts = cuda_ransac.sampson_counts(models, p1, p2, THRESHOLD)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < 8 << 20
    assert int(counts.max()) > 25000
