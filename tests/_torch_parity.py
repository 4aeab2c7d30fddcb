"""Shared helpers of the PyTorch port's parity tests.

Each parity test makes its inputs with numpy from a seed, runs the JAX
function (on the CPU, its XLA twin) and the port's counterpart on the
same arrays, and compares them at the tolerance the test states.
"""

import dataclasses

import numpy as np
import torch

# several pytest workers share the host's cores
torch.set_num_threads(2)


def port_cfg(cfg):
    """The JAX package's HesaffConfig as the port's (same fields)."""
    from hesaff_tpu_torch.config import HesaffConfig

    return HesaffConfig(**dataclasses.asdict(cfg))


def t(a, dtype=None):
    """numpy / JAX array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def smooth_stacks(rng, *shape):
    """Smooth random float32 images (the JAX tests' _smooth_stacks)."""
    img = rng.normal(128, 40, shape).astype(np.float32)
    for _ in range(8):
        for ax in (-1, -2):
            img = (np.roll(img, 1, ax) + img + np.roll(img, -1, ax)) / 3.0
    return img


def assert_affine_parity(ref, out, act, budget: float = 0.02,
                         min_matched: int = 10, u_atol: float = 5e-5):
    """Affine agreement under the JAX tests' documented budget: <= 2% of
    active keypoints may flip ok or their convergence iteration (a
    threshold-adjacent keypoint moves by a whole Baumberg step); U
    within rtol 1e-4 / atol 5e-5 where both accept at the same
    iteration."""
    act = n(act).astype(bool)
    ro = n(ref.ok).astype(bool) & act
    po = n(out.ok).astype(bool) & act
    n_act = max(1, int(act.sum()))
    allow = max(1, int(np.ceil(budget * n_act)))
    assert int((ro != po).sum()) <= allow, "ok flips over budget"
    m = ro & po
    assert m.sum() >= min_matched
    it_r = n(ref.iters)[m]
    it_o = n(out.iters)[m]
    assert int((it_r != it_o).sum()) <= allow, "iteration flips over budget"
    mm = np.zeros_like(m)
    mm[m] = it_r == it_o
    for f in ("u11", "u12", "u21", "u22"):
        np.testing.assert_allclose(n(getattr(ref, f))[mm],
                                   n(getattr(out, f))[mm],
                                   rtol=1e-4, atol=u_atol)


def match_slots(ref, out):
    """One-to-one map of ref's valid slots to out's (DenseFeatures): same
    image, x and y within 0.01 px, s within 1e-3 relative."""
    rv, ov = n(ref.valid).astype(bool), n(out.valid).astype(bool)
    ri, oi = np.nonzero(rv)[0], np.nonzero(ov)[0]
    f = lambda d, k: n(getattr(d, k)).astype(np.float64)
    pairs = {}
    for i in ri:
        near = oi[(n(out.img_idx)[oi] == n(ref.img_idx)[i])
                  & (np.abs(f(out, "x")[oi] - f(ref, "x")[i]) <= 0.01)
                  & (np.abs(f(out, "y")[oi] - f(ref, "y")[i]) <= 0.01)
                  & (np.abs(f(out, "s")[oi] - f(ref, "s")[i])
                     <= 1e-3 * f(ref, "s")[i])]
        assert len(near) == 1, (i, near)
        pairs[i] = int(near[0])
    assert sorted(pairs.values()) == list(oi)
    return pairs


def assert_same_features(ref, out, overflow: int = 0):
    """The same keypoints (match_slots), descriptors within one step,
    the same overflow in both (0 unless given), and zero descriptor
    rows where the port's slot is not valid."""
    rv, ov = n(ref.valid).astype(bool), n(out.valid).astype(bool)
    assert rv.sum() == ov.sum() > 20
    assert int(n(ref.overflow)) == int(n(out.overflow)) == overflow
    rd, od = n(ref.desc).astype(int), n(out.desc).astype(int)
    pairs = match_slots(ref, out)
    for i, j in pairs.items():
        assert np.abs(rd[i] - od[j]).max() <= 1
    assert out.desc.dtype == torch.uint8
    assert not od[~ov].any()
    return pairs
