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
