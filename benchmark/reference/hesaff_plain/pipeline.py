"""Single-image extraction API and the output records.

Same records as ``hesaff_tpu/pipeline.py``; the arrays are numpy on the
host whatever device ran the extraction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Features(NamedTuple):
    """Keypoints in the reference's octave / level / scan emission order."""

    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    a11: np.ndarray
    a12: np.ndarray
    a21: np.ndarray
    a22: np.ndarray
    response: np.ndarray
    type: np.ndarray
    desc: np.ndarray  # (N, 128) uint8

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


class ExtractStats(NamedTuple):
    """Detection funnel counters; capacity overflow is counted."""

    num_candidates: int
    num_keypoints: int
    num_affine: int
    num_described: int
    candidate_overflow: int
    bucket_overflow: int


def resolve_device(data, device=None):
    """Where an entry point runs: `device` if given, else the device of a
    tensor input, else the GPU.  Without a CUDA device the last case
    raises; a CPU run is asked for with device="cpu"."""
    import torch

    if device is not None:
        return torch.device(device)
    if isinstance(data, torch.Tensor):
        return data.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device=\"cpu\" "
                           "to run on the CPU")
    return torch.device("cuda")


def extract(image, cfg=None, device=None, return_stats: bool = False):
    """Hessian-Affine + SIFT extraction on one (H, W) grayscale image.

    device: where to run (default: the tensor's device, or the GPU for
    numpy input; pass "cpu" to run on the CPU).  Returns Features, or
    (Features, ExtractStats).
    """
    import torch

    from benchmark.reference.hesaff_plain.batch import extract_batch
    from benchmark.reference.hesaff_plain.config import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    image = torch.as_tensor(image, dtype=torch.float32,
                            device=resolve_device(image, device))
    out = extract_batch(image[None], cfg, return_stats=return_stats)
    if return_stats:
        feats, stats = out
        return feats[0], stats
    return out[0]
