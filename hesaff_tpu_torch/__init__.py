"""hesaff_tpu_torch — Hessian-Affine + SIFT extraction in PyTorch and CUDA.

The port of ``hesaff_tpu`` (JAX) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).  The JAX package stays the
reference; this package imports nothing from it, and no JAX.

Public API
----------
    HesaffConfig   — frozen parameter set (the JAX package's fields)
    extract        — single-image extraction -> Features
    extract_batch  — same-size image batch -> list of Features
    Features, ExtractStats — output records
    dist.extraction_step_grouped — the grouped serving path ->
                     DenseFeatures of tensors

Entry points run on the GPU unless given a CPU tensor or
device="cpu", for images of any size (octaves of 2^23 px or more take
the sparse detection path).  A CPU tensor runs every stage as plain
PyTorch; a CUDA tensor runs the six kernels of ``ops/cuda_*.py``, which
are built from ``csrc/`` at first use.
"""

from hesaff_tpu_torch.batch import extract_batch
from hesaff_tpu_torch.config import DEFAULT_CONFIG, HesaffConfig
from hesaff_tpu_torch.pipeline import ExtractStats, Features, extract

__all__ = [
    "DEFAULT_CONFIG",
    "ExtractStats",
    "Features",
    "HesaffConfig",
    "extract",
    "extract_batch",
]
