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
    write_sift_file, read_sift_file — Oxford ".hesaff.sift" export
                     (native writer, byte-equal Python fallback)
    load_image_gray — PNM / PNG / JPEG to float32 (R+G+B)/3
    match_descriptors — exact 2-NN Lowe-ratio (+ mutual) matching
    ransac_homography, ransac_fundamental — batched-hypothesis RANSAC
    evaluate.repeatability, retrieval.rank_images — Oxford protocol,
                     kNN-vote retrieval
    cli — ``python -m hesaff_tpu_torch.cli extract|match|eval|retrieve``

Entry points run on the GPU unless given a CPU tensor or
device="cpu", for images of any size (octaves of 2^23 px or more take
the sparse detection path).  A CPU tensor runs every stage as plain
PyTorch; a CUDA tensor runs the six kernels of ``ops/cuda_*.py``, which
are built from ``csrc/`` at first use.  Matching and RANSAC run on the
same rule (numpy input on the GPU); their products are PyTorch's, no
kernel of this package.
"""

from hesaff_tpu_torch.batch import extract_batch
from hesaff_tpu_torch.config import DEFAULT_CONFIG, HesaffConfig
from hesaff_tpu_torch.match import match_descriptors
from hesaff_tpu_torch.pipeline import ExtractStats, Features, extract
from hesaff_tpu_torch.ransac import ransac_fundamental, ransac_homography
from hesaff_tpu_torch.sift_io import (load_image_gray, read_sift_file,
                                      write_sift_file)

__all__ = [
    "DEFAULT_CONFIG",
    "ExtractStats",
    "Features",
    "HesaffConfig",
    "extract",
    "extract_batch",
    "load_image_gray",
    "match_descriptors",
    "ransac_fundamental",
    "ransac_homography",
    "read_sift_file",
    "write_sift_file",
]
