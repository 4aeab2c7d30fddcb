"""The benchmark of hesaff_tpu_torch on one H100 (see run.py)."""
