"""A frozen plain-PyTorch copy of the port's grouped extraction path.

Copied from ``hesaff_tpu_torch`` (its CPU path: every kernel's plain
version) and cut to what ``dist.extraction_step_grouped`` reaches; the
kernel launches are left out, so it runs as plain PyTorch on the CPU
and on a card alike.  It imports nothing of the port, so later changes
to the port cannot change what the benchmark judges it against.
"""
