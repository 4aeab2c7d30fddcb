"""Fleet extraction and profiling helpers."""
