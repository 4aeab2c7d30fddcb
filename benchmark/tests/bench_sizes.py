"""Small sizes at which the benchmark's cells run on the CPU in tests."""

BATCH = "oxford_affine_800x640.batch16"
QUERY = "oxford5k_1024x768.query"

SMALL = {
    BATCH: {"image": {"width": 128, "height": 96},
            "traffic": {"batch": 2, "pool": 4, "warmup_calls": 1,
                        "sample_calls": 2, "traced_calls": 2}},
    QUERY: {"image": {"width": 128, "height": 96},
            "index": {"images": 20, "sources": 2, "filler_rows": 3000},
            "traffic": {"angles": 2, "warmup_calls": 1, "sample_calls": 2,
                        "traced_calls": 2}},
}
