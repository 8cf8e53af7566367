"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``."""
