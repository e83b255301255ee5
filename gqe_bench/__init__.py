"""The benchmark of graphqembed_tpu_torch: see PERF.md and BENCHMARK.json."""
