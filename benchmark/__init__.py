"""The benchmark of umgen_tpu_torch on one NVIDIA H100 (see PERF.md)."""
