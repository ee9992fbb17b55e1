"""The benchmark of metapde_tpu_torch's meta-training (see BENCHMARK.json
at the repository's root and PERF.md)."""
