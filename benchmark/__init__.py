"""The benchmark of mipnerf_pl_tpu_torch: see run.py and BENCHMARK.json."""
