"""The benchmark of jxl_tpu_torch (BENCHMARK.json at the repository's root):
run.py and the files it finds by name."""
