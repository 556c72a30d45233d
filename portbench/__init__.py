"""The port's benchmark: one cell of BENCHMARK.json a run, on one H100 (see run.py)."""
