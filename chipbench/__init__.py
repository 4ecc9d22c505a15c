"""The port's benchmark: one cell of ``BENCHMARK.json`` a run, driven by
data (``bench``); ``run.py`` is the command."""
