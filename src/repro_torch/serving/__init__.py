"""Serving: prefill/decode steps and batched generation (``engine``), and
the risk-scoring pipeline over the feature engine (``pipeline``)."""
