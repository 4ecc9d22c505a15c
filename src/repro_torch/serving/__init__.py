"""Serving: prefill/decode steps and batched generation."""
