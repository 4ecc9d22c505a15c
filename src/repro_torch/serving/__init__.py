"""Serving: prefill/decode steps and batched generation (``engine``), the
risk-scoring pipeline over the feature engine (``pipeline``) and its
open-loop frontend — admission queue, dynamic batching, prefetched
hydration (``frontend``)."""
from repro_torch.serving import frontend, pipeline
from repro_torch.serving.frontend import (ServingFrontend, VirtualClock,
                                          make_requests, poisson_arrivals)

__all__ = ["frontend", "pipeline", "ServingFrontend", "VirtualClock",
           "make_requests", "poisson_arrivals"]
