"""LM serving on the port: prefill and greedy decode (``serve_step``) and
the continuous batcher (``batching``)."""
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.serve.serve_step import (greedy_generate, make_decode_step,
                                          make_prefill_step)

__all__ = ["ContinuousBatcher", "Request", "greedy_generate",
           "make_decode_step", "make_prefill_step"]
