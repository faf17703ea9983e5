"""Serving: the prefill and decode steps and the batching engine."""

from .engine import (ServeConfig, ServingEngine, make_decode_step,  # noqa: F401
                     make_prefill_step)
