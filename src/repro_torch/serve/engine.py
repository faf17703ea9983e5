"""Batched serving: prefill and decode steps and a request-batching engine.

The port of the JAX package's ``serve/engine.py`` for the dense attention
family on one device.  The prefill and decode steps are plain functions
(the JAX package jits them).  The engine holds its weights on its device
cast once to the compute dtype (:func:`repro_torch.models.model.
cast_params`), where the JAX package casts them at every use: the same
bits, and a decode step reads the compute-dtype weights only.

Prefill and decode run under ``torch.no_grad()``: parameters that come
out of training still requiring grad build no autograd graph and keep no
activations here.

The ``ServingEngine`` is a minimal continuous-batching loop: a
fixed-size slot table, greedy sampling, per-request budgets, prompts
right-aligned with zeros on their left.  Encoder-only models, which have
no decode step, come with the frontends' slice (ROADMAP A13.11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..dist.sharding import Runtime
from ..models import model as model_mod
from ..models.common import dtype_of
from ..models.config import ModelConfig

__all__ = ["ServeConfig", "make_prefill_step", "make_decode_step",
           "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_len: int
    cache_dtype: str = "bfloat16"


def make_prefill_step(cfg: ModelConfig, rt: Runtime, sc: ServeConfig,
                      device="cuda"):
    """(params, {"tokens"}) -> (last-token logits, primed cache)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, batch: Dict[str, Any]):
        cache = model_mod.init_cache(cfg, rt, sc.batch, sc.max_len,
                                     dtype_of(sc.cache_dtype), device=dev)
        logits, cache, _ = model_mod.forward(params, cfg, rt, batch,
                                             cache=cache)
        return logits[:, -1], cache

    return prefill


def make_decode_step(cfg: ModelConfig, rt: Runtime, sc: ServeConfig):
    """(params, cache, last_token) -> (next_token, f32 logits, cache)."""
    assert cfg.decoder, f"{cfg.name} is encoder-only: no decode step"

    @torch.no_grad()
    def decode(params, cache, tokens):
        logits, cache, _ = model_mod.forward(params, cfg, rt,
                                             {"tokens": tokens}, cache=cache)
        lg = logits[:, -1].float()
        if cfg.final_softcap:
            lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        return nxt, lg, cache

    return decode


class ServingEngine:
    """Continuous batching over a fixed slot table (single replica) on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, params,
                 sc: ServeConfig, device="cuda"):
        model_mod.check_supported(cfg)
        self.cfg, self.rt, self.sc = cfg, rt, sc
        self.device = resolve_device(device)
        with torch.no_grad():
            self.params = model_mod.cast_params(params, cfg, self.device)
        self.prefill = make_prefill_step(cfg, rt, sc, self.device)
        self.decode = make_decode_step(cfg, rt, sc)
        self.reset()

    def reset(self) -> None:
        self.cache = None
        self.last = np.zeros(self.sc.batch, np.int32)
        self.done = np.ones(self.sc.batch, bool)
        self.outputs: List[List[int]] = [[] for _ in range(self.sc.batch)]
        self.budget = np.zeros(self.sc.batch, np.int32)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks.astype(np.int64)).to(self.device)

    def submit(self, prompts: List[np.ndarray], max_new: int = 16) -> None:
        """Prefill a full batch of prompts (right-aligned to equal length)."""
        b = self.sc.batch
        assert len(prompts) <= b
        width = max(len(p) for p in prompts)
        toks = np.zeros((b, width), np.int32)
        for i, p in enumerate(prompts):
            toks[i, -len(p):] = p
        logits, self.cache = self.prefill(self.params,
                                          {"tokens": self._tokens(toks)})
        self.last = torch.argmax(logits, dim=-1).cpu().numpy().astype(
            np.int32)
        self.done = np.arange(b) >= len(prompts)
        self.budget = np.full(b, max_new, np.int32)
        for i in range(len(prompts)):
            self.outputs[i] = [int(self.last[i])]

    def step(self) -> bool:
        """One decode step for every live slot; returns whether any live."""
        nxt, _, self.cache = self.decode(self.params, self.cache,
                                         self._tokens(self.last[:, None]))
        nxt = nxt.cpu().numpy()
        self.budget -= 1
        for i in range(self.sc.batch):
            if not self.done[i]:
                self.outputs[i].append(int(nxt[i]))
                if self.budget[i] <= 0:
                    self.done[i] = True
        self.last = nxt
        return bool((~self.done).any())

    def run(self, prompts: List[np.ndarray], max_new: int = 16
            ) -> List[List[int]]:
        self.submit(prompts, max_new)
        while self.step():
            pass
        return self.outputs[:len(prompts)]
