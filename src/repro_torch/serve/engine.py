"""Batched serving: prefill and decode steps and a request-batching engine.

The port of the JAX package's ``serve/engine.py`` on one device, for
every decoder the port runs: the dense GQA family, the mixture-of-experts
family (deepseek-v2's latent cache) and the recurrent families (zamba2's
SSM state, conv window and shared block's windowed KV cache; rwkv6's
state and boundary tokens).  The prefill and decode steps are plain
functions (the JAX package jits them).  The engine holds its weights on its device
cast once to the compute dtype (:func:`repro_torch.models.model.
cast_params`), where the JAX package casts them at every use: the same
bits, and a decode step reads the compute-dtype weights only.

Prefill and decode run under ``torch.no_grad()``: parameters that come
out of training still requiring grad build no autograd graph and keep no
activations here.

The ``ServingEngine`` is a minimal continuous-batching loop: a
fixed-size slot table, greedy sampling, per-request budgets, prompts
right-aligned with zeros on their left.  It serves token prompts only,
as the JAX package's engine feeds them: a frontend model (qwen2-vl-7b's
patch and text embeddings, hubert-xlarge's frames) is rejected at
construction, where the JAX package's ``run`` fails on the missing
``embeds``.  Such a model is driven through the steps themselves:
:func:`make_prefill_step` takes ``{"embeds"}``, and
:func:`make_decode_step` feeds a frontend decoder (qwen2-vl) its
per-step input under ``"embeds"``.  An encoder-only model (hubert) has
a prefill step and no decode step.
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
           "check_token_model", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_len: int
    cache_dtype: str = "bfloat16"


def make_prefill_step(cfg: ModelConfig, rt: Runtime, sc: ServeConfig,
                      device="cuda"):
    """(params, {"tokens"} or {"embeds"}) -> (last-token logits, primed
    cache)."""
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
    """(params, cache, last_token) -> (next_token, f32 logits, cache); a
    frontend model takes its step's (B, 1, ``frontend_dim``) embeddings
    in place of the last token."""
    assert cfg.decoder, f"{cfg.name} is encoder-only: no decode step"
    key = "embeds" if cfg.frontend is not None else "tokens"

    @torch.no_grad()
    def decode(params, cache, tokens):
        logits, cache, _ = model_mod.forward(params, cfg, rt, {key: tokens},
                                             cache=cache)
        lg = logits[:, -1].float()
        if cfg.final_softcap:
            lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        return nxt, lg, cache

    return decode


def check_token_model(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a model that takes embeddings, not
    tokens: the engine has no prompts to give it."""
    if cfg.frontend is not None:
        raise ValueError(
            f"{cfg.name} takes {cfg.frontend} embeddings, not token "
            "prompts: the engine cannot serve it.  Drive "
            "make_prefill_step (and, for a decoder, make_decode_step) "
            'with {"embeds"} instead')


class ServingEngine:
    """Continuous batching over a fixed slot table (single replica) on
    ``device`` (``cuda`` unless the caller asks for the CPU), for models
    that take tokens (:func:`check_token_model`)."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, params,
                 sc: ServeConfig, device="cuda"):
        check_token_model(cfg)
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
