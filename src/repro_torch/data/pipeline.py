"""Deterministic synthetic token pipeline.

The port of the JAX package's ``data/pipeline.py`` on one device (its
``mesh=None`` branch).  A batch is a function of ``(seed, step)``:
restart-safe, so resuming from a checkpoint at step ``s`` regenerates
exactly the batches the crashed run would have seen.  The draws are the
JAX package's numpy draws, seeded by ``SeedSequence([seed, step,
shard])`` with shard 0, so the tokens are bitwise its tokens; they go to
the device as int64, the index type of the model's embedding gather.

Two generators:
  * ``lm``    — Zipf-ish token stream with induced bigram structure, so
                that cross-entropy falls below ln(V) within a few hundred
                steps;
  * ``bytes`` — uniform tokens (throughput benchmarking).

For the frontend architectures the inputs are frame or patch embeddings
(``embeds``, f32, ``cfg.frontend_dim`` wide) in place of the tokens.
Sharded generation belongs to the mesh (ROADMAP A13.5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..dist.sharding import Runtime
from ..models.config import ModelConfig

__all__ = ["DataConfig", "SyntheticDataset", "make_global_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    kind: str = "lm"              # lm | bytes
    zipf_a: float = 1.2           # lm: token frequency skew


def _lm_tokens(rng: np.random.Generator, b: int, s: int, vocab: int,
               zipf_a: float) -> np.ndarray:
    """Zipf unigram draw + deterministic bigram transition (t -> (a*t+c)%V
    with prob 1/2) — enough structure that CE falls quickly below ln(V)."""
    base = rng.zipf(zipf_a, size=(b, s)).astype(np.int64)
    base = (base - 1) % vocab
    follow = (base[:, :-1] * 31 + 17) % vocab
    mask = rng.random((b, s - 1)) < 0.5
    out = base.copy()
    out[:, 1:] = np.where(mask, follow, base[:, 1:])
    return out.astype(np.int32)


class SyntheticDataset:
    """Deterministic ``(seed, step) -> batch`` on ``device`` (``cuda``
    unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, rt: Runtime,
                 device="cuda"):
        if data.kind not in ("lm", "bytes"):
            raise ValueError(f"kind must be 'lm' or 'bytes', got "
                             f"{data.kind!r}")
        self.cfg = cfg
        self.data = data
        self.rt = rt
        self.device = resolve_device(device)

    # -- host-side generation for one data shard ------------------------------
    def _shard_tokens(self, step: int, shard: int, rows: int) -> np.ndarray:
        d = self.data
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, shard]))
        if d.kind == "bytes":
            return rng.integers(0, self.cfg.vocab,
                                size=(rows, d.seq_len), dtype=np.int32)
        return _lm_tokens(rng, rows, d.seq_len, self.cfg.vocab, d.zipf_a)

    def _shard_embeds(self, step: int, shard: int, rows: int) -> np.ndarray:
        d = self.data
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, shard, 7]))
        return rng.standard_normal(
            (rows, d.seq_len, self.cfg.frontend_dim)).astype(np.float32)

    # -- global batch ----------------------------------------------------------
    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """``{"tokens", "labels"}`` (the same int64 tensor), or, for a
        frontend, ``{"embeds", "labels"}``, on the dataset's device."""
        d = self.data
        tok = torch.from_numpy(
            self._shard_tokens(step, 0, d.global_batch).astype(np.int64)
        ).to(self.device)
        out: Dict[str, torch.Tensor] = {"tokens": tok, "labels": tok}
        if self.cfg.frontend is not None:
            out["embeds"] = torch.from_numpy(
                self._shard_embeds(step, 0, d.global_batch)).to(self.device)
            out.pop("tokens")
        return out


def make_global_batch(cfg: ModelConfig, rt: Runtime, global_batch: int,
                      seq_len: int, step: int = 0, seed: int = 0,
                      kind: str = "lm", device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    ds = SyntheticDataset(cfg, DataConfig(global_batch, seq_len, seed, kind),
                          rt, device)
    return ds.batch(step)
