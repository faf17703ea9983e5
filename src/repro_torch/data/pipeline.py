"""Deterministic, sharded synthetic token pipeline.

The port of the JAX package's ``data/pipeline.py``.  A batch is a
function of ``(seed, step)``: restart-safe, so resuming from a
checkpoint at step ``s`` regenerates exactly the batches the crashed run
would have seen.  The draws are the
JAX package's numpy draws, seeded by ``SeedSequence([seed, step,
shard])``, so the tokens are bitwise its tokens; they go to the device
as int64, the index type of the model's embedding gather.  Without a
mesh the batch is shard 0 of ``global_batch`` rows.  Under a mesh each
rank generates only its own rows: shard = its index over the data axes,
``global_batch / fsdp_size`` rows (the JAX package's per-shard
callback), and ``batch`` returns those rows.

Two generators:
  * ``lm``    — Zipf-ish token stream with induced bigram structure, so
                that cross-entropy falls below ln(V) within a few hundred
                steps;
  * ``bytes`` — uniform tokens (throughput benchmarking).

For the frontend architectures the inputs are frame or patch embeddings
(``embeds``, f32, ``cfg.frontend_dim`` wide) in place of the tokens.
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
        if data.global_batch % max(rt.fsdp_size, 1):
            raise ValueError(f"global batch {data.global_batch} does not "
                             f"divide over {rt.fsdp_size} data shards")
        self.cfg = cfg
        self.data = data
        self.rt = rt
        self.device = resolve_device(device)
        self.rows = data.global_batch // max(rt.fsdp_size, 1)
        self.shard = 0
        if rt.mesh is not None:
            import torch.distributed as dist
            self.shard = rt.mesh.axis_index(rt.fsdp_axes, dist.get_rank())

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
        frontend, ``{"embeds", "labels"}``, on the dataset's device: this
        rank's rows under a mesh."""
        tok = torch.from_numpy(
            self._shard_tokens(step, self.shard, self.rows).astype(np.int64)
        ).to(self.device)
        out: Dict[str, torch.Tensor] = {"tokens": tok, "labels": tok}
        if self.cfg.frontend is not None:
            out["embeds"] = torch.from_numpy(
                self._shard_embeds(step, self.shard, self.rows)
            ).to(self.device)
            out.pop("tokens")
        return out


def make_global_batch(cfg: ModelConfig, rt: Runtime, global_batch: int,
                      seq_len: int, step: int = 0, seed: int = 0,
                      kind: str = "lm", device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    ds = SyntheticDataset(cfg, DataConfig(global_batch, seq_len, seed, kind),
                          rt, device)
    return ds.batch(step)
