"""Assigned input shapes and (arch × shape) applicability.

Shapes (task spec):
  train_4k      seq 4096,    global_batch 256   -> train_step
  prefill_32k   seq 32768,   global_batch 32    -> serve prefill
  decode_32k    seq 32768,   global_batch 128   -> serve decode (1 token,
                                                   KV/state cache of seq)
  long_500k     seq 524288,  global_batch 1     -> long-context decode

Skips (recorded in DESIGN.md §Arch-applicability):
  * decode shapes for encoder-only archs (hubert);
  * long_500k for pure/periodic full-attention archs — runnable only for
    the recurrent-state families (zamba2 hybrid, rwkv6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["Shape", "SHAPES", "applicable", "cell_matrix"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# archs whose sequence mixing is sub-quadratic end to end
_SUBQUADRATIC = {"zamba2-1.2b", "rwkv6-7b"}
_ENCODER_ONLY = {"hubert-xlarge"}


def applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable?, reason-if-skipped)."""
    sh = SHAPES[shape]
    if arch in _ENCODER_ONLY and sh.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return False, "full attention is quadratic at 512k; per task spec " \
                      "long_500k runs only for SSM/hybrid/linear archs"
    return True, ""


def cell_matrix(arch_names) -> Dict[Tuple[str, str], Tuple[bool, str]]:
    return {(a, s): applicable(a, s) for a in arch_names for s in SHAPES}
