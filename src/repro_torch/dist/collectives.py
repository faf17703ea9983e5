"""FatPaths-layered collective schedules: the ring strides.

The paper spreads one logical flow over several near-disjoint routing
layers; the collective analogue runs one ring all-reduce per *stride
ring*: ring ``r`` visits the ranks in order ``0, s_r, 2 s_r, ...``
(mod n), which on a fabric with FatPaths layers maps each ring onto a
different set of links (quantified by :mod:`repro_torch.dist.fabric`).

Only :func:`layer_strides` is here so far, the integer part the fabric
model needs.  The ring collectives themselves (reduce-scatter,
all-gather and the multi-ring all-reduce over ``torch.distributed``)
come with the LM substrate's multi-device slice (ROADMAP A13.5).
"""

from __future__ import annotations

import math
from typing import Tuple

__all__ = ["layer_strides"]


def layer_strides(n: int, k: int) -> Tuple[int, ...]:
    """The first ``k`` positive ring strides coprime with ``n``.

    ``layer_strides(16, 3) == (1, 3, 5)``.  Every returned stride
    generates a Hamiltonian ring on n ranks (gcd(s, n) == 1) — the
    software twin of the paper's routing layers.  The first ``phi(n)``
    rings traverse distinct neighbour patterns; only when ``k`` exceeds
    the number of coprime residues (pigeonhole) do rings repeat a pattern
    mod n, and the payload still splits k ways.
    """
    if n <= 1:
        return (1,) * k
    out = []
    s = 1
    while len(out) < k:
        if math.gcd(s, n) == 1:
            out.append(s)
        s += 1
    return tuple(out)
