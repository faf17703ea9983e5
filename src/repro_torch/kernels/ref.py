"""Plain PyTorch versions of the hand-written kernels.

They are the CPU path of every kernel wrapper and the yardstick the CUDA
kernels are held against on the card.  Their semantics follow the JAX
package's oracles line for line, so that on the CPU the port computes
the same float32 operations in the same order:

* scatter-adds run over the flattened ``(F, S)`` edge array in row-major
  order on a 1-D target (``index_add_``), which is the order XLA's CPU
  scatter sums in, and the order the water-filling kernel sums each
  link in on the card;
* ``a + b * c`` where XLA contracts it into one fused multiply-add on
  the CPU is emulated exactly (:func:`fused_add_mul`);
* reductions that decide results (min, max) are order-free.

The GF(p) product is exact integer arithmetic on both devices (float64
products of K slices short enough to stay below 2**53, then ``%``),
because PyTorch has no integer matrix product on CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["SAT", "pathcount_ref", "semiring_matmul_ref",
           "sparse_semiring_matmul_ref", "waterfill_ref", "fused_add_mul",
           "gf_matmul_ref", "attention_ref"]

SAT = 3.0e38


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def pathcount_ref(a: torch.Tensor, b: torch.Tensor,
                  sat: float = SAT) -> torch.Tensor:
    """min(A @ B, sat) in f32 (exact below 2**24)."""
    prod = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return torch.minimum(prod, _f32(sat, prod))


def _minplus_2d(a: torch.Tensor, b: torch.Tensor,
                chunk: int = 64) -> torch.Tensor:
    """(min, +) product, row-chunked so the (m, k, n) broadcast never
    materialises whole."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    return torch.cat([(a[i:i + chunk, :, None] + b[None]).amin(dim=1)
                      for i in range(0, a.shape[0], chunk)]
                     or [a.new_empty((0, b.shape[1]))])


def semiring_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                        semiring: str = "count",
                        sat: float = SAT) -> torch.Tensor:
    """Semantics of :func:`repro_torch.kernels.semiring.semiring_matmul`;
    operands may carry one leading batch dimension."""
    if a.ndim == 3 or b.ndim == 3:
        if a.ndim == 2:
            a = a[None].expand((b.shape[0],) + a.shape)
        if b.ndim == 2:
            b = b[None].expand((a.shape[0],) + b.shape)
    if semiring == "count":
        return pathcount_ref(a, b, sat)
    if semiring == "bool":
        return torch.matmul(a.to(torch.float32), b.to(torch.float32)) > 0
    if semiring == "minplus":
        if a.ndim == 3:
            if a.shape[0] == 0:
                return a.new_empty((0, a.shape[1], b.shape[2]),
                                   dtype=torch.float32)
            return torch.stack([_minplus_2d(x, y) for x, y in zip(a, b)])
        return _minplus_2d(a, b)
    raise ValueError(f"unknown semiring {semiring!r}")


def sparse_semiring_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                               semiring: str = "count",
                               sat: float = SAT) -> torch.Tensor:
    """Semantics of :func:`repro_torch.kernels.sparse
    .sparse_semiring_matmul`: an all-identity tile contributes exactly
    the additive identity, so the block-sparse product IS the dense one."""
    return semiring_matmul_ref(a, b, semiring, sat=sat)


def _scatter_add(e_tot: int, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """Per-link sums of ``val`` (F, S) over link ids ``idx`` (F, S),
    accumulated in flat row-major order from +0.0."""
    out = torch.zeros(e_tot, dtype=torch.float32, device=idx.device)
    return out.index_add_(0, idx.reshape(-1), val.reshape(-1))


def fused_add_mul(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """f32 ``a + b * c`` rounded once, as a fused multiply-add rounds it.

    The product of two f32 values is exact in float64, and TwoSum gives
    the float64 sum ``s`` with its exact error.  Rounding ``s`` to f32 is
    then the correct rounding of ``a + b * c`` unless ``s`` is an f32
    midpoint; there the exact sum lies on the error's side of it."""
    a64 = a.to(torch.float64)
    p = b.to(torch.float64) * c.to(torch.float64)
    s = a64 + p
    bb = s - a64
    err = (a64 - (s - bb)) + (p - bb)
    r = s.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    other = torch.nextafter(r, torch.where(s > r.to(torch.float64), inf, -inf))
    tie = ((r.to(torch.float64) + other.to(torch.float64)) * 0.5 == s) \
        & (err != 0)
    side = torch.where(err > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(tie, side, r)


def waterfill_ref(edges: torch.Tensor, w: torch.Tensor, desired: torch.Tensor,
                  cap: torch.Tensor, fair_iters: int = 2,
                  active: Optional[torch.Tensor] = None,
                  want_util: bool = False,
                  acc: Optional[torch.Tensor] = None):
    """One max-min water-filling step (semantics of
    :func:`repro_torch.kernels.waterfill.waterfill_step`).

    ``edges`` (F, S) int link ids, the last id ``cap.shape[0] - 1`` being
    the write-only trash link; ``w`` (F,) 0/1 weights; ``desired`` (F,)
    requested rates; ``cap`` (E,) capacities; ``active`` (F,) bool
    optional — inactive rows and -1 slots go to the trash link and their
    weight and desire are zeroed.  Returns ``(sent, share)``, plus
    ``util`` with ``want_util`` (the max over live slots of load / cap,
    from round ``min(1, fair_iters)``), plus ``acc + sent`` with ``acc``
    (F,) f32 given, rounded once: ``acc + d * s`` over the last round's
    demand ``d`` and scale ``s`` as one fused multiply-add, as XLA
    contracts the reference scan's ``sent_acc + sent``.
    """
    e_tot = cap.shape[0]
    w = w.to(torch.float32)
    if active is not None:
        actf = active.to(torch.float32)
        edges = torch.where(active[:, None] & (edges >= 0), edges,
                            e_tot - 1)
        w = w * actf
        desired = desired * actf
    live = edges < e_tot - 1
    # Negative ids (only possible without ``active``) wrap like jnp indexing.
    idx = torch.where(edges < 0, edges + e_tot, edges).to(torch.int64)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=cap.device)
    tiny = _f32(1e-9, cap)
    count = _scatter_add(e_tot, idx, w[:, None].expand(idx.shape))
    fair = cap / torch.maximum(count, tiny)
    share = torch.where(live, fair[idx], inf).amin(dim=1)
    util = None
    if want_util and fair_iters == 0:
        link_util = count / torch.maximum(cap, tiny)
        util = torch.where(live, link_util[idx], 0.0).amax(dim=1)
    d = torch.minimum(desired, share)
    acc_out = None if acc is None else acc + d
    for it in range(fair_iters):
        load = _scatter_add(e_tot, idx, d[:, None].expand(idx.shape))
        if want_util and it == 0:
            link_util = load / torch.maximum(cap, tiny)
            util = torch.where(live, link_util[idx], 0.0).amax(dim=1)
        scale = torch.clamp_max(cap / torch.maximum(load, tiny), 1.0)
        s = torch.where(live, scale[idx], inf).amin(dim=1)
        s = torch.where(torch.isfinite(s), s, 0.0)
        if acc is not None and it == fair_iters - 1:
            acc_out = fused_add_mul(acc, d, s)
        d = d * s
    out = (d, share)
    if want_util:
        out += (util,)
    if acc is not None:
        out += (acc_out,)
    return out


def gf_matmul_ref(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(A @ B) mod p as exact integers, returned as int32.

    Operands are reduced mod p first.  The product runs in float64 over
    K slices of at most ``(2**53 - 1) // (p - 1)**2`` terms, so every
    partial sum is an exact integer; each slice is reduced mod p and the
    slices are summed mod p.  That works on the CPU and on CUDA alike
    (PyTorch has no int64 matrix product on CUDA)."""
    a = a.to(torch.int64) % p
    b = b.to(torch.int64) % p
    k = a.shape[-1]
    step = max(1, (2 ** 53 - 1) // max(1, (p - 1) ** 2))
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.int64,
                      device=a.device)
    for k0 in range(0, k, step):
        part = torch.matmul(a[..., k0:k0 + step].to(torch.float64),
                            b[..., k0:k0 + step, :].to(torch.float64))
        out = (out + part.to(torch.int64) % p) % p
    return out.to(torch.int32)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive (materialised-logits) attention with GQA, causal and sliding
    window masks and gemma2 logit soft-capping, over (B, H, S, D).

    Query and key positions both start at 0.  A row whose keys are all
    masked gives 0.  Computes in f32 and returns q's dtype."""
    _, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = float(d) ** -0.5
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     kk.to(torch.float32)) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(torch.isnan(p), 0.0, p)  # fully masked rows
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0, 1.0, denom)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.to(torch.float32))
    return out.to(q.dtype)
