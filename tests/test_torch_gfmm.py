"""The GF(p) kernel's arithmetic on the CPU: the limb plan of
``repro_torch.kernels.gfmm.gf_plan`` and the limb identity the CUDA kernel
computes, modelled here in plain int64 ``torch.matmul``, against the
port's plain version and the JAX package's oracle.

The CUDA kernel splits every residue into bytes, r = lo + 256 hi, sums
S_ll = lo_A lo_B, S_x = lo_A hi_B + hi_A lo_B and S_hh = hi_A hi_B in s32,
reducing mod p every ``chunk`` K entries, and returns
(S_ll + 256 S_x + 65536 S_hh) mod p.  The kernel itself is held against
the plain version by tests/test_torch_gpu.py, which needs a card."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import gf_matmul, ref
from repro_torch.kernels.gfmm import GF_P_MAX, gf_plan

# Every class of p the wrapper admits: one limb (p <= 256, its edge
# included), two limbs with a small and a full high byte, the JAX
# package's two constants, and the largest p.
P_CLASSES = [2, 3, 127, 251, 256, 257, 1009, 4093, 40009, 46337, 65521,
             GF_P_MAX]
S32 = 2 ** 31


def _limbs(r: torch.Tensor, limbs: int):
    lo, hi = r & 255, r >> 8
    assert limbs == 2 or bool((hi == 0).all())
    return lo, hi


def _limb_product(a: torch.Tensor, b: torch.Tensor, p: int):
    """The CUDA kernel's arithmetic in int64 tensors: limbs, s32 sums
    reduced mod p after every chunk (each sum checked against 2^31 before
    the reduction), the combination mod p."""
    k = a.shape[1]
    limbs, chunk = gf_plan(p, k)
    lo_a, hi_a = _limbs(a.to(torch.int64) % p, limbs)
    lo_b, hi_b = _limbs(b.to(torch.int64) % p, limbs)
    shape = (a.shape[0], b.shape[1])
    s_ll, s_x, s_hh = (torch.zeros(shape, dtype=torch.int64)
                       for _ in range(3))
    for k0 in range(0, k, chunk):
        sl = slice(k0, k0 + chunk)
        s_ll = s_ll + lo_a[:, sl] @ lo_b[sl]
        s_x = s_x + lo_a[:, sl] @ hi_b[sl] + hi_a[:, sl] @ lo_b[sl]
        s_hh = s_hh + hi_a[:, sl] @ hi_b[sl]
        for s in (s_ll, s_x, s_hh):
            assert int(s.max()) < S32, "an s32 accumulator would overflow"
        s_ll, s_x, s_hh = s_ll % p, s_x % p, s_hh % p
    return ((s_ll + 256 * s_x + 65536 * s_hh) % p).to(torch.int32)


@pytest.mark.parametrize("p", P_CLASSES)
def test_gf_plan_limbs_rebuild_every_residue(p):
    limbs, _ = gf_plan(p, 1000)
    assert limbs == (1 if p <= 256 else 2)
    r = torch.arange(p, dtype=torch.int64)
    lo, hi = _limbs(r, limbs)
    assert int(lo.max()) <= 255 and int(hi.max()) <= 255
    assert torch.equal(lo + 256 * hi, r)


@pytest.mark.parametrize("p", P_CLASSES)
def test_gf_plan_chunk_keeps_every_s32_sum_below_2_31(p):
    """The residue carried in plus a chunk of the largest terms the limbs
    of p can give stays below 2^31 in each accumulator, and the chunk is
    a whole number of the kernel's 128-entry steps."""
    limbs, chunk = gf_plan(p, 10 ** 9)
    lo_max = min(p - 1, 255)
    hi_max = (p - 1) >> 8
    terms = [lo_max ** 2]
    if limbs == 2:
        terms += [2 * lo_max * hi_max, hi_max ** 2]
    assert chunk % 128 == 0 and chunk >= 128
    for t in terms:
        assert (p - 1) + chunk * t < S32
    # Two limbs: the cross sum's bound, about (2^31 - 1) / (2 * 255^2).
    assert chunk == (16512 if limbs == 2 else 33024)
    # A short K is one chunk: k rounded up to the step.
    assert gf_plan(p, 100) == (limbs, 128)
    assert gf_plan(p, 128) == (limbs, 128)


def test_gf_plan_refuses_p_outside_two_limbs():
    for p in (1, 0, GF_P_MAX + 1, 70001):
        with pytest.raises(ValueError, match="2 <= p"):
            gf_plan(p, 64)


def test_gf_matmul_refuses_p_above_2_16_on_the_cpu():
    """Only bk <= 0 gets past the mode limits with p > 2^16; the wrapper
    refuses it on any device, before choosing a route."""
    a = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="two 8-bit limbs"):
        gf_matmul(a, a, p=GF_P_MAX + 1, bk=0)
    with pytest.raises(ValueError, match="two 8-bit limbs"):
        gf_matmul(a, a, p=70001, bk=-1, mode="f32")
    out = gf_matmul(a + 3, a + 5, p=GF_P_MAX, bk=0)     # p = 2^16 is taken
    assert torch.equal(out, torch.full((4, 4), 60, dtype=torch.int32))


# (m, k, n, p): ragged shapes (not multiples of 16, 8 or 32), K across a
# chunk boundary (20 000 > 16 512 at p = 40009), one and two limbs.
LIMB_CASES = [(1, 1, 1, 2), (70, 130, 33, 127), (17, 300, 9, 251),
              (33, 257, 65, 256), (29, 100, 31, 257), (70, 1100, 33, 1009),
              (13, 515, 7, 4093), (5, 20000, 7, 40009), (3, 777, 11, 65521)]


@pytest.mark.parametrize("m,k,n,p", LIMB_CASES)
def test_limb_identity_equals_the_plain_version(m, k, n, p):
    rng = np.random.default_rng(m * k + n + p)
    a = torch.from_numpy(rng.integers(0, p, (m, k)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, p, (k, n)).astype(np.int32))
    out = _limb_product(a, b, p)
    assert torch.equal(out, ref.gf_matmul_ref(a, b, p))
    assert torch.equal(out, gf_matmul(a, b, p=p, bk=0))
    if k * (p - 1) ** 2 < S32:      # the JAX oracle sums in int32
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jref.gf_matmul_ref(
                jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), p)))


def test_limb_identity_is_exact_where_the_jax_oracle_wraps():
    """All entries p - 1: the JAX package's oracle wraps in int32; the
    limb identity and the plain version are exact."""
    p, k = 1009, 2200
    a = torch.full((8, k), p - 1, dtype=torch.int32)
    b = torch.full((k, 8), p - 1, dtype=torch.int32)
    exact = (k * (p - 1) ** 2) % p
    out = _limb_product(a, b, p)
    assert bool((out == exact).all())
    assert torch.equal(out, ref.gf_matmul_ref(a, b, p))
    oracle = np.asarray(jref.gf_matmul_ref(jnp.asarray(a.numpy()),
                                           jnp.asarray(b.numpy()), p))
    assert (oracle != exact).all()


def test_limb_identity_needs_its_chunks_at_the_largest_p():
    """All entries 2^16 - 1 (both bytes 255) over 40 000 K entries: one
    s32 cross sum would pass 2^31 by far; reduced every chunk, none does,
    and the result is exact."""
    p, k = GF_P_MAX, 40000
    _, chunk = gf_plan(p, k)
    assert k * 2 * 255 ** 2 >= S32 > (p - 1) + chunk * 2 * 255 ** 2
    a = torch.full((2, k), p - 1, dtype=torch.int32)
    b = torch.full((k, 3), p - 1, dtype=torch.int32)
    out = _limb_product(a, b, p)
    assert bool((out == (k * (p - 1) ** 2) % p).all())
    assert torch.equal(out, ref.gf_matmul_ref(a, b, p))
