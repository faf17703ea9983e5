"""The port's block-sparse semiring, GF(p) and attention kernels on the
CPU, against the JAX package on the same numpy inputs:

* ``sparse_semiring_matmul`` and ``tile_occupancy`` against the JAX
  package's Pallas kernel in interpret mode, bitwise;
* ``gf_matmul`` in both modes against the Pallas kernel in interpret
  mode and against the JAX package's oracle, exactly;
* ``flash_attention`` (its plain route) against the JAX package's oracle
  at rtol 1e-5 / atol 1e-6 in f32 (einsum sums in another order), and
  against the Pallas kernel in interpret mode at the JAX package's own
  kernel-versus-oracle tolerances, 2e-3 in f32 and 5e-2 in bf16;
* the ``ops`` wrappers against ``repro.kernels.ops``.

CPU tensors launch nothing.  The CUDA kernels are held against these
plain versions by tests/test_torch_gpu.py, which needs a card."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.gfmm import gf_matmul as j_gf_matmul
from repro.kernels.sparse import sparse_semiring_matmul as j_sparse
from repro.kernels.sparse import tile_occupancy as j_occupancy
from repro_torch.kernels import (LAUNCHES, flash_attention, gf_matmul, ops,
                                 reset_launches, sparse_semiring_matmul,
                                 tile_occupancy)
from repro_torch.kernels.sparse import _occupancy

SEMIRINGS = ["bool", "count", "minplus"]


def _sparse_operands(shape_a, shape_b, semiring, seed, density=0.25):
    """0/1 (bool, count) or small-integer (minplus) entries at the given
    density, the rest the semiring's identity; integer values keep the
    Pallas kernel's tile-by-tile f32 sums exact."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in (shape_a, shape_b):
        live = rng.random(shape) < density
        if semiring == "bool":
            out.append(live)
        elif semiring == "count":
            out.append(live.astype(np.float32))
        else:
            out.append(np.where(live, rng.integers(1, 9, shape),
                                np.inf).astype(np.float32))
    return out


# -----------------------------------------------------------------------------
# Block-sparse semiring product.
# -----------------------------------------------------------------------------
SPARSE_CASES = [((96, 96), (96, 96), 32),          # tests/test_sparse.py
                ((70, 90), (90, 50), 32),          # ragged edges
                ((2, 70, 90), (2, 90, 50), 32),    # batched
                ((2, 70, 90), (90, 50), 16)]       # broadcast


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("shape_a,shape_b,tile", SPARSE_CASES)
def test_sparse_matches_pallas_kernel(semiring, shape_a, shape_b, tile):
    a, b = _sparse_operands(shape_a, shape_b, semiring,
                            seed=len(shape_a) + tile)
    kern = np.asarray(j_sparse(jnp.asarray(a), jnp.asarray(b), semiring,
                               bm=tile, bn=tile, bk=tile, backend="pallas",
                               interpret=True))
    out = sparse_semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                 semiring, bm=tile, bn=tile, bk=tile)
    assert out.numpy().dtype == kern.dtype and out.shape == kern.shape
    np.testing.assert_array_equal(out.numpy(), kern)


@pytest.mark.parametrize("semiring", ["count", "minplus"])
def test_tile_occupancy_matches_jax(semiring):
    a, _ = _sparse_operands((96, 64), (1, 1), semiring, seed=9, density=0.01)
    for bm, bk in ((32, 32), (16, 64), (96, 8)):
        exp = np.asarray(j_occupancy(jnp.asarray(a), bm, bk, semiring))
        got = tile_occupancy(torch.from_numpy(a), bm, bk, semiring)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), exp)
    # The reference test's hand-made cases.
    x = np.zeros((64, 64), np.float32)
    x[40, 10] = 2.0
    np.testing.assert_array_equal(
        tile_occupancy(torch.from_numpy(x), 32, 32, "count").numpy(),
        [[0, 0], [1, 0]])
    x = np.full((64, 64), np.inf, np.float32)
    x[5, 50] = 1.0
    np.testing.assert_array_equal(
        tile_occupancy(torch.from_numpy(x), 32, 32, "minplus").numpy(),
        [[0, 1], [0, 0]])
    with pytest.raises(ValueError, match="multiple"):
        tile_occupancy(torch.from_numpy(x), 48, 32, "minplus")


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_ragged_occupancy_is_that_of_the_padded_operand(semiring):
    """The kernel's occupancy of an unpadded (batched) operand equals the
    JAX package's occupancy of the operand padded with the identity."""
    a, _ = _sparse_operands((3, 70, 45), (1, 1), semiring, seed=4,
                            density=0.02)
    pad = np.inf if semiring == "minplus" else 0
    for bm, bk in ((32, 16), (64, 64), (7, 9)):
        got = _occupancy(torch.from_numpy(a), bm, bk, semiring)
        for i, x in enumerate(a):
            xp = np.full((-(-70 // bm) * bm, -(-45 // bk) * bk), pad,
                         np.float32)
            xp[:70, :45] = x
            exp = np.asarray(j_occupancy(jnp.asarray(xp), bm, bk,
                                         "minplus" if semiring == "minplus"
                                         else "count"))
            np.testing.assert_array_equal(got[i].numpy(), exp)


# -----------------------------------------------------------------------------
# GF(p) product.
# -----------------------------------------------------------------------------
GF_CASES = [(128, 128, 128, 1009, "int32"), (256, 128, 128, 1009, "int32"),
            (128, 384, 256, 127, "int32"), (128, 128, 128, 251, "f32"),
            (128, 384, 256, 127, "f32"), (70, 130, 33, 1009, "int32")]


@pytest.mark.parametrize("m,k,n,p,mode", GF_CASES)
def test_gf_matmul_matches_pallas_kernel_and_oracle(m, k, n, p, mode):
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(0, p, (m, k)).astype(np.int32)
    b = rng.integers(0, p, (k, n)).astype(np.int32)
    out = gf_matmul(torch.from_numpy(a), torch.from_numpy(b), p=p, mode=mode)
    assert out.dtype == torch.int32
    kern = np.asarray(j_gf_matmul(jnp.asarray(a), jnp.asarray(b), p=p,
                                  mode=mode, interpret=True))
    np.testing.assert_array_equal(out.numpy(), kern)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jref.gf_matmul_ref(jnp.asarray(a),
                                                   jnp.asarray(b), p)))


def test_gf_matmul_limits_raise():
    a = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="bk \\* p\\^2"):
        gf_matmul(a, a, p=1009, mode="f32")
    with pytest.raises(ValueError, match="bk \\* p\\^2"):
        gf_matmul(a, a, p=4099, mode="int32")
    with pytest.raises(ValueError):
        gf_matmul(a, a, mode="f16")


def test_gf_matmul_is_exact_where_the_jax_oracle_wraps():
    """With x64 off the JAX package's oracle multiplies in int32, which
    wraps once k (p - 1)^2 >= 2^31; its Pallas kernel reduces per K tile
    and stays exact.  The port's plain version is exact (ROADMAP C)."""
    p, k = 1009, 2200
    a = np.full((8, k), p - 1, np.int32)
    b = np.full((k, 8), p - 1, np.int32)
    exact = (k * (p - 1) ** 2) % p
    out = gf_matmul(torch.from_numpy(a), torch.from_numpy(b), p=p)
    assert (out.numpy() == exact).all()
    kern = np.asarray(j_gf_matmul(jnp.asarray(a), jnp.asarray(b), p=p,
                                  interpret=True))
    np.testing.assert_array_equal(out.numpy(), kern)
    oracle = np.asarray(jref.gf_matmul_ref(jnp.asarray(a), jnp.asarray(b), p))
    assert (oracle != exact).all()


# -----------------------------------------------------------------------------
# Attention.
# -----------------------------------------------------------------------------
# (b, h, hkv, sq, sk, d, causal, window, softcap)
ATTN_CASES = [(1, 4, 2, 40, 40, 16, True, 0, 0.0),      # GQA, causal
              (2, 4, 1, 33, 33, 24, False, 0, 0.0),     # MQA, full
              (1, 2, 2, 48, 48, 16, True, 8, 0.0),      # sliding window
              (1, 2, 1, 40, 40, 16, True, 0, 5.0),      # softcap
              (1, 2, 2, 40, 29, 16, False, 0, 0.0),     # ragged Sk
              (1, 2, 1, 50, 20, 16, True, 4, 0.0),      # rows 23.. fully masked
              (1, 2, 2, 36, 36, 8, False, 6, 2.0)]      # window without causal


def _qkv(b, h, hkv, sq, sk, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,softcap", ATTN_CASES)
def test_attention_plain_matches_jax_oracle(b, h, hkv, sq, sk, d, causal,
                                            window, softcap):
    q, k, v = _qkv(b, h, hkv, sq, sk, d, seed=sq * d + h)
    kw = dict(causal=causal, window=window, softcap=softcap)
    exp = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)), **kw))
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert out.dtype == torch.float32 and out.shape == exp.shape
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-5, atol=1e-6)
    if causal and window and sq > sk + window - 1:
        assert (out.numpy()[:, :, sk + window - 1:] == 0).all()


@pytest.mark.parametrize("case", [ATTN_CASES[0], ATTN_CASES[2], ATTN_CASES[3],
                                  ATTN_CASES[5]])
def test_attention_plain_matches_pallas_kernel(case):
    b, h, hkv, sq, sk, d, causal, window, softcap = case
    q, k, v = _qkv(b, h, hkv, sq, sk, d, seed=7)
    kw = dict(causal=causal, window=window, softcap=softcap)
    kern = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), bq=16, bk=16,
                              interpret=True, **kw))
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), bq=16, bk=16,
                          **kw)
    np.testing.assert_allclose(out.numpy(), kern, rtol=2e-3, atol=2e-3)


def test_attention_bf16_matches_pallas_kernel():
    q, k, v = _qkv(1, 2, 1, 32, 32, 16, seed=9)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    kern = np.asarray(j_flash(jq, jk, jv, causal=True, softcap=10.0, bq=16,
                              bk=16, interpret=True), dtype=np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, softcap=10.0)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), kern, rtol=5e-2,
                               atol=5e-2)


# -----------------------------------------------------------------------------
# ops wrappers and dispatch.
# -----------------------------------------------------------------------------
def test_ops_path_counts_power_bitwise():
    rng = np.random.default_rng(3)
    adj = (rng.random((100, 100)) < 0.1).astype(np.float32)
    exp = np.asarray(j_ops.path_counts_power(jnp.asarray(adj), 3,
                                             interpret=True))
    out = ops.path_counts_power(torch.from_numpy(adj), 3)
    np.testing.assert_array_equal(out.numpy(), exp)
    eye = np.eye(128, k=1, dtype=np.float32)
    np.testing.assert_array_equal(
        ops.path_counts_power(torch.from_numpy(eye), 3).numpy(),
        np.linalg.matrix_power(eye, 3))


@pytest.mark.parametrize("p,mode", [(1009, "int32"), (251, "f32")])
def test_ops_gf_power_sum_exact(p, mode):
    rng = np.random.default_rng(p)
    kmat = np.where(rng.random((130, 130)) < 0.05,
                    rng.integers(1, p, (130, 130)), 0).astype(np.int32)
    exp = np.asarray(j_ops.gf_power_sum(jnp.asarray(kmat), 4, p=p, mode=mode,
                                        interpret=True))
    out = ops.gf_power_sum(torch.from_numpy(kmat), 4, p=p, mode=mode)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), exp)


def test_ops_attention_matches_jax():
    q, k, v = _qkv(1, 4, 2, 24, 24, 16, seed=11)
    exp = np.asarray(j_ops.attention(*map(jnp.asarray, (q, k, v)), window=6,
                                     bq=8, bk=8, interpret=True))
    out = ops.attention(*map(torch.from_numpy, (q, k, v)), window=6, bq=8,
                        bk=8)
    np.testing.assert_allclose(out.numpy(), exp, rtol=2e-3, atol=2e-3)


def test_cpu_tensors_launch_nothing_in_the_new_kernels():
    reset_launches()
    a, b = _sparse_operands((40, 40), (40, 40), "minplus", seed=0)
    sparse_semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           "minplus")
    g = torch.ones((8, 8), dtype=torch.int32)
    gf_matmul(g, g)
    ops.gf_power_sum(g, 3)
    ops.path_counts_power(torch.eye(8), 3)
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 1, 8, 8, 8, seed=0))
    ops.attention(q, k, v)
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES
    assert {"sparse", "gfmm", "flash_attention"} <= set(LAUNCHES)
    with pytest.raises(ValueError, match="unknown semiring"):
        sparse_semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               "tropical")
    with pytest.raises(ValueError, match="positive"):
        flash_attention(q, k, v, bq=0)


# -----------------------------------------------------------------------------
# The count kernel's split of K (the wrapper's rule; no kernel runs here).
# -----------------------------------------------------------------------------
SPLIT_SHAPES = [(1, 722, 722, 722), (9, 722, 722, 722), (8, 722, 722, 722),
                (1, 722, 722, 5000), (2, 65, 67, 1100), (1, 1, 1, 1),
                (1, 130, 200, 1), (3, 33, 129, 70), (1, 4114, 4114, 4114),
                (70000, 1, 1, 10 ** 6)]


@pytest.mark.parametrize("batch,m,n,k", SPLIT_SHAPES)
def test_count_split_is_a_pure_function_of_the_shapes(batch, m, n, k):
    """The same shapes always give the same (split, chunk); every share is
    non-empty, a whole number of 32-entry steps, at least 128 entries
    long unless K is shorter, and the grid's z extent stays within
    65535."""
    from repro_torch.kernels.semiring import count_split

    split, chunk = count_split(batch, m, n, k)
    assert (split, chunk) == count_split(batch, m, n, k)
    assert split >= 1 and chunk % 32 == 0
    assert (split - 1) * chunk < k <= split * chunk
    assert split == 1 or chunk >= 128
    assert batch * split <= 65535 or split == 1
    tiles = batch * -(-m // 64) * -(-n // 64)
    if tiles > 3 * 132 // 2:
        assert split == 1
    assert tiles * split <= 3 * 132 or split == 1   # one wave
    if (batch, m, n, k) == (1, 722, 722, 722):
        assert (split, chunk) == (2, 384)     # 288 blocks, 3 an SM
