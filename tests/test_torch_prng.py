"""The port's threefry2x32 (repro_torch.prng) against jax.random: keys,
raw bits and uniforms must be bitwise equal, for many seeds and for the
exact shapes the main path draws."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro_torch import prng

SEEDS = [0, 1, 2, 7, 42, 1000, 12345, 2 ** 31 - 1, -3]


def _key_np(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(_key_np(k), kt.numpy())
    for num in (1, 2, 3, 17):
        np.testing.assert_array_equal(_key_np(jax.random.split(k, num)),
                                      prng.split(kt, num).numpy())
    for data in (0, 1, 5, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _key_np(jax.random.fold_in(k, np.uint32(data))),
            prng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(2,), (64, 2), (9, 50, 50), (7,), (1,)])
def test_uniform_bitwise(seed, shape):
    k = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed, "cpu")
    u = np.asarray(jax.random.uniform(k, shape))
    ut = prng.uniform(kt, shape).numpy()
    assert ut.dtype == np.float32 and ut.shape == shape
    np.testing.assert_array_equal(u, ut)
    bits = np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32))
    np.testing.assert_array_equal(bits.astype(np.int64),
                                  prng.random_bits(kt, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_batched_fold_in_and_uniform(seed):
    """The scan's per-flow and per-chunk draws: vmap(fold_in) over flows,
    then vmap(uniform) of (2,) and (chunk, 2) blocks."""
    f = 37
    k_init, k_scan = jax.random.split(jax.random.PRNGKey(seed))
    kt_init, kt_scan = prng.split(prng.PRNGKey(seed, "cpu"))
    keys = jax.vmap(lambda i: jax.random.fold_in(k_scan, i))(jnp.arange(f))
    keys_t = prng.fold_in(kt_scan, torch.arange(f))
    np.testing.assert_array_equal(_key_np(keys), keys_t.numpy())
    u2 = jax.vmap(lambda kk: jax.random.uniform(kk, (2,)))(keys)
    np.testing.assert_array_equal(np.asarray(u2),
                                  prng.uniform(keys_t, (2,)).numpy())
    for c in (0, 3):
        ck = jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, c)
        ck_t = prng.fold_in(keys_t, c)
        np.testing.assert_array_equal(_key_np(ck), ck_t.numpy())
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (64, 2)))(ck)
        np.testing.assert_array_equal(np.asarray(u),
                                      prng.uniform(ck_t, (64, 2)).numpy())
    ui = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k_init, i), (2,)))(jnp.arange(f))
    ui_t = prng.uniform(prng.fold_in(kt_init, torch.arange(f)), (2,))
    np.testing.assert_array_equal(np.asarray(ui), ui_t.numpy())


def test_uniform_range_and_partitionable_layout():
    """Values lie in [0, 1), and a draw depends on the whole shape (the
    partitionable counter layout): (4,) is not the prefix of (8,)."""
    kt = prng.PRNGKey(3, "cpu")
    u = prng.uniform(kt, (4096,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    a = prng.uniform(kt, (4,)).numpy()
    b = prng.uniform(kt, (2, 2)).numpy().reshape(-1)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (4,))))


def test_prngkey_defaults_to_the_card():
    """Like every entry point of the port, PRNGKey runs on ``cuda`` unless
    asked for the CPU, and raises without a card instead of falling back."""
    if torch.cuda.is_available():
        assert prng.PRNGKey(5).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prng.PRNGKey(5)
    assert prng.PRNGKey(5, "cpu").device.type == "cpu"
