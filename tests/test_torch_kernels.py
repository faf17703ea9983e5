"""The port's kernels on the CPU: plain versions against the JAX package's
oracles (bitwise) and against its Pallas kernels run in interpret mode
(``share``/``bool``/``minplus``/``count`` bitwise; ``sent``/``util``
within rtol 1e-5, atol 1e-7, the JAX package's own tolerance between
those two, because the Pallas kernel sums link loads tile by tile in
another order).  Device dispatch: CPU tensors take the plain version and
launch nothing.  The CUDA kernels themselves are held against the plain
versions by tests/test_torch_gpu.py, which needs a card."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.semiring import semiring_matmul as j_semiring
from repro.kernels.waterfill import waterfill_step as j_waterfill
from repro_torch.kernels import (LAUNCHES, pathcount_matmul, ref,
                                 reset_launches, semiring_matmul,
                                 waterfill_step)

# Ragged (F, S, E): tile multiples and odd remainders, as in the JAX
# package's tests/test_waterfill.py and tests/test_recovery.py.
WF_SHAPES = [(7, 3, 19), (128, 7, 512), (200, 7, 751), (1, 5, 33),
             (130, 9, 513), (256, 4, 1024)]
MM_SHAPES = [(1, 1, 1), (100, 130, 70), (1, 257, 129), (130, 1, 200)]


def _wf_instance(f, s, e, seed, idle_frac=0.25, holes=False):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, e - 1, (f, s)).astype(np.int32)
    edges[rng.random((f, s)) < 0.3] = e - 1          # trash-padded slots
    w = (rng.random(f) >= idle_frac).astype(np.float32)
    edges[w == 0] = e - 1                            # inert flows: all trash
    desired = rng.random(f).astype(np.float32) * w
    cap = np.ones(e, np.float32)
    active = rng.random(f) < 0.6
    if holes:
        edges[rng.random((f, s)) < 0.2] = -1         # raw walk padding
    return edges, w, desired, cap, active


def _mm_operands(m, k, n, semiring, seed, batch=None):
    rng = np.random.default_rng(seed)
    shape_a = (m, k) if batch is None else (batch, m, k)
    shape_b = (k, n) if batch is None else (batch, k, n)
    a = rng.random(shape_a, dtype=np.float32)
    b = rng.random(shape_b, dtype=np.float32)
    if semiring == "bool":
        return a > 0.6, b > 0.6
    if semiring == "count":                  # integer-valued: exact sums
        return np.floor(a * 5), np.floor(b * 5)
    a[rng.random(shape_a) < 0.3] = np.inf
    b[rng.random(shape_b) < 0.3] = np.inf
    return a, b


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.asarray(x))
            for x in xs]


@pytest.mark.parametrize("f,s,e", WF_SHAPES)
@pytest.mark.parametrize("fair_iters", [0, 1, 2])
@pytest.mark.parametrize("lane", ["none", "active"])
def test_waterfill_ref_matches_jax_oracle_bitwise(f, s, e, fair_iters, lane):
    holes = lane == "active"
    edges, w, desired, cap, active = _wf_instance(f, s, e, f * s + e,
                                                  holes=holes)
    act = active if holes else None
    out_j = jref.waterfill_ref(jnp.asarray(edges), jnp.asarray(w),
                               jnp.asarray(desired), jnp.asarray(cap),
                               fair_iters=fair_iters,
                               active=None if act is None else jnp.asarray(act),
                               want_util=True)
    te, tw, td, tc, ta = _t(edges, w, desired, cap, act)
    out_t = ref.waterfill_ref(te, tw, td, tc, fair_iters=fair_iters,
                              active=ta, want_util=True)
    for name, a, b in zip(("sent", "share", "util"), out_j, out_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    # want_util only adds an output
    two = ref.waterfill_ref(te, tw, td, tc, fair_iters=fair_iters, active=ta)
    assert len(two) == 2
    for a, b in zip(two, out_t):
        assert torch.equal(a, b)


@pytest.mark.parametrize("f,s,e,fair_iters,lane",
                         [(7, 3, 19, 0, "none"), (130, 9, 513, 1, "none"),
                          (256, 4, 1024, 2, "none"), (1, 5, 33, 2, "active"),
                          (200, 7, 751, 2, "active")])
def test_waterfill_ref_matches_pallas_kernel(f, s, e, fair_iters, lane):
    """Against the TPU kernel itself (interpret mode).  With the active
    lane both mask -1 slots to the trash link."""
    holes = lane == "active"
    edges, w, desired, cap, active = _wf_instance(f, s, e, f + s + e,
                                                  holes=holes)
    act = active if holes else None
    sent_k, share_k, util_k = j_waterfill(
        jnp.asarray(edges), jnp.asarray(w), jnp.asarray(desired),
        jnp.asarray(cap), active=None if act is None else jnp.asarray(act),
        fair_iters=fair_iters, backend="pallas", interpret=True,
        want_util=True)
    te, tw, td, tc, ta = _t(edges, w, desired, cap, act)
    sent, share, util = waterfill_step(te, tw, td, tc, active=ta,
                                       fair_iters=fair_iters, want_util=True)
    np.testing.assert_array_equal(np.asarray(share_k), share.numpy())
    np.testing.assert_allclose(sent.numpy(), np.asarray(sent_k),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(util.numpy(), np.asarray(util_k),
                               rtol=1e-5, atol=1e-7)


def test_waterfill_masks_inactive_rows_and_rows_without_live_slot():
    """Inactive rows send nothing and see share +inf; a row whose slots
    are all trash keeps share +inf and sends 0 after the first
    refinement, exactly as the TPU kernel's trash link does."""
    edges, w, desired, cap, active = _wf_instance(64, 5, 97, 3, idle_frac=0.0)
    edges[:8] = 96                                   # no live slot
    te, tw, td, tc, ta = _t(edges, w, desired, cap, active)
    sent, share = waterfill_step(te, tw, td, tc, active=ta, fair_iters=2)
    assert (sent.numpy()[~active] == 0).all()
    assert np.isposinf(share.numpy()[~active]).all()
    assert np.isposinf(share.numpy()[:8]).all()
    assert (sent.numpy()[:8] == 0).all()
    load = np.zeros(97)
    np.add.at(load, edges.reshape(-1), np.repeat(sent.numpy(), 5))
    assert (load[:96] <= 1 + 1e-4).all()


@pytest.mark.parametrize("semiring", ["bool", "count", "minplus"])
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_semiring_ref_matches_jax(semiring, m, k, n):
    a, b = _mm_operands(m, k, n, semiring, seed=m * k + n)
    exp = np.asarray(jref.semiring_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                              semiring))
    out = semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring)
    assert out.numpy().dtype == exp.dtype and out.shape == exp.shape
    np.testing.assert_array_equal(out.numpy(), exp)
    if m * k * n > 1:
        kern = np.asarray(j_semiring(jnp.asarray(a), jnp.asarray(b), semiring,
                                     backend="pallas", interpret=True))
        np.testing.assert_array_equal(out.numpy(), kern)


@pytest.mark.parametrize("semiring", ["bool", "count", "minplus"])
def test_semiring_batched_and_broadcast(semiring):
    a, b = _mm_operands(33, 70, 29, semiring, seed=5, batch=3)
    exp = np.asarray(jref.semiring_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                              semiring))
    out = semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring)
    np.testing.assert_array_equal(out.numpy(), exp)
    exp2 = np.asarray(jref.semiring_matmul_ref(jnp.asarray(a),
                                               jnp.asarray(b[0]), semiring))
    out2 = semiring_matmul(torch.from_numpy(a), torch.from_numpy(b[0]),
                           semiring)
    assert out2.shape == (3, 33, 29)
    np.testing.assert_array_equal(out2.numpy(), exp2)


@pytest.mark.parametrize("semiring", ["bool", "count", "minplus"])
def test_semiring_empty_batch_matches_jax(semiring):
    """A batch of zero products gives an empty (0, M, N) result, as the
    JAX package's oracle does (the ksp scheme with one layer makes one)."""
    a, b = _mm_operands(6, 5, 4, semiring, seed=1, batch=0)
    exp = np.asarray(jref.semiring_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                              semiring))
    out = semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring)
    assert out.shape == exp.shape == (0, 6, 4)
    assert out.numpy().dtype == exp.dtype


def test_count_saturates_and_pathcount_is_count():
    big = torch.full((20, 20), 1e30)
    out = pathcount_matmul(big, big)
    assert torch.isfinite(out).all()
    a, b = _mm_operands(17, 23, 9, "count", seed=2)
    np.testing.assert_array_equal(
        pathcount_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jref.pathcount_ref(jnp.asarray(a), jnp.asarray(b))))


def test_cpu_tensors_launch_nothing():
    reset_launches()
    a, b = _mm_operands(8, 8, 8, "bool", seed=0)
    semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), "bool")
    te, tw, td, tc, ta = _t(*_wf_instance(7, 3, 19, 0))
    waterfill_step(te, tw, td, tc, active=ta)
    assert set(LAUNCHES) >= {"semiring", "waterfill"}
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES
    with pytest.raises(ValueError, match="unknown semiring"):
        semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), "tropical")
