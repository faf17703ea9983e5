"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips itself."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, ref, semiring_matmul, waterfill_step

WF_SHAPES = [(7, 3, 19), (128, 7, 512), (200, 7, 751), (1, 5, 33),
             (130, 9, 513), (256, 4, 1024), (10830, 8, 42599)]
MM_SHAPES = [(1, 1, 1), (100, 130, 70), (1, 257, 129), (130, 1, 200),
             (97, 300, 65), (70, 1100, 90)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _mm_operands(m, k, n, semiring, seed, batch=2):
    rng = np.random.default_rng(seed)
    a = rng.random((batch, m, k), dtype=np.float32)
    b = rng.random((batch, k, n), dtype=np.float32)
    if semiring == "bool":
        a, b = a > 0.6, b > 0.6
    elif semiring == "count":                # integer-valued: exact sums
        a, b = np.floor(a * 5), np.floor(b * 5)
    else:
        a[rng.random(a.shape) < 0.3] = np.inf
        b[rng.random(b.shape) < 0.3] = np.inf
    return torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["bool", "count", "minplus"])
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_cuda_semiring_matches_plain(semiring, m, k, n):
    _need_card()
    a, b = _mm_operands(m, k, n, semiring, seed=m + n)
    before = LAUNCHES["semiring"]
    out = semiring_matmul(a, b, semiring)
    assert LAUNCHES["semiring"] == before + 1
    assert torch.equal(out, ref.semiring_matmul_ref(a, b, semiring))
    assert torch.equal(semiring_matmul(a, b[0], semiring),
                       ref.semiring_matmul_ref(a, b[0], semiring))
    assert torch.equal(semiring_matmul(a[0], b[0], semiring),
                       ref.semiring_matmul_ref(a[0], b[0], semiring))


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("f,s,e", WF_SHAPES)
def test_cuda_waterfill_matches_plain_and_repeats(f, s, e, pad):
    """``pad`` > 0 hands the kernel a strided (F, S) view of an (F, S + pad)
    record, as the scan does with its packed path record."""
    _need_card()
    rng = np.random.default_rng(f + e)
    edges = rng.integers(0, e - 1, (f, s + pad)).astype(np.int32)
    edges[rng.random((f, s + pad)) < 0.3] = e - 1
    edges[rng.random((f, s + pad)) < 0.1] = -1
    w = (rng.random(f) >= 0.25).astype(np.float32)
    desired = rng.random(f).astype(np.float32) * w
    args = [torch.from_numpy(x).cuda()
            for x in (edges, w, desired, np.ones(e, np.float32))]
    args[0] = args[0][:, :s]
    act = torch.from_numpy(rng.random(f) < 0.7).cuda()
    for fair_iters in (0, 1, 2):
        before = LAUNCHES["waterfill"]
        k1 = waterfill_step(*args, active=act, fair_iters=fair_iters,
                            want_util=True)
        k2 = waterfill_step(*args, active=act, fair_iters=fair_iters,
                            want_util=True)
        assert LAUNCHES["waterfill"] == before + 2
        r = ref.waterfill_ref(*args, active=act, fair_iters=fair_iters,
                              want_util=True)
        for x, y in zip(k1, k2):
            assert torch.equal(x, y)
        assert torch.equal(k1[1], r[1])
        for x, y in ((k1[0], r[0]), (k1[2], r[2])):
            np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    a = torch.zeros((4, 4), device="cuda")
    with pytest.raises(TypeError, match="bool operands"):
        semiring_matmul(a, a, "bool")
    with pytest.raises(ValueError, match="inner dimensions"):
        semiring_matmul(a, torch.zeros((3, 4), device="cuda"), "count")
    edges = torch.zeros((4, 2), dtype=torch.int64, device="cuda")
    v = torch.ones(4, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        waterfill_step(edges, v, v, torch.ones(5, device="cuda"))
