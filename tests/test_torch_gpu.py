"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips itself."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import (LAUNCHES, flash_attention, gf_matmul, ref,
                                 semiring_matmul, sparse_semiring_matmul,
                                 waterfill_step)
from repro_torch.kernels.semiring import SAT, count_split
from repro_torch.kernels.waterfill import link_plan

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


# (m, k, n, bound): integer operands below `bound`, so that sums pass 2^24
# but stay below 2^53 (exact in float64): a single 722^2 product (split
# K), k = 5000, and ragged m, k, n that are not multiples of 8.
COUNT_EXACT = [(722, 722, 722, 2 ** 20), (722, 5000, 722, 2 ** 18),
               (37, 1001, 53, 2 ** 20), (1, 3, 1, 2 ** 20),
               (129, 77, 65, 2 ** 21), (250, 4100, 3, 2 ** 18),
               (70, 1100, 90, 2 ** 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,bound", COUNT_EXACT)
def test_cuda_count_is_the_rounded_float64_product(m, k, n, bound):
    """K2's count product is bitwise f32(float64 product) clamped at sat
    (exact fp64 sums, one rounding, whatever the split of K), the same bits
    from launch to launch, and K3's count product is bitwise K2's."""
    _need_card()
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(0, bound, (m, k)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, bound, (k, n)).astype(np.float32))
    a, b = a.cuda(), b.cuda()
    exp = torch.minimum(torch.matmul(a.double(), b.double()).float(),
                        torch.tensor(SAT, device="cuda"))
    if m * n > 1:
        assert float(exp.max()) > 2 ** 24
    before = LAUNCHES["semiring"]
    out = semiring_matmul(a, b, "count")
    assert LAUNCHES["semiring"] == before + 1
    assert torch.equal(out, exp)
    assert torch.equal(semiring_matmul(a, b, "count"), out)
    assert torch.equal(sparse_semiring_matmul(a, b, "count"), out)
    for x, y, e in ((a[None].expand(2, -1, -1), b, exp[None].expand(2, -1, -1)),
                    (a, b[None].expand(3, -1, -1), exp[None].expand(3, -1, -1))):
        assert torch.equal(semiring_matmul(x, y, "count"), e)


@pytest.mark.gpu
def test_cuda_count_saturates_once():
    """Sums past FLT_MAX round to inf and the min takes them to sat, as the
    plain min(A @ B, sat) does; a small sat clamps the exact sum."""
    _need_card()
    a = torch.ones((33, 70), device="cuda")
    a[:10] = 2.0 ** 70
    b = torch.full((70, 129), 2.0 ** 70, device="cuda")   # 2^140 > FLT_MAX
    b[:, :5] = 1.0
    out = semiring_matmul(a, b, "count")
    assert torch.equal(out, ref.semiring_matmul_ref(a, b, "count"))
    assert bool((out[:10, 5:] == torch.tensor(SAT, dtype=torch.float32)).all())
    c = torch.from_numpy(np.random.default_rng(1).integers(
        0, 9, (700, 700)).astype(np.float32)).cuda()
    small = semiring_matmul(c, c, "count", sat=10000.0)
    exact = torch.matmul(c.double(), c.double())
    assert torch.equal(small, torch.clamp_max(exact, 10000.0).float())
    assert count_split(1, 700, 700, 700)[0] > 1


# The bool product (both operands packed to bits along K in one launch,
# then a 64x64-tile product on the tensor cores' single-bit form, m16n8k256
# .and.popc) across the edges of its output tiles
# (m, n 1, 63-65, 722), of its 32-entry words and 32-word passes (k 1,
# 31-33, 722, 1100), with A broadcast, B broadcast and both 3-D.
BOOL_K = [1, 31, 32, 33, 722, 1100]
BOOL_MN = [1, 63, 64, 65, 722]


@pytest.mark.gpu
@pytest.mark.parametrize("k", BOOL_K)
def test_cuda_bool_across_tile_and_step_edges(k):
    """Bitwise the plain version with A broadcast, B broadcast, both 3-D
    and both 2-D."""
    _need_card()
    rng = np.random.default_rng(k)
    density = min(0.5, k ** -0.5)
    for m in BOOL_MN:
        for n in BOOL_MN:
            a = torch.from_numpy(rng.random((3, m, k)) < density).cuda()
            b = torch.from_numpy(rng.random((3, k, n)) < density).cuda()
            for x, y in ((a, b), (a[1], b), (a, b[2]), (a[0], b[0])):
                exp = ref.semiring_matmul_ref(x, y, "bool")
                out = semiring_matmul(x, y, "bool")
                assert torch.equal(out, exp), (m, k, n, x.ndim, y.ndim)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,m,k,n", [(300, 65, 33, 65),
                                         (270, 129, 722, 1),
                                         (9, 722, 1100, 722),
                                         (2, 1682, 31, 1682)])
def test_cuda_bool_large_batches_across_edges(batch, m, k, n):
    """Batches of hundreds of small products and products of two K passes
    (K above 1 024), ragged at their row, column and word edges: bitwise
    the plain version, A broadcast too."""
    _need_card()
    rng = np.random.default_rng(batch + m + k + n)
    density = min(0.5, k ** -0.5)
    a = torch.from_numpy(rng.random((batch, m, k)) < density).cuda()
    b = torch.from_numpy(rng.random((batch, k, n)) < density).cuda()
    for x in (a, a[0]):
        assert torch.equal(semiring_matmul(x, b, "bool"),
                           ref.semiring_matmul_ref(x, b, "bool"))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(65, 722, 63), (722, 722, 722),
                                   (9, 1100, 130)])
def test_cuda_bool_reads_any_nonzero_byte_as_true(m, k, n):
    """uint8 bytes 0-255 viewed as bool give the product of ``x != 0``."""
    _need_card()
    rng = np.random.default_rng(m + k + n)
    xa = rng.integers(0, 256, (2, m, k), dtype=np.uint8)
    xb = rng.integers(0, 256, (2, k, n), dtype=np.uint8)
    xa[rng.random(xa.shape) > k ** -0.5] = 0
    xb[rng.random(xb.shape) > k ** -0.5] = 0
    a = torch.from_numpy(xa).cuda().view(torch.bool)
    b = torch.from_numpy(xb).cuda().view(torch.bool)
    exp = ref.semiring_matmul_ref(torch.from_numpy(xa != 0).cuda(),
                                  torch.from_numpy(xb != 0).cuda(), "bool")
    assert 0 < int(exp.sum()) < exp.numel()
    assert torch.equal(semiring_matmul(a, b, "bool"), exp)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [9, 1])
def test_cuda_bool_is_two_kernels_and_repeats(batch):
    """A bool call at the main path's shapes is two device kernels (the
    packing of both operands, then the product; ``torch.profiler``,
    besides ``LAUNCHES``), allocates its output and the two packed
    operands, and two launches give the same bits."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, b = _mm_operands(722, 722, 722, "bool", seed=5, batch=batch)
    first = semiring_matmul(a, b, "bool")
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    before = LAUNCHES["semiring"]
    again = semiring_matmul(a, b, "bool")
    torch.cuda.synchronize()
    assert LAUNCHES["semiring"] == before + 1
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 3
    assert torch.equal(again, first)
    assert torch.equal(first, ref.semiring_matmul_ref(a, b, "bool"))
    # The profiler can lose a trace's first device events: lead with spin
    # kernels and take the reading again unless every one of them is there.
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            semiring_matmul(a, b, "bool")
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if sum("spin" in x for x in names) == 8:
            break
    else:
        pytest.fail("the profiler kept losing device events")
    work = [x for x in names if "spin" not in x]
    assert len(work) == 2, work
    assert "pack_bool" in work[0] and "bool_product" in work[1], work


def _wf_inputs(f, s, e, seed, pad=0, scale=1.0):
    """Random water-filling inputs on the card: (edges, w, desired, cap,
    active), edges an (F, S) view of an (F, S + pad) record as the scan
    hands the kernel; ``scale`` != 1 puts weights, demands and capacities
    outside [0, 1]."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, e - 1, (f, s + pad)).astype(np.int32)
    edges[rng.random((f, s + pad)) < 0.3] = e - 1
    edges[rng.random((f, s + pad)) < 0.1] = -1
    w = (rng.random(f) >= 0.25).astype(np.float32)
    desired = rng.random(f).astype(np.float32) * w
    cap = np.ones(e, np.float32)
    if scale != 1.0:
        w = w * rng.uniform(0.5, scale, f).astype(np.float32)
        desired = (desired * scale).astype(np.float32)
        cap = rng.uniform(0.25, scale, e).astype(np.float32)
    args = [torch.from_numpy(x).cuda() for x in (edges, w, desired, cap)]
    args[0] = args[0][:, :s]
    return args + [torch.from_numpy(rng.random(f) < 0.7).cuda()]


def _cpu(xs):
    return [None if x is None else x.cpu() for x in xs]


def _assert_bitwise(out, exp):
    assert len(out) == len(exp)
    for x, y in zip(out, exp):
        assert x.is_cuda
        assert torch.equal(x.cpu(), y)


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("f,s,e", WF_SHAPES)
def test_cuda_waterfill_matches_plain_and_repeats(f, s, e, pad):
    """Bitwise the plain version on CPU copies of the same inputs (the
    kernel sums each link in its flat (flow, slot) order) and from launch
    to launch; ``pad`` > 0 hands the kernel a strided (F, S) view of an
    (F, S + pad) record, as the scan does with its packed path record."""
    _need_card()
    *args, act = _wf_inputs(f, s, e, f + e, pad)
    for fair_iters in (0, 1, 2):
        before = LAUNCHES["waterfill"]
        k1 = waterfill_step(*args, active=act, fair_iters=fair_iters,
                            want_util=True)
        k2 = waterfill_step(*args, active=act, fair_iters=fair_iters,
                            want_util=True)
        assert LAUNCHES["waterfill"] == before + 2
        r = ref.waterfill_ref(*_cpu(args), active=act.cpu(),
                              fair_iters=fair_iters, want_util=True)
        for x, y in zip(k1, k2):
            assert torch.equal(x, y)
        _assert_bitwise(k1, r)


@pytest.mark.gpu
@pytest.mark.parametrize("f,s,e", WF_SHAPES[1::2])
def test_cuda_waterfill_accumulator_is_one_rounding(f, s, e):
    """``acc`` comes back as acc + d * s rounded once (one fmaf; acc + d
    at fair_iters 0), bitwise the plain version's emulation, and the
    input accumulator is left as it was."""
    _need_card()
    *args, act = _wf_inputs(f, s, e, 3 * f + e)
    acc = torch.from_numpy(np.random.default_rng(f).random(f).astype(
        np.float32) * 50).cuda()
    kept = acc.clone()
    for fair_iters in (0, 1, 2):
        for want_util in (False, True):
            out = waterfill_step(*args, active=act, fair_iters=fair_iters,
                                 want_util=want_util, acc=acc)
            exp = ref.waterfill_ref(*_cpu(args), active=act.cpu(),
                                    fair_iters=fair_iters,
                                    want_util=want_util, acc=acc.cpu())
            assert len(out) == 4 if want_util else 3
            _assert_bitwise(out, exp)
    assert torch.equal(acc, kept)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [7.5, 300.0])
def test_cuda_waterfill_values_outside_unit_range(scale):
    """Weights, demands and capacities outside [0, 1] (and many flows
    on one link): f32 sums in the plain version's order, bitwise."""
    _need_card()
    *args, act = _wf_inputs(4000, 6, 9001, int(scale), scale=scale)
    acc = torch.zeros(4000, device="cuda")
    for fair_iters in (0, 2):
        out = waterfill_step(*args, active=act, fair_iters=fair_iters,
                             want_util=True, acc=acc)
        exp = ref.waterfill_ref(*_cpu(args), active=act.cpu(),
                                fair_iters=fair_iters, want_util=True,
                                acc=acc.cpu())
        _assert_bitwise(out, exp)
        assert float(out[0].max()) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers", [1, 3, 32])
def test_cuda_waterfill_scan_style_call_with_plan(n_layers):
    """As the scan calls it: the rows of a strided view of an (L, F, S + 2)
    record gathered by each flow's layer, with the plan of the whole
    stack built once.  Bitwise the plain version on the gathered edges,
    one launch a call (the plan's own launches are not counted)."""
    _need_card()
    f, s, e = 3000, 7, 2001
    rng = np.random.default_rng(n_layers)
    stack = rng.integers(0, e - 1, (n_layers, f, s + 2)).astype(np.int32)
    stack[rng.random(stack.shape) < 0.2] = -1
    stack[rng.random(stack.shape) < 0.05] = e - 1
    stack[:, :, s - 1] = stack[0, :, s - 1]        # a NIC-like shared slot
    stack = torch.from_numpy(stack).cuda()
    plan = link_plan(stack[:, :, :s], e)
    w = torch.ones(f, device="cuda")
    cap = torch.ones(e, device="cuda")
    acc = torch.zeros(f, device="cuda")
    frows = torch.arange(f, device="cuda")
    for step in range(4):
        layer = torch.from_numpy(rng.integers(0, n_layers, f).astype(
            np.int32)).cuda()
        send = torch.from_numpy(rng.random(f) < 0.8).cuda()
        edges = stack[layer, frows][:, :s]
        desired = torch.from_numpy(rng.random(f).astype(np.float32)).cuda()
        before = LAUNCHES["waterfill"]
        out = waterfill_step(edges, w, desired, cap, active=send, acc=acc,
                             plan=plan, layer=layer)
        assert LAUNCHES["waterfill"] == before + 1
        exp = ref.waterfill_ref(*_cpu([edges, w, desired, cap]),
                                active=send.cpu(), acc=acc.cpu())
        _assert_bitwise(out, exp)
        acc = out[2]


SPARSE_SHAPES = [(1, 1, 1, 128), (100, 130, 70, 32), (97, 300, 65, 128),
                 (70, 1100, 90, 64), (130, 257, 200, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["bool", "count", "minplus"])
@pytest.mark.parametrize("m,k,n,tile", SPARSE_SHAPES)
def test_cuda_sparse_matches_dense_kernel_and_plain(semiring, m, k, n, tile):
    """Bitwise against the dense kernel and the plain version, batched,
    broadcast and 2-D; integer-valued counts (bk = 48 moves the kernel's
    32-wide saturation steps off the dense kernel's)."""
    _need_card()
    a, b = _mm_operands(m, k, n, semiring, seed=m * n + tile)
    before = LAUNCHES["sparse"]
    for x, y in ((a, b), (a, b[0]), (a[0], b[0])):
        out = sparse_semiring_matmul(x, y, semiring, bm=tile, bn=tile,
                                     bk=tile)
        assert torch.equal(out, semiring_matmul(x, y, semiring))
        assert torch.equal(out, ref.sparse_semiring_matmul_ref(x, y,
                                                               semiring))
    assert LAUNCHES["sparse"] == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["bool", "count", "minplus"])
def test_cuda_sparse_skips_empty_tiles_exactly(semiring):
    """A block-diagonal operand: three quarters of the tile pairs are
    empty and skipped; the result is still the dense product's."""
    _need_card()
    a, b = _mm_operands(256, 256, 256, semiring, seed=3, batch=1)
    a, b = a[0].clone(), b[0]
    zero = float("inf") if semiring == "minplus" else 0
    for i in range(4):
        for j in range(4):
            if i != j:
                a[64 * i:64 * (i + 1), 64 * j:64 * (j + 1)] = zero
    out = sparse_semiring_matmul(a, b, semiring, bm=64, bn=64, bk=64)
    assert torch.equal(out, ref.sparse_semiring_matmul_ref(a, b, semiring))


@pytest.mark.gpu
@pytest.mark.parametrize("bk", [48, 96])
@pytest.mark.parametrize("m,k,n,tile", [(130, 257, 200, 64), (97, 300, 65, 32),
                                        (2, 1100, 3, 128)])
def test_cuda_sparse_bool_packed_words_any_bk(bk, m, k, n, tile):
    """The bool product on K2's bit-packed words with a bk that is not a
    multiple of 32 (a word then straddles two K tiles): bitwise against the
    dense kernel and the plain version, dense and with every other K tile
    of A emptied, so that words are skipped and others are partly empty."""
    _need_card()
    a, b = _mm_operands(m, k, n, "bool", seed=m + k + bk)
    sparse_a = a.clone()
    for kt in range(1, -(-k // bk), 2):
        sparse_a[..., kt * bk:(kt + 1) * bk] = False
    for x in (a, sparse_a):
        for y in (b, b[0]):
            out = sparse_semiring_matmul(x, y, "bool", bm=tile, bn=tile,
                                         bk=bk)
            assert out.dtype == torch.bool
            assert torch.equal(out, semiring_matmul(x, y, "bool"))
            assert torch.equal(out, ref.sparse_semiring_matmul_ref(x, y,
                                                                   "bool"))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,p", [("int32", 1009), ("int32", 127),
                                    ("f32", 251), ("int32", 40009)])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (128, 384, 256), (70, 1100, 33),
                                   (257, 64, 129)])
def test_cuda_gfmm_matches_plain_exactly(mode, p, m, k, n):
    """p = 40009 takes the kernel's int64 step sums (32 (p-1)^2 >= 2^31)."""
    _need_card()
    rng = np.random.default_rng(m + k + n + p)
    a = torch.from_numpy(rng.integers(0, p, (m, k)).astype(np.int32)).cuda()
    b = torch.from_numpy(rng.integers(0, p, (k, n)).astype(np.int32)).cuda()
    bk = 1 if p == 40009 else 128
    before = LAUNCHES["gfmm"]
    out = gf_matmul(a, b, p=p, mode=mode, bk=bk)
    assert LAUNCHES["gfmm"] == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, ref.gf_matmul_ref(a, b, p))


# (p, mode, bk): every limb class the kernel takes (one limb up to 256,
# two above), in the mode whose limit admits it; bk = 0 passes the mode
# limit for the largest primes below 2^16.
GF_LIMBS = [(2, "int32", 128), (2, "f32", 128), (127, "int32", 128),
            (251, "f32", 256), (257, "int32", 128), (1009, "int32", 128),
            (4093, "int32", 128), (40009, "int32", 1), (65521, "int32", 0)]
# Shapes that are not multiples of 16, 8 or 32; k = 20 000 crosses the
# kernel's K chunk (16 512 entries with two limbs).
GF_RAGGED = [(1, 1, 1), (70, 1100, 33), (257, 64, 129), (131, 333, 77),
             (17, 20000, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("p,mode,bk", GF_LIMBS)
@pytest.mark.parametrize("m,k,n", GF_RAGGED)
def test_cuda_gfmm_limbs_exact(p, mode, bk, m, k, n):
    _need_card()
    rng = np.random.default_rng(m * n + k + p)
    a = torch.from_numpy(rng.integers(0, p, (m, k)).astype(np.int32)).cuda()
    b = torch.from_numpy(rng.integers(0, p, (k, n)).astype(np.int32)).cuda()
    before = LAUNCHES["gfmm"]
    out = gf_matmul(a, b, p=p, mode=mode, bk=bk)
    assert LAUNCHES["gfmm"] == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, ref.gf_matmul_ref(a, b, p))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [257, 40009, 65521])
def test_cuda_gfmm_largest_residues_across_chunks(p):
    """Every entry p - 1 over 40 000 K entries: the s32 sums must be
    reduced at each chunk boundary (unreduced, the cross sum of p = 65521
    would pass 2^31), and the result is exact."""
    _need_card()
    k = 40000
    a = torch.full((19, k), p - 1, dtype=torch.int32, device="cuda")
    b = torch.full((k, 23), p - 1, dtype=torch.int32, device="cuda")
    out = gf_matmul(a, b, p=p, bk=0)
    assert bool((out == (k * (p - 1) ** 2) % p).all())
    assert torch.equal(out, ref.gf_matmul_ref(a, b, p))


# (b, h, hkv, sq, sk, d, causal, window, softcap)
ATTN_CASES = [(1, 4, 2, 200, 200, 64, True, 0, 0.0),
              (2, 4, 1, 130, 130, 128, False, 0, 0.0),
              (1, 2, 2, 300, 300, 96, True, 50, 0.0),
              (1, 4, 2, 190, 190, 128, True, 64, 50.0),
              (1, 2, 1, 100, 77, 200, False, 0, 0.0),
              (1, 2, 1, 150, 60, 32, True, 16, 0.0),     # rows 75.. dead
              (1, 8, 1, 64, 64, 256, True, 0, 30.0),
              (2, 4, 4, 300, 300, 80, False, 0, 0.0),    # hubert: D 80
              (1, 14, 2, 130, 130, 128, True, 0, 0.0)]   # qwen2-vl: group 7


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,softcap", ATTN_CASES)
def test_cuda_flash_attention_matches_plain(dtype, tol, b, h, hkv, sq, sk, d,
                                            causal, window, softcap):
    _need_card()
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype) for s in ((b, h, sq, d), (b, hkv, sk, d),
                                             (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    assert LAUNCHES["flash_attention"] == before + 1
    exp = ref.attention_ref(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == exp.shape
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=tol, atol=tol)
    if causal and window and sq > sk + window - 1:
        assert (out[:, :, sk + window - 1:] == 0).all()


# (b, h, hkv, sq, sk, d, causal, window, softcap): bf16 cases for the
# tensor-core kernel's edges.
TC_CASES = [(1, 2, 2, 64, 64, 16, True, 0, 0.0),        # D 16: one chunk
            (1, 2, 1, 100, 130, 48, False, 0, 0.0),     # D 48, Sk > Sq
            (1, 4, 2, 1, 300, 128, False, 0, 0.0),      # Sq 1
            (1, 4, 2, 1, 300, 64, True, 0, 0.0),        # Sq 1, causal
            (1, 4, 2, 200, 1, 128, True, 0, 0.0),       # Sk 1
            (1, 4, 2, 200, 1, 128, False, 0, 0.0),
            (1, 8, 1, 1024, 1024, 128, True, 0, 0.0),   # GQA group 8
            (1, 2, 1, 150, 60, 32, True, 16, 0.0),      # rows 75.. dead
            (1, 4, 2, 190, 190, 200, True, 64, 50.0),   # D 200, softcap
            (2, 2, 1, 77, 93, 20, True, 0, 0.0),        # D 20: no cp.async
            (1, 2, 1, 300, 300, 256, True, 100, 30.0),  # D 256
            (2, 4, 4, 300, 300, 64, True, 100, 0.0),    # zamba2: MHA, D 64
            (1, 4, 4, 256, 256, 64, True, 4096, 0.0)]   # window >= S


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,softcap", TC_CASES)
def test_cuda_flash_attention_bf16_tensor_cores(b, h, hkv, sq, sk, d, causal,
                                                window, softcap):
    """bf16 through the tensor-core kernel, held to bf16's rounding
    against the plain version (|err| <= 1e-2 |exp| + 1e-3, tighter than
    the JAX package's 5e-2); fully masked rows exactly 0."""
    _need_card()
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", torch.bfloat16)
               for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    assert LAUNCHES["flash_attention"] == before + 1
    exp = ref.attention_ref(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == exp.shape
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=1e-2,
                               atol=1e-3)
    if causal and window and sq > sk + window - 1:
        assert (out[:, :, sk + window - 1:] == 0).all()


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
    # No F*S limit (it was 2^23 for the fixed-point sums): f32 sums in
    # the plain version's order at any size.
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.integers(0, 2 ** 17, (2 ** 20, 8)).astype(
        np.int32)).cuda()
    ones = torch.ones(2 ** 20, device="cuda")
    cap = torch.ones(2 ** 17 + 1, device="cuda")
    _assert_bitwise(waterfill_step(big, ones, ones, cap),
                    ref.waterfill_ref(*_cpu([big, ones, ones, cap]),
                                      active=torch.ones(2 ** 20,
                                                        dtype=torch.bool)))
    with pytest.raises(ValueError, match="layer"):
        waterfill_step(big[:4].contiguous(), v, v,
                       torch.ones(5, device="cuda"),
                       layer=torch.zeros(4, dtype=torch.int32,
                                         device="cuda"))
    with pytest.raises(ValueError, match="plan is for 8 flows"):
        waterfill_step(big[:4].contiguous(), v, v, cap,
                       plan=link_plan(big[:8], cap.shape[0]))
    with pytest.raises(TypeError, match="bool operands"):
        sparse_semiring_matmul(a, a, "bool")
    q = torch.zeros((1, 2, 4, 300), device="cuda")
    with pytest.raises(ValueError, match="head dimension"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q[..., :8].half(), q[..., :8].half(),
                        q[..., :8].half())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_pi_min_tables_equal_cpu(seed):
    """The pi_min stack built on the card (K2 bool in each layer's APSP)
    is bitwise the one built on the CPU, and loop-free."""
    from repro_torch.core import layers, topology
    _need_card()
    tt = topology.slim_fly(5)
    before = LAUNCHES["semiring"]
    gpu = layers.build_layers(tt, 9, 0.6, scheme="pi_min", seed=seed,
                              device="cuda")
    assert LAUNCHES["semiring"] > before
    cpu = layers.build_layers(tt, 9, 0.6, scheme="pi_min", seed=seed,
                              device="cpu")
    for name in ("layer_adj", "nh", "reach", "pathlen"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    assert gpu.validate_loop_free(n_samples=10 ** 6).ok


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 32, 33, 1025, 10509, 630493])
def test_cuda_xla_sum_equals_cpu(n):
    from repro_torch.core.layers import xla_sum
    _need_card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.random(n) * 10.0 ** rng.integers(-3, 5, n))
                         .astype(np.float32))
    got = xla_sum(x.cuda())
    assert got.device.type == "cuda"
    assert got.cpu().numpy().tobytes() == xla_sum(x).numpy().tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,evaluator", [
    ("load(window=24)", "transport(steps=400)"),
    ("incast", "outcast(steps=400)"),
    ("anycast", "transport(steps=400,transport=tcp)")])
def test_cuda_dynamic_cell_equals_cpu(pattern, evaluator):
    """An open-loop sf(q=5) cell on the card: the same departures and
    metrics as on the CPU."""
    from repro_torch.experiments import Session, catalog
    _need_card()
    runs = {}
    for dev in ("cuda", "cpu"):
        sims = []
        real = catalog.simulate_seeds

        def rec(*a, **kw):
            sims.append(real(*a, **kw))
            return sims[-1]
        catalog.simulate_seeds = rec
        try:
            rr = Session(device=dev).run("sf", "fatpaths(n_layers=9,rho=0.6)",
                                         pattern, evaluator)
        finally:
            catalog.simulate_seeds = real
        runs[dev] = (rr, sims[0][0])
    assert runs["cuda"][0].metrics == runs["cpu"][0].metrics
    np.testing.assert_array_equal(runs["cuda"][1].depart_step,
                                  runs["cpu"][1].depart_step)
    assert (runs["cuda"][1].depart_step >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("f,s,e", WF_SHAPES[1::2])
def test_cuda_waterfill_dead_links(f, s, e):
    """Links with capacity 0 (a mid-run death, a churn outage): fair share
    0, scale 0 and ``util = load / 1e-9`` on the card are bitwise the plain
    version's, with and without ``want_util``."""
    _need_card()
    *args, act = _wf_inputs(f, s, e, 5 * f + e)
    rng = np.random.default_rng(e)
    args[3] = torch.where(torch.from_numpy(rng.random(e) < 0.2).cuda(),
                          0.0, args[3])
    acc = torch.zeros(f, device="cuda")
    for fair_iters in (0, 2):
        for want_util in (False, True):
            out = waterfill_step(*args, active=act, fair_iters=fair_iters,
                                 want_util=want_util, acc=acc)
            exp = ref.waterfill_ref(*_cpu(args), active=act.cpu(),
                                    fair_iters=fair_iters,
                                    want_util=want_util, acc=acc.cpu())
            _assert_bitwise(out, exp)
            if want_util and fair_iters == 0 and f > 1:
                # claim counts over a dead link's 1e-9 floor; from round
                # 1 on, flows through a dead link demand nothing
                assert float(out[2].max()) > 1e8


def _cell_card_and_cpu(routing, pattern, evaluator):
    """One sf(q=5) cell in a session on the card and on the CPU: both
    RunResults and each run's first SimResult."""
    from repro_torch.experiments import Session, catalog
    runs = {}
    for dev in ("cuda", "cpu"):
        sims = []
        real = catalog.simulate_seeds

        def rec(*a, **kw):
            sims.append(real(*a, **kw))
            return sims[-1]
        catalog.simulate_seeds = rec
        try:
            rr = Session(device=dev).run("sf", routing, pattern, evaluator)
        finally:
            catalog.simulate_seeds = real
        runs[dev] = (rr, [s[0] for s in sims])
    return runs


@pytest.mark.gpu
@pytest.mark.parametrize("routing,evaluator", [
    ("failures(of=fatpaths(n_layers=9,rho=0.6),rate=0.05,down_step=20)",
     "recovery(steps=200,transport=dctcp)"),
    ("churn(of=fatpaths(n_layers=9,rho=0.6),rate=0.2,mtbf=30,mttr=10)",
     "availability(steps=200)")])
def test_cuda_fault_cell_equals_cpu(routing, evaluator):
    """A mid-run death under dctcp recovery (K1 with ``want_util`` and
    zero capacities) and a churn cell with its pristine control: the
    card's departures, retransmissions and per-step curves are the CPU's,
    bitwise, and so are the metrics."""
    _need_card()
    before = LAUNCHES["waterfill"]
    runs = _cell_card_and_cpu(routing, "permutation(flow_size=268435456)",
                              evaluator)
    assert LAUNCHES["waterfill"] > before
    from repro_torch.experiments.results import compare_results
    assert compare_results([runs["cuda"][0]], [runs["cpu"][0]]) == []
    for g, c in zip(runs["cuda"][1], runs["cpu"][1]):
        for name in ("depart_step", "delivered", "retrans_bytes",
                     "goodput_steps", "stalled_steps"):
            assert getattr(g, name).tobytes() == getattr(c, name).tobytes(), \
                name
    assert runs["cuda"][1][0].goodput_steps.max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,mode", [("bernoulli", "repair"),
                                          ("switch", "drop"),
                                          ("blast", "repair")])
def test_cuda_degraded_tables_equal_cpu(pattern, mode):
    """sf(q=5) stacks degraded on the card (repair: K2 bool in the APSP of
    the masked stack; blast: K2 bool hop distances) are bitwise the CPU's,
    with the same report, and loop-free."""
    from repro_torch.core import failures, layers, topology
    _need_card()
    tt = topology.slim_fly(5)
    out = {}
    for dev in ("cuda", "cpu"):
        lr = layers.build_layers(tt, 9, 0.6, seed=0, device=dev)
        key = failures.scenario_key(0, 0, dev)
        before = LAUNCHES["semiring"]
        dead = failures.failure_mask(key, tt.adj, 0.1, pattern)
        out[dev] = failures.apply_failures(lr, dead, mode=mode, rate=0.1,
                                           pattern=pattern) + (dead,)
        if dev == "cuda" and mode == "repair":
            assert LAUNCHES["semiring"] > before
    (g, g_rep, g_dead), (c, c_rep, c_dead) = out["cuda"], out["cpu"]
    assert (g_dead == c_dead).all() and g_dead.any() and g_rep == c_rep
    for name in ("layer_adj", "nh", "reach", "pathlen"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    assert g.validate_loop_free(n_samples=10 ** 6).ok


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["rand", "ksp", "pi_min", "ecmp"])
def test_cuda_blocked_engine_equals_dense_and_cpu(monkeypatch, scheme):
    """At sf(q=13) (338 routers: two destination chunks) the blocked
    engine's tables on the card are bitwise the dense engine's on the
    card and the blocked engine's on the CPU, and its compressed tables
    are the CPU's."""
    from repro_torch.core import layers, topology, transport
    _need_card()
    tt = topology.slim_fly(13)

    def build(engine, dev):
        if scheme == "ecmp":
            monkeypatch.setenv("REPRO_PATH_ENGINE", engine)
            return transport.ecmp_routing(tt, n_tables=4, seed=1, device=dev)
        return layers.build_layers(tt, 5, 0.6, scheme=scheme, seed=1,
                                   engine=engine, device=dev)

    blocked, dense, cpu = (build("blocked", "cuda"), build("dense", "cuda"),
                           build("blocked", "cpu"))
    for name in ("layer_adj", "nh", "reach", "pathlen"):
        assert torch.equal(getattr(blocked, name), getattr(dense, name)), name
        assert torch.equal(getattr(blocked, name).cpu(),
                           getattr(cpu, name)), name
    ct, ct_cpu = blocked.compressed, cpu.compressed
    assert ct.sel.is_cuda and dense.compressed is None
    assert (ct.block, ct.n) == (ct_cpu.block, ct_cpu.n)
    assert torch.equal(ct.nh_sets.cpu(), ct_cpu.nh_sets)
    assert torch.equal(ct.sel.cpu(), ct_cpu.sel)
    assert torch.equal(ct.dense(), blocked.nh)


@pytest.mark.gpu
@pytest.mark.parametrize("n,block", [(338, None), (903, None), (722, 64)])
def test_cuda_compressed_tables_equal_cpu(n, block):
    """``CompressedTables.from_dense`` on the card (stable sort, scatter)
    gives the CPU's ``nh_sets``, ``sel`` and block bitwise, on tables with
    holes and with next-hop sets wide enough to halve the block."""
    from repro_torch.core.paths import CompressedTables
    _need_card()
    rng = np.random.default_rng(n)
    width = 300 if n == 903 else 40
    nh = rng.integers(-1, width, (3, n, n)).astype(np.int32)
    nh[:, :, : n // 3] = np.sort(nh[:, :, : n // 3], axis=-1)
    cpu = CompressedTables.from_dense(torch.from_numpy(nh), block)
    gpu = CompressedTables.from_dense(torch.from_numpy(nh).cuda(), block)
    assert (gpu.block, gpu.n) == (cpu.block, cpu.n)
    if n == 903:
        assert cpu.block < 512
    assert torch.equal(gpu.nh_sets.cpu(), cpu.nh_sets)
    assert torch.equal(gpu.sel.cpu(), cpu.sel)
    assert torch.equal(gpu.dense().cpu(), torch.from_numpy(nh))
    li, s, t = (torch.from_numpy(rng.integers(hi, size=1000)).cuda()
                for hi in (3, n, n))
    assert torch.equal(gpu.lookup(li, s, t).cpu(),
                       torch.from_numpy(nh)[li.cpu(), s.cpu(), t.cpu()])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [338, 1682])
def test_cuda_count_row_block_bitwise(n):
    """K2 count on the blocked ``min_path_stats`` shapes, a (256, N) row
    block times the (N, N) adjacency, bitwise its plain version while the
    exact sums stay below 2^24; and the blocked statistics on the card
    equal the CPU's."""
    from repro_torch.core import paths, topology
    _need_card()
    q = {338: 13, 1682: 29}[n]
    adj = torch.from_numpy(np.asarray(topology.slim_fly(q).adj,
                                      np.float32)).cuda()
    cur = adj[:256]
    for _ in range(3):
        before = LAUNCHES["semiring"]
        out = semiring_matmul(cur, adj, "count")
        assert LAUNCHES["semiring"] == before + 1
        assert float(out.max()) < 2 ** 24
        assert torch.equal(out, ref.semiring_matmul_ref(cur, adj, "count"))
        cur = out
    if n == 338:
        g = paths.min_path_stats(adj, max_l=8, engine="blocked")
        c = paths.min_path_stats(adj.cpu(), max_l=8, engine="blocked")
        for x, y in zip(g, c):
            assert np.array_equal(x, y)


def _union_case(dev):
    """Three sf(q=5) elements of different sizes under a death and dctcp
    recovery, padded to one shape: (padded, static, unpadded, seeds)."""
    from repro_torch.core import transport as T
    from repro_torch.experiments import Session
    ses = Session(device=dev)
    routing = "failures(of=fatpaths(n_layers=9,rho=0.6),rate=0.05,down_step=10)"
    cells = [ses.resolve(ses.grid(["sf"], [routing],
                                  [f"{p}(flow_size=4194304)"])[0])
             for p in ("uniform", "anycast", "shuffle")]
    cfg = T.SimConfig(balancing="fatpaths", n_steps=200, recovery="on",
                      transport="dctcp")
    prep = [T.prepare(c.topo, c.bundle.routing, c.workload, cfg, device=dev)
            for c in cells]
    nf = max(a["size"].shape[0] for a, _ in prep)
    ne = max(st[0] for _, st in prep)
    nh = max(a["path_edges"].shape[2] for a, _ in prep)
    padded = [T.pad_prepared(a, st, n_flows=nf, n_edges=ne, hop_slots=nh)
              for a, st in prep]
    return cfg, [p for p, _ in padded], padded[0][1], prep, [0, 1000, 7]


@pytest.mark.gpu
def test_cuda_union_scan_equals_each_element():
    """On the card the union scan of three elements gives each element
    the bits of its own scan (every per-flow lane), with one water-filling
    launch a step for the union."""
    from repro_torch import prng
    from repro_torch.core import transport as T
    _need_card()
    cfg, padded, static, prep, seeds = _union_case("cuda")
    uarrs, ustatic = T.union_prepared(padded, static)
    keys = torch.stack([prng.PRNGKey(s, "cuda") for s in seeds])
    n_real = [a["size"].shape[0] for a, _ in prep]
    before = LAUNCHES["waterfill"]
    final = T._run_scan(uarrs, keys, cfg, ustatic, n_real=n_real)
    steps = max(final["horizon_chunks"]) * cfg.horizon_chunk \
        + cfg.n_steps % cfg.horizon_chunk
    assert LAUNCHES["waterfill"] - before == steps
    per = T.split_union(final, 3)
    for b, ((arrs, st), s) in enumerate(zip(prep, seeds)):
        alone = T._run_scan(arrs, prng.PRNGKey(s, "cuda"), cfg, st)
        assert alone["horizon_chunks"] == per[b]["horizon_chunks"]
        for k in ("remaining", "sent_acc", "w_acc", "depart_step", "hops",
                  "retrans_acc"):
            got = per[b][k][:n_real[b]]
            assert alone[k].cpu().numpy().tobytes() == got.tobytes(), (b, k)


@pytest.mark.gpu
def test_cuda_waterfill_on_a_union_plan_equals_each_element():
    """K1 over a union's plan returns each element's rows bitwise as K1
    over the element's own plan does."""
    from repro_torch.core import transport as T
    from repro_torch.kernels.waterfill import LinkPlan
    _need_card()
    _, padded, static, _, _ = _union_case("cuda")
    uarrs, ustatic = T.union_prepared(padded, static)
    fp = padded[0]["size"].shape[0]
    rng = np.random.default_rng(3)
    n = len(padded) * fp
    layer = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)).cuda()
    w = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32)).cuda()
    w[torch.cat([torch.arange(b * fp + 190, (b + 1) * fp)
                 for b in range(len(padded))]).cuda()] = 0.0
    desired = torch.from_numpy(rng.random(n).astype(np.float32)).cuda() * w
    acc = torch.from_numpy(rng.random(n).astype(np.float32)).cuda()
    frows = torch.arange(n, device="cuda")
    edges = uarrs["path_edges"][layer.long(), frows]
    cap = torch.from_numpy(rng.random(ustatic[0]).astype(np.float32)).cuda()
    got = waterfill_step(edges, w, desired, cap, active=w > 0,
                         want_util=True, acc=acc, layer=layer,
                         plan=LinkPlan(uarrs["plan_offsets"],
                                       uarrs["plan_entries"], n))
    live = static[0] - 1
    for b, a in enumerate(padded):
        rows = slice(b * fp, (b + 1) * fp)
        cap_b = torch.cat([cap[b * live:(b + 1) * live], cap[-1:]])
        exp = waterfill_step(
            a["path_edges"][layer[rows].long(), torch.arange(fp,
                                                             device="cuda")],
            w[rows], desired[rows], cap_b, active=w[rows] > 0,
            want_util=True, acc=acc[rows], layer=layer[rows],
            plan=LinkPlan(a["plan_offsets"], a["plan_entries"], fp))
        for x, y in zip(got, exp):
            assert x[rows].cpu().numpy().tobytes() == \
                y.cpu().numpy().tobytes(), b


@pytest.mark.gpu
def test_cuda_session_devices_beyond_the_visible_cards_raise():
    from repro_torch.experiments import Session
    _need_card()
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA device"):
        Session(device="cuda").sweep(["sf"], ["ecmp"], ["uniform"],
                                     ["transport(steps=40)"],
                                     devices=n + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["dense", "blocked"])
def test_cuda_usable_walks_equal_cpu(monkeypatch, engine):
    """The off-scan evaluators' batched walk over every usable (pair,
    layer) on the card (the dense tables, or the compressed ones under the
    blocked engine) gives the CPU's pairs, layers and sequences."""
    from repro_torch.core import layers, topology
    _need_card()
    monkeypatch.setenv("REPRO_PATH_ENGINE", engine)
    tt = topology.slim_fly(13)
    rng = np.random.default_rng(0)
    s, t = rng.integers(0, tt.n_routers, (2, 3000))
    out = {}
    for dev in ("cuda", "cpu"):
        lr = layers.build_layers(tt, 9, 0.6, seed=0, device=dev)
        assert (lr.compressed is not None) == (engine == "blocked")
        out[dev] = layers.usable_walks(lr, s, t, 12)
    for got, exp in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(got, exp)


@pytest.mark.gpu
@pytest.mark.parametrize("q,max_len", [(5, 3), (7, 3), (7, 5)])
def test_cuda_gf_connectivity_bitwise_cpu(q, max_len):
    """GFConnectivity's float64 Horner product on the card is bitwise the
    CPU's (every partial sum an exact integer below 2^53)."""
    from repro_torch.core import diversity, topology
    _need_card()
    adj = topology.slim_fly(q).adj
    got = diversity.GFConnectivity.build(adj, max_len, device="cuda")
    exp = diversity.GFConnectivity.build(adj, max_len, device="cpu")
    np.testing.assert_array_equal(got.M.view(np.int64), exp.M.view(np.int64))
    pairs = [(0, 1), (3, 40), (17, 2), (49, 48)]
    np.testing.assert_array_equal(got.query_pairs(pairs),
                                  exp.query_pairs(pairs))


@pytest.mark.gpu
@pytest.mark.parametrize("routing", ["fatpaths(n_layers=9,rho=0.6)", "ecmp"])
@pytest.mark.parametrize("evaluator", ["mat", "fabric"])
def test_cuda_off_scan_cell_equals_cpu(routing, evaluator):
    """An sf(q=5) ``mat`` or ``fabric`` cell on the card equals the CPU
    port's at rtol 0."""
    from repro_torch.experiments import Session, compare_results
    _need_card()
    got = Session(device="cuda").run("sf", routing, "permutation", evaluator)
    exp = Session(device="cpu").run("sf", routing, "permutation", evaluator)
    assert compare_results([got], [exp], rtol=0) == []


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, (1e-2, 1e-3)),
                                       (torch.float32, (1e-4, 1e-4))])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("sk", [1, 5, 24, 128])
def test_cuda_flash_attention_at_decode_shapes(sk, group, dtype, tol):
    """A decode step's attention: one query row per head over the cache's
    ``sk`` live keys, non-causal (Sk = 1 is the first step after a
    one-token prompt), GQA groups of 1 and 8 at yi-9b's head size; bf16
    at bf16's rounding, f32 at rtol = atol = 1e-4."""
    _need_card()
    rng = np.random.default_rng(sk * 10 + group)
    b, hkv, d = 4, 4, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype) for s in ((b, hkv * group, 1, d),
                                             (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=False, window=0, softcap=0.0, scale=d ** -0.5)
    before = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    assert LAUNCHES["flash_attention"] == before + 1
    exp = ref.attention_ref(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == exp.shape
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=tol[0],
                               atol=tol[1])


def _attention_blocks(cfg):
    """The blocks of ``cfg`` that launch K5: its g, l and a positions
    times the pattern's repeats."""
    return sum(ch in "gla" for ch in cfg.layer_pattern) * cfg.pattern_repeats


@pytest.mark.gpu
@pytest.mark.parametrize("arch,lengths", [("yi-9b", (1, 1, 1)),
                                          ("gemma2-27b", (20, 8, 5)),
                                          ("zamba2-1.2b", (5, 3, 7)),
                                          ("rwkv6-7b", (5, 3, 7))])
def test_cuda_engine_equals_cpu_port(arch, lengths):
    """A smoke config served on the card and on the CPU port with the same
    weights: equal tokens, every step's logits within rtol 1e-4 (f32
    compute; the f32 kernel is held to 1e-4 of the plain version), and
    flash attention launched for every attention block of every step
    (zamba2's shared block twice a step, rwkv6 never).  One-token
    prompts make the prefill a decode over one key; gemma2's 20-token
    prompt fills its 16-slot window ring from a longer sequence."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    _need_card()
    cfg, rt = configs.get_smoke(arch), Runtime()
    params = model.init_params(cfg, rt, torch.Generator().manual_seed(0),
                               "cpu")
    sc = ServeConfig(batch=4, max_len=32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in lengths]
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, rt, params, sc, device=dev)
        logits = []
        decode = eng.decode

        def rec(p, cache, toks, decode=decode, logits=logits):
            out = decode(p, cache, toks)
            logits.append(out[1].cpu().numpy())
            return out
        eng.decode = rec
        before = LAUNCHES["flash_attention"]
        outs = eng.run(prompts, max_new=6)
        runs[dev] = (outs, logits, LAUNCHES["flash_attention"] - before)
    assert runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][2] == _attention_blocks(cfg) * (1 + 6)
    assert runs["cpu"][2] == 0
    for g, c in zip(runs["cuda"][1], runs["cpu"][1]):
        np.testing.assert_allclose(g, c, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(c).max()))


# (b, h, hkv, sq, sk, d, dv, causal, window, softcap): K5's backward; the
# rows with dv < d hold V narrower than Q and K.
BWD_CASES = [(1, 4, 2, 200, 200, 64, 64, True, 0, 0.0),
             (2, 4, 1, 130, 130, 128, 128, False, 0, 0.0),
             (1, 2, 2, 300, 300, 96, 96, True, 50, 0.0),
             (1, 4, 2, 190, 190, 128, 128, True, 64, 50.0),
             (1, 2, 1, 100, 77, 200, 200, False, 0, 0.0),
             (1, 2, 1, 150, 60, 32, 32, True, 16, 0.0),     # rows 75.. dead
             (1, 8, 1, 130, 130, 256, 256, True, 0, 30.0),
             (2, 8, 1, 257, 257, 16, 16, True, 0, 0.0),     # GQA group 8
             (1, 4, 4, 1, 33, 128, 128, False, 0, 0.0),     # Sq 1
             (1, 8, 8, 256, 256, 192, 128, True, 0, 0.0),   # deepseek-v2 MLA
             (1, 4, 4, 96, 96, 24, 16, True, 0, 0.0),       # its smoke config
             (2, 4, 2, 130, 100, 64, 48, False, 0, 0.0),
             (1, 4, 2, 190, 190, 100, 36, True, 0, 0.0),    # no cp.async rows
             (1, 4, 4, 1, 33, 192, 128, False, 0, 0.0),     # a decode row
             (2, 4, 4, 300, 300, 64, 64, True, 100, 0.0),   # zamba2: D 64
             (1, 4, 4, 256, 256, 64, 64, True, 4096, 0.0),  # window >= S
             (1, 4, 2, 333, 333, 192, 128, True, 0, 0.0),   # MLA, ragged S
             (2, 4, 2, 150, 300, 64, 64, True, 32, 0.0),    # Sq != Sk
             (1, 4, 2, 120, 120, 80, 80, True, 0, 0.0),     # D 80 in 128
             (1, 2, 2, 100, 100, 160, 160, True, 0, 0.0),   # Dv 160 in 192
             (2, 4, 4, 300, 300, 80, 80, False, 0, 0.0),    # hubert: D 80
             (1, 14, 2, 190, 190, 128, 128, True, 0, 0.0)]  # group 7


def _bwd_inputs(b, h, hkv, sq, sk, d, dtype, seed, dv=None):
    """q, k, v and dO; v and dO ``dv`` wide (D by default)."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to("cuda", dtype) for s in ((b, h, sq, d), (b, hkv, sk, d),
                                          (b, hkv, sk, dv), (b, h, sq, dv))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,dv,causal,window,softcap",
                         BWD_CASES)
def test_cuda_flash_attention_bwd_matches_plain(dtype, tol, b, h, hkv, sq,
                                                sk, d, dv, causal, window,
                                                softcap):
    """K5's backward against its plain version on the same inputs (the
    kernel's forward output and log-sum-exp): |err| <= tol max|exp| per
    gradient, tol 1e-4 in f32 and 2e-2 in bf16 (both sum f32 products in
    other orders; bf16 rounds each gradient once); the forward's output
    (``dv`` wide) within 1e-4 (f32) or bf16's rounding (1e-2 |exp| +
    1e-3) of the plain version's and bitwise the output of a launch
    without the LSE; its LSE within 1e-4 of the plain version's,
    ``finfo(f32).min`` on dead rows."""
    from repro_torch.kernels.flash_attention import (_launch,
                                                     flash_attention_bwd)
    _need_card()
    q, k, v, do = _bwd_inputs(b, h, hkv, sq, sk, d, dtype, sq + d + h, dv)
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=d ** -0.5)
    out, lse = _launch(q, k, v, causal, window, softcap, d ** -0.5,
                       with_lse=True)
    assert out.shape == (b, h, sq, dv)
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    exp, lse_exp = ref.attention_ref(q, k, v, return_lse=True, **kw)
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-3)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_exp.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    before = LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert LAUNCHES["flash_attention_bwd"] == before + 1
    exp = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for name, g, e in zip("qkv", got, exp):
        assert g.dtype == dtype and g.shape == e.shape, name
        err = float((g.float() - e.float()).abs().max())
        assert err <= tol * float(e.float().abs().max()) + 1e-30, (name, err)
    if causal and window and sq > sk + window - 1:
        dead = sk + window - 1
        assert bool((lse[:, :, dead:] == ref.NEG_INF).all())
        assert bool((got[0][:, :, dead:] == 0).all())


def _misaligned(t):
    """A contiguous copy of ``t`` whose storage starts 2 bytes off 16-byte
    alignment: TMA cannot describe it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


# (route, dtype, (b, h, hkv, sq, sk, d, dv, causal, window, softcap),
# misaligned): one case of each backward route.
ROUTE_CASES = [
    ("wgmma-tma", torch.bfloat16, (2, 4, 2, 190, 190, 128, 128, True, 0, 0.0),
     False),
    ("wgmma-tma", torch.bfloat16, (1, 4, 2, 333, 333, 192, 128, True, 0, 0.0),
     False),
    ("wgmma-tma", torch.bfloat16, (2, 4, 4, 300, 300, 64, 64, True, 100, 0.0),
     False),
    ("wgmma-ldst", torch.bfloat16, (1, 4, 2, 190, 190, 100, 36, True, 0, 0.0),
     False),
    ("wgmma-ldst", torch.bfloat16, (1, 4, 2, 130, 130, 128, 128, True, 0,
                                    50.0), True),
    ("cuda-cores", torch.bfloat16, (1, 2, 1, 100, 77, 200, 200, False, 0, 0.0),
     False),
    ("tf32x3", torch.float32, (1, 4, 2, 190, 190, 128, 128, True, 64, 0.0),
     False),
    ("tf32x3", torch.float32, (1, 4, 2, 190, 190, 192, 128, True, 0, 0.0),
     True)]


@pytest.mark.gpu
@pytest.mark.parametrize("route,dtype,case,misaligned", ROUTE_CASES)
def test_cuda_flash_attention_bwd_route_and_repeats(route, dtype, case,
                                                    misaligned):
    """Each backward route launches where the rule says, and two launches
    on the same inputs give the same bits (no atomics, sums in a fixed
    order); the gradients hold the plain version's tolerance (2e-2 max|exp|
    in bf16, 1e-4 in f32)."""
    from repro_torch.kernels.flash_attention import (ROUTE_LAUNCHES, _launch,
                                                     flash_attention_bwd)
    _need_card()
    b, h, hkv, sq, sk, d, dv, causal, window, softcap = case
    q, k, v, do = _bwd_inputs(b, h, hkv, sq, sk, d, dtype, sq + d, dv)
    if misaligned:
        q, k, v, do = (_misaligned(t) for t in (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=d ** -0.5)
    out, lse = _launch(q, k, v, causal, window, softcap, d ** -0.5,
                       with_lse=True)
    before = dict(ROUTE_LAUNCHES)
    first = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    second = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert {r: n - before.get(r, 0) for r, n in ROUTE_LAUNCHES.items()
            if n != before.get(r, 0)} == {route: 2}
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    exp = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for name, g, e in zip("qkv", first, exp):
        err = float((g.float() - e.float()).abs().max())
        assert err <= tol * float(e.float().abs().max()) + 1e-30, (name, err)


# (b, h, hkv, sq, sk, d, dv, causal, window, softcap): f32 K5 forward and
# backward on the split-TF32 kernels, at each padded width (64, 128, 192 with
# V at 128, 192, 256) under causal, window, softcap, GQA and fully masked
# rows (sq > sk + window - 1).
F32_CASES = [(2, 4, 4, 300, 300, 64, 64, True, 100, 0.0),   # zamba2's D 64
             (1, 8, 2, 257, 257, 64, 64, True, 0, 0.0),     # GQA 4
             (1, 2, 1, 150, 60, 64, 48, True, 16, 0.0),     # rows 75.. dead
             (1, 8, 1, 190, 190, 128, 128, True, 64, 50.0),  # GQA 8, softcap
             (2, 4, 2, 130, 130, 128, 128, False, 0, 0.0),
             (1, 2, 1, 150, 60, 128, 128, True, 16, 0.0),   # rows 75.. dead
             (1, 4, 4, 333, 333, 192, 128, True, 0, 0.0),   # MLA, ragged S
             (1, 4, 2, 150, 60, 192, 128, True, 16, 30.0),  # dead, softcap
             (1, 4, 4, 1, 33, 192, 128, False, 0, 0.0),     # a decode row
             (1, 4, 2, 100, 77, 160, 160, False, 0, 0.0),   # D 192, Dv 192
             (1, 2, 1, 130, 130, 256, 256, True, 0, 30.0),  # D 256, GQA 2
             (1, 4, 2, 150, 60, 256, 256, True, 16, 0.0),   # rows 75.. dead
             (1, 4, 2, 120, 120, 100, 36, True, 0, 0.0)]    # no cp.async rows


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,dv,causal,window,softcap",
                         F32_CASES)
def test_cuda_flash_attention_f32_split_tf32(b, h, hkv, sq, sk, d, dv,
                                             causal, window, softcap):
    """f32 K5 on the tensor cores in split TF32: the forward within rtol =
    atol = 1e-4 of the plain version, its LSE within 1e-4 + 1e-5 |lse|
    (``finfo(f32).min`` and a zero output on fully masked rows), and the
    backward launched twice on route ``tf32x3``, the two launches bitwise
    equal, each gradient within 1e-4 of its largest."""
    from repro_torch.kernels.flash_attention import (ROUTE_LAUNCHES, _launch,
                                                     flash_attention_bwd)
    _need_card()
    q, k, v, do = _bwd_inputs(b, h, hkv, sq, sk, d, torch.float32,
                              sq * 3 + d + dv, dv)
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=d ** -0.5)
    before = LAUNCHES["flash_attention"]
    out, lse = _launch(q, k, v, causal, window, softcap, d ** -0.5,
                       with_lse=True)
    assert LAUNCHES["flash_attention"] == before + 1
    exp, lse_exp = ref.attention_ref(q, k, v, return_lse=True, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), exp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert bool(((lse - lse_exp).abs() <= 1e-4 + 1e-5 * lse_exp.abs()).all())
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    routes = dict(ROUTE_LAUNCHES)
    first = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    second = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert {r: n - routes.get(r, 0) for r, n in ROUTE_LAUNCHES.items()
            if n != routes.get(r, 0)} == {"tf32x3": 2}
    exp = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for name, a, c, e in zip("qkv", first, second, exp):
        assert torch.equal(a, c), name
        assert a.dtype == torch.float32 and a.shape == e.shape, name
        err = float((a - e).abs().max())
        assert err <= 1e-4 * float(e.abs().max()) + 1e-30, (name, err)
    if causal and window and sq > sk + window - 1:
        dead = sk + window - 1
        assert bool((lse[:, :, dead:] == ref.NEG_INF).all())
        assert bool((out[:, :, dead:] == 0).all())
        assert bool((first[0][:, :, dead:] == 0).all())


@pytest.mark.gpu
def test_cuda_flash_attention_autograd_launches_the_kernels():
    """Under autograd a CUDA attention runs one forward launch (with the
    LSE) and one backward launch, and gives the plain version's
    gradients."""
    _need_card()
    q, k, v, do = _bwd_inputs(2, 8, 2, 100, 100, 64, torch.float32, 5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]
    out = flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert LAUNCHES["flash_attention"] == f0 + 1
    assert LAUNCHES["flash_attention_bwd"] == b0 + 1
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    exp = torch.autograd.grad(ref.attention_ref(qc, kc, vc), (qc, kc, vc),
                              do.cpu())
    for g, e in zip(grads, exp):
        assert float((g.cpu() - e).abs().max()) <= 1e-4 * float(
            e.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_cuda_moe_engine_equals_cpu_port(arch):
    """The mixture-of-experts family's smoke configs served on the card and
    on the CPU port with the same weights (f32 compute): equal tokens,
    every decode step's logits within rtol 1e-4, K5 launched once a layer
    in the prefill and, for olmoe, once a layer a decode step (deepseek's
    absorbed decode launches none)."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    _need_card()
    cfg, rt = configs.get_smoke(arch), Runtime()
    params = model.init_params(cfg, rt, torch.Generator().manual_seed(0),
                               "cpu")
    prompts = [np.random.default_rng(2).integers(1, cfg.vocab, size=n)
               for n in (5, 3, 7)]
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, rt, params, ServeConfig(4, 32), device=dev)
        logits = []
        decode = eng.decode

        def rec(p, cache, toks, decode=decode, logits=logits):
            out = decode(p, cache, toks)
            logits.append(out[1].cpu().numpy())
            return out
        eng.decode = rec
        before = LAUNCHES["flash_attention"]
        outs = eng.run(prompts, max_new=6)
        runs[dev] = (outs, logits, LAUNCHES["flash_attention"] - before)
    per_step = 0 if cfg.mla is not None else cfg.n_layers
    assert runs["cuda"][2] == cfg.n_layers + 6 * per_step
    assert runs["cpu"][2] == 0
    assert runs["cuda"][0] == runs["cpu"][0]
    for g, c in zip(runs["cuda"][1], runs["cpu"][1]):
        np.testing.assert_allclose(g, c, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(c).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-27b", "olmoe-1b-7b",
                                  "deepseek-v2-236b", "zamba2-1.2b",
                                  "rwkv6-7b"])
def test_cuda_train_step_equals_cpu_port(arch):
    """A smoke config's loss and gradients, and one train step, on the
    card against the CPU port from the same parameters (f32 compute;
    zamba2's SSD at 40 tokens through ``ssd_chunked``): loss within rtol
    1e-5, every gradient leaf within 1e-4 of its largest (K5 and its
    backward hold 1e-4 to the plain version), K5 forward and backward
    launched once an attention block (none in rwkv6)."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model
    from repro_torch.train import optimizer, train_step
    _need_card()
    cfg, rt = configs.get_smoke(arch), Runtime()
    host = model.init_params(cfg, rt, torch.Generator().manual_seed(0),
                             "cpu")
    card = optimizer.tree_map(lambda t: t.cuda(), host)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 40)))
    f0, b0 = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]
    lg, _, gg = train_step.loss_and_grads(
        card, cfg, rt, {"tokens": tok.cuda(), "labels": tok.cuda()})
    assert LAUNCHES["flash_attention"] - f0 == _attention_blocks(cfg)
    assert LAUNCHES["flash_attention_bwd"] - b0 == _attention_blocks(cfg)
    lc, _, gc = train_step.loss_and_grads(
        host, cfg, rt, {"tokens": tok, "labels": tok})
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for a, b in zip(optimizer.tree_leaves(gg), optimizer.tree_leaves(gc)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    step = train_step.make_train_step(cfg, rt)
    out = {}
    for name, p, t in (("cuda", card, tok.cuda()), ("cpu", host, tok)):
        p, st, m = step(p, optimizer.adamw_init(p),
                        {"tokens": t, "labels": t})
        out[name] = (float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)


@pytest.mark.gpu
def test_cuda_multiring_all_reduce_two_gloo_ranks_on_one_card(tmp_path):
    """``multiring_all_reduce`` over 2 gloo ranks whose payloads lie on the
    card (staged through host buffers) gives the bits of the same call on
    CPU payloads, f32, int32 and bf16, 3 rings over an odd length."""
    from _torch_ranks import multiring_card_rank, run_ranks
    _need_card()
    rng = np.random.default_rng(5)
    xs = {"f32": rng.standard_normal((2, 1001)).astype(np.float32),
          "i32": rng.integers(-500, 500, (2, 1001)).astype(np.int32),
          "bf16": rng.standard_normal((2, 1001)).astype(np.float32)}
    for out in run_ranks(multiring_card_rank, 2, tmp_path, xs, timeout=120):
        for name, (card, host) in out.items():
            np.testing.assert_array_equal(card, host, err_msg=name)


@pytest.mark.gpu
def test_cuda_model_region_two_gloo_ranks_on_one_card(tmp_path):
    """The model region's autograd functions (tensor parallelism) over 2
    gloo ranks whose tensors lie on the card give, forward and backward,
    the bits of the same calls on CPU tensors."""
    from _torch_ranks import model_region_card_rank, run_ranks
    _need_card()
    rng = np.random.default_rng(6)
    xs = {"x": rng.standard_normal((2, 3, 8, 5)).astype(np.float32),
          "g": rng.standard_normal((2, 3, 8, 5)).astype(np.float32)}
    for out in run_ranks(model_region_card_rank, 2, tmp_path, xs,
                         timeout=120):
        assert out.pop("staged")
        for name, ((y_card, dx_card), (y_host, dx_host)) in out.items():
            np.testing.assert_array_equal(y_card, y_host, err_msg=name)
            np.testing.assert_array_equal(dx_card, dx_host, err_msg=name)
