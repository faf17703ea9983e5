"""The order the card's water-filling kernel sums links in, checked on the
CPU: the link plan lists each link's live (flow, slot) positions in flat
row-major order, summing in plan order is the plain version's
``index_add_`` bitwise, and the plain version's fused ``acc + d * s`` is
the exactly rounded FMA that XLA's CPU contraction computes."""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import transport
from repro_torch.experiments import Session
from repro_torch.kernels import ref
from repro_torch.kernels.waterfill import link_plan


def _random_stack(n_layers, f, s, e, seed):
    """(L, F, S) link ids with repeats inside a row, -1 slots, the trash
    link and ids out of range, and slots that hold the same link in every
    layer (as a NIC slot does)."""
    rng = np.random.default_rng(seed)
    stack = rng.integers(0, e - 1, (n_layers, f, s)).astype(np.int32)
    stack[:, :, 1] = stack[:, :, 0]                 # one link twice a row
    stack[:, :, -1] = stack[0, :, -1]               # shared across layers
    stack[rng.random(stack.shape) < 0.15] = -1
    stack[rng.random(stack.shape) < 0.05] = e - 1
    stack[rng.random(stack.shape) < 0.02] = e + 3
    return stack


def _live_flows(offsets, entries, layer, send):
    """Per link, the flows of its live plan entries, in plan order."""
    off = offsets.numpy().astype(np.int64)
    ent = entries.numpy()
    flow = (ent & 0xFFFFFFFF).astype(np.int64)
    mask = (ent >> 32) & 0xFFFFFFFF
    live = send[flow] & (((mask >> layer[flow]) & 1) == 1)
    return [flow[off[i]:off[i + 1]][live[off[i]:off[i + 1]]]
            for i in range(len(off) - 1)]


def _gathered_flows(stack, layer, send, e):
    """Per link, the flows of the flat (flow, slot) positions that hold it
    in each flow's current layer, stable-sorted by link."""
    f, s = stack.shape[1:]
    edges = stack[layer, np.arange(f)]
    flat = np.where(send[:, None], edges, -1).reshape(-1)
    pos = np.argsort(flat, kind="stable")
    pos = pos[(flat[pos] >= 0) & (flat[pos] < e - 1)]
    by_link = [[] for _ in range(e)]
    for p in pos:
        by_link[flat[p]].append(p // s)
    return [np.asarray(x, np.int64) for x in by_link]


def _cell_stack():
    ses = Session(device="cpu")
    cell = ses.resolve(ses.grid(["sf(q=5)"], ["fatpaths(n_layers=9,rho=0.6)"],
                                ["permutation"])[0])
    cfg = transport.SimConfig(balancing=cell.bundle.balancing, n_steps=16)
    arrs, static = transport.prepare(cell.topo, cell.bundle.routing,
                                     cell.workload, cfg, device="cpu")
    return arrs, static[0]


@pytest.mark.parametrize("n_layers,f,s,e,seed",
                         [(1, 40, 5, 23, 0), (4, 300, 6, 97, 1),
                          (9, 500, 9, 61, 2), (32, 64, 4, 17, 3)])
def test_link_plan_lists_live_positions_in_flat_order(n_layers, f, s, e,
                                                      seed):
    stack = _random_stack(n_layers, f, s, e, seed)
    offsets, entries, n_flows = link_plan(torch.from_numpy(stack), e)
    assert n_flows == f
    assert offsets.dtype == torch.int32 and offsets.shape == (e + 1,)
    assert entries.dtype == torch.int64
    # The trash link and ids out of range have no entries; a slot that
    # holds one link in every layer is one entry.
    assert int(offsets[e - 1]) == int(offsets[e]) == entries.numel()
    valid = (stack >= 0) & (stack < e - 1)
    assert entries.numel() < valid.sum() or n_layers == 1
    rng = np.random.default_rng(seed + 100)
    for _ in range(4):
        layer = rng.integers(0, n_layers, f)
        send = rng.random(f) < 0.8
        got = _live_flows(offsets, entries, layer, send)
        exp = _gathered_flows(stack, layer, send, e)
        for link in range(e):
            np.testing.assert_array_equal(got[link], exp[link],
                                          err_msg=f"link {link}")


def test_link_plan_of_the_cell_is_the_scans():
    """``prepare`` stores the plan of its own path-edge stack."""
    arrs, e_tot = _cell_stack()
    offsets, entries, _ = link_plan(arrs["path_edges"], e_tot)
    assert torch.equal(offsets, arrs["plan_offsets"])
    assert torch.equal(entries, arrs["plan_entries"])
    assert entries.numel() < int((arrs["path_edges"] >= 0).sum())


@pytest.mark.parametrize("source", ["sf5-cell", "random"])
def test_summing_in_plan_order_is_index_add(source):
    """A numpy f32 loop over each link's live plan entries, in order,
    equals the plain version's ``index_add_`` bitwise: so the CPU sums
    in flat (flow, slot) order, the order the card's kernel takes."""
    if source == "random":
        stack = _random_stack(6, 400, 7, 31, 5)
        e = 31
        offsets, entries, _ = link_plan(torch.from_numpy(stack), e)
    else:
        arrs, e = _cell_stack()
        stack = arrs["path_edges"].numpy()
        offsets, entries = arrs["plan_offsets"], arrs["plan_entries"]
    n_layers, f, _ = stack.shape
    rng = np.random.default_rng(7)
    differs = 0
    for _ in range(3):
        layer = rng.integers(0, n_layers, f)
        send = rng.random(f) < 0.85
        val = (rng.random(f) * 10.0 ** rng.integers(-4, 4, f)).astype(
            np.float32)
        edges = stack[layer, np.arange(f)]
        idx = np.where(send[:, None] & (edges >= 0) & (edges < e), edges,
                       e - 1).astype(np.int64)
        exp = ref._scatter_add(e, torch.from_numpy(idx),
                               torch.from_numpy(val)[:, None].expand(
                                   idx.shape)).numpy()
        for link, flows in enumerate(_live_flows(offsets, entries, layer,
                                                 send)):
            acc = rev = np.float32(0.0)
            for fl in flows:
                acc = np.float32(acc + val[fl])
            for fl in flows[::-1]:
                rev = np.float32(rev + val[fl])
            if link < e - 1:
                assert acc.view(np.int32) == exp[link].view(np.int32), link
                differs += int(rev != acc)
    if source == "random":
        assert differs > 0          # the order is what makes it bitwise


def _round_f32(x: Fraction) -> np.float32:
    """An exact rational rounded to the nearest f32, ties to even."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1, -x) if x < 0 else (1, x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    e = max(e, -126)
    q = x / Fraction(2) ** (e - 23)
    n, rem = divmod(q.numerator, q.denominator)
    half = Fraction(rem, q.denominator) - Fraction(1, 2)
    if half > 0 or (half == 0 and n % 2):
        n += 1
    return np.float32(sign * float(n) * 2.0 ** (e - 23))


def _ties(n, seed):
    """Triples whose float64 sum ``a + b*c`` is an f32 midpoint that the
    exact sum misses by less than half a float64 ulp: a = m (1 + k 2^-23),
    b*c = m 2^-24 (1 - 2^-46), in both signs and at many scales."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.integers(-60, 60, n)
    sign = rng.choice([-1.0, 1.0], n)
    k = rng.integers(0, 2 ** 22, n)
    a = (sign * scale * (1 + k * 2.0 ** -23)).astype(np.float32)
    b = (1 + 2.0 ** -23) * np.ones(n)
    c = (sign * scale * 2.0 ** -24 * (1 - 2.0 ** -23))
    return a, b.astype(np.float32), c.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_fused_add_mul_is_the_rounded_exact_fma(kind):
    rng = np.random.default_rng(11)
    if kind == "random":
        n = 100_000
        a = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
        b = rng.standard_normal(n)
        c = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
        a, b, c = (x.astype(np.float32) for x in (a, b, c))
    else:
        a, b, c = _ties(2000, 12)
    got = ref.fused_add_mul(*(torch.from_numpy(x) for x in (a, b, c)))
    got = got.numpy()
    exp = np.array([_round_f32(Fraction(float(x)) + Fraction(float(y))
                               * Fraction(float(z)))
                    for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), exp.view(np.int32))
    xla = np.asarray(jax.jit(lambda x, y, z: x + y * z)(a, b, c))
    np.testing.assert_array_equal(got.view(np.int32), xla.view(np.int32))
    twice = a + b * c
    if kind == "ties":              # float64 then f32 rounds every tie wrong
        f64 = (a.astype(np.float64) + b.astype(np.float64)
               * c.astype(np.float64)).astype(np.float32)
        assert (f64 != exp).mean() > 0.4
    assert (twice != exp).any()
