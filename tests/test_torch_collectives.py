"""The port's stride-ring collectives (``repro_torch.dist.collectives``)
on 8 gloo ranks against the JAX package's on 8 forced host devices.

The JAX package's side runs once, in one subprocess, over the mesh of its
own ``repro.launch.mesh.make_mesh``; the port's 8 ranks run once per
module (``tests/_torch_ranks.py``).  Rank ``r`` at mesh position ``j``
takes row ``j`` of each input, as ``shard_map`` hands device ``j`` its
block.  f32 and int32 payloads are held bitwise: the port keeps the JAX
package's order of adds, padding and ring interleave.  The bf16 wire
adds in bf16 on the port and in f32 on XLA:CPU, which hoists the casts
out of its rings (``train/manual_dp.py``'s note): within (n - 1) 2^-8
of the sum of the magnitudes.
"""

import math

import numpy as np
import pytest

from _torch_ranks import collectives_rank, run_ranks, run_reference
from repro.dist import collectives as jcoll
from repro_torch.dist import collectives as tcoll

WORLD = 8
ORDER = np.array([3, 1, 4, 0, 6, 2, 7, 5])

_PROG = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist.collectives import (multiring_all_reduce, layer_strides,
                                    ring_reduce_scatter, ring_all_gather)
from repro.launch.mesh import make_mesh

n = 8
order = np.array([int(c) for c in sys.argv[2].split(",")])


def sm(f, x, mesh=None, axis="data"):
    mesh = mesh or make_mesh((n,), ("data",))
    return np.asarray(jax.jit(jax.shard_map(
        lambda v: f(v.reshape(v.shape[1:]))[None], mesh=mesh,
        in_specs=P(axis), out_specs=P(axis)))(x))


rng = np.random.default_rng(0)
xf = (jnp.arange(n * 53, dtype=jnp.float32).reshape(n, 53) * 0.37) - 11.0
xi = jnp.asarray(rng.integers(-1000, 1000, size=(n, 53), dtype=np.int32))
xb = jnp.asarray(rng.standard_normal((n, 53)).astype(np.float32)
                 ).astype(jnp.bfloat16)
y = jnp.asarray(rng.standard_normal((n, 24)).astype(np.float32))
out = {}
for r in (1, 2, 3, 5):
    st = layer_strides(n, r)
    f = lambda v, st=st: multiring_all_reduce(v, "data", st)
    out[f"f32_{r}"] = sm(f, xf)
    out[f"i32_{r}"] = sm(f, xi)
    out[f"bf16_{r}"] = sm(f, xb).astype(np.float32)
out["rs5"] = sm(lambda v: ring_reduce_scatter(v, "data", 5), y)
out["ag5"] = sm(lambda v: ring_all_gather(ring_reduce_scatter(v, "data", 5),
                                          "data", 5, chunk_offset=5), y)
out["tuple_3"] = sm(
    lambda v: multiring_all_reduce(v, ("pod", "data"), layer_strides(n, 3)),
    xf, make_mesh((2, n // 2), ("pod", "data")), ("pod", "data"))
out["perm_2"] = sm(
    lambda v: multiring_all_reduce(v, "data", layer_strides(n, 2)), xf,
    make_mesh((n,), ("data",), device_order=order))
np.savez(sys.argv[1], xf=np.asarray(xf), xi=np.asarray(xi),
         xb=np.asarray(xb.astype(jnp.float32)), y=np.asarray(y), **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("coll_ref")
    return run_reference(_PROG, WORLD, d / "ref.npz",
                         ",".join(map(str, ORDER)), timeout=120)


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    inputs = {k: ref[k] for k in ("xf", "xi", "xb", "y")}
    return run_ranks(collectives_rank, WORLD,
                     tmp_path_factory.mktemp("coll_pg"), inputs, ORDER,
                     timeout=90)


@pytest.mark.parametrize("payload", ["f32", "i32"])
@pytest.mark.parametrize("rings", [1, 2, 3, 5])
def test_multiring_all_reduce_bitwise(ref, port, payload, rings):
    key = f"{payload}_{rings}"
    for rank, out in enumerate(port):
        assert out[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(out[key], ref[key][rank],
                                      err_msg=f"rank {rank}")


def test_reduce_scatter_all_gather_stride5_bitwise(ref, port):
    for rank, out in enumerate(port):
        np.testing.assert_array_equal(out["rs5"], ref["rs5"][rank])
        np.testing.assert_array_equal(out["ag5"], ref["ag5"][rank])


@pytest.mark.parametrize("rings", [1, 2, 3, 5])
def test_bf16_wire_within_its_rounding(ref, port, rings):
    bound = (WORLD - 1) * 2.0 ** -8 * np.abs(ref["xb"]).sum(0)
    for rank, out in enumerate(port):
        err = np.abs(out[f"bf16_{rings}"] - ref[f"bf16_{rings}"][rank])
        assert np.all(err <= bound), (rank, float(err.max()))


def test_axis_tuple_and_permuted_mesh_bitwise(ref, port):
    """A ring over ``("pod", "data")`` of a (2, 4) mesh (row-major), and
    a 1-D mesh whose device order puts rank ``ORDER[j]`` at position
    ``j``."""
    for rank, out in enumerate(port):
        np.testing.assert_array_equal(out["tuple_3"], ref["tuple_3"][rank])
        j = out["pos_perm"]
        assert ORDER[j] == rank
        np.testing.assert_array_equal(out["perm_2"], ref["perm_2"][j])


def test_one_rank_shortcut_and_stride_guard(port):
    for out in port:
        assert out["n1"]
        assert out["raised"] == [True, True, True]


def test_layer_strides_match_reference():
    for n in (1, 4, 8, 16, 32, 256, 100):
        for k in (1, 3, 4, 9):
            assert tcoll.layer_strides(n, k) == jcoll.layer_strides(n, k)
            assert all(math.gcd(s, n) == 1 for s in tcoll.layer_strides(n, k)
                       if n > 1)
