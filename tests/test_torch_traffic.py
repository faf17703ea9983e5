"""The port's flow workloads against the JAX package's, and the device
rule of the traffic entry points: ``worstcase`` computes its router
distances on the card unless the caller asks for the CPU, and without a
card that default raises; the other patterns are built with numpy and
need no device."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import topology as j_topo
from repro.core import traffic as j_traffic
from repro_torch.core import topology, traffic

NUMPY_PATTERNS = ("uniform", "permutation", "offdiag", "shuffle",
                  "alltoone", "adversarial", "stencil")


def _assert_same_workload(ours, theirs):
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


@pytest.mark.parametrize("seed", [0, 3])
def test_worstcase_on_cpu_matches_jax(seed):
    ours = traffic.make_workload(topology.slim_fly(5), "worstcase",
                                 seed=seed, device="cpu")
    theirs = j_traffic.make_workload(j_topo.slim_fly(5), "worstcase",
                                     seed=seed)
    _assert_same_workload(ours, theirs)


def test_worstcase_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is there, so the default does not raise")
    topo = topology.slim_fly(5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traffic.make_workload(topo, "worstcase")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traffic.worst_case(topo)


@pytest.mark.parametrize("pattern", NUMPY_PATTERNS)
def test_numpy_patterns_need_no_device(pattern):
    ours = traffic.make_workload(topology.slim_fly(5), pattern, n_rounds=2,
                                 seed=1)
    theirs = j_traffic.make_workload(j_topo.slim_fly(5), pattern, n_rounds=2,
                                     seed=1)
    _assert_same_workload(ours, theirs)
