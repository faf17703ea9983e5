"""The port's training launcher's ``main`` on the JAX package's initial
parameters, for ``torchrun`` in ``tests/test_torch_dp.py``:

  torchrun --standalone --nproc-per-node 4 tests/_torch_launch.py \\
      init.npz --arch yi-9b --smoke --device cpu --mesh 4 ...

``TrainLoop.init_state`` is replaced by one that carries the arrays of
``init.npz`` (named ``init/a/b/...``) across through
``repro_torch.interop`` and keeps the rank's shards, as
``tests/test_torch_train_loop.py`` does on one device; everything else is
the launcher's own.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ranks import nested  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.dist.sharding import tree_map_specs  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train import loop, optimizer  # noqa: E402
from repro_torch.train.train_step import param_spec_tree  # noqa: E402


def init_state(self, seed=0):
    with np.load(sys.argv[1]) as z:
        tree = nested({k: z[k] for k in z.files}, "init")
    params = interop.model_params_from_arrays(self.cfg, tree, self.device)
    pspecs = param_spec_tree(self.cfg, self.rt, params)
    params = tree_map_specs(lambda p, s: self.rt.local(p, s).clone(),
                            params, pspecs)
    self.specs = {"params": pspecs, "opt": optimizer.opt_specs(pspecs)}
    return {"params": params, "opt": optimizer.adamw_init(params)}


if __name__ == "__main__":
    loop.TrainLoop.init_state = init_state
    launch.main(sys.argv[2:])
