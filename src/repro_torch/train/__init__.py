"""Training: AdamW, the train step (one device or data parallel on a
mesh), manual data parallelism over the stride rings, and the
fault-tolerant loop (the port of the JAX package's ``train``)."""

from .manual_dp import ManualDPConfig, make_manual_dp_step  # noqa: F401
from .optimizer import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                        opt_specs)
from .train_step import (TrainConfig, make_train_state,  # noqa: F401
                         make_train_step)
