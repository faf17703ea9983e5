"""Training of the dense family on one device: AdamW, the train step and
the fault-tolerant loop (the port of the JAX package's ``train``)."""

from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .train_step import (TrainConfig, make_train_state,  # noqa: F401
                         make_train_step)
