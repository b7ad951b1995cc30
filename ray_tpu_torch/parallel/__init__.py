"""Training on the card: the train state, the train step and the optimizer,
ported from ``ray_tpu.parallel.train_step`` (one device; no mesh yet)."""

from ray_tpu_torch.parallel.train_step import (  # noqa: F401
    ClippedAdamW,
    TrainState,
    TrainStep,
    default_optimizer,
    make_sharded_state,
    make_train_step,
)
