"""Training support, ported from ``ray_tpu.train``: sharded async
checkpoints of train states."""

from ray_tpu_torch.train.sharded_checkpoint import (  # noqa: F401
    ShardedSaveHandle,
    checkpoint_step,
    is_committed,
    load_sharded,
    save_sharded,
)
