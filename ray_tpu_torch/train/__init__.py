"""ray_tpu_torch.train — the Train-equivalent library (PyTorch port of
``ray_tpu.train``): SPMD over one ``torch.distributed`` process group.

    from ray_tpu_torch import train
    from ray_tpu_torch.train import (
        TorchTrainer, ScalingConfig, RunConfig, CheckpointConfig,
        FailureConfig, Checkpoint, Result, session,
    )

    def loop(config):
        mesh = train.session.make_mesh()
        device = train.session.get_device()
        ...
        train.session.report({"loss": l}, checkpoint=...)

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=4)
    ).fit()

Also the sharded async checkpoints of train states
(``sharded_checkpoint``), exported lazily: ``import ray_tpu_torch.train``
loads no torch.
"""

from ray_tpu_torch.train import session  # noqa: F401
from ray_tpu_torch.train.checkpoint import (  # noqa: F401
    Checkpoint,
    CheckpointManager,
)
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.trainer import (  # noqa: F401
    DataParallelTrainer,
    TorchTrainer,
    TrainingFailedError,
)

_SHARDED = ("ShardedSaveHandle", "checkpoint_step", "is_committed",
            "load_sharded", "save_sharded", "upload_sharded_checkpoint",
            "download_sharded_checkpoint")


def __getattr__(name):
    # lazy: the sharded checkpoints are torch's; the rest of Train (and a
    # Tune driver, which reports through its session) loads no torch
    if name in _SHARDED:
        from ray_tpu_torch.train import sharded_checkpoint

        return getattr(sharded_checkpoint, name)
    raise AttributeError(name)


__all__ = [
    "TorchTrainer",
    "DataParallelTrainer",
    "ScalingConfig",
    "RunConfig",
    "CheckpointConfig",
    "FailureConfig",
    "Checkpoint",
    "CheckpointManager",
    "Result",
    "TrainingFailedError",
    "ShardedSaveHandle",
    "checkpoint_step",
    "is_committed",
    "save_sharded",
    "load_sharded",
    "upload_sharded_checkpoint",
    "download_sharded_checkpoint",
    "session",
]
