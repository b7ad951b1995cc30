"""Parallelism on the card: device meshes and sharding rules
(``parallel/mesh.py``), the train state, the train step and the optimizer
over one device or a mesh (``parallel/train_step.py``), and pipeline
parallelism over the mesh's pp axis (``parallel/pipeline.py``), ported from
``ray_tpu.parallel``."""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    DEFAULT_RULES,
    FSDP_RULES,
    AxisRules,
    MeshConfig,
    build_mesh,
    logical_to_placements,
    shard_box,
    shardings_for,
)
from ray_tpu_torch.parallel.train_step import (  # noqa: F401
    ClippedAdamW,
    TrainState,
    TrainStep,
    batch_sharding,
    default_optimizer,
    make_sharded_state,
    make_train_step,
)
from ray_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_train_step,
    pipeline_grads_1f1b,
    pipeline_loss_fn,
)
