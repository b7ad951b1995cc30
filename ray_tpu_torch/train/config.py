"""Train-equivalent configuration dataclasses (PyTorch port of
``ray_tpu/train/config.py``).

Parity: reference ``python/ray/air/config.py`` (ScalingConfig:91,
RunConfig:705, CheckpointConfig:575, FailureConfig:524). The unit of
scaling is one ``torch.distributed`` rank per worker process, on one card
(or the CPU); ``ScalingConfig.mesh`` says how the ranks are factored into
the dp/pp/ep/sp/tp axes of one device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:  # the mesh module loads torch; a tune driver needs none
    from ray_tpu_torch.parallel.mesh import MeshConfig


@dataclasses.dataclass
class ScalingConfig:
    """How many workers to gang-start and how they mesh together.

    num_workers: worker processes, one rank each. Each joins one
        ``torch.distributed`` process group and owns one device.
    use_gpu: request one ``GPU`` per worker (the worker runs on the card
        its lease names). The port runs on the card unless asked not to:
        a CPU run passes ``use_gpu=False``.
    resources_per_worker: extra scheduler resources per worker.
    mesh: factorization of the ranks into mesh axes; ``None`` = pure DP.
    """

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh: Optional[MeshConfig] = None
    # Gang placement: reserve one bundle per worker via a placement group
    # before starting (None = schedule workers individually). STRICT_SPREAD
    # = one worker per node.
    placement_strategy: Optional[str] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", 1.0)
        return res


@dataclasses.dataclass
class CheckpointConfig:
    """Keep-N / scoring policy for persisted checkpoints
    (parity: air/config.py:575)."""

    num_to_keep: Optional[int] = None  # None = keep all
    checkpoint_score_attribute: Optional[str] = None  # None = recency
    checkpoint_score_order: str = "max"  # max | min

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclasses.dataclass
class FailureConfig:
    """Trainer-level fault tolerance (parity: air/config.py:524).

    max_failures: group restarts (from latest checkpoint) before giving up;
    -1 = unlimited.
    """

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    # default: <tmp>/raytpu_torch/results, beside the port's sessions
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig
    )


@dataclasses.dataclass
class Result:
    """What ``TorchTrainer.fit`` returns (parity: air Result)."""

    metrics: Dict[str, Any]
    checkpoint: Optional["Checkpoint"]  # noqa: F821 (train.checkpoint)
    path: Optional[str] = None
    error: Optional[BaseException] = None
