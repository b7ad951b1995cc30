"""Logical plan optimization for ray_tpu_torch.data.

Parity: reference ``python/ray/data/_internal/logical/`` — the logical
operator DAG plus rewrite rules, of which the load-bearing one is
OperatorFusionRule (``logical/rules/operator_fusion.py``): adjacent 1:1
map operators with compatible compute strategies become ONE physical
operator, so a ``read -> map -> filter -> map_batches`` chain costs one
task launch per block instead of four.

The Dataset's stage chain IS its logical plan here (1:1 ``Stage`` and
all-to-all ``ExchangeStage`` nodes); :func:`optimize` applies fusion and
returns the physical stage list the StreamingExecutor runs.
``Dataset.explain()`` shows both plans.
"""

from __future__ import annotations

from typing import Any, List

from ray_tpu_torch.data.streaming import ExchangeStage, Stage


class FusedStage(Stage):
    """N adjacent task-pool map stages run as one physical stage: the
    fused fn applies each child in order, doing that child's batch-format
    conversion at its boundary (semantically identical to staged
    execution — minus N-1 remote task launches and block hand-offs per
    block)."""

    def __init__(self, stages: List[Stage]):
        self.fused = list(stages)

        def fused_fn(block, _children=tuple(self.fused)):
            from ray_tpu_torch.data.block import BlockAccessor

            for child in _children:
                if child.batch_format is None:
                    arg = block
                else:
                    acc = BlockAccessor.for_block(block)
                    arg = (
                        acc.to_rows()
                        if child.batch_format == "rows"
                        else acc.to_numpy_batch()
                    )
                block = BlockAccessor.batch_to_block(child.fn(arg))
            return block

        super().__init__(
            name="+".join(s.name for s in stages),
            fn=fused_fn,
            num_cpus=max(s.num_cpus for s in stages),
            batch_format=None,  # fused_fn handles per-child conversion
        )

    def __repr__(self):
        return f"FusedStage({self.name})"


def _fusable(stage: Any) -> bool:
    """Task-pool 1:1 maps fuse; actor pools (stateful UDFs pinned to
    their pool), with_index stages (limit bookkeeping) and exchanges (a
    barrier by nature) do not — matching the reference rule's
    compatibility checks."""
    return (
        isinstance(stage, Stage)
        and not isinstance(stage, ExchangeStage)
        and stage.compute is None
        and not stage.with_index
    )


def optimize(stages: List[Any]) -> List[Any]:
    """Apply operator fusion; pure function of the logical stage list."""
    out: List[Any] = []
    run: List[Stage] = []

    def flush():
        if len(run) == 1:
            out.append(run[0])
        elif run:
            out.append(FusedStage(run))
        run.clear()

    for s in stages:
        if _fusable(s):
            run.append(s)
        else:
            flush()
            out.append(s)
    flush()
    return out


def explain(dataset) -> str:
    """Two-section plan description (reference Dataset.explain shape)."""
    logical = " -> ".join(s.name for s in dataset._stages) or "(source)"
    physical = " -> ".join(
        (f"Fused[{s.name}]" if isinstance(s, FusedStage) else s.name)
        for s in optimize(dataset._stages)
    ) or "(source)"
    return (
        f"Logical plan:  source({dataset._num_source_blocks()} blocks)"
        f" -> {logical}\n"
        f"Physical plan: source -> {physical}"
    )
