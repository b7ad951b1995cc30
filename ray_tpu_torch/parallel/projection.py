"""A 32-card H100 cluster's GPT-J-6B training projection, from the port's
own train step.

The north-star train workload (a GPT-J-6B fine-tune) needs a cluster of
cards; one card measures one piece of it. Rather than leave the number
unmeasurable, this module:

1. **Counts the FLOPs each rank runs in the port's real train step**
   (``make_train_step`` over a ``DeviceMesh``, or
   ``make_pipeline_train_step`` when pp > 1). One process stands as rank 0
   of the mesh through torch's fake process group (its collectives move
   nothing), and ``torch.utils.flop_counter.FlopCounterMode`` counts the
   products that rank runs. On ``device="meta"`` no parameter
   materializes.
2. **Validates the analytic FLOP model against that count** (``run_probe``;
   the tests assert agreement), so the scale-out arithmetic stands on a
   count of the step that runs, not on a formula alone.
3. **Combines it with published H100 SXM figures and an efficiency anchor
   measured on the card** (``chip_smoke.py projection``: a GPT-J-width
   train step of one pipeline stage's depth) into a stated MFU for 32
   cards, with every assumption listed in the result.

Run: ``python -m ray_tpu_torch.parallel.projection`` (the probe runs on the
card; ``--device meta`` runs it with no card).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional

# ---- hardware model (stated assumptions; published H100 SXM figures) ----
H100_SXM = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,  # dense, no sparsity
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
    # four nodes of eight cards
    "devices": 32,
    "devices_per_node": 8,
    # NVLink 4: 450 GB/s each way per card to the node's NVSwitches
    "intra_node_link": "NVLink 4",
    "intra_node_bytes_per_s": 450e9,
    # one 400 Gb/s InfiniBand NDR link per card between nodes
    "inter_node_link": "InfiniBand NDR",
    "inter_node_bytes_per_s": 50e9,
    # links a ring collective's traffic spreads over, each way: one, since
    # a card's NVLink rate and its NIC's rate are already per card
    "ring_links": 1,
}

# The per-device matmul stream's fraction of peak, measured on the card:
# the mean graph-replay MFU (``analytic_train_flops`` over 989 TFLOP/s) of
# ``chip_smoke.py projection``'s anchor step (GPT-J-6B width, 7 layers = one
# stage of the projected layout, flash at d_head 256, remat "dots", [4,
# 2048]): 0.32665 at 254.79 ms a replay on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md §6, the projection phase's first run).
GPTJ_STAGE_MFU = 0.3266
GPTJ_STAGE_MFU_BASIS = (
    "measured MFU of a GPT-J-6B-width train step of one stage's depth (7 "
    "layers, flash at d_head 256, remat 'dots', [4, 2048]) on an NVIDIA "
    "H100 80GB HBM3 at 700.00 W (chip_smoke.py projection; PERF.md §6)")


def _init_process_group(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks: every collective returns at once and moves nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "extract_device_cost stands as rank 0 of a fake process group of "
            "its own; destroy the current process group first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _sharded_state(config, mesh, optimizer, device, rules=None):
    """(state, state_shardings) as ``train_step.make_sharded_state`` lays
    them out over ``mesh``, with the parameters made on ``device`` (on
    "meta": shapes only, so a 6B state never allocates memory)."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from ray_tpu_torch.models.transformer import (
        init_params,
        param_logical_axes,
    )
    from ray_tpu_torch.parallel.mesh import DEFAULT_RULES, shardings_for
    from ray_tpu_torch.parallel.train_step import TrainState, _tree_zip

    rules = rules or DEFAULT_RULES
    params = init_params(config, 0, device)
    placements = _tree_zip(lambda _, pl: pl, params, shardings_for(
        mesh, rules, param_logical_axes(config)))
    params = _tree_zip(
        lambda t, pl: distribute_tensor(
            t, mesh, pl, src_data_rank=None).requires_grad_(True),
        params, placements)
    state = TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params, opt_state=optimizer.init(params))
    replicated = (Replicate(),) * mesh.ndim
    return state, TrainState(step=replicated, params=placements,
                             opt_state=placements)


def extract_device_cost(
    config,
    axes: Dict[str, int],
    *,
    batch_size: int,
    seq: int,
    microbatches: int = 8,
    schedule: str = "1f1b",
    device=None,
) -> Dict[str, Any]:
    """Runs one eager step of the port's train step over ``axes`` as rank 0
    of a fake process group of ``prod(axes)`` ranks, on ``device`` (CUDA by
    default; "meta" makes nothing), and returns the FLOPs that rank ran
    (``FlopCounterMode``: the products and attention each rank computes on
    its own shards; the fake group's collectives add none). With pp > 1 the
    step is ``make_pipeline_train_step``'s, whose stage sends take no meta
    tensors: it needs a CPU or CUDA device."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from ray_tpu_torch.parallel.train_step import (
        default_optimizer,
        make_train_step,
    )

    dev = resolve_device(device)
    if axes.get("pp", 1) > 1 and dev.type == "meta":
        raise ValueError("a pipelined step's stage sends take no meta "
                         "tensors: count pp > 1 on a CPU or CUDA device")
    n = math.prod(axes.values())
    _init_process_group(n)
    try:
        mesh = build_mesh(MeshConfig(**axes),
                          device_type="cuda" if dev.type == "cuda" else "cpu")
        opt = default_optimizer()
        state, state_sh = _sharded_state(config, mesh, opt, dev)
        if axes.get("pp", 1) > 1:
            step = make_pipeline_train_step(
                config, opt, microbatches, mesh=mesh,
                state_shardings=state_sh, schedule=schedule)
        else:
            step = make_train_step(config, opt, mesh=mesh,
                                   state_shardings=state_sh)
        tokens = torch.zeros((batch_size, seq), dtype=torch.int64,
                             device=dev)
        batch = {"tokens": tokens, "targets": tokens,
                 "mask": torch.ones((batch_size, seq), device=dev)}
        with FlopCounterMode(display=False) as counter:
            step.eager(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        by_op = {str(op): int(f) for op, f in
                 counter.get_flop_counts()["Global"].items()}
        del state, step, batch
    finally:
        dist.destroy_process_group()
    return {
        "flops_per_device": float(counter.get_total_flops()),
        "flops_by_op": by_op,
        "flops_basis": (
            f"FlopCounterMode over one eager train step on {dev.type}, run "
            f"as rank 0 of a fake process group of {n} ranks (the products "
            "and attention that rank computes on its shards)"),
        "devices": n,
        "batch_size": batch_size,
        "seq": seq,
        "microbatches": microbatches,
        "schedule": schedule,
    }


def analytic_train_flops(config, tokens: int, seq: int) -> float:
    """Matmul training FLOPs (the standard MFU numerator): 6 per
    matmul-param per token — the embedding table is a GATHER, not a
    matmul, so it is excluded (PaLM-appendix convention; a count of the
    step's products leaves it out the same way, which is what lets the
    probe validate this formula) — plus the causal-attention score/value
    term 6*L*S*d_attn per token (fwd 2 + bwd 4; causal halves S^2)."""
    p_matmul = config.param_count() - config.vocab_size * config.d_model
    d_attn = config.n_heads * config.d_head
    attn = 6.0 * config.n_layers * seq * d_attn  # per token, causal-halved
    return tokens * (6.0 * p_matmul + attn)


def _axis_links(layout: Dict[str, int], hw: Dict[str, Any]) -> Dict:
    """The link each axis's traffic crosses, with ranks numbered tp
    innermost, then pp, then dp, and node = rank // devices_per_node: tp's
    all-reduces and dp's gradient all-reduce on the ring rate of the link
    their group spans; pp's sends on the slowest stage edge (the stages
    run in lockstep)."""
    tp, pp, dp = layout["tp"], layout["pp"], layout["dp"]
    per_node = hw["devices_per_node"]

    def node(d, p, t):
        return ((d * pp + p) * tp + t) // per_node

    def rate(crosses):
        return (hw["inter_node_bytes_per_s"] if crosses
                else hw["intra_node_bytes_per_s"])

    def link(crosses):
        return hw["inter_node_link"] if crosses else hw["intra_node_link"]

    tp_crosses = any(node(d, p, t) != node(d, p, 0) for d in range(dp)
                     for p in range(pp) for t in range(tp))
    edges = [any(node(d, p, t) != node(d, p + 1, t) for d in range(dp)
                 for t in range(tp)) for p in range(pp - 1)]
    dp_crosses = any(node(d, p, t) != node(0, p, t) for d in range(dp)
                     for p in range(pp) for t in range(tp))
    return {
        "tp": (rate(tp_crosses) * hw["ring_links"], link(tp_crosses)),
        "pp": (min((rate(c) for c in edges),
                   default=hw["intra_node_bytes_per_s"]),
               link(any(edges))),
        "pp_edges_between_nodes": sum(edges),
        "dp": (rate(dp_crosses) * hw["ring_links"], link(dp_crosses)),
    }


def project_h100_pod(
    config=None,
    *,
    layout: Optional[Dict[str, int]] = None,
    hardware: Optional[Dict[str, Any]] = None,
    global_batch: int = 64,
    seq: int = 2048,
    microbatches: int = 32,
    efficiency_anchor: float = GPTJ_STAGE_MFU,
    dp_overlap: float = 0.7,
    extracted: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Projected GPT-J-6B fine-tune MFU on ``hardware`` (32 H100 SXM cards,
    four nodes of eight, by default).

    ``efficiency_anchor`` is the fraction of peak the per-device matmul
    stream achieves on real silicon; by default the MFU measured on the
    card for one stage's depth of this model (``GPTJ_STAGE_MFU``); where
    another anchor is given, its caller records where it came from.
    ``dp_overlap`` is
    the fraction of the dp gradient all-reduce hidden behind the backward
    pass. ``extracted``, when given, is ``run_probe``'s output: its
    measured/analytic FLOP ratio scales the executed work (the MFU
    numerator stays the model's FLOPs)."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    hw = dict(hardware or H100_SXM)
    cfg = config or dataclasses.replace(
        TransformerConfig.gptj_6b(), attn_impl="flash", remat=True
    )
    lay = dict(layout or {"dp": 2, "tp": 4, "pp": 4})
    n_dev = lay["dp"] * lay["tp"] * lay["pp"]
    if n_dev != hw["devices"]:
        raise ValueError(f"layout {lay} covers {n_dev} devices, not the "
                         f"{hw['devices']} of {hw['name']}")
    links = _axis_links(lay, hw)
    tokens = global_batch * seq
    total_flops = analytic_train_flops(cfg, tokens, seq)
    flops_basis = "analytic(6P + causal-attn)"
    per_dev_flops = total_flops / n_dev
    exec_ratio = 1.0
    if extracted:
        # The probe validated the analytic per-token FLOP model against a
        # count of the products one rank of the port's step runs (a
        # 1-layer config at real 6B widths). The measured/analytic ratio
        # scales the EXECUTED work; the MFU numerator stays model FLOPs,
        # per the standard MFU convention.
        exec_ratio = extracted["measured_over_analytic"]
        flops_basis = (
            f"analytic, validated by a count of the step's products "
            f"(1-layer probe at real 6B widths; executed/model flop ratio "
            f"{exec_ratio:.3f})"
        )

    peak = hw["peak_flops_bf16"]
    t_compute = per_dev_flops * exec_ratio / (peak * efficiency_anchor)

    d = cfg.d_model
    bytes_act = 2  # bf16 activations
    mb_tokens = tokens / lay["dp"] / microbatches  # per microbatch/replica

    # tp: 4 activation all-reduces per layer per microbatch (2 fwd 2 bwd,
    # Megatron placement), ring volume 2*(tp-1)/tp of B*S*d each
    layers_per_stage = cfg.n_layers / lay["pp"]
    v_tp = (
        4 * layers_per_stage * microbatches
        * mb_tokens * d * bytes_act
        * 2 * (lay["tp"] - 1) / lay["tp"]
    )
    t_tp = v_tp / links["tp"][0]

    # pp: one activation (+ one grad) boundary transfer per microbatch
    # per stage edge, point to point
    v_pp = 2 * microbatches * mb_tokens * d * bytes_act
    t_pp_comm = v_pp / links["pp"][0]

    # dp: gradient all-reduce of this device's param shard (bf16), ring
    # over dp; partially overlapped with backward
    p_shard = cfg.param_count() / (lay["tp"] * lay["pp"])
    v_dp = 2 * p_shard * bytes_act * (lay["dp"] - 1) / lay["dp"]
    t_dp = (1.0 - dp_overlap) * v_dp / links["dp"][0]

    bubble = (lay["pp"] - 1) / (microbatches + lay["pp"] - 1)
    t_stage = t_compute + t_tp + t_pp_comm
    t_step = t_stage / (1.0 - bubble) + t_dp

    mfu = total_flops / (n_dev * peak * t_step)
    card = f"{hw['name']} at {hw['power_limit_w']:.0f} W"
    per_node = hw["devices_per_node"]
    return {
        "workload": "GPT-J-6B fine-tune (north star)",
        "pod": (f"{n_dev} x {hw['name']} ({n_dev // per_node} nodes of "
                f"{per_node})"),
        "layout": lay,
        "global_batch": global_batch,
        "seq": seq,
        "microbatches": microbatches,
        "params": cfg.param_count(),
        "total_flops_per_step": total_flops,
        "per_device_flops": per_dev_flops,
        "flops_basis": flops_basis,
        "efficiency_anchor": efficiency_anchor,
        "t_compute_s": t_compute,
        "t_tp_comm_s": t_tp,
        "t_pp_comm_s": t_pp_comm,
        "t_dp_exposed_s": t_dp,
        "pipeline_bubble_fraction": bubble,
        "t_step_s": t_step,
        "tokens_per_s": tokens / t_step,
        "projected_mfu": mfu,
        "assumptions": [
            f"{card}: {peak / 1e12:.0f} TFLOP/s dense bf16, "
            f"{hw['hbm_bytes_per_s'] / 1e12:.2f} TB/s HBM, "
            f"{hw['hbm_bytes'] / 1e9:.0f} GB (published H100 SXM figures)",
            f"{n_dev} cards = {n_dev // per_node} nodes of {per_node}; ranks "
            "numbered tp innermost, then pp, then dp",
            f"{hw['intra_node_link']}: {hw['intra_node_bytes_per_s'] / 1e9:.0f}"
            f" GB/s each way per card inside a node; "
            f"{hw['inter_node_link']}: "
            f"{hw['inter_node_bytes_per_s'] / 1e9:.0f} GB/s each way per card "
            "between nodes",
            f"tp {lay['tp']} all-reduces on {links['tp'][1]} "
            f"({links['tp'][0] / 1e9:.0f} GB/s)",
            f"pp {lay['pp']}: {links['pp_edges_between_nodes']} of "
            f"{lay['pp'] - 1} stage edges per replica cross nodes; the stages "
            f"run in lockstep, so sends go at the slowest edge's "
            f"{links['pp'][0] / 1e9:.0f} GB/s ({links['pp'][1]})",
            f"dp {lay['dp']} gradient all-reduce on {links['dp'][1]} "
            f"({links['dp'][0] / 1e9:.0f} GB/s), {dp_overlap:.0%} overlapped "
            "with backward",
            f"efficiency anchor {efficiency_anchor}: "
            + (GPTJ_STAGE_MFU_BASIS if efficiency_anchor == GPTJ_STAGE_MFU
               else "given by the caller"),
            "tp all-reduces and pp sends serialize with compute "
            "(no overlap credit — conservative)",
            "per-device FLOPs basis: " + flops_basis,
        ],
    }


def run_probe(seq: int = 512, batch: int = 8,
              device=None) -> Dict[str, Any]:
    """Run a 1-LAYER GPT-J-6B-width train step over tp=2 (this process as
    rank 0) and compare the FLOPs it ran with the analytic model.

    One layer at the REAL 6B row widths (d=4096, d_ff=16384, vocab=50432):
    the per-layer arithmetic the projection composes, and the head's.
    CUDA by default; ``device="meta"`` materializes nothing."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    cfg = dataclasses.replace(
        TransformerConfig.gptj_6b(), max_seq_len=seq, n_layers=1,
        attn_impl="dense", remat=False,
    )
    axes = {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 2}
    out = extract_device_cost(cfg, axes, batch_size=batch, seq=seq,
                              device=device)
    out["axes"] = axes
    measured_total = out["flops_per_device"] * out["devices"]
    analytic = analytic_train_flops(cfg, batch * seq, seq)
    out["analytic_flops_total"] = analytic
    out["measured_flops_total"] = measured_total
    out["measured_over_analytic"] = measured_total / analytic
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the probe's device: CUDA by default, or 'meta'")
    args = p.parse_args(argv)
    probe = run_probe(device=args.device)
    proj = project_h100_pod(extracted=probe)
    print(json.dumps({"probe": probe, "projection": {
        k: v for k, v in proj.items() if k != "assumptions"
    }}, indent=2, default=str))
    print("assumptions:")
    for a in proj["assumptions"]:
        print("  -", a)


if __name__ == "__main__":
    main()
