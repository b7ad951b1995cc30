"""The port's cluster projection (``ray_tpu_torch/parallel/projection.py``)
against the reference's (``ray_tpu/parallel/projection.py``).

The FLOP formula must equal the reference's exactly. Given the reference's
v5p numbers and layout as a hardware description, ``project_h100_pod``
must reproduce every figure of ``project_v5p64`` to 1e-9 relative. The
reference's own checks are mirrored on the H100 projection: the figures
recompute from their components, the layout must cover the cluster, and
the state fits the card's 80 GB at 75%. The reference's ``projected_mfu >=
0.40`` bar (tests/test_projection.py:61, :87) is a v5p target and is not
carried over: the H100 projection's MFU follows from an efficiency anchor
measured on the card. The probe runs the port's real train step on
``device="meta"`` as rank 0 of a fake process group of two (tp 2), at the
reference's slow-test size, and must count within (0.90, 1.10) of the
analytic FLOPs, the band the reference's test holds.
"""

import dataclasses

import pytest
import torch.distributed as dist

from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.parallel import projection as ref
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.parallel import projection as pj

REL = 1e-9  # the projection's figures, relative

# The reference's v5p model as a hardware description of the port's: every
# axis on ICI links (one "node" spans the pod), ring collectives on the two
# links of an axis, sends on one.
V5P_HW = {
    "name": "v5p", "power_limit_w": 0.0,
    "peak_flops_bf16": ref.V5P["peak_flops_bf16"],
    "hbm_bytes_per_s": ref.V5P["hbm_bytes_per_s"], "hbm_bytes": 95e9,
    "devices": ref.V5P64_DEVICES, "devices_per_node": ref.V5P64_DEVICES,
    "intra_node_link": "ICI",
    "intra_node_bytes_per_s": ref.V5P["ici_link_bytes_per_s"],
    "inter_node_link": "ICI",
    "inter_node_bytes_per_s": ref.V5P["ici_link_bytes_per_s"],
    "ring_links": 2,
}
REFERENCE_ANCHOR = 0.55  # project_v5p64's default efficiency_anchor


@pytest.mark.parametrize("name", ["gptj_6b", "bench_400m", "serve_7b",
                                  "tiny"])
@pytest.mark.parametrize("tokens,seq", [(64 * 2048, 2048), (4 * 256, 256)])
def test_analytic_train_flops_equals_the_reference(name, tokens, seq):
    got = pj.analytic_train_flops(getattr(TransformerConfig, name)(),
                                  tokens, seq)
    assert got == ref.analytic_train_flops(getattr(JaxConfig, name)(),
                                           tokens, seq)


@pytest.mark.parametrize("extracted", [None,
                                       {"measured_over_analytic": 1.10}])
def test_v5p_hardware_reproduces_project_v5p64(extracted):
    want = ref.project_v5p64(extracted=extracted)
    got = pj.project_h100_pod(hardware=V5P_HW,
                              efficiency_anchor=REFERENCE_ANCHOR,
                              extracted=extracted)
    numbers = {k: v for k, v in want.items()
               if isinstance(v, (int, float))}
    assert len(numbers) == 14
    for k, v in numbers.items():
        assert got[k] == pytest.approx(v, rel=REL, abs=0), k
    assert got["layout"] == want["layout"]


def test_the_h100_cluster_puts_each_axis_on_its_link():
    """tp 4 inside a node on NVLink; of each replica's three stage edges
    the middle one crosses nodes, on InfiniBand, and sets the sends'
    pace; dp crosses nodes, on InfiniBand."""
    links = pj._axis_links({"dp": 2, "tp": 4, "pp": 4}, pj.H100_SXM)
    assert links["tp"] == (450e9, "NVLink 4")
    assert links["pp"] == (50e9, "InfiniBand NDR")
    assert links["pp_edges_between_nodes"] == 1
    assert links["dp"] == (50e9, "InfiniBand NDR")
    # tp 8 still fits a node; pp 8 x tp 4 puts three of seven edges
    # between nodes
    assert pj._axis_links({"dp": 1, "tp": 8, "pp": 4},
                          pj.H100_SXM)["tp"] == (450e9, "NVLink 4")
    assert pj._axis_links({"dp": 1, "tp": 4, "pp": 8},
                          pj.H100_SXM)["pp_edges_between_nodes"] == 3


def test_projection_arithmetic_recomputes():
    """Every reported figure follows from the reported components (the
    reference's tests/test_projection.py:36-62, without its v5p bar)."""
    proj = pj.project_h100_pod()
    lay = proj["layout"]
    n = lay["dp"] * lay["tp"] * lay["pp"]
    assert n == pj.H100_SXM["devices"] == 32
    t_stage = (proj["t_compute_s"] + proj["t_tp_comm_s"]
               + proj["t_pp_comm_s"])
    t_step = t_stage / (1 - proj["pipeline_bubble_fraction"]) + proj[
        "t_dp_exposed_s"]
    assert abs(t_step - proj["t_step_s"]) < 1e-9
    mfu = proj["total_flops_per_step"] / (
        n * pj.H100_SXM["peak_flops_bf16"] * proj["t_step_s"])
    assert abs(mfu - proj["projected_mfu"]) < 1e-9
    tps = proj["global_batch"] * proj["seq"] / proj["t_step_s"]
    assert abs(tps - proj["tokens_per_s"]) < 1e-6
    assert proj["pipeline_bubble_fraction"] == pytest.approx(
        (lay["pp"] - 1) / (proj["microbatches"] + lay["pp"] - 1))
    assert 0 < proj["projected_mfu"] < proj["efficiency_anchor"]
    assert proj["efficiency_anchor"] == pj.GPTJ_STAGE_MFU
    text = " ".join(proj["assumptions"])
    assert "NVIDIA H100 80GB HBM3 at 700 W" in text
    assert "NVLink 4" in text and "InfiniBand NDR" in text
    assert "v5p" not in text


def test_projection_probe_ratio_plumbs_into_compute_time():
    base = pj.project_h100_pod()
    bumped = pj.project_h100_pod(extracted={"measured_over_analytic": 1.10})
    assert bumped["t_compute_s"] == pytest.approx(base["t_compute_s"] * 1.10)
    assert bumped["total_flops_per_step"] == base["total_flops_per_step"]
    assert bumped["projected_mfu"] < base["projected_mfu"]


def test_projection_layout_must_cover_the_cluster():
    with pytest.raises(ValueError, match="covers 16 devices"):
        pj.project_h100_pod(layout={"dp": 1, "tp": 4, "pp": 4})


def test_projection_fits_hbm():
    """The chosen layout's per-device state fits the card's 80 GB at 75%:
    fp32 params, grads and AdamW's two moments of the stage's shard."""
    cfg = TransformerConfig.gptj_6b()
    lay = pj.project_h100_pod()["layout"]
    shard = cfg.param_count() / (lay["tp"] * lay["pp"])
    assert shard * 4 * 4 < pj.H100_SXM["hbm_bytes"] * 0.75


def test_probe_counts_the_port_step_within_ten_percent():
    """The 1-layer GPT-J-width step over tp 2 on meta tensors (nothing
    materializes) counts within 10% of the analytic FLOPs; the fake
    process group is gone afterwards."""
    probe = pj.run_probe(seq=256, batch=4, device="meta")
    assert probe["devices"] == 2
    assert 0.90 < probe["measured_over_analytic"] < 1.10, probe
    assert "fake process group of 2 ranks" in probe["flops_basis"]
    assert not dist.is_initialized()
    cfg = dataclasses.replace(TransformerConfig.gptj_6b(), n_layers=1)
    assert probe["analytic_flops_total"] == pj.analytic_train_flops(
        cfg, 4 * 256, 256)
    proj = pj.project_h100_pod(extracted=probe)
    assert proj["t_compute_s"] == pytest.approx(
        pj.project_h100_pod()["t_compute_s"]
        * probe["measured_over_analytic"])


def test_extract_device_cost_counts_a_pipelined_step():
    """pp 2: ``make_pipeline_train_step`` (1F1B, 4 microbatches) of a small
    config, run on the CPU as rank 0 of a fake process group of two, is
    counted and the group is gone afterwards; on meta tensors, which the
    stage sends cannot take, the count is refused."""
    cfg = dataclasses.replace(TransformerConfig.tiny(), attn_impl="dense",
                              remat=False)
    axes = {"dp": 1, "pp": 2, "ep": 1, "sp": 1, "tp": 1}
    out = pj.extract_device_cost(cfg, axes, batch_size=4, seq=64,
                                 microbatches=4, device="cpu")
    assert not dist.is_initialized()
    assert out["devices"] == 2
    assert (out["microbatches"], out["schedule"]) == (4, "1f1b")
    assert out["flops_per_device"] == sum(out["flops_by_op"].values()) > 0
    assert "fake process group of 2 ranks" in out["flops_basis"]
    with pytest.raises(ValueError, match="meta"):
        pj.extract_device_cost(cfg, axes, batch_size=4, seq=64,
                               microbatches=4, device="meta")
    assert not dist.is_initialized()
