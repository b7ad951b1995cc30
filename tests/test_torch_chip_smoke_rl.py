"""chip_smoke's rl twins on the CPU. The rl phase holds five learner
computations on the card against their CPU twins within ``RL_TWIN_TOL``
(parameters, gradients) and ``RL_LOSS_RTOL`` (losses). Here the same five
run in fp32 and in fp64 on the same inputs: fp32's own rounding must stay
well inside those bounds (a third of the atol, a tenth of the loss
rtol), so that the card's rounding has room and a real fault does not.
Run with ``-s`` to see each figure."""

import importlib.util
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rl_twin_bounds_cover_fp32_rounding():
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    inputs = cs.rl_twin_inputs()
    f32 = cs.rl_twin_run(inputs, cpu)
    f64 = cs.rl_twin_run(inputs, cpu, torch.float64)
    assert set(f32) == {"ppo_update", "vtrace_loss", "dqn_step", "sac_step",
                        "bc_step"}
    atol = cs.RL_TWIN_TOL[1]
    for name in f32:
        got, want = f32[name]["result"], f64[name]["result"]
        for key in got:
            abs_err, rel_err = cs._tree_err(got[key], want[key])
            print(f"{name} {key}: max abs {abs_err:.3g}, max rel "
                  f"{rel_err:.3g}")
            if key in ("aux", "loss", "losses"):
                assert rel_err <= cs.RL_LOSS_RTOL / 10, (name, key, rel_err)
            else:
                assert abs_err <= atol / 3, (name, key, abs_err)
