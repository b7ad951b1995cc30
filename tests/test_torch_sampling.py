"""The port's on-device sampler (``_sample_vec`` and its counter-based hash,
ray_tpu_torch/models/generation.py) on the CPU.

The reference draws with ``jax.random.fold_in(key(seed), count)``
(ray_tpu/models/generation.py:293-306); the port's bits differ from JAX's,
so only greedy output is held to JAX (tests/test_torch_generation.py,
tests/test_torch_llm_engine.py). Here: greedy is argmax; a draw is a pure
function of (seed, count); the hash's integer bits equal an independent
pure-Python implementation and pinned golden values (``chip_smoke.py``
holds the card's bits equal to the CPU's); and the draws follow
softmax(logits / t).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import generation as tgen

_M32 = 0xFFFFFFFF


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _bits(seed: int, count: int, i: int) -> int:
    """The hash written with Python's unbounded ints."""
    key = _fmix32(_fmix32(seed & _M32) ^ ((count & _M32) * 0x85EBCA77 & _M32))
    return _fmix32((key + (i * 0x9E3779B9 & _M32)) & _M32)


def _state(temps, seeds, counts):
    return (torch.tensor(temps, dtype=torch.float32), torch.tensor(seeds),
            torch.tensor(counts))


def test_hash_bits_equal_an_independent_implementation():
    rng = np.random.default_rng(0)
    seeds = [0, 1, -3, 2 ** 31 + 5, 2 ** 40 + 7,
             *rng.integers(-2 ** 62, 2 ** 62, 11).tolist()]
    counts = [0, 1, 9, 2 ** 33 + 2, *rng.integers(0, 2 ** 40, 12).tolist()]
    got = tgen._hash_bits(torch.tensor(seeds), torch.tensor(counts), 37)
    assert got.dtype == torch.int64
    want = [[_bits(s, c, i) for i in range(37)]
            for s, c in zip(seeds, counts)]
    assert got.tolist() == want


def test_hash_bits_golden():
    """Pinned values: the card's bits are held to the CPU's, so the CPU's
    must not move."""
    got = tgen._hash_bits(torch.tensor([5, 5, -3, 2 ** 40 + 7]),
                          torch.tensor([0, 1, 9, 2 ** 33 + 2]), 4)
    assert got.tolist() == [
        [3210785937, 4197385419, 2723443152, 3538062282],
        [41488432, 3922883534, 308141564, 2761108339],
        [2414937289, 586875337, 3891304705, 2252625712],
        [700626906, 3020708844, 1992919505, 1545164742],
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_is_argmax(dtype):
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 300), dtype=np.float32)).to(dtype)
    temps, seeds, counts = _state([0.0, -1.0, 0.0, 0.0, 0.0],
                                  [0, 1, 2, 3, 4], [7, 7, 7, 7, 7])
    got = tgen._sample_vec(logits, temps, seeds, counts)
    assert torch.equal(got, torch.argmax(logits, dim=-1))


def test_draws_are_a_function_of_seed_and_count_only():
    """The same (seed, count) draws the same token in any row and batch;
    another count or seed moves the draw; a row's draw ignores the others'
    state."""
    logits = torch.zeros((3, 1000))
    a = tgen._sample_vec(logits, *_state([1.0] * 3, [4, 4, 9], [2, 2, 2]))
    assert int(a[0]) == int(a[1])
    b = tgen._sample_vec(logits[:1], *_state([1.0], [4], [2]))
    assert int(b[0]) == int(a[0])
    c = tgen._sample_vec(logits, *_state([1.0] * 3, [4, 5, 9], [2, 3, 2]))
    assert int(c[0]) == int(a[0]) and int(c[2]) == int(a[2])
    by_count = {int(tgen._sample_vec(logits[:1], *_state([1.0], [4], [n]))[0])
                for n in range(20)}
    by_seed = {int(tgen._sample_vec(logits[:1], *_state([1.0], [n], [2]))[0])
               for n in range(20)}
    assert len(by_count) > 10 and len(by_seed) > 10


def test_noise_is_finite_gumbel():
    g = tgen._gumbel_noise(torch.arange(64), torch.arange(64), 2000)
    assert bool(torch.isfinite(g).all())
    # standard Gumbel: mean = Euler's constant, variance pi^2 / 6; 128,000
    # draws put the sample mean within ~0.004 (one standard error) of it
    assert abs(g.mean().item() - 0.5772) < 0.02
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.05


# chi-square with 3 degrees of freedom (4 tokens): its 0.999 quantile. The
# draws are seeded, so the test is deterministic; a sampler off softmax(l/t)
# by a few percent at 4,096 draws lands far above it.
CHI2_3DOF_999 = 16.27


@pytest.mark.parametrize("t", [0.8, 2.0])
def test_draws_follow_softmax_of_logits_over_t(t):
    logits = torch.tensor([1.0, 0.0, -0.5, 2.0])
    seeds, counts = torch.meshgrid(torch.arange(64), torch.arange(64),
                                   indexing="ij")
    n = seeds.numel()
    draws = tgen._sample_vec(logits.expand(n, 4), torch.full((n,), t),
                             seeds.reshape(-1), counts.reshape(-1))
    observed = torch.bincount(draws, minlength=4).double()
    expected = torch.softmax(logits.double() / t, dim=0) * n
    chi2 = (((observed - expected) ** 2) / expected).sum().item()
    assert chi2 < CHI2_3DOF_999, (chi2, observed.tolist(), expected.tolist())
