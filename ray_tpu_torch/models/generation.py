"""Autoregressive generation with a KV cache (prefill + decode).

Port of ``ray_tpu/models/generation.py``. ``prefill`` runs the prompt through
the stack once while writing K/V into a fixed-shape cache, ``decode_step``
extends by one token attending over the cache, and ``generate`` chains them
with greedy or temperature sampling. The continuous-batching primitives
(``decode_step_multi``, ``decode_block``, ``prefill_into_slot``,
``_sample_vec``) serve ``serve/llm.py``'s engine.

Where JAX donates the cache and rebuilds it, the port writes it in place:
every function that takes ``cache`` updates its tensors and returns the same
dict. Cache layout [L, B, S_max, Hkv, D]; GQA caches only kv_heads. Attention
here is the dense masked form, as in JAX (no Pallas kernel on this path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.quant import QTensor
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_layer,
    layer_params,
    lm_head,
    tree_map,
)
from ray_tpu_torch.ops.attention import NEG_INF, repeat_kv


def prepare_for_inference(params, config: TransformerConfig):
    """Cast training params (fp32 master copy) to the compute dtype ONCE:
    serving streams every weight per decode step. Int8-quantized weights
    (``models/quant.py`` QTensor) pass through untouched: they dequantize
    where the layer uses them. Returns (params, config)."""
    cast = tree_map(
        lambda x: x if isinstance(x, QTensor) else x.to(config.dtype), params)
    return cast, dataclasses.replace(config, param_dtype=config.dtype)


def init_kv_cache(config: TransformerConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, batch, max_len, c.kv_heads, c.d_head)
    return {
        "k": torch.zeros(shape, dtype=c.dtype, device=dev),
        "v": torch.zeros(shape, dtype=c.dtype, device=dev),
    }


def _masked_attend(q, k, v, mask):
    """q [B,Sq,H,D] against k/v [B,Sk,Hkv,D]; ``mask`` broadcasts against
    the fp32 scores [B,H,Sq,Sk] (True = attend)."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend_cached(q, cache_k, cache_v, q_pos, kv_len_mask):
    """q [B,S,H,D] against cache_k/v [B,S_max,Hkv,D]; kv_len_mask [S_max]
    marks valid cache slots; q_pos [S] are the query positions."""
    k_pos = torch.arange(cache_k.shape[1], device=q.device)
    causal = q_pos[:, None] >= k_pos[None, :]
    return _masked_attend(q, cache_k, cache_v, causal & kv_len_mask[None, :])


def _forward_cached(params, tokens, cache, start_pos: int,
                    config: TransformerConfig):
    """Run `tokens` [B, S] starting at absolute position start_pos, writing
    K/V into the cache. Returns (logits [B, S, V], cache). The layer body is
    the SAME ``apply_layer`` the forward uses; only the attention callable
    differs (cache-writing, cache-attending)."""
    c = config
    x = params["embed"][tokens].to(c.dtype)
    S = tokens.shape[1]
    positions = start_pos + torch.arange(S, device=tokens.device)
    s_max = cache["k"].shape[2]
    kv_valid = torch.arange(s_max, device=tokens.device) < start_pos + S
    for li in range(c.n_layers):
        ck, cv = cache["k"][li], cache["v"][li]

        def cached_attn(q, k, v, ck=ck, cv=cv):
            ck[:, start_pos:start_pos + S] = k
            cv[:, start_pos:start_pos + S] = v
            return _attend_cached(q, ck, cv, positions, kv_valid)

        x, _aux = apply_layer(x, layer_params(params, li), c, positions,
                              cached_attn)
    return lm_head(params, x, c), cache


def prefill(params, tokens, config: TransformerConfig, max_len: int):
    """Prompt pass. Returns (last-token logits [B, V], cache)."""
    cache = init_kv_cache(config, tokens.shape[0], max_len,
                          device=tokens.device)
    logits, cache = _forward_cached(params, tokens, cache, 0, config)
    return logits[:, -1, :], cache


def decode_step(params, token, cache, pos: int, config: TransformerConfig):
    """One token [B] at absolute position pos. Returns (logits [B,V], cache)."""
    logits, cache = _forward_cached(params, token[:, None], cache, pos,
                                    config)
    return logits[:, 0, :], cache


# ---------------- continuous-batching primitives ----------------
# (serve/llm.py's iteration-level scheduler: per-SLOT positions so one
# decode step serves sequences admitted at different times.)


def _attend_prefix_plus_self(q, ck, cv, k_new, v_new, pos):
    """q [B,1,H,D] against the UNWRITTEN cache prefix (k_pos < pos, strict:
    the row at ``pos`` may hold stale garbage) plus the fresh (k_new, v_new)
    [B,1,Hkv,D] as one extra logical position. Exactly equivalent to writing
    the token's k/v at ``pos`` first and attending ``k_pos <= pos``."""
    n_rep = q.shape[2] // ck.shape[2]
    k = repeat_kv(ck, n_rep)
    v = repeat_kv(cv, n_rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = k_pos[None, :] < pos[:, None]  # [B, S_max], STRICT
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    self_score = torch.einsum(
        "bqhd,bqhd->bhq", q.float(), repeat_kv(k_new, n_rep).float()
    )[..., None] * scale  # [B,H,1,1]
    all_scores = torch.cat([scores, self_score], dim=-1)
    probs = torch.softmax(all_scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs[..., :-1], v)
    return out + probs[..., -1:].permute(0, 2, 1, 3) * repeat_kv(
        v_new, n_rep
    )


def decode_step_multi(params, token, cache, pos, config: TransformerConfig):
    """One token per SLOT at per-slot absolute positions.

    token [B], pos [B] integer tensors on the device (position each slot's
    token occupies). Each layer attends prefix-plus-self, then writes its
    fresh k/v row in place. Inactive slots simply decode garbage into their
    own lane: they attend only their own cache row, so active slots are
    unaffected; the engine ignores their outputs. Returns (logits [B, V],
    cache)."""
    c = config
    x = params["embed"][token].to(c.dtype)[:, None]  # [B,1,D]
    b_idx = torch.arange(token.shape[0], device=token.device)
    # JAX drops a scatter row past the cache; here a slot decoding on past
    # its request's end writes its own last row instead, which no other slot
    # reads and which the slot's next admission rewrites.
    w_pos = pos.clamp(max=cache["k"].shape[2] - 1)
    for li in range(c.n_layers):
        ck, cv = cache["k"][li], cache["v"][li]

        def cached_attn(q, k, v, ck=ck, cv=cv):
            out = _attend_prefix_plus_self(q, ck, cv, k, v, pos)
            ck[b_idx, w_pos] = k[:, 0]
            cv[b_idx, w_pos] = v[:, 0]
            return out

        x, _aux = apply_layer(x, layer_params(params, li), c, pos[:, None],
                              cached_attn)
    return lm_head(params, x[:, 0], c), cache


def _slot_seed(seed: int, count: int) -> int:
    return (int(seed) * 1_000_003 + int(count)) % (1 << 63)


def _gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    noise = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return -noise.exponential_(generator=generator).log()


def _sample_vec(logits, temps: Sequence[float], seeds: Sequence[int],
                counts: Sequence[int]):
    """Per-slot sampling: greedy where temps <= 0, Gumbel-max categorical
    elsewhere, deterministic per (seed, count). ``temps``, ``seeds`` and
    ``counts`` are host values (the engine keeps them on the host, so no
    sample waits on the device). The random bits differ from JAX's; only
    greedy output is held to parity."""
    out = torch.argmax(logits, dim=-1)
    for i, t in enumerate(temps):
        if t > 0:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_slot_seed(seeds[i], counts[i]))
            g = _gumbel(logits.shape[-1], gen)
            out[i] = torch.argmax(logits[i].float() / max(float(t), 1e-6) + g)
    return out


def decode_block(params, cache, token, pos, temps, seeds, counts,
                 config: TransformerConfig, steps: int):
    """``steps`` decode iterations with per-slot sampling: the serving
    engine's unit of work, fetched by the host as one [B, steps] transfer.
    ``token``/``pos`` are device tensors [B]; ``temps``/``seeds``/``counts``
    host arrays [B].

    Returns (tokens [B, steps], cache, token', pos', counts')."""
    counts = np.asarray(counts, np.int64)
    toks = []
    for _ in range(steps):
        logits, cache = decode_step_multi(params, token, cache, pos, config)
        token = _sample_vec(logits, temps, seeds, counts)
        pos = pos + 1
        counts = counts + 1
        toks.append(token)
    return torch.stack(toks, dim=1), cache, token, pos, counts


def _attend_prefill(q, ck, cv, q_pos, kv_valid_b):
    k_pos = torch.arange(ck.shape[1], device=q.device)
    mask = (q_pos[:, None] >= k_pos[None, :])[None] & kv_valid_b[:, None, :]
    return _masked_attend(q, ck, cv, mask[:, None])


def prefill_into_slot(params, prompt, prompt_len: int, slot: int, cache,
                      config: TransformerConfig):
    """Run ONE padded prompt [1, Sb] and write its K/V into ``slot`` of the
    shared batch cache (Sb is a bucket size). Positions past prompt_len write
    junk K/V that is never attended: the slot's kv_valid mask stops at its
    position, and decode overwrites those cells before reaching them.

    The slot's WHOLE [L, 1, S_max] row is rewritten, zeros past the bucket,
    as JAX's single-slot buffer does. Returns (last-valid-token logits [V],
    cache)."""
    c = config
    S = prompt.shape[1]
    s_max = cache["k"].shape[2]
    k_row = cache["k"][:, slot:slot + 1]  # [L, 1, S_max, Hkv, D] views
    v_row = cache["v"][:, slot:slot + 1]
    k_row.zero_()
    v_row.zero_()
    x = params["embed"][prompt].to(c.dtype)
    positions = torch.arange(S, device=prompt.device)
    kv_valid = (torch.arange(s_max, device=prompt.device) < prompt_len)[None]
    for li in range(c.n_layers):
        ck, cv = k_row[li], v_row[li]

        def cached_attn(q, k, v, ck=ck, cv=cv):
            ck[:, :S] = k
            cv[:, :S] = v
            return _attend_prefill(q, ck, cv, positions, kv_valid)

        x, _aux = apply_layer(x, layer_params(params, li), c, positions,
                              cached_attn)
    return lm_head(params, x[0, prompt_len - 1], c), cache


def _sample(logits, generator: torch.Generator, temperature: float):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    g = _gumbel(logits.shape, generator)
    return torch.argmax(logits.float() / temperature + g, dim=-1)


def decode_loop(params, first_token, cache, start_pos: int,
                config: TransformerConfig, max_new_tokens: int,
                temperature: float, generator: torch.Generator):
    """N-step decode: feeds each sampled token back in; returns
    [B, max_new_tokens]."""
    tok, toks = first_token, []
    for i in range(max_new_tokens):
        logits, cache = decode_step(params, tok, cache, start_pos + i, config)
        tok = _sample(logits, generator, temperature)
        toks.append(tok)
    return torch.stack(toks, dim=1)


@torch.inference_mode()
def generate(
    params,
    prompt,  # [B, S] integer (tensor or array)
    config: TransformerConfig,
    *,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Returns [B, max_new_tokens] generated ids (greedy when
    temperature=0) on ``device`` (CUDA by default), where ``params`` must
    live."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, S = prompt.shape
    max_len = max_len or config.max_seq_len
    if S + max_new_tokens > max_len:
        raise ValueError(
            f"prompt {S} + new {max_new_tokens} exceeds max_len {max_len}"
        )
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    logits, cache = prefill(params, prompt, config, max_len)
    first = _sample(logits, generator, temperature)
    if max_new_tokens == 1:
        return first[:, None]
    rest = decode_loop(params, first, cache, S, config, max_new_tokens - 1,
                       temperature, generator)
    return torch.cat([first[:, None], rest], dim=1)
