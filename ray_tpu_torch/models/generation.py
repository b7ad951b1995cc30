"""Autoregressive generation with a KV cache (prefill + decode).

Port of ``ray_tpu/models/generation.py``. ``prefill`` runs the prompt through
the stack once while writing K/V into a fixed-shape cache, ``decode_step``
extends by one token attending over the cache, and ``generate`` chains them
with greedy or temperature sampling. The continuous-batching primitives
(``decode_step_multi``, ``decode_block`` / ``decode_block_into``,
``prefill_into_slot``, ``_sample_vec``) serve ``serve/llm.py``'s engine,
which captures them in CUDA graphs: they take all state as device tensors and
never sync with the host (no ``.item()``, no boolean-mask indexing, no
numpy).

``generate`` runs as the reference compiles it: ``prefill`` and
``decode_loop`` are captured programs on CUDA (CUDA graphs over a session's
static buffers, captured at first use and replayed; the loop as fixed
blocks of steps; see ``_Session``), with every token sampled on the device.

Every cached decode step (``decode_step``, ``decode_step_multi``) attends
through ``ops/decode_attention.py``'s hand-written kernel, which reads each
slot's valid cache rows once; prompts attend with the dense masked form, as
in JAX.

Where JAX donates the cache and rebuilds it, the port writes it in place:
every function that takes ``cache`` updates its tensors and returns the same
dict. Cache layout [L, B, S_max, Hkv, D]; GQA caches only kv_heads.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable, Dict, Optional

import torch

from ray_tpu_torch import graphs
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.quant import QTensor
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_layer,
    layer_params,
    lm_head,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.ops.attention import masked_attention
from ray_tpu_torch.ops.decode_attention import decode_attention


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


def _attend_cached(q, cache_k, cache_v, q_pos, kv_len_mask):
    """q [B,S,H,D] against cache_k/v [B,S_max,Hkv,D]; kv_len_mask [S_max]
    marks valid cache slots; q_pos [S] are the query positions. The prefill
    form (S > 1), dense as the reference's; a decode step (S = 1) attends
    through ``decode_attention`` instead (``_forward_cached``)."""
    k_pos = torch.arange(cache_k.shape[1], device=q.device)
    causal = q_pos[:, None] >= k_pos[None, :]
    return masked_attention(q, cache_k, cache_v,
                            causal & kv_len_mask[None, :])


def _forward_cached(params, tokens, cache, start_pos,
                    config: TransformerConfig):
    """Run `tokens` [B, S] starting at absolute position ``start_pos`` (an
    int, or a 0-d integer tensor on the tokens' device), writing K/V into
    the cache at device indices (``index_copy_``; the positions must lie in
    the cache). Returns (logits [B, S, V], cache). The layer body is the
    SAME ``apply_layer`` the forward uses; only the attention callable
    differs (cache-writing, cache-attending). A decode step (S = 1) attends
    through ``decode_attention`` over the rows up to and including its own
    (``lengths = start_pos + 1``); a prompt (S > 1) densely, as the
    reference does."""
    c = config
    x = params["embed"][tokens].to(c.dtype)
    B, S = tokens.shape
    positions = start_pos + torch.arange(S, device=tokens.device)
    if S == 1:
        lengths = (positions + 1).expand(B).contiguous()
    else:
        s_max = cache["k"].shape[2]
        kv_valid = torch.arange(s_max, device=tokens.device) < start_pos + S
    for li in range(c.n_layers):
        ck, cv = cache["k"][li], cache["v"][li]

        def cached_attn(q, k, v, ck=ck, cv=cv):
            ck.index_copy_(1, positions, k)
            cv.index_copy_(1, positions, v)
            if S == 1:
                return decode_attention(q, ck, cv, lengths)
            return _attend_cached(q, ck, cv, positions, kv_valid)

        x, _aux = apply_layer(x, layer_params(params, li), c, positions,
                              cached_attn)
    return lm_head(params, x, c), cache


def decode_step(params, token, cache, pos, config: TransformerConfig):
    """One token [B] at absolute position ``pos`` (an int or a 0-d integer
    tensor on the device). Returns (logits [B,V], cache)."""
    logits, cache = _forward_cached(params, token[:, None], cache, pos,
                                    config)
    return logits[:, 0, :], cache


# ---------------- continuous-batching primitives ----------------
# (serve/llm.py's iteration-level scheduler: per-SLOT positions so one
# decode step serves sequences admitted at different times.)


def decode_step_multi(params, token, cache, pos, config: TransformerConfig):
    """One token per SLOT at per-slot absolute positions.

    token [B], pos [B] integer tensors on the device (position each slot's
    token occupies). Each layer attends the cache rows below ``pos`` plus
    the token's fresh k/v as one more column (``decode_attention`` with the
    self column: the reference's ``_attend_prefix_plus_self``), so its own
    row need not be written first. Two structures, selected as the
    reference selects them (``RAYTPU_DECODE_DEFERRED_WRITES``, read at each
    call, so a captured graph keeps the structure of its capture):

    * default (unset or 0): each layer writes its fresh k/v row in place
      right after attending;
    * deferred (=1): the layers only read the cache; every layer's fresh
      rows land with one write each for k and v after the stack (2 writes
      per step in place of 2 per layer; ``_decode_forward_multi_deferred``,
      ``ray_tpu/models/generation.py:209-237``).

    Both write the same rows and attend the same values. Inactive slots
    simply decode garbage into their own lane: they attend only their own
    cache row, so active slots are unaffected; the engine ignores their
    outputs. Returns (logits [B, V], cache)."""
    c = config
    x = params["embed"][token].to(c.dtype)[:, None]  # [B,1,D]
    b_idx = torch.arange(token.shape[0], device=token.device)
    # JAX drops a scatter row past the cache; here a slot decoding on past
    # its request's end writes its own last row instead, which no other slot
    # reads and which the slot's next admission rewrites. The attention's
    # lengths stay ``pos``: the kernel clamps them to the cache.
    w_pos = pos.clamp(max=cache["k"].shape[2] - 1)
    deferred = os.environ.get("RAYTPU_DECODE_DEFERRED_WRITES", "0") == "1"
    fresh = []
    for li in range(c.n_layers):
        ck, cv = cache["k"][li], cache["v"][li]

        def cached_attn(q, k, v, ck=ck, cv=cv):
            out = decode_attention(q, ck, cv, pos, k, v)
            if deferred:
                fresh.append((k[:, 0], v[:, 0]))
            else:
                ck[b_idx, w_pos] = k[:, 0]
                cv[b_idx, w_pos] = v[:, 0]
            return out

        x, _aux = apply_layer(x, layer_params(params, li), c, pos[:, None],
                              cached_attn)
    if deferred:
        # [L, B, Hkv, D] each: adjacent advanced indices keep their place
        cache["k"][:, b_idx, w_pos] = torch.stack([k for k, _ in fresh])
        cache["v"][:, b_idx, w_pos] = torch.stack([v for _, v in fresh])
    return lm_head(params, x[:, 0], c), cache


# ---------------- on-device sampling ----------------
# The counterpart of ``jax.random.fold_in(jax.random.key(seed), count)`` and
# ``jax.random.gumbel`` in ``_sample_vec`` (ray_tpu/models/generation.py:
# 293-306): a counter-based hash of (seed, count, vocab index) in integer
# tensor ops, so a draw is a pure function of its inputs (deterministic per
# (seed, count), and capturable in a CUDA graph). Values are held in int64 in
# [0, 2^32); torch's int64 ``>>`` is arithmetic and its overflow is not
# defined, so every product stays below 2^49 and every result is masked.
_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant
    ``c``, from two products below 2^48."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_bits(seeds: torch.Tensor, counts: torch.Tensor,
               n: int) -> torch.Tensor:
    """[B, n] int64 random bits in [0, 2^32) of (seed, count, index) for
    seeds and counts [B]: a per-row key from seed and count, then index i of
    the row as the i-th step of a Weyl sequence from that key, finalized
    (splitmix's scheme at 32 bits). The same on every device."""
    seeds = seeds.to(torch.int64) & _MASK32
    counts = counts.to(torch.int64) & _MASK32
    key = _fmix32(_fmix32(seeds) ^ _mul32(counts, 0x85EBCA77))
    idx = _mul32(torch.arange(n, dtype=torch.int64, device=seeds.device),
                 0x9E3779B9)
    return _fmix32((key[:, None] + idx[None, :]) & _MASK32)


def _gumbel_noise(seeds, counts, n: int) -> torch.Tensor:
    """[B, n] fp32 standard Gumbel noise from ``_hash_bits``: the top 24
    bits as a uniform in (0, 1), then -log(-log(u))."""
    u = ((_hash_bits(seeds, counts, n) >> 8).float() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def _sample_vec(logits: torch.Tensor, temps: torch.Tensor,
                seeds: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling on the device: greedy where temps <= 0, Gumbel-max
    categorical elsewhere, deterministic per (seed, count). ``temps``
    (fp32), ``seeds`` and ``counts`` are tensors [B] on the logits' device;
    nothing here waits on or reads from the host. The random bits differ
    from JAX's; only greedy output is held to parity."""
    greedy = torch.argmax(logits, dim=-1)
    noise = _gumbel_noise(seeds, counts, logits.shape[-1])
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temps <= 0, greedy, sampled)


def decode_block_into(params, cache, token, pos, temps, seeds, counts,
                      config: TransformerConfig, out: torch.Tensor):
    """``out.shape[1]`` decode iterations with per-slot sampling, in place:
    the serving engine's unit of work (one captured CUDA graph per block
    length). ``token``, ``pos`` and ``counts`` [B] are advanced in place;
    step i's tokens are written to ``out[:, i]`` ([B, steps], the one host
    transfer of a block). Every input is a device tensor and nothing syncs
    with the host. Returns ``out``."""
    for i in range(out.shape[1]):
        logits, cache = decode_step_multi(params, token, cache, pos, config)
        token.copy_(_sample_vec(logits, temps, seeds, counts))
        pos.add_(1)
        counts.add_(1)
        out[:, i].copy_(token)
    return out


def decode_block(params, cache, token, pos, temps, seeds, counts,
                 config: TransformerConfig, steps: int):
    """``steps`` decode iterations (``decode_block_into`` on copies of the
    slot state), functional as the reference's ``decode_block``
    (ray_tpu/models/generation.py:309-330): ``token``/``pos`` [B] and
    ``temps``/``seeds``/``counts`` [B] are device tensors, left unchanged.

    Returns (tokens [B, steps], cache, token', pos', counts')."""
    token, pos, counts = token.clone(), pos.clone(), counts.clone()
    out = torch.empty((token.shape[0], steps), dtype=token.dtype,
                      device=token.device)
    decode_block_into(params, cache, token, pos, temps, seeds, counts,
                      config, out)
    return out, cache, token, pos, counts


def _attend_prefill(q, ck, cv, q_pos, kv_valid_b):
    k_pos = torch.arange(ck.shape[1], device=q.device)
    mask = (q_pos[:, None] >= k_pos[None, :])[None] & kv_valid_b[:, None, :]
    return masked_attention(q, ck, cv, mask[:, None])


def prefill_into_slot(params, prompt, prompt_len: torch.Tensor,
                      slot: torch.Tensor, cache, config: TransformerConfig):
    """Run ONE padded prompt [1, Sb] and write its K/V into ``slot`` of the
    shared batch cache (Sb is a bucket size: one program per bucket).
    ``prompt_len`` and ``slot`` are 0-d integer tensors on the prompt's
    device, as the reference takes them, so nothing here reads the host.
    Positions past prompt_len write junk K/V that is never attended: the
    slot's kv_valid mask stops at its position, and decode overwrites those
    cells before reaching them.

    The layers write a scratch [L, 1, S_max] row, zeros past the bucket, as
    JAX's single-slot buffer does, which then replaces the slot's WHOLE row
    (``index_copy_`` along the slot dim). Returns (last-valid-token logits
    [V], cache)."""
    c = config
    S = prompt.shape[1]
    s_max = cache["k"].shape[2]
    rows = {key: torch.zeros_like(cache[key][:, :1]) for key in ("k", "v")}
    x = params["embed"][prompt].to(c.dtype)
    positions = torch.arange(S, device=prompt.device)
    kv_valid = (torch.arange(s_max, device=prompt.device) < prompt_len)[None]
    for li in range(c.n_layers):
        ck, cv = rows["k"][li], rows["v"][li]

        def cached_attn(q, k, v, ck=ck, cv=cv):
            ck[:, :S] = k
            cv[:, :S] = v
            return _attend_prefill(q, ck, cv, positions, kv_valid)

        x, _aux = apply_layer(x, layer_params(params, li), c, positions,
                              cached_attn)
    for key in ("k", "v"):
        cache[key].index_copy_(1, slot.reshape(1), rows[key])
    last = x[0].index_select(0, (prompt_len - 1).reshape(1))[0]
    return lm_head(params, last, c), cache


# ---------------- generate: prefill and the decode loop ----------------
# The reference compiles ``generate`` as two programs, the jitted
# ``prefill`` and ``decode_loop`` (one ``lax.scan``), with the first token
# sampled between them. On CUDA the port captures the same two as CUDA
# graphs (``graphs.py``) over the static buffers of a ``_Session`` and
# replays them; on the CPU (the tests' path) the same bodies run eagerly.
#
# The decode loop is a fixed set of captured blocks, not one graph of all
# its steps: blocks of DECODE_BLOCK steps, then one block for each binary
# digit of the rest (``_block_plan``), so any step count is met exactly (no
# step past the request, no ragged block) and a session captures at most
# 1 + 2 + ... + DECODE_BLOCK steps whatever ``max_new_tokens`` is. One graph
# of all the steps, as the reference's one scan, cost a capture per step
# count that grew with it (6.9-8.2 s and 86,662 kernel nodes at 64 steps on
# an H100); the engine replays a block too (``decode_block_into``).
DECODE_BLOCK = 32


def _block_plan(steps: int) -> list:
    """The block lengths that ``steps`` decode steps replay, in order:
    DECODE_BLOCK as often as it fits, then the powers of two of the rest,
    largest first."""
    plan = [DECODE_BLOCK] * (steps // DECODE_BLOCK)
    rest = steps % DECODE_BLOCK
    return plan + [1 << i for i in reversed(range(rest.bit_length()))
                   if rest >> i & 1]


def decode_loop_into(params, cache, tok, pos, temps, seeds, counts,
                     config: TransformerConfig, out: torch.Tensor):
    """``out.shape[1]`` steps of ``generate``'s loop, in place: each step
    decodes ``tok`` [B] at the 0-d position ``pos``, samples the next token
    on the device (``_sample_vec`` with ``temps``, ``seeds``, ``counts`` [B])
    and writes it to ``out[:, i]``; ``tok``, ``pos`` and ``counts`` advance
    in place. Every input is a device tensor and nothing reads the host, so
    a block of steps is one capturable program. Returns ``out``."""
    for i in range(out.shape[1]):
        logits, cache = decode_step(params, tok, cache, pos, config)
        tok.copy_(_sample_vec(logits, temps, seeds, counts))
        out[:, i].copy_(tok)
        pos.add_(1)
        counts.add_(1)
    return out


def _draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One 0-d int64 seed from ``generator`` (on its own device, so a CUDA
    generator draws without a host read), moved to ``device``."""
    seed = torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                         device=generator.device)
    return seed.to(device)


def _fill_sampling(temps, seeds, counts, temperature: float,
                   seed: torch.Tensor, count: int) -> None:
    """The sampler's per-row state for one call: every row at
    ``temperature``; row b's seed is ``seed + b`` (each row its own stream,
    _hash_bits masks to 32 bits); every count at ``count`` (0 for the first
    token, then one more per step)."""
    temps.fill_(temperature)
    torch.add(seed, torch.arange(seeds.shape[0], device=seeds.device),
              out=seeds)
    counts.fill_(count)


def _sampling_state(batch: int, temperature: float, seed: torch.Tensor,
                    count: int, device) -> tuple:
    temps = torch.empty(batch, dtype=torch.float32, device=device)
    seeds = torch.empty(batch, dtype=torch.long, device=device)
    counts = torch.empty(batch, dtype=torch.long, device=device)
    _fill_sampling(temps, seeds, counts, temperature, seed, count)
    return temps, seeds, counts


class _Session:
    """The captured programs of one (params, config, batch, max_len,
    device), and everything they read and write: a static cache that
    ``prefill`` programs fill (one per prompt length) and decode blocks
    extend, the loop's token, position and sampler state, and a memory pool
    of their own. Nothing of it reaches a caller: the public ``prefill``
    returns a copy of the cache, ``decode_loop`` copies a caller's cache in
    and the rows it wrote back, and ``generate`` returns tokens.

    A program is captured at its first use (``graphs.warm_up``, then
    ``graphs.capture``) from a body that closes over the params of that
    call, and keeps no reference to them after the capture: the graph reads
    their memory, so sessions are keyed on each parameter's address, shape
    and dtype (``_params_key``). Params updated in place are read anew by
    the next replay; params elsewhere get a session of their own."""

    def __init__(self, config: TransformerConfig, batch: int, max_len: int,
                 device: torch.device):
        self.config, self.device = config, device
        self.cache = init_kv_cache(config, batch, max_len, device=device)
        long = dict(dtype=torch.long, device=device)
        self.tok = torch.zeros(batch, **long)
        self.pos = torch.zeros((), **long)
        self.temps = torch.zeros(batch, dtype=torch.float32, device=device)
        self.seeds = torch.zeros(batch, **long)
        self.counts = torch.zeros(batch, **long)
        self.out = torch.zeros((batch, DECODE_BLOCK), **long)
        self.logits = torch.empty((batch, config.vocab_size),
                                  dtype=config.dtype, device=device)
        self.prompts: Dict[int, torch.Tensor] = {}
        self.programs: "collections.OrderedDict[tuple, graphs.Captured]" = (
            collections.OrderedDict())
        self.pool = torch.cuda.graph_pool_handle()

    def _program(self, key: tuple, body: Callable[[], None]):
        """The program ``key``, captured from ``body`` at its first use.
        The warm-up advances the loop's state, which is put back before the
        replay; the cache rows it wrote, the replay writes again."""
        prog = self.programs.get(key)
        if prog is None:
            loop = (self.tok, self.pos, self.counts)
            before = [t.clone() for t in loop]
            with torch.cuda.device(self.device):
                graphs.warm_up(body, self.device)
                prog = self.programs[key] = graphs.capture(body, self.pool)
            for t, b in zip(loop, before):
                t.copy_(b)
        return prog

    def prefill(self, params, tokens: torch.Tensor) -> None:
        """The prompt [B, S] through the stack into the static cache (rows
        from S on zeroed, as a new cache's are) and its last logits into
        ``self.logits``: one replay of the program for S."""
        c, cache = self.config, self.cache
        S = tokens.shape[1]
        if S not in self.prompts:
            self.prompts[S] = torch.zeros_like(tokens)
        prompt = self.prompts[S]

        def body():
            cache["k"][:, :, S:].zero_()
            cache["v"][:, :, S:].zero_()
            logits, _ = _forward_cached(params, prompt, cache, 0, c)
            self.logits.copy_(logits[:, -1, :])

        prompt.copy_(tokens)
        self._program(("prefill", S), body).replay()

    def decode(self, params, first_token, start_pos, temperature: float,
               seed: torch.Tensor, steps: int) -> torch.Tensor:
        """``steps`` decode steps over the static cache from ``first_token``
        at ``start_pos``, the first sampled with count 1: one replay per
        block of ``_block_plan(steps)``. Returns the tokens [B, steps]."""
        self.tok.copy_(first_token)
        if isinstance(start_pos, torch.Tensor):
            self.pos.copy_(start_pos)
        else:
            self.pos.fill_(start_pos)
        _fill_sampling(self.temps, self.seeds, self.counts, temperature,
                       seed, 1)
        toks = torch.empty((self.tok.shape[0], steps), dtype=torch.long,
                           device=self.device)
        done = 0
        for k in _block_plan(steps):
            out = self.out[:, :k]

            def body(out=out):
                decode_loop_into(params, self.cache, self.tok, self.pos,
                                 self.temps, self.seeds, self.counts,
                                 self.config, out)

            self._program(("decode", k), body).replay()
            toks[:, done:done + k].copy_(out)
            done += k
        return toks


# Sessions by signature, least recently used first; an evicted session's
# programs, static cache and pool go with it.
_MAX_SESSIONS = 2
_sessions: "collections.OrderedDict[tuple, _Session]" = (
    collections.OrderedDict())


def _captured(device: torch.device) -> bool:
    """Whether ``prefill``/``decode_loop``/``generate`` run through captured
    programs on ``device`` (CUDA), rather than eagerly."""
    return device.type == "cuda"


def _params_key(params) -> tuple:
    """Where each parameter lies, with its shape and dtype."""
    key = []
    for leaf in tree_leaves(params):
        for t in ((leaf.q, leaf.s) if isinstance(leaf, QTensor) else (leaf,)):
            key.append((t.data_ptr(), tuple(t.shape), t.dtype))
    return tuple(key)


def _session(params, config: TransformerConfig, batch: int, max_len: int,
             device: torch.device) -> _Session:
    key = (_params_key(params), config, batch, max_len, device)
    if key in _sessions:
        _sessions.move_to_end(key)
    else:
        while len(_sessions) >= _MAX_SESSIONS:
            _sessions.popitem(last=False)
        _sessions[key] = _Session(config, batch, max_len, device)
    return _sessions[key]


def release_programs() -> None:
    """Drops every session: its captured programs, static cache and memory
    pool return to the caching allocator."""
    _sessions.clear()


def programs() -> list:
    """(kind, replays, decode_attention launches recorded in the graph) of
    each captured program: kind ``("prefill", S)`` or ``("decode",
    steps)``."""
    return [(key, prog.replays, prog.launches["decode_attention"])
            for session in _sessions.values()
            for key, prog in session.programs.items()]


@torch.no_grad()
def prefill(params, tokens, config: TransformerConfig, max_len: int):
    """Prompt pass. Returns (last-token logits [B, V], cache), the cache a
    new one of ``max_len`` rows, as the reference's.

    On CUDA the pass is the captured program of (params, config, B, S,
    max_len) over its session's static cache, which is then copied out. On
    the CPU it runs eagerly into a new cache. Under ``no_grad`` (not
    inference mode), so the cache can be decoded into outside either."""
    if not _captured(tokens.device):
        cache = init_kv_cache(config, tokens.shape[0], max_len,
                              device=tokens.device)
        logits, cache = _forward_cached(params, tokens, cache, 0, config)
        return logits[:, -1, :], cache
    session = _session(params, config, tokens.shape[0], max_len,
                       tokens.device)
    session.prefill(params, tokens)
    return session.logits.clone(), {k: v.clone()
                                    for k, v in session.cache.items()}


@torch.no_grad()
def decode_loop(params, first_token, cache, start_pos,
                config: TransformerConfig, max_new_tokens: int,
                temperature: float, generator: torch.Generator):
    """N-step decode: feeds each sampled token back in; returns
    [B, max_new_tokens] and writes the rows it decodes into ``cache``.
    Sampling runs on the device (``_sample_vec``) from one seed drawn from
    ``generator`` per call, so the tokens are a function of the generator's
    state; greedy at temperature 0. On CUDA the steps are replays of the
    captured blocks of (params, config, B, max_len) (see ``_Session``):
    ``cache`` is copied into the session's static cache, and the rows the
    loop wrote are copied back."""
    batch, dev = first_token.shape[0], first_token.device
    seed = _draw_seed(generator, dev)
    if not _captured(dev):
        pos = torch.as_tensor(start_pos, device=dev).long().clone()
        out = torch.empty((batch, max_new_tokens), dtype=torch.long,
                          device=dev)
        return decode_loop_into(
            params, cache, first_token.to(torch.long, copy=True), pos,
            *_sampling_state(batch, temperature, seed, 1, dev), config, out)
    session = _session(params, config, batch, cache["k"].shape[2], dev)
    for key in ("k", "v"):
        session.cache[key].copy_(cache[key])
    toks = session.decode(params, first_token, start_pos, temperature, seed,
                          max_new_tokens)
    rows = start_pos + torch.arange(max_new_tokens, device=dev)
    for key in ("k", "v"):
        cache[key].index_copy_(2, rows,
                               session.cache[key].index_select(2, rows))
    return toks


@torch.no_grad()
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
    live. As the reference: ``prefill``, the first token sampled, then
    ``decode_loop``; on CUDA both are replays of one session's programs,
    whose cache never leaves it. One seed is drawn from ``generator``
    (default: a fresh one seeded 0) per call; row b samples from seed + b,
    its first token with count 0."""
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
    seed = _draw_seed(generator, dev)
    session = None
    if _captured(dev):
        session = _session(params, config, B, max_len, dev)
        session.prefill(params, prompt)
        logits = session.logits
    else:
        logits, cache = prefill(params, prompt, config, max_len)
    first = _sample_vec(logits, *_sampling_state(B, temperature, seed, 0,
                                                 dev))
    if max_new_tokens == 1:
        return first[:, None]
    if session is not None:
        rest = session.decode(params, first, S, temperature, seed,
                              max_new_tokens - 1)
    else:
        rest = decode_loop_into(
            params, cache, first.clone(), torch.tensor(S, device=dev),
            *_sampling_state(B, temperature, seed, 1, dev), config,
            torch.empty((B, max_new_tokens - 1), dtype=torch.long,
                        device=dev))
    return torch.cat([first[:, None], rest], dim=1)
