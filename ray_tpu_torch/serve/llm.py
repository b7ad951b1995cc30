"""Iteration-level continuous batching for LLM serving (replica-side).

Port of ``ray_tpu/serve/llm.py``'s ``LLMEngine`` and ``LLMServer``:

- a FIXED pool of decode slots over one shared KV cache;
- the engine thread loops: admit pending requests into free slots (per-slot
  prefill writes straight into the shared cache), run one decode BLOCK for
  all active slots, ship each slot's tokens to its consumer;
- a request arriving mid-decode waits one block + its prefill, not a whole
  batch completion;
- finished slots free immediately and the next pending request takes the
  slot on the following iteration.

The engine serves through fixed programs, as the reference does ("XLA
compiles exactly two programs: bucketed prefill-insert and one multi-position
decode step", ``ray_tpu/serve/llm.py:9-12``). On CUDA each program is a CUDA
graph captured once in the constructor (``_warm_blocks``): one per decode
block length and one prefill-insert per bucket, all in one memory pool. The
slot state (next token, position, temperature, seed, sample count) lives on
the device, sampling runs on the device, and serving only copies inputs into
the graphs' static buffers and replays them. On the CPU (the tests' path,
taken only when the caller asks for it) the same programs run eagerly.

Device work is queued on the engine thread's CUDA stream and the host reads
results through copies that an event marks done, so the one wait per block
covers that block alone: block k + 1 is queued before block k's tokens are
read (pipeline depth 1), and the device never waits on the host.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ray_tpu_torch import graphs
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.generation import (
    _sample_vec,
    decode_block_into,
    init_kv_cache,
    prefill_into_slot,
    prepare_for_inference,
)
from ray_tpu_torch.models.transformer import tree_map

_END = object()


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "temperature", "out", "seed",
                 "produced", "cancelled", "finished")

    def __init__(self, prompt, max_new_tokens, temperature, seed):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.seed = seed
        self.out: "queue.Queue" = queue.Queue()
        self.produced = 0
        self.cancelled = False
        self.finished = False


def _to_host_async(t: torch.Tensor):
    """Starts a device->host copy of ``t`` behind the work queued so far;
    returns (host tensor, event that marks it done; None on the CPU). ``t``
    may be a program's static buffer, which the program's next run
    overwrites: on the CPU the copy is a clone, on CUDA it is queued before
    that run."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = t.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    # the copy runs on the current stream of t's device, which need not be
    # the current device (LLMEngine(device="cuda:1"))
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def _host_values(host: torch.Tensor, done) -> np.ndarray:
    if done is not None:
        done.synchronize()
    return host.numpy()


def _prefill_program(params, args, temp, cache, tok, pos, temps, seeds,
                     counts, config):
    """The engine's prefill-insert program for one bucket: the reference's
    ``prefill_into_slot``, its first-token sample (``_first_token``,
    ``ray_tpu/serve/llm.py:245-258``) and the slot writes (``:235-241``),
    all on the device. ``args`` is int64 [bucket + 3]: the padded prompt,
    then its length, the slot and the seed; ``temp`` is fp32 [1]. The first
    token lands in ``tok`` at the slot."""
    b = args.shape[0] - 3
    prompt_len, slot, seed = args[b], args[b + 1], args[b + 2:]
    logits, _ = prefill_into_slot(params, args[:b].view(1, b), prompt_len,
                                  slot, cache, config)
    idx = slot.reshape(1)
    first = _sample_vec(logits[None], temp, seed, torch.zeros_like(idx))
    tok.index_copy_(0, idx, first)
    pos.index_copy_(0, idx, prompt_len.reshape(1))
    temps.index_copy_(0, idx, temp)
    seeds.index_copy_(0, idx, seed)
    counts.index_fill_(0, idx, 1)


class LLMEngine:
    """Continuous-batching decode engine over one model + one KV cache.

    ``max_slots``: concurrent sequences (the decode batch width).
    ``max_len``: per-slot KV capacity.
    ``prefill_buckets``: prompt pad lengths.
    ``eos_id``: generation stops early when the model emits it (None =
    always run to max_new_tokens).
    ``device``: where the model runs (CUDA by default).
    """

    def __init__(self, params, config, *, max_slots: int = 8,
                 max_len: int = 1024,
                 prefill_buckets: tuple = (64, 128, 256, 512, 1024),
                 eos_id: Optional[int] = None, block_steps: int = 8,
                 burst_block_steps: int = 2, pipeline: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        params = tree_map(lambda x: x.to(self.device), params)
        params, config = prepare_for_inference(params, config)
        self.params = params
        self.config = config
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_len))
        self.eos_id = eos_id
        # Decode runs in BLOCKS of this many steps (one [B, K] host transfer
        # per block). ADAPTIVE length: while the engine is lightly loaded
        # (<= half the slots active) it runs short ``burst_block_steps``
        # blocks so a burst arrival waits a couple of steps, not a whole
        # long block, before admission; at saturation the long blocks keep
        # steady throughput.
        self.block_steps = max(1, int(block_steps))
        self.burst_block_steps = min(
            self.block_steps, max(1, int(burst_block_steps))
        )
        # pipeline depth 1: dispatch block k+1 before fetching block k's
        # tokens, so the device never waits on the host
        self.pipeline = pipeline
        self.cache = init_kv_cache(config, max_slots, max_len,
                                   device=self.device)
        dev = self.device
        # device-side slot state, as the reference keeps it (:102-106): next
        # token, its absolute position, sampling temperature, seed, sample
        # counter. Updated in place only: the programs hold these tensors.
        self.tok = torch.zeros(max_slots, dtype=torch.long, device=dev)
        self.pos = torch.zeros(max_slots, dtype=torch.long, device=dev)
        self.temps = torch.zeros(max_slots, dtype=torch.float32, device=dev)
        self.seeds = torch.zeros(max_slots, dtype=torch.long, device=dev)
        self.counts = torch.zeros(max_slots, dtype=torch.long, device=dev)
        # the programs and their static inputs and outputs: a decode block's
        # tokens [B, K] per length K; per bucket, the padded prompt, its
        # length, slot and seed; the admitted request's temperature
        self._state = state = (self.tok, self.pos, self.temps, self.seeds,
                               self.counts)
        self._block_out = {}
        self._prefill_args = {}
        self._prefill_temp = torch.zeros(1, dtype=torch.float32, device=dev)
        self._programs = {}
        for k in sorted({self.burst_block_steps, self.block_steps}):
            self._block_out[k] = torch.zeros((max_slots, k), dtype=torch.long,
                                             device=dev)
            self._programs[("decode", k)] = functools.partial(
                decode_block_into, self.params, self.cache, *state,
                self.config, self._block_out[k])
        for b in self.buckets:
            self._prefill_args[b] = torch.zeros(b + 3, dtype=torch.long,
                                                device=dev)
            self._programs[("prefill", b)] = functools.partial(
                _prefill_program, self.params, self._prefill_args[b],
                self._prefill_temp, self.cache, *state, self.config)
        self._graphs = {}  # CUDA: program key -> its captured CUDAGraph
        # observability: replays per graph, and the int8_matmul and
        # decode_attention kernel launches recorded in each graph (each
        # replay launches them again)
        self.graph_replays = dict.fromkeys(self._programs, 0)
        self.graph_int8_launches = {}
        self.graph_decode_attention_launches = {}
        # host-side slot table
        self.slot_req: List[Optional[_Request]] = [None] * max_slots
        self.pending: "collections.deque[_Request]" = collections.deque()
        self._pending_first: List = []  # (req, slot) admitted, not emitted
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._failure: Optional[BaseException] = None
        self._steps = 0  # decode iterations (observability)
        self._warm_blocks()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    def _warm_blocks(self):
        """Builds every program before the engine takes traffic, as the
        reference compiles both block lengths (``:128-140``): on CUDA it
        captures one graph per decode block length and per prefill bucket,
        all in one memory pool (they never run at once), after a warm-up run
        on a side stream; a failed capture raises. On the CPU each program
        runs once. The warm-up prefills a 1-token prompt into slot 0 and the
        warm-up decode writes rows 0..K-1 of every slot; the state reset
        below and prefill's whole-row rewrite make that invisible."""
        for b, args in self._prefill_args.items():
            args[b] = 1  # prompt length 1 (slot 0, seed 0)
        with torch.inference_mode():
            if self.device.type != "cuda":
                for program in self._programs.values():
                    program()
            else:
                self._capture_graphs()
        for t in self._state:
            t.zero_()

    def _capture_graphs(self):
        dev = self.device
        with torch.cuda.device(dev):
            graphs.warm_up(lambda: [p() for p in self._programs.values()],
                           dev)
            pool = torch.cuda.graph_pool_handle()
            for key, program in self._programs.items():
                cap = graphs.capture(program, pool)
                self.graph_int8_launches[key] = cap.launches["int8_matmul"]
                self.graph_decode_attention_launches[key] = cap.launches[
                    "decode_attention"]
                self._graphs[key] = cap.graph
            torch.cuda.synchronize(dev)

    def _run(self, key):
        """Runs one program: its graph's replay on CUDA, the program itself
        on the CPU."""
        if self.device.type == "cuda":
            self._graphs[key].replay()
            self.graph_replays[key] += 1
        else:
            self._programs[key]()

    # -- public --

    def submit(self, prompt_ids, max_new_tokens: int = 64,
               temperature: float = 0.0, seed: int = 0) -> _Request:
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + new {max_new_tokens} exceeds "
                f"engine max_len {self.max_len}"
            )
        if len(prompt) > self.buckets[-1]:
            raise ValueError(
                f"prompt {len(prompt)} exceeds largest prefill bucket "
                f"{self.buckets[-1]}"
            )
        req = _Request(prompt, int(max_new_tokens), float(temperature),
                       int(seed))
        if self._stop or self._failure is not None or (
            not self._thread.is_alive()
        ):
            raise RuntimeError(
                "LLMEngine is not running"
            ) from self._failure
        with self._lock:
            self.pending.append(req)
        self._work.set()
        return req

    def generate_stream(self, prompt_ids, max_new_tokens: int = 64,
                        temperature: float = 0.0, seed: int = 0):
        """Generator of token ids; the engine produces them between its
        decode blocks (iteration-level admission)."""
        req = self.submit(prompt_ids, max_new_tokens, temperature, seed)
        try:
            while True:
                item = req.out.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            req.cancelled = True  # consumer gone: free the slot next step

    def generate(self, prompt_ids, **kw) -> List[int]:
        return list(self.generate_stream(prompt_ids, **kw))

    def stats(self):
        with self._lock:
            return {
                "steps": self._steps,
                "active": sum(r is not None for r in self.slot_req),
                "pending": len(self.pending),
                "graph_replays": sum(self.graph_replays.values()),
            }

    def shutdown(self):
        self._stop = True
        self._work.set()
        self._thread.join(timeout=10)

    # -- engine loop --

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets")

    def _admit(self):
        """Fill free slots from the pending queue (one prefill each).
        NOTHING here waits on the device: the first token is sampled on the
        device and emitted after the next block is dispatched."""
        while True:
            with self._lock:
                free = next(
                    (i for i, r in enumerate(self.slot_req) if r is None),
                    None,
                )
                if free is None or not self.pending:
                    return
                req = self.pending.popleft()
            if req.cancelled:
                continue
            n = len(req.prompt)
            b = self._bucket_for(n)
            args = np.zeros(b + 3, np.int64)
            args[:n] = req.prompt
            args[b:] = (n, free, req.seed)
            host = torch.from_numpy(args)
            if self.device.type == "cuda":
                # pinned, so the copy queues behind the running block without
                # stalling the host
                host = host.pin_memory()
            self._prefill_args[b].copy_(host, non_blocking=True)
            self._prefill_temp.fill_(req.temperature)
            self._run(("prefill", b))
            self.slot_req[free] = req
            self._pending_first.append((req, free))

    def _emit(self, req: Optional[_Request], token: int) -> bool:
        """Deliver one token to a request; True if the request finished."""
        if req is None or req.finished:
            return True
        req.out.put(token)
        req.produced += 1
        done = (
            req.produced >= req.max_new_tokens
            or (self.eos_id is not None and token == self.eos_id)
            or req.cancelled
        )
        if done:
            req.finished = True
            req.out.put(_END)
        return done

    def _stage_firsts(self):
        """Queues the host copy of the slots' next tokens, which hold the
        admitted requests' first tokens, BEFORE the next block overwrites
        them, so reading them waits on the prefills only."""
        firsts, self._pending_first = self._pending_first, []
        if not firsts:
            return None
        return firsts, _to_host_async(self.tok)

    def _dispatch_block(self):
        """Queue one K-step decode block; returns its tokens' pending host
        copy and a snapshot of which request owned each slot at dispatch
        time. K adapts to load (see __init__): light load -> short blocks
        -> short admission waits."""
        active = sum(
            r is not None and not r.finished for r in self.slot_req
        )
        steps = (
            self.block_steps
            if active > self.max_slots // 2
            else self.burst_block_steps
        )
        self._run(("decode", steps))
        self._steps += steps
        snapshot = list(self.slot_req)  # slot -> req at dispatch
        return _to_host_async(self._block_out[steps]), snapshot

    def _retire_firsts(self, staged):
        """Emit admitted requests' first tokens. Called right after the next
        block is dispatched: the copy was queued before it, so this waits
        only on the prefills while the block keeps the device busy."""
        if staged is None:
            return
        firsts, pending = staged
        toks = _host_values(*pending)
        for req, slot in firsts:
            self._emit(req, int(toks[slot]))

    def _retire_block(self, pending, snapshot):
        """Wait for one block's tokens and deliver them in step order."""
        toks = _host_values(*pending)  # [B, K]: THE one wait per block
        for k in range(toks.shape[1]):
            for slot, req in enumerate(snapshot):
                if req is None or req.finished:
                    continue
                self._emit(req, int(toks[slot, k]))
        # free slots whose requests finished (table may already have a
        # NEWER request in the slot: only clear if it's still this one)
        for slot, req in enumerate(snapshot):
            if req is not None and req.finished and (
                self.slot_req[slot] is req
            ):
                self.slot_req[slot] = None

    def _loop(self):
        inflight: "collections.deque" = collections.deque()
        depth = 1 if self.pipeline else 0
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        try:
            # grad mode and the current device are per thread: the engine
            # thread sets its own
            with torch.inference_mode(), on_card:
                while not self._stop:
                    self._admit()
                    active = any(r is not None and not r.finished
                                 for r in self.slot_req)
                    if active:
                        firsts = self._stage_firsts()
                        inflight.append(self._dispatch_block())
                        self._retire_firsts(firsts)
                    while len(inflight) > (depth if active else 0):
                        self._retire_block(*inflight.popleft())
                    if not active and not self.pending and not inflight:
                        self._work.wait(timeout=0.05)
                        self._work.clear()
        except BaseException as e:  # device error / teardown
            self._failure = e
        finally:
            # no consumer may block forever on a dead engine: fail every
            # live and pending request explicitly
            err = self._failure or RuntimeError("LLMEngine shut down")
            for req in list(self.slot_req) + [r for r, _ in
                                              self._pending_first]:
                if req is not None and not req.finished:
                    req.finished = True
                    req.out.put(err if self._failure else _END)
                    req.out.put(_END)
            with self._lock:
                pending, self.pending = list(self.pending), (
                    collections.deque()
                )
            for req in pending:
                if not req.finished:
                    req.finished = True
                    req.out.put(err if self._failure else _END)
                    req.out.put(_END)


class LLMServer:
    """Deployment-ready wrapper: construct with a model factory returning
    ``(params, config)``; expose streaming + blocking generation. The
    deployment plane is not ported yet, so this is a plain class."""

    def __init__(self, model_factory: Callable, *, max_slots: int = 8,
                 max_len: int = 1024, eos_id: Optional[int] = None,
                 prefill_buckets: tuple = (64, 128, 256, 512, 1024),
                 device: DeviceLike = None):
        params, config = model_factory()
        self.engine = LLMEngine(
            params, config, max_slots=max_slots, max_len=max_len,
            eos_id=eos_id, prefill_buckets=prefill_buckets, device=device,
        )

    def generate_stream(self, prompt_ids, max_new_tokens: int = 64,
                        temperature: float = 0.0, seed: int = 0):
        yield from self.engine.generate_stream(
            prompt_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed,
        )

    stream = generate_stream

    def __call__(self, prompt_ids, max_new_tokens: int = 64,
                 temperature: float = 0.0, seed: int = 0) -> List[int]:
        return self.engine.generate(
            prompt_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed,
        )

    def stats(self):
        return self.engine.stats()
