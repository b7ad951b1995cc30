"""On-card smoke of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py                  # every phase (what a check runs)
    timeout 300 python3 chip_smoke.py kernel   # the kernel phases only
    timeout 300 python3 chip_smoke.py decode_kernel  # the decode kernel only
    timeout 600 python3 chip_smoke.py serve_7b # the serve_7b phase only
    timeout 600 python3 chip_smoke.py train    # the train phase only
    timeout 600 python3 chip_smoke.py inference  # the inference phase only
    timeout 600 python3 chip_smoke.py mesh     # the mesh phase only
    timeout 700 python3 chip_smoke.py moe      # the moe phase only
    timeout 450 python3 chip_smoke.py seq      # the seq phase only
    timeout 450 python3 chip_smoke.py pipe     # the pipe phase only
    timeout 600 python3 chip_smoke.py runtime  # the runtime phase only
    timeout 600 python3 chip_smoke.py mesh_group  # the mesh_group phase only
    timeout 600 python3 chip_smoke.py data     # the data phase only
    timeout 600 python3 chip_smoke.py tune     # the tune phase only
    timeout 600 python3 chip_smoke.py rl       # the rl phase only
    timeout 600 python3 chip_smoke.py platform # the platform phase only
    timeout 600 python3 chip_smoke.py projection  # the projection phase only
    timeout 600 python3 chip_smoke.py micro    # the micro phase only
    python3 chip_smoke.py multicard            # four cards; not in the default run

Run from the repo root on a machine with one CUDA card. Twenty-one phases,
run in the order below but for serve_7b and micro, which run right after
the kernel phases, and projection, which runs right after serve; any
failure raises and the script exits non-zero without a result line. A
profiled replay whose kernels counted by name fall short of what its graph
holds is read again, up to three readings (``profile_launches``: the
profiler has lost a kernel's record now and then); the checks read the
last reading, and the readings go beside it (``launch_readings``). With
the argument ``kernel`` (or ``decode_kernel``, ``serve_7b``, ``train``,
``inference``, ``mesh``, ``moe``, ``seq``, ``pipe``, ``runtime``,
``mesh_group``, ``data``, ``tune``, ``rl``, ``platform``, ``projection``,
``micro``) it runs the kernel
phases (or that phase, ``decode_kernel`` building its kernel first) alone
and prints no result line: the first call after a kernel (or that path)
changes, under ``timeout``. ``multicard`` needs four cards (it raises with
fewer): it starts four NCCL ranks of this script, one per card
(``multicard-rank <rank> <world> <port>``), trains ``bench_400m`` at
[8, 2048] with ring attention over dp 2 x sp 2, Ulysses over sp 2 x tp 2,
4 experts over ep 2 x dp 2, and, with dense attention, as a pipeline: 1F1B
over pp 4 (8 microbatches), GPipe over dp 2 x pp 2 (4) and 1F1B over pp 2 x
tp 2 (4); 4 steps each (warm-up, capture, two replays), each step's loss
within ``MESH_LOSS_RTOL`` of the one-card run of the same seed and batches
(dense attention for ring, Ulysses and the pipelines, the same MoE model
for the experts), runs ``dryrun_multidevice(4)`` (parts 1, 2, 2c and 3),
and prints replay ms, the device ms in NCCL collectives and the peak memory
per layout. Then the runtime on the four cards (``multicard_runtime``) and a
MeshGroup over two simulated hosts of two cards each
(``multicard_mesh_group``): ``{"dp": 2, "tp": 2}``, rank 1 SIGKILLed after a
checkpoint, recovered onto ``{"dp": 4, "tp": 1}``; and a dp 4
``TorchTrainer`` fed from a ``Dataset`` of 32 files
(``multicard_data``): every row reaches exactly one rank, on four distinct
cards, rank r's batches being the blocks with ``idx % 4 == r``; and
IMPALA's learner over four learner actors on four distinct cards
(``multicard_rl``): the dp 4 update on one batch against one learner's,
then 3 async iterations with 4 workers; and ``ray_perf``'s mesh group and
data plane legs with their ranks on the cards (``multicard_micro``: four
NCCL ranks over dp 2 x tp 2, two over dp 2, each rank on a distinct card
by its uuid).

1. kernel: builds every CUDA kernel from ``ray_tpu_torch/ops/csrc`` (nvcc,
   sm_90a, one process per source, all at once) and prints ptxas's
   registers, shared memory and spills for each; holds the forward kernel
   and the two backward kernels (dQ with the delta it fuses, dK/dV on that
   delta) against their plain PyTorch versions on the card, at the 400M
   model's shapes, at the projection phase's anchor step's ([4, 2048, 16,
   256] causal) and at others (ragged S, GQA, fp32, and the head dims the
   kernels pad: 16, 32, 64, 96, 192, 256), and times kernels, plain
   versions and the library yardsticks (SDPA forward and backward) at the
   400M model's shapes (CUDA events, after warm-up).
2. int8_kernel: ``int8_matmul`` against its plain version under a stated
   bound, at serve_7b's six weight shapes at M 8 (decode) and 128 (prefill)
   in bf16 and fp32, at ragged M (1, 3, 17, and the fp32 check's 2, 40, 64)
   and at ``tiny``'s widths; every case also bit-equal across two launches
   and with row 0 computed alone. Device times inside CUDA graphs (kernel,
   plain version, ``torch._weight_int8pack_mm``, a bf16 product over
   pre-dequantized weights) per shape, per decode step and per prefill;
   ptxas's registers and spills of the int8 kernels, and each shape's
   launch plan (K split, ring stages, wgmma N, workspace).
3. decode_kernel: ``decode_attention`` against its plain version under
   ``DECODE_RTOL``, in bf16 and fp32, at D 16, 64, 96, 128, 192 and 256,
   n_rep 1, 2, 3, 4 and 8, clusters of 1, 2, 4 and 8 blocks, with and
   without the self column, at lengths 0 (self alone), 1, below the
   cluster's size, around every tile edge (and so every edge of a
   cluster's shares), S_max - 1, S_max and past it; in every case the
   rows at or past a slot's length set to NaN, and to zeros, give the same
   output bit for bit, and so does a second launch. Then at the main
   paths' own shapes (serve_7b's engine step: 8 slots at position 160 of
   512, self column; bench.py's inference leg: lengths 1025..1088 of 1089;
   the 400M engine's step: 8 slots at 300 of 1024, self column), each with
   one more call at ragged
   per-slot lengths: the kernel against its plain version on the same
   operands in bf16 and fp32, and device times inside CUDA graphs (kernel,
   plain version, SDPA with a boolean mask, bound) per call and per step,
   with each shape's launch plan (cluster, tile rows, ring stages, shared
   memory, clusters the card holds at once: all of the grid's, checked),
   the host cost of an eager call, and ptxas's registers and spills.
4. forward: ``bench_400m`` (full width: 24 layers, d_model 1024, 8 heads x
   128) in bf16 from a seeded random init, ``forward`` and ``loss_fn`` on
   tokens [8, 2048]; the flash kernel must launch exactly once per layer and
   the logits must agree with the dense-attention forward.
5. train: ``bench_400m`` (remat "dots", flash) trained as the reference's
   loops train it: seeded numpy batches [8, 2048] (a cycle of 4) through
   the port's pump (``data.device_batches``) into ``make_train_step``,
   which runs step 1 eagerly (warm-up), captures step 2 as one CUDA graph
   and replays it from then on; a ``save_sharded`` checkpoint after step 8,
   written while steps 9-14 train. Checks: the flash wrappers count 48 /
   24 / 24 for the eager step and for the capture and nothing for the 13
   replays, and one profiled replay launches the kernels 48 / 24 / 24
   times by name; loss and grad norm finite, the loss of the last cycle
   below the first; eager steps from a state of the same seed equal the
   captured ones bit for bit; the checkpoint restored into a fresh state
   equals the saved state bit for bit, and its next step equals the
   original's, every tensor included. Printed: replay ms (CUDA events),
   tokens/s, MFU, host ms per call, wall ms per replay, device-busy share
   of a replay, peak memory eager and captured, eager step ms, the pump's
   prefetch and hidden host time, and the checkpoint's bytes, snapshot ms,
   write and restore seconds.
6. mesh: ``bench_400m`` as the train phase trains it, over a one-card mesh:
   a world-size-1 NCCL process group, ``build_mesh(MeshConfig(dp=1))``,
   ``make_sharded_state`` / ``make_train_step`` with ``mesh=`` fed by
   ``device_batches(..., sharding=batch_sharding(mesh))``, under
   ``DEFAULT_RULES`` and then ``FSDP_RULES``, 6 steps each (step 1 the
   warm-up, step 2 the capture, steps 3-6 replays), beside the one-device
   step from the same seed and batches. Checks: losses, grad norms and
   every parameter after step 6 equal the one-device step's (expected bit
   for bit: every placement is whole at world size 1 and no collective
   runs; a difference is printed and the loss must stay within
   ``MESH_LOSS_RTOL``); one profiled replay of each launches the flash
   kernels 48 / 24 / 24 times by name; the mesh state's checkpoint restores
   into a one-device state bit for bit, and that state's into a mesh state.
   Printed: replay ms (CUDA events) and peak memory of the one-device step
   and of each rules table.
7. moe: ``bench_400m`` with 4 experts, top-2, capacity factor 2 (971.6 M
   parameters) trained as the mesh phase trains ``bench_400m``: 6 steps at
   [8, 2048] through the pump (steps 3-6 replays), 48 / 24 / 24 flash
   launches per replay by name, losses finite and falling over the cycle,
   three eager steps equal to the captured ones bit for bit, the same
   training over a one-card mesh equal to one device bit for bit; layer 0's
   ``moe_ffn`` at full width against its one-hot plain version (bf16, one
   ulp) with the same picks dropped; picks dropped per layer; greedy
   ``generate`` (8 x 128 prompt, 16 new tokens) through its graphs equal
   to its bodies run uncaptured. Printed: replay ms, tokens/s, peak
   memory, device ms by kind of a profiled replay.
8. seq: over a one-card mesh, ``bench_400m``'s forward with ring and with
   Ulysses attention against the dense-attention forward (the forward
   phase's tolerance), ``ulysses_attention(..., attn_impl="flash")`` at
   [8, 2048, 8, 128] bf16 equal to ``flash_attention`` bit for bit, and 3
   train steps of each (warm-up, capture, replay): finite losses, replay
   ms and peak memory.
9. pipe: ``bench_400m`` with dense attention (the pipeline's stages run
   dense attention) through ``make_pipeline_train_step`` over a one-card
   mesh, 8 microbatches of one row, under GPipe and under 1F1B: 6 steps
   each through the pump (warm-up, capture, replays). At pp = 1 the
   schedule, its ring buffer and the scoring run, but no hop. Checks: no
   flash kernel in a profiled replay; the first loss within
   ``MESH_LOSS_RTOL`` of the non-pipelined dense loss on the same weights
   and batch; three eager steps from a fresh state equal the captured ones
   bit for bit; 1F1B's peak memory during an eager step at most 1.05 times
   GPipe's. Printed: replay ms, tokens/s, MFU, peaks, device ms and
   launches by kind.
10. grad: the flash grads of ``loss_fn`` against the dense-attention grads,
   at the 400M width with 2 layers in fp32 (TF32 off), and the full-depth
   bf16 train steps' losses and grad norms, flash against dense (step 1
   held to a tolerance, the rest reported).
11. inference: bench.py's inference leg (``measure_inference``) on the port:
   ``bench_400m`` with dense attention, no remat, bf16, 8 prompts of 1024
   tokens, 64 new tokens, max_len 1089. ``prefill`` (TTFT) and
   ``decode_loop`` (decode tokens/s) timed at the second call of each, the
   first having captured its programs; the timed loop runs no eager decode
   step and replays its captured blocks of steps, whose graphs and a
   profiled replay hold one decode attention call per layer per step (24).
   The first and second calls of a 256- and a 1023-step loop are timed
   (capture cost and memory). The captured ``generate`` must give the same
   greedy tokens as its bodies run uncaptured on the card; in float32 with
   TF32 off, the engine's decode program, captured with
   ``RAYTPU_DECODE_DEFERRED_WRITES`` unset and set, gives ``generate``'s
   tokens (the two structures bit for bit alike).
12. serve: ``LLMEngine`` over ``bench_400m`` in bf16 answers 8 concurrent
   greedy requests from client threads through its CUDA graphs (graph
   replays > 0, no decode step run eagerly during the traffic, one decode
   attention launch per layer per decode step); one
   temperature-1 request twice gives the same tokens; the sampler's hash
   bits equal on the CPU and the card; a decode block replayed from a graph
   and run eagerly, each profiled; then, in float32 with TF32 off, the
   engine's greedy tokens for 3 interleaved prompts must EQUAL
   ``generate``'s.
13. serve_7b: ``serve_7b`` (6.7B parameters, 32 layers, d_model 4096, 32
   heads x 128, full width and depth) from ``init_params_int8`` on the card
   (weight bytes and peak memory printed), served through ``LLMEngine``'s
   graphs at bench.py's shape (8 slots, max_len 512, prefill bucket 128,
   blocks of 8 steps): 8 concurrent greedy requests of 128-token prompts
   and 64 new tokens (TTFT median and max, decode tokens/s with 8 slots
   active), the same graph and sampling checks as serve, int8_matmul
   launches per decode step counted over the graphs' replays (6 per layer)
   and decode attention launches (1 per layer),
   and the profiled decode blocks (graph and eager; device time by kind;
   the graph's block also captured with ``RAYTPU_DECODE_DEFERRED_WRITES=1``
   and timed in turns with the default; the plain dequant's time per step,
   which the kernel took off the path);
   the same on bf16 weights of the same init (no int8 launch). Checks: 8
   valid 64-token streams each time; in float32 with TF32 off, the engine's
   greedy tokens EQUAL ``generate``'s on the int8 weights at full depth
   (through the graphs and the kernel); int8 against bf16 logits on one
   128-token prompt within ``INT8_LOGITS_RTOL`` at 2 layers (full depth
   reported). No flash kernel runs here (dense attention, as in JAX): the
   phase reports ``flash_launches`` 0.
14. runtime: the port's own runtime planes (``ray_tpu_torch.init`` with
   no resources given: the GCS, a raylet with its shared-memory store in
   /dev/shm, workers) on the card. Checks ``GPU`` granted equals the CUDA
   device count and that /dev/shm holds the store with room; times the
   GPU probe, ``init``, a no-op CPU task's round trip (median of 200 after
   20 warm-up calls) and the first ``num_gpus=1`` call (worker spawn,
   torch import, CUDA context), and reads the card memory the idle GPU
   worker then holds. ``bench_400m``'s parameters, made from the
   seed, are ``put`` once as the reference's numpy tree (``params_to_numpy``,
   1.47 GB fp32). A ``num_gpus=1`` task gets them, builds the state
   through ``params_from_numpy`` and trains 4 captured steps at [8, 2048]
   (warm-up, capture, two replays, the last profiled); its losses and grad
   norms must equal bit for bit the same steps run in this process on the
   same tree and batches, with 48 / 24 / 24 flash launches per replay by
   name on both sides. A ``TorchTrainer`` of one ``use_gpu`` worker runs
   the same steps on the same tree and batches (its losses and grad norms
   bit for bit equal, 48 / 24 / 24 flash launches per replay); rank 0
   reports the parameters once, at the end, as the checkpoint, and the
   driver's persisted copy, loaded back through ``params_from_numpy``, must
   equal the worker's parameters bit for bit (sha256 over every leaf);
   the report-to-persist time and the wall time from ``fit()`` to its
   ``Result`` are printed. ``LLMServer`` then runs as a bare actor,
   ``remote(num_gpus=0.5, max_concurrency=16)`` (the reference's options
   for it, ray_tpu/serve/llm.py:371-372, with half the card: it shares the
   one card with the deployment), and as a Serve deployment
   (``serve.run`` of an ``LLMServer`` subclass, ``ray_actor_options``
   ``num_gpus`` 0.5 and ``max_concurrency`` 16) streamed through its
   handle, their model factory taking the weights' ref: 8 concurrent
   greedy requests of 128-token prompts and 64 new tokens, each stream
   consumed by a driver thread (TTFT and decode tokens/s measured in the
   driver, beside the same traffic on an in-process engine: 5 rounds on
   each of the three sides, in turns, with the median, least and greatest
   of each figure); every decode step a graph replay with one decode
   attention launch per layer on the actor and the deployment (from
   ``stats()``). In float32 with TF32 off, an actor's greedy tokens and a
   ``num_gpus=1`` deployment's for 3 prompts must EQUAL ``generate``'s in
   this process. After ``serve.delete`` and ``shutdown()`` no process of
   the session may be left and nvidia-smi may list no compute process but
   this one.
15. mesh_group: ``bench_400m`` trained in a ``MeshGroup`` (``ray_tpu_torch/
   mesh/``) on a local session with one ``GPU`` node: one rank, one process
   on the card (``resources_per_host`` ``{"CPU": 1, "GPU": 1}``), joined by
   NCCL, ``{"dp": 1}``; a small product compiled through both plan paths
   (DTensor placements, ``local_map``) must give equal outputs; the state
   from ``make_sharded_state`` of seed ``SEED`` on the rank's mesh, the
   train step (the port's captured ``TrainStep``) compiled through
   ``compile_step_with_plan`` with both plans given; 4 steps at [8, 2048]
   on the train phase's batches, ``save_state(step=4)``, SIGKILL of the
   rank's process, which must raise ``RankFailedError`` (rank 0, epoch 1)
   and leave the gang ``BROKEN``; ``recover()`` (restored step 4, epoch 2,
   a new process) and 4 more steps. Checks: the 8 losses and grad norms
   equal the train phase's first 8 (in this process) bit for bit; in the
   worker, the flash wrappers count 48 / 24 / 24 at the warm-up and again
   at the capture and nothing across replays, and a profiled replay
   launches the kernels 48 / 24 / 24 times by name, before and after the
   recovery. Printed: the gang's bring-up, state-init, ``save_state`` and
   ``recover()`` seconds, and its replay ms beside this process's.
16. data: ``bench_400m`` at ``LIBRARY_LAYERS`` (4) layers (so are tune's and
   platform's; their twin in process: ``gang_in_process`` at that depth)
   fed from a ``Dataset`` (``ray_tpu_torch/data/``)
   on a local session with one ``GPU`` node. Eight ``.npy`` files, file i
   the token ids behind the train phase's step i ([8, 2049] int64, the
   cycle's batch i % 4), read by ``read_numpy(dir, parallelism=8)`` and
   ``map_batches(to_lm_batch)`` (tokens, targets, a mask of ones: the train
   phase's dtypes) in CPU tasks, then split by the coordinator actor
   (``streaming_split``) and landed on the card by
   ``iter_device_batches(batch_size=8, prefetch_batches=2,
   prefetch_blocks=2)``, in two consumers. A ``TorchTrainer(datasets=)`` of
   one ``use_gpu`` worker takes 8 captured steps from the train phase's
   initial state (seed ``SEED``) through ``session.get_dataset_shard``;
   then a one-card ``MeshGroup`` (``{"dp": 1}``) through ``split_dataset``,
   its rank iterating its split, laid out over its mesh, into the gang's
   train step (``GangTrainStep``) for 8 steps. Checks: every batch a CUDA
   tensor on the worker's ``cuda:0``; every row once, in file order; the
   8 losses and grad norms equal the twin's first 8 bit for bit in
   both consumers; 8 / 4 / 4 flash launches per replay by name in each
   worker; the coordinator's executor routed its launches by the gang's
   node (``routed_launches`` > 0). The trainer's worker saves its state
   after step 8 (``save_sharded``); the driver uploads it
   (``upload_sharded_checkpoint``, ``file://``), downloads it to a fresh
   directory and ``load_sharded``s it into a live state: equal bit for bit
   to the worker's (sha256 over every tensor). Printed: replay ms beside
   the train phase's, ``fit()`` s, the ingest stall, batches waiting when
   asked, rows/s and bytes/s from the first block to the last batch, the
   gang's call-to-first-step time, the upload and download s and GB/s.
17. tune: ``Tuner`` over ``bench_400m`` at full width and 4 layers, two trials
   (``lr`` 3e-4 and 1e-3, a grid) at ``{"CPU": 1, "GPU": 0.5}`` at once
   (``max_concurrent_trials=2``) under ``ASHAScheduler(metric="loss",
   mode="min", grace_period=2, reduction_factor=2, max_t=4)``. Each trial
   builds the train phase's initial state (seed ``SEED``) with
   ``default_optimizer(lr=config["lr"])``, takes the train phase's first 4
   batches by object ref, and trains 4 captured steps, reporting loss and
   grad norm each step; at its second step it profiles one extra replay
   (the state put back after it). Checks: both trials on card 0
   (``CUDA_VISIBLE_DEVICES`` naming it, the same card's uuid), their step
   windows overlapping; no trial errored and each reported at least
   ``grace_period`` iterations; the 3e-4 trial's losses equal the twin's
   first ones bit for bit as far as ASHA let it run;
   ``get_best_result()`` is the trial whose last reported loss is lower;
   8 / 4 / 4 flash launches per replay by name in each trial. Printed:
   ``fit()`` s, each trial's replay ms (two processes share the card) and
   peak memory.
18. rl: the RLlib port (``ray_tpu_torch/rllib/``), its learners on the
   card and its env runners CPU actors. First the learner against its
   plain CPU twin on the same inputs (fp32, TF32 off; ``RL_TWIN_TOL``):
   PPO's update (8 epochs x 4 minibatches of 256 MinAtar-Breakout steps),
   IMPALA's V-trace loss and gradients over a 256-step rollout, DQN's step
   (32 minibatches of 64, double-Q, target copies), SAC's step (16 of 128
   on PointGoal2D) and BC's step (16 of 256). Then on a local session: PPO
   on MinAtar-Breakout at ``PPOConfig``'s defaults (2 workers x 512 steps,
   hidden 64 x 64) for 5 iterations (wall, sample and weights-to-workers s
   per iteration, the update's device ms by CUDA events; parameters on
   ``cuda:0``; nvidia-smi lists no CUDA context but this process's while
   the env runners live); IMPALA (one learner) and APPO for 3 iterations
   each and DQN for 4, all on MinAtar-Breakout (async updates, env steps,
   finite losses); SAC on PointGoal2D with the reference test's config
   until its mean episode reward passes -15, at most 40 iterations (the
   one learning check); two-agent PPO for 2 iterations; BC from a JSONL
   file of 3,000 expert steps written by ``collect_experience``, 2 train
   calls (the loss falls) and ``evaluate``. No kernel of the five launches
   on this path (their counters are checked unchanged).
19. platform: the platform planes on a one-node TCP cluster with a warm
   standby GCS (``gcs_standby``, the file backend, a 1 s failover grace)
   and the dashboard. Job 1, submitted through the CLI (``python -m
   ray_tpu_torch.scripts job submit ... --wait``; its driver is this
   script, ``platform-job``, which holds no CUDA context), runs a workflow
   ``train -> serve``: ``train`` a num_gpus=1 task taking 4 captured steps
   of ``bench_400m`` at 4 layers at [8, 2048] from ``SEED`` (the last a replay,
   profiled for its flash kernels) and saving a sharded checkpoint;
   ``serve`` raises an injected error, so the CLI exits 1, ``job status``
   says FAILED and ``job logs`` show the error. Job 2 resumes it:
   ``train`` is not run again (one train task across both jobs, by the
   state API), and ``serve`` builds an ``ActorPool`` of two ``LLMServer``
   actors at 0.5 GPU each from the checkpoint, which serve 8 greedy
   requests of 128 prompt tokens and 64 new ones taken from a
   ``util.queue.Queue`` through ``map_unordered``, counting tokens and
   TTFT in ``util.metrics``. Once serve starts, the GCS primary is
   SIGKILLed: the standby serves at epoch 2, every key acknowledged
   before the kill reads back, the card's two halves are not granted
   again (no GPU available, a num_gpus=1 lease waits) and nvidia-smi
   lists no CUDA context but this process's, the pool's and the train
   worker's. Job 2 succeeds; the losses equal the twin's first 4
   bit for bit, the pool's tokens the in-process engine's from the same
   checkpoint, flash fwd/dq/dkv run 8/4/4 per replay in the job's task
   and decode attention 24 per decode step in each actor; the dashboard
   (``/api/jobs``, ``/api/actors``, ``/api/node/<id>``, ``/api/metrics``,
   ``/metrics``, ``/api/logs``) reports it all; and a workflow step
   returning a CUDA tensor is refused (``StepResultOnDeviceError``).
20. projection: the flash kernels on a train path at GPT-J's head dim 256:
   ``gptj_6b`` at full width (d_model 4096, 16 heads x 256, d_ff 16384,
   vocab 50432, rotary_dim 64) at 7 layers (one stage of the projected
   layout: 28 layers over pp 4), flash attention, remat "dots", 1.82 B
   parameters, trained through ``make_train_step`` at [4, 2048] on seeded
   batches: one eager step, the capture, then 4 replays. Checks: the flash
   wrappers count 14 / 7 / 7 for the eager step and for the capture and
   nothing across replays, and a profiled replay launches the kernels 14 /
   7 / 7 times by name; losses and grad norms finite; three eager steps
   from a state of the same seed equal the captured ones bit for bit;
   ``projection.run_probe()`` on the card (one layer, tp 2 as rank 0 of a
   fake process group) counts within 10% of the analytic FLOPs. Printed:
   replay ms (CUDA events), tokens/s, MFU by ``analytic_train_flops``, peak
   memory, and ``project_h100_pod`` (32 cards) anchored on this MFU and on
   the train phase's 400M MFU counted the same way.
21. micro: ``ray_tpu_torch._private.ray_perf`` on the CPU. ``ping`` on the
   GCS, the raylet and an actor's core worker of a session; ``python -m
   ray_tpu_torch._private.ray_perf`` (``run_microbenchmarks`` at its
   ``main``'s sizes: 1,000 tasks, 2,000 actor calls, 10 puts of 64 MB, the
   transfer leg at 256 MB over the shm path and the socket plane); then
   the broadcast, GCS plane, GCS failover and serving scale legs, and the
   gang legs (mesh group, mesh heal, data plane) with ``device="cpu"``
   (gloo ranks). Checks: every leg returns its result line; "pong" on the
   three planes; no ``transfer_error``; 0 acknowledged writes lost across
   the failover; the gang healed; the data plane's gang took every row;
   no daemon of the port that this run started (its environment holds
   this run's ``RUN_VAR``) left after each leg. Printed: every leg's
   figures and seconds, not gated.

Prints one JSON line per phase (each with its ``phase_s``, seconds by the
script's clock), the card's name and power limit (as nvidia-smi reports
them), a ``phase_seconds`` line (every phase's seconds and the whole
run's), a ``kernels`` JSON line (five kernels; the int8
and decode attention kernels' numbers are per serve_7b decode step, with
the int8 kernel's per-prefill time and the decode attention kernel's per
inference-leg step beside them; the flash kernels' launches per
``bench_400m`` train step, per mesh step, per ``bench_400m`` x4 experts
step, per replay of the runtime's GPU task, per replay of its
``TorchTrainer``, per replay of the MeshGroup's step, per replay of the
data phase's trainer and gang, per replay of a tune trial and per replay
of the platform job's train task and per replay of the projection's
anchor step; the decode attention kernel's per
decode step of the runtime's serving actor, of its Serve deployment and
of each actor of the platform job's pool; the rl phase launches none of
them), the whole run's
seconds, and as its last
line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# bench_400m's attention shape on the forward path: [B, S, H, D].
MAIN_SHAPE = (8, 2048, 8, 128)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# Each phase's seconds by this script's clock, in the order they ran
# (``timed_phase``); the default run prints them in one line before the
# ``kernels`` line.
PHASE_SECONDS: dict = {}
_PHASES_RUNNING: list = []  # (name, start) of the phases running, innermost last


def timed_phase(fn):
    """Times ``phase_<name>`` into ``PHASE_SECONDS[name]``; the phase's own
    line (``"phase": name``) carries its seconds so far as ``phase_s``."""
    name = fn.__name__[len("phase_"):]

    @functools.wraps(fn)
    def run(*args, **kwargs):
        _PHASES_RUNNING.append((name, time.perf_counter()))
        try:
            return fn(*args, **kwargs)
        finally:
            _, start = _PHASES_RUNNING.pop()
            PHASE_SECONDS[name] = time.perf_counter() - start

    return run


# Where this script's processes keep the bytecode of what they import.
PYCACHE = Path(__file__).resolve().parent / "ray_tpu_torch" / "_build" / "pyc"


def cache_bytecode() -> None:
    """Every process this script starts from now on (workers, raylets, job
    drivers, ranks, legs: most import torch) caches the bytecode of its
    imports under ``PYCACHE``, in the checkout's build directory. Where the
    environment forbids writing bytecode (``PYTHONDONTWRITEBYTECODE``, as on
    the card machine, whose torch ships no ``__pycache__``), every such
    process would otherwise compile torch's sources anew at import."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(PYCACHE)


def emit(obj) -> None:
    if _PHASES_RUNNING and obj.get("phase") == _PHASES_RUNNING[-1][0]:
        obj = {**obj, "phase_s": time.perf_counter() - _PHASES_RUNNING[-1][1]}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Kinds of kernel in a decode step, matched in order on the full kernel
# name: the decode attention kernel (one launch per call); the int8
# weight-only matmul kernel; dtype conversions (the plain dequant's int8 ->
# bf16 among them), products by a broadcast scale and other elementwise
# multiplies, matrix products (cuBLAS's nvjet and gemv kernels).
DECODE_KINDS = {"decode_attention": "decode_attention_kernel",
                "int8_matmul": "int8_mm", "copy_convert": "direct_copy_kernel",
                "mul": "MulFunctor", "gemm": "gemm|gemv|nvjet|xmma|cutlass"}


def device_profile(fn, top: int = 10, kinds: dict = None) -> dict:
    """Runs ``fn()`` once under torch.profiler. Returns the host wall time,
    the time the host took to queue the work (until ``fn`` returned), the
    device's busy time (union of its kernel and copy intervals), the busy
    share of the wall, the kernels with the most device time and, with
    ``kinds`` (name -> regex), the device time and the launches of each
    kind of kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    by_kind = dict.fromkeys([*kinds, "other"], 0.0) if kinds else {}
    count_by_kind = dict.fromkeys(by_kind, 0)
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        if kinds:
            kind = next((k for k, rx in kinds.items() if re.search(rx, name)),
                        "other")
            by_kind[kind] += (stop - start) / 1e3
            count_by_kind[kind] += 1
        name = name[:80]
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    busy_ms = busy_us / 1e3 if spans else None  # None: profiler saw none
    out = {"wall_ms": wall * 1e3, "host_queue_ms": queued * 1e3,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall * 1e3) if spans else None,
           "top_kernels_ms": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:top]}
    if kinds:
        out["device_ms_by_kind"] = by_kind
        out["launches_by_kind"] = count_by_kind
    return out


# Readings of one profiled replay, at most. The profiler on the H100 machine
# has lost a kernel's record now and then: a replay of a graph that holds
# 48 flash forwards once read as 47 in a run whose flash wrappers had
# counted 48 into that graph at its capture. A captured graph launches the
# same kernels at every replay, so a count below the graph's is a lost
# record, and it is read again.
PROFILE_READINGS = 3


def flash_want(cfg) -> dict:
    """The flash kernels' launches in one ``bench_400m``-style train step:
    two forwards per layer (the step and its rematerialization) and one of
    each backward kernel."""
    n = cfg.n_layers
    return dict(zip(FLASH_KINDS, (2 * n, n, n)))


def profile_launches(fn, kinds: dict, want: dict, mesh=None, reset=None,
                     first: dict = None,
                     readings: int = PROFILE_READINGS) -> dict:
    """``device_profile(fn, kinds=kinds)`` of a replay whose launches of the
    kinds in ``want`` (kind -> count) are known. A reading below ``want``
    in some kind and above it in none is taken again, after ``reset()``
    when given (it puts back the state ``fn`` changed), up to ``readings``
    readings in all; ``first``, when given, is the first reading, taken by
    the caller. Over a ``mesh`` of more than one rank the ranks decide
    together, as ``fn`` holds collectives. Returns the last reading, with
    every reading's counts of ``want``'s kinds under ``launch_readings``;
    the caller checks the last reading's counts against ``want``."""
    import torch.distributed as dist

    taken, prof = [], first
    while True:
        if prof is None:
            prof = device_profile(fn, kinds=kinds)
        got = {k: prof["launches_by_kind"][k] for k in want}
        taken.append(got)
        short = got != want and all(got[k] <= n for k, n in want.items())
        again = short and len(taken) < readings
        if mesh is not None and mesh.size() > 1:
            flag = torch.tensor([int(again)], device=mesh.device_type)
            for dim in range(mesh.ndim):
                dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                                group=mesh.get_group(dim))
            again = bool(flag.item())
        if not again:
            break
        if reset is not None:
            reset()
        prof = None
    prof["launch_readings"] = taken
    return prof


def attention_bound_ms(b, s, h, d, dtype, causal) -> tuple:
    """The least time the card could take for one forward: the larger of
    the operations of the unmasked (q, k) pairs (2D for q.k, 2D for p.v)
    over the peak rate for the type, and q, k, v and o read or written once
    plus lse written once, over the memory rate."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * b * h * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * s * h * d * elem + 4 * b * h * s
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def attention_bwd_bound_ms(b, s, h, hkv, d, dtype, causal, kernel) -> tuple:
    """The least time the card could take for one backward kernel
    (``kernel`` "dq" or "dkv"): the larger of the operations of the unmasked
    (q, k) pairs (dq: q.k, dO.v, ds.k, 6D; dkv: q.k, dO.v, p.dO, ds.q, 8D)
    over the peak rate for the type, and the bytes it must move over the
    memory rate (dq: q, k, v, dO, O read, dQ written, lse read and the delta
    it fuses written; dkv: q, k, v, dO read, dK and dV written, lse and
    delta read; lse and delta fp32 [B, H, S]). The D products of delta are
    left out of the operations: D per row against 6D per (q, k) pair."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (6 if kernel == "dq" else 8) * d * b * h * pairs
    elem = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes = b * s * h * d * elem, b * s * hkv * d * elem
    nbytes = (4 * q_bytes + 2 * kv_bytes if kernel == "dq"
              else 2 * q_bytes + 4 * kv_bytes) + 2 * 4 * b * h * s
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def check_bwd_bounds() -> dict:
    """The backward bounds at bench_400m's shape, held to the figures
    worked out by hand: 134,283,264 unmasked pairs; dQ (delta fused)
    1.031e11 FLOP, >= 0.104 ms, ~202 MB (0.060 ms: q, dO, O, dQ and k, v
    33.5 MB each, lse and delta 0.5 MB each); dK/dV 1.375e11 FLOP,
    >= 0.139 ms, ~202 MB (0.060 ms); operations bound both."""
    b, s, h, d = MAIN_SHAPE
    out = {}
    for kernel, flops_want, ms_want in (("dq", 1.031e11, 0.104),
                                        ("dkv", 1.375e11, 0.139)):
        ms, by, flops = attention_bwd_bound_ms(b, s, h, h, d, torch.bfloat16,
                                               True, kernel)
        check(abs(flops / flops_want - 1) < 1e-3 and abs(ms - ms_want) < 1e-3
              and by == "operations",
              f"{kernel} bound {flops} FLOP, {ms} ms, {by}")
        out[kernel] = (ms, by, flops)
    return out


# Tolerances of the kernel against its plain version (dense fp32 scores,
# exact softmax, o rounded once to the input type):
# - bf16: the kernel rounds p to bf16 before p.v (as the TPU kernel does,
#   2^-9 relative per weight) and sums in another order; o itself is rounded
#   to bf16 (2^-8 relative per ulp). Allowed: 1e-2 + 1e-2 * |o|, about two
#   bf16 ulps at the outputs' magnitude.
# - fp32: only the summation order and expf differ: 1e-5 + 1e-5 * |o|.
# - lse is fp32 in both: 1e-4 absolute (values ~ log S + max score).
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
LSE_ATOL = 1e-4
# Tolerances of the backward kernels against their plain version, which
# rounds p and ds to the input type at the same places (dense fp32 scores,
# fp32 sums):
# - bf16: dQ, dK, dV are rounded to bf16 once (2^-8 relative), and p and ds
#   are rounded to bf16 from fp32 values that differ in their last bits
#   (summation order, expf), so a few terms of each sum land one bf16 ulp
#   apart (2^-9 relative each) before sums over up to S * n_rep terms.
#   Allowed: 2e-2 + 2e-2 * |ref|, a few bf16 ulps at the grads' magnitude.
# - fp32: only the summation order and expf differ: 1e-4 + 1e-4 * |ref|.
BWD_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
# delta = rowsum(dO * O) from the dQ kernel against flash_attention_delta:
# both sum the same D fp32 products (exact for bf16 inputs) in another
# order, and a sum of D terms in fp32 is off by at most about
# D * 2^-24 * sum|dO * O| whatever its order, so the two may differ by
# twice that: |err| <= DELTA_TERM_RTOL * D * sum_d |dO * O| per row.
DELTA_TERM_RTOL = 2 * 2.0 ** -24
# Head dims that the kernels pad (any multiple of 16 up to 256 is taken):
# D 16, ``TransformerConfig.tiny``'s (one 64-column block, 48 columns
# zero-filled by TMA); D 96 (padded to 128: the second 64-column block half
# filled); D 192 (padded to 256: the dK/dV kernel's second 128-column chunk
# half filled). Causal and not, one GQA case, one fp32 case; [B, S, H, D],
# kv heads, dtype, causal.
HEAD_DIM_CASES = [
    ((2, 256, 4, 16), 4, torch.bfloat16, True),
    ((2, 300, 4, 16), 2, torch.bfloat16, False),
    ((2, 384, 8, 96), 8, torch.bfloat16, True),
    ((2, 300, 8, 96), 8, torch.bfloat16, False),
    ((1, 320, 4, 192), 4, torch.bfloat16, True),
    ((1, 257, 4, 192), 4, torch.bfloat16, False),
    ((1, 200, 4, 96), 4, torch.float32, True),
]


def compare_kernel(fa, gen, shape, hkv, dtype, causal) -> tuple:
    b, s, h, d = shape
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    atol, rtol = TOL[dtype]
    err = (o.float() - ref_o.float()).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    case = {"shape": [b, s, h, d], "kv_heads": hkv,
            "dtype": str(dtype).removeprefix("torch."), "causal": causal,
            "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
            "atol": atol, "rtol": rtol, "lse_atol": LSE_ATOL}
    check(bool(torch.isfinite(o.float()).all()), f"non-finite o in {case}")
    check(bool((err <= atol + rtol * ref_o.float().abs()).all())
          and lse_err <= LSE_ATOL, f"kernel disagrees with plain: {case}")
    return case, (q, k, v, o, lse)


def compare_bwd(fa, gen, q, k, v, o, lse, causal, strided_do=False) -> tuple:
    """The dQ and dK/dV kernels (through ``flash_attention_bwd``) against
    ``flash_attention_bwd_reference`` on the forward kernel's o and lse and
    a random dO (with ``strided_do``, a [B, H, S, D] tensor seen as
    [B, S, H, D], read through its strides); the delta the dQ kernel fuses
    against ``flash_attention_delta``; and a second dQ launch, which must
    give the same dQ bit for bit (each block owns its rows, no atomics)."""
    b, s, h, d = q.shape
    if strided_do:
        do = torch.randn((b, h, s, d), generator=gen,
                         device="cuda").to(q.dtype).transpose(1, 2)
    else:
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    atol, rtol = BWD_TOL[q.dtype]
    case = {"shape": [b, s, h, d], "kv_heads": k.shape[2],
            "dtype": str(q.dtype).removeprefix("torch."), "causal": causal,
            "strided_do": strided_do, "atol": atol, "rtol": rtol}
    ok = True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == w.dtype
              and bool(torch.isfinite(g.float()).all()),
              f"{name} of the wrong shape, dtype or not finite: {case}")
        err = (g.float() - w.float()).abs()
        case[f"{name}_max_abs_err"] = err.max().item()
        case[f"{name}_ref_max_abs"] = w.float().abs().max().item()
        ok &= bool((err <= atol + rtol * w.float().abs()).all())
    check(ok, f"backward kernels disagree with plain: {case}")
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    want_delta = fa.flash_attention_delta(o, do)
    terms = (do.float() * o.float()).abs().sum(-1).transpose(1, 2)
    derr = (delta - want_delta).abs()
    case["delta_max_abs_err"] = derr.max().item()
    case["delta_term_rtol"] = DELTA_TERM_RTOL
    check(delta.shape == want_delta.shape and delta.dtype == torch.float32
          and bool((derr <= DELTA_TERM_RTOL * d * terms).all()),
          f"dQ kernel's delta disagrees with flash_attention_delta: {case}")
    check(torch.equal(dq, got[0]), f"dQ differs between two launches: {case}")
    return case, do


def ptxas_report(logs: dict) -> list:
    """Registers, static shared memory and spills of every kernel in
    nvcc's ``-Xptxas -v`` output, with any ptxas warning about a kernel
    (an ignored setmaxnreg, serialized wgmma)."""
    out, cur = [], None
    for lib, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = {"library": lib, "kernel": m.group(1), "warnings": []}
                out.append(cur)
                continue
            if cur is None:
                continue
            if "warning" in line.lower():
                cur["warnings"].append(line.strip())
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


@timed_phase
def phase_kernel() -> dict:
    from ray_tpu_torch.ops import build
    from ray_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    libs = build.build(verbose=True)  # prints ptxas's register report
    build_s = time.perf_counter() - t0
    report = ptxas_report(build.BUILD_LOGS)
    dyn_smem = {d: fa.kernel_smem_bytes(d) for d in (64, 128, 256)}
    emit({"phase": "kernel_build", "build_s": build_s, "ptxas": report,
          "dynamic_smem_bytes_by_head_dim": dyn_smem})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b, s, h, d = MAIN_SHAPE
    shapes = [
        ((2, 512, 8, 128), 8, torch.bfloat16, False),
        ((2, 512, 8, 128), 2, torch.bfloat16, True),  # GQA
        ((2, 1000, 8, 128), 8, torch.bfloat16, True),  # ragged S
        ((2, 1000, 8, 128), 2, torch.bfloat16, False),
        ((1, 384, 4, 256), 4, torch.bfloat16, True),  # gptj_6b's D
        ((2, 300, 8, 128), 2, torch.float32, True),
        ((1, 333, 4, 64), 4, torch.float32, False),
        # cases the wgmma/TMA kernels make risky: S below one tile, D 64
        # (one 64-column block), GQA with n_rep 4 through the dK/dV ring,
        # a head dim below one TMA box (zero-filled columns)
        ((2, 40, 8, 128), 8, torch.bfloat16, True),
        ((2, 512, 8, 64), 8, torch.bfloat16, True),
        ((2, 1000, 8, 64), 8, torch.bfloat16, False),
        ((2, 1024, 8, 128), 2, torch.bfloat16, True),
        ((1, 200, 4, 32), 2, torch.bfloat16, True),
        # D 64 (two dK/dV consumer warpgroups) with n_rep 4 and S mod 128 in
        # 1..64: one ring item per q head on the last kv block, which the
        # second warpgroup skips under the causal mask, over more items than
        # ring stages
        ((2, 40, 8, 64), 2, torch.bfloat16, True),
        ((2, 192, 8, 64), 2, torch.bfloat16, True),
        # cases the dQ kernel's 128-row q tiles over 64-row kv tiles make
        # risky: causal at D 128 with n_rep 4 and S mod 128 in 1..64 (the
        # last q tile's second warpgroup has no live row, the first none on
        # the diagonal's last kv tile); S 130: as many kv tiles as ring
        # stages in the first q tile, more in the second, whose second
        # warpgroup has no live row (S 40 above has fewer tiles than
        # stages); D 256 (one consumer, two ds.k wgmmas per k step)
        # non-causal with GQA
        ((2, 1040, 8, 128), 2, torch.bfloat16, True),
        ((2, 130, 8, 128), 2, torch.bfloat16, True),
        ((1, 320, 8, 256), 2, torch.bfloat16, False),
        # the projection phase's anchor step (gptj_6b at [4, 2048]): causal
        # MHA at D 256 over 16 q and 32 kv tiles per head
        ((4, 2048, 16, 256), 16, torch.bfloat16, True),
    ] + HEAD_DIM_CASES
    with torch.inference_mode():
        main, (q, k, v, o, lse) = compare_kernel(fa, gen, MAIN_SHAPE, h,
                                                 torch.bfloat16, True)
        main_bwd, do = compare_bwd(fa, gen, q, k, v, o, lse, True)
        cases, bwd_cases = [main], [main_bwd]
        for shape, hkv, dtype, causal in shapes:
            case, ins = compare_kernel(fa, gen, shape, hkv, dtype, causal)
            cases.append(case)
            bwd_cases.append(compare_bwd(fa, gen, *ins, causal)[0])
        # dO as autograd may hand it over: not contiguous
        bwd_cases.append(compare_bwd(fa, gen, q, k, v, o, lse, True,
                                     strided_do=True)[0])
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 20)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_reference(q, k, v, True), 5)
        # dQ with delta fused; dK/dV on the dQ kernel's delta; both, as
        # flash_attention_bwd runs them; the plain delta expression that the
        # fusion took off the path
        dq_ms = cuda_ms(lambda: fa.flash_bwd_dq_kernel(q, k, v, o, do, lse,
                                                       True), 20)
        _, delta = fa.flash_bwd_dq_kernel(q, k, v, o, do, lse, True)
        dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse,
                                                         delta, True), 20)
        bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                        True), 20)
        delta_plain_ms = cuda_ms(lambda: fa.flash_attention_delta(o, do), 20)
        dq_plain_ms = cuda_ms(lambda: fa.flash_bwd_dq_reference(
            q, k, v, o, lse, do, True), 3)
        bwd_plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, True), 3)
        # yardsticks only: the port never calls SDPA
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True), 20)
    qt, kt, vt = (x.transpose(1, 2).clone().requires_grad_(True)
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    dot = do.transpose(1, 2).clone()
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
    del out, qt, kt, vt, dot
    bound_ms, bound_by, flops = attention_bound_ms(b, s, h, d,
                                                   torch.bfloat16, True)
    bwd_bounds = check_bwd_bounds()
    out = {"phase": "kernel", "build_s": build_s,
           "libraries": {n: str(p.name) for n, p in libs.items()},
           "ptxas": report, "dynamic_smem_bytes_by_head_dim": dyn_smem,
           "cases": cases, "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "roofline_share": bound_ms / ms,
           "tflops": flops / ms / 1e9,
           "bwd_cases": bwd_cases, "bwd_dq_ms": dq_ms, "bwd_dkv_ms": dkv_ms,
           "bwd_ms": bwd_ms, "bwd_delta_plain_ms": delta_plain_ms,
           "bwd_dq_plain_ms": dq_plain_ms, "bwd_plain_ms": bwd_plain_ms,
           "bwd_library_ms": library_bwd_ms}
    for kernel, kms in (("dq", dq_ms), ("dkv", dkv_ms)):
        kbound, kby, kflops = bwd_bounds[kernel]
        out[f"bwd_{kernel}_bound_ms"] = kbound
        out[f"bwd_{kernel}_bound_by"] = kby
        out[f"bwd_{kernel}_roofline_share"] = kbound / kms
        out[f"bwd_{kernel}_tflops"] = kflops / kms / 1e9
    emit(out)
    torch.cuda.empty_cache()
    return out


# The int8 weight-only matmul kernel against its plain version, which
# multiplies the same dequantized weights (the kernel rounds them as
# ``QTensor.to`` does, bit for bit) and sums in another order:
# - fp32: two fp32 sums of the same K exact products, each within
#   K * 2^-24 * sum_k |x_k w_k| of the exact sum, so they may differ by twice
#   that: |y - ref| <= 2 K 2^-24 S, S = |x| @ |w| per element;
# - bf16: the same fp32 sums, each rounded once to bf16 (8 significant bits,
#   so within 2^-8 of the value): |y - ref| <= 2 K 2^-24 S
#   + 2^-7 (1 + 2^-7) max(|y|, |ref|).
# The plain version's product runs with cuBLAS's reduced-precision bf16
# reductions off, so its sums are fp32 as the bound assumes.
INT8_BF16_ROUND = 2.0 ** -7 * (1 + 2.0 ** -7)
INT8_MS = (8, 128)  # serve_7b's decode (8 slots) and prefill (bucket 128) M
# Ragged M, and the M of the fp32 engine check (2 slots, buckets 64 and 128).
INT8_RAGGED_MS = (1, 3, 17, 2, 40, 64)


def int8_weight_shapes(cfg) -> dict:
    """(K, N) of the six int8 weights of a layer, as ``QTensor.matmul``
    flattens them."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.kv_heads * cfg.d_head
    return {"wq": (d, hd), "wk": (d, kvd), "wv": (d, kvd), "attn_wo": (hd, d),
            "mlp_wi": (d, cfg.d_ff), "mlp_wo": (cfg.d_ff, d)}


def int8_operands(gen, m, k, n, dtype, copies=1) -> tuple:
    """x [m, k] ~ N(0, 1) and ``copies`` int8 weights [k, n] with their
    scales (uniform int8, scales near those of a N(0, 1/k) init)."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    ws = [(torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                         dtype=torch.int8),
           (torch.rand(n, generator=gen, device="cuda") + 0.5)
           * (4.0 / 127.0 / k ** 0.5)) for _ in range(copies)]
    return x, ws


def int8_bound_ms(m, k, n, dtype) -> tuple:
    """The least time the card could take for one product: x, q, s read and
    y written once over the memory rate, against 2 M K N operations over the
    peak rate for x's type (bf16 tensor cores, fp32 CUDA cores)."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = m * k * elem + k * n + 4 * n + m * n * elem
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = 2 * m * k * n / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare_int8(im, gen, m, k, n, dtype) -> dict:
    """One product of the kernel against the plain version under the bound
    above; a second launch must agree bit for bit, and so must the first
    row computed alone (a row's sum order depends on K alone)."""
    x, [(q, s)] = int8_operands(gen, m, k, n, dtype)
    y = im.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    ref = im.int8_matmul_reference(x, q, s)
    w = (q.to(dtype) * s.to(dtype)).float()
    terms = x.float().abs() @ w.abs()
    yf, rf = y.float(), ref.float()
    tol = 2 * k * 2.0 ** -24 * terms
    if dtype == torch.bfloat16:
        tol = tol + INT8_BF16_ROUND * torch.maximum(yf.abs(), rf.abs())
    err = (yf - rf).abs()
    case = {"m": m, "k": k, "n": n,
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err.max().item(),
            "ref_max_abs": rf.abs().max().item(),
            "max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item()}
    check(y.shape == (m, n) and y.dtype == dtype
          and bool(torch.isfinite(yf).all()),
          f"int8_matmul output of the wrong shape, dtype or not finite: "
          f"{case}")
    check(bool((err <= tol).all()),
          f"int8_matmul disagrees with its plain version: {case}")
    check(torch.equal(im.int8_matmul(x, q, s), y),
          f"int8_matmul differs between two launches: {case}")
    check(torch.equal(im.int8_matmul(x[:1].contiguous(), q, s), y[:1]),
          f"int8_matmul's row 0 differs when computed alone: {case}")
    return case


def graph_ms(fn, args, reps: int = 10) -> float:
    """Device ms per call of ``fn(*a)`` for a in ``args``: one pass over
    ``args`` captured in a CUDA graph (``ray_tpu_torch.graphs``: a warm-up
    pass on a side stream, then the capture) and replayed ``reps`` times,
    by CUDA events. No host time is in it, as none is in a served decode
    step."""
    from ray_tpu_torch import graphs

    def one_pass():
        for a in args:
            fn(*a)

    graphs.warm_up(one_pass, torch.device("cuda", torch.cuda.current_device()))
    cap = graphs.capture(one_pass)
    ms = cuda_ms(cap.graph.replay, reps, warmup=1) / len(args)
    del cap
    return ms


def int8_times(im, gen, m, k, n, dtype) -> dict:
    """Device times of one product at (m, k, n) (``graph_ms``) on weights
    that rotate through copies larger than L2 together (each call finds its
    weight in device memory, as a decode step does): the kernel, its plain
    version, ``torch._weight_int8pack_mm`` (q transposed to [N, K] and the
    scales cast to x's dtype beforehand, as it takes them; None with the
    reason where this torch has none on CUDA) and, as a second yardstick, a
    bf16 product over weights dequantized beforehand."""
    copies = max(2, -(-240_000_000 // (k * n)))
    x, ws = int8_operands(gen, m, k, n, dtype, copies)
    out = {"m": m, "k": k, "n": n,
           "dtype": str(dtype).removeprefix("torch."), "weight_copies": copies,
           "kernel_ms": graph_ms(lambda q, s: im.int8_matmul(x, q, s), ws),
           "plain_ms": graph_ms(
               lambda q, s: im.int8_matmul_reference(x, q, s), ws[:2])}
    out["bound_ms"], out["bound_by"] = int8_bound_ms(m, k, n, dtype)
    try:
        packed = [(q.t().contiguous(), s.to(dtype)) for q, s in ws[:2]]
        out["library_ms"] = graph_ms(
            lambda qt, s: torch._weight_int8pack_mm(x, qt, s), packed)
        del packed
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        out["library_ms"] = None
        out["library_none_reason"] = f"torch._weight_int8pack_mm: {e}"[:300]
    dq = [(q.to(dtype) * s.to(dtype),) for q, s in ws[:2]]
    out["dequantized_matmul_ms"] = graph_ms(lambda w: x @ w, dq)
    del dq, ws
    torch.cuda.empty_cache()
    return out


@timed_phase
def phase_int8_kernel() -> dict:
    """``int8_matmul`` (built by the kernel phase) against its plain version
    at every int8 weight shape of serve_7b, at decode's and prefill's M, in
    bf16 and fp32; at ragged M; at ``tiny``'s widths. Device times inside
    CUDA graphs at serve_7b's shapes, bf16, per decode step and per
    prefill (a layer's six products at M 8 and at M 128, times its 32
    layers); ptxas's report of the int8 kernels and each shape's launch
    plan."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.ops import build
    from ray_tpu_torch.ops import int8_matmul as im

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cfg = TransformerConfig.serve_7b()
    shapes = int8_weight_shapes(cfg)
    distinct = sorted(set(shapes.values()))
    cases = []
    with torch.inference_mode():
        for (k, n), m, dtype in itertools.product(
                distinct, INT8_MS, (torch.bfloat16, torch.float32)):
            cases.append(compare_int8(im, gen, m, k, n, dtype))
        serve_7b_err = max(c["max_abs_err"] for c in cases)
        k, n = distinct[0]
        for m, dtype in itertools.product(INT8_RAGGED_MS,
                                          (torch.bfloat16, torch.float32)):
            cases.append(compare_int8(im, gen, m, k, n, dtype))
        for name, (k, n) in int8_weight_shapes(TransformerConfig.tiny(
                n_kv_heads=2)).items():
            for m in (8, 64):
                cases.append({"tiny": name,
                              **compare_int8(im, gen, m, k, n,
                                             torch.bfloat16)})
        times = {(k, n, m): int8_times(im, gen, m, k, n, torch.bfloat16)
                 for (k, n), m in itertools.product(distinct, INT8_MS)}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True

    def per_step(m) -> dict:
        """A layer's six products at M ``m``, times its layers: the
        kernel's share of a decode step (M 8) or of a prefill (M 128)."""
        out = {"m": m, "layers": cfg.n_layers, "launches": 6 * cfg.n_layers}
        for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                    "dequantized_matmul_ms"):
            vals = [times[(k, n, m)][key] for k, n in shapes.values()]
            out[key] = (None if None in vals
                        else cfg.n_layers * float(sum(vals)))
        out["bound_share"] = out["bound_ms"] / out["kernel_ms"]
        return out

    # each serve_7b shape's bf16 launch: K split, ring, wgmma N, workspace
    plans = [{"m": m, "k": k, "n": n, **dataclasses.asdict(im.launch_plan(
        m, k, n, im._sms(torch.device("cuda"))))}
        for (k, n), m in itertools.product(distinct, INT8_MS)]
    out = {"phase": "int8_kernel", "cases": cases,
           "serve_7b_max_abs_err": serve_7b_err,
           "bf16_round_rtol": INT8_BF16_ROUND,
           "ptxas": [r for r in ptxas_report(build.BUILD_LOGS)
                     if r["library"] == "int8_matmul"],
           "plans": plans,
           "times": list(times.values()),
           "decode_step": {**per_step(INT8_MS[0]), "bound_by": "bytes"},
           "prefill_step": per_step(INT8_MS[1])}
    check(all(times[(k, n, INT8_MS[0])]["bound_by"] == "bytes"
              for k, n in distinct), "decode products are bound by bytes")
    emit(out)
    return out


# The decode attention kernel against its plain version (dense fp32 scores
# over the whole cache, fp32 softmax, p rounded to the dtype, the output
# rounded once, the self term added in the dtype), per element, with
# T = sum_j p_j |v_j| + p_self |v_new| (the plain version's fp32
# probabilities applied to |v|):
# - bf16: both take the same fp32 scores and softmax up to the order of
#   their sums and expf, so a p may round to the neighbouring bf16 value
#   (2^-7 relative at most), which moves the prefix sum by 2^-7 T at most;
#   the prefix, the self product and their sum are each rounded to bf16
#   (2^-8 relative on each side). Derived: about 2^-6 (T + max(|got|,
#   |ref|)); allowed twice that.
# - fp32: only the order of the sums (up to S_max + 1 = 1090 terms, D = 256
#   products) and expf differ, each sum within n 2^-24 of its terms' sum:
#   under 2^-13 (T + max(|got|, |ref|)); allowed 2^-12.
DECODE_RTOL = {torch.bfloat16: 2.0 ** -5, torch.float32: 2.0 ** -12}
DECODE_HEAD_DIMS = (16, 64, 96, 128, 192, 256)
DECODE_S_MAX = 300
# serve_7b's engine step (8 slots at position 160 of 512, 32 heads of 128,
# the self column) and bench.py's inference leg on bench_400m (8 sequences
# at positions 1024..1087 of a 1089-row cache, 8 heads of 128, no self
# column: lengths 1025..1088).
# ``ragged``: one more call with the slots at different lengths, as the
# engine's slots are (serve_7b's traffic decodes positions 128..191; the
# 400M engine's prompts are 64..500 tokens long, and it decodes 32 more).
DECODE_SERVE_7B = {"b": 8, "h": 32, "s_max": 512, "d": 128, "layers": 32,
                   "lengths": [160], "self": True,
                   "ragged": [128, 137, 146, 155, 164, 173, 182, 191]}
DECODE_INFERENCE = {"b": 8, "h": 8, "s_max": 1089, "d": 128, "layers": 24,
                    "lengths": list(range(1025, 1089)), "self": False,
                    "ragged": [1025, 1034, 1043, 1052, 1061, 1070, 1079,
                               1088]}
# the 400M engine's step (serve phase: 8 slots, a 1024-row cache, the self
# column; ``graph_decode_profile`` decodes at position 300)
DECODE_ENGINE_400M = {"b": 8, "h": 8, "s_max": 1024, "d": 128, "layers": 24,
                      "lengths": [300], "self": True,
                      "ragged": [64, 131, 198, 265, 332, 399, 466, 532]}


def decode_lengths(s_max: int, self_col: bool, tile_rows: int = 16) -> list:
    """Per-slot lengths at the edges the kernel cuts at: none (the self
    column alone), one row, fewer rows than a cluster has blocks (2, 3, 5,
    7: blocks with no share), around every multiple of the kernel's
    ``tile_rows`` (tiles end there, and a cluster of C blocks splits a slot
    evenly at multiples of C tiles) and so of 64 (the chunks of the earlier
    design), the last rows, and past the cache (clamped)."""
    edges = {1, 2, 3, 5, 7, s_max - 1, s_max, s_max + 7}
    for c in range(tile_rows, s_max, tile_rows):
        edges |= {c - 1, c, c + 1}
    return ([0] if self_col else []) + sorted(edges)


def decode_operands(gen, b, h, hkv, s_max, d, dtype) -> tuple:
    """q, the caches, k_new and v_new ~ N(0, 1) in ``dtype`` on the card."""
    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return (t(b, 1, h, d), t(b, s_max, hkv, d), t(b, s_max, hkv, d),
            t(b, 1, hkv, d), t(b, 1, hkv, d))


def decode_error(da, q, k, v, lengths, new) -> tuple:
    """The kernel's output at these operands, its error against the plain
    version, and the error's bound (``DECODE_RTOL`` of the sum of the
    terms' magnitudes plus the larger output)."""
    got = da.decode_attention(q, k, v, lengths, *new)
    torch.cuda.synchronize()
    ref = da.decode_attention_reference(q, k, v, lengths, *new)
    terms = da.decode_attention_reference(
        q.float(), k.float(), v.float().abs(), lengths,
        *((new[0].float(), new[1].float().abs()) if new else ()))
    gf, rf = got.float(), ref.float()
    bound = DECODE_RTOL[q.dtype] * (terms + torch.maximum(gf.abs(),
                                                          rf.abs()))
    return got, (gf - rf).abs(), bound


def compare_decode(da, gen, b_extra, h, n_rep, d, dtype) -> dict:
    """The kernel against its plain version with and without the self
    column, at every length of ``decode_lengths`` (one slot each, plus
    ``b_extra`` slots at S_max / 2); then stale rows: the rows at or past
    each slot's length set to NaN, and to zeros, give the kernel's output
    bit for bit; a second launch too."""
    hkv = h // n_rep
    case = {"h": h, "kv_heads": hkv, "d": d, "s_max": DECODE_S_MAX,
            "dtype": str(dtype).removeprefix("torch."),
            "rtol": DECODE_RTOL[dtype]}
    for self_col in (True, False):
        lens = decode_lengths(DECODE_S_MAX, self_col, da.TILE_ROWS)
        lens += [DECODE_S_MAX // 2] * b_extra
        b = len(lens)
        q, k, v, kn, vn = decode_operands(gen, b, h, hkv, DECODE_S_MAX, d,
                                          dtype)
        lengths = torch.tensor(lens, device="cuda")
        new = (kn, vn) if self_col else ()
        got, err, bound = decode_error(da, q, k, v, lengths, new)
        gf = got.float()
        key = "self" if self_col else "no_self"
        plan = {**dataclasses.asdict(da.launch_plan(
            b, h, hkv, DECODE_S_MAX, d, da._sms(q.device))),
            **da.ring(dtype, b, h, hkv, DECODE_S_MAX, d)}
        case[key] = {"batch": b, "kv_rows": b * hkv, "plan": plan,
                     "max_abs_err": err.max().item(),
                     "max_err_over_bound":
                         (err / bound.clamp_min(1e-30)).max().item()}
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(gf).all()),
              f"decode_attention output of the wrong shape, dtype or not "
              f"finite: {case}")
        check(bool((err <= bound).all()),
              f"decode_attention disagrees with its plain version: {case}")
        rows = torch.arange(DECODE_S_MAX, device="cuda")
        stale = (rows[None, :] >= lengths.clamp(max=DECODE_S_MAX)[:, None])
        stale = stale[:, :, None, None]
        outs = [da.decode_attention(q, k.masked_fill(stale, fill),
                                    v.masked_fill(stale, fill), lengths,
                                    *new)
                for fill in (float("nan"), 0.0)]
        outs.append(da.decode_attention(q, k, v, lengths, *new))
        check(all(torch.equal(o, got) for o in outs),
              f"decode_attention read a stale row or differs between "
              f"launches: {case}")
    return case


def decode_bound_ms(shape: dict, dtype=torch.bfloat16) -> tuple:
    """The least time the card could take for one call at ``shape``, per
    call averaged over its lengths: q, the valid K and V rows, k_new and
    v_new read once and the output written once over the memory rate,
    against the products (q.k and p.v, 2 D each per head and row, the self
    column included) over the peak rate for the type."""
    b, h, d, s_max = shape["b"], shape["h"], shape["d"], shape["s_max"]
    elem = torch.finfo(dtype).bits // 8
    rows = np.mean([min(n, s_max) for n in shape["lengths"]])
    cols = rows + (1 if shape["self"] else 0)
    nbytes = (2 * b * h * d * elem + 2 * b * rows * h * d * elem + 8 * b
              + (2 * b * h * d * elem if shape["self"] else 0))
    flops = 4 * d * b * h * cols
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), nbytes


def check_at_main_shape(da, q, calls, new, ragged) -> dict:
    """The kernel against its plain version at a main path's own operands:
    every call of ``calls`` (each length of the shape, each on a layer of
    its own) and one with the slots at the ``ragged`` lengths, in bf16 as
    the path runs and in fp32 (the same operands, widened; what the fp32
    engine = ``generate`` checks run), within ``DECODE_RTOL``."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst, max_err = 0.0, 0.0
        for k, v, n in calls + [(calls[0][0], calls[0][1], ragged)]:
            ops = [t.to(dtype) for t in (q, k, v, *new)]
            got, err, bound = decode_error(da, *ops[:3], n, tuple(ops[3:]))
            check(bool(torch.isfinite(got.float()).all())
                  and bool((err <= bound).all()),
                  f"decode_attention disagrees with its plain version at a "
                  f"main path's shape ({dtype}, lengths {n.tolist()})")
            worst = max(worst, (err / bound.clamp_min(1e-30)).max().item())
            max_err = max(max_err, err.max().item())
        out[str(dtype).removeprefix("torch.")] = {
            "calls": len(calls) + 1, "max_abs_err": max_err,
            "max_err_over_bound": worst}
    return out


def decode_times(da, gen, shape: dict) -> dict:
    """At ``shape``, the kernel held against its plain version on the same
    operands (``check_at_main_shape``), then device times per call
    (``graph_ms``: a pass over every layer's own cache, at each of the
    shape's lengths in turn, so each call finds its rows in device memory
    as a decode step does) of the kernel, its plain version and
    ``scaled_dot_product_attention`` with a boolean mask over the same rows
    (the self column as a written row; None with the reason where this
    torch cannot take it in a graph), beside the bound; and the same per
    decode step (one call per layer)."""
    b, h, d, s_max = shape["b"], shape["h"], shape["d"], shape["s_max"]
    layers = shape["layers"]

    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    cache = randn(2, layers, b, s_max, h, d)
    q, kn, vn = randn(b, 1, h, d), randn(b, 1, h, d), randn(b, 1, h, d)
    new = (kn, vn) if shape["self"] else ()
    pos = torch.arange(s_max, device="cuda")
    extra = 1 if shape["self"] else 0
    lens = [torch.full((b,), n, device="cuda") for n in shape["lengths"]]
    masks = [(pos[None, :] < n[:, None] + extra)[:, None, None] for n in lens]
    n_calls = max(layers, len(lens))
    calls = [(cache[0, i % layers], cache[1, i % layers], lens[i % len(lens)])
             for i in range(n_calls)]
    ragged = torch.tensor(shape["ragged"], device="cuda")
    plan = da.launch_plan(b, h, h, s_max, d, da._sms(q.device))
    ring = da.ring(torch.bfloat16, b, h, h, s_max, d)
    check(ring["smem_bytes"] <= 227 * 1024
          and ring["clusters_at_once"] >= plan.grid[1],
          f"decode_attention at a main path's shape: a ring beyond a block's "
          f"227 KB, or a grid the card cannot hold at once: {plan}, {ring}")
    out = {"shape": {k: v for k, v in shape.items() if k != "lengths"},
           "lengths": [shape["lengths"][0], shape["lengths"][-1]],
           "plan": {**dataclasses.asdict(plan), **ring},
           "vs_plain": check_at_main_shape(da, q, calls, new, ragged),
           "kernel_ms_per_call": graph_ms(
               lambda k, v, n: da.decode_attention(q, k, v, n, *new), calls),
           "plain_ms_per_call": graph_ms(
               lambda k, v, n: da.decode_attention_reference(q, k, v, n,
                                                             *new),
               calls[:2], reps=3)}
    qt = q.transpose(1, 2)
    lib = [(k.transpose(1, 2), v.transpose(1, 2), masks[i % len(masks)])
           for i, (k, v, _) in enumerate(calls[:4])]
    try:
        out["library_ms_per_call"] = graph_ms(
            lambda k, v, m: torch.nn.functional.scaled_dot_product_attention(
                qt, k, v, attn_mask=m), lib, reps=5)
    except RuntimeError as e:
        out["library_ms_per_call"] = None
        out["library_none_reason"] = f"scaled_dot_product_attention: {e}"[
            :300]
    # host cost of an eager call: the whole wrapper (checks, the tensor
    # maps' encode, launch), queued without a sync
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, v, n in calls[:20]:
        da.decode_attention(q, k, v, n, *new)
    out["eager_host_us_per_call"] = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    bound, by, nbytes = decode_bound_ms(shape)
    out.update({"bound_ms_per_call": bound, "bound_by": by,
                "bytes_per_call": nbytes,
                "bound_share": bound / out["kernel_ms_per_call"]})
    for key in ("kernel", "plain", "library", "bound"):
        per_call = out[f"{key}_ms_per_call"]
        out[f"{key}_ms_per_step"] = (None if per_call is None
                                     else layers * per_call)
    del cache, calls, lib
    torch.cuda.empty_cache()
    return out


@timed_phase
def phase_decode_kernel() -> dict:
    """``decode_attention`` (built by the kernel phase) against its plain
    version on the card: bf16 and fp32, D 16 to 256, n_rep 1 to 8,
    clusters of 1 to 8 blocks, lengths at every edge, with and without the
    self column, stale rows and repeated launches (``compare_decode``);
    then, at serve_7b's engine step, bench.py's inference leg and the 400M
    engine's step, the kernel against its plain version on those shapes'
    own operands, and its times per call and per decode step beside its
    plain version, SDPA and its bound."""
    from ray_tpu_torch.ops import build
    from ray_tpu_torch.ops import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    cases = []
    with torch.inference_mode():
        for d, n_rep, dtype in itertools.product(
                DECODE_HEAD_DIMS, (1, 2, 4), (torch.bfloat16, torch.float32)):
            cases.append(compare_decode(da, gen, 0, 16, n_rep, d, dtype))
        # few kv heads: clusters of 4 (h 2) and 8 (h 1; 4 heads of one kv
        # head); n_rep 8 (8 heads per block) and 3 (3 groups of one head)
        for h, n_rep, dtype in ((2, 1, torch.bfloat16), (1, 1, torch.bfloat16),
                                (2, 1, torch.float32), (4, 4, torch.float32),
                                (16, 8, torch.bfloat16), (12, 3, torch.float32)):
            cases.append(compare_decode(da, gen, 0, h, n_rep, 128, dtype))
        # B * Hkv above 264: clusters of one block
        cases.append(compare_decode(da, gen, 20, 16, 1, 128, torch.bfloat16))
        times = {"serve_7b_step": decode_times(da, gen, DECODE_SERVE_7B),
                 "inference_step": decode_times(da, gen, DECODE_INFERENCE),
                 "engine_400m_step": decode_times(da, gen,
                                                  DECODE_ENGINE_400M)}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    errs = {dt: max([c[form]["max_abs_err"] for c in cases for form in
                     ("self", "no_self") if c["dtype"] == dt]
                    + [t["vs_plain"][dt]["max_abs_err"]
                       for t in times.values()])
            for dt in ("bfloat16", "float32")}
    out = {"phase": "decode_kernel", "cases": cases, "max_abs_err": errs,
           "rtol": {str(k).removeprefix("torch."): v
                    for k, v in DECODE_RTOL.items()},
           "ptxas": [r for r in ptxas_report(build.BUILD_LOGS)
                     if r["library"] == "decode_attention"],
           "times": times}
    check(all(t["bound_by"] == "bytes" for t in times.values()),
          "decode attention is bound by bytes")
    emit(out)
    return out


@timed_phase
def phase_forward(params, cfg) -> dict:
    from ray_tpu_torch.models.generation import prepare_for_inference
    from ray_tpu_torch.models.transformer import forward, loss_fn
    from ray_tpu_torch.ops import flash_attention as fa

    ip, icfg = prepare_for_inference(params, cfg)
    check(icfg.attn_impl == "flash", "bench_400m must use flash attention")
    rng = np.random.default_rng(SEED)
    b, s = MAIN_SHAPE[0], MAIN_SHAPE[1]
    tokens = torch.from_numpy(
        rng.integers(0, icfg.vocab_size, (b, s + 1))).cuda()
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    dense_cfg = dataclasses.replace(icfg, attn_impl="dense")
    with torch.inference_mode():
        fa.launches = 0
        logits = forward(ip, batch["tokens"], icfg)
        torch.cuda.synchronize()
        launches = fa.launches
        check(launches == icfg.n_layers,
              f"flash launches {launches} != {icfg.n_layers} layers")
        check(logits.shape == (b, s, icfg.vocab_size)
              and bool(torch.isfinite(logits.float()).all()),
              "forward logits not finite or of the wrong shape")
        dense = forward(ip, batch["tokens"], dense_cfg)
        diff = (logits.float() - dense.float()).abs()
        agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
        loss = loss_fn(ip, batch, icfg).item()
        dense_loss = loss_fn(ip, batch, dense_cfg).item()
        fwd_ms = cuda_ms(lambda: forward(ip, batch["tokens"], icfg), 3, 1)
        dense_ms = cuda_ms(lambda: forward(ip, batch["tokens"], dense_cfg),
                           3, 1)
        prof = device_profile(lambda: forward(ip, batch["tokens"], icfg))
    out = {"phase": "forward", "flash_launches": launches,
           "logits_max_abs_diff_vs_dense": diff.max().item(),
           "logits_mean_abs_diff_vs_dense": diff.mean().item(),
           "argmax_agreement_vs_dense": agree, "loss": loss,
           "dense_loss": dense_loss, "forward_ms": fwd_ms,
           "dense_forward_ms": dense_ms,
           "tokens_per_s": b * s / fwd_ms * 1e3, "profile": prof}
    # bf16 through 24 layers: the two attentions round p at different
    # places, and the residual stream amplifies it. Held: mean |diff| <=
    # 2e-2, max |diff| <= 0.5 (logits are ~N(0, 1) at this init), argmax
    # agreement >= 95%, loss within 1e-2.
    check(out["logits_mean_abs_diff_vs_dense"] <= 2e-2
          and out["logits_max_abs_diff_vs_dense"] <= 0.5
          and agree >= 0.95 and abs(loss - dense_loss) <= 1e-2
          and np.isfinite(loss), f"flash forward disagrees with dense: {out}")
    emit(out)
    return out


def train_batch(vocab: int, b: int, s: int, seed: int) -> dict:
    """One seeded batch on the card: tokens, the targets shifted by one,
    and a mask of ones."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, vocab, (b, s + 1))).cuda()
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": torch.ones((b, s), device=ids.device)}


def train_flops(cfg, b: int, s: int) -> int:
    """FLOPs of one train step as bench.py:228-230 counts them: 6 N per
    token for the weights, plus the causal attention's products."""
    return 6 * cfg.param_count() * b * s + (
        12 * cfg.n_layers * cfg.n_heads * cfg.d_head * b * s * s // 2)


# The train phase's loop: batches drawn from a cycle of TRAIN_CYCLE fixed
# seeded batches (so the loss can fall), TRAIN_STEPS steps, a checkpoint
# saved after step TRAIN_SAVE_AFTER while training goes on.
TRAIN_CYCLE, TRAIN_STEPS, TRAIN_SAVE_AFTER = 4, 14, 8
# Flash launches of one bench_400m train step: the forward kernel in the
# forward and again in the remat recompute, each backward kernel once, per
# layer; counted by kernel name in a profiled graph replay. Beside them, the
# other kinds of kernel of a step, matched in order on the full name:
# cuBLAS's products, the foreach kernels (clip, global norm, AdamW), dtype
# conversions and copies, other elementwise kernels.
FLASH_KINDS = {"flash_fwd": "flash_fwd_(bf16|f32)_kernel",
               "flash_bwd_dq": "flash_bwd_dq_(bf16|f32)_kernel",
               "flash_bwd_dkv": "flash_bwd_dkv_(bf16|f32)_kernel"}
TRAIN_KINDS = {**FLASH_KINDS, "gemm": DECODE_KINDS["gemm"],
               "foreach": "multi_tensor_apply",
               "copy_convert": "copy_kernel|direct_copy",
               "elementwise": "elementwise_kernel"}


def numpy_train_batches(vocab: int, b: int, s: int, n: int,
                        seed: int) -> list:
    """``n`` seeded numpy batches as a data source yields them: tokens,
    the targets shifted by one, and a mask of ones."""
    out = []
    for i in range(n):
        ids = np.random.default_rng(seed + i).integers(0, vocab, (b, s + 1))
        out.append({"tokens": ids[:, :-1], "targets": ids[:, 1:],
                    "mask": np.ones((b, s), np.float32)})
    return out


def state_tensors(state) -> list:
    """Every tensor a TrainState holds: step, params, and per parameter
    AdamW's step count and moments."""
    from ray_tpu_torch.models.transformer import tree_leaves

    out = [state.step]
    for p in tree_leaves(state.params):
        st = state.opt_state.state[p]
        out += [p.detach(), st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out


def tensors_differing(a: list, b: list) -> int:
    """How many of two states' tensors differ in any bit."""
    check(len(a) == len(b), "states of different structure")
    return sum(not torch.equal(x, y) for x, y in zip(a, b))


def _metric(m) -> tuple:
    return (m["loss"].item(), m["grad_norm"].item(), int(m["step"]))


@timed_phase
def phase_train(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1],
                steps: int = TRAIN_STEPS,
                save_after: int = TRAIN_SAVE_AFTER) -> dict:
    """``bench_400m`` trained on the card as the reference's loops train
    it: numpy batches through the port's pump (``device_batches``), the
    port's ``make_train_step`` (step 1 the eager warm-up, step 2 captures
    the CUDA graph, then replays), and a ``save_sharded`` checkpoint after
    step ``save_after`` written while training goes on. Then: one replay
    profiled (48 / 24 / 24 flash launches by kernel name; the wrappers'
    counters must not move across replays); eager steps from a state of the
    same seed, which must equal the captured ones bit for bit (the same
    kernels in the same order on the same inputs; no kernel of the step
    sums with atomics); and the checkpoint restored into a fresh state,
    bit-equal to the state it saved, whose next step (eager) must equal
    the original's (captured) bit for bit, every tensor included."""
    import shutil
    import tempfile

    from ray_tpu_torch.data import device_batches
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )
    from ray_tpu_torch.train import is_committed, load_sharded, save_sharded

    check(cfg.attn_impl == "flash" and cfg.remat
          and cfg.remat_policy == "dots", "bench_400m trains with flash "
          "attention under remat 'dots'")
    check(2 < save_after < steps, "the save falls among the replays")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)

    def counters():
        return (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)

    def on_card(i):
        return {k: torch.from_numpy(v).cuda() for k, v in cycle[i].items()}

    # The pump alone, with no step beside it: its own host cost per batch.
    alone = device_batches(lambda: iter(cycle * 2), prefetch_batches=2)
    t0 = time.perf_counter()
    for _ in alone:
        pass
    torch.cuda.synchronize()
    pump_alone_ms = ((time.perf_counter() - t0) * 1e3 / len(cycle) / 2,
                     alone.stats["host_s"] * 1e3 / len(cycle) / 2)

    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED)
    step = make_train_step(cfg, opt)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        metrics, events, host_ms = [], [], []
        fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
        pump = device_batches(
            lambda: (cycle[i % TRAIN_CYCLE] for i in range(steps)),
            prefetch_batches=2)
        for i, batch in enumerate(pump):
            n = i + 1  # the step this call takes
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            end.record()
            metrics.append(m)
            events.append((start, end))
            if n == 1:  # the eager warm-up
                torch.cuda.synchronize()
                eager_peak = torch.cuda.max_memory_allocated()
                above = {"eager_first_step": eager_peak - base}
                warm_counts = counters()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            elif n == 2:  # captured, and replayed once
                torch.cuda.synchronize()
                capture_counts = counters()
                t_replays = time.perf_counter()
            elif n == save_after:
                torch.cuda.synchronize()
                wall_ms = ((time.perf_counter() - t_replays) * 1e3
                           / (save_after - 2))
                captured_peak = torch.cuda.max_memory_allocated()
                above["captured"] = captured_peak - base
                at_save = [t.clone() for t in state_tensors(state)]
                t0 = time.perf_counter()
                handle = save_sharded(state, tmp, step=n)
                snapshot_ms = (time.perf_counter() - t0) * 1e3
                t_save = time.perf_counter()
            elif n == save_after + 1:
                after_save = [t.clone() for t in state_tensors(state)]
                write_done_next = handle.done()
        torch.cuda.synchronize()
        loop_after_save_s = time.perf_counter() - t_save
        run_counts = counters()
        handle.wait()
        write_s = handle.seconds
        commit_s = time.perf_counter() - t_save
        check(is_committed(tmp, save_after), "checkpoint not committed")
        ckpt_bytes = sum(f.stat().st_size for f in
                         Path(tmp, f"pieces_{save_after}").iterdir())
        check(pump.stats["batches"] == steps and not pump.thread.is_alive(),
              f"pump: {pump.stats}")
        check(warm_counts == want and capture_counts == tuple(
            2 * w for w in want) and run_counts == capture_counts,
              f"flash wrapper counts: warm-up {warm_counts}, after capture "
              f"{capture_counts}, after the run {run_counts} (want {want} "
              "per eager or captured step, none per replay)")
        check(step.captures == 1 and step.replays == steps - 1,
              f"{step.captures} captures, {step.replays} replays")
        losses = [m["loss"].item() for m in metrics]
        norms = [m["grad_norm"].item() for m in metrics]
        check([int(m["step"]) for m in metrics] == list(range(1, steps + 1)),
              "metrics' steps")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"non-finite loss or grad norm: {losses}, {norms}")
        first = float(np.mean(losses[:TRAIN_CYCLE]))
        last = float(np.mean(losses[-TRAIN_CYCLE:]))
        check(last < first, f"loss did not fall over the cycle: {losses}")
        step_ms = [a.elapsed_time(e) for a, e in events]
        replay_ms = step_ms[2:save_after]
        mean_ms = float(np.mean(replay_ms))
        flops = train_flops(cfg, b, s)

        # One replay profiled: the flash kernels by name, the busy share.
        batch = on_card(steps % TRAIN_CYCLE)
        before = counters()
        prof = profile_launches(lambda: step(state, batch), TRAIN_KINDS,
                                dict(zip(FLASH_KINDS, want)))
        check(counters() == before, "a replay moved the flash counters")
        per_replay = tuple(prof["launches_by_kind"][k] for k in FLASH_KINDS)
        check(per_replay == want, f"one replay launched flash fwd/dq/dkv "
              f"{per_replay} times, not {want}")
        del batch

        # Eager steps from a state of the same seed against the captured.
        opt_b = default_optimizer()
        state_b, _ = make_sharded_state(cfg, opt_b, SEED)
        step_b = make_train_step(cfg, opt_b)
        eager, eager_ms = [], []
        for i in range(3):
            batch = on_card(i)
            if i == 2:  # the moments exist now, as in a captured step
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eager.append(_metric(step_b.eager(state_b, batch)[1]))
            end.record()
            torch.cuda.synchronize()
            eager_ms.append(start.elapsed_time(end))
        above["eager_later_step"] = torch.cuda.max_memory_allocated() - base
        captured = [_metric(m) for m in metrics[:3]]
        check(eager == captured, f"eager steps {eager} != captured (1: "
              f"eager warm-up, 2: first captured, 3: replay) {captured}")
        del state_b, step_b, opt_b, batch
        torch.cuda.empty_cache()

        # The checkpoint restored into a fresh state, and one more step.
        opt_c = default_optimizer()
        state_c, _ = make_sharded_state(cfg, opt_c, SEED + 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_sharded(tmp, like=state_c)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_diff = tensors_differing(state_tensors(state_c), at_save)
        step_c = make_train_step(cfg, opt_c)
        _, m_c = step_c(state_c, on_card(save_after % TRAIN_CYCLE))
        resumed = _metric(m_c)
        resumed_diff = tensors_differing(state_tensors(state_c), after_save)
        check(restored_diff == 0, f"{restored_diff} restored tensors differ "
              "from the state saved")
        check(resumed == _metric(metrics[save_after]) and resumed_diff == 0,
              f"the restored state's next step {resumed} (tensors differing "
              f"{resumed_diff}) != the original's "
              f"{_metric(metrics[save_after])}")
        del state_c, step_c, opt_c, at_save, after_save
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state, step, metrics
    torch.cuda.empty_cache()
    stats = pump.stats
    hidden_ms = max(0.0, stats["host_s"] - stats["wait_s"]) / steps * 1e3
    out = {"phase": "train", "batch": [b, s], "n_layers": cfg.n_layers,
           "remat_policy": cfg.remat_policy, "steps": steps,
           "losses": losses, "grad_norms": norms,
           "loss_mean_first_cycle": first, "loss_mean_last_cycle": last,
           "step_ms": step_ms, "step_ms_mean": mean_ms,
           "step_ms_timed": replay_ms,
           "step_ms_while_writing": step_ms[save_after:],
           "host_ms_per_call": host_ms,
           "host_ms_per_replay_mean": float(np.mean(host_ms[2:save_after])),
           "wall_ms_per_replay": wall_ms,
           "eager_step_ms": eager_ms,
           "tokens_per_s": b * s / mean_ms * 1e3, "flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_BF16_FLOPS,
           "launches_per_step": dict(zip(FLASH_KINDS, per_replay)),
           "wrapper_counts_in_run": dict(zip(FLASH_KINDS, run_counts)),
           "captures": 1, "replays_in_run": steps - 1,
           "eager_vs_captured": {"eager": eager, "captured": captured,
                                 "bit_equal": True},
           "peak_memory_eager_bytes": eager_peak,
           "peak_memory_captured_bytes": captured_peak,
           # peak of a step above what was allocated before it (the state;
           # AdamW's moments are made during the first step)
           "step_memory_above_state_bytes": above,
           "pump": {"batches": stats["batches"],
                    "prefetched": stats["ready"],
                    "host_ms_per_batch": stats["host_s"] / steps * 1e3,
                    "consumer_wait_ms_per_batch":
                        stats["wait_s"] / steps * 1e3,
                    "host_ms_per_batch_hidden": hidden_ms,
                    "alone_wall_ms_per_batch": pump_alone_ms[0],
                    "alone_host_ms_per_batch": pump_alone_ms[1]},
           "checkpoint": {"step": save_after, "bytes_written": ckpt_bytes,
                          "snapshot_ms": snapshot_ms,
                          "write_s": write_s,
                          "save_to_commit_s": commit_s,
                          "steps_after_save": steps - save_after,
                          "steps_after_save_s": loop_after_save_s,
                          "write_done_after_next_step": write_done_next,
                          "restore_s": restore_s,
                          "restored_tensors_differing": restored_diff,
                          "resumed_step": resumed,
                          "resumed_tensors_differing": resumed_diff},
           "profile": prof}
    emit(out)
    return out


# The mesh phase: bench_400m trained over a one-card mesh (world size 1,
# NCCL) under each rules table, held against the one-device step from the
# same seed and batches. At world size 1 every placement is whole and no
# collective runs, so the two are expected bit for bit; a difference would
# be printed, and must stay within the reference's bf16 loss tolerance
# (tests/test_model.py:138).
MESH_STEPS = 6
MESH_LOSS_RTOL = 5e-3


@contextlib.contextmanager
def one_card_process_group():
    """A world-size-1 NCCL process group on this card (a free local port),
    destroyed on the way out."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def mesh_train_run(cfg, cycle, mesh=None, rules=None, steps=MESH_STEPS,
                   kinds=TRAIN_KINDS, pipeline=None, want=None) -> dict:
    """``steps`` steps of a fresh state of seed ``SEED`` over ``cycle``
    (through the pump; over ``mesh`` with ``rules`` when given, else on one
    device; as a pipeline when ``pipeline`` = (schedule, microbatches)
    gives one, ``make_pipeline_train_step``): step 1 the warm-up, step 2 the
    capture, then replays. Returns
    the metrics, the replays' ms (CUDA events), the memory the run adds to
    what was allocated before it (the state's bytes, the peak, and the
    peaks above the state during the warm-up and during the capture and
    replays), one profiled replay's device ms and launches by ``kinds``
    (read again while it counts fewer flash kernels than ``want``, the
    flash launches per step, when given: ``profile_launches``), and the
    state and step."""
    from ray_tpu_torch.data import device_batches
    from ray_tpu_torch.parallel import (
        batch_sharding,
        default_optimizer,
        make_pipeline_train_step,
        make_sharded_state,
        make_train_step,
    )

    opt = default_optimizer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    if mesh is None:
        state, _ = make_sharded_state(cfg, opt, SEED)
        step = make_train_step(cfg, opt)
        sharding = None
    else:
        state, sh = make_sharded_state(cfg, opt, SEED, mesh=mesh, rules=rules)
        if pipeline is None:
            step = make_train_step(cfg, opt, mesh=mesh, state_shardings=sh,
                                   rules=rules)
        else:
            step = make_pipeline_train_step(
                cfg, opt, pipeline[1], mesh=mesh, state_shardings=sh,
                rules=rules, schedule=pipeline[0])
        sharding = batch_sharding(mesh, rules)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - before
    pump = device_batches(
        lambda: (cycle[i % len(cycle)] for i in range(steps)),
        prefetch_batches=2, sharding=sharding)
    metrics, events = [], []
    for batch in pump:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        metrics.append(m)
        events.append((start, end))
        if len(metrics) == 1:  # the warm-up (AdamW's moments made here)
            torch.cuda.synchronize()
            warm_up_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        if sharding is not None:
            check(all(type(v).__name__ == "DTensor" for v in batch.values()),
                  "the mesh pump yielded tensors that are not DTensors")
    torch.cuda.synchronize()
    check(step.captures == 1 and step.replays == steps - 1,
          f"{step.captures} captures, {step.replays} replays")
    captured_peak = torch.cuda.max_memory_allocated()
    peak = max(warm_up_peak, captured_peak) - before
    above = {"state_bytes": state_bytes,
             "warm_up": warm_up_peak - before - state_bytes,
             "captured": captured_peak - base}
    params = [_full(p).detach().clone() for p in _param_leaves(state)]
    batch = {k: torch.from_numpy(v).cuda() for k, v in cycle[0].items()}
    if want is None:
        prof = device_profile(lambda: step(state, batch), kinds=kinds)
    else:
        prof = profile_launches(lambda: step(state, batch), kinds,
                                dict(zip(FLASH_KINDS, want)), mesh=mesh)
    del batch
    replay_ms = [a.elapsed_time(e) for a, e in events[2:]]
    return {"metrics": [_metric(m) for m in metrics], "replay_ms": replay_ms,
            "peak_bytes": peak, "memory_above_state": above,
            "profile": prof, "params": params,
            "launches": tuple(prof["launches_by_kind"][k]
                              for k in FLASH_KINDS),
            "state": state, "step": step}


def _param_leaves(state) -> list:
    from ray_tpu_torch.models.transformer import tree_leaves

    return tree_leaves(state.params)


def _state_full(state) -> list:
    """Every tensor of a TrainState (``state_tensors``), whole."""
    return [_full(t) for t in state_tensors(state)]


@timed_phase
def phase_mesh(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """``bench_400m`` over a one-card mesh (``build_mesh(MeshConfig(dp=1))``
    in a world-size-1 NCCL group): ``make_sharded_state(..., mesh=)`` and
    ``make_train_step(..., mesh=)`` fed by ``device_batches(...,
    sharding=batch_sharding(mesh))``, under ``DEFAULT_RULES`` and then
    ``FSDP_RULES``, ``MESH_STEPS`` steps each (warm-up, capture, replays).
    Each is held against the one-device step from the same seed and
    batches: losses, grad norms and every parameter after the last step.
    One profiled replay of each counts the flash kernels by name (48 / 24
    / 24); the replays' ms (CUDA events) and the peak memory stand beside
    the one-device step's. Then the mesh state's checkpoint restores into a
    one-device state bit for bit, and the other way round."""
    import shutil
    import tempfile

    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        FSDP_RULES,
        MeshConfig,
        build_mesh,
        default_optimizer,
        make_sharded_state,
    )
    from ray_tpu_torch.train import load_sharded, save_sharded

    check(cfg.attn_impl == "flash" and cfg.remat
          and cfg.remat_policy == "dots", "bench_400m trains with flash "
          "attention under remat 'dots'")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    out = {"phase": "mesh", "batch": [b, s], "n_layers": cfg.n_layers,
           "steps": MESH_STEPS, "runs": {}}

    def summary(run):
        return {"losses": [m[0] for m in run["metrics"]],
                "grad_norms": [m[1] for m in run["metrics"]],
                "replay_ms": run["replay_ms"],
                "replay_ms_mean": float(np.mean(run["replay_ms"])),
                "peak_memory_bytes": run["peak_bytes"],  # above its start
                "memory_above_state_bytes": run["memory_above_state"],
                "launches_per_step": dict(zip(FLASH_KINDS, run["launches"])),
                "launch_readings": run["profile"].get("launch_readings"),
                "profile_top_kernels_ms": run["profile"]["top_kernels_ms"],
                "profile_device_ms_by_kind":
                    run["profile"]["device_ms_by_kind"],
                "profile_busy_share": run["profile"]["device_busy_share"]}

    ref = mesh_train_run(cfg, cycle, want=want)
    check(ref["launches"] == want, f"one device: a replay launched flash "
          f"{ref['launches']}, not {want}")
    ref_params = ref.pop("params")
    out["runs"]["one_device"] = summary(ref)
    del ref["state"], ref["step"]
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))
        check(mesh.mesh_dim_names == ("dp",) and tuple(mesh.shape) == (1,),
              f"mesh {mesh}")
        try:
            for name, rules in (("DEFAULT_RULES", DEFAULT_RULES),
                                ("FSDP_RULES", FSDP_RULES)):
                last_state = None  # one state on the card at a time
                torch.cuda.empty_cache()
                run = mesh_train_run(cfg, cycle, mesh, rules, want=want)
                check(run["launches"] == want, f"{name}: a replay launched "
                      f"flash {run['launches']}, not {want}")
                params = run.pop("params")  # after the last step
                differing = tensors_differing(params, ref_params)
                max_diff = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(params, ref_params))
                del params
                same = run["metrics"] == ref["metrics"]
                rel = max(abs(g[0] - r[0]) / abs(r[0]) for g, r in
                          zip(run["metrics"], ref["metrics"]))
                res = summary(run)
                res.update({"metrics_bit_equal": same,
                            "params_differing": differing,
                            "params_max_abs_diff": max_diff,
                            "loss_max_rel_diff": rel})
                if not same or differing:
                    print(f"chip_smoke mesh {name}: differs from one device: "
                          f"{differing} params (max {max_diff}), loss rel "
                          f"{rel}", flush=True)
                check(rel <= MESH_LOSS_RTOL, f"{name}: loss differs from the "
                      f"one-device step by {rel} relative")
                out["runs"][name] = res
                last_state, last_rules = run["state"], rules
                del run["step"], run
                torch.cuda.empty_cache()

            # mesh -> one device, and one device -> mesh, bit for bit
            save_sharded(last_state, f"{tmp}/mesh", step=MESH_STEPS + 1,
                         wait=True)
            one, _ = make_sharded_state(cfg, default_optimizer(), SEED + 7)
            t0 = time.perf_counter()
            load_sharded(f"{tmp}/mesh", like=one)
            torch.cuda.synchronize()
            restore_into_one_s = time.perf_counter() - t0
            into_one = tensors_differing(_state_full(one),
                                         _state_full(last_state))
            save_sharded(one, f"{tmp}/one", step=MESH_STEPS + 1, wait=True)
            del last_state
            torch.cuda.empty_cache()
            back, _ = make_sharded_state(cfg, default_optimizer(), SEED + 9,
                                         mesh=mesh, rules=last_rules)
            load_sharded(f"{tmp}/one", like=back)
            into_mesh = tensors_differing(_state_full(back), _state_full(one))
            check(into_one == 0 and into_mesh == 0,
                  f"checkpoint restores differ: mesh -> one device "
                  f"{into_one} tensors, one device -> mesh {into_mesh}")
            out["checkpoint"] = {
                "rules": "FSDP_RULES", "bytes_written": sum(
                    f.stat().st_size for f in
                    Path(tmp, "mesh", f"pieces_{MESH_STEPS + 1}").iterdir()),
                "mesh_to_one_device_tensors_differing": into_one,
                "one_device_to_mesh_tensors_differing": into_mesh,
                "restore_into_one_device_s": restore_into_one_s}
            del one, back
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["replay_ms_table"] = {k: v["replay_ms_mean"]
                              for k, v in out["runs"].items()}
    out["peak_memory_table"] = {k: v["peak_memory_bytes"]
                                for k, v in out["runs"].items()}
    emit(out)
    return out


# The moe phase: bench_400m with 4 experts, top-2, capacity factor 2.0 (the
# reference's MoE settings, tests/test_parallel.py:157 and
# __graft_entry__.py:231-234, at the flagship's widths: 971.6 M parameters)
# trained on one card as the train phase trains bench_400m. Kinds of kernel
# in its step, matched in order on the full name: the flash kernels,
# cuBLAS's products (the expert products among them), the MoE dispatch and
# combine (index copies and gathers, and the sort of the gather's backward),
# the foreach kernels, conversions and copies, other elementwise work.
MOE_KINDS = {**FLASH_KINDS, "gemm": DECODE_KINDS["gemm"],
             "scatter_gather": "index|scatter|gather|[Rr]adix|[Ss]ort",
             "foreach": "multi_tensor_apply",
             "copy_convert": "copy_kernel|direct_copy",
             "elementwise": "elementwise_kernel|reduce_kernel"}
# The index dispatch against the one-hot plain version, one layer at full
# width in bf16: both sum a token's <= 2 weighted expert rows in fp32 and
# round to bf16 once, so they may differ by one bf16 ulp (2^-8 relative).
MOE_LAYER_RTOL, MOE_LAYER_ATOL = 2.0 ** -8, 1e-6
MOE_GENERATE = (8, 128, 16)  # prompts, prompt length, new tokens


# The depth of bench_400m in the library phases (data, tune, platform: their
# workers' state, checkpoints and captures), cut to keep the default run
# inside its time limit; each is held against its twin in process at the
# same depth.
LIBRARY_LAYERS = 4


def bench_400m_dense():
    """``bench_400m`` with dense attention, as the pipeline's stages run
    it (``parallel/pipeline.py``); otherwise the flagship's settings."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig.bench_400m(),
                               attn_impl="dense")


def library_cfg():
    """``bench_400m`` at ``LIBRARY_LAYERS`` layers: what the data, tune and
    platform phases train and serve."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig.bench_400m(),
                               n_layers=LIBRARY_LAYERS)


def bench_400m_moe():
    from ray_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig.bench_400m(), moe_experts=4,
                               moe_top_k=2, moe_capacity_factor=2.0)


def moe_layer_check(params, cfg, tokens) -> dict:
    """Layer 0's ``moe_ffn`` on its own input (the normed embedding of
    ``tokens``) at full width: the index dispatch against the one-hot plain
    version (``moe_ffn_reference``) under ``MOE_LAYER_RTOL``, the picks each
    drops, and both timed (CUDA events)."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.ops import moe

    lp = tf.layer_params(params, 0)
    k, cf = cfg.moe_top_k, cfg.moe_capacity_factor
    with torch.no_grad():
        h = tf._rms_norm(params["embed"][tokens].to(cfg.dtype),
                         lp["ln1"]["scale"])
        args = (h, lp["moe"]["router"], lp["moe"]["wi"], lp["moe"]["wo"])
        got, aux = moe.moe_ffn(*args, top_k=k, capacity_factor=cf)
        want, want_aux = moe.moe_ffn_reference(*args, top_k=k,
                                               capacity_factor=cf)
        g, n, _ = h.shape
        cap = moe.capacity(n, cfg.moe_experts, k, cf)
        dropped = int(moe.route(h, args[1], k, cap).dropped())
        dispatch_t = moe.one_hot_routing(h, args[1], k, cap)[0]
        dropped_ref = k * g * n - int(dispatch_t.sum())
        del dispatch_t
        err = (got.float() - want.float()).abs()
        bound = MOE_LAYER_RTOL * want.float().abs() + MOE_LAYER_ATOL
        over = float((err / bound).max())
        index_ms = cuda_ms(lambda: moe.moe_ffn(*args, top_k=k,
                                               capacity_factor=cf), 5)
        one_hot_ms = cuda_ms(lambda: moe.moe_ffn_reference(
            *args, top_k=k, capacity_factor=cf), 3)
        experts_ms = cuda_ms(lambda: moe.experts(
            torch.zeros((cfg.moe_experts, g, cap, cfg.d_model),
                        dtype=h.dtype, device=h.device),
            args[2], args[3], h.dtype), 5)
    out = {"shape": list(h.shape), "capacity": cap,
           "max_abs_err": float(err.max()), "max_err_over_bound": over,
           "bit_equal": bool(torch.equal(got, want)),
           "aux": aux.item(), "aux_one_hot": want_aux.item(),
           "dropped": dropped, "dropped_one_hot": dropped_ref,
           "index_ms": index_ms, "one_hot_ms": one_hot_ms,
           "expert_products_ms": experts_ms}
    check(over <= 1.0 and dropped == dropped_ref
          and abs(aux.item() - want_aux.item()) <= 1e-6 * abs(want_aux.item()),
          f"moe_ffn at full width differs from its one-hot plain version: "
          f"{out}")
    return out


def moe_drops_per_layer(params, cfg, tokens) -> list:
    """Picks past capacity in each layer of an eager forward of ``tokens``
    (``moe.moe_ffn`` wrapped for the forward to count them)."""
    from ray_tpu_torch.models.transformer import forward
    from ray_tpu_torch.ops import moe

    drops = []
    original = moe.moe_ffn

    def counting(x, router_w, wi, wo, *, top_k, capacity_factor, mesh=None):
        cap = moe.capacity(x.shape[1], router_w.shape[-1], top_k,
                           capacity_factor)
        drops.append(moe.route(x, router_w, top_k, cap).dropped())
        return original(x, router_w, wi, wo, top_k=top_k,
                        capacity_factor=capacity_factor, mesh=mesh)

    moe.moe_ffn = counting
    try:
        with torch.no_grad():
            forward(params, tokens, cfg)
    finally:
        moe.moe_ffn = original
    return [int(d) for d in drops]


def moe_generate_check(cfg) -> dict:
    """Greedy ``generate`` of the MoE model (bf16 from a seeded init,
    ``MOE_GENERATE``) through its captured programs, against the same
    bodies run uncaptured on the card: the tokens must be equal."""
    from ray_tpu_torch.models import generation
    from ray_tpu_torch.models.transformer import init_params

    b, s, new = MOE_GENERATE
    params, icfg = generation.prepare_for_inference(init_params(cfg, SEED),
                                                    cfg)
    prompt = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, icfg.vocab_size, (b, s))).cuda()
    max_len = s + new
    t0 = time.perf_counter()
    captured = generation.generate(params, prompt, icfg, max_new_tokens=new,
                                   max_len=max_len)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    with torch.no_grad():
        cache = generation.init_kv_cache(icfg, b, max_len)
        logits = generation._forward_cached(params, prompt, cache, 0,
                                            icfg)[0][:, -1]
        first = torch.argmax(logits, dim=-1)
        zeros_i = torch.zeros(b, dtype=torch.long, device="cuda")
        rest = generation.decode_loop_into(
            params, cache, first.clone(), torch.tensor(s, device="cuda"),
            torch.zeros(b, device="cuda"), zeros_i, zeros_i.clone(), icfg,
            torch.zeros((b, new - 1), dtype=torch.long, device="cuda"))
    uncaptured = torch.cat([first[:, None], rest], dim=1)
    check(captured.shape == (b, new) and torch.equal(captured, uncaptured),
          "captured MoE generate differs from the same loop run uncaptured")
    programs = generation.programs()
    generation.release_programs()
    del params, cache
    torch.cuda.empty_cache()
    return {"prompts": b, "prompt_len": s, "new_tokens": new,
            "captured_equals_uncaptured": True,
            "first_call_s": first_call_s, "programs": programs}


@timed_phase
def phase_moe(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """``bench_400m`` with 4 experts (``bench_400m_moe``) trained on one
    card through ``make_train_step``: seeded numpy batches [8, 2048] through
    ``device_batches``, step 1 the eager warm-up, step 2 the capture, steps
    3-6 replays (``mesh_train_run``). Checks: one profiled replay launches
    the flash kernels 48 / 24 / 24 times by name; losses and grad norms
    finite and the loss falling over the cycle (steps 5 and 6 below steps 1
    and 2, on the same batches); three eager steps from a state of the same
    seed equal the captured ones bit for bit; layer 0's ``moe_ffn`` at full
    width equals the one-hot plain version under ``MOE_LAYER_RTOL`` and
    drops as many picks; the same training over a one-card mesh (a
    world-size-1 NCCL group, ``DEFAULT_RULES``) equal to one device bit for
    bit (losses, grad norms, every parameter after step 6); and greedy
    ``generate`` through its captured programs equal to the same bodies
    run uncaptured. Printed: replay ms (CUDA events), tokens/s, peak memory,
    device ms by kind of a profiled replay, picks dropped per layer."""
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        MeshConfig,
        build_mesh,
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    check(cfg.moe_experts == 4 and cfg.attn_impl == "flash" and cfg.remat
          and cfg.remat_policy == "dots", "bench_400m with 4 experts trains "
          "with flash attention under remat 'dots'")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)

    def on_card(i):
        return {k: torch.from_numpy(v).cuda() for k, v in cycle[i].items()}

    params = init_params(cfg, SEED)
    tokens = on_card(0)["tokens"]
    layer = moe_layer_check(params, cfg, tokens)
    drops = moe_drops_per_layer(params, cfg, tokens)
    del params, tokens
    torch.cuda.empty_cache()

    run = mesh_train_run(cfg, cycle, kinds=MOE_KINDS, want=want)
    check(run["launches"] == want, f"a replay launched flash "
          f"{run['launches']}, not {want}")
    losses = [m[0] for m in run["metrics"]]
    norms = [m[1] for m in run["metrics"]]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses}, {norms}")
    check(losses[4] < losses[0] and losses[5] < losses[1],
          f"the loss did not fall over the cycle: {losses}")
    ref_params = run.pop("params")
    del run["state"], run["step"]
    torch.cuda.empty_cache()

    opt_b = default_optimizer()
    state_b, _ = make_sharded_state(cfg, opt_b, SEED)
    step_b = make_train_step(cfg, opt_b)
    eager = [_metric(step_b.eager(state_b, on_card(i))[1]) for i in range(3)]
    check(eager == run["metrics"][:3], f"eager steps {eager} != captured "
          f"{run['metrics'][:3]}")
    del state_b, step_b, opt_b
    torch.cuda.empty_cache()

    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))
        mrun = mesh_train_run(cfg, cycle, mesh, DEFAULT_RULES,
                              kinds=MOE_KINDS, want=want)
        differing = tensors_differing(mrun.pop("params"), ref_params)
        del mrun["state"], mrun["step"], ref_params
        torch.cuda.empty_cache()
    check(mrun["launches"] == want, f"mesh: a replay launched flash "
          f"{mrun['launches']}, not {want}")
    check(mrun["metrics"] == run["metrics"] and differing == 0,
          f"the one-card mesh differs from one device: metrics "
          f"{mrun['metrics']} against {run['metrics']}, {differing} "
          "parameters differing")
    gen = moe_generate_check(cfg)
    mean_ms = float(np.mean(run["replay_ms"]))
    prof = run["profile"]
    out = {"phase": "moe", "batch": [b, s], "n_layers": cfg.n_layers,
           "moe_experts": cfg.moe_experts, "moe_top_k": cfg.moe_top_k,
           "moe_capacity_factor": cfg.moe_capacity_factor,
           "param_count": cfg.param_count(), "steps": MESH_STEPS,
           "losses": losses, "grad_norms": norms,
           "replay_ms": run["replay_ms"], "replay_ms_mean": mean_ms,
           "tokens_per_s": b * s / mean_ms * 1e3,
           "peak_memory_bytes": run["peak_bytes"],
           "memory_above_state_bytes": run["memory_above_state"],
           "launches_per_step": dict(zip(FLASH_KINDS, run["launches"])),
           "launch_readings": prof.get("launch_readings"),
           "profile_device_ms_by_kind": prof["device_ms_by_kind"],
           "profile_launches_by_kind": prof["launches_by_kind"],
           "profile_top_kernels_ms": prof["top_kernels_ms"],
           "profile_busy_share": prof["device_busy_share"],
           "eager_vs_captured": {"eager": eager, "bit_equal": True},
           "mesh": {"replay_ms_mean": float(np.mean(mrun["replay_ms"])),
                    "peak_memory_bytes": mrun["peak_bytes"],
                    "metrics_bit_equal": True, "params_differing": 0},
           "dropped_per_layer": drops,
           "picks_per_layer": cfg.moe_top_k * b * s,
           "layer0_check": layer, "generate": gen}
    emit(out)
    return out


# The seq phase: bench_400m over a one-card mesh with ring and Ulysses
# attention (sp = 1: the mesh has no sp axis, so no hop and no all-to-all
# runs; the cell exercises the local_map layer and the local attention).
SEQ_STEPS = 3  # warm-up, capture, one replay


@timed_phase
def phase_seq(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """Over a one-card mesh (a world-size-1 NCCL group): the forward of
    ``bench_400m`` with ``attn_impl`` "ring" and "ulysses" against the
    dense-attention forward on the same parameters (the forward phase's
    tolerance); ``ulysses_attention(..., attn_impl="flash")`` at
    ``MAIN_SHAPE`` bf16 equal to ``flash_attention`` bit for bit; and
    ``SEQ_STEPS`` train steps of each (warm-up, capture, replay) with finite
    losses. Printed: the logits' differences, replay ms (CUDA events) and
    peak memory."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from ray_tpu_torch.models.transformer import forward, tree_map
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.ulysses_attention import ulysses_attention
    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        MeshConfig,
        batch_sharding,
        build_mesh,
        default_optimizer,
        make_sharded_state,
    )

    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    out = {"phase": "seq", "batch": [b, s], "n_layers": cfg.n_layers,
           "forward": {}, "train": {}}
    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        q, k, v = (torch.randn(MAIN_SHAPE, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        whole = [Replicate()]
        with torch.no_grad():
            got = ulysses_attention(
                *(DTensor.from_local(t, mesh, whole) for t in (q, k, v)),
                mesh=mesh, attn_impl="flash").to_local()
            check(torch.equal(got, fa.flash_attention(q, k, v)),
                  "ulysses_attention(flash) differs from flash_attention")
        out["ulysses_flash_bit_equal_flash"] = True
        del q, k, v, got

        state, _ = make_sharded_state(cfg, default_optimizer(), SEED,
                                      mesh=mesh)
        local = tree_map(lambda p: p.to_local(), state.params)
        tokens = torch.from_numpy(cycle[0]["tokens"]).cuda()
        placed = distribute_tensor(tokens, mesh, batch_sharding(mesh)[1],
                                   src_data_rank=None)
        with torch.no_grad():
            dense = forward(local, tokens,
                            dataclasses.replace(cfg, attn_impl="dense"))
            for impl in ("ring", "ulysses"):
                icfg = dataclasses.replace(cfg, attn_impl=impl)
                logits = forward(state.params, placed, icfg, mesh).to_local()
                diff = (logits.float() - dense.float()).abs()
                agree = float((logits.argmax(-1) == dense.argmax(-1))
                              .float().mean())
                res = {"logits_max_abs_diff_vs_dense": float(diff.max()),
                       "logits_mean_abs_diff_vs_dense": float(diff.mean()),
                       "argmax_agreement_vs_dense": agree,
                       "forward_ms": cuda_ms(lambda: forward(
                           state.params, placed, icfg, mesh), 2, 1)}
                out["forward"][impl] = res
                # the forward phase's tolerance
                check(res["logits_mean_abs_diff_vs_dense"] <= 2e-2
                      and res["logits_max_abs_diff_vs_dense"] <= 0.5
                      and agree >= 0.95, f"{impl} forward disagrees with "
                      f"dense: {res}")
                del logits, diff
        del state, local, dense
        torch.cuda.empty_cache()
        for impl in ("ring", "ulysses"):
            run = mesh_train_run(dataclasses.replace(cfg, attn_impl=impl),
                                 cycle, mesh, DEFAULT_RULES, steps=SEQ_STEPS)
            losses = [m[0] for m in run["metrics"]]
            check(all(np.isfinite(losses)), f"{impl}: losses {losses}")
            out["train"][impl] = {
                "losses": losses, "grad_norms": [m[1] for m in
                                                 run["metrics"]],
                "replay_ms": run["replay_ms"],
                "peak_memory_bytes": run["peak_bytes"],
                "profile_device_ms_by_kind":
                    run["profile"]["device_ms_by_kind"]}
            del run
            torch.cuda.empty_cache()
    emit(out)
    return out


# The pipe phase: bench_400m with dense attention (the pipeline's stages run
# dense attention, as the reference's) trained as a pipeline over a one-card
# mesh (world size 1) under GPipe and 1F1B. At pp = 1 the schedule, its ring
# buffer and the scoring run, but no hop and no collective over pp does.
# 1F1B's peak activation memory may be at most PIPE_PEAK_RATIO times GPipe's
# (__graft_entry__.py:219-224).
PIPE_SCHEDULES = ("gpipe", "1f1b")
PIPE_MICROBATCHES = 8  # microbatches of one row at [8, 2048]
PIPE_STEPS = 6  # warm-up, capture, four replays
PIPE_EAGER_STEPS = 3
PIPE_PEAK_RATIO = 1.05


@timed_phase
def phase_pipe(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """``bench_400m`` (dense attention, fp32 parameters, bf16 compute, remat
    "dots") through ``make_pipeline_train_step`` over a one-card mesh (a
    world-size-1 NCCL group), ``PIPE_MICROBATCHES`` microbatches, under each
    schedule: ``PIPE_STEPS`` steps through the pump (warm-up, capture,
    replays), then ``PIPE_EAGER_STEPS`` eager steps from a fresh state of
    the same seed, which must equal the captured ones bit for bit; the peak
    memory of the last eager step above what was allocated before it. The
    first step's loss must lie within ``MESH_LOSS_RTOL`` of the
    non-pipelined dense loss on the same weights and batch, and 1F1B's peak
    within ``PIPE_PEAK_RATIO`` of GPipe's. No flash kernel runs (checked by
    name in a profiled replay). Printed: replay ms (CUDA events), tokens/s,
    MFU, peaks, launches and device ms by kind of a profiled replay."""
    from ray_tpu_torch.models.transformer import loss_fn
    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        MeshConfig,
        batch_sharding,
        build_mesh,
        default_optimizer,
        make_pipeline_train_step,
        make_sharded_state,
    )
    from torch.distributed.tensor import distribute_tensor

    check(cfg.attn_impl == "dense" and cfg.remat
          and cfg.remat_policy == "dots", "the pipelined bench_400m trains "
          "with dense attention under remat 'dots'")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    flops = train_flops(cfg, b, s)
    out = {"phase": "pipe", "batch": [b, s], "n_layers": cfg.n_layers,
           "microbatches": PIPE_MICROBATCHES, "steps": PIPE_STEPS,
           "pp": 1, "runs": {}}
    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))

        def placed(i):
            return {k: distribute_tensor(torch.from_numpy(v).cuda(), mesh,
                                         batch_sharding(mesh)[1],
                                         src_data_rank=None)
                    for k, v in cycle[i].items()}

        state, _ = make_sharded_state(cfg, default_optimizer(), SEED,
                                      mesh=mesh)
        with torch.no_grad():
            dense_loss = loss_fn(state.params, placed(0), cfg,
                                 mesh).full_tensor().item()
        del state
        torch.cuda.empty_cache()
        out["dense_first_loss"] = dense_loss
        for schedule in PIPE_SCHEDULES:
            t0 = time.perf_counter()
            run = mesh_train_run(cfg, cycle, mesh, DEFAULT_RULES,
                                 steps=PIPE_STEPS,
                                 pipeline=(schedule, PIPE_MICROBATCHES))
            del run["state"], run["step"], run["params"]
            torch.cuda.empty_cache()
            check(run["launches"] == (0, 0, 0), f"{schedule}: a replay "
                  f"launched flash kernels {run['launches']}")
            losses = [m[0] for m in run["metrics"]]
            rel = abs(losses[0] - dense_loss) / abs(dense_loss)
            check(all(np.isfinite(losses)) and rel <= MESH_LOSS_RTOL,
                  f"{schedule}: losses {losses} against the dense step's "
                  f"{dense_loss}")
            opt = default_optimizer()
            state, sh = make_sharded_state(cfg, opt, SEED, mesh=mesh)
            step = make_pipeline_train_step(cfg, opt, PIPE_MICROBATCHES,
                                            mesh=mesh, state_shardings=sh,
                                            schedule=schedule)
            eager = []
            for i in range(PIPE_EAGER_STEPS):
                batch = placed(i)
                if i == PIPE_EAGER_STEPS - 1:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                eager.append(_metric(step.eager(state, batch)[1]))
            torch.cuda.synchronize()
            eager_peak = torch.cuda.max_memory_allocated() - base
            check(eager == run["metrics"][:PIPE_EAGER_STEPS],
                  f"{schedule}: eager steps {eager} != captured "
                  f"{run['metrics'][:PIPE_EAGER_STEPS]}")
            del state, step, opt, batch
            torch.cuda.empty_cache()
            mean_ms = float(np.mean(run["replay_ms"]))
            prof = run["profile"]
            out["runs"][schedule] = {
                "losses": losses, "grad_norms": [m[1] for m in
                                                 run["metrics"]],
                "first_loss_rel_diff_vs_dense": rel,
                "replay_ms": run["replay_ms"], "replay_ms_mean": mean_ms,
                "tokens_per_s": b * s / mean_ms * 1e3,
                "mfu": flops / (mean_ms / 1e3) / PEAK_BF16_FLOPS,
                "eager_step_peak_above_start_bytes": eager_peak,
                "peak_memory_bytes": run["peak_bytes"],
                "memory_above_state_bytes": run["memory_above_state"],
                "eager_vs_captured": {"eager": eager, "bit_equal": True},
                "launches_per_step": dict(zip(FLASH_KINDS, run["launches"])),
                "profile_launches_by_kind": prof["launches_by_kind"],
                "profile_device_ms_by_kind": prof["device_ms_by_kind"],
                "profile_top_kernels_ms": prof["top_kernels_ms"],
                "profile_busy_share": prof["device_busy_share"],
                "seconds": time.perf_counter() - t0}
    peaks = {k: v["eager_step_peak_above_start_bytes"]
             for k, v in out["runs"].items()}
    out["peak_1f1b_over_gpipe"] = peaks["1f1b"] / peaks["gpipe"]
    check(peaks["1f1b"] <= PIPE_PEAK_RATIO * peaks["gpipe"],
          f"1F1B's peak {peaks['1f1b']} above {PIPE_PEAK_RATIO} x GPipe's "
          f"{peaks['gpipe']}")
    emit(out)
    return out


# multicard: bench_400m over four cards (NCCL, one process per card, spawned
# by this script) in six layouts, each against the one-card run of the same
# seed and batches (dense attention for ring, Ulysses and the pipelines, whose
# math it is; the same MoE model for the expert layout), losses within
# MESH_LOSS_RTOL per step; then dryrun_multidevice(4). Kinds of kernel in a
# replay: NCCL's collectives first, then the train step's kinds.
MULTICARD_WORLD = 4
MULTICARD_STEPS = 4  # warm-up, capture, two replays
MULTICARD_KINDS = {"nccl": "nccl", **MOE_KINDS}
MULTICARD_LAYOUTS = {  # mesh, config changes, pipeline (schedule, M)
    "ring_dp2_sp2": ({"dp": 2, "sp": 2}, {"attn_impl": "ring"}, None),
    "ulysses_sp2_tp2": ({"sp": 2, "tp": 2}, {"attn_impl": "ulysses"}, None),
    "moe_ep2_dp2": ({"dp": 2, "ep": 2}, {"moe_experts": 4, "moe_top_k": 2,
                                          "moe_capacity_factor": 2.0}, None),
    "pipe_1f1b_pp4": ({"pp": 4}, {"attn_impl": "dense"}, ("1f1b", 8)),
    "pipe_gpipe_dp2_pp2": ({"dp": 2, "pp": 2}, {"attn_impl": "dense"},
                           ("gpipe", 4)),
    "pipe_1f1b_pp2_tp2": ({"pp": 2, "tp": 2}, {"attn_impl": "dense"},
                          ("1f1b", 4)),
}
MULTICARD_TIMEOUT_S = 900


def multicard_rank(rank: int, world: int, port: str) -> None:
    """One rank of ``multicard`` (card ``rank``): the one-card runs, then
    each layout over the four cards, then the dry run; rank 0 prints the
    result line."""
    import faulthandler

    import torch.distributed as dist

    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig, build_mesh
    from ray_tpu_torch.parallel.dryrun import dryrun_multidevice

    # a rank still waiting shortly before the launcher's deadline shows
    # where (every thread's stack), and exits
    faulthandler.dump_traceback_later(MULTICARD_TIMEOUT_S - 30, exit=True)

    def stage(what):
        print(f"multicard rank {rank}: {what} "
              f"({time.strftime('%H:%M:%S')})", flush=True)

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        base = TransformerConfig.bench_400m()
        b, s = MAIN_SHAPE[0], MAIN_SHAPE[1]
        cycle = numpy_train_batches(base.vocab_size, b, s, TRAIN_CYCLE,
                                    SEED + 2)
        one_card = {}
        for name in ("dense", "moe"):
            kw = MULTICARD_LAYOUTS["moe_ep2_dp2"][1] if name == "moe" else {
                "attn_impl": "dense"}
            stage(f"one-card run, {name}")
            run = mesh_train_run(dataclasses.replace(base, **kw), cycle,
                                 steps=MULTICARD_STEPS)
            one_card[name] = {"metrics": run["metrics"],
                              "replay_ms": run["replay_ms"]}
            del run
            torch.cuda.empty_cache()
        out = {"phase": "multicard", "world": world, "batch": [b, s],
               "layouts": {}}
        for name, (sizes, kw, pipeline) in MULTICARD_LAYOUTS.items():
            stage(f"layout {name}")
            cfg = dataclasses.replace(base, **kw)
            mesh = build_mesh(MeshConfig(**sizes))
            run = mesh_train_run(cfg, cycle, mesh, DEFAULT_RULES,
                                 steps=MULTICARD_STEPS, kinds=MULTICARD_KINDS,
                                 pipeline=pipeline)
            ref = one_card["moe" if cfg.moe_experts else "dense"]
            rel = [abs(g[0] - r[0]) / abs(r[0])
                   for g, r in zip(run["metrics"], ref["metrics"])]
            prof = run["profile"]
            out["layouts"][name] = {
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "pipeline": pipeline,
                "losses": [m[0] for m in run["metrics"]],
                "one_card_losses": [m[0] for m in ref["metrics"]],
                "loss_rel_diff": rel,
                "replay_ms": run["replay_ms"],
                "one_card_replay_ms": ref["replay_ms"],
                "peak_memory_bytes": run["peak_bytes"],
                "device_ms_by_kind": prof["device_ms_by_kind"],
                "launches_by_kind": prof["launches_by_kind"],
                "collective_ms": prof["device_ms_by_kind"]["nccl"],
                "busy_share": prof["device_busy_share"]}
            check(all(np.isfinite(m[0]) for m in run["metrics"])
                  and max(rel) <= MESH_LOSS_RTOL,
                  f"{name}: losses {run['metrics']} against one card "
                  f"{ref['metrics']}")
            del run
            torch.cuda.empty_cache()
        stage("dryrun_multidevice")
        out["dryrun"] = dryrun_multidevice(world)
        if rank == 0:
            emit(out)
    finally:
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()


@timed_phase
def phase_multicard() -> None:
    """Spawns ``multicard_rank`` in ``MULTICARD_WORLD`` processes (this
    script, one per card) and waits for them, at most
    ``MULTICARD_TIMEOUT_S``; when a rank fails the others are killed, and
    every rank's output is printed. Needs four cards."""
    import shutil
    import socket
    import tempfile

    n = torch.cuda.device_count()
    if n < MULTICARD_WORLD:
        raise RuntimeError(f"multicard needs {MULTICARD_WORLD} CUDA cards; "
                           f"{n} visible")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_multicard_"))
    logs = [open(work / f"rank{r}.log", "w+") for r in range(MULTICARD_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "multicard-rank",
         str(r), str(MULTICARD_WORLD), port], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(MULTICARD_WORLD)]
    deadline = time.monotonic() + MULTICARD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.returncode is not None):
                break  # a rank failed: its peers would wait for it
            if time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * MULTICARD_WORLD:
        for r, (c, o) in enumerate(zip(codes, outs)):
            print(f"--- multicard rank {r} (exit {c}) ---\n{o[-8000:]}",
                  flush=True)
        raise RuntimeError(f"multicard ranks exited {codes}")
    print(outs[0], end="", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    multicard_runtime()
    multicard_mesh_group()
    multicard_data()
    multicard_rl()
    multicard_micro()


def _multicard_trainer_loop(config):
    """A ``TorchTrainer`` worker of ``multicard_runtime``: ``bench_400m``
    over the group's dp mesh (NCCL) for ``steps`` steps; reports its card
    and losses."""
    import os

    import chip_smoke
    from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig
    from ray_tpu_torch.train import session

    mesh = session.make_mesh(MeshConfig(dp=session.get_world_size()))
    run = chip_smoke.mesh_train_run(config["cfg"], config["cycle"], mesh,
                                    DEFAULT_RULES, steps=config["steps"])
    session.report({"rank": session.get_world_rank(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "uuid": str(torch.cuda.get_device_properties(0).uuid),
                    "losses": [m[0] for m in run["metrics"]],
                    "replay_ms": run["replay_ms"]})


def multicard_runtime() -> None:
    """The runtime on four cards: four ``num_gpus=1`` tasks held at once
    each see one distinct card (``get_accelerator_ids`` and the device's
    uuid), and a ``TorchTrainer`` of four NCCL workers trains
    ``bench_400m`` at dp 4 for ``MULTICARD_STEPS`` steps, each loss within
    ``MESH_LOSS_RTOL`` of the same steps on one card in this process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = TransformerConfig.bench_400m()
    cycle = numpy_train_batches(cfg.vocab_size, MAIN_SHAPE[0], MAIN_SHAPE[1],
                                TRAIN_CYCLE, SEED + 2)
    one = mesh_train_run(cfg, cycle, steps=MULTICARD_STEPS)
    one_card = [m[0] for m in one["metrics"]]
    one_card_replay_ms = one["replay_ms"]
    del one
    torch.cuda.empty_cache()
    rt.init()
    try:
        check(rt.cluster_resources().get("GPU") == MULTICARD_WORLD,
              f"init granted {rt.cluster_resources()}")

        @rt.remote(num_cpus=0)
        class Gate:
            def __init__(self):
                self.n = 0

            def arrive(self):
                self.n += 1
                return self.n

            def count(self):
                return self.n

        @rt.remote(num_gpus=1)
        def on_card(gate):
            import time

            import torch

            import ray_tpu_torch as rt_w

            rt_w.get(gate.arrive.remote(), timeout=60)
            while rt_w.get(gate.count.remote(), timeout=60) < 4:
                time.sleep(0.05)
            ids = rt_w.get_runtime_context().get_accelerator_ids()["GPU"]
            return ids, str(torch.cuda.get_device_properties(0).uuid)

        gate = Gate.remote()
        held = rt.get([on_card.remote(gate) for _ in range(MULTICARD_WORLD)],
                      timeout=300)
        ids = [i for i, _ in held]
        uuids = [u for _, u in held]
        check(all(len(i) == 1 for i in ids)
              and len({i[0] for i in ids}) == MULTICARD_WORLD
              and len(set(uuids)) == MULTICARD_WORLD,
              f"four held GPU tasks saw cards {held}")
        reports = {}

        class Collect(TorchTrainer):
            def _drain(self, group):
                done = [False] * group.num_workers
                while not all(done):
                    for rank, p in enumerate(group.poll_all(timeout=10.0)):
                        for ev in p["events"]:
                            reports[rank] = ev["metrics"]
                        if p["done"]:
                            check(p["error"] is None,
                                  f"rank {rank}: {p['error']!r}\n"
                                  f"{p.get('error_tb')}")
                            done[rank] = True
                return reports.get(0, {})

        t0 = time.perf_counter()
        Collect(_multicard_trainer_loop,
                train_loop_config={"cfg": cfg, "cycle": cycle,
                                   "steps": MULTICARD_STEPS},
                scaling_config=ScalingConfig(num_workers=MULTICARD_WORLD,
                                             use_gpu=True),
                run_config=RunConfig(name="multicard")).fit()
        fit_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
    check(sorted(reports) == list(range(MULTICARD_WORLD))
          and len({r["uuid"] for r in reports.values()}) == MULTICARD_WORLD,
          f"trainer ranks on cards {[r.get('uuid') for r in reports.values()]}")
    rel = [abs(g - r) / abs(r) for g, r in zip(reports[0]["losses"],
                                                one_card)]
    check(all(np.isfinite(reports[0]["losses"])) and max(rel)
          <= MESH_LOSS_RTOL,
          f"trainer losses {reports[0]['losses']} against one card "
          f"{one_card}")
    emit({"phase": "multicard_runtime",
          "held_tasks": [{"gpu_ids": i, "uuid": u} for i, u in held],
          "trainer": {"fit_s": fit_s,
                      "ranks": {r: {k: v[k] for k in ("visible", "uuid",
                                                       "replay_ms")}
                                for r, v in sorted(reports.items())},
                      "losses": reports[0]["losses"],
                      "one_card_losses": one_card,
                      "one_card_replay_ms": one_card_replay_ms,
                      "loss_rel_diff": rel}})


# Flash against dense attention through the whole model:
# - fp32 (TF32 off), 2 layers: the same math with sums in another order and
#   expf; each leaf's grads may differ by 2e-4 of that leaf's largest dense
#   grad (a wrong mask or GQA sum moves them by O(1) of it).
# - bf16, full depth, the first train step: the two attentions round p and
#   ds at different places through 24 layers; loss within 2e-3 and grad
#   norm within 5e-3 relative (both ~1e-4 on the card).
GRAD_FP32_RTOL = 2e-4
STEP_LOSS_ATOL, STEP_NORM_RTOL = 2e-3, 5e-3


@timed_phase
def phase_grad(cfg, b32: int = 2, b: int = MAIN_SHAPE[0],
               s: int = MAIN_SHAPE[1], steps: int = 7) -> dict:
    from ray_tpu_torch.models.transformer import (
        init_params,
        loss_fn,
        tree_leaves,
        tree_map,
    )
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = tree_map(lambda t: t.requires_grad_(True),
                      init_params(cfg32, SEED))
    batch = train_batch(cfg.vocab_size, b32, s, SEED + 3)
    grads = {}
    for impl in ("flash", "dense"):
        loss = loss_fn(params, batch,
                       dataclasses.replace(cfg32, attn_impl=impl))
        grads[impl] = (loss.item(),
                       torch.autograd.grad(loss, tree_leaves(params)))
    ratios = [((f - d).abs().max() / d.abs().max().clamp_min(1e-30)).item()
              for f, d in zip(grads["flash"][1], grads["dense"][1])]
    out = {"phase": "grad", "fp32_layers": 2, "fp32_batch": [b32, s],
           "fp32_loss_flash": grads["flash"][0],
           "fp32_loss_dense": grads["dense"][0],
           "fp32_grad_max_rel_err": max(ratios),
           "fp32_grad_rtol": GRAD_FP32_RTOL}
    check(max(ratios) <= GRAD_FP32_RTOL
          and abs(grads["flash"][0] - grads["dense"][0]) <= 1e-4,
          f"fp32 flash grads disagree with dense: {out}")
    del grads, params
    torch.cuda.empty_cache()

    # The train phase's run again (same init, same batch), beside the same
    # steps with dense attention: step 1 is held to the tolerances above;
    # the later steps are reported, to tell the optimizer's dynamics on a
    # repeated batch from the kernels'.
    init = init_params(cfg, SEED)
    batch = train_batch(cfg.vocab_size, b, s, SEED + 2)
    traj = {}
    for impl in ("flash", "dense"):
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        opt = default_optimizer()
        state, _ = make_sharded_state(icfg, opt, SEED,
                                      params=tree_map(torch.clone, init))
        step = make_train_step(icfg, opt)
        ms = [step(state, batch)[1] for _ in range(steps)]
        traj[impl] = [(m["loss"].item(), m["grad_norm"].item()) for m in ms]
        del state, step, ms
        torch.cuda.empty_cache()
    (lf, nf), (ld, nd) = traj["flash"][0], traj["dense"][0]
    out.update({"bf16_step_loss_flash": lf, "bf16_step_loss_dense": ld,
                "bf16_step_grad_norm_flash": nf,
                "bf16_step_grad_norm_dense": nd,
                "bf16_losses_flash": [x[0] for x in traj["flash"]],
                "bf16_losses_dense": [x[0] for x in traj["dense"]],
                "bf16_grad_norms_flash": [x[1] for x in traj["flash"]],
                "bf16_grad_norms_dense": [x[1] for x in traj["dense"]]})
    check(bool(np.isfinite([lf, ld, nf, nd]).all())
          and abs(lf - ld) <= STEP_LOSS_ATOL
          and abs(nf / nd - 1) <= STEP_NORM_RTOL,
          f"bf16 flash train step disagrees with dense: {out}")
    emit(out)
    return out


# bench.py's inference leg (``measure_inference``, bench.py:233-270, called
# at :388-391): bench_400m with dense attention and no remat, bf16, 8
# prompts of 1024 tokens, 64 new tokens through a 1089-row cache.
INFERENCE_BATCH, INFERENCE_PROMPT, INFERENCE_NEW = 8, 1024, 64


def captured_decode_block(params, cfg, cache, first, start: int,
                          steps: int) -> torch.Tensor:
    """``decode_block_into`` (the engine's decode program) from ``first`` at
    ``start`` for every slot, greedy, captured in a CUDA graph
    (``ray_tpu_torch.graphs``) and replayed once (the state and the cache
    rows the warm-up wrote are reset first). Returns the tokens [B,
    steps]."""
    from ray_tpu_torch import graphs
    from ray_tpu_torch.models.generation import decode_block_into

    b = first.shape[0]
    tok, pos = first.clone(), torch.full((b,), start, device=first.device)
    zeros_i = torch.zeros(b, dtype=torch.long, device=first.device)
    temps = torch.zeros(b, dtype=torch.float32, device=first.device)
    counts = zeros_i.clone()
    out = torch.zeros((b, steps), dtype=torch.long, device=first.device)

    def block():
        decode_block_into(params, cache, tok, pos, temps, zeros_i, counts,
                          cfg, out)

    graphs.warm_up(block, first.device)
    cap = graphs.capture(block)
    tok.copy_(first)
    pos.fill_(start)
    counts.zero_()
    cap.replay()
    torch.cuda.synchronize()
    del cap
    return out.clone()


@timed_phase
def phase_inference(cfg) -> dict:
    """bench.py's inference leg on the port: ``prefill`` timed as TTFT and
    ``decode_loop`` as decode tokens/s (each the second call of its
    signature, the first having captured its programs), as bench.py times
    the reference's two compiled programs. Checks: the timed loop runs no
    eager decode step; it replays its captured blocks, each holding one
    decode attention launch per layer per step, and so does a profiled
    replay by kernel name. Then the first and second calls of a 256- and a
    1023-step loop (what capture costs in time and memory at longer
    generations). The captured ``generate`` gives the same greedy tokens as
    the same bodies run uncaptured on the card; in float32 with TF32 off,
    the engine's decode program (captured, ``RAYTPU_DECODE_DEFERRED_WRITES``
    unset and set) gives ``generate``'s tokens from its prefill, the two
    structures bit for bit alike."""
    import os

    from ray_tpu_torch.models import generation
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops import decode_attention as da

    b, s, new = INFERENCE_BATCH, INFERENCE_PROMPT, INFERENCE_NEW
    max_len = s + new + 1
    icfg = dataclasses.replace(cfg, attn_impl="dense", remat=False)
    params, icfg = generation.prepare_for_inference(init_params(icfg, SEED),
                                                    icfg)
    rng = np.random.default_rng(SEED + 6)
    prompt = torch.from_numpy(rng.integers(0, icfg.vocab_size, (b, s))).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    out = {"phase": "inference", "batch": b, "prompt_len": s,
           "new_tokens": new, "max_len": max_len,
           "n_layers": icfg.n_layers}
    generation.release_programs()
    da.launches = 0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def run_prefill():
        return generation.prefill(params, prompt, icfg, max_len)

    _, out["prefill_capture_ms"] = timed(run_prefill)
    (logits, cache), out["ttft_ms"] = timed(run_prefill)
    first = torch.argmax(logits, dim=-1)
    start = torch.tensor(s, device="cuda")

    def run_decode():
        return generation.decode_loop(params, first, cache, start, icfg, new,
                                      0.0, gen)

    _, out["decode_capture_ms"] = timed(run_decode)
    with eager_decode_steps("decode_step") as eager:
        toks, decode_ms = timed(run_decode)
    out.update({"decode_ms": decode_ms,
                "decode_tokens_per_s": b * new / decode_ms * 1e3,
                "eager_decode_steps_in_timed_loop": eager[0],
                "decode_ms_cuda_events": cuda_ms(run_decode, 3, 0)})
    programs = generation.programs()
    out["programs"] = [{"kind": list(kind), "replays": replays,
                        "decode_attention_launches": launches}
                       for kind, replays, launches in programs]
    decode = [(kind[1], replays, launches)
              for kind, replays, launches in programs if kind[0] == "decode"]
    plan = generation._block_plan(new)
    check(sorted(k for k, _, _ in decode) == sorted(set(plan))
          and all(r >= 2 * plan.count(k) for k, r, _ in decode),
          f"decode_loop ran from its captured blocks {plan}: {programs}")
    rates = {launches / k for k, _, launches in decode}
    per_step = rates.pop() if len(rates) == 1 else sorted(rates)
    per_step = (int(per_step) if isinstance(per_step, float)
                and per_step.is_integer() else per_step)
    out["decode_attention_launches_per_step"] = per_step
    out["decode_attention_wrapper_launches"] = da.launches
    check(eager[0] == 0 and per_step == icfg.n_layers,
          f"the timed loop ran {eager[0]} eager decode steps; its graph "
          f"holds {per_step} decode attention launches per step, not "
          f"{icfg.n_layers}")
    prof = profile_launches(run_decode, DECODE_KINDS,
                            {"decode_attention": icfg.n_layers * new})
    per_step_by_name = prof["launches_by_kind"]["decode_attention"] / new
    out["decode_profile"] = prof
    out["decode_attention_kernel_ms_per_step"] = (
        prof["device_ms_by_kind"]["decode_attention"] / new)
    check(per_step_by_name == icfg.n_layers,
          f"a profiled replay ran {per_step_by_name} decode attention calls "
          f"per step, not {icfg.n_layers}")
    check(toks.shape == (b, new) and bool(((toks >= 0)
                                           & (toks < icfg.vocab_size)).all()),
          "decode_loop tokens of the wrong shape or out of the vocabulary")

    # the first call of a longer loop: the blocks it captures (one at 256
    # steps, all six at 1023) against its second call, and the memory the
    # capture took (the session's pool; its static cache came with prefill)
    out["first_call_by_new_tokens"] = {}
    for n in (256, 1023):
        generation.release_programs()
        torch.cuda.empty_cache()
        logits_n, cache_n = generation.prefill(params, prompt, icfg,
                                               s + n + 1)
        first_n = torch.argmax(logits_n, dim=-1)
        torch.cuda.synchronize()
        alloc, reserved = (torch.cuda.memory_allocated(),
                           torch.cuda.memory_reserved())

        def run_n():
            return generation.decode_loop(params, first_n, cache_n, start,
                                          icfg, n, 0.0, gen)

        _, first_ms = timed(run_n)
        grown = (torch.cuda.memory_allocated() - alloc,
                 torch.cuda.memory_reserved() - reserved)
        _, second_ms = timed(run_n)
        out["first_call_by_new_tokens"][n] = {
            "block_plan": generation._block_plan(n),
            "programs_captured": sum(k[0] == "decode"
                                     for k, _, _ in generation.programs()),
            "first_call_ms": first_ms, "second_call_ms": second_ms,
            "capture_ms": first_ms - second_ms,
            "allocated_bytes_grown": grown[0],
            "reserved_bytes_grown": grown[1]}
        del logits_n, cache_n
    generation.release_programs()
    torch.cuda.empty_cache()

    # captured generate against the same bodies run uncaptured on the card
    captured = generation.generate(params, prompt, icfg,
                                   max_new_tokens=new + 1, max_len=max_len)
    with torch.no_grad():
        cache_e = generation.init_kv_cache(icfg, b, max_len)
        logits_e = generation._forward_cached(params, prompt, cache_e, 0,
                                              icfg)[0][:, -1]
        first_e = torch.argmax(logits_e, dim=-1)
        zeros_i = torch.zeros(b, dtype=torch.long, device="cuda")
        rest_e = generation.decode_loop_into(
            params, cache_e, first_e.clone(), torch.tensor(s, device="cuda"),
            torch.zeros(b, device="cuda"), zeros_i, zeros_i.clone(), icfg,
            torch.zeros((b, new), dtype=torch.long, device="cuda"))
    uncaptured = torch.cat([first_e[:, None], rest_e], dim=1)
    check(torch.equal(captured, uncaptured),
          "captured generate differs from the same loop run uncaptured")
    out["captured_equals_uncaptured"] = True
    out["prefill_logits_bit_equal_uncaptured"] = torch.equal(logits,
                                                             logits_e)
    out["tokens_equal_decode_loop"] = torch.equal(captured[:, 1:], toks)
    del cache_e, logits_e
    generation.release_programs()
    torch.cuda.empty_cache()

    # float32, TF32 off: generate's tokens against the engine's decode
    # program from generate's prefill, with and without deferred writes
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(icfg, dtype=torch.float32)
    ref = generation.generate(params, prompt, cfg32, max_new_tokens=new + 1,
                              max_len=max_len)
    with torch.no_grad():
        logits32, cache32 = generation.prefill(params, prompt, cfg32,
                                               max_len)
        first32 = torch.argmax(logits32, dim=-1)
        blocks = {}
        for flag in ("0", "1"):
            os.environ["RAYTPU_DECODE_DEFERRED_WRITES"] = flag
            try:
                blocks[flag] = captured_decode_block(
                    params, cfg32, {k: v.clone() for k, v in cache32.items()},
                    first32, s, new)
            finally:
                os.environ.pop("RAYTPU_DECODE_DEFERRED_WRITES")
    check(torch.equal(blocks["1"], blocks["0"]),
          "deferred writes change the engine's decode tokens")
    check(torch.equal(first32, ref[:, 0])
          and torch.equal(blocks["1"], ref[:, 1:]),
          "fp32: the deferred-writes decode differs from generate")
    out["fp32_deferred_writes_equals_generate"] = True
    del cache32, logits32, params
    generation.release_programs()
    torch.cuda.empty_cache()
    emit(out)
    return out


def _serve_concurrently(engine, prompts, max_new_tokens):
    """One client thread per prompt, all started together. Returns each
    stream's tokens and the arrival times of its tokens (s since start)."""
    results = [None] * len(prompts)
    stamps = [[] for _ in prompts]
    t0 = time.perf_counter()

    def client(i):
        toks = []
        for tok in engine.generate_stream(prompts[i],
                                          max_new_tokens=max_new_tokens):
            stamps[i].append(time.perf_counter() - t0)
            toks.append(tok)
        results[i] = toks

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client never finished")
    return results, stamps


def _decode_state(cfg, rng, slots, pos, max_len):
    """A fresh engine-sized cache and greedy slot state on the card: random
    next tokens, every slot at position ``pos``."""
    from ray_tpu_torch.models.generation import init_kv_cache

    cache = init_kv_cache(cfg, slots, max_len)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, slots)).cuda()
    pos_t = torch.full((slots,), pos, device=tok.device)
    zeros_i = torch.zeros(slots, dtype=torch.long, device=tok.device)
    temps = torch.zeros(slots, dtype=torch.float32, device=tok.device)
    return cache, tok, pos_t, temps, zeros_i, zeros_i.clone()


def decode_profile(params, cfg, rng, slots=8, steps=8, pos=300,
                   max_len=1024) -> dict:
    """One engine-sized decode block (``slots`` slots at position ``pos`` of
    a ``max_len``-row cache, ``steps`` greedy steps) run eagerly, op by op,
    under the profiler: the host's share of a step without graphs. Device
    time is also summed by kind of kernel (``DECODE_KINDS``)."""
    from ray_tpu_torch.models.generation import (
        decode_block,
        prepare_for_inference,
    )

    ip, icfg = prepare_for_inference(params, cfg)
    state = _decode_state(icfg, rng, slots, pos, max_len)

    def block():
        decode_block(ip, *state, icfg, steps)

    with torch.inference_mode():
        block()  # warm-up
        prof = device_profile(block, kinds=DECODE_KINDS)
    prof["steps"] = steps
    prof["wall_ms_per_step"] = prof["wall_ms"] / steps
    return prof


def graph_decode_profile(params, cfg, rng, slots=8, steps=8, pos=300,
                         max_len=1024) -> dict:
    """The same decode block as the engine runs it: ``decode_block_into``
    captured in one CUDA graph (``ray_tpu_torch.graphs``) and replayed
    (every slot back at ``pos`` before each replay). Device ms per step by
    CUDA events over 5 replays, then one replay under the profiler (busy
    share, device ms by kind), and the int8 and decode attention launches
    the graph holds. Beside it, the block captured again with
    ``RAYTPU_DECODE_DEFERRED_WRITES=1`` (the reference's deferred-writes
    structure), the two timed in turns: default, deferred, default,
    deferred."""
    import os

    from ray_tpu_torch import graphs
    from ray_tpu_torch.models.generation import (
        decode_block_into,
        prepare_for_inference,
    )

    ip, icfg = prepare_for_inference(params, cfg)
    cache, tok, pos_t, temps, seeds, counts = _decode_state(
        icfg, rng, slots, pos, max_len)
    out = torch.empty((slots, steps), dtype=torch.long, device=tok.device)
    block = functools.partial(decode_block_into, ip, cache, tok, pos_t,
                              temps, seeds, counts, icfg, out)
    caps = {}
    knob = "RAYTPU_DECODE_DEFERRED_WRITES"
    with torch.inference_mode():
        was = os.environ.pop(knob, None)
        try:
            for flag in ("0", "1"):
                os.environ[knob] = flag
                graphs.warm_up(block, tok.device)
                caps[flag] = graphs.capture(block)
        finally:
            os.environ.pop(knob)
            if was is not None:
                os.environ[knob] = was

        def replayer(flag):
            def replay():
                pos_t.fill_(pos)
                caps[flag].graph.replay()
            return replay

        turns = {"0": [], "1": []}
        for flag in ("0", "1", "0", "1"):
            turns[flag].append(cuda_ms(replayer(flag), 5, 1) / steps)
        prof = profile_launches(replayer("0"), DECODE_KINDS,
                                {"decode_attention": icfg.n_layers * steps})
    launches = caps["0"].launches
    del caps
    torch.cuda.empty_cache()
    prof.update({"steps": steps,
                 "device_ms_per_step_cuda_events": turns["0"][0],
                 "wall_ms_per_step": prof["wall_ms"] / steps,
                 "int8_launches_per_replay": launches["int8_matmul"],
                 "decode_attention_launches_per_replay":
                     launches["decode_attention"],
                 "deferred_writes_turns_ms_per_step": {
                     "per_layer_writes": turns["0"],
                     "deferred_writes": turns["1"]}})
    prof["device_ms_per_step_by_kind"] = {
        k: v / steps for k, v in prof["device_ms_by_kind"].items()}
    prof["decode_attention_launches_per_step_by_name"] = (
        prof["launches_by_kind"]["decode_attention"] / steps)
    check(prof["decode_attention_launches_per_step_by_name"]
          == icfg.n_layers,
          f"a profiled replay of the engine's decode block ran "
          f"{prof['decode_attention_launches_per_step_by_name']} decode "
          f"attention kernels per step, not one per layer ({icfg.n_layers})")
    return prof


@contextlib.contextmanager
def eager_decode_steps(name: str = "decode_step_multi"):
    """Counts the decode steps that Python runs while the block is open
    (``generation.<name>`` called op by op: the engine's
    ``decode_step_multi``, ``generate``'s ``decode_step``); a replayed graph
    calls none."""
    from ray_tpu_torch.models import generation

    real = getattr(generation, name)
    count = [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    setattr(generation, name, counted)
    try:
        yield count
    finally:
        setattr(generation, name, real)


def graph_stats(engine, int8_wrapper_launches: int) -> dict:
    """The engine's graph replays, the int8 and decode attention kernel
    launches they made (each graph's captured launches times its replays),
    the int8 launches the wrapper counted (warm-up and capture), and the
    launches of each per decode step."""
    replays = engine.graph_replays
    decode = [key for key in replays if key[0] == "decode"]
    steps = sum(replays[key] * key[1] for key in decode)
    out = {"graph_replays": {f"{a}_{b}": n for (a, b), n in replays.items()},
           "replayed_decode_steps": steps,
           "int8_launches_wrapper": int8_wrapper_launches}
    for name, per_graph in (("int8", engine.graph_int8_launches),
                            ("decode_attention",
                             engine.graph_decode_attention_launches)):
        per_step = None
        if steps:  # each block length's graph holds a whole number per step
            per_step = sum(replays[key] * per_graph[key]
                           for key in decode) / steps
            per_step = int(per_step) if per_step.is_integer() else per_step
        out.update({f"graph_{name}_launches": {
                        f"{a}_{b}": n for (a, b), n in per_graph.items()},
                    f"{name}_launches_replayed": sum(
                        replays[key] * per_graph[key] for key in replays),
                    f"{name}_launches_per_decode_step": per_step})
    return out


def serve_through_graphs(engine, prompts, new, vocab) -> dict:
    """Warms the engine with one short request, then serves ``prompts``
    concurrently: every decode block of the traffic must be a graph replay
    (no decode step run by Python). Then one sampled request (temperature
    1, seed 5) twice: the same tokens both times."""
    engine.generate(prompts[0][:64], max_new_tokens=4)  # warm-up
    with eager_decode_steps() as eager:
        results, stamps = _serve_concurrently(engine, prompts, new)
    stats = engine.stats()
    kw = dict(max_new_tokens=16, temperature=1.0, seed=5)
    sampled = [engine.generate(prompts[1][:100], **kw) for _ in range(2)]
    check(stats["graph_replays"] > 0 and eager[0] == 0,
          f"serving ran {eager[0]} eager decode steps, "
          f"{stats['graph_replays']} graph replays")
    check(sampled[0] == sampled[1]
          and all(0 <= t < vocab for t in sampled[0]),
          f"temperature-1 requests differ: {sampled}")
    return {**serve_metrics(results, stamps, new, vocab),
            "decode_steps": stats["steps"],
            "graph_replays_total": stats["graph_replays"],
            "eager_decode_steps_in_traffic": eager[0],
            "sampled_tokens_equal_twice": True,
            "sampled_differs_from_greedy":
            sampled[0] != engine.generate(prompts[1][:100],
                                          max_new_tokens=16)}


def check_hash_bits_cpu_equals_cuda(vocab: int) -> dict:
    """The sampler's integer bits for the same (seed, count) pairs must be
    equal on the CPU and on the card."""
    from ray_tpu_torch.models.generation import _hash_bits

    seeds = torch.tensor([0, 1, 7, -3, 2 ** 31 + 5, 123456789, 5, 5])
    counts = torch.tensor([0, 1, 2, 3, 4, 1000, 0, 1])
    cpu = _hash_bits(seeds, counts, vocab)
    card = _hash_bits(seeds.cuda(), counts.cuda(), vocab).cpu()
    check(torch.equal(cpu, card), "hash bits differ between CPU and CUDA")
    return {"pairs": len(seeds), "vocab": vocab, "equal": True}


def serve_metrics(results, stamps, new: int, vocab: int) -> dict:
    """Checks that every stream has ``new`` valid ids; TTFT median and max,
    and the decode rate once every request has its first token (the tokens
    that arrived after that moment over the time they took)."""
    for r in results:
        check(r is not None and len(r) == new
              and all(isinstance(t, int) and 0 <= t < vocab for t in r),
              f"bad stream {r}")
    ttft = [s[0] for s in stamps]
    wall = max(s[-1] for s in stamps)
    all_in = max(ttft)
    decoded = sum(t > all_in for s in stamps for t in s)
    return {"requests": len(results), "new_tokens": new, "wall_s": wall,
            "tokens_per_s": sum(map(len, results)) / wall,
            "decode_tokens_per_s": decoded / (wall - all_in),
            "ttft_ms_median": float(np.median(ttft)) * 1e3,
            "ttft_ms_max": all_in * 1e3}


def serve_rounds(rounds: list) -> dict:
    """``serve_metrics`` of several rounds of the same traffic: each round's,
    and the median, least and greatest of each figure over the rounds."""
    keys = ("wall_s", "tokens_per_s", "decode_tokens_per_s",
            "ttft_ms_median", "ttft_ms_max")
    return {"rounds": len(rounds), "per_round": rounds,
            **{stat: {k: float(f([m[k] for m in rounds])) for k in keys}
               for stat, f in (("median", np.median), ("min", min),
                               ("max", max))}}


def fp32_engine_equals_generate(params, cfg, rng) -> None:
    """In float32 with TF32 off, the engine's greedy tokens for 3
    interleaved prompts (2 slots, 16 new tokens) must EQUAL ``generate``'s,
    one prompt at a time."""
    from ray_tpu_torch.models.generation import generate, release_programs
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    new = 16
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 100, 70)]
    ref = [generate(params, p[None], cfg32, max_new_tokens=new,
                    max_len=256)[0].tolist() for p in prompts]
    release_programs()  # generate's sessions leave the card to the engine
    engine = LLMEngine(params, cfg32, max_slots=2, max_len=256,
                       prefill_buckets=(64, 128))
    try:
        got, _ = _serve_concurrently(engine, prompts, new)
    finally:
        engine.shutdown()
    check(got == ref, f"fp32 engine tokens differ from generate: {got} "
          f"vs {ref}")


@timed_phase
def phase_serve(params, cfg) -> dict:
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import int8_matmul as im
    from ray_tpu_torch.serve.llm import LLMEngine

    rng = np.random.default_rng(SEED + 1)
    new = 32
    lens = rng.integers(64, 501, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    fa.launches = im.launches = 0
    engine = LLMEngine(params, cfg, max_slots=8, max_len=1024,
                       prefill_buckets=(128, 512))
    try:
        traffic = serve_through_graphs(engine, prompts, new, cfg.vocab_size)
        graphs = graph_stats(engine, im.launches)
    finally:
        engine.shutdown()
    out = {"phase": "serve", "prompt_lens": lens.tolist(), **traffic,
           **graphs, "flash_launches": fa.launches}
    check(graphs["int8_launches_per_decode_step"] == 0,
          "bf16 weights launch no int8 kernel")
    check(graphs["decode_attention_launches_per_decode_step"]
          == cfg.n_layers, f"decode attention launches per decode step "
          f"{graphs['decode_attention_launches_per_decode_step']}, not one "
          f"per layer ({cfg.n_layers})")
    del engine
    torch.cuda.empty_cache()
    out["decode_block_graph_profile"] = graph_decode_profile(params, cfg, rng)
    out["decode_block_profile"] = decode_profile(params, cfg, rng)
    out["hash_bits_cpu_equals_cuda"] = check_hash_bits_cpu_equals_cuda(
        cfg.vocab_size)
    torch.cuda.empty_cache()

    # float32, TF32 off: the engine's greedy tokens must EQUAL generate's
    fp32_engine_equals_generate(params, cfg, rng)
    out["fp32_engine_equals_generate"] = True
    emit(out)
    return out


def weight_bytes(params) -> dict:
    """Bytes of the weights at rest: the layers' int8 ``q`` and fp32 scales,
    their other leaves (norms; every weight when none is quantized), and
    the embedding, lm_head and final norm."""
    from ray_tpu_torch.models.quant import QTensor
    from ray_tpu_torch.models.transformer import tree_leaves

    out = {"layers_int8": 0, "layers_scales": 0, "layers_other": 0,
           "embed_head_final_ln": 0}
    for w in tree_leaves(params["layers"]):
        if isinstance(w, QTensor):
            out["layers_int8"] += w.q.numel() * w.q.element_size()
            out["layers_scales"] += w.s.numel() * w.s.element_size()
        else:
            out["layers_other"] += w.numel() * w.element_size()
    out["embed_head_final_ln"] = sum(
        w.numel() * w.element_size() for name, sub in params.items()
        if name != "layers" for w in tree_leaves(sub))
    return out


def dequant_ms_per_step(params, dtype) -> float:
    """Device time (CUDA events) of dequantizing every layer weight once,
    layer by layer, as one decode step or one prefill does."""
    from ray_tpu_torch.models.quant import QTensor
    from ray_tpu_torch.models.transformer import tree_leaves, unbind_layers

    n_layers = params["layers"]["ln1"]["scale"].shape[0]
    qts = [w for lp in unbind_layers(params, n_layers)
           for w in tree_leaves(lp) if isinstance(w, QTensor)]

    def run():
        for w in qts:
            w.to(dtype)

    with torch.inference_mode():
        return cuda_ms(run, 3, 1)


def serve_7b_traffic(params, cfg, prompts, new) -> dict:
    """bench.py's serving engine (8 slots, max_len 512, prefill bucket 128,
    block 8 steps) answering ``prompts`` concurrently through its graphs;
    then one decode block of 8 slots at a position inside that traffic,
    replayed from a graph and run eagerly, each profiled."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import int8_matmul as im
    from ray_tpu_torch.serve.llm import LLMEngine

    fa.launches = im.launches = 0
    t0 = time.perf_counter()
    engine = LLMEngine(params, cfg, max_slots=8, max_len=512,
                       prefill_buckets=(128,), block_steps=8)
    build_s = time.perf_counter() - t0
    try:
        out = serve_through_graphs(engine, prompts, new, cfg.vocab_size)
        out.update(graph_stats(engine, im.launches))
    finally:
        engine.shutdown()
    del engine
    out.update({"engine_build_s": build_s, "flash_launches": fa.launches})
    check(fa.launches == 0, "serve_7b attends densely: no flash launch")
    check(out["decode_attention_launches_per_decode_step"] == cfg.n_layers,
          f"decode attention launches per decode step "
          f"{out['decode_attention_launches_per_decode_step']}, not one per "
          f"layer ({cfg.n_layers})")
    torch.cuda.empty_cache()
    at = len(prompts[0]) + new // 2
    out["decode_block_graph_profile"] = graph_decode_profile(
        params, cfg, np.random.default_rng(SEED + 4), pos=at, max_len=512)
    out["decode_block_profile"] = decode_profile(
        params, cfg, np.random.default_rng(SEED + 4), pos=at, max_len=512)
    torch.cuda.empty_cache()
    return out


def logits_vs(ref, got) -> dict:
    """max|got - ref| / max|ref| and top-1 agreement of two logit tensors."""
    ref, got = ref.float(), got.float()
    return {"max_abs_diff_over_max_abs_ref":
            ((got - ref).abs().max() / ref.abs().max()).item(),
            "top1_agreement":
            (got.argmax(-1) == ref.argmax(-1)).float().mean().item()}


# int8 against bf16 logits (tests/test_quant.py:63): the int8 grid moves
# every weight by up to half a step of its channel's scale; gated at 2
# layers of the full width, reported at full depth.
INT8_LOGITS_RTOL = 0.12


@timed_phase
def phase_serve_7b() -> dict:
    """``serve_7b`` (6.7B parameters, full width and depth) served int8 on
    the card through ``LLMEngine`` at bench.py's shape, then the same
    traffic on bf16 weights of the same init, timing only; the fp32 engine
    equals ``generate`` on the int8 weights; int8 against bf16 logits."""
    from ray_tpu_torch.models.generation import prepare_for_inference
    from ray_tpu_torch.models.quant import (
        init_params_by_layer,
        init_params_int8,
        quantize_params_int8,
    )
    from ray_tpu_torch.models.transformer import (
        TransformerConfig,
        forward,
        init_params,
        tree_map,
    )

    cfg = TransformerConfig.serve_7b()
    rng = np.random.default_rng(SEED + 5)
    new = 64
    prompts = [rng.integers(0, cfg.vocab_size, 128) for _ in range(8)]
    probe = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 128))).cuda()
    out = {"phase": "serve_7b", "param_count": cfg.param_count(),
           "n_layers": cfg.n_layers, "prompt_len": 128}

    # int8 weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_int8(cfg, SEED)
    torch.cuda.synchronize()
    out["int8_init_s"] = time.perf_counter() - t0
    out["int8_weight_bytes"] = weight_bytes(params)
    out["int8_max_memory_allocated_after_init_bytes"] = (
        torch.cuda.max_memory_allocated())
    out["int8"] = serve_7b_traffic(params, cfg, prompts, new)
    check(out["int8"]["int8_launches_per_decode_step"] == 6 * cfg.n_layers,
          f"int8 weights: {out['int8']['int8_launches_per_decode_step']} "
          f"int8_matmul launches per decode step, not {6 * cfg.n_layers}")
    # what the kernel took off the path: the plain dequant of every weight
    out["int8"]["plain_dequant_ms_per_step"] = dequant_ms_per_step(params,
                                                                   cfg.dtype)
    out["int8"]["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    fp32_engine_equals_generate(params, cfg, rng)
    out["fp32_engine_equals_generate"] = True
    out["fp32_check_layers"] = cfg.n_layers
    out["fp32_check_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        ip, icfg = prepare_for_inference(params, cfg)
        int8_logits = forward(ip, probe, icfg).float()
    del params, ip
    torch.cuda.empty_cache()

    # bf16 weights of the same init (each layer the bf16 rounding of the
    # fp32 layer that init_params_int8 quantized): timing only
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_by_layer(
        cfg, SEED, lambda layer: tree_map(lambda w: w.to(torch.bfloat16),
                                          layer))
    torch.cuda.synchronize()
    out["bf16_init_s"] = time.perf_counter() - t0
    out["bf16_weight_bytes"] = weight_bytes(params)
    out["bf16"] = serve_7b_traffic(params, cfg, prompts, new)
    check(out["bf16"]["int8_launches_per_decode_step"] == 0,
          "bf16 weights launch no int8 kernel")
    out["bf16"]["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        ip, icfg = prepare_for_inference(params, cfg)
        out["full_depth_int8_vs_bf16_logits"] = logits_vs(
            forward(ip, probe, icfg), int8_logits)
    del params, ip, int8_logits
    torch.cuda.empty_cache()

    # the gate: 2 layers at full width, a bf16 init against its int8
    # quantization, on one 128-token prompt
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype=torch.bfloat16)
    with torch.inference_mode():
        p2 = init_params(cfg2, SEED)
        ref = forward(p2, probe, cfg2)
        got = forward(quantize_params_int8(p2), probe, cfg2)
        two = logits_vs(ref, got)
    del p2, ref, got
    torch.cuda.empty_cache()
    two["rtol"] = INT8_LOGITS_RTOL
    out["two_layer_int8_vs_bf16_logits"] = two
    check(two["max_abs_diff_over_max_abs_ref"] < INT8_LOGITS_RTOL,
          f"int8 logits stray from bf16 at 2 layers: {two}")
    emit(out)
    return out


# The runtime phase: the port's own runtime planes on the card.
# bench_400m's parameters go into the object store once, as the reference's
# numpy tree; a num_gpus=1 task trains on them and LLMServer serves them
# from a num_gpus=1 actor (the reference's own actor options for it,
# ray_tpu/serve/llm.py:371-372, with num_tpus -> num_gpus), each held
# against the same work run in this process.
RUNTIME_STORE_BYTES = 4 * 1024 ** 3  # the node's store, in /dev/shm
RUNTIME_NOOP_CALLS, RUNTIME_NOOP_WARMUP = 200, 20
RUNTIME_TRAIN_STEPS = 4  # warm-up, capture, two replays (the last profiled)
RUNTIME_SERVE = (8, 128, 64)  # concurrent requests, prompt length, new
RUNTIME_SERVE_ROUNDS = 5  # of that traffic on each side, in turns
RUNTIME_FP32_PROMPTS = (40, 100, 70)  # and 16 new tokens, as serve's check
# the bare actor's and the deployment's share of the one card: both serve
# through the rounds (the fp32 deployment, alone, asks a whole card)
RUNTIME_SERVE_GPUS = 0.5
RUNTIME_SHUTDOWN_S = 20.0  # for the session's processes to be gone


def runtime_train(cfg, params_np: dict, batches: list,
                  steps: int = RUNTIME_TRAIN_STEPS, on_last=None) -> dict:
    """``bench_400m``'s captured train loop on one device from a numpy
    parameter tree in the reference's format: the state built through
    ``params_from_numpy``, then ``steps`` steps (the eager warm-up, the
    capture, replays; the last replay profiled for its kernels by name).
    Run by this process, by a num_gpus=1 task of the runtime and by a
    TorchTrainer's worker on the same tree and batches; returns plain data.
    ``on_last(params)``, when given, sees the parameters after the last
    step."""
    import os

    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    t0 = time.perf_counter()
    params = params_from_numpy(params_np)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED, params=params)
    step = make_train_step(cfg, opt)
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, step_ms, counts, prof = [], [], [], None
    for i in range(steps):
        batch = {k: torch.from_numpy(np.array(v)).cuda()  # a writable copy
                 for k, v in batches[i % len(batches)].items()}
        out = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def run():
            start.record()
            out.append(step(state, batch))
            end.record()

        if i == steps - 1:
            prof = device_profile(run, kinds=TRAIN_KINDS)
        else:
            run()
        state, m = out[0]
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        metrics.append(m)
        counts.append((fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv))
    peak = torch.cuda.max_memory_allocated()
    if on_last is not None:
        on_last(state.params)
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    captures, replays = step.captures, step.replays
    # the profiled replay read again while it counts too few flash kernels
    # (profile_launches), now that nothing reads the state any more
    prof = profile_launches(lambda: step(state, batch), TRAIN_KINDS,
                            flash_want(cfg), first=prof)
    del state, step, opt, params, metrics, out
    torch.cuda.empty_cache()
    return {"pid": os.getpid(), "upload_s": upload_s, "losses": losses,
            "grad_norms": norms, "step_ms": step_ms,
            "replay_ms": step_ms[2:], "wrapper_counts": counts,
            "launches_per_replay": {k: prof["launches_by_kind"][k]
                                    for k in FLASH_KINDS},
            "profile_launch_readings": prof["launch_readings"],
            "profiled_replay_busy_share": prof["device_busy_share"],
            "captures": captures, "replays": replays,
            "peak_memory_bytes": peak}


def _session_pids(session_dir: str, mark: str = None) -> list:
    """Live (not zombie) processes whose command line names the session
    directory: the GCS, the raylets and their workers. With ``mark``, only
    those whose environment holds that ``NAME=value`` entry."""
    import os

    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            if session_dir not in cmd or state == "Z":
                continue
            if mark is not None:
                with open(f"/proc/{d}/environ", "rb") as f:
                    if mark.encode() not in f.read().split(b"\0"):
                        continue
        except OSError:
            continue
        out.append(int(d))
    return sorted(out)


def _compute_app_pids() -> list:
    """The processes holding a CUDA context, as nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())



class _ActorStreams:
    """An actor's ``generate_stream``, called as an actor generator, with an
    engine's interface: token ids, each the next object of the stream."""

    def __init__(self, rt, server):
        self.rt, self.server = rt, server

    def generate_stream(self, prompt, max_new_tokens: int):
        gen = self.server.generate_stream.options(
            num_returns="streaming").remote(prompt,
                                            max_new_tokens=max_new_tokens)
        while (ref := gen.next_with_timeout(300)) is not None:
            yield self.rt.get(ref, timeout=60)


def _weights_factory(ref, cfg, fp32: bool = False):
    """LLMServer's model factory: the parameters from the object store (the
    reference's numpy tree), uploaded to the card in the actor; with
    ``fp32``, the actor's TF32 is turned off first, as serve's check does."""

    def factory():
        import torch

        import ray_tpu_torch as rt_w
        from ray_tpu_torch.models.convert import params_from_numpy

        if fp32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return params_from_numpy(rt_w.get(ref, timeout=600)), cfg

    return factory


def params_digest(params) -> str:
    """sha256 over every parameter's shape, dtype and bytes, in tree
    order: equal digests are equal parameters, bit for bit."""
    import hashlib

    from ray_tpu_torch.models.transformer import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(params):
        t = t.detach().contiguous()
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _trainer_loop(config):
    """``TorchTrainer``'s loop in the runtime phase: ``runtime_train`` on
    the worker's card over the parameters and batches in the object store;
    rank 0 reports the run's figures once, at the end, with the parameters
    as the checkpoint (the reference's numpy tree) and their digest."""
    import os
    import time

    import ray_tpu_torch as rt_w
    import chip_smoke
    from ray_tpu_torch.models.convert import params_to_numpy
    from ray_tpu_torch.train import Checkpoint, session

    device = session.get_device()
    chip_smoke.check(device == torch.device("cuda", 0),
                     f"the trainer's worker runs on {device}")
    t0 = time.perf_counter()
    tree, batches = rt_w.get(config["refs"], timeout=600)
    get_s = time.perf_counter() - t0
    last = {}

    def on_last(params):
        last["digest"] = chip_smoke.params_digest(params)
        last["tree"] = params_to_numpy(params)

    run = chip_smoke.runtime_train(config["cfg"], tree, batches,
                                   config["steps"], on_last=on_last)
    del tree
    session.report({**run, "get_s": get_s, "device": str(device),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "rank": session.get_world_rank(),
                    "params_digest": last["digest"],
                    "report_at": time.time()},
                   checkpoint=Checkpoint.from_dict({"params": last["tree"]}))


def runtime_trainer(cfg, refs, here: dict) -> dict:
    """``bench_400m`` trained by a ``TorchTrainer`` of one GPU worker on the
    parameters and batches of ``refs``: its losses and grad norms equal
    ``here``'s (the same steps in this process) bit for bit, with the flash
    launches per replay by name; the persisted checkpoint, loaded back
    through ``params_from_numpy``, equals the worker's parameters bit for
    bit. Returns the run's figures, the report-to-persist time and the
    wall time from ``fit()`` to its ``Result``."""
    import os
    import shutil
    import tempfile

    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    storage = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        trainer = TorchTrainer(
            _trainer_loop,
            train_loop_config={"refs": refs, "cfg": cfg,
                               "steps": RUNTIME_TRAIN_STEPS},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="runtime", storage_path=storage))
        persisted = []
        register = trainer._ckpt_manager.register

        def timed_register(checkpoint, metrics):
            out = register(checkpoint, metrics)
            persisted.append(time.time())
            return out

        trainer._ckpt_manager.register = timed_register
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        run = result.metrics
        check(len(persisted) == 1 and result.checkpoint is not None,
              f"{len(persisted)} checkpoints persisted, not 1")
        t0 = time.perf_counter()
        saved = result.checkpoint.to_dict()["params"]
        restored = params_from_numpy(saved)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        digest = params_digest(restored)
        del saved, restored
        torch.cuda.empty_cache()
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(result.checkpoint.path)
                         for f in fs)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    check(tuple(run["launches_per_replay"].values()) == want,
          f"trainer: one replay launched flash fwd/dq/dkv "
          f"{run['launches_per_replay']}, not {want}")
    check(run["captures"] == 1 and run["replays"] == RUNTIME_TRAIN_STEPS - 1,
          f"trainer: {run['captures']} captures, {run['replays']} replays")
    check(run["losses"] == here["losses"]
          and run["grad_norms"] == here["grad_norms"],
          f"the trainer's losses {run['losses']} (grad norms "
          f"{run['grad_norms']}) differ from this process's "
          f"{here['losses']} ({here['grad_norms']})")
    check(digest == run["params_digest"],
          "the persisted checkpoint, restored, differs from the worker's "
          "parameters")
    check(run["pid"] != os.getpid() and run["device"] == "cuda:0",
          f"the trainer's worker: pid {run['pid']}, {run['device']}")
    return {**run, "fit_s": fit_s,
            "report_to_persist_s": persisted[0] - run["report_at"],
            "checkpoint_bytes_on_disk": ckpt_bytes,
            "restore_s": restore_s,
            "restored_equals_worker_params_bit_for_bit": True}


class _HandleStreams:
    """A deployment handle's ``stream`` with an engine's interface."""

    def __init__(self, handle):
        self.handle = handle

    def generate_stream(self, prompt, max_new_tokens: int):
        yield from self.handle.stream(prompt, max_new_tokens=max_new_tokens)


def _served_llm():
    """``LLMServer`` as the runtime phase deploys it: a request of None
    returns the engine's ``stats()`` (a handle calls ``__call__`` only)."""
    from ray_tpu_torch.serve.llm import LLMServer

    class ServedLLM(LLMServer):
        def __call__(self, prompt_ids, *args, **kwargs):
            if prompt_ids is None:
                return self.stats()
            return super().__call__(prompt_ids, *args, **kwargs)

    return ServedLLM


@timed_phase
def phase_runtime(cfg) -> dict:
    """The port's runtime on the card (see the module docstring, 14)."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
    from ray_tpu_torch.models.generation import generate, release_programs
    from ray_tpu_torch.models.transformer import init_params, tree_leaves
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    check(not rt.is_initialized(), "the runtime is already up")
    driver = os.getpid()
    shm = os.statvfs("/dev/shm")
    shm_total, shm_free = (shm.f_blocks * shm.f_frsize,
                           shm.f_bavail * shm.f_frsize)
    check(shm_free >= RUNTIME_STORE_BYTES + (1 << 30),
          f"/dev/shm has {shm_free} bytes free of {shm_total}: the object "
          f"store ({RUNTIME_STORE_BYTES} bytes) holding bench_400m's "
          "parameters needs that much and room besides")
    t0 = time.perf_counter()
    probed = worker_mod._detect_gpus()
    probe_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    info = rt.init(object_store_memory=RUNTIME_STORE_BYTES)
    init_s = time.perf_counter() - t0
    session = info["session_dir"]
    try:
        resources = rt.cluster_resources()
        check(probed == torch.cuda.device_count()
              and resources.get("GPU") == torch.cuda.device_count(),
              f"init granted {resources} (probe {probed}); the card count "
              f"is {torch.cuda.device_count()}")

        @rt.remote
        def noop():
            return None

        rtt = []
        for i in range(RUNTIME_NOOP_WARMUP + RUNTIME_NOOP_CALLS):
            t0 = time.perf_counter()
            rt.get(noop.remote(), timeout=60)
            if i >= RUNTIME_NOOP_WARMUP:
                rtt.append((time.perf_counter() - t0) * 1e3)

        @rt.remote(num_gpus=1)
        def first_gpu_call():
            import os

            import torch

            torch.ones(1, device="cuda").sum().item()  # a CUDA context
            return os.getpid(), torch.cuda.get_device_name(0)

        # what an idle GPU worker holds on the card (its CUDA context and
        # one block of torch's caching allocator): the card's free bytes
        # before and after, this process idle in between. nvidia-smi's
        # per-process memory cannot say it here: where the pid namespace
        # is not shared, it names every process pid 1.
        torch.cuda.synchronize()
        free_before = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        gpu_pid, gpu_name = rt.get(first_gpu_call.remote(), timeout=300)
        first_gpu_s = time.perf_counter() - t0
        worker_mib = (free_before - torch.cuda.mem_get_info()[0]) / 2 ** 20
        check(gpu_name == torch.cuda.get_device_name(0), gpu_name)

        # the parameters, put once as the reference's numpy tree
        tree = params_to_numpy(init_params(cfg, SEED))
        n_bytes = sum(a.nbytes for a in tree_leaves(tree))
        batches = numpy_train_batches(cfg.vocab_size, MAIN_SHAPE[0],
                                      MAIN_SHAPE[1], 2, SEED + 2)
        t0 = time.perf_counter()
        params_ref = rt.put(tree)
        put_s = time.perf_counter() - t0
        batches_ref = rt.put(batches)

        @rt.remote(num_gpus=1)
        def train_in_task(refs, cfg, steps):
            import time

            import chip_smoke

            t0 = time.perf_counter()
            tree, batches = rt.get(refs, timeout=600)
            get_s = time.perf_counter() - t0
            return {**chip_smoke.runtime_train(cfg, tree, batches, steps),
                    "get_s": get_s}

        t0 = time.perf_counter()
        task = rt.get(train_in_task.remote([params_ref, batches_ref], cfg,
                                           RUNTIME_TRAIN_STEPS), timeout=900)
        task_s = time.perf_counter() - t0
        here = runtime_train(cfg, tree, batches)
        want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
        for run, name in ((task, "task"), (here, "in-process")):
            check(all(np.isfinite(run["losses"])), f"{name}: {run['losses']}")
            check(tuple(run["launches_per_replay"].values()) == want,
                  f"{name}: one replay launched flash fwd/dq/dkv "
                  f"{run['launches_per_replay']}, not {want}")
            check(run["wrapper_counts"][0] == want
                  and run["wrapper_counts"][-1] == tuple(2 * w for w in want)
                  and run["captures"] == 1
                  and run["replays"] == RUNTIME_TRAIN_STEPS - 1,
                  f"{name}: flash wrapper counts {run['wrapper_counts']}, "
                  f"{run['captures']} captures, {run['replays']} replays")
        check(task["losses"] == here["losses"]
              and task["grad_norms"] == here["grad_norms"],
              f"the GPU task's losses {task['losses']} (grad norms "
              f"{task['grad_norms']}) differ from this process's "
              f"{here['losses']} ({here['grad_norms']})")
        check(task["pid"] != driver, "the task ran in the driver")

        # the same steps through TorchTrainer, the checkpoint persisted
        trainer = runtime_trainer(cfg, [params_ref, batches_ref], here)

        # serving: LLMServer as an actor, the reference's options, and as a
        # Serve deployment streamed through a handle
        new_fp32 = 16
        rng = np.random.default_rng(SEED + 3)
        n_req, prompt_len, new = RUNTIME_SERVE
        prompts = [rng.integers(0, cfg.vocab_size, prompt_len)
                   for _ in range(n_req)]
        server_cls = rt.remote(num_gpus=RUNTIME_SERVE_GPUS,
                               max_concurrency=16)(LLMServer)
        t0 = time.perf_counter()
        server = server_cls.remote(_weights_factory(params_ref, cfg),
                                   max_slots=8, max_len=1024,
                                   prefill_buckets=(128, 512))
        rt.get(server.stats.remote(), timeout=600)  # constructed: graphs in
        actor_up_s = time.perf_counter() - t0
        streams = _ActorStreams(rt, server)
        list(streams.generate_stream(prompts[0][:64], 4))  # warm-up
        deployment = serve.deployment(
            name="LLMServer",
            ray_actor_options={"num_gpus": RUNTIME_SERVE_GPUS,
                               "max_concurrency": 16},
        )(_served_llm())
        t0 = time.perf_counter()
        handle = serve.run(deployment.bind(
            _weights_factory(params_ref, cfg), max_slots=8, max_len=1024,
            prefill_buckets=(128, 512)))
        handle.remote(None).result(timeout=600)  # constructed: graphs in
        deployment_up_s = time.perf_counter() - t0
        routed = _HandleStreams(handle)
        list(routed.generate_stream(prompts[0][:64], 4))  # warm-up
        params = params_from_numpy(tree)
        engine = LLMEngine(params, cfg, max_slots=8, max_len=1024,
                           prefill_buckets=(128, 512))
        try:
            engine.generate(prompts[0][:64], max_new_tokens=4)  # warm-up
            before = rt.get(server.stats.remote(), timeout=60)
            dep_before = handle.remote(None).result(timeout=60)
            actor_apps = _compute_app_pids()
            # nvidia-smi names this machine's pids only where it shares the
            # pid namespace: then the actor's process is among those it lists
            same_ns = bool(set(actor_apps) & set(_session_pids(session)))
            # the same traffic on each side, in turns (the order rotates
            # every round), the three engines up throughout
            sides = (("actor", streams), ("in_process", engine),
                     ("deployment", routed))
            rounds = {name: [] for name, _ in sides}
            for r in range(RUNTIME_SERVE_ROUNDS):
                k = r % len(sides)
                for name, eng in sides[k:] + sides[:k]:
                    res, st = _serve_concurrently(eng, prompts, new)
                    rounds[name].append(
                        (res, serve_metrics(res, st, new, cfg.vocab_size)))
            after = rt.get(server.stats.remote(), timeout=60)
            dep_after = handle.remote(None).result(timeout=60)
        finally:
            engine.shutdown()
        del engine
        rt.kill(server)
        check(serve.delete("LLMServer"), "the deployment was not deleted")
        served = {name: serve_rounds([m for _, m in rounds[name]])
                  for name, _ in sides}
        bf16_equal = {name: [a == i for (a, _), (i, _)
                             in zip(rounds[name], rounds["in_process"])]
                      for name in ("actor", "deployment")}

        def decode_counts(name, first, last):
            steps = last["steps"] - first["steps"]
            replayed = (last["decode_steps_replayed"]
                        - first["decode_steps_replayed"])
            da_launches = (last["decode_attention_launches_replayed"]
                           - first["decode_attention_launches_replayed"])
            check(steps > 0 and replayed == steps,
                  f"the {name}'s engine ran {steps} decode steps, {replayed} "
                  "of them graph replays")
            check(da_launches == cfg.n_layers * steps,
                  f"the {name}: {da_launches} decode attention launches over "
                  f"{steps} decode steps: not one per layer ({cfg.n_layers})")
            return steps, da_launches // steps

        steps, da_per_step = decode_counts("actor", before, after)
        dep_steps, dep_da_per_step = decode_counts("deployment", dep_before,
                                                   dep_after)
        torch.cuda.empty_cache()

        # float32, TF32 off: the actor's greedy tokens EQUAL generate's here
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        fp32_prompts = [rng.integers(0, cfg.vocab_size, n)
                        for n in RUNTIME_FP32_PROMPTS]
        ref_tokens = [generate(params, p[None], cfg32,
                               max_new_tokens=new_fp32,
                               max_len=256)[0].tolist()
                      for p in fp32_prompts]
        release_programs()
        del params
        torch.cuda.empty_cache()
        server32 = server_cls.remote(_weights_factory(params_ref, cfg32,
                                                      fp32=True),
                                     max_slots=2, max_len=256,
                                     prefill_buckets=(64, 128))
        got, _ = _serve_concurrently(_ActorStreams(rt, server32),
                                     fp32_prompts, new_fp32)
        rt.kill(server32)
        check(got == ref_tokens, f"the fp32 actor's tokens {got} differ "
              f"from generate's {ref_tokens}")
        handle32 = serve.run(deployment.options(
            name="LLMServer32",
            ray_actor_options={"num_gpus": 1, "max_concurrency": 16},
        ).bind(
            _weights_factory(params_ref, cfg32, fp32=True), max_slots=2,
            max_len=256, prefill_buckets=(64, 128)))
        got, _ = _serve_concurrently(_HandleStreams(handle32), fp32_prompts,
                                     new_fp32)
        check(serve.delete("LLMServer32"), "the fp32 deployment stayed")
        check(got == ref_tokens, f"the fp32 deployment's tokens {got} "
              f"differ from generate's {ref_tokens}")
        live = _session_pids(session)
        check(live, f"no process of the session {session} found")
    finally:
        rt.shutdown()
    deadline = time.monotonic() + RUNTIME_SHUTDOWN_S
    while _session_pids(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = _session_pids(session)

    def only_the_driver(apps):
        return len(apps) <= 1 and (not same_ns or set(apps) <= {driver})

    apps = _compute_app_pids()
    while not only_the_driver(apps) and time.monotonic() < deadline:
        time.sleep(0.2)
        apps = _compute_app_pids()
    check(not left, f"processes of the session left after shutdown: {left}")
    check(only_the_driver(apps),
          f"after shutdown nvidia-smi lists {apps} (the driver is {driver})")
    out = {"phase": "runtime",
           "gpu_probe_ms": probe_ms, "init_s": init_s,
           "cluster_resources": resources,
           "dev_shm": {"bytes": shm_total, "free_bytes": shm_free},
           "object_store_bytes": RUNTIME_STORE_BYTES,
           "noop_task_rtt_ms_median": float(np.median(rtt)),
           "noop_task_rtt_ms_p90": float(np.percentile(rtt, 90)),
           "noop_calls": RUNTIME_NOOP_CALLS,
           "first_gpu_call_s": first_gpu_s,
           "idle_gpu_worker_card_mib": worker_mib,
           "params_bytes": n_bytes, "put_s": put_s,
           "put_gb_per_s": n_bytes / put_s / 1e9,
           "task": {**task, "wall_s": task_s,
                    "upload_gb_per_s": n_bytes / task["upload_s"] / 1e9},
           "in_process": here,
           "task_losses_equal_in_process_bit_for_bit": True,
           "trainer": {**trainer, "upload_gb_per_s":
                       n_bytes / trainer["upload_s"] / 1e9},
           "trainer_losses_equal_in_process_bit_for_bit": True,
           "replay_ms": {"in_process": here["replay_ms"],
                         "task": task["replay_ms"],
                         "trainer": trainer["replay_ms"]},
           "serve": {**served,
                     "actor_up_s": actor_up_s,
                     "deployment_up_s": deployment_up_s,
                     "actor_decode_steps": steps,
                     "deployment_decode_steps": dep_steps,
                     "decode_attention_launches_per_decode_step": da_per_step,
                     "deployment_decode_attention_launches_per_decode_step":
                         dep_da_per_step,
                     "bf16_tokens_equal_in_process": bf16_equal},
           "fp32_actor_tokens_equal_generate": True,
           "fp32_deployment_tokens_equal_generate": True,
           "shutdown": {"session_processes_before": len(live),
                        "left": left, "compute_apps_while_serving":
                            actor_apps, "compute_apps_after": apps,
                        "driver_pid": driver, "first_gpu_worker": gpu_pid,
                        "pid_namespace_shared": same_ns}}
    emit(out)
    return out


# The mesh_group phase: bench_400m trained in a MeshGroup (ray_tpu_torch/
# mesh/), one _MeshWorker process per card, joined by torch.distributed and
# stepped in lockstep through compile_step_with_plan; SIGKILLed after a
# checkpoint and recovered. The gang's step is the port's TrainStep (warm-up,
# capture, replays) on the worker-resident state; every gang incarnation
# profiles its GANG_PROFILE_CALL-th call, a replay.
GANG_STEPS, GANG_SAVE_AFTER = 8, 4
GANG_PROFILE_CALL = 4  # calls: 1 warm-up, 2 capture, 3 and 4 replays
GANG_STORE_BYTES = 1 << 30  # each node's object store, in /dev/shm
GANG_STEP_TIMEOUT_S = 600.0  # one lockstep call (the first builds kernels)
GANG_SHUTDOWN_S = 20.0  # for the session's processes to be gone
# multicard: the recovered gang's losses against an uninterrupted
# continuation from the same checkpoint on the same mesh. Expected bit for
# bit (the same kernels and collectives on the same inputs; eager steps
# equal captured ones, the train phase checks); the bound leaves room for
# NCCL to sum one reduction in another order, which moves a loss by a few
# ulps of fp32 (~1e-7 relative), far below a wrong restore's effect.
GANG_CONTINUATION_RTOL = 1e-5
# kinds of kernel in a gang's profiled replay: NCCL's collectives first
GANG_KINDS = {"nccl": "nccl", **TRAIN_KINDS}
# one worker-process record per step call (in a gang worker, where this
# module is imported by GangTrainStep)
GANG_STATS = {"calls": []}


class GangStateInit:
    """A MeshGroup's ``state_init``: ``make_sharded_state`` of seed ``SEED``
    on the rank's mesh, kept as ``ctx.state["state"]``. Pickled by value
    from this script; the worker imports this module for the work."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, ctx):
        import chip_smoke

        return chip_smoke.gang_state_init(self.cfg, ctx)


def gang_state_init(cfg, ctx) -> dict:
    import os

    from ray_tpu_torch.parallel import default_optimizer, make_sharded_state

    state, _ = make_sharded_state(cfg, default_optimizer(), SEED,
                                  mesh=ctx.mesh)
    ctx.state["state"] = state
    return {"rank": ctx.rank, "pid": os.getpid(), "device": str(ctx.device)}


class GangTrainStep:
    """The step a MeshGroup compiles: the port's ``make_train_step`` on the
    mesh of the state's parameters, made at the first call on each rank;
    its ``TrainStep`` then serves the resident state (warm-up, capture,
    replays). Each call is recorded in ``GANG_STATS``."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.step = self.step_mesh = None

    def __call__(self, state, batch):
        import chip_smoke

        return chip_smoke.gang_train_call(self, state, batch)


def gang_train_call(gs, state, batch):
    """One call of a gang's train step on this rank: on the card, timed by
    CUDA events, the ``GANG_PROFILE_CALL``-th profiled for the flash
    kernels by name; the flash wrappers' counters (zeroed when the step is
    made) after each call."""
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import default_optimizer, make_train_step

    if gs.step is None:
        mesh = gs.step_mesh = tree_leaves(state.params)[0].device_mesh
        gs.step = make_train_step(gs.cfg, default_optimizer(), mesh=mesh)
        fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
        GANG_STATS["calls"] = []
    # wall-clock entry time (one host's clock for every rank): the spread
    # across ranks of one call is how late the lockstep call reached each
    rec = {"call": len(GANG_STATS["calls"]) + 1, "t_enter": time.time()}
    out = []

    def run():
        out.append(gs.step(state, batch))

    if state.step.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if rec["call"] == GANG_PROFILE_CALL:
            # a reading taken again (profile_launches) replays the step
            # again from the state as it was before the call
            held = [_local(t).clone() for t in state_tensors(state)]

            def reset():
                for t, h in zip(state_tensors(state), held):
                    _local(t).copy_(h)

            prof = profile_launches(run, GANG_KINDS, flash_want(gs.cfg),
                                    mesh=gs.step_mesh, reset=reset)
            del held
            rec["retakes"] = len(prof["launch_readings"]) - 1
            rec["launch_readings"] = prof["launch_readings"]
            rec["launches_per_replay"] = {
                k: prof["launches_by_kind"][k] for k in FLASH_KINDS}
            rec["busy_share"] = prof["device_busy_share"]
            rec["device_ms_by_kind"] = prof["device_ms_by_kind"]
        else:
            run()
        end.record()
        torch.cuda.synchronize()
        rec["ms"] = start.elapsed_time(end)
    else:
        run()
    rec["wrapper_counts"] = [fa.launches, fa.launches_bwd_dq,
                             fa.launches_bwd_dkv]
    rec["captures"], rec["replays"] = gs.step.captures, gs.step.replays
    GANG_STATS["calls"].append(rec)
    return out[-1]


def gang_stats(ctx) -> dict:
    """A gang rank's ``GANG_STATS`` (run by ``MeshGroup.run``)."""
    import chip_smoke

    return {"rank": ctx.rank, "calls": chip_smoke.GANG_STATS["calls"]}


def gang_plan(cfg, axes) -> dict:
    """The train step's plan for a mesh of ``axes``, made on the
    controller: the state as ``make_sharded_state`` lays it out under
    ``DEFAULT_RULES`` (step replicated, AdamW's moments as their params),
    the batch as ``batch_sharding``, the metrics replicated."""
    from torch.distributed.tensor import Replicate

    from ray_tpu_torch.models.transformer import param_logical_axes
    from ray_tpu_torch.parallel import DEFAULT_RULES
    from ray_tpu_torch.parallel.mesh import logical_to_placements, shardings_for
    from ray_tpu_torch.parallel.train_step import TrainState

    params = shardings_for(tuple(axes), DEFAULT_RULES, param_logical_axes(cfg))
    rep = (Replicate(),) * len(axes)
    state = TrainState(step=rep, params=params, opt_state=params)
    batch = logical_to_placements(tuple(axes), DEFAULT_RULES,
                                  ("batch", "seq"))
    return {"in_shardings": (state, batch), "out_shardings": (state, rep)}


def _gang_small_step(x, w):
    return torch.relu(x @ w) + 1.0


def gang_plan_paths(mg) -> dict:
    """A small product compiled on the gang through both plan paths
    (DTensor placements; ``local_map``), on the same seeded host values:
    the two outputs, fetched whole, must be equal."""
    from torch.distributed.tensor import Replicate, Shard

    n = len(mg.axis_names)
    rows = (Shard(0),) + (Replicate(),) * (n - 1)
    rep = (Replicate(),) * n
    rng = np.random.default_rng(SEED + 5)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    a = mg.compile_step_with_plan(_gang_small_step, in_shardings=(rows, rep),
                                  out_shardings=rows, step_id="small_dtensor")
    b = mg.compile_step_with_plan(_gang_small_step, in_specs=(rows, rep),
                                  out_specs=rows, step_id="small_local_map")
    ya = mg.run_step(a, x, w, timeout=GANG_STEP_TIMEOUT_S)[0]
    yb = mg.run_step(b, x, w, timeout=GANG_STEP_TIMEOUT_S)[0]
    check(np.array_equal(ya, yb), "the local_map path's small step differs "
          f"from its DTensor path's (max |diff| {np.abs(ya - yb).max()})")
    return {"shape": list(ya.shape), "equal": True}


def _gang_metric(m) -> tuple:
    return (float(m["loss"]), float(m["grad_norm"]), int(m["step"]))


def gang_run(cfg, batches, *, hosts: int, per_host: int, shape: dict,
             resources: dict, kill_rank: int, ckpt: str,
             recover_shape=None, continuation: bool = False) -> dict:
    """``bench_400m`` in a MeshGroup of ``hosts`` x ``per_host`` ranks over
    ``shape``: bring-up, the small step's two plan paths, the state and the
    train step, ``GANG_SAVE_AFTER`` steps, ``save_state``, SIGKILL of rank
    ``kill_rank``'s process, the step that must raise ``RankFailedError``,
    ``recover(mesh_shape=recover_shape)`` and the remaining steps; with
    ``continuation`` the checkpoint is restored again into the recovered
    gang and the same steps retaken (an uninterrupted continuation on the
    recovered shape). Returns plain data; the caller checks it."""
    import os
    import signal

    from ray_tpu_torch.mesh import MeshGroup, RankFailedError, StateKey

    t0 = time.perf_counter()
    mg = MeshGroup(hosts=hosts, mesh_shape=shape, devices_per_host=per_host,
                   resources_per_host=resources, checkpoint_path=ckpt,
                   state_init=GangStateInit(cfg), name="chip_smoke_gang")
    out = {"bring_up_s": time.perf_counter() - t0}
    try:
        out["members"] = [dict(m) for m in mg.members]
        out["plan_paths"] = gang_plan_paths(mg)
        t0 = time.perf_counter()
        out["state_init"] = mg.run(GangStateInit(cfg),
                                   timeout=GANG_STEP_TIMEOUT_S)
        out["state_init_s"] = time.perf_counter() - t0
        sid = mg.compile_step_with_plan(GangTrainStep(cfg),
                                        **gang_plan(cfg, mg.axis_names),
                                        donate_argnums=(0,), step_id="train")

        def steps(lo, hi):
            got = []
            for i in range(lo, hi):
                (m,) = mg.run_step(sid, StateKey("state"), batches[i],
                                   store={0: "state"},
                                   timeout=GANG_STEP_TIMEOUT_S)
                got.append(_gang_metric(m))
            return got

        metrics = steps(0, GANG_SAVE_AFTER)
        out["stats_before"] = mg.run(gang_stats, timeout=60)
        t0 = time.perf_counter()
        mg.save_state(step=GANG_SAVE_AFTER, timeout=GANG_STEP_TIMEOUT_S)
        out["save_state_s"] = time.perf_counter() - t0
        victim = mg.members[kill_rank]["pid"]
        os.kill(victim, signal.SIGKILL)
        t0 = time.perf_counter()
        try:
            mg.run_step(sid, StateKey("state"), batches[GANG_SAVE_AFTER],
                        store={0: "state"}, timeout=GANG_STEP_TIMEOUT_S)
            failure = None
        except RankFailedError as e:
            failure = {"rank": e.rank, "host": e.host, "epoch": e.epoch,
                       "cause": type(e.cause).__name__}
        out["failure"] = failure
        out["failure_s"] = time.perf_counter() - t0
        out["state_after_failure"] = mg.state
        out["killed_pid"] = victim
        t0 = time.perf_counter()
        out["restored_step"] = mg.recover(mesh_shape=recover_shape)
        out["recover_s"] = time.perf_counter() - t0
        out["epoch"] = mg.epoch
        out["mesh_after"] = dict(zip(mg.axis_names, mg.sizes))
        out["members_after"] = [dict(m) for m in mg.members]
        metrics += steps(GANG_SAVE_AFTER, GANG_STEPS)
        out["stats_after"] = mg.run(gang_stats, timeout=60)
        out["metrics"] = metrics
        if continuation:
            check(mg.restore_state(timeout=GANG_STEP_TIMEOUT_S)
                  == GANG_SAVE_AFTER, "the continuation's restore")
            out["continuation"] = steps(GANG_SAVE_AFTER, GANG_STEPS)
            out["stats_continuation"] = mg.run(gang_stats, timeout=60)
    finally:
        mg.shutdown()
    return out


def _gang_skew_ms(stats: list) -> list:
    """Per call, the spread of the ranks' entry times into the step (ms):
    a rank that enters early waits for the others in the step's first
    collective, inside its timed replay."""
    calls = zip(*[r["calls"] for r in stats])
    return [(max(c["t_enter"] for c in cs) - min(c["t_enter"] for c in cs))
            * 1e3 for cs in calls]


def _gang_launches(stats: list, want: tuple) -> dict:
    """A gang incarnation's flash launches, checked on every rank: the
    wrappers count ``want`` at the warm-up and again at the capture and
    nothing across replays; the profiled replay launches ``want`` by
    kernel name (its last reading, ``profile_launches``)."""
    for r in stats:
        calls = r["calls"]
        counts = [tuple(c["wrapper_counts"]) for c in calls]
        check(counts[0] == want and all(
            c == tuple(2 * w for w in want) for c in counts[1:]),
              f"rank {r['rank']}: flash wrapper counts by call {counts} "
              f"(want {want} at the warm-up, as much again at the capture)")
        prof = [c for c in calls if "launches_per_replay" in c]
        check(len(prof) == 1 and tuple(
            prof[0]["launches_per_replay"].values()) == want,
              f"rank {r['rank']}: a profiled replay launched "
              f"{[p.get('launches_per_replay') for p in prof]}, not {want}")
        retakes = sum(c.get("retakes", 0) for c in calls)
        check(calls[-1]["captures"] == 1
              and calls[-1]["replays"] == len(calls) - 1 + retakes,
              f"rank {r['rank']}: {calls[-1]['captures']} captures, "
              f"{calls[-1]['replays']} replays in {len(calls)} calls "
              f"({retakes} profiled again)")
    rank0 = stats[0]["calls"]
    return {"launches_per_replay": rank0[GANG_PROFILE_CALL - 1][
                "launches_per_replay"],
            "wrapper_counts_by_call": [c["wrapper_counts"] for c in rank0],
            "replay_ms": [c["ms"] for c in rank0[2:]
                          if "launches_per_replay" not in c],
            "profile_launch_readings": rank0[GANG_PROFILE_CALL - 1][
                "launch_readings"],
            "profiled_busy_share": rank0[GANG_PROFILE_CALL - 1][
                "busy_share"],
            "profiled_device_ms_by_kind": rank0[GANG_PROFILE_CALL - 1][
                "device_ms_by_kind"]}


def gang_in_process(cfg, batches) -> dict:
    """The same steps in this process on one device (``make_sharded_state``
    of seed ``SEED``, the captured step): metrics and replay ms."""
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED)
    step = make_train_step(cfg, opt)
    metrics, ms = [], []
    for b in batches:
        batch = {k: torch.from_numpy(np.array(v)).cuda() for k, v in b.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        metrics.append(_metric(m))
        ms.append(start.elapsed_time(end))
    del state, step, opt
    torch.cuda.empty_cache()
    return {"metrics": metrics, "replay_ms": ms[2:]}


def _session_gone(session: str, mark: str = None) -> list:
    deadline = time.monotonic() + GANG_SHUTDOWN_S
    left = _session_pids(session, mark)
    while left and time.monotonic() < deadline:
        time.sleep(0.2)
        left = _session_pids(session, mark)
    return left


@timed_phase
def phase_mesh_group(cfg, here: dict = None, b: int = MAIN_SHAPE[0],
                     s: int = MAIN_SHAPE[1]) -> dict:
    """The mesh_group phase (see the module docstring, 15). ``here``: the
    in-process train phase's first ``GANG_STEPS`` metrics and its replay
    ms, when it ran; else the same steps are taken in this process."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    check(not rt.is_initialized(), "the runtime is already up")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    batches = [cycle[i % TRAIN_CYCLE] for i in range(GANG_STEPS)]
    if here is None:
        here = gang_in_process(cfg, batches)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    t0 = time.perf_counter()
    info = rt.init(object_store_memory=GANG_STORE_BYTES)
    init_s = time.perf_counter() - t0
    try:
        check(rt.cluster_resources().get("GPU") == 1,
              f"init granted {rt.cluster_resources()}")
        run = gang_run(cfg, batches, hosts=1, per_host=1, shape={"dp": 1},
                       resources={"CPU": 1, "GPU": 1}, kill_rank=0,
                       ckpt=ckpt)
    finally:
        rt.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
    left = _session_gone(info["session_dir"])
    check(not left, f"session processes left after shutdown: {left}")
    member = run["members"][0]
    check(member["device"] == "cuda:0" and member["visible"] == "0"
          and member["device_uuid"] == str(
              torch.cuda.get_device_properties(0).uuid),
          f"the gang's rank ran on {member}")
    check(run["failure"] == {"rank": 0, "host": 0, "epoch": 1,
                             "cause": "ActorDiedError"}
          and run["state_after_failure"] == "BROKEN",
          f"after the SIGKILL: {run['failure']}, {run['state_after_failure']}")
    check(run["restored_step"] == GANG_SAVE_AFTER and run["epoch"] == 2,
          f"recover() restored step {run['restored_step']}, epoch "
          f"{run['epoch']}")
    check(run["members_after"][0]["pid"] != member["pid"],
          "recover() kept the killed process")
    got, ref = run["metrics"], [tuple(m) for m in here["metrics"]]
    check(got == ref, f"the gang's metrics {got} differ from this "
          f"process's {ref}")
    before = _gang_launches(run["stats_before"], want)
    after = _gang_launches(run["stats_after"], want)
    out = {"phase": "mesh_group", "batch": [b, s], "n_layers": cfg.n_layers,
           "steps": GANG_STEPS, "saved_after": GANG_SAVE_AFTER,
           "init_s": init_s, "bring_up_s": run["bring_up_s"],
           "state_init_s": run["state_init_s"],
           "member": {k: member[k] for k in ("device", "visible", "pid",
                                               "device_uuid")},
           "plan_paths": run["plan_paths"],
           "losses": [m[0] for m in got], "grad_norms": [m[1] for m in got],
           "metrics_equal_in_process_bit_for_bit": True,
           "launches_per_step": before["launches_per_replay"],
           "launches_per_step_after_recover": after["launches_per_replay"],
           "launch_readings": [before["profile_launch_readings"],
                               after["profile_launch_readings"]],
           "wrapper_counts_by_call": before["wrapper_counts_by_call"],
           "wrapper_counts_by_call_after_recover":
               after["wrapper_counts_by_call"],
           "replay_ms": before["replay_ms"],
           "replay_ms_after_recover": after["replay_ms"],
           "in_process_replay_ms": here["replay_ms"],
           "profiled_busy_share": before["profiled_busy_share"],
           "device_ms_by_kind": before["profiled_device_ms_by_kind"],
           "save_state_s": run["save_state_s"],
           "failure": run["failure"], "failure_s": run["failure_s"],
           "recover_s": run["recover_s"],
           "restored_step": run["restored_step"], "epoch": run["epoch"]}
    emit(out)
    return out


# The data phase: bench_400m fed from a Dataset (ray_tpu_torch/data/) in two
# consumers, a TorchTrainer and a one-card MeshGroup; the tune phase: two
# trials of a Tuner sharing the card. Both take the train phase's batches
# (the cycle of TRAIN_CYCLE) and its initial state (seed SEED).
DATA_FILES = 8  # one per step: file i holds step i's token ids
DATA_STEPS = 8
DATA_PREFETCH_BATCHES, DATA_PREFETCH_BLOCKS = 2, 2
DATA_PROFILE_CALL = 4  # the trainer's profiled call: a replay
DATA_STORE_BYTES = 1 << 30  # the node's object store, in /dev/shm
TUNE_LRS = (3e-4, 1e-3)  # 3e-4: default_optimizer's own, the train phase's
TUNE_STEPS = 4
TUNE_GPUS = 0.5  # each trial's share of the one card
TUNE_PROFILE_STEP = 2  # each trial profiles an extra replay after it


def to_lm_batch(a):
    """A ``read_numpy`` block of token ids [rows, s + 1] as the train
    phase's batch: tokens, the targets shifted by one, a mask of ones."""
    return {"tokens": np.ascontiguousarray(a[:, :-1]),
            "targets": np.ascontiguousarray(a[:, 1:]),
            "mask": np.ones((a.shape[0], a.shape[1] - 1), np.float32)}


def write_token_files(cycle: list, n: int, directory: str) -> int:
    """File i: the token ids behind step i, ``cycle[i % len(cycle)]``'s
    tokens and the last target column, [b, s + 1]; returns the bytes."""
    import os

    total = 0
    for i in range(n):
        c = cycle[i % len(cycle)]
        ids = np.concatenate([c["tokens"], c["targets"][:, -1:]], axis=1)
        path = os.path.join(directory, f"tokens_{i:03d}.npy")
        np.save(path, ids)
        total += os.path.getsize(path)
    return total


def token_dataset(directory: str, n: int):
    import ray_tpu_torch.data as rd

    return rd.read_numpy(directory, parallelism=n).map_batches(
        to_lm_batch, batch_format="numpy")


def state_digest(state) -> str:
    """sha256 over every tensor of a TrainState (``state_tensors``: step,
    params, AdamW's step count and moments), shape, dtype and bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in state_tensors(state):
        t = _local(t).detach().contiguous()
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def state_putback(state):
    """A function that puts a TrainState's tensors back as they are now (a
    clone of each is held until it is dropped): a profiled replay taken
    again, or one taken beside the run, leaves the run's path as it was."""
    held = [t.clone() for t in state_tensors(state)]

    def reset():
        for t, h in zip(state_tensors(state), held):
            t.copy_(h)

    return reset


def _batch_bytes(batch) -> int:
    return sum(_local(v).numel() * _local(v).element_size()
               for v in batch.values())


def data_train(cfg, it, steps: int, ckpt: str = None, gang_step=None,
               state=None, sharding=None) -> dict:
    """``steps`` captured steps of ``bench_400m`` on batches that ``it`` (a
    ``DataIterator``) lands on this process's card: the trainer's worker
    makes its state and step here; a gang's rank passes its resident state
    and its ``GangTrainStep`` (which profiles its own replay). Every
    batch is checked on the card; the first column of its tokens and its
    targets' last column are kept (the row check). With ``ckpt`` the state
    after the last step is saved there (``save_sharded``) and its digest
    returned. Returns plain data."""
    import os

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    own = gang_step is None
    if own:
        opt = default_optimizer()
        state, _ = make_sharded_state(cfg, opt, SEED)
        step = make_train_step(cfg, opt)
        fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    else:
        step = gang_step
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, ms, rows, nbytes, prof = [], [], [], 0, None
    t0 = time.perf_counter()
    pump = it.iter_device_batches(
        batch_size=MAIN_SHAPE[0], prefetch_batches=DATA_PREFETCH_BATCHES,
        prefetch_blocks=DATA_PREFETCH_BLOCKS, sharding=sharding)
    for i, batch in enumerate(pump):
        for k, v in batch.items():
            check(_local(v).device == dev,
                  f"batch {i}'s {k} is on {_local(v).device}, not {dev}")
        rows.append((_local(batch["tokens"])[:, 0].clone(),
                     _local(batch["targets"])[:, -1].clone()))
        nbytes += _batch_bytes(batch)
        out = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def run():
            start.record()
            out.append(step(state, batch))
            end.record()

        if own and i + 1 == DATA_PROFILE_CALL:
            prof = profile_launches(run, TRAIN_KINDS, flash_want(cfg),
                                    reset=state_putback(state))
        else:
            run()
        state, m = out[-1]
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        metrics.append(_metric({k: _full(v) for k, v in m.items()}))
    last_batch_s = time.perf_counter() - t0
    check(len(metrics) == steps, f"{len(metrics)} batches, not {steps}")
    out = {"pid": os.getpid(), "device": str(dev),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "metrics": metrics, "step_ms": ms, "replay_ms": ms[2:],
           "rows": [[a.tolist(), b.tolist()] for a, b in rows],
           "first_block_to_last_batch_s": last_batch_s,
           "rows_per_s": steps * MAIN_SHAPE[0] / last_batch_s,
           "bytes": nbytes, "bytes_per_s": nbytes / last_batch_s,
           "pump": dict(pump.stats), "ingest": it.stats()["prefetch"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if own:
        check(prof is not None, "the trainer profiled no replay")
        out["launches_per_replay"] = {k: prof["launches_by_kind"][k]
                                      for k in FLASH_KINDS}
        out["profile_launch_readings"] = prof["launch_readings"]
        out["profiled_busy_share"] = prof["device_busy_share"]
        out["wrapper_counts"] = [fa.launches, fa.launches_bwd_dq,
                                 fa.launches_bwd_dkv]
        out["captures"], out["replays"] = step.captures, step.replays
    if ckpt is not None:
        from ray_tpu_torch.train import save_sharded

        save_sharded(state, ckpt, step=steps, wait=True)
        out["state_digest"] = state_digest(state)
    if own:
        del state, step, opt
    torch.cuda.empty_cache()
    return out


def _data_trainer_loop(config):
    """``TorchTrainer``'s loop in the data phase: ``data_train`` over this
    worker's shard of the dataset; rank 0 reports the run once."""
    import chip_smoke
    from ray_tpu_torch.train import session

    device = session.get_device()
    chip_smoke.check(device == torch.device("cuda", 0),
                     f"the trainer's worker runs on {device}")
    run = chip_smoke.data_train(config["cfg"],
                                session.get_dataset_shard("train"),
                                config["steps"], ckpt=config["ckpt"])
    session.report({**run, "rank": session.get_world_rank()})


class DataGangRun:
    """``MeshGroup.run``'s function in the data phase: the rank iterates
    its split into the gang's train step. Pickled by value from this
    script; the worker imports this module for the work."""

    def __init__(self, cfg, steps):
        self.cfg, self.steps = cfg, steps

    def __call__(self, ctx, its):
        import chip_smoke

        return chip_smoke.data_gang_run(self.cfg, self.steps, ctx, its)


def data_gang_run(cfg, steps, ctx, its) -> dict:
    from ray_tpu_torch.parallel.train_step import batch_sharding

    gs = GangTrainStep(cfg)
    run = data_train(cfg, its[ctx.rank], steps, gang_step=gs,
                     state=ctx.state["state"],
                     sharding=batch_sharding(ctx.mesh))
    return {**run, "rank": ctx.rank}


def _data_rows_in_order(run, cycle) -> bool:
    want = [[cycle[i % len(cycle)]["tokens"][:, 0].tolist(),
             cycle[i % len(cycle)]["targets"][:, -1].tolist()]
            for i in range(DATA_FILES)]
    return run["rows"] == want


@timed_phase
def phase_data(cfg, here: dict = None, b: int = MAIN_SHAPE[0],
               s: int = MAIN_SHAPE[1]) -> dict:
    """The data phase (see the module docstring, 16). ``here``: the train
    phase's first ``DATA_STEPS`` metrics and its replay ms, when it ran;
    else the same steps are taken in this process."""
    import os
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.mesh import MeshGroup
    from ray_tpu_torch.parallel import default_optimizer, make_sharded_state
    from ray_tpu_torch.train import (
        RunConfig,
        ScalingConfig,
        TorchTrainer,
        download_sharded_checkpoint,
        load_sharded,
        upload_sharded_checkpoint,
    )

    check(not rt.is_initialized(), "the runtime is already up")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    if here is None:
        here = gang_in_process(
            cfg, [cycle[i % TRAIN_CYCLE] for i in range(DATA_STEPS)])
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    ref = [tuple(m) for m in here["metrics"]][:DATA_STEPS]
    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    files = os.path.join(work, "tokens")
    os.makedirs(files)
    file_bytes = write_token_files(cycle, DATA_FILES, files)
    info = rt.init(object_store_memory=DATA_STORE_BYTES)
    try:
        check(rt.cluster_resources().get("GPU") == 1,
              f"init granted {rt.cluster_resources()}")
        # consumer 1: a TorchTrainer of one GPU worker, datasets=
        ckpt = os.path.join(work, "trainer_ckpt")
        trainer = TorchTrainer(
            _data_trainer_loop,
            train_loop_config={"cfg": cfg, "steps": DATA_STEPS,
                               "ckpt": ckpt},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="data",
                                 storage_path=os.path.join(work, "runs")),
            datasets={"train": token_dataset(files, DATA_FILES)})
        t0 = time.perf_counter()
        tr = trainer.fit().metrics
        fit_s = time.perf_counter() - t0

        # consumer 2: a one-card MeshGroup through split_dataset
        t0 = time.perf_counter()
        mg = MeshGroup(hosts=1, mesh_shape={"dp": 1}, devices_per_host=1,
                       resources_per_host={"CPU": 1, "GPU": 1},
                       state_init=GangStateInit(cfg),
                       name="chip_smoke_data_gang")
        gang_up_s = time.perf_counter() - t0
        try:
            mg.run(GangStateInit(cfg), timeout=GANG_STEP_TIMEOUT_S)
            its = mg.split_dataset(token_dataset(files, DATA_FILES))
            check(len(its) == 1, f"{len(its)} splits for one rank")
            t_call = time.time()
            (gr,) = mg.run(DataGangRun(cfg, DATA_STEPS), its,
                           timeout=GANG_STEP_TIMEOUT_S)
            gang_stats_ = mg.run(gang_stats, timeout=60)
            coord = rt.get(its[0]._coord.stats.remote(), timeout=60)
            its[0].stop()
            member = dict(mg.members[0])
        finally:
            mg.shutdown()
    finally:
        rt.shutdown()
    left = _session_gone(info["session_dir"])
    check(not left, f"session processes left after shutdown: {left}")

    # the trainer
    check(tr["device"] == "cuda:0" and tr["pid"] != os.getpid(),
          f"the trainer's worker: pid {tr['pid']}, {tr['device']}")
    check(_data_rows_in_order(tr, cycle),
          "the trainer's batches are not the files' rows, once, in order")
    check([tuple(m) for m in tr["metrics"]] == ref,
          f"the trainer's metrics {tr['metrics']} differ from the train "
          f"phase's {ref}")
    check(tuple(tr["launches_per_replay"].values()) == want,
          f"trainer: one replay launched flash fwd/dq/dkv "
          f"{tr['launches_per_replay']}, not {want}")
    check(tr["captures"] == 1 and tr["replays"] >= DATA_STEPS - 1,
          f"trainer: {tr['captures']} captures, {tr['replays']} replays")
    # the gang
    check(member["device"] == "cuda:0" and gr["device"] == "cuda:0",
          f"the gang's rank ran on {member}, batches on {gr['device']}")
    check(_data_rows_in_order(gr, cycle),
          "the gang's batches are not the files' rows, once, in order")
    check([tuple(m) for m in gr["metrics"]] == ref,
          f"the gang's metrics {gr['metrics']} differ from the train "
          f"phase's {ref}")
    launches = _gang_launches(gang_stats_, want)
    routed = coord["executor"]["routed_launches"]
    check(routed > 0, f"the split's executor routed no launch: {coord}")
    first_call = gang_stats_[0]["calls"][0]["t_enter"]

    # the trainer's checkpoint through external storage
    remote = "file://" + os.path.join(work, "bucket")
    ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(ckpt) for f in fs)
    t0 = time.perf_counter()
    uri = upload_sharded_checkpoint(ckpt, remote, step=DATA_STEPS)
    upload_s = time.perf_counter() - t0
    fresh = os.path.join(work, "downloaded", "ckpt")
    t0 = time.perf_counter()
    download_sharded_checkpoint(uri, fresh)
    download_s = time.perf_counter() - t0
    opt = default_optimizer()
    live, _ = make_sharded_state(cfg, opt, SEED + 7)
    t0 = time.perf_counter()
    load_sharded(fresh, like=live)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored = state_digest(live)
    del live, opt
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    check(restored == tr["state_digest"],
          "the checkpoint, uploaded, downloaded and restored, differs from "
          "the trainer's state")

    def ingest(run):
        return {"ingest_stall_s": run["ingest"]["ingest_stall_s"],
                "prefetch": run["ingest"],
                "batches_waiting_when_asked": run["pump"]["ready"],
                "pump": run["pump"],
                "first_block_to_last_batch_s":
                    run["first_block_to_last_batch_s"],
                "rows_per_s": run["rows_per_s"],
                "bytes_per_s": run["bytes_per_s"], "bytes": run["bytes"]}

    out = {"phase": "data", "batch": [b, s], "n_layers": cfg.n_layers,
           "files": DATA_FILES, "file_bytes": file_bytes,
           "steps": DATA_STEPS,
           "losses": [m[0] for m in tr["metrics"]],
           "grad_norms": [m[1] for m in tr["metrics"]],
           "in_process_replay_ms": here["replay_ms"],
           "trainer": {"fit_s": fit_s, "replay_ms": tr["replay_ms"],
                       "step_ms": tr["step_ms"],
                       "launches_per_replay": tr["launches_per_replay"],
                       "profile_launch_readings":
                           tr["profile_launch_readings"],
                       "profiled_busy_share": tr["profiled_busy_share"],
                       "wrapper_counts": tr["wrapper_counts"],
                       "peak_memory_bytes": tr["peak_memory_bytes"],
                       "visible": tr["visible"], **ingest(tr),
                       "metrics_equal_in_process_bit_for_bit": True},
           "gang": {"bring_up_s": gang_up_s,
                    "call_to_first_step_s": first_call - t_call,
                    "replay_ms": launches["replay_ms"],
                    "step_ms": gr["step_ms"],
                    "launches_per_replay": launches["launches_per_replay"],
                    "profile_launch_readings":
                        launches["profile_launch_readings"],
                    "wrapper_counts_by_call":
                        launches["wrapper_counts_by_call"],
                    "routed_launches": routed,
                    "coordinator": {k: coord[k] for k in
                                    ("calls", "retries", "exhausted")},
                    "visible": member.get("visible"), **ingest(gr),
                    "metrics_equal_in_process_bit_for_bit": True},
           "checkpoint": {"bytes": ck_bytes, "upload_s": upload_s,
                          "upload_gb_per_s": ck_bytes / upload_s / 1e9,
                          "download_s": download_s,
                          "download_gb_per_s": ck_bytes / download_s / 1e9,
                          "restore_s": restore_s,
                          "restored_equals_worker_state_bit_for_bit": True}}
    emit(out)
    return out


def _tune_trainable(config):
    """The tune phase's trainable (pickled by value from this script; the
    trial's worker imports this module for the work)."""
    import chip_smoke

    chip_smoke.tune_trial(config)


def tune_trial(config) -> None:
    """One trial: the train phase's initial state with
    ``default_optimizer(lr=config["lr"])``, ``TUNE_STEPS`` captured steps
    on the batches of ``config["batches"]`` (an object ref), a report per
    step; after step ``TUNE_PROFILE_STEP`` one extra replay profiled, the
    state put back after it."""
    import os

    import ray_tpu_torch as rt_w
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )
    from ray_tpu_torch.train import session

    cfg = config["cfg"]
    device = session.get_device()
    check(device == torch.device("cuda", 0), f"the trial runs on {device}")
    check(session.get_world_rank() == 0 and session.get_world_size() == 1,
          "a trial is rank 0 of 1")
    batches = rt_w.get(config["batches"], timeout=600)
    opt = default_optimizer(lr=config["lr"])
    state, _ = make_sharded_state(cfg, opt, SEED)
    step = make_train_step(cfg, opt)
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ident = {"pid": os.getpid(), "device": str(device),
             "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "uuid": str(torch.cuda.get_device_properties(0).uuid)}
    prof = None
    for i in range(TUNE_STEPS):
        batch = {k: torch.from_numpy(np.array(v)).cuda()  # a writable copy
                 for k, v in batches[i % len(batches)].items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_start = time.time()
        start.record()
        state, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        t_end = time.time()
        loss, norm, n = _metric(m)
        extra = {}
        if i + 1 == TUNE_PROFILE_STEP:
            reset = state_putback(state)
            prof = profile_launches(lambda: step(state, batch), TRAIN_KINDS,
                                    flash_want(cfg), reset=reset)
            reset()  # the extra replay leaves the trial's path as it was
            del reset
            extra = {"launches_per_replay": {
                         k: prof["launches_by_kind"][k] for k in FLASH_KINDS},
                     "profile_launch_readings": prof["launch_readings"],
                     "profiled_busy_share": prof["device_busy_share"]}
        session.report({"loss": loss, "grad_norm": norm, "step": n,
                        "ms": start.elapsed_time(end), "t_start": t_start,
                        "t_end": t_end,
                        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                        "captures": step.captures, "replays": step.replays,
                        **ident, **extra})


@timed_phase
def phase_tune(cfg, here: dict = None, b: int = MAIN_SHAPE[0],
               s: int = MAIN_SHAPE[1]) -> dict:
    """The tune phase (see the module docstring, 17). ``here``: the train
    phase's first metrics, when it ran; else the same steps are taken in
    this process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    check(not rt.is_initialized(), "the runtime is already up")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    batches = [cycle[i % TRAIN_CYCLE] for i in range(TUNE_STEPS)]
    if here is None:
        here = gang_in_process(cfg, batches)
    ref = [tuple(m) for m in here["metrics"]][:TUNE_STEPS]
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    info = rt.init(object_store_memory=DATA_STORE_BYTES)
    try:
        check(rt.cluster_resources().get("GPU") == 1,
              f"init granted {rt.cluster_resources()}")
        asha = tune.ASHAScheduler(metric="loss", mode="min", grace_period=2,
                                  reduction_factor=2, max_t=TUNE_STEPS)
        tuner = tune.Tuner(
            _tune_trainable,
            param_space={"lr": tune.grid_search(list(TUNE_LRS)), "cfg": cfg,
                         "batches": rt.put(batches)},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=2,
                                        scheduler=asha),
            resources_per_trial={"CPU": 1, "GPU": TUNE_GPUS})
        reports = {}
        orig = asha.on_trial_result

        def record(trial, result):  # every report, in arrival order
            reports.setdefault(trial.config["lr"], []).append(dict(result))
            return orig(trial, result)

        asha.on_trial_result = record
        t0 = time.perf_counter()
        grid = tuner.fit()
        fit_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = _session_gone(info["session_dir"])
    check(not left, f"session processes left after shutdown: {left}")
    check(not grid.errors, f"trials errored: {[r.error for r in grid.errors]}")
    check(sorted(reports) == sorted(TUNE_LRS), f"reports from {list(reports)}")
    uuid = str(torch.cuda.get_device_properties(0).uuid)
    trials = {}
    for lr, rs in reports.items():
        check(len(rs) >= asha.grace_period,
              f"lr {lr}: {len(rs)} reports, under the grace period")
        check(all(r["visible"] == "0" and r["device"] == "cuda:0"
                  and r["uuid"] == uuid for r in rs),
              f"lr {lr} ran on {[(r['visible'], r['uuid']) for r in rs]}")
        prof = [r for r in rs if "launches_per_replay" in r]
        check(len(prof) == 1 and tuple(
            prof[0]["launches_per_replay"].values()) == want,
              f"lr {lr}: a profiled replay launched "
              f"{[p.get('launches_per_replay') for p in prof]}, not {want}")
        trials[lr] = {
            "iterations": len(rs), "losses": [r["loss"] for r in rs],
            "grad_norms": [r["grad_norm"] for r in rs],
            "step_ms": [r["ms"] for r in rs],
            "replay_ms": [r["ms"] for r in rs[2:]],
            "window": [rs[0]["t_start"], rs[-1]["t_end"]],
            "peak_memory_bytes": max(r["peak_memory_bytes"] for r in rs),
            "pid": rs[0]["pid"],
            "launches_per_replay": prof[0]["launches_per_replay"],
            "profile_launch_readings": prof[0]["profile_launch_readings"],
            "profiled_busy_share": prof[0]["profiled_busy_share"]}
    a, b_ = (trials[lr] for lr in TUNE_LRS)
    check(a["pid"] != b_["pid"], "both trials ran in one process")
    overlap = min(a["window"][1], b_["window"][1]) - max(a["window"][0],
                                                         b_["window"][0])
    check(overlap > 0, f"the trials' step windows do not overlap: "
          f"{a['window']}, {b_['window']}")
    mine = [(r["loss"], r["grad_norm"], int(r["step"]))
            for r in reports[TUNE_LRS[0]]]
    check(mine == ref[:len(mine)], f"the {TUNE_LRS[0]} trial's metrics "
          f"{mine} differ from the train phase's {ref[:len(mine)]}")
    best = grid.get_best_result()
    lower = min(TUNE_LRS, key=lambda lr: trials[lr]["losses"][-1])
    check(best.config["lr"] == lower,
          f"get_best_result() picked lr {best.config['lr']}, not {lower} "
          f"(last losses {[trials[lr]['losses'][-1] for lr in TUNE_LRS]})")
    out = {"phase": "tune", "batch": [b, s], "n_layers": cfg.n_layers,
           "lrs": list(TUNE_LRS), "gpu_per_trial": TUNE_GPUS,
           "fit_s": fit_s, "best_lr": best.config["lr"],
           "trials": {str(lr): t for lr, t in trials.items()},
           "windows_overlap_s": overlap,
           "in_process_losses": [m[0] for m in ref],
           "default_lr_trial_equal_in_process_bit_for_bit": True}
    emit(out)
    return out


# ------------------------------------------------------------------- rl --
RL_ENV = "MinAtar-Breakout"  # the in-repo Atari proxy (no gymnasium there)
RL_OBS, RL_ACTIONS = 300, 3  # its observation width and actions
RL_PPO_ITERS = 5
RL_ASYNC_ITERS = 3  # IMPALA's and APPO's iterations
RL_DQN_ITERS = 4
RL_SAC_MAX_ITERS = 40  # tests/test_rllib_sac_ma.py:117-130's cap
RL_SAC_BAR = -15.0  # and its bar
RL_STORE_BYTES = 1 << 30  # the node's object store, in /dev/shm
RL_CPUS = 16  # logical: the phase's 12 env runners (each holds one) at once
# Twins, the learner on the card against the same update on the CPU (fp32,
# TF32 off): losses within RL_LOSS_RTOL, gradients and the parameters after
# an update of many Adam steps within RL_TWIN_TOL. On the CPU the same
# computations in fp32 come within 8.7e-7 of fp64 (parameters) and 5.3e-6
# (V-trace gradients); tests/test_torch_chip_smoke_rl.py holds that under
# a third of the atol, so the card's own rounding has room. Adam's first
# step moves a weight by about ±lr whatever its gradient, so a gradient
# within float noise of zero that flipped sign between the devices would
# show as a difference near lr, and fail.
RL_LOSS_RTOL = 1e-4
RL_TWIN_TOL = (1e-4, 2e-5)  # rtol, atol
# four cards: the dp 4 update against one learner's on one batch, the
# reference's criterion (tests/test_rllib.py:252-281) and tolerances;
# elements whose one-learner gradient is within 1e-5 of its leaf's largest
# (float noise) are held to 2 lr, Adam's first step either way
RL_DP_LOSS_RTOL = 1e-4
RL_DP_PARAM_TOL = (1e-5, 1e-6)


def _f64(x) -> torch.Tensor:
    """A tensor or host array as a float64 CPU tensor of its own."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu()
    return torch.from_numpy(np.array(x, np.float64))


def _tree_err(got, want) -> tuple:
    """(max abs, max rel) difference over the leaves of two trees."""
    from ray_tpu_torch.rllib.models import tree_leaves

    abs_err = rel_err = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = _f64(a), _f64(b)
        d = (a - b).abs()
        abs_err = max(abs_err, float(d.max()) if d.numel() else 0.0)
        rel_err = max(rel_err, float((d / b.abs().clamp_min(1e-30)).max())
                      if d.numel() else 0.0)
    return abs_err, rel_err


def _tree_close(got, want, rtol: float, atol: float, what: str) -> float:
    from ray_tpu_torch.rllib.models import tree_leaves

    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = _f64(a), _f64(b)
        check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
              f"{what}: card and CPU differ by {float((a - b).abs().max())} "
              f"(rtol {rtol}, atol {atol})")
    return _tree_err(got, want)[0]


def rl_twin_inputs(seed: int = SEED + 40) -> dict:
    """Seeded host inputs of the five learner twins, at the main path's
    shapes: MinAtar-Breakout batches (binary planes, 300 wide; 3 actions)
    for PPO (one iteration: 2 x 512 steps), V-trace (one IMPALA rollout of
    256 steps), DQN (32 minibatches of 64) and BC (1,024 rows); PointGoal2D
    for SAC (16 steps of 128)."""
    from ray_tpu_torch.rllib.models import init_actor_critic, init_q_network
    from ray_tpu_torch.rllib.sac import init_sac_networks

    rng = np.random.default_rng(seed)

    def planes(*shape):
        return (rng.random((*shape, RL_OBS)) < 0.1).astype(np.float32)

    n = 1024
    adv = rng.normal(size=n).astype(np.float32)
    cuts = (rng.random((1, 256)) < 0.02).astype(np.float32)
    return {
        "ac": init_actor_critic(seed, RL_OBS, RL_ACTIONS, device="cpu"),
        "q": init_q_network(seed + 1, RL_OBS, RL_ACTIONS, device="cpu"),
        "sac": init_sac_networks(seed + 2, 4, 2, (64, 64), device="cpu"),
        "ppo": {"obs": planes(n),
                "actions": rng.integers(0, RL_ACTIONS, n).astype(np.int32),
                "logp": np.log(rng.uniform(0.2, 0.5, n)).astype(np.float32),
                "advantages": (adv - adv.mean()) / (adv.std() + 1e-8),
                "returns": rng.normal(size=n).astype(np.float32)},
        "perms": torch.stack([torch.randperm(n, generator=torch.Generator()
                                             .manual_seed(seed + e))
                              for e in range(8)]),
        "vtrace": {"obs": planes(1, 256),
                   "actions": rng.integers(0, RL_ACTIONS,
                                           (1, 256)).astype(np.int32),
                   "logp": np.log(rng.uniform(0.2, 0.5, (1, 256))
                                  ).astype(np.float32),
                   "rewards": (rng.random((1, 256)) < 0.1).astype(np.float32),
                   "next_values": rng.normal(size=(1, 256)).astype(np.float32),
                   "terminals": cuts * (rng.random((1, 256)) < 0.5),
                   "cuts": cuts},
        "dqn": {"obs": planes(32, 64),
                "actions": rng.integers(0, RL_ACTIONS,
                                        (32, 64)).astype(np.int32),
                "rewards": (rng.random((32, 64)) < 0.1).astype(np.float32),
                "next_obs": planes(32, 64),
                "terminals": (rng.random((32, 64)) < 0.02).astype(np.float32)},
        "sac_batches": {
            "obs": rng.uniform(-1, 1, (16, 128, 4)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (16, 128, 2)).astype(np.float32),
            "rewards": -rng.random((16, 128)).astype(np.float32),
            "next_obs": rng.uniform(-1, 1, (16, 128, 4)).astype(np.float32),
            "terminals": np.zeros((16, 128), np.float32)},
        "sac_noise": torch.randn(16, 2, 128, 2, generator=torch.Generator()
                                 .manual_seed(seed + 3)),
        "bc": {"obs": planes(16, 256),
               "actions": rng.integers(0, RL_ACTIONS,
                                       (16, 256)).astype(np.int32)},
    }


def rl_twin_run(inputs: dict, device: torch.device,
                dtype: torch.dtype = torch.float32) -> dict:
    """The five learner computations on ``device`` from ``inputs``: PPO's
    update (8 epochs x 4 minibatches of 256), IMPALA's V-trace loss and its
    gradients, DQN's step (32 minibatches, double-Q, a target copy every 16
    steps), SAC's step (16) and BC's step (16). Returns each one's outputs
    and its wall ms (synchronized)."""
    from ray_tpu_torch.rllib import dqn, impala, offline, ppo, sac
    from ray_tpu_torch.rllib.models import (adam, grads_of, to_device,
                                            trainable, tree_leaves,
                                            tree_map)

    def on(tree):
        return tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                        else t, to_device(tree, device))

    def params(tree):
        return trainable(tree_map(lambda t: t.to(dtype), tree), device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    out = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[name] = {"result": res, "ms": (time.perf_counter() - t0) * 1e3}

    def run_ppo():
        p = params(inputs["ac"])
        aux = ppo.ppo_update(p, adam(p, 3e-4), on(inputs["ppo"]),
                             inputs["perms"].to(device), ppo.PPOConfig())
        return {"params": p, "aux": aux}

    def run_vtrace():
        p = params(inputs["ac"])
        loss = impala.make_impala_loss(impala.IMPALAConfig())(
            p, on(inputs["vtrace"]))
        return {"loss": loss.detach(),
                "grads": grads_of(loss, tree_leaves(p))}

    def run_dqn():
        p = params(inputs["q"])
        target = tree_map(lambda t: t.detach().clone(), p)
        cfg = dqn.DQNConfig(target_update_freq=16)
        step, loss = dqn.dqn_update(p, target, adam(p, cfg.lr), 0,
                                    on(inputs["dqn"]), cfg)
        return {"params": p, "target": target, "loss": loss}

    def run_sac():
        cfg = sac.SACConfig(hidden=(64, 64))
        state = sac.init_sac_state(cfg, 4, 2, device,
                                   params=tree_map(lambda t: t.to(dtype),
                                                   inputs["sac"]))
        cl, al = sac.sac_update(state, on(inputs["sac_batches"]),
                                inputs["sac_noise"].to(device, dtype), cfg,
                                -2.0)
        return {"params": state["params"], "target_q": state["target_q"],
                "log_alpha": state["log_alpha"], "losses": [cl, al]}

    def run_bc():
        p = params(inputs["ac"])
        loss = offline.bc_update(p, adam(p, 1e-3), on(inputs["bc"]))
        return {"params": p, "loss": loss}

    for name, fn in (("ppo_update", run_ppo), ("vtrace_loss", run_vtrace),
                     ("dqn_step", run_dqn), ("sac_step", run_sac),
                     ("bc_step", run_bc)):
        timed(name, fn)
    return out


def rl_twins() -> dict:
    """The learner's updates on ``cuda:0`` against their CPU twins (fp32,
    TF32 off), on the same inputs; each within its tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = rl_twin_inputs()
    card = rl_twin_run(inputs, torch.device("cuda", 0))
    card = rl_twin_run(inputs, torch.device("cuda", 0))  # timed warm
    host = rl_twin_run(inputs, torch.device("cpu"))
    out = {}
    for name in card:
        c, h = card[name]["result"], host[name]["result"]
        errs = {}
        if name == "vtrace_loss":
            errs["loss"] = _tree_close(c["loss"], h["loss"], RL_LOSS_RTOL,
                                       0.0, f"{name} loss")
            errs["grads"] = _tree_close(c["grads"], h["grads"],
                                        *RL_TWIN_TOL, f"{name} grads")
        else:
            for key in c:
                tol = ((RL_LOSS_RTOL, 1e-6) if key in ("aux", "loss",
                                                       "losses")
                       else RL_TWIN_TOL)
                errs[key] = _tree_close(c[key], h[key], *tol,
                                        f"{name} {key}")
        out[name] = {"max_abs_err": errs, "card_ms": card[name]["ms"],
                     "cpu_ms": host[name]["ms"]}
    return out


class _Timed:
    """An algorithm's hook, wrapped: host seconds per call and, with
    ``cuda``, the device ms from the call's start to its end (CUDA
    events)."""

    def __init__(self, fn, cuda: bool = False):
        self.fn, self.cuda = fn, cuda
        self.host_s, self._events = [], []

    def __call__(self, *args, **kwargs):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self.cuda:
            end.record()
            self._events.append((start, end))
        self.host_s.append(time.perf_counter() - t0)
        return out

    def device_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events]


def _card_clear(session_dir: str) -> list:
    """The CUDA contexts on the card: this process's, and no actor's.
    nvidia-smi names this machine's pids only where it shares the pid
    namespace; elsewhere it lists one entry per context all the same, so
    the driver's must be the only entry."""
    import os

    pids = _compute_app_pids()
    ours = set(pids) & (set(_session_pids(session_dir)) | {os.getpid()})
    check(len(pids) == 1 and ours <= {os.getpid()},
          f"nvidia-smi lists CUDA contexts {pids}; the driver is "
          f"{os.getpid()}, the session's processes "
          f"{_session_pids(session_dir)}")
    return pids


def _on_card(params) -> bool:
    from ray_tpu_torch.rllib.models import tree_leaves

    return all(t.device == torch.device("cuda", 0)
               for t in tree_leaves(params))


def rl_algorithms() -> dict:
    """Every algorithm of the phase, built at once, their learners on the
    card: the env runners' processes (each imports torch) start together
    and each algorithm then trains in turn. PPO on MinAtar-Breakout at
    ``PPOConfig``'s defaults (2 workers x 512 steps, 8 epochs of
    minibatches of 256, hidden 64 x 64); IMPALA (one learner) and APPO at
    theirs (2 workers x 256); DQN at its own with the replay warm-up cut to
    256 steps, so that every iteration learns; SAC on PointGoal2D with
    tests/test_rllib_sac_ma.py:117-130's config (2 workers x 256 steps,
    learning_starts 512, hidden 64 x 64); two-agent PPO, a policy per
    agent."""
    from ray_tpu_torch.rllib import (APPOConfig, DQNConfig, IMPALAConfig,
                                     MultiAgentPPOConfig, PPOConfig,
                                     SACConfig)

    configs = {
        "ppo": PPOConfig(env=RL_ENV),
        "impala": IMPALAConfig(env=RL_ENV),
        "appo": APPOConfig(env=RL_ENV),
        "dqn": DQNConfig(env=RL_ENV, learning_starts=256),
        "sac": SACConfig(env="PointGoal2D-v0", num_workers=2, rollout_len=256,
                         learning_starts=512, hidden=(64, 64), seed=0),
        "multi_agent": MultiAgentPPOConfig(
            policy_mapping_fn=lambda aid: f"pol_{aid}", num_workers=2),
    }
    algos = {}
    try:
        for name, config in configs.items():
            algos[name] = config.build()
    except BaseException:
        for algo in algos.values():
            algo.stop()
        raise
    return algos


def rl_ppo(algo, session_dir: str) -> dict:
    """PPO for ``RL_PPO_ITERS`` iterations."""
    try:
        check(_on_card(algo.params), "PPO's parameters are not on cuda:0")
        update = algo._update = _Timed(algo._update, cuda=True)
        sample = algo._sample = _Timed(algo._sample)
        weights = algo._broadcast = _Timed(algo._broadcast)
        walls, results = [], []
        for _ in range(RL_PPO_ITERS):
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
        pids = _card_clear(session_dir)
        check(_on_card(algo.params), "PPO's parameters left cuda:0")
    finally:
        algo.stop()
    last = results[-1]
    check(all(np.isfinite(v) for r in results for v in r["info"].values()),
          f"PPO's losses are not finite: {[r['info'] for r in results]}")
    check(last["num_env_steps_sampled"] == RL_PPO_ITERS * 2 * 512,
          f"PPO sampled {last['num_env_steps_sampled']} env steps")
    return {"iterations": RL_PPO_ITERS, "wall_s": walls,
            "sample_s": sample.host_s, "weights_to_workers_s": weights.host_s,
            "update_ms": update.device_ms(), "update_host_s": update.host_s,
            "episode_reward_mean": [r["episode_reward_mean"]
                                    for r in results],
            "info": last["info"], "params_on": "cuda:0",
            "compute_app_pids": pids}


def rl_async(algo, name: str) -> dict:
    """IMPALA (one learner, on the card) or APPO for ``RL_ASYNC_ITERS``
    iterations."""
    try:
        check(_on_card(algo.learners.params),
              f"{name}'s parameters are not on cuda:0")
        update = algo._update = _Timed(algo._update, cuda=True)
        walls, results = [], []
        for _ in range(RL_ASYNC_ITERS):
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
    finally:
        algo.stop()
    last = results[-1]
    check(last["num_async_updates"] == 2 * RL_ASYNC_ITERS,
          f"{name}: {last['num_async_updates']} async updates")
    check(last["num_env_steps"] == 2 * RL_ASYNC_ITERS * 256,
          f"{name}: {last['num_env_steps']} env steps")
    check(all(np.isfinite(r["loss"]) for r in results),
          f"{name}: losses {[r['loss'] for r in results]}")
    return {"iterations": RL_ASYNC_ITERS, "wall_s": walls,
            "update_ms": update.device_ms(),
            "num_async_updates": last["num_async_updates"],
            "num_env_steps": last["num_env_steps"],
            "losses": [r["loss"] for r in results]}


def rl_dqn(algo) -> dict:
    """DQN for ``RL_DQN_ITERS`` iterations (2 workers x 128 steps, 32
    minibatches of 64 an iteration)."""
    try:
        check(_on_card(algo.params), "DQN's parameters are not on cuda:0")
        update = algo._update = _Timed(algo._update, cuda=True)
        walls, results = [], []
        for _ in range(RL_DQN_ITERS):
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
    finally:
        algo.stop()
    losses = [r["info"]["mean_td_loss"] for r in results]
    check(all(np.isfinite(x) for x in losses), f"DQN's losses: {losses}")
    check(results[-1]["num_env_steps_sampled"] == RL_DQN_ITERS * 256,
          f"DQN sampled {results[-1]['num_env_steps_sampled']}")
    return {"iterations": RL_DQN_ITERS, "wall_s": walls,
            "update_ms": update.device_ms(), "losses": losses,
            "sgd_steps": algo._sgd_steps}


def rl_sac(algo, session_dir: str) -> dict:
    """SAC until its mean episode reward passes ``RL_SAC_BAR``, at most
    ``RL_SAC_MAX_ITERS`` iterations: the one learning check on the card."""
    best, rewards, walls = -1e9, [], []
    try:
        check(_on_card(algo.params), "SAC's parameters are not on cuda:0")
        update = algo._update = _Timed(algo._update, cuda=True)
        for _ in range(RL_SAC_MAX_ITERS):
            t0 = time.perf_counter()
            m = algo.train()
            walls.append(time.perf_counter() - t0)
            rewards.append(m["episode_reward_mean"])
            if np.isfinite(m["episode_reward_mean"]):
                best = max(best, m["episode_reward_mean"])
            if best > RL_SAC_BAR:
                break
        pids = _card_clear(session_dir)
    finally:
        algo.stop()
    check(best > RL_SAC_BAR, f"SAC plateaued at {best:.2f} after "
          f"{len(rewards)} iterations: {rewards}")
    return {"iterations": len(rewards), "best_reward": best,
            "episode_reward_mean": rewards, "wall_s": walls,
            "update_ms": update.device_ms(), "info": m["info"],
            "compute_app_pids": pids}


def _breakout_expert(flat_obs) -> int:
    """Track the ball with the paddle (tests/test_offline_webdataset.py)."""
    n = 10
    planes = flat_obs.reshape(3, n, n)
    paddle_cols = np.where(planes[0][n - 1] > 0)[0]
    ball = np.argwhere(planes[1] > 0)
    if len(ball) == 0 or len(paddle_cols) == 0:
        return 1
    bx, px = ball[0][1], int(paddle_cols.mean())
    return 0 if bx < px else (2 if bx > px else 1)


def rl_ma_and_bc(algo) -> dict:
    """Two-agent PPO for 2 iterations; BC from a JSONL file that
    ``collect_experience`` wrote (3,000 expert steps on MinAtar-Breakout),
    read back through ``read_experience``: 2 train calls and
    ``evaluate``."""
    import shutil
    import tempfile

    from ray_tpu_torch.rllib import (BCConfig, collect_experience,
                                     read_experience, write_experience_json)

    try:
        check(all(_on_card(p) for p in algo.params.values()),
              "multi-agent PPO's parameters are not on cuda:0")
        ma = [algo.train() for _ in range(2)]
    finally:
        algo.stop()
    check(set(ma[-1]["info"]) == {"pol_a0", "pol_a1"},
          f"multi-agent PPO trained {set(ma[-1]['info'])}")
    check(all(np.isfinite(v) for r in ma for d in r["info"].values()
              for v in d.values()), f"multi-agent losses: {ma[-1]['info']}")
    work = tempfile.mkdtemp(prefix="chip_smoke_bc_")
    try:
        path = f"{work}/expert.jsonl"
        rows = write_experience_json(
            collect_experience(RL_ENV, _breakout_expert, 3000, seed=0), path)
        bc = BCConfig(seed=0).build(read_experience(path))
        check(_on_card(bc.params), "BC's parameters are not on cuda:0")
        losses = [bc.train()["info"]["bc_loss"] for _ in range(2)]
        t0 = time.perf_counter()
        score = bc.evaluate(RL_ENV, episodes=5, seed=7)
        eval_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(all(np.isfinite(x) for x in losses) and losses[1] < losses[0],
          f"BC's losses {losses}")
    return {"multi_agent": {"iterations": 2,
                            "episode_reward_mean": [r["episode_reward_mean"]
                                                    for r in ma],
                            "info": ma[-1]["info"]},
            "bc": {"rows": rows, "losses": losses, "evaluate_return": score,
                   "evaluate_s": eval_s}}


def _kernel_counts() -> tuple:
    from ray_tpu_torch.ops import decode_attention as da
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import int8_matmul as im

    return (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv,
            im.launches, da.launches)


@timed_phase
def phase_rl() -> dict:
    """The rl phase (see the module docstring, 18)."""
    import ray_tpu_torch as rt

    check(not rt.is_initialized(), "the runtime is already up")
    before = _kernel_counts()
    out = {"phase": "rl", "twins": rl_twins()}
    emit({"phase": "rl_twins", **out["twins"]})
    info = rt.init(num_cpus=RL_CPUS, object_store_memory=RL_STORE_BYTES)
    session = info["session_dir"]
    algos = {}
    try:
        t0 = time.perf_counter()
        algos = rl_algorithms()
        out["build_s"] = time.perf_counter() - t0
        for name, key, part in (
                ("ppo", "ppo", lambda a: rl_ppo(a, session)),
                ("impala", "impala", lambda a: rl_async(a, "impala")),
                ("appo", "appo", lambda a: rl_async(a, "appo")),
                ("dqn", "dqn", rl_dqn),
                ("sac", "sac", lambda a: rl_sac(a, session)),
                ("multi_agent_and_bc", "multi_agent", rl_ma_and_bc)):
            t0 = time.perf_counter()
            out[name] = {**part(algos.pop(key)),
                         "part_s": time.perf_counter() - t0}
            emit({"phase": f"rl_{name}", **out[name]})
    finally:
        for algo in algos.values():
            algo.stop()
        rt.shutdown()
    left = _session_gone(session)
    check(not left, f"session processes left after shutdown: {left}")
    check(_kernel_counts() == before,
          f"the RL path launched a kernel: {before} -> {_kernel_counts()}")
    out["kernel_launches"] = 0
    emit({k: out[k] for k in ("phase", "kernel_launches")})
    return out


# The platform phase: bench_400m trained and served in a workflow inside a
# job submitted through the CLI (``python -m ray_tpu_torch.scripts``), the
# GCS primary SIGKILLed under the second job and its warm standby promoted,
# the dashboard, the state API and the metrics read over it all. The job's
# driver is this script, ``chip_smoke.py platform-job <dir> <workflow id>
# <fail | resume>``; it holds no CUDA context: the card's work runs in the
# workflow's tasks and actors.
PLATFORM_STEPS = 4  # warm-up, capture, two replays (the last profiled)
PLATFORM_SERVE = (8, 128, 64)  # requests, prompt length, new tokens each
# each pool actor's engine, and the in-process engine held against them
PLATFORM_ENGINE = {"max_slots": 8, "max_len": 256, "prefill_buckets": (128,)}
PLATFORM_POOL = 2  # LLMServer actors in the ActorPool
PLATFORM_POOL_GPUS = 0.5  # each actor's share of the one card
PLATFORM_CPUS = 8  # logical, on the one node
PLATFORM_STORE_BYTES = 1 << 30  # the node's object store, in /dev/shm
# the file backend's journal, a warm standby that promotes 1 s after the
# primary stops answering; an actor whose creation (a process that imports
# torch and loads a checkpoint) is in flight at the SIGKILL is announced by
# its raylet once created, and the promoted GCS waits that long for it
# before it places the actor again
PLATFORM_CONFIG = {"gcs_storage_backend": "file", "gcs_standby": True,
                   "gcs_failover_grace_s": 1.0,
                   "gcs_actor_recovery_grace_s": 120.0}
PLATFORM_JOB_TIMEOUT_S = 900.0  # one job, its driver's start included
PLATFORM_KILL_WRITES_S = 2.0  # KV writes go on this long after the SIGKILL
PLATFORM_SHUTDOWN_S = 20.0  # for the session's processes to be gone
PLATFORM_FAILURE_FLAG = "inject_failure"  # in the work dir: serve raises
# KV keys: the serve step's start (the SIGKILL waits on it), the pool up
# (the card checks run then), the driver's go-ahead after them, and the
# handshake's switch (set by the phase; a workflow run without it serves
# at once)
PLATFORM_KEYS = {"serve": "platform:serve_started", "pool": "platform:pool_up",
                 "sampled": "platform:sampled",
                 "handshake": "platform:handshake"}
PLATFORM_HANDSHAKE_S = 300.0


def platform_prompts(cfg, n: int, length: int) -> list:
    rng = np.random.default_rng(SEED + 5)
    return [rng.integers(0, cfg.vocab_size, length).tolist()
            for _ in range(n)]


def platform_train(cfg, b: int, s: int, steps: int, ckpt: str,
                   device=None) -> dict:
    """The workflow's train step: ``steps`` captured steps of ``cfg`` from
    ``SEED`` on the train phase's batches (``TRAIN_CYCLE`` of seed
    ``SEED + 2``), the last a replay profiled for its flash kernels by name
    (on the card), then the state saved as a sharded checkpoint at
    ``ckpt``. Returns host values only: the metrics, replay ms, launches and
    the checkpoint's path."""
    import os

    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )
    from ray_tpu_torch.train import save_sharded

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED, device=dev)
    step = make_train_step(cfg, opt)
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    metrics, ms, prof, out = [], [], None, []
    for i in range(steps):
        batch = {k: torch.from_numpy(np.array(v)).to(dev)
                 for k, v in cycle[i % TRAIN_CYCLE].items()}
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if on_card else None)

        def run():
            if events:
                events[0].record()
            out.append(step(state, batch))
            if events:
                events[1].record()

        if on_card and i == steps - 1:
            prof = profile_launches(run, TRAIN_KINDS, flash_want(cfg),
                                    reset=state_putback(state))
        else:
            run()
        state, m = out[-1]
        if on_card:
            torch.cuda.synchronize()
            ms.append(events[0].elapsed_time(events[1]))
        metrics.append(_metric(m))
    t0 = time.perf_counter()
    save_sharded(state, ckpt, step=steps, wait=True)
    save_s = time.perf_counter() - t0
    res = {"pid": os.getpid(), "device": str(dev),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "metrics": metrics, "step_ms": ms, "replay_ms": ms[2:],
           "wrapper_counts": [fa.launches, fa.launches_bwd_dq,
                              fa.launches_bwd_dkv],
           "captures": step.captures, "replays": step.replays,
           "ckpt": ckpt, "save_s": save_s,
           "ckpt_bytes": sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(ckpt) for f in fs)}
    if on_card:
        res["launches_per_replay"] = {k: prof["launches_by_kind"][k]
                                      for k in FLASH_KINDS}
        res["profile_launch_readings"] = prof["launch_readings"]
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del state, step, opt, out
    if on_card:
        torch.cuda.empty_cache()
    return res


def platform_params(cfg, ckpt: str, device=None):
    """The parameters of the sharded checkpoint at ``ckpt``, loaded into a
    fresh ``TrainState`` of ``cfg`` on ``device`` (CUDA by default)."""
    from ray_tpu_torch.parallel import default_optimizer, make_sharded_state
    from ray_tpu_torch.train import load_sharded

    state, _ = make_sharded_state(cfg, default_optimizer(), SEED,
                                  device=device)
    load_sharded(ckpt, like=state)
    return state.params


class PlatformWeights:
    """A pool actor's model factory: the parameters of the train step's
    checkpoint, on the actor's card (``device``: None for CUDA)."""

    def __init__(self, cfg, ckpt: str, device=None):
        self.cfg, self.ckpt, self.device = cfg, ckpt, device

    def __call__(self):
        return platform_params(self.cfg, self.ckpt, self.device), self.cfg


def _platform_llm():
    """``LLMServer`` as the pool's actor: it counts the tokens it serves in
    a ``util.metrics`` Counter and records each request's TTFT in a
    Histogram, flushed to the GCS after each request."""
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.util import metrics

    class PlatformLLM(LLMServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.tokens = metrics.Counter(
                "platform_tokens", "tokens served by the pool",
                tag_keys=("actor",))
            self.ttft = metrics.Histogram(
                "platform_ttft_s", "time to first token",
                boundaries=[0.01, 0.03, 0.1, 0.3, 1.0])

        def ready(self):
            import os

            import ray_tpu_torch as rt_a

            return {"pid": os.getpid(),
                    "cards": rt_a.get_runtime_context()
                    .get_accelerator_ids()}

        def serve_one(self, index: int, prompt: list, new: int):
            import os

            t0 = time.perf_counter()
            tokens, ttft = [], None
            for tok in self.engine.generate_stream(prompt,
                                                   max_new_tokens=new):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                tokens.append(int(tok))
            total = time.perf_counter() - t0
            name = str(os.getpid())
            self.tokens.inc(len(tokens), {"actor": name})
            self.ttft.observe(ttft)
            metrics.flush_to_gcs()
            return {"index": index, "tokens": tokens, "ttft_s": ttft,
                    "total_s": total, "pid": os.getpid()}

    return PlatformLLM


def _kv(gcs, key: str, value=None):
    """Put ``value`` (JSON) under ``key`` in the GCS KV, or read it."""
    if value is not None:
        return gcs.call("kv_put", [key, json.dumps(value).encode(), True],
                        timeout=60)
    blob = gcs.call("kv_get", key, timeout=60)
    return None if blob is None else json.loads(bytes(blob))


def _kv_wait(gcs, key: str, timeout: float):
    deadline = time.monotonic() + timeout
    while True:
        try:
            got = _kv(gcs, key)
        except Exception:  # the GCS mid-failover: ask again
            got = None
        if got is not None:
            return got
        check(time.monotonic() < deadline, f"no {key} within {timeout} s")
        time.sleep(0.1)


def _decode_rate(r: dict, new: int) -> float:
    """Decode tokens/s of one request: the tokens after the first over the
    time after it."""
    return (new - 1) / (r["total_s"] - r["ttft_s"])


def platform_serve(trained: dict, cfg, shape, work: str,
                   device=None) -> dict:
    """The workflow's serve step (a CPU task): an ``ActorPool`` of
    ``PLATFORM_POOL`` LLMServer actors at ``PLATFORM_POOL_GPUS`` each,
    their parameters from the train step's checkpoint, serves the prompts
    of a ``util.queue.Queue`` greedily through ``map_unordered``. Raises
    the injected failure while the work dir holds the flag file."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import require_connected
    from ray_tpu_torch.util import ActorPool
    from ray_tpu_torch.util.queue import Queue

    if os.path.exists(os.path.join(work, PLATFORM_FAILURE_FLAG)):
        raise RuntimeError("platform: injected failure in the serve step")
    gcs = require_connected().gcs
    worker_id = rt.get_runtime_context().get_worker_id()
    _kv(gcs, PLATFORM_KEYS["serve"], {"pid": os.getpid()})
    n, length, new = shape
    queue = Queue()
    for i, p in enumerate(platform_prompts(cfg, n, length)):
        queue.put((i, p))
    actor_cls = rt.remote(num_gpus=PLATFORM_POOL_GPUS,
                          max_concurrency=4)(_platform_llm())
    t0 = time.perf_counter()
    actors = [actor_cls.options(name=f"LLMServer-{k}").remote(
        PlatformWeights(cfg, trained["ckpt"], device), device=device,
        **PLATFORM_ENGINE) for k in range(PLATFORM_POOL)]
    up = rt.get([a.ready.remote() for a in actors], timeout=900)
    pool_up_s = time.perf_counter() - t0
    if _kv(gcs, PLATFORM_KEYS["handshake"]) is not None:
        # the driver checks the card's shares while the pool lives
        _kv(gcs, PLATFORM_KEYS["pool"], {"pool": up,
                                         "train_pid": trained["pid"]})
        _kv_wait(gcs, PLATFORM_KEYS["sampled"], PLATFORM_HANDSHAKE_S)
    before = rt.get([a.stats.remote() for a in actors], timeout=60)
    pool = ActorPool(actors)
    t0 = time.perf_counter()
    results = list(pool.map_unordered(
        lambda a, _: a.serve_one.remote(*queue.get(timeout=60), new),
        range(n)))
    serve_s = time.perf_counter() - t0
    after = rt.get([a.stats.remote() for a in actors], timeout=60)
    check(queue.empty(), "prompts left in the queue")
    for a in actors:
        rt.kill(a)
    rt.kill(queue._actor)
    results.sort(key=lambda r: r["index"])
    per_actor = []
    for u, b, a in zip(up, before, after):
        steps = a["steps"] - b["steps"]
        per_actor.append({
            "pid": u["pid"], "cards": u["cards"], "decode_steps": steps,
            "decode_steps_replayed": (a["decode_steps_replayed"]
                                      - b["decode_steps_replayed"]),
            "decode_attention_launches": (
                a["decode_attention_launches_replayed"]
                - b["decode_attention_launches_replayed"]),
            "requests": sum(r["pid"] == u["pid"] for r in results)})
    print(f"platform serve: {n} requests of {length} tokens, {new} new "
          f"each, served by {PLATFORM_POOL} actors in {serve_s:.3f} s",
          flush=True)
    return {"train": trained, "worker_id": worker_id,
            "tokens": [r["tokens"] for r in results],
            "ttft_s": [r["ttft_s"] for r in results],
            "decode_tokens_per_s": [_decode_rate(r, new) for r in results],
            "actors": per_actor, "pool_up_s": pool_up_s,
            "serve_s": serve_s}


def platform_dag(rt, cfg, work: str, shape, serve_shape, device=None):
    """train -> serve as workflow steps: ``platform_train`` a num_gpus=1
    task, ``platform_serve`` a CPU task given its result."""
    import os

    @rt.remote(num_gpus=1)
    def platform_train_step(cfg, shape, ckpt, device):
        import chip_smoke

        return chip_smoke.platform_train(cfg, *shape,
                                         chip_smoke.PLATFORM_STEPS, ckpt,
                                         device)

    @rt.remote
    def platform_serve_step(trained, cfg, serve_shape, work, device):
        import chip_smoke

        return chip_smoke.platform_serve(trained, cfg, serve_shape, work,
                                         device)

    ckpt = os.path.join(work, "ckpt")
    return platform_serve_step.bind(
        platform_train_step.bind(cfg, tuple(shape), ckpt, device), cfg,
        tuple(serve_shape), work, device)


def platform_workflow(rt, work: str, workflow_id: str, mode: str, cfg,
                      shape=MAIN_SHAPE[:2], serve_shape=PLATFORM_SERVE,
                      device=None):
    """What the job's driver runs: with ``mode`` "fail", ``workflow.run``
    of ``platform_dag`` with the failure flag set (serve raises); with
    "resume", the flag removed and ``workflow.resume``."""
    import os

    from ray_tpu_torch import workflow

    flag = os.path.join(work, PLATFORM_FAILURE_FLAG)
    storage = os.path.join(work, "workflows")
    if mode == "fail":
        with open(flag, "w"):
            pass
        return workflow.run(
            platform_dag(rt, cfg, work, shape, serve_shape, device),
            workflow_id=workflow_id, storage=storage)
    check(mode == "resume", f"unknown mode {mode!r}")
    os.unlink(flag)
    return workflow.resume(workflow_id, storage=storage)


def platform_job(work: str, workflow_id: str, mode: str) -> int:
    """``chip_smoke.py platform-job``: the submitted job's driver. It joins
    the cluster through ``RAYTPU_ADDRESS`` (its raylet given no CPU), runs ``platform_workflow`` on
    ``bench_400m`` and writes what it saw (its result or error, its pid and
    whether torch initialized CUDA in it) to ``<work>/job_<mode>.json``."""
    import os

    import ray_tpu_torch as rt

    # the driver's own raylet offers nothing: the steps and the pool run on
    # the node that owns the card and outlives the job
    rt.init(num_cpus=0)
    out = {"pid": os.getpid(), "mode": mode}
    try:
        out["result"] = platform_workflow(rt, work, workflow_id, mode,
                                          library_cfg())
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        out["cuda_initialized"] = torch.cuda.is_initialized()
        with open(os.path.join(work, f"job_{mode}.json"), "w") as f:
            json.dump(out, f)
        rt.shutdown()
    return 0


def platform_engine(cfg, ckpt: str, prompts: list, new: int,
                    device=None) -> dict:
    """The in-process engine, built as a pool actor builds its own, serving
    the same requests one at a time as each actor does: tokens, TTFT and
    decode tokens/s per request."""
    from ray_tpu_torch.serve.llm import LLMEngine

    engine = LLMEngine(platform_params(cfg, ckpt, device), cfg,
                       device=device, **PLATFORM_ENGINE)
    out = {"tokens": [], "ttft_s": [], "decode_tokens_per_s": []}
    try:
        for p in prompts:
            t0 = time.perf_counter()
            toks, ttft = [], None
            for tok in engine.generate_stream(p, max_new_tokens=new):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.append(int(tok))
            r = {"ttft_s": ttft, "total_s": time.perf_counter() - t0}
            out["tokens"].append(toks)
            out["ttft_s"].append(ttft)
            out["decode_tokens_per_s"].append(_decode_rate(r, new))
    finally:
        engine.shutdown()
    return out


def platform_check_run(cfg, got: dict, want_metrics: list,
                       want_tokens: list, shape=PLATFORM_SERVE) -> None:
    """The checks the job's result must pass against this process's runs:
    the train step's metrics (losses, grad norms, steps) bit for bit, every
    token of the pool equal to the in-process engine's, each actor's share
    of the requests, and, on the card, the launches per replay and per
    decode step."""
    train = got["train"]
    n, _, new = shape
    check(all(np.isfinite(m[0]) for m in train["metrics"]),
          f"the job's losses {train['metrics']}")
    check([tuple(m) for m in train["metrics"]]
          == [tuple(m) for m in want_metrics],
          f"the job's train metrics {train['metrics']} differ from this "
          f"process's {want_metrics}")
    check(len(got["tokens"]) == n
          and all(len(t) == new for t in got["tokens"]),
          f"the pool served {[len(t) for t in got['tokens']]} tokens")
    check(got["tokens"] == want_tokens,
          "the pool's tokens differ from the in-process engine's: "
          f"{sum(a != b for a, b in zip(got['tokens'], want_tokens))} of "
          f"{n} requests")
    check(sum(a["requests"] for a in got["actors"]) == n
          and len(got["actors"]) == PLATFORM_POOL,
          f"the pool's actors served {got['actors']}")
    if train["device"].startswith("cuda"):
        want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
        check(tuple(train["launches_per_replay"].values()) == want,
              f"the job's train task launched flash fwd/dq/dkv "
              f"{train['launches_per_replay']} in a replay, not {want}")
        check(train["captures"] == 1, f"{train['captures']} captures")
        for a in got["actors"]:
            check(a["decode_steps"] > 0
                  and a["decode_steps_replayed"] == a["decode_steps"],
                  f"a pool actor ran {a['decode_steps']} decode steps, "
                  f"{a['decode_steps_replayed']} of them graph replays")
            check(a["decode_attention_launches"]
                  == cfg.n_layers * a["decode_steps"],
                  f"a pool actor: {a['decode_attention_launches']} decode "
                  f"attention launches over {a['decode_steps']} decode "
                  f"steps, not {cfg.n_layers} per step")


def _cli_command(addr: str, *args) -> tuple:
    """``python -m ray_tpu_torch.scripts --address <addr> <args>`` from the
    repo root, its output unbuffered: (argv, cwd, env)."""
    import os

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (":" + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.pop("RAYTPU_ADDRESS", None)
    env["PYTHONUNBUFFERED"] = "1"  # a job's id as soon as it is printed
    return ([sys.executable, "-m", "ray_tpu_torch.scripts", "--address",
             addr, *args], root, env)


def _cli(addr: str, *args, timeout: float = PLATFORM_JOB_TIMEOUT_S):
    """The CLI run to its end: (exit code, stdout, stderr)."""
    argv, cwd, env = _cli_command(addr, *args)
    p = subprocess.run(argv, cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def _submit(addr: str, entrypoint: str, client, timeout: float):
    """``job submit <entrypoint> --wait`` through the CLI, in the background:
    the job's id (the CLI's first line), the seconds from the submit to
    RUNNING, and the CLI's process."""
    import tempfile

    argv, cwd, env = _cli_command(addr, "job", "submit", entrypoint,
                                  "--wait")
    t0 = time.perf_counter()
    # stderr to a file: a pipe nobody reads while the job runs could fill
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    proc.err_file = err
    job_id = proc.stdout.readline().strip()
    check(job_id.startswith("raytpu_job_"),
          f"the CLI printed {job_id!r} for the job's id")
    deadline = time.monotonic() + timeout
    while client.get_job_status(job_id) == "PENDING":
        check(time.monotonic() < deadline, f"job {job_id} still PENDING")
        time.sleep(0.05)
    return job_id, time.perf_counter() - t0, proc


def _finish(proc, timeout: float) -> tuple:
    """A ``_submit`` CLI run to its end: (exit code, stdout, stderr)."""
    out, _ = proc.communicate(timeout=timeout)
    proc.err_file.seek(0)
    err = proc.err_file.read()
    proc.err_file.close()
    return proc.returncode, out, err


def _ppid(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _http(url: str, parse: bool = True):
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=60) as r:
        body = r.read()
    ms = (time.perf_counter() - t0) * 1e3
    return (json.loads(body) if parse else body.decode()), ms


@timed_phase
def phase_platform(cfg, here: dict = None, b: int = MAIN_SHAPE[0],
                   s: int = MAIN_SHAPE[1]) -> dict:
    """The platform phase (see the module docstring, 19). ``here``: the
    train phase's first ``PLATFORM_STEPS`` metrics and replay ms, when it
    ran; else the same steps are taken in this process."""
    import os
    import shutil
    import tempfile
    import uuid

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.worker import require_connected
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.util import state as rt_state

    check(not rt.is_initialized(), "the runtime is already up")
    if here is None:
        cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE,
                                    SEED + 2)
        here = gang_in_process(
            cfg, [cycle[i % TRAIN_CYCLE] for i in range(PLATFORM_STEPS)])
    want_metrics = [tuple(m) for m in here["metrics"]][:PLATFORM_STEPS]
    work = tempfile.mkdtemp(prefix="chip_smoke_platform_")
    wf_id = f"platform_{uuid.uuid4().hex[:8]}"
    script = str(Path(__file__).resolve())
    entry = f"{sys.executable} {script} platform-job {work} {wf_id}"
    driver = os.getpid()
    out = {"phase": "platform"}
    c = Cluster(initialize_head=True, head_node_args={
        "resources": {"CPU": PLATFORM_CPUS,
                      "GPU": torch.cuda.device_count()},
        "object_store_memory": PLATFORM_STORE_BYTES},
        system_config=PLATFORM_CONFIG, use_tcp=True)
    session = c.session_dir
    addr = c.gcs_address
    try:
        c.connect()
        gcs = require_connected().gcs
        deadline = time.monotonic() + 60  # the standby's first sync
        while True:
            st = gcs.call("internal_state", None, timeout=30)
            if st["standbys"] or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        check(st["epoch"] == 1 and st["standbys"] == 1,
              f"the primary at epoch {st['epoch']} with {st['standbys']} "
              "standbys")
        url = start_dashboard(port=0, host="127.0.0.1")
        client = JobSubmissionClient()
        # job 1: train, then the injected failure in serve
        job1, job1_running_s, proc = _submit(addr, entry + " fail", client,
                                             PLATFORM_JOB_TIMEOUT_S)
        rc1, cli_out, cli_err = _finish(proc, PLATFORM_JOB_TIMEOUT_S)
        check(rc1 == 1 and cli_out.split()[-1:] == ["FAILED"],
              f"job submit --wait of job 1 exited {rc1}: {cli_out!r} "
              f"{cli_err[-2000:]}")
        rc, status1, _ = _cli(addr, "job", "status", job1, timeout=120)
        check(rc == 0 and status1.strip() == "FAILED",
              f"job status of job 1: {rc} {status1!r}")
        rc, logs1, _ = _cli(addr, "job", "logs", job1, timeout=120)
        check(rc == 0 and "injected failure in the serve step" in logs1,
              f"job logs of job 1 lack the injected error: {logs1[-2000:]}")
        with open(os.path.join(work, "job_fail.json")) as f:
            job1_seen = json.load(f)
        # the CUDA-tensor rule: a step returning a CUDA tensor is refused
        # (run now, on the train step's worker, idle until job 2)
        @rt.remote(num_gpus=1)
        def platform_cuda_step():
            return torch.ones(2, device="cuda")

        storage = os.path.join(work, "rule")
        try:
            workflow.run(platform_cuda_step.bind(),
                         workflow_id="cuda_rule", storage=storage)
            refused = None
        except workflow.StepResultOnDeviceError as e:
            refused = str(e)
        stored = sorted(os.listdir(os.path.join(storage, "cuda_rule")))
        check(refused is not None and "cuda" in refused
              and not [n for n in stored if n.startswith("step_")]
              and workflow.get_status("cuda_rule", storage=storage)
              == "FAILED",
              f"a step returning a CUDA tensor: {refused!r}, stored {stored}")
        deadline = time.monotonic() + 15  # task events flush each ~1 s
        while True:
            train_tasks_job1 = len(rt_state.list_tasks(
                name="platform_train_step", state="FINISHED"))
            if train_tasks_job1 or time.monotonic() > deadline:
                break
            time.sleep(0.2)

        # job 2 resumes; the primary is SIGKILLed once serve has started
        _kv(gcs, PLATFORM_KEYS["handshake"], True)
        job2, job2_running_s, proc = _submit(addr, entry + " resume",
                                             client, PLATFORM_JOB_TIMEOUT_S)
        _kv_wait(gcs, PLATFORM_KEYS["serve"], PLATFORM_JOB_TIMEOUT_S)
        train_tasks_before_kill = len(rt_state.list_tasks(
            name="platform_train_step"))
        keys_before = {k: gcs.call("kv_get", k, timeout=30)
                       for k in gcs.call("kv_keys", "", timeout=30)}
        acked, stop = [], threading.Event()
        writer = rpc.Client.connect(addr, name="platform-acks")

        def put():
            k = 0
            while not stop.is_set():
                try:
                    if writer.call("kv_put", [f"platform:ack:{k}", b"d",
                                              True], timeout=20):
                        acked.append(k)
                except Exception:
                    pass  # not acked: allowed to be lost
                k += 1

        t = threading.Thread(target=put)
        t.start()
        time.sleep(0.5)  # writes in flight when the primary dies
        t_kill = time.perf_counter()
        c._impl.kill_gcs()
        while True:
            try:
                st = gcs.call("internal_state", None, timeout=5)
                break
            except Exception:
                check(time.perf_counter() - t_kill < 60,
                      "no GCS call served within 60 s of the SIGKILL")
        recover_s = time.perf_counter() - t_kill
        check(st["epoch"] == 2, f"after the SIGKILL the GCS serves at "
              f"epoch {st['epoch']}, not 2")
        time.sleep(PLATFORM_KILL_WRITES_S)
        stop.set()
        t.join(timeout=60)
        writer.close()
        # every write acknowledged before the kill reads back: the
        # writer's own (as written) and every key the KV held at the kill
        # (present; a job's record moves on)
        lost = [k for k in acked
                if gcs.call("kv_get", f"platform:ack:{k}", timeout=30)
                != b"d"]
        lost += [k for k in keys_before
                 if gcs.call("kv_get", k, timeout=30) is None]
        check(not lost and len(acked) > 0,
              f"{len(lost)} acknowledged keys lost across the failover "
              f"({len(acked)} acked writes): {lost[:10]}")

        # the pool is up: the card's shares, and no CUDA context but the
        # pool's and this process's
        up = _kv_wait(gcs, PLATFORM_KEYS["pool"], PLATFORM_JOB_TIMEOUT_S)
        actor_pids = [u["pid"] for u in up["pool"]]
        cards = [u["cards"] for u in up["pool"]]
        check(cards[0] == cards[1] and len(cards[0]["GPU"]) == 1,
              f"the pool's actors hold cards {cards}")
        deadline = time.monotonic() + 20
        while rt.available_resources().get("GPU", 0.0) != 0.0:
            check(time.monotonic() < deadline,
                  f"with both halves leased the cluster shows "
                  f"{rt.available_resources()} available")
            time.sleep(0.2)

        @rt.remote(num_gpus=1)
        def platform_probe():
            return "ran"

        probe = platform_probe.remote()
        ready, _ = rt.wait([probe], timeout=3)
        check(not ready, "a num_gpus=1 lease ran while the pool's two "
              "halves held the card")
        rt.cancel(probe)
        actors_api, actors_ms = _http(url + "/api/actors")
        pool_rows = [a for a in actors_api
                     if a["name"].startswith("LLMServer-")
                     and a["state"] == "ALIVE"]
        check(len(pool_rows) == PLATFORM_POOL
              and all(a["resources"].get("GPU") == PLATFORM_POOL_GPUS
                      and a["accelerator_ids"] == cards[0]
                      for a in pool_rows),
              f"/api/actors shows the pool as {pool_rows}")
        node_id = c._impl.head_node.node_id.hex()
        detail, node_ms = _http(url + f"/api/node/{node_id}")
        check(detail["stats"]["gpu_cards"]["free"] == [0.0],
              f"the card's free share with the pool up: "
              f"{detail['stats']['gpu_cards']}")
        info2 = client.get_job_info(job2)
        supervisor = _ppid(info2["pid"])
        # the processes that may hold a CUDA context now: this one, the
        # pool's, and the train step's worker while it lives on, idle
        apps = _compute_app_pids()
        gpu_pids = {driver, *actor_pids}
        if _pid_alive(up["train_pid"]):
            gpu_pids.add(up["train_pid"])
        contexts = {
            "nvidia_smi": apps, "expected": sorted(gpu_pids),
            "pool": actor_pids, "train_worker": up["train_pid"],
            "supervisor": supervisor, "job_process": info2["pid"]}
        _kv(gcs, PLATFORM_KEYS["sampled"], True)

        rc2, cli_out, cli_err = _finish(proc, PLATFORM_JOB_TIMEOUT_S)
        check(rc2 == 0 and cli_out.split()[-1:] == ["SUCCEEDED"],
              f"job submit --wait of job 2 exited {rc2}: {cli_out!r} "
              f"{cli_err[-2000:]}")
        rc, status2, _ = _cli(addr, "job", "status", job2, timeout=120)
        check(rc == 0 and status2.strip() == "SUCCEEDED",
              f"job status of job 2 after the failover: {rc} {status2!r}")
        rc, logs2, _ = _cli(addr, "job", "logs", job2, timeout=120)
        check(rc == 0 and "Traceback" not in logs2,
              f"job logs of job 2: {rc} {logs2[-2000:]}")
        rc, status1b, _ = _cli(addr, "job", "status", job1, timeout=120)
        check(rc == 0 and status1b.strip() == "FAILED",
              f"job 1's record after the failover: {rc} {status1b!r}")
        with open(os.path.join(work, "job_resume.json")) as f:
            job2_seen = json.load(f)
        got = job2_seen["result"]
        train_tasks_after_kill = len(rt_state.list_tasks(
            name="platform_train_step"))
        check(train_tasks_job1 == 1 and train_tasks_before_kill
              + train_tasks_after_kill == 1,
              f"train tasks: {train_tasks_job1} after job 1, "
              f"{train_tasks_before_kill} at the SIGKILL, "
              f"{train_tasks_after_kill} after it: not one in all")
        check(not job1_seen["cuda_initialized"]
              and not job2_seen["cuda_initialized"],
              "torch initialized CUDA in a job's driver")
        # nvidia-smi names this machine's pids only where it shares the
        # pid namespace; elsewhere it lists one entry per context all the
        # same, so the count must be the expected processes' count: one
        # more would be a context in the job's driver or its supervisor
        # (a process that imports torch maps the CUDA driver library
        # without holding a context, so its maps say nothing)
        same_ns = bool(set(apps) & gpu_pids)
        contexts["pid_namespace_shared"] = same_ns
        contexts["job_driver"] = job2_seen["pid"]
        check(len(apps) == len(gpu_pids)
              and (not same_ns or set(apps) == gpu_pids),
              f"CUDA contexts with the pool up: {contexts}")

        # the dashboard after the jobs
        jobs, jobs_ms = _http(url + "/api/jobs")
        by_id = {j["job_id"]: j["status"] for j in jobs["submissions"]}
        check(by_id.get(job1) == "FAILED" and by_id.get(job2) == "SUCCEEDED",
              f"/api/jobs shows {by_id}")
        served = sum(len(tk) for tk in got["tokens"])
        api_metrics, metrics_ms = _http(url + "/api/metrics")
        counted = sum(api_metrics["platform_tokens"]["values"].values())
        prom, prom_ms = _http(url + "/metrics", parse=False)
        prom_counted = sum(
            float(line.rsplit(" ", 1)[1]) for line in prom.splitlines()
            if line.startswith("platform_tokens{"))
        check(counted == served == prom_counted,
              f"the token counter reads {counted} (/api/metrics) and "
              f"{prom_counted} (/metrics); the pool served {served}")
        deadline = time.monotonic() + 30
        while True:
            detail, _ = _http(url + f"/api/node/{node_id}")
            if detail["stats"]["gpu_cards"]["free"] == [1.0]:
                break
            check(time.monotonic() < deadline,
                  f"the card's free share after the job: "
                  f"{detail['stats']['gpu_cards']}")
            time.sleep(0.2)
        log_tail, log_ms = _http(
            url + f"/api/logs?node={node_id[:12]}"
            f"&proc=worker-{got['worker_id'][:12]}&tail=65536")
        check("platform serve: " in log_tail.get("data", ""),
              f"the serve step's worker log, tailed through the raylet: "
              f"{str(log_tail)[-1000:]}")

        # the in-process references: the engine from the same checkpoint
        prompts = platform_prompts(cfg, *PLATFORM_SERVE[:2])
        engine = platform_engine(cfg, got["train"]["ckpt"], prompts,
                                 PLATFORM_SERVE[2])
        platform_check_run(cfg, got, want_metrics, engine["tokens"])

        live = _session_pids(session)
    finally:
        stop_dashboard()
        c.shutdown()
        try:
            rt.shutdown()
        except Exception:
            pass
        shutil.rmtree(work, ignore_errors=True)
    deadline = time.monotonic() + PLATFORM_SHUTDOWN_S
    while _session_pids(session) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _session_pids(session)
    check(not left, f"session processes left after shutdown: {left}")
    train = got["train"]
    out.update({
        "jobs": {"job1": {"id": job1, "submit_to_running_s": job1_running_s,
                          "cli_rc": rc1, "status": "FAILED"},
                 "job2": {"id": job2, "submit_to_running_s": job2_running_s,
                          "cli_rc": rc2, "status": "SUCCEEDED"}},
        "failover": {"time_to_recover_s": recover_s, "epoch_after": 2,
                     "acked_writes": len(acked),
                     "keys_before_kill": len(keys_before), "acks_lost": 0},
        "train_tasks": {"job1": train_tasks_job1,
                        "at_kill": train_tasks_before_kill,
                        "after_kill": train_tasks_after_kill},
        "train": {k: train[k] for k in (
            "pid", "device", "visible", "metrics", "step_ms", "replay_ms",
            "launches_per_replay", "profile_launch_readings", "captures",
            "replays", "save_s", "ckpt_bytes", "peak_memory_bytes")},
        "replay_ms": {"job_task": train["replay_ms"],
                      "in_process": here["replay_ms"]},
        "train_metrics_equal_in_process_bit_for_bit": True,
        "pool": {"actors": got["actors"], "pool_up_s": got["pool_up_s"],
                 "serve_s": got["serve_s"],
                 "ttft_s_median": float(np.median(got["ttft_s"])),
                 "decode_tokens_per_s_median": float(np.median(
                     got["decode_tokens_per_s"])),
                 "decode_attention_launches_per_decode_step":
                     got["actors"][0]["decode_attention_launches"]
                     // got["actors"][0]["decode_steps"]},
        "in_process_engine": {
            "ttft_s_median": float(np.median(engine["ttft_s"])),
            "decode_tokens_per_s_median": float(np.median(
                engine["decode_tokens_per_s"]))},
        "pool_tokens_equal_in_process": True,
        "tokens_counted": counted,
        "dashboard_ms": {"actors": actors_ms, "node": node_ms,
                         "jobs": jobs_ms, "metrics": metrics_ms,
                         "prometheus": prom_ms},
        "cuda_tensor_rule": refused,
        "contexts_with_pool_up": contexts,
        "session_processes_before_shutdown": len(live)})
    emit(out)
    return out


MULTICARD_DATA_FILES = 32


def _multicard_data_loop(config):
    """A ``TorchTrainer`` worker of ``multicard_data``: its shard's batches
    landed on its card; reports each batch's first token column and the
    card it ran on."""
    import os

    from ray_tpu_torch.train import session

    it = session.get_dataset_shard("train")
    firsts = []
    for batch in it.iter_device_batches(batch_size=MAIN_SHAPE[0]):
        check(batch["tokens"].device == torch.device("cuda", 0),
              f"a batch on {batch['tokens'].device}")
        firsts.append(batch["tokens"][:, 0].tolist())
    session.report({"rank": session.get_world_rank(), "firsts": firsts,
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "uuid": str(torch.cuda.get_device_properties(0).uuid)})


def multicard_data() -> dict:
    """A dp 4 ``TorchTrainer`` with ``datasets=`` over
    ``MULTICARD_DATA_FILES`` token files (``bench_400m``'s batch shape):
    every row reaches exactly one rank, the ranks run on four distinct
    cards, and rank r's batches are the blocks with ``idx % 4 == r`` (the
    coordinator deals blocks in output order)."""
    import os
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = TransformerConfig.bench_400m()
    b, s = MAIN_SHAPE[:2]
    cycle = numpy_train_batches(cfg.vocab_size, b, s, MULTICARD_DATA_FILES,
                                SEED + 11)
    work = tempfile.mkdtemp(prefix="chip_smoke_mc_data_")
    files = os.path.join(work, "tokens")
    os.makedirs(files)
    write_token_files(cycle, MULTICARD_DATA_FILES, files)
    seen = {}

    class Collect(TorchTrainer):
        def _drain(self, group):
            done = [False] * group.num_workers
            while not all(done):
                for rank, p in enumerate(group.poll_all(timeout=10.0)):
                    for ev in p["events"]:
                        seen[rank] = ev["metrics"]
                    if p["done"]:
                        check(p["error"] is None, f"rank {rank}: "
                              f"{p.get('error_tb')}")
                        done[rank] = True
            return {}

    t0 = time.perf_counter()
    rt.init(object_store_memory=DATA_STORE_BYTES)
    try:
        Collect(_multicard_data_loop,
                scaling_config=ScalingConfig(num_workers=MULTICARD_WORLD,
                                             use_gpu=True),
                run_config=RunConfig(name="mc_data",
                                     storage_path=os.path.join(work, "r")),
                datasets={"train": token_dataset(
                    files, MULTICARD_DATA_FILES)}).fit()
    finally:
        rt.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    check(sorted(seen) == list(range(MULTICARD_WORLD)), f"ranks {list(seen)}")
    uuids = {seen[r]["uuid"] for r in seen}
    check(len(uuids) == MULTICARD_WORLD, f"the ranks ran on {uuids}")
    for r in range(MULTICARD_WORLD):
        want = [cycle[i]["tokens"][:, 0].tolist()
                for i in range(MULTICARD_DATA_FILES)
                if i % MULTICARD_WORLD == r]
        check(seen[r]["firsts"] == want,
              f"rank {r}'s batches are not the blocks idx % "
              f"{MULTICARD_WORLD} == {r}")
    out = {"phase": "multicard_data", "files": MULTICARD_DATA_FILES,
           "ranks": MULTICARD_WORLD,
           "visible": [seen[r]["visible"] for r in range(MULTICARD_WORLD)],
           "batches_per_rank": [len(seen[r]["firsts"])
                                for r in range(MULTICARD_WORLD)],
           "every_row_once": True, "distinct_cards": len(uuids),
           "wall_s": time.perf_counter() - t0}
    emit(out)
    return out


def multicard_mesh_group() -> dict:
    """``bench_400m`` in a MeshGroup over two simulated hosts of two cards
    each (``cluster_utils.Cluster``: each node starts with its own two
    cards), ``{"dp": 2, "tp": 2}``: 4 steps, a checkpoint, SIGKILL of rank
    1's process (``RankFailedError`` must name rank 1), ``recover(mesh_shape=
    {"dp": 4, "tp": 1})`` and 4 more steps; then the checkpoint restored
    again into the recovered gang and the same 4 steps retaken. Checks:
    four distinct cards (device uuids) before and after the recovery; every
    loss within ``MESH_LOSS_RTOL`` of the same steps on one card in this
    process; the resumed losses equal to the uninterrupted continuation's
    within ``GANG_CONTINUATION_RTOL``."""
    import shutil
    import tempfile

    from ray_tpu_torch._private.protocol import LABEL_HOST
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig.bench_400m()
    cycle = numpy_train_batches(cfg.vocab_size, MAIN_SHAPE[0], MAIN_SHAPE[1],
                                TRAIN_CYCLE, SEED + 2)
    batches = [cycle[i % TRAIN_CYCLE] for i in range(GANG_STEPS)]
    one = gang_in_process(cfg, batches)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_gang4_")
    c = Cluster(initialize_head=True,
                head_node_args={"resources": {"CPU": 2},
                                "object_store_memory": GANG_STORE_BYTES})
    try:
        for h in range(2):
            c.add_node(num_cpus=3, num_gpus=2, labels={LABEL_HOST: f"h{h}"},
                       object_store_memory=GANG_STORE_BYTES)
        c.connect()
        run = gang_run(cfg, batches, hosts=2, per_host=2,
                       shape={"dp": 2, "tp": 2},
                       resources={"CPU": 2, "GPU": 2}, kill_rank=1,
                       ckpt=ckpt, recover_shape={"dp": 4, "tp": 1},
                       continuation=True)
    finally:
        c.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
    for key in ("members", "members_after"):
        uuids = [m["device_uuid"] for m in run[key]]
        check(len(set(uuids)) == 4 and all(uuids),
              f"{key}: the gang's ranks ran on cards {uuids}")
    check(run["failure"] is not None and run["failure"]["rank"] == 1
          and run["failure"]["epoch"] == 1,
          f"after rank 1's SIGKILL: {run['failure']}")
    check(run["restored_step"] == GANG_SAVE_AFTER and run["epoch"] == 2
          and run["mesh_after"] == {"dp": 4, "tp": 1},
          f"recover(): step {run['restored_step']}, epoch {run['epoch']}, "
          f"mesh {run['mesh_after']}")
    losses = [m[0] for m in run["metrics"]]
    one_card = [m[0] for m in one["metrics"]]
    rel = [abs(g - r) / abs(r) for g, r in zip(losses, one_card)]
    check(all(np.isfinite(losses)) and max(rel) <= MESH_LOSS_RTOL,
          f"gang losses {losses} against one card {one_card}")
    resumed = losses[GANG_SAVE_AFTER:]
    cont = [m[0] for m in run["continuation"]]
    cont_rel = [abs(g - r) / abs(r) for g, r in zip(resumed, cont)]
    check(max(cont_rel) <= GANG_CONTINUATION_RTOL,
          f"resumed losses {resumed} against the continuation {cont}")
    before = _gang_launches(run["stats_before"], want)
    after = _gang_launches(run["stats_after"], want)
    out = {"phase": "multicard_mesh_group",
           "bring_up_s": run["bring_up_s"], "state_init_s":
               run["state_init_s"],
           "members": [{k: m[k] for k in ("rank", "host", "node_id",
                                          "visible", "device_uuid")}
                       for m in run["members"]],
           "members_after": [{k: m[k] for k in ("rank", "host", "node_id",
                                                "visible", "device_uuid")}
                             for m in run["members_after"]],
           "plan_paths": run["plan_paths"],
           "losses": losses, "one_card_losses": one_card,
           "loss_rel_diff": rel, "continuation_losses": cont,
           "continuation_rel_diff": cont_rel,
           "launches_per_step": before["launches_per_replay"],
           "launches_per_step_after_recover": after["launches_per_replay"],
           "launch_readings": [before["profile_launch_readings"],
                               after["profile_launch_readings"]],
           "replay_ms": before["replay_ms"],
           "replay_ms_after_recover": after["replay_ms"],
           "replay_ms_continuation": [
               c["ms"] for c in run["stats_continuation"][0]["calls"][
                   GANG_PROFILE_CALL:]],
           "device_ms_by_kind": before["profiled_device_ms_by_kind"],
           "device_ms_by_kind_after_recover":
               after["profiled_device_ms_by_kind"],
           "entry_skew_ms": _gang_skew_ms(run["stats_before"]),
           "entry_skew_ms_after_recover": _gang_skew_ms(
               run["stats_continuation"]),
           "replay_ms_by_rank_continuation": [
               [c["ms"] for c in r["calls"][GANG_PROFILE_CALL:]]
               for r in run["stats_continuation"]],
           "one_card_replay_ms": one["replay_ms"],
           "save_state_s": run["save_state_s"], "failure": run["failure"],
           "failure_s": run["failure_s"], "recover_s": run["recover_s"],
           "mesh_after": run["mesh_after"]}
    emit(out)
    return out


def _dp_close(one, four, grads, lr: float) -> float:
    """Leaf by leaf, the dp 4 parameters against one learner's after one
    update (RL_DP_PARAM_TOL), but an element whose gradient is float noise
    (within 1e-5 of its leaf's largest) only within 2 lr. Returns the
    largest difference."""
    from ray_tpu_torch.rllib.models import tree_leaves

    rtol, atol = RL_DP_PARAM_TOL
    worst = 0.0
    for a, b, g in zip(tree_leaves(one), tree_leaves(four), grads):
        a, b, g = _f64(a), _f64(b), _f64(g).abs()
        noise = g <= 1e-5 * g.max()
        bound = torch.where(noise, torch.full_like(a, 2 * lr),
                            atol + rtol * a.abs())
        d = (a - b).abs()
        check(bool((d <= bound).all()),
              f"dp 4 differs from one learner by {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def multicard_rl() -> dict:
    """IMPALA's learner over four learner actors, one card each
    (``LearnerGroup(num_learners=4)``, NCCL): the learners on four distinct
    cards; the dp 4 update on one [4, 256] MinAtar-Breakout batch against
    one learner's in this process (``RL_DP_*``); then IMPALA with 4 workers
    and 4 learners for ``RL_ASYNC_ITERS`` async iterations."""
    import functools

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import IMPALAConfig
    from ray_tpu_torch.rllib.impala import make_impala_loss
    from ray_tpu_torch.rllib.learner_group import LearnerGroup
    from ray_tpu_torch.rllib.models import (grads_of, init_actor_critic,
                                            to_device, trainable,
                                            tree_leaves)

    n = torch.cuda.device_count()
    check(n >= 4, f"multicard_rl needs 4 cards; {n} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    started = time.perf_counter()
    cfg = IMPALAConfig(env=RL_ENV, num_workers=4, num_learners=4)
    rng = np.random.default_rng(SEED + 50)
    shape = (4, 256)
    batch = {
        "obs": rng.random((*shape, RL_OBS)).astype(np.float32),
        "actions": rng.integers(0, RL_ACTIONS, shape).astype(np.int32),
        "logp": np.log(rng.uniform(0.2, 0.5, shape)).astype(np.float32),
        "rewards": rng.random(shape).astype(np.float32),
        "next_values": rng.random(shape).astype(np.float32),
        "terminals": np.zeros(shape, np.float32),
        "cuts": np.zeros(shape, np.float32),
    }
    params = init_actor_critic(SEED, RL_OBS, RL_ACTIONS, device="cpu")
    loss_fn = make_impala_loss(cfg)
    adam = functools.partial(torch.optim.Adam, lr=cfg.lr)
    card = torch.device("cuda", 0)
    p0 = trainable(params, card)
    g0 = grads_of(loss_fn(p0, to_device(batch, card)), tree_leaves(p0))
    info = rt.init(object_store_memory=RL_STORE_BYTES)
    try:
        check(rt.cluster_resources().get("GPU") == 4,
              f"init granted {rt.cluster_resources()}")
        one = LearnerGroup(loss_fn, params, adam, num_learners=1)
        t0 = time.perf_counter()
        four = LearnerGroup(loss_fn, params, adam, num_learners=4)
        bring_up_s = time.perf_counter() - t0
        try:
            uuids = [i["uuid"] for i in four.learner_info]
            check(len(set(uuids)) == 4 and all(
                i["device"] == "cuda:0" for i in four.learner_info),
                f"learners on {four.learner_info}")
            l1, l4 = one.update(batch), four.update(batch)
            check(abs(l1 - l4) <= RL_DP_LOSS_RTOL * max(1.0, abs(l1)),
                  f"dp 4 loss {l4} against one learner's {l1}")
            worst = _dp_close(one.get_params_host(),
                              four.get_params_host(), g0, cfg.lr)
            times = {}
            for name, group in (("one", one), ("four", four)):
                t0 = time.perf_counter()
                group.update(batch)
                times[name] = (time.perf_counter() - t0) * 1e3
        finally:
            four.shutdown()
        algo = cfg.build()
        try:
            results = [algo.train() for _ in range(RL_ASYNC_ITERS)]
            learners = algo.learners.learner_info
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    left = _session_gone(info["session_dir"])
    check(not left, f"session processes left after shutdown: {left}")
    last = results[-1]
    check(len({i["uuid"] for i in learners}) == 4,
          f"IMPALA's learners on {learners}")
    check(last["num_async_updates"] == RL_ASYNC_ITERS
          and last["num_env_steps"] == RL_ASYNC_ITERS * 4 * 256
          and all(np.isfinite(r["loss"]) for r in results),
          f"IMPALA x4 learners: {results}")
    out = {"phase": "multicard_rl", "learner_uuids": uuids,
           "dp1_loss": l1, "dp4_loss": l4, "dp4_max_abs_param_err": worst,
           "learner_bring_up_s": bring_up_s,
           "update_ms": times, "impala_losses": [r["loss"] for r in results],
           "num_async_updates": last["num_async_updates"],
           "num_env_steps": last["num_env_steps"],
           "phase_s": time.perf_counter() - started}
    emit(out)
    return out


# The projection phase's anchor step: GPT-J-6B at full width, at the depth
# of one stage of the projected layout (28 layers over pp 4), trained at
# [4, 2048]: one eager step, the capture, then PROJECTION_REPLAYS replays.
PROJECTION_LAYERS = 7
PROJECTION_SHAPE = (4, 2048)
PROJECTION_REPLAYS = 4
PROJECTION_EAGER_STEPS = 3  # eager steps held against the captured ones
PROJECTION_PROBE_BAND = 0.10  # tests/test_projection.py:84's band around 1


def anchor_mfu(cfg, b: int, s: int, replay_ms: list) -> float:
    """The MFU the projection composes: ``analytic_train_flops`` (no
    embedding) of one step at [b, s] over the mean replay time, against
    the card's dense bf16 peak."""
    from ray_tpu_torch.parallel.projection import analytic_train_flops

    return (analytic_train_flops(cfg, b * s, s)
            / (float(np.mean(replay_ms)) / 1e3) / PEAK_BF16_FLOPS)


@timed_phase
def phase_projection(here: dict) -> dict:
    """The projection phase (see the module docstring, 20). ``here``: the
    train phase's replay ms (``bench_400m`` at [8, 2048])."""
    import dataclasses as dc

    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )
    from ray_tpu_torch.parallel.projection import (
        GPTJ_STAGE_MFU,
        project_h100_pod,
        run_probe,
    )

    cfg = dc.replace(TransformerConfig.gptj_6b(), n_layers=PROJECTION_LAYERS,
                     attn_impl="flash", remat=True, remat_policy="dots")
    b, s = PROJECTION_SHAPE
    want = tuple(flash_want(cfg).values())
    batches = [{k: torch.from_numpy(v).cuda() for k, v in batch.items()}
               for batch in numpy_train_batches(cfg.vocab_size, b, s,
                                                TRAIN_CYCLE, SEED + 2)]

    def counters():
        return (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED)
    step = make_train_step(cfg, opt)
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    metrics, events = [], []
    for i in range(2 + PROJECTION_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batches[i % TRAIN_CYCLE])
        end.record()
        metrics.append(m)
        events.append((start, end))
        if i == 0:
            torch.cuda.synchronize()
            eager_counts = counters()
        elif i == 1:
            torch.cuda.synchronize()
            capture_counts = counters()
    torch.cuda.synchronize()
    run_counts = counters()
    peak = torch.cuda.max_memory_allocated()
    check(eager_counts == want and capture_counts == tuple(2 * w for w in want)
          and run_counts == capture_counts,
          f"flash wrapper counts: eager step {eager_counts}, after capture "
          f"{capture_counts}, after the replays {run_counts} (want {want} per "
          "eager or captured step, none per replay)")
    check(step.captures == 1 and step.replays == 1 + PROJECTION_REPLAYS,
          f"{step.captures} captures, {step.replays} replays")
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses}, {norms}")
    step_ms = [a.elapsed_time(e) for a, e in events]
    replay_ms = step_ms[2:]
    prof = profile_launches(lambda: step(state, batches[0]), TRAIN_KINDS,
                            dict(zip(FLASH_KINDS, want)))
    per_replay = tuple(prof["launches_by_kind"][k] for k in FLASH_KINDS)
    check(per_replay == want, f"one replay launched flash fwd/dq/dkv "
          f"{per_replay} times, not {want}")
    captured = [_metric(m) for m in metrics[:PROJECTION_EAGER_STEPS]]
    del state, step, opt, metrics, m
    torch.cuda.empty_cache()

    # Eager steps from a state of the same seed against the captured ones.
    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED)
    step = make_train_step(cfg, opt)
    eager = [_metric(step.eager(state, batches[i])[1])
             for i in range(PROJECTION_EAGER_STEPS)]
    check(eager == captured, f"eager steps {eager} != captured (1: eager "
          f"warm-up, 2: first captured, 3: replay) {captured}")
    del state, step, opt, batches
    torch.cuda.empty_cache()

    probe = run_probe()
    ratio = probe["measured_over_analytic"]
    check(abs(ratio - 1.0) <= PROJECTION_PROBE_BAND,
          f"the probe's measured/analytic FLOPs {ratio} is not within "
          f"{PROJECTION_PROBE_BAND} of 1: {probe}")
    torch.cuda.empty_cache()

    mfu = anchor_mfu(cfg, b, s, replay_ms)
    bench = TransformerConfig.bench_400m()
    mfu_400m = anchor_mfu(bench, MAIN_SHAPE[0], MAIN_SHAPE[1],
                          here["replay_ms"])
    card = (f"{torch.cuda.get_device_name(0)}, "
            f"{_power_limit()} (this run)")
    proj = project_h100_pod(efficiency_anchor=mfu, extracted=probe)
    proj_400m = project_h100_pod(efficiency_anchor=mfu_400m, extracted=probe)
    out = {"phase": "projection",
           "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "d_head": cfg.d_head,
                      "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
                      "rotary_dim": cfg.rotary_dim,
                      "params": cfg.param_count()},
           "batch": [b, s], "losses": losses, "grad_norms": norms,
           "step_ms": step_ms, "replay_ms": replay_ms,
           "replay_ms_mean": float(np.mean(replay_ms)),
           "tokens_per_s": b * s / float(np.mean(replay_ms)) * 1e3,
           "mfu": mfu, "mfu_basis": "analytic_train_flops over 989 TFLOP/s",
           "mfu_in_code": GPTJ_STAGE_MFU,
           "bench_400m_mfu": mfu_400m,
           "peak_memory_bytes": peak,
           "launches_per_step": dict(zip(FLASH_KINDS, per_replay)),
           "launch_readings": prof["launch_readings"],
           "wrapper_counts": {"eager_step": eager_counts,
                              "after_capture": capture_counts,
                              "after_replays": run_counts},
           "eager_vs_captured": {"eager": eager, "captured": captured,
                                 "bit_equal": True},
           "device_ms_by_kind": prof.get("device_ms_by_kind"),
           "probe": {k: probe[k] for k in (
               "measured_over_analytic", "flops_per_device",
               "measured_flops_total", "analytic_flops_total", "flops_by_op",
               "flops_basis", "devices", "batch_size", "seq")},
           "projection": {k: v for k, v in proj.items()},
           "anchor_basis": f"this run's GPT-J-width stage step, {card}",
           "projection_400m_anchor": {
               "anchor_basis": f"this run's bench_400m train replays at "
                               f"[8, 2048], {card}",
               **{k: proj_400m[k] for k in (
                   "efficiency_anchor", "t_compute_s", "t_step_s",
                   "tokens_per_s", "projected_mfu")}}}
    emit(out)
    return out


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# The micro phase: ray_perf's legs at ``ray_perf.main``'s sizes, each in a
# process of its own, on the CPU (the gang legs' ranks are gloo ranks).
MICRO_TIMEOUT_S = 300  # one leg's subprocess
MICRO_DAEMONS = "ray_tpu_torch._private."  # in every daemon's command line
# Set in this process's environment when the run starts, and so inherited
# by every process it starts: the micro phase's leak checks look only at
# processes that carry it, not at the port's daemons of another run on the
# machine.
RUN_VAR = "CHIP_SMOKE_RUN"


def run_mark() -> str:
    """This run's ``RUN_VAR=value`` environment entry, set on first use."""
    os.environ.setdefault(RUN_VAR, f"{os.getpid()}.{time.time_ns()}")
    return f"{RUN_VAR}={os.environ[RUN_VAR]}"
MICRO_DATA_ROWS = 16 * 4096  # the data plane leg's N_BLOCKS * ROWS_PER


@timed_phase
def phase_micro() -> dict:
    """The micro phase (see the module docstring, 21)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import ray_perf, rpc
    from ray_tpu_torch._private.worker import require_connected

    check(not rt.is_initialized(), "the runtime is already up")
    mark = run_mark()
    check(not _session_gone(MICRO_DAEMONS, mark),
          "a daemon of the port started by this run is alive")
    seconds = {}

    # ping on the three planes of a session of this process
    t0 = time.perf_counter()
    info = rt.init(num_cpus=2, num_gpus=0)
    try:
        @rt.remote(num_cpus=1)
        class Addr:
            def addr(self):
                from ray_tpu_torch._private.worker import global_worker

                return global_worker.core_worker.my_addr

        actor = Addr.remote()
        pongs = {"gcs": require_connected().gcs.call("ping", None,
                                                     timeout=30)}
        for name, addr in (("raylet", rt.nodes()[0]["raylet_addr"]),
                           ("worker", rt.get(actor.addr.remote(),
                                             timeout=120))):
            cli = rpc.Client.connect(addr, name=f"micro-{name}")
            try:
                pongs[name] = cli.call("ping", None, timeout=30)
            finally:
                cli.close()
        rt.kill(actor)
    finally:
        rt.shutdown()
    left = {"ping": _session_gone(info["session_dir"])}
    seconds["ping"] = time.perf_counter() - t0
    check(pongs == {"gcs": "pong", "raylet": "pong", "worker": "pong"},
          f"ping on the three planes: {pongs}")

    # run_microbenchmarks at main's sizes, through the module's entry point
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "RAYTPU_ADDRESS"}
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._private.ray_perf"],
        capture_output=True, text=True, timeout=MICRO_TIMEOUT_S, env=env,
        cwd=str(Path(__file__).resolve().parent))
    check(proc.returncode == 0, f"python -m ray_tpu_torch._private.ray_perf "
          f"exited {proc.returncode}: {proc.stderr[-2000:]}")
    legs = {"microbenchmarks": json.loads(proc.stdout)}
    seconds["microbenchmarks"] = time.perf_counter() - t0
    left["microbenchmarks"] = _session_gone(MICRO_DAEMONS, mark)
    micro = legs["microbenchmarks"]
    check("transfer_error" not in micro,
          f"the transfer leg failed: {micro.get('transfer_error')}")
    check(all(micro[k] > 0 for k in (
        "tasks_per_s", "actor_calls_per_s", "actor_calls_pipelined_per_s",
        "put_gbps", "get_gbps", "transfer_gbps", "transfer_socket_gbps"))
          and micro["task_inline_hits"] >= 0
          and micro["task_inline_bytes"] >= 0, f"microbenchmarks: {micro}")

    # the host-plane legs (the transfer leg ran inside run_microbenchmarks)
    # and the gang legs, their ranks gloo ranks on the CPU
    for name, leg in (("broadcast", ray_perf.run_broadcast_bench),
                      ("gcs_plane", ray_perf.run_gcs_plane_bench),
                      ("gcs_failover", ray_perf.run_gcs_failover_bench),
                      ("serving_scale", ray_perf.run_serving_scale_bench),
                      ("mesh_group", functools.partial(
                          ray_perf.run_mesh_group_bench, device="cpu")),
                      ("mesh_heal", functools.partial(
                          ray_perf.run_mesh_heal_bench, device="cpu")),
                      ("data_plane", functools.partial(
                          ray_perf.run_data_plane_bench, device="cpu"))):
        t0 = time.perf_counter()
        legs[name] = leg()
        seconds[name] = time.perf_counter() - t0
        left[name] = _session_gone(MICRO_DAEMONS, mark)
    check(not any(left.values()), f"processes left after a leg: {left}")
    fo = legs["gcs_failover"]
    check(fo["acks_lost"] == 0 and fo["total_acked"] > 0
          and fo["post_failover_epoch"] == 2,
          f"the failover lost acknowledged writes: {fo}")
    check(legs["mesh_heal"]["outcome"] == "healed",
          f"the gang did not heal: {legs['mesh_heal']}")
    rows = legs["data_plane"]["rows"]
    check(rows == MICRO_DATA_ROWS, f"the data plane's gang took {rows} rows, "
          f"not {MICRO_DATA_ROWS}")
    check(legs["mesh_group"]["devices"] == ["cpu"] * 4
          and legs["mesh_group"]["cards"] == [None] * 4,
          f"the gang's ranks ran on {legs['mesh_group']['devices']}")
    out = {"phase": "micro", "pong": pongs, "legs": legs,
           "leg_seconds": seconds}
    emit(out)
    return out



def multicard_micro() -> dict:
    """``run_mesh_group_bench`` and ``run_data_plane_bench`` with their
    ranks on the cards (NCCL): four and two cards."""
    from ray_tpu_torch._private import ray_perf

    group = ray_perf.run_mesh_group_bench(device="cuda")
    data = ray_perf.run_data_plane_bench(device="cuda")
    # each rank sees its own card as cuda:0; their uuids tell them apart
    check(group["devices"] == ["cuda:0"] * 4
          and len(set(group["cards"])) == 4 and all(group["cards"]),
          f"the gang's ranks ran on {group['devices']}, cards "
          f"{group['cards']}")
    check(data["rows"] == MICRO_DATA_ROWS and data["device"] == "cuda"
          and len(set(data["cards"])) == 2 and all(data["cards"]),
          f"the data plane's gang: {data}")
    out = {"phase": "multicard_micro", "mesh_group": group,
           "data_plane": data}
    emit(out)
    return out


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "platform-job":
        # a submitted job's driver: before any CUDA call, as it makes none
        return platform_job(*argv[1:])
    rank = len(argv) == 4 and argv[0] == "multicard-rank"
    if not rank and argv not in (
            [], ["kernel"], ["decode_kernel"], ["serve_7b"], ["train"],
            ["inference"], ["mesh"], ["moe"], ["seq"], ["pipe"], ["runtime"],
            ["mesh_group"], ["data"], ["tune"], ["rl"], ["platform"],
            ["projection"], ["micro"], ["multicard"]):
        print("usage: chip_smoke.py [kernel | decode_kernel | serve_7b | "
              "train | inference | mesh | moe | seq | pipe | runtime | "
              "mesh_group | data | tune | rl | platform | projection | "
              "micro | multicard]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs on the "
              "card only", file=sys.stderr)
        return 1
    cache_bytecode()
    run_mark()
    if rank:
        multicard_rank(int(argv[1]), int(argv[2]), argv[3])
        return 0
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if argv == ["decode_kernel"]:
        from ray_tpu_torch.ops import build

        build.build(["decode_attention"], verbose=True)
        phase_decode_kernel()
        print(smi, flush=True)
        return 0
    if argv == ["serve_7b"]:
        phase_serve_7b()
        print(smi, flush=True)
        return 0
    if argv == ["train"]:
        phase_train(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["inference"]:
        phase_inference(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["mesh"]:
        phase_mesh(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["moe"]:
        phase_moe(bench_400m_moe())
        print(smi, flush=True)
        return 0
    if argv == ["seq"]:
        phase_seq(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["pipe"]:
        phase_pipe(bench_400m_dense())
        print(smi, flush=True)
        return 0
    if argv == ["rl"]:
        phase_rl()
        print(smi, flush=True)
        return 0
    if argv == ["multicard"]:
        phase_multicard()
        print(smi, flush=True)
        return 0
    if argv == ["micro"]:
        phase_micro()
        print(smi, flush=True)
        return 0
    if argv == ["projection"]:
        from ray_tpu_torch.ops import build

        build.build()
        cfg = TransformerConfig.bench_400m()
        cycle = numpy_train_batches(cfg.vocab_size, MAIN_SHAPE[0],
                                    MAIN_SHAPE[1], TRAIN_CYCLE, SEED + 2)
        phase_projection(here=gang_in_process(cfg, cycle))
        print(smi, flush=True)
        return 0
    if argv == ["runtime"]:
        from ray_tpu_torch.ops import build

        build.build()  # once here, before any worker loads a kernel
        phase_runtime(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["mesh_group"]:
        from ray_tpu_torch.ops import build

        build.build()  # once here, before any worker loads a kernel
        phase_mesh_group(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["platform"]:
        from ray_tpu_torch.ops import build

        build.build()  # once here, before any worker loads a kernel
        phase_platform(library_cfg())
        print(smi, flush=True)
        return 0
    if argv in (["data"], ["tune"]):
        from ray_tpu_torch.ops import build

        build.build()  # once here, before any worker loads a kernel
        phase = phase_data if argv == ["data"] else phase_tune
        phase(library_cfg())
        print(smi, flush=True)
        return 0
    started = time.perf_counter()
    kernel = phase_kernel()
    int8 = phase_int8_kernel()
    dec = phase_decode_kernel()
    if argv == ["kernel"]:
        print(smi, flush=True)
        return 0
    # serve_7b first of the model phases: in a process that has profiled
    # much, the profiler has lost a graph kernel's record in every reading
    # of serve_7b's decode block (255 of 256 decode attention launches);
    # early in the process, and alone, it read all 256 (PERF.md §6)
    s7 = phase_serve_7b()
    torch.cuda.empty_cache()
    # the CPU legs while the host runs nothing else of this script
    phase_micro()
    cfg = TransformerConfig.bench_400m()
    params = init_params(cfg, SEED)
    phase_forward(params, cfg)
    train = phase_train(cfg)
    mesh = phase_mesh(cfg)
    moe_run = phase_moe(bench_400m_moe())
    phase_seq(cfg)
    phase_pipe(bench_400m_dense())
    phase_grad(cfg)
    inference = phase_inference(cfg)
    phase_serve(params, cfg)
    del params
    torch.cuda.empty_cache()
    here = {"metrics": list(zip(train["losses"], train["grad_norms"],
                                range(1, train["steps"] + 1))),
            "replay_ms": train["step_ms_timed"]}
    projection = phase_projection(here=here)
    torch.cuda.empty_cache()
    runtime = phase_runtime(cfg)
    gang = phase_mesh_group(cfg, here={
        "metrics": here["metrics"][:GANG_STEPS],
        "replay_ms": here["replay_ms"]})
    # the library phases' twin in process, at their depth
    lib = library_cfg()
    lib_cycle = numpy_train_batches(lib.vocab_size, MAIN_SHAPE[0],
                                    MAIN_SHAPE[1], TRAIN_CYCLE, SEED + 2)
    lib_here = gang_in_process(
        lib, [lib_cycle[i % TRAIN_CYCLE] for i in range(DATA_STEPS)])
    data = phase_data(lib, here=lib_here)
    tuned = phase_tune(lib, here=lib_here)
    phase_rl()
    platform = phase_platform(lib, here=lib_here)
    print(smi, flush=True)
    per_step = train["launches_per_step"]
    wrappers = train["wrapper_counts_in_run"]
    # per replayed step over the one-card mesh (DEFAULT_RULES; FSDP_RULES
    # checked equal in the mesh phase)
    per_mesh_step = mesh["runs"]["DEFAULT_RULES"]["launches_per_step"]
    per_moe_step = moe_run["launches_per_step"]  # bench_400m x4 experts
    per_task_step = runtime["task"]["launches_per_replay"]  # the GPU task
    per_trainer_step = runtime["trainer"]["launches_per_replay"]
    per_gang_step = gang["launches_per_step"]  # a MeshGroup replay
    per_data_trainer = data["trainer"]["launches_per_replay"]
    per_data_gang = data["gang"]["launches_per_replay"]
    # the 3e-4 trial's (both trials' are checked equal to the want)
    per_trial = tuned["trials"][str(TUNE_LRS[0])]["launches_per_replay"]
    per_job_task = platform["train"]["launches_per_replay"]
    int8_step = int8["decode_step"]
    dec7, dec_inf = (dec["times"]["serve_7b_step"],
                     dec["times"]["inference_step"])
    main_bwd = kernel["bwd_cases"][0]
    print(f"chip_smoke: the whole run took "
          f"{time.perf_counter() - started:.1f} s", flush=True)
    emit({"phase_seconds": {**PHASE_SECONDS,
                            "total": time.perf_counter() - started}})
    per_anchor = projection["launches_per_step"]  # GPT-J width, 7 layers
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:72",
         "launches": per_step["flash_fwd"],
         "launches_per_mesh_step": per_mesh_step["flash_fwd"],
         "launches_per_moe_step": per_moe_step["flash_fwd"],
         "launches_per_runtime_task_step": per_task_step["flash_fwd"],
         "launches_per_trainer_replay": per_trainer_step["flash_fwd"],
         "launches_per_mesh_group_step": per_gang_step["flash_fwd"],
         "launches_per_data_trainer_replay": per_data_trainer["flash_fwd"],
         "launches_per_data_gang_replay": per_data_gang["flash_fwd"],
         "launches_per_tune_trial_replay": per_trial["flash_fwd"],
         "launches_per_job_task_replay": per_job_task["flash_fwd"],
         "launches_per_projection_anchor_step": per_anchor["flash_fwd"],
         "wrapper_count_in_train_run": wrappers["flash_fwd"],
         "max_abs_err": kernel["cases"][0]["max_abs_err"],
         "ms": kernel["kernel_ms"], "plain_ms": kernel["plain_ms"],
         "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
         "library_ms": kernel["library_ms"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:158",
         "fuses": "delta = rowsum(dO*O), ray_tpu/ops/flash_attention.py:247",
         "launches": per_step["flash_bwd_dq"],
         "launches_per_mesh_step": per_mesh_step["flash_bwd_dq"],
         "launches_per_moe_step": per_moe_step["flash_bwd_dq"],
         "launches_per_runtime_task_step": per_task_step["flash_bwd_dq"],
         "launches_per_trainer_replay": per_trainer_step["flash_bwd_dq"],
         "launches_per_mesh_group_step": per_gang_step["flash_bwd_dq"],
         "launches_per_data_trainer_replay": per_data_trainer["flash_bwd_dq"],
         "launches_per_data_gang_replay": per_data_gang["flash_bwd_dq"],
         "launches_per_tune_trial_replay": per_trial["flash_bwd_dq"],
         "launches_per_job_task_replay": per_job_task["flash_bwd_dq"],
         "launches_per_projection_anchor_step": per_anchor["flash_bwd_dq"],
         "wrapper_count_in_train_run": wrappers["flash_bwd_dq"],
         "max_abs_err": main_bwd["dq_max_abs_err"],
         "ms": kernel["bwd_dq_ms"], "plain_ms": kernel["bwd_dq_plain_ms"],
         "bound_ms": kernel["bwd_dq_bound_ms"],
         "bound_by": kernel["bwd_dq_bound_by"],
         "library_ms": kernel["bwd_library_ms"]},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:197",
         "launches": per_step["flash_bwd_dkv"],
         "launches_per_mesh_step": per_mesh_step["flash_bwd_dkv"],
         "launches_per_moe_step": per_moe_step["flash_bwd_dkv"],
         "launches_per_runtime_task_step": per_task_step["flash_bwd_dkv"],
         "launches_per_trainer_replay": per_trainer_step["flash_bwd_dkv"],
         "launches_per_mesh_group_step": per_gang_step["flash_bwd_dkv"],
         "launches_per_data_trainer_replay": per_data_trainer["flash_bwd_dkv"],
         "launches_per_data_gang_replay": per_data_gang["flash_bwd_dkv"],
         "launches_per_tune_trial_replay": per_trial["flash_bwd_dkv"],
         "launches_per_job_task_replay": per_job_task["flash_bwd_dkv"],
         "launches_per_projection_anchor_step": per_anchor["flash_bwd_dkv"],
         "wrapper_count_in_train_run": wrappers["flash_bwd_dkv"],
         "max_abs_err": max(main_bwd["dk_max_abs_err"],
                            main_bwd["dv_max_abs_err"]),
         "ms": kernel["bwd_dkv_ms"], "plain_ms": kernel["bwd_plain_ms"],
         "bound_ms": kernel["bwd_dkv_bound_ms"],
         "bound_by": kernel["bwd_dkv_bound_by"],
         "library_ms": kernel["bwd_library_ms"]},
        # per serve_7b decode step: 6 products per layer at M 8, 32 layers
        {"name": "int8_matmul", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/int8_matmul.cu",
         "replaces": "ray_tpu/models/quant.py:43 (XLA fusion)",
         "launches": s7["int8"]["int8_launches_per_decode_step"],
         "launches_in_traffic": s7["int8"]["int8_launches_replayed"],
         "max_abs_err": int8["serve_7b_max_abs_err"],
         "ms": int8_step["kernel_ms"], "plain_ms": int8_step["plain_ms"],
         "bound_ms": int8_step["bound_ms"],
         "bound_by": int8_step["bound_by"],
         "library_ms": int8_step["library_ms"],
         # per serve_7b prefill: the same products at M 128
         "prefill_ms": int8["prefill_step"]["kernel_ms"],
         "prefill_bound_ms": int8["prefill_step"]["bound_ms"]},
        # per serve_7b decode step: one call per layer, 8 slots at position
        # 160 of 512 with the self column; beside it, per step of bench.py's
        # inference leg (bench_400m, lengths 1025..1088 of 1089)
        {"name": "decode_attention", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/decode_attention.cu",
         "replaces": "ray_tpu/models/generation.py:151 (XLA fusion; and "
                     ":61 at S = 1)",
         "launches": s7["int8"]["decode_attention_launches_per_decode_step"],
         "launches_in_traffic":
             s7["int8"]["decode_attention_launches_replayed"],
         "launches_per_inference_step":
             inference["decode_attention_launches_per_step"],
         "launches_per_runtime_actor_decode_step": runtime["serve"][
             "decode_attention_launches_per_decode_step"],
         "launches_per_deployment_decode_step": runtime["serve"][
             "deployment_decode_attention_launches_per_decode_step"],
         "launches_per_pool_actor_decode_step": platform["pool"][
             "decode_attention_launches_per_decode_step"],
         "max_abs_err": dec["max_abs_err"]["bfloat16"],
         "ms": dec7["kernel_ms_per_step"],
         "plain_ms": dec7["plain_ms_per_step"],
         "bound_ms": dec7["bound_ms_per_step"], "bound_by": dec7["bound_by"],
         "library_ms": dec7["library_ms_per_step"],
         "inference_ms": dec_inf["kernel_ms_per_step"],
         "inference_plain_ms": dec_inf["plain_ms_per_step"],
         "inference_bound_ms": dec_inf["bound_ms_per_step"],
         "inference_library_ms": dec_inf["library_ms_per_step"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
