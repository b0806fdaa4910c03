#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``datatunerx_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``datatunerx_tpu_torch/csrc`` with
nvcc, then, each phase failing the run (non-zero exit) on any error (each
phase prints its seconds on the host clock on a line of its own,
``[time] phase <name>: <s> s``, and the end the whole script's):

1. device: prints the card's name and power limit (nvidia-smi) and the
   kernel build time;
2. kernels: runs each kernel of the serving path — K7 paged decode, K8 paged
   multi-token (each over bf16 pools and, as K7-int8/K8-int8, over int8
   pools with scale pools, the latter in bf16 and f32 and also against the
   gather path's dequantized read), K9 fused sampling — on the card at the
   shapes the tinyllama-1.1b serving path gives it, holds it against its
   plain PyTorch version on the same inputs with the stated tolerance, and
   times kernel, plain version and a PyTorch yardstick call with CUDA
   events;
3. serve: starts the port's HTTP server in-process for
   ``preset:tinyllama-1.1b`` (full width, random weights from seed 0) with
   ``--kv_block_size 16 --slots 4``, sends four concurrent
   ``/chat/completions`` (two greedy, one of them streamed over SSE; two
   sampled at temperature 0.8) and requires every kernel's launch counter,
   zeroed just before, to have moved;
4. greedy parity: two greedy prompts, 32 tokens each, through the kernel
   engine and through an engine on the gather path with the legacy sampler;
   the streams must agree up to a divergence at a near-tie (top-2 logits of
   the plain path within 2 bf16 ulps), and from there every token of both
   streams, teacher-forced through one plain forward, must lie within
   ``FORCED_ULPS`` of its top (the check every greedy comparison below
   shares);
5. train: ``python -m datatunerx_tpu_torch.tuning.train`` (its ``main``)
   for ``preset:tinyllama-1.1b`` at full width and depth, LoRA r8 on
   q_proj,v_proj, ``--attention flash --remat dots --bf16``, packed to
   1024, batch 8, 8 steps, on a CSV written from a seed, with the default
   LoRA dropout 0.1 (its masks drawn by the threefry kernel, once for each
   adapted projection in the forward and again in the recompute: 88 a
   step); requires the K1, K2, K3 and threefry launch counts (zeroed just
   before) to equal ``expected_launches``, finite
   loss and grad norm, non-zero LoRA B leaves after the first step, and the
   manifest, a checkpoint and ``model.npz`` written; the CLI runs with
   ``--metrics_export_address`` pointed at a remote-write receiver the
   script runs in-process, which must get one snappy-framed WriteRequest a
   logging step carrying ``dtx_train_loss``, and ``watch/metrics.prom``
   must exist; the batches are packed by the port's native packer
   (``native/``, built by g++ from the checkout: the phase fails unless it
   builds, prints the build's seconds, and counts the trainer's packing
   calls through it, none falling back to Python); prints step time,
   tokens/s over the steady steps, the peak memory, ``pipe_step_wait_ms``
   from ``trainer_log.jsonl`` and, for the profiled steps, the busy share
   and device ms by kernel group (threefry apart);
6. train parity: one ``Trainer.train_step`` (and one gradient) at
   tinyllama width and 4 layers on one packed batch, with
   ``attention_impl="flash"`` and with ``"xla"``: losses within 1e-2
   relative, LoRA gradients within 3e-2 relative (bf16 compute); once
   with LoRA dropout 0 and once with 0.1 (both variants draw the same
   masks from the same key);
7. QLoRA train: the same CLI run with ``--quantization int4`` (nf4 base,
   ``quant_impl`` pallas: every projection on K4, its dx on K5), 6 steps
   with steps 2-3 profiled; the same checks as phase 5, plus exact launch
   counts per step: K4 = 2 x 7 x 22 = 308 (each projection's forward and
   its recompute under remat ``dots``, which saves only matmuls), K5 =
   7 x 22 - 3 = 151 (layer 0's q/k/v inputs come from the frozen
   embedding and need no gradient), K1-K3 as in phase 5; prints step time,
   tokens/s, peak memory and device ms by kernel group (flash K1 and flash
   K2/K3 apart, as in phase 5);
8. QLoRA int8: 6 steps with ``--quantization int8``, steps 2-3 profiled
   as in phase 7: K6 = 308 per step, device ms by kernel group;
9. QLoRA parity: one train step (int4, then int8) at tinyllama width and
   4 layers with ``quant_impl="pallas"`` against ``"xla"`` (dequantize,
   then a plain matmul): the bounds of phase 6;
10. fused LoRA matmul: drives ``lora_matmul`` (K10; no model path calls it,
    in either package) at tinyllama-1.1b's adapted projections — q_proj
    (2048 x 2048) and v_proj (2048 x 256), r = 8, scale 32/8, on a training
    batch (M = 8192 rows) and a decode step (M = 4), bf16 — against the f32
    composite ``x W + (x A) B scale`` (atol 2^-5 + rtol 2^-6: the strip and
    the output each round once to bf16), its launch counter zeroed just
    before;
11. trainer paths (``--phase train`` and ``all``): the trainer CLI at
    tinyllama-1.1b's full width and depth (flash, remat dots, bf16, block
    1024, LoRA r8 on q_proj,v_proj, dropout 0.1), 4 steps each: ``--stage
    dpo`` (4 pairs a step; the first loss ln 2 within 1e-3, K1 three times
    a layer a step with the reference forward), ``--stage rm`` (4 pairs;
    the merged export holds a finite ``v_head.weight`` [2048]), ``--optim
    adafactor`` and ``--optim lion`` (SFT, packed 8x1024), ``--streaming``
    (SFT, 8 padded rows a step, a 64-record shuffle buffer) and
    ``--predict_with_generate`` (2 steps; 4 examples, 32 new tokens:
    ``generated_predictions.jsonl`` and rouge/bleu in the eval log); K1-K3
    and threefry launch counts exact in every run; prints each run's step
    ms and peak GiB;
12. PPO (after phase 11, whose RM run is its ``--reward_model``): the
    trainer CLI with ``--stage ppo`` at tinyllama-1.1b's full width and
    depth (flash, remat dots, bf16, LoRA r8 on q_proj,v_proj), 4 prompts
    a step filling ``--block_size 192``, ``--ppo_gen_len 64 --ppo_epochs
    2``, 4 steps; each step's launches exact (K1 = 22 reference + 22
    reward + 44 a pass = 132, K2 = K3 = 44, threefry 0: PPO runs no
    dropout), the first pass at the rollout's policy (approx_kl below
    1e-3, clipfrac 0), finite losses, ``ppo_controller.json`` written;
    prints the median of steps 3-4: rollout, update and step ms, rollout
    tokens/s, peak GiB, and step 2's busy share, device ms by kernel
    group and GPU kernel count (the CLI's ``--profile_steps 1``); the run's K1-K3 and threefry launches go into the
    kernels line as ``launches@ppo``;
13. the launch backends: the port's ``LocalProcessBackend`` runs a
    2-step tinyllama-1.1b LoRA SFT job as a subprocess (``--device
    cuda``, a ``file://`` storage path), its manifest appears, the port's ``LocalServingBackend``
    serves its checkpoint in a server subprocess until ``/healthz`` says
    HEALTHY, which answers two ``/chat/completions`` and two
    ``/perplexity``; ``delete`` leaves no process; prints the job's time,
    the time to HEALTHY and the requests' times;
14. prints one JSON ``{"kernels": [...]}`` line (K7, K8, K7-int8,
    K8-int8, K9, threefry, K10, K1-K6; K7's entries add the splits its
    wrapper launched, the
    CUDA kernels one call launched as torch.profiler traced them, and its
    resources; K4's, K5's and K6's their resources; K9's its greedy time
    beside ``torch.argmax``'s and its resources; K10's every shape/dtype
    case (ms, library ms, bound, route) and its kernels' resources) and,
    last, one JSON line ``{"ok": true, "device": {...}}``.

Three more serving phases run right after phase 4, before any training
phase (a decode step is bound by the host's launch rate, and the serving
phases read slower once the trainer's profiler windows and input threads
have run in the process):

- 3-int8: phase 3 with ``--kv_quant int8`` (int8 KV pool with f32 scale
  pools), full width and depth; requires the int8 instantiations of K7 and
  K8 to have launched, and prints TTFT, decode tok/s and the KV pool's bytes
  beside the bf16 pool's;
- 4-int8: phase 4 between the int8 kernel engine and the int8 gather engine;
- 3-dense: the server with its default flags (``--kv_block_size 0``, the
  dense per-slot cache) answers two concurrent greedy requests, and the
  dense engine's greedy streams equal the paged gather engine's up to a
  near-tie;
- 3-obs: the observability plane. The paged server (``--kv_block_size 16
  --slots 4 --trace_ring 64 --trace_log <tmp>/spans.jsonl --slo_config
  <one TTFT objective> --slo_sample_s 0.5``) on a state of its own answers
  four concurrent requests, each with its own ``X-DTX-Trace-Id`` (two
  greedy, one of them streamed; two sampled at 0.8). ``/metrics`` must
  parse (one ``# TYPE`` before each family's samples, no duplicate series)
  and carry the gateway's families; the TTFT and TPOT histogram counts
  move by exactly 4, the TTFT sum by the server's own ``request_stats``
  TTFTs within 1 ms; ``?exemplars=1`` names a trace id, the plain wire
  none. Each ``/debug/trace/<id>`` span's ``ttft_ms`` and ``tpot_ms``
  equal ``request_stats`` to 1e-3 ms and its events hold ``admit`` and
  ``first_token``; ``spans.jsonl`` holds the four; ``/debug/slo`` reports
  the configured objective. ``POST /debug/profile {"seconds": 3}``
  answers 202 (the JAX server's code for an armed window) and a second
  POST inside the window 409; the same four requests run inside the window,
  and the Chrome trace must hold ``dtx_engine_decode`` and
  ``dtx_engine_prefill_chunk`` ranges and K7, K8 and K9 kernels under
  their symbol names, with a K7 launch (its host call, matched by
  correlation id) inside a decode range. Then the two greedy prompts, one
  at a time, through the server's engine (tracing on) and an engine with
  ``tracing=False``: equal streams and equal K7/K8/K9 launches (zeroed
  before each). Prints decode tok/s a request with tracing on and off,
  one scrape's ms with 4 slots busy and the trace's size.

Four more run right after 3-obs, each failing the run on any error:

- 3-prefix: an in-process ``BatchedEngine`` with ``prefix_cache=8``,
  ``kv_overcommit="on"`` and a 64-block pool of 16-token blocks, 4 slots.
  Request A (a 520-token prompt P, seeded random ids) runs alone, then
  once more alone (an exact hit), then A again sampled at temperature 0.8
  (an exact copy-on-write hit) and P plus 48, 64 and 80 other tokens
  (strict-prefix hits: K8 prefills only the suffix from the cached cursor)
  run at once, 128 new tokens each; eager reservation would need 175
  blocks, so tables grow, prefix entries are reclaimed and sessions are
  preempted and resumed. Requires reuse and extension, an exported and a
  resumed preemption, no failed request, the K7 and K8 counters (zeroed
  just before the batch) to have moved, every greedy stream equal to a
  cold engine's (no prefix cache, overcommit off, the default pool) and
  the sampled one to the same request's there, each up to a near-tie, and
  free blocks plus the prefix entries' blocks to fill the pool; prints
  TTFTs, decode tok/s, peak reserved blocks and ``kv_overcommit_ratio``;
- 3-prefix-int8: the same over int8 KV pools (int8 K7/K8 counters);
- 3-perplexity: ``POST /perplexity`` to the paged server (phase 3's
  flags) for a ~600-token prompt and a 64-token completion, and for a
  prompt the context cuts from the left; then the single-request engine's
  ``perplexity`` on both inputs. Each ``nll_sum`` within ``PPL_BOUND``
  (1e-3) relative, and ``num_tokens`` equal, of an f32 forward of the same
  params over the unpadded, cut sequence; prints ms per call;
- 3-single: the server with ``--slots 1`` (``InferenceEngine``) answers two
  greedy chats in turn; its 64-token streams equal the dense batched
  engine's up to a near-tie. Then ``--slots 1 --quantization int8`` and
  ``int4`` (weights quantized on the host, the ``xla`` dequantize-then-
  matmul path) on an HF directory of TinyLlama-1.1B's configuration cut to
  ``SINGLE_QUANT_LAYERS`` = 4 layers (the host quantization of all 22
  took ~40 s of the script's time limit): 32 greedy tokens each, equal to
  an unquantized engine's over the dequantized weights up to a near-tie,
  with the K4-K6 counters left at 0; prints each weight tree's bytes
  beside the directory's bf16 weights'.

Then, last of the serving phases:

- 3-adapters: the paged server (phase 3's flags) with ``--adapter_pool 4
  --adapter_rank_max 8 --host_adapter_cache_mb 64`` and an inline
  ``--tenants_config``: a pinned tenant owning ``ad0-r2``, a bulk tenant
  owning the rest. Six random adapters (``make_adapter_sweep``: ranks 2, 4
  and 8 on q_proj,v_proj) are registered through ``POST /admin/adapters``
  (not warmed), then three rounds of concurrent greedy chats, 64 new
  tokens each: the base, ``ad0``, ``ad1`` and ``ad2``; ``ad3``, ``ad4``,
  ``ad5`` and ``ad0`` again (the pool is full: the two bulk residents
  evict, the pinned tenant's ``ad0`` stays); ``ad1`` again (an eviction and
  a reload from the host tier). Requires the registry's loads, evictions,
  hits, misses and host-tier hits to equal ``ADAPTER_EXPECT``, the K7, K8
  and K9 counters (zeroed just before) to equal what the scheduler's trace
  says the rounds ran (22 K7 and one K9 a decode step, 22 K8 a prefill
  chunk), every stream teacher-forced within ``FORCED_ULPS`` of a plain
  forward that carries only its own adapter, unpadded (the single-adapter
  path), ``tenant_usage()``'s tokens in and out to equal the responses'
  ``prompt_tokens`` and the streams' lengths, and ``DELETE`` of ``ad5`` to
  answer 200 and a chat naming it then 400, and ``/metrics``'
  ``dtx_serving_adapter_resident`` and ``_registered`` series to name the
  resident and registered sets of ``adapter_occupancy()``; prints TTFT and
  decode tok/s per request beside phase 3's base-only batch.

And after it:

- 3-migrate: session migration and the fleet plane between port servers
  in this process, each on its own ``ServingState`` (``--kv_block_size 16
  --slots 8``, tinyllama-1.1b at full width and depth, random weights from
  seed 0; 8 slots so the keep-warm source has four for fillers, and every
  server the same count: K7's split plan follows it). A source
  (``--prefix_cache 4 --role prefill --kv_overcommit on``, its engine's
  ``prefix_keep_warm`` on) decodes four
  ~600-token prompts, 64 new tokens each (three greedy, one sampled at
  0.8 with a seed); once each has 8 tokens, four one-token fillers churn
  the prompts' entries out of its prefix cache and ``POST
  /admin/sessions/export`` takes all four sessions: the source's cache
  must then hold one ``no_reuse`` block entry per prompt (``full``,
  ``rem`` = divmod(``cursor``, 16), ``cursor`` the prompt's 64-lane
  bucket, no logits) and its trace four ``keep_warm`` events, and the
  first prompt extended by 40 tokens must admit ``cow_extend`` on its
  entry and prefill only the extension on K8 (K7/K8/K9 held to the
  source's trace), its greedy stream equal to a cold run of the same
  prompt on the destination by ``check_greedy``.
  ``/admin/sessions/import`` (SSE) resumes the four sessions on a
  destination (``--prefix_cache 8``): the destination's K7, K8 and K9
  counters, zeroed just before, must equal its scheduler trace's (22 K7
  and one K9 a decode step, no K8), the receipt's text must be the tail's
  and the SSE deltas exactly what ``resume_stream``'s hold-back rule gives
  the destination's tokens (with random weights most ids decode to no
  text under the byte-level tokenizer, so the continuation's text is
  often empty; the CPU tests compare non-empty text), and each stream
  must equal the same request's unmoved run on the source (the sampled
  one exactly, the greedy ones by ``check_greedy``). The source's
  ``/metrics`` must show its role. The host's split of the export and the
  imports is timed: the scheduler's commands, the device-host copies, the
  base64 coding and the JSON coding. A source with
  ``--prefill_token_budget 64`` is caught between two prefill chunks of
  an ~880-token prompt and exports it with ``"prefill": true``: the
  destination prefills only the tail (its prefill
  tokens equal the ``pending`` ids), on K8 as its trace says. An int8
  destination (``--kv_quant int8``) takes such a bf16 mid-prefill payload
  (int8 K7/K8 and K9 equal its trace) and an int8 source's two sessions
  (the int8 wire), which must equal that source's unmoved streams. A
  ~520-token prefix served on the source moves through
  ``/admin/prefix/export`` and ``/admin/prefix/import``: the destination's
  first request on it runs no prefill chunk (its TTFT beside a cold
  prompt's). Last, an overcommitted source (``--kv_overcommit on
  --kv_blocks 64``) decodes four ~400-token prompts: a parked session held
  and released over HTTP resumes there, then the port's
  ``SpillCoordinator`` (over HTTP, its peers' stats scraped from
  ``/metrics``) holds, imports on the destination and drops parked
  sessions; every request completes once, as the reference
  run's stream, and the source's spilled count equals the coordinator's.
  Prints payload bytes (bf16 and int8 wire), export and import ms, the
  client's gap, TTFTs and each engine's ``session_stats``.
- 14a, gateway: two port servers in this process (tinyllama-1.1b,
  ``--template vanilla --max_seq_len 2048 --kv_block_size 16 --slots 4
  --prefix_cache 8``, one ``--role prefill``, one ``--role decode``)
  behind the port's ``Gateway`` over two ``HTTPReplica``s, served on a
  free port: role-aware routing (``prefill_threshold`` 768 tokens), the
  fleet prefix tier and prefill→decode handoff (ticked by the phase),
  session handoff on drain, and a tenant directory (a pinned ``gold``, a
  bulk ``batch`` with a 16-block quota). K7, K8 and K9 are zeroed before
  the gateway's traffic: four concurrent greedy chats; a ~520-token
  prompt, then the prefix tier's ticks; a ~880-token prompt holding it,
  which the prefill replica admits from the pushed prefix (no prefill
  chunk of the shared part) and whose decode a tick moves to the decode
  replica mid-stream; a 64-token greedy stream on the decode replica, held
  by a gate at 8 tokens and drained with ``POST /admin/drain`` (one
  session imported, the drained replica empty); ``batch``'s ~600-token
  request answers 429 naming the tenant and the blocks, ``gold``'s 200,
  ``GET /admin/tenants`` lists both; ``/metrics`` holds the gateway's,
  the tenants' and the fleet's families and both replicas' KV gauges.
  The launches, summed over both replicas, must equal their schedulers'
  traces (the kernels line adds ``launches@gateway`` to K7, K8 and K9).
  The same prompts sent straight to a replica afterwards hold every
  stream (``check_greedy``), and every spliced client stream is the
  tail's text plus its continuation's. Prints the handoff tick's ms, the
  drain's client gap and, each request alone in turns, TTFT and tok/s
  through the gateway and direct, and the gateway's added ms;
- 14b, gateway spawn: ``LocalServingBackend`` deploys ``{"replicas": 2,
  "kv_block_size": 16, "slots": 4}`` of tinyllama-1.1b: the port's gateway
  process spawns two port server processes on the card; HEALTHY within
  600 s, two chats, ``scale_hint`` 2, ``scale`` to 1 (the drained
  process reaped), and after ``delete`` no port server process is left
  and ``nvidia-smi --query-compute-apps`` lists none of them.

After phase 5 (``--phase train`` and ``all``):

- 5-serve: the checkpoint phase 5's trainer CLI wrote (the manifest's
  ``checkpoint``) served with ``--checkpoint_path``: on the paged server,
  where it is the adapter ``"default"``, ``/perplexity`` with ``"model":
  "default"``, and on ``--slots 1``, where the single-request engine merges
  it, ``/perplexity`` without ``model``: each ``nll_sum`` within
  ``PPL_BOUND`` of an f32 forward of base + adapter at the manifest's
  scaling; and a greedy chat with ``"model": "default"`` against the
  merged engine's stream, checked as in phase 4 with the plain forward
  carrying the adapter.

After the training phases (``--phase hf`` and ``all``), before phase 10,
three phases serve and train HF checkpoint directories that the script
writes under a temporary directory: ``config.json`` with a published
configuration's fields, seeded random weights (safetensors written by a
few lines below, one tensor at a time, or ``torch.save``), and the
tokenizer fixtures of ``tests/fixtures/torch_hf``. Each directory is first
loaded as the engines load it (bf16, on the card): the read and the
placement are timed apart and the weight tree's parameters must equal the
configuration's count.

- hf-llama2: Llama-2-7b-hf's configuration (V 32000, D 4096, F 11008,
  H = KV = 32, d 128) cut to ``HF_LLAMA2_LAYERS`` = 8 of its 32 layers
  (the script's time limit; 4 when the disk is short), F16 safetensors in
  shards with an index (the 10 GB shard limit cut with the depth, so the
  sharded loader runs: two shards at 8 layers). The
  server (``--kv_block_size 16 --slots 4``) answers four ~600-token
  prompts at once, two greedy and two sampled at 0.8, 64 new tokens each:
  K7, K8 and K9 must have launched exactly as the scheduler's trace says
  (L each a decode step and a prefill chunk, K9 once a decode step), and
  each greedy stream, teacher-forced, must lie within ``FORCED_ULPS`` of a
  plain forward's top. Then the trainer CLI on the same directory (LoRA r8
  on q_proj,v_proj, bf16, flash, remat dots, packed 8x1024, 3 steps, K1-K3
  counted exactly) and one step with flash against plain attention on its
  first 4 layers (phase 6's bounds);
- hf-mistral: Mistral-7B-v0.1's configuration (sliding window 4096, KV 8)
  cut to 4 layers, BF16 safetensors, ``--max_seq_len 8192``: one ~4600-
  token prompt, 64 greedy tokens. K7 and K8 must not launch (a window
  model takes the gather path, as in the reference), K9 once a decode
  step; the stream is checked against a plain forward carrying the window,
  and the plain forward without the window must read the last prompt
  position more than 4 x ``FORCED_ULPS`` apart (the window binds);
- hf-qwen: Qwen1.5-7B's configuration (V 151936, q/k/v biases, rope theta
  1e6) cut to 4 layers, one ``pytorch_model.bin``, byte-level BPE, the
  chatml template: two greedy ~600-token prompts, checked as hf-llama2's.

Phase 2 also holds K7 and K8 at llama2-7b's heads (H = KV = 32, d = 128),
K1-K3 at its training shape (B=8 T=1024 H=KV=32 d=128) and K9 at
V = 151936; the kernels line reports those entries (``@hf-llama2``,
``@hf-qwen``) with the launches of the HF phase that runs that shape.

The bf16 K1-K3 and the bf16 K8 (over bf16 and over int8 pools) are
tensor-core kernels (``mma.sync`` bf16 -> f32, fed by ``cp.async``; the
skeleton of ``csrc/mma_sm90.cuh``); the bf16 K4/K5 (``csrc/nf4_gemm.cu``)
and K6 (``csrc/int8_gemm.cu``) run on ``wgmma`` fed by TMA (the skeleton of
``csrc/wgmma_sm90.cuh``); K7 is a split-table decode on CUDA cores (one
launch a call: a thread-block cluster per head group); K9 runs a
16-block cluster a row, each block holding its slice of the row; K10
runs many bf16 rows on TMA + ``wgmma`` (``csrc/lora_gemm.cu``) and few rows
(and f32) as a split over K in a thread-block cluster (``csrc/lora.cu``;
f32 at many rows on CUDA-core tiles); the f32 instantiations and the rest
run on CUDA cores. Phase 2 also prints an empty kernel's time under the
same timer (the floor a small kernel is read against), K9's and K10's
registers, spill bytes and blocks per SM, and each K10 case's route. Phase 2 prints K8's
registers, spill bytes, shared bytes and blocks per SM at the smoke shape,
the same for K7 (with its splits) and K4-K6, requires two K7 calls on the
same inputs to agree bit for bit, and also holds K1 (flash forward), K2
(dQ) and K3 (dK/dV) against their plain versions at the training shapes
(B=8 H=32 KV=4 T=1024 d=64, causal, bf16), on a packed batch and at d=128,
printing for each case K1 against one SDPA forward and the pair K2+K3
against one SDPA backward (which computes dQ, dK and dV together; both
masked to the segments on the packed batch) and the bf16 K1/K2/K3's
registers, spills, shared bytes and blocks per SM, and K4 (nf4 matmul), K5
(its transposed dx product) and K6 (int8 matmul) at M=8192 rows and each
projection shape of tinyllama-1.1b, in bf16 and f32, and K10 (fused LoRA
matmul) at M=8192 and M=4 rows, N=2048 and N=256, K=2048, r=8, in bf16 and
f32, and the threefry kernel against its plain version, bit for bit, at
8 x 1024 x 2048 (the keep mask at p = 0.9 and the uniform draw over
[-1, 1)) and at odd lengths. ``--phase kernels`` stops after phase 2;
``--phase install`` runs phases 1, 2 and install (19 below); ``--phase
serve`` runs phases 1, 2, install, 3, 4, the eight above, the spec phases,
3-adapters, 3-migrate, 14, 17 and 10; ``--phase gateway`` runs phases 1, 2,
14 and 17; ``--phase loadgen`` runs phases 1, 2 and 17; ``--phase train``
runs phases 1, 2, 5, 5-serve, 6-9, 11-13, 16 and 18; ``--phase qlora`` runs
phases 1, 2 and 7-9; ``--phase hf`` runs phases 1, 2 and the three HF
phases; ``--phase parallel`` runs phases 1, 2 and 15; ``--phase operator``
runs phases 1, 2, 16 and 18 (``train`` and ``all`` run 16 and 18 after
13).

15. parallel (``--phase parallel`` and ``all``, last): the multi-GPU
    slice on one card. (a) The threefry kernel's block draws (a rank's
    dp rows, sp chunk or tp column shard of a global draw) bit-equal to its
    plain version; K1, K2 and K3 with ``causal=False`` (the ring's
    past chunks) against their plain versions within ``FLASH_TOL`` at a
    ring chunk of tinyllama's heads (B 2, T 1024, H 32, KV 4, d 64) and of
    llama2-7b's (H = KV = 32, d 128), timed with the L2 flushed beside the
    plain versions and non-causal SDPA forward and backward: the
    ``K1@ring``/``K2@ring``/``K3@ring`` entries of the kernels line, whose
    launches are (b)'s. (b) The sp = 4 ring's schedule for every rank in
    this process over the kernels (``ring_schedule``: the rotation by
    indexing; one process cannot hold an NCCL ring on one card), T = 4 x
    1024 at tinyllama's heads: output and dQ/dK/dV within ``FLASH_TOL`` of
    the same schedule over the plain versions and within ``RING_TOL`` of
    one causal flash call over T = 4096, exactly 16 launches each of K1, K2
    and K3, the ring's wall time beside the one call's. (c) The trainer
    CLI at tinyllama width (phase 5's data and shape, 2 steps) with
    ``--attention ring --mesh dp=1`` and with ``--attention xla``: equal
    losses; ``maybe_initialize_distributed`` reports a world of 1; then
    ``--stage ppo`` (phase 12's flags, 2 steps of 16 tokens, against a
    2-step rm run) with ``--mesh dp=1`` and without a mesh: losses,
    approx_kl and kl_coef within 1e-5 (the multi-rank PPO is held on the
    CPU under gloo). (d)
    ``estimate_footprint`` at phases 5, 7 and 8 and hf-llama2's LoRA (at
    the depth it ran) at or above the peaks those phases measured in this
    run; ``check_fits`` on
    the card's budget rejects a 7B full-parameter job and admits a 7B
    QLoRA one. (e) ``LocalProcessBackend`` with more hosts than cards on
    CUDA raises, naming the card count.

16. operator (``--phase operator``, ``train`` and ``all``): the port's
    controller-manager as a subprocess (``python -m
    datatunerx_tpu_torch.operator.manager --backend local``, a ``file://``
    storage path, the device health probe every 5 s, ``TPU_SLICE_POOL``
    one slice of 1 card). ``dtx-torch apply`` registers a Dataset (phase
    13's CSV generator, 8 rows), an LLM (``preset:tinyllama-1.1b``), two
    Hyperparameters that differ in learningRate and a FinetuneExperiment
    of two FinetuneJobs (LoRA r8 on q_proj,v_proj, batch 4: 2 steps each,
    built-in scoring). Checked: ``dtx_device_healthy 1`` and the slice
    gauges on the manager's ``/metrics``; one job waits for the card
    (``PLACEMENT_PENDING``) while the other holds it; both jobs
    Successful with an LLMCheckpoint and a numeric score; the experiment
    Success with the ``bestVersion`` the reference's ``parse_score``
    ranks first. The first job's server subprocess is probed as soon as it
    appears, with the manager held (SIGSTOP) until the probes are done
    so that the operator cannot tear it down meanwhile: the built-in
    probes' greedy answers with ``"model": "default"`` (the job's
    adapter; ``PROBE_NEW`` tokens each) and their references' ``nll_sum``
    with and without the
    adapter, which must differ (the first job's server only: the second
    runs the same path); deleting the
    experiment leaves no trainer or server process. Prints the seconds
    from apply to each job's training, HEALTHY and score, and the
    experiment's wall time, less the seconds the manager was held.

17. replay (``--phase loadgen``, ``gateway``, ``serve`` and ``all``, after
    14): the port's paged server in-process as phase 3 starts it
    (``preset:tinyllama-1.1b`` at full width and depth, random weights from
    seed 0, ``--kv_block_size 16 --slots 4 --max_seq_len 1024``), then
    ``dtx-torch replay --url <server> --requests 40 --sessions 6 --rps 25
    --seed 0 --record <trace> --report_json <report>`` as a subprocess (the
    reference's defaults), then the recorded trace (``--trace``) through a
    port ``Gateway`` over the same server twice: built as phase 14a builds
    it (fleet-true admission prices each request in KV blocks against the
    server's free blocks and sheds what the pool cannot hold: the 429s are
    counted, not failed), and with the block signal off and a static
    prefill budget of the trace's own estimate. Each run: every request
    answers 200 (the block-priced gateway: 200 or 429), the server's
    ``dtx_serving_ttft_ms_count`` moves by the 200s, K7, K8 and K9 launch
    on the server (``launches@replay`` and ``launches@replay-gateway`` on
    the kernels line); prints the client's TTFT and latency p50/p90/p99,
    the requests whose stream carried no content (random weights: the byte
    tokenizer decodes ids of 266 and above to nothing, and text ending in
    U+FFFD is held back), the server's TTFT and TPOT quantiles from its
    ``/metrics`` histograms and the SLO epilogue's verdicts (exit 1 is the
    epilogue's FAIL, which is printed, not failed). The static-budget
    gateway runs under the port's sanitizers (lock order, thread leaks,
    builds; ``analysis/sanitizers``), installed before that gateway is
    built and taken out after it closes, as ``dtx-torch replay``'s
    ``DTX_SAN`` bracket does: no new finding against the empty
    ``dtxsan-torch-baseline.json``, no build in the window, and its
    K7/K8/K9 launches equal to the direct replay's.

18. experiment (``--phase operator``, ``train`` and ``all``, after 16):
    ``dtx-torch experiment -f spec.json --backend local --status_json`` as
    a subprocess: two LoRA jobs on ``preset:tinyllama-1.1b`` (r8 on
    q_proj,v_proj, flash, 8 rows at batch 4: 2 steps, a checkpoint every
    step) that differ only in learning rate, a pool of one slice of 1
    card, each job scored at a port paged server this phase starts
    in-process (random weights: it scores the base). Checked: exit 0; both
    jobs Succeeded; the second job started only after the first succeeded;
    each job scored at exactly the steps ``checkpoint_steps`` lists (1 and
    2, ``minEvals``); no trainer process left. Prints the experiment's wall
    seconds beside phase 16's.

19. install (``--phase install``, ``serve`` and ``all``, right after phase
    2; logged as ``[install]``): the port as an installed package. Its
    card-free half runs in a thread at nice 19, begun beside phase 1's
    build and joined when the phase starts (``start_install_prep``): ``pip
    wheel --no-build-isolation``
    builds the project's wheel from a temporary copy of ``pyproject.toml``
    and ``datatunerx_tpu_torch`` (what the trainer image copies; no
    ``build/`` or egg-info lands in the checkout) and ``pip install
    --no-deps --no-index --target`` installs it into a temporary directory;
    from a temporary working directory, with only that directory on
    ``PYTHONPATH`` and a fresh ``XDG_CACHE_HOME``, ``python -m
    datatunerx_tpu_torch.ops._build`` compiles the installed sources (nvcc,
    nothing loaded). The phase then runs a child process (written out from
    ``INSTALL_CHILD``) that checks that the package, ``_build.CSRC`` and the
    apiserver lie in the install and both build directories under the cache,
    loads the library without a build, serves the two greedy 32-token
    prompts of phase 4 on a paged ``BatchedEngine(device="cuda")``
    (tinyllama-1.1b, full width and depth, seed 0, block 16), runs two steps
    of the trainer CLI's ``main`` as phase 5 does (flash, remat dots, bf16,
    packed 8x1024) with its packing counted through the installed native
    packer (a fresh g++ build in the cache), and gets ``GET /ui`` from an
    installed apiserver. The parent requires the installed sources' digest
    to equal the checkout's, no module of the port loaded from outside the
    install, K1-K3 and threefry equal to ``expected_launches(None, 2)``,
    every packing call native and ``/ui`` 200 with the checkout's
    ``ui.html`` bytes. Phase 4 then holds the child's token ids against
    its own generations of the same prompts on phase 3's engine (the
    shared near-tie check), and the child's K7, K8 and K9 launches to
    exactly the counts those generations launched (with ``--phase
    install`` a checkout engine of the same geometry, logged as
    ``[install-streams]``); the phase prints the pip, nvcc and child
    seconds, and the kernels line carries the child's counts as
    ``launches@install``.

The script imports nothing of JAX, of the JAX package or of the HF
libraries.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
# 32-bit integer instructions: each of an SM's 4 sub-partitions issues one
# warp instruction (32 lanes) a clock, 132 SMs at the 1.98 GHz boost clock.
# The integer ALU pipe alone (LOP3, SHF, IADD3) takes 64 lanes a clock, half
# of this; nvcc also issues adds on the FMA pipe (IMAD), so the issue rate
# is the ceiling of any mix.
I32_OPS_PER_S = 4 * 32 * 132 * 1.98e9
SENTINEL = 2**30


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# a phase's header is logged at column 0 as "[<phase>] ..."; each header
# closes the phase before it, which prints its seconds on a line of its own
_PHASE_RE = re.compile(
    r"^\[([0-9][0-9a-z-]*|hf-[a-z0-9]+(?: [a-z]+)?|install(?:-streams)?)\] ")
_PHASES = {"name": None, "t0": 0.0, "seconds": []}
T_START = time.perf_counter()


def log(msg: str):
    m = _PHASE_RE.match(msg)
    if m:
        phase_done()
        _PHASES["name"], _PHASES["t0"] = m.group(1), time.perf_counter()
    print(msg, flush=True)


def phase_done():
    """Close the running phase: print its seconds (host clock)."""
    name = _PHASES["name"]
    if name is None:
        return
    secs = time.perf_counter() - _PHASES["t0"]
    _PHASES["seconds"].append((name, secs))
    _PHASES["name"] = None
    print(f"  [time] phase {name}: {secs:.1f} s", flush=True)


# ------------------------------------------------------------------ timing
class Timer:
    """Device time of one call with CUDA events. Before each timed call the
    L2 is flushed (64 MB written) and the stream is held busy by a spin
    kernel, so the host has enqueued the events and the call before the
    device reaches them: the interval is device time, not launch overhead
    (for a call made of many launches, host time between them still
    counts — that is the plain versions' real cost)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 2
def make_pool(torch, B, nbps, bs, KV, d, lens, gen):
    """A bf16 block pool holding ``lens[b]`` written tokens per slot through
    shuffled block tables (positions 0..len-1, sentinel elsewhere); the pool
    carries the engine's extra scratch block."""
    NB = B * nbps
    perm = torch.randperm(NB, generator=gen).tolist()
    tables = torch.full((B, nbps), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        need = -(-lens[b] // bs)
        tables[b, :need] = torch.tensor(perm[nxt:nxt + need], dtype=torch.int32)
        nxt += need
    k = torch.randn((NB + 1, bs, KV, d), generator=gen).to(torch.bfloat16)
    v = torch.randn((NB + 1, bs, KV, d), generator=gen).to(torch.bfloat16)
    pos = torch.full((NB + 1, bs), SENTINEL, dtype=torch.int32)
    for b in range(B):
        for i in range(lens[b]):
            pos[tables[b, i // bs], i % bs] = i
    return (k.cuda(), v.cuda(), tables.cuda(), pos.cuda())


def gathered(torch, pool, tables):
    """The gather path's linear view of a pool [NB, bs, ...]: [B, W, ...]."""
    tbl = torch.where(tables >= 0, tables, torch.zeros_like(tables)).long()
    B = tables.shape[0]
    return pool[tbl].reshape(B, -1, *pool.shape[2:])


def kv_positions(torch, pos, tables):
    """The gathered position view [B, W], sentinel where no block backs it."""
    bs = pos.shape[1]
    view = gathered(torch, pos, tables)
    return torch.where((tables >= 0).repeat_interleave(bs, 1), view,
                       torch.full_like(view, SENTINEL))


def int8_pools(k, v):
    """bf16 pools → (int8 pools, f32 scale pools), as the cache writes them."""
    from datatunerx_tpu_torch.ops.attention import kv_quantize

    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    return kq, vq, ks, vs


def dequantized_view(torch, pools, tables, dtype):
    """What the gather path reads from int8 pools: [B, W, KV, d] in dtype."""
    from datatunerx_tpu_torch.ops.attention import kv_dequantize

    kq, vq, ks, vs = pools
    return (kv_dequantize(gathered(torch, kq, tables),
                          gathered(torch, ks, tables), dtype),
            kv_dequantize(gathered(torch, vq, tables),
                          gathered(torch, vs, tables), dtype))


def sdpa(torch, q, k, v, mask=None, causal=False):
    """Yardstick: one PyTorch SDPA call, q [B, H, T, d], k/v [B, KV, S, d]."""
    F = torch.nn.functional
    G = q.shape[1] // k.shape[1]
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal,
                                              enable_gqa=True)
    except TypeError:  # torch without enable_gqa
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            attn_mask=mask, is_causal=causal)


def close_enough(torch, got, want, atol, rtol):
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max())


PAGED_TOL = (2**-8, 2**-7)  # f32 sums in another order, one bf16 rounding


# the llama2-7b / qwen1.5-7b serving shape: 32 heads, G = 1, d = 128
K7_LLAMA2 = (4, 32, 32, 128, 16, 64)
K8_LLAMA2 = (1, 256, 32, 32, 128, 16, 64)


def check_k7(torch, timer, gen, quant=False, shape=None, path=""):
    """K7 against its plain version. ``quant``: the int8 instantiation, over
    pools quantized as the cache writes them, in bf16 and f32 and also
    against the gather path's dequantized read; timed in bf16. ``shape``
    (B, H, KV, d, bs, nbps) replaces tinyllama's; ``path`` names the phase
    whose launches the entry reports."""
    from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
    from datatunerx_tpu_torch.ops.attention import (
        make_causal_bias,
        xla_attention,
    )

    B, H, KV, d, bs, nbps = shape or (4, 32, 4, 64, 16, 64)
    lens = [1000, 517, 77, 0]  # ragged, one empty slot
    k, v, tables, pos = make_pool(torch, B, nbps, bs, KV, d, lens, gen)
    q32 = torch.randn((B, H, d), generator=gen).cuda()
    qpos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32,
                        device="cuda")
    kv_pos = kv_positions(torch, pos, tables)
    pools = int8_pools(k, v) if quant else (k, v, None, None)
    name = ("K7-int8" if quant else "K7") + path
    err = 0.0
    for dtype in ((torch.bfloat16, torch.float32) if quant
                  else (torch.bfloat16,)):
        q = q32.to(dtype)
        got = cpa.paged_decode_attention(q, *pools, tables, pos, qpos)
        want = cpa._plain_decode(q, pools[0], pools[1], tables, pos, qpos,
                                 pools[2], pools[3])
        torch.cuda.synchronize()
        ok, e = close_enough(torch, got, want, *PAGED_TOL)
        if not ok:
            fail(f"{name} ({dtype}) disagrees with its plain version: max "
                 f"abs err {e}")
        if got[3].abs().max().item() != 0:
            fail(f"{name}: the empty slot did not write zeros")
        err = max(err, e)
        if quant:
            k_att, v_att = dequantized_view(torch, pools, tables, dtype)
            bias = make_causal_bias(qpos[:, None], kv_pos)
            read = xla_attention(q[:, None], k_att, v_att, bias)[:, 0]
            ok, e = close_enough(torch, got[:3], read[:3], *PAGED_TOL)
            if not ok:
                fail(f"{name} ({dtype}) disagrees with the gather path's "
                     f"dequantized read: max abs err {e}")
            err = max(err, e)
    q = q32.to(torch.bfloat16)
    if quant:
        k_all, v_all = dequantized_view(torch, pools, tables, torch.bfloat16)
    else:
        k_all, v_all = gathered(torch, k, tables), gathered(torch, v, tables)
    mask = (kv_pos <= qpos[:, None])[:, None, None, :]  # [B, 1, 1, W]
    qs, ks, vs = q[:, :, None, :], k_all.transpose(1, 2), v_all.transpose(1, 2)
    valid = sum(lens)
    # per cached token: its position, and K and V rows of every KV head
    # (bf16: 2 bytes an element; int8: 1 byte plus one f32 scale per row)
    token_bytes = 4 + 2 * KV * ((d + 4) if quant else 2 * d)
    nbytes = (2 * q.numel() * 2 + tables.numel() * 4 + qpos.numel() * 4
              + valid * token_bytes)
    b_ms, b_by = bound_ms(nbytes, 4 * H * d * valid, BF16_OPS_PER_S)

    def kern():
        return cpa.paged_decode_attention(q, *pools, tables, pos, qpos)

    def plain():
        return cpa._plain_decode(q, pools[0], pools[1], tables, pos, qpos,
                                 pools[2], pools[3])

    res = resources("dtx_paged_decode_resources", 8, d,
                    H // KV)[4 if quant else 0:][:4]
    ms = timer.ms(kern)
    again = kern()
    if not torch.equal(kern(), again):
        fail(f"{name}: two calls on the same inputs differ")
    launched = cuda_kernels(torch, kern)
    if not launched:
        fail(f"{name}: the profiler traced no CUDA kernel of a call")
    splits, per = cpa.paged_decode_attention.last_split
    log(f"  {name} ran {splits} splits of {per} table blocks a (slot, KV "
        f"head), one cluster of {splits} blocks each; a call launched "
        f"{len(launched)} CUDA kernel(s) ("
        + ", ".join(kernel_name(n) for n in launched) + "); bf16 "
        + describe_resources(res, (("", 0),)))
    return {
        "name": f"{name} paged_decode_attention"
                + (" (int8 pools)" if quant else ""), "route": "cuda",
        "path": path,
        "source": "datatunerx_tpu_torch/csrc/paged_attention.cu",
        "replaces": "datatunerx_tpu/ops/pallas_paged_attention.py:65",
        "counter": cpa.paged_decode_attention,
        "count": "int8_launches" if quant else "launches",
        "max_abs_err": err,
        "tolerance": "atol 2^-8 + rtol 2^-7" + (
            " (bf16 and f32; vs plain and vs the gather path)" if quant
            else " (bf16)"),
        "ms": ms, "plain_ms": timer.ms(plain, reps=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: sdpa(torch, qs, ks, vs, mask)),
        "shape": f"B={B} H={H} KV={KV} d={d} bs={bs} nbps={nbps} lens={lens}"
                 + ("; library: SDPA on the dequantized view" if quant
                    else ""),
        "extra": {"splits": splits, "entries_per_split": per,
                  "cuda_launches_per_call": len(launched),
                  "registers": res[0], "spill_bytes": res[1],
                  "shared_bytes": res[2], "blocks_per_sm": res[3]},
    }


def check_k8(torch, timer, gen, quant=False, shape=None, path=""):
    """K8 against its plain version; ``quant``, ``path`` as in
    ``check_k7``, ``shape`` (B, T, H, KV, d, bs, nbps)."""
    from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
    from datatunerx_tpu_torch.ops.attention import (
        attention_allow,
        make_causal_bias,
        xla_attention,
    )

    B, T, H, KV, d, bs, nbps = shape or (1, 256, 32, 4, 64, 16, 64)
    lens = [768]  # the third 256-token chunk of a prompt, post-write
    if not quant:
        log_k8_resources(H // KV, d, cpa.multitoken_tile(T, H // KV))
    k, v, tables, pos = make_pool(torch, B, nbps, bs, KV, d, lens, gen)
    q32 = torch.randn((B, T, H, d), generator=gen).cuda()
    qpos = torch.arange(lens[0] - T, lens[0], dtype=torch.int32,
                        device="cuda")[None]
    kv_pos = kv_positions(torch, pos, tables)
    allow = attention_allow(qpos, kv_pos)
    pools = int8_pools(k, v) if quant else (k, v, None, None)
    name = ("K8-int8" if quant else "K8") + path
    err = 0.0
    for dtype in ((torch.bfloat16, torch.float32) if quant
                  else (torch.bfloat16,)):
        q = q32.to(dtype)
        got = cpa.paged_multitoken_attention(q, *pools, tables, allow)
        want = cpa._plain_multitoken(q, pools[0], pools[1], tables, allow,
                                     pools[2], pools[3])
        torch.cuda.synchronize()
        ok, e = close_enough(torch, got, want, *PAGED_TOL)
        if not ok:
            fail(f"{name} ({dtype}) disagrees with its plain version: max "
                 f"abs err {e}")
        err = max(err, e)
        if quant:
            k_att, v_att = dequantized_view(torch, pools, tables, dtype)
            read = xla_attention(q, k_att, v_att,
                                 make_causal_bias(qpos, kv_pos))
            ok, e = close_enough(torch, got, read, *PAGED_TOL)
            if not ok:
                fail(f"{name} ({dtype}) disagrees with the gather path's "
                     f"dequantized read: max abs err {e}")
            err = max(err, e)
    q = q32.to(torch.bfloat16)
    if quant:
        k_all, v_all = dequantized_view(torch, pools, tables, torch.bfloat16)
    else:
        k_all, v_all = gathered(torch, k, tables), gathered(torch, v, tables)
    qs = q.transpose(1, 2)
    ks, vs = k_all.transpose(1, 2), v_all.transpose(1, 2)
    mask = allow[:, None]
    valid_pairs = int(allow.sum().item())
    token_bytes = 2 * KV * ((d + 4) if quant else 2 * d)
    nbytes = (2 * q.numel() * 2 + allow.numel() + tables.numel() * 4
              + lens[0] * token_bytes)
    b_ms, b_by = bound_ms(nbytes, 4 * H * d * valid_pairs, BF16_OPS_PER_S)

    def kern():
        return cpa.paged_multitoken_attention(q, *pools, tables, allow)

    def plain():
        return cpa._plain_multitoken(q, pools[0], pools[1], tables, allow,
                                     pools[2], pools[3])

    return {
        "name": f"{name} paged_multitoken_attention"
                + (" (int8 pools)" if quant else ""), "route": "cuda",
        "path": path,
        "source": "datatunerx_tpu_torch/csrc/paged_attention.cu",
        "replaces": "datatunerx_tpu/ops/pallas_paged_attention.py:294",
        "counter": cpa.paged_multitoken_attention,
        "count": "int8_launches" if quant else "launches",
        "max_abs_err": err,
        "tolerance": "atol 2^-8 + rtol 2^-7" + (
            " (bf16 and f32; vs plain and vs the gather path)" if quant
            else " (bf16)"),
        "ms": timer.ms(kern), "plain_ms": timer.ms(plain, reps=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: sdpa(torch, qs, ks, vs, mask)),
        "shape": f"B={B} T={T} H={H} KV={KV} d={d} bs={bs} nbps={nbps} "
                 f"len={lens[0]}"
                 + ("; library: SDPA on the dequantized view" if quant
                    else ""),
    }


# --------------------------------------------- phase 2, the threefry twin
def check_twin(torch, gen):
    """The device twin of ``jax.random`` (``ops/prng.py``, torch int64 words
    on the card) bit-equal to the host twin (numpy) for ``split``,
    ``fold_in``, ``uniform`` at [4] and ``random_bits``/``categorical`` at
    [4, 32000], and the Random123 known answer on the card. Returns the
    kernels one [4, 32000] ``categorical`` draw launches (a profiler
    window), the spec verify step's residual draw."""
    import numpy as np

    from datatunerx_tpu_torch.ops import prng

    seed = int(torch.randint(0, 2**31, (1,), generator=gen))
    hk = prng.PRNGKey(seed)
    dk = prng.to_device(hk, "cuda")
    checks = {
        "split": (prng.split(hk, 5), prng.split(dk, 5)),
        "fold_in": (prng.fold_in(hk, 12345), prng.fold_in(dk, 12345)),
        "uniform[4]": (prng.uniform(hk, (4,)), prng.uniform(dk, (4,))),
        "random_bits[4,32000]": (prng.random_bits(hk, (4, 32000)),
                                 prng.random_bits(dk, (4, 32000))),
    }
    keys = prng.split(hk, 4)
    logits = (torch.randn((4, 32000), generator=gen) * 2.0)
    checks["categorical[4,32000]"] = (
        prng.categorical(keys, logits.numpy()),
        prng.categorical(prng.to_device(keys, "cuda"), logits.cuda()))
    for name, (host, dev) in checks.items():
        got = dev.cpu().numpy()
        host = np.asarray(host)
        same = (got.view(np.uint32) == host.view(np.uint32)).all() \
            if host.dtype == np.float32 else (got.astype(np.int64)
                                              == host.astype(np.int64)).all()
        if not same:
            fail(f"threefry twin: {name} differs between the card and the "
                 "host")
    ka = prng.threefry2x32(*(torch.tensor(x, dtype=torch.int64,
                                          device="cuda") for x in (
        0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)))
    if (int(ka[0]), int(ka[1])) != (0xC4923A9C, 0x483DF7A0):
        fail("threefry twin: the Random123 known answer differs on the card")
    dkeys = prng.to_device(keys, "cuda")
    lg = logits.cuda()
    launches = profile_launches(torch, lambda: prng.categorical(
        dkeys, prng.xla_log(torch.softmax(lg, -1).clamp(min=1e-30))))
    log(f"  threefry twin: card == host for {', '.join(checks)}; Random123 "
        f"known answer on the card; one [4, 32000] residual draw (log + "
        f"categorical) launches {launches} kernels")
    return launches


THREEFRY_SHAPE = (8, 1024, 2048)  # phase 5's [B, T, D] at the q/v inputs
THREEFRY_OPS = 76  # 32-bit integer instructions an element (csrc/threefry.cu)


def check_threefry(torch, timer, gen):
    """The threefry kernel (``ops/cuda_prng.threefry_bits``) against its
    plain version (the twin's int64 ops on the card), exactly: the dropout
    keep mask at p = 0.9 and the NEFTune draw over [-1, 1) at phase 5's
    8 x 1024 x 2048, then odd lengths (not a multiple of the 4 elements a
    thread writes) in both modes. Times the mask, its bound the larger of
    the bytes written (1 an element) over the HBM rate and its 32-bit
    integer instructions over the issue rate ``I32_OPS_PER_S`` (no PyTorch
    call draws jax.random's bits: library null)."""
    import numpy as np

    from datatunerx_tpu_torch.ops import cuda_prng, prng

    seed = int(torch.randint(0, 2**31, (1,), generator=gen))
    key = prng.fold_in(prng.PRNGKey(seed), 7)
    cases = [THREEFRY_SHAPE, (3, 1001), (7,), (1,), (5, 13, 17)]
    for shape in cases:
        got = cuda_prng.threefry_bits(key, shape, "cuda", p=0.9)
        want = cuda_prng.plain_bernoulli(key, 0.9, shape, "cuda")
        if not torch.equal(got, want):
            fail(f"threefry kernel: the keep mask at {shape} differs from "
                 "its plain version")
        got = cuda_prng.threefry_bits(key, shape, "cuda", lo=-1.0, hi=1.0)
        want = cuda_prng.plain_uniform(key, shape, -1.0, 1.0, "cuda")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"threefry kernel: the uniform draw at {shape} differs "
                 "from its plain version")
    host = np.asarray(prng.bernoulli(key, 0.9, (3, 1001)))
    if not (cuda_prng.threefry_bits(key, (3, 1001), "cuda", p=0.9).cpu()
            .numpy() == host).all():
        fail("threefry kernel: the keep mask differs from the host twin")
    torch.cuda.synchronize()
    n = int(np.prod(THREEFRY_SHAPE))
    ms = timer.ms(lambda: cuda_prng.threefry_bits(key, THREEFRY_SHAPE, "cuda",
                                                  p=0.9))
    plain = timer.ms(lambda: cuda_prng.plain_bernoulli(
        key, 0.9, THREEFRY_SHAPE, "cuda"), reps=3, warmup=1)
    u_ms = timer.ms(lambda: cuda_prng.threefry_bits(
        key, THREEFRY_SHAPE, "cuda", lo=-1.0, hi=1.0))
    u_plain = timer.ms(lambda: cuda_prng.plain_uniform(
        key, THREEFRY_SHAPE, -1.0, 1.0, "cuda"), reps=3, warmup=1)
    b_ms, b_by = bound_ms(n, THREEFRY_OPS * n, I32_OPS_PER_S)
    u_bound, u_by = bound_ms(4 * n, THREEFRY_OPS * n, I32_OPS_PER_S)
    plain_launches = profile_launches(torch, lambda: cuda_prng.plain_bernoulli(
        key, 0.9, THREEFRY_SHAPE, "cuda"))
    log(f"  threefry uniform [-1, 1) at {THREEFRY_SHAPE}: kernel "
        f"{u_ms:.4f} ms, plain {u_plain:.4f} ms, bound {u_bound:.5f} ms "
        f"({u_by}; bytes alone {4 * n / HBM_BYTES_PER_S * 1e3:.5f} ms); "
        f"the plain mask is {plain_launches} kernels; exact at "
        f"{', '.join(str(c) for c in cases)}")
    return {
        "name": "threefry bits", "route": "cuda",
        "source": "datatunerx_tpu_torch/csrc/threefry.cu",
        "replaces": "none: XLA fuses jax.random.bernoulli/uniform "
                    "(datatunerx_tpu/models/llama.py:120-122, :226-233)",
        "counter": cuda_prng.threefry_bits,
        "max_abs_err": 0, "tolerance": "bit-exact",
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "extra": {"uniform_ms": u_ms, "uniform_plain_ms": u_plain,
                  "uniform_bound_ms": u_bound,
                  "bytes_bound_ms": n / HBM_BYTES_PER_S * 1e3,
                  "plain_kernels": plain_launches},
        "shape": f"keep mask p=0.9 at {THREEFRY_SHAPE}",
    }


def profile_launches(torch, fn) -> int:
    """CUDA kernels one call of ``fn`` launches (after a warm-up call),
    copies and memsets not counted (``cuda_kernels``' profiler window)."""
    fn()
    return sum(1 for n in cuda_kernels(torch, fn)
               if "memcpy" not in n.lower() and "memset" not in n.lower())


# --------------------------------------------- phase 2, K8 at spec shapes
SPEC_K = 4
SPEC_TREE = (2, 3)
TWIN_LAUNCHES = [0]  # one residual draw's kernels, set by check_twin


def check_k8_spec(torch, timer, gen, quant=False, tree=False):
    """K8 at the verify shapes of the spec phases, against its plain
    version: a 4-slot batch over tinyllama's heads, each slot's window the
    last T written lanes of its table. Chain: T = k + 1 = 5, causal. Tree:
    the 2x3 tree's T = 7 columns at a non-zero ``window_start`` under the
    branch ancestry mask (``tree_verify_mask``), siblings sharing a rope
    position, as ``SpecPrograms.tree_step`` writes them."""
    import numpy as np

    from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
    from datatunerx_tpu_torch.ops.attention import attention_allow
    from datatunerx_tpu_torch.serving.speculative import tree_verify_mask

    B, H, KV, d, bs, nbps = 4, 32, 4, 64, 16, 64
    lens = [700, 301, 513, 64]
    k, v, tables, pos = make_pool(torch, B, nbps, bs, KV, d, lens, gen)
    if tree:
        W, D = SPEC_TREE
        T = 1 + W * D
        depth = np.concatenate([[0]] + [[j] * W for j in range(1, D + 1)])
        wmask = torch.from_numpy(tree_verify_mask(W, D)).cuda()
    else:
        T = SPEC_K + 1
        depth = np.arange(T)
        wmask = None
    start = torch.tensor([n - T for n in lens], dtype=torch.int32,
                         device="cuda")
    # the window's lanes carry the step's rope positions: the pending
    # token's position plus each column's depth
    tab = tables.cpu()
    for b, n in enumerate(lens):
        for c in range(T):
            lane = n - T + c
            pos[int(tab[b, lane // bs]), lane % bs] = n - T + int(depth[c])
    qpos = start[:, None] + torch.from_numpy(depth.astype(np.int32)).cuda()
    kv_pos = kv_positions(torch, pos, tables)
    allow = attention_allow(
        qpos, kv_pos, window_mask=(None if wmask is None else
                                   wmask[None].expand(B, T, T)),
        window_start=start)
    q = torch.randn((B, T, H, d), generator=gen).to(torch.bfloat16).cuda()
    pools = int8_pools(k, v) if quant else (k, v, None, None)
    got = cpa.paged_multitoken_attention(q, *pools, tables, allow)
    want = cpa._plain_multitoken(q, pools[0], pools[1], tables, allow,
                                 pools[2], pools[3])
    torch.cuda.synchronize()
    ok, err = close_enough(torch, got, want, *PAGED_TOL)
    path = "@spec-tree" if tree else "@spec-chain"
    name = ("K8-int8" if quant else "K8") + path
    if not ok:
        fail(f"{name} disagrees with its plain version: max abs err {err}")
    if quant:
        k_all, v_all = dequantized_view(torch, pools, tables, torch.bfloat16)
    else:
        k_all, v_all = gathered(torch, k, tables), gathered(torch, v, tables)
    qs, ks, vs = q.transpose(1, 2), k_all.transpose(1, 2), \
        v_all.transpose(1, 2)
    valid_pairs = int(allow.sum().item())
    token_bytes = 2 * KV * ((d + 4) if quant else 2 * d)
    nbytes = (2 * q.numel() * 2 + allow.numel() + tables.numel() * 4
              + sum(lens) * token_bytes)
    b_ms, b_by = bound_ms(nbytes, 4 * H * d * valid_pairs, BF16_OPS_PER_S)
    return {
        "name": f"{name} paged_multitoken_attention"
                + (" (int8 pools)" if quant else ""), "route": "cuda",
        "path": path,
        "source": "datatunerx_tpu_torch/csrc/paged_attention.cu",
        "replaces": "datatunerx_tpu/ops/pallas_paged_attention.py:294",
        "counter": cpa.paged_multitoken_attention,
        "count": "int8_launches" if quant else "launches",
        "max_abs_err": err,
        "tolerance": "atol 2^-8 + rtol 2^-7 (bf16)",
        "ms": timer.ms(lambda: cpa.paged_multitoken_attention(
            q, *pools, tables, allow)),
        "plain_ms": timer.ms(lambda: cpa._plain_multitoken(
            q, pools[0], pools[1], tables, allow, pools[2], pools[3]),
            reps=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: sdpa(torch, qs, ks, vs,
                                            allow[:, None])),
        "shape": f"B={B} T={T} H={H} KV={KV} d={d} bs={bs} lens={lens}"
                 + (" 2x3 tree ancestry mask" if tree else " causal"),
    }


def check_k9(torch, timer, gen, V=32000, path=""):
    """K9 against its plain version at vocabulary ``V``; ``path`` as in
    ``check_k7``."""
    from datatunerx_tpu_torch.ops import cuda_sampling as cs

    S = 4
    logits = (torch.randn((S, V), generator=gen) * 2.0).cuda()
    logits[1, 7] = logits[1, 31000] = logits[1].max() + 1.0  # exact tie
    us = torch.rand((S,), generator=gen).cuda()
    err = 0
    results = {}
    for mode, temps in (("greedy", [0.0] * S),
                        ("simple", [0.8, 0.8, 0.0, 1.3])):
        t = torch.tensor(temps, device="cuda")
        x, bn = cs._prep(logits, t, mode=mode)
        greedy = mode == "greedy"
        got = cs.kernel_sample(x, t, us, greedy=greedy)
        want = cs._plain_sample(x, t, us, bn=bn, greedy=greedy)
        torch.cuda.synchronize()
        if greedy and int(got[1]) != 7:
            fail(f"K9 greedy tie: got {int(got[1])}, want the first max 7")
        for r in range(S):
            a, b = int(got[r]), int(want[r])
            if a == b:
                continue
            if greedy or temps[r] <= 0:
                fail(f"K9 {mode} row {r}: kernel {a} != plain {b}")
            # a sampled mismatch is allowed only at a CDF boundary within
            # 1e-5*Z of u*Z between the two tokens (f32 sum order)
            row = x[r].double()
            e = torch.exp(row - row.max())
            cdf, z = torch.cumsum(e, 0), e.sum()
            lo, hi = min(a, b), max(a, b)
            gap = (cdf[lo:hi] - us[r].double() * z).abs().min()
            if float(gap) > 1e-5 * float(z):
                fail(f"K9 simple row {r}: kernel {a} != plain {b}, "
                     "not at a CDF boundary")
        err = max(err, int((got.long() - want.long()).abs().max()))
        if greedy:
            lib = timer.ms(lambda: torch.argmax(x, dim=-1))
        else:
            lib = timer.ms(lambda: torch.multinomial(
                torch.softmax(x, dim=-1), 1))
        results[mode] = {
            "ms": timer.ms(lambda: cs.kernel_sample(x, t, us, greedy=greedy)),
            "plain_ms": timer.ms(lambda: cs._plain_sample(
                x, t, us, bn=bn, greedy=greedy), reps=5),
            "library_ms": lib, "vp": x.shape[1]}
    # the entry reports the simple mode (all three passes) and adds greedy
    vp = results["simple"]["vp"]
    b_ms, b_by = bound_ms(S * vp * 4 + 3 * S * 4, 4 * S * vp, F32_OPS_PER_S)
    log(f"  K9{path} (V={V}) greedy: kernel {results['greedy']['ms']:.4f} ms, plain "
        f"{results['greedy']['plain_ms']:.4f} ms, torch.argmax "
        f"{results['greedy']['library_ms']:.4f} ms")
    r = resources("dtx_sample_resources", 4)
    log("  K9 (a 16-block cluster a row, 256 threads): "
        + describe_resources(r, (("K9", 0),)))
    return {
        "name": f"K9{path} fused_sample", "route": "cuda", "path": path,
        "source": "datatunerx_tpu_torch/csrc/sampling.cu",
        "replaces": "datatunerx_tpu/ops/pallas_sampling.py:97",
        "counter": cs.kernel_sample,
        "max_abs_err": err,
        "tolerance": "token ids exact (sampled rows: up to a CDF boundary "
                     "within 1e-5*Z)",
        "ms": results["simple"]["ms"],
        "plain_ms": results["simple"]["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": results["simple"]["library_ms"],
        "extra": {"greedy_ms": results["greedy"]["ms"],
                  "argmax_ms": results["greedy"]["library_ms"],
                  "registers": r[0], "spill_bytes": r[1],
                  "blocks_per_sm": r[3]},
        "shape": f"S={S} V={V} (Vp={vp}), simple mode; greedy in greedy_ms "
                 "(library: torch.argmax, argmax_ms)",
    }


def empty_kernel_ms(torch, timer):
    """An empty kernel's time under the same ``Timer``: the floor that a
    small kernel's time is read against (printed, not claimed)."""
    from datatunerx_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    return timer.ms(lambda: _build.check(lib.dtx_empty_kernel(stream),
                                         "empty kernel"))


# ------------------------------------------------------------ phase 2, K1-K3
FLASH_TOL = (2**-6, 2**-6)  # bf16: one rounding of f32 sums in another order


def flash_inputs(torch, B, T, H, KV, d, gen, segments=0):
    """bf16 q, k, v, dO on the card; with ``segments`` > 0, ids of that many
    packed segments per row plus a pad tail (id 0)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()

    seg = None
    if segments:
        seg = torch.zeros((B, T), dtype=torch.int32)
        for b in range(B):
            n = segments + b % 3  # 3-5 segments per row
            cuts = sorted(torch.randperm(T - 64, generator=gen)[:n - 1]
                          .add(16).tolist())
            for i, (lo, hi) in enumerate(zip([0] + cuts, cuts + [T - 40])):
                seg[b, lo:hi] = i + 1
        seg = seg.cuda()
    return rnd(B, T, H, d), rnd(B, T, KV, d), rnd(B, T, KV, d), \
        rnd(B, T, H, d), seg


def visible_pairs(torch, B, T, H, seg):
    """(query, key) pairs the causal + segment mask lets through, over all
    heads: what the kernels' work is, counted from this run's data."""
    if seg is None:
        return B * H * T * (T + 1) // 2
    total = 0
    for b in range(B):
        ids, counts = torch.unique(seg[b], return_counts=True)
        total += sum(int(c) * (int(c) + 1) // 2 for c in counts.tolist())
    return total * H


def flash_cases(torch, gen):
    return [
        ("causal", flash_inputs(torch, 8, 1024, 32, 4, 64, gen)),
        ("packed", flash_inputs(torch, 8, 1024, 32, 4, 64, gen, segments=3)),
        ("d128", flash_inputs(torch, 2, 1024, 32, 32, 128, gen)),
        # llama2-7b's heads at the hf-llama2 trainer's batch
        ("llama2", flash_inputs(torch, 8, 1024, 32, 32, 128, gen)),
    ]


TIMED_FLASH = {"causal": ("", "B=8 T=1024 H=32 KV=4 d=64"),
               "llama2": ("@hf-llama2", "B=8 T=1024 H=32 KV=32 d=128")}


def check_flash(torch, timer, gen):
    """K1, K2 and K3 against their plain versions on four inputs; the
    timed entries are the causal cases at the training shapes of
    tinyllama-1.1b and llama2-7b (``TIMED_FLASH``)."""
    from datatunerx_tpu_torch.ops import flash_attention as fa

    out = {}
    for case, (q, k, v, do, seg) in flash_cases(torch, gen):
        B, T, H, d = q.shape
        KV = k.shape[2]
        got_o, got_lse = fa.flash_fwd(q, k, v, seg)
        want_o, want_lse = fa._plain_fwd(q, k, v, seg, True, 512, 512)
        dsum = fa.row_dot(do, want_o)
        got_dq = fa.flash_bwd_dq(q, k, v, do, want_lse, dsum, seg)
        got_dk, got_dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, dsum, seg)
        want_dq = fa._plain_bwd_dq(q, k, v, do, want_lse, dsum, seg, True,
                                   512, 512)
        want_dk, want_dv = fa._plain_bwd_dkv(q, k, v, do, want_lse, dsum,
                                             seg, True, 512, 512)
        torch.cuda.synchronize()
        errs = {}
        for name, pairs in (("K1", [(got_o, want_o)]),
                            ("K2", [(got_dq, want_dq)]),
                            ("K3", [(got_dk, want_dk), (got_dv, want_dv)])):
            err = 0.0
            for got, want in pairs:
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"{name} ({case}) wrote non-finite values")
                ok, e = close_enough(torch, got, want, *FLASH_TOL)
                if not ok:
                    fail(f"{name} ({case}) disagrees with its plain version:"
                         f" max abs err {e}")
                err = max(err, e)
            errs[name] = err
        lse_err = float((got_lse - want_lse).abs().max())
        if lse_err > 1e-3:
            fail(f"K1 ({case}) lse differs from the plain version by "
                 f"{lse_err}")
        pairs = visible_pairs(torch, B, T, H, seg)
        io = 2 * (2 * B * T * H * d + 2 * B * T * KV * d)  # q,o|dO + k,v
        stats = 2 * B * H * T * 4
        seg_b = 0 if seg is None else B * T * 4
        bounds = {
            "K1": bound_ms(io + B * H * T * 4 + seg_b, 4 * d * pairs,
                           BF16_OPS_PER_S),
            "K2": bound_ms(io + 2 * B * T * H * d + stats + seg_b,
                           6 * d * pairs, BF16_OPS_PER_S),
            "K3": bound_ms(io + 4 * B * T * KV * d + stats + seg_b,
                           8 * d * pairs, BF16_OPS_PER_S),
        }
        ms = {
            "K1": timer.ms(lambda: fa.flash_fwd(q, k, v, seg)),
            "K2": timer.ms(lambda: fa.flash_bwd_dq(q, k, v, do, want_lse,
                                                   dsum, seg)),
            "K3": timer.ms(lambda: fa.flash_bwd_dkv(q, k, v, do, want_lse,
                                                    dsum, seg)),
        }
        line = (f"  flash {case} [B={B} T={T} H={H} KV={KV} d={d}"
                f"{'' if seg is None else ', 3-5 segments/row'}]: " + ", ".join(
                    f"{n} {ms[n]:.3f} ms (err {errs[n]:.3g}, bound "
                    f"{bounds[n][0]:.4f})" for n in ms))
        log(line)
        lib_fwd = sdpa_fwd_ms(torch, timer, q, k, v, seg)
        log(f"  flash {case}: K1 {ms['K1']:.4f} ms vs SDPA forward "
            f"{lib_fwd:.4f} ms: {ms['K1'] / lib_fwd:.2f}x")
        lib_bwd = sdpa_bwd_ms(torch, timer, q, k, v, do, seg)
        pair = ms["K2"] + ms["K3"]
        log(f"  flash {case}: K2+K3 {pair:.4f} ms vs SDPA backward (dQ, dK, dV "
            f"together) {lib_bwd:.4f} ms: {pair / lib_bwd:.2f}x")
        out[case] = (errs, ms, bounds)
        if case not in TIMED_FLASH:
            continue
        plain = {
            "K1": timer.ms(lambda: fa._plain_fwd(q, k, v, seg, True, 512,
                                                 512), reps=3, warmup=1),
            "K2": timer.ms(lambda: fa._plain_bwd_dq(
                q, k, v, do, want_lse, dsum, seg, True, 512, 512), reps=3,
                warmup=1),
            "K3": timer.ms(lambda: fa._plain_bwd_dkv(
                q, k, v, do, want_lse, dsum, seg, True, 512, 512), reps=3,
                warmup=1),
        }
        qs, ks, vs, dos = (t.transpose(1, 2) for t in (q, k, v, do))
        leaf = [t.detach().requires_grad_() for t in (qs, ks, vs)]

        def fwd_bwd():
            o2 = sdpa(torch, *leaf, causal=True)
            torch.autograd.grad(o2, leaf, dos)

        lib_fb = timer.ms(fwd_bwd)
        log(f"  SDPA (library yardstick, causal case): forward "
            f"{lib_fwd:.3f} ms, backward {lib_bwd:.3f} ms, forward+backward "
            f"{lib_fb:.3f} ms; kernels K1+K2+K3 "
            f"{ms['K1'] + ms['K2'] + ms['K3']:.3f} ms")
        out[case] += (plain, {"K1": lib_fwd, "K2": lib_bwd, "K3": lib_bwd})
    log_flash_resources()
    meta = {
        "K1": ("K1 flash_fwd", "datatunerx_tpu/ops/flash_attention.py:85",
               fa.flash_fwd),
        "K2": ("K2 flash_bwd_dq", "datatunerx_tpu/ops/flash_attention.py:191",
               fa.flash_bwd_dq),
        "K3": ("K3 flash_bwd_dkv",
               "datatunerx_tpu/ops/flash_attention.py:233", fa.flash_bwd_dkv),
    }
    entries = []
    for case, (path, shape) in TIMED_FLASH.items():
        errs, ms, bounds, plain, lib = out[case]
        for key, (name, replaces, counter) in meta.items():
            library = ("SDPA forward" if key == "K1" else "SDPA backward "
                       "(dQ, dK, dV together), compare with K2+K3")
            first, rest = name.split(" ", 1)
            entries.append({
                "name": f"{first}{path} {rest}", "route": "cuda",
                "path": path,
                "source": "datatunerx_tpu_torch/csrc/flash_attention.cu",
                "replaces": replaces, "counter": counter,
                "max_abs_err": max(out[c][0][key] for c in
                                   ("causal", "packed", "d128", "llama2")),
                "tolerance": "atol 2^-6 + rtol 2^-6 (bf16), "
                             "causal/packed/d128/llama2",
                "ms": ms[key], "plain_ms": plain[key],
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": lib[key], "library": library,
                "shape": f"{shape} causal bf16 (timed); library: " + library,
            })
    return entries


K3_SWEEP_SEEDS = tuple(range(8))


def check_k3_sweep(torch):
    """K3 against its plain version over ``K3_SWEEP_SEEDS`` draws of the
    packed and llama2 cases (untimed), each draw from a generator of its
    own; every draw holds ``FLASH_TOL``. Prints, per output, the largest
    error as a share of its element's bound and that element's |want|."""
    from datatunerx_tpu_torch.ops import flash_attention as fa

    worst = 0.0
    for seed in K3_SWEEP_SEEDS:
        gen = torch.Generator().manual_seed(1000 + seed)
        for case, shape, segs in (("packed", (8, 1024, 32, 4, 64), 3),
                                  ("llama2", (8, 1024, 32, 32, 128), 0)):
            q, k, v, do, seg = flash_inputs(torch, *shape, gen,
                                            segments=segs)
            o, lse = fa._plain_fwd(q, k, v, seg, True, 512, 512)
            dsum = fa.row_dot(do, o)
            got = fa.flash_bwd_dkv(q, k, v, do, lse, dsum, seg)
            want = fa._plain_bwd_dkv(q, k, v, do, lse, dsum, seg, True, 512,
                                     512)
            parts = []
            for name, g, w in zip(("dK", "dV"), got, want):
                g, w = g.float(), w.float()
                share = (g - w).abs() / (FLASH_TOL[0] + FLASH_TOL[1] * w.abs())
                i = int(share.argmax())
                r = float(share.flatten()[i])
                worst = max(worst, r)
                parts.append(f"{name} {r:.3f} of its bound (err "
                             f"{float((g - w).abs().flatten()[i]):.4g}, "
                             f"|want| {float(w.abs().flatten()[i]):.4g})")
                if r > 1.0 or not bool(torch.isfinite(g).all()):
                    fail(f"K3 sweep seed {seed} {case}: {parts[-1]}")
            log(f"  K3 sweep seed {seed} {case}: " + "; ".join(parts))
            del q, k, v, do, seg, o, lse, dsum, got, want
    log(f"  K3 sweep: {len(K3_SWEEP_SEEDS)} seeds x 2 cases, worst "
        f"{worst:.3f} of the bound")
    return worst


def describe_resources(r, names):
    return "; ".join(f"{n} {r[i]} registers, {r[i + 1]} spill bytes, "
                     f"{r[i + 2]} shared bytes, {r[i + 3]} blocks/SM"
                     for n, i in names)


def resources(entry, n, *args):
    """What a kernel takes of an SM, as built: the ``n`` ints the C entry
    ``entry`` (a ``dtx_*_resources``) writes, four a variant: registers,
    spill bytes, shared bytes, blocks/SM (the compiler's registers and
    spills, as ``nvcc -Xptxas -v`` reports them)."""
    import ctypes

    from datatunerx_tpu_torch.ops import _build

    r = (ctypes.c_int * n)()
    _build.check(getattr(_build.library(), entry)(*args,
                                                  ctypes.addressof(r)), entry)
    return list(r)


def log_flash_resources():
    """What the bf16 K1, K2 and K3 take of an SM, as built."""
    for d in (64, 128):
        r = (resources("dtx_flash_fwd_resources", 4, d)
             + resources("dtx_flash_bwd_resources", 8, d))
        log(f"  bf16 K1/K2/K3 at d={d}: "
            + describe_resources(r, (("K1", 0), ("K2", 4), ("K3", 8))))


def log_k8_resources(G, d, tq):
    """What the bf16 K8 (over bf16 and over int8 pools) takes of an SM at
    the smoke shape's G, d and row tile, as built."""
    r = resources("dtx_paged_multitoken_resources", 8, d, G, tq)
    log(f"  bf16 K8 at G={G} d={d} tq={tq} ({-(-G * tq // 16)} row groups "
        f"of 16, each over {4 if d <= 64 else 2} key splits): "
        + describe_resources(r, (("bf16 pools", 0), ("int8 pools", 4))))


def kernel_name(traced):
    """A traced kernel's name without its return type, namespace, template
    and parameter lists."""
    name = traced.replace("(anonymous namespace)::", "").split("<")[0]
    return name.split("(")[0].split()[-1] if name.split() else traced


def cuda_kernels(torch, fn, windows=3):
    """The names of the CUDA kernels one call of ``fn`` launched, as
    torch.profiler traced them on the card. A window that recorded no
    device event at all is opened again, up to ``windows`` times: CUPTI
    has been seen to hand back an empty window for a single short call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return []


def segment_mask(torch, q, k, seg):
    """The causal same-segment mask [B, 1, T, T] of a packed batch, and the
    GQA group size to repeat K and V by (a masked SDPA may not take GQA)."""
    T = q.shape[1]
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    mask = (seg[:, None, :, None] == seg[:, None, None, :]) & causal
    return mask, q.shape[2] // k.shape[2]


def sdpa_fwd_ms(torch, timer, q, k, v, seg):
    """SDPA forward's device time on the inputs of a flash case: causal,
    and with ``seg`` the same-segment mask."""
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    if seg is None:
        return timer.ms(lambda: sdpa(torch, qs, ks, vs, causal=True))
    mask, G = segment_mask(torch, q, k, seg)
    ks, vs = ks.repeat_interleave(G, 1), vs.repeat_interleave(G, 1)
    return timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))


def sdpa_bwd_ms(torch, timer, q, k, v, do, seg):
    """SDPA backward's device time on the inputs of a flash case: causal,
    and with ``seg`` the same-segment mask (K and V repeated to the query
    heads beforehand, since a masked SDPA may not take GQA)."""
    qs, ks, vs, dos = (t.transpose(1, 2) for t in (q, k, v, do))
    mask = None
    if seg is not None:
        mask, G = segment_mask(torch, q, k, seg)
        ks, vs = ks.repeat_interleave(G, 1), vs.repeat_interleave(G, 1)
    leaf = [t.detach().requires_grad_() for t in (qs, ks, vs)]
    if mask is None:
        o = sdpa(torch, *leaf, causal=True)
    else:
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaf, attn_mask=mask)
    return timer.ms(lambda: torch.autograd.grad(o, leaf, dos,
                                                retain_graph=True))


# ------------------------------------------------------------ phase 2, K4-K6
QUANT_M = 8192  # packed B8 x T1024 rows
# (projections, K, N, how many per layer) of tinyllama-1.1b
QUANT_SHAPES = (("q/o", 2048, 2048, 2), ("k/v", 2048, 256, 2),
                ("gate/up", 2048, 5632, 2), ("down", 5632, 2048, 1))
# the staged weights are bit-equal to the plain version's; the f32 sums
# (over up to 5632 products, in another order) round once to the dtype
QUANT_TOL = {"bf16": (2**-8, 2**-7), "f32": (1e-4, 1e-4)}


def check_quant(torch):
    """K4, K5 and K6 against their plain versions at M=8192 and every
    projection shape of tinyllama-1.1b, in bf16 and f32. An entry's times
    and bound are one layer's worth: the sum over its seven projections
    (bf16); the library yardstick is cuBLAS's bf16 matmul on a W dequantized
    beforehand (it does not pay the dequant)."""
    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import quant as tq

    # name, TPU kernel, launch counter, bf16 source, its resources' offset
    meta = {
        "K4": ("K4 nf4_matmul", "datatunerx_tpu/ops/pallas_quant.py:109",
               cq.nf4_matmul, "nf4_gemm.cu", 0),
        "K5": ("K5 nf4_matmul_t", "datatunerx_tpu/ops/pallas_quant.py:210",
               cq.nf4_matmul_t, "nf4_gemm.cu", 4),
        "K6": ("K6 int8_matmul", "datatunerx_tpu/ops/pallas_quant.py:40",
               cq.int8_matmul, "int8_gemm.cu", 8),
    }
    timer = Timer(torch)
    M = QUANT_M
    cgen = torch.Generator(device="cuda").manual_seed(4)
    tot = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bound_ms=0.0, by_bytes=0.0, by_ops=0.0) for k in meta}
    for label, K, N, count in QUANT_SHAPES:
        w = torch.randn((K, N), generator=cgen, device="cuda") * 0.02
        qw, q8 = tq.quantize_nf4(w), tq.quantize_int8(w)
        del w
        nf4_w = N * K // 2 + N * K // 64 + 8  # packed, scale_q, meta
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = torch.randn((M, K), generator=cgen, device="cuda").to(dtype)
            g = torch.randn((M, N), generator=cgen, device="cuda").to(dtype)
            calls = {
                "K4": (lambda: cq.nf4_matmul(x, qw, (K, N)),
                       lambda: tq.matmul_nf4(x, qw, (K, N))),
                "K5": (lambda: cq.nf4_matmul_t(g, qw, (K, N)),
                       lambda: cq._plain_nf4_t(g, qw, (K, N))),
                "K6": (lambda: cq.int8_matmul(x, q8["q"], q8["scale"]),
                       lambda: tq.matmul_int8(x, q8["q"], q8["scale"])),
            }
            for key, (kern, plain) in calls.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"{key} ({label}, {dt}) wrote non-finite values")
                ok, err = close_enough(torch, got, want, *QUANT_TOL[dt])
                if not ok:
                    fail(f"{key} ({label}, {dt}) disagrees with its plain "
                         f"version: max abs err {err}")
                tot[key]["err"] = max(tot[key]["err"], err)
            if dtype is not torch.bfloat16:
                continue
            wd = tq.dequant_nf4(qw, (K, N), dtype=dtype).contiguous()
            w8 = tq.dequant_int8(q8["q"], q8["scale"], dtype=dtype)
            library = {"K4": lambda: torch.matmul(x, wd),
                       "K5": lambda: torch.matmul(g, wd.T),
                       "K6": lambda: torch.matmul(x, w8)}
            nbytes = {"K4": 2 * M * K + nf4_w + 2 * M * N,
                      "K5": 2 * M * N + nf4_w + 2 * M * K,
                      "K6": 2 * M * K + K * N + 4 * N + 2 * M * N}
            parts = []
            for key, (kern, plain) in calls.items():
                b_ms, b_by = bound_ms(nbytes[key], 2 * M * K * N,
                                      BF16_OPS_PER_S)
                ms, lib_ms = timer.ms(kern), timer.ms(library[key])
                t = tot[key]
                t["ms"] += count * ms
                t["plain_ms"] += count * timer.ms(plain, reps=3, warmup=1)
                t["library_ms"] += count * lib_ms
                t["bound_ms"] += count * b_ms
                t["by_bytes" if b_by == "bytes" else "by_ops"] += count * b_ms
                parts.append(f"{key} {ms:.3f} ms "
                             f"({2 * M * K * N / ms / 1e9:.0f} TFLOP/s; "
                             f"cuBLAS {lib_ms:.3f}; bound {b_ms:.4f} {b_by})")
            log(f"  quant {label} [M={M} K={K} N={N} bf16]: "
                + ", ".join(parts))
            del wd, w8
        del qw, q8, x, g
    r = (resources("dtx_nf4_matmul_resources", 8)
         + resources("dtx_int8_matmul_resources", 4))
    log("  bf16 K4/K5/K6 (TMA + wgmma, 128 x 256 tiles, 384 threads): "
        + describe_resources(r, (("K4", 0), ("K5", 4), ("K6", 8))))
    entries = []
    for key, (name, replaces, counter, source, i) in meta.items():
        t = tot[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": (f"datatunerx_tpu_torch/csrc/{source} (bf16), "
                       "datatunerx_tpu_torch/csrc/quant.cu (f32)"),
            "replaces": replaces, "counter": counter,
            "extra": {"registers": r[i], "spill_bytes": r[i + 1],
                      "shared_bytes": r[i + 2], "blocks_per_sm": r[i + 3]},
            "max_abs_err": t["err"],
            "tolerance": "atol 2^-8 + rtol 2^-7 (bf16), 1e-4 + 1e-4 (f32), "
                         "all four shapes",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["by_ops"] >= t["by_bytes"]
                         else "bytes"),
            "shape": f"one layer's 7 projections at M={M} bf16 (2x q/o "
                     "2048x2048, 2x k/v 2048x256, 2x gate/up 2048x5632, "
                     "down 5632x2048), summed; library: cuBLAS bf16 matmul "
                     "on W dequantized beforehand",
        })
    return entries


# ------------------------------------------------------------- phase 2, K10
LORA_K, LORA_R, LORA_SCALE = 2048, 8, 32 / 8  # tinyllama-1.1b, r8 alpha 32
# (label, M, N): a packed B8 x T1024 training batch and a 4-slot decode
# step, on q_proj (2048 x 2048) and v_proj (2048 x 256)
LORA_SHAPES = (("train q_proj", 8192, 2048), ("train v_proj", 8192, 256),
               ("decode q_proj", 4, 2048), ("decode v_proj", 4, 256))
# kernel and plain version round at the same points; their f32 sums (over
# 2048 products) run in another order and round once to the dtype
LORA_TOL = {"bf16": (2**-8, 2**-7), "f32": (1e-4, 1e-4)}


def lora_operands(torch, M, N, dtype, gen):
    def rnd(shape, s):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype)

    return (rnd((M, LORA_K), 1.0), rnd((LORA_K, N), 0.02),
            rnd((LORA_K, LORA_R), 0.02), rnd((LORA_R, N), 0.02))


def check_k10(torch):
    """K10 against its plain version at the four shapes above in bf16 and
    f32, each case timed beside the composite ``x @ w + ((x @ a) @ b) *
    scale`` on cuBLAS (which writes the [M, N] delta and the [M, r] strip to
    device memory). The entry's own numbers are the M=8192, N=2048 bf16
    case's; ``cases`` holds all eight."""
    from datatunerx_tpu_torch.ops import cuda_lora as cl

    timer = Timer(torch)
    cgen = torch.Generator(device="cuda").manual_seed(6)
    err, cases = 0.0, []
    K, r, scale = LORA_K, LORA_R, LORA_SCALE
    for label, M, N in LORA_SHAPES:
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, w, a, b = lora_operands(torch, M, N, dtype, cgen)

            def kern():
                return cl.lora_matmul(x, w, a, b, scale)

            def plain():
                return cl._plain_lora_matmul(x, w, a, b, scale)

            def library():
                return x @ w + ((x @ a) @ b) * scale

            got = kern()
            route, splits, cv = cl.lora_matmul.last  # as launched
            want = plain()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got.float()).all()):
                fail(f"K10 ({label}, {dt}) wrote non-finite values")
            ok, e = close_enough(torch, got, want, *LORA_TOL[dt])
            if not ok:
                fail(f"K10 ({label}, {dt}) disagrees with its plain version: "
                     f"max abs err {e}")
            err = max(err, e)
            size = 2 if dt == "bf16" else 4
            nbytes = size * (M * K + K * N + K * r + r * N + M * N)
            ops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
            b_ms, b_by = bound_ms(nbytes, ops, BF16_OPS_PER_S if dt == "bf16"
                                  else F32_OPS_PER_S)
            ms, lib_ms = timer.ms(kern), timer.ms(library)
            plain_ms = timer.ms(plain, reps=3, warmup=1)
            plan = f", S={splits} CV={cv}" if route == "split" else ""
            log(f"  K10 {label} [M={M} K={K} N={N} r={r} {dt}, {route}"
                f"{plan}]: err {e:.3g}, kernel {ms:.4f} ms "
                f"({ops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.0f} "
                f"GB/s), plain {plain_ms:.4f} ms, "
                f"composite on cuBLAS {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by})")
            cases.append(dict(case=f"{label} {dt}", M=M, N=N, route=route,
                              splits=splits, column_vectors=cv, ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by))
            del x, w, a, b
    r_gemm = resources("dtx_lora_gemm_resources", 8)
    r_split = resources("dtx_lora_split_resources", 8)
    log("  K10 many-row bf16 (TMA + wgmma, 384 threads): "
        + describe_resources(r_gemm, (("128 x 256 tiles", 0),
                                      ("128 x 128 tiles", 4)))
        + "; split (a cluster of K splits, 256 threads): "
        + describe_resources(r_split, (("bf16", 0), ("f32", 4))))
    first = {k: cases[0][k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}
    return [dict(first, **{
        "name": "K10 lora_matmul", "route": "cuda",
        "source": ("datatunerx_tpu_torch/csrc/lora_gemm.cu (bf16, many rows), "
                   "datatunerx_tpu_torch/csrc/lora.cu (few rows; f32)"),
        "replaces": "datatunerx_tpu/ops/pallas_lora.py:27",
        "counter": cl.lora_matmul, "max_abs_err": err,
        "tolerance": "atol 2^-8 + rtol 2^-7 (bf16), 1e-4 + 1e-4 (f32), all "
                     "eight cases",
        "extra": {"cases": cases,
                  "registers": [r_gemm[0], r_gemm[4], r_split[0], r_split[4]],
                  "spill_bytes": [r_gemm[1], r_gemm[5], r_split[1],
                                  r_split[5]],
                  "blocks_per_sm": [r_gemm[3], r_gemm[7], r_split[3],
                                    r_split[7]]},
        "shape": f"M=8192 K={K} N=2048 r={r} bf16 (its numbers; cases: all "
                 "eight); library: the composite on cuBLAS",
    })]


def lora_phase(torch):
    """K10's own path: ``lora_matmul`` at tinyllama-1.1b's adapted
    projections, against the f32 composite of the same bf16 operands."""
    from datatunerx_tpu_torch.ops import cuda_lora as cl

    cgen = torch.Generator(device="cuda").manual_seed(7)
    cl.lora_matmul.launches = 0
    for label, M, N in LORA_SHAPES:
        x, w, a, b = lora_operands(torch, M, N, torch.bfloat16, cgen)
        lead = (8, 1024) if M == 8192 else (4, 1)  # [B, T, K], as a model's
        got = cl.lora_matmul(x.reshape(*lead, LORA_K), w, a, b, LORA_SCALE)
        torch.cuda.synchronize()
        if tuple(got.shape) != (*lead, N) or got.dtype != torch.bfloat16:
            fail(f"lora_matmul ({label}) returned {tuple(got.shape)} "
                 f"{got.dtype}")
        xf, wf, af, bf = (t.float() for t in (x, w, a, b))
        want = xf @ wf + ((xf @ af) @ bf) * LORA_SCALE
        ok, e = close_enough(torch, got.reshape(M, N), want, 2**-5, 2**-6)
        if not ok:
            fail(f"lora_matmul ({label}) is off the f32 composite by {e}")
        delta = float((want - xf @ wf).abs().max())
        log(f"  {label} [{'x'.join(map(str, lead))}x{LORA_K} -> {N}]: max "
            f"abs err {e:.3g} vs the f32 composite (adapter delta up to "
            f"{delta:.3g})")
    n = cl.lora_matmul.launches
    if n != len(LORA_SHAPES):
        fail(f"lora phase: {n} K10 launches, expected {len(LORA_SHAPES)}")
    return {"lora_matmul": n}


# ------------------------------------------------------------------ phase 3
def post(port, body, stream=False, trace=""):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/chat/completions",
        data=json.dumps(dict(body, stream=stream)).encode(),
        headers={"Content-Type": "application/json",
                 "X-DTX-Trace-Id": trace})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}")
        if not stream:
            out = json.loads(resp.read())
            return {"text": out["choices"][0]["message"]["content"],
                    "keys": sorted(out), "usage": out.get("usage"),
                    "wall_s": time.perf_counter() - t0}
        text, first = "", None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[len("data: "):])
            if "error" in ev:
                raise RuntimeError(ev["error"])
            delta = ev["choices"][0]["delta"].get("content")
            if delta and first is None:
                first = time.perf_counter() - t0
            text += delta or ""
        return {"text": text, "keys": ["stream"], "first_delta_s": first,
                "wall_s": time.perf_counter() - t0}


def start_server(torch, flags, model="preset:tinyllama-1.1b", state=None):
    """The port's server, in-process, for ``model`` with ``flags``;
    returns (srv, port, engine) once ``/healthz`` answers 200. ``state``
    (a ``ServingState``; default the module's) holds the engine, so that
    two servers can run side by side."""
    from datatunerx_tpu_torch.serving import server

    state = state or server.STATE
    args = server.parse_args([
        "--model_path", model, *flags,
        "--host", "127.0.0.1", "--port", "0"])
    srv = server.start(args, state=state)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    t0 = time.perf_counter()
    while state.engine is None:
        if state.error:
            fail(f"engine failed to load: {state.error}")
        if time.perf_counter() - t0 > 600:
            fail("engine did not load within 600 s")
        time.sleep(0.2)
    eng = state.engine
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        if r.status != 200:
            fail(f"/healthz answered {r.status} after load")
    log(f"  {type(eng).__name__} loaded in {time.perf_counter() - t0:.1f} "
        f"s: quantization={eng.cfg.quantization}")
    # warm-up request (first-call allocations), not counted
    post(port, {"messages": [{"role": "user", "content": "warm up"}],
                "max_tokens": 8})
    return srv, port, eng


def stop_server(srv, state=None):
    from datatunerx_tpu_torch.serving import server

    srv.shutdown()
    srv.server_close()
    state = state or server.STATE
    if state.slo is not None:
        state.slo.stop()  # the server's SLO sampler thread
    # the server's module state would keep the engine's weights and cache on
    # the card after the caller closes it, inside the train phases' peaks
    state.engine = None


def serve_phase(torch, counters, flags=("--kv_block_size", "16",
                                        "--slots", "4"), greedy_only=False):
    """Concurrent ``/chat/completions`` through the server started with
    ``flags``; ``counters`` are ``(wrapper, count attribute)`` pairs, zeroed
    just before the requests and read just after."""
    srv, port, eng = start_server(torch, flags)
    log(f"  decode_path={eng.decode_path} sampling_epilogue="
        f"{eng.sampling_epilogue} kv_quant={eng.kv_quant} "
        f"kv_blocks={eng.total_kv_blocks} kv_cache_bytes="
        f"{eng.kv_cache_bytes}")
    long_q = " ".join(f"item {i}: the quick brown fox." for i in range(40))
    reqs = [
        ("greedy-long", {"messages": [{"role": "user", "content": long_q}],
                         "max_tokens": 64}, False),
        ("greedy-sse", {"messages": [{"role": "user",
                                      "content": "Stream me a story."}],
                        "max_tokens": 64}, True),
        ("sampled-a", {"messages": [{"role": "user", "content": "Say hi."}],
                       "max_tokens": 64, "temperature": 0.8, "top_p": 1.0},
         False),
        ("sampled-b", {"messages": [{"role": "user",
                                     "content": "Count to ten."}],
                       "max_tokens": 64, "temperature": 0.8, "top_p": 1.0},
         False),
    ]
    if greedy_only:
        reqs = reqs[:2]
    def batch():
        """The requests, all at once; (results, wall seconds, stats by
        request name)."""
        eng.request_stats.clear()
        results, errors = {}, []

        def run(name, body, stream):
            try:
                results[name] = post(port, body, stream=stream, trace=name)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{name}: {e}")

        threads = [threading.Thread(target=run, args=r) for r in reqs]
        t_start = time.perf_counter()
        for th_ in threads:
            th_.start()
        for th_ in threads:
            th_.join(timeout=900)
        wall = time.perf_counter() - t_start
        if errors or len(results) != len(reqs):
            fail(f"serve phase: {errors or 'requests did not finish'}")
        return results, wall, {s["trace_id"]: s for s in eng.request_stats}

    for c, attr in counters:
        setattr(c, attr, 0)
    results, wall, stats = batch()
    launches = {counter_key(c, attr): getattr(c, attr)
                for c, attr in counters}
    total = 0
    for name, _, _ in reqs:
        st = stats.get(name)
        if st is None or st["tokens"] <= 0:
            fail(f"{name}: the engine emitted no tokens")
        if not isinstance(results[name]["text"], str):
            fail(f"{name}: no content string in the response")
        total += st["tokens"]
        tps = (1.0 / st["tpot_s"]) if st["tpot_s"] else float("nan")
        log(f"  {name}: 200, {st['tokens']} tokens "
            f"({len(results[name]['text'])} chars of text), TTFT "
            f"{st['ttft_s'] * 1e3:.1f} ms, decode {tps:.1f} tok/s per request")
    if results["greedy-sse"].get("first_delta_s") is None and \
            results["greedy-sse"]["text"]:
        fail("greedy-sse: text arrived without a delta event")
    if eng.paged and _most_chunks(eng.sched_trace) < 2:
        fail("no prompt was prefilled in two or more chunks")
    log(f"  {len(reqs)} concurrent requests: {total} tokens in {wall:.2f} s "
        f"wall ({total / wall:.1f} tok/s aggregate), launches {launches}")
    first = {"ttft_ms": median([s["ttft_s"] * 1e3 for s in stats.values()]),
             "tok_s": median([1.0 / s["tpot_s"] for s in stats.values()
                              if s["tpot_s"]]),
             "aggregate": total / wall}
    for name, n in launches.items():
        if n <= 0:
            fail(f"serve phase: kernel {name} was never launched")
    stop_server(srv)
    return eng, launches, {"wall_s": wall, "tokens": total, **first}


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def counter_key(counter, attr="launches") -> str:
    """A kernel's key in the launch table: its wrapper's name, with
    ``:int8`` for the count of its int8 instantiation."""
    return counter.__name__ + (":int8" if attr == "int8_launches" else "")


def _most_chunks(sched_trace) -> int:
    """Most prefill chunks any one admission took."""
    cur, best = {}, 0
    for ev in list(sched_trace):
        if ev[0] == "admit":
            cur[ev[1]] = 0
        elif ev[0] == "prefill":
            cur[ev[1]] = cur.get(ev[1], 0) + 1
            best = max(best, cur[ev[1]])
    return best


# ------------------------------------------------------------ phase 3-obs
OBS_SLO = {"name": "serving-ttft", "objective": 0.95,
           "sli": {"kind": "latency", "metric": "dtx_serving_ttft_ms",
                   "threshold_ms": 2500}}
OBS_REQS = [
    ("obs-greedy", {"messages": [{"role": "user", "content":
                                  "Describe the sea in three sentences."}],
                    "max_tokens": 64}, False),
    ("obs-greedy-sse", {"messages": [{"role": "user",
                                      "content": "Stream me a story."}],
                        "max_tokens": 64}, True),
    ("obs-sampled-a", {"messages": [{"role": "user", "content": "Say hi."}],
                       "max_tokens": 64, "temperature": 0.8}, False),
    ("obs-sampled-b", {"messages": [{"role": "user",
                                     "content": "Count to ten."}],
                       "max_tokens": 64, "temperature": 0.8}, False),
]
# the gateway's HTTPReplica scrape reads these families off a replica
GATEWAY_FAMILIES = (
    "dtx_serving_slots_busy", "dtx_serving_slots_capacity",
    "dtx_serving_kv_blocks_free", "dtx_serving_kv_blocks_capacity",
    "dtx_serving_kv_block_size", "dtx_serving_sessions_parked",
    "dtx_serving_role", "dtx_serving_spec_enabled",
    "dtx_serving_spec_accept_rate", "dtx_serving_adapter_resident",
    "dtx_serving_adapter_registered")
K7_SYMBOL, K9_SYMBOL = "paged_decode_split_kernel", "fused_sample_kernel"
K8_SYMBOL = "paged_multitoken"  # the mma (bf16) and the f32 instantiation


def http_get(port, path):
    """(status, body text) of a GET on the local server."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def parse_metrics(text):
    """An exposition's samples ({series: value}) and families ({name:
    type}); fails on a sample before its family's ``# TYPE``, a second
    ``# TYPE`` for one name or a duplicate series."""
    from datatunerx_tpu_torch.obs.metrics import annotation_start

    types, samples = {}, {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, mtype = ln.split(None, 3)
            if name in types:
                fail(f"/metrics: a second # TYPE for {name}")
            types[name] = mtype
            continue
        if not ln or ln.startswith("#"):
            continue
        cut = annotation_start(ln)
        series, value = (ln[:cut] if cut >= 0 else ln).rsplit(None, 1)
        name = series.split("{")[0]
        family = next((f for f in (name, name.rsplit("_", 1)[0])
                       if f in types), None)
        if family is None:
            fail(f"/metrics: sample {series} before its family's # TYPE")
        if series in samples:
            fail(f"/metrics: duplicate series {series}")
        samples[series] = float(value)
    return samples, types


def annotation_ranges(events, name):
    """(start, end) in µs of every ``name`` range on the host timeline."""
    return sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("name") == name and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")


def read_profile(path):
    """The engine ranges and the K7/K8/K9 kernels of a Chrome trace, and
    how many K7 launches (the host call that launched the kernel, found
    through its correlation id) lie inside a ``dtx_engine_decode`` range."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    decode = annotation_ranges(events, "dtx_engine_decode")
    prefill = annotation_ranges(events, "dtx_engine_prefill_chunk")
    kernels = {"K7": [], "K8": [], "K9": []}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        n = e.get("name", "")
        for key, sym in (("K7", K7_SYMBOL), ("K8", K8_SYMBOL),
                         ("K9", K9_SYMBOL)):
            if sym in n:
                kernels[key].append(e)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    inside = 0
    for k in kernels["K7"]:
        ts = launch_ts.get(k.get("args", {}).get("correlation"))
        if ts is not None and any(a <= ts <= b for a, b in decode):
            inside += 1
    return decode, prefill, kernels, inside


def obs_phase(torch, counters, card):
    """3-obs (see the module docstring). ``counters`` are K7, K8 and K9's
    ``(wrapper, attribute)``; ``card`` the card's name and power limit, as
    nvidia-smi prints them, for the summary line."""
    from datatunerx_tpu_torch.obs.profiling import process_profiler
    from datatunerx_tpu_torch.serving import server
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    tmp = tempfile.mkdtemp(prefix="dtx-obs-")
    os.environ["DTX_PROFILE_DIR"] = tmp
    spans_path = os.path.join(tmp, "spans.jsonl")
    state = server.ServingState()
    srv, port, eng = start_server(torch, (
        "--kv_block_size", "16", "--slots", "4", "--trace_ring", "64",
        "--trace_log", spans_path, "--slo_config", json.dumps([OBS_SLO]),
        "--slo_sample_s", "0.5"), state=state)
    names = [r[0] for r in OBS_REQS]

    def scrape():
        code, text = http_get(port, "/metrics")
        if code != 200:
            fail(f"3-obs: /metrics answered {code}")
        return parse_metrics(text)

    def batch(label, watch=None):
        """The four requests at once; (results, stats by trace id)."""
        eng.request_stats.clear()
        results, errors = {}, []

        def run(name, body, stream):
            try:
                results[name] = post(port, body, stream=stream, trace=name)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{name}: {e}")

        threads = [threading.Thread(target=run, args=r) for r in OBS_REQS]
        for th_ in threads:
            th_.start()
        if watch is not None:
            watch()
        for th_ in threads:
            th_.join(timeout=900)
        if errors or len(results) != len(OBS_REQS):
            fail(f"3-obs {label}: {errors or 'requests did not finish'}")
        return results, {s["trace_id"]: s for s in eng.request_stats}

    scrape_ms = []

    def time_scrapes():
        """Once all 4 slots hold a request, time 5 scrapes."""
        t0 = time.perf_counter()
        while sum(r is not None for r in eng._slot_req) < 4:
            if time.perf_counter() - t0 > 120:
                fail("3-obs: the 4 slots never were busy at once")
            time.sleep(0.001)
        for _ in range(5):
            t1 = time.perf_counter()
            scrape()
            scrape_ms.append((time.perf_counter() - t1) * 1e3)

    before, types = scrape()
    results, stats = batch("batch 1", watch=time_scrapes)
    after, types = scrape()
    missing = [f for f in GATEWAY_FAMILIES if f not in types]
    if missing:
        fail(f"3-obs: /metrics lacks the gateway's families {missing}")
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in (
        "dtx_serving_ttft_ms_count", "dtx_serving_tpot_ms_count",
        "dtx_serving_ttft_ms_sum", "dtx_serving_tpot_ms_sum")}
    multi = sum(1 for n in names if stats[n]["tpot_s"] is not None)
    ttft_sum = sum(stats[n]["ttft_s"] * 1e3 for n in names)
    log(f"  /metrics: {len(types)} families, {len(after)} series; TTFT "
        f"count +{moved['dtx_serving_ttft_ms_count']:g}, TPOT count "
        f"+{moved['dtx_serving_tpot_ms_count']:g}; TTFT sum "
        f"+{moved['dtx_serving_ttft_ms_sum']:.3f} ms against request_stats' "
        f"{ttft_sum:.3f} ms")
    if (moved["dtx_serving_ttft_ms_count"] != 4
            or moved["dtx_serving_tpot_ms_count"] != multi or multi != 4):
        fail(f"3-obs: histogram counts moved {moved}, expected 4 and 4 "
             f"({multi} requests with more than one token)")
    if abs(moved["dtx_serving_ttft_ms_sum"] - ttft_sum) > 1.0:
        fail(f"3-obs: TTFT sum moved {moved['dtx_serving_ttft_ms_sum']}, "
             f"request_stats say {ttft_sum}")
    code, rich = http_get(port, "/metrics?exemplars=1")
    named = [n for n in names if f'trace_id="{n}"' in rich]
    if code != 200 or not named:
        fail(f"3-obs: /metrics?exemplars=1 ({code}) names none of {names}")
    code, plain = http_get(port, "/metrics")
    if "trace_id=" in plain:
        fail("3-obs: the plain /metrics carries exemplars")
    for n in names:
        code, body = http_get(port, f"/debug/trace/{n}")
        if code != 200:
            fail(f"3-obs: /debug/trace/{n} answered {code}")
        (span,) = json.loads(body)["spans"]
        st, attrs = stats[n], span["attrs"]
        events = [e["name"] for e in span["events"]]
        err = max(abs(attrs["ttft_ms"] - st["ttft_s"] * 1e3),
                  abs(attrs["tpot_ms"] - st["tpot_s"] * 1e3))
        if err > 1e-3 or not {"admit", "first_token"} <= set(events):
            fail(f"3-obs: span of {n}: {attrs}, events {events}; "
                 f"request_stats {st} (|diff| {err})")
        if n == names[0]:
            first_events = events
    log(f"  /debug/trace: 4 spans agree with request_stats to 1e-3 ms; "
        f"events of {names[0]}: {first_events}")
    if http_get(port, "/debug/trace/no-such-id")[0] != 404:
        fail("3-obs: an unknown trace id did not answer 404")
    with open(spans_path) as f:
        logged = [json.loads(ln)["trace_id"] for ln in f]
    if sorted(t for t in logged if t in names) != sorted(names):
        fail(f"3-obs: spans.jsonl holds {logged}")
    code, body = http_get(port, "/debug/slo")
    rep = json.loads(body)
    if code != 200 or [s["name"] for s in rep["slos"]] != [OBS_SLO["name"]]:
        fail(f"3-obs: /debug/slo answered {code} {body[:300]}")
    log(f"  spans.jsonl: {len(logged)} lines (the warm-up's and the 4); "
        f"/debug/slo: {rep['slos'][0]['name']} compliant "
        f"{rep['slos'][0]['compliant']}, windows "
        f"{[(w['window_s'], w['total']) for w in rep['slos'][0]['windows']]}")

    # a profiler window over a second batch of the same requests
    code, doc = admin(port, "POST", "/debug/profile", {"seconds": 3})
    if code != 202:
        fail(f"3-obs: POST /debug/profile answered {code} {doc}")
    code2, doc2 = admin(port, "POST", "/debug/profile", {"seconds": 3})
    if code2 != 409:
        fail(f"3-obs: a second POST inside the window answered {code2}")
    batch("batch 2 (profiled)")
    done = process_profiler().wait(120)
    if not done or done.get("error") or not done.get("trace"):
        fail(f"3-obs: the profile window ended with {done}")
    decode, prefill, kernels, inside = read_profile(done["trace"])
    size = os.path.getsize(done["trace"])
    log(f"  /debug/profile: 202 then 409; trace {size} bytes, "
        f"{len(decode)} dtx_engine_decode and {len(prefill)} "
        f"dtx_engine_prefill_chunk ranges; kernels K7 {len(kernels['K7'])}, "
        f"K8 {len(kernels['K8'])}, K9 {len(kernels['K9'])}; K7 launches "
        f"inside a decode range {inside}")
    if not decode or not prefill or not all(kernels.values()) \
            or inside <= 0:
        fail("3-obs: the profile lacks the engine's ranges or kernels")
    stop_server(srv, state)

    # tracing on (the server's engine) and off: equal streams and launches
    prompts = [r[1]["messages"] for r in OBS_REQS
               if not r[1].get("temperature")]

    def drive(e):
        """The greedy prompts one at a time (one schedule for both
        engines), counters zeroed just before."""
        e.request_stats.clear()
        zero(counters)
        streams = []
        for msgs in prompts:
            ids, stops = e._encode_chat(msgs)
            r = e.submit(ids, max_new_tokens=64, stop_ids=stops)
            if not r.done.wait(600) or r.error:
                fail(f"3-obs: tracing={e.tracing}: {r.error}")
            streams.append(r.tokens)
        return {"streams": streams,
                "launches": tuple(getattr(c, a) for c, a in counters),
                "tok_s": [1.0 / s["tpot_s"] for s in e.request_stats
                          if s["tpot_s"]],
                "spans": len(e.trace_store)}

    runs = {}
    try:
        runs[True] = drive(eng)
    finally:
        eng.close()
    del eng
    off = BatchedEngine("preset:tinyllama-1.1b", slots=4, kv_block_size=16,
                        tracing=False)
    try:
        runs[False] = drive(off)
    finally:
        off.close()
    on, no = runs[True], runs[False]
    log(f"  tracing on: launches K7/K8/K9 {on['launches']}, decode "
        f"{[round(x, 1) for x in on['tok_s']]} tok/s a request; tracing "
        f"off: {no['launches']}, {[round(x, 1) for x in no['tok_s']]} tok/s")
    if on["streams"] != no["streams"] or on["launches"] != no["launches"]:
        fail(f"3-obs: tracing off changed the streams or the launches "
             f"({on['launches']} vs {no['launches']})")
    if no["spans"] != 0 or min(on["launches"]) <= 0:
        fail("3-obs: an engine without tracing kept spans, or a kernel "
             "never launched")
    log(f"  one /metrics scrape with 4 slots busy: median "
        f"{median(scrape_ms):.2f} ms of {[round(x, 2) for x in scrape_ms]}")
    log(f"  3-obs on {card}: decode {median(on['tok_s']):.1f} tok/s a "
        f"request with tracing on, {median(no['tok_s']):.1f} off; scrape "
        f"{median(scrape_ms):.2f} ms; profile trace {size} bytes")
    return {"scrape_ms": median(scrape_ms), "profile_bytes": size,
            "tok_s_on": median(on["tok_s"]), "tok_s_off": median(no["tok_s"])}


# ------------------------------------------------------------------ phase 4
def plain_step_logits(torch, params, cfg, prompt, stream, max_seq_len,
                      max_new, eos, kv_quant=None, lora=None):
    """Rows of a plain bf16 forward over the bucketed prompt plus
    ``stream``: row i is the step that emits ``stream[i]`` given the prompt
    and ``stream[:i]`` (teacher forcing: one causal forward serves every
    step), and the last row the step after the stream. With ``kv_quant``
    the forward attends through a dense cache of that quantization, as the
    engine under check does; with ``lora`` (``(adapter tree, scaling)``)
    it carries that one adapter."""
    from datatunerx_tpu_torch.models.llama import forward, init_cache
    from datatunerx_tpu_torch.utils.decoding import prepare_prompt

    ids, mask, positions, plen, n_prompt, _, _ = prepare_prompt(
        prompt, eos, max_seq_len, max_new)
    n = len(stream)
    seq = ids + list(stream)
    pos = positions + list(range(n_prompt, n_prompt + n))
    msk = mask + [1] * n
    with torch.inference_mode():
        cache = (init_cache(cfg, 1, len(seq), quantize=kv_quant,
                            device="cuda") if kv_quant else None)
        logits, _ = forward(
            params, torch.tensor([seq], device="cuda"), cfg,
            positions=torch.tensor([pos], device="cuda"),
            attention_mask=torch.tensor([msk], device="cuda"),
            cache=cache, lora=lora, compute_dtype=torch.bfloat16)
        return logits[0, plen - 1:plen + n].double()


def gaps_ulps(torch, rows, picks):
    """For each row, how far the picked token's logit sits below the row's
    top logit, in bf16 ulps of the top."""
    top = rows.max(dim=-1).values
    ulp = 2.0 ** (torch.floor(torch.log2(top.abs())) - 7)
    picked = rows.gather(-1, torch.tensor(picks, device=rows.device)[:, None])
    return ((top - picked[:, 0]) / ulp).tolist()


NEAR_TIE_ULPS = 2.0
# the most a token of a teacher-forced stream may sit below the plain
# forward's top: twice the largest such gap of a correct engine's own
# stream on the H100 (4 ulps: 3-prefix's cold streams, bf16 and int8, 128
# tokens each; PERF.md). A wrong token sits tens to hundreds below.
FORCED_ULPS = 8.0


def stream_gaps(torch, eng, prompt, stream, start, max_new, stops,
                kv_quant, lora=None):
    """Teacher-forced gaps of ``stream`` from token ``start`` on: for each
    step, how far its token sits below the top logit of ``eng``'s plain
    forward over the prompt and the stream before it, in bf16 ulps (with
    ``kv_quant`` the forward attends through such a cache). A stream that
    stops short adds the step after it, scored by its nearest stop id
    (``stops`` and the end-of-sequence token). Returns (steps, gaps)."""
    eos = eng.tokenizer.eos_token_id
    rows = plain_step_logits(torch, eng.params, eng.cfg, prompt, stream,
                             eng.max_seq_len, max_new, eos, kv_quant, lora)
    steps = list(range(start, len(stream)))
    gaps = gaps_ulps(torch, rows[steps], [stream[i] for i in steps])
    if len(stream) < max_new:
        ids = sorted({int(t) for t in stops if t >= 0} | {eos})
        steps.append(len(stream))
        gaps.append(min(gaps_ulps(torch, rows[[len(stream)] * len(ids)],
                                  ids)))
    return steps, gaps


def check_greedy(torch, label, got, want, ref, prompt, max_new,
                 stops=(), kv_quant=None, plain=None, lora=None,
                 tie_ulps=NEAR_TIE_ULPS):
    """``got`` equals ``want`` (the stream of ``ref``, an engine whose
    params and cfg give the plain forward), or the two part at a near-tie:
    ``ref``'s plain bf16 forward over the prompt and the tokens they share
    puts its top two logits within 2 bf16 ulps. From there ``got`` is
    checked step by step, teacher-forced: none of its tokens may sit more
    than ``FORCED_ULPS`` below the top of the plain forward over the prompt
    and ``got`` before it, and nor may ``want``'s, scored the same way on
    ``ref``'s (with ``kv_quant`` the forward attends through such a cache).
    Where ``got``'s engine computes another model than ``ref`` (quantized
    weights against their dequantized twin), ``plain`` is that engine and
    its own forward scores ``got``. With ``lora`` every plain forward
    carries that adapter. ``tie_ulps`` is the parting rule's gap: a
    speculative engine picks its tokens from a verify forward (K8 over
    k + 1 columns), not from the decode step the reference engine runs,
    so its parting token is held only to ``FORCED_ULPS``, like every
    token after it."""
    n = min(len(got), len(want))
    div = next((i for i in range(n) if got[i] != want[i]), None)
    if div is None and len(got) == len(want):
        log(f"  {label}: {len(got)} tokens equal")
        return
    div = n if div is None else div
    if div < len(got) and div < len(want):
        row = plain_step_logits(torch, ref.params, ref.cfg, prompt,
                                want[:div], ref.max_seq_len, max_new,
                                ref.tokenizer.eos_token_id,
                                lora=lora)[div]
        second = int(torch.topk(row, 2).indices[1])
        tie = gaps_ulps(torch, row[None], [second])[0]
        if tie > tie_ulps:
            fail(f"{label}: the streams part at token {div} without a "
                 f"near-tie (the top two {tie:.2f} ulps apart)")
    else:
        tie = float("nan")  # one stream stopped: scored as a stop step
    steps, gaps = stream_gaps(torch, plain or ref, prompt, got, div,
                              max_new, stops, kv_quant, lora)
    _, own = stream_gaps(torch, ref, prompt, want, 0, max_new, stops,
                         kv_quant, lora)
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    log(f"  {label}: equal for {div} tokens, parting where the top two "
        f"lie {tie:.2f} bf16 ulps apart; then {len(gaps)} teacher-forced "
        f"steps, the furthest {gaps[worst]:.2f} ulps below the plain "
        f"forward's top (token {steps[worst]}), the reference's own stream "
        f"{max(own):.2f}; bound {FORCED_ULPS:.2f}")
    if max(own) > FORCED_ULPS:
        fail(f"{label}: the reference's own stream sits {max(own):.2f} ulps "
             "below the plain forward's top")
    if gaps[worst] > FORCED_ULPS:
        fail(f"{label}: token {steps[worst]} of the stream sits "
             f"{gaps[worst]:.2f} ulps below the plain forward's top")


PARITY_PROMPTS = ("The capital of France is", "def fibonacci(n):" * 20)
PARITY_NEW = 32


def greedy_streams(eng, counters=()):
    """``eng``'s greedy streams of ``PARITY_PROMPTS``: (the prompts' token
    ids, the streams, the launches of ``counters``, zeroed just before the
    streams and read just after)."""
    prompts = [eng.tokenizer.encode(t) for t in PARITY_PROMPTS]
    for c, attr in counters:
        setattr(c, attr, 0)
    streams = [eng.generate(p, max_new_tokens=PARITY_NEW) for p in prompts]
    return prompts, streams, {counter_key(c, attr): getattr(c, attr)
                              for c, attr in counters}


def parity_phase(torch, eng, kv_quant=None, counters=()):
    """Greedy streams of ``eng`` against an engine on the paged gather path
    with the legacy sampler (and the same KV quantization): equal, or
    diverging at a near-tie of the gather path's logits. Returns
    ``greedy_streams(eng, counters)``."""
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    plain = BatchedEngine("preset:tinyllama-1.1b", template="llama2",
                          max_seq_len=1024, slots=4, kv_block_size=16,
                          kv_quant=kv_quant, paged_kernel="off",
                          sampling_epilogue="off")
    try:
        out = greedy_streams(eng, counters)
        for p, got in zip(out[0], out[1]):
            check_greedy(torch, "greedy parity", got,
                         plain.generate(p, max_new_tokens=PARITY_NEW), plain,
                         p, PARITY_NEW, kv_quant=kv_quant)
    finally:
        plain.close()
    return out


# -------------------------------------------------- phases 3-prefix and on
PREFIX_NEW = 128
PREFIX_TEMP, PREFIX_SEED = 0.8, 5


def sampled_near_tie(torch, ref, prompt, prefix, step, temperature, seed,
                     chunk):
    """Where two sampled streams part at ``step``: the step's uniform (the
    slot generator's draw, chunk by chunk) lies within 1e-2 of the softmax
    mass of a CDF step between the two tokens, over ``ref``'s plain
    logits."""
    from datatunerx_tpu_torch.models.llama import forward
    from datatunerx_tpu_torch.utils.decoding import prepare_prompt

    ids, mask, positions, _, n_prompt, _, _ = prepare_prompt(
        prompt, ref.tokenizer.eos_token_id, ref.max_seq_len, PREFIX_NEW)
    seq = ids + list(prefix[:step])
    pos = positions + list(range(n_prompt, n_prompt + step))
    with torch.inference_mode():
        logits, _ = forward(
            ref.params, torch.tensor([seq], device="cuda"), ref.cfg,
            positions=torch.tensor([pos], device="cuda"),
            attention_mask=torch.tensor([mask + [1] * step], device="cuda"),
            compute_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(step // chunk + 1):
            us = torch.rand(chunk, generator=gen, device="cuda")
        u = float(us[step % chunk])
        x = (logits[0, -1].double() / temperature)
        e = torch.exp(x - x.max())
        cdf, z = torch.cumsum(e, 0), float(e.sum())
    return cdf, u, z


def prefix_phase(torch, counters, kv_quant=None):
    """3-prefix: the prefix cache with KV overcommit on a 64-block pool.
    Request A (a 520-token prompt P) runs alone; then A again (an exact COW
    hit, sampled) and P plus 48, 64 and 80 other tokens (COW strict-prefix
    hits: K8 prefills only the suffix, from the cached cursor) run at once,
    128 new tokens each, so growth, reclamation and preemption all happen.
    ``counters`` (K7 and K8) are zeroed just before the concurrent batch and
    read just after. Every greedy stream must equal a cold engine's (no
    prefix cache, overcommit off, the default pool) and the sampled one the
    same request's on that engine, each up to a near-tie; afterwards free
    blocks plus the prefix entries' blocks fill the pool."""
    import random

    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    kw = dict(template="llama2", max_seq_len=1024, slots=4, kv_block_size=16,
              kv_quant=kv_quant)
    eng = BatchedEngine("preset:tinyllama-1.1b", prefix_cache=8,
                        kv_overcommit="on", kv_blocks=64, **kw)
    rnd = random.Random(0)
    P = [rnd.randrange(10, 30000) for _ in range(520)]
    reqs = [("A-exact-sampled", P, PREFIX_TEMP)]
    for extra in (48, 64, 80):
        reqs.append((f"P+{extra}", P + [rnd.randrange(10, 30000)
                                        for _ in range(extra)], 0.0))
    eng.request_stats.clear()
    eng.generate(P, max_new_tokens=PREFIX_NEW, trace_id="A-cold",
                 stop_ids={-1})
    cold_ttft = eng.request_stats[-1]["ttft_s"]
    eng.generate(P, max_new_tokens=8, trace_id="A-hit-alone")
    hit_ttft = eng.request_stats[-1]["ttft_s"]
    for c, attr in counters:
        setattr(c, attr, 0)
    stats0 = dict(eng.prefill_stats)
    handles = {name: eng.submit(p, max_new_tokens=PREFIX_NEW,
                                temperature=t, seed=PREFIX_SEED,
                                stop_ids={-1}, trace_id=name)
               for name, p, t in reqs}
    peak_reserved, peak_ratio = 0, 0.0
    t0 = time.perf_counter()
    while not all(h.done.is_set() for h in handles.values()):
        if time.perf_counter() - t0 > 600:
            fail("3-prefix: requests did not finish within 600 s")
        peak_reserved = max(peak_reserved, eng.kv_blocks_reserved)
        peak_ratio = max(peak_ratio, eng.kv_overcommit_ratio)
        time.sleep(0.002)
    wall = time.perf_counter() - t0
    launches = {counter_key(c, attr): getattr(c, attr)
                for c, attr in counters}
    for name, h in handles.items():
        if h.error:
            fail(f"3-prefix: {name} failed: {h.error}")
    stats = {s["trace_id"]: s for s in eng.request_stats}
    for name, _, _ in reqs:
        st = stats[name]
        tps = (1.0 / st["tpot_s"]) if st["tpot_s"] else float("nan")
        log(f"  {name}: {st['tokens']} tokens, TTFT "
            f"{st['ttft_s'] * 1e3:.1f} ms, decode {tps:.1f} tok/s per "
            "request")
    log(f"  A cold TTFT {cold_ttft * 1e3:.1f} ms vs an exact hit's alone "
        f"{hit_ttft * 1e3:.1f} ms and in the batch (behind the three "
        f"suffix prefills) {stats['A-exact-sampled']['ttft_s'] * 1e3:.1f} "
        "ms; batch wall "
        f"{wall:.2f} s; peak reserved blocks {peak_reserved} of 64, peak "
        f"kv_overcommit_ratio {peak_ratio}")
    reuse = eng.prefill_stats["reuse"] - stats0["reuse"]
    extend = eng.prefill_stats["extend"] - stats0["extend"]
    log(f"  prefill_stats {eng.prefill_stats} (this batch: reuse {reuse}, "
        f"extend {extend}); preemptions {eng.preempt_stats}; peak sessions "
        f"{eng.kv_stats['peak_sessions']}; launches {launches}")
    if reuse < 1 or extend < 1:
        fail(f"3-prefix: reuse {reuse}, extend {extend}: a COW path did "
             "not run")
    if (eng.preempt_stats.get("exported", 0) < 1
            or eng.preempt_stats.get("resumed", 0) < 1):
        fail(f"3-prefix: no preemption was exported and resumed "
             f"({eng.preempt_stats})")
    for name, n in launches.items():
        if n <= 0:
            fail(f"3-prefix: kernel {name} was never launched")
    owned = {b for e in eng._prefix._d.values() for b in e.get("blocks", [])}
    if eng.free_kv_blocks + len(owned) != 64:
        fail(f"3-prefix: {eng.free_kv_blocks} free blocks + {len(owned)} "
             "prefix-entry blocks != 64: blocks leaked")
    got = {name: handles[name].tokens for name, _, _ in reqs}
    eng.close()
    del eng
    torch.cuda.empty_cache()
    cold = BatchedEngine("preset:tinyllama-1.1b", **kw)
    try:
        want = {}
        chs = {name: cold.submit(p, max_new_tokens=PREFIX_NEW,
                                 temperature=t, seed=PREFIX_SEED,
                                 stop_ids={-1})
               for name, p, t in reqs}
        for name, h in chs.items():
            if not h.done.wait(600) or h.error:
                fail(f"3-prefix: cold {name}: {h.error or 'timed out'}")
            want[name] = h.tokens
        for name, p, t in reqs:
            if t <= 0.0:
                check_greedy(torch, f"{name} vs cold", got[name], want[name],
                             cold, p, PREFIX_NEW, kv_quant=kv_quant)
                continue
            g, w = got[name], want[name]
            div = next((i for i in range(min(len(g), len(w)))
                        if g[i] != w[i]), None)
            if div is None and len(g) == len(w):
                log(f"  {name} vs overcommit off: {len(g)} sampled tokens "
                    "equal")
                continue
            div = min(len(g), len(w)) if div is None else div
            cdf, u, z = sampled_near_tie(torch, cold, p, w, div, t,
                                         PREFIX_SEED, cold.chunk)
            lo, hi = sorted((g[div], w[div]))
            off = float((cdf[lo:hi] - u * z).abs().min()) / z
            log(f"  {name} vs overcommit off: diverged at token {div}; "
                f"u*Z sits {off:.2e} of Z from a CDF step between them")
            if off > 1e-2:
                fail(f"{name}: sampled streams diverge at token {div} "
                     "away from a CDF step")
    finally:
        cold.close()
    torch.cuda.empty_cache()
    return launches
def post_perplexity(port, prompt, completion, model=""):
    body = {"prompt": prompt, "completion": completion}
    if model:
        body["model"] = model
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/perplexity",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}")
        out = json.loads(resp.read())
    return out, (time.perf_counter() - t0) * 1e3


PPL_BOUND = 1e-3  # relative, on nll_sum: ~4x the larger H100 reading (PERF.md)


def f32_nll(torch, params32, cfg, p_ids, c_ids, max_seq_len, lora=None):
    """The completion's NLL under an f32 forward of prompt + completion, cut
    from the left to ``max_seq_len``, with no padding and no mask: the
    targets are the last ``len(c_ids)`` tokens (fewer when the cut reaches
    into the completion); ``lora`` (``(adapter tree, scaling)``) adds one
    adapter. Returns (nll_sum, num_tokens)."""
    from datatunerx_tpu_torch.models.llama import forward

    ids = (list(p_ids) + list(c_ids))[-max_seq_len:]
    n = min(len(c_ids), len(ids) - 1)
    with torch.inference_mode():
        logits, _ = forward(params32, torch.tensor([ids], device="cuda"),
                            cfg, lora=lora, compute_dtype=torch.float32)
        lp = torch.log_softmax(logits[0, -n - 1:-1].double(), dim=-1)
        tgt = torch.tensor(ids[-n:], device="cuda")
        nll = float(-lp.gather(-1, tgt[:, None]).sum())
    return nll, n


# ------------------------------------------------------- phase 3-spec
SPEC_FLAGS = ("--kv_block_size", "16", "--slots", "4",
              "--spec_draft_config", "take:4", "--spec_k", str(SPEC_K),
              "--spec_mode", "on")
SPEC_REQS = [
    ("greedy-a", {"messages": [{"role": "user", "content":
                                "Write a haiku about the sea."}],
                  "max_tokens": 64}),
    ("greedy-b", {"messages": [{"role": "user", "content": " ".join(
        f"item {i}: the quick brown fox." for i in range(30))}],
                  "max_tokens": 64}),
    ("sampled", {"messages": [{"role": "user", "content": "Say hi."}],
                 "max_tokens": 64, "temperature": 0.8, "top_p": 1.0}),
    ("sampled-topp", {"messages": [{"role": "user",
                                    "content": "Count to ten."}],
                      "max_tokens": 64, "temperature": 0.8, "top_p": 0.9}),
]


def spec_expected(trace, layers):
    """K7, K8 and K9 launches a spec engine's scheduler trace implies: K8
    once a layer per prefill chunk and per verify step (chain or tree), K7
    once a layer per pending-form decode step and per settle, K9 once per
    fresh-row draw and per draft draw of a "simple" batch (k a chain step,
    the tree's node count a tree step) and once per pending-form decode
    step, except in "topp" batches (the nucleus path is plain)."""
    k7 = k8 = k9 = 0
    fused = ("greedy", "simple")
    for ev in trace:
        if ev[0] == "prefill":
            k8 += layers
        elif ev[0] == "spec":
            k8 += layers
            if ev[3] == "simple":
                k9 += sum(ev[4]) if ev[4] else ev[1]
        elif ev[0] == "spec_settle":
            k7 += layers
        elif ev[0] == "decode":
            k7 += layers * ev[1]
            k9 += ev[1] if ev[2] in fused else 0
        elif ev[0] == "spec_enter":
            k9 += 1 if ev[2] in fused else 0
    return k7, k8, k9


def run_requests(eng, reqs, submit, in_order=False):
    """``reqs`` at once through ``submit(name, body)`` (HTTP or the engine);
    returns ({name: result}, {name: request stats}). ``in_order`` (with
    ``hold_admission``) starts each request only once the one before it
    waits in the engine's queue, so the batch takes slots in the order of
    ``reqs``."""
    eng.request_stats.clear()
    results, errors = {}, []

    def run(name, body):
        try:
            results[name] = submit(name, body)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=run, args=r) for r in reqs]
    for i, th_ in enumerate(threads):
        th_.start()
        # the gate holds the queue until the last one is in, which it admits
        wait = in_order and i < len(threads) - 1
        deadline = time.time() + 60
        while (wait and eng._waiting.qsize() <= i and not errors
               and time.time() < deadline):
            time.sleep(0.002)
        if wait and eng._waiting.qsize() <= i:
            fail(f"request {reqs[i][0]} did not reach the engine's queue: "
                 f"{errors or 'timed out'}")
    for th_ in threads:
        th_.join(timeout=900)
    if errors or len(results) != len(reqs):
        fail(f"requests failed: {errors or 'did not finish'}")
    return results, {s["trace_id"]: s for s in eng.request_stats}


def hold_admission(eng, n):
    """Make the engine's next admission pass wait (60 s at most) until
    ``n`` requests are queued, so a batch sent over HTTP from ``n``
    threads is admitted in one tick. A seeded sampled stream on a spec
    engine depends on when its neighbours join the batch and on which slot
    each row holds (the controller folds the rows' acceptances into its k
    in slot order), in the reference as in the port
    (tests/test_torch_speculative.py), so a repeat check holds the schedule
    fixed: this gate, and ``run_requests(in_order=True)``. One pass only:
    the wrapper removes itself. Returns the list that receives the queued
    requests' trace ids in admission order."""
    admit, order = eng._admit_waiting, []

    def gated():
        deadline = time.time() + 60
        while eng._waiting.qsize() < n and time.time() < deadline:
            time.sleep(0.002)
        order.extend(r.trace_id for r in list(eng._waiting.queue))
        del eng._admit_waiting
        admit()

    eng._admit_waiting = gated
    return order


def describe_stats(stats):
    ttft = median([s["ttft_s"] * 1e3 for s in stats.values()])
    tps = median([1.0 / s["tpot_s"] for s in stats.values() if s["tpot_s"]])
    return ttft, tps


def spec_phase(torch, label, flags, reqs, path):
    """The paged server with a draft (``flags``): ``reqs`` at once over
    HTTP with K7/K8/K9 counted against the scheduler trace, the same batch
    on a second server with the same flags (equal text: seeded draws; each
    batch queued in the order of ``reqs`` and admitted in one tick,
    ``hold_admission``, and from a fresh engine, since a seeded spec stream
    depends on the schedule, the slots and the controllers' state, in the
    reference too), greedy streams against an engine without a draft
    (``check_greedy``), and the same prompts through that engine for its
    TTFT and tok/s. Its ``/metrics`` must show ``dtx_serving_spec_enabled
    1`` and the accept-length histogram's count move by the drafting rows
    ``spec_info()`` counts. Returns the K8 launches keyed by ``path``."""
    from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
    from datatunerx_tpu_torch.ops import cuda_sampling as cs
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    srv, port, eng = start_server(torch, flags)
    quant = eng.kv_quant == "int8"
    attr = "int8_launches" if quant else "launches"
    counters = ((cpa.paged_decode_attention, attr),
                (cpa.paged_multitoken_attention, attr),
                (cs.kernel_sample, "launches"))
    if eng.spec is None or eng.decode_path != "kernel":
        fail(f"{label}: spec {eng.spec is not None}, decode path "
             f"{eng.decode_path}")

    def http(name, body):
        return post(port, body, trace=name)

    before = dict(eng.spec_info())
    hist = "dtx_serving_spec_accept_len_count"
    hist0 = scrape_metrics(port).get(hist, 0)
    for c, a in counters:
        setattr(c, a, 0)
    eng.sched_trace.clear()
    order = hold_admission(eng, len(reqs))
    results, stats = run_requests(eng, reqs, http, in_order=True)
    got = tuple(getattr(c, a) for c, a in counters)
    trace = list(eng.sched_trace)
    want = spec_expected(trace, eng.cfg.num_layers)
    log(f"  launches K7/K8/K9 {got}, from the trace {want} "
        f"({sum(1 for e in trace if e[0] == 'spec')} verify steps, "
        f"{sum(1 for e in trace if e[0] == 'decode')} pending-form chunks, "
        f"{sum(1 for e in trace if e[0] == 'prefill')} prefill chunks)")
    if got != want:
        fail(f"{label}: launches {got} differ from the trace's {want}")
    if got[1] <= 0:
        fail(f"{label}: no verify step launched K8")
    info = eng.spec_info()
    prop = info["proposed"] - before["proposed"]
    acc = info["accepted"] - before["accepted"]
    rows = info["row_steps"] - before["row_steps"]
    metrics = scrape_metrics(port)
    log(f"  {label} /metrics: dtx_serving_spec_enabled "
        f"{metrics.get('dtx_serving_spec_enabled'):g}, {hist} "
        f"+{metrics.get(hist, 0) - hist0:g} against spec_info()'s "
        f"{rows} drafting rows")
    if (metrics.get("dtx_serving_spec_enabled") != 1
            or metrics.get(hist, 0) - hist0 != rows):
        fail(f"{label}: /metrics spec family {metrics.get(hist)} "
             f"(from {hist0}) against {rows} drafting rows")
    for name, body in reqs:
        st = stats.get(name)
        if st is None or st["tokens"] <= 0:
            fail(f"{label} {name}: no tokens")
        if st["tokens"] > body["max_tokens"]:
            fail(f"{label} {name}: {st['tokens']} tokens over its budget")
    ttft, tps = describe_stats(stats)
    log(f"  {label}: acceptance {acc}/{prop} = "
        f"{acc / max(prop, 1):.4f}, mean accepted length "
        f"{acc / max(rows, 1):.3f} a verify row; TTFT median {ttft:.1f} ms, "
        f"decode {tps:.1f} tok/s per request (median)")
    if "tree" in info:
        log(f"  {label}: tree widths {info['tree']['widths']} "
            f"(depth EMA {info['tree'].get('depth_ema')}, decisive EMA "
            f"{info['tree'].get('decisive_ema')})")
    if path == "@spec-chain" and not quant:
        n = spec_step_launches(torch, eng)
        log(f"  {label}: host launches a chain verify step (k {SPEC_K}, 4 "
            f"slots): greedy {n['greedy']}, sampled {n['simple']} (of "
            f"which the residual draw's bits ~{TWIN_LAUNCHES[0]}); a "
            f"pending-form decode step {n['decode']}")
    # the repeat runs on a second server with the same flags: the spec
    # controllers (k, tree widths) carry what the first run taught them,
    # so a rerun on the same engine draws in other steps, in the
    # reference too (tests/test_torch_speculative.py)
    from datatunerx_tpu_torch.serving.server import ServingState

    first = list(eng.sched_trace)
    state2 = ServingState()
    srv2, port2, eng2 = start_server(torch, flags, state=state2)
    try:
        order2 = hold_admission(eng2, len(reqs))
        again, _ = run_requests(
            eng2, reqs, lambda name, body: post(port2, body, trace=name),
            in_order=True)
        second = list(eng2.sched_trace)
    finally:
        stop_server(srv2, state2)
        eng2.close()
    for name, _ in reqs:
        a, b = results[name]["text"], again[name]["text"]
        if a != b:
            j = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                     min(len(a), len(b)))

            def sched(trace):
                steps = collections.Counter(
                    f"{e[0]} {e[3] if e[0] == 'spec' else e[2]}"
                    for e in trace if e[0] in ("spec", "decode"))
                return ([(e[1], e[2]) for e in trace if e[0] == "admit"],
                        dict(steps))

            fail(f"{label} {name}: the same seeded batch on a second server "
                 f"differs at character {j} ({len(a)} and {len(b)} "
                 "characters); "
                 "queue orders, admissions (slot, prompt lanes) and steps "
                 f"by batch mode {order}, {sched(first)}, then {order2}, "
                 f"{sched(second)}")
    plain = BatchedEngine("preset:tinyllama-1.1b", template="llama2",
                          max_seq_len=eng.max_seq_len, slots=4,
                          kv_block_size=16, kv_quant=eng.kv_quant)
    try:
        def local(engine):
            def submit(name, body):
                ids, stops = engine._encode_chat(body["messages"])
                r = engine.submit(ids, max_new_tokens=body["max_tokens"],
                                  temperature=body.get("temperature", 0.0),
                                  top_p=body.get("top_p", 1.0),
                                  stop_ids=stops, trace_id=name)
                if not r.done.wait(600) or r.error:
                    raise RuntimeError(r.error or "timed out")
                return {"ids": ids, "stops": stops, "tokens": r.tokens}
            return submit

        base, base_stats = run_requests(plain, reqs, local(plain))
        b_ttft, b_tps = describe_stats(base_stats)
        log(f"  the same prompts without a draft (phase 3's engine, "
            f"in-process): TTFT median {b_ttft:.1f} ms, decode "
            f"{b_tps:.1f} tok/s per request; spec / plain decode "
            f"{tps / b_tps:.3f}")
        greedy = [r for r in reqs if not r[1].get("temperature")]
        spec_own, _ = run_requests(eng, greedy, local(eng))
        for name, body in greedy:
            g, w = spec_own[name], base[name]
            check_greedy(torch, f"{label} {name}", g["tokens"], w["tokens"],
                         plain, g["ids"], body["max_tokens"], g["stops"],
                         kv_quant=eng.kv_quant, tie_ulps=FORCED_ULPS)
    finally:
        plain.close()
    stop_server(srv)
    eng.close()
    return {counter_key(cpa.paged_multitoken_attention, attr) + path: got[1]}


def spec_step_launches(torch, eng):
    """CUDA kernels one chain verify step launches (k = ``SPEC_K`` over the
    engine's 4 slots) in a greedy and in a sampled ("simple") batch, and
    one pending-form decode step, each in a profiler window around a call
    on the idle engine's own state (no row active: the same launches, no
    row moves)."""
    sp = eng.spec
    progs = sp["programs"]
    off = torch.zeros_like(eng._active)

    def step(mode):
        return lambda: progs.step(
            eng.params, sp["dparams"], eng._lora_arg(), eng._cache,
            dict(sp["dcache"]), eng._spec_pending, eng._pos, eng._remaining,
            off, eng._keys, eng._temps, eng._top_ps, eng._stops,
            eng._adapter_idx, ~off, k=SPEC_K, mode=mode)

    def decode():
        return progs.decode(eng.params, eng._lora_arg(), eng._cache,
                            eng._spec_pending, eng._pos, eng._remaining, off,
                            eng._keys, eng._temps, eng._top_ps, eng._stops,
                            eng._adapter_idx, K=1, mode="simple",
                            batch="simple")

    with torch.inference_mode():
        counts = {"greedy": profile_launches(torch, step("greedy")),
                  "simple": profile_launches(torch, step("simple")),
                  "decode": profile_launches(torch, decode)}
    return counts


def spec_full_draft_phase(torch):
    """take:22 (the draft is the whole target): greedy proposals must be
    accepted at 0.9 or more, which a broken rollback cannot reach."""
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    eng = BatchedEngine("preset:tinyllama-1.1b", template="llama2",
                        max_seq_len=1024, slots=4, kv_block_size=16,
                        spec_draft=f"take:{LAYERS}", spec_k=SPEC_K,
                        spec_mode="on")
    try:
        tok = eng.tokenizer
        reqs = [eng.submit(tok.encode(t), max_new_tokens=48)
                for t in ("The history of the printing press",
                          "def quicksort(xs):")]
        for r in reqs:
            if not r.done.wait(600) or r.error:
                fail(f"take:{LAYERS}: {r.error or 'timed out'}")
        info = eng.spec_info()
        rate = info["accepted"] / max(info["proposed"], 1)
        log(f"  take:{LAYERS} greedy: {info['accepted']}/{info['proposed']} "
            f"proposals accepted ({rate:.4f}), {info['spec_steps']} verify "
            "steps")
        if rate < 0.9:
            fail(f"take:{LAYERS} accepted {rate:.4f} of its proposals "
                 "(want >= 0.9)")
    finally:
        eng.close()


def perplexity_phase(torch):
    """3-perplexity: ``/perplexity`` on the paged server (phase 3's flags)
    for a ~600-token prompt with a 64-token completion, and for a prompt
    too long for the context (cut from the left, the completion kept); then
    the single-request engine's ``perplexity`` on the same inputs. Each
    ``nll_sum`` within ``PPL_BOUND`` relative of an f32 forward of the same
    params built without the engines' padding and masking, and
    ``num_tokens`` equal."""
    import random

    from datatunerx_tpu_torch.serving.engine import InferenceEngine

    srv, port, eng = start_server(torch, ("--kv_block_size", "16",
                                          "--slots", "4"))
    rnd = random.Random(1)
    words = ["alpha", "beta", "gamma", "delta", "river", "stone", "light"]
    prompt = " ".join(rnd.choice(words) for _ in range(100))[:600]
    long_prompt = " ".join(rnd.choice(words) for _ in range(700))
    completion = " ".join(rnd.choice(words) for _ in range(12))[:64]
    tok = eng.tokenizer
    inputs = {"600-token prompt": prompt, "cut prompt": long_prompt}
    ids = {name: (tok.encode(text),
                  tok.encode(completion, add_special_tokens=False))
           for name, text in inputs.items()}
    p_long, c_ids = ids["cut prompt"]
    if len(p_long) + len(c_ids) <= eng.max_seq_len:
        fail(f"3-perplexity: the long input ({len(p_long)} + {len(c_ids)} "
             "tokens) is not cut")

    params32 = f32_tree(eng.params)
    want = {name: f32_nll(torch, params32, eng.cfg, p, c, eng.max_seq_len)
            for name, (p, c) in ids.items()}

    def check(engine, name, out):
        ref, n = want[name]
        rel = abs(out["nll_sum"] - ref) / abs(ref)
        log(f"  {engine}, {name} ({len(ids[name][0])} + "
            f"{len(ids[name][1])} tokens): nll_sum {out['nll_sum']:.6f} over "
            f"{out['num_tokens']} tokens vs f32 {ref:.6f} over {n} (rel "
            f"{rel:.2e}, bound {PPL_BOUND:g})")
        if out["num_tokens"] != n or not rel <= PPL_BOUND:
            fail(f"3-perplexity: {engine} on the {name} is off the f32 "
                 "forward")

    for name, text in inputs.items():
        out, _ = post_perplexity(port, text, completion)
        check("/perplexity", name, out)
    times = sorted(post_perplexity(port, prompt, completion)[1]
                   for _ in range(5))
    log(f"  /perplexity: {times[len(times) // 2]:.1f} ms per call on the "
        f"600-token prompt (median of 5, {times[0]:.1f}-{times[-1]:.1f})")
    stop_server(srv)
    eng.close()
    del eng
    torch.cuda.empty_cache()
    single = InferenceEngine("preset:tinyllama-1.1b", template="llama2",
                             max_seq_len=1024)
    for name, (p, c) in ids.items():
        check("the single-request engine", name, single.perplexity(p, c))
    del single, params32
    torch.cuda.empty_cache()


def f32_tree(tree):
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    return tree.float()


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def single_phase(torch, quant_counters):
    """3-single: the server with ``--slots 1`` (the single-request engine)
    answers two greedy chats in turn, whose streams must equal the dense
    batched engine's; then ``--slots 1 --quantization int8`` and ``int4``
    (host-quantized weights, the ``xla`` dequantize-then-matmul path: K4-K6
    must not launch) on a ``SINGLE_QUANT_LAYERS``-layer directory of
    TinyLlama-1.1B's configuration generate 32 greedy tokens each, equal to
    an unquantized engine's over the dequantized weights, each up to a
    near-tie."""
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    srv, port, eng = start_server(torch, ("--slots", "1"))
    if type(eng).__name__ != "InferenceEngine":
        fail(f"--slots 1 served {type(eng).__name__}")
    chats = [[{"role": "user", "content": "Tell me about the sea."}],
             [{"role": "user", "content": "List three colours."}]]
    for i, msgs in enumerate(chats):
        r = post(port, {"messages": msgs, "max_tokens": 64})
        log(f"  chat {i}: 200, {len(r['text'])} chars in "
            f"{r['wall_s'] * 1e3:.0f} ms")
    stop_server(srv)
    dense = BatchedEngine("preset:tinyllama-1.1b", template="llama2",
                          max_seq_len=1024, slots=4)
    try:
        for i, msgs in enumerate(chats):
            ids, stops = eng._encode_chat(msgs)
            t0 = time.perf_counter()
            got = eng.generate(ids, max_new_tokens=64, stop_ids=stops)
            ms = (time.perf_counter() - t0) * 1e3
            want = dense.generate(ids, max_new_tokens=64, stop_ids=stops)
            log(f"  chat {i}: {len(got)} tokens in {ms:.0f} ms "
                f"({len(got) / ms * 1e3:.1f} tok/s)")
            check_greedy(torch, f"chat {i} vs the dense batched engine", got,
                         want, dense, ids, 64, stops)
    finally:
        dense.close()
    del eng, dense
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dtx-single-") as tmp:
        path = os.path.join(tmp, "tinyllama")
        bf16_bytes, _ = write_hf_checkpoint(
            torch, path, TINYLLAMA_1B, SINGLE_QUANT_LAYERS, "BF16",
            "safetensors", 3, "llama")
        for mode in ("int8", "int4"):
            quantized_single(torch, quant_counters, path, mode, bf16_bytes)


def quantized_single(torch, quant_counters, path, mode, bf16_bytes):
    """3-single's ``--slots 1 --quantization mode`` server on ``path``,
    whose bf16 weights take ``bf16_bytes``."""
    import copy
    import dataclasses

    from datatunerx_tpu_torch.models.lora import target_dims
    from datatunerx_tpu_torch.ops.quant import dequantize_model_params

    for c, attr in quant_counters:
        setattr(c, attr, 0)
    srv, port, qeng = start_server(torch, ("--slots", "1",
                                           "--quantization", mode),
                                   model=path)
    stop_server(srv)
    ids = qeng.tokenizer.encode("The history of the printing press")
    t0 = time.perf_counter()
    got = qeng.generate(ids, max_new_tokens=32, stop_ids={-1})
    ms = (time.perf_counter() - t0) * 1e3
    launched = {counter_key(c, attr): getattr(c, attr)
                for c, attr in quant_counters}
    if any(launched.values()):
        fail(f"--quantization {mode} launched {launched}: the serving "
             "path is the xla one")
    ppl = qeng.perplexity(ids, got)["perplexity"]
    if len(got) != 32 or not math.isfinite(ppl):
        fail(f"--quantization {mode}: {len(got)} tokens, perplexity "
             f"{ppl}")
    ref = copy.copy(qeng)
    ref.params = dequantize_model_params(
        qeng.params, mode, lambda n: target_dims(qeng.cfg, n))
    ref.cfg = dataclasses.replace(qeng.cfg, quantization=None)
    want = ref.generate(ids, max_new_tokens=32, stop_ids={-1})
    log(f"  --quantization {mode}, {qeng.cfg.num_layers} layers: weights "
        f"{tree_bytes(qeng.params)} bytes vs bf16 {bf16_bytes} "
        f"({tree_bytes(qeng.params) / bf16_bytes:.4f}); 32 tokens in "
        f"{ms:.0f} ms ({32 / ms * 1e3:.1f} tok/s), perplexity of its "
        f"own stream {ppl:.3f}; K4-K6 launches "
        f"{launched}")
    check_greedy(torch, f"{mode} vs its dequantized weights", got, want,
                 ref, ids, 32, plain=qeng)
    del ref, qeng
    torch.cuda.empty_cache()


# ------------------------------------------------------- phase 3-adapters
ADAPTER_TENANTS = {
    "plat": {"tier": "pinned", "adapters": ["ad0-r2"]},
    "batch": {"tier": "bulk", "adapters": ["ad1-r4", "ad2-r8", "ad3-r2",
                                           "ad4-r4", "ad5-r8"]},
}
ADAPTER_ROUNDS = (("", "ad0-r2", "ad1-r4", "ad2-r8"),
                  ("ad3-r2", "ad4-r4", "ad5-r8", "ad0-r2"),
                  ("ad1-r4",))
# the registry after the three rounds, predicted before the first run
# (PERF.md): round 1 loads ad0-ad2 from their checkpoints into three of the
# four slots; round 2 finds ad0 resident (a hit) and loads ad3-ad5, into
# the free slot and over ad1 and ad2 (two evictions: ad0 is the pinned
# tenant's and never evicts); round 3 reloads ad1 over the coldest of
# ad3-ad5 (a third eviction), from the host tier
ADAPTER_EXPECT = {"loads": 7, "evictions": 3, "hits": 1, "misses": 7,
                  "host_hits": 1, "orbax_loads": 6}
ADAPTER_NEW = 64


def admin(port, method, path, body=None):
    """(status, JSON body) of one call to the server."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def record_submits(eng):
    """Keep every Request the engine's ``submit`` makes, by trace id (the
    HTTP answer carries text only; the checks need the token ids)."""
    seen, real = {}, eng.submit

    def submit(*a, **kw):
        req = real(*a, **kw)
        seen[req.trace_id] = req
        return req

    eng.submit = submit
    return seen


def adapter_tree(torch, path, device="cuda"):
    """``(adapter tree on ``device``, scaling)`` of an adapter checkpoint,
    at the scaling the engines serve it with."""
    from datatunerx_tpu_torch.models.lora import lora_scaling
    from datatunerx_tpu_torch.serving.batched_engine import (
        load_checkpoint_state,
    )
    from datatunerx_tpu_torch.serving.engine import tree_to

    state = load_checkpoint_state(path)
    layers = state["lora"]["layers"]
    scaling = state["_scaling"]
    if scaling is None:
        scaling = lora_scaling(32.0, next(iter(layers.values()))["a"]
                               .shape[-1])
    return tree_to(state["lora"], device, torch.float32), scaling


def adapter_phase(torch, counters, base):
    """3-adapters (see the module docstring). ``counters`` are K7, K8 and
    K9's ``(wrapper, attribute)``; ``base`` phase 3's first-batch stats."""
    from datatunerx_tpu_torch.serving.adapters import make_adapter_sweep

    with tempfile.TemporaryDirectory(prefix="dtx-adapters-") as tmp:
        t0 = time.perf_counter()
        cks = make_adapter_sweep(tmp, "preset:tinyllama-1.1b", 6)
        log(f"  6 adapters written in {time.perf_counter() - t0:.1f} s")
        srv, port, eng = start_server(torch, (
            "--kv_block_size", "16", "--slots", "4", "--adapter_pool", "4",
            "--adapter_rank_max", "8", "--host_adapter_cache_mb", "64",
            "--tenants_config", json.dumps(ADAPTER_TENANTS)))
        for name, path in cks.items():
            code, doc = admin(port, "POST", "/admin/adapters",
                              {"name": name, "checkpoint": path,
                               "load": False})
            if code != 200 or doc["resident"]:
                fail(f"3-adapters: registering {name} answered {code} {doc}")
        log(f"  pool: {eng.adapter_store.nbytes()} bytes on the card (4 "
            "slots and the base row, r8, q_proj,v_proj, bf16)")
        seen = record_submits(eng)
        eng.request_stats.clear()
        eng.sched_trace.clear()
        before = eng.tenant_usage()  # the warm-up request's, anonymous
        for c, attr in counters:
            setattr(c, attr, 0)
        answers, errors = {}, []

        def run(trace, name, i):
            body = {"messages": [{"role": "user", "content":
                                  f"Tenant {name or 'base'}, request {i}: "
                                  "tell me about the sea."}],
                    "max_tokens": ADAPTER_NEW}
            if name:
                body["model"] = name
            try:
                answers[trace] = post(port, body, trace=trace)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{trace}: {e}")

        t0 = time.perf_counter()
        i = 0
        for rnd, names in enumerate(ADAPTER_ROUNDS, start=1):
            threads = []
            for name in names:
                i += 1
                trace = f"r{rnd}-{name or 'base'}"
                threads.append(threading.Thread(target=run,
                                                args=(trace, name, i)))
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
        wall = time.perf_counter() - t0
        launched = {counter_key(c, attr): getattr(c, attr)
                    for c, attr in counters}
        if errors or len(answers) != sum(map(len, ADAPTER_ROUNDS)):
            fail(f"3-adapters: {errors or 'requests did not finish'}")
        steps = sum(e[1] for e in eng.sched_trace if e[0] == "decode")
        chunks = sum(1 for e in eng.sched_trace if e[0] == "prefill")
        L = eng.cfg.num_layers
        want = dict(zip(launched, (L * steps, L * chunks, steps)))
        log(f"  {len(answers)} requests in 3 rounds, {wall:.2f} s wall; "
            f"{steps} decode steps and {chunks} prefill chunks by the "
            f"trace; launches {launched}, expected {want}")
        if launched != want or steps <= 0 or chunks <= 0:
            fail(f"3-adapters: launches {launched}, expected {want}")
        occ = eng.adapter_occupancy()
        host = eng.adapter_registry.host_tier_stats()
        got = {k: occ[k] for k in ("loads", "evictions", "hits", "misses")}
        got.update(host_hits=host["host_hits"],
                   orbax_loads=host["orbax_loads"])
        log(f"  registry {got} (expected {ADAPTER_EXPECT}); resident "
            f"{occ['resident_adapters']}; host tier {host['entries']} "
            f"entries, {host['bytes']} bytes; load ms "
            f"{[round(x, 1) for x in occ['load_ms']]}")
        if got != ADAPTER_EXPECT:
            fail(f"3-adapters: registry {got}, expected {ADAPTER_EXPECT}")
        # the residency set a gateway's adapter-aware routing scrapes
        metrics = scrape_metrics(port)
        for fam, key in (("resident", "resident_adapters"),
                         ("registered", "registered_adapters")):
            prefix = f'dtx_serving_adapter_{fam}{{adapter="'
            named = sorted(k[len(prefix):-2] for k, v in metrics.items()
                           if k.startswith(prefix) and v == 1)
            if named != sorted(occ[key]):
                fail(f"3-adapters: /metrics {fam} {named}, occupancy "
                     f"{sorted(occ[key])}")
        log(f"  /metrics: dtx_serving_adapter_resident equals the resident "
            f"set {sorted(occ['resident_adapters'])}")
        # each stream teacher-forced through a plain forward that carries
        # only the request's own adapter, at its own rank
        stats = {s["trace_id"]: s for s in eng.request_stats}
        trees = {name: adapter_tree(torch, path)
                 for name, path in cks.items()}
        usage_in, usage_out = {}, {}
        tenant_of = {a: t for t, e in ADAPTER_TENANTS.items()
                     for a in e["adapters"]}
        for trace in sorted(answers):
            req, st = seen[trace], stats.get(trace)
            if st is None or not req.tokens:
                fail(f"3-adapters: {trace} emitted no tokens")
            name = req.adapter_name
            _, gaps = stream_gaps(torch, eng, req.prompt_ids, req.tokens, 0,
                                  ADAPTER_NEW, req.stop_ids, None,
                                  trees.get(name))
            tps = (1.0 / st["tpot_s"]) if st["tpot_s"] else float("nan")
            log(f"  {trace}: {len(req.tokens)} tokens, TTFT "
                f"{st['ttft_s'] * 1e3:.1f} ms, decode {tps:.1f} tok/s; "
                f"teacher-forced: furthest {max(gaps):.2f} ulps below the "
                f"plain forward's top (bound {FORCED_ULPS:.2f})")
            if max(gaps) > FORCED_ULPS:
                fail(f"3-adapters: {trace} sits {max(gaps):.2f} ulps below "
                     "its adapter's plain forward")
            tenant = tenant_of.get(name, "")
            usage_in[tenant] = (usage_in.get(tenant, 0)
                                + answers[trace]["usage"]["prompt_tokens"])
            usage_out[tenant] = usage_out.get(tenant, 0) + len(req.tokens)
        usage = eng.tenant_usage()
        for tenant in usage_in:
            row, old = usage.get(tenant, {}), before.get(tenant, {})
            used = {k: row.get(k, 0) - old.get(k, 0)
                    for k in ("tokens_in", "tokens_out")}
            # tokens out count only for a named tenant (as in the reference)
            if (used["tokens_in"] != usage_in[tenant]
                    or (tenant and used["tokens_out"] != usage_out[tenant])):
                fail(f"3-adapters: tenant {tenant!r} used {used}, the "
                     f"client counts {usage_in[tenant]} in, "
                     f"{usage_out[tenant]} out")
        log(f"  tenant usage {usage}")
        ttft = median([stats[t]["ttft_s"] * 1e3 for t in answers])
        tps = median([1.0 / stats[t]["tpot_s"] for t in answers
                      if stats[t]["tpot_s"]])
        r1 = [f"r1-{n or 'base'}" for n in ADAPTER_ROUNDS[0]]
        r1_tokens = sum(len(seen[t].tokens) for t in r1)
        r1_wall = max(answers[t]["wall_s"] for t in r1)
        log(f"  median TTFT {ttft:.1f} ms, decode {tps:.1f} tok/s per "
            f"request; round 1 (the base and 3 adapters) "
            f"{r1_tokens / r1_wall:.1f} tok/s aggregate; phase 3's "
            f"base-only batch: TTFT {base['ttft_ms']:.1f} ms, decode "
            f"{base['tok_s']:.1f} tok/s per request, {base['aggregate']:.1f}"
            " tok/s aggregate")
        code, doc = admin(port, "DELETE", "/admin/adapters/ad5-r8")
        if code != 200 or doc != {"unloaded": "ad5-r8"}:
            fail(f"3-adapters: DELETE ad5-r8 answered {code} {doc}")
        code, doc = admin(port, "POST", "/chat/completions",
                          {"messages": [{"role": "user", "content": "hi"}],
                           "model": "ad5-r8", "max_tokens": 4})
        if code != 400:
            fail(f"3-adapters: a chat naming a deleted adapter answered "
                 f"{code} {doc}")
        log("  DELETE /admin/adapters/ad5-r8: 200; a chat naming it: 400")
        stop_server(srv)
        eng.close()
    del eng, trees
    torch.cuda.empty_cache()


# ------------------------------------------------------- phase 3-migrate
MIGRATE_NEW = 64
SPILL_NEW = 160  # two ~400-token sessions outgrow a 64-block pool
MIGRATE_TEMP, MIGRATE_SEED = 0.8, 7
# 8 slots on every server of 3-migrate: the keep-warm source runs four
# fillers beside its four sessions, and K7's split plan follows the slot
# count, so a sampled stream moved between servers of two counts would
# part from its unmoved run at a near-tie of the draw
MIGRATE_FLAGS = ("--kv_block_size", "16", "--slots", "8")


def capture_imports(eng):
    """Keep the Request of every session the engine imports, by trace id
    (the SSE answer carries text only; the checks need the token ids)."""
    seen, real = {}, eng.import_session

    def import_session(payload, *a, **kw):
        meta = real(payload, *a, **kw)
        seen[meta["session"]] = meta["_request"]
        return meta

    eng.import_session = import_session
    return seen


def sse_events(resp):
    """The JSON events of an SSE response, up to ``[DONE]``."""
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            return
        yield json.loads(line[len("data: "):])


def import_stream(port, payload):
    """``POST /admin/sessions/import`` (SSE): ``(receipt meta, iterator of
    (delta, perf_counter stamp)))``; raises on a refusal."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/admin/sessions/import",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=600)
    events = sse_events(resp)
    first = next(events, None)
    if not first or "imported" not in first:
        resp.close()
        raise RuntimeError(f"import answered {first}")

    def deltas():
        with resp:
            for ev in events:
                if "error" in ev:
                    raise RuntimeError(ev["error"])
                yield ev["delta"], time.perf_counter()

    return first["imported"], deltas()


def drain_import(port, payload, out, key):
    """Import ``payload`` and read its stream to the end into ``out[key]``:
    the receipt, the text, the first delta's stamp and the post's start."""
    t0 = time.perf_counter()
    try:
        meta, deltas = import_stream(port, payload)
        t_receipt = time.perf_counter()
        text, first = "", None
        for delta, ts in deltas:
            first = ts if first is None else first
            text += delta
        out[key] = {"meta": meta, "text": text, "t0": t0,
                    "t_receipt": t_receipt, "t_first": first}
    except Exception as e:  # noqa: BLE001 — reported by the caller
        out[key] = {"error": str(e)}


class HttpPeer:
    """A port server as the fleet coordinators' replica: the session and
    fleet routes over HTTP, the stats and the role from its ``/metrics``
    fleet gauges, as a gateway scrapes them."""

    def __init__(self, name, port):
        self.name, self.port, self.role = name, port, "mixed"

    def stats_snapshot(self):
        m = scrape_metrics(self.port)
        self.role = next(k.split('"')[1] for k, v in m.items()
                         if k.startswith("dtx_serving_role{") and v == 1)
        return {"slots_busy": int(m["dtx_serving_slots_busy"]),
                "kv_blocks_free": int(m["dtx_serving_kv_blocks_free"]),
                "sessions_parked": int(m["dtx_serving_sessions_parked"])}

    def _post(self, path, body):
        code, doc = admin(self.port, "POST", path, body)
        if code != 200:
            raise RuntimeError(f"{self.name} {path}: {code} {doc}")
        return doc

    def hold_parked(self, max_sessions=4, hold_s=10.0):
        return self._post("/admin/sessions/hold",
                          {"max_sessions": max_sessions, "hold_s": hold_s})

    def drop_parked(self, trace_ids):
        return self._post("/admin/sessions/drop",
                          {"trace_ids": list(trace_ids)})

    def release_parked(self, trace_ids):
        return self._post("/admin/sessions/release",
                          {"trace_ids": list(trace_ids)})

    def import_session(self, payload):
        return import_stream(self.port, payload)


class PeerPool:
    def __init__(self, peers):
        self.peers = list(peers)

    def available(self):
        return list(self.peers)


def rand_ids(rnd, n):
    return [rnd.randrange(10, 30000) for _ in range(n)]


def trace_counts(eng, mark):
    """(decode steps, prefill chunks, prefill tokens) in the engine's
    scheduler trace since index ``mark``."""
    trace = list(eng.sched_trace)[mark:]
    return (sum(e[1] for e in trace if e[0] == "decode"),
            sum(1 for e in trace if e[0] == "prefill"),
            sum(e[2] for e in trace if e[0] == "prefill"))


def sse_text(tok, tokens, base):
    """The text an import's SSE stream carries past its first ``base``
    tokens, by ``resume_stream``'s rule: a delta each time the decoded text
    grows and does not end inside a character (U+FFFD)."""
    acc = list(tokens[:base])
    sent = tok.decode(acc, skip_special_tokens=True) if acc else ""
    out = []
    for t in tokens[base:]:
        acc.append(t)
        text = tok.decode(acc, skip_special_tokens=True)
        if len(text) > len(sent) and not text.endswith("\ufffd"):
            out.append(text[len(sent):])
            sent = text
    return "".join(out)


def spliced(tok, tail, text_so_far, deltas, tokens) -> bool:
    """The destination's stream continues the tail: its tokens start with
    the tail, the receipt's text is the tail's, and the SSE deltas are
    exactly the text ``sse_text`` gives its tokens past the tail (empty
    when they decode to none, as most of a random-weight model's ids do
    under the byte-level tokenizer)."""
    tail_text = tok.decode(tail, skip_special_tokens=True) if tail else ""
    return (tokens[:len(tail)] == tail and text_so_far == tail_text
            and deltas == sse_text(tok, tokens, len(tail)))


def clocked(obj, attr, sink):
    """Append the host ms of each call of ``obj.attr`` to ``sink``;
    returns the restore callable."""
    real = getattr(obj, attr)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, attr, timed)
    return lambda: setattr(obj, attr, real)


def scrape_metrics(port):
    """The samples of a server's ``GET /metrics``: series → value."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        text = resp.read().decode()
    return {ln.rsplit(None, 1)[0]: float(ln.rsplit(None, 1)[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


def check_launches(label, counters, eng, mark, prefill=True,
                   whose="destination", phase="3-migrate"):
    """The counters (K7, K8, K9 wrappers and attributes) against what the
    engine's trace since ``mark`` ran: L K7 a decode step, L K8 a prefill
    chunk, one K9 a decode step. Returns the launch table."""
    if len(eng.sched_trace) == eng.sched_trace.maxlen:
        fail(f"{phase} {label}: the scheduler trace filled its "
             f"{eng.sched_trace.maxlen} entries, so it no longer counts "
             "from the mark")
    steps, chunks, _ = trace_counts(eng, mark)
    L = eng.cfg.num_layers
    got = {counter_key(c, a): getattr(c, a) for c, a in counters}
    want = dict(zip(got, (L * steps, L * chunks, steps)))
    log(f"  {label}: {steps} decode steps and {chunks} prefill chunks by "
        f"the {whose}'s trace; launches {got}, expected {want}")
    if got != want or steps <= 0 or (prefill and chunks <= 0):
        fail(f"{phase} {label}: launches {got}, expected {want}")
    return got


def zero(counters):
    for c, attr in counters:
        setattr(c, attr, 0)


def wait_tokens(label, handles, n, timeout=300):
    t0 = time.perf_counter()
    while not all(len(h.tokens) >= n for h in handles):
        if any(h.done.is_set() for h in handles):
            fail(f"3-migrate {label}: a request finished before {n} tokens")
        if time.perf_counter() - t0 > timeout:
            fail(f"3-migrate {label}: requests never reached {n} tokens")
        time.sleep(0.001)


def finished(label, handles, timeout=600):
    for h in handles:
        if not h.done.wait(timeout):
            fail(f"3-migrate {label}: {h.trace_id} did not finish")


def check_moved(torch, label, got, want, ref, prompt, sampled,
                kv_quant=None, max_new=MIGRATE_NEW):
    """A moved stream against the unmoved one: equal for a sampled stream,
    ``check_greedy``'s rule for a greedy one."""
    if sampled:
        if got != want:
            n = next((i for i in range(min(len(got), len(want)))
                      if got[i] != want[i]), min(len(got), len(want)))
            fail(f"{label}: the sampled stream parts from the unmoved one "
                 f"at token {n} ({len(got)} vs {len(want)} tokens)")
        log(f"  {label}: {len(got)} sampled tokens equal")
        return
    check_greedy(torch, label, got, want, ref, prompt, max_new,
                 kv_quant=kv_quant)


def export_http(label, port, body):
    t0 = time.perf_counter()
    code, doc = admin(port, "POST", "/admin/sessions/export", body)
    ms = (time.perf_counter() - t0) * 1e3
    if code != 200:
        fail(f"3-migrate {label}: export answered {code} {doc}")
    return doc, ms


def slowed(eng, attr, delay):
    """Slow ``eng.attr`` by ``delay`` s a call (to catch a prefill between
    its chunks); returns the restore callable."""
    real = getattr(eng, attr)

    def slow(*a, **kw):
        time.sleep(delay)
        return real(*a, **kw)

    setattr(eng, attr, slow)
    return lambda: setattr(eng, attr, real)


def export_mid_prefill_http(label, port, eng, prompt, **kw):
    """Submit ``prompt``, catch it between two prefill chunks and export it
    with ``"prefill": true``; returns (request, payload)."""
    restore = slowed(eng, "_prefill_chunk_fn", 0.02)
    try:
        h = eng.submit(prompt, max_new_tokens=MIGRATE_NEW, **kw)
        t0 = time.perf_counter()
        while not any(0 < st["done"] < st["plen"]
                      for st in list(eng._pending.values())):
            if h.done.is_set() or time.perf_counter() - t0 > 120:
                fail(f"3-migrate {label}: never caught mid-prefill")
            time.sleep(0.001)
        doc, _ = export_http(label, port, {"prefill": True})
    finally:
        restore()
    if len(doc["sessions"]) != 1 or "pending" not in doc["sessions"][0]:
        fail(f"3-migrate {label}: export gave {len(doc['sessions'])} "
             f"sessions, skipped {doc['skipped']}")
    return h, doc["sessions"][0]


def keep_warm_check(torch, counters, src, prompts, mark, rnd):
    """3-migrate's keep-warm: after the export, one no_reuse block entry a
    exported prompt in ``src``'s prefix cache (``full``, ``rem`` =
    divmod(``cursor``, 16), the prompt's blocks, no logits) and one
    ``keep_warm`` trace event each; then a request that extends the first
    prompt admits through a COW strict-prefix hit on its entry
    (``cow_extend``) and prefills only the extension, on K8, as the trace
    says. Returns (the extended prompt, its greedy tokens)."""
    bs = src.block_size
    events = [e for e in list(src.sched_trace)[mark:]
              if e[0] == "keep_warm"]
    entries = {k[0]: e for k, e in src._prefix.snapshot_entries()}
    for i, p in enumerate(prompts):
        e = entries.get(tuple(p))
        if e is None or not e.get("no_reuse") or e.get("logits") is not None:
            fail(f"3-migrate keep-warm: prompt {i} has no no_reuse entry "
                 f"after the export ({sorted(len(k) for k in entries)})")
        full, rem = divmod(e["cursor"], bs)
        # the cursor is the prompt's lanes, left-padded to a 64-lane bucket
        if (e["full"], e["rem"]) != (full, rem) or len(e["blocks"]) != (
                full + (1 if rem else 0)) or e["cursor"] != -(-len(p) // 64) * 64:
            fail(f"3-migrate keep-warm: prompt {i} ({len(p)} tokens): "
                 f"entry full {e['full']} rem {e['rem']} cursor "
                 f"{e['cursor']} with {len(e['blocks'])} blocks")
    if len(events) != len(prompts):
        fail(f"3-migrate keep-warm: {len(events)} keep_warm events, "
             f"expected {len(prompts)}")
    log(f"  keep-warm: {len(events)} no_reuse entries published by the "
        f"export, cursors {[e[2] for e in events]}")
    ext = list(prompts[0]) + rand_ids(rnd, 40)
    zero(counters)
    mark = len(src.sched_trace)
    req = src.submit(ext, max_new_tokens=MIGRATE_NEW, temperature=0.0,
                     trace_id="keep-warm-ext")
    finished("keep-warm", [req], 300)
    if req.error:
        fail(f"3-migrate keep-warm: {req.error}")
    admits = [e[3] for e in list(src.sched_trace)[mark:] if e[0] == "admit"]
    _, _, ptoks = trace_counts(src, mark)
    if admits != ["cow_extend"] or not 40 <= ptoks < len(ext) - bs:
        fail(f"3-migrate keep-warm: the extension admitted {admits} and "
             f"prefilled {ptoks} of its {len(ext)} tokens")
    log(f"  keep-warm: the first prompt plus 40 tokens admitted "
        f"cow_extend, prefilled {ptoks} tokens (not {len(ext)})")
    check_launches("keep-warm cow_extend", counters, src, mark,
                   whose="source")
    return ext, req.tokens


def migrate_phase(torch, counters, int8_counters):
    """3-migrate (see the module docstring). ``counters`` are K7, K8 and
    K9's ``(wrapper, attribute)``, ``int8_counters`` the int8 K7/K8's."""
    import random

    from datatunerx_tpu_torch.fleet import SpillCoordinator
    from datatunerx_tpu_torch.serving import migration as mig
    from datatunerx_tpu_torch.serving import server

    rnd = random.Random(14)
    t_phase = time.perf_counter()
    servers = {}

    def up(name, flags):
        state = server.ServingState()
        srv, port, eng = start_server(torch, MIGRATE_FLAGS + flags,
                                      state=state)
        servers[name] = (srv, state)
        return port, eng

    def down(name):
        srv, state = servers.pop(name)
        eng = state.engine
        stop_server(srv, state)
        eng.close()

    try:
        # ---- 1. session handoff: 3 greedy + 1 sampled, moved mid-decode
        # the source runs keep-warm, which needs COW prefix blocks: KV
        # overcommit beside the prefix cache
        sport, src = up("A", ("--prefix_cache", "4", "--role", "prefill",
                              "--kv_overcommit", "on"))
        if not src.cow:
            fail("3-migrate: the source has no COW prefix blocks")
        src.prefix_keep_warm = True
        dport, dst = up("B", ("--prefix_cache", "8"))
        imported = capture_imports(dst)
        roles = [k for k, v in scrape_metrics(sport).items()
                 if k.startswith("dtx_serving_role{") and v == 1]
        if roles != ['dtx_serving_role{role="prefill"}']:
            fail(f"3-migrate: the source's /metrics shows the roles {roles}")
        prompts = [rand_ids(rnd, 600) for _ in range(4)]
        temps = [0.0, 0.0, 0.0, MIGRATE_TEMP]
        names = [f"mig-{i}" for i in range(4)]

        def submit_all(eng, tag):
            return [eng.submit(p, max_new_tokens=MIGRATE_NEW, temperature=t,
                               seed=MIGRATE_SEED, trace_id=f"{tag}{n}")
                    for p, t, n in zip(prompts, temps, names)]

        moving = submit_all(src, "")
        wait_tokens("handoff", moving, 8)
        # four short one-token fillers churn the 4-entry prefix cache: the
        # sessions' prompt entries leave it, as they would under traffic
        fillers = [src.submit(rand_ids(rnd, 64), max_new_tokens=1,
                              trace_id=f"filler-{i}") for i in range(4)]
        finished("fillers", fillers, 120)
        ptoks = {tuple(p) for p in prompts}
        if ptoks & {k[0] for k, _ in src._prefix.snapshot_entries()}:
            fail("3-migrate keep-warm: a session's prompt entry is still "
                 "in the source's prefix cache after the fillers")
        kw_mark = len(src.sched_trace)
        # the host's split of the export: the scheduler's command, and in
        # it the device-to-host copies and the base64 encoding
        split = {k: [] for k in ("export", "host", "b64", "import",
                                 "unpack", "unb64")}
        restores = [clocked(src, "_do_export", split["export"]),
                    clocked(mig, "_host", split["host"]),
                    clocked(mig, "_b64", split["b64"])]
        try:
            doc, export_ms = export_http("handoff", sport, {})
        finally:
            for r in restores:
                r()
        finished("handoff", moving, 60)
        if len(doc["sessions"]) != 4 or any(
                "session migrated" not in (h.error or "") for h in moving):
            fail(f"3-migrate handoff: exported {len(doc['sessions'])} "
                 f"sessions, skipped {doc['skipped']}")
        kw_ext, kw_got = keep_warm_check(torch, counters, src, prompts,
                                         kw_mark, rnd)
        payloads = {p["trace_id"]: p for p in doc["sessions"]}
        zero(counters)
        mark = len(dst.sched_trace)
        out, threads = {}, []
        for n in names:
            threads.append(threading.Thread(
                target=drain_import, args=(dport, payloads[n], out, n)))
        # the import's: the scheduler's command, and in it the row's
        # unpacking onto the card and, in that, the base64 decoding
        restores = [clocked(dst, "_do_import", split["import"]),
                    clocked(mig, "unpack_kv_row", split["unpack"]),
                    clocked(mig, "_unb64", split["unb64"])]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
        finally:
            for r in restores:
                r()
        bad = {n: o.get("error") for n, o in out.items() if "error" in o}
        if bad or len(out) != 4:
            fail(f"3-migrate handoff: imports failed {bad}")
        check_launches("handoff", counters, dst, mark, prefill=False)
        # the keep-warm extension against its cold run on the destination
        want = dst.generate(kw_ext, max_new_tokens=MIGRATE_NEW)
        check_greedy(torch, "3-migrate keep-warm cow_extend", kw_got, want,
                     dst, kw_ext, MIGRATE_NEW)
        unmoved = submit_all(src, "unmoved-")
        finished("handoff unmoved", unmoved)
        tok = src.tokenizer
        cfg = src.cfg
        lane_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
        for i, n in enumerate(names):
            got = imported[n].tokens
            if not spliced(tok, payloads[n]["tokens"],
                           out[n]["meta"]["text_so_far"], out[n]["text"],
                           got):
                fail(f"3-migrate {n}: the SSE text is not the tail's and "
                     "its continuation's")
            check_moved(torch, f"3-migrate {n}", got, unmoved[i].tokens, src,
                        prompts[i], sampled=temps[i] > 0)
        for i, n in enumerate(names):
            p, o = payloads[n], out[n]
            first = imported[n].first_token_ts
            log(f"  {n}: cursor {p['cursor']}, tail {len(p['tokens'])} "
                f"tokens, KV {p['cursor'] * lane_bytes} B raw (bf16), payload "
                f"{len(json.dumps(p))} B of JSON (bf16 wire); import POST to "
                f"receipt {(o['t_receipt'] - o['t0']) * 1e3:.1f} ms, to the "
                f"destination's first token {(first - o['t0']) * 1e3:.1f} ms"
                f", to the first text delta "
                + (f"{(o['t_first'] - o['t0']) * 1e3:.1f} ms" if o["t_first"]
                   else "(none: the tokens decode to no text)")
                + f" ({len(o['text'])} characters of SSE text, as expected)"
                + "; the client's gap (the source's last token to the "
                f"destination's first) "
                f"{(first - moving[i].last_token_ts) * 1e3:.1f} ms")
        log(f"  export of 4 sessions: {export_ms:.1f} ms (one POST)")
        jt = []
        for n in names:
            t0 = time.perf_counter()
            body = json.dumps(dict(payloads[n], stream=True))
            t1 = time.perf_counter()
            json.loads(body)
            jt.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        t0 = time.perf_counter()
        body = json.dumps(doc)
        t1 = time.perf_counter()
        json.loads(body)
        t2 = time.perf_counter()

        def ms(xs):
            return "[" + ", ".join(f"{x:.1f}" for x in xs) + "] ms"

        log("  host split (host clock; the four imports ran at once, so "
            "each includes waits for the interpreter lock): export: the "
            f"scheduler's command {ms(split['export'])}, in it the device-"
            f"to-host copies {sum(split['host']):.1f} ms and base64 "
            f"{sum(split['b64']):.1f} ms; the answer's json.dumps "
            f"{(t1 - t0) * 1e3:.1f} ms and json.loads {(t2 - t1) * 1e3:.1f}"
            f" ms, again alone. Import, a session: json.dumps "
            f"{ms(a for a, _ in jt)} and json.loads {ms(b for _, b in jt)} "
            f"again alone; the scheduler's command {ms(split['import'])}, "
            f"in it unpack_kv_row {ms(split['unpack'])}, in that base64 "
            f"{sum(split['unb64']):.1f} ms over {len(split['unb64'])} "
            "calls")

        # ---- 2. mid-prefill handoff: a ~880-token prompt, 64 a tick
        pport, psrc = up("A2", ("--prefill_token_budget", "64"))
        p_mid = rand_ids(rnd, 880)
        _, payload = export_mid_prefill_http("mid-prefill", pport, psrc,
                                             p_mid, trace_id="mid-0")
        tail = len(payload["pending"]["ids"])
        zero(counters)
        mark = len(dst.sched_trace)
        drain_import(dport, payload, out, "mid-0")
        if "error" in out["mid-0"]:
            fail(f"3-migrate mid-prefill: {out['mid-0']['error']}")
        _, _, ptoks = trace_counts(dst, mark)
        log(f"  mid-prefill: exported after {payload['pending']['done']} of "
            f"{tail + payload['pending']['done']} prompt lanes; the "
            f"destination prefilled {ptoks} (the tail: {tail}); payload "
            f"{len(json.dumps(payload))} B")
        if ptoks != tail:
            fail(f"3-migrate mid-prefill: the destination prefilled {ptoks} "
                 f"tokens, the tail is {tail}")
        check_launches("mid-prefill", counters, dst, mark)
        want = psrc.generate(p_mid, max_new_tokens=MIGRATE_NEW)
        check_moved(torch, "3-migrate mid-prefill", imported["mid-0"].tokens,
                    want, psrc, p_mid, sampled=False)

        # ---- 3. int8: a bf16 wire into int8 pools, an int8 wire between
        # int8 engines
        qport, qdst = up("C", ("--kv_quant", "int8"))
        q_imported = capture_imports(qdst)
        _, payload = export_mid_prefill_http(
            "int8 from bf16", pport, psrc, rand_ids(rnd, 880),
            trace_id="int8-from-bf16")
        q_all = int8_counters + [counters[2]]
        zero(q_all)
        mark = len(qdst.sched_trace)
        drain_import(qport, payload, out, "int8-from-bf16")
        if "error" in out["int8-from-bf16"]:
            fail(f"3-migrate int8: {out['int8-from-bf16']['error']}")
        check_launches("bf16 wire into int8 pools (mid-prefill)", q_all,
                       qdst, mark)
        got = q_imported["int8-from-bf16"].tokens
        if len(got) <= len(payload["tokens"]) or \
                q_imported["int8-from-bf16"].error:
            fail("3-migrate int8: the bf16-wire session did not complete")
        log(f"  bf16 wire into int8 pools: {len(got)} tokens")
        down("A2")
        iport, isrc = up("D", ("--kv_quant", "int8"))
        i_prompts = [rand_ids(rnd, 600) for _ in range(2)]
        i_temps = [0.0, MIGRATE_TEMP]

        def i_submit(tag):
            return [isrc.submit(p, max_new_tokens=MIGRATE_NEW, temperature=t,
                                seed=MIGRATE_SEED, trace_id=f"{tag}int8-{i}")
                    for i, (p, t) in enumerate(zip(i_prompts, i_temps))]

        i_unmoved = i_submit("unmoved-")
        finished("int8 unmoved", i_unmoved)
        i_moving = i_submit("")
        wait_tokens("int8", i_moving, 8)
        doc, i_export_ms = export_http("int8", iport, {})
        finished("int8", i_moving, 60)
        zero(q_all)
        mark = len(qdst.sched_trace)
        for p in doc["sessions"]:
            if p["kv"]["wire"] != "int8":
                fail("3-migrate int8: an int8 engine exported another wire")
            drain_import(qport, p, out, p["trace_id"])
        check_launches("int8 wire into int8 pools", q_all, qdst, mark,
                       prefill=False)
        for i, (p, t) in enumerate(zip(i_prompts, i_temps)):
            n = f"int8-{i}"
            check_moved(torch, f"3-migrate {n}", q_imported[n].tokens,
                        i_unmoved[i].tokens, isrc, p, sampled=t > 0,
                        kv_quant="int8")
            pl = next(x for x in doc["sessions"] if x["trace_id"] == n)
            log(f"  {n}: cursor {pl['cursor']}, payload "
                f"{len(json.dumps(pl))} B of JSON (int8 wire)")
        log(f"  int8 export of 2 sessions: {i_export_ms:.1f} ms")
        for name in ("C", "D"):
            log(f"  session_stats {name}: "
                f"{servers[name][1].engine.session_stats}")
            down(name)

        # ---- 4. the prefix tier: a ~520-token prefix moves A -> B
        shared = rand_ids(rnd, 520)
        src.generate(shared, max_new_tokens=8)
        fp = mig.prefix_fingerprint("", shared)
        code, doc = admin(sport, "POST", "/admin/prefix/export",
                          {"max_entries": 8})
        entry = next((e for e in doc.get("entries", [])
                      if e["fingerprint"] == fp), None)
        if code != 200 or entry is None:
            fail(f"3-migrate prefix: export answered {code}, no entry {fp}")
        code, res = admin(dport, "POST", "/admin/prefix/import", entry)
        if code != 200 or not res.get("imported"):
            fail(f"3-migrate prefix: import answered {code} {res}")
        # in turns, each a request alone on the destination: cold, the
        # imported prefix (its first request), cold, the prefix again
        ttft = {"hit": [], "cold": []}
        for label, prompt in (("cold", rand_ids(rnd, 520)), ("hit", shared),
                              ("cold", rand_ids(rnd, 520)), ("hit", shared)):
            mark = len(dst.sched_trace)
            dst.request_stats.clear()
            got = dst.generate(prompt, max_new_tokens=MIGRATE_NEW,
                               trace_id=f"prefix-{label}")
            _, chunks, _ = trace_counts(dst, mark)
            ttft[label].append((dst.request_stats[-1]["ttft_s"] * 1e3,
                                chunks))
            if label == "hit" and chunks != 0:
                fail(f"3-migrate prefix: the imported prefix ran {chunks} "
                     "prefill chunks")
            if label == "hit" and len(ttft["hit"]) == 1:
                check_greedy(torch, "3-migrate prefix hit", got,
                             src.generate(shared, max_new_tokens=MIGRATE_NEW),
                             src, shared, MIGRATE_NEW)

        def show(xs):
            return ", ".join(f"{t:.1f} ms ({c} prefill chunks)" for t, c in xs)

        log(f"  prefix: payload {len(json.dumps(entry))} B; TTFT (a decode "
            f"chunk of 8 steps included) on the imported prefix "
            f"{show(ttft['hit'])}; cold 520-token prompts "
            f"{show(ttft['cold'])}")
        log(f"  session_stats A: {src.session_stats}")
        down("A")

        # ---- 5. spill: a tight overcommit pool, hold/release, then the
        # port's SpillCoordinator over HTTP (hold -> import -> drop)
        eport, esrc = up("E", ("--kv_overcommit", "on", "--kv_blocks", "64"))
        s_prompts = [rand_ids(rnd, 400) for _ in range(4)]
        s_temps = [0.0, 0.0, 0.0, MIGRATE_TEMP]

        def s_submit(eng, tag):
            return [eng.submit(p, max_new_tokens=SPILL_NEW, temperature=t,
                               seed=MIGRATE_SEED, trace_id=f"{tag}spill-{i}")
                    for i, (p, t) in enumerate(zip(s_prompts, s_temps))]

        s_ref = s_submit(dst, "ref-")
        finished("spill reference", s_ref)
        # round 1: a leased head released at once resumes here
        round1 = s_submit(esrc, "r1-")
        t0 = time.perf_counter()
        while not esrc.parked_sessions:
            if all(h.done.is_set() for h in round1) or \
                    time.perf_counter() - t0 > 300:
                fail("3-migrate spill: nothing was parked")
            time.sleep(0.001)
        code, held = admin(eport, "POST", "/admin/sessions/hold",
                           {"max_sessions": 1, "hold_s": 60})
        tids = [s["trace_id"] for s in held.get("sessions", [])]
        code2, rel = admin(eport, "POST", "/admin/sessions/release",
                           {"trace_ids": tids})
        if code != 200 or code2 != 200 or rel != {"released": 1}:
            fail(f"3-migrate spill: hold {code} {held.get('sessions')}, "
                 f"release {code2} {rel}")
        finished("spill round 1", round1)
        for i, h in enumerate(round1):
            if h.error:
                fail(f"3-migrate spill: {h.trace_id}: {h.error}")
            check_moved(torch, f"3-migrate {h.trace_id}", h.tokens,
                        s_ref[i].tokens, dst, s_prompts[i],
                        sampled=s_temps[i] > 0, max_new=SPILL_NEW)
        log(f"  spill round 1: {tids[0]} held and released, resumed here; "
            f"preemptions {esrc.preempt_stats}")
        # round 2: the coordinator re-homes parked sessions onto B
        box = {}
        coord = SpillCoordinator(
            PeerPool([HttpPeer("E", eport), HttpPeer("B", dport)]),
            park=box.__setitem__, max_sessions=2, hold_s=60)
        spilled0 = esrc.preempt_stats.get("spilled", 0)
        round2 = s_submit(esrc, "r2-")
        t0 = time.perf_counter()
        while not all(h.done.is_set() for h in round2):
            if esrc.parked_sessions:
                coord.tick()
            if time.perf_counter() - t0 > 600:
                fail("3-migrate spill: round 2 did not finish")
            time.sleep(0.002)
        if coord.counters["ok"] < 1:
            fail(f"3-migrate spill: nothing spilled {coord.counters}")
        for i, h in enumerate(round2):
            if h.error is None:
                got = h.tokens
            elif "session migrated" in h.error:
                ent = box[h.trace_id]
                deltas = "".join(d for d, _ in ent["stream"])
                got = imported[h.trace_id].tokens
                if not spliced(dst.tokenizer, h.tokens, ent["text_so_far"],
                               deltas, got):
                    fail(f"3-migrate {h.trace_id}: the spilled stream is "
                         "not the tail plus the continuation")
            else:
                fail(f"3-migrate spill: {h.trace_id}: {h.error}")
            check_moved(torch, f"3-migrate {h.trace_id}", got,
                        s_ref[i].tokens, dst, s_prompts[i],
                        sampled=s_temps[i] > 0, max_new=SPILL_NEW)
        spilled = esrc.preempt_stats.get("spilled", 0) - spilled0
        if spilled != coord.counters["ok"]:
            fail(f"3-migrate spill: the source spilled {spilled}, the "
                 f"coordinator moved {coord.counters['ok']}")
        log(f"  spill round 2: coordinator {coord.counters}; the source "
            f"{esrc.preempt_stats}, its pool whole: "
            f"{esrc.free_kv_blocks == esrc.total_kv_blocks}")
        log(f"  session_stats E: {esrc.session_stats}, B: "
            f"{dst.session_stats}")
        if esrc.free_kv_blocks != esrc.total_kv_blocks:
            fail("3-migrate spill: the source's pool is not whole")
        down("E")
        down("B")
    finally:
        for name in list(servers):
            down(name)
    log(f"  3-migrate took {time.perf_counter() - t_phase:.1f} s")


def checkpoint_serve_phase(torch, checkpoint, scaling):
    """5-serve (see the module docstring): ``checkpoint`` is the step
    directory phase 5's manifest names, ``scaling`` its recorded
    scaling."""
    lora = adapter_tree(torch, checkpoint)
    if lora[1] != scaling:
        fail(f"5-serve: the checkpoint reads scaling {lora[1]}, the "
             f"manifest {scaling}")
    srv, port, eng = start_server(torch, ("--kv_block_size", "16", "--slots",
                                          "4", "--checkpoint_path",
                                          checkpoint))
    if eng.adapter_ids != {"": 0, "default": 1}:
        fail(f"5-serve: adapters {eng.adapter_ids}")
    prompt = ("Below is an instruction that describes a task. Write a "
              "response that appropriately completes the request.\n\n"
              "### Instruction:\nName three rivers.\n\n### Response:\n")
    completion = "The Nile, the Amazon and the Yangtze."
    tok = eng.tokenizer
    p_ids = tok.encode(prompt)
    c_ids = tok.encode(completion, add_special_tokens=False)
    params32 = f32_tree(eng.params)
    ref, n = f32_nll(torch, params32, eng.cfg, p_ids, c_ids,
                     eng.max_seq_len, lora=lora)
    base_ref, _ = f32_nll(torch, params32, eng.cfg, p_ids, c_ids,
                          eng.max_seq_len)
    del params32

    def check(label, out):
        rel = abs(out["nll_sum"] - ref) / abs(ref)
        log(f"  {label}: nll_sum {out['nll_sum']:.6f} over "
            f"{out['num_tokens']} tokens vs f32 base + adapter {ref:.6f} "
            f"over {n} (rel {rel:.2e}, bound {PPL_BOUND:g}; the base alone "
            f"{base_ref:.6f})")
        if out["num_tokens"] != n or not rel <= PPL_BOUND:
            fail(f"5-serve: {label} is off the f32 forward")

    out, _ = post_perplexity(port, prompt, completion, model="default")
    check('/perplexity "model": "default" (paged server)', out)
    # the same server without "model" serves the base (the reference's
    # rule): the adapter must have moved the number
    plain, _ = post_perplexity(port, prompt, completion)
    log(f"  /perplexity without model on the paged server (the base): "
        f"nll_sum {plain['nll_sum']:.6f}")
    if plain["nll_sum"] == out["nll_sum"]:
        fail('5-serve: "default" scored as the base model')
    times = sorted(post_perplexity(port, prompt, completion,
                                   model="default")[1] for _ in range(5))
    log(f"  /perplexity with the adapter: {median(times):.1f} ms per call "
        f"(median of 5, {times[0]:.1f}-{times[-1]:.1f})")
    seen = record_submits(eng)
    msgs = [{"role": "user", "content": "Name three rivers."}]
    post(port, {"messages": msgs, "model": "default", "max_tokens": 64},
         trace="5-serve")
    req = seen["5-serve"]
    stop_server(srv)
    srv, port, single = start_server(torch, ("--slots", "1",
                                             "--checkpoint_path",
                                             checkpoint))
    if type(single).__name__ != "InferenceEngine":
        fail(f"5-serve: --slots 1 served {type(single).__name__}")
    out, _ = post_perplexity(port, prompt, completion)
    check("/perplexity, no model (the single-request engine, merged)", out)
    stop_server(srv)
    want = single.generate(req.prompt_ids, max_new_tokens=64,
                           stop_ids=set(req.stop_ids))
    check_greedy(torch, '"default" on the paged engine vs the merged '
                 "single-request engine", req.tokens, want, eng,
                 req.prompt_ids, 64, req.stop_ids, lora=lora)
    eng.close()
    del eng, single, lora
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 5
TRAIN_STEPS = 8
PROFILE_STEPS = 2  # steps 2-3 run under torch.profiler; 4-8 are timed
QLORA_STEPS = 6  # steps 2-3 profiled; 4-6 timed
INT8_STEPS = 6  # steps 2-3 profiled; 4-6 timed
TRAIN_SHAPE = dict(batch=8, block=1024)
LAYERS = 22
# the quant kernels first: their (mangled) names also hold "gemm"; K4 and K5
# are told apart by their role template argument (Nf4Fwd, Nf4T), in the bf16
# nf4_gemm_wgmma and the f32 qgemm alike
KERNEL_GROUPS = (("K4 nf4", ("nf4fwd",)), ("K5 nf4 dx", ("nf4t",)),
                 ("K6 int8", ("int8src", "int8_gemm")),
                 ("flash K1", ("flash_fwd",)),
                 ("flash K2/K3", ("flash_bwd",)),
                 ("threefry", ("threefry",)),
                 ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")))


def device_breakdown(trace_path, steps):
    """Device time per step by kernel group, and the busy share, from the
    CLI's torch.profiler chrome trace: busy = the union of GPU kernel and
    copy intervals over the span from the first to the last of them."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset")
           and "dur" in e]
    if not gpu:
        fail("the profiled train steps recorded no GPU events")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    gpu_total = sum(e["dur"] for e in gpu)
    for e in gpu:
        name = e["name"].lower()
        for group, keys in KERNEL_GROUPS:
            if any(k in name for k in keys):
                groups[group] += e["dur"]
                break
        else:
            groups["other"] += e["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, s1 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return ({k: v / 1e3 / steps for k, v in groups.items() if v or
             not k.startswith("K")},
            busy / window, window / 1e3 / steps, gpu_total / 1e3 / steps)


def write_train_csv(path, seed=0, n=1500):
    """Instruction/response rows of varied length, made from a seed."""
    import csv
    import random

    rnd = random.Random(seed)
    words = ["alpha", "beta", "gamma", "delta", "tensor", "kernel", "train",
             "model", "token", "layer", "adapter", "rank"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["instruction", "response"])
        for i in range(n):
            q = " ".join(rnd.choice(words) for _ in range(rnd.randint(2, 16)))
            a = " ".join(rnd.choice(words) for _ in range(rnd.randint(4, 30)))
            w.writerow([f"#{i}: {q}?", a])


def expected_launches(quant, steps, layers=LAYERS, forwards=2, dropped=2):
    """Kernel launches the CLI run must make, derived from the model: per
    step and layer, K1 twice (forward + remat recompute; ``forwards`` 3
    for DPO, whose reference forward runs without grad), K2 and K3 once,
    and the threefry kernel once per LoRA-dropout draw: each of the
    ``dropped`` adapted projections in the forward and in its recompute;
    with an nf4 base K4 on each of the 7 projections twice (forward +
    recompute: ``dots`` saves only matmuls) and K5 once per projection
    whose input needs a gradient (all but layer 0's q/k/v, whose input is
    the frozen embedding's); with int8, K6 as K4."""
    per = {"flash_fwd": forwards * layers, "flash_bwd_dq": layers,
           "flash_bwd_dkv": layers, "nf4_matmul": 0, "nf4_matmul_t": 0,
           "int8_matmul": 0, "threefry_bits": 2 * dropped * layers}
    if quant == "int4":
        per.update(nf4_matmul=2 * 7 * layers, nf4_matmul_t=7 * layers - 3)
    elif quant == "int8":
        per["int8_matmul"] = 2 * 7 * layers
    return {k: v * steps for k, v in per.items()}


def train_phase(torch, tmp, quant=None, steps=TRAIN_STEPS,
                profile=PROFILE_STEPS, export=True,
                model="preset:tinyllama-1.1b", layers=LAYERS,
                remote_write=False, native_packer=False):
    from datatunerx_tpu_torch import native
    from datatunerx_tpu_torch.ops import cuda_prng
    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import flash_attention as fa
    from datatunerx_tpu_torch.training import train_lib
    from datatunerx_tpu_torch.tuning import train

    csv_path = os.path.join(tmp, "train.csv")
    if not os.path.exists(csv_path):
        write_train_csv(csv_path)
    tmp = os.path.join(tmp, quant or "lora")
    out, store, export_dir = (os.path.join(tmp, n) for n in
                              ("out", "store", "export"))
    argv = ["--model_name_or_path", model,
            "--train_path", csv_path, "--template", "alpaca",
            "--finetuning_type", "lora", "--lora_target", "q_proj,v_proj",
            "--attention", "flash", "--remat", "dots", "--bf16",
            "--block_size", str(TRAIN_SHAPE["block"]), "--pack_sequences",
            "--per_device_train_batch_size", str(TRAIN_SHAPE["batch"]),
            "--max_steps", str(steps), "--logging_steps", "1",
            "--output_dir", out, "--storage_path", store,
            "--device", "cuda", "--profile_steps", str(profile)]
    if quant:
        argv += ["--quantization", quant]  # quant_impl: pallas (default)
    if export:
        argv += ["--export_dir", export_dir]
    receiver = RemoteWriteReceiver() if remote_write else None
    if receiver is not None:
        argv += ["--metrics_export_address", receiver.url]
    # time each step to its end on the device, and look at the adapters
    # after the first (B starts at 0)
    real_step = train_lib.Trainer.train_step
    times, seen = [], {}

    def timed_step(self, state, batch):
        t0 = time.perf_counter()
        new, metrics = real_step(self, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if "b_max" not in seen:
            seen["b_max"] = min(float(ab["b"].abs().max()) for ab in
                                new.lora["layers"].values())
            seen["rows"] = batch["segment_ids"].shape
            seen["segments"] = float(batch["segment_ids"].amax(1).float()
                                     .mean())
        return new, metrics

    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                cq.nf4_matmul, cq.nf4_matmul_t, cq.int8_matmul,
                cuda_prng.threefry_bits)
    packed = []
    real_pack = native.pack_batch_native
    if native_packer:
        # the trainer's batches must pack through the native packer: built
        # from the checkout here (g++), and no Python fallback allowed
        t0 = time.perf_counter()
        if not native.available():
            fail("phase 5: the native packer did not build (g++)")
        log(f"  native packer: {native._library_path().name} "
            + (f"built by g++ in {native.build_seconds:.2f} s"
               if native.build_seconds else "loaded (already built)")
            + f", {time.perf_counter() - t0:.2f} s to load")

        def counted_pack(*a, **kw):
            out = real_pack(*a, **kw)
            packed.append(out is not None)
            return out

        native.pack_batch_native = counted_pack
    train_lib.Trainer.train_step = timed_step
    try:
        gc.collect()
        held = torch.cuda.memory_allocated() / 2**30  # left by earlier phases
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = train.main(argv)
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
    finally:
        train_lib.Trainer.train_step = real_step
        native.pack_batch_native = real_pack
        if receiver is not None:
            receiver.close()
    if rc != 0:
        fail(f"train CLI returned {rc}")
    if native_packer:
        if not packed or not all(packed):
            fail(f"phase 5: the trainer packed {len(packed)} times through "
                 f"the native packer, {packed.count(False)} of them fell "
                 "back to Python")
        log(f"  the trainer's packing ran {len(packed)} time(s) through the "
            "native packer")
    if receiver is not None:
        check_remote_write(receiver, out, steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected_launches(quant, steps, layers)
    for name, n in launches.items():
        if n <= 0 and want[name] > 0:
            fail(f"train phase: kernel {name} was never launched")
    if launches != want:
        fail(f"train phase launches {launches}, expected {want}")
    with open(os.path.join(out, "watch", "trainer_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != steps:
        fail(f"{len(recs)} train records, expected {steps}")
    for r in recs:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0):
            fail(f"step {r['current_steps']}: loss {r['loss']} grad_norm "
                 f"{r['grad_norm']}")
    if not seen.get("b_max", 0) > 0:
        fail("a LoRA B leaf is still all zeros after the first step")
    with open(os.path.join(store, "out", "manifest.json")) as f:
        manifest = json.load(f)
    trained = {"checkpoint": manifest["checkpoint"],
               "scaling": manifest["lora_scaling"]}
    ckpt = os.path.join(manifest["checkpoint"], "state.pt")
    npz = os.path.join(export_dir, "model.npz")
    written = [ckpt] + ([npz, os.path.join(export_dir, "config.json")]
                        if export else [])
    for path in written:
        if not os.path.exists(path):
            fail(f"train phase did not write {path}")
    if export and quant:
        with open(os.path.join(export_dir, "config.json")) as f:
            if json.load(f).get("quantization") != quant:
                fail(f"the export's config.json does not record {quant}")
    first = 1 + profile  # steps after the first and the profiled ones
    steady = times[first:]
    step_s = sorted(steady)[len(steady) // 2]
    positions = TRAIN_SHAPE["batch"] * TRAIN_SHAPE["block"]
    tokens = sum(r["tokens"] for r in recs[first:]) / len(recs[first:])
    log(f"  {steps} steps in {wall:.1f} s wall (CLI: load, "
        f"{'quantize, ' if quant else ''}data, train, checkpoint"
        f"{', export' if export else ''}); rows {tuple(seen['rows'])}, "
        f"{seen['segments']:.2f} segments per row")
    log(f"  step time (steady steps {first + 1}-{steps}, median) "
        f"{step_s * 1e3:.1f}"
        f" ms, all steps {[round(t * 1e3, 1) for t in times]} ms")
    log(f"  {positions / step_s:.0f} positions/s, {tokens / step_s:.0f} "
        f"trained tokens/s; peak memory {peak:.2f} GiB ({peak - held:.2f} "
        f"above the {held:.2f} GiB held before the run); losses "
        f"{[round(r['loss'], 4) for r in recs]}")
    log(f"  launches {launches}"
        + (f"; model.npz {os.path.getsize(npz) / 2**30:.2f} GiB"
           if export else ""))
    waits = [r["pipe_step_wait_ms"] for r in recs[first:]
             if "pipe_step_wait_ms" in r]
    log(f"  input pipeline: pipe_step_wait_ms (trainer_log.jsonl, steps "
        f"{first + 1}-{steps}) "
        + (f"mean {sum(waits) / len(waits):.3f}, max {max(waits):.3f}"
           if waits else "not logged"))
    busy = None
    if profile:
        groups, busy, window_ms, gpu_ms = device_breakdown(
            os.path.join(out, "trace", "trace.json"), profile)
        log(f"  profiled steps 2-{1 + profile}: {window_ms:.1f} ms of "
            f"device span per step, busy {busy * 100:.1f} %; device ms per "
            "step " + ", ".join(f"{k} {v:.1f} ({v / gpu_ms * 100:.4g} %)"
                                for k, v in groups.items()))
    return launches, {"step_ms": step_s * 1e3, "peak_gib": peak,
                      "busy": busy, **trained}


class RemoteWriteReceiver:
    """A Prometheus remote-write endpoint on localhost, in-process, that
    keeps every POST's path and body."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        posts = self.posts = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                posts.append((self.path, self.headers.get(
                    "Content-Encoding"), self.rfile.read(n)))
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


def unsnappy(data: bytes) -> bytes:
    """A snappy block of literal elements (what the trainer writes)."""
    n, shift, i = 0, 0, 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while i < len(data):
        if data[i] & 3:
            fail("remote-write: a snappy element other than a literal")
        ln = (data[i] >> 2) + 1
        out += data[i + 1:i + 1 + ln]
        i += 1 + ln
    if len(out) != n:
        fail(f"remote-write: {len(out)} bytes decoded, header says {n}")
    return bytes(out)


def check_remote_write(receiver, out, steps):
    """One snappy-framed WriteRequest a logging step carrying the loss
    sample, and the ``watch/metrics.prom`` mirror."""
    train = [unsnappy(body) for path, enc, body in receiver.posts
             if path == "/api/v1/write" and enc == "snappy"
             and b"dtx_train_loss" in unsnappy(body)]
    prom = os.path.join(out, "watch", "metrics.prom")
    if len(train) != steps or not os.path.exists(prom):
        fail(f"remote-write: {len(train)} WriteRequests with the loss "
             f"for {steps} logging steps; metrics.prom "
             f"{os.path.exists(prom)}")
    with open(prom) as f:
        families = sum(1 for ln in f if ln.startswith("# TYPE "))
    log(f"  remote-write: {len(receiver.posts)} WriteRequests received "
        f"({len(train)} with dtx_train_loss, one a logging step, "
        f"{sum(map(len, train))} bytes of protobuf); watch/metrics.prom "
        f"{families} families")


# ------------------------------------------------------------------ phase 6
def train_parity_phase(torch, variants, quant=None, model=None,
                       dropout=0.0):
    """One train step (and one LoRA gradient) under each of two config
    variants — ``(label, overrides)``: the kernels' path first, its plain
    counterpart second — from the same params (quantized with ``quant``),
    adapters and packed batch: tinyllama-1.1b's random params, or the first
    4 layers of the HF directory ``model``. With ``dropout`` the gradient
    and the step draw LoRA-dropout masks (the threefry kernel) from the
    same key in both variants."""
    import dataclasses

    from datatunerx_tpu_torch.ops import prng

    from datatunerx_tpu_torch.data.preprocess import pack_to_block
    from datatunerx_tpu_torch.models.config import get_config
    from datatunerx_tpu_torch.models.llama import init_params
    from datatunerx_tpu_torch.ops.quant import quantize_model_params
    from datatunerx_tpu_torch.training.train_lib import TrainConfig, Trainer
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer,
    )

    gen = torch.Generator().manual_seed(5)
    exs = []
    for _ in range(10):
        n = int(torch.randint(120, 400, (1,), generator=gen))
        ids = torch.randint(3, 32000, (n,), generator=gen).tolist()
        exs.append({"input_ids": ids, "labels": ids})
    batch = pack_to_block(exs, 1024)
    batch = {k: v[:2] for k, v in batch.items()}
    results = {}
    params = None
    for label, overrides in variants:
        if params is None:  # the first variant's, shared by both
            if model is None:
                base = get_config("tinyllama-1.1b", num_layers=4,
                                  remat="dots")
                params = init_params(base, seed=0, dtype=torch.bfloat16,
                                     device="cuda")
            else:
                base, params, _ = load_model_and_tokenizer(
                    model, dtype=torch.bfloat16, device="cuda",
                    config_overrides=dict(num_layers=4, remat="dots"))
            if quant:
                params = quantize_model_params(params, quant)
        cfg = dataclasses.replace(base, **overrides)
        tr = Trainer(cfg, TrainConfig(lora_dropout=dropout, total_steps=10),
                     device="cuda")
        state = tr.init_state(params, 1)
        lgen = torch.Generator(device="cuda").manual_seed(9)
        lora = {"layers": {t: {"a": ab["a"], "b": torch.randn(
            ab["b"].shape, generator=lgen, device="cuda") * 0.01}
            for t, ab in state.lora["layers"].items()}}
        state = dataclasses.replace(state, lora=lora,
                                    opt_state=tr.optimizer.init(lora))
        dev = tr.put_batch(batch)
        leaves = [ab[x].requires_grad_() for ab in lora["layers"].values()
                  for x in ("a", "b")]
        s, n = tr._forward_loss(params, lora, dev, prng.PRNGKey(3),
                                train=dropout > 0)
        grads = torch.autograd.grad(s / n, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        _, m = tr.train_step(state, batch)
        results[label] = (float(m["loss"]), float(m["grad_norm"]),
                          torch.cat([g.flatten().float() for g in grads]))
    (a, (lf, nf, gf)), (b, (lx, nx, gx)) = results.items()
    rel_g = float((gf - gx).norm() / gx.norm())
    log(f"  lora_dropout {dropout}: loss {a} {lf:.6f} vs {b} {lx:.6f}; "
        f"grad_norm {nf:.6f} vs "
        f"{nx:.6f}; LoRA grads relative error {rel_g:.3e}")
    if abs(lf - lx) > 1e-2 * abs(lx):
        fail(f"train parity: loss {lf} ({a}) vs {lx} ({b})")
    if rel_g > 3e-2 or abs(nf - nx) > 3e-2 * nx:
        fail(f"train parity: LoRA grads differ by {rel_g:.3e} relative "
             f"(grad_norm {nf} vs {nx})")


# ----------------------------------------------------------------- phase 11
PATH_STEPS = 4
GEN_EXAMPLES, GEN_NEW = 4, 32


def write_pref_csv(path, seed=1, n=64):
    """Preference rows (instruction, chosen, rejected) made from a seed."""
    import csv
    import random

    rnd = random.Random(seed)
    words = ["alpha", "beta", "gamma", "delta", "tensor", "kernel", "train",
             "model", "token", "layer", "adapter", "rank"]

    def text(lo, hi):
        return " ".join(rnd.choice(words) for _ in range(rnd.randint(lo, hi)))

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["instruction", "chosen", "rejected"])
        for i in range(n):
            w.writerow([f"#{i}: {text(2, 16)}?", text(4, 30), text(4, 30)])


def cli_path(torch, tmp, label, flags, steps=PATH_STEPS, forwards=2,
             batch=TRAIN_SHAPE["batch"], eval_batches=0):
    """One trainer CLI run of tinyllama-1.1b at full width and depth (flash,
    remat dots, bf16, block 1024, LoRA r8 on q_proj,v_proj with the default
    dropout 0.1) with ``flags`` added: K1-K3 and threefry launches held to
    ``expected_launches`` exactly (plus K1 once a layer for each of
    ``eval_batches`` eval-loss batches), finite losses, each step timed to its
    end on the device. Returns (records, output dir, storage dir, step
    ms, peak GiB)."""
    from datatunerx_tpu_torch.ops import cuda_prng
    from datatunerx_tpu_torch.ops import flash_attention as fa
    from datatunerx_tpu_torch.training import train_lib
    from datatunerx_tpu_torch.tuning import train

    out, store = (os.path.join(tmp, label, n) for n in ("out", "store"))
    argv = ["--model_name_or_path", "preset:tinyllama-1.1b",
            "--template", "alpaca", "--finetuning_type", "lora",
            "--lora_target", "q_proj,v_proj", "--attention", "flash",
            "--remat", "dots", "--bf16", "--block_size",
            str(TRAIN_SHAPE["block"]), "--per_device_train_batch_size",
            str(batch), "--max_steps", str(steps), "--logging_steps", "1",
            "--output_dir", out, "--storage_path", store, "--uid", label,
            "--device", "cuda", *flags]
    real_step = train_lib.Trainer.train_step
    times = []

    def timed_step(self, state, b):
        t0 = time.perf_counter()
        new, metrics = real_step(self, state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return new, metrics

    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                cuda_prng.threefry_bits)
    train_lib.Trainer.train_step = timed_step
    try:
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = train.main(argv)
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
    finally:
        train_lib.Trainer.train_step = real_step
    if rc != 0:
        fail(f"[11] {label}: the trainer CLI returned {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected_launches(None, steps, forwards=forwards)
    want = {k: want[k] for k in launches}
    want["flash_fwd"] += eval_batches * LAYERS
    if launches != want:
        fail(f"[11] {label}: launches {launches}, expected {want}")
    with open(os.path.join(out, "watch", "trainer_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != steps or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            for r in recs):
        fail(f"[11] {label}: train records {recs}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    log(f"  {label}: {steps} steps in {wall:.1f} s wall; step (steps 2-"
        f"{steps}, median) {step_s * 1e3:.1f} ms, all "
        f"{[round(t * 1e3, 1) for t in times]} ms; peak {peak:.2f} GiB; "
        f"losses {[round(r['loss'], 5) for r in recs]}; launches "
        f"{launches}")
    return recs, out, os.path.join(store, label), step_s * 1e3, peak


def trainer_paths_phase(torch, tmp):
    """The trainer's item-8 paths through the CLI at tinyllama-1.1b's full
    width and depth: DPO (4 pairs a step: K1 three times a layer, the
    reference forward included), RM (4 pairs; ``v_head.weight`` in the
    merged export), adafactor and lion (SFT, packed 8 x 1024), streaming
    (SFT, 8 padded rows a step) and generative eval (4 examples, 32 new
    tokens; ``generated_predictions.jsonl``). Returns the RM run's
    directory (manifest and checkpoint), phase 12's reward model."""
    import numpy as np

    sft = os.path.join(tmp, "train.csv")
    if not os.path.exists(sft):
        write_train_csv(sft)
    pref = os.path.join(tmp, "pref.csv")
    write_pref_csv(pref)
    recs, *_ = cli_path(torch, tmp, "dpo",
                        ["--stage", "dpo", "--train_path", pref], forwards=3,
                        batch=4)
    if abs(recs[0]["loss"] - math.log(2)) > 1e-3:
        fail(f"[11] dpo: first-step loss {recs[0]['loss']}, expected ln 2 "
             "(the policy starts equal to the reference)")
    export = os.path.join(tmp, "rm", "export")
    _, _, rm_run, *_ = cli_path(torch, tmp, "rm", [
        "--stage", "rm", "--train_path", pref, "--export_dir", export],
        batch=4)
    with np.load(os.path.join(export, "model.npz")) as z:
        if "v_head.weight" not in z.files or z["v_head.weight"].shape != (
                2048,) or not np.isfinite(z["v_head.weight"]).all():
            fail("[11] rm: the export holds no finite v_head.weight [2048]")
    for optim in ("adafactor", "lion"):
        cli_path(torch, tmp, optim, ["--optim", optim, "--train_path", sft,
                                     "--pack_sequences"])
    cli_path(torch, tmp, "streaming", ["--streaming", "--train_path", sft,
                                       "--shuffle_buffer", "64"])
    held_out = os.path.join(tmp, "eval.csv")
    write_train_csv(held_out, seed=3, n=8)  # one eval-loss batch
    _, out, *_ = cli_path(torch, tmp, "generate", [
        "--train_path", sft, "--pack_sequences", "--evaluation_path",
        held_out, "--predict_with_generate", "--generate_examples",
        str(GEN_EXAMPLES), "--max_new_tokens", str(GEN_NEW),
        "--per_device_eval_batch_size", "8"], steps=2, eval_batches=1)
    with open(os.path.join(out, "generated_predictions.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(out, "watch", "eval_log.jsonl")) as f:
        scores = [r for r in map(json.loads, f) if "rouge-1" in r]
    if len(rows) != GEN_EXAMPLES or not scores:
        fail(f"[11] generate: {len(rows)} predictions, scores {scores}")
    log(f"  generate: {len(rows)} predictions; "
        + ", ".join(f"{k} {scores[-1][k]:.4f}"
                    for k in ("rouge-1", "rouge-2", "rouge-l", "bleu-4")))
    return rm_run


PPO_STEPS, PPO_BATCH, PPO_BLOCK, PPO_GEN, PPO_EPOCHS = 4, 4, 192, 64, 2


def write_prompt_csv(path, seed=2, n=PPO_STEPS * PPO_BATCH, words_each=300):
    """Prompts (an instruction column) made from a seed, each long enough
    to fill the PPO block: no row is left-padded (ROADMAP Queue 3: the
    flash forward attends to left pads in both packages)."""
    import csv
    import random

    rnd = random.Random(seed)
    words = ["alpha", "beta", "gamma", "delta", "tensor", "kernel", "train",
             "model", "token", "layer", "adapter", "rank", "reward", "policy"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["instruction"])
        for i in range(n):
            w.writerow([f"#{i}: " + " ".join(rnd.choice(words)
                                            for _ in range(words_each))])


def ppo_launches(layers=LAYERS, epochs=PPO_EPOCHS):
    """A PPO step's flash launches: K1 once a layer for the reference and
    the reward forwards (no grad, no remat) and twice a layer an update
    pass (forward + the ``dots`` recompute), K2 and K3 once a layer a
    pass; no threefry (PPO runs no dropout). The rollout's prefill and
    decode read the dense cache on the biased path, in both packages."""
    return {"flash_fwd": 2 * layers + 2 * layers * epochs,
            "flash_bwd_dq": layers * epochs, "flash_bwd_dkv": layers * epochs,
            "threefry_bits": 0}


def ppo_first_logps(torch, trainer, state, ro):
    """The first rollout's response log-probs through the update's forward
    (no grad, the pass's params) three ways: ``flash`` (K1 in bf16, what
    the pass runs), ``plain`` (the plain attention in bf16) and ``f32``
    (the plain attention in f32)."""
    import dataclasses

    from datatunerx_tpu_torch.models.llama import forward, lm_logits

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float()

    G = ro["old_logp"].shape[1]
    Tp = ro["seq"].shape[1] - G
    out = {}
    for name, impl in (("flash", "flash"), ("plain", "xla"), ("f32", "xla")):
        cfg = dataclasses.replace(trainer.model_cfg, attention_impl=impl)
        wide = name == "f32"
        params = f32(state.params) if wide else state.params
        lora = f32(state.lora) if wide else state.lora
        with torch.no_grad():
            _, _, hid = forward(
                params, ro["seq"], cfg, positions=ro["positions"],
                attention_mask=ro["full_mask"], lora=(lora, trainer.scaling),
                compute_dtype=None if wide else trainer.cfg.compute_dtype,
                return_hidden=True, skip_logits=True)
            lg = lm_logits(params, hid[:, Tp - 1:-1], cfg)
            out[name] = torch.gather(torch.log_softmax(lg, -1), -1,
                                     ro["seq"][:, Tp:].long()[..., None])[
                                         ..., 0].float()
        del params, lora, hid, lg
    return out


def ppo_phase(torch, tmp, rm_run):
    """``--stage ppo`` through the trainer CLI at tinyllama-1.1b's full
    width and depth (flash, remat dots, bf16, LoRA r8 on q_proj,v_proj)
    against phase 11's RM run: 4 prompts a step filling ``PPO_BLOCK``,
    ``PPO_GEN`` sampled tokens, 2 passes, ``PPO_STEPS`` steps, step 2
    under the CLI's profiler window.
    Holds each step's K1/K2/K3 launches to ``ppo_launches`` and threefry
    to 0; the first pass's ratio at the rollout's policy (the pass's
    forward runs before its update, the lr = 0 case): clipfrac 0, and the
    flash forward's approx_kl within 1e-3 of the plain attention's on the
    same rollout, with its log-probs no further from the f32 forward's
    than 1.5 times the plain attention's (bf16 alone parts the cached
    decode from a full forward by about 1e-3 at this depth); finite
    losses and the controller state; logs the median
    of the steps after 2 and the profiled step's busy share, device ms and
    GPU kernels."""
    from datatunerx_tpu_torch.ops import cuda_prng
    from datatunerx_tpu_torch.ops import flash_attention as fa
    from datatunerx_tpu_torch.training import ppo
    from datatunerx_tpu_torch.tuning import train

    prompts = os.path.join(tmp, "prompts.csv")
    write_prompt_csv(prompts)
    out, store = (os.path.join(tmp, "ppo", n) for n in ("out", "store"))
    argv = ["--model_name_or_path", "preset:tinyllama-1.1b",
            "--stage", "ppo",
            "--reward_model", rm_run, "--train_path", prompts,
            "--template", "alpaca", "--finetuning_type", "lora",
            "--lora_target", "q_proj,v_proj", "--attention", "flash",
            "--remat", "dots", "--bf16", "--block_size", str(PPO_BLOCK),
            "--per_device_train_batch_size", str(PPO_BATCH),
            "--ppo_gen_len", str(PPO_GEN), "--ppo_epochs", str(PPO_EPOCHS),
            "--max_steps", str(PPO_STEPS), "--logging_steps", "1",
            "--profile_steps", "1", "--output_dir", out,
            "--storage_path", store, "--uid", "ppo"]
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                cuda_prng.threefry_bits)
    T = ppo.PPOTrainer
    real = {n: getattr(T, n) for n in ("step", "_rollout", "_update")}
    steps, passes = [], []

    def timed(name, sink):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](self, *a, **kw)
            torch.cuda.synchronize()
            sink.append({"s": time.perf_counter() - t0})
            return out
        return run

    rollouts, updates = [], []

    def step(self, state, batch):
        before = {c.__name__: c.launches for c in counters}
        new, metrics = timed("step", steps)(self, state, batch)
        steps[-1]["launches"] = {c.__name__: c.launches - before[c.__name__]
                                 for c in counters}
        return new, metrics

    first_in = []

    def update(self, state, ro):
        if not first_in:  # the first rollout and the state it was drawn at
            first_in.extend((self, state, ro))
        new, metrics = timed("_update", updates)(self, state, ro)
        passes.append({k: float(metrics[k]) for k in
                       ("loss", "pg_loss", "vf_loss", "approx_kl",
                        "clipfrac")})
        return new, metrics

    T.step, T._rollout, T._update = step, timed("_rollout", rollouts), update
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = train.main(argv)
        wall = time.perf_counter() - t0
    finally:
        for n, fn in real.items():
            setattr(T, n, fn)
    peak = torch.cuda.max_memory_allocated() / 2**30  # before the f32 copy
    if rc != 0:
        fail(f"[12] ppo: the trainer CLI returned {rc}")
    if len(steps) != PPO_STEPS or len(passes) != PPO_STEPS * PPO_EPOCHS:
        fail(f"[12] ppo: {len(steps)} steps, {len(passes)} update passes")
    want = ppo_launches()
    for i, st in enumerate(steps):
        if st["launches"] != want:
            fail(f"[12] ppo step {i + 1}: launches {st['launches']}, "
                 f"expected {want}")
    first = passes[0]
    saved = {c.__name__: c.launches for c in counters}
    lp = ppo_first_logps(torch, *first_in)
    for c in counters:  # the comparison's launches are not the path's
        c.launches = saved[c.__name__]
    ro = first_in[2]
    m = ro["resp_mask"]

    def mmean(x):
        return float(torch.sum(x * m) / torch.sum(m))

    kl = {n: mmean(ro["old_logp"] - v) for n, v in lp.items()}
    err = {n: mmean(torch.abs(v - lp["f32"])) for n, v in lp.items()}
    err["decode"] = mmean(torch.abs(ro["old_logp"] - lp["f32"]))
    first_in.clear()
    log(f"  ppo: first rollout, approx_kl of the cached decode against the "
        f"update's forward: flash {kl['flash']:.4g} (the pass read "
        f"{first['approx_kl']:.4g}), plain attention {kl['plain']:.4g}, "
        f"f32 {kl['f32']:.4g}; mean |log-prob - f32's|: flash "
        f"{err['flash']:.4g}, plain {err['plain']:.4g}, cached decode "
        f"{err['decode']:.4g}")
    if not (first["clipfrac"] == 0.0
            and abs(kl["flash"] - kl["plain"]) < 1e-3
            and err["flash"] <= 1.5 * err["plain"]):
        fail(f"[12] ppo: the first pass (at the rollout's policy) reads "
             f"clipfrac {first['clipfrac']}, approx_kl {kl['flash']} "
             f"through flash against {kl['plain']} through the plain "
             f"attention, mean log-prob error {err['flash']} against "
             f"{err['plain']}: the flash forward disagrees")
    if not all(math.isfinite(v) for p in passes for v in p.values()):
        fail(f"[12] ppo: non-finite update metrics {passes}")
    with open(os.path.join(out, "watch", "trainer_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != PPO_STEPS or not all(
            math.isfinite(r[k]) for r in recs
            for k in ("loss", "reward_score", "kl", "grad_norm")):
        fail(f"[12] ppo: train records {recs}")
    cs = ppo.load_controller_state(os.path.join(store, "ppo", "checkpoints"))
    if cs is None or cs["step"] != PPO_STEPS:
        fail(f"[12] ppo: controller state {cs}")
    after = range(2, PPO_STEPS)  # step 2 ran under the profiler
    roll = median([rollouts[i]["s"] for i in after])
    upd = median([sum(u["s"] for u in updates[i * PPO_EPOCHS:
                                               (i + 1) * PPO_EPOCHS])
                  for i in after])
    stp = median([steps[i]["s"] for i in after])
    trace = os.path.join(out, "trace", "trace.json")
    groups, busy, window_ms, gpu_ms = device_breakdown(trace, 1)
    with open(trace) as f:
        kernels = sum(1 for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel")
    log(f"  ppo: profiled step 2: {window_ms:.1f} ms of device span, "
        f"busy {busy * 100:.1f} %, device ms {gpu_ms:.1f} ("
        + ", ".join(f"{k} {v:.1f}" for k, v in groups.items())
        + f"); {kernels} GPU kernels in the step")
    log(f"  ppo: {PPO_STEPS} steps in {wall:.1f} s wall; steps 3-"
        f"{PPO_STEPS} (median): rollout {roll * 1e3:.1f} ms "
        f"({PPO_BATCH * PPO_GEN / roll:.1f} tokens/s), update ({PPO_EPOCHS} "
        f"passes) {upd * 1e3:.1f} ms, step {stp * 1e3:.1f} ms; all steps "
        f"{[round(st['s'] * 1e3, 1) for st in steps]} ms; peak "
        f"{peak:.2f} GiB; launches a step {steps[0]['launches']}")
    log(f"  ppo: first pass approx_kl {first['approx_kl']:.3g}, clipfrac "
        f"{first['clipfrac']}; records "
        + "; ".join(f"reward {r['reward_score']:.4f} kl {r['kl']:.4g} loss "
                    f"{r['loss']:.4f} len {r['response_len']:.1f}"
                    for r in recs)
        + f"; kl_coef saved {cs['kl_coef']:.6f}")
    return {"launches": {k: sum(st["launches"][k] for st in steps)
                         for k in want},
            "rollout_ms": roll * 1e3, "update_ms": upd * 1e3,
            "step_ms": stp * 1e3, "peak_gib": peak}


def wait_for(label, probe, want, timeout, poll=0.5):
    """Poll ``probe()`` until it returns one of ``want``; seconds taken."""
    t0 = time.perf_counter()
    while True:
        got = probe()
        if got in want:
            return time.perf_counter() - t0, got
        if time.perf_counter() - t0 > timeout:
            fail(f"{label}: still {got!r} after {timeout} s")
        time.sleep(poll)


def launch_phase(torch, tmp):
    """The port's launch backends on the card: ``LocalProcessBackend``
    runs a 2-step LoRA SFT job (a trainer subprocess) with a ``file://``
    storage path, its manifest appears there, ``LocalServingBackend``
    serves the manifest's checkpoint (a server subprocess) until HEALTHY,
    which answers two ``/chat/completions`` and two ``/perplexity``;
    ``delete`` tears both down. The reference operator cannot run here
    (it imports the JAX package): its half of the pipeline is held on the
    CPU (``tests/test_torch_pipeline_e2e.py``)."""
    from datatunerx_tpu_torch.operator.backends import LocalProcessBackend
    from datatunerx_tpu_torch.serving.local_backend import (
        LocalServingBackend,
    )
    from datatunerx_tpu_torch.training.checkpoint import read_manifest

    csv_path = os.path.join(tmp, "launch.csv")
    write_train_csv(csv_path, seed=4, n=64)
    work = os.path.join(tmp, "launch", "jobs")
    # the storage path through fsspec's file:// scheme: the manifest and
    # checkpoint are written and served through the object-store plane
    store = "file://" + os.path.join(tmp, "launch", "store")
    model, timeout = "preset:tinyllama-1.1b", 600
    torch.cuda.empty_cache()  # the subprocesses share the card
    training = LocalProcessBackend(work)
    serving = LocalServingBackend(work, template="alpaca")
    try:
        training.submit("smoke-job", {"args": [
            "--model_name_or_path", model, "--train_path", csv_path,
            "--storage_path", store, "--uid", "smoke-job", "--output_dir",
            "result", "--template", "alpaca", "--lora_target",
            "q_proj,v_proj", "--attention", "flash", "--remat", "dots",
            "--bf16", "true", "--block_size", "256",
            "--per_device_train_batch_size", "4", "--max_steps", "2",
            "--logging_steps", "1"]})
        job_s, state = wait_for("[13] training job", lambda: training.status(
            "smoke-job"), ("Succeeded", "Failed"), timeout)
        if state != "Succeeded":
            fail(f"[13] the trainer subprocess failed:\n"
                 f"{training.log_tail('smoke-job')}")
        manifest = read_manifest(store, "smoke-job")
        if manifest is None or manifest.get("steps") != 2 or not manifest[
                "checkpoint"].startswith("file://"):
            fail(f"[13] manifest {manifest}")
        serving.deploy("smoke-app", {
            "model_path": model, "checkpoint_path": manifest["checkpoint"]})
        up_s, state = wait_for("[13] server", lambda: serving.status(
            "smoke-app"), ("HEALTHY", "FAILED"), timeout)
        if state != "HEALTHY":
            with open(os.path.join(work, "serve-smoke-app", "log.txt")) as f:
                fail(f"[13] the server subprocess failed:\n{f.read()[-3000:]}")
        port = int(serving.endpoint("smoke-app").rsplit(":", 1)[1])
        # twice each: the first request carries the server's first use of
        # the card
        chats = [post(port, {"messages": [{"role": "user",
                                           "content": "add 2+2"}],
                             "max_tokens": 16}) for _ in range(2)]
        ppls = [post_perplexity(port, "add 2+2", " answer 4")
                for _ in range(2)]
        ppl = ppls[0][0]
        if not all(isinstance(c["text"], str) for c in chats) or not (
                ppl["num_tokens"] > 0 and math.isfinite(ppl["perplexity"])):
            fail(f"[13] answers: chats {chats}, perplexity {ppl}")
    finally:
        serving.delete("smoke-app")
        training.delete("smoke-job")
    if serving.status("smoke-app") != "NotFound" or training.status(
            "smoke-job") != "NotFound":
        fail("[13] delete left a process behind")
    chat_ms = [round(c["wall_s"] * 1e3, 1) for c in chats]
    ppl_ms = [round(ms, 1) for _, ms in ppls]
    log(f"  launch: job (2 steps, subprocess) {job_s:.1f} s to Succeeded; "
        f"server to HEALTHY {up_s:.1f} s; /chat/completions {chat_ms} ms "
        f"(16 tokens max, first and second); /perplexity {ppl_ms} ms "
        f"({ppl['num_tokens']} tokens, perplexity {ppl['perplexity']:.2f}); "
        "torn down")
    return {"job_s": job_s, "up_s": up_s, "chat_ms": chat_ms,
            "ppl_ms": ppl_ms}


# ------------------------------------------------------------- phase 14

GATEWAY_FLAGS = ("--template", "vanilla", "--max_seq_len", "2048",
                 "--kv_block_size", "16", "--slots", "4",
                 "--prefix_cache", "8")
GATEWAY_NEW = 64
GATEWAY_THRESHOLD = 768  # tokens: only the handoff prompt reaches it
# a pinned tenant, and a bulk one whose quota is below what a ~600-token
# prompt needs (blocks_for_admit(600, 16) = 42)
GATEWAY_TENANTS = {"gold": {"tier": "pinned", "share": 3},
                   "batch": {"tier": "bulk", "share": 1,
                             "kv_block_quota": 16}}
GW_FAMILIES = (
    "dtx_gateway_requests_total", "dtx_gateway_request_latency_seconds",
    "dtx_gateway_replica_up", "dtx_gateway_replica_role",
    "dtx_gateway_role_routes_total", "dtx_gateway_handoff_total",
    "dtx_gateway_handoff_splices_total", "dtx_gateway_shed_total",
    "dtx_gateway_tenant_requests_total", "dtx_gateway_tenant_share",
    "dtx_gateway_replica_kv_blocks_free",
    "dtx_gateway_adapter_resident_replicas",
    "dtx_fleet_handoff_total", "dtx_fleet_prefix_entries")


def rand_text(rnd, n):
    """``n`` bytes of lowercase words: ``n`` tokens under the byte-level
    tokenizer of the presets."""
    out = ""
    while len(out) < n:
        out += "".join(rnd.choice("abcdefghijklmnopqrstuvwxyz")
                       for _ in range(rnd.randrange(2, 9))) + " "
    return out[:n]


def gate(eng, when):
    """Hold ``eng``'s scheduler between two ticks while ``when()`` is true,
    until the returned callable releases it; the held loop keeps serving
    session commands (the first call of every tick), so an export or an
    import still runs: a gate, not a clock."""
    opened = threading.Event()
    serve = eng._service_migrations

    def held():
        serve()
        while when() and not opened.is_set():
            opened.wait(0.001)
            serve()

    eng._service_migrations = held

    def release():
        opened.set()
        del eng._service_migrations

    return release


def gw_post(port, body, trace="", tenant="", stream=False):
    """(status, JSON body or SSE text, wall s) of one chat to the
    gateway."""
    headers = {"Content-Type": "application/json", "X-DTX-Trace-Id": trace}
    if tenant:
        headers["X-DTX-Tenant"] = tenant
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/chat/completions", headers=headers,
        data=json.dumps(dict(body, stream=stream)).encode())
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            if not stream:
                return resp.status, json.loads(resp.read()), \
                    time.perf_counter() - t0
            text = ""
            for ev in sse_events(resp):
                if "error" in ev:
                    raise RuntimeError(ev["error"])
                text += ev["choices"][0]["delta"].get("content") or ""
            return resp.status, text, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def spliced_text(tok, tail, full):
    """A client's stream spliced at ``tail``: the gateway sends the
    import's ``text_so_far`` (the tail's whole text), then the
    continuation's stream past the tail."""
    return (tok.decode(tail, skip_special_tokens=True)
            + sse_text(tok, full, len(tail)))


def server_pids(root=None):
    """Pids of the port's server processes (whose working directory is
    under ``root``, if given)."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
            cwd = os.readlink(f"/proc/{pid}/cwd")
        except OSError:
            continue
        if b"datatunerx_tpu_torch.serving.server" in cmd and (
                root is None or cwd.startswith(root)):
            pids.append(int(pid))
    return sorted(pids)


def gateway_phase(torch, counters):
    """14a (see the module docstring): the port's gateway in this process
    over two in-process port servers. ``counters`` are K7, K8 and K9's
    ``(wrapper, attribute)``; returns their launches over the gateway's
    traffic."""
    import random

    from datatunerx_tpu_torch.gateway.admission import AdmissionController
    from datatunerx_tpu_torch.gateway.replica_pool import (
        HTTPReplica,
        ReplicaPool,
    )
    from datatunerx_tpu_torch.gateway.server import Gateway, serve
    from datatunerx_tpu_torch.serving import server
    from datatunerx_tpu_torch.utils.model_loader import load_tokenizer

    rnd = random.Random(18)
    t_phase = time.perf_counter()
    servers, ports, engines = {}, {}, {}
    for role in ("prefill", "decode"):
        state = server.ServingState()
        srv, ports[role], engines[role] = start_server(
            torch, GATEWAY_FLAGS + ("--role", role), state=state)
        servers[role] = (srv, state)
    gw = srv_gw = None
    try:
        tok = load_tokenizer("preset:tinyllama-1.1b")
        pool = ReplicaPool(
            [HTTPReplica(role, f"http://127.0.0.1:{ports[role]}", role=role)
             for role in ("prefill", "decode")], health_interval_s=1.0)
        gw = Gateway(pool, model_name="preset:tinyllama-1.1b",
                     admission=AdmissionController(
                         count_tokens=lambda t: len(tok.encode(t))),
                     prefill_threshold=GATEWAY_THRESHOLD,
                     fleet_prefix_bytes=256 << 20, fleet_handoff=True,
                     session_handoff=True, tenants=GATEWAY_TENANTS)
        srv_gw = serve(gw, port=0, host="127.0.0.1")
        threading.Thread(target=srv_gw.serve_forever, daemon=True).start()
        gport = srv_gw.server_port
        seen = {r: record_submits(e) for r, e in engines.items()}
        imported = {r: capture_imports(e) for r, e in engines.items()}
        P, D = engines["prefill"], engines["decode"]

        def where(tid):
            return next(r for r in engines if tid in seen[r])

        def body(text, new=GATEWAY_NEW):
            return {"messages": [{"role": "user", "content": text}],
                    "max_tokens": new, "temperature": 0.0}

        zero(counters)
        marks = {r: len(e.sched_trace) for r, e in engines.items()}

        # ---- 1. four concurrent greedy chats
        chats = [rand_text(rnd, 160 + 48 * i) for i in range(4)]
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.setdefault(
            i, gw_post(gport, body(chats[i]), trace=f"gw-chat-{i}")))
            for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(out.get(i, (0,))[0] != 200 for i in range(4)):
            fail(f"14 chats: {out}")
        chat_reqs = [seen[where(f"gw-chat-{i}")][f"gw-chat-{i}"]
                     for i in range(4)]
        log(f"  chats: replicas {[where(f'gw-chat-{i}') for i in range(4)]}"
            f", {[len(r.tokens) for r in chat_reqs]} tokens")

        # ---- 2. the prefix tier: a shared ~520-token prompt served once
        shared = rand_text(rnd, 520)
        code, _, _ = gw_post(gport, body(shared, 8), trace="gw-shared")
        if code != 200 or where("gw-shared") != "decode":
            fail(f"14 prefix: the shared prompt answered {code} on "
                 f"{where('gw-shared')}")
        # a tick syncs the replicas in turn, pulling before it pushes: the
        # decode replica's entries reach the prefill replica on the second
        t0 = time.perf_counter()
        ticks = [gw.fleet.tick() for _ in range(2)]
        tick1_ms = (time.perf_counter() - t0) * 1e3
        if ticks[1]["prefix"]["pushed"] < 1:
            fail(f"14 prefix: the tier pushed nothing: {ticks}")

        # ---- 3. handoff: a prompt above the threshold, the shared one
        # inside it, goes to the prefill replica; its decode moves on
        long_text = shared + rand_text(rnd, 360)
        mark_p = len(P.sched_trace)
        release = gate(P, lambda: any(r is not None and len(r.tokens) >= 3
                                      for r in P._slot_req))
        hand = {}
        th = threading.Thread(target=lambda: hand.setdefault(
            "out", gw_post(gport, body(long_text), trace="gw-handoff",
                           stream=True)))
        try:
            th.start()
            t0 = time.perf_counter()
            while not any(r is not None and len(r.tokens) >= 3
                          for r in P._slot_req):
                if time.perf_counter() - t0 > 300 or not th.is_alive():
                    fail("14 handoff: the prefill replica never decoded")
                time.sleep(0.001)
            # the coordinator reads the replica's last scraped stats, which
            # routing refreshes once their 1 s lifetime is up: refresh them
            # as routing would, until they show the session
            rep = gw.pool.get("prefill")
            while not rep.stats().get("slots_busy"):
                if time.perf_counter() - t0 > 300:
                    fail("14 handoff: the prefill replica's stats never "
                         "showed the session")
                time.sleep(0.01)
            t0 = time.perf_counter()
            tick2 = gw.fleet.tick()
            handoff_ms = (time.perf_counter() - t0) * 1e3
        finally:
            release()
        th.join(timeout=600)
        if tick2["handoff"]["moved"] != 1 or hand["out"][0] != 200:
            fail(f"14 handoff: tick {tick2}, answer {hand['out'][0]}")
        trace_p = list(P.sched_trace)[mark_p:]
        admits = [e for e in trace_p if e[0] == "admit"]
        p_tokens = sum(e[2] for e in trace_p if e[0] == "prefill")
        h_req = seen["prefill"]["gw-handoff"]
        h_ids = list(h_req.prompt_ids)
        s_len = len(tok.encode(shared, add_special_tokens=True))
        log(f"  prefix + handoff: the {len(h_ids)}-token prompt was admitted "
            f"on the prefill replica as {[e[3] for e in admits]}, which "
            f"prefilled {p_tokens} tokens in chunks (the shared "
            f"{s_len}-token prompt none); the tick moving it took "
            f"{handoff_ms:.1f} ms (the prefix tier's two ticks "
            f"{tick1_ms:.1f} ms: {[t['prefix'] for t in ticks]})")
        if p_tokens > len(h_ids) - s_len + 64:
            fail(f"14 prefix: the prefill replica prefilled {p_tokens} of "
                 f"{len(h_ids)} tokens with {s_len} shared")
        stats = gw.fleet.stats()
        if stats["handoff"].get("ok") != 1:
            fail(f"14 handoff: the gateway's stats {stats['handoff']}")
        h_tail, h_full = list(h_req.tokens), imported["decode"][
            "gw-handoff"].tokens
        if h_full[:len(h_tail)] != h_tail or hand["out"][1] != spliced_text(
                tok, h_tail, h_full):
            fail("14 handoff: the client's stream is not the tail and its "
                 "continuation")

        # ---- 4. drain: a 64-token greedy stream on the decode replica
        drain_text = rand_text(rnd, 300)
        release = gate(D, lambda: any(r is not None and len(r.tokens) >= 8
                                      for r in D._slot_req))
        drained = {}
        th = threading.Thread(target=lambda: drained.setdefault(
            "out", gw_post(gport, body(drain_text), trace="gw-drain",
                           stream=True)))
        try:
            th.start()
            t0 = time.perf_counter()
            while not any(r is not None and len(r.tokens) >= 8
                          for r in D._slot_req):
                if time.perf_counter() - t0 > 300 or not th.is_alive():
                    fail("14 drain: the decode replica never decoded")
                time.sleep(0.001)
            code, doc = admin(gport, "POST", "/admin/drain",
                              {"replica": "decode"})
            last = dict(gw.last_handoff)
            empty = all(r is None for r in D._slot_req)
        finally:
            release()
        th.join(timeout=600)
        if code != 200 or last.get("imported") != 1 or not empty:
            fail(f"14 drain: answered {code} {doc}, last handoff {last}, "
                 f"the drained replica empty: {empty}")
        d_req = seen["decode"]["gw-drain"]
        d_imp = imported["prefill"]["gw-drain"]
        d_tail, d_full = list(d_req.tokens), list(d_imp.tokens)
        if drained["out"][0] != 200 or d_full[:len(d_tail)] != d_tail or \
                drained["out"][1] != spliced_text(tok, d_tail, d_full):
            fail("14 drain: the client's stream is not the tail and its "
                 "continuation")
        drain_gap_ms = (d_imp.first_token_ts - d_req.last_token_ts) * 1e3
        gw.pool.get("decode").undrain()
        log(f"  drain: {len(d_tail)} tokens on the decode replica, "
            f"{len(d_full) - len(d_tail)} after the splice on the prefill "
            f"replica; the client's gap (the source's last token to the "
            f"destination's first) {drain_gap_ms:.1f} ms; handoffs "
            f"{gw.handoff_stats()}")

        # ---- 5. tenancy
        t_text = rand_text(rnd, 600)
        code_b, doc_b, _ = gw_post(gport, body(t_text), trace="gw-batch",
                                   tenant="batch")
        err = doc_b.get("error", "") if isinstance(doc_b, dict) else ""
        if code_b != 429 or "tenant batch" not in err or "blocks" not in err:
            fail(f"14 tenancy: the bulk request answered {code_b} {doc_b}")
        code_g, _, _ = gw_post(gport, body(t_text), trace="gw-gold",
                               tenant="gold")
        code_t, tenants = admin(gport, "GET", "/admin/tenants")
        if code_g != 200 or code_t != 200 or sorted(
                tenants.get("tenants", {})) != ["batch", "gold"]:
            fail(f"14 tenancy: gold answered {code_g}, /admin/tenants "
                 f"{code_t} {tenants}")
        log(f"  tenancy: bulk 429 ({err}); pinned 200; /admin/tenants "
            f"lists {sorted(tenants['tenants'])}")

        # ---- 6. /metrics
        with urllib.request.urlopen(f"http://127.0.0.1:{gport}/metrics",
                                    timeout=60) as r:
            text = r.read().decode()
        missing = [f for f in GW_FAMILIES if f"# TYPE {f} " not in text]
        kv = [ln for ln in text.splitlines()
              if ln.startswith("dtx_gateway_replica_kv_blocks_free{")]
        if missing or len(kv) != 2:
            fail(f"14 /metrics: missing {missing}, kv lines {kv}")

        # ---- 7. launches over the gateway's traffic, summed over both
        got = {counter_key(c, a): getattr(c, a) for c, a in counters}
        L = P.cfg.num_layers
        steps = chunks = 0
        for r, e in engines.items():
            s_, c_, _ = trace_counts(e, marks[r])
            steps, chunks = steps + s_, chunks + c_
        want = dict(zip(got, (L * steps, L * chunks, steps)))
        log(f"  launches: {got} over {steps} decode steps and {chunks} "
            f"prefill chunks of both replicas' traces; expected {want}")
        if got != want or steps <= 0 or chunks <= 0:
            fail(f"14 launches {got}, expected {want}")

        # ---- the same prompts straight to a replica (not counted)
        for i, req in enumerate(chat_reqs):
            r = where(f"gw-chat-{i}")
            code, _, _ = gw_post(ports[r], body(chats[i]),
                                 trace=f"direct-chat-{i}")
            ref = seen[r][f"direct-chat-{i}"]
            check_greedy(torch, f"14 chat {i}", list(req.tokens),
                         list(ref.tokens), engines[r], list(req.prompt_ids),
                         GATEWAY_NEW, stops=req.stop_ids)
        for label, tid, full, text in (
                ("handoff", "gw-handoff", h_full, long_text),
                ("drain", "gw-drain", d_full, drain_text)):
            gw_post(ports["decode"], body(text), trace=f"direct-{label}")
            ref = seen["decode"][f"direct-{label}"]
            req = seen["prefill" if label == "handoff" else "decode"][tid]
            check_greedy(torch, f"14 {label}", list(full), list(ref.tokens),
                         D, list(req.prompt_ids), GATEWAY_NEW,
                         stops=req.stop_ids)

        # ---- timing: each request alone, gateway and direct in turns
        timing = {"gateway": {"ttft": [], "wall": [], "tokens": []},
                  "direct": {"ttft": [], "wall": [], "tokens": []}}
        for j, route in enumerate(("gateway", "direct", "direct",
                                   "gateway")):
            port = gport if route == "gateway" else ports["decode"]
            tid = f"time-{route}-{j}"
            _, _, ttft = gw_post(port, body(rand_text(rnd, 400), 1))
            code, doc, wall = gw_post(port, body(rand_text(rnd, 400)),
                                      trace=tid)
            if code != 200:
                fail(f"14 timing: {route} answered {code} {doc}")
            n = len(seen[where(tid)][tid].tokens)
            timing[route]["ttft"].append(ttft * 1e3)
            timing[route]["wall"].append(wall * 1e3)
            timing[route]["tokens"].append(n)
        summary = {}
        for route, t in timing.items():
            summary[route] = {
                "ttft_ms": median(t["ttft"]), "wall_ms": median(t["wall"]),
                "tok_s": median([n / (w / 1e3) for n, w in
                                 zip(t["tokens"], t["wall"])])}
        added = summary["gateway"]["wall_ms"] - summary["direct"]["wall_ms"]
        log(f"  a request alone (400-token prompts, host clock, medians of "
            f"{len(timing['direct']['wall'])}): through the gateway TTFT "
            f"(1 token) "
            f"{summary['gateway']['ttft_ms']:.1f} ms, 64 tokens "
            f"{summary['gateway']['wall_ms']:.1f} ms = "
            f"{summary['gateway']['tok_s']:.1f} tok/s; direct TTFT "
            f"{summary['direct']['ttft_ms']:.1f} ms, "
            f"{summary['direct']['wall_ms']:.1f} ms = "
            f"{summary['direct']['tok_s']:.1f} tok/s; the gateway adds "
            f"{added:.1f} ms a request")
        log(f"  14a took {time.perf_counter() - t_phase:.1f} s")
        return got
    finally:
        if srv_gw is not None:
            srv_gw.shutdown()
            srv_gw.server_close()
        if gw is not None:
            gw.slo.stop()
            gw.pool.close()
        for role in list(servers):
            srv, state = servers.pop(role)
            eng = state.engine
            stop_server(srv, state)
            eng.close()


def gateway_spawn_phase(torch, tmp):
    """14b (see the module docstring): ``LocalServingBackend`` deploys the
    port's gateway, which spawns two port servers on the card; scaled to
    one, then deleted, leaving no server process."""
    from datatunerx_tpu_torch.serving.local_backend import (
        LocalServingBackend,
    )

    work = os.path.join(tmp, "gateway-deploy")
    torch.cuda.empty_cache()  # the subprocesses share the card
    backend = LocalServingBackend(work)
    pids = []
    try:
        backend.deploy("gw", {"model_path": "preset:tinyllama-1.1b",
                              "replicas": 2, "kv_block_size": 16,
                              "slots": 4})
        up_s, state = wait_for("[14b] gateway", lambda: backend.status(
            "gw"), ("HEALTHY", "FAILED"), 600)
        if state != "HEALTHY":
            with open(os.path.join(work, "serve-gw", "log.txt")) as f:
                fail(f"[14b] the gateway failed:\n{f.read()[-3000:]}")
        pids = server_pids(work)
        if len(pids) != 2:
            fail(f"[14b] {len(pids)} replica processes, expected 2")
        port = int(backend.endpoint("gw").rsplit(":", 1)[1])
        chats = []
        for i in range(2):
            code, doc, wall = gw_post(port, {
                "messages": [{"role": "user", "content": f"chat {i}"}],
                "max_tokens": 16})
            if code != 200 or "content" not in doc["choices"][0]["message"]:
                fail(f"[14b] chat {i}: {code} {doc}")
            chats.append(round(wall * 1e3, 1))
        hint = backend.scale_hint("gw")
        if not hint or hint["replicas"] != 2:
            fail(f"[14b] hint {hint}, expected 2 replicas")
        if not backend.scale("gw", 1):
            fail("[14b] scale to 1 was refused")
        scale_s, _ = wait_for("[14b] scale", lambda: (backend.scale_hint(
            "gw") or {}).get("replicas"), (1,), 120)
        reap_s, _ = wait_for("[14b] reap", lambda: len(server_pids(work)),
                             (1,), 120)
    finally:
        backend.delete("gw")
    left_s, _ = wait_for("[14b] delete", lambda: len(server_pids()), (0,), 60)
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True)
    listed = {int(x) for x in smi.stdout.split() if x.strip().isdigit()}
    if smi.returncode != 0 or listed & set(pids):
        fail(f"[14b] nvidia-smi still lists {listed & set(pids)} "
             f"({smi.stderr.strip()})")
    log(f"  deploy: HEALTHY in {up_s:.1f} s (a gateway and 2 port servers); "
        f"chats {chats} ms (16 tokens max); hint 2 replicas, then 1 after "
        f"{scale_s:.1f} s, the drained replica's process gone after "
        f"{reap_s:.1f} s more; after delete no server process within "
        f"{left_s:.1f} s, none of {pids} on the card")


# ------------------------------------------------------------- HF phases
HF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_hf")
# the published configurations' config.json fields (Llama-2-7b-hf,
# Mistral-7B-v0.1, Qwen1.5-7B); the weights are random, from a seed
LLAMA2_7B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "tie_word_embeddings": False,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "torch_dtype": "float16"}
MISTRAL_7B = {
    "architectures": ["MistralForCausalLM"], "model_type": "mistral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 4096,
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "hidden_act": "silu", "torch_dtype": "bfloat16"}
TINYLLAMA_1B = {  # TinyLlama-1.1B's config.json (3-single's directory)
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 32000, "hidden_size": 2048, "intermediate_size": 5632,
    "num_hidden_layers": 22, "num_attention_heads": 32,
    "num_key_value_heads": 4, "max_position_embeddings": 2048,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "rope_scaling": None,
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "hidden_act": "silu", "torch_dtype": "bfloat16"}
SINGLE_QUANT_LAYERS = 4
QWEN15_7B = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
    "vocab_size": 151936, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "sliding_window": 32768,
    "use_sliding_window": False, "max_window_layers": 28,
    "tie_word_embeddings": False, "bos_token_id": 151643,
    "eos_token_id": 151643, "hidden_act": "silu", "torch_dtype": "bfloat16"}
HF_DTYPES = {"F16": "float16", "BF16": "bfloat16", "F32": "float32"}
SHARD_BYTES = 10 * 10**9  # save_pretrained's default largest shard
HF_NEW = 64
# hf-llama2's depth: 8 of Llama-2-7b's 32 layers keeps the script inside
# its time limit (full depth took ~25 s more; PERF.md)
HF_LLAMA2_LAYERS = 8
HF_LIVE_ULPS = 4 * FORCED_ULPS  # the window's effect must exceed this


def hf_tensors(config):
    """(name, shape, init) of a llama-family HF checkpoint, in the order
    ``save_pretrained`` writes them: matrices random (init "normal"), norm
    scales ones, qwen2's q/k/v biases random."""
    D, F, V = (config["hidden_size"], config["intermediate_size"],
               config["vocab_size"])
    H, KV = config["num_attention_heads"], config["num_key_value_heads"]
    d = D // H
    out = [("model.embed_tokens.weight", (V, D), "normal")]
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (H * d, D)),
                            ("self_attn.k_proj", (KV * d, D)),
                            ("self_attn.v_proj", (KV * d, D))):
            out.append((p + name + ".weight", shape, "normal"))
            if config["model_type"] == "qwen2":
                out.append((p + name + ".bias", shape[:1], "normal"))
        out += [(p + "self_attn.o_proj.weight", (D, H * d), "normal"),
                (p + "mlp.gate_proj.weight", (F, D), "normal"),
                (p + "mlp.up_proj.weight", (F, D), "normal"),
                (p + "mlp.down_proj.weight", (D, F), "normal"),
                (p + "input_layernorm.weight", (D,), "ones"),
                (p + "post_attention_layernorm.weight", (D,), "ones")]
    return out + [("model.norm.weight", (D,), "ones"),
                  ("lm_head.weight", (V, D), "normal")]


def write_hf_checkpoint(torch, path, config, layers, stored, fmt, seed,
                        tokenizer, shard_bytes=SHARD_BYTES):
    """An HF checkpoint directory as ``save_pretrained`` lays one out:
    ``config.json`` (``config`` with ``layers`` layers), the weights in
    ``stored`` dtype as safetensors (shards of at most ``shard_bytes``,
    with an index where there are two or more, written by the few lines
    below, one tensor at a time)
    or as one ``pytorch_model.bin`` (``torch.save``), made on the card from
    a seeded generator, and the ``tokenizer`` fixture's three files.
    Returns (bytes of weights, seconds)."""
    import shutil
    import struct

    t0 = time.perf_counter()
    os.makedirs(path)
    config = dict(config, num_hidden_layers=layers)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    dtype = getattr(torch, HF_DTYPES[stored])
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device="cuda")
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.02).to(dtype)

    items = hf_tensors(config)
    total = sum(math.prod(shape) for _, shape, _ in items) * dtype.itemsize
    if fmt == "bin":
        torch.save({name: make(shape, init).cpu()
                    for name, shape, init in items},
                   os.path.join(path, "pytorch_model.bin"))
    else:
        shards, size = [[]], 0
        for item in items:
            nbytes = math.prod(item[1]) * dtype.itemsize
            if shards[-1] and size + nbytes > shard_bytes:
                shards.append([])
                size = 0
            shards[-1].append(item)
            size += nbytes
        weight_map = {}
        for k, shard in enumerate(shards):
            file = (f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
                    if len(shards) > 1 else "model.safetensors")
            header, offset = {"__metadata__": {"format": "pt"}}, 0
            for name, shape, _ in shard:
                end = offset + math.prod(shape) * dtype.itemsize
                header[name] = {"dtype": stored, "shape": list(shape),
                                "data_offsets": [offset, end]}
                offset = end
                weight_map[name] = file
            raw = json.dumps(header).encode()
            raw += b" " * (-len(raw) % 8)
            with open(os.path.join(path, file), "wb") as f:
                f.write(struct.pack("<Q", len(raw)) + raw)
                for name, shape, init in shard:
                    f.write(make(shape, init).cpu().view(torch.uint8)
                            .numpy().data)
        if len(shards) > 1:
            with open(os.path.join(path, "model.safetensors.index.json"),
                      "w") as f:
                json.dump({"metadata": {"total_size": total},
                           "weight_map": weight_map}, f, indent=2)
    src = os.path.join(HF_FIXTURES, tokenizer)
    for name in os.listdir(src):
        shutil.copy(os.path.join(src, name), path)
    return total, time.perf_counter() - t0


def hf_load_check(torch, path):
    """Load the directory as the engines do (bf16, on the card), print the
    read and placement times apart, and hold the weight tree to the
    configuration's parameter count. Returns the tokenizer."""
    from datatunerx_tpu_torch.utils.hf_weights import param_count
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer,
    )

    t = {}
    t0 = time.perf_counter()
    cfg, params, tok = load_model_and_tokenizer(
        path, dtype=torch.bfloat16, device="cuda", timings=t)
    wall = time.perf_counter() - t0
    leaves, stack = [], [params]
    while stack:
        node = stack.pop()
        for v in node.values():
            (stack if isinstance(v, dict) else leaves).append(v)
    n = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    want = param_count(cfg)
    log(f"  load (bf16, on the card): read {t['read_s']:.2f} s, placement "
        f"{t['place_s']:.2f} s, {wall:.2f} s in all, {t['bytes']} bytes "
        f"from disk; the weight tree {nbytes} bytes, {n} parameters (the "
        f"configuration's count: {want}); tokenizer {type(tok).__name__}, "
        f"{len(tok)} tokens")
    if n != want or nbytes != 2 * want:
        fail(f"{path}: the weight tree holds {n} parameters ({nbytes} "
             f"bytes), the configuration {want}")
    if any(not bool(torch.isfinite(x).all()) for x in leaves):
        fail(f"{path}: a loaded weight is not finite")
    del params, leaves
    torch.cuda.empty_cache()
    return tok


def hf_prompt(tok, template, n_tokens, seed):
    """A user message of words drawn from a seed whose chat prompt under
    ``template`` (the server's) is about ``n_tokens`` tokens long."""
    import random

    from datatunerx_tpu_torch.data.templates import get_template

    chat = get_template(template, tok)
    rnd = random.Random(seed)
    words = ["the", "model", "reads", "a", "checkpoint", "directory",
             "tokens", "window", "attention", "layer", "weights", "served",
             "trained", "sliding", "of", "and", "kernel", "cache"]
    text = ""
    while len(chat.encode_oneturn(tok, text, "")[0]) < n_tokens:
        text += " ".join(rnd.choice(words) for _ in range(12)) + ". "
    return text


def hf_serve_phase(torch, label, path, flags, reqs, counters,
                   window=None):
    """Serve the HF directory ``path`` with ``flags``, send ``reqs`` —
    ``(name, content, temperature)`` — at once, and check: K7, K8 and K9's
    launches (``counters``, zeroed just before) equal what the scheduler's
    trace ran (L each a decode step and a prefill chunk; K9 once a decode
    step; K7 and K8 none with a sliding window), and every greedy stream
    teacher-forced within ``FORCED_ULPS`` of a plain forward. With
    ``window`` (a sliding-window model) the plain forward without the
    window must read the longest prompt's last position more than
    ``HF_LIVE_ULPS`` apart. Returns the launches."""
    import dataclasses

    t0 = time.perf_counter()
    srv, port, eng = start_server(torch, flags, model=path)
    log(f"  {label}: server up in {time.perf_counter() - t0:.1f} s; "
        f"decode_path={eng.decode_path} kv_blocks={eng.total_kv_blocks} "
        f"kv_cache_bytes={eng.kv_cache_bytes}")
    seen = record_submits(eng)
    eng.request_stats.clear()
    eng.sched_trace.clear()
    for c, attr in counters:
        setattr(c, attr, 0)
    answers, errors = {}, []

    def run(name, content, temperature):
        body = {"messages": [{"role": "user", "content": content}],
                "max_tokens": HF_NEW, "temperature": temperature}
        try:
            answers[name] = post(port, body, trace=name)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=run, args=r) for r in reqs]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    launched = {counter_key(c, attr): getattr(c, attr)
                for c, attr in counters}
    if errors or len(answers) != len(reqs):
        fail(f"{label}: {errors or 'requests did not finish'}")
    steps = sum(e[1] for e in eng.sched_trace if e[0] == "decode")
    chunks = sum(1 for e in eng.sched_trace if e[0] == "prefill")
    L = eng.cfg.num_layers
    paged = 0 if window else L
    want = dict(zip(launched, (paged * steps, paged * chunks, steps)))
    log(f"  {label}: {len(reqs)} requests in {wall:.2f} s wall; {steps} "
        f"decode steps and {chunks} prefill chunks by the trace; launches "
        f"{launched}, expected {want}")
    if launched != want or steps <= 0 or chunks <= 0:
        fail(f"{label}: launches {launched}, expected {want}")
    stats = {s["trace_id"]: s for s in eng.request_stats}
    tokens = 0
    for name, _, temperature in reqs:
        req, st = seen[name], stats.get(name)
        if st is None or not req.tokens:
            fail(f"{label}: {name} emitted no tokens")
        tokens += len(req.tokens)
        tps = (1.0 / st["tpot_s"]) if st["tpot_s"] else float("nan")
        line = (f"  {name}: {len(req.prompt_ids)} prompt tokens, "
                f"{len(req.tokens)} new, TTFT {st['ttft_s'] * 1e3:.1f} ms, "
                f"decode {tps:.1f} tok/s")
        if temperature == 0.0:
            _, gaps = stream_gaps(torch, eng, req.prompt_ids, req.tokens, 0,
                                  HF_NEW, req.stop_ids, None)
            line += (f"; teacher-forced: furthest {max(gaps):.2f} ulps "
                     f"below the plain forward's top (bound "
                     f"{FORCED_ULPS:.2f})")
            if max(gaps) > FORCED_ULPS:
                fail(f"{label}: {name} sits {max(gaps):.2f} ulps below the "
                     "plain forward's top")
        log(line)
    log(f"  {label}: {tokens / wall:.1f} tok/s aggregate; median TTFT "
        f"{median([s['ttft_s'] * 1e3 for s in stats.values()]):.1f} ms, "
        f"decode {median([1 / s['tpot_s'] for s in stats.values() if s['tpot_s']]):.1f}"
        " tok/s per request")
    if window:
        name = max(reqs, key=lambda r: len(seen[r[0]].prompt_ids))[0]
        req = seen[name]
        args = (req.prompt_ids, req.tokens, eng.max_seq_len, HF_NEW,
                eng.tokenizer.eos_token_id)
        rows = plain_step_logits(torch, eng.params, eng.cfg, *args)
        flat = plain_step_logits(torch, eng.params, dataclasses.replace(
            eng.cfg, sliding_window=None), *args)
        top = rows[0].max()
        ulp = 2.0 ** (torch.floor(torch.log2(top.abs())) - 7)
        live = float((rows[0] - flat[0]).abs().max() / ulp)
        served = gaps_ulps(torch, rows[:1], req.tokens[:1])[0]
        unwindowed = gaps_ulps(torch, flat[:1], req.tokens[:1])[0]
        log(f"  {name} ({len(req.prompt_ids)} prompt tokens, window "
            f"{window}): at the last prompt position the plain forward "
            f"with the window and without it differ by up to {live:.2f} "
            f"bf16 ulps of the top (bound > {HF_LIVE_ULPS:.2f}); the served "
            f"first token sits {served:.2f} ulps below the windowed top, "
            f"{unwindowed:.2f} below the unwindowed one")
        if len(req.prompt_ids) <= window:
            fail(f"{label}: the prompt ({len(req.prompt_ids)} tokens) does "
                 "not pass the window")
        if live <= HF_LIVE_ULPS:
            fail(f"{label}: the window changes the last prompt position by "
                 f"only {live:.2f} ulps")
        del rows, flat
    stop_server(srv)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def hf_phases(torch, tmp, by_name):
    """hf-llama2 (serve and train), hf-mistral and hf-qwen (see the
    module docstring). ``by_name``: each kernel's ``(wrapper, attribute)``.
    Returns the launches by entry key (``path`` suffixed)."""
    import shutil

    launches = {}
    kernels = [by_name[k] for k in ("K7", "K8", "K9")]
    free = shutil.disk_usage(tmp).free
    full = 2 * sum(math.prod(s) for _, s, _ in hf_tensors(LLAMA2_7B))
    # the depth cut to the script's time limit, and to 4 layers when the
    # disk cannot hold that with a margin
    layers = (HF_LLAMA2_LAYERS if free > 1.25 * full * HF_LLAMA2_LAYERS / 32
              else 4)
    # the shard limit cut with the depth, so the cut directory is sharded
    # with an index as the full-depth one is (13.5 GB in two 10 GB shards)
    shard = SHARD_BYTES * layers // 32
    log(f"[hf-llama2] Llama-2-7b-hf's configuration, F16 safetensors in "
        f"shards of at most {shard / 1e9:.2f} GB with an index, {layers} of "
        f"32 layers ({free / 1e9:.1f} GB free; {full / 1e9:.2f} GB at full "
        "depth)")
    path = os.path.join(tmp, "llama2-7b")
    nbytes, secs = write_hf_checkpoint(torch, path, LLAMA2_7B, layers, "F16",
                                       "safetensors", 0, "llama",
                                       shard_bytes=shard)
    files = sorted(os.listdir(path))
    log(f"  written: {nbytes} bytes of weights in {secs:.1f} s: "
        + ", ".join(files))
    if "model.safetensors.index.json" not in files or sum(
            f.endswith(".safetensors") for f in files) < 2:
        fail("hf-llama2: the directory is not sharded with an index, so "
             "the sharded loader would not run")
    tok = hf_load_check(torch, path)
    reqs = [(f"{kind}-{i}", hf_prompt(tok, "llama2", 600, i), temp)
            for i, (kind, temp) in enumerate((("greedy", 0.0),
                                              ("greedy", 0.0),
                                              ("sampled", 0.8),
                                              ("sampled", 0.8)))]
    served = hf_serve_phase(torch, "hf-llama2", path,
                            ("--kv_block_size", "16", "--slots", "4"),
                            reqs, kernels)
    launches.update({k + "@hf-llama2": v for k, v in served.items()})
    log("[hf-llama2 train] the trainer CLI on the same directory: LoRA r8 "
        "on q_proj,v_proj, bf16, flash, remat dots, packed 8x1024, 3 steps")
    trained, run = train_phase(torch, tmp, steps=3, profile=0,
                               export=False, model=path, layers=layers)
    PEAKS["hf-llama2"] = run["peak_gib"]
    PEAK_LAYERS["hf-llama2"] = layers  # phase 15d estimates at this depth
    launches.update({k + "@hf-llama2": trained[k] for k in
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
    torch.cuda.empty_cache()
    log("[hf-llama2 parity] one step with the flash kernels vs plain "
        "attention on the directory's first 4 layers")
    train_parity_phase(torch, [("flash", dict(attention_impl="flash")),
                               ("xla", dict(attention_impl="xla"))],
                       model=path)
    shutil.rmtree(path)
    torch.cuda.empty_cache()

    log("[hf-mistral] Mistral-7B-v0.1's configuration (sliding window "
        "4096), 4 of 32 layers, BF16 safetensors; one ~4600-token prompt")
    path = os.path.join(tmp, "mistral-7b")
    nbytes, secs = write_hf_checkpoint(torch, path, MISTRAL_7B, 4, "BF16",
                                       "safetensors", 1, "llama")
    log(f"  written: {nbytes} bytes of weights in {secs:.1f} s")
    tok = hf_load_check(torch, path)
    hf_serve_phase(torch, "hf-mistral", path,
                   ("--kv_block_size", "16", "--max_seq_len", "8192"),
                   [("greedy-long", hf_prompt(tok, "llama2", 4600, 7), 0.0)],
                   kernels, window=MISTRAL_7B["sliding_window"])
    shutil.rmtree(path)

    log("[hf-qwen] Qwen1.5-7B's configuration (V=151936, q/k/v biases), 4 "
        "of 32 layers, pytorch_model.bin, the chatml template")
    path = os.path.join(tmp, "qwen1.5-7b")
    nbytes, secs = write_hf_checkpoint(torch, path, QWEN15_7B, 4, "BF16",
                                       "bin", 2, "qwen2")
    log(f"  written: {nbytes} bytes of weights in {secs:.1f} s")
    tok = hf_load_check(torch, path)
    served = hf_serve_phase(
        torch, "hf-qwen", path,
        ("--kv_block_size", "16", "--slots", "4", "--template", "chatml"),
        [(f"greedy-{i}", hf_prompt(tok, "chatml", 600, 10 + i), 0.0)
         for i in range(2)], kernels)
    launches.update({k + "@hf-qwen": v for k, v in served.items()})
    shutil.rmtree(path)
    return launches


# ------------------------------------------------------------------- main
# ------------------------------------------------------------------ phase 15
RING_SHAPES = {"tinyllama": (2, 1024, 32, 4, 64),
               "llama2": (2, 1024, 32, 32, 128)}  # B, T_local, H, KV, d
RING_SP = 4
# the sp = 4 ring against ONE causal flash call over the whole sequence:
# the ring rounds each chunk's output (and each chunk's dQ/dK/dV) to bf16
# before the f32 merge, so it carries two bf16 roundings where the one
# call carries one: twice FLASH_TOL
RING_TOL = (2**-5, 2**-5)
# peak GiB (torch.cuda.max_memory_allocated) of this run's training phases,
# by phase: read by phase 15's memory check
PEAKS = {}
PEAK_LAYERS = {}  # a phase's depth where it ran cut


def check_flash_ring(torch, timer, gen):
    """Phase 15a: K1, K2 and K3 with ``causal=False`` (the ring's past
    chunks) against their plain versions at the ring's chunk shapes
    (``RING_SHAPES``), timed with the L2 flushed beside the plain versions
    and non-causal SDPA. Returns the ``@ring`` kernel entries (timed at
    tinyllama's heads) and logs llama2-7b's."""
    from datatunerx_tpu_torch.ops import flash_attention as fa

    rows = {}
    for label, (B, T, H, KV, d) in RING_SHAPES.items():
        q, k, v, do, _ = flash_inputs(torch, B, T, H, KV, d, gen)
        got_o, got_lse = fa.flash_fwd(q, k, v, None, causal=False)
        want_o, want_lse = fa._plain_fwd(q, k, v, None, False, 512, 512)
        dsum = fa.row_dot(do, want_o)
        got_dq = fa.flash_bwd_dq(q, k, v, do, want_lse, dsum, None,
                                 causal=False)
        got_dk, got_dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, dsum, None,
                                          causal=False)
        want_dq = fa._plain_bwd_dq(q, k, v, do, want_lse, dsum, None, False,
                                   512, 512)
        want_dk, want_dv = fa._plain_bwd_dkv(q, k, v, do, want_lse, dsum,
                                             None, False, 512, 512)
        torch.cuda.synchronize()
        errs = {}
        for name, pairs in (("K1", [(got_o, want_o)]),
                            ("K2", [(got_dq, want_dq)]),
                            ("K3", [(got_dk, want_dk), (got_dv, want_dv)])):
            err = 0.0
            for got, want in pairs:
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"{name}@ring ({label}) wrote non-finite values")
                ok, e = close_enough(torch, got, want, *FLASH_TOL)
                if not ok:
                    fail(f"{name}@ring ({label}, causal=False) disagrees "
                         f"with its plain version: max abs err {e}")
                err = max(err, e)
            errs[name] = err
        lse_err = float((got_lse - want_lse).abs().max())
        if lse_err > 1e-3:
            fail(f"K1@ring ({label}) lse differs from the plain version by "
                 f"{lse_err}")
        pairs = B * H * T * T  # every (query, key) pair: no mask
        io = 2 * (2 * B * T * H * d + 2 * B * T * KV * d)
        stats = 2 * B * H * T * 4
        bounds = {
            "K1": bound_ms(io + B * H * T * 4, 4 * d * pairs,
                           BF16_OPS_PER_S),
            "K2": bound_ms(io + 2 * B * T * H * d + stats, 6 * d * pairs,
                           BF16_OPS_PER_S),
            "K3": bound_ms(io + 4 * B * T * KV * d + stats, 8 * d * pairs,
                           BF16_OPS_PER_S),
        }
        ms = {
            "K1": timer.ms(lambda: fa.flash_fwd(q, k, v, None, causal=False)),
            "K2": timer.ms(lambda: fa.flash_bwd_dq(
                q, k, v, do, want_lse, dsum, None, causal=False)),
            "K3": timer.ms(lambda: fa.flash_bwd_dkv(
                q, k, v, do, want_lse, dsum, None, causal=False)),
        }
        plain = {
            "K1": timer.ms(lambda: fa._plain_fwd(q, k, v, None, False, 512,
                                                 512), reps=3, warmup=1),
            "K2": timer.ms(lambda: fa._plain_bwd_dq(
                q, k, v, do, want_lse, dsum, None, False, 512, 512), reps=3,
                warmup=1),
            "K3": timer.ms(lambda: fa._plain_bwd_dkv(
                q, k, v, do, want_lse, dsum, None, False, 512, 512), reps=3,
                warmup=1),
        }
        qs, ks, vs, dos = (t.transpose(1, 2) for t in (q, k, v, do))
        lib_fwd = timer.ms(lambda: sdpa(torch, qs, ks, vs, causal=False))
        leaf = [t.detach().requires_grad_() for t in (qs, ks, vs)]
        o2 = sdpa(torch, *leaf, causal=False)
        lib_bwd = timer.ms(lambda: torch.autograd.grad(o2, leaf, dos,
                                                       retain_graph=True))
        log(f"  flash non-causal {label} [B={B} T=S={T} H={H} KV={KV} d={d}]"
            ": " + ", ".join(
                f"{n} {ms[n]:.4f} ms (err {errs[n]:.3g}, plain "
                f"{plain[n]:.2f} ms, bound {bounds[n][0]:.4f} "
                f"{bounds[n][1]})" for n in ms)
            + f"; SDPA non-causal forward {lib_fwd:.4f} ms, backward "
            f"{lib_bwd:.4f} ms; K1 {ms['K1'] / lib_fwd:.2f}x, K2+K3 "
            f"{(ms['K2'] + ms['K3']) / lib_bwd:.2f}x")
        rows[label] = (errs, ms, bounds, plain,
                       {"K1": lib_fwd, "K2": lib_bwd, "K3": lib_bwd})
        del q, k, v, do, leaf, o2
    meta = {
        "K1": ("K1@ring flash_fwd", "datatunerx_tpu/ops/flash_attention.py:85",
               fa.flash_fwd),
        "K2": ("K2@ring flash_bwd_dq",
               "datatunerx_tpu/ops/flash_attention.py:191", fa.flash_bwd_dq),
        "K3": ("K3@ring flash_bwd_dkv",
               "datatunerx_tpu/ops/flash_attention.py:233", fa.flash_bwd_dkv),
    }
    errs, ms, bounds, plain, lib = rows["tinyllama"]
    entries = []
    for key, (name, replaces, counter) in meta.items():
        library = ("SDPA forward, non-causal" if key == "K1" else
                   "SDPA backward, non-causal (dQ, dK, dV together), "
                   "compare with K2+K3")
        entries.append({
            "name": name, "route": "cuda", "path": "@ring",
            "source": "datatunerx_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "counter": counter,
            "max_abs_err": max(r[0][key] for r in rows.values()),
            "tolerance": "atol 2^-6 + rtol 2^-6 (bf16), causal=False, "
                         "tinyllama and llama2-7b heads",
            "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": lib[key], "library": library,
            "shape": "B=2 T=S=1024 H=32 KV=4 d=64 causal=False bf16 (a "
                     "ring chunk; timed); library: " + library,
        })
    return entries


def check_threefry_blocks(torch, timer):
    """Phase 15a: the threefry kernel drawing a rank's block of a global
    draw (``index``: a start counter and the block's strides) against its
    plain version, bit for bit, on blocks of phase 5's [8, 1024, 2048]
    (dp rows, an sp chunk, an sp chunk of a tp column shard) and of the
    down projection's [8, 1024, 5632] input (a row module's column
    shard); times an sp chunk (B strided runs) beside a contiguous draw of
    as many elements."""
    from datatunerx_tpu_torch.ops import cuda_prng, prng

    key = prng.fold_in(prng.PRNGKey(19), 3)
    blocks = (((8, 1024, 2048), (4, 0, 0), (4, 1024, 2048)),
              ((8, 1024, 2048), (0, 512, 0), (8, 512, 2048)),
              ((8, 1024, 2048), (2, 256, 1024), (2, 256, 1024)),
              ((8, 1024, 5632), (0, 0, 2816), (8, 1024, 2816)))
    for global_shape, starts, local in blocks:
        idx = prng.slice_index(global_shape, starts)
        got = cuda_prng.threefry_bits(key, local, "cuda", p=0.9, index=idx)
        want = cuda_prng.plain_bernoulli(key, 0.9, local, "cuda", idx)
        if not torch.equal(got, want):
            fail(f"threefry kernel: the block {local} at {starts} of "
                 f"{global_shape} differs from its plain version")
        got = cuda_prng.threefry_bits(key, local, "cuda", lo=-1.0, hi=1.0,
                                      index=idx)
        want = cuda_prng.plain_uniform(key, local, -1.0, 1.0, "cuda", idx)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"threefry kernel: the uniform block {local} at {starts} "
                 "differs from its plain version")
    idx = prng.slice_index((8, 1024, 2048), (0, 512, 0))
    strided = timer.ms(lambda: cuda_prng.threefry_bits(
        key, (8, 512, 2048), "cuda", p=0.9, index=idx))
    flat = timer.ms(lambda: cuda_prng.threefry_bits(
        key, (8, 512, 2048), "cuda", p=0.9))
    log(f"  threefry blocks (dp rows, sp chunk, sp x tp shard, row-module "
        f"shard): kernel == plain bit for bit, mask and uniform; an sp "
        f"chunk [8, 512, 2048] of [8, 1024, 2048] {strided:.4f} ms vs a "
        f"contiguous draw of as many {flat:.4f} ms")


def ring_phase(torch, timer, gen):
    """Phase 15b: the sp = 4 ring's schedule for every rank in this process
    (``ops/ring_attention.ring_schedule``: the rotation by indexing) over
    the kernels, at tinyllama's heads and T = 4 x 1024: output and
    dQ/dK/dV against the same schedule over the plain versions
    (``FLASH_TOL``) and against one causal flash call over T = 4096
    (``RING_TOL``); K1, K2 and K3 launched exactly n² = 16 times each.
    Returns the launch counts."""
    from datatunerx_tpu_torch.ops import flash_attention as fa
    from datatunerx_tpu_torch.ops import ring_attention as ra

    B, t, H, KV, d = RING_SHAPES["tinyllama"]
    n = RING_SP
    T = n * t
    q, k, v, do, _ = flash_inputs(torch, B, T, H, KV, d, gen)

    def chunks(x):
        return [x[:, r * t:(r + 1) * t].contiguous() for r in range(n)]

    qs, ks, vs, dos = chunks(q), chunks(k), chunks(v), chunks(do)
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for c in counters:
        c.launches = 0
    got = ra.ring_schedule(qs, ks, vs, dos)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = {c.__name__: n * n for c in counters}
    if launches != want:
        fail(f"ring schedule launches {launches}, expected {want}")
    plain = ra.ring_schedule(qs, ks, vs, dos, plain=True)
    names = ("out", "lse", "dQ", "dK", "dV")
    errs = {}
    for name, g_list, p_list in zip(names, got, plain):
        g_all, p_all = torch.cat(g_list, 1), torch.cat(p_list, 1)
        if not bool(torch.isfinite(g_all.float()).all()):
            fail(f"ring schedule wrote non-finite {name}")
        tol = (1e-3, 0.0) if name == "lse" else FLASH_TOL
        ok, e = close_enough(torch, g_all, p_all, *tol)
        if not ok:
            fail(f"ring schedule {name} disagrees with the plain schedule: "
                 f"max abs err {e}")
        errs[name] = e
    o_full, lse_full = fa.flash_fwd(q, k, v)
    dsum = fa.row_dot(do, o_full)
    dq_full = fa.flash_bwd_dq(q, k, v, do, lse_full, dsum)
    dk_full, dv_full = fa.flash_bwd_dkv(q, k, v, do, lse_full, dsum)
    whole = {"out": o_full, "dQ": dq_full, "dK": dk_full, "dV": dv_full}
    one_errs = {}
    for name, g_list in zip(names, got):
        if name == "lse":
            continue
        ok, e = close_enough(torch, torch.cat(g_list, 1), whole[name],
                             *RING_TOL)
        if not ok:
            fail(f"ring schedule {name} disagrees with one causal flash call "
                 f"over T={T}: max abs err {e}")
        one_errs[name] = e
    ring_ms = timer.ms(lambda: ra.ring_schedule(qs, ks, vs, dos), reps=5,
                       warmup=1)

    def one_call():
        o, lse = fa.flash_fwd(q, k, v)
        ds = fa.row_dot(do, o)
        fa.flash_bwd_dq(q, k, v, do, lse, ds)
        fa.flash_bwd_dkv(q, k, v, do, lse, ds)

    one_ms = timer.ms(one_call, reps=5, warmup=1)
    log(f"  ring sp={n} [B={B} T={T}={n}x{t} H={H} KV={KV} d={d} bf16], "
        f"every rank's schedule in one process: launches {launches}; vs "
        f"the plain schedule max abs err "
        + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
        + f" ({FLASH_TOL}); vs one causal flash call over T={T} "
        + ", ".join(f"{k_} {e:.3g}" for k_, e in one_errs.items())
        + f" ({RING_TOL})")
    log(f"  ring schedule forward+backward {ring_ms:.3f} ms (16 K1, 16 K2, "
        f"16 K3; 6 of each chunk pair are masked future chunks) vs one "
        f"causal flash call forward+backward over T={T} {one_ms:.3f} ms "
        f"({ring_ms / one_ms:.2f}x)")
    return launches


def ring_cli_phase(torch, tmp):
    """Phase 15c: the trainer CLI at tinyllama's full width (LoRA r8 on
    q_proj,v_proj, phase 5's data and shape), 2 steps with ``--attention
    ring --mesh dp=1`` and with ``--attention xla``: equal losses (at sp 1
    the ring is the plain biased attention); one process reports a world
    of 1."""
    from datatunerx_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from datatunerx_tpu_torch.tuning import train

    info = maybe_initialize_distributed(1, "cuda")
    if info != {"initialized": False, "process_id": 0, "num_processes": 1}:
        fail(f"maybe_initialize_distributed(1) gave {info}")
    csv_path = os.path.join(tmp, "train.csv")
    write_train_csv(csv_path)
    losses = {}
    for impl, extra in (("ring", ["--mesh", "dp=1"]), ("xla", [])):
        out = os.path.join(tmp, impl)
        argv = ["--model_name_or_path", "preset:tinyllama-1.1b",
                "--train_path", csv_path, "--template", "alpaca",
                "--finetuning_type", "lora", "--lora_target",
                "q_proj,v_proj", "--attention", impl, "--remat", "dots",
                "--bf16", "--block_size", str(TRAIN_SHAPE["block"]),
                "--pack_sequences", "--per_device_train_batch_size",
                str(TRAIN_SHAPE["batch"]), "--max_steps", "2",
                "--logging_steps", "1", "--output_dir", out,
                "--storage_path", os.path.join(tmp, "store"),
                "--device", "cuda", *extra]
        t0 = time.perf_counter()
        if train.main(argv) != 0:
            fail(f"train CLI --attention {impl} failed")
        with open(os.path.join(out, "watch", "trainer_log.jsonl")) as f:
            losses[impl] = [json.loads(line)["loss"] for line in f]
        log(f"  --attention {impl} {' '.join(extra)}: losses "
            f"{losses[impl]} ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    if losses["ring"] != losses["xla"] or len(losses["ring"]) != 2:
        fail(f"ring at sp 1 {losses['ring']} != xla {losses['xla']}")
    log(f"  world: {info}; ring at sp 1 == xla, loss for loss")


def ppo_mesh_cli_phase(torch, tmp):
    """Phase 15c's PPO case: an rm run (2 steps), then ``--stage ppo``
    through the trainer CLI (phase 12's flags, 2 steps of 16 sampled
    tokens) with ``--mesh dp=1`` and without a mesh: equal losses,
    approx_kl and kl_coef within 1e-5. One card admits a world of 1 (NCCL
    refuses two ranks on one GPU); the multi-rank PPO is held on the CPU
    under gloo (``tests/test_torch_ppo_mesh.py``)."""
    from datatunerx_tpu_torch.tuning import train

    prefs, prompts = (os.path.join(tmp, n) for n in ("prefs.csv",
                                                      "prompts.csv"))
    write_pref_csv(prefs)
    write_prompt_csv(prompts, n=2 * PPO_BATCH)
    store = os.path.join(tmp, "ppo-store")
    common = ["--model_name_or_path", "preset:tinyllama-1.1b",
              "--template", "alpaca", "--finetuning_type", "lora",
              "--lora_target", "q_proj,v_proj", "--attention", "flash",
              "--remat", "dots", "--bf16", "--max_steps", "2",
              "--logging_steps", "1", "--storage_path", store,
              "--device", "cuda"]
    t0 = time.perf_counter()
    if train.main(common + [
            "--stage", "rm", "--train_path", prefs, "--block_size", "256",
            "--per_device_train_batch_size", "4", "--uid", "rm",
            "--output_dir", os.path.join(tmp, "rm-out")]) != 0:
        fail("15c: the rm run failed")
    log(f"  rm run (2 steps): {time.perf_counter() - t0:.1f} s")
    keys = ("loss", "pg_loss", "vf_loss", "approx_kl", "kl", "kl_coef")
    runs = {}
    for label, extra in (("mesh dp=1", ["--mesh", "dp=1"]), ("no mesh", [])):
        out = os.path.join(tmp, f"ppo-{len(runs)}")
        t0 = time.perf_counter()
        if train.main(common + [
                "--stage", "ppo", "--reward_model", os.path.join(store, "rm"),
                "--train_path", prompts, "--block_size", str(PPO_BLOCK),
                "--per_device_train_batch_size", str(PPO_BATCH),
                "--ppo_gen_len", "16", "--ppo_epochs", str(PPO_EPOCHS),
                "--ppo_target", "0.01", "--uid", f"ppo-{len(runs)}",
                "--output_dir", out, *extra]) != 0:
            fail(f"15c: PPO ({label}) failed")
        with open(os.path.join(out, "watch", "trainer_log.jsonl")) as f:
            runs[label] = [{k: json.loads(line)[k] for k in keys}
                           for line in f]
        log(f"  PPO {label}: {runs[label]} ({time.perf_counter() - t0:.1f} "
            "s)")
        torch.cuda.empty_cache()
    a, b = runs["mesh dp=1"], runs["no mesh"]
    if len(a) != 2 or len(b) != 2 or any(
            not math.isfinite(r[k]) for r in a for k in keys):
        fail(f"15c: PPO records {a} / {b}")
    worst = max(abs(x[k] - y[k]) for x, y in zip(a, b) for k in keys)
    if worst > 1e-5:
        fail(f"15c: PPO --mesh dp=1 parts from the run without a mesh by "
             f"{worst:.3g}")
    log(f"  PPO --mesh dp=1 == no mesh within {worst:.3g} (bound 1e-5)")


# ------------------------------------------------------------- phase 16
# one slice of one card: the second job waits for the first's card
OPERATOR_POOL = [{"name": "card0", "topology": "1x1", "chips": 1}]
OPERATOR_POLL_ENV = {"DTX_POLL_INTERVAL_S": "0.5", "DTX_RUNNING_POLL_S": "1",
                     "DTX_SERVE_POLL_S": "1", "DTX_EXPERIMENT_POLL_S": "1",
                     "DTX_SCORING_RETRY_S": "2"}
OPERATOR_JOBS = (("opj-a", "hp-a", "2e-4"), ("opj-b", "hp-b", "1e-3"))


def operator_crs(model, csv_path, block=256):
    """The phase's CRs: a Dataset over ``csv_path``, an LLM, two
    Hyperparameters that differ in learningRate, and a FinetuneExperiment
    of two FinetuneJobs (LoRA r8 on q_proj,v_proj, built-in scoring)."""
    fin = "finetune.datatunerx.io/v1beta1"
    core = "core.datatunerx.io/v1beta1"
    docs = [
        {"apiVersion": "extension.datatunerx.io/v1beta1", "kind": "Dataset",
         "metadata": {"name": "ds"},
         "spec": {"datasetMetadata": {"datasetInfo": {
             "subsets": [{"splits": {"train": {"file": csv_path}}}],
             "features": [{"name": "instruction", "mapTo": "instruction"},
                          {"name": "response", "mapTo": "response"}]}}}},
        {"apiVersion": core, "kind": "LLM", "metadata": {"name": "llm"},
         "spec": {"path": model}}]
    for _, hp, lr in OPERATOR_JOBS:
        docs.append({"apiVersion": core, "kind": "Hyperparameter",
                     "metadata": {"name": hp}, "spec": {"parameters": {
                         "scheduler": "cosine", "optimizer": "adamw",
                         "loRA_R": "8", "loRA_Alpha": "32",
                         "loRA_Dropout": "0.1", "learningRate": lr,
                         "epochs": "1", "blockSize": str(block),
                         "batchSize": "4", "gradAccSteps": "1",
                         "PEFT": "true", "attention": "flash",
                         "loRATarget": "q_proj,v_proj"}}})
    docs.append({"apiVersion": fin, "kind": "FinetuneExperiment",
                 "metadata": {"name": "exp"}, "spec": {"finetuneJobs": [
                     {"name": job, "spec": {"finetune": {
                         "name": f"{job}-finetune", "finetuneSpec": {
                             "llm": "llm", "dataset": "ds",
                             "hyperparameter": {"hyperparameterRef": hp},
                             "image": {"name": "trainer", "path": model},
                             "node": 1}}}}
                     for job, hp, _ in OPERATOR_JOBS]}})
    return docs


def port_procs(root):
    """(pid, argv) of the port's trainer and server processes whose working
    directory is under ``root``."""
    procs = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = [c.decode() for c in f.read().split(b"\0")]
            cwd = os.readlink(f"/proc/{pid}/cwd")
        except OSError:
            continue
        if cwd.startswith(root) and any(
                m in cmd for m in ("datatunerx_tpu_torch.tuning.train",
                                   "datatunerx_tpu_torch.serving.server")):
            procs.append((int(pid), cmd))
    return sorted(procs)


def port_pids(root):
    """Pids of ``port_procs(root)``."""
    return [pid for pid, _ in port_procs(root)]


def _running(pid) -> bool:
    """``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# each probe's greedy answer: 16 tokens, cut from 64 to the script's time
# limit (the manager's own Scoring probes run at their own length)
PROBE_NEW = 16


def probe_operator_server(mgr, pid, port, timeout=600):
    """The built-in Scoring probes on a server the operator launched
    (process ``pid`` on ``port``), with the manager held (SIGSTOP) so that
    it can neither score nor tear the server down meanwhile: each probe's
    greedy answer with ``"model": "default"`` (the job's adapter), and
    the ``nll_sum`` of its reference answer under the adapter and under
    the base. Returns those and the seconds the probes took once the
    server answered (the manager's timeline is short by those: the
    server's load while held is not)."""
    from datatunerx_tpu_torch.scoring.builtin import DEFAULT_PROBES

    t0 = t1 = time.perf_counter()
    os.kill(mgr.pid, signal.SIGSTOP)
    try:
        while not _reachable(f"http://127.0.0.1:{port}/healthz"):
            if not _running(pid):
                fail(f"16: the operator's server {pid} exited before it "
                     "answered /healthz")
            if time.perf_counter() - t0 > timeout:
                fail(f"16: the operator's server {pid} did not answer "
                     f"/healthz within {timeout} s")
            time.sleep(0.2)
        t1 = time.perf_counter()
        out = {"answers": [], "nll": [], "base_nll": []}
        for pr in DEFAULT_PROBES:
            out["answers"].append(post(port, {
                "messages": [{"role": "user", "content": pr["prompt"]}],
                "model": "default", "max_tokens": PROBE_NEW,
                "temperature": 0.0})["text"])
            for key, name in (("nll", "default"), ("base_nll", "")):
                out[key].append(post_perplexity(port, pr["prompt"],
                                                pr["reference"], name)[0])
    finally:
        os.kill(mgr.pid, signal.SIGCONT)
    return out, time.perf_counter() - t1


def operator_phase(torch, tmp, model="preset:tinyllama-1.1b", device="cuda",
                   timeout=900):
    """16 (see the module docstring). Returns the phase's seconds."""
    from datatunerx_tpu_torch import cli
    from datatunerx_tpu_torch.operator.backends import _free_port
    from datatunerx_tpu_torch.operator.finetune_controller import (
        PLACEMENT_PENDING,
    )
    from datatunerx_tpu_torch.operator.finetuneexperiment_controller import (
        parse_score,
    )
    csv_path = os.path.join(tmp, "operator.csv")
    write_train_csv(csv_path, seed=4, n=8)  # 8 rows at batch 4: 2 steps
    work = os.path.join(tmp, "operator")
    os.makedirs(work, exist_ok=True)
    crs = os.path.join(tmp, "operator-crs.json")
    with open(crs, "w") as f:
        json.dump(operator_crs(model, csv_path), f)
    api_port, health_port = _free_port(), _free_port()
    server = f"http://127.0.0.1:{api_port}"
    env = dict(os.environ, TPU_SLICE_POOL=json.dumps(OPERATOR_POOL),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               **OPERATOR_POLL_ENV)
    argv = [sys.executable, "-m", "datatunerx_tpu_torch.operator.manager",
            "--backend", "local", "--device", device,
            "--storage-path", "file://" + os.path.join(tmp, "storage"),
            "--workdir", work, "--device-health-interval", "5",
            "--metrics-bind-address", f"127.0.0.1:{api_port}",
            "--health-probe-bind-address", f"127.0.0.1:{health_port}"]
    mlog = open(os.path.join(tmp, "manager.log"), "w")
    mgr = subprocess.Popen(argv, stdout=mlog, stderr=subprocess.STDOUT,
                           env=env, cwd=work, start_new_session=True)
    mlog.close()

    def manager_log():
        with open(os.path.join(tmp, "manager.log")) as f:
            return f.read()[-4000:]

    def get(kind, name):
        try:
            with urllib.request.urlopen(cli._url(server, kind, "default",
                                                 name), timeout=30) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def metrics():
        with urllib.request.urlopen(f"{server}/metrics", timeout=30) as r:
            return {ln.rsplit(None, 1)[0]: float(ln.rsplit(None, 1)[1])
                    for ln in r.read().decode().splitlines()
                    if ln and not ln.startswith("#")}

    def dtx(*args):
        p = subprocess.run([sys.executable, "-m", "datatunerx_tpu_torch.cli",
                            "--server", server, *args], env=env,
                           capture_output=True, text=True, timeout=120)
        if p.returncode != 0:
            fail(f"16: dtx-torch {' '.join(args)}: {p.stderr[-2000:]}")
        return p.stdout

    try:
        wait_for("16: the manager's API", lambda: _reachable(
            f"{server}/healthz"), (True,), 120)
        t_apply = time.perf_counter()
        applied = dtx("apply", "-f", crs)
        log(f"  dtx-torch apply: {applied.strip().splitlines()}")
        seen = {j: {} for j, _, _ in OPERATOR_JOBS}
        held = set()  # jobs seen waiting for the card while the other ran
        served = {}  # checkpoint → its operator's server's answers
        paused = 0.0  # seconds those probes held the manager
        exp = None
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline + paused:
            if mgr.poll() is not None:
                fail(f"16: the manager exited {mgr.returncode}:\n"
                     f"{manager_log()}")
            now = time.perf_counter() - t_apply - paused
            fts = {j: get("Finetune", f"{j}-finetune") for j in seen}
            for j, ft in fts.items():
                st = (ft or {}).get("status", {})
                if st.get("backendUnavailable"):
                    fail(f"16: {j} held for device health: {st}")
                others = [o for o in fts if o != j and fts[o] is not None
                          and (fts[o].get("status") or {}).get("placement")
                          and fts[o]["status"].get("state") not in (
                              "Successful", "Failed")]
                if (st.get("placementPending") == PLACEMENT_PENDING
                        and st.get("state") == "Pending" and others):
                    held.add(j)
                if st.get("state") == "Successful":
                    seen[j].setdefault("trained_s", now)
                job = get("FinetuneJob", j) or {}
                if (job.get("status") or {}).get("result", {}).get("serve"):
                    seen[j].setdefault("healthy_s", now)
                sc = get("Scoring", j)
                if sc and (sc.get("status") or {}).get("score") is not None:
                    seen[j].setdefault("scored_s", now)
                    seen[j]["scoring"] = sc
                if (job.get("status") or {}).get("state") in (
                        "Successful", "Failed"):
                    seen[j]["job"] = job
            for pid, cmd in port_procs(work):
                ckpt = cmd[cmd.index("--checkpoint_path") + 1] \
                    if "--checkpoint_path" in cmd else None
                # the first job's server only: the second runs the same
                # serving path, and its hold would stretch the phase
                if ("datatunerx_tpu_torch.serving.server" in cmd
                        and not served):
                    served[ckpt], held_s = probe_operator_server(
                        mgr, pid, int(cmd[cmd.index("--port") + 1]))
                    paused += held_s
            exp = get("FinetuneExperiment", "exp")
            state = ((exp or {}).get("status") or {}).get("state")
            if state in ("Success", "Failed"):
                break
            time.sleep(0.25)
        wall = time.perf_counter() - t_apply - paused
        if state != "Success":
            fail(f"16: the experiment is {state!r} after {wall:.0f} s: "
                 f"{json.dumps((exp or {}).get('status'))[:1500]}\n"
                 f"{manager_log()}")
        for j, rec in seen.items():
            job = rec.get("job") or get("FinetuneJob", j)
            jst = job["status"]
            if jst.get("state") != "Successful":
                fail(f"16: {j} is {jst}")
            score = jst["result"]["score"]
            if not isinstance(score, str) or not math.isfinite(
                    float(score)):
                fail(f"16: {j}'s score {score!r}")
            ref = jst["finetuneStatus"]["llmCheckpoint"]["llmCheckpointRef"]
            rec["checkpoint"] = get("LLMCheckpoint", ref)
            if rec["checkpoint"] is None:
                fail(f"16: {j} has no LLMCheckpoint {ref}")
            rec["score"] = score
            rec["checkpointPath"] = jst["result"]["checkpointPath"]
        if not held:
            fail("16: no job was seen waiting for the slice while the other "
                 "held it")
        best = max((seen[j] for j, _, _ in OPERATOR_JOBS),
                   key=lambda r: parse_score(r["score"]))
        bv = exp["status"]["bestVersion"]
        if (bv["checkpointPath"] != best["checkpointPath"]
                or bv["score"] != best["score"]):
            fail(f"16: bestVersion {bv}, expected the job scoring "
                 f"{best['score']} ({best['checkpointPath']})")
        m = {}
        for _ in range(60):  # the probe runs while no job trains
            m = metrics()
            if m.get("dtx_device_healthy") == 1.0:
                break
            time.sleep(1)
        if m.get("dtx_device_healthy") != 1.0 or m.get(
                "dtx_slices_total") != 1.0 or m.get("dtx_slices_free") != 1.0:
            fail(f"16: /metrics {m}")
        # the probed server (the first job's): its adapter moves every
        # answer's nll_sum off the base's, so the operator's server serves
        # "default" from the job's LLMCheckpoint
        probed = [(j, seen[j]) for j, _, _ in OPERATOR_JOBS
                  if seen[j]["checkpoint"]["spec"]["checkpoint"] in served]
        if [j for j, _ in probed] != [OPERATOR_JOBS[0][0]]:
            fail(f"16: probed the servers of {[j for j, _ in probed]} "
                 f"(seen: {sorted(served)}), expected the first job's")
        for j, rec in probed:
            op = served[rec["checkpoint"]["spec"]["checkpoint"]]
            if all(a == b for a, b in zip(op["nll"], op["base_nll"])):
                fail(f'16: {j}\'s server scores "default" as the base: '
                     f"nll_sum {op['nll']}")
            log(f"  {j}: the operator's server answered {len(op['answers'])}"
                f" greedy probes with \"default\"; nll_sum with the adapter "
                f"{[x['nll_sum'] for x in op['nll']]}, the base "
                f"{[x['nll_sum'] for x in op['base_nll']]}")
        log(f"  the probes held the manager {paused:.1f} s (left out of "
            f"the seconds below)")
        # teardown: the experiment's deletion cascades to every workload
        dtx("delete", "FinetuneExperiment", "exp")
        wait_for("16: delete", lambda: get("FinetuneExperiment", "exp")
                 is None and all(get("Finetune", f"{j}-finetune") is None
                                 for j in seen), (True,), 120)
        left = port_pids(work)
        if left:
            fail(f"16: processes left after the experiment's deletion: "
                 f"{left}")
    finally:
        if mgr.poll() is None:
            os.killpg(mgr.pid, 15)
            try:
                mgr.wait(60)
            except subprocess.TimeoutExpired:
                os.killpg(mgr.pid, 9)
                mgr.wait()
        for pid in port_pids(work):  # whatever a failed run left
            os.kill(pid, 9)
    times = {j: {k: round(v, 1) for k, v in rec.items() if k.endswith("_s")}
             for j, rec in seen.items()}
    log(f"  seconds from apply: {times}; experiment {wall:.1f} s; scores "
        f"{ {j: r['score'] for j, r in seen.items()} }; held for the card: "
        f"{sorted(held)}; bestVersion {bv['hyperparameter']} "
        f"({bv['score']})")
    return {"times": times, "wall_s": wall}


# ------------------------------------------------------------- phase 17

# the reference's replay defaults (loadgen/replay.py), at the port's
# paged server as phase 3 runs it
REPLAY_ARGS = ("--requests", "40", "--sessions", "6", "--rps", "25",
               "--seed", "0")
REPLAY_FLAGS = ("--kv_block_size", "16", "--slots", "4",
                "--max_seq_len", "1024")
REPLAY_REQUESTS = 40


def hist_quantile(after, before, name, q):
    """The ``q`` quantile of histogram ``name`` over what it counted
    between two ``parse_metrics`` samples (linear within a bucket, as
    Prometheus' ``histogram_quantile``); nan when it counted nothing."""
    buckets = []
    for series, v in after.items():
        if series.startswith(name + "_bucket{"):
            le = series.split('le="', 1)[1].split('"', 1)[0]
            buckets.append((math.inf if le == "+Inf" else float(le),
                            v - before.get(series, 0.0)))
    buckets.sort()
    if not buckets or buckets[-1][1] <= 0:
        return math.nan
    rank = q * buckets[-1][1]
    lo, below = 0.0, 0.0
    for le, n in buckets:
        if n >= rank:
            if le == math.inf:
                return lo
            return lo + (le - lo) * (rank - below) / max(n - below, 1e-12)
        lo, below = le, n
    return lo


def replay_run(label, url, args, report, counters, port, all_ok=True):
    """``dtx-torch replay --url url *args --report_json report`` as a
    subprocess, with ``counters`` zeroed just before and read just after
    and the server's ``/metrics`` scraped around it. With ``all_ok`` every
    request must answer 200; else only those that did reach the server.
    Returns (report, launches, server TTFT/TPOT quantiles, the epilogue's
    lines, wall s, exit code)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    # the client runs unsanitized: the phase sanitizes the gateway here
    env.pop("DTX_SAN", None)
    code, text = http_get(port, "/metrics")
    if code != 200:
        fail(f"17 {label}: /metrics answered {code}")
    before, _ = parse_metrics(text)
    zero(counters)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "datatunerx_tpu_torch.cli", "replay",
         "--url", url, *args, "--report_json", report],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    launches = {counter_key(c, a): getattr(c, a) for c, a in counters}
    # exit 1 is the SLO epilogue's FAIL verdict, which the phase prints;
    # anything else is a broken run
    if p.returncode not in (0, 1) or not os.path.exists(report):
        fail(f"17 {label}: dtx-torch replay exited {p.returncode}:\n"
             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    with open(report) as f:
        rep = json.load(f)
    code, text = http_get(port, "/metrics")
    after, _ = parse_metrics(text)
    moved = after.get("dtx_serving_ttft_ms_count", 0.0) - before.get(
        "dtx_serving_ttft_ms_count", 0.0)
    ok = rep["codes"].get("200", 0)
    if rep["requests"] != REPLAY_REQUESTS or (all_ok and ok != (
            REPLAY_REQUESTS)) or set(rep["codes"]) - {"200", "429"}:
        fail(f"17 {label}: {rep['requests']} requests, codes {rep['codes']}"
             f"\n{p.stdout[-3000:]}")
    if moved != ok:
        fail(f"17 {label}: the server's dtx_serving_ttft_ms_count moved by "
             f"{moved:g}, not {ok}")
    for k, n in launches.items():
        if n <= 0 and ok:
            fail(f"17 {label}: {k} was never launched on the server")
    server = {f"{m}_p{int(q * 100)}": hist_quantile(
        after, before, f"dtx_serving_{m}_ms", q)
        for m in ("ttft", "tpot") for q in (0.5, 0.9, 0.99)}
    slo = [ln for ln in p.stdout.splitlines() if ln.startswith("[slo]")
           or "SLO verdict" in ln]
    return rep, launches, server, slo, wall, p.returncode


def loadgen_phase(torch, tmp, counters, card, model="preset:tinyllama-1.1b",
                  flags=REPLAY_FLAGS):
    """17 (see the module docstring). ``counters``: K7, K8 and K9's
    (wrapper, attribute) pairs (empty where the plain versions run: they
    count nothing). Returns their launches in each replay."""
    from datatunerx_tpu_torch.gateway.admission import AdmissionController
    from datatunerx_tpu_torch.gateway.replica_pool import (
        HTTPReplica,
        ReplicaPool,
    )
    from datatunerx_tpu_torch.gateway.server import Gateway, serve

    from datatunerx_tpu_torch.analysis.sanitizers import runtime
    from datatunerx_tpu_torch.loadgen.workload import read_trace

    srv, port, eng = start_server(torch, flags, model=model)
    out = {}
    trace = os.path.join(tmp, "replay-trace.jsonl")
    url = f"http://127.0.0.1:{port}"

    def open_gateway(admission):
        gw = Gateway(ReplicaPool([HTTPReplica("r0", url)],
                                 health_interval_s=1.0),
                     model_name=model, admission=admission)
        srv_gw = serve(gw, port=0, host="127.0.0.1")
        th = threading.Thread(target=srv_gw.serve_forever, daemon=True)
        th.start()
        return gw, srv_gw, th

    def close_gateway(gw, srv_gw, th):
        srv_gw.shutdown()
        srv_gw.server_close()
        th.join(timeout=30)
        gw.close()  # HTTP replicas: the pool's thread, nothing remote

    try:
        tok = eng.tokenizer
        count = lambda t: len(tok.encode(t))  # noqa: E731
        runs = [("direct", None),
                # the gateway as phase 14a builds it: fleet-true admission
                # prices each request in KV blocks against the server's
                # free blocks and sheds (429) what the pool cannot hold now
                ("gateway-blocks", AdmissionController(count_tokens=count)),
                # the block signal off and a static budget of the whole
                # trace's prefill estimate (set once the direct run has
                # recorded it): the gateway queues the burst on the
                # server, as the direct replay does; it runs under the
                # sanitizers
                ("gateway", AdmissionController(
                    count_tokens=count, fleet_blocks_fn=lambda: None))]
        for label, admission in runs:
            san = None
            if label == "gateway":
                admission.token_budget = sum(
                    admission.estimate(e["messages"])
                    for e in read_trace(trace)[1])
                runtime.COLLECTOR.reset()
                # before the gateway is built
                san = runtime.open_window("lock,thread,compile")
            opened = None
            mark = len(eng.sched_trace)
            try:
                if admission is None:
                    target, args = url, REPLAY_ARGS + ("--record", trace)
                else:
                    opened = open_gateway(admission)
                    target = f"http://127.0.0.1:{opened[1].server_port}"
                    args = ("--trace", trace)
                rep, launches, server, slo, wall, rc = replay_run(
                    label, target, args,
                    os.path.join(tmp, f"replay-{label}.json"), counters,
                    port, all_ok=label != "gateway-blocks")
            finally:
                if opened is not None:
                    close_gateway(*opened)
            if san is not None:  # after the gateway closed
                san_epilogue(san, "17 gateway")
            if counters:
                check_launches(label, counters, eng, mark, whose="server",
                               phase="17")
            out[label] = launches
            log(f"  {label} ({target}): {rep['requests']} requests, codes "
                f"{rep['codes']}, {rep['duration_s']} s of replay "
                f"({wall:.1f} s with the process), exit {rc}; the "
                f"server's TTFT count moved by {rep['codes'].get('200')}; "
                f"launches {launches}")
            log(f"    client TTFT ms p50 {rep['ttft_ms_p50']} p90 "
                f"{rep['ttft_ms_p90']} p99 {rep['ttft_ms_p99']}; latency ms "
                f"p50 {rep['latency_ms_p50']} p90 {rep['latency_ms_p90']} "
                f"p99 {rep['latency_ms_p99']}; {rep['no_content']} of "
                f"{rep['requests']} streams carried no content (no client "
                "TTFT)")
            log("    server TTFT ms p50 {ttft_p50:.1f} p90 {ttft_p90:.1f} "
                "p99 {ttft_p99:.1f}; TPOT ms p50 {tpot_p50:.2f} p90 "
                "{tpot_p90:.2f} p99 {tpot_p99:.2f} (/metrics histograms, "
                "bucket-interpolated)".format(**server))
            for ln in slo:
                log(f"    {ln}")
        # every replay's launches equal its own scheduler trace (above).
        # The prefill chunks are the trace's prompts, so the sanitized
        # gateway replay prefills what the direct one did; the decode
        # steps follow the arrivals' timing (4 slots batch the requests
        # as they come), and two runs of one trace part by a few steps
        k8 = counter_key(*counters[1]) if counters else None
        if counters and out["gateway"][k8] != out["direct"][k8]:
            fail(f"17: the sanitized gateway replay launched "
                 f"{out['gateway']}, the direct replay {out['direct']}: "
                 "not the same prefill chunks")
        log(f"  the gateway's static prefill budget: "
            f"{runs[-1][1].token_budget} tokens (the trace's own "
            f"estimate); {card}")
    finally:
        stop_server(srv)
        eng.close()
    return out


def san_epilogue(win, label):
    """The sweep after phase 17's sanitized window (``dtx-torch
    replay``'s): lock-order cycles, the threads started in the window and
    still alive, the builds in it; the sanitizers then come out. Fails on
    any new finding against ``dtxsan-torch-baseline.json`` (empty) or
    any build."""
    from datatunerx_tpu_torch.analysis.sanitizers import report, runtime

    findings, suppressed, counters = runtime.close_window(win, label)
    evaluation = report.evaluate(findings, suppressed)
    builds = counters["window_builds"]
    log("    " + report.render_text(evaluation, counters).replace(
        "\n", "\n    "))
    log(f"    dtxsan: {builds} builds in the sanitized window; installed "
        f"{list(win.installed)}, taken out again")
    if evaluation["failed"] or builds:
        fail(f"{label}: {len(evaluation['new'])} new dtxsan findings, "
             f"{builds} builds in the sanitized window")


# ------------------------------------------------------------- phase 18

EXPERIMENT_JOBS = (("exp-a", "2e-4"), ("exp-b", "1e-3"))
EXPERIMENT_MIN_EVALS = 2


def experiment_spec(tmp, csv_path, storage, endpoint,
                    model="preset:tinyllama-1.1b"):
    """Two LoRA jobs that differ only in learning rate (r8 on q_proj,v_proj,
    flash, 8 rows at batch 4: 2 steps, a checkpoint every step), a pool of
    one slice of 1 card, each job scored at ``endpoint``."""
    jobs = []
    for name, lr in EXPERIMENT_JOBS:
        jobs.append({"name": name, "spec": {
            "args": ["--model_name_or_path", model, "--train_path",
                     csv_path, "--storage_path", storage, "--uid", name,
                     "--output_dir", "result", "--template", "alpaca",
                     "--lora_target", "q_proj,v_proj", "--lora_rank", "8",
                     "--attention", "flash", "--remat", "dots", "--bf16",
                     "true", "--block_size", "256",
                     "--per_device_train_batch_size", "4",
                     "--learning_rate", lr, "--max_steps", "2",
                     "--save_steps", "1", "--logging_steps", "1"],
            "checkpoint_dir": os.path.join(storage, name, "checkpoints"),
            "score_endpoint": endpoint}})
    return {"name": "smoke-exp", "jobs": jobs,
            "pool": {"slices": [{"name": "card0", "chips": 1,
                                 "topology": "1x1"}]},
            "scoring": {"minEvals": EXPERIMENT_MIN_EVALS}}


def experiment_phase(torch, tmp, model="preset:tinyllama-1.1b",
                     device="cuda", flags=REPLAY_FLAGS):
    """18 (see the module docstring). Returns the experiment's wall s."""
    from datatunerx_tpu_torch.training.checkpoint import saved_steps

    csv_path = os.path.join(tmp, "experiment.csv")
    write_train_csv(csv_path, seed=4, n=8)  # 8 rows at batch 4: 2 steps
    storage = os.path.join(tmp, "storage")
    work = os.path.join(tmp, "jobs")
    spec_path = os.path.join(tmp, "experiment.json")
    status_path = os.path.join(tmp, "status.json")
    srv, port, eng = start_server(torch, flags, model=model)
    try:
        with open(spec_path, "w") as f:
            json.dump(experiment_spec(
                tmp, csv_path, storage,
                f"http://127.0.0.1:{port}/chat/completions", model), f)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        torch.cuda.empty_cache()  # the trainers share the card
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "datatunerx_tpu_torch.cli", "experiment",
             "-f", spec_path, "--backend", "local", "--device", device,
             "--workdir", work, "--tick_s", "0.5", "--max_ticks", "1200",
             "--status_json", status_path],
            capture_output=True, text=True, timeout=900, env=env, cwd=tmp)
        wall = time.perf_counter() - t0
    finally:
        stop_server(srv)
        eng.close()
    left = port_pids(tmp)
    if left:
        for pid in left:
            os.kill(pid, 9)
        fail(f"18: trainer processes left after the runner exited: {left}")

    def job_log(name):
        path = os.path.join(work, name, "log.txt")
        if not os.path.exists(path):
            return f"({name}: no log)"
        with open(path) as f:
            return f.read()[-3000:]

    logs = "\n".join(job_log(n) for n, _ in EXPERIMENT_JOBS)
    if p.returncode != 0 or not os.path.exists(status_path):
        fail(f"18: dtx-torch experiment exited {p.returncode}:\n"
             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}\n{logs}")
    with open(status_path) as f:
        status = json.load(f)
    events = [json.loads(ln[len("[experiment] "):])
              for ln in p.stdout.splitlines()
              if ln.startswith("[experiment] {")]
    states = {j["name"]: j["state"] for j in status["jobs"]}
    if states != {n: "Succeeded" for n, _ in EXPERIMENT_JOBS}:
        fail(f"18: job states {states}\n{logs}")
    order = [(e["event"], e.get("job")) for e in events
             if e.get("event") in ("started", "succeeded")]
    first, second = EXPERIMENT_JOBS[0][0], EXPERIMENT_JOBS[1][0]
    want = [("started", first), ("succeeded", first), ("started", second),
            ("succeeded", second)]
    if order != want:
        fail(f"18: the slice's order {order}, expected {want}")
    board = {e["job"]: e for e in status["leaderboard"]["standings"]}
    for name, _ in EXPERIMENT_JOBS:
        steps = saved_steps(os.path.join(storage, name, "checkpoints"))
        got = [s for s, _ in board.get(name, {}).get("history", [])]
        if steps != [1, 2] or got != steps or len(got) < (
                EXPERIMENT_MIN_EVALS):
            fail(f"18: {name} scored at steps {got}; its checkpoints "
                 f"{steps}")
        if not all(math.isfinite(float(sc)) for _, sc in board[name][
                "history"]):
            fail(f"18: {name}'s scores {board[name]['history']}")
    log(f"  dtx-torch experiment: exit 0 in {wall:.1f} s; order {order}; "
        f"leaderboard {[(e['job'], e['history']) for e in status['leaderboard']['standings']]}"
        f"; winner {status['winner']}; no trainer process left")
    return wall


def _reachable(url) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status == 200
    except (OSError, urllib.error.URLError):
        return False


def memory_phase(torch):
    """Phase 15d: ``estimate_footprint`` at the geometries of phases 5, 7,
    8 and hf-llama2's LoRA beside the peaks those phases measured in this
    run (``PEAKS``; a phase that did not run is marked so): every estimate
    at or above its peak. ``check_fits`` on the card's budget rejects a 7B
    full-parameter job on one card and admits a 7B QLoRA one; the budget
    table's total equals the card's."""
    import dataclasses

    from datatunerx_tpu_torch.models.config import get_config
    from datatunerx_tpu_torch.parallel import memory
    from datatunerx_tpu_torch.training.train_lib import TrainConfig

    total = torch.cuda.get_device_properties(0).total_memory
    if memory.HBM_BYTES["h100-80gb"] != total:
        fail(f"memory.HBM_BYTES['h100-80gb'] is "
             f"{memory.HBM_BYTES['h100-80gb']}, the card reports {total}")
    lora = TrainConfig(finetuning_type="lora", lora_rank=8,
                       lora_targets=("q_proj", "v_proj"))
    geo = dict(batch=TRAIN_SHAPE["batch"], seq=TRAIN_SHAPE["block"])
    cases = (("5", "tinyllama-1.1b", {}), ("7", "tinyllama-1.1b",
                                          {"quantization": "int4"}),
             ("8", "tinyllama-1.1b", {"quantization": "int8"}),
             ("hf-llama2", "llama2-7b", {}))
    for label, preset, over in cases:
        cfg = get_config(preset, attention_impl="flash", remat="dots",
                         **over)
        if label in PEAK_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=PEAK_LAYERS[label])
        fp = memory.estimate_footprint(cfg, lora, **geo)
        ref = memory.estimate_footprint(cfg, lora, activations="reference",
                                        **geo)
        est = fp.total / 2**30
        peak = PEAKS.get(label)
        seen = "not run in this call" if peak is None else f"{peak:.2f} GiB"
        log(f"  phase {label} ({preset}, {cfg.num_layers} layers, LoRA r8{' ' + over['quantization'] if over else ''}, "
            f"8x1024): estimate {est:.2f} GiB (the reference's activation "
            f"and logit terms: {ref.total / 2**30:.2f} GiB), measured peak "
            f"{seen}; {fp.gb()}")
        if peak is not None and peak > est:
            fail(f"phase {label}: measured peak {peak:.2f} GiB above the "
                 f"estimate {est:.2f} GiB")
    budget = memory.hbm_budget("h100-80gb")
    full = TrainConfig(finetuning_type="full")
    fits, fp, _ = memory.check_fits(
        get_config("llama2-7b", remat="dots", attention_impl="flash"), full,
        generation="h100-80gb", **geo)
    if fits:
        fail(f"check_fits admitted a 7B full-parameter job on one card "
             f"({fp.total / 1e9:.1f} GB <= {budget / 1e9:.1f} GB)")
    qfits, qfp, _ = memory.check_fits(
        get_config("llama2-7b", remat="dots", attention_impl="flash",
                   quantization="int4"), lora, generation="h100-80gb",
        **geo)
    if not qfits:
        fail(f"check_fits rejected a 7B QLoRA job on one card "
             f"({qfp.total / 1e9:.1f} GB > {budget / 1e9:.1f} GB)")
    log(f"  budget h100-80gb: {budget / 1e9:.2f} GB of the card's "
        f"{total} bytes; 7B full-parameter (8 x 1024) "
        f"{fp.total / 1e9:.1f} GB rejected, 7B QLoRA int4 "
        f"{qfp.total / 1e9:.1f} GB admitted")


def hosts_phase(torch, tmp):
    """Phase 15e: ``LocalProcessBackend`` asked for 2 hosts on CUDA raises
    on a machine with fewer cards, naming the count, and starts nothing."""
    from datatunerx_tpu_torch.operator.backends import LocalProcessBackend

    cards = torch.cuda.device_count()
    backend = LocalProcessBackend(os.path.join(tmp, "jobs"), device="cuda")
    try:
        backend.submit("two-hosts", {"args": ["--max_steps", "1"],
                                     "num_hosts": cards + 1})
    except RuntimeError as e:
        if f"{cards} card(s)" not in str(e):
            fail(f"the refusal does not name the card count: {e}")
        log(f"  num_hosts {cards + 1} on {cards} card(s): refused ({e})")
    else:
        backend.delete("two-hosts")
        fail(f"LocalProcessBackend started {cards + 1} hosts on {cards} "
             "card(s)")
    if backend.status("two-hosts") != "NotFound":
        fail("a refused job left a process behind")


def parallel_phase(torch, timer, gen, tmp):
    """Phase 15: the multi-GPU slice on one card (a + b + c + d + e).
    Returns (the @ring kernel entries, the ring schedule's launches)."""
    log("[15a] K1/K2/K3 with causal=False (the ring's past chunks) vs "
        "their plain versions at ring chunk shapes; threefry block draws")
    entries = check_flash_ring(torch, timer, gen)
    check_threefry_blocks(torch, timer)
    torch.cuda.empty_cache()
    log(f"[15b] the sp={RING_SP} ring schedule in one process over the "
        "kernels (rotation by indexing)")
    launches = ring_phase(torch, timer, gen)
    torch.cuda.empty_cache()
    log("[15c] the trainer CLI at tinyllama width: --attention ring --mesh "
        "dp=1 vs --attention xla, 2 steps each")
    ring_cli_phase(torch, tmp)
    torch.cuda.empty_cache()
    log("[15c] PPO through the trainer CLI at tinyllama width: --mesh dp=1 "
        "vs no mesh, 2 steps each, against a 2-step rm run")
    ppo_mesh_cli_phase(torch, tmp)
    torch.cuda.empty_cache()
    log("[15d] memory: estimate_footprint beside the training phases' "
        "peaks; check_fits on the card's budget")
    memory_phase(torch)
    log("[15e] LocalProcessBackend: more hosts than cards under --device "
        "cuda")
    hosts_phase(torch, tmp)
    return entries, launches


# ------------------------------------------------------------ phase install
INSTALL_STEPS = 2
# the counters the child reads: the serving path's K7, K8, K9, then the
# trainer's K1-K3 and threefry
INSTALL_SERVE = ("paged_decode_attention", "paged_multitoken_attention",
                 "kernel_sample")
INSTALL_TRAIN = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "threefry_bits")

# The child runs the installed package alone (its own cwd, only the install
# target on the path, a fresh XDG_CACHE_HOME), so it cannot import this
# script: it is written out and run as a file. It stops at the first miss.
INSTALL_CHILD = r'''
import hashlib
import json
import os
import sys
import time
import urllib.request

cfg = json.load(open(sys.argv[1]))
site, checkout, cache = (os.path.realpath(cfg[k])
                         for k in ("site", "checkout", "cache"))
res = {}


def say(msg):
    print(f"[install-child] {msg}", flush=True)


def under(path, root):
    path = os.path.realpath(str(path))
    return path == root or path.startswith(root + os.sep)


def installed(label, path):
    if not under(path, site) or under(path, checkout):
        raise SystemExit(f"{label} {path} is not in the install target "
                         f"{site}, or lies in the checkout {checkout}")


def cached(label, path):
    if not under(path, cache) or under(path, site) or under(path, checkout):
        raise SystemExit(f"{label} {path} is not under XDG_CACHE_HOME "
                         f"{cache}")


import torch

import datatunerx_tpu_torch as pkg
from datatunerx_tpu_torch import native
from datatunerx_tpu_torch.ops import _build

installed("datatunerx_tpu_torch", pkg.__file__)
installed("_build.CSRC", _build.CSRC)
cached("_build.BUILD_DIR", _build.BUILD_DIR)
cached("native.BUILD_DIR", native.BUILD_DIR)
res["digest"] = _build._digest(_build._sources())
lib = _build.BUILD_DIR / f"libdtx_kernels-{res['digest']}.so"
if not lib.exists():
    raise SystemExit(f"the compile-only entry left no {lib}")
t0 = time.perf_counter()
_build.library()
res["library"] = str(lib)
say(f"loaded {lib} in {time.perf_counter() - t0:.2f} s (no build)")

# serving: the paged engine, two greedy prompts
from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
from datatunerx_tpu_torch.ops import cuda_sampling as cs
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

t0 = time.perf_counter()
eng = BatchedEngine(cfg["model"], template="llama2", max_seq_len=1024,
                    slots=4, kv_block_size=16, device="cuda")
res["prompts"] = [eng.tokenizer.encode(p) for p in cfg["prompts"]]
counters = (cpa.paged_decode_attention, cpa.paged_multitoken_attention,
            cs.kernel_sample)
for c in counters:
    c.launches = 0
res["streams"] = [eng.generate(p, max_new_tokens=cfg["max_new"])
                  for p in res["prompts"]]
res["serve_launches"] = {c.__name__: c.launches for c in counters}
eng.close()
del eng
torch.cuda.empty_cache()
say(f"served {len(res['streams'])} greedy prompts in "
    f"{time.perf_counter() - t0:.1f} s (load included), launches "
    f"{res['serve_launches']}")

# training: the trainer CLI's main, packing through the installed packer
from datatunerx_tpu_torch.ops import cuda_prng
from datatunerx_tpu_torch.ops import flash_attention as fa
from datatunerx_tpu_torch.tuning import train

so = native._library_path()
if so is None:
    raise SystemExit("the installed package holds no native/packer.cpp")
res["native_fresh"] = not so.exists()
if not native.available():
    raise SystemExit("the installed native packer did not build (g++)")
cached("the native packer", so)
res["native_library"] = str(so)
res["native_build_s"] = native.build_seconds
packed = []
real_pack = native.pack_batch_native


def counted_pack(*a, **kw):
    out = real_pack(*a, **kw)
    packed.append(out is not None)
    return out


native.pack_batch_native = counted_pack
counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
            cuda_prng.threefry_bits)
for c in counters:
    c.launches = 0
t0 = time.perf_counter()
res["train_rc"] = train.main(cfg["train_argv"])
res["train_s"] = time.perf_counter() - t0
res["train_launches"] = {c.__name__: c.launches for c in counters}
native.pack_batch_native = real_pack
res["packed"] = packed
with open(cfg["train_log"]) as f:
    res["losses"] = [json.loads(line)["loss"] for line in f]
say(f"trained {len(res['losses'])} steps in {res['train_s']:.1f} s, "
    f"launches {res['train_launches']}, packing calls {packed}")

# the control plane's UI
from datatunerx_tpu_torch.operator import apiserver
from datatunerx_tpu_torch.operator.store import ObjectStore

installed("operator/apiserver.py", apiserver.__file__)
srv, port = apiserver.serve_api(ObjectStore(), port=0)
try:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/ui",
                                timeout=30) as r:
        res["ui_status"], body = r.status, r.read()
        res["ui_type"] = r.headers.get("Content-Type", "")
finally:
    srv.shutdown()
    srv.server_close()
res["ui_sha256"] = hashlib.sha256(body).hexdigest()

res["stray"] = sorted(
    m.__file__ for name, m in list(sys.modules.items())
    if name.split(".")[0] == "datatunerx_tpu_torch"
    and getattr(m, "__file__", None) and not under(m.__file__, site))
res["blocked"] = sorted({n.split(".")[0] for n in sys.modules}
                        & {"jax", "jaxlib", "datatunerx_tpu"})
with open(cfg["out"], "w") as f:
    json.dump(res, f)
'''


def run_logged(label, argv, timeout, procs=None, **kw):
    """Run ``argv`` to its end (killed at ``timeout``); fail with its
    output's tail unless it exits 0. Returns its output. ``procs`` (a
    list) holds the process while it runs."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)
    if procs is not None:
        procs.append(proc)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        fail(f"{label} did not finish within {timeout} s:\n{out[-4000:]}")
    if proc.returncode != 0:
        fail(f"{label} exited {proc.returncode}:\n{out[-6000:]}")
    return out


# the install prep's processes run at the lowest priority, so phase 1's
# build and phase 2's timings keep the cores they need
NICE = ("nice", "-n", "19")


def start_install_prep(tmp):
    """The install phase's card-free half, begun beside phase 1's build in
    a thread at nice 19 and joined when the install phase starts (after
    phase 2): the project's wheel built from a copy of the tree's
    ``pyproject.toml`` and ``datatunerx_tpu_torch`` (what
    ``Dockerfile.torch-trainer`` copies), ``pip install --target`` into
    ``tmp``, then the compile-only entry run by the installed package from
    an empty directory into a fresh ``XDG_CACHE_HOME``. Returns a function
    that joins it and returns the paths, the child's environment and the
    seconds; the run fails if a step did."""
    import atexit
    import shutil

    res = {"procs": []}
    src, wheels, site, cache, cwd = (os.path.join(tmp, n) for n in
                                     ("src", "wheels", "site", "cache",
                                      "cwd"))

    def work():
        try:
            for d in (src, cwd):
                os.makedirs(d)
            shutil.copy2(os.path.join(ROOT, "pyproject.toml"), src)
            shutil.copytree(os.path.join(ROOT, "datatunerx_tpu_torch"),
                            os.path.join(src, "datatunerx_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            t0 = time.perf_counter()
            run_logged("pip wheel", [
                *NICE, sys.executable, "-m", "pip", "wheel", "--no-deps",
                "--no-build-isolation", "--no-index", "-q", "-w", wheels,
                src], 600, res["procs"])
            whl = [os.path.join(wheels, f) for f in os.listdir(wheels)
                   if f.endswith(".whl")]
            if len(whl) != 1:
                fail(f"pip wheel left {whl}")
            run_logged("pip install --target", [
                *NICE, sys.executable, "-m", "pip", "install", "--no-deps",
                "--no-index", "-q", "--target", site, whl[0]], 600,
                res["procs"])
            res["wheel"], res["pip_s"] = whl[0], time.perf_counter() - t0
            env = {k: v for k, v in os.environ.items()
                   if k not in ("PYTHONPATH", "PYTHONHOME", "PYTHONSTARTUP")}
            env.update(PYTHONPATH=site, XDG_CACHE_HOME=cache,
                       PYTHONNOUSERSITE="1")
            t0 = time.perf_counter()
            res["build_out"] = run_logged(
                "python -m datatunerx_tpu_torch.ops._build",
                [*NICE, sys.executable, "-m",
                 "datatunerx_tpu_torch.ops._build"],
                600, res["procs"], cwd=cwd, env=env).strip()
            res.update(site=site, cache=cache, cwd=cwd, env=env,
                       nvcc_s=time.perf_counter() - t0)
        except SystemExit:  # fail() has printed the step's output
            pass

    # a failing run exits with the prep still running: stop its processes
    atexit.register(lambda: [p.kill() for p in res["procs"]
                             if p.poll() is None])
    th = threading.Thread(target=work, daemon=True)
    th.start()

    def join():
        th.join(timeout=1200)
        if "nvcc_s" not in res:
            fail("install: the wheel, its install or the compile-only "
                 "build failed or hung (above)")
        return res

    return join


def install_phase(torch, tmp, prep):
    """The port as an installed package: ``prep`` (``start_install_prep``'s
    result: the wheel installed with ``pip install --target`` and its
    kernels compiled by the compile-only entry into a fresh
    ``XDG_CACHE_HOME``) run by a child that sees only the install. Returns
    the child's result, whose greedy streams and serving launches
    ``install_streams_check`` holds against a checkout engine's."""
    import hashlib

    from datatunerx_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    log(f"  {os.path.basename(prep['wheel'])}: built and installed in "
        f"{prep['pip_s']:.1f} s; the compile-only entry (nvcc, no load): "
        f"{prep['build_out']}, {prep['nvcc_s']:.1f} s with its "
        "interpreter's start (both at nice 19 beside phases 1 and 2)")
    child_dir = os.path.join(tmp, "child")
    os.makedirs(child_dir)
    csv_path = os.path.join(tmp, "train.csv")
    write_train_csv(csv_path)
    out_dir = os.path.join(tmp, "out")
    train_argv = [
        "--model_name_or_path", "preset:tinyllama-1.1b",
        "--train_path", csv_path, "--template", "alpaca",
        "--finetuning_type", "lora", "--lora_target", "q_proj,v_proj",
        "--attention", "flash", "--remat", "dots", "--bf16",
        "--block_size", str(TRAIN_SHAPE["block"]), "--pack_sequences",
        "--per_device_train_batch_size", str(TRAIN_SHAPE["batch"]),
        "--max_steps", str(INSTALL_STEPS), "--logging_steps", "1",
        "--output_dir", out_dir, "--storage_path",
        os.path.join(tmp, "store"), "--device", "cuda"]
    cfg_path = os.path.join(tmp, "child.json")
    result_path = os.path.join(tmp, "child-result.json")
    with open(cfg_path, "w") as f:
        json.dump({"site": prep["site"], "checkout": ROOT,
                   "cache": prep["cache"],
                   "model": "preset:tinyllama-1.1b",
                   "prompts": list(PARITY_PROMPTS),
                   "max_new": PARITY_NEW, "train_argv": train_argv,
                   "train_log": os.path.join(out_dir, "watch",
                                             "trainer_log.jsonl"),
                   "out": result_path}, f)
    child = os.path.join(child_dir, "install_child.py")
    with open(child, "w") as f:
        f.write(INSTALL_CHILD)
    t0 = time.perf_counter()
    out = run_logged("the install child", [sys.executable, "-s", child,
                                           cfg_path], 900, cwd=prep["cwd"],
                     env=prep["env"])
    child_s = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith("[install-child] "):
            log("  " + line)
    with open(result_path) as f:
        res = json.load(f)

    digest = _build._digest(_build._sources())
    if res["digest"] != digest:
        fail(f"install: the installed sources' digest {res['digest']} is "
             f"not the checkout's {digest}")
    if res["stray"] or res["blocked"]:
        fail(f"install: modules from outside the install {res['stray']}, "
             f"blocked packages imported {res['blocked']}")
    for name in INSTALL_SERVE:
        if res["serve_launches"].get(name, 0) <= 0:
            fail(f"install: {name} was never launched by the installed "
                 "engine")
    if res["train_rc"] != 0:
        fail(f"install: the installed trainer CLI returned "
             f"{res['train_rc']}")
    want = expected_launches(None, INSTALL_STEPS)
    want = {k: want[k] for k in INSTALL_TRAIN}
    if res["train_launches"] != want:
        fail(f"install: trainer launches {res['train_launches']}, "
             f"expected {want}")
    if len(res["losses"]) != INSTALL_STEPS or not all(
            math.isfinite(x) for x in res["losses"]):
        fail(f"install: train losses {res['losses']}")
    if not res["native_fresh"] or not res["packed"] or not all(
            res["packed"]):
        fail(f"install: the native packer (fresh build "
             f"{res['native_fresh']}) packed {res['packed']}")
    with open(os.path.join(ROOT, "datatunerx_tpu_torch", "operator",
                           "ui.html"), "rb") as f:
        ui_sha = hashlib.sha256(f.read()).hexdigest()
    if res["ui_status"] != 200 or res["ui_sha256"] != ui_sha or not \
            res["ui_type"].startswith("text/html"):
        fail(f"install: GET /ui answered {res['ui_status']} "
             f"({res['ui_type']}), sha256 {res['ui_sha256']} against the "
             f"checkout's {ui_sha}")
    log(f"  the installed package: kernels {os.path.basename(res['library'])}"
        f" and {os.path.basename(res['native_library'])} (g++ "
        f"{res['native_build_s']:.2f} s) under XDG_CACHE_HOME; serve "
        f"launches {res['serve_launches']}; train launches "
        f"{res['train_launches']} (expected), losses "
        f"{[round(x, 4) for x in res['losses']]}, {len(res['packed'])} "
        f"packing call(s) through the native packer; GET /ui 200, "
        f"{ui_sha[:12]}")
    log(f"  [time] install: wheel + install {prep['pip_s']:.1f} s and nvcc "
        f"{prep['nvcc_s']:.1f} s beside phases 1 and 2; the child "
        f"{child_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s")
    return res


def install_streams_check(torch, installed, ref, checkout):
    """The install child's greedy streams and serving launches against
    ``checkout`` (``greedy_streams`` of ``ref``, a checkout engine of the
    child's geometry, with K7, K8 and K9 counted): the same token ids for
    the same prompts, each stream equal up to a near-tie
    (``check_greedy``), and every serving kernel launched exactly as often
    as the checkout's engine launched it for the same generations."""
    prompts, streams, launches = checkout
    if installed["prompts"] != prompts:
        fail("install: the installed tokenizer encodes a prompt "
             "differently")
    if installed["serve_launches"] != launches:
        fail(f"install: the installed engine launched "
             f"{installed['serve_launches']}, the checkout's {launches} "
             f"(streams of {[len(x) for x in installed['streams']]} and "
             f"{[len(x) for x in streams]} tokens)")
    for ids, got, want in zip(prompts, installed["streams"], streams):
        check_greedy(torch, "install greedy vs the checkout", got, want,
                     ref, ids, PARITY_NEW)
    log(f"  install: serving launches {launches}, equal to the checkout "
        "engine's for the same two generations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="all",
                    choices=["all", "kernels", "serve", "train", "qlora",
                             "hf", "gateway", "parallel", "operator",
                             "loadgen", "install"])
    opts = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "datatunerx_tpu_torch", "csrc")):
        fail("datatunerx_tpu_torch/ is missing: run from a repository "
             "checkout")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[1] device: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}")

    from datatunerx_tpu_torch.ops import _build

    install_tmp = None
    if opts.phase in ("all", "serve", "install"):
        # the install phase's wheel and nvcc build run beside this one
        install_tmp = tempfile.TemporaryDirectory(prefix="dtx-install-")
        join_install_prep = start_install_prep(install_tmp.name)
    t0 = time.perf_counter()
    _build.library()
    log(f"    kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})"
        + ("; the install phase's wheel and build beside it, at nice 19"
           if install_tmp else ""))

    log("[2] kernels vs their plain versions (tinyllama-1.1b shapes)")
    gen = torch.Generator().manual_seed(0)
    timer = Timer(torch)
    entries = []

    def report(e):
        entries.append(e)
        lib = ("none" if e["library_ms"] is None
               else f"{e['library_ms']:.4f} ms")
        log(f"  {e['name']} [{e['shape']}]: max abs err {e['max_abs_err']:.3g}"
            f" ({e['tolerance']}); kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library {lib}, bound "
            f"{e['bound_ms']:.5f} ms ({e['bound_by']})")

    for check, quant in ((check_k7, False), (check_k8, False),
                         (check_k7, True), (check_k8, True)):
        report(check(torch, timer, gen, quant))
    report(check_k9(torch, timer, gen))
    # the HF phases' shapes, from a generator of their own: the inputs of
    # the checks before and after them stay what they were
    gen_hf = torch.Generator().manual_seed(12)
    report(check_k7(torch, timer, gen_hf, shape=K7_LLAMA2,
                    path="@hf-llama2"))
    report(check_k8(torch, timer, gen_hf, shape=K8_LLAMA2,
                    path="@hf-llama2"))
    report(check_k9(torch, timer, gen_hf, V=151936, path="@hf-qwen"))
    # the spec phases' shapes and the twin, each from a generator of its
    # own (the inputs of every other check stay what they were)
    TWIN_LAUNCHES[0] = check_twin(torch, torch.Generator().manual_seed(13))
    for i, (quant, tree) in enumerate(((False, False), (True, False),
                                       (False, True))):
        report(check_k8_spec(torch, timer,
                             torch.Generator().manual_seed(14 + i),
                             quant=quant, tree=tree))
    report(check_threefry(torch, timer, torch.Generator().manual_seed(17)))
    log(f"  an empty kernel under the same timer: "
        f"{empty_kernel_ms(torch, timer):.4f} ms (the floor of a small "
        "kernel's time)")
    flash = check_flash(torch, timer, gen)
    check_k3_sweep(torch)
    del timer
    torch.cuda.empty_cache()
    for e in check_k10(torch) + flash + check_quant(torch):
        report(e)
    torch.cuda.empty_cache()
    for e in entries:  # an entry of another path counts that path's runs
        e["key"] = (counter_key(e["counter"], e.get("count", "launches"))
                    + e.get("path", ""))
    by_name = {e["name"].split()[0]: (e["counter"], e.get("count", "launches"))
               for e in entries}
    launches = {e["key"]: 0 for e in entries}
    serving_counters = [by_name[k] for k in ("K7", "K8", "K9")]
    installed = None
    if install_tmp is not None:
        with install_tmp as tmp:
            log("[install] the port as an installed package: a wheel from a "
                "copy of the tree, pip install --target, kernels and packer "
                "built under a fresh XDG_CACHE_HOME, two greedy prompts, "
                f"{INSTALL_STEPS} LoRA steps and GET /ui from the install")
            t0 = time.perf_counter()
            install_prep = join_install_prep()
            log(f"  waited {time.perf_counter() - t0:.1f} s for the wheel and "
                "the compile-only build begun in phase 1")
            installed = install_phase(torch, tmp, install_prep)
        counts = {**installed["serve_launches"],
                  **installed["train_launches"]}
        for e in entries:  # the install's launches beside the main path's
            key = counter_key(e["counter"], e.get("count", "launches"))
            if not e.get("path") and key in counts:
                e.setdefault("extra", {})["launches@install"] = counts[key]
        torch.cuda.empty_cache()
    serving = opts.phase in ("all", "serve")
    if installed is not None and not serving:
        from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

        log("[install-streams] the install's streams and launches against a "
            "checkout engine of its geometry")
        ref = BatchedEngine("preset:tinyllama-1.1b", template="llama2",
                            max_seq_len=1024, slots=4, kv_block_size=16,
                            device="cuda")
        try:
            install_streams_check(torch, installed, ref,
                                  greedy_streams(ref, serving_counters))
        finally:
            ref.close()
        del ref
        torch.cuda.empty_cache()
    if serving:
        log("[3] serve preset:tinyllama-1.1b (4 concurrent /chat/completions)")
        eng, served, base_batch = serve_phase(
            torch, [by_name[k] for k in ("K7", "K8", "K9")])
        launches.update(served)
        bf16_pool_bytes = eng.kv_cache_bytes
        log("[4] greedy parity: kernels vs gather path + legacy sampler"
            + ("; the install's streams and launches against the same "
               "generations" if installed else ""))
        try:
            checkout = parity_phase(torch, eng, counters=serving_counters)
            if installed is not None:
                install_streams_check(torch, installed, eng, checkout)
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
        log("[3-int8] serve with --kv_quant int8 (int8 KV pool + f32 scale pools; "
            "4 concurrent /chat/completions)")
        eng, served, _ = serve_phase(
            torch, [by_name[k] for k in ("K7-int8", "K8-int8")],
            flags=("--kv_block_size", "16", "--kv_quant", "int8",
                   "--slots", "4"))
        launches.update(served)
        log(f"  KV pool (K, V and scales): int8 {eng.kv_cache_bytes} bytes, "
            f"bf16 {bf16_pool_bytes} bytes "
            f"({eng.kv_cache_bytes / bf16_pool_bytes:.4f} of it)")
        log("[4-int8] greedy parity: int8 kernels vs the int8 gather path")
        try:
            parity_phase(torch, eng, kv_quant="int8")
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
        log("[3-dense] serve with the server's default flags (--kv_block_size "
            "0: the dense cache), 2 concurrent greedy requests, then greedy "
            "parity with the paged gather path")
        eng, _, _ = serve_phase(torch, [], flags=(), greedy_only=True)
        try:
            if eng.decode_path != "dense" or eng.total_kv_blocks is not None:
                fail(f"the default flags gave decode_path {eng.decode_path}")
            parity_phase(torch, eng)
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
        log("[3-obs] the observability plane: /metrics, /debug/trace, "
            "/debug/slo and a /debug/profile window over the paged server "
            "(--trace_ring 64 --trace_log --slo_config --slo_sample_s 0.5), "
            "4 concurrent requests twice; tracing on vs off")
        obs_phase(torch, [by_name[k] for k in ("K7", "K8", "K9")], card)
        torch.cuda.empty_cache()
        from datatunerx_tpu_torch.ops import cuda_quant as cq

        log("[3-prefix] prefix cache + KV overcommit (COW blocks, growth, "
            "preemption and resume) on a 64-block pool, 4 slots")
        prefix_phase(torch, [by_name["K7"], by_name["K8"]])
        log("[3-prefix-int8] the same over int8 KV pools")
        prefix_phase(torch, [by_name["K7-int8"], by_name["K8-int8"]],
                     kv_quant="int8")
        log("[3-spec] the paged server with a draft (take:4, k 4, spec on): "
            "2 greedy, 1 sampled and 1 top-p request at once")
        launches.update(spec_phase(torch, "3-spec", SPEC_FLAGS, SPEC_REQS,
                                   "@spec-chain"))
        spec_full_draft_phase(torch)
        torch.cuda.empty_cache()
        log("[3-spec-tree] the same server with --spec_tree 2x3")
        launches.update(spec_phase(
            torch, "3-spec-tree", SPEC_FLAGS + ("--spec_tree", "2x3"),
            SPEC_REQS[:3], "@spec-tree"))
        torch.cuda.empty_cache()
        log("[3-spec-int8] 3-spec over --kv_quant int8, 2 greedy requests")
        launches.update(spec_phase(
            torch, "3-spec-int8", SPEC_FLAGS + ("--kv_quant", "int8"),
            SPEC_REQS[:2], "@spec-chain"))
        torch.cuda.empty_cache()
        log("[3-perplexity] POST /perplexity to the paged server")
        perplexity_phase(torch)
        log("[3-single] the single-request engine (--slots 1), then "
            "serve-time --quantization int8 and int4")
        single_phase(torch, [(cq.nf4_matmul, "launches"),
                             (cq.nf4_matmul_t, "launches"),
                             (cq.int8_matmul, "launches")])
        log("[3-adapters] pooled adapters and tenancy: 6 adapters through "
            "/admin/adapters, 3 rounds of concurrent requests")
        adapter_phase(torch, [by_name[k] for k in ("K7", "K8", "K9")],
                      base_batch)
        log("[3-migrate] session migration and the fleet plane: two port "
            "servers, sessions moved mid-decode and mid-prefill, int8, the "
            "prefix tier, peer spill")
        migrate_phase(torch, [by_name[k] for k in ("K7", "K8", "K9")],
                      [by_name[k] for k in ("K7-int8", "K8-int8")])
    if opts.phase in ("all", "serve", "gateway"):
        log("[14a] the port's gateway over two port servers in this "
            "process (prefill and decode roles, the fleet prefix tier and "
            "handoff, session handoff, tenants): chats, a prefix, a "
            "handoff, a drain, a tenant's 429, /metrics")
        gated = gateway_phase(torch, [by_name[k] for k in ("K7", "K8", "K9")])
        for e in entries:  # the gateway's launches beside the serve phase's
            if not e.get("path") and e["name"].split()[0] in ("K7", "K8",
                                                               "K9"):
                e.setdefault("extra", {})["launches@gateway"] = gated[
                    counter_key(e["counter"], e.get("count", "launches"))]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="dtx-gateway-") as tmp:
            log("[14b] LocalServingBackend deploys the port's gateway over "
                "2 port server subprocesses: HEALTHY, chats, scale 2 -> 1, "
                "delete")
            gateway_spawn_phase(torch, tmp)
        torch.cuda.empty_cache()
    if opts.phase in ("all", "serve", "gateway", "loadgen"):
        with tempfile.TemporaryDirectory(prefix="dtx-replay-") as tmp:
            log("[17] dtx-torch replay (40 requests, 6 sessions, 25 rps, "
                "seed 0) against the port's paged server, then its recorded "
                "trace through a port gateway over the same server")
            replayed = loadgen_phase(
                torch, tmp, [by_name[k] for k in ("K7", "K8", "K9")], card)
        for e in entries:  # each replay's launches beside the serve phase's
            key = counter_key(e["counter"], e.get("count", "launches"))
            if not e.get("path") and key in replayed["direct"]:
                e.setdefault("extra", {}).update({
                    "launches@replay": replayed["direct"][key],
                    "launches@replay-gateway": replayed["gateway"][key]})
        torch.cuda.empty_cache()

    if opts.phase in ("all", "train", "qlora"):
        # each kernel's launches come from the run of its own path
        flash_keys = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        with tempfile.TemporaryDirectory(prefix="dtx-smoke-") as tmp:
            if opts.phase != "qlora":
                log("[5] train preset:tinyllama-1.1b: LoRA SFT through the "
                    "trainer CLI (flash, remat dots, bf16, packed 8x1024)")
                trained, run = train_phase(torch, tmp, remote_write=True,
                                           native_packer=True)
                PEAKS["5"] = run["peak_gib"]
                launches.update({k: trained[k] for k in flash_keys})
                launches["threefry_bits"] = trained["threefry_bits"]
                log(f"  with the twin's dropout masks: step "
                    f"{run['step_ms']:.1f} ms, busy "
                    f"{run['busy'] * 100:.1f} % (PR 12, torch-generator "
                    "masks: 281.3 ms, 67.8 %)")
                torch.cuda.empty_cache()
                log("[5-serve] serve phase 5's checkpoint with "
                    "--checkpoint_path: the paged server (adapter "
                    '"default") and --slots 1 (merged)')
                checkpoint_serve_phase(torch, run["checkpoint"],
                                       run["scaling"])
                log("[6] train parity: one step with the flash kernels vs "
                    "plain attention (tinyllama width, 4 layers)")
                for dropout in (0.0, 0.1):
                    train_parity_phase(torch, [
                        ("flash", dict(attention_impl="flash")),
                        ("xla", dict(attention_impl="xla"))],
                        dropout=dropout)
                    torch.cuda.empty_cache()
            log("[7] QLoRA train preset:tinyllama-1.1b --quantization int4 "
                "(nf4 base on K4/K5, flash, remat dots, bf16, packed 8x1024)")
            trained, run = train_phase(torch, tmp, quant="int4",
                                       steps=QLORA_STEPS)
            PEAKS["7"] = run["peak_gib"]
            launches.update({k: trained[k] for k in
                             ("nf4_matmul", "nf4_matmul_t")})
            torch.cuda.empty_cache()
            log("[8] QLoRA train --quantization int8 (int8 base on K6)")
            trained, run = train_phase(torch, tmp, quant="int8",
                                       steps=INT8_STEPS, export=False)
            PEAKS["8"] = run["peak_gib"]
            launches["int8_matmul"] = trained["int8_matmul"]
            torch.cuda.empty_cache()
        for mode in ("int4", "int8"):
            log(f"[9] QLoRA parity ({mode}): one step with quant_impl pallas "
                "(the kernels) vs xla (dequantize + matmul), tinyllama width, "
                "4 layers")
            train_parity_phase(torch, [
                ("pallas", dict(attention_impl="flash", quantization=mode,
                                quant_impl="pallas")),
                ("xla", dict(attention_impl="flash", quantization=mode,
                             quant_impl="xla"))], quant=mode)
            torch.cuda.empty_cache()

        if opts.phase != "qlora":
            with tempfile.TemporaryDirectory(prefix="dtx-paths-") as tmp:
                log("[11] the trainer's paths at tinyllama-1.1b: DPO, RM, "
                    "adafactor, lion, streaming, generative eval")
                rm_run = trainer_paths_phase(torch, tmp)
                torch.cuda.empty_cache()
                log(f"[12] PPO at tinyllama-1.1b against phase 11's RM run: "
                    f"{PPO_BATCH} prompts x block {PPO_BLOCK} a step, "
                    f"{PPO_GEN} sampled tokens, {PPO_EPOCHS} passes, "
                    f"{PPO_STEPS} steps (flash, remat dots, bf16)")
                ppo = ppo_phase(torch, tmp, rm_run)
                for e in entries:  # the PPO run's launches beside phase 5's
                    name = getattr(e["counter"], "__name__", "")
                    if not e.get("path") and name in ppo["launches"]:
                        e.setdefault("extra", {})["launches@ppo"] = (
                            ppo["launches"][name])
                torch.cuda.empty_cache()
                log("[13] the launch backends: LocalProcessBackend trains 2 "
                    "steps in a subprocess, LocalServingBackend serves its "
                    "checkpoint, two chats and two perplexities, teardown")
                launch_phase(torch, tmp)
            torch.cuda.empty_cache()
    if opts.phase in ("all", "train", "operator"):
        with tempfile.TemporaryDirectory(prefix="dtx-operator-") as tmp:
            log("[16] the port's controller-manager (--backend local, one "
                "slice of 1 card) takes a FinetuneExperiment of two "
                "FinetuneJobs through dtx-torch apply to Success")
            op = operator_phase(torch, tmp)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="dtx-experiment-") as tmp:
            log("[18] dtx-torch experiment --backend local: two LoRA jobs "
                "(learning rates 2e-4 and 1e-3) on one slice of 1 card, "
                "scored at a port paged server")
            wall = experiment_phase(torch, tmp)
        log(f"  {card}: the experiment {wall:.1f} s through dtx-torch "
            f"experiment, {op['wall_s']:.1f} s through the operator (phase "
            "16, less its probes' hold)")
        torch.cuda.empty_cache()

    if opts.phase in ("all", "hf"):
        # HF checkpoint directories at the published configurations
        with tempfile.TemporaryDirectory(prefix="dtx-hf-") as tmp:
            launches.update(hf_phases(torch, tmp, by_name))
        torch.cuda.empty_cache()

    if serving:
        log("[10] fused LoRA matmul (K10) at tinyllama-1.1b's adapted "
            "projections vs the f32 composite")
        launches.update(lora_phase(torch))
    if opts.phase in ("all", "parallel"):
        with tempfile.TemporaryDirectory(prefix="dtx-parallel-") as tmp:
            ring_entries, ring_launches = parallel_phase(
                torch, Timer(torch), torch.Generator().manual_seed(19), tmp)
        for e in ring_entries:
            e["key"] = counter_key(e["counter"]) + e["path"]
            launches[e["key"]] = ring_launches[e["counter"].__name__]
            report(e)
        torch.cuda.empty_cache()
    if opts.phase == "all":
        for e in entries:
            if launches[e["key"]] <= 0:
                fail(f"{e['name']} was never launched on its path")
    line = []
    for e in entries:
        line.append({
            "name": e["name"], "route": e["route"], "source": e["source"],
            "replaces": e["replaces"],
            "launches": launches[e["key"]],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            **({"library": e["library"]} if "library" in e else {}),
            **e.get("extra", {})})
    phase_done()
    total = time.perf_counter() - T_START
    log(f"  [time] {len(_PHASES['seconds'])} phases "
        f"{sum(t for _, t in _PHASES['seconds']):.1f} s; the whole script "
        f"{total:.1f} s on {card}")
    log(card)  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
