"""Continuous-batching inference engine: the port of
``datatunerx_tpu/serving/batched_engine.py`` over both cache layouts.

- DENSE KV cache (``kv_block_size == 0``, the default;
  models/llama.init_cache with per-slot cursors): every slot owns a
  ``max_seq_len`` row. Admission prefills the whole (bucketed) prompt into a
  fresh one-row cache in one forward, copies that row into the slot's row
  and arms the slot at once; decode attention reads the full rows.
- PAGED KV cache (``kv_block_size > 0``, ops/paged_attention.py): a pool of
  fixed-size blocks plus per-slot block tables. Admission reserves
  ``ceil((prompt + max_new) / block_size)`` blocks from a free list.
- CHUNKED PREFILL (paged): a cold prompt prefills directly into its slot's
  blocks in ``prefill_chunk``-token forwards, interleaved with decode (at
  most ``prefill_token_budget`` prompt tokens between decode chunks).
- ``kv_quant="int8"`` stores K/V as int8 with an f32 scale per head vector
  on either layout: about half the cache bytes per token, quantized on
  write and dequantized on read (inside the paged kernels on their path).
- PREFIX CACHE (``prefix_cache > 0``): an LRU of prefilled prompts keyed by
  their tokens. An exact hit skips prefill; the longest strict-prefix hit
  prefills only the suffix. Dense and eager paged engines store dense rows
  (paged ones trimmed to the cursor, scattered back into a slot's blocks).
- KV OVERCOMMIT (``kv_overcommit="on"``, paged only): admission reserves
  the prompt's blocks plus one tick's advance, and ``_grow_tick`` appends
  blocks ahead of each cursor between ticks. With a prefix cache, entries
  are refcounted BLOCKS that a hit maps into the new slot's table
  (copy-on-write: only a partial tail block is copied). When the pool runs
  dry, growth reclaims prefix entries, then preempts the youngest session:
  it parks in the dtx-kv-session row format (serving/migration.py) and
  resumes token for token, its threefry key included. The oldest live
  session is never preempted.
- SESSION MIGRATION (serving/migration.py): ``export_sessions`` serializes
  live sessions (mid-decode, or mid-chunked-prefill with a ``pending``
  tail) into dtx-kv-session payloads and finishes the source requests with
  the "session migrated" marker; ``import_session`` admits a payload from
  either package and resumes it token for token. ``hold_parked``,
  ``drop_parked`` and ``release_parked`` lease preempted sessions to a
  peer-spill coordinator; ``export_prefix_entries`` and
  ``import_prefix_entry`` move prefix-cache entries between replicas
  (fleet/). The commands queue to the scheduler thread, which serves them
  first each tick.
- decode runs in CHUNKS of K tokens: a Python loop of K single-token steps
  with every operand on the device; the one host sync per chunk is the
  transfer of the emitted tokens (and the active mask) that lets
  ``Request.push`` stream them.
- with ``paged_kernel`` on (paged layout only), decode attention is the
  paged decode kernel (K7) and prefill chunks the multi-token kernel (K8);
  with ``sampling_epilogue`` on, each step samples through the fused
  sampling kernel (K9). ``auto`` means on under CUDA. Off gives the gather
  path and the legacy sampler.
- ADAPTERS: every forward carries the adapter tree and a per-row adapter
  index (``models/llama.forward(..., lora_adapter_idx=...)``; row 0 of the
  tree is the all-zero base adapter), so one decode step serves a
  mixed-adapter batch. Static mode (``adapters``, ``checkpoint_path``)
  stacks the named checkpoints once, zero-padded to the largest rank over
  the union of targets; ``--checkpoint_path`` becomes the adapter named
  ``"default"`` (a full-parameter checkpoint swaps the base instead).
  Pooled mode (``adapter_pool > 0``, ``adapters/``) loads adapters into a
  fixed-geometry device pool at runtime: load on miss at admission, pinned
  while a slot decodes, LRU-evicted when full, with an optional host-RAM
  tier (``host_adapter_cache_mb``).
- TENANCY (``tenants``, ``tenancy/``): requests carry a tenant and its
  tier; overcommit preemption takes the lowest tier first (bulk, then
  standard, then pinned), youngest within a tier, and a bulk requester
  never preempts a pinned tenant; pinned tenants' adapters never evict.
  With no directory the victim is the youngest, as without the plane.
- SPECULATIVE DECODING (``spec_draft``, serving/speculative.py): a draft
  (``take:N``, the target's first N layers, or a model path) proposes
  ``spec_k`` tokens (a ``spec_tree`` WxD tree), one target forward over the
  paged or dense cache verifies them, and the acceptance rule keeps a prefix
  plus one token: greedy streams are token-exact, sampled ones
  distribution-exact from the slot's key. Slots run in pending-token form
  and settle before they park. ``spec_mode`` auto backs off to the plain
  pending-form decode when acceptance collapses; off is the plain engine.
- OBSERVABILITY (obs/): the engine records into a shared ``registry``
  (the serving server's): one TTFT/TPOT observe pair per completed request,
  one prefill-chunk observe per chunk, one accept-length observe per
  drafting row of a verify step, and adapter load times. With ``tracing``
  on, each request's scheduler timeline (``Request.mark``: admit, adapter,
  prefill, activate, preempt, resume, export, import, spill, finish) folds
  into a span in ``trace_store`` (``GET /debug/trace/<id>``; ``trace_log_path``
  appends each span to a JSONL file) and the TTFT/TPOT observes carry the
  trace id as an exemplar. The ticks run inside ``record_function`` ranges
  (``dtx_engine_prefill_chunk``, ``dtx_engine_decode``,
  ``dtx_engine_spec_step``, ``dtx_engine_spec_tree``) for a profiler
  window. Tracing off changes no token and no kernel launch.

The scheduler thread owns every piece of slot state; callers only enqueue
requests. The caches are updated in place.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import queue
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from datatunerx_tpu_torch.data.templates import Template, get_template
from datatunerx_tpu_torch.models.llama import forward, init_cache
from datatunerx_tpu_torch.models.lora import (
    DEFAULT_TARGETS,
    LORA_TARGETS,
    lora_scaling,
    target_dims,
)
from datatunerx_tpu_torch.obs.metrics import (
    Registry,
    adapter_load_histogram,
    serving_latency_histograms,
    spec_accept_len_histogram,
)
from datatunerx_tpu_torch.obs.trace import TraceStore, build_request_span
from datatunerx_tpu_torch.ops import prng
from datatunerx_tpu_torch.ops.cuda_sampling import fused_sample
from datatunerx_tpu_torch.ops.paged_attention import (
    POS_SENTINEL,
    BlockAllocator,
    blocks_for_depth,
    init_paged_cache,
    paged_copy_block,
    paged_extract_row,
    paged_insert_row,
    row_trim,
)
from datatunerx_tpu_torch.serving import migration as mig
from datatunerx_tpu_torch.serving import speculative as spec_mod
from datatunerx_tpu_torch.serving.engine import (
    _sample_jit,
    encode_chat_messages,
    nll_impl,
    nll_result,
    prepare_nll_inputs,
    tree_to,
)
from datatunerx_tpu_torch.tenancy.directory import TIER_RANK, load_tenants
from datatunerx_tpu_torch.training.checkpoint import (
    load_raw_state,
    read_manifest,
    saved_steps,
)
from datatunerx_tpu_torch.utils.decoding import DECODE_BUCKET, prepare_prompt
from datatunerx_tpu_torch.utils.model_loader import load_model_and_tokenizer

MAX_STOP = 8  # static per-slot stop-token capacity

# global arrival order: preemption never takes the oldest live request, and
# parked sessions resume before anything younger is admitted
_REQ_SEQ = itertools.count()


class _RetryLater(Exception):
    """A session command that cannot complete this tick but may a later one
    (no free slot, KV blocks exhausted, adapter mid-load): the scheduler
    retries it each tick until its deadline."""


def manifest_lora_scaling(ckpt_root: str) -> Optional[float]:
    """The adapter's alpha / rank scaling that the trainer recorded in the
    run's completion manifest (``<storage>/<run>/manifest.json``, next to
    ``<storage>/<run>/checkpoints``); None when there is no manifest or it
    holds none. Serving with any other value serves another model."""
    run_dir = os.path.dirname(ckpt_root.rstrip("/"))
    try:
        manifest = read_manifest(os.path.dirname(run_dir),
                                 os.path.basename(run_dir))
        val = (manifest or {}).get("lora_scaling")
        return float(val) if val is not None else None
    except (OSError, ValueError, TypeError):
        return None


def load_checkpoint_state(checkpoint_path: str, cfg=None) -> dict:
    """The raw state of one of the port trainer's checkpoints: a step
    directory (``.../checkpoints/<step>``) or the ``checkpoints`` root (its
    newest step), read from ``state.pt`` on the CPU; ``{"lora": ...}`` or
    ``{"params": ...}``, plus the manifest's scaling under ``"_scaling"``.
    A directory holding a ``model.npz`` export gives ``{"params": ...}`` in
    ``cfg``'s layout (f32). The JAX package's Orbax checkpoints are not
    read: the packages cross-load through the export."""
    root = checkpoint_path.rstrip("/")
    if os.path.exists(os.path.join(root, "model.npz")):
        if cfg is None:
            raise ValueError(f"{checkpoint_path} is a model.npz export: "
                             "the model's config is needed to read it")
        import numpy as np

        from datatunerx_tpu_torch.models.convert import params_from_jax
        from datatunerx_tpu_torch.utils.hf_convert import (
            convert_hf_state_dict,
        )

        with np.load(os.path.join(root, "model.npz")) as data:
            sd = dict(data)
        return {"params": params_from_jax(convert_hf_state_dict(sd, cfg), cfg,
                                          device="cpu", dtype=torch.float32)}
    step: Optional[int] = None
    if os.path.basename(root).isdigit():
        step = int(os.path.basename(root))
        root = os.path.dirname(root)
    if step is None:
        steps = saved_steps(root)
        step = steps[-1] if steps else None
    if step is None or step not in saved_steps(root):
        raise FileNotFoundError(f"no checkpoint under {checkpoint_path}")
    state = dict(load_raw_state(root, step))
    state["_scaling"] = manifest_lora_scaling(root)
    return state


def _mode(value, name: str) -> str:
    mode = value if isinstance(value, str) else ("on" if value else "off")
    mode = (mode or "auto").strip().lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{name} must be auto|on|off, got {value!r}")
    return mode


def _resolve_auto(value, name: str, cuda: bool) -> bool:
    mode = _mode(value, name)
    return mode == "on" or (mode == "auto" and cuda)


class _PrefixCache:
    """Host-side LRU of prefilled prompts keyed by (prompt tokens, adapter
    identity: the stack index in static mode, the NAME in pooled mode),
    with a per-adapter token TRIE so ``longest_prefix`` walks at most
    ``len(tokens)`` nodes. The OrderedDict keeps recency and the entries;
    the trie mirrors its key set (terminal nodes point back at the key).

    Entries are dense rows ``{"cache", "logits", "cursor"}`` or, on
    overcommit engines, refcounted BLOCK entries ``{"blocks", "full",
    "rem", "cursor", "logits"}``. ``on_evict`` receives every entry that
    leaves the cache (capacity eviction, same-key replacement), so the
    engine can return block entries' refs to the allocator."""

    def __init__(self, capacity: int, on_evict=None):
        self.capacity = capacity
        self._on_evict = on_evict
        self._d: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()
        # adapter -> trie root; node = [children {tok: node}, terminal key]
        self._roots: Dict[object, list] = {}
        self.evictions = 0
        # the scheduler thread looks up and inserts; the adapter plane's
        # admin threads invalidate (drop_adapter)
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._d)

    def get(self, key):
        with self._lock:
            ent = self._d.get(key)
            if ent is not None:
                self._d.move_to_end(key)
            return ent

    def longest_prefix(self, tokens: tuple, adapter):
        """Longest stored STRICT prefix of ``tokens`` for this adapter: one
        trie descent, the deepest terminal wins."""
        with self._lock:
            node = self._roots.get(adapter)
            if node is None:
                return None, None
            best_key = None
            for i in range(len(tokens) - 1):  # strict: depth < len(tokens)
                node = node[0].get(tokens[i])
                if node is None:
                    break
                if node[1] is not None:
                    best_key = node[1]
            if best_key is None:
                return None, None
            self._d.move_to_end(best_key)
            return best_key, self._d[best_key]

    def put(self, key, ent):
        dropped = []
        with self._lock:
            is_new = key not in self._d
            if not is_new:
                dropped.append(self._d[key])  # same-key replacement
            self._d[key] = ent
            self._d.move_to_end(key)
            if is_new:
                ptoks, adapter = key
                node = self._roots.setdefault(adapter, [{}, None])
                for t in ptoks:
                    node = node[0].setdefault(t, [{}, None])
                node[1] = key
            while len(self._d) > self.capacity:
                old_key, old_ent = self._d.popitem(last=False)
                self._trie_remove(old_key)
                self.evictions += 1
                dropped.append(old_ent)
        # outside the lock: the hook frees allocator blocks under its own
        if self._on_evict is not None:
            for ent in dropped:
                self._on_evict(ent)

    def snapshot_entries(self):
        """MRU-first (key, entry) pairs, recency untouched: the prefix
        tier's publish scan (a point-in-time copy)."""
        with self._lock:
            return list(reversed(list(self._d.items())))

    def pop_lru_block_entry(self):
        """Evict and return the least-recently-used BLOCK entry (None when
        there is none): the overcommit scheduler's first reclamation tier.
        The caller owns the entry's block refs (``on_evict`` is not
        called)."""
        with self._lock:
            for key, ent in self._d.items():
                if ent.get("blocks"):
                    del self._d[key]
                    self._trie_remove(key)
                    self.evictions += 1
                    return ent
        return None

    def drop_adapter(self, adapter):
        """Drop every entry cached under one adapter identity: required when
        an adapter NAME is rebound to other weights (unload, re-register),
        whose cached rows would serve the old weights."""
        dropped = []
        with self._lock:
            for key in [k for k in self._d if k[1] == adapter]:
                dropped.append(self._d.pop(key))
                self._trie_remove(key)
        if self._on_evict is not None:
            for ent in dropped:
                self._on_evict(ent)

    def _trie_remove(self, key):
        ptoks, adapter = key
        root = self._roots.get(adapter)
        if root is None:
            return
        path, node = [root], root
        for t in ptoks:
            node = node[0].get(t)
            if node is None:
                return
            path.append(node)
        node[1] = None
        # prune now-useless nodes bottom-up
        for i in range(len(path) - 1, 0, -1):
            n = path[i]
            if n[0] or n[1] is not None:
                break
            del path[i - 1][0][ptoks[i - 1]]
        if not root[0] and root[1] is None:
            del self._roots[adapter]


def _copy_row(row: Dict, width: int) -> Dict:
    """A fresh dense row of ``width`` lanes holding ``row``'s lanes, the
    rest sentinel-padded. Stored prefix rows stay immutable: the extension
    forward writes into the copy."""
    W = row["k"].shape[2]
    out = {"len": row["len"].clone()}
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in row:
            shape = list(row[key].shape)
            shape[2] = width
            buf = torch.zeros(shape, dtype=row[key].dtype,
                              device=row[key].device)
            buf[:, :, :W] = row[key]
            out[key] = buf
    pos = torch.full((1, width), POS_SENTINEL, dtype=row["pos"].dtype,
                     device=row["pos"].device)
    pos[:, :W] = row["pos"]
    out["pos"] = pos
    return out


class Request:
    def __init__(self, prompt_ids: Sequence[int], max_new_tokens: int,
                 temperature: float, top_p: float, seed: int,
                 stop_ids: Sequence[int], trace_id: str = "",
                 adapter: int = 0, adapter_name: str = "",
                 tenant: str = "", tenant_tier: str = "standard"):
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.stop_ids = list(stop_ids)[:MAX_STOP]
        self.trace_id = trace_id
        self.seq = next(_REQ_SEQ)  # arrival order (preemption fairness)
        # the adapter's device index (stack or pool slot; pooled mode
        # resolves and pins the NAME at admission) and its name
        self.adapter = adapter
        self.adapter_name = adapter_name
        # tenancy: "" = anonymous, scheduled as without the plane; the tier
        # orders overcommit's preemption victims
        self.tenant = tenant
        self.tenant_tier = tenant_tier
        # pooled mode: residency at the FIRST admission attempt (the span's
        # "loaded" flag), and a re-admission retry does not count its
        # lookup twice
        self.adapter_was_resident: Optional[bool] = None
        self.adapter_stats_counted = False
        self.tokens: List[int] = []
        self.stream: "queue.Queue[Optional[int]]" = queue.Queue()
        self.done = threading.Event()
        self.error: Optional[str] = None
        # the request's span timeline: plain attribute writes from the
        # scheduler thread (no locks, no device reads)
        self.t_submit = time.perf_counter()
        self.wall_submit_ms = time.time() * 1e3
        self.timeline: List[tuple] = []  # (perf stamp, event, detail dict)
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None

    def mark(self, event: str, **detail):
        self.timeline.append((time.perf_counter(), event, detail))

    def push(self, token: int):
        now = time.perf_counter()
        if self.first_token_ts is None:
            self.first_token_ts = now
        self.last_token_ts = now
        self.tokens.append(token)
        self.stream.put(token)

    def finish(self, error: Optional[str] = None):
        self.error = error
        self.stream.put(None)
        self.done.set()


class BatchedEngine:
    def __init__(
        self,
        model_path: str,
        checkpoint_path: Optional[str] = None,
        adapters: Optional[Dict[str, str]] = None,  # name -> checkpoint
        adapter_pool: int = 0,  # > 0: pooled adapters, P device slots
        adapter_rank_max: int = 8,  # pool rank ceiling (lower ranks pad)
        adapter_targets: Optional[Sequence[str]] = None,  # pool target set
        template: str = "llama2",
        max_seq_len: int = 1024,
        slots: int = 4,
        decode_chunk: int = 8,
        kv_quant: Optional[str] = None,
        prefix_cache: int = 0,  # LRU entries of reusable prefilled prompts
        kv_block_size: int = 0,
        kv_blocks: Optional[int] = None,
        kv_overcommit: str = "off",  # on: lazy growth + COW + preemption
        paged_kernel: str = "auto",  # paged attention kernels: auto|on|off
        spec_draft: Optional[str] = None,  # draft: take:N | path | preset:
        spec_k: int = 4,  # proposals per verify step (adaptive ceiling)
        spec_mode: str = "auto",  # auto (adaptive) | on (pinned) | off
        spec_tree: Optional[str] = None,  # "WxD" tree drafts (None = chain)
        spec_tree_learned: bool = True,  # learned widths + early exit
        sampling_epilogue: str = "auto",  # fused sampling kernel: auto|on|off
        prefill_chunk: int = 256,
        prefill_token_budget: int = 0,
        tenants=None,  # TenantDirectory / dict / path / inline JSON
        host_adapter_cache_mb: float = 0.0,  # host-RAM adapter tier budget
        registry: Optional[Registry] = None,  # shared /metrics registry
        tracing: bool = True,  # per-request span timelines + trace ring
        trace_ring: int = 256,  # completed traces kept for /debug/trace
        trace_log_path: Optional[str] = None,  # JSONL log of every span
        seed: int = 0,  # preset weights' random init
        device="cuda",
    ):
        self.kv_quant = kv_quant or None
        if self.kv_quant not in (None, "int8"):
            raise ValueError(
                f"unsupported cache quantization {self.kv_quant!r}")
        self.paged = kv_block_size > 0
        self.block_size = int(kv_block_size)
        oc_mode = (kv_overcommit if isinstance(kv_overcommit, str)
                   else ("on" if kv_overcommit else "off"))
        oc_mode = (oc_mode or "off").strip().lower()
        if oc_mode not in ("on", "off"):
            raise ValueError(
                f"kv_overcommit must be on|off, got {kv_overcommit!r}")
        if oc_mode == "on" and not self.paged:
            raise ValueError(
                "--kv_overcommit on requires the paged KV cache "
                "(--kv_block_size > 0)")
        self.overcommit = self.paged and oc_mode == "on"
        if _mode(paged_kernel, "paged_kernel") == "on" and not self.paged:
            raise ValueError(
                "--paged_kernel on requires the paged KV cache "
                "(--kv_block_size > 0)")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "BatchedEngine runs on CUDA by default and no CUDA device "
                    "is visible; pass device='cpu' to run on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        cuda = self.device.type == "cuda"
        self.cfg, self.params, self.tokenizer = load_model_and_tokenizer(
            model_path, dtype=torch.bfloat16, seed=seed, device=self.device)
        self.template: Template = get_template(template, self.tokenizer)
        self.max_seq_len = min(max_seq_len, self.cfg.max_seq_len)
        self.slots = slots
        self.chunk = max(1, decode_chunk)
        self._wake = threading.Event()

        # ---- adapters: checkpoint_path becomes the adapter "default"
        # (unmerged); a full-parameter checkpoint swaps the base instead
        named: Dict[str, str] = dict(adapters or {})
        states: Dict[str, dict] = {}
        if checkpoint_path:
            state = load_checkpoint_state(checkpoint_path, self.cfg)
            if state.get("lora"):
                named.setdefault("default", checkpoint_path)
                states[checkpoint_path] = state
            elif state.get("params"):
                self.params = tree_to(state["params"], self.device,
                                      torch.bfloat16)
        self._static_adapter_ids: Dict[str, int] = {"": 0}  # 0 = base
        self.lora_stack: Optional[tuple] = None
        self.tenants = load_tenants(tenants)
        # per-tenant usage counters, capped: a client-chosen header must not
        # grow them without bound
        self._tenant_lock = threading.Lock()
        self.tenant_stats: Dict[str, Dict[str, int]] = {}
        self._tenant_stats_cap = 1024
        self.adapter_registry = None
        self.adapter_store = None
        if adapter_pool > 0:
            from datatunerx_tpu_torch.adapters import (
                AdapterRegistry,
                AdapterStore,
            )

            self.adapter_store = AdapterStore(
                self.cfg, pool_slots=int(adapter_pool),
                rank_max=int(adapter_rank_max) or 8,
                targets=tuple(adapter_targets or DEFAULT_TARGETS),
                dtype=torch.bfloat16, device=self.device)
            host_tier = None
            if host_adapter_cache_mb and host_adapter_cache_mb > 0:
                from datatunerx_tpu_torch.tenancy import HostAdapterTier

                host_tier = HostAdapterTier(
                    int(float(host_adapter_cache_mb) * 1024 * 1024))
            self.adapter_registry = AdapterRegistry(
                self.adapter_store,
                # bound late: the histogram exists once the registry does
                load_observer=lambda ms: self._h_adapter_load.observe(ms),
                # a resolved load wakes the scheduler, so the waiting head
                # admits at once instead of at the next poll
                on_load_done=self._wake.set, host_tier=host_tier)
            for aname, path in named.items():
                self.adapter_registry.register(aname, path)
            if self.tenants is not None:
                self.adapter_registry.set_pinned(
                    self.tenants.pinned_adapters())
        elif named:
            self._build_adapter_stack(named, states)
        # per-adapter request counts, capped and pruned on unload
        self._adapter_req_lock = threading.Lock()
        self.adapter_requests: Dict[str, int] = {}
        self._adapter_requests_cap = 1024

        self.paged_kernel = self.paged and _resolve_auto(
            paged_kernel, "paged_kernel", cuda)
        if self.paged_kernel:
            import dataclasses

            self.cfg = dataclasses.replace(self.cfg, paged_kernel=True)
        self.sampling_epilogue = "on" if _resolve_auto(
            sampling_epilogue, "sampling_epilogue", cuda) else "off"
        # /metrics' dtx_serving_sampling_epilogue: 2 = the fused kernel (K9)
        self._epilogue_impl = ("kernel" if self.sampling_epilogue == "on"
                               else "off")
        # decode chunks that sampled through the fused epilogue vs the
        # legacy sampler; written by the scheduler thread only
        self.sampling_stats = {"fused_steps": 0, "legacy_steps": 0}

        self._allocator: Optional[BlockAllocator] = None
        if self.paged:
            if self.max_seq_len % self.block_size:
                raise ValueError(
                    f"kv_block_size {self.block_size} must divide "
                    f"max_seq_len {self.max_seq_len}")
            self.blocks_per_slot = self.max_seq_len // self.block_size
            total_blocks = int(kv_blocks or slots * self.blocks_per_slot)
            if total_blocks < self.blocks_per_slot:
                raise ValueError(
                    f"kv_blocks {total_blocks} cannot hold one full-length "
                    f"request ({self.blocks_per_slot} blocks of "
                    f"{self.block_size})")
            self._allocator = BlockAllocator(total_blocks)
            self._cache = init_paged_cache(
                self.cfg, slots, total_blocks, self.block_size,
                self.blocks_per_slot, dtype=torch.bfloat16,
                quantize=self.kv_quant, device=self.device)
        else:
            self._cache = init_cache(
                self.cfg, slots, self.max_seq_len, dtype=torch.bfloat16,
                per_slot=True, quantize=self.kv_quant, device=self.device)
        # chunked prefill runs in bucket-multiple forwards
        self.prefill_chunk = max(
            DECODE_BUCKET,
            -(-int(prefill_chunk) // DECODE_BUCKET) * DECODE_BUCKET)
        budget = max(0, int(prefill_token_budget))
        self.prefill_token_budget = (
            -(-budget // DECODE_BUCKET) * DECODE_BUCKET if budget else 0)

        dev = self.device
        self._logits = torch.zeros((slots, self.cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
        self._pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._remaining = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._top_ps = torch.ones((slots,), dtype=torch.float32, device=dev)
        self._stops = torch.full((slots, MAX_STOP), -1, dtype=torch.int32,
                                 device=dev)
        # each slot's adapter: its row of the stack or pool (0 = base)
        self._adapter_idx = torch.zeros((slots,), dtype=torch.int64,
                                        device=dev)
        # per-slot threefry keys ([S, 2] uint32 on the host, the
        # reference's ``_rng``): PRNGKey(seed) at admission, split once a
        # decode step (ops/prng.py); a parked session carries its key
        self._keys = np.stack([prng.PRNGKey(i) for i in range(slots)])

        self._init_spec(spec_draft, spec_k, spec_mode, spec_tree,
                        spec_tree_learned)
        # ---- overcommit state. _tick_advance: the most cache lanes one
        # scheduler tick consumes per slot (a decode chunk or a verify
        # step); the grower keeps every table that far ahead of its cursor
        # plus the verify write overshoot (0 without a draft)
        self._tick_advance = self.chunk
        if self.spec is not None:
            self._tick_advance = max(self.chunk, self._spec_step_tokens)
        # preempted sessions parked host-side as dtx-kv-session payloads,
        # oldest first; owned by the scheduler thread
        self._preempted: List[dict] = []
        self.preempt_stats: Dict[str, int] = {}
        # high-water mark of admitted sessions, and each finished session's
        # physical block count (its peak: tables only grow)
        self.kv_stats = {"peak_sessions": 0,
                         "session_blocks": collections.deque(maxlen=4096)}
        # per-slot eager-equivalent reserve: the kv_overcommit_ratio
        # numerator
        self._slot_demand: List[int] = [0] * slots

        self._slot_req: List[Optional[Request]] = [None] * slots
        self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        # pooled mode: the adapter NAME each slot pins (released with the
        # slot, so eviction never pulls weights from under a live row)
        self._slot_adapter: List[Optional[str]] = [None] * slots
        self._decode_ready: List[bool] = [False] * slots
        # slot → in-progress chunked-prefill state, in admission order
        self._pending: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._waiting: "queue.Queue[Request]" = queue.Queue()
        # requests that admit BEFORE anything in _waiting, in FIFO order:
        # the pool-starved head, and requests set aside while their adapter
        # loads
        self._waiting_front: "collections.deque[Request]" = collections.deque()
        self._last_adapter_wait: Optional[str] = None  # wait-trace dedupe
        self._admit_wait_reason = ""  # why the last _admit returned False
        self._shutdown = threading.Event()
        self._dead: Optional[str] = None  # set when the scheduler died
        # session commands from admin threads, served by the scheduler
        # first each tick; transient refusals wait in _mig_retry until
        # their deadline
        self._mig_q: "queue.Queue[dict]" = queue.Queue()
        self._mig_retry: List[dict] = []
        # command outcome counts, by command kind
        self.session_stats: Dict[str, Dict[str, int]] = {
            "export": {}, "import": {}}
        self._encode_memo: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._encode_memo_lock = threading.Lock()

        self._prefix = _PrefixCache(
            prefix_cache, on_evict=self._free_prefix_entry
        ) if prefix_cache > 0 else None
        # COW prefix blocks: overcommit engines with a prefix cache store
        # refcounted BLOCK entries that a hit maps into the new slot's table
        self.cow = self.overcommit and self._prefix is not None
        # slot → (prefix-cache key, prompt cursor) of the prompt it holds
        self._slot_key: List[Optional[tuple]] = [None] * slots
        # how admissions were served
        self.prefill_stats = {"full": 0, "reuse": 0, "extend": 0}
        # scheduler-tick trace, for tests and TTFT/TPOT forensics:
        # ("admit", slot, plen, "chunked" | "dense" | "cache" | "cow" |
        # "cow_extend") / ("prefill", slot, ntokens) / ("activate", slot) /
        # ("decode", K) / ("finish", slot) / ("grow", slot, nblocks) /
        # ("preempt", slot, seq) / ("preempt_prefill", slot, seq) /
        # ("resume", slot, cursor) / ("adapter_wait", name); spec engines:
        # ("spec_prime", slot, n) / ("spec_enter", n, epilogue mode) /
        # ("spec", k, rows, batch mode, tree widths | None) /
        # ("spec_settle", slot) / ("decode", K, epilogue mode)
        self.sched_trace: "collections.deque[tuple]" = \
            collections.deque(maxlen=4096)
        # one record per completed request: TTFT and per-token decode time
        # measured on the host clock at the chunk's designed sync point
        self.request_stats: "collections.deque[dict]" = \
            collections.deque(maxlen=4096)
        # shared-registry histograms. Recording is BUFFERED off the hot
        # path: token stamps are attribute writes in Request.push; the
        # observes fire once per completed request (TTFT/TPOT), once per
        # prefill chunk, once per drafting row of a verify step — never
        # per token
        self.registry = registry if registry is not None else Registry()
        (self._h_ttft, self._h_tpot,
         self._h_prefill_chunk) = serving_latency_histograms(self.registry)
        self._h_adapter_load = adapter_load_histogram(self.registry)
        self._h_accept_len = (spec_accept_len_histogram(self.registry)
                              if self.spec is not None else None)
        # per-request span timelines: completed requests land in a bounded
        # ring keyed by trace id (GET /debug/trace/<id>)
        self.tracing = tracing
        self.trace_store = TraceStore(capacity=trace_ring,
                                      jsonl_path=trace_log_path)

        self._thread = threading.Thread(target=self._scheduler, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ block pool
    @property
    def decode_path(self) -> str:
        """How decode attention reads the KV cache: ``kernel`` (the in-place
        paged kernels; their plain versions for CPU tensors), ``gather``
        (the paged gathered view) or ``dense`` (the slots' full rows)."""
        if not self.paged:
            return "dense"
        return "kernel" if self.paged_kernel else "gather"

    @property
    def total_kv_blocks(self) -> Optional[int]:
        """Blocks in the paged pool; None on the dense layout."""
        return self._allocator.num_blocks if self.paged else None

    @property
    def free_kv_blocks(self) -> Optional[int]:
        return self._allocator.free_count if self.paged else None

    @property
    def kv_blocks_reserved(self) -> Optional[int]:
        if self._allocator is None:
            return None
        return self._allocator.num_blocks - self._allocator.free_count

    @property
    def kv_overcommit_ratio(self) -> Optional[float]:
        """Live sessions' EAGER-equivalent block demand over the physical
        pool: above 1.0 the engine has admitted more logical reserve than
        the pool holds. None on the dense layout."""
        if self._allocator is None:
            return None
        demand = sum(self._slot_demand[s] for s in range(self.slots)
                     if self._slot_req[s] is not None)
        return round(demand / max(1, self._allocator.num_blocks), 4)

    @property
    def parked_sessions(self) -> int:
        """Preempted sessions waiting to resume."""
        return len(self._preempted)

    @property
    def kv_cache_bytes(self) -> int:
        """Device bytes of the K/V leaves and, for an int8 cache, their
        scales (the position table and cursors are not counted)."""
        return sum(t.numel() * t.element_size()
                   for name, t in self._cache.items()
                   if name in ("k", "v", "k_scale", "v_scale"))

    def _free_prefix_entry(self, ent: dict):
        """Prefix-cache eviction hook: return a block entry's refs to the
        allocator (dense-row entries hold no pool blocks)."""
        blocks = ent.get("blocks")
        if blocks and self._allocator is not None:
            self._allocator.free(blocks)

    def _count_preempt(self, outcome: str):
        self.preempt_stats[outcome] = self.preempt_stats.get(outcome, 0) + 1

    def _trace(self, *event):
        self.sched_trace.append(event)

    def _table_row(self, blocks: List[int]) -> torch.Tensor:
        row = torch.full((self.blocks_per_slot,), -1, dtype=torch.int32)
        row[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
        return row.to(self.device)

    def _scrub(self, blocks: List[int]):
        """Recycled blocks' positions to the sentinel, BEFORE a table shows
        them to attention."""
        self._cache["pos"][torch.tensor(blocks, device=self.device)] = \
            POS_SENTINEL

    def _alloc_blocks(self, depth: int) -> Optional[List[int]]:
        return self._allocator.alloc(blocks_for_depth(
            depth, self.block_size, overshoot=self._spec_overshoot,
            cap_depth=self.max_seq_len))

    def _reserve_depth(self, cursor: int, max_new: int) -> int:
        """Token depth admission reserves blocks for: the full decode extent
        eagerly, or the context plus one tick's advance when overcommitted
        (the grower keeps the table ahead of the cursor from there)."""
        if self.overcommit:
            return cursor + min(max_new, self._tick_advance)
        return cursor + max_new

    def _eager_demand(self, cursor: int, max_new: int) -> int:
        """Blocks the overcommit-off engine would reserve for a session."""
        return blocks_for_depth(cursor + max_new, self.block_size,
                                overshoot=self._spec_overshoot,
                                cap_depth=self.max_seq_len)

    def _note_admitted(self):
        live = sum(1 for r in self._slot_req if r is not None)
        if live > self.kv_stats["peak_sessions"]:
            self.kv_stats["peak_sessions"] = live

    # ------------------------------------------------------------ admission
    def _take_waiting(self) -> Optional[Request]:
        if self._waiting_front:
            return self._waiting_front.popleft()
        try:
            return self._waiting.get_nowait()
        except queue.Empty:
            return None

    def _requeue_front(self, reqs: List[Request]):
        """Put requests back at the FRONT of the wait order, keeping their
        relative (older-first) order."""
        for req in reversed(reqs):
            self._waiting_front.appendleft(req)

    def _admit_waiting(self):
        # requests whose adapter is mid-load: set aside this pass so younger
        # requests can fill other slots while the checkpoint reads (the
        # load already holds their pool slot, so they cannot starve)
        parked: List[Request] = []
        for slot in range(self.slots):
            if self._slot_req[slot] is not None:
                continue
            while True:
                req = self._take_waiting()
                if req is None:
                    self._requeue_front(parked)
                    return
                if self._preempted and self._preempted[0]["req"].seq < req.seq:
                    # strict FIFO across the park: an older preempted
                    # session resumes before a younger cold request
                    self._requeue_front(parked + [req])
                    return
                try:
                    ok = self._admit(req, slot)
                except Exception as e:  # noqa: BLE001 — fail request, not loop
                    self._complete(req, error=str(e))
                    continue
                if ok:
                    break
                if self._admit_wait_reason == "adapter":
                    parked.append(req)
                    continue
                # KV blocks or adapter slots exhausted: the FIFO head waits
                # (younger requests would take what it waits for)
                self._requeue_front(parked + [req])
                return
        self._requeue_front(parked)

    def _admit(self, req: Request, slot: int) -> bool:
        """Occupy ``slot`` with ``req``, resolving and PINNING its adapter
        first in pooled mode: a miss starts an asynchronous load, and a
        fully pinned pool waits like an exhausted block pool. False = a pool
        (adapter slots or KV blocks) is exhausted; nothing is held."""
        pinned = False
        self._admit_wait_reason = "blocks"
        if self.adapter_registry is not None and req.adapter_name:
            if req.adapter_was_resident is None:
                req.adapter_was_resident = (
                    req.adapter_name in self.adapter_registry.resident())
            idx = self.adapter_registry.acquire(
                req.adapter_name, count_hit=not req.adapter_stats_counted)
            if idx is not None:
                req.adapter_stats_counted = True
            if idx is None:
                loading = self.adapter_registry.describe(
                    req.adapter_name).get("loading", False)
                # mid-load: younger requests may pass (the load holds the
                # head's slot); a fully pinned pool: strict FIFO, or passers
                # could re-pin residents forever and starve the head
                self._admit_wait_reason = ("adapter" if loading
                                           else "adapter_pool")
                if self._last_adapter_wait != req.adapter_name:
                    self._trace("adapter_wait", req.adapter_name)
                    self._last_adapter_wait = req.adapter_name
                return False
            self._last_adapter_wait = None
            pinned = True
            req.adapter = idx
            if self.tracing:
                req.mark("adapter", name=req.adapter_name, slot=idx,
                         loaded=not req.adapter_was_resident)
        try:
            ok = self._admit_slot(req, slot)
        except Exception:
            if pinned:
                self.adapter_registry.release(req.adapter_name)
            raise
        if ok:
            if pinned:
                self._slot_adapter[slot] = req.adapter_name
        elif pinned:
            self.adapter_registry.release(req.adapter_name)
        return ok

    def _prefix_key(self, ids, plen: int, n_prompt: int, akey):
        return (tuple(ids[plen - n_prompt:]), akey)

    def _adapter_cache_key(self, req: Request):
        """The prefix cache's adapter identity: the NAME in pooled mode (a
        pool slot is recycled across evict and reload; cached rows depend
        only on the weights the name binds), the stack index in static
        mode."""
        if self.adapter_registry is not None:
            return req.adapter_name
        return req.adapter

    def _lora_arg(self):
        """The forwards' ``lora`` argument: None (base only), the static
        stack, or the pool's published snapshot (one attribute read, no
        lock on the decode path)."""
        if self.adapter_store is not None:
            return self.adapter_store.tree
        return self.lora_stack

    def _suffix(self, used, n_pref: int) -> dict:
        """The left-padded bucket of prompt tokens past a cached prefix:
        pads carry the sentinel position, real tokens their own."""
        suffix = list(used[n_pref:])
        pad = (-len(suffix)) % DECODE_BUCKET
        eos = self.tokenizer.eos_token_id or 0
        return {"ids": [eos] * pad + suffix,
                "mask": [0] * pad + [1] * len(suffix),
                "positions": [0] * pad + list(range(n_pref, len(used)))}

    def _forward_row(self, row: Dict, ids, mask, positions, adapter: int):
        """One forward of a prompt (or suffix) bucket onto a dense one-row
        cache (scalar cursor), in place, under ``adapter``; returns the
        last token's logits."""
        dev = self.device
        lora = self._lora_arg()
        logits, new = forward(
            self.params, torch.tensor([ids], dtype=torch.int32, device=dev),
            self.cfg,
            positions=torch.tensor([positions], dtype=torch.int32, device=dev),
            attention_mask=torch.tensor([mask], dtype=torch.int32, device=dev),
            cache=row, lora=lora,
            lora_adapter_idx=(torch.tensor([adapter], device=dev)
                              if lora is not None else None),
            compute_dtype=torch.bfloat16)
        row["len"] = new["len"]
        return logits[0, -1].clone()

    def _prefill_row_cached(self, ids, plen: int, n_prompt: int,
                            adapter: int, akey, budget_needed: int):
        """Prefix-cache paths only: ``(logits, dense row, cursor)`` on an
        exact hit (no compute) or a strict-prefix hit (suffix extension over
        a copy of the cached row); None on a miss or with no cache. A cached
        row that sits deeper than this prompt's own plen is used only when
        it still leaves the decode room the cold path would give, so reuse
        never changes the response."""
        if self._prefix is None:
            return None
        used, _ = key = self._prefix_key(ids, plen, n_prompt, akey)
        need = min(budget_needed, self.max_seq_len - plen)
        ent = self._prefix.get(key)
        # no_reuse entries (logits-free prefix imports) carry no logits:
        # they serve strict-prefix extension only
        if (ent is not None and not ent.get("no_reuse")
                and self.max_seq_len - ent["cursor"] >= need):
            self.prefill_stats["reuse"] += 1
            return ent["logits"], ent["cache"], ent["cursor"]
        pkey, pent = self._prefix.longest_prefix(used, akey)
        if pent is not None:
            sfx = self._suffix(used, len(pkey[0]))
            cursor = pent["cursor"] + len(sfx["ids"])
            if self.max_seq_len - cursor >= need:
                row = _copy_row(pent["cache"], self.max_seq_len)
                row_logits = self._forward_row(
                    row, sfx["ids"], sfx["mask"], sfx["positions"], adapter)
                self.prefill_stats["extend"] += 1
                self._prefix.put(key, {"cache": row, "logits": row_logits,
                                       "cursor": cursor})
                return row_logits, row, cursor
        return None

    def _prefill_row(self, ids, mask, positions, plen: int, n_prompt: int,
                     adapter: int, akey, budget_needed: int = 1):
        """``(last-token logits, dense row, cursor)`` for a prompt, through
        the prefix cache when there is one: exact hit = no compute, prefix
        hit = suffix extension, miss = full prefill (then stored)."""
        hit = self._prefill_row_cached(ids, plen, n_prompt, adapter, akey,
                                       budget_needed)
        if hit is not None:
            return hit
        row = init_cache(self.cfg, 1, self.max_seq_len, dtype=torch.bfloat16,
                         quantize=self.kv_quant, device=self.device)
        row_logits = self._forward_row(row, ids, mask, positions, adapter)
        self.prefill_stats["full"] += 1
        if self._prefix is not None:
            self._prefix.put(self._prefix_key(ids, plen, n_prompt, akey),
                             {"cache": row, "logits": row_logits,
                              "cursor": plen})
        return row_logits, row, plen

    def _admit_slot(self, req: Request, slot: int) -> bool:
        """Occupy ``slot`` with ``req``. Dense: prefill monolithically (or
        through the prefix cache) and arm the slot at once. Paged: a prefix
        hit scatters its row into freshly reserved blocks (COW engines map
        shared blocks instead); a cold prompt reserves its blocks (False =
        pool exhausted; the request stays queued), installs its table,
        scrubs the blocks' recycled positions to the sentinel (chunked
        prefill reveals the whole table to attention before every lane is
        written), rewinds the cursor and registers for chunked prefill."""
        ids, mask, positions, plen, n_prompt, max_new, _ = prepare_prompt(
            req.prompt_ids, self.tokenizer.eos_token_id,
            self.max_seq_len, req.max_new_tokens)
        # the kept (un-padded) prompt: what the draft prefills when this
        # slot joins speculative decoding
        req.spec_prime_ids = ids[plen - n_prompt:]
        akey = self._adapter_cache_key(req)
        # chunked prefill (cold, or a COW suffix) reads the slot's index
        self._adapter_idx[slot] = req.adapter
        if not self.paged:
            row_logits, row, cursor = self._prefill_row(
                ids, mask, positions, plen, n_prompt, req.adapter, akey,
                budget_needed=max_new)
            # copy the row — K/V, scales and positions, sentinel lanes
            # included, which scrubs what the slot's last request left
            for name in ("k", "v", "k_scale", "v_scale"):
                if name in self._cache:
                    self._cache[name][:, slot] = row[name][:, 0]
            self._cache["pos"][slot] = row["pos"][0]
            # decode continues from the row's real KV depth (a reused row
            # can sit deeper than this request's plen)
            self._cache["len"][slot] = cursor
            self._slot_req[slot] = req
            self._note_admitted()
            self._trace("admit", slot, plen, "dense")
            if self.tracing:
                req.mark("admit", slot=slot, plen=plen, mode="dense")
            self._arm_slot(slot, req, row_logits, cursor, n_prompt, max_new)
            return True
        if self.cow:
            handled = self._admit_cow(req, slot, ids, plen, n_prompt, max_new,
                                      akey)
            if handled is not None:
                return handled
        else:
            hit = self._prefill_row_cached(ids, plen, n_prompt, req.adapter,
                                           akey, budget_needed=max_new)
            if hit is not None:
                row_logits, row, cursor = hit
                max_new = max(1, min(max_new, self.max_seq_len - cursor))
                blocks = self._alloc_blocks(
                    self._reserve_depth(cursor, max_new))
                if blocks is None:
                    return False
                try:
                    # scrub first: stored rows are trimmed to their cursor,
                    # so the insert does not cover the whole table
                    self._scrub(blocks)
                    paged_insert_row(self._cache, slot,
                                     self._table_row(blocks), row)
                    self._cache["len"][slot] = cursor
                except Exception:
                    self._allocator.free(blocks)
                    raise
                self._slot_blocks[slot] = blocks
                self._slot_req[slot] = req
                self._slot_demand[slot] = self._eager_demand(cursor, max_new)
                self._note_admitted()
                self._trace("admit", slot, plen, "cache")
                if self.tracing:
                    req.mark("admit", slot=slot, plen=plen, mode="cache")
                self._arm_slot(slot, req, row_logits, cursor, n_prompt,
                               max_new)
                return True
        blocks = self._alloc_blocks(self._reserve_depth(plen, max_new))
        if blocks is None:
            return False
        try:
            self._cache["block_tables"][slot] = self._table_row(blocks)
            self._scrub(blocks)
            self._cache["len"][slot] = 0
        except Exception:
            self._allocator.free(blocks)
            raise
        self._slot_blocks[slot] = blocks
        self._slot_req[slot] = req
        self._decode_ready[slot] = False
        self._slot_demand[slot] = self._eager_demand(plen, max_new)
        self._pending[slot] = {
            "req": req, "ids": ids, "mask": mask, "positions": positions,
            "plen": plen, "n_prompt": n_prompt, "max_new": max_new, "done": 0,
            "base": 0, "key": self._prefix_key(ids, plen, n_prompt, akey),
        }
        self._note_admitted()
        self._trace("admit", slot, plen, "chunked")
        if self.tracing:
            req.mark("admit", slot=slot, plen=plen, mode="chunked")
        return True

    # ------------------------------------------------- COW prefix blocks
    def _admit_cow(self, req: Request, slot: int, ids, plen: int,
                   n_prompt: int, max_new: int, akey) -> Optional[bool]:
        """Overcommit admission through the prefix cache: an exact hit maps
        the entry's refcounted blocks into this slot's table and arms decode
        (no prefill); a strict-prefix hit maps the shared prefix and
        chunk-prefills only the suffix, in place, from the cached cursor.
        True = admitted, False = blocks exhausted (the FIFO head waits),
        None = no usable entry (cold path). The decode-room gates are the
        dense-row path's."""
        used, _ = key = self._prefix_key(ids, plen, n_prompt, akey)
        need = min(max_new, self.max_seq_len - plen)
        ent = self._prefix.get(key)
        if (ent is not None and ent.get("blocks") is not None
                and not ent.get("no_reuse")
                and self.max_seq_len - ent["cursor"] >= need):
            m = max(1, min(max_new, self.max_seq_len - ent["cursor"]))
            ok = self._cow_map(req, slot, ent, n_prompt, m, suffix=None,
                               key=key)
            if ok:
                self.prefill_stats["reuse"] += 1
                self._trace("admit", slot, plen, "cow")
                if self.tracing:
                    req.mark("admit", slot=slot, plen=plen, mode="cow")
            return ok
        pkey, pent = self._prefix.longest_prefix(used, akey)
        if pent is not None and pent.get("blocks") is not None:
            sfx = self._suffix(used, len(pkey[0]))
            cursor = pent["cursor"] + len(sfx["ids"])
            if self.max_seq_len - cursor >= need:
                ok = self._cow_map(req, slot, pent, n_prompt, max_new,
                                   suffix=sfx, key=key)
                if ok:
                    self.prefill_stats["extend"] += 1
                    self._trace("admit", slot, plen, "cow_extend")
                    if self.tracing:
                        req.mark("admit", slot=slot, plen=plen,
                                 mode="cow_extend")
                return ok
        return None

    def _cow_map(self, req: Request, slot: int, ent: dict, n_prompt: int,
                 max_new: int, suffix: Optional[dict], key) -> bool:
        """Install a block entry into ``slot``: incref and map its full
        blocks, copy its partial tail block (the at-most-once COW event:
        decode only appends at the cursor, which sits inside that block),
        allocate fresh blocks for the suffix and decode extent, and arm
        decode (exact hit) or register the suffix for chunked prefill from
        the base cursor. False = the pool cannot cover the fresh blocks;
        nothing is held."""
        base = ent["cursor"]
        full, rem = ent["full"], ent["rem"]
        shared = list(ent["blocks"][:full])
        final = base + (len(suffix["ids"]) if suffix else 0)
        target = blocks_for_depth(
            self._reserve_depth(final, max_new), self.block_size,
            overshoot=self._spec_overshoot, cap_depth=self.max_seq_len)
        own = self._allocator.alloc(target - full)  # >= 1: max_new >= 1
        if own is None:
            return False
        self._allocator.incref(shared)
        blocks = shared + own
        try:
            self._scrub(own)
            if rem:
                paged_copy_block(self._cache, ent["blocks"][full], own[0],
                                 rem)
            self._cache["block_tables"][slot] = self._table_row(blocks)
            self._cache["len"][slot] = base
        except Exception:
            self._allocator.free(blocks)
            raise
        self._slot_blocks[slot] = blocks
        self._slot_req[slot] = req
        self._slot_demand[slot] = self._eager_demand(final, max_new)
        self._slot_key[slot] = (key, final)
        self._note_admitted()
        if suffix is None:
            self._arm_slot(slot, req, ent["logits"], base, n_prompt, max_new)
        else:
            self._decode_ready[slot] = False
            self._pending[slot] = {
                "req": req, "ids": suffix["ids"], "mask": suffix["mask"],
                "positions": suffix["positions"],
                "plen": len(suffix["ids"]), "n_prompt": n_prompt,
                "max_new": max_new, "done": 0, "key": key, "base": base,
            }
        return True

    def _cow_store(self, slot: int, key, cursor: int, logits) -> bool:
        """Publish the slot's first ``cursor`` lanes as a refcounted block
        entry: full blocks are shared as they are (lanes before the cursor
        never change again), the partial tail block is copied so the
        slot's later writes cannot leak into the entry. False when the pool
        has no block for the tail copy (serving beats caching)."""
        full, rem = divmod(cursor, self.block_size)
        blocks = self._slot_blocks[slot]
        if len(blocks) < full + (1 if rem else 0):
            return False
        ent_blocks = list(blocks[:full])
        if rem:
            tail = self._allocator.alloc(1)
            if tail is None:
                return False
            paged_copy_block(self._cache, blocks[full], tail[0], rem)
            ent_blocks.append(tail[0])
        self._allocator.incref(blocks[:full])
        ent = {"blocks": ent_blocks, "full": full, "rem": rem,
               "cursor": cursor, "logits": logits}
        self._prefix.put(key, ent)
        return True

    # ------------------------------------------------------ chunked prefill
    def _prefill_chunk_fn(self, slot: int, ids, mask, positions):
        """One chunk of a slot's prompt written straight into its blocks of
        the SHARED pool (a one-row view of the cursor and table). Returns the
        chunk's last-token logits [V]."""
        dev = self.device
        view = dict(self._cache)
        view["len"] = self._cache["len"][slot:slot + 1]
        view["block_tables"] = self._cache["block_tables"][slot:slot + 1]
        lora = self._lora_arg()
        logits, new = forward(
            self.params, torch.tensor([ids], dtype=torch.int32, device=dev),
            self.cfg,
            positions=torch.tensor([positions], dtype=torch.int32, device=dev),
            attention_mask=torch.tensor([mask], dtype=torch.int32, device=dev),
            cache=view, lora=lora,
            lora_adapter_idx=(self._adapter_idx[slot:slot + 1]
                              if lora is not None else None),
            compute_dtype=torch.bfloat16)
        self._cache["len"][slot:slot + 1] = new["len"]
        return logits[0, -1]

    def _prefill_tick(self):
        """Spend at most ``prefill_token_budget`` prompt tokens on pending
        chunked prefills (admission order), then yield back to decode. A
        budget of 0 prefills every pending prompt to completion."""
        if not self._pending:
            return
        budget = self.prefill_token_budget or float("inf")
        spent = 0
        for slot in list(self._pending.keys()):
            st = self._pending[slot]
            req = st["req"]
            while spent < budget:
                c = int(min(self.prefill_chunk, st["plen"] - st["done"],
                            budget - spent))
                lo = st["done"]
                t0 = time.perf_counter()
                try:
                    with record_function("dtx_engine_prefill_chunk"):
                        logits = self._prefill_chunk_fn(
                            slot, st["ids"][lo:lo + c],
                            st["mask"][lo:lo + c],
                            st["positions"][lo:lo + c])
                except Exception as e:  # noqa: BLE001 — fail request, not loop
                    self._release_slot(slot)
                    self._complete(req, error=str(e))
                    break
                # wall time as the scheduler sees it: on CUDA the chunk's
                # dispatch (no sync is added to make it "exact")
                self._h_prefill_chunk.observe(
                    (time.perf_counter() - t0) * 1e3)
                st["done"] += c
                spent += c
                self._trace("prefill", slot, c)
                if self.tracing:
                    req.mark("prefill", slot=slot, tokens=c)
                if st["done"] >= st["plen"]:
                    self._finish_prefill(slot, st, logits)
                    break
            if spent >= budget:
                break

    def _finish_prefill(self, slot: int, st: dict, row_logits):
        """Arm a chunk-prefilled slot and publish its prompt to the prefix
        cache. A COW suffix prefill started at the shared prefix's cursor,
        so the decode extent is measured from the FINAL cursor."""
        del self._pending[slot]
        cursor = st["base"] + st["plen"]
        self._arm_slot(slot, st["req"], row_logits, cursor, st["n_prompt"],
                       st["max_new"])
        if st["key"] is None:
            # an imported mid-prefill tail: no cold prefill, no entry
            self._trace("activate", slot)
            if self.tracing:
                st["req"].mark("activate", slot=slot)
            return
        if not st["base"]:
            self.prefill_stats["full"] += 1  # extensions counted at admission
        self._slot_key[slot] = (st["key"], cursor)
        if self._prefix is not None:
            row_logits = row_logits.clone()
            if self.cow:
                self._cow_store(slot, st["key"], cursor, row_logits)
            else:
                # the slot's blocks as a dense row trimmed to the cursor
                row = paged_extract_row(self._cache, slot, cursor,
                                        width=cursor)
                self._prefix.put(st["key"], {"cache": row,
                                             "logits": row_logits,
                                             "cursor": cursor})
        self._trace("activate", slot)
        if self.tracing:
            st["req"].mark("activate", slot=slot)

    def _arm_slot(self, slot: int, req: Request, row_logits, cursor: int,
                  n_prompt: int, max_new: int):
        """Set a prefilled slot's decode state: its last-token logits, rope
        position, token budget (clamped to the room left after ``cursor``
        cache lanes), sampling parameters, stop ids and threefry key."""
        max_new = max(1, min(max_new, self.max_seq_len - cursor))
        stop_row = torch.full((MAX_STOP,), -1, dtype=torch.int32)
        stop_row[:len(req.stop_ids)] = torch.tensor(req.stop_ids,
                                                    dtype=torch.int32)
        self._logits[slot] = row_logits
        self._pos[slot] = n_prompt
        self._remaining[slot] = max_new
        self._active[slot] = True
        self._temps[slot] = float(req.temperature)
        self._top_ps[slot] = float(req.top_p)
        self._stops[slot] = stop_row.to(self.device)
        self._adapter_idx[slot] = req.adapter
        self._keys[slot] = prng.PRNGKey(req.seed)
        self._decode_ready[slot] = True

    # --------------------------------------------- overcommit: grow/preempt
    def _grow_tick(self):
        """On-demand block growth, between prefill and decode: keep every
        decode-ready slot's table covering the lanes the next tick can write.
        A slot the pool cannot serve, even after reclaiming prefix entries
        and preempting younger sessions, parks ITSELF — unless it is the
        oldest live session, which is never preempted and claims what
        reclamation frees (the forward-progress guarantee)."""
        if not self.overcommit:
            return
        ready = [s for s in range(self.slots)
                 if self._decode_ready[s] and self._slot_req[s] is not None]
        if not ready:
            return
        # the tick's designed sync: the cursors and budgets, one transfer
        lens, rem = torch.stack(
            (self._cache["len"], self._remaining)).cpu().tolist()
        ready.sort(key=lambda s: self._slot_req[s].seq)
        for slot in ready:
            req = self._slot_req[slot]
            if req is None:
                continue  # preempted by an older slot's reclaim this pass
            advance = min(self._tick_advance, max(1, rem[slot]))
            depth = min(lens[slot] + advance + self._spec_overshoot,
                        self.max_seq_len)
            need = (blocks_for_depth(depth, self.block_size)
                    - len(self._slot_blocks[slot]))
            while need > 0:
                got = self._allocator.alloc(need)
                if got is not None:
                    self._install_growth(slot, got)
                    break
                if self._reclaim_for(req):
                    continue
                if not self._is_oldest_live(req):
                    self._preempt_slot(slot)
                break

    def _is_oldest_live(self, req: Request) -> bool:
        seqs = [r.seq for r in self._slot_req if r is not None]
        return bool(seqs) and req.seq == min(seqs)

    def _reclaim_for(self, req: Request) -> bool:
        """Free blocks for ``req``'s growth, cheapest casualty first: (1) an
        LRU prefix-cache block entry, (2) the youngest strictly-younger
        decode session (it parks and resumes token for token), (3) the
        youngest strictly-younger chunk-prefilling request (incomplete KV
        cannot park: it re-queues cold). False = nothing younger is left."""
        if self._prefix is not None:
            ent = self._prefix.pop_lru_block_entry()
            if ent is not None:
                self._allocator.free(ent["blocks"])
                return True
        victims = [s for s in range(self.slots)
                   if self._decode_ready[s]
                   and self._slot_req[s] is not None
                   and self._slot_req[s].seq > req.seq]
        victims = self._tenant_filter_victims(req, victims, self._slot_req)
        if victims:
            self._preempt_slot(self._pick_victim(victims, self._slot_req))
            return True
        pend = {s: self._pending[s]["req"] for s in self._pending
                if self._pending[s]["req"].seq > req.seq}
        pend_slots = self._tenant_filter_victims(req, list(pend), pend)
        if pend_slots:
            self._unadmit_pending(self._pick_victim(pend_slots, pend))
            return True
        return False

    def _tenant_filter_victims(self, req: Request, slots, req_of):
        """A BULK-tier requester never preempts a pinned tenant's session.
        No directory, or a requester of another tier, passes the victims
        through as they are."""
        if self.tenants is None or req.tenant_tier != "bulk":
            return slots
        return [s for s in slots if req_of[s].tenant_tier != "pinned"]

    def _pick_victim(self, slots, req_of):
        """Which victim pays: with no directory the youngest; with one the
        lowest tier first (bulk before standard before pinned), youngest
        within the tier."""
        if self.tenants is None:
            return max(slots, key=lambda s: req_of[s].seq)
        return min(slots, key=lambda s: (
            TIER_RANK.get(req_of[s].tenant_tier, 1), -req_of[s].seq))

    def _install_growth(self, slot: int, new_blocks: List[int]):
        blocks = self._slot_blocks[slot]
        blocks.extend(new_blocks)
        # scrub the recycled blocks BEFORE the table reveals them
        self._scrub(new_blocks)
        self._cache["block_tables"][slot] = self._table_row(blocks)
        self._trace("grow", slot, len(new_blocks))

    @staticmethod
    def _session_fields(req: Request) -> dict:
        """A request's host fields as a session payload carries them."""
        return {"trace_id": req.trace_id, "adapter": req.adapter_name,
                "prompt_ids": list(req.prompt_ids),
                "tokens": list(req.tokens),
                "max_new_tokens": req.max_new_tokens,
                "temperature": req.temperature, "top_p": req.top_p,
                "seed": req.seed, "stop_ids": list(req.stop_ids)}

    def _slot_row(self, slot: int, cursor: int) -> Dict:
        """The slot's KV as a dense row: on the paged layout its live blocks
        gathered (bucket-rounded width), on the dense layout its row."""
        if self.paged:
            w = min(-(-max(1, cursor) // DECODE_BUCKET) * DECODE_BUCKET,
                    self.max_seq_len)
            return paged_extract_row(self._cache, slot, cursor, width=w)
        return {name: (t[slot:slot + 1] if name == "pos"
                       else t[:, slot:slot + 1])
                for name, t in self._cache.items()
                if name in ("k", "v", "k_scale", "v_scale", "pos")}

    def _export_slot(self, slot: int, req: Request, wire: Optional[str],
                     b64: bool = True) -> dict:
        """The slot's decode session as a dtx-kv-session payload: its KV
        prefix, last-token logits, cursor, position, budget and threefry
        key (``b64=False``: host numpy bodies, for preemption parking), plus
        the spec controller's learned state on a spec engine."""
        # the export's designed sync: the slot's scalar decode state
        cursor, pos, remaining = torch.stack(
            (self._cache["len"][slot], self._pos[slot],
             self._remaining[slot])).cpu().tolist()
        payload = mig.build_payload(
            self.cfg, self.kv_quant, self._session_fields(req),
            self._slot_row(slot, cursor), cursor, pos, remaining,
            self._keys[slot], self._logits[slot], wire=wire, b64=b64)
        if self.spec is not None:
            payload["spec"] = self.spec_ctrl.export_slot_state(slot)
        return payload

    def _export_prefill_slot(self, slot: int, st: dict,
                             wire: Optional[str]) -> dict:
        """A mid-chunked-prefill slot's payload: the KV written so far
        (``base + done`` lanes) and a ``pending`` document holding the
        prompt tail. Its rng and logits are placeholders: the importer arms
        decode from the seed when the tail is done, as this engine would."""
        req = st["req"]
        done = int(st["done"])
        cursor = int(st["base"]) + done
        payload = mig.build_payload(
            self.cfg, self.kv_quant, self._session_fields(req),
            self._slot_row(slot, cursor), cursor, st["n_prompt"],
            st["max_new"], np.zeros(2, np.uint32),
            np.zeros((self.cfg.vocab_size,), np.float32), wire=wire)
        payload["pending"] = {
            "ids": [int(t) for t in st["ids"][done:]],
            "mask": [int(m) for m in st["mask"][done:]],
            "positions": [int(p) for p in st["positions"][done:]],
            "n_prompt": int(st["n_prompt"]), "max_new": int(st["max_new"]),
            "base": int(st["base"]), "done": done,
        }
        return payload

    def _deactivate(self, slot: int, note_session: bool = True):
        """Release a slot whose session left while still ACTIVE on the
        device: clear its mask and budget too, or the next chunk would
        sample it and write through the next tenant's table."""
        self._release_slot(slot, note_session=note_session)
        self._active[slot] = False
        self._remaining[slot] = 0

    def _preempt_slot(self, slot: int):
        """Park a decode session host-side and release everything it held.
        The Request stays live (same stream, same done event): resume
        re-installs the KV into a fresh slot and keeps pushing tokens to
        the same consumer — no re-prefill, nothing dropped."""
        req = self._slot_req[slot]
        if self.spec is not None and self._spec_form[slot]:
            self._spec_settle_slot(slot)  # the row format is logits form
        payload = self._export_slot(slot, req, None, b64=False)
        self._deactivate(slot, note_session=False)
        self._preempted.append({"payload": payload, "req": req})
        self._preempted.sort(key=lambda e: e["req"].seq)
        self._count_preempt("exported")
        self._trace("preempt", slot, req.seq)
        if self.tracing:
            req.mark("preempt", slot=slot)

    def _unadmit_pending(self, slot: int):
        """Roll a chunk-prefilling admission back to the cold queue at its
        FIFO position: its KV is incomplete, so it cannot park."""
        req = self._pending[slot]["req"]
        self._release_slot(slot, note_session=False)
        self._waiting_front = collections.deque(
            sorted([*self._waiting_front, req], key=lambda r: r.seq))
        self._count_preempt("requeued_prefill")
        self._trace("preempt_prefill", slot, req.seq)
        if self.tracing:
            req.mark("preempt", slot=slot, kind="prefill")

    def _resume_preempted_tick(self):
        """Re-admit parked sessions, oldest first, ahead of the cold queue;
        a head that cannot resume yet holds everything behind it, and so
        does a head leased to a peer-spill coordinator until its hold is
        dropped, released or expires."""
        while self._preempted:
            entry = self._preempted[0]
            if entry.get("hold_until", 0.0) > time.monotonic():
                return
            try:
                ok = self._resume_one(entry)
            except Exception as e:  # noqa: BLE001 — fail the session, not the loop
                self._preempted.pop(0)
                self._count_preempt("error")
                self._complete(entry["req"], error=str(e))
                continue
            if not ok:
                return
            self._preempted.pop(0)

    def _free_slot(self) -> Optional[int]:
        return next((i for i in range(self.slots)
                     if self._slot_req[i] is None), None)

    def _install_session(self, slot: int, blocks: Optional[List[int]],
                         payload: dict, req: Request, cursor: int, pos: int,
                         remaining: int):
        """Scatter a payload's KV row into ``slot`` (its fresh ``blocks``
        on the paged layout: the row's sentinel lanes scrub them) and arm
        decode from its logits, position, budget and LIVE threefry key.
        On a failure the slot's table and mask are cleared again; the
        caller frees what it allocated."""
        try:
            row = mig.unpack_kv_row(payload["kv"], self.max_seq_len,
                                    self.kv_quant, device=self.device)
            if self.paged:
                paged_insert_row(self._cache, slot, self._table_row(blocks),
                                 row)
            else:
                for name in ("k", "v", "k_scale", "v_scale"):
                    if name in self._cache:
                        self._cache[name][:, slot] = row[name][:, 0]
                self._cache["pos"][slot] = row["pos"][0]
            self._cache["len"][slot] = cursor
            self._arm_slot(slot, req, mig.unpack_logits(
                payload, self.cfg.vocab_size, device=self.device), cursor,
                pos, remaining)
            # token-exact resume: the slot's LIVE key, not the seed's
            self._keys[slot] = np.asarray(payload["rng"], dtype=np.uint32)
        except Exception:
            if self.paged:
                self._cache["block_tables"][slot] = -1
            self._active[slot] = False
            self._decode_ready[slot] = False
            raise

    def _resume_one(self, entry: dict) -> bool:
        req, payload = entry["req"], entry["payload"]
        slot = self._free_slot()
        if slot is None:
            return False
        name = req.adapter_name
        pinned = False
        if name and self.adapter_registry is not None:
            # the pool slot may have changed while the session was parked
            idx = self.adapter_registry.acquire(name, count_hit=False)
            if idx is None:
                return False  # mid-load or pool pinned: retry next tick
            req.adapter, pinned = idx, True
        cursor, remaining = payload["cursor"], payload["remaining"]
        blocks = self._alloc_blocks(self._reserve_depth(cursor, remaining))
        if blocks is None and self._prefix is not None:
            ent = self._prefix.pop_lru_block_entry()
            if ent is not None:
                self._allocator.free(ent["blocks"])
                blocks = self._alloc_blocks(
                    self._reserve_depth(cursor, remaining))
        if blocks is None:
            if pinned:
                self.adapter_registry.release(name)
            return False
        try:
            self._install_session(slot, blocks, payload, req, cursor,
                                  payload["pos"], remaining)
        except Exception:
            self._allocator.free(blocks)
            if pinned:
                self.adapter_registry.release(name)
            raise
        if pinned:
            self._slot_adapter[slot] = name
        self._slot_blocks[slot] = blocks
        self._slot_req[slot] = req
        self._slot_demand[slot] = self._eager_demand(cursor, remaining)
        self._note_admitted()
        self._count_preempt("resumed")
        self._trace("resume", slot, cursor)
        if self.tracing:
            req.mark("resume", slot=slot, cursor=cursor)
        return True

    # ------------------------------------------------- session migration
    def export_sessions(self, slots: Optional[Sequence[int]] = None,
                        wire_quant: Optional[str] = None,
                        timeout_s: float = 30.0,
                        include_prefill: bool = False) -> dict:
        """Serialize every in-flight decode session (or just ``slots``) into
        dtx-kv-session payloads and finish the source requests with the
        migrated marker. Slots mid-chunked-prefill are skipped (they finish
        in place), unless ``include_prefill``: then their payload carries
        the KV written so far and a ``pending`` prompt tail. A full export
        also takes the parked sessions no spill coordinator holds. Returns
        ``{"sessions": [...], "skipped": [{"slot", "reason"}]}``."""
        return self._mig_call({"kind": "export",
                               "slots": (None if slots is None
                                         else [int(s) for s in slots]),
                               "wire": wire_quant,
                               "prefill": bool(include_prefill)}, timeout_s)

    def import_session(self, payload: dict, timeout_s: float = 30.0,
                       wait_s: float = 10.0) -> dict:
        """Admit an exported session (from either package) and resume it:
        KV scattered into fresh blocks (or the slot's dense row), decode
        state and threefry key restored, so greedy and seeded streams go on
        token for token. No free slot, no blocks or an adapter mid-load is
        retried each tick until ``wait_s``; every refusal raises
        ValueError. The meta holds ``"_request"`` (for ``resume_stream``)
        and ``text_so_far``, the detokenized tail."""
        return self._mig_call(
            {"kind": "import", "payload": payload,
             "deadline": time.monotonic() + wait_s}, timeout_s)

    def hold_parked(self, max_sessions: int = 4, hold_s: float = 10.0,
                    timeout_s: float = 30.0) -> dict:
        """Phase 1 of a peer spill: lease up to ``max_sessions`` parked
        payloads for ``hold_s`` seconds. A held head resumes nowhere and
        still keeps younger cold requests waiting. Returns ``{"sessions":
        [{"trace_id", "seq", "cursor", "remaining", "payload"}], "parked":
        n}``."""
        return self._mig_call({"kind": "hold_parked",
                               "max_sessions": int(max_sessions),
                               "hold_s": float(hold_s)}, timeout_s)

    def drop_parked(self, trace_ids: Sequence[str],
                    timeout_s: float = 30.0) -> dict:
        """Phase 2, success: a peer imported these parked sessions; drop
        them and finish their requests with the migrated marker."""
        return self._mig_call({"kind": "drop_parked",
                               "trace_ids": [str(t) for t in trace_ids]},
                              timeout_s)

    def release_parked(self, trace_ids: Sequence[str],
                       timeout_s: float = 30.0) -> dict:
        """Phase 2, failure: clear the holds so the sessions resume here."""
        return self._mig_call({"kind": "release_parked",
                               "trace_ids": [str(t) for t in trace_ids]},
                              timeout_s)

    def export_prefix_entries(self, exclude: Optional[Sequence[str]] = None,
                              max_entries: int = 4,
                              wire_quant: Optional[str] = None,
                              timeout_s: float = 30.0) -> dict:
        """Up to ``max_entries`` prefix-cache entries, most recent first, as
        dtx-kv-prefix payloads, skipping the fingerprints in ``exclude``.
        The entries stay cached. Returns ``{"entries": [...]}``."""
        return self._mig_call({"kind": "export_prefix",
                               "exclude": set(exclude or ()),
                               "max_entries": int(max_entries),
                               "wire": wire_quant}, timeout_s)

    def import_prefix_entry(self, payload: dict, timeout_s: float = 30.0,
                            wait_s: float = 5.0) -> dict:
        """Install a dtx-kv-prefix payload as a local prefix-cache entry,
        so the next prompt on that prefix admits with no prefill chunk.
        A block shortage is retried until ``wait_s``; a signature mismatch,
        an unknown adapter or a disabled prefix cache raises ValueError."""
        return self._mig_call(
            {"kind": "import_prefix", "payload": payload,
             "deadline": time.monotonic() + wait_s}, timeout_s)

    def resume_stream(self, req: Request):
        """An imported session's text deltas past its migrated tail, as
        decode produces them."""
        acc = list(req.tokens[:getattr(req, "resume_base", 0)])
        sent = (self.tokenizer.decode(acc, skip_special_tokens=True)
                if acc else "")
        while True:
            t = req.stream.get()
            if t is None:
                break
            acc.append(t)
            text = self.tokenizer.decode(acc, skip_special_tokens=True)
            if len(text) > len(sent) and not text.endswith("�"):
                yield text[len(sent):]
                sent = text
        if req.error:
            raise RuntimeError(req.error)

    def adapter_catalog(self) -> Dict[str, str]:
        """Registered adapter name → checkpoint path (pooled mode only)."""
        if self.adapter_registry is None:
            return {}
        return {n: self.adapter_registry.describe(n)["checkpoint"]
                for n in self.adapter_registry.names()}

    def _mig_call(self, cmd: dict, timeout_s: float):
        if self._shutdown.is_set() or self._dead:
            raise RuntimeError(self._dead or "engine is shut down")
        cmd["_done"] = threading.Event()
        self._mig_q.put(cmd)
        self._wake.set()
        if not cmd["_done"].wait(timeout_s):
            raise TimeoutError(
                f"engine did not service session {cmd['kind']} within "
                f"{timeout_s}s")
        if cmd.get("_error"):
            if cmd.get("_refused"):
                raise ValueError(cmd["_error"])
            raise RuntimeError(cmd["_error"])
        return cmd["_result"]

    def _count_mig(self, kind: str, outcome: str):
        d = self.session_stats.setdefault(kind, {})
        d[outcome] = d.get(outcome, 0) + 1

    def _service_migrations(self):
        """Serve the queued session commands on the scheduler thread; a
        transient refusal waits for the next tick until its deadline. An
        empty queue costs nothing (no device work)."""
        if not self._mig_retry and self._mig_q.empty():
            return
        pending, self._mig_retry = self._mig_retry, []
        while True:
            try:
                pending.append(self._mig_q.get_nowait())
            except queue.Empty:
                break
        handlers = {"export": self._do_export, "import": self._do_import,
                    "hold_parked": self._do_hold_parked,
                    "drop_parked": self._do_drop_parked,
                    "release_parked": self._do_release_parked,
                    "export_prefix": self._do_export_prefix,
                    "import_prefix": self._do_import_prefix}
        for cmd in pending:
            try:
                handler = handlers.get(cmd["kind"])
                if handler is None:
                    raise ValueError(
                        f"unknown session command {cmd['kind']!r}")
                cmd["_result"] = handler(cmd)
            except _RetryLater as retry:
                if time.monotonic() < cmd.get("deadline", 0.0):
                    self._mig_retry.append(cmd)
                    continue
                self._refuse(cmd, str(retry), True)
            except (ValueError, KeyError) as e:
                self._refuse(cmd, str(e), True)
            except Exception as e:  # noqa: BLE001 — fail the command, not the loop
                self._refuse(cmd, str(e), False)
            cmd["_done"].set()

    def _refuse(self, cmd: dict, error: str, refused: bool):
        cmd["_error"], cmd["_refused"] = error, refused
        self._count_mig(cmd["kind"], "refused" if refused else "error")

    def _fail_commands(self, error: str):
        """Fail every queued session command (the scheduler is gone)."""
        pending, self._mig_retry = self._mig_retry, []
        while True:
            try:
                pending.append(self._mig_q.get_nowait())
            except queue.Empty:
                break
        for cmd in pending:
            cmd["_error"], cmd["_refused"] = error, False
            cmd["_done"].set()

    def _do_export(self, cmd: dict) -> dict:
        want = cmd.get("slots")
        sessions: List[dict] = []
        skipped: List[dict] = []
        for slot in range(self.slots):
            if want is not None and slot not in want:
                continue
            req = self._slot_req[slot]
            if req is None:
                if want is not None:
                    skipped.append({"slot": slot, "reason": "empty"})
                continue
            if not self._decode_ready[slot]:
                st = self._pending.get(slot)
                if not (cmd.get("prefill") and st is not None
                        and self.paged):
                    skipped.append({"slot": slot,
                                    "reason": "prefill_in_progress"})
                    self._count_mig("export", "skipped_prefill")
                    continue
                # the blocks written so far plus the prompt tail: the
                # importer resumes chunked prefill where this one stopped
                try:
                    payload = self._export_prefill_slot(slot, st,
                                                        cmd.get("wire"))
                except Exception as e:  # noqa: BLE001 — skip the slot, keep the rest
                    skipped.append({"slot": slot, "reason": str(e)})
                    self._count_mig("export", "error")
                    continue
                sessions.append(payload)
                self._count_mig("export", "ok_prefill")
                self._trace("export_prefill", slot)
                if self.tracing:
                    req.mark("export", slot=slot, prefill=True,
                             done=st["done"])
                self._deactivate(slot)
                self._complete(req, error=f"{mig.MIGRATED_SESSION}: "
                                          "prefill slot exported")
                continue
            try:
                # a spec-form slot settles first: the payload is the plain
                # logits form any replica imports (it re-primes its draft)
                if self.spec is not None and self._spec_form[slot]:
                    self._spec_settle_slot(slot)
                payload = self._export_slot(slot, req, cmd.get("wire"))
            except Exception as e:  # noqa: BLE001 — skip the slot, keep the rest
                skipped.append({"slot": slot, "reason": str(e)})
                self._count_mig("export", "error")
                continue
            sessions.append(payload)
            self._count_mig("export", "ok")
            self._trace("export", slot)
            if self.tracing:
                req.mark("export", slot=slot, cursor=payload["cursor"])
            self._deactivate(slot)
            self._complete(req, error=f"{mig.MIGRATED_SESSION}: "
                                      "slot exported")
        if want is None and self._preempted:
            # parked sessions are in flight too; a held one stays with its
            # spill coordinator (exporting it too would fork the session)
            now = time.monotonic()
            parked = [e for e in self._preempted
                      if e.get("hold_until", 0.0) <= now]
            self._preempted = [e for e in self._preempted
                               if e.get("hold_until", 0.0) > now]
            for entry in parked:
                req = entry["req"]
                sessions.append(mig.encode_payload(entry["payload"]))
                self._count_mig("export", "ok")
                self._trace("export_parked", req.seq)
                if self.tracing:
                    req.mark("export", parked=True)
                self._complete(req, error=f"{mig.MIGRATED_SESSION}: "
                                          "parked session exported")
        return {"sessions": sessions, "skipped": skipped}

    def _import_adapter(self, cmd: dict, name: str):
        """The adapter index an imported session decodes with, and whether
        it pins a pool slot: the base for "", else the NAME resolved here
        (pooled: load on miss, retried until the deadline)."""
        if not name:
            return 0, False
        if self.adapter_registry is not None:
            # hit/miss stats count the first lookup only, across retries
            first = not cmd.get("_adapter_seen", False)
            cmd["_adapter_seen"] = True
            try:
                idx = self.adapter_registry.acquire(name, count_hit=first)
            except KeyError:
                raise ValueError(f"unknown adapter {name!r} on this replica")
            if idx is None:
                loading = self.adapter_registry.describe(name).get(
                    "loading", False)
                raise _RetryLater(
                    f"adapter {name!r} " + ("still loading" if loading else
                                            "pool exhausted (all slots "
                                            "pinned)"))
            return idx, True
        if name in self._static_adapter_ids:
            return self._static_adapter_ids[name], False
        raise ValueError(f"unknown adapter {name!r} on this replica")

    def _imported_request(self, payload: dict, idx: int, slot: int):
        """The Request an imported session continues under; on a spec
        engine its draft re-prime ids and the source's controller state."""
        req = Request(payload["prompt_ids"], payload["max_new_tokens"],
                      payload["temperature"], payload["top_p"],
                      payload["seed"], payload["stop_ids"],
                      trace_id=(payload["trace_id"]
                                or f"dtx-{uuid.uuid4().hex[:16]}"),
                      adapter=idx, adapter_name=payload["adapter"])
        req.tokens = list(payload["tokens"])
        req.resume_base = len(req.tokens)
        if self.spec is not None:
            ids, _, _, plen, n_prompt, _, _ = prepare_prompt(
                payload["prompt_ids"], self.tokenizer.eos_token_id,
                self.max_seq_len, payload["max_new_tokens"])
            req.spec_prime_ids = ids[plen - n_prompt:]
            self.spec_ctrl.import_slot_state(slot, payload.get("spec"))
        return req

    def _import_meta(self, req: Request, slot: int, cursor: int,
                     remaining: int, **extra) -> dict:
        text = (self.tokenizer.decode(req.tokens, skip_special_tokens=True)
                if req.tokens else "")
        return {"session": req.trace_id, "slot": slot,
                "tokens": req.resume_base, "cursor": cursor,
                "remaining": remaining, "adapter": req.adapter_name,
                "text_so_far": text, "_request": req, **extra}

    def _do_import(self, cmd: dict) -> dict:
        payload = mig.normalize_payload(cmd["payload"], self.cfg)
        cursor = payload["cursor"]
        W = self.max_seq_len
        if cursor >= W:
            raise ValueError(
                f"session depth {cursor} exceeds this replica's context {W}")
        remaining = max(1, min(payload["remaining"], W - cursor))
        slot = self._free_slot()
        if slot is None:
            raise _RetryLater(
                f"no free cache slot to import into ({self.slots} busy)")
        name = payload["adapter"]
        idx, pinned = self._import_adapter(cmd, name)
        blocks: Optional[List[int]] = None
        try:
            if payload.get("pending") is not None:
                return self._import_prefill_tail(payload, slot, idx, pinned)
            if self.paged:
                # an overcommit engine imports lazily: growth follows decode
                depth = self._reserve_depth(cursor, remaining)
                blocks = self._alloc_blocks(depth)
                if blocks is None:
                    raise _RetryLater(
                        "kv blocks exhausted "
                        f"(need {-(-depth // self.block_size)}"
                        f", free {self._allocator.free_count})")
            req = self._imported_request(payload, idx, slot)
            self._install_session(slot, blocks, payload, req, cursor,
                                  payload["pos"], remaining)
        except Exception:
            if blocks:
                self._allocator.free(blocks)
            if pinned:
                self.adapter_registry.release(name)
            raise
        if pinned:
            self._slot_adapter[slot] = name
        self._slot_blocks[slot] = blocks or []
        self._slot_req[slot] = req
        if self.paged:
            self._slot_demand[slot] = self._eager_demand(cursor, remaining)
        self._note_admitted()
        self._count_mig("import", "ok")
        self._trace("import", slot, cursor)
        if self.tracing:
            req.mark("import", slot=slot, cursor=cursor, adapter=name,
                     tail_tokens=req.resume_base)
        return self._import_meta(req, slot, cursor, remaining)

    def _import_prefill_tail(self, payload: dict, slot: int, idx: int,
                             pinned: bool) -> dict:
        """Admit a mid-chunked-prefill export: scatter the KV written so far
        into fresh blocks and register the prompt tail as a chunked prefill
        with no prefix key (an imported tail publishes no entry). The
        finished prefill arms decode from the seed, as the source would
        have. The caller releases the adapter pin on a failure."""
        if not self.paged:
            raise ValueError("mid-prefill import requires a paged engine")
        pending, cursor = payload["pending"], payload["cursor"]
        ids = [int(t) for t in pending["ids"]]
        final = cursor + len(ids)
        if final >= self.max_seq_len:
            raise ValueError(f"prefill depth {final} exceeds this replica's "
                             f"context {self.max_seq_len}")
        max_new = max(1, int(pending["max_new"]))
        blocks = self._alloc_blocks(self._reserve_depth(final, max_new))
        if blocks is None:
            raise _RetryLater(
                "kv blocks exhausted for mid-prefill import "
                f"(free {self._allocator.free_count})")
        try:
            row = mig.unpack_kv_row(payload["kv"], self.max_seq_len,
                                    self.kv_quant, device=self.device)
            req = self._imported_request(payload, idx, slot)
            # the row's unwritten lanes are sentinel-padded to full width,
            # so the scatter scrubs the recycled blocks too
            paged_insert_row(self._cache, slot, self._table_row(blocks), row)
            self._cache["len"][slot] = cursor
            self._adapter_idx[slot] = idx  # the chunks' adapter row
        except Exception:
            self._cache["block_tables"][slot] = -1
            self._allocator.free(blocks)
            raise
        if pinned:
            self._slot_adapter[slot] = payload["adapter"]
        self._slot_blocks[slot] = blocks
        self._slot_req[slot] = req
        self._decode_ready[slot] = False
        self._slot_demand[slot] = self._eager_demand(final, max_new)
        self._pending[slot] = {
            "req": req, "ids": ids,
            "mask": [int(m) for m in pending["mask"]],
            "positions": [int(p) for p in pending["positions"]],
            "plen": len(ids), "n_prompt": int(pending["n_prompt"]),
            "max_new": max_new, "done": 0, "base": cursor, "key": None,
        }
        self._note_admitted()
        self._count_mig("import", "ok_prefill")
        self._trace("import_prefill", slot, cursor)
        if self.tracing:
            req.mark("import", slot=slot, cursor=cursor,
                     adapter=payload["adapter"], prefill=True, tail=len(ids))
        return self._import_meta(req, slot, cursor, max_new, prefill=True)

    # ------------------------------------------- peer spill of parked sessions
    def _do_hold_parked(self, cmd: dict) -> dict:
        now = time.monotonic()
        hold_until = now + float(cmd.get("hold_s", 10.0))
        limit = int(cmd.get("max_sessions", 4))
        out = []
        for entry in self._preempted:
            if len(out) >= limit:
                break
            if entry.get("hold_until", 0.0) > now:
                continue  # already leased
            entry["hold_until"] = hold_until
            payload = entry["payload"]
            out.append({"trace_id": entry["req"].trace_id,
                        "seq": entry["req"].seq,
                        "cursor": int(payload["cursor"]),
                        "remaining": int(payload["remaining"]),
                        "payload": mig.encode_payload(payload)})
        return {"sessions": out, "parked": len(self._preempted)}

    def _do_drop_parked(self, cmd: dict) -> dict:
        want = set(cmd.get("trace_ids") or [])
        keep, dropped = [], 0
        for entry in self._preempted:
            req = entry["req"]
            if req.trace_id not in want:
                keep.append(entry)
                continue
            dropped += 1
            self._count_preempt("spilled")
            self._trace("spill", req.seq)
            if self.tracing:
                req.mark("spill")
            self._complete(req, error=f"{mig.MIGRATED_SESSION}: "
                                      "parked session spilled")
        self._preempted = keep
        return {"dropped": dropped}

    def _do_release_parked(self, cmd: dict) -> dict:
        want = set(cmd.get("trace_ids") or [])
        released = 0
        for entry in self._preempted:
            if entry["req"].trace_id in want and entry.pop(
                    "hold_until", None) is not None:
                released += 1
        return {"released": released}

    # ------------------------------------------------ fleet prefix tier
    def _adapter_akey_name(self, akey) -> Optional[str]:
        """A prefix-cache adapter identity → its fleet-wide NAME (pooled
        mode keys by name; a static stack by index). None: unmappable."""
        if isinstance(akey, str):
            return akey
        if akey == 0:
            return ""
        return next((n for n, i in self._static_adapter_ids.items()
                     if i == akey), None)

    def _mount_entry_row(self, ent: dict, cursor: int) -> Dict:
        """Gather a COW block entry into a dense row by installing its
        blocks on a FREE slot's table for the gather (nothing reads an
        unoccupied slot's table), restored before returning."""
        slot = self._free_slot()
        if slot is None:
            raise _RetryLater("no free slot to stage a prefix export")
        w = min(-(-max(1, cursor) // DECODE_BUCKET) * DECODE_BUCKET,
                self.max_seq_len)
        saved = self._cache["block_tables"][slot].clone()
        try:
            self._cache["block_tables"][slot] = self._table_row(ent["blocks"])
            return paged_extract_row(self._cache, slot, cursor, width=w)
        finally:
            self._cache["block_tables"][slot] = saved

    def _do_export_prefix(self, cmd: dict) -> dict:
        if self._prefix is None:
            return {"entries": []}
        exclude = cmd.get("exclude") or set()
        limit = int(cmd.get("max_entries", 4))
        entries: List[dict] = []
        for (ptoks, akey), ent in self._prefix.snapshot_entries():
            if len(entries) >= limit:
                break
            name = self._adapter_akey_name(akey)
            if name is None:
                continue
            fp = mig.prefix_fingerprint(name, ptoks)
            if fp in exclude:
                continue
            cursor = int(ent["cursor"])
            try:
                row = (self._mount_entry_row(ent, cursor)
                       if ent.get("blocks") is not None else ent["cache"])
                entries.append({
                    "kind": mig.PREFIX_KIND,
                    "version": mig.PAYLOAD_VERSION,
                    "fingerprint": fp, "adapter": name,
                    "prompt_ids": [int(t) for t in ptoks],
                    "cursor": cursor,
                    "no_reuse": bool(ent.get("no_reuse", False)),
                    "logits": (None if ent.get("logits") is None
                               else mig.pack_logits(ent["logits"])),
                    "kv": mig.pack_kv_row(row, cursor, cmd.get("wire")),
                    "model_sig": mig.model_signature(self.cfg,
                                                     self.kv_quant),
                })
                self._count_mig("export_prefix", "ok")
            except Exception:  # noqa: BLE001 — publishing is best effort
                self._count_mig("export_prefix", "error")
        return {"entries": entries}

    def _do_import_prefix(self, cmd: dict) -> dict:
        if self._prefix is None:
            raise ValueError("prefix cache disabled on this replica")
        payload = cmd["payload"]
        mig.check_prefix_signature(payload, self.cfg)
        name = payload.get("adapter") or ""
        if not name:
            akey = "" if self.adapter_registry is not None else 0
        elif self.adapter_registry is not None:
            if name not in self.adapter_registry.names():
                raise ValueError(f"unknown adapter {name!r} on this replica")
            akey = name
        elif name in self._static_adapter_ids:
            akey = self._static_adapter_ids[name]
        else:
            raise ValueError(f"unknown adapter {name!r} on this replica")
        key = (tuple(int(t) for t in payload["prompt_ids"]), akey)
        if self._prefix.get(key) is not None:
            return {"imported": False, "reason": "present"}
        cursor = int(payload["cursor"])
        if not 0 < cursor < self.max_seq_len:
            raise ValueError(f"prefix depth {cursor} unusable in context "
                             f"{self.max_seq_len}")
        row = mig.unpack_kv_row(payload["kv"], self.max_seq_len,
                                self.kv_quant, device=self.device)
        row["len"] = torch.tensor(cursor, dtype=torch.int32,
                                  device=self.device)
        logits = (None if payload.get("logits") is None
                  else mig.unpack_logits(payload, self.cfg.vocab_size,
                                         device=self.device))
        if self.cow:
            full, rem = divmod(cursor, self.block_size)
            n_blocks = full + (1 if rem else 0)
            slot = self._free_slot()
            if slot is None:
                raise _RetryLater("no free slot to stage a prefix import")
            blocks = self._allocator.alloc(n_blocks)
            if blocks is None:
                raise _RetryLater(
                    f"kv blocks exhausted for prefix import "
                    f"(need {n_blocks}, free {self._allocator.free_count})")
            # the scatter goes through a free slot's table, restored after:
            # the ENTRY owns these blocks, not a slot
            saved = self._cache["block_tables"][slot].clone()
            try:
                paged_insert_row(self._cache, slot, self._table_row(blocks),
                                 row)
            except Exception:
                self._allocator.free(blocks)
                raise
            finally:
                self._cache["block_tables"][slot] = saved
            ent = {"blocks": blocks, "full": full, "rem": rem,
                   "cursor": cursor, "logits": logits}
        elif self.paged:
            w = min(-(-cursor // DECODE_BUCKET) * DECODE_BUCKET,
                    self.max_seq_len)
            ent = {"cache": row_trim(row, w), "logits": logits,
                   "cursor": cursor}
        else:
            # the dense layout copies whole rows at admission
            ent = {"cache": row, "logits": logits, "cursor": cursor}
        if bool(payload.get("no_reuse")) or logits is None:
            ent["no_reuse"] = True
        self._prefix.put(key, ent)
        self._count_mig("import_prefix", "ok")
        self._trace("import_prefix", cursor)
        return {"imported": True, "cursor": cursor,
                "fingerprint": payload.get("fingerprint")}

    # --------------------------------------------------------------- decode
    def _batch_sample_mode(self) -> str:
        """Static per-batch sampling mode, from host-side request params."""
        live = [r for r in self._slot_req if r is not None]
        if all(r.temperature <= 0.0 for r in live):
            return "greedy"
        if any(r.top_p < 1.0 and r.temperature > 0.0 for r in live):
            return "topp"
        return "simple"

    def _epilogue_mode(self) -> str:
        return ("off" if self.sampling_epilogue != "on"
                else self._batch_sample_mode())

    def _split_keys(self, K: int) -> np.ndarray:
        """Advance every slot's key through K decode steps, as the
        reference's steps split them (half 0 kept, half 1 drawn from);
        returns the drawn halves ``[K, S, 2]``."""
        subs = []
        for _ in range(K):
            halves = prng.split(self._keys)
            self._keys = halves[:, 0]
            subs.append(halves[:, 1])
        return np.stack(subs)

    def _chunk_draws(self, K: int, mode: str) -> Optional[torch.Tensor]:
        """The K steps' draw operands in one host-to-device copy: ``[K, S]``
        uniforms for the fused epilogue, ``[K, S, 2]`` draw keys for the
        legacy sampler, None where every row is greedy. Keys advance
        either way."""
        subs = self._split_keys(K)
        greedy = (mode == "greedy" or (mode == "off" and
                                       self._batch_sample_mode() == "greedy"))
        if greedy:
            return None
        if mode == "off":
            return prng.to_device(subs, self.device)
        return torch.from_numpy(prng.uniform(subs)).to(self.device)

    def _decode_chunk(self, K: int, mode: str) -> torch.Tensor:
        """K single-token decode steps over every slot, all on the device.
        Returns ``[K + 1, S]`` int32: the emitted tokens (-1 = none) and, in
        the last row, the post-chunk active mask."""
        draws = self._chunk_draws(K, mode)
        # one snapshot of the adapters for the whole chunk
        lora = self._lora_arg()
        aidx = self._adapter_idx if lora is not None else None
        logits, cache = self._logits, self._cache
        pos, remaining, active = self._pos, self._remaining, self._active
        temps, top_ps, stops = self._temps, self._top_ps, self._stops
        rows = []
        for step in range(K):
            draw = None if draws is None else draws[step]
            if mode == "off":
                nxt = _sample_jit(logits, temps, top_ps, draw)
            else:
                nxt = fused_sample(logits, temps, top_ps, draw, mode=mode)
            is_stop = (nxt[:, None] == stops).any(dim=1)
            emit = active & ~is_stop & (remaining > 0)
            emit_i = emit.to(torch.int32)
            rows.append(torch.where(emit, nxt, torch.full_like(nxt, -1)))
            active = emit & (remaining > 1)
            remaining = remaining - emit_i
            prev_len = cache["len"]
            tok = torch.where(emit, nxt, torch.zeros_like(nxt))[:, None]
            logits2, cache = forward(
                self.params, tok, self.cfg, positions=pos[:, None],
                attention_mask=emit_i[:, None], cache=cache, lora=lora,
                lora_adapter_idx=aidx, compute_dtype=torch.bfloat16)
            # forward advances every cursor; only emitting slots really moved
            cache["len"] = prev_len + emit_i
            pos = pos + emit_i
            logits = logits2[:, -1]
        self._logits, self._cache = logits, cache
        self._pos, self._remaining, self._active = pos, remaining, active
        rows.append(active.to(torch.int32))
        return torch.stack(rows)

    # ------------------------------------------------ speculative decoding
    def _init_spec(self, spec_draft, spec_k, spec_mode, spec_tree,
                   spec_tree_learned):
        """The spec structures (None without a draft, or with
        ``spec_mode`` off: the engine is then the plain one)."""
        smode = (spec_mode or "auto").strip().lower()
        if smode not in ("auto", "on", "off"):
            raise ValueError(
                f"spec_mode must be auto|on|off, got {spec_mode!r}")
        if smode == "on" and not spec_draft:
            raise ValueError("--spec_mode on requires --spec_draft_config")
        self.spec_mode = smode
        self.spec_k = max(1, int(spec_k))
        self.spec = None
        self.spec_tree = None
        if spec_tree and smode != "off":
            if not spec_draft:
                raise ValueError("--spec_tree requires --spec_draft_config")
            self.spec_tree = spec_mod.parse_spec_tree(spec_tree)
            if self.spec_tree.step_tokens >= self.max_seq_len:
                raise ValueError(
                    f"spec_tree {self.spec_tree} writes "
                    f"{self.spec_tree.step_tokens} tokens per step: does "
                    f"not fit max_seq_len {self.max_seq_len}")
        self.spec_tree_learned = (bool(spec_tree_learned)
                                  and self.spec_tree is not None)
        # a verify step writes its step's tokens past a row's cursor
        # (chain: pending + k proposals; tree: pending + every node); paged
        # reservations and growth keep that overshoot physical
        self._spec_step_tokens = (self.spec_tree.step_tokens
                                  if self.spec_tree else self.spec_k + 1)
        self._spec_overshoot = 0
        if not spec_draft or smode == "off":
            return
        dcfg, dparams = spec_mod.build_draft(spec_draft, self.cfg,
                                             self.params, device=self.device)
        self.spec = {
            "draft": spec_draft, "dcfg": dcfg, "dparams": dparams,
            # the draft's dense per-slot cache (read through the gather
            # path, as the reference's)
            "dcache": init_cache(dcfg, self.slots, self.max_seq_len,
                                 dtype=torch.bfloat16, per_slot=True,
                                 device=self.device),
            "programs": spec_mod.SpecPrograms(
                self.cfg, dcfg, epilogue=self.sampling_epilogue),
        }
        ctrl_cls = (spec_mod.AdaptiveTree if self.spec_tree_learned
                    else spec_mod.AdaptiveK)
        self.spec_ctrl = ctrl_cls(self.spec_k, mode=smode,
                                  tree=self.spec_tree)
        self._spec_overshoot = self._spec_step_tokens
        self._spec_pending = torch.zeros((self.slots,), dtype=torch.int32,
                                         device=self.device)
        self._spec_form = [False] * self.slots  # slot in pending form
        self._spec_primed = [False] * self.slots  # draft row holds context
        self.spec_stats = {"proposed": 0, "accepted": 0, "row_steps": 0,
                           "spec_steps": 0, "plain_steps": 0,
                           "tree_steps": 0}
        self._spec_adapter_ema: Dict[str, float] = {}
        self._spec_tree_slot_path: Dict[int, float] = {}

    def _spec_prime_slot(self, slot: int):
        """Prefill the slot's context (kept prompt + emitted tokens) through
        the draft into its row of the draft cache. Priming feeds only the
        acceptance rate: verification keeps the output exact."""
        req = self._slot_req[slot]
        ids = list(getattr(req, "spec_prime_ids", None) or [])
        eos = self.tokenizer.eos_token_id or 0
        if not ids:
            ids = list(req.prompt_ids)[-self.max_seq_len:] or [eos]
        toks = ids + list(req.tokens)
        n, W = len(toks), self.max_seq_len
        if n > W:
            # the context does not fit a draft row: this slot takes the
            # plain path for its lifetime
            self.spec_ctrl.force_off_slot(slot)
            self._spec_primed[slot] = True
            return
        padded = min(-(-n // DECODE_BUCKET) * DECODE_BUCKET, W)
        pad = padded - n
        dev = self.device
        sp = self.spec
        sp["dcache"] = sp["programs"].prime(
            sp["dparams"], sp["dcache"], slot,
            torch.tensor([[eos] * pad + toks], dtype=torch.int32, device=dev),
            torch.tensor([[0] * pad + [1] * n], dtype=torch.int32,
                         device=dev),
            torch.tensor([[0] * pad + list(range(n))], dtype=torch.int32,
                         device=dev),
            padded)
        self._spec_primed[slot] = True
        self._trace("spec_prime", slot, n)

    def _spec_settle_slot(self, slot: int):
        """Write the slot's pending token through the target so the slot is
        in logits form again (the row format's contract)."""
        if self.spec is None or not self._spec_form[slot]:
            return
        onehot = torch.zeros((self.slots,), dtype=torch.bool,
                             device=self.device)
        onehot[slot] = True
        row_logits, self._cache, self._pos = self.spec["programs"].settle(
            self.params, self._lora_arg(), self._cache, self._spec_pending,
            self._pos, self._adapter_idx, onehot)
        self._logits = torch.where(onehot[:, None], row_logits, self._logits)
        self._spec_form[slot] = False
        self._trace("spec_settle", slot)

    def _spec_decode_tick(self):
        """One speculative tick in place of the plain chunk: fresh slots
        are primed and enter pending form (their first token drawn as the
        plain step would); then, if the controller approves, ONE
        draft/verify step (chain or tree) emits up to ``step`` tokens a
        drafting row, else the pending-form plain chunk runs. Returns
        ``(emitted rows [n][S], active [S])`` on the host."""
        sp = self.spec
        progs = sp["programs"]
        dev = self.device
        bmode, emode = self._batch_sample_mode(), self._epilogue_mode()
        rows: List[List[int]] = []
        fresh = [s for s in range(self.slots)
                 if self._decode_ready[s] and self._slot_req[s] is not None
                 and not self._spec_form[s]]
        enter_emitted = None
        if fresh:
            for slot in fresh:
                if not self._spec_primed[slot]:
                    self._spec_prime_slot(slot)
            fresh_h = np.zeros((self.slots,), dtype=bool)
            fresh_h[fresh] = True
            (enter_emitted, self._spec_pending, self._remaining,
             self._active, self._keys) = progs.enter(
                self._logits, self._spec_pending, self._remaining,
                self._active, self._keys, self._temps, self._top_ps,
                self._stops, fresh_h, mode=emode, batch=bmode)
            for slot in fresh:
                self._spec_form[slot] = True
            self._trace("spec_enter", len(fresh), emode)
        # the tick's designed sync: which rows can draft (active, a budget
        # of 2 or more), with the first tokens of the fresh rows
        parts = [self._active.to(torch.int32), self._remaining]
        if enter_emitted is not None:
            parts.append(enter_emitted.to(torch.int32))
        host = torch.stack(parts).cpu().tolist()
        active_prev, rem = host[0], host[1]
        if enter_emitted is not None:
            rows.append(host[2])
        spec_rows = np.array([
            bool(self._spec_form[s] and self._spec_primed[s]
                 and active_prev[s] and rem[s] >= 2
                 and self.spec_ctrl.slot_enabled(s))
            for s in range(self.slots)])
        lora = self._lora_arg()
        if spec_rows.any() and self.spec_ctrl.use_spec():
            plan = self.spec_ctrl.current_plan()
            spec_on = torch.from_numpy(spec_rows).to(dev)
            args = (self.params, sp["dparams"], lora, self._cache,
                    sp["dcache"], self._spec_pending, self._pos,
                    self._remaining, self._active, self._keys, self._temps,
                    self._top_ps, self._stops, self._adapter_idx, spec_on)
            margin = None
            if plan[0] == "tree":
                widths = plan[1]
                k = len(widths)
                with record_function("dtx_engine_spec_tree"):
                    (emitted, acc, self._cache, sp["dcache"],
                     self._spec_pending, self._pos, self._remaining,
                     self._active, self._keys, margin) = progs.tree_step(
                        *args, widths=widths, mode=bmode)
                self.spec_stats["tree_steps"] += 1
            else:
                k = plan[1]
                with record_function("dtx_engine_spec_step"):
                    (emitted, acc, self._cache, sp["dcache"],
                     self._spec_pending, self._pos, self._remaining,
                     self._active, self._keys) = progs.step(*args, k=k,
                                                            mode=bmode)
            # the step's one sync: its tokens, acceptances and active mask
            host = torch.cat([emitted.T.to(torch.int32),
                              acc[None].to(torch.int32),
                              self._active[None].to(torch.int32)]).cpu()
            rows.extend(host[:-2].tolist())
            acc_h, active = host[-2].tolist(), host[-1].tolist()
            obs = [(s, acc_h[s], k) for s in range(self.slots)
                   if spec_rows[s] and active_prev[s]]
            self._spec_observe(plan, obs, margin)
            self.sampling_stats["fused_steps" if self.sampling_epilogue
                                == "on" else "legacy_steps"] += 1
            self._trace("spec", k, len(obs), bmode,
                        plan[1] if plan[0] == "tree" else None)
        else:
            with record_function("dtx_engine_decode"):
                (emitted, self._cache, self._spec_pending, self._pos,
                 self._remaining, self._active, self._keys) = progs.decode(
                    self.params, lora, self._cache, self._spec_pending,
                    self._pos, self._remaining, self._active, self._keys,
                    self._temps, self._top_ps, self._stops,
                    self._adapter_idx, K=self.chunk, mode=emode,
                    batch=bmode)
            host = torch.cat([emitted.to(torch.int32),
                              self._active[None].to(torch.int32)]).cpu()
            rows.extend(host[:-1].tolist())
            active = host[-1].tolist()
            self.spec_stats["plain_steps"] += 1
            self.sampling_stats["fused_steps" if emode != "off"
                                else "legacy_steps"] += 1
            self.spec_ctrl.note_plain_step()
            self._trace("decode", self.chunk, emode)
        return rows, active

    def _spec_observe(self, plan, obs, margin):
        """Feed one verify step's acceptances to the controller and the
        acceptance counters (host data only, but the tree's root margins)."""
        self.spec_ctrl.observe(obs)
        st = self.spec_stats
        st["spec_steps"] += 1
        st["row_steps"] += len(obs)
        alpha = self.spec_ctrl.alpha
        for s, a, kk in obs:
            st["proposed"] += kk
            st["accepted"] += a
            self._h_accept_len.observe(a)
            if plan[0] == "tree":
                ema_t = self._spec_tree_slot_path.get(s)
                self._spec_tree_slot_path[s] = (
                    a * 1.0 if ema_t is None else ema_t + alpha * (a - ema_t))
            req = self._slot_req[s]
            name = req.adapter_name if req is not None else ""
            ema = self._spec_adapter_ema.get(name)
            rate = a / kk
            self._spec_adapter_ema[name] = (
                rate if ema is None else ema + alpha * (rate - ema))
        if plan[0] == "tree" and self.spec_tree_learned and obs:
            depth_fracs = [sum(1 for _, a, _ in obs if a >= j + 1) / len(obs)
                           for j in range(len(plan[1]))]
            margins = margin.cpu().tolist()
            decisive = sum(1 for s, _, _ in obs
                           if margins[s] >= self.spec_ctrl.DECISIVE_MARGIN)
            self.spec_ctrl.observe_tree(depth_fracs, decisive / len(obs))

    def spec_info(self) -> Optional[dict]:
        """The speculative decoding document (None without a draft): mode,
        draft, k, acceptance rates, the tree's widths, the step mix."""
        if self.spec is None:
            return None
        snap = self.spec_ctrl.snapshot()
        info = {
            "enabled": True,
            "mode": self.spec_mode,
            "draft": self.spec["draft"],
            "k_max": self.spec_k,
            "k": snap["k"],
            "accept_rate": (round(snap["global_ema"], 4)
                            if snap["global_ema"] is not None else None),
            "adapter_accept_rate": {n: round(v, 4) for n, v in
                                    dict(self._spec_adapter_ema).items()},
            "slot_accept_rate": snap["slots"],
            "slots_off": snap["slots_off"],
            "active": self.spec_ctrl.use_spec(),
            "disabled_events": snap["disabled_events"],
        }
        if self.spec_tree is not None:
            plan = snap.get("plan") or []
            widths = (list(plan[1]) if len(plan) == 2 and plan[0] == "tree"
                      else [self.spec_tree.width] * self.spec_tree.depth)
            info["tree"] = {
                "spec": str(self.spec_tree),
                "width": self.spec_tree.width,
                "depth": self.spec_tree.depth,
                "learned": self.spec_tree_learned,
                "widths": widths,
                "plan_width": widths[0] if widths else self.spec_tree.width,
                "slot_path_len": {s: round(v, 4) for s, v in
                                  dict(self._spec_tree_slot_path).items()},
            }
            for key in ("depth_ema", "decisive_ema"):
                if key in snap:
                    info["tree"][key] = snap[key]
        info["sampling_epilogue"] = self.sampling_epilogue
        info.update(self.sampling_stats)
        info.update(self.spec_stats)
        return info

    def _scheduler(self):
        # grad mode is thread-local: this thread enters inference mode itself
        try:
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                self._scheduler_loop()
        except BaseException as e:
            # a dead scheduler must not leave callers waiting out timeouts
            self._dead = f"scheduler thread died: {e!r}"
            self._fail_all(self._dead)
            raise

    def _fail_all(self, error: str):
        self._fail_commands(error)
        while True:
            req = self._take_waiting()
            if req is None:
                break
            req.finish(error=error)
        parked, self._preempted = self._preempted, []
        for req in [e["req"] for e in parked] + self._slot_req:
            if req is not None and not req.done.is_set():
                req.finish(error=error)

    def _scheduler_loop(self):
        while not self._shutdown.is_set():
            # session commands first: an imported session is mid-decode (the
            # source paid its prefill), so it outranks cold admissions
            self._service_migrations()
            self._resume_preempted_tick()
            self._admit_waiting()
            self._prefill_tick()
            self._grow_tick()
            if not any(self._decode_ready):
                if self._pending:
                    continue  # keep prefilling; nothing to decode yet
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            try:
                if self.spec is not None:
                    emitted, active = self._spec_decode_tick()
                else:
                    mode = self._epilogue_mode()
                    with record_function("dtx_engine_decode"):
                        out = self._decode_chunk(self.chunk, mode)
                    self.sampling_stats["fused_steps" if mode != "off"
                                        else "legacy_steps"] += 1
                    self._trace("decode", self.chunk)
                    # the decode loop's ONE designed sync point: K tokens
                    # per chunk (and the active mask) cross to the host
                    host = out.cpu()
                    emitted, active = host[:-1].tolist(), host[-1].tolist()
            except Exception as e:  # noqa: BLE001 — device fault: fail all in-flight
                for slot, req in enumerate(self._slot_req):
                    if req is not None:
                        self._release_slot(slot)
                        self._complete(req, error=str(e))
                continue
            for row in emitted:
                for slot, t in enumerate(row):
                    req = self._slot_req[slot]
                    if t >= 0 and req is not None:
                        req.push(t)
            for slot in range(self.slots):
                req = self._slot_req[slot]
                # pending-prefill slots are inactive by design — only slots
                # that entered this decode chunk can finish here
                if (req is not None and self._decode_ready[slot]
                        and not active[slot]):
                    self._release_slot(slot)
                    if self.tracing:
                        req.mark("finish", slot=slot)
                    self._complete(req)
                    self._trace("finish", slot)

    def _release_slot(self, slot: int, note_session: bool = True):
        self._slot_req[slot] = None
        self._pending.pop(slot, None)
        self._decode_ready[slot] = False
        self._slot_demand[slot] = 0
        self._slot_key[slot] = None
        if self.spec is not None:
            self._spec_form[slot] = False
            self._spec_primed[slot] = False
            self.spec_ctrl.reset_slot(slot)
            self._spec_tree_slot_path.pop(slot, None)
        name, self._slot_adapter[slot] = self._slot_adapter[slot], None
        if name is not None and self.adapter_registry is not None:
            self.adapter_registry.release(name)
        blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
        if blocks:
            if note_session:
                # tables only grow: the count at release is the peak
                self.kv_stats["session_blocks"].append(len(blocks))
            # clear the table FIRST: a masked decode write from this slot
            # must never land in a block the allocator has already re-issued
            self._cache["block_tables"][slot] = -1
            self._allocator.free(blocks)

    def _complete(self, req: Request, error: Optional[str] = None):
        """Finish a request AND flush its buffered observability: one
        TTFT/TPOT observe pair (never one a token) and, with tracing on,
        the request's span into the trace ring."""
        n = len(req.tokens)
        if self.tenants is not None and req.tenant:
            self._tenant_count(req.tenant, "tokens_out", n)
        if req.first_token_ts is not None:
            tpot = None
            if req.last_token_ts is not None and n > 1:
                tpot = (req.last_token_ts - req.first_token_ts) / (n - 1)
            self.request_stats.append({
                "trace_id": req.trace_id,
                "ttft_s": req.first_token_ts - req.t_submit,
                "tpot_s": tpot, "tokens": n})
            # an exemplar only while tracing: its trace id then resolves
            # at GET /debug/trace/<id>
            tid = req.trace_id if self.tracing else None
            self._h_ttft.observe((req.first_token_ts - req.t_submit) * 1e3,
                                 trace_id=tid)
            if tpot is not None:
                self._h_tpot.observe(tpot * 1e3, trace_id=tid)
        if self.tracing:
            self.trace_store.add(build_request_span(
                req.trace_id, req.t_submit, req.timeline,
                req.first_token_ts, req.last_token_ts, n,
                req.wall_submit_ms, error=error,
                attrs={"adapter": req.adapter_name or req.adapter,
                       "prompt_len": len(req.prompt_ids)}))
        req.finish(error=error)

    # ------------------------------------------------------------- adapters
    def _build_adapter_stack(self, named: Dict[str, str],
                             states: Dict[str, dict]):
        """Stack the named adapter checkpoints into ``[L, E, ...]`` leaves
        (entry 0 is the all-zero base adapter), in bf16 on the device, with
        f32 scales ``[E]``. Mixed ranks are zero-padded to the largest
        (zero columns and rows leave the delta as it is); mixed target sets
        take the union, with zeros where an adapter lacks a target."""
        loaded = []
        for name, path in named.items():
            state = states.get(path) or load_checkpoint_state(path)
            lora = state.get("lora")
            if not lora:
                raise ValueError(f"adapter {name!r}: no lora tree in {path}")
            layers = lora["layers"]
            rank = next(iter(layers.values()))["a"].shape[-1]
            scaling = state.get("_scaling")
            if scaling is None:
                scaling = lora_scaling(32.0, rank)
            loaded.append((name, layers, float(scaling)))
        targets = sorted({t for _, layers, _ in loaded for t in layers}
                         & set(LORA_TARGETS))
        max_rank = max(layers[t]["a"].shape[-1]
                       for _, layers, _ in loaded for t in layers)
        L, E = self.cfg.num_layers, len(loaded) + 1
        stack: Dict[str, dict] = {}
        for t in targets:
            d_in, d_out = target_dims(self.cfg, t)
            a = torch.zeros((L, E, d_in, max_rank), dtype=torch.float32)
            b = torch.zeros((L, E, max_rank, d_out), dtype=torch.float32)
            for e, (_, layers, _) in enumerate(loaded, start=1):
                if t not in layers:
                    continue
                r = layers[t]["a"].shape[-1]
                a[:, e, :, :r] = layers[t]["a"].float()
                b[:, e, :r, :] = layers[t]["b"].float()
            stack[t] = {"a": a.to(torch.bfloat16).to(self.device),
                        "b": b.to(torch.bfloat16).to(self.device)}
        scales = torch.tensor([0.0] + [s for _, _, s in loaded],
                              dtype=torch.float32, device=self.device)
        self.lora_stack = ({"layers": stack}, scales)
        for e, (name, _, _) in enumerate(loaded, start=1):
            self._static_adapter_ids[name] = e

    @property
    def adapter_ids(self) -> Dict[str, int]:
        """Known adapter names → device index. Static mode: the stack's
        binding. Pooled mode: every REGISTERED name (resident → its pool
        slot, loadable on a miss → -1)."""
        if self.adapter_registry is not None:
            return self.adapter_registry.id_map()
        return self._static_adapter_ids

    def adapter_for(self, model: str) -> str:
        """The adapter a request's "model" names: "" for none, KeyError for
        a name that is no adapter of this engine."""
        if model and model not in self.adapter_ids:
            raise KeyError(model)
        return model

    def load_adapter(self, name: str, checkpoint_path: str,
                     preload: bool = True) -> dict:
        """Register (and by default warm) an adapter at runtime. Raises
        NotImplementedError on a static stack, ValueError /
        AdapterRankError for a checkpoint the pool's geometry refuses,
        RuntimeError when every pool slot is pinned, and AdapterPinnedError
        when re-registering a live name."""
        if self.adapter_registry is None:
            raise NotImplementedError(
                "engine runs a static adapter stack; restart with "
                "--adapter_pool to load adapters at runtime")
        existed = name in self.adapter_registry.names()
        rebound = existed and (self.adapter_registry.describe(name)
                               ["checkpoint"] != checkpoint_path)
        self.adapter_registry.register(name, checkpoint_path)
        if rebound and self._prefix is not None:
            self._prefix.drop_adapter(name)  # rows of the old weights
        if preload:
            try:
                self.adapter_registry.preload(name)
            except (ValueError, FileNotFoundError):
                # a bad CHECKPOINT does not stay registered, but only a
                # registration THIS call made is rolled back; a transient
                # failure (pool exhausted) never unregisters
                if not existed:
                    self.adapter_registry.unregister(name)
                raise
        return self.adapter_registry.describe(name)

    def unload_adapter(self, name: str) -> bool:
        """Evict and unregister. AdapterPinnedError while in-flight
        requests still decode with it."""
        if self.adapter_registry is None:
            raise NotImplementedError("engine runs a static adapter stack")
        gone = self.adapter_registry.unregister(name)
        if gone:
            if self._prefix is not None:
                self._prefix.drop_adapter(name)
            with self._adapter_req_lock:
                self.adapter_requests.pop(name, None)
        return gone

    def adapter_occupancy(self) -> Optional[dict]:
        """Pool occupancy and registry stats; None on a static or base
        engine."""
        if self.adapter_registry is None:
            return None
        occ = self.adapter_registry.occupancy()
        occ["resident_adapters"] = sorted(self.adapter_registry.resident())
        occ["registered_adapters"] = self.adapter_registry.names()
        occ["load_ms"] = list(self.adapter_registry.load_ms)
        with self._adapter_req_lock:
            occ["requests"] = dict(self.adapter_requests)
        return occ

    @property
    def resident_adapters(self) -> Optional[Dict[str, int]]:
        if self.adapter_registry is None:
            return None
        return self.adapter_registry.resident()

    # -------------------------------------------------------------- tenancy
    def _tenant_count(self, tenant: str, key: str, n: int):
        """Bump a per-tenant usage counter: known tenants always count, new
        names stop landing once 1024 exist."""
        with self._tenant_lock:
            row = self.tenant_stats.get(tenant)
            if row is None:
                if len(self.tenant_stats) >= self._tenant_stats_cap:
                    return
                row = self.tenant_stats[tenant] = {
                    "requests": 0, "tokens_in": 0, "tokens_out": 0}
            row[key] = row.get(key, 0) + n

    def tenant_usage(self) -> Optional[dict]:
        """Per-tenant usage, live KV blocks, tier and resident adapters, or
        None when the tenancy plane is off."""
        if self.tenants is None:
            return None
        with self._tenant_lock:
            usage = {t: dict(row) for t, row in self.tenant_stats.items()}
        # racy slot-list reads, as every stats read here
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None or not req.tenant:
                continue
            row = usage.setdefault(
                req.tenant, {"requests": 0, "tokens_in": 0, "tokens_out": 0})
            row["kv_blocks"] = (row.get("kv_blocks", 0)
                                + len(self._slot_blocks[s]))
        resident = (set(self.adapter_registry.resident())
                    if self.adapter_registry is not None else set())
        for name in self.tenants.names():
            spec = self.tenants.get(name)
            if spec is None:
                continue
            row = usage.setdefault(
                name, {"requests": 0, "tokens_in": 0, "tokens_out": 0})
            row["tier"] = spec.tier
            row["adapters_resident"] = len(resident & set(spec.adapters))
        return usage

    def refresh_tenant_pins(self):
        """Re-sync the registry's pinned set after a directory change."""
        if self.tenants is not None and self.adapter_registry is not None:
            self.adapter_registry.set_pinned(self.tenants.pinned_adapters())

    # ---------------------------------------------------------------- API
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 128,
               temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
               stop_ids: Optional[set] = None, adapter: str = "",
               trace_id: str = "", tenant: str = "") -> Request:
        if self._dead:
            raise RuntimeError(self._dead)
        known = self.adapter_ids
        if adapter not in known:
            raise KeyError(f"unknown adapter {adapter!r}; loaded: "
                           f"{sorted(n for n in known if n)}")
        # the device index is fixed now for the static stack; pooled names
        # resolve (and pin) at admission
        idx = known[adapter] if self.adapter_registry is None else 0
        with self._adapter_req_lock:
            if (adapter in self.adapter_requests
                    or len(self.adapter_requests)
                    < self._adapter_requests_cap):
                self.adapter_requests[adapter] = \
                    self.adapter_requests.get(adapter, 0) + 1
        # tenancy: an explicit tenant wins, else the adapter maps through
        # the directory; unknown stays anonymous
        tenant_name, tier = "", "standard"
        if self.tenants is not None:
            spec = self.tenants.resolve(tenant=tenant, adapter=adapter)
            if spec is not None:
                tenant_name, tier = spec.name, spec.tier
            self._tenant_count(tenant_name or tenant, "requests", 1)
            self._tenant_count(tenant_name or tenant, "tokens_in",
                               len(prompt_ids))
        stops = {int(s) for s in (stop_ids or set())}
        stops.add(int(self.tokenizer.eos_token_id))
        req = Request(prompt_ids, max_new_tokens, temperature, top_p, seed,
                      sorted(stops),
                      trace_id=trace_id or f"dtx-{uuid.uuid4().hex[:16]}",
                      adapter=idx, adapter_name=adapter,
                      tenant=tenant_name or tenant, tenant_tier=tier)
        self._waiting.put(req)
        self._wake.set()
        return req

    def generate(self, prompt_ids, timeout: float = 300.0, **kw) -> List[int]:
        req = self.submit(prompt_ids, **kw)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.tokens

    def perplexity(self, prompt_ids: Sequence[int],
                   completion_ids: Sequence[int], adapter: str = "") -> dict:
        """Mean completion NLL under the served model, or under ``adapter``
        through the same per-row adapter path decode uses. Runs on the
        caller's thread beside the scheduler (the forward touches no engine
        state); the [1, P, V] f32 log-probs live only for the call."""
        if adapter not in self.adapter_ids:
            raise KeyError(f"unknown adapter {adapter!r}")
        # pooled mode: pin the adapter across the forward, so eviction
        # cannot swap its weights out mid-read (a cold one loads here, and
        # is warm for serving after)
        pinned = False
        if self.adapter_registry is not None and adapter:
            idx = self.adapter_registry.acquire(adapter, wait=True)
            if idx is None:
                raise RuntimeError(
                    "adapter pool exhausted (all slots pinned); retry")
            pinned = True
        else:
            idx = self.adapter_ids[adapter]
        try:
            # grad mode is thread-local: the caller's thread enters it
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                tokens, mask, _ = prepare_nll_inputs(
                    list(prompt_ids), list(completion_ids),
                    self.tokenizer.eos_token_id, self.max_seq_len,
                    device=self.device)
                lora = self._lora_arg()
                nll_sum, n_tok = nll_impl(
                    self.params, self.cfg, tokens, mask, lora=lora,
                    lora_adapter_idx=(torch.tensor([idx], device=self.device)
                                      if lora is not None else None))
                return nll_result(float(nll_sum), int(n_tok))
        finally:
            if pinned:
                self.adapter_registry.release(adapter)

    def _encode_chat(self, messages: List[dict]):
        try:
            key = json.dumps(messages, sort_keys=True)
        except (TypeError, ValueError):
            return encode_chat_messages(self.template, self.tokenizer,
                                        messages)
        with self._encode_memo_lock:
            hit = self._encode_memo.get(key)
            if hit is not None:
                self._encode_memo.move_to_end(key)
                return hit
        out = encode_chat_messages(self.template, self.tokenizer, messages)
        with self._encode_memo_lock:
            self._encode_memo[key] = out
            while len(self._encode_memo) > 32:
                self._encode_memo.popitem(last=False)
        return out

    def chat(self, messages: List[dict], max_new_tokens: int = 128,
             temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
             adapter: str = "", trace_id: str = "", tenant: str = "") -> str:
        prompt_ids, stop_ids = self._encode_chat(messages)
        out = self.generate(prompt_ids, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_p=top_p, seed=seed,
                            stop_ids=stop_ids, adapter=adapter,
                            trace_id=trace_id, tenant=tenant)
        return self.tokenizer.decode(out, skip_special_tokens=True)

    def chat_stream(self, messages: List[dict], max_new_tokens: int = 128,
                    temperature: float = 0.0, top_p: float = 1.0,
                    seed: int = 0, adapter: str = "", trace_id: str = "",
                    tenant: str = ""):
        """Yields text deltas as tokens stream off the decode chunks."""
        prompt_ids, stop_ids = self._encode_chat(messages)
        req = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          temperature=temperature, top_p=top_p, seed=seed,
                          stop_ids=stop_ids, adapter=adapter,
                          trace_id=trace_id, tenant=tenant)
        sent = ""
        acc: List[int] = []
        while True:
            t = req.stream.get()
            if t is None:
                break
            acc.append(t)
            text = self.tokenizer.decode(acc, skip_special_tokens=True)
            if len(text) > len(sent) and not text.endswith("�"):
                yield text[len(sent):]
                sent = text
        if req.error:
            raise RuntimeError(req.error)

    def close(self):
        self._shutdown.set()
        self._wake.set()
        self._thread.join(timeout=30)
        # requests the scheduler will never serve, parked sessions
        # included: fail them so callers do not sit out their timeouts
        self._fail_all("engine shut down")
        if self.adapter_registry is not None:
            self.adapter_registry.close()  # no loader outlives the engine
