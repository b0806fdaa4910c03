"""Continuous-batching inference engine: the port of the cold-admission
paths of ``datatunerx_tpu/serving/batched_engine.py`` over both cache layouts.

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
- decode runs in CHUNKS of K tokens: a Python loop of K single-token steps
  with every operand on the device; the one host sync per chunk is the
  transfer of the emitted tokens (and the active mask) that lets
  ``Request.push`` stream them.
- with ``paged_kernel`` on (paged layout only), decode attention is the
  paged decode kernel (K7) and prefill chunks the multi-token kernel (K8);
  with ``sampling_epilogue`` on, each step samples through the fused
  sampling kernel (K9). ``auto`` means on under CUDA. Off gives the gather
  path and the legacy sampler.

The scheduler thread owns every piece of slot state; callers only enqueue
requests. The caches are updated in place.

The port refuses what it does not carry yet (prefix cache, adapters,
speculative decoding, overcommit, tenancy): each such argument raises
``ValueError`` naming its ROADMAP item.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

import torch

from datatunerx_tpu_torch.data.templates import Template, get_template
from datatunerx_tpu_torch.models.llama import forward, init_cache
from datatunerx_tpu_torch.ops.cuda_sampling import sample_rows
from datatunerx_tpu_torch.ops.paged_attention import (
    POS_SENTINEL,
    BlockAllocator,
    blocks_for_depth,
    init_paged_cache,
)
from datatunerx_tpu_torch.serving.engine import _sample_jit, encode_chat_messages
from datatunerx_tpu_torch.utils.decoding import DECODE_BUCKET, prepare_prompt
from datatunerx_tpu_torch.utils.model_loader import load_model_and_tokenizer

MAX_STOP = 8  # static per-slot stop-token capacity

# what each refused argument waits for (ROADMAP Queue 1)
_NOT_PORTED = {
    "prefix_cache": "item 2 (prefix cache and KV overcommit)",
    "kv_overcommit": "item 2 (prefix cache and KV overcommit)",
    "checkpoint_path": "item 3 (adapters and tenancy)",
    "adapters": "item 3 (adapters and tenancy)",
    "adapter_pool": "item 3 (adapters and tenancy)",
    "tenants": "item 3 (adapters and tenancy)",
    "host_adapter_cache_mb": "item 3 (adapters and tenancy)",
    "spec_draft": "item 5 (speculative decoding)",
    "spec_tree": "item 5 (speculative decoding)",
}


def _refuse(arg: str):
    raise ValueError(
        f"{arg} is not ported to the PyTorch engine yet: ROADMAP Queue 1 "
        f"{_NOT_PORTED[arg]}")


def _mode(value, name: str) -> str:
    mode = value if isinstance(value, str) else ("on" if value else "off")
    mode = (mode or "auto").strip().lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{name} must be auto|on|off, got {value!r}")
    return mode


def _resolve_auto(value, name: str, cuda: bool) -> bool:
    mode = _mode(value, name)
    return mode == "on" or (mode == "auto" and cuda)


class Request:
    def __init__(self, prompt_ids: Sequence[int], max_new_tokens: int,
                 temperature: float, top_p: float, seed: int,
                 stop_ids: Sequence[int], trace_id: str = ""):
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.stop_ids = list(stop_ids)[:MAX_STOP]
        self.trace_id = trace_id
        self.tokens: List[int] = []
        self.stream: "queue.Queue[Optional[int]]" = queue.Queue()
        self.done = threading.Event()
        self.error: Optional[str] = None
        # latency stamps: plain attribute writes from the scheduler thread
        self.t_submit = time.perf_counter()
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None

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
        adapters: Optional[Dict[str, str]] = None,
        adapter_pool: int = 0,
        template: str = "llama2",
        max_seq_len: int = 1024,
        slots: int = 4,
        decode_chunk: int = 8,
        kv_quant: Optional[str] = None,
        prefix_cache: int = 0,
        kv_block_size: int = 0,
        kv_blocks: Optional[int] = None,
        kv_overcommit: str = "off",
        paged_kernel: str = "auto",  # paged attention kernels: auto|on|off
        spec_draft: Optional[str] = None,
        spec_tree: Optional[str] = None,
        sampling_epilogue: str = "auto",  # fused sampling kernel: auto|on|off
        prefill_chunk: int = 256,
        prefill_token_budget: int = 0,
        tenants=None,
        host_adapter_cache_mb: float = 0.0,
        seed: int = 0,  # preset weights' random init
        device="cuda",
    ):
        for arg, val in (("checkpoint_path", checkpoint_path),
                         ("adapters", adapters),
                         ("adapter_pool", adapter_pool),
                         ("prefix_cache", prefix_cache),
                         ("kv_overcommit", (kv_overcommit or "off") != "off"),
                         ("spec_draft", spec_draft),
                         ("spec_tree", spec_tree),
                         ("tenants", tenants),
                         ("host_adapter_cache_mb", host_adapter_cache_mb)):
            if val:
                _refuse(arg)
        self.kv_quant = kv_quant or None
        if self.kv_quant not in (None, "int8"):
            raise ValueError(
                f"unsupported cache quantization {self.kv_quant!r}")
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

        self.paged = kv_block_size > 0
        self.block_size = int(kv_block_size)
        if _mode(paged_kernel, "paged_kernel") == "on" and not self.paged:
            raise ValueError(
                "--paged_kernel on requires the paged KV cache "
                "(--kv_block_size > 0)")
        self.paged_kernel = self.paged and _resolve_auto(
            paged_kernel, "paged_kernel", cuda)
        if self.paged_kernel:
            import dataclasses

            self.cfg = dataclasses.replace(self.cfg, paged_kernel=True)
        self.sampling_epilogue = "on" if _resolve_auto(
            sampling_epilogue, "sampling_epilogue", cuda) else "off"
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
        # per-slot sampling randomness: one seeded generator per slot, one
        # uniform per slot per decode step (see ops/cuda_sampling.py)
        self._gens = [torch.Generator(device=dev).manual_seed(i)
                      for i in range(slots)]

        self._slot_req: List[Optional[Request]] = [None] * slots
        self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        self._decode_ready: List[bool] = [False] * slots
        # slot → in-progress chunked-prefill state, in admission order
        self._pending: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._waiting: "queue.Queue[Request]" = queue.Queue()
        self._waiting_front: "collections.deque[Request]" = collections.deque()
        self._wake = threading.Event()
        self._shutdown = threading.Event()
        self._dead: Optional[str] = None  # set when the scheduler died
        self._encode_memo: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._encode_memo_lock = threading.Lock()
        # scheduler-tick trace, for tests and TTFT/TPOT forensics:
        # ("admit", slot, plen, "chunked" | "dense") /
        # ("prefill", slot, ntokens) /
        # ("activate", slot) / ("decode", K) / ("finish", slot)
        self.sched_trace: "collections.deque[tuple]" = \
            collections.deque(maxlen=4096)
        # one record per completed request: TTFT and per-token decode time
        # measured on the host clock at the chunk's designed sync point
        self.request_stats: "collections.deque[dict]" = \
            collections.deque(maxlen=4096)

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
    def kv_cache_bytes(self) -> int:
        """Device bytes of the K/V leaves and, for an int8 cache, their
        scales (the position table and cursors are not counted)."""
        return sum(t.numel() * t.element_size()
                   for name, t in self._cache.items()
                   if name in ("k", "v", "k_scale", "v_scale"))

    def _trace(self, *event):
        self.sched_trace.append(event)

    # ------------------------------------------------------------ scheduler
    def _take_waiting(self) -> Optional[Request]:
        if self._waiting_front:
            return self._waiting_front.popleft()
        try:
            return self._waiting.get_nowait()
        except queue.Empty:
            return None

    def _admit_waiting(self):
        for slot in range(self.slots):
            if self._slot_req[slot] is not None:
                continue
            while True:
                req = self._take_waiting()
                if req is None:
                    return
                try:
                    ok = self._admit_slot(req, slot)
                except Exception as e:  # noqa: BLE001 — fail request, not loop
                    self._complete(req, error=str(e))
                    continue
                if ok:
                    break
                # KV blocks exhausted: the FIFO head waits for freed blocks
                self._waiting_front.appendleft(req)
                return

    def _admit_slot(self, req: Request, slot: int) -> bool:
        """Occupy ``slot`` with ``req``. Dense: prefill monolithically and
        arm the slot at once. Paged: reserve the slot's blocks (False = pool
        exhausted; the request stays queued), install its table, scrub the
        blocks' recycled positions to the sentinel (chunked prefill reveals
        the whole table to attention before every lane is written), rewind
        the slot's cursor and register the prompt for chunked prefill."""
        ids, mask, positions, plen, n_prompt, max_new, _ = prepare_prompt(
            req.prompt_ids, self.tokenizer.eos_token_id,
            self.max_seq_len, req.max_new_tokens)
        if not self.paged:
            self._admit_dense(req, slot, ids, mask, positions, plen,
                              n_prompt, max_new)
            return True
        blocks = self._allocator.alloc(blocks_for_depth(
            plen + max_new, self.block_size, cap_depth=self.max_seq_len))
        if blocks is None:
            return False
        try:
            row = torch.full((self.blocks_per_slot,), -1, dtype=torch.int32)
            row[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
            self._cache["block_tables"][slot] = row.to(self.device)
            self._cache["pos"][torch.tensor(blocks, device=self.device)] = \
                POS_SENTINEL
            self._cache["len"][slot] = 0
        except Exception:
            self._allocator.free(blocks)
            raise
        self._slot_blocks[slot] = blocks
        self._slot_req[slot] = req
        self._decode_ready[slot] = False
        self._pending[slot] = {
            "req": req, "ids": ids, "mask": mask, "positions": positions,
            "plen": plen, "n_prompt": n_prompt, "max_new": max_new, "done": 0,
        }
        self._trace("admit", slot, plen, "chunked")
        return True

    def _admit_dense(self, req: Request, slot: int, ids, mask, positions,
                     plen: int, n_prompt: int, max_new: int):
        """Dense admission: prefill the bucketed prompt into a fresh one-row
        cache (scalar cursor) in one forward, copy the row — K/V, scales and
        positions, sentinel lanes included, which scrubs what the slot's last
        request left — into the slot's row, set its cursor and arm it."""
        dev = self.device
        row = init_cache(self.cfg, 1, self.max_seq_len, dtype=torch.bfloat16,
                         quantize=self.kv_quant, device=dev)
        logits, row = forward(
            self.params, torch.tensor([ids], dtype=torch.int32, device=dev),
            self.cfg,
            positions=torch.tensor([positions], dtype=torch.int32, device=dev),
            attention_mask=torch.tensor([mask], dtype=torch.int32, device=dev),
            cache=row, compute_dtype=torch.bfloat16)
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in self._cache:
                self._cache[name][:, slot] = row[name][:, 0]
        self._cache["pos"][slot] = row["pos"][0]
        self._cache["len"][slot] = plen
        self._slot_req[slot] = req
        self._trace("admit", slot, plen, "dense")
        self._arm_slot(slot, req, logits[0, plen - 1], plen, n_prompt,
                       max_new)

    def _prefill_chunk_fn(self, slot: int, ids, mask, positions):
        """One chunk of a slot's prompt written straight into its blocks of
        the SHARED pool (a one-row view of the cursor and table). Returns the
        chunk's last-token logits [V]."""
        dev = self.device
        view = dict(self._cache)
        view["len"] = self._cache["len"][slot:slot + 1]
        view["block_tables"] = self._cache["block_tables"][slot:slot + 1]
        logits, new = forward(
            self.params, torch.tensor([ids], dtype=torch.int32, device=dev),
            self.cfg,
            positions=torch.tensor([positions], dtype=torch.int32, device=dev),
            attention_mask=torch.tensor([mask], dtype=torch.int32, device=dev),
            cache=view, compute_dtype=torch.bfloat16)
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
                try:
                    logits = self._prefill_chunk_fn(
                        slot, st["ids"][lo:lo + c], st["mask"][lo:lo + c],
                        st["positions"][lo:lo + c])
                except Exception as e:  # noqa: BLE001 — fail request, not loop
                    self._release_slot(slot)
                    self._complete(req, error=str(e))
                    break
                st["done"] += c
                spent += c
                self._trace("prefill", slot, c)
                if st["done"] >= st["plen"]:
                    self._finish_prefill(slot, st, logits)
                    break
            if spent >= budget:
                break

    def _finish_prefill(self, slot: int, st: dict, row_logits):
        """Arm a chunk-prefilled slot's decode state."""
        del self._pending[slot]
        self._arm_slot(slot, st["req"], row_logits, st["plen"],
                       st["n_prompt"], st["max_new"])

    def _arm_slot(self, slot: int, req: Request, row_logits, plen: int,
                  n_prompt: int, max_new: int):
        """Set a prefilled slot's decode state: its last-token logits, rope
        position, token budget (clamped to the room left after ``plen``
        cache lanes), sampling parameters, stop ids and generator."""
        max_new = max(1, min(max_new, self.max_seq_len - plen))
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
        self._gens[slot] = torch.Generator(device=self.device).manual_seed(
            int(req.seed))
        self._decode_ready[slot] = True
        self._trace("activate", slot)

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

    def _draw_uniforms(self, K: int) -> torch.Tensor:
        """[K, S] uniforms: K draws from each slot's own generator."""
        return torch.stack([torch.rand(K, generator=g, device=self.device)
                            for g in self._gens], dim=1)

    def _decode_chunk(self, K: int, mode: str) -> torch.Tensor:
        """K single-token decode steps over every slot, all on the device.
        Returns ``[K + 1, S]`` int32: the emitted tokens (-1 = none) and, in
        the last row, the post-chunk active mask."""
        us = self._draw_uniforms(K)
        logits, cache = self._logits, self._cache
        pos, remaining, active = self._pos, self._remaining, self._active
        temps, top_ps, stops = self._temps, self._top_ps, self._stops
        rows = []
        for step in range(K):
            if mode == "off":
                nxt = _sample_jit(logits, temps, top_ps, us[step])
            else:
                nxt = sample_rows(logits, temps, top_ps, us[step], mode=mode)
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
                attention_mask=emit_i[:, None], cache=cache,
                compute_dtype=torch.bfloat16)
            # forward advances every cursor; only emitting slots really moved
            cache["len"] = prev_len + emit_i
            pos = pos + emit_i
            logits = logits2[:, -1]
        self._logits, self._cache = logits, cache
        self._pos, self._remaining, self._active = pos, remaining, active
        rows.append(active.to(torch.int32))
        return torch.stack(rows)

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
        while True:
            req = self._take_waiting()
            if req is None:
                break
            req.finish(error=error)
        for req in self._slot_req:
            if req is not None and not req.done.is_set():
                req.finish(error=error)

    def _scheduler_loop(self):
        while not self._shutdown.is_set():
            self._admit_waiting()
            self._prefill_tick()
            if not any(self._decode_ready):
                if self._pending:
                    continue  # keep prefilling; nothing to decode yet
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            try:
                mode = self._epilogue_mode()
                out = self._decode_chunk(self.chunk, mode)
                self.sampling_stats["fused_steps" if mode != "off"
                                    else "legacy_steps"] += 1
                self._trace("decode", self.chunk)
                # the decode loop's ONE designed sync point: K tokens per
                # chunk (and the active mask) cross to the host together
                host = out.cpu()
            except Exception as e:  # noqa: BLE001 — device fault: fail all in-flight
                for slot, req in enumerate(self._slot_req):
                    if req is not None:
                        self._release_slot(slot)
                        self._complete(req, error=str(e))
                continue
            emitted, active = host[:-1].tolist(), host[-1].tolist()
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
                    self._complete(req)
                    self._trace("finish", slot)

    def _release_slot(self, slot: int):
        self._slot_req[slot] = None
        self._pending.pop(slot, None)
        self._decode_ready[slot] = False
        blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
        if blocks:
            # clear the table FIRST: a masked decode write from this slot
            # must never land in a block the allocator has already re-issued
            self._cache["block_tables"][slot] = -1
            self._allocator.free(blocks)

    def _complete(self, req: Request, error: Optional[str] = None):
        n = len(req.tokens)
        if req.first_token_ts is not None:
            tpot = None
            if req.last_token_ts is not None and n > 1:
                tpot = (req.last_token_ts - req.first_token_ts) / (n - 1)
            self.request_stats.append({
                "trace_id": req.trace_id,
                "ttft_s": req.first_token_ts - req.t_submit,
                "tpot_s": tpot, "tokens": n})
        req.finish(error=error)

    # ---------------------------------------------------------------- API
    @property
    def adapter_ids(self) -> Dict[str, int]:
        """Known adapter names (the base model only in this slice)."""
        return {"": 0}

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 128,
               temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
               stop_ids: Optional[set] = None, adapter: str = "",
               trace_id: str = "") -> Request:
        if self._dead:
            raise RuntimeError(self._dead)
        if adapter:
            raise KeyError(f"unknown adapter {adapter!r}; adapters are not "
                           "ported yet (ROADMAP Queue 1 item 3)")
        stops = {int(s) for s in (stop_ids or set())}
        stops.add(int(self.tokenizer.eos_token_id))
        req = Request(prompt_ids, max_new_tokens, temperature, top_p, seed,
                      sorted(stops),
                      trace_id=trace_id or f"dtx-{uuid.uuid4().hex[:16]}")
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
             adapter: str = "", trace_id: str = "") -> str:
        prompt_ids, stop_ids = self._encode_chat(messages)
        out = self.generate(prompt_ids, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_p=top_p, seed=seed,
                            stop_ids=stop_ids, adapter=adapter,
                            trace_id=trace_id)
        return self.tokenizer.decode(out, skip_special_tokens=True)

    def chat_stream(self, messages: List[dict], max_new_tokens: int = 128,
                    temperature: float = 0.0, top_p: float = 1.0,
                    seed: int = 0, adapter: str = "", trace_id: str = ""):
        """Yields text deltas as tokens stream off the decode chunks."""
        prompt_ids, stop_ids = self._encode_chat(messages)
        req = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          temperature=temperature, top_p=top_p, seed=seed,
                          stop_ids=stop_ids, adapter=adapter,
                          trace_id=trace_id)
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
        # requests the scheduler will never serve: fail them so callers do
        # not sit out their timeouts
        self._fail_all("engine shut down")
