"""Speculative decoding for the batched engine: the port of
``datatunerx_tpu/serving/speculative.py``.

A draft model proposes ``k`` tokens, the target runs ONE verify forward
over ``[pending, d_0..d_{k-1}]``, and a batched acceptance rule keeps the
longest agreeing prefix plus one corrected token:

- greedy (``temperature <= 0``): a proposal is accepted iff it equals the
  target argmax at its position, so the stream is token-identical to
  plain greedy decode;
- sampled: Leviathan/Chen rejection sampling (accept ``d_j`` with
  probability ``min(1, p_j(d_j)/q_j(d_j))``, the residual
  ``norm(max(p - q, 0))`` at the first rejection, the bonus from
  ``p_k``), every draw from the slot's threefry key through the port's
  twin of ``jax.random`` (``ops/prng.py``), in the reference's split order.

Slots live in PENDING-TOKEN form while spec runs: the last emitted token's
KV is not written yet, so one verify forward yields the target's
distributions at every proposed position. ``--spec_tree WxD`` drafts a
tree of W chains of depth D instead, verified in one forward under the
branch ancestry mask (siblings share a rope position), after which
``compact_window`` keeps only the accepted path.

``SpecPrograms`` holds the state machine's steps as plain functions on
tensors (the reference jits them; eager PyTorch has nothing to compile).
Keys live on the host as ``[S, 2]`` uint32 arrays: their evolution never
depends on a sampled value. Uniforms for the acceptance tests and the
fused epilogue cross to the device as ``[S, k]`` / ``[S]`` arrays; the
draws over a vocabulary (the legacy sampler's and the residual's
``categorical``) take the step's keys to the device and make their
``[S, V]`` bits there (``prng.categorical``)."""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from datatunerx_tpu_torch.models.llama import forward, init_cache
from datatunerx_tpu_torch.ops import prng
from datatunerx_tpu_torch.ops.attention import compact_window
from datatunerx_tpu_torch.ops.cuda_sampling import fused_sample, sample_rows
from datatunerx_tpu_torch.serving.engine import _sample_jit

# ------------------------------------------------------------- tree topology
@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """``--spec_tree WxD``: W draft chains of depth D sharing the pending
    root. The verify window flattens depth-major: column 0 is the pending
    token, node (depth j, branch b) sits at column ``1 + (j-1)*W + b`` with
    rope position ``pos + j``."""

    width: int
    depth: int

    @property
    def step_tokens(self) -> int:
        """Tokens one tree step writes a slot (pending + every node): the
        write overshoot, the window width, the verify columns."""
        return 1 + self.width * self.depth

    def __str__(self) -> str:
        return f"{self.width}x{self.depth}"


def parse_spec_tree(spec: str) -> TreeSpec:
    """Parse a ``"WxD"`` string (``--spec_tree``)."""
    err = (f"spec_tree must be 'WxD' (branch width x draft depth, e.g. "
           f"'4x3'), got {spec!r}")
    parts = str(spec).strip().lower().split("x")
    if len(parts) != 2:
        raise ValueError(err)
    try:
        width, depth = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(err) from None
    if not 1 <= width <= 64 or not 1 <= depth <= 16:
        raise ValueError(
            f"spec_tree {spec!r} out of range: width must be in [1, 64] "
            "and depth in [1, 16]")
    return TreeSpec(width, depth)


def _widths_tuple(width, depth=None) -> tuple:
    """Per-depth widths: ``(W, D)`` ints are the rectangle ``(W,) * D``; a
    sequence is a learned ragged shape. Widths must not increase with
    depth, which keeps every branch chain prefix-live."""
    if depth is not None:
        ws = (int(width),) * int(depth)
    else:
        ws = tuple(int(w) for w in width)
    if not ws or any(w < 1 for w in ws):
        raise ValueError(f"tree widths must all be >= 1, got {ws}")
    if any(b > a for a, b in zip(ws, ws[1:])):
        raise ValueError(
            f"tree widths must be non-increasing (branch chains must be "
            f"prefix-live), got {ws}")
    return ws


def _width_offsets(ws: tuple) -> list:
    """Window column of each depth's first node (column 0 is the root)."""
    offs, c = [], 1
    for w in ws:
        offs.append(c)
        c += w
    return offs


def tree_verify_mask(width, depth=None) -> np.ndarray:
    """The ``[T, T]`` branch ancestry mask of the verify forward: column c
    may attend window column c' iff c' is on c's root-to-self path."""
    ws = _widths_tuple(width, depth)
    offs = _width_offsets(ws)
    T = 1 + sum(ws)
    mask = np.zeros((T, T), dtype=bool)
    mask[0, 0] = True
    for j, w in enumerate(ws, start=1):
        for b in range(w):
            c = offs[j - 1] + b
            mask[c, 0] = True
            for i in range(1, j + 1):
                mask[c, offs[i - 1] + b] = True
    return mask


def tree_draft_mask(width, j: int) -> np.ndarray:
    """The window mask of the draft's depth-``j`` forward: branch b sees the
    root, its own ancestors and its own lane, never a sibling chain."""
    ws = _widths_tuple(width, j) if isinstance(width, int) else \
        _widths_tuple(width)
    offs = _width_offsets(ws)
    w = ws[j - 1]
    mask = np.zeros((w, 1 + sum(ws[:j])), dtype=bool)
    for b in range(w):
        mask[b, 0] = True
        for i in range(1, j + 1):
            mask[b, offs[i - 1] + b] = True
    return mask


# ------------------------------------------------------------- sampling math
def sampling_probs(logits: torch.Tensor, temps: torch.Tensor,
                   top_ps: torch.Tensor, exact_topp: bool = True
                   ) -> torch.Tensor:
    """The distributions ``_sample_jit`` samples from, ``[S, ..., V]``
    float32 for logits ``[S, ..., V]`` and per-row ``temps``/``top_ps``
    ``[S]``: a one-hot argmax where ``temperature <= 0``, else the top-p
    truncated, renormalized softmax of ``logits / t`` computed in sorted
    space (ties in index order). ``exact_topp=False`` is the fast path for
    batches where no row filters (every ``top_p >= 1``): plain softmax."""
    x = logits.to(torch.float32)
    S, V = x.shape[0], x.shape[-1]
    shape = (S,) + (1,) * (x.dim() - 1)
    t = temps.to(torch.float32).reshape(shape)
    tp = top_ps.to(torch.float32).reshape(shape)
    greedy = torch.zeros_like(x).scatter_(
        -1, torch.argmax(x, dim=-1, keepdim=True), 1.0)
    scaled = x / t.clamp(min=1e-6)
    if exact_topp:
        svals, sidx = torch.sort(scaled, dim=-1, descending=True,
                                 stable=True)
        probs = torch.softmax(svals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cut = (cum - probs > tp) & (tp < 1.0)
        kept = torch.where(cut, torch.zeros_like(probs), probs)
        kept = kept / kept.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        sampled = torch.zeros_like(x).scatter_(-1, sidx, kept)
    else:
        sampled = torch.softmax(scaled, dim=-1)
    return torch.where(t <= 0.0, greedy, sampled)


def _residual_draw(keys: np.ndarray, probs: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, log(max(probs, 1e-30)))`` a row, with
    the reference's log (``prng.xla_log``)."""
    logp = prng.xla_log(probs.clamp(min=1e-30))
    return prng.categorical(prng.to_device(keys, probs.device), logp)


def accept_tokens(p_probs: torch.Tensor, q_probs: torch.Tensor,
                  draft_toks: torch.Tensor, temps: torch.Tensor,
                  keys: np.ndarray, spec_on: torch.Tensor):
    """The rejection/residual acceptance of every row (the reference's
    ``accept_tokens``, vmapped). ``p_probs [S, k+1, V]``: the target's
    distributions at the k proposed positions and the bonus position;
    ``q_probs [S, k, V]``: the draft's; ``draft_toks [S, k]``. Returns
    ``(n_accept [S], extra_token [S], new keys [S, 2])``: a row emits
    ``draft_toks[:n_accept]`` then ``extra_token``. ``spec_on`` False rows
    accept nothing and draw from the plain ``p_0``."""
    S, k = draft_toks.shape
    dev = p_probs.device
    halves = prng.split(keys, 3)
    new_keys, u_key, x_key = halves[:, 0], halves[:, 1], halves[:, 2]
    us = torch.from_numpy(prng.uniform(u_key, (k,))).to(dev)  # [S, k]
    d = draft_toks.long()
    rows = torch.arange(S, device=dev)
    p_at = torch.gather(p_probs[:, :k], 2, d[..., None])[..., 0]
    q_at = torch.gather(q_probs, 2, d[..., None])[..., 0]
    greedy = temps <= 0.0
    tgt = torch.argmax(p_probs, dim=-1)  # [S, k+1]
    ok_sampled = (us * q_at <= p_at) & (q_at > 0.0)
    ok_greedy = d == tgt[:, :k]
    on = spec_on.to(torch.bool)
    ok = torch.where(greedy[:, None], ok_greedy, ok_sampled) & on[:, None]
    a = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    p_a = p_probs[rows, a]
    q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
    q_a = torch.where(on[:, None], q_pad[rows, a], torch.zeros_like(p_a))
    resid = (p_a - q_a).clamp(min=0.0)
    tot = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(tot > 0.0, resid / tot.clamp(min=1e-30), p_a)
    extra_s = _residual_draw(x_key, resid)
    extra = torch.where(greedy, tgt[rows, a], extra_s)
    return a.to(torch.int32), extra.to(torch.int32), new_keys


def _tree_tables(ws: tuple):
    """Static tables of a widths shape: column of (depth j, branch b)
    clamped to the depth's live width ``col [D, W]``, each node's parent
    column ``pred [D, W]``, and liveness ``live [D, W]``."""
    W, D = ws[0], len(ws)
    offs = _width_offsets(ws)
    col = np.array([[offs[j] + min(b, ws[j] - 1) for b in range(W)]
                    for j in range(D)], np.int64)
    pred = np.zeros((D, W), np.int64)
    for j in range(1, D):
        for b in range(W):
            pred[j, b] = offs[j - 1] + min(b, ws[j - 1] - 1)
    live = np.array([[b < ws[j] for b in range(W)] for j in range(D)])
    return col, pred, live, offs


def _tree_greedy(tgt: torch.Tensor, d_toks: torch.Tensor, ws: tuple,
                 on: torch.Tensor):
    """Greedy tree acceptance from the target argmax at every column
    ``tgt [S, T]``: each branch's surviving depth, the first deepest
    branch, and the argmax at its divergence."""
    col, pred, live, offs = _tree_tables(ws)
    dev = tgt.device
    pred_t = torch.from_numpy(pred).to(dev)
    live_t = torch.from_numpy(live).to(dev)
    ok = (d_toks.long() == tgt[:, pred_t]) & live_t[None] & on[:, None, None]
    a_per_b = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)  # [S, W]
    b_sel = torch.argmax(a_per_b, dim=1)  # the first maximum wins
    a = torch.gather(a_per_b, 1, b_sel[:, None])[:, 0]
    offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    leaf = torch.where(a == 0, torch.zeros_like(b_sel),
                       offs_t[(a - 1).clamp(min=0)] + b_sel)
    extra = torch.gather(tgt, 1, leaf[:, None])[:, 0]
    return a, b_sel, extra


def accept_tree_tokens(p_cols: torch.Tensor, q_tree: torch.Tensor,
                       d_toks: torch.Tensor, temps: torch.Tensor,
                       keys: np.ndarray, spec_on: torch.Tensor, *,
                       width: int = 0, depth: int = 0,
                       widths: Optional[tuple] = None):
    """Tree acceptance of every row (the reference's
    ``accept_tree_tokens``, vmapped). ``p_cols [S, T, V]``: the target's
    distributions at every window column; ``q_tree [S, D, W, V]``: the
    draft distribution each node was drawn from (``q_tree[:, 0]`` the
    shared root); ``d_toks [S, D, W]`` (dead ragged lanes -1, their q
    zero). Greedy: the deepest surviving branch (first on ties) and the
    argmax at its divergence. Sampled: SpecInfer-style recursive rejection
    across the depth-1 siblings, then the chain rule down the accepted
    branch. Returns ``(n_accept, branch, extra_token, new keys)``."""
    ws = _widths_tuple(widths) if widths is not None else \
        _widths_tuple(width, depth)
    W, D = ws[0], len(ws)
    S = p_cols.shape[0]
    dev = p_cols.device
    halves = prng.split(keys, 3)
    new_keys, u_key, x_key = halves[:, 0], halves[:, 1], halves[:, 2]
    n_u = W + D - 1
    us = (torch.from_numpy(prng.uniform(u_key, (n_u,))).to(dev) if n_u
          else torch.zeros((S, 0), device=dev))
    greedy = temps <= 0.0
    on = spec_on.to(torch.bool)
    rows = torch.arange(S, device=dev)
    d = d_toks.long()

    # ---- sampled: W-round sibling rejection at depth 1
    r = p_cols[:, 0]
    q0 = q_tree[:, 0, 0]
    b_star = torch.full((S,), -1, dtype=torch.int64, device=dev)
    accepted = torch.zeros((S,), dtype=torch.bool, device=dev)
    for b in range(W):
        x = d[:, 0, b].clamp(min=0)
        q_at = torch.gather(q0, 1, x[:, None])[:, 0]
        r_at = torch.gather(r, 1, x[:, None])[:, 0]
        ok = (~accepted) & on & (q_at > 0.0) & (us[:, b] * q_at <= r_at)
        b_star = torch.where(ok, torch.full_like(b_star, b), b_star)
        accepted = accepted | ok
        r_new = (r - q0).clamp(min=0.0)
        tot = r_new.sum(dim=-1, keepdim=True)
        r_new = torch.where(tot > 0.0, r_new / tot.clamp(min=1e-30), r)
        r = torch.where(((~accepted) & on)[:, None], r_new, r)

    # ---- chain rule down the accepted branch (depths 2..D)
    col, _, _, _ = _tree_tables(ws)
    bsafe = b_star.clamp(min=0)
    toks_b = d[rows, :, bsafe]                                   # [S, D]
    cols_b = torch.from_numpy(col).to(dev)[:, bsafe].T           # [S, D]
    p_b = p_cols[rows[:, None], cols_b]                          # [S, D, V]
    q_b = q_tree[rows, :, bsafe]                                 # [S, D, V]
    if D > 1:
        t1 = toks_b[:, 1:].clamp(min=0)
        p_at = torch.gather(p_b[:, :-1], 2, t1[..., None])[..., 0]
        q_at = torch.gather(q_b[:, 1:], 2, t1[..., None])[..., 0]
        ok_chain = (us[:, W:] * q_at <= p_at) & (q_at > 0.0)
        nacc = torch.cumprod(ok_chain.to(torch.int32), dim=1).sum(dim=1)
    else:
        nacc = torch.zeros((S,), dtype=torch.int64, device=dev)
    a_sampled = torch.where(accepted, 1 + nacc, torch.zeros_like(nacc))
    resid = (p_b[:, :-1] - q_b[:, 1:]).clamp(min=0.0)
    tots = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(tots > 0.0, resid / tots.clamp(min=1e-30),
                        p_b[:, :-1])
    table = torch.cat([r[:, None], resid, p_b[:, -1:]], dim=1)  # [S, D+1, V]
    extra_s = _residual_draw(x_key, table[rows, a_sampled.long()])

    # ---- greedy: pure argmax comparison per node
    tgt = torch.argmax(p_cols, dim=-1)
    a_g, b_g, extra_g = _tree_greedy(tgt, d, ws, on)

    a = torch.where(greedy, a_g, a_sampled)
    branch = torch.where(greedy, b_g, bsafe)
    extra = torch.where(greedy, extra_g, extra_s)
    return (a.to(torch.int32), branch.to(torch.int32), extra.to(torch.int32),
            new_keys)


# --------------------------------------------------------------- draft model
def build_draft(spec_draft: str, target_cfg, target_params,
                target_vocab: Optional[int] = None, device="cpu"):
    """``--spec_draft_config`` → ``(draft_cfg, draft_params)``.

    - ``take:N``: the target's first N blocks with its embedding, final
      norm and unembedding (views of the target's tensors: no extra device
      memory for any of them);
    - anything else: a model path or ``preset:`` loaded by the model
      loader; its vocabulary must be the target's.

    The draft reads its dense per-slot cache through the gather path
    (``paged_kernel`` off)."""
    if spec_draft.startswith("take:"):
        n = int(spec_draft.split(":", 1)[1])
        if not 1 <= n <= target_cfg.num_layers:
            raise ValueError(
                f"spec draft take:{n} out of range for a "
                f"{target_cfg.num_layers}-layer target")
        dcfg = dataclasses.replace(
            target_cfg, num_layers=n, name=f"{target_cfg.name}-take{n}",
            paged_kernel=False)
        dparams = dict(target_params)
        dparams["layers"] = _take_layers(target_params["layers"], n)
        return dcfg, dparams
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer,
    )

    dcfg, dparams, _ = load_model_and_tokenizer(
        spec_draft, dtype=torch.bfloat16, device=device)
    want = target_vocab or target_cfg.vocab_size
    if dcfg.vocab_size != want:
        raise ValueError(
            f"spec draft vocab {dcfg.vocab_size} != target vocab {want}; "
            "speculative verification needs one shared vocabulary")
    if getattr(dcfg, "paged_kernel", False):
        dcfg = dataclasses.replace(dcfg, paged_kernel=False)
    return dcfg, dparams


def _take_layers(tree, n: int):
    return {k: _take_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


# ---------------------------------------------------------------- controller
class AdaptiveK:
    """Host-side acceptance-rate controller: per-slot EMAs gate rows out of
    drafting, the global EMA shrinks ``k`` and (``mode="auto"``) falls back
    to the plain pending-form decode entirely, re-probing every
    ``probe_every`` plain steps. Observed from the scheduler thread, read
    from HTTP threads (the lock keeps the small dicts consistent)."""

    def __init__(self, k_max: int, mode: str = "auto", floor: float = 0.35,
                 alpha: float = 0.25, min_obs: int = 4,
                 probe_every: int = 64, tree: Optional[TreeSpec] = None):
        if k_max < 1:
            raise ValueError(f"spec_k must be >= 1, got {k_max}")
        self.k_max = int(k_max)
        self.tree = tree
        self.mode = mode
        self.floor = float(floor)
        self.alpha = float(alpha)
        self.min_obs = int(min_obs)
        self.probe_every = int(probe_every)
        self.global_ema: Optional[float] = None
        self._slot_ema: Dict[int, Tuple[float, int]] = {}
        self._slot_off: Dict[int, bool] = {}
        self._plain_streak = 0
        self.disabled_events = 0
        self._lock = threading.Lock()

    def observe(self, rows: List[Tuple[int, int, int]]):
        """``rows`` = [(slot, accepted, k)] for every row that drafted."""
        with self._lock:
            for slot, accepted, k in rows:
                rate = accepted / k if k else 0.0
                ema, n = self._slot_ema.get(slot, (rate, 0))
                ema = ema + self.alpha * (rate - ema)
                self._slot_ema[slot] = (ema, n + 1)
                if n + 1 >= self.min_obs and ema < self.floor:
                    if not self._slot_off.get(slot):
                        self.disabled_events += 1
                    self._slot_off[slot] = True
                g = self.global_ema if self.global_ema is not None else rate
                self.global_ema = g + self.alpha * (rate - g)
            if rows:
                self._plain_streak = 0

    def note_plain_step(self):
        with self._lock:
            self._plain_streak += 1

    def reset_slot(self, slot: int):
        """A released slot's next tenant starts with a clean history."""
        with self._lock:
            self._slot_ema.pop(slot, None)
            self._slot_off.pop(slot, None)

    def force_off_slot(self, slot: int):
        """Hard per-slot disable (the draft could not be primed)."""
        with self._lock:
            self._slot_off[slot] = True
            self._slot_ema[slot] = (0.0, self.min_obs)

    def slot_enabled(self, slot: int) -> bool:
        with self._lock:
            return not self._slot_off.get(slot, False)

    def current_k(self) -> int:
        with self._lock:
            return self.current_k_locked()

    def use_spec(self) -> bool:
        """Whether this tick drafts at all: ``on`` pins it; ``auto`` backs
        off while the global EMA sits under the floor, with probes."""
        if self.mode == "on":
            return True
        with self._lock:
            g = self.global_ema
            streak = self._plain_streak
        if g is None or g >= self.floor:
            return True
        return streak >= self.probe_every

    def current_plan(self) -> tuple:
        """``("chain", k)`` or ``("tree", widths)``."""
        with self._lock:
            return self.current_plan_locked()

    def current_plan_locked(self) -> tuple:
        if self.tree is None:
            return ("chain", self.current_k_locked())
        g = self.global_ema
        if g is None or g >= 0.6:
            w = self.tree.width
        elif g >= 0.3:
            w = max(1, self.tree.width // 2)
        else:
            w = 1
        return ("tree", (w,) * self.tree.depth)

    def snapshot(self) -> dict:
        with self._lock:
            plan = self.current_plan_locked()
            return {
                "k": self.current_k_locked(),
                "plan": [list(p) if isinstance(p, tuple) else p
                         for p in plan],
                "global_ema": self.global_ema,
                "slots": {s: round(e, 4)
                          for s, (e, _) in self._slot_ema.items()},
                "slots_off": sorted(s for s, off in self._slot_off.items()
                                    if off),
                "disabled_events": self.disabled_events,
            }

    def current_k_locked(self) -> int:
        g = self.global_ema
        if g is None or g >= 0.6:
            return self.k_max
        if g >= 0.3:
            return max(1, self.k_max // 2)
        return 1

    def export_slot_state(self, slot: int) -> dict:
        """JSON-safe controller state of one slot's session."""
        with self._lock:
            ema = self._slot_ema.get(slot)
            plan = self.current_plan_locked()
            return {
                "slot_ema": list(ema) if ema is not None else None,
                "slot_off": bool(self._slot_off.get(slot, False)),
                "global_ema": self.global_ema,
                "plan": [list(p) if isinstance(p, tuple) else p
                         for p in plan],
            }

    def import_slot_state(self, slot: int, state) -> None:
        """Warm the slot from an exported state; the global EMA is adopted
        only when this controller has none."""
        if not isinstance(state, dict):
            return
        with self._lock:
            ema = state.get("slot_ema")
            if isinstance(ema, (list, tuple)) and len(ema) == 2:
                self._slot_ema[slot] = (float(ema[0]), int(ema[1]))
            if state.get("slot_off"):
                self._slot_off[slot] = True
            g = state.get("global_ema")
            if g is not None and self.global_ema is None:
                self.global_ema = float(g)


class AdaptiveTree(AdaptiveK):
    """Learned tree shapes: per-depth survival EMAs pick each depth's width
    from ``{1, ceil(W/2), W}`` (monotone non-increasing), and a decisive
    draft-root margin caps the root's width at 1 (the draft-side early
    exit)."""

    DECISIVE_MARGIN = 4.0
    DECISIVE_EMA = 0.9

    def __init__(self, k_max: int, mode: str = "auto",
                 tree: Optional[TreeSpec] = None, **kw):
        if tree is None:
            raise ValueError("AdaptiveTree requires a TreeSpec")
        super().__init__(k_max, mode=mode, tree=tree, **kw)
        self._depth_ema: List[Optional[float]] = [None] * tree.depth
        self._decisive_ema: Optional[float] = None

    def observe_tree(self, depth_fracs, decisive_frac) -> None:
        with self._lock:
            for j, f in enumerate(depth_fracs[:len(self._depth_ema)]):
                e = self._depth_ema[j]
                self._depth_ema[j] = float(f) if e is None else \
                    e + self.alpha * (float(f) - e)
            d = self._decisive_ema
            self._decisive_ema = float(decisive_frac) if d is None else \
                d + self.alpha * (float(decisive_frac) - d)

    def _bucket(self, ema: Optional[float]) -> int:
        W = self.tree.width
        if ema is None or ema >= 0.6:
            return W
        if ema >= 0.3:
            return max(1, -(-W // 2))
        return 1

    def current_plan_locked(self) -> tuple:
        g = self.global_ema
        if g is not None and g < 0.3:
            return ("tree", (1,) * self.tree.depth)
        ws, cap = [], self.tree.width
        for j in range(self.tree.depth):
            w = min(self._bucket(self._depth_ema[j]), cap)
            if j == 0 and self._decisive_ema is not None \
                    and self._decisive_ema >= self.DECISIVE_EMA:
                w = 1
            ws.append(w)
            cap = w
        return ("tree", tuple(ws))

    def snapshot(self) -> dict:
        doc = super().snapshot()
        with self._lock:
            doc["depth_ema"] = [None if e is None else round(e, 4)
                                for e in self._depth_ema]
            doc["decisive_ema"] = None if self._decisive_ema is None \
                else round(self._decisive_ema, 4)
        return doc

    def export_slot_state(self, slot: int) -> dict:
        state = super().export_slot_state(slot)
        with self._lock:
            state["depth_ema"] = list(self._depth_ema)
            state["decisive_ema"] = self._decisive_ema
        return state

    def import_slot_state(self, slot: int, state) -> None:
        super().import_slot_state(slot, state)
        if not isinstance(state, dict):
            return
        with self._lock:
            de = state.get("depth_ema")
            if isinstance(de, (list, tuple)):
                for j, e in enumerate(de[:len(self._depth_ema)]):
                    if e is not None and self._depth_ema[j] is None:
                        self._depth_ema[j] = float(e)
            d = state.get("decisive_ema")
            if d is not None and self._decisive_ema is None:
                self._decisive_ema = float(d)


# ------------------------------------------------------------- the programs
def _emit(cand: torch.Tensor, a: torch.Tensor, extra: torch.Tensor,
          stops: torch.Tensor, remaining: torch.Tensor,
          participate: torch.Tensor, pending: torch.Tensor):
    """Emission of a spec step: the accepted prefix then the extra token,
    truncated by the row's stop set (a stop is never emitted) and budget,
    either of which deactivates the row. ``cand [S, n]`` holds the path's
    tokens with -1 past them. Returns ``(emitted, remaining, active,
    pending)``."""
    n = cand.shape[1]
    idx = torch.arange(n + 1, device=cand.device)[None, :]
    ext = torch.cat([cand, torch.full_like(cand[:, :1], -1)], dim=1)
    a = a.to(torch.int64)
    c = torch.where(idx < a[:, None], ext,
                    torch.where(idx == a[:, None], extra[:, None].to(
                        ext.dtype), torch.full_like(ext, -1)))
    is_stop = ((c[:, :, None] == stops[:, None, :]).any(dim=2)) & (c >= 0)
    navail = a + 1
    stop_idx = torch.where(is_stop, idx, torch.full_like(idx, n + 2)).amin(1)
    n_emit = torch.minimum(torch.minimum(navail, stop_idx),
                           remaining.to(torch.int64))
    n_emit = torch.where(participate, n_emit, torch.zeros_like(n_emit))
    emitted = torch.where(idx < n_emit[:, None], c, torch.full_like(c, -1))
    new_remaining = remaining - n_emit.to(remaining.dtype)
    new_active = participate & (n_emit == navail) & (new_remaining > 0)
    pending = torch.where(new_active, extra.to(pending.dtype), pending)
    return emitted.to(torch.int32), new_remaining, new_active, pending


class SpecPrograms:
    """The steps of the speculative state machine, on tensors of one device
    (the target's cache and the draft's dense per-slot cache are updated in
    place; ``len`` leaves are replaced). Keys are host ``[S, 2]`` arrays;
    every method that draws returns the new keys.

    ``epilogue`` is ``"on"`` (draws through the fused sampling epilogue,
    K9 on the card) or ``"off"`` (the legacy sampler); ``mode`` arguments
    are the engine's static batch sampling mode ("greedy" | "simple" |
    "topp"), or "off" where the reference passes its epilogue sentinel."""

    def __init__(self, tcfg, dcfg, epilogue: str = "off"):
        self.tcfg = tcfg
        self.dcfg = dcfg
        self.epilogue = epilogue

    # ---- one batched token draw
    def _sample(self, logits, temps, top_ps, sub: np.ndarray, mode: str,
                batch: str):
        """A token a row from ``sub`` keys (not split): the legacy sampler
        when the epilogue or ``mode`` is off, else the fused epilogue with
        one uniform a row. ``batch`` is the batch's sampling mode: an
        all-greedy batch takes the argmax without a draw."""
        if mode == "off" or self.epilogue == "off":
            if batch == "greedy":
                return _sample_jit(logits, temps, top_ps, None)
            return _sample_jit(logits, temps, top_ps,
                               prng.to_device(sub, logits.device))
        us = None
        if mode != "greedy":
            us = torch.from_numpy(prng.uniform(sub)).to(logits.device)
        return fused_sample(logits, temps, top_ps, us, mode=mode)

    def _draw(self, logits, temps, top_ps, keys, mode, batch):
        """Split every row's key (half 0 kept) and draw from half 1: the
        legacy split-then-sample pair, or ``sample_rows`` (the same split
        order) through the epilogue."""
        if mode == "off" or self.epilogue == "off":
            halves = prng.split(keys)
            return (self._sample(logits, temps, top_ps, halves[:, 1], "off",
                                 batch), halves[:, 0])
        return sample_rows(logits, temps, top_ps, keys, mode=mode)

    # ---- logits form → pending form (the first emitted token)
    def enter(self, logits, pending, remaining, active, keys, temps, top_ps,
              stops, fresh_h: np.ndarray, *, mode: str, batch: str):
        """Sample each fresh row's first token from its held logits (the
        plain step's split-then-draw), emit it and make it the row's
        pending token; ``fresh_h`` is the host mask of fresh rows. The
        cache is untouched: the token's KV is written by the row's first
        verify or pending forward."""
        fresh = torch.from_numpy(fresh_h).to(pending.device)
        nxt, keys2 = self._draw(logits, temps, top_ps, keys, mode, batch)
        is_stop = (nxt[:, None] == stops).any(dim=1)
        emit = fresh & active & ~is_stop & (remaining > 0)
        emitted = torch.where(emit, nxt, torch.full_like(nxt, -1))
        new_active = torch.where(fresh, emit & (remaining > 1), active)
        remaining = remaining - emit.to(remaining.dtype)
        pending = torch.where(emit, nxt, pending)
        keys = np.where(fresh_h[:, None], keys2, keys).astype(np.uint32)
        return emitted, pending, remaining, new_active, keys

    # ---- draft prefill of one slot's context
    def prime(self, dparams, dcache, slot: int, tokens, mask, positions,
              prime_len: int):
        """Prefill ``tokens`` through the draft into a fresh row and install
        it as ``slot``'s row of the draft cache."""
        W = dcache["k"].shape[2]
        dev = dcache["k"].device
        row = init_cache(self.dcfg, 1, W, dtype=torch.bfloat16, device=dev)
        _, row = forward(dparams, tokens, self.dcfg, positions=positions,
                         attention_mask=mask, cache=row,
                         compute_dtype=torch.bfloat16)
        dcache["k"][:, slot] = row["k"][:, 0]
        dcache["v"][:, slot] = row["v"][:, 0]
        dcache["pos"][slot] = row["pos"][0]
        dcache["len"][slot] = prime_len
        return dcache

    def _lora_kw(self, lora, adapter_idx):
        return dict(lora=lora, lora_adapter_idx=(adapter_idx if lora
                                                 is not None else None))

    # ---- the chain super-step: propose k, verify once, accept
    def step(self, tparams, dparams, lora, tcache, dcache, pending, pos,
             remaining, active, keys, temps, top_ps, stops, adapter_idx,
             spec_on, *, k: int, mode: str):
        S = pending.shape[0]
        dev = pending.device
        participate = active
        drow = participate & spec_on
        d_len0 = dcache["len"].clone()
        t_len0 = tcache["len"].clone()
        exact = mode == "topp"
        dmask = drow[:, None].to(torch.int32)
        cur, d_all, q_all = pending, [], []
        for i in range(k + 1):
            dlogits, dcache = forward(
                dparams, cur[:, None], self.dcfg, positions=(pos + i)[:, None],
                attention_mask=dmask, cache=dcache,
                compute_dtype=torch.bfloat16)
            if i == k:
                break  # the last forward only writes d_{k-1}'s KV
            last = dlogits[:, -1]
            if mode == "greedy":
                nxt = torch.argmax(last, dim=-1).to(torch.int32)
            else:
                nxt, keys = self._draw(last, temps, top_ps, keys, mode, mode)
                q_all.append(sampling_probs(last, temps, top_ps, exact))
            d_all.append(nxt)
            cur = nxt
        if mode != "greedy":
            # the reference's scan draws in its (k+1)-th iteration too,
            # and discards the sample: its key split still happens
            keys = prng.split(keys)[:, 0]
        d_toks = torch.stack(d_all, dim=1)                     # [S, k]
        vtoks = torch.cat([pending[:, None], d_toks], dim=1)
        vpos = pos[:, None] + torch.arange(k + 1, dtype=pos.dtype,
                                           device=dev)[None, :]
        vmask = torch.cat([participate[:, None],
                           drow[:, None].expand(S, k)], dim=1)
        vlogits, tcache = forward(
            tparams, vtoks, self.tcfg, positions=vpos,
            attention_mask=vmask.to(torch.int32), cache=tcache,
            compute_dtype=torch.bfloat16, **self._lora_kw(lora, adapter_idx))
        if mode == "greedy":
            tgt = torch.argmax(vlogits, dim=-1)
            ok = (d_toks.long() == tgt[:, :k]) & drow[:, None]
            a = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
            extra = torch.gather(tgt, 1, a[:, None].long())[:, 0]
        else:
            q_dists = torch.stack(q_all, dim=1)                # [S, k, V]
            p_dists = sampling_probs(vlogits, temps, top_ps, exact)
            a, extra, keys = accept_tokens(p_dists, q_dists, d_toks, temps,
                                           keys, drow)
        a = torch.where(participate, a, torch.zeros_like(a))
        emitted, remaining, active, pending = _emit(
            d_toks.to(torch.int64), a, extra, stops, remaining, participate,
            pending)
        adv = torch.where(participate, 1 + a, torch.zeros_like(a)).to(
            pos.dtype)
        pos = pos + adv
        tcache["len"] = t_len0 + adv
        dcache["len"] = d_len0 + torch.where(drow, adv, torch.zeros_like(adv))
        return (emitted, a, tcache, dcache, pending, pos, remaining, active,
                keys)

    # ---- the tree super-step
    def tree_step(self, tparams, dparams, lora, tcache, dcache, pending, pos,
                  remaining, active, keys, temps, top_ps, stops, adapter_idx,
                  spec_on, *, widths: tuple, mode: str):
        ws = _widths_tuple(widths)
        W, D = ws[0], len(ws)
        T = 1 + sum(ws)
        S = pending.shape[0]
        dev = pending.device
        participate = active
        drow = participate & spec_on
        d_len0 = dcache["len"].clone()
        t_len0 = tcache["len"].clone()
        exact = mode == "topp"
        dsub = "off" if self.epilogue == "off" else mode

        dlogits, dcache = forward(
            dparams, pending[:, None], self.dcfg, positions=pos[:, None],
            attention_mask=drow[:, None].to(torch.int32), cache=dcache,
            compute_dtype=torch.bfloat16)
        l0 = dlogits[:, -1]
        order = torch.sort(l0, dim=-1, descending=True, stable=True)[1]
        top2 = torch.gather(l0, 1, order[:, :2])
        margin = top2[:, 0] - top2[:, 1]
        V = l0.shape[-1]
        if mode == "greedy":
            # distinct top-W roots, ties in index order (jax.lax.top_k's)
            cur = order[:, :W].to(torch.int32)
            q0 = None
        else:
            split = prng.split(keys, W + 1)
            keys = split[:, 0]
            cur = torch.stack([self._sample(l0, temps, top_ps,
                                            split[:, 1 + b], dsub, mode)
                               for b in range(W)], dim=1)
            q0 = sampling_probs(l0, temps, top_ps, exact)
        d_depth, q_depth = [cur], [q0]
        for j in range(1, D + 1):
            wj = ws[j - 1]
            wmask = torch.from_numpy(tree_draft_mask(ws, j)).to(dev)
            dlogits, dcache = forward(
                dparams, cur[:, :wj], self.dcfg,
                positions=(pos + j)[:, None].expand(S, wj),
                attention_mask=drow[:, None].expand(S, wj).to(torch.int32),
                cache=dcache, compute_dtype=torch.bfloat16,
                window_mask=wmask[None].expand(S, wj, wmask.shape[1]),
                window_start=d_len0)
            if j == D:
                break
            wn = ws[j]
            if mode == "greedy":
                nxt = torch.argmax(dlogits[:, :wn], dim=-1).to(torch.int32)
                qj = None
            else:
                split = prng.split(keys, wn + 1)
                keys = split[:, 0]
                nxt = torch.stack([self._sample(dlogits[:, b], temps, top_ps,
                                                split[:, 1 + b], dsub, mode)
                                   for b in range(wn)], dim=1)
                qn = sampling_probs(dlogits[:, :wn], temps, top_ps, exact)
                qj = torch.nn.functional.pad(qn, (0, 0, 0, W - wn))
            cur = torch.nn.functional.pad(nxt, (0, W - wn), value=-1)
            d_depth.append(cur)
            q_depth.append(qj)
        d_toks = torch.stack(d_depth, dim=1)                   # [S, D, W]

        vtoks = torch.cat([pending[:, None]]
                          + [d_toks[:, j, :ws[j]] for j in range(D)], dim=1)
        depth_of = np.concatenate([[0]] + [[j] * ws[j - 1]
                                           for j in range(1, D + 1)])
        vpos = pos[:, None] + torch.from_numpy(depth_of.astype(np.int32)).to(
            dev)[None, :]
        vmask = torch.cat([participate[:, None],
                           drow[:, None].expand(S, T - 1)], dim=1)
        wmask_v = torch.from_numpy(tree_verify_mask(ws)).to(dev)
        vlogits, tcache = forward(
            tparams, vtoks, self.tcfg, positions=vpos,
            attention_mask=vmask.to(torch.int32), cache=tcache,
            compute_dtype=torch.bfloat16,
            window_mask=wmask_v[None].expand(S, T, T), window_start=t_len0,
            **self._lora_kw(lora, adapter_idx))
        if mode == "greedy":
            tgt = torch.argmax(vlogits, dim=-1)
            a, b_sel, extra = _tree_greedy(tgt, d_toks, ws, drow)
        else:
            p_cols = sampling_probs(vlogits, temps, top_ps, exact)
            q_tree = torch.stack([q_depth[0][:, None].expand(S, W, V)]
                                 + q_depth[1:], dim=1)          # [S, D, W, V]
            a, b_sel, extra, keys = accept_tree_tokens(
                p_cols, q_tree, d_toks, temps, keys, drow, widths=ws)
        a = torch.where(participate, a.to(torch.int64), torch.zeros_like(
            a, dtype=torch.int64))
        b_sel = torch.where(drow, b_sel.to(torch.int64),
                            torch.zeros_like(b_sel, dtype=torch.int64))
        path = torch.gather(d_toks.to(torch.int64), 2,
                            b_sel[:, None, None].expand(S, D, 1))[:, :, 0]
        emitted, remaining, active, pending = _emit(
            path, a, extra, stops, remaining, participate, pending)

        col, _, _, _ = _tree_tables(ws)
        src_cols = torch.from_numpy(col.T.copy()).to(dev)[b_sel]  # [S, D]
        compact_window(tcache, participate, t_len0, src_cols, a, pos, T)
        compact_window(dcache, drow, d_len0, src_cols, a, pos, T)
        adv = torch.where(participate, 1 + a, torch.zeros_like(a)).to(
            pos.dtype)
        pos = pos + adv
        tcache["len"] = t_len0 + adv
        dcache["len"] = d_len0 + torch.where(drow, adv, torch.zeros_like(adv))
        return (emitted, a.to(torch.int32), tcache, dcache, pending, pos,
                remaining, active, keys, margin)

    # ---- plain decode in pending form (the never-slower fallback)
    def decode(self, tparams, lora, tcache, pending, pos, remaining, active,
               keys, temps, top_ps, stops, adapter_idx, *, K: int, mode: str,
               batch: str):
        rows = []
        for _ in range(K):
            prev_len = tcache["len"]
            logits, tcache = forward(
                tparams, pending[:, None], self.tcfg, positions=pos[:, None],
                attention_mask=active[:, None].to(torch.int32), cache=tcache,
                compute_dtype=torch.bfloat16,
                **self._lora_kw(lora, adapter_idx))
            act = active.to(prev_len.dtype)
            tcache["len"] = prev_len + act
            pos = pos + act.to(pos.dtype)
            nxt, keys = self._draw(logits[:, -1], temps, top_ps, keys, mode,
                                   batch)
            is_stop = (nxt[:, None] == stops).any(dim=1)
            emit = active & ~is_stop & (remaining > 0)
            rows.append(torch.where(emit, nxt, torch.full_like(nxt, -1)))
            active = emit & (remaining > 1)
            remaining = remaining - emit.to(remaining.dtype)
            pending = torch.where(emit, nxt, pending)
        return (torch.stack(rows), tcache, pending, pos, remaining, active,
                keys)

    # ---- pending form → logits form (before a park)
    def settle(self, tparams, lora, tcache, pending, pos, adapter_idx,
               onehot):
        prev_len = tcache["len"]
        logits, tcache = forward(
            tparams, pending[:, None], self.tcfg, positions=pos[:, None],
            attention_mask=onehot[:, None].to(torch.int32), cache=tcache,
            compute_dtype=torch.bfloat16, **self._lora_kw(lora, adapter_idx))
        oh = onehot.to(prev_len.dtype)
        tcache["len"] = prev_len + oh
        pos = pos + oh.to(pos.dtype)
        return logits[:, -1], tcache, pos
