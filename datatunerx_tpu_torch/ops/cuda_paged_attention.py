"""In-place paged attention over the block pool: the port of
``datatunerx_tpu/ops/pallas_paged_attention.py``.

K7 (one-token decode) and K8 (multi-token chunks) are hand-written CUDA in
``csrc/paged_attention.cu`` (the bf16 K8 on tensor cores, the rest on CUDA
cores); the design note there says what bounds them and why they keep the
reference's two passes. K7 splits each slot's table (``decode_splits``)
into the blocks of one thread-block cluster per head group, which exchange
the splits' (m, l), merged in split order, and their partial outputs,
summed in split order, through distributed shared memory: one launch a
call, no workspace. Pools are q's dtype (bf16/f32), or
int8 with f32 scale pools ``[NB+1, bs, KV]``: the int8 instantiations
dequantize each staged tile as ``kv_dequantize`` does (f32 product, rounded
through q's dtype), so they read what the gather path reads. K7 takes
head dims 8..128 in steps of 8; in K8 head dims that are not a multiple
of 16 (int8), 8 (bf16) or 4 (f32) take an element-wise staging loop
instead of 16-byte loads. Each wrapper below launches its
kernel for CUDA tensors (or raises) and runs the kernel's plain PyTorch
version, which repeats the kernel's arithmetic block by block, only for CPU
tensors — the port's counterpart of Pallas interpret mode. Both read the
pools through the tables in place; the gathered view of the gather path
(``ops/attention.kv_cache_update`` + ``xla_attention``) never exists.

``paged_decode_attention.launches`` and ``paged_multitoken_attention.launches``
count the wrapper calls that launched their kernels (plain-version calls
are not counted); ``.int8_launches`` counts those of them that ran the
int8 instantiation, and ``paged_decode_attention.last_split`` holds the
``(splits, entries per split)`` of K7's last launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from datatunerx_tpu_torch.ops import _build
from datatunerx_tpu_torch.ops.attention import kv_dequantize, softmax_scale

NEG_INF = -1e30  # finite: -inf - -inf would NaN
_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_pools(q, k_pool, v_pool, k_scale, v_scale) -> bool:
    """The pools' dtype rule, on any device: q's dtype with no scales, or
    int8 with both f32 scale pools ``[NB+1, bs, KV]``. Returns whether the
    pools are int8."""
    _require(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
             f"pools must be matching [NB, bs, KV, d], got "
             f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    _require(k_pool.dtype == v_pool.dtype,
             f"pools differ in dtype: {k_pool.dtype} and {v_pool.dtype}")
    if k_pool.dtype != torch.int8:
        _require(k_pool.dtype == q.dtype and k_scale is None
                 and v_scale is None,
                 f"pools must be q's dtype {q.dtype} without scale pools, or "
                 f"int8 with both scale pools; got {k_pool.dtype} pools"
                 + (" with scale pools" if k_scale is not None
                    or v_scale is not None else ""))
        return False
    _require(k_scale is not None and v_scale is not None,
             "int8 pools need both scale pools (k_scale, v_scale)")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _require(t.dtype == torch.float32
                 and tuple(t.shape) == tuple(k_pool.shape[:3])
                 and t.device == k_pool.device,
                 f"{name} must be float32 {tuple(k_pool.shape[:3])} on "
                 f"{k_pool.device}, got {t.dtype} {tuple(t.shape)} on "
                 f"{t.device}")
    return True


def _check_cuda_operands(q, k_pool, v_pool, k_scale, v_scale, tables):
    """What the kernels index memory by: devices, dtypes, contiguity and
    the shapes tying q, the pools and the tables together."""
    _require(q.device.type == "cuda",
             f"paged attention kernels run on CUDA tensors, got {q.device}")
    _require(k_pool.shape[-1] == q.shape[-1],
             f"head dim of q {q.shape[-1]} != pools' {k_pool.shape[-1]}")
    _require(q.shape[-2] % k_pool.shape[2] == 0,
             f"H={q.shape[-2]} is not a multiple of KV={k_pool.shape[2]}")
    _require(tables.dim() == 2 and tables.shape[0] == q.shape[0]
             and tables.device == q.device,
             f"tables must be [B={q.shape[0]}, nbps] on {q.device}")
    _require(q.dtype in _KERNEL_DTYPES,
             f"paged attention kernels take bf16/f32, got {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is None:
            continue
        _require(t.device == q.device,
                 f"{name} must be on {q.device}, got {t.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(tables.dtype == torch.int32 and tables.is_contiguous(),
             "block tables must be contiguous int32")


def _kernel(name: str, q, quant: bool):
    """The C entry point: ``dtx_paged_<name>[_i8]_<bf16|f32>``."""
    return getattr(_build.library(),
                   f"dtx_paged_{name}{'_i8' if quant else ''}_"
                   f"{_KERNEL_DTYPES[q.dtype]}")


def _scale_ptrs(quant: bool, k_scale, v_scale):
    return (k_scale.data_ptr(), v_scale.data_ptr()) if quant else ()


# ------------------------------------------------------------------- plain
def _block(pool, scale_pool, tbl_j, dtype):
    """One table column's blocks ``[B, bs, KV, d]`` as f32: int8 pools
    dequantized by their scales through ``dtype``, as the gather path's
    ``kv_dequantize`` (and the kernels' staging step) does."""
    blk = pool[tbl_j]
    if scale_pool is not None:
        blk = kv_dequantize(blk, scale_pool[tbl_j], dtype)
    return blk.to(torch.float32)


def _plain_paged_attention(q, k_pool, v_pool, k_scale, v_scale, tables,
                           lane_mask):
    """The kernels' arithmetic in PyTorch, vectorised over slots and heads:
    q ``[B, T, H, d]``; ``lane_mask(j) -> [B, T, bs]`` bool says which lanes
    of table column j each query row may attend. Pass 0 builds the f32
    running max/normaliser over the live blocks in table order; pass 1 rounds
    ``exp(s - m) / max(l, 1e-30)`` to q's dtype before the f32 PV product.
    int8 pools are dequantized block by block."""
    B, T, H, d = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    nbps = tables.shape[1]
    scale = softmax_scale(d)
    qf = q.to(torch.float32).reshape(B, T, KV, G, d).permute(0, 2, 3, 1, 4)
    live = tables >= 0
    tbl = torch.where(live, tables, torch.zeros_like(tables)).long()
    m = torch.full((B, KV, G, T), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, T, d), dtype=torch.float32, device=q.device)

    def masked_scores(j):
        kt = _block(k_pool, k_scale, tbl[:, j], q.dtype)
        s = torch.einsum("bkgtd,bskd->bkgts", qf, kt) * scale
        ok = lane_mask(j)[:, None, None, :, :]  # [B, 1, 1, T, bs]
        return torch.where(ok, s, torch.full_like(s, NEG_INF))

    for j in range(nbps):
        s = masked_scores(j)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l_new = l * torch.exp(m - m_new) + torch.exp(
            s - m_new[..., None]).sum(dim=-1)
        on = live[:, j][:, None, None, None]
        m = torch.where(on, m_new, m)
        l = torch.where(on, l_new, l)
    l_row = l.clamp(min=1e-30)[..., None]
    for j in range(nbps):
        s = masked_scores(j)
        p = (torch.exp(s - m[..., None]) / l_row).to(q.dtype).to(torch.float32)
        vt = _block(v_pool, v_scale, tbl[:, j], q.dtype)
        upd = torch.einsum("bkgts,bskd->bkgtd", p, vt)
        acc = torch.where(live[:, j][:, None, None, None, None], acc + upd,
                          acc)
    return acc.permute(0, 3, 1, 2, 4).reshape(B, T, H, d).to(q.dtype)


def _plain_decode(q, k_pool, v_pool, tables, pos_pool, q_positions,
                  k_scale=None, v_scale=None):
    """K7's plain version: q ``[B, H, d]`` → ``[B, H, d]``."""
    qp = q_positions.to(torch.int64)[:, None, None]  # [B, 1, 1]

    def lane_mask(j):
        blk = torch.where(tables[:, j] >= 0, tables[:, j],
                          torch.zeros_like(tables[:, j])).long()
        return pos_pool[blk][:, None, :].to(torch.int64) <= qp  # [B, 1, bs]

    return _plain_paged_attention(q[:, None], k_pool, v_pool, k_scale,
                                  v_scale, tables, lane_mask)[:, 0]


def _plain_multitoken(q, k_pool, v_pool, tables, allow, k_scale=None,
                      v_scale=None):
    """K8's plain version: q ``[B, T, H, d]``, allow ``[B, T, nbps*bs]``."""
    bs = k_pool.shape[1]
    ok = allow.to(torch.bool)

    def lane_mask(j):
        return ok[:, :, j * bs:(j + 1) * bs]

    return _plain_paged_attention(q, k_pool, v_pool, k_scale, v_scale,
                                  tables, lane_mask)


# ----------------------------------------------------------------- wrappers
def paged_decode_attention(
    q: torch.Tensor,          # [B, H, d] — the decode step's single token
    k_pool: torch.Tensor,     # [NB+1, bs, KV, d] one layer's block pool
    v_pool: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # [NB+1, bs, KV] f32 (int8 pools) | None
    v_scale: Optional[torch.Tensor],
    tables: torch.Tensor,     # [B, nbps] int32, -1 = unallocated
    pos_pool: torch.Tensor,   # [NB+1, bs] int32, POST-write
    q_positions: torch.Tensor,  # [B] int32 rope position of the query token
) -> torch.Tensor:
    """In-place paged decode attention (K7): out ``[B, H, d]`` in q.dtype.
    Slots whose tables hold no valid block produce zeros."""
    quant = _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return _plain_decode(q, k_pool, v_pool, tables, pos_pool, q_positions,
                             k_scale, v_scale)
    B, H, d = q.shape
    _, bs, KV, _ = k_pool.shape
    _check_cuda_operands(q, k_pool, v_pool, k_scale, v_scale, tables)
    _require(pos_pool.dtype == torch.int32 and pos_pool.is_contiguous()
             and tuple(pos_pool.shape) == tuple(k_pool.shape[:2])
             and pos_pool.device == q.device,
             f"pos pool must be contiguous int32 {tuple(k_pool.shape[:2])} "
             f"on {q.device}")
    _require(tuple(q_positions.shape) == (B,)
             and q_positions.device == q.device,
             f"q_positions must be [B={B}] on {q.device}")
    _require(d % 8 == 0 and 8 <= d <= DECODE_MAX_HEAD_DIM,
             f"the paged decode kernel takes head dims 8..."
             f"{DECODE_MAX_HEAD_DIM} in steps of 8, got {d}")
    q = q.contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nbps = tables.shape[1]
    splits, per_split = decode_splits(
        B, KV, nbps, bs,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    code = _kernel("decode", q, quant)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *_scale_ptrs(quant, k_scale, v_scale), tables.data_ptr(),
        pos_pool.data_ptr(), qpos.data_ptr(), out.data_ptr(), B, H, KV, d,
        bs, nbps, splits, per_split, softmax_scale(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged decode kernel (K7)")
    paged_decode_attention.launches += 1
    paged_decode_attention.int8_launches += quant
    paged_decode_attention.last_split = (splits, per_split)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
paged_decode_attention.last_split = None  # (splits, entries), last launch

DECODE_MAX_HEAD_DIM = 128
DECODE_MAX_SPLITS = 16  # blocks a thread-block cluster
_MIN_SPLIT_LANES = 16


def decode_splits(B: int, KV: int, nbps: int, bs: int, sms: int):
    """K7's split of a slot's table on a card of ``sms`` streaming
    multiprocessors: ``(splits, entries per split)``. Split s takes table
    entries ``[s * E, min((s + 1) * E, nbps))``, so the splits cover every
    entry once, in order, each at least one table block and
    ``_MIN_SPLIT_LANES`` lanes. The count aims at two thread blocks an SM
    over the ``B * KV * splits`` blocks, at most ``DECODE_MAX_SPLITS`` (the
    splits of a head group form one cluster)."""
    want = min(DECODE_MAX_SPLITS, max(1, -(-2 * sms // max(1, B * KV))))
    per = max(1, -(-nbps // want), -(-_MIN_SPLIT_LANES // max(1, bs)))
    per = min(per, max(1, nbps))
    return max(1, -(-nbps // per)), per


def multitoken_tile(T: int, G: int) -> int:
    """Query rows per K8 block: G*tile ≈ 64 rows share each staged tile."""
    return max(1, min(T, 64 // max(1, G)))


def paged_multitoken_attention(
    q: torch.Tensor,          # [B, T, H, d] — the step's query columns
    k_pool: torch.Tensor,     # [NB+1, bs, KV, d] one layer's block pool
    v_pool: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    tables: torch.Tensor,     # [B, nbps] int32, -1 = unallocated
    allow: torch.Tensor,      # [B, T, nbps·bs] bool, POST-write
) -> torch.Tensor:
    """In-place paged attention for q_len > 1 (K8): out ``[B, T, H, d]``.
    ``allow`` must be ``attention_allow(...)`` over the POST-write gathered
    kv positions — the one tensor the gather path biases with."""
    quant = _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    B, T, H, d = q.shape
    _, bs, KV, _ = k_pool.shape
    nbps = tables.shape[1]
    _require(tuple(allow.shape) == (B, T, nbps * bs),
             f"allow {tuple(allow.shape)} != {(B, T, nbps * bs)}")
    if q.device.type == "cpu":
        return _plain_multitoken(q, k_pool, v_pool, tables, allow, k_scale,
                                 v_scale)
    _check_cuda_operands(q, k_pool, v_pool, k_scale, v_scale, tables)
    _require(allow.device == q.device, f"allow must be on {q.device}")
    q = q.contiguous()
    allow_u8 = allow.to(torch.bool).contiguous()  # one byte per lane
    out = torch.empty_like(q)
    code = _kernel("multitoken", q, quant)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *_scale_ptrs(quant, k_scale, v_scale), tables.data_ptr(),
        allow_u8.data_ptr(), out.data_ptr(), B, T, H, KV, d, bs, nbps,
        multitoken_tile(T, H // KV), softmax_scale(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged multi-token kernel (K8)")
    paged_multitoken_attention.launches += 1
    paged_multitoken_attention.int8_launches += quant
    return out


paged_multitoken_attention.launches = 0
paged_multitoken_attention.int8_launches = 0


def paged_attention_decode_step(q, ck, cv, cks, cvs, cache: dict,
                                pos_pool, positions):
    """Model-facing wrapper: q ``[B, 1, H, d]`` (one decode token), one
    layer's pools, the live cache dict (block tables), the POST-write pos
    pool and the step's ``positions [B, 1]``. Returns ``[B, 1, H, d]`` —
    drop-in for the gather + ``xla_attention`` pair."""
    B, T, H, d = q.shape
    if T != 1:
        raise ValueError(f"paged decode kernel is single-token, got T={T}")
    out = paged_decode_attention(
        q[:, 0], ck, cv, cks, cvs, cache["block_tables"], pos_pool,
        positions[:, 0])
    return out[:, None]


def paged_attention_multitoken_step(q, ck, cv, cks, cvs, cache: dict, allow):
    """Model-facing wrapper: q ``[B, T, H, d]``, one layer's pools, the live
    cache dict and the POST-write ``allow [B, T, S]`` tensor."""
    return paged_multitoken_attention(q, ck, cv, cks, cvs,
                                      cache["block_tables"], allow)
