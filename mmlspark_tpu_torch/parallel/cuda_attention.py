"""The port's attention kernels: wrappers, plain versions, counts.

Hand-written Hopper kernels (``mmlspark_tpu_torch/csrc``) replace the
JAX package's Pallas attention kernels. On the paged decode path:

* :func:`paged_decode_attention` (K1) — one query per slot against its
  paged lane, every decode step and layer, the lane split across blocks
  (:func:`paged_decode_plan`) and the splits' partials merged by a
  second kernel in the same call (:func:`paged_merge_partials_plain` is
  its plain version);
* :func:`flash_prefill_attention` (K2) — causal attention of a cold
  prefill over the q/k/v it just computed, f32 on the tensor cores in
  3xTF32 (``csrc/tf32_mma.cuh``);
* :func:`paged_prefix_prefill_attention` (K3) — a prefix-cache hit's
  suffix queries against the slot's paged lane, in 3xTF32 like K2, the
  live keys of a short suffix split across blocks
  (:func:`paged_prefix_plan`) and merged as K1's.

On the train step (``csrc/attention_train.cu``):

* :func:`attention_fwd` — the forward with its log-sum-exp, f32 or
  bf16 inputs;
* :func:`attention_bwd` — the FlashAttention-2 backward: the dq kernel
  (:func:`attention_bwd_dq`) and the dk/dv kernel
  (:func:`attention_bwd_dkdv`);
* the differentiable :func:`flash_attention_folded` (K7, the
  transformer's ``folded`` engine) and :func:`flash_attention` (its
  ``flash`` engine, whose backward is K5) run on them. The JAX folded kernels exist to dodge the TPU's 128-lane
  padding at short head dims; the port's kernels read [B, S, H, Dh]
  directly, so one set serves both, with no layout adapter.

On the sequence-parallel train step's ring (``csrc/ring_block_attention.cu``,
K8), masked by positions instead of indices:

* :func:`ring_block_fwd` — one (query block, key/value block) pair's
  partials (unnormalized ``o``, running max ``m``, normalizer ``l``), the
  kernel under :func:`flash_block_attn` and :func:`folded_block_attn`;
* :func:`ring_block_bwd_dq` and :func:`ring_block_bwd_dkdv` — the pair's
  FlashAttention-2 backward given the ring's lse and delta
  (:mod:`~mmlspark_tpu_torch.parallel.ring_attention` runs them).

Each wrapper takes the JAX function's layout and arguments, checks
device, dtype, shape and contiguity (raising on anything else),
allocates its output with ``torch.empty`` and launches on the current
stream. A wrapper runs its ``*_plain`` PyTorch version only when it is
handed CPU tensors; for CUDA tensors it launches the kernel or raises —
there is no fallback. :data:`LAUNCHES` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mmlspark_tpu_torch.native.launch import (
    DTYPE_CODES, F, I, P, check, device_of, launch,
)

#: kernel launches per wrapper (plain-version calls never count)
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0,
                            "flash_prefill_attention": 0,
                            "paged_prefix_prefill_attention": 0,
                            "attention_fwd": 0, "attention_bwd_dq": 0,
                            "attention_bwd_dkdv": 0, "ring_block_fwd": 0,
                            "ring_block_bwd_dq": 0, "ring_block_bwd_dkdv": 0}

#: the largest head dim the kernels are built for (every transformer
#: config in the repository has Dh <= 64)
MAX_HEAD_DIM = 64

_NEG_INF = -1e30

#: streaming multiprocessors of the card the split plans are sized for
#: (an H100 SXM has 132)
CARD_SMS = 132
#: K1 aims at this many blocks over a batch whose lanes are full, so that a
#: batch whose lanes are a third full still runs more than one block an SM
_K1_BLOCKS = 4 * CARD_SMS

# C entry -> argtypes (the stream pointer follows)
_ARGTYPES = {
    "mmt_paged_decode_attention": [P] * 7 + [I] * 7 + [F],
    "mmt_flash_prefill_attention": [P] * 4 + [I] * 4 + [F],
    "mmt_paged_prefix_prefill_attention": [P] * 6 + [I] * 9 + [F],
    "mmt_attention_fwd": [P] * 5 + [I] * 5 + [F] + [I] * 3,
    "mmt_attention_bwd_dq": [P] * 7 + [I] * 5 + [F] + [I] * 2,
    "mmt_attention_bwd_dkdv": [P] * 8 + [I] * 5 + [F] + [I] * 2,
    "mmt_ring_block_fwd": [P] * 8 + [I] * 5 + [F] + [I] * 2,
    "mmt_ring_block_bwd_dq": [P] * 9 + [I] * 5 + [F] + [I] * 2,
    "mmt_ring_block_bwd_dkdv": [P] * 10 + [I] * 5 + [F] + [I] * 2,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch(entry: str, device: torch.device, *args) -> None:
    launch(entry, _ARGTYPES[entry], device, *args)


def _check_head_dim(d: int) -> None:
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}: the kernels "
                         f"have no instance for it")


# ---------------------------------------------------------------------------
# K1: paged decode attention


def paged_decode_attention_plain(q, k_pages, v_pages, page_tables, pos,
                                 scale: float, page_size: int):
    """The dense engine (transformer.py's paged step, ``attn_impl=
    "dense"``): gather every slot's whole virtual lane through its
    table, then one softmax masked to ``index <= pos``."""
    n, h, d = q.shape
    lane = page_tables.shape[1] * page_size
    lk = k_pages[page_tables].reshape(n, lane, h, d)
    lv = v_pages[page_tables].reshape(n, lane, h, d)
    s = torch.einsum("nhk,nshk->nhs", q, lk) * scale
    idx = torch.arange(lane, device=q.device)
    s = torch.where(idx[None, None, :] <= pos[:, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nhs,nshk->nhk", p, lv)


def paged_decode_plan(n_slots: int, pages_per_slot: int
                      ) -> Tuple[int, int]:
    """K1's split of the lane, from the shapes alone: ``(pages_per_split,
    n_splits)``. Split ``j`` holds table entries ``[j * pages_per_split,
    (j + 1) * pages_per_split)``, so every page of a lane lies in exactly
    one split. A launch runs ``n_splits * n_slots`` blocks; a block whose
    split starts past its slot's ``pos`` exits after reading it, so the
    live blocks are the splits that hold a page at or before ``pos``."""
    per = max(1, -(-n_slots * pages_per_slot // _K1_BLOCKS))
    return per, -(-pages_per_slot // per)


def _split_partials(s, vis, v, keys_per_split: int):
    """Every run of ``keys_per_split`` keys' softmax partial, as the split
    kernels write them: ``s`` (I, H, K) scaled scores, ``vis`` (I, 1 or H,
    K) which keys an item sees, ``v`` (I, K, H, Dh). Returns ``m``, ``l``
    (I, n, H) and the unnormalized ``acc`` (I, n, H, Dh): a run with no
    visible key has m = -1e30, l = 0, acc = 0."""
    n_items, h, k = s.shape
    n = -(-k // keys_per_split)
    pad = n * keys_per_split - k
    s = torch.nn.functional.pad(s, (0, pad)).reshape(n_items, h, n, -1)
    vis = torch.nn.functional.pad(vis, (0, pad)).reshape(
        n_items, vis.shape[1], n, -1)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        n_items, n, keys_per_split, h, v.shape[-1])
    s = torch.where(vis, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("ihnk,inkhd->inhd", p, v)
    return m.transpose(1, 2), p.sum(dim=-1).transpose(1, 2), acc


def paged_decode_partials_plain(q, k_pages, v_pages, page_tables, pos,
                                scale: float, page_size: int,
                                pages_per_split: int):
    """K1's per-split partials in plain PyTorch (``m`` in the natural-log
    domain; the kernel keeps ``m * log2 e``): ``m``, ``l`` (N, n_splits,
    H), ``acc`` (N, n_splits, H, Dh) over the dense gather of each lane,
    masked to ``index <= pos``."""
    n, h, d = q.shape
    lane = page_tables.shape[1] * page_size
    lk = k_pages[page_tables].reshape(n, lane, h, d)
    lv = v_pages[page_tables].reshape(n, lane, h, d)
    s = torch.einsum("nhk,nshk->nhs", q, lk) * scale
    vis = torch.arange(lane, device=q.device)[None, None, :] \
        <= pos[:, None, None]
    return _split_partials(s, vis, lv, pages_per_split * page_size)


def paged_merge_partials_plain(m, l, acc):
    """The split kernels' merge in plain PyTorch: per-split partials
    (split dim 1: ``m``, ``l`` (I, n, H), ``acc`` (I, n, H, Dh), ``m`` in
    the natural-log domain) merged in split order by their maxima, the
    JAX numerics: ``M = max m_j``, ``L = sum l_j e^(m_j - M)``, output
    ``(sum acc_j e^(m_j - M)) / max(L, 1e-30)``. A split with no visible
    key (m = -1e30, l = 0) weighs exactly 0. Returns (I, H, Dh)."""
    big = m.amax(dim=1)
    total = torch.zeros_like(big)
    out = torch.zeros_like(acc[:, 0])
    for j in range(m.shape[1]):
        w = torch.exp(m[:, j] - big)
        total = total + l[:, j] * w
        out = out + acc[:, j] * w[..., None]
    return out / total.clamp(min=1e-30)[..., None]


def paged_decode_attention(q, k_pages, v_pages, page_tables, pos,
                           scale: float, page_size: int):
    """One decode step of one layer: ``q`` (N, H, Dh) f32, each slot's
    query (rope applied); ``k_pages``/``v_pages`` (n_pages, page_size,
    H, Dh) f32, the layer's pool AFTER this step's K/V write;
    ``page_tables`` (N, pages_per_slot) int32; ``pos`` (N,) int32.
    Returns the normalized attention output (N, H, Dh), numerically the
    dense gather's. Table entries must be valid page indices: the
    kernel reads them unchecked."""
    dev = device_of("q", q)
    check("q", q, torch.float32, (None, None, None), dev)
    n, h, d = q.shape
    check("k_pages", k_pages, torch.float32, (None, page_size, h, d), dev)
    check("v_pages", v_pages, torch.float32, tuple(k_pages.shape), dev)
    check("page_tables", page_tables, torch.int32, (n, None), dev)
    check("pos", pos, torch.int32, (n,), dev)
    if dev.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            page_tables, pos, scale,
                                            page_size)
    _check_head_dim(d)
    pps = page_tables.shape[1]
    per, n_splits = paged_decode_plan(n, pps)
    out = torch.empty_like(q)
    # the splits' partials: acc, then (m, l) (csrc/paged_split.cuh)
    ws = torch.empty(n * n_splits * h * (d + 2), dtype=torch.float32,
                     device=dev)
    _launch("mmt_paged_decode_attention", dev, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), ws.data_ptr(), n, h, d,
            int(page_size), pps, per, n_splits, float(scale))
    LAUNCHES["paged_decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: causal flash attention for the cold prefill


def _mm(spec: str, a, b, compute_dtype):
    """Attention matmul under the JAX mixed-precision policy (``_mm`` of
    ``ring_attention.py``): inputs cast to ``compute_dtype``, products
    accumulated and returned in f32 (``preferred_element_type``);
    ``None`` = a plain einsum."""
    if compute_dtype is None:
        return torch.einsum(spec, a, b)
    return torch.einsum(spec, a.to(compute_dtype).float(),
                        b.to(compute_dtype).float())


def _causal_mask(sq: int, sk: int, device):
    """Query ``i`` sees key ``j <= i`` (the arange mask)."""
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


def dense_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, compute_dtype=None):
    """Softmax attention over [B, S, H, Dh] — the JAX package's
    ``ring_attention.dense_attention``: the scores and the output matmul
    take inputs cast to ``compute_dtype`` with f32 accumulation, the
    softmax runs in f32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = _mm("bqhd,bkhd->bhqk", q, k, compute_dtype) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _mm("bhqk,bkhd->bqhd", p, v, compute_dtype)


def flash_prefill_attention_plain(q, k, v, scale: Optional[float] = None):
    """Causal softmax attention over [B, S, H, Dh] in f32 — the JAX
    package's ``dense_attention(causal=True)``."""
    return dense_attention(q, k, v, True, scale)


def flash_prefill_attention(q, k, v, scale: Optional[float] = None):
    """Normalized causal self-attention for the in-flight prefill:
    ``q``/``k``/``v`` [B, S, H, Dh] f32 -> [B, S, H, Dh], default scale
    ``Dh ** -0.5``. On the card no [S, S] matrix is ever written."""
    dev = device_of("q", q)
    check("q", q, torch.float32, (None, None, None, None), dev)
    check("k", k, torch.float32, tuple(q.shape), dev)
    check("v", v, torch.float32, tuple(q.shape), dev)
    b, s, h, d = q.shape
    scale = float(scale) if scale is not None else d ** -0.5
    if dev.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, scale)
    _check_head_dim(d)
    out = torch.empty_like(q)
    _launch("mmt_flash_prefill_attention", dev, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, s, h, d, scale)
    LAUNCHES["flash_prefill_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: prefix-prefill attention over the paged lane


def paged_prefix_prefill_attention_plain(q, k_pages, v_pages, page_table,
                                         hit_len: int, scale: float,
                                         page_size: int):
    """The dense engine (transformer.py's prefix prefill, ``attn_impl=
    "dense"``): gather the slot's whole virtual lane, softmax the
    [S, V] scores masked to ``index <= hit_len + row``."""
    s_len, h, d = q.shape
    lane = page_table.shape[0] * page_size
    lk = k_pages[page_table].reshape(lane, h, d)
    lv = v_pages[page_table].reshape(lane, h, d)
    s = torch.einsum("shk,vhk->shv", q, lk) * scale
    qpos = hit_len + torch.arange(s_len, device=q.device)
    idx = torch.arange(lane, device=q.device)
    s = torch.where(idx[None, None, :] <= qpos[:, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("shv,vhk->shk", p, lv)


def paged_prefix_plan(seq: int, hit_len: int, n_heads: int, lane: int
                      ) -> Tuple[int, int, int]:
    """K3's grid, from the host's hit depth and shapes: ``(rows_per_tile,
    keys_per_split, n_splits)``. The live keys are ``[0, kv_end)``,
    ``kv_end = min(lane, hit_len + seq)``; query tiles are 16 rows at
    ``seq <= 16`` (32-key stages), else 32 (64-key stages). Where heads x
    query tiles fill the card the keys stay whole (one split); else they
    split into runs of whole stages, as many as bring the grid to about
    one block per SM."""
    kv_end = min(lane, hit_len + seq)
    rows = 16 if seq <= 16 else 32
    stage = 2 * rows
    blocks = n_heads * -(-seq // rows)
    stages = -(-kv_end // stage)
    per = stages if blocks >= CARD_SMS else \
        -(-stages // -(-CARD_SMS // blocks))
    return rows, stage * per, -(-stages // per)


def paged_prefix_partials_plain(q, k_pages, v_pages, page_table,
                                hit_len: int, scale: float, page_size: int,
                                keys_per_split: int):
    """K3's per-split partials in plain PyTorch, as
    :func:`paged_decode_partials_plain` (items are the suffix rows):
    ``m``, ``l`` (S, n_splits, H), ``acc`` (S, n_splits, H, Dh) over the
    whole lane masked to ``index <= hit_len + row``."""
    s_len, h, d = q.shape
    lane = page_table.shape[0] * page_size
    lk = k_pages[page_table].reshape(lane, h, d)
    lv = v_pages[page_table].reshape(lane, h, d)
    s = torch.einsum("shk,vhk->shv", q, lk) * scale
    qpos = hit_len + torch.arange(s_len, device=q.device)
    vis = torch.arange(lane, device=q.device)[None, None, :] \
        <= qpos[:, None, None]
    return _split_partials(s, vis, lv.expand(s_len, lane, h, d),
                           keys_per_split)


def paged_prefix_prefill_attention(q, k_pages, v_pages, page_table,
                                   hit_len: int, scale: float,
                                   page_size: int):
    """One layer of one slot's prefix prefill: ``q`` (S, H, Dh) f32,
    suffix queries roped at virtual positions ``hit_len + j``;
    ``k_pages``/``v_pages`` the layer's pool AFTER the suffix write;
    ``page_table`` (pages_per_slot,) int32, shared prefix pages first;
    ``hit_len`` a host int (hit depth is data, never a shape). Returns
    (S, H, Dh), numerically the dense whole-lane path."""
    dev = device_of("q", q)
    check("q", q, torch.float32, (None, None, None), dev)
    s_len, h, d = q.shape
    check("k_pages", k_pages, torch.float32, (None, page_size, h, d), dev)
    check("v_pages", v_pages, torch.float32, tuple(k_pages.shape), dev)
    check("page_table", page_table, torch.int32, (None,), dev)
    if isinstance(hit_len, bool) or not isinstance(hit_len, int) \
            or hit_len < 0:
        raise TypeError(f"hit_len must be a non-negative int, got "
                        f"{hit_len!r}")
    if dev.type == "cpu":
        return paged_prefix_prefill_attention_plain(
            q, k_pages, v_pages, page_table, hit_len, scale, page_size)
    _check_head_dim(d)
    pps = page_table.shape[0]
    rows, per, n_splits = paged_prefix_plan(s_len, hit_len, h,
                                            pps * int(page_size))
    out = torch.empty_like(q)
    ws = (torch.empty(s_len * n_splits * h * (d + 2), dtype=torch.float32,
                      device=dev) if n_splits > 1 else None)
    _launch("mmt_paged_prefix_prefill_attention", dev, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            out.data_ptr(), 0 if ws is None else ws.data_ptr(), s_len, h, d,
            int(page_size), pps, hit_len, rows, per, n_splits,
            float(scale))
    LAUNCHES["paged_prefix_prefill_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K7 (and K5): the train step's differentiable attention


def attention_fwd_plain(q, k, v, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: normalized attention (f32, [B, Sq, H, Dh]) and the
    per-row log-sum-exp (f32, [B, H, Sq]; 1e30 for a row that sees no
    key), scores from the inputs' values in f32, ``p`` rounded to the
    input dtype before ``p @ v`` as the JAX kernels cast it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)[None, None]
    else:
        mask = torch.ones((), dtype=torch.bool, device=q.device)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = l.clamp(min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    out = out / l_safe.squeeze(-1).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(l_safe), 1e30).squeeze(-1)
    return out, lse


def attention_bwd_plain(q, k, v, dout, lse, delta, causal: bool,
                        scale: float):
    """The FlashAttention-2 gradient algebra as dense einsums (the JAX
    ``_flash_bwd`` ``bwd_impl="xla"`` branch): ``p = exp(s - lse)``
    from the saved lse, ``ds = p (dp - delta)``; ``p`` and ``ds`` rounded
    to the input dtype before their products. Returns f32 ``(dq, dk,
    dv)``."""
    dt = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        p = torch.where(mask[None, None], p, 0.0)
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq, dk, dv


def _check_qkv(q, k, v):
    dev = device_of("q", q)
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be torch.float32 or torch.bfloat16, got "
                        f"{q.dtype}")
    check("q", q, q.dtype, (None, None, None, None), dev)
    b, sq, h, d = q.shape
    check("k", k, q.dtype, (b, None, h, d), dev)
    check("v", v, q.dtype, tuple(k.shape), dev)
    return dev, b, sq, k.shape[1], h, d


def attention_fwd(q, k, v, causal: bool = True,
                  scale: Optional[float] = None, out_dtype=None):
    """Attention with its log-sum-exp: ``q`` [B, Sq, H, Dh], ``k``/``v``
    [B, Sk, H, Dh], f32 or bf16 alike -> ``(out [B, Sq, H, Dh] in
    out_dtype (default q's; f32 or q's dtype), lse [B, H, Sq] f32)``.
    Causal is the arange mask (query ``i`` sees key ``j <= i``)."""
    dev, b, sq, sk, h, d = _check_qkv(q, k, v)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {q.dtype} or torch.float32")
    scale = float(scale) if scale is not None else d ** -0.5
    if dev.type == "cpu":
        out, lse = attention_fwd_plain(q, k, v, causal, scale)
        return out.to(out_dtype), lse
    _check_head_dim(d)
    out = torch.empty(b, sq, h, d, dtype=out_dtype, device=dev)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    _launch("mmt_attention_fwd", dev, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d,
            scale, int(causal), DTYPE_CODES[q.dtype],
            int(out_dtype == torch.float32))
    LAUNCHES["attention_fwd"] += 1
    return out, lse


def _check_bwd(q, k, v, dout, lse, delta, scale):
    dev, b, sq, sk, h, d = _check_qkv(q, k, v)
    check("dout", dout, q.dtype, tuple(q.shape), dev)
    check("lse", lse, torch.float32, (b, h, sq), dev)
    check("delta", delta, torch.float32, (b, h, sq), dev)
    if dev.type == "cuda":
        _check_head_dim(d)
    scale = float(scale) if scale is not None else d ** -0.5
    return dev, (b, sq, sk, h, d), scale


def _bwd_args(q, k, v, dout, lse, delta, shape, scale, causal):
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (*shape, scale, int(causal), DTYPE_CODES[q.dtype]))


def attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                     scale: Optional[float] = None):
    """The backward's dq kernel (f32 [B, Sq, H, Dh]); on CPU tensors the
    plain backward's dq."""
    dev, shape, scale = _check_bwd(q, k, v, dout, lse, delta, scale)
    if dev.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, lse, delta, causal,
                                   scale)[0]
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    ptrs, tail = _bwd_args(q, k, v, dout, lse, delta, shape, scale, causal)
    _launch("mmt_attention_bwd_dq", dev, *ptrs, dq.data_ptr(), *tail)
    LAUNCHES["attention_bwd_dq"] += 1
    return dq


def attention_bwd_dkdv(q, k, v, dout, lse, delta, causal: bool = True,
                       scale: Optional[float] = None):
    """The backward's dk/dv kernel (f32, k's shape); on CPU tensors the
    plain backward's dk, dv."""
    dev, shape, scale = _check_bwd(q, k, v, dout, lse, delta, scale)
    if dev.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, lse, delta, causal,
                                   scale)[1:]
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(k.shape, dtype=torch.float32, device=dev)
    ptrs, tail = _bwd_args(q, k, v, dout, lse, delta, shape, scale, causal)
    _launch("mmt_attention_bwd_dkdv", dev, *ptrs, dk.data_ptr(),
            dv.data_ptr(), *tail)
    LAUNCHES["attention_bwd_dkdv"] += 1
    return dk, dv


def attention_bwd(q, k, v, dout, lse, delta, causal: bool = True,
                  scale: Optional[float] = None):
    """The backward from the forward's ``q``/``k``/``v``, the output's
    cotangent ``dout`` (q's shape and dtype), ``lse`` and ``delta =
    sum(dout * out, -1)`` (both [B, H, Sq] f32) -> f32 ``(dq, dk, dv)``.
    On the card: the dq kernel, then the dk/dv kernel; no [S, S] matrix
    is ever written. On CPU tensors: :func:`attention_bwd_plain`."""
    dev, _, scale = _check_bwd(q, k, v, dout, lse, delta, scale)
    if dev.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, lse, delta, causal, scale)
    dq = attention_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    return (dq, *attention_bwd_dkdv(q, k, v, dout, lse, delta, causal,
                                    scale))


def _delta(dout, out):
    """``sum(dout * out, -1)`` in f32, as [B, H, Sq]."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = attention_fwd(q, k, v, causal, scale,
                                 out_dtype=torch.float32)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale = ctx.scale if ctx.scale is not None else q.shape[-1] ** -0.5
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = attention_bwd(q, k, v, dout, lse, _delta(dout, out),
                                   ctx.causal, scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, bwd_impl: str = "xla"):
    """Differentiable flash attention, [B, S, H, Dh] in and out (the JAX
    ``flash_attention``; Sq may differ from Sk). The forward keeps its
    output in f32 for the backward's ``delta``; the backward is
    :func:`attention_bwd` — the dq and dk/dv kernels on the card (K5),
    the plain einsums on CPU tensors. ``bwd_impl`` keeps the JAX
    signature: "xla" (the JAX default) and "pallas" choose between the
    JAX einsum and Pallas backwards, which compute the same function;
    here both run the one backward."""
    if bwd_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown bwd_impl {bwd_impl!r} (xla or pallas)")
    return _FlashAttention.apply(q, k, v, causal, scale)


class _FoldedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = attention_bwd(q, k, v, dout, lse, _delta(dout, out),
                                   ctx.causal, ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention_folded(q, k, v, causal: bool = True,
                           scale: Optional[float] = None):
    """Differentiable self-attention, [B, S, H, Dh] in and out — the JAX
    ``flash_attention_folded`` (K7): the output is stored in the input
    dtype, and the backward's ``delta`` comes from it and from the
    cotangent cast to that dtype, as ``_ffold_bwd`` computes them. On the
    card: :func:`attention_fwd`, then :func:`attention_bwd`'s two
    kernels."""
    if tuple(k.shape) != tuple(q.shape):
        raise ValueError(f"folded attention is self-attention: k "
                         f"{tuple(k.shape)} != q {tuple(q.shape)}")
    return _FoldedAttention.apply(q, k, v, causal, scale)


#: the JAX folded kernels' largest tile edge, and their VMEM budget for
#: the (H * Dh, tile) working set; the eligibility rules below keep them
#: so that ``attention_impl="auto"`` picks what the JAX policy picks
F_TILE = 512
_FOLDED_VMEM_BUDGET = 14 * 2**20


def _fold_tile(s: int) -> int:
    for t in (F_TILE, 256, 128):
        if s % t == 0:
            return t
    return 0


def _folded_shape_ok(sq: int, sk: int, d: int,
                     h: Optional[int] = None) -> bool:
    """The JAX package's shape rule for the folded engine: same-length
    self-attention, a 128-tileable S, Dh % 8 == 0, and (given ``h``) an
    (H * Dh, tile) working set inside the JAX kernels' VMEM budget."""
    ok = sq == sk and d % 8 == 0 and _fold_tile(sq) > 0
    if ok and h is not None:
        ok = h * d * _fold_tile(sq) * 40 <= _FOLDED_VMEM_BUDGET
    return ok


def folded_available(sq: int, sk: int, d: int,
                     h: Optional[int] = None) -> bool:
    """:func:`_folded_shape_ok` and a kernel instance for the head dim
    (the JAX test of a TPU backend is dropped: the caller decides the
    device)."""
    return _folded_shape_ok(sq, sk, d, h) and d <= MAX_HEAD_DIM


# ---------------------------------------------------------------------------
# K8: the ring-attention block step, masked by positions

#: the JAX package's ``_PAD_POS`` (int32 max): a padded key, never visible
PAD_POS = 2**31 - 1


def _visible(q_pos, k_pos, causal: bool):
    """Which (query, key) pairs count, [B, 1, Sq, Sk] (or [B, 1, 1, Sk]
    without the causal rule): a key whose position is not the pad
    sentinel, and, if causal, is at or before the query's."""
    vis = (k_pos != PAD_POS)[:, None, None, :]
    if causal:
        vis = vis & (k_pos[:, None, None, :] <= q_pos[:, None, :, None])
    return vis


def ring_block_fwd_plain(q, k, v, q_pos, k_pos, causal: bool, scale: float):
    """``(o, m, l)``: the block pair's partials in f32 — ``o``
    [B, Sq, H, Dh] unnormalized, ``m`` and ``l`` [B, H, Sq] — with
    positions [B, S] int32. Scores from the inputs' values in f32, ``p``
    rounded to v's dtype before ``p @ v``, as the JAX kernels cast it. A
    row that sees no key gives ``m = -1e30``, ``l = 0``, ``o = 0``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = _visible(q_pos, k_pos, causal)
    s = torch.where(vis, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, p.sum(dim=-1)


def ring_block_bwd_plain(q, k, v, dout, lse, delta, q_pos, k_pos,
                         causal: bool, scale: float):
    """The block pair's FlashAttention-2 backward as dense einsums (the
    JAX ``_frdq_kernel``/``_frdkv_kernel`` algebra): ``p = exp(s - lse)``
    on visible pairs (``lse`` = +1e30 on a row with no visible key makes
    it 0), ``ds = p (dp - delta)``; ``p`` and ``ds`` rounded to the input
    dtype before their products. Returns f32 ``(dq, dk, dv)``."""
    dt = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.where(_visible(q_pos, k_pos, causal),
                    torch.exp(s - lse[..., None]), 0.0)
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq, dk, dv


def _positions(name: str, pos, b: int, s: int, dev) -> torch.Tensor:
    """``pos`` ([S], or [B, S] per batch row) as a contiguous [B, S] int32
    tensor on ``dev``."""
    pos = torch.as_tensor(pos).to(device=dev, dtype=torch.int32)
    if pos.dim() == 1:
        pos = pos.expand(b, -1)
    pos = pos.contiguous()
    check(name, pos, torch.int32, (b, s), dev)
    return pos


def _check_ring(q, k, v, q_pos, k_pos, scale):
    dev, b, sq, sk, h, d = _check_qkv(q, k, v)
    q_pos = _positions("q_pos", q_pos, b, sq, dev)
    k_pos = _positions("k_pos", k_pos, b, sk, dev)
    if dev.type == "cuda":
        _check_head_dim(d)
    scale = float(scale) if scale is not None else d ** -0.5
    return dev, (b, sq, sk, h, d), q_pos, k_pos, scale


def ring_block_fwd(q, k, v, q_pos, k_pos, causal: bool = True,
                   scale: Optional[float] = None):
    """One ring step's block attention: ``q`` [B, Sq, H, Dh], ``k``/``v``
    [B, Sk, H, Dh], f32 or bf16 alike; ``q_pos``/``k_pos`` global
    positions, [S] or [B, S] per batch row (:data:`PAD_POS` marks a
    padded key) -> f32 ``(o [B, Sq, H, Dh] unnormalized, m [B, H, Sq],
    l [B, H, Sq])``. One launch on the card: bf16 on the tensor cores
    (Sk up to 262144, and Sq likewise for the backward's dk/dv), f32 on
    the CUDA cores; on CPU tensors :func:`ring_block_fwd_plain`."""
    dev, shape, q_pos, k_pos, scale = _check_ring(q, k, v, q_pos, k_pos,
                                                  scale)
    if dev.type == "cpu":
        return ring_block_fwd_plain(q, k, v, q_pos, k_pos, causal, scale)
    b, sq, _, h, d = shape
    o = torch.empty(b, sq, h, d, dtype=torch.float32, device=dev)
    m = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    l = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    _launch("mmt_ring_block_fwd", dev, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), *shape, scale, int(causal),
            DTYPE_CODES[q.dtype])
    LAUNCHES["ring_block_fwd"] += 1
    return o, m, l


def _check_ring_bwd(q, k, v, dout, lse, delta, q_pos, k_pos, scale):
    dev, shape, q_pos, k_pos, scale = _check_ring(q, k, v, q_pos, k_pos,
                                                  scale)
    b, sq, _, h, _ = shape
    check("dout", dout, q.dtype, tuple(q.shape), dev)
    check("lse", lse, torch.float32, (b, h, sq), dev)
    check("delta", delta, torch.float32, (b, h, sq), dev)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr())
    return dev, shape, q_pos, k_pos, scale, ptrs


def ring_block_bwd_dq(q, k, v, dout, lse, delta, q_pos, k_pos,
                      causal: bool = True, scale: Optional[float] = None):
    """The block pair's dq (f32 [B, Sq, H, Dh]) from the forward's
    inputs and positions, the output's cotangent ``dout`` (q's shape and
    dtype), the ring's ``lse`` and ``delta = sum(dout * out, -1)`` over
    the f32 normalized output (both [B, H, Sq] f32). One launch on the
    card; on CPU tensors the plain backward's dq."""
    dev, shape, q_pos, k_pos, scale, ptrs = _check_ring_bwd(
        q, k, v, dout, lse, delta, q_pos, k_pos, scale)
    if dev.type == "cpu":
        return ring_block_bwd_plain(q, k, v, dout, lse, delta, q_pos, k_pos,
                                    causal, scale)[0]
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    _launch("mmt_ring_block_bwd_dq", dev, *ptrs, dq.data_ptr(), *shape,
            scale, int(causal), DTYPE_CODES[q.dtype])
    LAUNCHES["ring_block_bwd_dq"] += 1
    return dq


def ring_block_bwd_dkdv(q, k, v, dout, lse, delta, q_pos, k_pos,
                        causal: bool = True, scale: Optional[float] = None):
    """The block pair's ``(dk, dv)`` (f32, k's shape); arguments as
    :func:`ring_block_bwd_dq`. One launch on the card; on CPU tensors the
    plain backward's dk, dv."""
    dev, shape, q_pos, k_pos, scale, ptrs = _check_ring_bwd(
        q, k, v, dout, lse, delta, q_pos, k_pos, scale)
    if dev.type == "cpu":
        return ring_block_bwd_plain(q, k, v, dout, lse, delta, q_pos, k_pos,
                                    causal, scale)[1:]
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(k.shape, dtype=torch.float32, device=dev)
    _launch("mmt_ring_block_bwd_dkdv", dev, *ptrs, dk.data_ptr(),
            dv.data_ptr(), *shape, scale, int(causal), DTYPE_CODES[q.dtype])
    LAUNCHES["ring_block_bwd_dkdv"] += 1
    return dk, dv


def check_interpret(interpret: bool, t: torch.Tensor) -> None:
    """``interpret=True`` names the JAX package's CPU debugging mode of
    its Pallas kernels: here the plain version on CPU tensors, which the
    wrappers run there anyway; on CUDA tensors it raises."""
    if interpret and t.device.type == "cuda":
        raise ValueError("interpret mode runs the plain version on CPU "
                         "tensors only; on the card the kernel runs")


def flash_block_attn(q, k, v, scale, q_pos, k_pos, causal: bool,
                     interpret: bool = False):
    """The JAX ``flash_block_attn``: ``(m, l, o)`` partials for the
    ring's online-softmax merge — ``m``/``l`` [B, H, Sq], ``o``
    [B, Sq, H, Dh] unnormalized — all cast to q's dtype. Any Sq, Sk and
    head dim <= 64 (the TPU kernel pads to its tiles; this one needs no
    padding); positions [S] or [B, S]. :func:`ring_block_fwd` underneath."""
    check_interpret(interpret, q)
    o, m, l = ring_block_fwd(q, k, v, q_pos, k_pos, causal, scale)
    return m.to(q.dtype), l.to(q.dtype), o.to(q.dtype)


def folded_block_attn(q, k, v, scale, q_pos, k_pos, causal: bool,
                      interpret: bool = False):
    """The JAX ``folded_block_attn``: :func:`flash_block_attn`'s twin.
    The JAX folded layout only tiles same-length blocks with a
    128-tileable S and Dh % 8 == 0, and raises on other shapes; so does
    this (the kernel underneath is the same as the flash twin's)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not _folded_shape_ok(sq, sk, d, h):
        raise ValueError(
            f"folded_block_attn needs same-length blocks (sq={sq}, "
            f"sk={sk}), head_dim % 8 == 0 (got {d}), a 128-tileable "
            f"sequence, and H*Dh within the folded budget (H*Dh={h * d}); "
            f"use flash_block_attn for other shapes")
    return flash_block_attn(q, k, v, scale, q_pos, k_pos, causal, interpret)


#: the JAX ``folded_block_available``: the folded engine's shape rule
#: (the ring's local blocks are same-length by construction)
folded_block_available = folded_available
