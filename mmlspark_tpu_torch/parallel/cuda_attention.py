"""The decode path's attention kernels: wrappers, plain versions, counts.

Three hand-written Hopper kernels (``mmlspark_tpu_torch/csrc``) replace
the JAX package's Pallas kernels on the paged decode path:

* :func:`paged_decode_attention` (K1) — one query per slot against its
  paged lane, every decode step and layer;
* :func:`flash_prefill_attention` (K2) — causal attention of a cold
  prefill over the q/k/v it just computed;
* :func:`paged_prefix_prefill_attention` (K3) — a prefix-cache hit's
  suffix queries against the slot's paged lane.

Each wrapper takes the JAX function's layout and arguments, checks
device, dtype, shape and contiguity (raising on anything else),
allocates its output with ``torch.empty`` and launches on the current
stream. A wrapper runs its ``*_plain`` PyTorch version only when it is
handed CPU tensors; for CUDA tensors it launches the kernel or raises —
there is no fallback. :data:`LAUNCHES` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mmlspark_tpu_torch.native.launch import F, I, P, check, device_of, launch

#: kernel launches per wrapper (plain-version calls never count)
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0,
                            "flash_prefill_attention": 0,
                            "paged_prefix_prefill_attention": 0}

#: the largest head dim the kernels are built for (every transformer
#: config in the repository has Dh <= 64)
MAX_HEAD_DIM = 64

_NEG_INF = -1e30

# C entry -> argtypes (the stream pointer follows)
_ARGTYPES = {
    "mmt_paged_decode_attention": [P] * 6 + [I] * 5 + [F],
    "mmt_flash_prefill_attention": [P] * 4 + [I] * 4 + [F],
    "mmt_paged_prefix_prefill_attention": [P] * 5 + [I] * 6 + [F],
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
    out = torch.empty_like(q)
    _launch("mmt_paged_decode_attention", dev, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), n, h, d, int(page_size),
            page_tables.shape[1], float(scale))
    LAUNCHES["paged_decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: causal flash attention for the cold prefill


def flash_prefill_attention_plain(q, k, v, scale: Optional[float] = None):
    """Causal softmax attention over [B, S, H, Dh] — the JAX package's
    ``ring_attention.dense_attention(causal=True)``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    sq, sk = q.shape[1], k.shape[1]
    mask = (torch.arange(sq, device=q.device)[:, None]
            >= torch.arange(sk, device=q.device)[None, :])
    s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


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
    out = torch.empty_like(q)
    _launch("mmt_paged_prefix_prefill_attention", dev, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            out.data_ptr(), s_len, h, d, int(page_size),
            page_table.shape[0], hit_len, float(scale))
    LAUNCHES["paged_prefix_prefill_attention"] += 1
    return out
