"""Transformer LM in PyTorch: decode over a paged KV pool, and training.

The port of ``mmlspark_tpu/models/transformer.py``'s decode half and its
single-device train step: the same config, the same parameter layout (a
``dict`` of tensors that mirrors the JAX ``init_params`` tree, stage dim
kept), the same math term for term — RMSNorm with eps 1e-6,
interleaved-pair RoPE, a relu MLP, f32 decode — and the same paged KV
pool
``[n_layers, n_pages, page_size, H, Dh]`` with page 0 as the scratch
page (unclaimed table entries route writes there, so bucket padding and
free slots never touch another slot's rows).

The builders return plain functions that update the pool IN PLACE
(``index_put_`` without accumulation — duplicate indices only ever aim
at the scratch page) and hand the same pool dict back, so the pool
keeps one allocation and a stable ``data_ptr`` for its whole life.
``attn_impl`` picks the attention engine: ``"dense"`` runs the plain
PyTorch versions (the JAX package's dense engine), ``"cuda"`` the
kernel wrappers of :mod:`~mmlspark_tpu_torch.parallel.cuda_attention`
(which launch the Hopper kernels on CUDA tensors and run the plain
versions on CPU tensors).

Speculative decoding adds the draft's dense slot-lane pool
(:func:`init_kv_cache`, :func:`build_prefill`,
:func:`build_decode_step`), the chained greedy
:func:`build_draft_propose`, the target's width-k
:func:`build_paged_verify_step` (its proposal scores through K4,
:mod:`~mmlspark_tpu_torch.ops.fused_ce`, under ``ce_impl="cuda"``) and
:func:`layer_truncated_draft`.

Training (:func:`build_train_step`) runs ``local_loss`` — embed, the
blocks, the final norm and the loss — under autograd, then momentum SGD
in place. ``cfg.dtype="bfloat16"`` is the JAX mixed precision: the
projections, the MLP, the attention products and the vocab head take
bf16 inputs with f32 masters, residual stream, rope and softmax.
``cfg.attention_impl`` picks the attention engine (``"folded"`` = K7,
``"flash"``, ``"dense"``, ``"auto"``) and ``cfg.ce_impl`` the loss's
(``"cuda"`` = K4's training variant + K6, ``"dense"``, ``"auto"``).

:func:`build_spmd_train_step` runs the same step over a (data, seq)
:class:`~mmlspark_tpu_torch.parallel.topology.Mesh`: each rank takes its
block of the batch, with global rope positions, and with a ``seq`` axis
every layer's attention goes around the ring
(:mod:`~mmlspark_tpu_torch.parallel.ring_attention`; its folded ring is
K8). The loss is summed over every rank's tokens, the gradients over
every process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device
from mmlspark_tpu_torch.ops import fused_ce as FC
from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.parallel import ring_attention as RA
from mmlspark_tpu_torch.parallel.collectives import allreduce_sum, axis_index
from mmlspark_tpu_torch.parallel.sharding import shard_batch
from mmlspark_tpu_torch.parallel.topology import (
    AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ, Mesh, MeshAxis,
)

# The decode path is f32 end to end in the JAX package; TF32 keeps 10
# mantissa bits, far outside the 1e-4 logit parity the port is held to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Params = Dict[str, Any]
ATTN_IMPLS = ("dense", "cuda")
CE_IMPLS = ("dense", "cuda")
#: the train step's attention engines (besides "auto")
ATTENTION_IMPLS = ("dense", "flash", "folded")
DTYPES = ("float32", "bfloat16")
_NEG_INF = -1e30      # the JAX package's masked-score sentinel


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the JAX ``TransformerConfig`` that the decode path
    and the single-device train step read (same names and defaults). The
    port decodes in f32 and trains in f32 or bf16 mixed precision
    (``dtype``); dense-MLP configs only — MoE and int8 trees are refused
    by :func:`params_from_jax`."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    d_head: int = 16
    d_ff: int = 128
    n_stages: int = 1
    layers_per_stage: int = 1
    #: the verify's score engine (:func:`verify_ce_engine`) and the train
    #: loss's (:func:`train_ce_engine`): "auto", "cuda" (K4, K6) or
    #: "dense"
    ce_impl: str = "auto"
    microbatches: int = 1
    #: the train step's compute dtype: "float32" or "bfloat16"
    dtype: str = "float32"
    #: the train step's attention engine (:func:`attention_engine`):
    #: "auto", "dense", "flash" or "folded"
    attention_impl: str = "auto"

    @property
    def n_layers(self) -> int:
        return self.n_stages * self.layers_per_stage


# ---------------------------------------------------------------------------
# parameters


_BLOCK_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "b1", "w2", "b2")


def params_from_jax(tree, device: DeviceLike = None,
                    memo: Optional[dict] = None) -> Params:
    """The JAX ``init_params`` tree (leaves as numpy arrays or tensors)
    as the port's params: the same keys and layouts — ``embed``
    (V, D), ``head`` (D, V), ``final_norm`` (D,),
    and per block ``ln1``/``ln2`` (s, D), ``wq``/``wk``/``wv``
    (s, D, H, Dh), ``wo`` (s, H, Dh, D), ``w1`` (s, D, F), ``b1``
    (s, F), ``w2`` (s, F, D), ``b2`` (s, D) — as f32 tensors on
    ``device``. MoE and int8 (``quantize_decode_ffn``) trees are
    refused.

    Aliasing is kept: an f32 tensor already on ``device`` is returned
    as it is, and ``memo`` (a dict, shared across calls) maps each leaf
    converted so far, by identity, to its tensor — so a draft tree that
    aliases the target's leaves (:func:`layer_truncated_draft`),
    converted with the target's memo, shares the target's tensors."""
    dev = resolve_device(device)
    memo = {} if memo is None else memo

    def conv(x):
        hit = memo.get(id(x))
        if hit is not None:
            return hit[1]
        if isinstance(x, torch.Tensor):
            t = x.to(device=dev, dtype=torch.float32)
        else:
            t = torch.tensor(np.asarray(x, np.float32), device=dev)
        memo[id(x)] = (x, t)        # holds x: its id stays unique
        return t

    blocks = []
    for b in tree["blocks"]:
        if "router" in b or "ew1" in b:
            raise NotImplementedError(
                "MoE trees are not ported yet (ROADMAP queue 1)")
        if "w1_q" in b:
            raise NotImplementedError(
                "int8 FFN trees are not ported yet (ROADMAP queue 1)")
        missing = [k for k in _BLOCK_KEYS if k not in b]
        if missing:
            raise ValueError(f"block is missing {missing}")
        blocks.append({k: conv(b[k]) for k in _BLOCK_KEYS})
    return {"embed": conv(tree["embed"]), "head": conv(tree["head"]),
            "final_norm": conv(tree["final_norm"]), "blocks": blocks}


def init_params_np(cfg: TransformerConfig, seed: int = 0) -> Params:
    """A random tree in the ``init_params`` layout, drawn with numpy
    (normal, scale 0.02; norms 1, biases 0). Not the JAX package's
    values: jax.random and numpy draw different numbers from one
    seed."""
    rng = np.random.default_rng(seed)

    def dense(*shape):
        return (0.02 * rng.standard_normal(shape, dtype=np.float32))

    s, d, h, dh, f = (cfg.n_stages, cfg.d_model, cfg.n_heads, cfg.d_head,
                      cfg.d_ff)
    p: Params = {"embed": dense(cfg.vocab, d), "head": dense(d, cfg.vocab),
                 "final_norm": np.ones(d, np.float32)}
    p["blocks"] = [{
        "ln1": np.ones((s, d), np.float32),
        "wq": dense(s, d, h, dh), "wk": dense(s, d, h, dh),
        "wv": dense(s, d, h, dh), "wo": dense(s, h, dh, d),
        "ln2": np.ones((s, d), np.float32),
        "w1": dense(s, d, f), "b1": np.zeros((s, f), np.float32),
        "w2": dense(s, f, d), "b2": np.zeros((s, d), np.float32),
    } for _ in range(cfg.layers_per_stage)]
    return p


def _decode_block_params(params: Params, cfg: TransformerConfig
                         ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer param dicts in reference order (STAGE-major: for each
    stage, for each block), with the leading ``n_stages`` dim indexed
    away."""
    return [{k: v[s] for k, v in bp.items()}
            for s in range(cfg.n_stages) for bp in params["blocks"]]


# ---------------------------------------------------------------------------
# building blocks


def _rmsnorm(x, g, eps: float = 1e-6):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * g


def _rope_freqs(dh: int, device) -> torch.Tensor:
    return 1.0 / (10000.0 ** (torch.arange(0, dh, 2, device=device,
                                           dtype=torch.float32) / dh))


def _rotate(x, cos, sin):
    """Rotate channel PAIRS (0, 1), (2, 3), ... — interleaved, not the
    half-split convention."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def _rope(x, pos):
    """Rotary embedding of ``x`` [B, S, H, Dh] at positions ``pos``
    [S]."""
    ang = pos.to(torch.float32)[:, None] * _rope_freqs(x.shape[-1],
                                                      x.device)[None, :]
    return _rotate(x, torch.cos(ang)[None, :, None, :],
                   torch.sin(ang)[None, :, None, :])


def _rope_at(x, pos):
    """Rotary embedding of mid-sequence tokens: ``x`` [..., H, Dh] at
    positions ``pos`` matching the leading dims."""
    ang = pos.to(torch.float32)[..., None] * _rope_freqs(x.shape[-1],
                                                        x.device)
    return _rotate(x, torch.cos(ang)[..., None, :],
                   torch.sin(ang)[..., None, :])


def _proj(h, w):
    """``h`` [..., D] through ``w`` (D, H, Dh) -> [..., H, Dh]."""
    d, nh, dh = w.shape
    return (h @ w.reshape(d, nh * dh)).reshape(*h.shape[:-1], nh, dh)


def _out_proj(a, wo):
    """``a`` [..., H, Dh] through ``wo`` (H, Dh, D) -> [..., D]."""
    nh, dh, d = wo.shape
    return a.reshape(*a.shape[:-2], nh * dh) @ wo.reshape(nh * dh, d)


def _decode_ffn(bp, h):
    """The dense-MLP FFN over post-``ln2`` activations (relu)."""
    return torch.relu(h @ bp["w1"] + bp["b1"]) @ bp["w2"] + bp["b2"]


def reference_logits(params: Params, tokens: torch.Tensor,
                     cfg: TransformerConfig) -> torch.Tensor:
    """Per-position next-token logits ``[b, s, vocab]`` from the whole
    context, dense causal attention — the port's full-context oracle
    (the JAX ``reference_logits``)."""
    x = params["embed"][tokens]
    pos = torch.arange(tokens.shape[1], device=x.device)
    for bp in _decode_block_params(params, cfg):
        h = _rmsnorm(x, bp["ln1"])
        q = _rope(_proj(h, bp["wq"]), pos)
        k = _rope(_proj(h, bp["wk"]), pos)
        v = _proj(h, bp["wv"])
        a = CA.flash_prefill_attention_plain(q, k, v)
        x = x + _out_proj(a, bp["wo"])
        x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]))
    return _rmsnorm(x, params["final_norm"]) @ params["head"]


# ---------------------------------------------------------------------------
# the paged KV pool and its builders


def init_paged_kv_cache(cfg: TransformerConfig, n_pages: int,
                        page_size: int, device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """The shared page pool: ``{"k", "v"}`` f32 zeros of shape
    ``[n_layers, n_pages, page_size, n_heads, d_head]``, allocated once;
    page 0 is the scratch page, so ``n_pages - 1`` pages are
    claimable."""
    shape = (cfg.n_layers, int(n_pages), int(page_size), cfg.n_heads,
             cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=dev),
            "v": torch.zeros(shape, dtype=torch.float32, device=dev)}


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} "
                         f"(one of {ATTN_IMPLS})")


def _last_logits(params, x, row: int):
    """Greedy token and logits of hidden row ``row`` of ``x`` [S, D]."""
    h = _rmsnorm(x[row], params["final_norm"])
    logits = h @ params["head"]
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def build_paged_prefill(cfg: TransformerConfig, page_size: int,
                        pages_per_slot: int, attn_impl: str = "dense"
                        ) -> Callable:
    """``prefill(params, cache, tokens, page_table, length) -> (cache,
    next_token, last_logits)``: the cold prefill of one bucket-padded
    prompt ``tokens`` [S_pad] into the pages of ``page_table``
    [pages_per_slot] (int32), ``length`` the true prompt length (int).

    Each layer writes its K/V into the pool BEFORE its attention runs:
    buckets >= ``page_size`` scatter whole page chunks (chunks past the
    claimed pages ride table entry 0, the scratch page), smaller
    buckets write rows [0, S) of the first page. Attention runs over
    the q/k/v just computed (K2 under ``"cuda"``)."""
    _check_impl(attn_impl)
    page_size, pages_per_slot = int(page_size), int(pages_per_slot)
    scale = cfg.d_head ** -0.5
    attn = (CA.flash_prefill_attention if attn_impl == "cuda"
            else CA.flash_prefill_attention_plain)
    nh, dh = cfg.n_heads, cfg.d_head

    @torch.no_grad()
    def prefill(params, cache, tokens, page_table, length: int):
        S = tokens.shape[0]
        x = params["embed"][tokens][None]              # [1, S, D]
        pos = torch.arange(S, device=x.device)
        ck, cv = cache["k"], cache["v"]
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _rope(_proj(h, bp["wq"]), pos)
            k = _rope(_proj(h, bp["wk"]), pos)
            v = _proj(h, bp["wv"])
            if S >= page_size:
                n_chunks = S // page_size
                pgs = page_table[:n_chunks]
                ck[l, pgs] = k[0].reshape(n_chunks, page_size, nh, dh)
                cv[l, pgs] = v[0].reshape(n_chunks, page_size, nh, dh)
            else:
                # a sub-page bucket: rows [0, S) of the first page
                ck[l][page_table[:1], :S] = k
                cv[l][page_table[:1], :S] = v
            a = attn(q, k, v, scale)
            x = x + _out_proj(a, bp["wo"])
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]))
        nxt, logits = _last_logits(params, x[0], int(length) - 1)
        return cache, nxt, logits

    return prefill


def build_paged_prefix_prefill(cfg: TransformerConfig, page_size: int,
                               pages_per_slot: int,
                               attn_impl: str = "dense") -> Callable:
    """``prefill(params, cache, tokens, page_table, length, hit_len) ->
    (cache, next_token, last_logits)``: the offset prefill behind the
    prefix cache. The prompt's first ``hit_len`` tokens (page-aligned,
    an int: hit depth is data, not a shape) already live in the shared
    pages at the head of ``page_table``; ``tokens`` is the suffix
    ``prompt[hit_len:]`` padded to its bucket. Suffix row ``j`` ropes
    at virtual position ``hit_len + j``, writes its K/V through the
    table there, and attends over the WHOLE virtual lane masked to
    ``index <= hit_len + j`` (K3 under ``"cuda"``).

    Shared pages are read-only by construction (every write lands at
    row >= hit_len). A bucket that overshoots the lane end sends its
    overflow chunks to the SCRATCH page — a clamped index would write
    padding over shared prefix pages."""
    _check_impl(attn_impl)
    page_size, pages_per_slot = int(page_size), int(pages_per_slot)
    scale = cfg.d_head ** -0.5
    attn = (CA.paged_prefix_prefill_attention if attn_impl == "cuda"
            else CA.paged_prefix_prefill_attention_plain)
    nh, dh = cfg.n_heads, cfg.d_head

    @torch.no_grad()
    def prefill(params, cache, tokens, page_table, length: int,
                hit_len: int):
        S = tokens.shape[0]
        hit_len = int(hit_len)
        x = params["embed"][tokens]                    # [S, D]
        pos = hit_len + torch.arange(S, device=x.device)
        start_page = hit_len // page_size
        ck, cv = cache["k"], cache["v"]
        if S >= page_size:
            n_chunks = S // page_size
            cpos = start_page + torch.arange(n_chunks, device=x.device)
            pgs = torch.where(
                cpos < pages_per_slot,
                page_table[cpos.clamp(max=pages_per_slot - 1)],
                torch.zeros((), dtype=page_table.dtype, device=x.device))
        else:
            # a sub-page suffix: rows [0, S) of the first private page
            pg = page_table[start_page:start_page + 1]
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _rope_at(_proj(h, bp["wq"]), pos)
            k = _rope_at(_proj(h, bp["wk"]), pos)
            v = _proj(h, bp["wv"])
            if S >= page_size:
                ck[l, pgs] = k.reshape(n_chunks, page_size, nh, dh)
                cv[l, pgs] = v.reshape(n_chunks, page_size, nh, dh)
            else:
                ck[l][pg, :S] = k[None]
                cv[l][pg, :S] = v[None]
            a = attn(q, ck[l], cv[l], page_table, hit_len, scale,
                     page_size)
            x = x + _out_proj(a, bp["wo"])
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]))
        nxt, logits = _last_logits(params, x, int(length) - 1 - hit_len)
        return cache, nxt, logits

    return prefill


def build_paged_decode_step(cfg: TransformerConfig, n_slots: int,
                            page_size: int, pages_per_slot: int,
                            attn_impl: str = "dense") -> Callable:
    """``step(params, cache, tokens, pos, page_tables) -> (cache,
    next_tokens, logits)``: one token for every slot. ``tokens``/``pos``
    are [n_slots] int32, ``page_tables`` [n_slots, pages_per_slot]
    int32. Each slot writes its new K/V row at page
    ``page_tables[slot, pos // page_size]``, row ``pos % page_size``,
    then attends over its lane masked to ``index <= pos`` (K1 under
    ``"cuda"``). Free slots ride at token 0 / pos 0 with an all-scratch
    table: their writes all land on page 0, row 0 — duplicate indices
    that are harmless only because page 0 is scratch."""
    _check_impl(attn_impl)
    n_slots, page_size = int(n_slots), int(page_size)
    pages_per_slot = int(pages_per_slot)
    scale = cfg.d_head ** -0.5
    attn = (CA.paged_decode_attention if attn_impl == "cuda"
            else CA.paged_decode_attention_plain)

    @torch.no_grad()
    def step(params, cache, tokens, pos, page_tables):
        x = params["embed"][tokens]                    # [N, D]
        ck, cv = cache["k"], cache["v"]
        rows = torch.arange(n_slots, device=x.device)
        pg = page_tables[rows, pos // page_size]       # [N]
        row = pos % page_size
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _rope_at(_proj(h, bp["wq"]), pos)
            k = _rope_at(_proj(h, bp["wk"]), pos)
            v = _proj(h, bp["wv"])
            ck[l, pg, row] = k
            cv[l, pg, row] = v
            a = attn(q, ck[l], cv[l], page_tables, pos, scale, page_size)
            x = x + _out_proj(a, bp["wo"])
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]))
        h = _rmsnorm(x, params["final_norm"])
        logits = h @ params["head"]
        return cache, torch.argmax(logits, dim=-1).to(torch.int32), logits

    return step


# ---------------------------------------------------------------------------
# the draft's dense slot-lane cache


def init_kv_cache(cfg: TransformerConfig, n_slots: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The slot-indexed pool a speculative draft decodes over:
    ``{"k", "v"}`` f32 zeros of shape ``[n_layers, n_slots, max_len,
    n_heads, d_head]``, allocated once and updated in place."""
    shape = (cfg.n_layers, int(n_slots), int(max_len), cfg.n_heads,
             cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=dev),
            "v": torch.zeros(shape, dtype=torch.float32, device=dev)}


def build_prefill(cfg: TransformerConfig, attn_impl: str = "dense"
                  ) -> Callable:
    """``prefill(params, cache, tokens, slot, length) -> (cache,
    next_token, last_logits)`` over the dense slot-lane pool: every
    layer writes the bucket-padded prompt's K/V into rows ``[0, S)`` of
    lane ``slot`` (rows past ``length`` hold padding garbage that the
    step's position mask never reads before overwriting), and attention
    runs over the q/k/v just computed (K2 under ``"cuda"``).

    The JAX decoder builds its draft prefill with the dense engine; the
    port's decoder builds it with the decoder's engine, so on the card
    the draft prefill runs K2 and no plain version is on the main
    path."""
    _check_impl(attn_impl)
    attn = (CA.flash_prefill_attention if attn_impl == "cuda"
            else CA.flash_prefill_attention_plain)
    scale = cfg.d_head ** -0.5

    @torch.no_grad()
    def prefill(params, cache, tokens, slot: int, length: int):
        S = tokens.shape[0]
        x = params["embed"][tokens][None]              # [1, S, D]
        pos = torch.arange(S, device=x.device)
        ck, cv = cache["k"], cache["v"]
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _rope(_proj(h, bp["wq"]), pos)
            k = _rope(_proj(h, bp["wk"]), pos)
            v = _proj(h, bp["wv"])
            ck[l, int(slot), :S] = k[0]
            cv[l, int(slot), :S] = v[0]
            a = attn(q, k, v, scale)
            x = x + _out_proj(a, bp["wo"])
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]))
        nxt, logits = _last_logits(params, x[0], int(length) - 1)
        return cache, nxt, logits

    return prefill


def _dense_step_body(params, cfg: TransformerConfig, ck, cv, tokens, pos):
    """One single-token step for every slot over the dense slot-lane
    pool (in place) -> ``(next_tokens, logits)``: slot ``n`` writes its
    K/V row at ``pos[n]``, then attends its lane masked to ``index <=
    pos``. The body :func:`build_decode_step` runs once and
    :func:`build_draft_propose` ``width`` times.

    A position past the lane end (a slot riding a propose near it) is
    not written: JAX drops such an out-of-bounds update, and the port
    writes that slot's last row back unchanged instead."""
    n_slots, max_len = ck.shape[1], ck.shape[2]
    scale = cfg.d_head ** -0.5
    rows = torch.arange(n_slots, device=tokens.device)
    idx = torch.arange(max_len, device=tokens.device)
    mask = idx[None, None, :] <= pos[:, None, None]    # [N, 1, S]
    keep = (pos < max_len)[:, None, None]
    wpos = pos.clamp(max=max_len - 1)
    x = params["embed"][tokens]                        # [N, D]
    for l, bp in enumerate(_decode_block_params(params, cfg)):
        h = _rmsnorm(x, bp["ln1"])
        q = _rope_at(_proj(h, bp["wq"]), pos)
        k = _rope_at(_proj(h, bp["wk"]), pos)
        v = _proj(h, bp["wv"])
        ck[l, rows, wpos] = torch.where(keep, k, ck[l, rows, wpos])
        cv[l, rows, wpos] = torch.where(keep, v, cv[l, rows, wpos])
        s = torch.einsum("nhk,nshk->nhs", q, ck[l]) * scale
        s = torch.where(mask, s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        a = torch.einsum("nhs,nshk->nhk", p, cv[l])
        x = x + _out_proj(a, bp["wo"])
        x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]))
    logits = _rmsnorm(x, params["final_norm"]) @ params["head"]
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def build_decode_step(cfg: TransformerConfig, n_slots: int,
                      max_len: int) -> Callable:
    """``step(params, cache, tokens, pos) -> (cache, next_tokens,
    logits)``: one token for every slot of the dense slot-lane pool
    (``tokens``/``pos`` [n_slots] int32; free slots ride at token 0 /
    pos 0, their lane row 0 rewritten by the next prefill)."""

    @torch.no_grad()
    def step(params, cache, tokens, pos):
        _check_lanes(cache, n_slots, max_len)
        nxt, logits = _dense_step_body(params, cfg, cache["k"], cache["v"],
                                       tokens, pos)
        return cache, nxt, logits

    return step


def _check_lanes(cache, n_slots: int, max_len: int) -> None:
    if tuple(cache["k"].shape[1:3]) != (int(n_slots), int(max_len)):
        raise ValueError(f"cache lanes {tuple(cache['k'].shape[1:3])} "
                         f"!= (n_slots, max_len) ({n_slots}, {max_len})")


# ---------------------------------------------------------------------------
# speculative decoding: draft propose + width-k target verify
#
# A small draft proposes ``width`` tokens per slot (chained greedy steps,
# the argmax staying on the device), then ONE width-``width`` verify of
# the target scores every proposal; the scheduler accepts the longest
# agreeing prefix. The verify's K/V writes for rejected positions are
# repaired by the next round's writes: every position is (re)written by
# the round that consumes its token.


def verify_ce_engine(cfg: TransformerConfig, n_slots: int, width: int,
                     sharded: bool = False,
                     device: DeviceLike = None) -> str:
    """The verify's score engine for ``cfg.ce_impl`` on ``device``:
    ``"cuda"`` scores proposals straight off the hidden states with K4
    (:func:`~mmlspark_tpu_torch.ops.fused_ce.fused_softmax_xent`, the
    counterpart of JAX ``"fused"``), ``"dense"`` takes log-sum-exp
    minus gold over the logits the verify computes anyway (JAX
    ``"xla"``).

    ``"auto"`` resolves to ``"cuda"`` on a CUDA device and ``"dense"``
    on the CPU, whatever ``n_slots * (width - 1)`` tokens a verify
    scores. The JAX rule picks its kernel exactly when the kernel is
    eligible, and excludes small token counts only because a TPU tile
    pads T to 512 (``ops/fused_ce.py:95``); the CUDA kernel's token
    tile is 32 rows and costs no such padding. A ``sharded`` head takes
    ``"dense"``, as in JAX: the kernel is not partition-aware."""
    impl = cfg.ce_impl
    if impl == "auto":
        impl = ("cuda" if resolve_device(device).type == "cuda"
                and not sharded else "dense")
    if impl not in CE_IMPLS:
        raise ValueError(f"unknown verify ce_impl {impl!r} "
                         f"(auto or one of {CE_IMPLS})")
    return impl


def build_paged_verify_step(cfg: TransformerConfig, n_slots: int,
                            width: int, page_size: int,
                            pages_per_slot: int, with_scores: bool = False,
                            ce_impl: str = "dense") -> Callable:
    """``verify(params, cache, tokens, pos, page_tables) -> (cache,
    greedy_tokens, logits[, scores])``: the target's scoring of
    ``width`` draft positions per slot over the paged pool, in place.

    ``tokens`` is [n_slots, width] int32 (column 0 = the slot's current
    input token, columns 1.. = draft proposals) and ``pos`` [n_slots]
    the start positions: query ``j`` ropes at ``pos + j``, writes its
    K/V row through the page table there, and attends its virtual lane
    masked causally to ``index <= pos + j``. A slot whose lane ends
    inside the window (a non-speculative slot riding the round near its
    lane end) routes its overflow writes to the scratch page instead of
    wrapping onto its own live pages. Returns the greedy argmax
    [n_slots, width] (the target's token at ``pos + j + 1``) and the
    logits [n_slots, width, vocab].

    ``with_scores`` adds [n_slots, width - 1] f32 target log-probs of
    the proposals (``tokens[:, j + 1]`` scored by query ``j``):
    ``-K4(h[:, :-1], head, tokens[:, 1:])`` under ``ce_impl="cuda"``,
    log-sum-exp minus gold over the verify's own logits under
    ``"dense"``. The attention is written with plain PyTorch ops, as
    the JAX builder writes it with XLA einsums."""
    if ce_impl not in CE_IMPLS:
        raise ValueError(f"unknown verify ce_impl {ce_impl!r} "
                         f"(one of {CE_IMPLS})")
    n_slots, width = int(n_slots), int(width)
    page_size, pages_per_slot = int(page_size), int(pages_per_slot)
    lane = page_size * pages_per_slot
    scale = cfg.d_head ** -0.5
    nh, dh = cfg.n_heads, cfg.d_head

    @torch.no_grad()
    def verify(params, cache, tokens, pos, page_tables):
        dev = tokens.device
        rows = torch.arange(n_slots, device=dev)
        idx = torch.arange(lane, device=dev)
        x = params["embed"][tokens]                    # [N, W, D]
        ck, cv = cache["k"], cache["v"]
        qpos = pos[:, None] + torch.arange(width, device=dev)[None, :]
        mask = idx[None, None, None, :] <= qpos[:, :, None, None]
        pg = torch.where(
            qpos < lane,
            page_tables[rows[:, None],
                        (qpos // page_size).clamp(max=pages_per_slot - 1)],
            torch.zeros((), dtype=page_tables.dtype, device=dev))
        row = qpos % page_size
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _rope_at(_proj(h, bp["wq"]), qpos)
            k = _rope_at(_proj(h, bp["wk"]), qpos)
            v = _proj(h, bp["wv"])
            ck[l, pg, row] = k
            cv[l, pg, row] = v
            lk = ck[l][page_tables].reshape(n_slots, lane, nh, dh)
            lv = cv[l][page_tables].reshape(n_slots, lane, nh, dh)
            s = torch.einsum("nwhk,nshk->nwhs", q, lk) * scale
            s = torch.where(mask, s, _NEG_INF)
            p = torch.softmax(s, dim=-1)
            a = torch.einsum("nwhs,nshk->nwhk", p, lv)
            x = x + _out_proj(a, bp["wo"])
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]))
        h = _rmsnorm(x, params["final_norm"])          # [N, W, D]
        logits = h @ params["head"]                    # [N, W, V]
        out = (cache, torch.argmax(logits, dim=-1).to(torch.int32), logits)
        if not with_scores:
            return out
        if ce_impl == "cuda":
            ce = FC.fused_softmax_xent(
                h[:, :-1].reshape(-1, cfg.d_model), params["head"],
                tokens[:, 1:].reshape(-1))
            scores = -ce.reshape(n_slots, width - 1)
        else:
            lg = logits[:, :-1]
            gold = torch.gather(lg, -1,
                                tokens[:, 1:, None].to(torch.int64))[..., 0]
            scores = gold - torch.logsumexp(lg, dim=-1)
        return out + (scores,)

    return verify


def build_draft_propose(cfg: TransformerConfig, n_slots: int,
                        max_len: int, width: int) -> Callable:
    """``propose(params, cache, tokens, pos) -> (cache, proposals)``:
    ``width`` greedy draft steps chained over the dense slot-lane pool,
    each step's argmax feeding the next ON THE DEVICE — no host round
    trip between steps. ``proposals`` is [n_slots, width] int32. Greedy
    only: a sampled slot needs each step's distribution on the host, so
    the scheduler runs separate draft steps for it."""
    width = int(width)

    @torch.no_grad()
    def propose(params, cache, tokens, pos):
        _check_lanes(cache, n_slots, max_len)
        cur, props = tokens, []
        for j in range(width):
            cur, _ = _dense_step_body(params, cfg, cache["k"], cache["v"],
                                      cur, pos + j)
            props.append(cur)
        return cache, torch.stack(props, dim=1)

    return propose


def layer_truncated_draft(params, cfg: TransformerConfig, layers: int):
    """A self-speculative draft: the target's FIRST ``layers`` blocks
    with the shared embed / final norm / head (LayerSkip-style early
    exit). Returns ``(draft_params, draft_cfg)``; the draft's leaves
    ARE the target's objects (no copy), for a numpy tree and the port's
    tensors alike."""
    if cfg.n_stages != 1:
        raise ValueError("layer-truncated drafts need n_stages == 1 "
                         "(decode configs are single-stage)")
    if not 1 <= layers <= cfg.layers_per_stage:
        raise ValueError(f"draft layers must be in "
                         f"[1, {cfg.layers_per_stage}]")
    dcfg = dataclasses.replace(cfg, layers_per_stage=int(layers))
    dparams = {"embed": params["embed"], "head": params["head"],
               "final_norm": params["final_norm"],
               "blocks": params["blocks"][:int(layers)]}
    return dparams, dcfg


# ---------------------------------------------------------------------------
# training: the single-device local_loss and train step


def _compute_dtype(cfg: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def attention_engine(cfg: TransformerConfig, seq: int,
                     device: DeviceLike = None) -> str:
    """The train step's attention engine for ``cfg.attention_impl`` at
    sequence length ``seq``. ``"auto"`` takes the JAX thresholds on a
    CUDA device — ``"folded"`` (K7) where its shape rule holds from
    S >= 256 at head dims < 128, ``"flash"`` from S >= 2048, ``"dense"``
    below — with the JAX TPU-backend test replaced by the kernels' head
    dim limit, and ``"dense"`` on the CPU. A named engine runs, or
    raises: ``"folded"`` on a shape its rule refuses is an error (JAX
    would warn and fall back)."""
    impl = cfg.attention_impl
    h, dh = cfg.n_heads, cfg.d_head
    if impl == "auto":
        if resolve_device(device).type != "cuda":
            return "dense"
        if CA.folded_available(seq, seq, dh, h) and seq >= 256 and dh < 128:
            return "folded"
        if dh <= CA.MAX_HEAD_DIM and seq >= 2048:
            return "flash"
        return "dense"
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention_impl {impl!r} (auto or one "
                         f"of {ATTENTION_IMPLS})")
    if impl == "folded" and not CA._folded_shape_ok(seq, seq, dh, h):
        raise ValueError(f"attention_impl='folded' needs S % 128 == 0, "
                         f"head_dim % 8 == 0 and H*Dh within the folded "
                         f"budget; got S={seq}, head_dim={dh}, H={h}")
    return impl


def train_ce_engine(cfg: TransformerConfig, n_tokens: int,
                    device: DeviceLike = None) -> str:
    """The train loss's engine for ``cfg.ce_impl``: ``"auto"`` is
    ``"cuda"`` (K4's training variant + K6, the JAX ``"fused"``) on a
    CUDA device from :data:`~mmlspark_tpu_torch.ops.fused_ce.T_TILE`
    tokens (the JAX gate; ``chip_smoke.py`` times both engines below and
    above it), ``"dense"`` (log-sum-exp minus gold over the head's
    logits, the JAX ``"xla"``) otherwise."""
    impl = cfg.ce_impl
    if impl == "auto":
        impl = ("cuda" if resolve_device(device).type == "cuda"
                and FC.fused_ce_available(n_tokens) else "dense")
    if impl not in CE_IMPLS:
        raise ValueError(f"unknown ce_impl {impl!r} (auto or one of "
                         f"{CE_IMPLS})")
    return impl


def _token_ce(h, head, labels, cfg: TransformerConfig, engine: str):
    """Per-token CE of the final-normed ``h`` [T, D] against ``labels``
    [T] through the loss engine ``engine`` (:func:`train_ce_engine`):
    ``"cuda"`` is the differentiable fused CE, ``"dense"`` log-sum-exp
    minus gold over the head's logits in the compute dtype."""
    dt = _compute_dtype(cfg)
    if engine == "cuda":
        return FC.fused_softmax_xent(h, head, labels, compute_dtype=dt)
    logits = CA._mm("td,dv->tv", h, head, dt if dt != torch.float32 else None)
    gold = torch.gather(logits, -1, labels[:, None].to(torch.int64))[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _attention(bp, x, cfg: TransformerConfig, pos, impl: Optional[str],
               ax: Optional["_Axes"] = None):
    """One block's attention branch (the JAX ``_attention``): the
    projections in the compute dtype with their outputs rounded to it
    (bf16 einsums), rope in f32 at ``pos`` ([S], or [rows, S] per row),
    the engine's attention, the output projection in the compute dtype.
    With a ``seq`` axis the attention goes around the ring, ``x`` holding
    the hosted ranks' rows rank-major, and ``cfg.attention_impl`` maps as
    in JAX: "auto" -> "auto_train", "folded" -> "folded", anything else
    -> "dense"."""
    dt = _compute_dtype(cfg)
    mm_dt = dt if dt != torch.float32 else None
    h = _rmsnorm(x, bp["ln1"]).to(dt)
    q = _rope_at(_proj(h, bp["wq"].to(dt)).float(), pos)
    k = _rope_at(_proj(h, bp["wk"].to(dt)).float(), pos)
    v = _proj(h, bp["wv"].to(dt)).float()
    if ax is not None and ax.seq is not None:
        ring_impl = ("auto_train" if cfg.attention_impl == "auto"
                     else "folded" if cfg.attention_impl == "folded"
                     else "dense")
        r = ax.mesh.n_hosted
        a = RA.ring_attention_local(
            *(t.view(r, t.shape[0] // r, *t.shape[1:]) for t in (q, k, v)),
            ax.seq, causal=True, compute_dtype=mm_dt,
            block_impl=ring_impl).reshape(q.shape)
    elif impl == "dense":
        a = CA.dense_attention(q, k, v, True, compute_dtype=mm_dt)
    else:
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        if impl == "folded":
            a = CA.flash_attention_folded(q, k, v, True)
        else:
            a = CA.flash_attention(q, k, v, True)
    return _out_proj(a.to(dt), bp["wo"].to(dt)).float()


def _mlp(bp, x, cfg: TransformerConfig):
    """The dense MLP in the compute dtype (the JAX ``_mlp``): ``b1``
    added in it, ``b2`` in f32."""
    dt = _compute_dtype(cfg)
    h = _rmsnorm(x, bp["ln2"]).to(dt)
    z = torch.relu(h @ bp["w1"].to(dt) + bp["b1"].to(dt))
    return (z @ bp["w2"].to(dt)).float() + bp["b2"]


def _stage(blocks, x, cfg: TransformerConfig, pos, impl: Optional[str],
           ax: Optional["_Axes"] = None):
    for bp in blocks:
        x = x + _attention(bp, x, cfg, pos, impl, ax)
        x = x + _mlp(bp, x, cfg)
    return x


def _check_train_config(cfg: TransformerConfig) -> None:
    if cfg.n_stages != 1:
        raise NotImplementedError("pipeline stages are not ported yet: "
                                  "the train step needs n_stages == 1")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r} (one of {DTYPES})")
    if cfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got "
                         f"{cfg.microbatches}")


# ---------------------------------------------------------------------------
# the mesh as the per-rank program sees it


@dataclasses.dataclass(frozen=True)
class _Axes:
    """Mesh axes visible to the per-rank program (None = absent), as
    :class:`~mmlspark_tpu_torch.parallel.topology.MeshAxis` objects where
    the JAX ``_Axes`` holds names; ``mesh`` is theirs."""

    data: Optional[MeshAxis]
    seq: Optional[MeshAxis]
    model: Optional[MeshAxis]
    expert: Optional[MeshAxis]
    pipe: Optional[MeshAxis]
    mesh: Mesh

    @staticmethod
    def of(mesh: Mesh) -> "_Axes":
        return _Axes(*(mesh.axis(a) if a in mesh.shape else None for a in
                       (AXIS_DATA, AXIS_SEQ, AXIS_MODEL, AXIS_EXPERT,
                        AXIS_PIPE)), mesh)


def _psum_if(x, axis: Optional[MeshAxis]):
    return allreduce_sum(x, axis) if axis is not None else x


def _replicated(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's share ``part`` of the loss, valued as the sum over
    every process (the JAX loss is replicated) while its gradient stays
    the share's own: the step sums the gradients across processes."""
    if mesh.hosted:
        return part
    total = part.detach().clone()
    dist.all_reduce(total)
    return part + (total - part.detach())


def local_loss(params: Params, tokens, labels, mask,
               cfg: TransformerConfig, ax: Optional[_Axes] = None
               ) -> torch.Tensor:
    """Mean CE over the unmasked tokens (the JAX ``local_loss``).

    Without ``ax`` (one device, no mesh): ``tokens``/``labels`` [B, S]
    int32, ``mask`` [B, S] f32. With ``ax`` (:func:`build_spmd_train_step`):
    each of the hosted ranks' blocks, [n_hosted, B_local, S_local], at
    global positions ``seq index * S_local + arange``, the attention
    around the ring of ``ax.seq`` where there is one; the loss is summed
    over every rank's tokens and divided by their psum'd count, valued as
    the whole mesh's loss on every process. The blocks run per
    microbatch (``cfg.microbatches`` slices of the local batch), the
    final norm and the loss over the whole."""
    _check_train_config(cfg)
    if ax is None:
        tokens, labels, mask = tokens[None], labels[None], mask[None]
    r, b, s = tokens.shape
    m = cfg.microbatches
    if b % m:
        raise ValueError(f"local batch {b} not divisible by microbatches "
                         f"{m}")
    mb = b // m
    dev = tokens.device
    ring = ax is not None and ax.seq is not None
    impl = None if ring else attention_engine(cfg, s, dev)
    blocks = _decode_block_params(params, cfg)
    pos = torch.arange(s, device=dev)
    if ring:
        # global positions, one row per (rank, microbatch row)
        pos = (axis_index(ax.seq)[:, None] * s + pos).repeat_interleave(
            mb, dim=0)
    x = torch.cat([
        _stage(blocks, params["embed"][tok.reshape(r * mb, s)], cfg, pos,
               impl, ax).view(r, mb, s, cfg.d_model)
        for tok in tokens.split(mb, dim=1)], dim=1)
    h = _rmsnorm(x, params["final_norm"]).reshape(r * b * s, cfg.d_model)
    # the engine gate counts one rank's tokens, as JAX's b_loc * s_loc
    ce = _token_ce(h, params["head"], labels.reshape(r * b * s), cfg,
                   train_ce_engine(cfg, b * s, dev)).view(r, b * s)
    mask = mask.reshape(r, b * s)
    if ax is None:
        return (ce * mask).sum() / mask.sum().clamp(min=1.0)
    count = _psum_if(_psum_if(mask.sum(dim=1), ax.data), ax.seq)
    part = ((ce * mask).sum(dim=1) / count.clamp(min=1.0)).sum()
    return _replicated(part, ax.mesh)


def reference_loss(params: Params, tokens, labels, mask,
                   cfg: TransformerConfig) -> torch.Tensor:
    """The JAX ``reference_loss`` for dense-MLP trees: the unsharded f32
    forward (dense causal attention, :func:`reference_logits`), mean CE
    over the unmasked tokens."""
    logits = reference_logits(params, tokens, cfg)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - gold
    return (ce * mask).sum() / mask.sum().clamp(min=1.0)


def _leaves(tree: Params) -> List[torch.Tensor]:
    """The tree's tensors in a fixed order (embed, head, final_norm, then
    every block's keys)."""
    out = [tree["embed"], tree["head"], tree["final_norm"]]
    for bp in tree["blocks"]:
        out.extend(bp[k] for k in _BLOCK_KEYS)
    return out


def init_velocity(params: Params) -> Params:
    """Zeros shaped like ``params``: the momentum buffers."""
    return {"embed": torch.zeros_like(params["embed"]),
            "head": torch.zeros_like(params["head"]),
            "final_norm": torch.zeros_like(params["final_norm"]),
            "blocks": [{k: torch.zeros_like(v) for k, v in bp.items()}
                       for bp in params["blocks"]]}


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The tree with every leaf as a numpy array (host copies), in the
    ``init_params`` layout, for leaf-by-leaf comparison with JAX."""
    def np_(t):
        return t.detach().to("cpu", copy=True).numpy()
    return {"embed": np_(params["embed"]), "head": np_(params["head"]),
            "final_norm": np_(params["final_norm"]),
            "blocks": [{k: np_(v) for k, v in bp.items()}
                       for bp in params["blocks"]]}


def _momentum_step(params, velocity, loss_fn, lr: float, mom: float,
                   reduce_grads=None):
    """``loss_fn()`` under autograd over every leaf of ``params``, the
    gradients through ``reduce_grads`` if given, then momentum SGD ``v =
    mom * v + g; p -= lr * v`` IN PLACE under ``no_grad``: the same dicts
    come back and every leaf keeps its ``data_ptr``."""
    leaves, vel = _leaves(params), _leaves(velocity)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn()
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    with torch.no_grad():
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        torch._foreach_mul_(vel, mom)
        torch._foreach_add_(vel, grads)
        torch._foreach_add_(leaves, vel, alpha=-lr)
    return params, velocity, loss.detach()


def build_train_step(cfg: TransformerConfig, learning_rate: float = 0.1,
                     momentum: float = 0.9,
                     device: DeviceLike = None) -> Callable:
    """``step(params, velocity, tokens, labels, mask) -> (params,
    velocity, loss)``: the JAX ``build_spmd_train_step`` on one device —
    :func:`local_loss` forward, autograd backward, then momentum SGD
    ``v = momentum * v + g; p -= learning_rate * v`` IN PLACE under
    ``no_grad``. ``params`` and ``velocity`` (f32 master trees, as
    :func:`params_from_jax` and :func:`init_velocity` give them) are the
    same dicts and keep every leaf's ``data_ptr``: the port's form of the
    JAX step's buffer donation. ``device=None`` is the card (raising
    without CUDA); every tensor must be on the step's device."""
    _check_train_config(cfg)
    dev = resolve_device(device)
    lr, mom = float(learning_rate), float(momentum)

    def step(params, velocity, tokens, labels, mask):
        for name, t in (("tokens", tokens), ("labels", labels),
                        ("mask", mask), ("params", params["embed"]),
                        ("velocity", velocity["embed"])):
            if t.device.type != dev.type:
                raise ValueError(f"{name} is on {t.device}, the step runs "
                                 f"on {dev}")
        return _momentum_step(
            params, velocity,
            lambda: local_loss(params, tokens, labels, mask, cfg), lr, mom)

    return step


# ---------------------------------------------------------------------------
# training over a (data, seq) mesh


def param_specs(cfg: TransformerConfig, mesh: Mesh) -> Dict[str, Any]:
    """The JAX ``param_specs`` tree: each leaf's mesh axis per dimension
    (a tuple, ``None`` = replicated). The port runs only the data and seq
    axes, over which every parameter is replicated, so every entry is
    ``None``; the tuples keep the JAX specs' lengths."""
    _validate_mesh_config(cfg, mesh)
    block = {"ln1": (None,), "ln2": (None,), "wq": (None,) * 4,
             "wk": (None,) * 4, "wv": (None,) * 4, "wo": (None,) * 4,
             "w1": (None,) * 3, "b1": (None,) * 2, "w2": (None,) * 3,
             "b2": (None,) * 2}
    return {"embed": (), "head": (), "final_norm": (),
            "blocks": [dict(block) for _ in range(cfg.layers_per_stage)]}


def _validate_mesh_config(cfg: TransformerConfig, mesh: Mesh) -> _Axes:
    """The JAX build-time checks: every mesh/config mismatch fails at
    build. (A model, expert or pipe axis of size > 1 never gets here:
    the port's :class:`~mmlspark_tpu_torch.parallel.topology.Mesh`
    refuses it.)"""
    ax = _Axes.of(mesh)
    if ax.pipe is not None and ax.pipe.size != cfg.n_stages:
        raise ValueError(f"n_stages={cfg.n_stages} != pipe axis size "
                         f"{ax.pipe.size}")
    if ax.pipe is None and cfg.n_stages != 1:
        raise ValueError("n_stages > 1 requires a 'pipe' mesh axis")
    return ax


def shard_params(params, cfg: TransformerConfig, mesh: Mesh) -> Params:
    """The JAX ``shard_params``: the tree (numpy leaves, as the JAX
    ``init_params`` gives them, or tensors) as f32 tensors on the mesh's
    device, replicated over data and seq (one set per process, which its
    hosted ranks share)."""
    _validate_mesh_config(cfg, mesh)
    return params_from_jax(params, mesh.device)


def build_spmd_train_step(cfg: TransformerConfig, mesh: Mesh,
                          learning_rate: float = 0.1,
                          momentum: float = 0.9) -> Callable:
    """``step(params, velocity, tokens, labels, mask) -> (params,
    velocity, loss)`` over ``mesh`` (the JAX ``build_spmd_train_step`` in
    its ``shard_map`` formulation): the global batch ([B, S], the same on
    every process) split into each rank's (data, seq) block
    (:func:`~mmlspark_tpu_torch.parallel.sharding.shard_batch`: rows
    padded with mask 0 to the data axis), :func:`local_loss` with the
    mesh's axes, autograd backward — hosted ranks share one set of
    parameter tensors, so autograd sums their gradients — the gradients
    summed across processes in one ``all_reduce``, then momentum SGD in
    place as :func:`build_train_step` does it. (The JAX pjit formulation,
    ``impl="pjit"``, is not ported: ROADMAP queue 1 item 9.)"""
    ax = _validate_mesh_config(cfg, mesh)
    _check_train_config(cfg)
    lr, mom = float(learning_rate), float(momentum)

    def all_reduce(grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        return [f.view(g.shape) for f, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def step(params, velocity, tokens, labels, mask):
        for name, t in (("params", params["embed"]),
                        ("velocity", velocity["embed"])):
            if t.device != mesh.device:
                raise ValueError(f"{name} is on {t.device}, the mesh on "
                                 f"{mesh.device}")
        local, _ = shard_batch({"tokens": tokens, "labels": labels,
                                "mask": mask}, mesh)
        return _momentum_step(
            params, velocity,
            lambda: local_loss(params, local["tokens"], local["labels"],
                               local["mask"], cfg, ax),
            lr, mom, None if mesh.hosted else all_reduce)

    return step


def make_batch(rng: np.random.Generator, cfg: TransformerConfig,
               batch: int, seq: int, device: DeviceLike = None):
    """Synthetic next-token batch ``(tokens, labels, mask)``: the JAX
    ``make_batch``'s numpy draws (so the same tokens from the same rng
    state), as int32/int32/f32 tensors on ``device``."""
    toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1), dtype=np.int64)
    dev = resolve_device(device)
    tokens = torch.tensor(toks[:, :-1].astype(np.int32), device=dev)
    labels = torch.tensor(toks[:, 1:].astype(np.int32), device=dev)
    return tokens, labels, torch.ones(batch, seq, dtype=torch.float32,
                                      device=dev)
