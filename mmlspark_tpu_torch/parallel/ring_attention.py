"""Ring attention: sequence parallelism over a mesh axis.

The port of ``mmlspark_tpu/parallel/ring_attention.py``. Sequences are
sharded over the ``seq`` axis of a :class:`~.topology.Mesh`: each rank
holds its block of queries, keys and values, and the key/value blocks
rotate around the ring (:func:`~.collectives.ring_permute`) while an
online-softmax accumulator builds the exact attention output. After step
``t`` a rank holds the block that started ``t`` ranks behind it, and the
block attention masks by global positions, so one block function serves
every step.

The per-rank functions take tensors ``[n_hosted, B, S_local, H, Dh]``
(the leading dimension is the ranks this process hosts: all of them on a
hosted mesh, one under ``torch.distributed``) and a
:class:`~.topology.MeshAxis` where the JAX bodies run inside
``shard_map`` over an axis name. The hosted ranks of one ring step share
each block kernel launch, folded into its batch with per-row positions.

``block_impl`` picks the block attention: ``"dense"`` (the plain
partials :func:`_block_attn`, differentiable through autograd),
``"flash"`` (K8's kernel through :func:`~.cuda_attention.flash_block_attn`,
forward only), ``"folded"`` (the differentiable ring of K8's kernels,
:func:`ring_attention_folded_local`), ``"auto"`` and ``"auto_train"``
(:func:`_resolve_block_impl`). ``"flash_interpret"`` and
``"folded_interpret"`` name the JAX package's CPU debugging mode: the
plain versions on CPU tensors; on CUDA tensors they raise.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.parallel.collectives import ring_permute
from mmlspark_tpu_torch.parallel.cuda_attention import (  # noqa: F401
    _mm, dense_attention,
)
from mmlspark_tpu_torch.parallel.sharding import gather_shards, shard_batch
from mmlspark_tpu_torch.parallel.topology import Mesh, MeshAxis

_NEG_INF = -1e30  # large-negative instead of -inf: keeps fully-masked
                  # blocks (causal, future-only) free of inf-inf NaNs
BLOCK_IMPLS = ("dense", "flash", "folded", "flash_interpret",
               "folded_interpret", "auto", "auto_train")


def _resolve_block_impl(s_local: int, dh: int, trainable: bool = False,
                        h: Optional[int] = None,
                        device: Optional[torch.device] = None) -> str:
    """The ``auto`` policy (the JAX ``_resolve_block_impl``): on a CUDA
    device, the folded ring where the folded shape rule holds at head
    dims < 128 from ``s_local >= 256``, else the flash kernel (head dims
    <= 64), else dense; ``trainable=True`` (``auto_train``) never picks
    the forward-only flash. The JAX TPU-backend test becomes "the
    tensors are on a card": dense on the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return "dense"
    if (CA.folded_block_available(s_local, s_local, dh, h) and dh < 128
            and s_local >= 256):
        return "folded"
    if not trainable and dh <= CA.MAX_HEAD_DIM:
        return "flash"
    return "dense"


def _block_attn(q, k, v, scale, q_pos, k_pos, causal, compute_dtype=None):
    """One (q-block x kv-block) streaming-attention partial: ``(m, l,
    o)``, the running max and normalizer [B, H, Sq] and the unnormalized
    output [B, Sq, H, Dh], for the online-softmax merge. Positions are
    [S] or [B, S]; ``compute_dtype`` as in :func:`dense_attention`."""
    s = _mm("bqhd,bkhd->bhqk", q, k, compute_dtype) * scale
    if causal:
        qp = q_pos if q_pos.dim() == 2 else q_pos[None]
        kp = k_pos if k_pos.dim() == 2 else k_pos[None]
        mask = (qp[:, :, None] >= kp[:, None, :])[:, None]  # [B, 1, Sq, Sk]
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if causal:
        # rows with no visible key: kill the exp(0) = 1 garbage
        p = torch.where(mask, p, 0.0)
    return m, p.sum(dim=-1), _mm("bhqk,bkhd->bqhd", p, v, compute_dtype)


def _rank_positions(idx: torch.Tensor, s_local: int, b: int) -> torch.Tensor:
    """Global positions of the blocks that start at ranks ``idx``
    ([n_hosted]), one row per (rank, batch row): int32
    [n_hosted * b, s_local]."""
    pos = idx[:, None] * s_local + torch.arange(s_local, device=idx.device)
    return pos.repeat_interleave(b, dim=0).to(torch.int32)


def _merge(m, l, o, bm, bl, bo):
    """The online-softmax merge of a block's partials into the running
    ``(m, l, o)``."""
    m_new = torch.maximum(m, bm)
    c_old = torch.exp(m - m_new)
    c_blk = torch.exp(bm - m_new)
    l = l * c_old + bl * c_blk
    o = (o * c_old.transpose(1, 2)[..., None]
         + bo * c_blk.transpose(1, 2)[..., None])
    return m_new, l, o


def ring_attention_local(q, k, v, axis: MeshAxis, causal: bool = True,
                         scale: Optional[float] = None,
                         block_impl: str = "dense", compute_dtype=None):
    """Exact attention with the sequence sharded over ``axis``, per rank:
    ``q``/``k``/``v`` [n_hosted, B, S_local, H, Dh] -> the same shape.
    The key/value blocks make ``n`` ring steps (``n`` the axis size); the
    merge is the JAX ``body``'s, the last rotation (which feeds no step)
    left out. ``compute_dtype`` casts the attention products' inputs
    (f32 sums); the folded path casts q, k and v to it first, as the JAX
    one does."""
    r, b, s_local, h, dh = q.shape
    if block_impl in ("auto", "auto_train"):
        block_impl = _resolve_block_impl(
            s_local, dh, trainable=block_impl == "auto_train", h=h,
            device=q.device)
    if block_impl in ("folded", "folded_interpret"):
        if compute_dtype is not None:
            q, k, v = (q.to(compute_dtype), k.to(compute_dtype),
                       v.to(compute_dtype))
        return ring_attention_folded_local(
            q, k, v, axis, causal, scale, block_impl == "folded_interpret")
    if block_impl in ("flash", "flash_interpret"):
        block_fn = functools.partial(
            CA.flash_block_attn,
            interpret=block_impl == "flash_interpret")
    elif block_impl == "dense":
        block_fn = functools.partial(_block_attn,
                                     compute_dtype=compute_dtype)
    else:
        raise ValueError(f"unknown block_impl {block_impl!r} (one of "
                         f"{BLOCK_IMPLS})")
    scale = scale if scale is not None else dh ** -0.5
    n, idx = axis.size, axis.index()
    q_pos = _rank_positions(idx, s_local, b)

    def flat(x):
        return x.reshape(r * b, s_local, h, dh)

    m = torch.full((r * b, h, s_local), _NEG_INF, dtype=q.dtype,
                   device=q.device)
    l = torch.zeros((r * b, h, s_local), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(flat(q))
    k_t, v_t = k, v
    for t in range(n):
        k_pos = _rank_positions((idx - t) % n, s_local, b)
        m, l, o = _merge(m, l, o, *block_fn(flat(q), flat(k_t), flat(v_t),
                                            scale, q_pos, k_pos, causal))
        if t < n - 1:
            k_t, v_t = ring_permute(k_t, axis), ring_permute(v_t, axis)
    l = l.clamp(min=1e-30)                               # fully-masked rows
    return (o / l.transpose(1, 2)[..., None]).reshape(q.shape)


class _RingFolded(torch.autograd.Function):
    """The folded ring with its own backward (the JAX custom VJP): the
    forward merges K8's block partials in f32 and keeps the f32
    normalized output and the lse; the backward runs a second ring in
    which the (dk, dv) accumulators travel with their kv block — each
    rank adds its query block's FlashAttention-2 contribution to the
    visiting block's gradients, and after ``n`` rotations the
    accumulators are home."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale, interpret):
        CA.check_interpret(interpret, q)
        r, b, s, h, dh = q.shape
        scale = float(scale) if scale is not None else dh ** -0.5
        n, idx = axis.size, axis.index()
        q_pos = _rank_positions(idx, s, b)
        qf, kf, vf = (x.reshape(r * b, s, h, dh).contiguous()
                      for x in (q, k, v))
        f32 = dict(dtype=torch.float32, device=q.device)
        m = torch.full((r * b, h, s), _NEG_INF, **f32)
        l = torch.zeros((r * b, h, s), **f32)
        o = torch.zeros((r * b, s, h, dh), **f32)
        k_t, v_t = kf, vf
        for t in range(n):
            k_pos = _rank_positions((idx - t) % n, s, b)
            bo, bm, bl = CA.ring_block_fwd(qf, k_t, v_t, q_pos, k_pos,
                                           causal, scale)
            m, l, o = _merge(m, l, o, bm, bl, bo)
            if t < n - 1:
                k_t = ring_permute(k_t.view(q.shape), axis).view(kf.shape)
                v_t = ring_permute(v_t.view(q.shape), axis).view(vf.shape)
        l_safe = l.clamp(min=1e-30)
        out_f = o / l_safe.transpose(1, 2)[..., None]
        # +1e30 on rows with no visible key: the backward's exp(s - lse)
        # then underflows to exactly 0 for them
        lse = torch.where(l > 0, m + torch.log(l_safe), 1e30)
        ctx.save_for_backward(qf, kf, vf, out_f, lse, idx)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return out_f.to(q.dtype).view(q.shape)

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out_f, lse, idx = ctx.saved_tensors
        axis, causal, scale = ctx.axis, ctx.causal, ctx.scale
        shape = dout.shape
        r, b, s = shape[:3]
        n = axis.size
        q_pos = _rank_positions(idx, s, b)
        dof = dout.reshape(qf.shape).to(qf.dtype).contiguous()
        # delta from the f32 normalized output, not the rounded one
        delta = (dof.float() * out_f).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        dk = torch.zeros(shape, dtype=torch.float32, device=qf.device)
        dv = torch.zeros_like(dk)
        k_t, v_t = kf, vf
        for t in range(n):
            k_pos = _rank_positions((idx - t) % n, s, b)
            args = (qf, k_t, v_t, dof, lse, delta, q_pos, k_pos, causal,
                    scale)
            dq += CA.ring_block_bwd_dq(*args)
            dkb, dvb = CA.ring_block_bwd_dkdv(*args)
            dk += dkb.view(shape)
            dv += dvb.view(shape)
            if t < n - 1:
                k_t = ring_permute(k_t.view(shape), axis).view(kf.shape)
                v_t = ring_permute(v_t.view(shape), axis).view(vf.shape)
            # the gradients travel with their kv block: after n rotations
            # each accumulator is back at its owner rank
            dk, dv = ring_permute(dk, axis), ring_permute(dv, axis)
        return (dq.to(qf.dtype).view(shape), dk.to(kf.dtype),
                dv.to(vf.dtype), None, None, None, None)


def ring_attention_folded_local(q, k, v, axis: MeshAxis,
                                causal: bool = True,
                                scale: Optional[float] = None,
                                interpret: bool = False):
    """Differentiable ring attention over K8's block kernels: the contract
    of :func:`ring_attention_local` (per-rank [n_hosted, B, S_local, H,
    Dh]); no [Sq, Sk] matrix reaches device memory in either direction on
    the card. The output is in q's dtype; the gradients come back in the
    inputs' dtypes."""
    return _RingFolded.apply(q, k, v, axis, causal, scale, interpret)


def ring_attention(q, k, v, mesh: Mesh, axis_name: str = "seq",
                   causal: bool = True, block_impl: str = "dense"):
    """Standalone ring attention over ``mesh`` (convenience): ``q``/``k``/
    ``v`` the full [B, S, H, Dh] arrays on every process; the batch is
    split over ``data`` if the mesh has it, the sequence over
    ``axis_name``. Returns the full output, gathered from every rank
    (differentiable on a hosted mesh)."""
    local, n_true = shard_batch({"q": q, "k": k, "v": v}, mesh,
                                seq_axis=axis_name)
    out = ring_attention_local(local["q"], local["k"], local["v"],
                               mesh.axis(axis_name), causal,
                               block_impl=block_impl)
    return gather_shards(out, mesh, seq_axis=axis_name)[:n_true]
