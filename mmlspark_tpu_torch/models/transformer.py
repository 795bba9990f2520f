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
in place. A block's FFN is the dense MLP or, with ``cfg.n_experts``, a
mixture of experts: the token-choice router with dense dispatch or
capacity dispatch (the ``"sort"`` or ``"scatter"`` engine), or the
expert-choice router, with the Switch aux and the router z-loss.
``cfg.dtype="bfloat16"`` is the JAX mixed precision: the projections,
the MLP, the experts, the attention products and the vocab head take
bf16 inputs with f32 masters, residual stream, rope, softmax and
router.
``cfg.attention_impl`` picks the attention engine (``"folded"`` = K7,
``"flash"``, ``"dense"``, ``"auto"``) and ``cfg.ce_impl`` the loss's
(``"cuda"`` = K4's training variant + K6, ``"dense"``, ``"auto"``).

:func:`build_spmd_train_step` runs the same step over a
:class:`~mmlspark_tpu_torch.parallel.topology.Mesh` of the JAX axes,
hosted, one rank per process or mixed (several processes, each hosting
several ranks): each rank takes its (data, seq) block of the batch, with global rope positions; with a ``seq`` axis every layer's
attention goes around the ring
(:mod:`~mmlspark_tpu_torch.parallel.ring_attention`; its folded ring is
K8); over ``model`` each rank takes its heads and ``d_ff`` slice and the
branches' partial outputs are summed (Megatron's split); over ``pipe``
each rank runs its stage's blocks in the GPipe schedule; over
``expert`` each rank routes its shard of the tokens to every rank's
experts (``all_to_all``). The loss is summed over the pipe, data and
seq axes, each leaf's gradient over the axes that hold copies of it.

The decode builders take MoE trees (dense dispatch, :func:`_decode_ffn`)
and int8 FFN trees (:func:`quantize_decode_ffn`, :func:`_q_matmul`), and
``tp`` model ranks (tensor-parallel decode: :func:`decode_param_specs`,
each rank's heads in pages of their own).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device
from mmlspark_tpu_torch.ops import fused_ce as FC
from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.parallel import ring_attention as RA
from mmlspark_tpu_torch.parallel.collectives import (
    all_gather, all_reduce, all_to_all, allreduce_sum, axis_index,
    enter_branch, leave_branch, ring_permute,
)
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
    and the train steps read (same names and defaults). The port decodes
    in f32 and trains in f32 or bf16 mixed precision (``dtype``), with a
    dense MLP or (``n_experts > 0``) a mixture of experts in every
    block; an int8 FFN tree (:func:`quantize_decode_ffn`) decodes."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    d_head: int = 16
    d_ff: int = 128
    n_stages: int = 1
    layers_per_stage: int = 1
    #: 0 = dense MLP; > 0 = MoE in every block
    n_experts: int = 0
    #: 0 = dense dispatch (every token through every expert); > 0 =
    #: capacity dispatch, C = ceil(factor * T * k / E) routings an
    #: expert, the overflow dropped to the residual (the expert-choice
    #: router's C = ceil(factor * T / E))
    moe_capacity_factor: float = 0.0
    #: Switch load-balancing aux weight (0 = off): E * sum_e f_e * P_e a
    #: layer, f_e the share of first choices, P_e the mean probability
    moe_aux_weight: float = 0.0
    #: experts a token consults: 1 = the raw top probability (Switch),
    #: k >= 2 = the top-k probabilities renormalised (Mixtral)
    moe_top_k: int = 1
    #: router z-loss weight (0 = off): mean logsumexp(router logits)^2
    moe_zloss_weight: float = 0.0
    #: the capacity-dispatch engine: "sort" (the routings grouped by
    #: expert through permutation gathers) or "scatter" (the one-hot
    #: cumsum slots written into the queues); both drop the same routings
    moe_dispatch: str = "sort"
    #: "token" (tokens pick their top-k experts) or "expert_choice" (each
    #: expert picks its top-C tokens of a rank's shard; needs
    #: moe_capacity_factor > 0, ignores moe_top_k)
    moe_router: str = "token"
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


_ATTN_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2")
#: a block's keys by its FFN: the dense MLP, the experts, the int8 MLP
_MLP_KEYS = _ATTN_KEYS + ("w1", "b1", "w2", "b2")
_MOE_KEYS = _ATTN_KEYS + ("router", "ew1", "ew2")
_INT8_KEYS = _ATTN_KEYS + ("w1_q", "w1_s", "b1", "w2_q", "w2_s", "b2")
#: the leaves kept as int8; every other leaf is f32
_INT8_LEAVES = ("w1_q", "w2_q")


def _block_keys(bp) -> Tuple[str, ...]:
    """A block's keys, in a fixed order, by the FFN its keys name."""
    if "router" in bp or "ew1" in bp:
        return _MOE_KEYS
    if "w1_q" in bp:
        return _INT8_KEYS
    return _MLP_KEYS


def params_from_jax(tree, device: DeviceLike = None,
                    memo: Optional[dict] = None) -> Params:
    """The JAX ``init_params`` tree (leaves as numpy arrays or tensors)
    as the port's params: the same keys and layouts — ``embed``
    (V, D), ``head`` (D, V), ``final_norm`` (D,),
    and per block ``ln1``/``ln2`` (s, D), ``wq``/``wk``/``wv``
    (s, D, H, Dh), ``wo`` (s, H, Dh, D), then the FFN's: ``w1`` (s, D,
    F), ``b1`` (s, F), ``w2`` (s, F, D), ``b2`` (s, D) for the dense
    MLP; ``router`` (s, D, E), ``ew1`` (s, E, D, F), ``ew2`` (s, E, F,
    D) for MoE; ``w1_q`` (s, D, F), ``w2_q`` (s, F, D) as int8 with
    their scales ``w1_s`` (s, F), ``w2_s`` (s, D) and ``b1``/``b2`` for
    a :func:`quantize_decode_ffn` tree — on ``device``, every leaf f32
    but the int8 weights.

    Aliasing is kept: an f32 tensor already on ``device`` is returned
    as it is, and ``memo`` (a dict, shared across calls) maps each leaf
    converted so far, by identity, to its tensor — so a draft tree that
    aliases the target's leaves (:func:`layer_truncated_draft`),
    converted with the target's memo, shares the target's tensors."""
    dev = resolve_device(device)
    memo = {} if memo is None else memo

    def conv(x, dtype=torch.float32):
        hit = memo.get(id(x))
        if hit is not None:
            return hit[1]
        if dtype == torch.int8:
            # int8 weights cross as they are: a widened copy would be
            # the f32 tree again
            if x.dtype not in (np.int8, torch.int8):
                raise ValueError(f"an int8 FFN leaf has dtype {x.dtype}")
            t = (x.to(dev) if isinstance(x, torch.Tensor)
                 else torch.tensor(np.asarray(x), device=dev))
        elif isinstance(x, torch.Tensor):
            t = x.to(device=dev, dtype=torch.float32)
        else:
            t = torch.tensor(np.asarray(x, np.float32), device=dev)
        memo[id(x)] = (x, t)        # holds x: its id stays unique
        return t

    blocks = []
    for b in tree["blocks"]:
        keys = _block_keys(b)
        missing = [k for k in keys if k not in b]
        if missing:
            raise ValueError(f"block is missing {missing}")
        blocks.append({k: conv(b[k], torch.int8 if k in _INT8_LEAVES
                               else torch.float32) for k in keys})
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
    e = cfg.n_experts
    p: Params = {"embed": dense(cfg.vocab, d), "head": dense(d, cfg.vocab),
                 "final_norm": np.ones(d, np.float32)}
    blocks = []
    for _ in range(cfg.layers_per_stage):
        b = {"ln1": np.ones((s, d), np.float32),
             "wq": dense(s, d, h, dh), "wk": dense(s, d, h, dh),
             "wv": dense(s, d, h, dh), "wo": dense(s, h, dh, d),
             "ln2": np.ones((s, d), np.float32)}
        if e:
            b.update(router=dense(s, d, e), ew1=dense(s, e, d, f),
                     ew2=dense(s, e, f, d))
        else:
            b.update(w1=dense(s, d, f), b1=np.zeros((s, f), np.float32),
                     w2=dense(s, f, d), b2=np.zeros((s, d), np.float32))
        blocks.append(b)
    p["blocks"] = blocks
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


def _route_top_k(probs, k: int):
    """``(weights, experts)`` of the top-k choices, trailing dim k: k == 1
    keeps the raw top probability (Switch), k >= 2 renormalises the top-k
    probabilities to sum to one (Mixtral). Equal probabilities may come
    out in another order than JAX's (``torch.topk`` promises no order
    among equals, ``jax.lax.top_k`` puts the lower index first)."""
    vals, idx = torch.topk(probs, k, dim=-1)
    if k > 1:
        vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-12)
    return vals, idx


def _expert_slice(w, g):
    """Expert ``g`` of ``w`` [E, ...] (shared by every rank) or [R, E,
    ...] (each rank's pipe stage): ``g`` an int, the same expert for
    every rank, or [R] each rank's."""
    per_rank = w.dim() == 4
    if isinstance(g, int):
        return w[:, g] if per_rank else w[g]
    if per_rank:
        return w[torch.arange(w.shape[0], device=w.device), g]
    return w[g]


def _moe_dense(bp, h, probs, k: int, dt: torch.dtype = torch.float32,
               ax: Optional["_Axes"] = None, tp: int = 1):
    """Dense dispatch: every expert on every token of ``h`` [..., D],
    combined in f32 by the top-k weights of ``probs`` [..., E] (the
    reference forward's, decode's and the train step's MoE). The products
    run in ``dt`` with their outputs rounded to it; over an expert axis
    (``h`` [R, T, D]) each rank runs its E / e local experts — slices of
    the one shared ``ew1``/``ew2`` on a hosted mesh, the process's own
    experts one rank per process — and the caller sums over the axis.
    ``tp`` > 1 (tensor-parallel decode) sums each expert's output over
    the model ranks' slices of its hidden units. Returns ``(y,
    experts)``."""
    wts, experts = _route_top_k(probs, k)
    E, e = probs.shape[-1], _expert_size(ax)
    h_c = h.to(dt)
    y = h.new_zeros(h.shape, dtype=torch.float32)
    for j in range(E // e):
        if e == 1:
            gid = widx = j
        else:
            # each rank's j-th local expert, within the process's block
            # of the expert dim (all of it on a hosted mesh)
            g = axis_index(ax.expert) * (E // e) + j
            gid, widx = g[:, None, None], g - _expert_offset(ax, E // e)
        w1 = _expert_slice(bp["ew1"], widx).to(dt)
        w2 = _expert_slice(bp["ew2"], widx).to(dt)
        sel = ((experts == gid).to(torch.float32) * wts).sum(dim=-1)
        z = torch.relu(h_c @ w1)
        y = y + _fold_mm(z, w2, 1, tp, dt).float() * sel[..., None]
    return y, experts


def _check_decode_config(cfg: TransformerConfig) -> None:
    if cfg.n_experts and cfg.moe_router == "expert_choice":
        raise NotImplementedError(
            "expert-choice MoE has no decode form: each expert picks "
            "its top tokens ACROSS the batch, so slots would couple — "
            "the property continuous batching forbids. Token-choice "
            "MoE decodes via dense dispatch (_decode_ffn).")


def _q_matmul(x, w_q, w_s):
    """The int8-weight product of the quantized decode FFN (the JAX
    ``_q_matmul``): ``x`` [T, I] f32 rounded to bf16 meets ``w_q`` [I, O]
    int8 widened exactly (|q| <= 127 is exact in bf16), products summed
    AND returned in f32 — never rounded to bf16 before the scale, as a
    plain bf16 product would — then ``w_s`` [O], the per-output-channel
    scales. On a CUDA device one bf16 product with an f32 output
    (``torch.mm(..., out_dtype=torch.float32)``: each weight crosses as 2
    bytes); elsewhere both operands widened to f32 (exact products, f32
    sums either way)."""
    a = x.to(torch.bfloat16)
    if x.device.type == "cuda":
        acc = torch.mm(a, w_q.to(torch.bfloat16), out_dtype=torch.float32)
    else:
        acc = a.to(torch.float32) @ w_q.to(torch.float32)
    return acc * w_s


def quantize_decode_ffn(params, cfg: TransformerConfig,
                        scale_multiplier: float = 1.0):
    """Per-channel int8 quantization of the decode FFN weights (the JAX
    ``quantize_decode_ffn``), computed once. For every stage's ``w1``
    [s, D, F] and ``w2`` [s, F, D]: symmetric per-output-channel scales
    ``amax(|w|, axis=input) / 127`` (f32; a zero channel's scale is 1.0)
    and the weights rounded half to even into ``w1_q``/``w2_q`` (int8,
    clipped to +-127) beside ``w1_s``/``w2_s``; the f32 ``w1``/``w2`` are
    dropped, every other leaf is kept as the same object (numpy leaves
    or tensors; the new leaves are tensors on their weight's device).
    MoE configs are refused. ``scale_multiplier`` != 1.0 deliberately
    corrupts the stored scales (the rollout-verify tests' chaos knob)."""
    _check_decode_config(cfg)
    if cfg.n_experts:
        raise NotImplementedError(
            "quantized decode FFN supports dense-MLP configs only")
    blocks = []
    for bp in params["blocks"]:
        b = {k: v for k, v in bp.items() if k not in ("w1", "w2")}
        for name in ("w1", "w2"):
            w = (bp[name].to(torch.float32) if isinstance(
                bp[name], torch.Tensor) else torch.tensor(
                np.asarray(bp[name], np.float32)))        # [s, I, O]
            sc = w.abs().amax(dim=1) / 127.0              # [s, O]
            sc = torch.where(sc > 0, sc, torch.ones_like(sc))
            b[name + "_q"] = torch.clamp(torch.round(w / sc[:, None, :]),
                                         -127, 127).to(torch.int8)
            b[name + "_s"] = (sc * float(scale_multiplier)).to(torch.float32)
        blocks.append(b)
    return {**params, "blocks": blocks}


def _tp_sum(y, axis: Optional[MeshAxis]):
    """A decode branch's partial output summed over a model axis across
    processes (tensor-parallel decode, one rank per process): the
    identity where the model ranks fold into this process (``tp``)."""
    return y if axis is None else leave_branch(y, axis)


def _decode_ffn(bp, h, cfg: TransformerConfig, tp: int = 1,
                axis: Optional[MeshAxis] = None):
    """The decode paths' FFN over post-``ln2`` activations ``h`` [..., D]
    (the JAX ``_decode_ffn``): the dense MLP; for MoE, token-choice
    routing by dense dispatch (every expert on every token, the top-k
    router weights combining; capacity is ignored, since dropping a
    routing would truncate a live sequence); for an int8 tree
    (:func:`quantize_decode_ffn`), the MLP through :func:`_q_matmul` with
    the biases and the residual in f32. Over ``tp`` > 1 model ranks
    (tensor-parallel decode, the JAX ``decode_param_specs`` split) each
    rank holds its slice of the hidden units — of ``w1/b1/w2``, of every
    expert's ``ew1/ew2``, of ``w1_q/w1_s/b1/w2_q`` — and the ranks'
    partial outputs are summed before ``b2``: over ``axis`` where the
    ranks are processes of their own (:func:`_tp_sum`)."""
    if cfg.n_experts:
        return _tp_sum(_moe_dense(bp, h,
                                  torch.softmax(h @ bp["router"], dim=-1),
                                  cfg.moe_top_k, tp=tp)[0], axis)
    if "w1_q" in bp:
        hf = h.reshape(-1, h.shape[-1])
        z = torch.relu(_q_matmul(hf, bp["w1_q"], bp["w1_s"]) + bp["b1"])
        y = _tp_sum(_fold_mm(z, bp["w2_q"], 1, tp, None,
                             mm=lambda a, w: _q_matmul(a, w, bp["w2_s"])),
                    axis)
        return (y + bp["b2"]).reshape(h.shape)
    return _tp_sum(_fold_mm(torch.relu(h @ bp["w1"] + bp["b1"]), bp["w2"],
                            1, tp, h.dtype), axis) + bp["b2"]


def _rank_offsets(tp: int, per_rank: int, like: torch.Tensor):
    """``[0, per_rank, 2 * per_rank, ...]`` (``tp`` entries) in ``like``'s
    dtype and device: where each model rank's pages (or lanes) start in a
    pool that holds every rank's, rank-major."""
    return torch.arange(tp, dtype=like.dtype, device=like.device) * per_rank


def _reference_ec(bp, h, cfg: TransformerConfig, ec_groups: int):
    """The unsharded expert-choice MoE of ``h`` [b, s, D] (the JAX
    ``_reference_ec``): expert choice within each of ``ec_groups`` equal
    token groups (a rank's token shard in the SPMD step). Returns ``(y,
    mean logsumexp(router logits)^2)``."""
    b, s, d = h.shape
    T, E = b * s, cfg.n_experts
    hf = h.reshape(T, d)
    logits = hf @ bp["router"]
    probs = torch.softmax(logits, dim=-1)
    tg = T // ec_groups
    C = max(int(math.ceil(cfg.moe_capacity_factor * tg / E)), 1)
    ys = []
    for g in range(ec_groups):
        hg = hf[g * tg:(g + 1) * tg]
        wts, idx = torch.topk(probs[g * tg:(g + 1) * tg].T, min(C, tg),
                              dim=-1)                     # (E, C)
        z = torch.relu(torch.einsum("ecd,edf->ecf", hg[idx], bp["ew1"]))
        out = torch.einsum("ecf,efd->ecd", z, bp["ew2"])
        ys.append(hg.new_zeros(tg, d).index_add(
            0, idx.reshape(-1), out.reshape(-1, d) * wts.reshape(-1)[:, None]))
    lse = torch.logsumexp(logits, dim=-1)
    return torch.cat(ys).reshape(b, s, d), torch.mean(torch.square(lse))


def _reference_forward(params: Params, tokens: torch.Tensor,
                       cfg: TransformerConfig, ec_groups: int = 1):
    """The unsharded f32 forward (the JAX ``_reference_forward``): dense
    causal attention, the FFN of :func:`_decode_ffn` (dense dispatch for
    token-choice MoE), expert choice by :func:`_reference_ec`. Returns
    ``(logits, aux_total, z_total)``."""
    x = params["embed"][tokens]
    pos = torch.arange(tokens.shape[1], device=x.device)
    aux_total = z_total = x.new_zeros(())
    E = cfg.n_experts
    for bp in _decode_block_params(params, cfg):
        h = _rmsnorm(x, bp["ln1"])
        q = _rope(_proj(h, bp["wq"]), pos)
        k = _rope(_proj(h, bp["wk"]), pos)
        v = _proj(h, bp["wv"])
        a = CA.flash_prefill_attention_plain(q, k, v)
        x = x + _out_proj(a, bp["wo"])
        h = _rmsnorm(x, bp["ln2"])
        if E and cfg.moe_router == "expert_choice":
            y, z_layer = _reference_ec(bp, h, cfg, ec_groups)
            x = x + y
            if cfg.moe_zloss_weight > 0:
                z_total = z_total + z_layer
        elif E:
            logits = h @ bp["router"]
            probs = torch.softmax(logits, dim=-1)
            y, experts = _moe_dense(bp, h, probs, cfg.moe_top_k)
            x = x + y
            if cfg.moe_aux_weight > 0:
                f, P = _router_stats(probs.reshape(1, -1, E),
                                     experts[..., 0].reshape(1, -1), E, ())
                aux_total = aux_total + E * torch.sum(f * P)
            if cfg.moe_zloss_weight > 0:
                lse = torch.logsumexp(logits, dim=-1)
                z_total = z_total + torch.mean(torch.square(lse))
        else:
            x = x + _decode_ffn(bp, h, cfg)
    logits = _rmsnorm(x, params["final_norm"]) @ params["head"]
    return logits, aux_total, z_total


def reference_logits(params: Params, tokens: torch.Tensor,
                     cfg: TransformerConfig) -> torch.Tensor:
    """Per-position next-token logits ``[b, s, vocab]`` from the whole
    context, dense causal attention — the port's full-context oracle
    (the JAX ``reference_logits``; an int8 tree's FFN runs
    :func:`_q_matmul`, as its decode does)."""
    return _reference_forward(params, tokens, cfg)[0]


def decode_param_specs(cfg: TransformerConfig, mesh: Mesh,
                       quantized_ffn: bool = False) -> Dict[str, Any]:
    """The JAX ``decode_param_specs`` tree (a tuple of axis names a leaf,
    ``None`` = replicated), tensor-parallel decode's split: the heads of
    ``wq/wk/wv/wo`` and the FFN's hidden units over ``model`` — ``w1/b1/
    w2``, every expert's ``ew1``/``ew2``, or an int8 tree's ``w1_q/w1_s/
    b1/w2_q`` (each scale with its product's output channels) — and every
    other leaf replicated. ``n_heads`` and ``d_ff`` must divide over the
    model axis."""
    _check_decode_config(cfg)
    model = AXIS_MODEL if AXIS_MODEL in mesh.shape else None
    tp = mesh.shape.get(AXIS_MODEL, 1)
    if model and cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} must divide over the "
                         f"model axis ({tp})")
    if model and cfg.d_ff % tp:
        raise ValueError(f"d_ff={cfg.d_ff} must divide over the "
                         f"model axis ({tp})")
    b = {"ln1": (), "ln2": (), "wq": (None, None, model, None),
         "wk": (None, None, model, None), "wv": (None, None, model, None),
         "wo": (None, model, None, None)}
    if cfg.n_experts:
        b.update(router=(), ew1=(None, None, None, model),
                 ew2=(None, None, model, None))
    elif quantized_ffn:
        b.update(w1_q=(None, None, model), w1_s=(None, model),
                 b1=(None, model), w2_q=(None, model, None), w2_s=(),
                 b2=())
    else:
        b.update(w1=(None, None, model), b1=(None, model),
                 w2=(None, model, None), b2=())
    return {"embed": (), "head": (), "final_norm": (),
            "blocks": [dict(b) for _ in range(cfg.layers_per_stage)]}


def cut_decode_params(params, cfg: TransformerConfig, mesh: Mesh,
                      quantized_ffn: bool = False) -> Params:
    """This process's part of a decode tree over a mesh whose model axis
    lies across processes: each leaf :func:`decode_param_specs` splits,
    cut to the process's block (its model ranks' heads and hidden
    units); every other leaf as it is."""
    specs = decode_param_specs(cfg, mesh, quantized_ffn)
    return {**params,
            "blocks": [{k: _cut_leaf(v, sp.get(k, ()), mesh)
                        for k, v in bp.items()}
                       for bp, sp in zip(params["blocks"], specs["blocks"])]}


def decode_cache_spec(mesh: Mesh) -> Tuple[Optional[str], ...]:
    """The JAX ``decode_cache_spec``: the KV pool's head dim over
    ``model``, in the logical layout ``[n_layers, pages or slots, rows,
    H, Dh]`` (the port's pool puts each model rank's heads in pages of
    their own, :func:`init_paged_kv_cache`, the same bytes a rank)."""
    return (None, None, None,
            AXIS_MODEL if AXIS_MODEL in mesh.shape else None, None)


# ---------------------------------------------------------------------------
# the paged KV pool and its builders


def init_paged_kv_cache(cfg: TransformerConfig, n_pages: int,
                        page_size: int, device: DeviceLike = None,
                        tp: int = 1) -> Dict[str, torch.Tensor]:
    """The shared page pool: ``{"k", "v"}`` f32 zeros of shape
    ``[n_layers, n_pages, page_size, n_heads, d_head]``, allocated once;
    page 0 is the scratch page, so ``n_pages - 1`` pages are
    claimable. Over ``tp`` model ranks (tensor-parallel decode) the pool
    is ``[n_layers, tp * n_pages, page_size, n_heads / tp, d_head]``:
    rank ``r``'s pages are ``[r * n_pages, (r + 1) * n_pages)``, each
    holding only its heads' lanes, so a rank's pool is ``1 / tp`` of the
    bytes, contiguous a layer; every rank's page tables are the same,
    offset by ``r * n_pages``."""
    _check_decode_config(cfg)
    shape = (cfg.n_layers, tp * int(n_pages), int(page_size),
             cfg.n_heads // tp, cfg.d_head)
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
                        pages_per_slot: int, attn_impl: str = "dense",
                        tp: int = 1,
                        axis: Optional[MeshAxis] = None) -> Callable:
    """``prefill(params, cache, tokens, page_table, length) -> (cache,
    next_token, last_logits)``: the cold prefill of one bucket-padded
    prompt ``tokens`` [S_pad] into the pages of ``page_table``
    [pages_per_slot] (int32), ``length`` the true prompt length (int).

    Each layer writes its K/V into the pool BEFORE its attention runs:
    buckets >= ``page_size`` scatter whole page chunks (chunks past the
    claimed pages ride table entry 0, the scratch page), smaller
    buckets write rows [0, S) of the first page. Attention runs over
    the q/k/v just computed (K2 under ``"cuda"``). Over ``tp`` model
    ranks (:func:`init_paged_kv_cache`'s layout) each rank's heads write
    its own pages and K2 takes the ranks as its batch."""
    _check_impl(attn_impl)
    page_size, pages_per_slot = int(page_size), int(pages_per_slot)
    scale = cfg.d_head ** -0.5
    attn = (CA.flash_prefill_attention if attn_impl == "cuda"
            else CA.flash_prefill_attention_plain)
    nh, dh = cfg.n_heads // tp, cfg.d_head

    @torch.no_grad()
    def prefill(params, cache, tokens, page_table, length: int):
        S = tokens.shape[0]
        x = params["embed"][tokens][None]              # [1, S, D]
        pos = torch.arange(S, device=x.device)
        ck, cv = cache["k"], cache["v"]
        off = _rank_offsets(tp, ck.shape[1] // tp, page_table)
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _fold_heads(_rope(_proj(h, bp["wq"]), pos), 1, tp)
            k = _fold_heads(_rope(_proj(h, bp["wk"]), pos), 1, tp)
            v = _fold_heads(_proj(h, bp["wv"]), 1, tp)      # [tp, S, nh, dh]
            if S >= page_size:
                n_chunks = S // page_size
                pgs = (off[:, None] + page_table[:n_chunks]).reshape(-1)
                ck[l, pgs] = k.reshape(tp * n_chunks, page_size, nh, dh)
                cv[l, pgs] = v.reshape(tp * n_chunks, page_size, nh, dh)
            else:
                # a sub-page bucket: rows [0, S) of the first page
                ck[l][off + page_table[0], :S] = k
                cv[l][off + page_table[0], :S] = v
            a = attn(q, k, v, scale)
            x = x + _tp_sum(_fold_out(a, bp["wo"], 1, tp, a.dtype), axis)
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]), cfg, tp, axis)
        nxt, logits = _last_logits(params, x[0], int(length) - 1)
        return cache, nxt, logits

    return prefill


def build_paged_prefix_prefill(cfg: TransformerConfig, page_size: int,
                               pages_per_slot: int,
                               attn_impl: str = "dense",
                               tp: int = 1,
                        axis: Optional[MeshAxis] = None) -> Callable:
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
    padding over shared prefix pages. Over ``tp`` model ranks each rank's
    heads go through K3 with its own pages (one launch a rank: K3 takes
    one table a launch)."""
    _check_impl(attn_impl)
    page_size, pages_per_slot = int(page_size), int(pages_per_slot)
    scale = cfg.d_head ** -0.5
    attn = (CA.paged_prefix_prefill_attention if attn_impl == "cuda"
            else CA.paged_prefix_prefill_attention_plain)
    nh, dh = cfg.n_heads // tp, cfg.d_head

    @torch.no_grad()
    def prefill(params, cache, tokens, page_table, length: int,
                hit_len: int):
        S = tokens.shape[0]
        hit_len = int(hit_len)
        x = params["embed"][tokens]                    # [S, D]
        pos = hit_len + torch.arange(S, device=x.device)
        start_page = hit_len // page_size
        ck, cv = cache["k"], cache["v"]
        off = _rank_offsets(tp, ck.shape[1] // tp, page_table)
        tables = off[:, None] + page_table             # [tp, pages_per_slot]
        if S >= page_size:
            n_chunks = S // page_size
            cpos = start_page + torch.arange(n_chunks, device=x.device)
            pgs = torch.where(
                cpos < pages_per_slot,
                page_table[cpos.clamp(max=pages_per_slot - 1)],
                torch.zeros((), dtype=page_table.dtype, device=x.device))
            pgs = (off[:, None] + pgs).reshape(-1)
        else:
            # a sub-page suffix: rows [0, S) of the first private page
            pg = tables[:, start_page]
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _fold_heads(_rope_at(_proj(h, bp["wq"]), pos)[None], 1,
                            tp)
            k = _fold_heads(_rope_at(_proj(h, bp["wk"]), pos)[None], 1,
                            tp)
            v = _fold_heads(_proj(h, bp["wv"])[None], 1, tp)  # [tp, S, nh, dh]
            if S >= page_size:
                ck[l, pgs] = k.reshape(tp * n_chunks, page_size, nh, dh)
                cv[l, pgs] = v.reshape(tp * n_chunks, page_size, nh, dh)
            else:
                ck[l][pg, :S] = k
                cv[l][pg, :S] = v
            a = torch.stack([attn(q[r], ck[l], cv[l], tables[r], hit_len,
                                  scale, page_size) for r in range(tp)])
            x = x + _tp_sum(_fold_out(a, bp["wo"], 1, tp, a.dtype)[0],
                            axis)
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]), cfg, tp, axis)
        nxt, logits = _last_logits(params, x, int(length) - 1 - hit_len)
        return cache, nxt, logits

    return prefill


def build_paged_decode_step(cfg: TransformerConfig, n_slots: int,
                            page_size: int, pages_per_slot: int,
                            attn_impl: str = "dense",
                            tp: int = 1,
                        axis: Optional[MeshAxis] = None) -> Callable:
    """``step(params, cache, tokens, pos, page_tables) -> (cache,
    next_tokens, logits)``: one token for every slot. ``tokens``/``pos``
    are [n_slots] int32, ``page_tables`` [n_slots, pages_per_slot]
    int32. Each slot writes its new K/V row at page
    ``page_tables[slot, pos // page_size]``, row ``pos % page_size``,
    then attends over its lane masked to ``index <= pos`` (K1 under
    ``"cuda"``). Free slots ride at token 0 / pos 0 with an all-scratch
    table: their writes all land on page 0, row 0 — duplicate indices
    that are harmless only because page 0 is scratch. Over ``tp`` model
    ranks each rank's heads are slots of their own over its pages, so
    one K1 launch a layer takes every rank (tables offset to the rank's
    pages, positions shared)."""
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
        row, pos_t = pos % page_size, pos
        if tp > 1:
            off = _rank_offsets(tp, ck.shape[1] // tp, page_tables)
            pg = (off[:, None] + pg).reshape(-1)
            page_tables = (off[:, None, None] + page_tables).reshape(
                tp * n_slots, pages_per_slot)
            row, pos_t = row.repeat(tp), pos.repeat(tp)
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _fold_heads(_rope_at(_proj(h, bp["wq"]), pos), 1, tp)
            k = _fold_heads(_rope_at(_proj(h, bp["wk"]), pos), 1, tp)
            v = _fold_heads(_proj(h, bp["wv"]), 1, tp)
            ck[l, pg, row] = k
            cv[l, pg, row] = v
            a = attn(q, ck[l], cv[l], page_tables, pos_t, scale, page_size)
            x = x + _tp_sum(_fold_out(a, bp["wo"], 1, tp, a.dtype), axis)
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]), cfg, tp, axis)
        h = _rmsnorm(x, params["final_norm"])
        logits = h @ params["head"]
        return cache, torch.argmax(logits, dim=-1).to(torch.int32), logits

    return step


# ---------------------------------------------------------------------------
# the draft's dense slot-lane cache


def init_kv_cache(cfg: TransformerConfig, n_slots: int, max_len: int,
                  device: DeviceLike = None, tp: int = 1
                  ) -> Dict[str, torch.Tensor]:
    """The slot-indexed pool (a speculative draft's, and the dense
    decoder's): ``{"k", "v"}`` f32 zeros of shape ``[n_layers, n_slots,
    max_len, n_heads, d_head]``, allocated once and updated in place.
    Over ``tp`` model ranks, ``[n_layers, tp * n_slots, max_len, n_heads
    / tp, d_head]``: rank ``r``'s lanes are ``[r * n_slots, (r + 1) *
    n_slots)``, each holding its heads."""
    _check_decode_config(cfg)
    shape = (cfg.n_layers, tp * int(n_slots), int(max_len),
             cfg.n_heads // tp, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=dev),
            "v": torch.zeros(shape, dtype=torch.float32, device=dev)}


def build_prefill(cfg: TransformerConfig, attn_impl: str = "dense",
                  tp: int = 1, axis: Optional[MeshAxis] = None) -> Callable:
    """``prefill(params, cache, tokens, slot, length) -> (cache,
    next_token, last_logits)`` over the dense slot-lane pool: every
    layer writes the bucket-padded prompt's K/V into rows ``[0, S)`` of
    lane ``slot`` (rows past ``length`` hold padding garbage that the
    step's position mask never reads before overwriting), and attention
    runs over the q/k/v just computed (K2 under ``"cuda"``).

    The JAX decoder builds its draft prefill with the dense engine; the
    port's decoder builds it with the decoder's engine, so on the card
    the draft prefill runs K2 and no plain version is on the main
    path. Over ``tp`` model ranks (:func:`init_kv_cache`'s layout) each
    rank's heads fill its own lane."""
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
        lanes = int(slot) + _rank_offsets(tp, ck.shape[1] // tp, tokens)
        for l, bp in enumerate(_decode_block_params(params, cfg)):
            h = _rmsnorm(x, bp["ln1"])
            q = _fold_heads(_rope(_proj(h, bp["wq"]), pos), 1, tp)
            k = _fold_heads(_rope(_proj(h, bp["wk"]), pos), 1, tp)
            v = _fold_heads(_proj(h, bp["wv"]), 1, tp)      # [tp, S, H/tp, Dh]
            ck[l, lanes, :S] = k
            cv[l, lanes, :S] = v
            a = attn(q, k, v, scale)
            x = x + _tp_sum(_fold_out(a, bp["wo"], 1, tp, a.dtype), axis)
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]), cfg, tp, axis)
        nxt, logits = _last_logits(params, x[0], int(length) - 1)
        return cache, nxt, logits

    return prefill


def _dense_step_body(params, cfg: TransformerConfig, ck, cv, tokens, pos,
                     tp: int = 1, axis: Optional[MeshAxis] = None):
    """One single-token step for every slot over the dense slot-lane
    pool (in place) -> ``(next_tokens, logits)``: slot ``n`` writes its
    K/V row at ``pos[n]``, then attends its lane masked to ``index <=
    pos``. The body :func:`build_decode_step` runs once and
    :func:`build_draft_propose` ``width`` times.

    A position past the lane end (a slot riding a propose near it) is
    not written: JAX drops such an out-of-bounds update, and the port
    writes that slot's last row back unchanged instead. Over ``tp`` model
    ranks each rank's heads are lanes of their own
    (:func:`init_kv_cache`)."""
    max_len = ck.shape[2]
    scale = cfg.d_head ** -0.5
    pos_t = pos.repeat(tp) if tp > 1 else pos          # a row a rank's lane
    rows = torch.arange(ck.shape[1], device=tokens.device)
    idx = torch.arange(max_len, device=tokens.device)
    mask = idx[None, None, :] <= pos_t[:, None, None]  # [N, 1, S]
    keep = (pos_t < max_len)[:, None, None]
    wpos = pos_t.clamp(max=max_len - 1)
    x = params["embed"][tokens]                        # [N, D]
    for l, bp in enumerate(_decode_block_params(params, cfg)):
        h = _rmsnorm(x, bp["ln1"])
        q = _fold_heads(_rope_at(_proj(h, bp["wq"]), pos), 1, tp)
        k = _fold_heads(_rope_at(_proj(h, bp["wk"]), pos), 1, tp)
        v = _fold_heads(_proj(h, bp["wv"]), 1, tp)
        ck[l, rows, wpos] = torch.where(keep, k, ck[l, rows, wpos])
        cv[l, rows, wpos] = torch.where(keep, v, cv[l, rows, wpos])
        s = torch.einsum("nhk,nshk->nhs", q, ck[l]) * scale
        s = torch.where(mask, s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        a = torch.einsum("nhs,nshk->nhk", p, cv[l])
        x = x + _tp_sum(_fold_out(a, bp["wo"], 1, tp, a.dtype), axis)
        x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]), cfg, tp, axis)
    logits = _rmsnorm(x, params["final_norm"]) @ params["head"]
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def build_decode_step(cfg: TransformerConfig, n_slots: int,
                      max_len: int, tp: int = 1,
                      axis: Optional[MeshAxis] = None) -> Callable:
    """``step(params, cache, tokens, pos) -> (cache, next_tokens,
    logits)``: one token for every slot of the dense slot-lane pool
    (``tokens``/``pos`` [n_slots] int32; free slots ride at token 0 /
    pos 0, their lane row 0 rewritten by the next prefill); over ``tp``
    model ranks, :func:`init_kv_cache`'s layout."""

    @torch.no_grad()
    def step(params, cache, tokens, pos):
        _check_lanes(cache, n_slots * tp, max_len)
        nxt, logits = _dense_step_body(params, cfg, cache["k"], cache["v"],
                                       tokens, pos, tp, axis)
        return cache, nxt, logits

    return step


def _check_lanes(cache, n_lanes: int, max_len: int) -> None:
    if tuple(cache["k"].shape[1:3]) != (int(n_lanes), int(max_len)):
        raise ValueError(f"cache lanes {tuple(cache['k'].shape[1:3])} "
                         f"!= (lanes, max_len) ({n_lanes}, {max_len})")


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
            x = x + _decode_ffn(bp, _rmsnorm(x, bp["ln2"]), cfg)
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
                     device: DeviceLike = None,
                     heads: Optional[int] = None) -> str:
    """The train step's attention engine for ``cfg.attention_impl`` at
    sequence length ``seq`` and ``heads`` heads a rank (default
    ``cfg.n_heads``; a model axis of size t leaves each rank ``n_heads /
    t``, the heads the kernel sees). ``"auto"`` takes the JAX thresholds on a
    CUDA device — ``"folded"`` (K7) where its shape rule holds from
    S >= 256 at head dims < 128, ``"flash"`` from S >= 2048, ``"dense"``
    below — with the JAX TPU-backend test replaced by the kernels' head
    dim limit, and ``"dense"`` on the CPU. A named engine runs, or
    raises: ``"folded"`` on a shape its rule refuses is an error (JAX
    would warn and fall back)."""
    impl = cfg.attention_impl
    h, dh = heads or cfg.n_heads, cfg.d_head
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


def _per_rank(fn, x, v):
    """``fn(x, v)`` for a gain or bias ``v``: [N] shared by every rank, or
    [R, N] (each rank's pipe stage), broadcast over each rank's rows of
    ``x`` [R * rows, ..., N] (rank-major) or [R, T, N]."""
    if v.dim() == 1:
        return fn(x, v)
    return fn(x.view(v.shape[0], -1, x.shape[-1]), v[:, None, :]).view(
        x.shape)


def _rank_mm(x, w):
    """``x`` [R * rows, ..., K] through ``w`` [K, N] shared by every rank,
    or [R, K, N] per rank (a batched product over the ranks' stages)."""
    if w.dim() == 2:
        return x @ w
    return (x.reshape(w.shape[0], -1, x.shape[-1]) @ w).reshape(
        *x.shape[:-1], w.shape[-1])


def _fold_sum(zf, w, dt, mm=None):
    """The hosted model ranks' partial products summed (the JAX ``psum``
    over ``model``): ``zf`` [R, t, M, K/t] each model rank's slice of the
    inputs, ``w`` [K, N] (or [R, K, N] per pipe stage) whose rows split
    over the t ranks alike. Each partial comes out in ``dt`` — or from
    ``mm``, a 2-D product with an f32 output (the int8 decode FFN's
    :func:`_q_matmul`; R 1, ``w`` [K, N]) — and is summed in f32 -> [R,
    M, N]."""
    t, kg = zf.shape[1], zf.shape[-1]
    wf = w.reshape(*w.shape[:-2], t, kg, w.shape[-1])
    if mm is not None:
        return sum(mm(zf[0, i], wf[i]) for i in range(t))[None]
    return (zf @ wf.to(dt)).float().sum(dim=1)


def _fold_mm(z, w, r: int, fold: int, dt, mm=None):
    """``z`` [R * rows, ..., K] through ``w`` [K, N] (or [R, K, N]) as
    ``fold`` hosted model ranks do it, each through its contiguous slice
    of the K units (:func:`_fold_sum`) -> [R * rows, ..., N]; the plain
    product (or ``mm``) at ``fold`` 1."""
    if fold == 1:
        return mm(z, w) if mm is not None else z @ w
    zf = z.reshape(r, -1, fold, z.shape[-1] // fold).transpose(1, 2)
    return _fold_sum(zf, w, dt, mm).view(*z.shape[:-1], -1)


def _fold_heads(t, r: int, fold: int):
    """q/k/v [R * rows, ..., H, Dh] -> [R * fold * rows, ..., H / fold,
    Dh]: each hosted model rank's heads as rows of their own beside the
    others', rank-major within each of the R row groups, so one kernel
    launch takes every model rank (the JAX ``shard_map`` over each rank's
    head slice)."""
    if fold == 1:
        return t
    return t.unflatten(-2, (fold, t.shape[-2] // fold)).unflatten(
        0, (r, -1)).movedim(-3, 1).flatten(0, 2).contiguous()


def _fold_out(a, wo, r: int, fold: int, dt):
    """Attention output ``a`` [R * fold * rows, ..., H / fold, Dh]
    (:func:`_fold_heads`' layout) through ``wo`` (H, Dh, D), or (R, H,
    Dh, D) per rank, each model rank through its heads' rows, the
    partial outputs summed (:func:`_fold_sum`) -> [R * rows, ..., D];
    the plain projection at ``fold`` 1."""
    if fold == 1:
        return _out_proj(a, wo)
    zf = a.to(dt).reshape(r, fold, -1, a.shape[-2] * a.shape[-1])
    return _fold_sum(zf, wo.flatten(-3, -2), dt).view(
        a.shape[0] // fold, *a.shape[1:-2], -1)


def _model_fold(ax: Optional["_Axes"]) -> int:
    """How many model ranks this process's branches compute side by side:
    the model axis's hosted part (1 where the axis lies across
    processes)."""
    return ax.fold if ax is not None else 1


def _branch_in(h, ax: Optional["_Axes"]):
    """A branch's input across model ranks in processes of their own."""
    if ax is None or ax.model is None or ax.model.across_size == 1:
        return h
    return enter_branch(h, ax.model)


def _branch_out(y, ax: Optional["_Axes"]):
    """A branch's partial output summed over the model axis's part across
    processes (its hosted part :func:`_fold_sum` has summed)."""
    if ax is None or ax.model is None or ax.model.across_size == 1:
        return y
    return leave_branch(y, ax.model)


def _attention(bp, x, cfg: TransformerConfig, pos, impl: Optional[str],
               ax: Optional["_Axes"] = None):
    """One block's attention branch (the JAX ``_attention``): the
    projections in the compute dtype with their outputs rounded to it
    (bf16 einsums), rope in f32 at ``pos`` ([S], or [rows, S] per row),
    the engine's attention, the output projection in the compute dtype.
    With a ``seq`` axis the attention goes around the ring, ``x`` holding
    the hosted ranks' rows rank-major, and ``cfg.attention_impl`` maps as
    in JAX: "auto" -> "auto_train", "folded" -> "folded", anything else
    -> "dense".

    Over a model axis each model rank takes ``n_heads / t`` heads and the
    ranks' partial outputs are summed before the residual add. Hosted,
    the model ranks' heads fold into the kernel's batch (one launch a
    layer) and their partial products are summed here; one rank per
    process, each holds its heads' weights and the sum is an
    ``all_reduce`` (:func:`~mmlspark_tpu_torch.parallel.collectives.
    leave_branch`)."""
    dt = _compute_dtype(cfg)
    mm_dt = dt if dt != torch.float32 else None
    r = ax.mesh.n_hosted if ax is not None else 1
    fold = _model_fold(ax)
    h = _branch_in(_per_rank(_rmsnorm, x, bp["ln1"]), ax).to(dt)
    q = _rope_at(_proj_r(h, bp["wq"].to(dt)).float(), pos)
    k = _rope_at(_proj_r(h, bp["wk"].to(dt)).float(), pos)
    v = _proj_r(h, bp["wv"].to(dt)).float()
    if fold > 1:
        q, k, v = (_fold_heads(t, r, fold) for t in (q, k, v))
    if ax is not None and ax.seq is not None:
        ring_impl = ("auto_train" if cfg.attention_impl == "auto"
                     else "folded" if cfg.attention_impl == "folded"
                     else "dense")
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
    if fold == 1:
        wo = bp["wo"].to(dt).flatten(-3, -2)
        return _branch_out(_rank_mm(a.to(dt).flatten(-2), wo).float(), ax)
    return _branch_out(_fold_out(a, bp["wo"], r, fold, dt), ax)


def _proj_r(h, w):
    """``h`` [..., D] through ``w`` (D, H, Dh), or (R, D, H, Dh) per rank
    -> [..., H, Dh]."""
    return _rank_mm(h, w.flatten(-2)).unflatten(-1, w.shape[-2:])


def _mlp(bp, x, cfg: TransformerConfig, ax: Optional["_Axes"] = None):
    """The dense MLP in the compute dtype (the JAX ``_mlp``): ``b1``
    added in it, ``b2`` in f32 after the model axis's sum (each model
    rank holds ``d_ff / t`` hidden units)."""
    dt = _compute_dtype(cfg)
    h = _branch_in(_per_rank(_rmsnorm, x, bp["ln2"]), ax).to(dt)
    z = torch.relu(_per_rank(torch.add, _rank_mm(h, bp["w1"].to(dt)),
                             bp["b1"].to(dt)))
    fold = _model_fold(ax)
    if fold == 1:
        y = _rank_mm(z, bp["w2"].to(dt)).float()
    else:
        y = _fold_mm(z, bp["w2"], ax.mesh.n_hosted, fold, dt)
    return _per_rank(torch.add, _branch_out(y, ax), bp["b2"])


def _stage(blocks, x, cfg: TransformerConfig, pos, impl: Optional[str],
           ax: Optional["_Axes"] = None):
    """The blocks over ``x`` [rows, S, D] (the hosted ranks' rows
    rank-major under ``ax``) -> ``(x, stats)``: with MoE blocks,
    ``stats`` is the per-block routing statistics of each hosted rank,
    ``(f, P)`` [n_hosted, n_blocks, E] and the z-loss means [n_hosted,
    n_blocks] (the JAX ``_stage``'s, kept linear so microbatches average
    before the aux's product); None for the dense MLP."""
    r = ax.mesh.n_hosted if ax is not None else 1
    stats = []
    for bp in blocks:
        x = x + _attention(bp, x, cfg, pos, impl, ax)
        if cfg.n_experts:
            # routing groups the tokens by rank: [n_hosted, tokens, D]
            y, st = _moe(bp, x.view(r, -1, x.shape[-1]), cfg, ax)
            x = x + y.reshape(x.shape)
            stats.append(st)
        else:
            x = x + _mlp(bp, x, cfg, ax)
    if not stats:
        return x, None
    return x, tuple(torch.stack(t, dim=1) for t in zip(*stats))


def _check_train_config(cfg: TransformerConfig,
                        ax: Optional["_Axes"] = None) -> None:
    if cfg.n_stages != 1 and (ax is None or ax.pipe is None):
        raise ValueError("n_stages > 1 requires a 'pipe' mesh axis")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r} (one of {DTYPES})")
    if cfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got "
                         f"{cfg.microbatches}")
    if cfg.n_experts and not 1 <= cfg.moe_top_k <= cfg.n_experts:
        raise ValueError(
            f"moe_top_k={cfg.moe_top_k} must be in [1, n_experts="
            f"{cfg.n_experts}]")


# ---------------------------------------------------------------------------
# the mesh as the per-rank program sees it


@dataclasses.dataclass(frozen=True)
class _Axes:
    """Mesh axes visible to the per-rank program (None = absent), as
    :class:`~mmlspark_tpu_torch.parallel.topology.MeshAxis` objects where
    the JAX ``_Axes`` holds names. ``mesh`` is the mesh of the
    per-rank tensors: where the model axis has a hosted part (a hosted
    mesh, or a mixed one whose processes each host model ranks), the
    same mesh with that part taken out of the axis, since those model
    ranks fold into the branches (:func:`_attention`, :func:`_mlp`) and
    every other value is the same on each of them; ``fold`` is the
    hosted part's size and ``model`` the rest of the axis, its part
    across processes (of size 1 on a hosted mesh), which the branches
    sum over with :func:`~mmlspark_tpu_torch.parallel.collectives.
    leave_branch`."""

    data: Optional[MeshAxis]
    seq: Optional[MeshAxis]
    model: Optional[MeshAxis]
    expert: Optional[MeshAxis]
    pipe: Optional[MeshAxis]
    mesh: Mesh

    fold: int = 1

    @staticmethod
    def of(mesh: Mesh) -> "_Axes":
        act, fold = mesh, 1
        if mesh.hosted_shape.get(AXIS_MODEL, 1) > 1:
            fold = mesh.hosted_shape[AXIS_MODEL]
            act = mesh.with_shape({a: n // fold if a == AXIS_MODEL else n
                                   for a, n in mesh.shape.items()})

        def axis(m, a):
            return m.axis(a) if a in m.shape else None

        return _Axes(axis(act, AXIS_DATA), axis(act, AXIS_SEQ),
                     axis(act, AXIS_MODEL), axis(act, AXIS_EXPERT),
                     axis(act, AXIS_PIPE), act, fold)

    @property
    def tp(self) -> int:
        """The whole model axis's size."""
        return self.fold * (self.model.size if self.model is not None
                            else 1)


def _psum_if(x, axis: Optional[MeshAxis]):
    return allreduce_sum(x, axis) if axis is not None else x


def _across(axes) -> List[MeshAxis]:
    """The axes of ``axes`` with a part across processes."""
    return [a for a in axes if a is not None and a.across_size > 1]


def _valued_sum(part: torch.Tensor, axes) -> torch.Tensor:
    """This process's share ``part`` valued as its sum over the parts of
    ``axes`` across processes (the JAX ``psum``: the loss is replicated)
    while its gradient stays the share's own: the step sums each leaf's
    gradients over the axes that hold copies of it."""
    total = part.detach()
    for a in _across(axes):
        total = all_reduce(total, a.group)
    return part + (total - part.detach())


# ---------------------------------------------------------------------------
# mixture of experts: the routers and the capacity engines
#
# Each function takes the hosted ranks' tokens ``x`` [R, T, D] (R = 1
# without a mesh) and routes each rank's tokens on their own, as the JAX
# per-device program does: capacities and the expert-choice top-C are a
# rank's (and microbatch's) token shard's.


def _pmean(x, axis: MeshAxis):
    """The JAX ``pmean`` of a routing statistic over ``axis``: hosted,
    the differentiable mean over the ranks; across processes, valued as
    the mean over every rank with the gradient of this process's share
    (its hosted ranks' sum over n), since the step sums the gradients
    over processes."""
    if axis.size == 1:
        return x
    if axis.across_size == 1:
        return allreduce_sum(x, axis) / axis.size
    share = x
    if axis.hosted_size > 1:
        grid = axis.grid(x)
        share = grid.sum(dim=axis.pos, keepdim=True).expand(
            grid.shape).reshape(x.shape)
    share = share / axis.size
    return share + (all_reduce(share, axis.group) - share).detach()


def _pmean_token_axes(x, axes):
    """pmean a token-linear statistic over every token-holding axis."""
    for a in axes:
        if a is not None:
            x = _pmean(x, a)
    return x


def _router_stats(probs, top, E: int, axes):
    """The global routing statistics of the Switch aux (the JAX
    ``_router_stats``): ``probs`` [R, T, E] and first choices ``top``
    [R, T] of each rank's tokens -> ``(f, P)`` [R, E], the routed share
    and the mean probability, pmean'd over every token-holding axis of
    ``axes``. Only these linear statistics average across shards and
    microbatches; the aux's product is taken once, from the totals."""
    f = F.one_hot(top, E).to(torch.float32).mean(dim=1)
    P = probs.to(torch.float32).mean(dim=1)
    return _pmean_token_axes(f, axes), _pmean_token_axes(P, axes)


def _take_rows(x, idx):
    """``x`` [R, N, ...] at rows ``idx`` [R, M] of each rank -> [R, M,
    ...]."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
                        .expand(*idx.shape, *x.shape[2:]))


class _PermuteRows(torch.autograd.Function):
    """``x[r, order[r]]`` with a gather in both directions (the JAX
    ``_permute_rows`` custom VJP): for a bijection the transpose of the
    gather is the gather by the inverse permutation, where autograd would
    scatter."""

    @staticmethod
    def forward(ctx, x, order, inv):
        ctx.save_for_backward(inv)
        return _take_rows(x, order)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _take_rows(g, inv), None, None


def _queue_slots(top, E: int):
    """Each routing's arrival-order slot in its expert's queue (the JAX
    one-hot cumsum read at the routing's expert), and each expert's
    count [R, E]. The one-hot is laid out [R, E, Tk] so the cumsum runs
    along the innermost dim: along the tokens' dim of [R, Tk, E], CUDA's
    scan walks 16384 rows in sequence (2.9 ms a layer on the H100 at
    ``bench_moe_train``'s shape)."""
    onehot = F.one_hot(top, E).transpose(1, 2)            # [R, E, Tk]
    arrived = torch.cumsum(onehot, dim=2)
    return torch.gather(arrived, 1, top[:, None, :])[:, 0] - 1, \
        onehot.sum(dim=2)


def _sorted_capacity_queues(h_rep, top, wf, E: int, C: int, dt):
    """Counting-sort capacity dispatch (the JAX
    ``_sorted_capacity_queues``): ``h_rep`` [R, Tk, d] routing rows,
    ``top`` [R, Tk] their experts, ``wf`` [R, Tk] their router weights
    -> ``(disp [R, E, C, d] in dt, combine)``, ``combine(y [R, E, C, d]
    f32) -> [R, Tk, d]`` the expert outputs in routing order, weighted.

    The one-hot cumsum gives each routing its slot within its expert;
    ``inv = starts[expert] + slot`` groups the routings by expert
    (stable: the same overflow routings drop as in the scatter engine)
    and ``order`` is its inverse. The rows move by permutation gathers
    (:class:`_PermuteRows`), and the E queues of C rows are read by one
    gather at ``starts[:, :, None] + arange(C)`` from the grouped rows
    padded with C zero rows: a queue's rows past its expert's count hold
    the next groups' rows, which the combine never reads, so their
    cotangent is zero."""
    R, Tk, d = h_rep.shape
    slot, counts = _queue_slots(top, E)
    starts = torch.cumsum(counts, dim=1) - counts
    inv = torch.gather(starts, 1, top) + slot             # routing -> row
    order = torch.empty_like(inv).scatter_(
        1, inv, torch.arange(Tk, device=top.device).expand(R, Tk))
    hs = _PermuteRows.apply(h_rep, order, inv)
    hs_pad = torch.cat([hs, hs.new_zeros(R, C, d)], dim=1)
    rows = starts[:, :, None] + torch.arange(C, device=top.device)
    disp = _take_rows(hs_pad, rows.reshape(R, E * C)).view(R, E, C, d)
    keep = slot < C

    def combine(y):
        at = top * C + torch.where(keep, slot, 0)
        w = (keep.to(torch.float32) * wf)[..., None]
        return _take_rows(y.reshape(R, E * C, y.shape[-1]), at) * w

    return disp.to(dt), combine


def _scatter_capacity_queues(h_rep, top, wf, E: int, C: int, dt):
    """One-hot cumsum and scatter capacity dispatch (the JAX
    ``_scatter_capacity_queues``), the contract of
    :func:`_sorted_capacity_queues`: overflow routings are written to a
    scratch column C that is sliced away (written more than once, which
    is harmless since it is thrown away) and read back from a zero
    column with weight 0."""
    R, Tk, d = h_rep.shape
    slot, _ = _queue_slots(top, E)
    keep = slot < C
    slot_c = torch.where(keep, slot, C)
    rank = torch.arange(R, device=top.device)[:, None].expand(R, Tk)
    disp = h_rep.new_zeros(R, E, C + 1, d, dtype=dt).index_put(
        (rank, top, slot_c), h_rep.to(dt))[:, :, :C]

    def combine(y):
        y = F.pad(y, (0, 0, 0, 1))                        # overflow row
        return y[rank, top, slot_c] * (keep.to(torch.float32) * wf)[..., None]

    return disp, combine


def _expert_size(ax: Optional["_Axes"]) -> int:
    return ax.expert.size if ax is not None and ax.expert is not None else 1


def _expert_offset(ax: "_Axes", e_loc: int) -> int:
    """The first expert of this process's block of the expert dim: its
    coordinate on the axis's part across processes times the experts its
    hosted ranks hold (0 on a hosted mesh)."""
    return ax.expert.across_index() * ax.expert.hosted_size * e_loc


def _expert_products(disp, w1, w2):
    """``disp`` [R, E', C, d] through each queue's expert, ``w1``/``w2``
    [E', ...] shared by every rank or [R, E', ...] per rank."""
    if w1.dim() == 3:
        z = torch.relu(torch.einsum("recd,edf->recf", disp, w1))
        return torch.einsum("recf,efd->recd", z, w2).float()
    z = torch.relu(torch.einsum("recd,redf->recf", disp, w1))
    return torch.einsum("recf,refd->recd", z, w2).float()


def _expert_ffn(bp, disp, cfg: TransformerConfig, ax: Optional["_Axes"]):
    """The queues ``disp`` [R, E, C, d] (compute dtype) through the
    experts -> [R, E, C, d] f32, the products in the compute dtype with
    their outputs rounded to it (the JAX einsums). With an expert axis,
    the queues are regrouped so each rank holds every rank's queues of
    its E / e local experts (``all_to_all``), which run on the slices of
    the one shared ``ew1``/``ew2`` on a hosted mesh (autograd sums their
    gradients) or on the process's own experts, and the results go home
    by the ``all_to_all`` the other way."""
    dt = _compute_dtype(cfg)
    w1, w2 = bp["ew1"].to(dt), bp["ew2"].to(dt)
    e = _expert_size(ax)
    if e == 1:
        return _expert_products(disp, w1, w2)
    e_loc = cfg.n_experts // e
    disp = all_to_all(disp, ax.expert, 0, 1)              # [R, e_loc, eC, d]
    if w1.shape[-3] != e_loc:
        # the hosted ranks' slices of the process's block of the expert
        # dim (the whole dim on a hosted mesh)
        gid = (axis_index(ax.expert)[:, None] * e_loc
               - _expert_offset(ax, e_loc)
               + torch.arange(e_loc, device=disp.device))  # [R, e_loc]
        if w1.dim() == 3:
            w1, w2 = w1[gid], w2[gid]
        else:
            ranks = torch.arange(w1.shape[0], device=disp.device)[:, None]
            w1, w2 = w1[ranks, gid], w2[ranks, gid]
    return all_to_all(_expert_products(disp, w1, w2), ax.expert, 1, 0)


def _router(bp, x):
    """The router in f32 on the normed ``x`` [R, T, D]: ``(h, logits,
    probs)``."""
    h = _per_rank(_rmsnorm, x, bp["ln2"])
    logits = h @ bp["router"]
    return h, logits, torch.softmax(logits, dim=-1)


def _z_stat(logits, axes):
    lse = torch.logsumexp(logits, dim=-1)
    return _pmean_token_axes(torch.mean(torch.square(lse), dim=-1), axes)


def _token_shard(ax: Optional["_Axes"], T: int, kind: str, device):
    """``(T_sh, shard)``: the size of each hosted rank's token shard on
    the expert axis and its rows, ``off + arange(T_sh)`` with ``off =
    expert index * T_sh`` ([R, T_sh]; None without an expert axis). The
    activations arrive replicated over the axis, which acts as extra
    token parallelism: each rank routes its own shard."""
    e = _expert_size(ax)
    if T % e:
        raise ValueError(f"{kind} needs local tokens ({T}) divisible by "
                         f"the expert axis ({e})")
    if e == 1:
        return T, None
    t_sh = T // e
    return t_sh, (axis_index(ax.expert)[:, None] * t_sh
                  + torch.arange(t_sh, device=device))


def _shard_rows(ts, shard, ax):
    """Each rank's token shard of the router's outputs ``ts`` (values every
    expert rank holds alike), entering the expert-varying branch."""
    return (_take_rows(enter_branch(t, ax.expert), shard) for t in ts)


def _unshard(y_sh, shard, T: int, ax):
    """Each rank's shard outputs back in a zero [R, T, d] and summed over
    the expert axis (the JAX ``psum``): every rank holds every token's
    output again."""
    if shard is None:
        return y_sh
    full = y_sh.new_zeros(y_sh.shape[0], T, y_sh.shape[-1]).scatter(
        1, shard[..., None].expand(-1, -1, y_sh.shape[-1]), y_sh)
    return leave_branch(full, ax.expert)


def _moe_capacity(bp, x, cfg: TransformerConfig, ax: Optional["_Axes"]):
    """Capacity-factor top-k dispatch (the JAX ``_moe_capacity``): each
    rank routes its token shard, each (token, choice) routing takes one
    slot of its expert's queue of ``C = max(ceil(factor * T_sh * k / E),
    1)``, the overflow drops to the residual, the experts run on the
    queues (:func:`_expert_ffn`) and the outputs come back weighted by
    the top-k router weights. Returns ``(y [R, T, D], (f, P, z))``."""
    dt = _compute_dtype(cfg)
    h, logits, probs = _router(bp, x)
    R, T, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    t_sh, shard = _token_shard(ax, T, "capacity MoE dispatch", x.device)
    if shard is not None:
        h, logits, probs = _shard_rows((h, logits, probs), shard, ax)
    wts, experts = _route_top_k(probs, k)                 # [R, T_sh, k]
    C = max(int(math.ceil(cfg.moe_capacity_factor * t_sh * k / E)), 1)
    if cfg.moe_dispatch == "sort":
        engine = _sorted_capacity_queues
    elif cfg.moe_dispatch == "scatter":
        engine = _scatter_capacity_queues
    else:
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    # the queue chain runs in the compute dtype: its rows are the
    # expert products' inputs
    disp, combine = engine(h.to(dt).repeat_interleave(k, dim=1),
                           experts.reshape(R, t_sh * k),
                           wts.reshape(R, t_sh * k), E, C, dt)
    y = combine(_expert_ffn(bp, disp, cfg, ax))
    y = y.view(R, t_sh, k, d).sum(dim=2)                  # the k choices
    axes = (ax.data, ax.seq, ax.expert) if ax is not None else ()
    f = P = x.new_zeros(R, E)
    if cfg.moe_aux_weight > 0:
        # the aux counts the first choice (Switch) for any k
        f, P = _router_stats(probs, experts[..., 0], E, axes)
    z = _z_stat(logits, axes) if cfg.moe_zloss_weight > 0 else x.new_zeros(R)
    return _unshard(y, shard, T, ax), (f, P, z)


def _moe_expert_choice(bp, x, cfg: TransformerConfig,
                       ax: Optional["_Axes"]):
    """Expert-choice routing (the JAX ``_moe_expert_choice``): within each
    rank's token shard, each expert picks its top ``C = max(ceil(factor
    * T_sh / E), 1)`` tokens by router probability; the combine weight is
    the probability of the pick, and a token may be served by several
    experts or none. Balanced by construction: the aux statistics stay
    zero."""
    dt = _compute_dtype(cfg)
    h, logits, probs = _router(bp, x)
    R, T, d = x.shape
    E = cfg.n_experts
    t_sh, shard = _token_shard(ax, T, "expert-choice MoE", x.device)
    if shard is not None:
        h, logits, probs = _shard_rows((h, logits, probs), shard, ax)
    C = max(int(math.ceil(cfg.moe_capacity_factor * t_sh / E)), 1)
    wts, idx = torch.topk(probs.transpose(1, 2), min(C, t_sh), dim=-1)
    n = idx.shape[-1]                                     # [R, E, n]
    disp = _take_rows(h, idx.reshape(R, E * n)).view(R, E, n, d).to(dt)
    y = _expert_ffn(bp, disp, cfg, ax) * wts[..., None]
    y = h.new_zeros(R, t_sh, d).scatter_add(
        1, idx.reshape(R, E * n, 1).expand(-1, -1, d), y.reshape(R, E * n, d))
    axes = (ax.data, ax.seq, ax.expert) if ax is not None else ()
    z = _z_stat(logits, axes) if cfg.moe_zloss_weight > 0 else x.new_zeros(R)
    zeros = x.new_zeros(R, E)
    return _unshard(y, shard, T, ax), (zeros, zeros, z)


def _moe(bp, x, cfg: TransformerConfig, ax: Optional["_Axes"]):
    """One MoE block over each hosted rank's tokens ``x`` [R, T, D] (the
    JAX ``_moe``) -> ``(y, (f, P, z))``: the expert-choice router, the
    capacity dispatch (``moe_capacity_factor > 0``) or dense dispatch
    (every local expert on every token, summed over the expert axis)."""
    if cfg.moe_router == "expert_choice":
        if cfg.moe_capacity_factor <= 0:
            raise ValueError("moe_router='expert_choice' needs "
                             "moe_capacity_factor > 0 (defines C)")
        return _moe_expert_choice(bp, x, cfg, ax)
    if cfg.moe_router != "token":
        raise ValueError(f"unknown moe_router {cfg.moe_router!r}")
    if cfg.moe_capacity_factor > 0:
        return _moe_capacity(bp, x, cfg, ax)
    # the router stays f32; the expert products run in the compute dtype
    h, logits, probs = _router(bp, x)
    R, E, e = x.shape[0], cfg.n_experts, _expert_size(ax)
    # each expert rank runs its own experts on every token: what feeds
    # them enters the expert-varying branch (the statistics below do not)
    hv, pv = ((enter_branch(h, ax.expert), enter_branch(probs, ax.expert))
              if e > 1 else (h, probs))
    y, experts = _moe_dense(bp, hv, pv, cfg.moe_top_k, _compute_dtype(cfg),
                            ax)
    # tokens are replicated over the expert axis here: only the data and
    # seq axes hold distinct ones
    axes = (ax.data, ax.seq) if ax is not None else ()
    f = P = x.new_zeros(R, E)
    if cfg.moe_aux_weight > 0:
        f, P = _router_stats(probs, experts[..., 0], E, axes)
    z = _z_stat(logits, axes) if cfg.moe_zloss_weight > 0 else x.new_zeros(R)
    if e > 1:
        y = leave_branch(y, ax.expert)
    return y, (f, P, z)


def _stage_blocks(params: Params, cfg: TransformerConfig,
                  ax: Optional[_Axes]) -> List[Dict[str, torch.Tensor]]:
    """The blocks each hosted rank runs, a dict of leaves a block: this
    process's one stage (the leading stage dim indexed away) where every
    rank runs the same one — no pipe axis, or a pipe axis wholly across
    processes, whose pipe-sharded leaves arrive [1, ...] — else, over a
    pipe axis with a hosted part, each leaf [R, ...] with each rank's
    stage among the process's (the stage stack itself where the ranks
    are the stages in order)."""
    if ax is None or ax.pipe is None or ax.pipe.size == 1 \
            or ax.pipe.hosted_size == 1:
        return [{k: v[0] for k, v in bp.items()} for bp in params["blocks"]]
    first = ax.pipe.across_index() * ax.pipe.hosted_size
    stages = [ax.mesh.coords(r)[ax.pipe.pos] - first for r in ax.mesh.ranks]
    if stages == list(range(ax.pipe.hosted_size)):
        return [dict(bp) for bp in params["blocks"]]
    idx = torch.tensor(stages, device=ax.mesh.device)
    return [{k: v[idx] for k, v in bp.items()} for bp in params["blocks"]]


def local_loss(params: Params, tokens, labels, mask,
               cfg: TransformerConfig, ax: Optional[_Axes] = None
               ) -> torch.Tensor:
    """Mean CE over the unmasked tokens (the JAX ``local_loss``), plus the
    MoE aux and z-loss terms where their weights are on.

    Without ``ax`` (one device, no mesh): ``tokens``/``labels`` [B, S]
    int32, ``mask`` [B, S] f32. With ``ax`` (:func:`build_spmd_train_step`):
    each of the hosted ranks' blocks, [n_hosted, B_local, S_local], at
    global positions ``seq index * S_local + arange``, the attention
    around the ring of ``ax.seq`` where there is one; the loss is summed
    over every rank's tokens and divided by their psum'd count, valued as
    the whole mesh's loss on every process. The JAX loss is psum'd over
    the pipe, data and seq axes only: the ranks of a model or expert axis
    hold the same tokens, so each token's CE counts once across them
    (hosted, the expert ranks' CE is divided by their number; the model
    ranks fold into the branches and compute it once).

    The GPipe schedule (JAX's): ``microbatches + n_stages - 1`` ticks;
    the first pipe rank takes the embedding of microbatch ``t`` at tick
    ``t``, every rank runs its stage's blocks, the state moves one rank
    along ``pipe`` each tick (:func:`~mmlspark_tpu_torch.parallel.
    collectives.ring_permute`), and the last rank collects the outputs
    once the fill is done. Only the last stage's CE counts; the routing
    statistics count only on ticks where real data flows through a rank,
    are summed over the microbatches and divided by their number before
    the aux's product, and the aux and z-loss are summed over the
    stages. Without a pipe axis the ticks are the microbatches."""
    _check_train_config(cfg, ax)
    if ax is None:
        tokens, labels, mask = tokens[None], labels[None], mask[None]
    r, b, s = tokens.shape
    m = cfg.microbatches
    if b % m:
        raise ValueError(f"local batch {b} not divisible by microbatches "
                         f"{m}")
    mb = b // m
    dev, d = tokens.device, cfg.d_model
    ring = ax is not None and ax.seq is not None
    tp = ax.tp if ax is not None else 1
    impl = None if ring else attention_engine(cfg, s, dev,
                                              heads=cfg.n_heads // tp)
    blocks = _stage_blocks(params, cfg, ax)
    pos = torch.arange(s, device=dev)
    if ring:
        # global positions, one row per (rank, microbatch row)
        pos = (axis_index(ax.seq)[:, None] * s + pos).repeat_interleave(
            mb, dim=0)
    pipe = ax.pipe if ax is not None and ax.pipe is not None \
        and ax.pipe.size > 1 else None
    p = pipe.size if pipe is not None else 1
    p_rank = axis_index(pipe) if pipe is not None else None
    outs, acc = [], None
    state = tokens.new_zeros((r * mb, s, d), dtype=torch.float32)
    for t, tok in enumerate(tokens.split(mb, dim=1) + (None,) * (p - 1)):
        if tok is not None:
            inp = params["embed"][tok.reshape(r * mb, s)]
            state = inp if pipe is None else torch.where(
                (p_rank == 0).view(r, 1, 1, 1), inp.view(r, mb, s, d),
                state.view(r, mb, s, d)).view(r * mb, s, d)
        state, stats = _stage(blocks, state, cfg, pos, impl, ax)
        if stats is not None:
            if pipe is not None:
                # fill and drain ticks carry garbage through a rank
                real = ((p_rank <= t) & (t < p_rank + m)).to(torch.float32)
                stats = tuple(st * real.view(r, *(1,) * (st.dim() - 1))
                              for st in stats)
            acc = stats if acc is None else tuple(
                a + st for a, st in zip(acc, stats))
        if t >= p - 1:
            outs.append(state.view(r, mb, s, d))
        if pipe is not None and t < m + p - 2:
            state = ring_permute(state.view(r, mb, s, d), pipe).view(
                r * mb, s, d)
    x = torch.cat(outs, dim=1)
    mask = mask.reshape(r, b * s)
    if ax is not None:
        count = _psum_if(_psum_if(mask.sum(dim=1), ax.data), ax.seq)
    labels = labels.reshape(r, b * s)
    last = None
    if pipe is not None:
        # only the last stage's outputs are real: its ranks' CE alone (a
        # process hosting none of them counts its CE at weight 0)
        last = [i for i, rk in enumerate(ax.mesh.ranks)
                if ax.mesh.coords(rk)[pipe.pos] == p - 1]
        if last and len(last) < r:
            idx = torch.tensor(last, device=dev)
            x, labels, mask, count = x[idx], labels[idx], mask[idx], \
                count[idx]
    n = x.shape[0]
    h = _rmsnorm(x, params["final_norm"]).reshape(n * b * s, d)
    # the engine gate counts one rank's tokens, as JAX's b_loc * s_loc
    ce = _token_ce(h, params["head"], labels.reshape(n * b * s), cfg,
                   train_ce_engine(cfg, b * s, dev)).view(n, b * s)
    if ax is None:
        loss = (ce * mask).sum() / mask.sum().clamp(min=1.0)
    else:
        part = ((ce * mask).sum(dim=1) / count.clamp(min=1.0)).sum()
        if last == []:
            part = part * 0.0
        # the hosted expert ranks hold the same tokens: their CE counts
        # once; the parts across processes are summed
        hosted_e = ax.expert.hosted_size if ax.expert is not None else 1
        loss = _valued_sum(part / hosted_e, (pipe, ax.data, ax.seq))
    if acc is not None:
        f, P, z = acc
        extra = x.new_zeros(r)
        if cfg.moe_aux_weight > 0:
            aux = cfg.n_experts * ((f / m) * (P / m)).sum(dim=(1, 2))
            extra = extra + cfg.moe_aux_weight * aux
        if cfg.moe_zloss_weight > 0:
            extra = extra + cfg.moe_zloss_weight * (z / m).sum(dim=1)
        if ax is None:
            loss = loss + extra.sum()
        else:
            # every hosted rank of a stage holds the same pmean'd totals:
            # one copy a hosted stage, the stages across processes summed
            hosted_p = pipe.hosted_size if pipe is not None else 1
            loss = loss + _valued_sum(extra.sum() * hosted_p / r, (pipe,))
    return loss


def reference_loss(params: Params, tokens, labels, mask,
                   cfg: TransformerConfig, ec_groups: int = 1
                   ) -> torch.Tensor:
    """The JAX ``reference_loss``: the unsharded f32 forward
    (:func:`_reference_forward`), mean CE over the unmasked tokens, plus
    the weighted aux and z-loss totals. ``ec_groups``: for expert-choice
    routing, the number of token groups the SPMD step shards the tokens
    into (expert choice is group-wise)."""
    logits, aux, z = _reference_forward(params, tokens, cfg, ec_groups)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - gold
    loss = (ce * mask).sum() / mask.sum().clamp(min=1.0)
    return loss + cfg.moe_aux_weight * aux + cfg.moe_zloss_weight * z


def _leaves(tree: Params) -> List[torch.Tensor]:
    """The tree's tensors in a fixed order (embed, head, final_norm, then
    every block's keys)."""
    out = [tree["embed"], tree["head"], tree["final_norm"]]
    for bp in tree["blocks"]:
        out.extend(bp[k] for k in _block_keys(bp))
    return out


def init_velocity(params: Params) -> Params:
    """Zeros shaped like ``params``: the momentum buffers."""
    return {"embed": torch.zeros_like(params["embed"]),
            "head": torch.zeros_like(params["head"]),
            "final_norm": torch.zeros_like(params["final_norm"]),
            "blocks": [{k: torch.zeros_like(v) for k, v in bp.items()}
                       for bp in params["blocks"]]}


def params_to_numpy(params: Params, cfg: Optional[TransformerConfig] = None,
                    mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The tree with every leaf as a numpy array (host copies), in the
    ``init_params`` layout, for leaf-by-leaf comparison with JAX. With
    ``cfg`` and a ``mesh`` spread over processes, each sharded leaf is
    first gathered from every process's block (:func:`param_specs`), so
    every process gets the whole tree."""
    if mesh is not None and not mesh.hosted:
        specs = param_specs(cfg, mesh)
        params = {**{k: params[k] for k in ("embed", "head", "final_norm")},
                  "blocks": [{k: _gather_leaf(v, sp[k], mesh)
                              for k, v in bp.items()}
                             for bp, sp in zip(params["blocks"],
                                               specs["blocks"])]}

    def np_(t):
        return t.detach().to("cpu", copy=True).numpy()
    return {"embed": np_(params["embed"]), "head": np_(params["head"]),
            "final_norm": np_(params["final_norm"]),
            "blocks": [{k: np_(v) for k, v in bp.items()}
                       for bp in params["blocks"]]}


def _sharded_dims(spec, mesh: Mesh):
    """``(dim, axis)`` of each dimension ``spec`` splits over an axis of
    ``mesh`` with a part across processes."""
    return [(i, mesh.axis(a)) for i, a in enumerate(spec)
            if a is not None and mesh.across_shape.get(a, 1) > 1]


def _cut_leaf(x, spec, mesh: Mesh):
    """This process's block of a whole leaf ``x`` (numpy or tensor): along
    each dimension ``spec`` splits over an axis with a part across
    processes, the block at the process's coordinate on that part (its
    hosted ranks share the block and each reads its slice)."""
    for dim, axis in _sharded_dims(spec, mesh):
        n = x.shape[dim] // axis.across_size
        c = axis.across_index()
        x = x[(slice(None),) * dim + (slice(c * n, (c + 1) * n),)]
    return x.contiguous() if isinstance(x, torch.Tensor) else x


def _gather_leaf(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every process's block ``t`` (all_gather over
    the across part of each axis ``spec`` names, in the axis's order)."""
    t = t.detach()
    for dim, axis in _sharded_dims(spec, mesh):
        t = torch.cat(all_gather(t, axis.group), dim=dim)
    return t


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
# training over a mesh


def param_specs(cfg: TransformerConfig, mesh: Mesh) -> Dict[str, Any]:
    """The JAX ``param_specs`` tree: each leaf's mesh axis per dimension
    (a tuple of axis names, ``None`` = replicated; an axis the mesh lacks
    is ``None``): every block leaf's stage dim over ``pipe``, the heads
    of ``wq/wk/wv/wo`` and the hidden units of ``w1/b1/w2`` over
    ``model``, the experts' ``ew1``/``ew2`` over ``expert``. One rank per
    process, each process holds just its shard of every leaf
    (:func:`shard_params`); the hosted ranks share one tensor a leaf and
    each reads its slice (a mixed mesh: each process holds its block over
    the axes' parts across processes, shared by its hosted ranks)."""
    _validate_mesh_config(cfg, mesh)

    def ax(a):
        return a if a in mesh.shape else None

    pipe, model, expert = ax(AXIS_PIPE), ax(AXIS_MODEL), ax(AXIS_EXPERT)
    block = {"ln1": (pipe,), "ln2": (pipe,),
             "wq": (pipe, None, model, None), "wk": (pipe, None, model, None),
             "wv": (pipe, None, model, None), "wo": (pipe, model, None, None)}
    if cfg.n_experts:
        block.update(router=(pipe, None, None),
                     ew1=(pipe, expert, None, None),
                     ew2=(pipe, expert, None, None))
    else:
        block.update(w1=(pipe, None, model), b1=(pipe, model),
                     w2=(pipe, model, None), b2=(pipe, None))
    return {"embed": (), "head": (), "final_norm": (),
            "blocks": [dict(block) for _ in range(cfg.layers_per_stage)]}


def _validate_mesh_config(cfg: TransformerConfig, mesh: Mesh) -> _Axes:
    """The JAX build-time checks: every mesh/config mismatch fails at
    build."""
    ax = _Axes.of(mesh)
    n_pipe, n_model = mesh.shape.get(AXIS_PIPE), mesh.shape.get(AXIS_MODEL)
    if n_pipe is not None and n_pipe != cfg.n_stages:
        raise ValueError(f"n_stages={cfg.n_stages} != pipe axis size "
                         f"{n_pipe}")
    if n_pipe is None and cfg.n_stages != 1:
        raise ValueError("n_stages > 1 requires a 'pipe' mesh axis")
    if n_model is not None and cfg.n_heads % n_model:
        raise ValueError("n_heads must divide over the model axis")
    if n_model is not None and cfg.d_ff % n_model:
        raise ValueError("d_ff must divide over the model axis")
    if (ax.expert is not None and cfg.n_experts
            and cfg.n_experts % ax.expert.size):
        raise ValueError("n_experts must divide over the expert axis")
    if cfg.n_experts and not 1 <= cfg.moe_top_k <= cfg.n_experts:
        raise ValueError(
            f"moe_top_k={cfg.moe_top_k} must be in [1, n_experts="
            f"{cfg.n_experts}]")
    return ax


def shard_params(params, cfg: TransformerConfig, mesh: Mesh) -> Params:
    """The JAX ``shard_params``: the tree (numpy leaves, as the JAX
    ``init_params`` gives them, or tensors) as f32 tensors on the mesh's
    device. Hosted, one set of whole tensors that every rank shares (each
    reads its slice); one rank per process, each process holds only its
    shards (:func:`param_specs`): its stage's slice of every block leaf,
    its heads of ``wq/wk/wv/wo``, its ``d_ff`` slice of ``w1/b1/w2`` and
    its experts' slice of ``ew1``/``ew2``."""
    _validate_mesh_config(cfg, mesh)
    if mesh.hosted:
        return params_from_jax(params, mesh.device)
    # each process's block; its hosted ranks share it
    specs = param_specs(cfg, mesh)
    cut = {**{k: params[k] for k in ("embed", "head", "final_norm")},
           "blocks": [{k: _cut_leaf(v, sp[k], mesh) for k, v in bp.items()}
                      for bp, sp in zip(params["blocks"], specs["blocks"])]}
    return params_from_jax(cut, mesh.device)


# ---------------------------------------------------------------------------
# the pjit formulation: one autograd program over the global batch
#
# The shard_map step above writes every rank's program and its
# collectives; this one writes none (the JAX ``build_pjit_train_step``):
# the same math over the global batch on the mesh's device, the pipe's
# stages a plain loop, attention the dense engine. Capacity-factor MoE is
# the one place where the grouping is semantic: the shard_map step sizes
# its capacity and drops the overflow within each rank's token shard, so
# this step routes the same rank-shaped groups (``_token_groups``) and
# the two formulations drop the same tokens.


def _token_groups(h, D: int, Q: int):
    """Global ``[B, S, ...]`` -> the ranks' token blocks ``[D * Q,
    T_local, ...]`` in the shard_map step's order: the batch over
    ``data``, the sequence over ``seq``, rows batch-major within a
    rank."""
    B, S = h.shape[0], h.shape[1]
    rest = h.shape[2:]
    g = h.reshape(D, B // D, Q, S // Q, *rest).movedim(2, 1)
    return g.reshape(D * Q, (B // D) * (S // Q), *rest)


def _ungroup_tokens(g, D: int, Q: int, B: int, S: int):
    """Inverse of :func:`_token_groups`."""
    rest = g.shape[2:]
    g = g.reshape(D, Q, B // D, S // Q, *rest).movedim(1, 2)
    return g.reshape(B, S, *rest)


def _pjit_moe(bp, x, cfg: TransformerConfig, D: int, Q: int, E_ax: int):
    """One MoE block over the global ``x`` [B, S, d] (the JAX
    ``_pjit_moe``) -> ``(y, (f, P, z))``, the routing statistics as
    global means. The capacity and expert-choice routers run
    :func:`_moe` over the ``D * Q * E_ax`` rank-shaped groups of tokens
    (each rank's tokens, each expert rank's shard of them), so each
    group builds its own queues and drops its own overflow as the
    shard_map step's ranks do (the JAX ``_pjit_moe_grouped`` and
    ``_pjit_moe_expert_choice``); dense dispatch (the JAX
    ``_pjit_moe_dense``) runs over the global tokens as one group. The
    statistics are token-linear, so the mean of the equal groups' means
    is the global mean."""
    B, S, d = x.shape
    T = B * S
    if cfg.moe_capacity_factor > 0 or cfg.moe_router == "expert_choice":
        n_rank = D * Q
        if T % n_rank:
            raise ValueError(f"tokens ({T}) must divide over data x seq "
                             f"({n_rank})")
        T_local = T // n_rank
        if T_local % E_ax:
            kind = ("expert-choice MoE" if cfg.moe_router == "expert_choice"
                    else "capacity MoE dispatch")
            raise ValueError(f"{kind} needs local tokens ({T_local}) "
                             f"divisible by the expert axis ({E_ax})")
        xg = _token_groups(x, D, Q).reshape(n_rank * E_ax, T_local // E_ax,
                                            d)
        y, (f, P, z) = _moe(bp, xg, cfg, None)
        y = _ungroup_tokens(y.reshape(n_rank, T_local, d), D, Q, B, S)
    else:
        y, (f, P, z) = _moe(bp, x.reshape(1, T, d), cfg, None)
        y = y.reshape(B, S, d)
    return y, (f.mean(dim=0), P.mean(dim=0), z.mean())


def _pjit_loss(params: Params, tokens, labels, mask, cfg: TransformerConfig,
               groups: Tuple[int, int, int], ce_engine: str) -> torch.Tensor:
    """The global loss (the JAX ``_pjit_loss``): ``local_loss``'s math
    over the global batch [B, S], the stages a plain loop over the
    blocks' stage dim (the GPipe schedule is a speed schedule, not a
    semantic one), attention the dense engine, the CE through
    ``ce_engine``, the MoE blocks group-faithful (:func:`_pjit_moe`)."""
    D, Q, E_ax = groups
    B, S = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(S, device=tokens.device)
    aux_total = z_total = x.new_zeros(())
    for st in range(cfg.n_stages):
        for bp_all in params["blocks"]:
            bp = {k: v[st] for k, v in bp_all.items()}
            x = x + _attention(bp, x, cfg, pos, "dense")
            if cfg.n_experts:
                y, (f, P, z) = _pjit_moe(bp, x, cfg, D, Q, E_ax)
                x = x + y
                aux_total = aux_total + cfg.n_experts * torch.sum(f * P)
                z_total = z_total + z
            else:
                x = x + _mlp(bp, x, cfg)
    h = _rmsnorm(x, params["final_norm"]).reshape(B * S, cfg.d_model)
    ce = _token_ce(h, params["head"], labels.reshape(B * S), cfg,
                   ce_engine).view(B, S)
    loss = (ce * mask).sum() / mask.sum().clamp(min=1.0)
    if cfg.n_experts and cfg.moe_aux_weight > 0:
        loss = loss + cfg.moe_aux_weight * aux_total
    if cfg.n_experts and cfg.moe_zloss_weight > 0:
        loss = loss + cfg.moe_zloss_weight * z_total
    return loss


def build_pjit_train_step(cfg: TransformerConfig, mesh: Mesh,
                          learning_rate: float = 0.1,
                          momentum: float = 0.9) -> Callable:
    """The train step as one autograd program over the global batch (the
    JAX ``build_pjit_train_step``): the signature, the state layout
    (:func:`shard_params`' hosted tensors) and the math of the shard_map
    formulation, with no collective written by hand. The global batch's
    rows are padded to the data axis with mask 0, as the shard_map step
    pads them, and the update is momentum SGD in place.

    Attention is the dense engine, and ``ce_impl="auto"`` the dense CE.
    An explicit ``ce_impl="cuda"`` runs K4's training variant and K6 once
    over the global batch's ``[B * S, d]`` whatever the mesh's size:
    every hosted rank lives on the mesh's one device, so the loss is one
    program there (JAX falls back to its dense CE on several ranks
    because its kernel runs per device).

    Over processes (one rank per process or mixed) the global program
    is split by the mesh as the shard_map step splits it, by the same
    :func:`param_specs`: each process runs its ranks' part of it with
    this formulation's choices (the dense attention engine, the CE
    engine above), and each leaf's gradient is summed over the axes
    that hold copies of it (:func:`build_spmd_train_step`)."""
    ax = _validate_mesh_config(cfg, mesh)
    _check_train_config(cfg, ax)
    engine = "dense" if cfg.ce_impl == "auto" else cfg.ce_impl
    if engine not in CE_IMPLS:
        raise ValueError(f"unknown ce_impl {cfg.ce_impl!r} (auto or one of "
                         f"{CE_IMPLS})")
    if not mesh.hosted:
        return build_spmd_train_step(
            dataclasses.replace(cfg, attention_impl="dense",
                                ce_impl=engine),
            mesh, learning_rate, momentum, impl="shard_map")
    groups = (mesh.shape.get(AXIS_DATA, 1), mesh.shape.get(AXIS_SEQ, 1),
              mesh.shape.get(AXIS_EXPERT, 1))
    lr, mom = float(learning_rate), float(momentum)
    n_data = groups[0]

    def step(params, velocity, tokens, labels, mask):
        for name, t in (("params", params["embed"]),
                        ("velocity", velocity["embed"])):
            if t.device != mesh.device:
                raise ValueError(f"{name} is on {t.device}, the mesh on "
                                 f"{mesh.device}")
        batch = [torch.as_tensor(t).to(mesh.device)
                 for t in (tokens, labels, mask)]
        extra = -batch[0].shape[0] % n_data
        if extra:
            batch = [torch.cat([t, t.new_zeros((extra, *t.shape[1:]))])
                     for t in batch]
        return _momentum_step(
            params, velocity,
            lambda: _pjit_loss(params, *batch, cfg, groups, engine),
            lr, mom)

    return step


def build_spmd_train_step(cfg: TransformerConfig, mesh: Mesh,
                          learning_rate: float = 0.1,
                          momentum: float = 0.9,
                          impl: str = "auto") -> Callable:
    """``step(params, velocity, tokens, labels, mask) -> (params,
    velocity, loss)`` over ``mesh`` (the JAX ``build_spmd_train_step`` in
    its ``shard_map`` formulation, which ``impl="auto"`` and
    ``"shard_map"`` take): the global batch ([B, S], the same on every
    process) split into each rank's (data, seq) block, replicated over
    the model, expert and pipe axes
    (:func:`~mmlspark_tpu_torch.parallel.sharding.shard_batch`: rows
    padded with mask 0 to the data axis), :func:`local_loss` with the
    mesh's axes, autograd backward, then momentum SGD in place as
    :func:`build_train_step` does it.

    Hosted ranks share one set of parameter tensors, so autograd sums
    their gradients. Across processes (one rank per process, or the
    mixed form's processes of hosted ranks), each leaf's gradient is
    summed over the parts across processes of the axes that hold copies
    of it: ``data`` and ``seq`` for every leaf, and ``pipe`` for
    ``embed``/``head``/``final_norm`` (the block leaves are the stage's
    own). Not over ``model`` or ``expert``: their branches sum their
    input's gradient themselves
    (:func:`~mmlspark_tpu_torch.parallel.collectives.enter_branch`), so
    every rank's gradient of a replicated leaf is already whole.
    ``impl="pjit"`` builds the global formulation instead
    (:func:`build_pjit_train_step`); ``"auto"`` resolves to shard_map,
    the port's counterpart of a VMA jax."""
    if impl not in ("auto", "shard_map", "pjit"):
        raise ValueError(f"unknown train-step impl {impl!r}")
    if impl == "pjit":
        return build_pjit_train_step(cfg, mesh, learning_rate, momentum)
    ax = _validate_mesh_config(cfg, mesh)
    _check_train_config(cfg, ax)
    lr, mom = float(learning_rate), float(momentum)
    pipe = ax.pipe if ax.pipe is not None and ax.pipe.size > 1 else None

    def reduce_group(grads, axes):
        axes = _across(axes)
        if not axes:
            return list(grads)
        flat = torch.cat([g.reshape(-1) for g in grads])
        for a in axes:
            flat = all_reduce(flat, a.group)
        return [f.view(g.shape) for f, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def reduce_grads(grads):
        # _leaves order: embed, head, final_norm, then the block leaves
        return (reduce_group(grads[:3], (ax.data, ax.seq, pipe))
                + reduce_group(grads[3:], (ax.data, ax.seq)))

    def step(params, velocity, tokens, labels, mask):
        for name, t in (("params", params["embed"]),
                        ("velocity", velocity["embed"])):
            if t.device != mesh.device:
                raise ValueError(f"{name} is on {t.device}, the mesh on "
                                 f"{mesh.device}")
        local, _ = shard_batch({"tokens": tokens, "labels": labels,
                                "mask": mask}, ax.mesh)
        return _momentum_step(
            params, velocity,
            lambda: local_loss(params, local["tokens"], local["labels"],
                               local["mask"], cfg, ax),
            lr, mom, None if mesh.hosted else reduce_grads)

    return step


# ---------------------------------------------------------------------------
# checkpoint / resume


def _param_template(cfg: TransformerConfig) -> Params:
    """The ``init_params`` tree's global shapes as f32 meta tensors: a
    restore's template, which allocates nothing."""
    s, d, h, dh, f = (cfg.n_stages, cfg.d_model, cfg.n_heads, cfg.d_head,
                      cfg.d_ff)
    e = cfg.n_experts

    def leaf(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    block = {"ln1": (s, d), "wq": (s, d, h, dh), "wk": (s, d, h, dh),
             "wv": (s, d, h, dh), "wo": (s, h, dh, d), "ln2": (s, d)}
    if e:
        block.update(router=(s, d, e), ew1=(s, e, d, f), ew2=(s, e, f, d))
    else:
        block.update(w1=(s, d, f), b1=(s, f), w2=(s, f, d), b2=(s, d))
    return {"embed": leaf(cfg.vocab, d), "head": leaf(d, cfg.vocab),
            "final_norm": leaf(d),
            "blocks": [{k: leaf(*v) for k, v in block.items()}
                       for _ in range(cfg.layers_per_stage)]}


def save_train_state(path: str, params: Params, velocity: Params, step: int,
                     max_to_keep: int = 3,
                     cfg: Optional[TransformerConfig] = None,
                     mesh: Optional[Mesh] = None) -> None:
    """Checkpoint the training state (params + velocity) at ``step`` (the
    JAX ``save_train_state``) in the native sharded store
    (:mod:`mmlspark_tpu_torch.io.checkpoint`): the format is layout
    independent, so a resume may use another mesh than the run that
    saved it, and the digest manifest written last keeps every step
    flip-eligible for the rollout plane. With ``cfg`` and ``mesh`` each
    leaf is written as :func:`param_specs` lays it out — one file per
    model/pipe/expert slice, as JAX writes the same state; one rank per
    process (where they are required) each process writes the slices it
    owns, cooperatively into one directory."""
    from mmlspark_tpu_torch.io import checkpoint as _ckpt
    specs = None
    if mesh is not None:
        if cfg is None:
            raise ValueError("save_train_state over a mesh needs cfg (its "
                             "param_specs lay the leaves out)")
        specs = param_specs(cfg, mesh)
    mngr = _ckpt.manager(path, max_to_keep)
    mngr.save(step, {"params": params, "velocity": velocity},
              specs={"params": specs, "velocity": specs}, mesh=mesh)
    mngr.wait_until_finished()
    mngr.close()


def restore_train_state(path: str, cfg: TransformerConfig,
                        mesh: Optional[Mesh] = None,
                        step: Optional[int] = None,
                        device: DeviceLike = None):
    """Restore ``(params, velocity, step)`` directly onto ``mesh``'s
    layout (the JAX ``restore_train_state``): a hosted mesh's whole
    tensors on its device (:func:`shard_params`' hosted layout), one
    rank per process this process's block of each leaf by
    :func:`param_specs` — each assembled from only the saved files that
    overlap it, so a state saved on one mesh resumes on another.
    ``mesh=None`` restores onto ``device`` (``None``: the card, raising
    without CUDA). ``step=None`` restores the latest checkpoint."""
    from mmlspark_tpu_torch.io import checkpoint as _ckpt
    from mmlspark_tpu_torch.io import fs as _fs
    if not _fs.exists(path):
        raise FileNotFoundError(f"no checkpoint under {path!r}")
    mngr = _ckpt.manager(path, create=False)
    target = step if step is not None else mngr.latest_step()
    if target is None:
        raise FileNotFoundError(f"no checkpoint under {path!r}")
    template = _param_template(cfg)
    specs = param_specs(cfg, mesh) if mesh is not None else None
    restored = mngr.restore(
        target, {"params": template, "velocity": template},
        specs={"params": specs, "velocity": specs}, mesh=mesh,
        device=None if mesh is not None else resolve_device(device))
    mngr.close()
    return restored["params"], restored["velocity"], target


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
