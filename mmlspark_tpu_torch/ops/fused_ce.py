"""Fused softmax cross-entropy over a linear vocabulary head.

The port of ``mmlspark_tpu/ops/fused_ce.py``: per token, ``ce =
lse(h @ w) - (h @ w)[label]`` without writing ``d_logits`` to device
memory. On the card the forward is the hand-written Hopper kernel
``csrc/fused_ce_forward.cu`` (K4: vocab slices spread over the blocks,
per-slice partial softmax states, and a second small launch that merges
them per token) and the backward is ``csrc/fused_ce_backward.cu`` (K6:
``dh`` and ``dW`` rebuilt tile by tile from the stored logits). Both
dispatch on the dtype, and both run on the tensor cores: bf16 on
``wgmma`` (tiles copied by TMA), f32 in 3xTF32 on ``mma.sync`` (each f32
operand split into two tf32 parts, three products summed: f32 accuracy).
The f32 forward picks its kernel by T: up to 64 tokens (the speculative
verify) a kernel that streams W once at the byte rate, past that one
bound by its operations.

:func:`fused_softmax_xent` takes the JAX function's layout: ``h``
(T, D), ``w`` (D, V) (the LM ``head`` as stored), ``labels`` (T,)
int32, and ``compute_dtype`` (default ``h``'s; f32 or bf16), the dtype
of the products' inputs and of the stored logits; it returns (T,) f32.
The gold logit is the SUM of the logits whose column equals the label —
the JAX kernel's in-tile ``iota == label`` mask — so a label that
matches no column gives gold 0 and ``ce = lse``, and adds no one-hot to
the backward. The JAX kernel pads V to its tile and holds -1e30 in the
pad columns, so there a label in ``[V, V_pad)`` meets a -1e30 logit in
the forward; the port has no pad columns and gives 0 for every label
outside ``[0, V)``. (Its backward agrees with JAX's for every label:
the pad column's one-hot meets a zero column of the padded ``w``.)

It is differentiable in ``h`` and ``w``, as the JAX ``custom_vjp`` is.
When grad is enabled and ``h`` or ``w`` requires it, the forward also
stores the logits in the compute dtype and the f32 lse (K4's training
variant, counted as ``fused_softmax_xent_train``) and the backward
launches K6 ``dh`` and ``dW``, which come out in the compute dtype and
flow back through the dtype cast as in JAX. Otherwise — the speculative
verify's scoring under ``no_grad`` — nothing is stored and the launch
counts as ``fused_softmax_xent``.

The wrappers check dtype, shape, device and contiguity and raise on
anything else. They run the ``*_plain`` versions only when handed CPU
tensors; for CUDA tensors they launch the kernel or raise — there is no
fallback. :data:`LAUNCHES` counts one per kernel call.
"""

from __future__ import annotations

from typing import Dict

import torch

from mmlspark_tpu_torch.native.launch import (
    DTYPE_CODES, I, P, check, device_of, launch,
)

#: kernel calls per wrapper (plain-version calls never count)
LAUNCHES: Dict[str, int] = {"fused_softmax_xent": 0,
                            "fused_softmax_xent_train": 0,
                            "fused_ce_dh": 0, "fused_ce_dw": 0}

#: vocab columns per block of the forward kernel (``kCols`` in the
#: source; the launcher refuses a partials buffer sized for any other
#: value)
VOCAB_SLICE = 128

#: the JAX kernel's token tile: its auto gate keeps ``T >= T_TILE``
T_TILE = 512

_FWD = ("mmt_fused_softmax_xent_fwd", [P] * 7 + [I] * 5)
_DH = ("mmt_fused_ce_dh", [P] * 6 + [I] * 4)
_DW = ("mmt_fused_ce_dw", [P] * 6 + [I] * 4)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_ce_available(n_tokens: int) -> bool:
    """The JAX auto gate (``fused_ce_available``) as it applies here: at
    least one JAX token tile of tokens. Its lane alignment, VMEM budget
    and backend test are TPU constraints and are dropped; the caller
    decides the device."""
    return n_tokens >= T_TILE


def _forward_plain(h, w, labels):
    """``(ce, logits, lse)``: f32 logits of the compute-dtype inputs (f32
    accumulation), their log-sum-exp, and the gold logit as a one-hot
    masked sum (the JAX kernel's form, not a gather)."""
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    hit = _one_hot(labels, w.shape[1])
    gold = torch.where(hit, logits, torch.zeros((), device=h.device)).sum(-1)
    return lse - gold, logits, lse


def _one_hot(labels, v: int):
    cols = torch.arange(v, device=labels.device)
    return cols[None, :] == labels[:, None].to(torch.int64)


def fused_softmax_xent_plain(h, w, labels):
    """The plain version of K4: per-token CE from the f32 logits."""
    return _forward_plain(h, w, labels)[0]


def _check_forward(h, w, labels):
    dev = device_of("h", h)
    if h.dtype not in DTYPE_CODES:
        raise TypeError(f"h must be torch.float32 or torch.bfloat16 (pass "
                        f"compute_dtype to cast), got {h.dtype}")
    check("h", h, h.dtype, (None, None), dev)
    t, d = h.shape
    check("w", w, h.dtype, (d, None), dev)
    check("labels", labels, torch.int32, (t,), dev)
    v = w.shape[1]
    if d < 1 or v < 1:
        raise ValueError(f"D={d} and V={v} must be >= 1")
    return dev, t, d, v


def _forward(h, w, labels, store: bool):
    """K4 on ``h``/``w`` in their (compute) dtype: ``(ce, logits, lse)``,
    with ``logits`` (T, V) in that dtype and ``lse`` (T,) f32 only when
    ``store`` (else None)."""
    dev, t, d, v = _check_forward(h, w, labels)
    if dev.type == "cpu":
        ce, logits, lse = _forward_plain(h, w, labels)
        return (ce, logits.to(h.dtype), lse) if store else (ce, None, None)
    out = torch.empty(t, dtype=torch.float32, device=dev)
    logits = lse = None
    if store:
        logits = torch.empty(t, v, dtype=h.dtype, device=dev)
        lse = torch.empty(t, dtype=torch.float32, device=dev)
    if t == 0:
        return out, logits, lse
    n_slices = -(-v // VOCAB_SLICE)
    partials = torch.empty(3 * n_slices * t, dtype=torch.float32,
                           device=dev)
    launch(*_FWD, dev, h.data_ptr(), w.data_ptr(), labels.data_ptr(),
           partials.data_ptr(), out.data_ptr(),
           logits.data_ptr() if store else None,
           lse.data_ptr() if store else None, t, d, v, n_slices,
           DTYPE_CODES[h.dtype])
    LAUNCHES["fused_softmax_xent_train" if store else
             "fused_softmax_xent"] += 1
    return out, logits, lse


def _d_logits_plain(labels, g, logits, lse):
    """``(softmax - onehot) * g`` in f32, from the stored logits."""
    p = torch.exp(logits.float() - lse[:, None])
    return (p - _one_hot(labels, logits.shape[1]).float()) * g[:, None]


def fused_ce_dh_plain(h, w, labels, g, logits, lse):
    """The plain version of K6 dh: ``d_l`` rounded to the compute dtype,
    times ``w^T`` in f32, written in the compute dtype."""
    dl = _d_logits_plain(labels, g, logits, lse).to(w.dtype)
    return (dl.float() @ w.float().T).to(h.dtype)


def fused_ce_dw_plain(h, w, labels, g, logits, lse):
    """The plain version of K6 dW: ``h^T`` times ``d_l`` rounded to the
    compute dtype, in f32, written in the compute dtype."""
    dl = _d_logits_plain(labels, g, logits, lse).to(h.dtype)
    return (h.float().T @ dl.float()).to(w.dtype)


def _check_backward(h, w, labels, g, logits, lse):
    dev, t, d, v = _check_forward(h, w, labels)
    check("g", g, torch.float32, (t,), dev)
    check("logits", logits, h.dtype, (t, v), dev)
    check("lse", lse, torch.float32, (t,), dev)
    return dev, t, d, v


def fused_ce_dh(h, w, labels, g, logits, lse):
    """K6 dh: ``((softmax(logits) - onehot) * g) @ w^T`` -> (T, D) in the
    compute dtype. ``logits`` (T, V) and ``lse`` (T,) are the training
    forward's; ``g`` (T,) f32 is the cotangent of ``ce``."""
    dev, t, d, v = _check_backward(h, w, labels, g, logits, lse)
    if dev.type == "cpu":
        return fused_ce_dh_plain(h, w, labels, g, logits, lse)
    dh = torch.empty(t, d, dtype=h.dtype, device=dev)
    if t == 0:
        return dh
    launch(*_DH, dev, logits.data_ptr(), w.data_ptr(), labels.data_ptr(),
           g.data_ptr(), lse.data_ptr(), dh.data_ptr(), t, d, v,
           DTYPE_CODES[h.dtype])
    LAUNCHES["fused_ce_dh"] += 1
    return dh


def fused_ce_dw(h, w, labels, g, logits, lse):
    """K6 dW: ``h^T @ ((softmax(logits) - onehot) * g)`` -> (D, V) in the
    compute dtype, summed over every token in one pass (no atomics)."""
    dev, t, d, v = _check_backward(h, w, labels, g, logits, lse)
    if dev.type == "cpu":
        return fused_ce_dw_plain(h, w, labels, g, logits, lse)
    if t == 0:
        return torch.zeros(d, v, dtype=w.dtype, device=dev)
    dw = torch.empty(d, v, dtype=w.dtype, device=dev)
    launch(*_DW, dev, logits.data_ptr(), h.data_ptr(), labels.data_ptr(),
           g.data_ptr(), lse.data_ptr(), dw.data_ptr(), t, d, v,
           DTYPE_CODES[h.dtype])
    LAUNCHES["fused_ce_dw"] += 1
    return dw


class _FusedSoftmaxXent(torch.autograd.Function):
    """K4's training variant forward, K6 backward; ``h``/``w`` arrive
    already in the compute dtype."""

    @staticmethod
    def forward(ctx, h, w, labels):
        ce, logits, lse = _forward(h, w, labels, store=True)
        ctx.save_for_backward(h, w, labels, logits, lse)
        return ce

    @staticmethod
    def backward(ctx, g):
        h, w, labels, logits, lse = ctx.saved_tensors
        g = g.float().contiguous()
        need_h, need_w = ctx.needs_input_grad[:2]
        dh = fused_ce_dh(h, w, labels, g, logits, lse) if need_h else None
        dw = fused_ce_dw(h, w, labels, g, logits, lse) if need_w else None
        return dh, dw, None


def fused_softmax_xent(h, w, labels, compute_dtype=None):
    """Per-token cross-entropy ``lse(h @ w) - (h @ w)[labels]``: ``h``
    (T, D), ``w`` (D, V), ``labels`` (T,) int32 -> (T,) f32. The products
    take ``h`` and ``w`` cast to ``compute_dtype`` (default ``h``'s
    dtype; f32 or bf16) and accumulate in f32; on the card an f32
    product runs in 3xTF32, to f32 accuracy."""
    device_of("h", h)
    dt = compute_dtype or h.dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"h must be torch.float32 or torch.bfloat16 (or "
                        f"compute_dtype one of them), got {dt}")
    if not isinstance(w, torch.Tensor):
        raise TypeError("w must be a torch.Tensor")
    hc, wc = h.to(dt), w.to(dt)
    if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
        return _FusedSoftmaxXent.apply(hc, wc, labels)
    return _forward(hc, wc, labels, store=False)[0]
