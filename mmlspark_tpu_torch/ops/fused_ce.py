"""Fused softmax cross-entropy over a linear vocabulary head, forward.

The port of the forward half of ``mmlspark_tpu/ops/fused_ce.py``
(K4): per token, ``ce = lse(h @ w) - (h @ w)[label]`` without writing
the ``(T, V)`` logits to device memory. On the card it is the
hand-written Hopper kernel ``csrc/fused_ce_forward.cu``: vocab slices
spread over the blocks, per-slice partial softmax states, and a second
small launch that merges them per token.

:func:`fused_softmax_xent` takes the JAX function's layout: ``h``
(T, D) f32, ``w`` (D, V) f32 (the LM ``head`` as stored), ``labels``
(T,) int32; it returns (T,) f32. The gold logit is the SUM of the
logits whose column equals the label — the JAX kernel's in-tile
``iota == label`` mask — so a label that matches no column gives gold 0
and ``ce = lse``. The JAX kernel pads V to its tile and holds -1e30 in
the pad columns, so there a label in ``[V, V_pad)`` meets a -1e30
logit; the port has no pad columns and gives 0 for every label outside
``[0, V)``.

Forward only: the speculative verify scores proposals under
``no_grad``. The training slice wraps this kernel and the backward (K6,
``_ce_dh_kernel``/``_ce_dw_kernel``) in a ``torch.autograd.Function``.
The JAX forward also stores the logits (its ``logits_ref`` output)
solely to feed that backward; this port does not write them.

The wrapper checks dtype, shape, device and contiguity and raises on
anything else. It runs :func:`fused_softmax_xent_plain` only when it is
handed CPU tensors; for CUDA tensors it launches the kernel or raises —
there is no fallback. :data:`LAUNCHES` counts one per kernel call.
"""

from __future__ import annotations

from typing import Dict

import torch

from mmlspark_tpu_torch.native.launch import I, P, check, device_of, launch

#: kernel calls per wrapper (plain-version calls never count)
LAUNCHES: Dict[str, int] = {"fused_softmax_xent": 0}

#: vocab columns per block of the kernel (``kCols`` in the source; the
#: launcher refuses a partials buffer sized for any other value)
VOCAB_SLICE = 128

_ENTRY = "mmt_fused_softmax_xent_fwd"
_ARGTYPES = [P] * 5 + [I] * 4


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_softmax_xent_plain(h, w, labels):
    """The logits, their log-sum-exp, and the gold logit as a one-hot
    masked sum (the JAX kernel's form, not a gather)."""
    logits = h @ w
    cols = torch.arange(w.shape[1], device=h.device)
    hit = cols[None, :] == labels[:, None].to(torch.int64)
    gold = torch.where(hit, logits, torch.zeros((), device=h.device)).sum(-1)
    return torch.logsumexp(logits, dim=-1) - gold


def fused_softmax_xent(h, w, labels):
    """Per-token cross-entropy ``lse(h @ w) - (h @ w)[labels]``: ``h``
    (T, D) f32, ``w`` (D, V) f32, ``labels`` (T,) int32 -> (T,) f32,
    f32-accumulated (no TF32)."""
    dev = device_of("h", h)
    check("h", h, torch.float32, (None, None), dev)
    t, d = h.shape
    check("w", w, torch.float32, (d, None), dev)
    check("labels", labels, torch.int32, (t,), dev)
    v = w.shape[1]
    if d < 1 or v < 1:
        raise ValueError(f"D={d} and V={v} must be >= 1")
    if dev.type == "cpu":
        return fused_softmax_xent_plain(h, w, labels)
    out = torch.empty(t, dtype=torch.float32, device=dev)
    if t == 0:
        return out
    n_slices = -(-v // VOCAB_SLICE)
    partials = torch.empty(3 * n_slices * t, dtype=torch.float32,
                           device=dev)
    launch(_ENTRY, _ARGTYPES, dev, h.data_ptr(), w.data_ptr(),
           labels.data_ptr(), partials.data_ptr(), out.data_ptr(), t, d, v,
           n_slices)
    LAUNCHES["fused_softmax_xent"] += 1
    return out
