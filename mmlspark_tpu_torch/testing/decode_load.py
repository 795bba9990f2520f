"""Model pairs for driving the speculative decode plane.

The port of ``make_spec_model_pair`` from
``mmlspark_tpu/testing/decode_load.py``; the module's load drivers and
benches come later (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Optional

from mmlspark_tpu_torch.models import transformer as T


def make_spec_model_pair(cfg: T.TransformerConfig, draft_layers: int = 1,
                         resid_scale: float = 0.05, seed: int = 0,
                         params: Optional[dict] = None):
    """A (target params, draft params, draft cfg) triple whose
    truncated-layer draft AGREES with the target at trained-pair rates.

    ``params`` is a tree in the ``init_params`` layout (numpy arrays, a
    JAX tree carried across as numpy, or the port's tensors); without
    it, :func:`~mmlspark_tpu_torch.models.transformer.init_params_np`
    draws one from ``seed``. Randomly initialized blocks drown the
    embedding stream in residual noise, so an early exit's argmax is
    uncorrelated with the full model's (about 0.1 acceptance). Scaling
    each block's output projections ``wo`` and ``w2`` by
    ``resid_scale`` restores the trained regime, where the residual
    refines rather than replaces the stream. The draft is
    :func:`~mmlspark_tpu_torch.models.transformer.layer_truncated_draft`
    of the scaled tree: its leaves are the target's objects."""
    if params is None:
        params = T.init_params_np(cfg, seed=seed)
    params = dict(params)
    params["blocks"] = [dict(b) for b in params["blocks"]]
    for b in params["blocks"]:
        b["wo"] = b["wo"] * resid_scale
        b["w2"] = b["w2"] * resid_scale
    draft_params, draft_cfg = T.layer_truncated_draft(params, cfg,
                                                      draft_layers)
    return params, draft_params, draft_cfg
