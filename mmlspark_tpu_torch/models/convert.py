"""Import trained weights from standard formats into NNFunction.

Capability parity with the reference's pretrained-model story: its
`ModelDownloader` serves *trained* CNTK nets whose value is transfer
learning through `ImageFeaturizer` (`ModelDownloader.scala:54,124`,
`ImageFeaturizer.scala:36,129-176`). The CNTK graph format died with
CNTK; the standard trained formats today are torch ``state_dict``s and
flax/orbax pytrees, so those are the importers here. GBDT interop has
the same shape (`gbdt/lgbm_compat.py` imports genuine LightGBM dumps).

Torch import contract (``import_torch_state_dict``): the source module
must define its submodules in **forward-call order** and mirror the
target architecture layer-for-layer (same convs/norms/denses, same
widths). Tensors are mapped positionally with layout transforms:

- ``Conv2d.weight`` (O, I, kH, kW) -> flax ``Conv.kernel`` (kH, kW, I, O)
- ``Linear.weight`` (O, I) -> flax ``Dense.kernel`` (I, O)
- 1-D tensors (norm scales/biases, linear biases) copy through

BatchNorm cannot be represented in the GroupNorm architectures this
framework ships (BN inference depends on ``running_mean/var``, which
have no GroupNorm equivalent). State dicts containing running stats —
or norm layers named like BatchNorm — are rejected; a BN layer with
``track_running_stats=False`` and an innocuous name is shape-identical
to GroupNorm and CANNOT be detected from tensors alone, so always
verify a converted model against the source's outputs (the pattern the
tests use) before publishing it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from mmlspark_tpu_torch.models.function import (
    NNFunction, flatten_params, unflatten_params,
)


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):  # torch tensor, no torch import needed here
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def import_torch_state_dict(state_dict: Dict[str, Any], arch: Dict[str, Any],
                            input_shape: Sequence[int]) -> NNFunction:
    """Convert a torch ``state_dict`` into an :class:`NNFunction`.

    ``arch``/``input_shape`` name the target architecture; the source
    module must mirror it in forward-call order (see module docstring).
    Golden-parity is tested against torch itself in
    ``tests/test_convert.py`` (same input → same logits).
    """
    import re
    bn_keys = [k for k in state_dict
               if k.endswith(("running_mean", "running_var"))
               or re.search(r"(^|\.)(bn\d*|batch_?norm\w*)\.", k)]
    if bn_keys:
        raise ValueError(
            "state_dict appears to contain BatchNorm layers "
            f"({bn_keys[:3]}...): BN inference semantics cannot be "
            "represented in this GroupNorm architecture; export a "
            "GroupNorm variant of the model instead. (Note: a stats-free "
            "BN with a non-standard name is undetectable from tensors — "
            "always verify converted outputs against the source model.)")

    src = [(k, _to_numpy(v)) for k, v in state_dict.items()
           if not k.endswith("num_batches_tracked")]

    target = NNFunction.init(arch, input_shape=input_shape, seed=0)
    flat = flatten_params(target.params)
    if len(src) != len(flat):
        raise ValueError(
            f"tensor count mismatch: state_dict has {len(src)} tensors, "
            f"architecture {arch.get('builder')!r} expects {len(flat)} "
            f"({list(flat)[:4]}...)")

    out: Dict[str, np.ndarray] = {}
    for (torch_key, t), (flax_key, ref) in zip(src, flat.items()):
        if t.ndim == 4:            # conv kernel OIHW -> HWIO
            t = np.transpose(t, (2, 3, 1, 0))
        elif t.ndim == 2:          # linear weight (O, I) -> (I, O)
            t = np.transpose(t, (1, 0))
        if t.shape != ref.shape:
            raise ValueError(
                f"shape mismatch at {torch_key!r} -> {flax_key!r}: "
                f"got {t.shape} (after layout transform), architecture "
                f"expects {ref.shape} — source layers must mirror the "
                f"target in forward-call order")
        out[flax_key] = t.astype(ref.dtype)
    return NNFunction(arch=dict(arch), params=unflatten_params(out))


def import_flax_params(params: Any, arch: Dict[str, Any],
                       input_shape: Sequence[int]) -> NNFunction:
    """Adopt an externally trained flax params pytree (e.g. restored from
    an orbax checkpoint), validating every leaf shape against ``arch``."""
    target = NNFunction.init(arch, input_shape=input_shape, seed=0)
    ref = flatten_params(target.params)
    got = flatten_params(params)
    if set(ref) != set(got):
        missing = sorted(set(ref) - set(got))[:4]
        extra = sorted(set(got) - set(ref))[:4]
        raise ValueError(f"param tree mismatch: missing={missing} "
                         f"extra={extra}")
    for k in ref:
        if ref[k].shape != got[k].shape:
            raise ValueError(f"shape mismatch at {k!r}: got "
                             f"{got[k].shape}, expected {ref[k].shape}")
    return NNFunction(
        arch=dict(arch),
        params=unflatten_params(
            {k: np.asarray(v, dtype=ref[k].dtype) for k, v in got.items()}))
