"""Matplotlib helpers for scored frames (the port's copy of
``mmlspark_tpu/plot.py``).

Parity: `src/plot/src/main/python/plot.py` — the reference ships small
confusion-matrix / ROC plotting utilities for notebook use. These accept
either a scored :class:`DataFrame` or plain arrays and return the axes
so callers can style further.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np


def _ax(ax):
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt
    return plt.gca()


def confusion_matrix(y_true, y_pred, labels: Optional[Sequence[Any]] = None,
                     ax=None):
    """Draw a labelled confusion-matrix heatmap; returns the axes."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = sorted(set(y_true.tolist()) | set(y_pred.tolist()))
    idx = {v: i for i, v in enumerate(labels)}
    m = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(y_true, y_pred):
        m[idx[t], idx[p]] += 1
    ax = _ax(ax)
    ax.imshow(m, cmap="Blues")
    ax.set_xticks(range(len(labels)), [str(v) for v in labels])
    ax.set_yticks(range(len(labels)), [str(v) for v in labels])
    ax.set_xlabel("predicted")
    ax.set_ylabel("actual")
    for i in range(len(labels)):
        for j in range(len(labels)):
            ax.text(j, i, str(m[i, j]), ha="center", va="center")
    return ax


def roc(y_true, scores, ax=None):
    """Draw the ROC curve (threshold sweep); returns the axes."""
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores)
    tps = np.cumsum(y_true[order])
    fps = np.cumsum(~y_true[order])
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    ax = _ax(ax)
    ax.plot(np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr]))
    ax.plot([0, 1], [0, 1], linestyle="--", color="gray")
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    return ax
