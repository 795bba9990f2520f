"""Column helper functions (the port's copy of
``mmlspark_tpu/udfs.py``).

Parity: `src/udf/src/main/scala/udfs.scala:15` — the reference registers
``to_vector`` (array column -> ML vector) and ``get_value_at`` (vector
element extraction) as Spark UDFs. Here they are plain column
transformations usable directly or through :class:`UDFTransformer`.
"""

from __future__ import annotations

import numpy as np


def to_vector(col) -> np.ndarray:
    """List/array-of-numbers column -> stacked (n, d) float64 matrix."""
    return np.stack([np.asarray(v, dtype=np.float64) for v in col])


def get_value_at(col, index: int) -> np.ndarray:
    """Element ``index`` of each row's vector as a float64 column."""
    return np.asarray([float(np.asarray(v)[index]) for v in col])
