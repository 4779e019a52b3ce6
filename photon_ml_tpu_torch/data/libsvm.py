"""LIBSVM text reader (a copy of photon_ml_tpu/data/libsvm.py, numpy only).

reference: photon-client/.../io/deprecated/LibSVMInputDataFormat.scala (legacy
LIBSVM -> RDD[LabeledPoint]) and dev-scripts/libsvm_text_to_trainingexample_avro.py
(the a1a conversion path in the reference README's "Try It Out!").

Returns dense numpy host arrays, as the JAX package's reader does; wrap X
in scipy.sparse.csr_matrix for the sparse path (train_glm takes either)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def read_libsvm(
    path: str,
    num_features: Optional[int] = None,
    add_intercept: bool = True,
    zero_based: bool = False,
    binary_labels_to_01: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (X [n, d(+1)], y [n]).  The intercept column (all ones) is appended
    LAST, matching IndexMap's intercept-last convention."""
    rows, cols, vals, labels = [], [], [], []
    max_col = -1
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                if tok.startswith("#"):
                    break
                idx_s, _, val_s = tok.partition(":")
                j = int(idx_s) - (0 if zero_based else 1)
                if j < 0:
                    raise ValueError(
                        f"{path}: feature index {idx_s} on line {i + 1} is below "
                        f"the {'0' if zero_based else '1'}-based minimum "
                        "(pass zero_based=True for 0-based files)")
                rows.append(len(labels) - 1)
                cols.append(j)
                vals.append(float(val_s))
                max_col = max(max_col, j)
    n = len(labels)
    d = num_features if num_features is not None else max_col + 1
    if max_col >= d:
        raise ValueError(
            f"{path}: feature index {max_col} out of range for "
            f"num_features={d} (indices are {'0' if zero_based else '1'}-based)")
    x = np.zeros((n, d + (1 if add_intercept else 0)))
    x[np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)] = vals
    if add_intercept:
        x[:, -1] = 1.0
    y = np.asarray(labels)
    if binary_labels_to_01 and set(np.unique(y)) <= {-1.0, 1.0}:
        y = (y > 0).astype(np.float64)  # ±1 -> {0,1}, the API's label space
    return x, y
