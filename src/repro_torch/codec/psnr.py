"""PSNR quality metric (luma, 8-bit range) — the paper's Fig. 6(b) metric."""
from __future__ import annotations

import numpy as np


def psnr(ref: np.ndarray, test: np.ndarray, peak: float = 255.0) -> float:
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    mse = np.mean((ref - test) ** 2)
    if mse <= 1e-12:
        return 99.0
    return float(10.0 * np.log10(peak * peak / mse))
