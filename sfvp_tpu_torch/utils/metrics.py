"""Image-quality metrics for the RMSE harness, counterpart of
sfvp_tpu/utils/metrics.py: the same float64 numpy functions (BASELINE
target: <= 2% relative RMSE against the reference renderer at equal
spp)."""

from __future__ import annotations

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_rmse(test: np.ndarray, reference: np.ndarray) -> float:
    """RMSE normalised by the reference's RMS magnitude: the metric of the
    <= 2% quality target."""
    ref = np.asarray(reference, np.float64)
    denom = float(np.sqrt(np.mean(ref ** 2)))
    return rmse(test, reference) / max(denom, 1e-12)


def mc_expected_rmse(var_image: np.ndarray, spp: int) -> float:
    """Expected Monte-Carlo RMSE given a per-pixel variance estimate: a
    measured RMSE near it is noise, not bias."""
    return float(np.sqrt(np.mean(np.asarray(var_image, np.float64) / spp)))
