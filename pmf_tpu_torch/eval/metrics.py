"""Evaluation metrics: host numpy forms and the masked tensor forms used
inside the fit loop (padded eval sets, precomputed rating classes)."""

from __future__ import annotations

import numpy as np
import torch

from pmf_tpu_torch.ops.segment import sorted_segment_sum


def rmse(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def mae(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(np.mean(np.abs(y_true - y_pred)))


def macro_mae(y_true, y_pred) -> float:
    """MAE averaged over the unique true-rating classes (equal weight)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    per_class = [
        np.mean(np.abs(y_true[y_true == v] - y_pred[y_true == v]))
        for v in np.unique(y_true)
    ]
    return float(np.mean(per_class))


def gaussian_log_predictive_likelihood(y_true, y_pred, sigma) -> float:
    """Sum of Gaussian log densities with standard deviation ``sigma``."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    var = float(sigma) ** 2
    sq = (y_true - y_pred) ** 2
    return float(np.sum(-0.5 * np.log(2.0 * np.pi * var) - sq / (2.0 * var)))


def poisson_log_predictive_likelihood(y_true, lam, epsilon: float = 1e-10) -> float:
    """Sum of Poisson log pmfs, the rate floored at ``epsilon``."""
    y_true = np.asarray(y_true, dtype=np.float64)
    lam = np.maximum(np.asarray(lam, dtype=np.float64), epsilon)
    log_fact = torch.lgamma(torch.from_numpy(y_true + 1.0)).numpy()
    return float(np.sum(y_true * np.log(lam) - lam - log_fact))


def masked_rmse(y_true: torch.Tensor, y_pred: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """RMSE over rows where ``mask`` is true (padding excluded)."""
    mask = mask.to(y_true.dtype)
    err2 = mask * (y_true - y_pred) ** 2
    return torch.sqrt(torch.sum(err2) / torch.clamp_min(torch.sum(mask), 1.0))


def masked_macro_mae(y_true: torch.Tensor, y_pred: torch.Tensor,
                     mask: torch.Tensor, class_id: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """Macro-MAE via one segment mean per rating class; classes with no
    masked-in rows are left out of the average."""
    per_class_sum, per_class_n = _class_sums(y_true, y_pred, mask, class_id, n_classes)
    return _macro(per_class_sum, per_class_n)


def _class_sums(y_true, y_pred, mask, class_id, n_classes):
    """(sum of absolute errors, rows) per rating class, masked rows only."""
    m = mask.to(y_true.dtype)
    abs_err = m * torch.abs(y_true - y_pred)
    ids = torch.where(mask, class_id.long(), n_classes)
    return (sorted_segment_sum(abs_err, ids, n_classes),
            sorted_segment_sum(m, ids, n_classes))


def _macro(per_class_sum, per_class_n):
    present = per_class_n > 0
    per_class_mae = per_class_sum / torch.clamp_min(per_class_n, 1.0)
    return torch.sum(torch.where(present, per_class_mae, 0.0)) / torch.clamp_min(
        torch.sum(present.to(per_class_n.dtype)), 1.0)


def masked_metrics(y_true: torch.Tensor, y_pred: torch.Tensor, mask: torch.Tensor,
                   class_id: torch.Tensor, n_classes: int, reduce=None):
    """(RMSE, macro-MAE) over the masked rows, as 0-d tensors.  ``reduce``:
    a mesh's sum over the ranks' shares of the rows (``parallel.mesh.Mesh.sum``);
    the squared-error sum, the row count and the per-class sums and counts
    are summed before the ratios, so the metrics equal the single-device
    ones."""
    if reduce is None:
        return (masked_rmse(y_true, y_pred, mask),
                masked_macro_mae(y_true, y_pred, mask, class_id, n_classes))
    m = mask.to(y_true.dtype)
    err2, n, per_class_sum, per_class_n = reduce(
        torch.sum(m * (y_true - y_pred) ** 2), torch.sum(m),
        *_class_sums(y_true, y_pred, mask, class_id, n_classes))
    return (torch.sqrt(err2 / torch.clamp_min(n, 1.0)),
            _macro(per_class_sum, per_class_n))
