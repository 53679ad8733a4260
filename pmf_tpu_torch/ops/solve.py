"""Batched K x K positive-definite solves for the flat Gaussian engine.

All rows solve at once as one batched Cholesky, as the JAX package's
``pmf_tpu/ops/solve.py`` does with XLA; here the library call is
``torch.linalg.cholesky`` with ``torch.cholesky_solve``.  The blocked
engine inverts with the Gauss-Jordan kernel instead (``ops.gj_inverse``).
"""

from __future__ import annotations

import torch


def batched_psd_solve(mats: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``mats[r] @ x[r] = rhs[r]`` for every row r.

    mats: (R, K, K) symmetric positive-definite; rhs: (R, K) -> (R, K)."""
    chol = torch.linalg.cholesky(mats)
    return torch.cholesky_solve(rhs[..., None], chol)[..., 0]


def batched_psd_inverse(mats: torch.Tensor) -> torch.Tensor:
    """Invert (R, K, K) symmetric positive-definite matrices via Cholesky."""
    chol = torch.linalg.cholesky(mats)
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype,
                    device=mats.device).expand(mats.shape)
    return torch.cholesky_solve(eye, chol)
