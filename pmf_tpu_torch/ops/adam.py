"""Adam with explicit state, on dicts of tensors.

The update of ``optax.adam`` at its defaults (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0): ``p - lr * m_hat / (sqrt(v_hat) + eps)`` with bias-corrected
moments.  Gradients are DENSE: a row with a zero gradient still has its
moments decayed and still moves by its old momentum.  The state is a plain
dict ``{"count": int, "mu": {...}, "nu": {...}}`` so that callers can
permute the moments with their parameter rows and carry them to and from
numpy.
"""

from __future__ import annotations

import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-8


def adam_init(params: dict) -> dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam_update(grads: dict, state: dict, params: dict, lr: float):
    """One Adam step: (new params, new state).  ``count`` stays a host
    integer, so the bias corrections cost no device read."""
    count = state["count"] + 1
    c1 = 1.0 - B1 ** count
    c2 = 1.0 - B2 ** count
    mu, nu, out = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = B1 * state["mu"][k] + (1.0 - B1) * g
        nu[k] = B2 * state["nu"][k] + (1.0 - B2) * (g * g)
        out[k] = p + (-lr) * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS))
    return out, {"count": count, "mu": mu, "nu": nu}
