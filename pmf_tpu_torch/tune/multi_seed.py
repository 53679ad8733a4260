"""Multi-seed training: S independent fits of one config in one batched
program.

The S random inits are stacked on a leading seed axis and
``torch.func.vmap`` maps the flat sweep and the eval metrics over it,
the rating COO shared by every seed.  As in the JAX package
(``jax.vmap`` of its flat sweep), the iteration count is fixed and no
stop rule runs: the per-seed early stop is host control flow.  The flat
sweep runs no kernel of the port; it is the plain form on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from pmf_tpu_torch.data.coo import build_eval_set, build_ratings
from pmf_tpu_torch.models import gaussian_mf, hpf, poisson_mf
from pmf_tpu_torch.models.base import as_triples
from pmf_tpu_torch.utils.device import resolve_device


def _model_fns(config):
    """(module, sweep(state, data), eval(state, ev)) of ``config``'s family."""
    if isinstance(config, hpf.HPFConfig):
        hyper = (config.a, config.a_prime, config.b_prime, config.c,
                 config.c_prime, config.d_prime)
        return (hpf, lambda s, d: hpf.sweep(s, d, *hyper), hpf.eval_metrics)
    if isinstance(config, poisson_mf.PoissonMFConfig):
        return (poisson_mf,
                lambda s, d: poisson_mf.sweep(s, d, config.a0, config.b0, config.extended),
                lambda s, ev: poisson_mf.eval_metrics(s, ev, config.extended))
    if isinstance(config, gaussian_mf.GaussianMFConfig):
        # As the reference: no covariance or bias_update reaches the
        # sweep, so every seed runs full covariance, exact bias order.
        return (gaussian_mf,
                lambda s, d: gaussian_mf.sweep(
                    s, d, config.sigma2, config.eta_theta2, config.eta_beta2,
                    config.eta_bias2, config.use_bias),
                lambda s, ev: gaussian_mf.eval_metrics(s, ev, config.use_bias))
    raise TypeError(f"unsupported config {type(config)!r}")


def stacked_init(config, n_users: int, n_items: int, seeds, device=None) -> dict:
    """Each seed's init (the family's numpy draws with ``random_state=seed``,
    equal to the JAX package's), stacked on a leading seed axis."""
    mod = _model_fns(config)[0]
    states = [mod.init_state(n_users, n_items,
                             dataclasses.replace(config, random_state=int(seed)), device)
              for seed in seeds]
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def vmapped_sweep(config, data):
    """stacked state -> stacked state after one flat sweep of every seed."""
    sweep = _model_fns(config)[1]
    return vmap(lambda s: sweep(s, data))


def multi_seed_fit(config, train, val=None, seeds=(0, 1, 2), n_iter: Optional[int] = None,
                   device=None):
    """Fit one config across seeds simultaneously.

    config: a GaussianMFConfig / PoissonMFConfig / HPFConfig.  Returns
    (stacked_state, per_seed_metrics): the state's tensors carry the seed
    axis first, on ``device`` (None = the card); per_seed_metrics is a
    list of {"seed", "val_rmse", "val_macro_mae"} (empty without val).
    Runs ``n_iter`` (default ``config.max_iter``) iterations.
    """
    eval_fn = _model_fns(config)[2]  # an unsupported config raises here
    device = resolve_device(device)
    u, i, x = as_triples(train)
    dtype = np.dtype(getattr(config, "dtype", "float32"))
    data = build_ratings(u, i, x, dtype=dtype, device=device)
    n_iter = n_iter or config.max_iter

    stacked = stacked_init(config, data.n_users, data.n_items, seeds, device)
    step = vmapped_sweep(config, data)
    for _ in range(n_iter):
        stacked = step(stacked)

    metrics = []
    if val is not None:
        vu, vi, vx = as_triples(val)
        ev = build_eval_set(vu, vi, vx, data.n_users, data.n_items, dtype=dtype,
                            device=device)
        rmses, macros = (t.cpu().tolist() for t in vmap(lambda s: eval_fn(s, ev))(stacked))
        metrics = [{"seed": int(seed), "val_rmse": rmses[k], "val_macro_mae": macros[k]}
                   for k, seed in enumerate(seeds)]
    return stacked, metrics
