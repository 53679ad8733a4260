"""Hierarchical Poisson Factorization (Gopalan et al.) with CAVI.

Model:
    x_ui ~ Poisson(theta_u^T beta_i)
    theta_uk ~ Gamma(a, xi_u),    xi_u ~ Gamma(a', b')
    beta_ik ~ Gamma(c, eta_i),    eta_i ~ Gamma(c', d')

Each sweep runs the four coordinate blocks in the order theta -> xi ->
beta -> eta with expectation refreshes between blocks; rows without
observations reset to shape a (resp. c) and rate E[xi_u] (resp.
E[eta_i]).  The state is a dict of tensors with the JAX package's keys.

Engines: "flat" computes the edge statistics with gathers and
``index_add_`` segment sums over the dual-sorted COO; "flat_chunked" does
the same in chunks of edges, so no (nnz, K) temporaries exist at once;
"blocked_high", "blocked_mid" and "blocked_fast" run the hybrid layout
through the two CUDA kernels (``ops.cavi_edge`` for the sparse tail,
``ops.dense_head`` for the dense head tiers) on the card, or through their
plain versions on the CPU.  "mid" computes what "high" does on the card
(the reference's mid differs only in its TPU tail gathers); "fast" runs the
head at one bf16 term (K2's one-term instance).  Any other name runs flat,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pmf_tpu_torch.data.coo import EvalSet, RatingsCOO
from pmf_tpu_torch.eval.metrics import masked_metrics
from pmf_tpu_torch.models.base import (
    FactorModel,
    FitLoop,
    blocked_precision,
    poisson_stop_rule,
    reduced,
    resolve_engine,
)
from pmf_tpu_torch.ops.segment import edge_dot, gather_rows, sorted_segment_sum
from pmf_tpu_torch.utils.device import resolve_device

RATE_FLOOR = 1e-10
STATE_KEYS = ("a_theta", "b_theta", "a_beta", "b_beta", "b_xi", "b_eta")
CHUNK_LEN = 1 << 20  # edges a chunk of the "flat_chunked" engine


@dataclasses.dataclass
class HPFConfig:
    n_factors: int = 20
    a: float = 0.3
    a_prime: float = 0.3
    b_prime: float = 1.0
    c: float = 0.3
    c_prime: float = 0.3
    d_prime: float = 1.0
    max_iter: int = 100
    tol: Optional[float] = 1e-4
    random_state: int = 42
    verbose: bool = True
    dtype: str = "float32"
    # "flat" (gather + index_add_), "flat_chunked" (the same in chunks of
    # edges), "blocked_high" / "blocked_mid" / "blocked_fast" (hybrid layout
    # through the CUDA kernels, the head at three bf16 terms or one) or
    # "auto" (flat below 300k edges or on the CPU, else blocked_high).
    engine: str = "auto"


def _init_state_numpy(n_users: int, n_items: int, cfg: HPFConfig) -> dict:
    """Initial Gamma state as numpy arrays, drawn in the JAX package's
    order (theta shape, theta rate, beta shape, beta rate), so both
    packages start from the same bits."""
    rng = np.random.default_rng(cfg.random_state)
    K = cfg.n_factors
    dt = np.dtype(cfg.dtype)
    N, M = n_users, n_items
    return {
        "a_theta": (cfg.a + rng.gamma(1.0, 0.1, size=(N, K))).astype(dt),
        "b_theta": (cfg.b_prime + rng.gamma(1.0, 0.1, size=(N, K))).astype(dt),
        "a_beta": (cfg.c + rng.gamma(1.0, 0.1, size=(M, K))).astype(dt),
        "b_beta": (cfg.d_prime + rng.gamma(1.0, 0.1, size=(M, K))).astype(dt),
        # xi/eta shapes are scalars, constant through training.
        "b_xi": np.full((N,), cfg.b_prime, dtype=dt),
        "b_eta": np.full((M,), cfg.d_prime, dtype=dt),
    }


def state_from_numpy(state_np: dict, device=None, dtype=None) -> dict:
    """numpy Gamma state (the JAX package's keys) -> dict of tensors on
    ``device`` (None = the card)."""
    device = resolve_device(device)
    out = {}
    for k in STATE_KEYS:
        t = torch.from_numpy(np.array(state_np[k]))  # a writable copy
        out[k] = t.to(device=device, dtype=dtype if dtype is not None else t.dtype)
    return out


def state_to_numpy(state: dict) -> dict:
    """dict of tensors -> numpy Gamma state (host copies)."""
    return {k: state[k].detach().cpu().numpy() for k in STATE_KEYS}


def init_state(n_users: int, n_items: int, cfg: HPFConfig, device=None) -> dict:
    return state_from_numpy(_init_state_numpy(n_users, n_items, cfg), device)


def _hpf_factor_block(E_self, E_other, E_rate_prior, self_ids, other_ids, x,
                      counts, shape0, n_self, reduce=None):
    """theta- or beta-block: multinomial allocation for the shape, observed
    sum of other rows plus the hierarchical rate expectation for the rate.
    Empty rows -> (shape0, E_rate_prior).  ``reduce``: the mesh's sum of
    the statistics over its data axis (``models.base.reduced``)."""
    self_rows = gather_rows(E_self, self_ids)
    other_rows = gather_rows(E_other, other_ids)
    rate = torch.clamp_min(edge_dot(self_rows, other_rows), RATE_FLOOR)
    alloc = (x / rate)[:, None] * self_rows * other_rows
    s_alloc = sorted_segment_sum(alloc, self_ids, n_self)
    s_other = sorted_segment_sum(other_rows, self_ids, n_self)
    s_alloc, s_other = reduced(reduce, s_alloc, s_other)
    return _factor_update(s_alloc, s_other, E_rate_prior, counts, shape0)


def _hpf_factor_block_chunked(E_self, E_other, E_rate_prior, self_ids, other_ids,
                              x, counts, shape0, n_self, chunk_len, reduce=None):
    """:func:`_hpf_factor_block` over chunks of ``chunk_len`` edges, the
    two segment sums accumulated, so no (nnz, K) temporary is held at
    once.  Padding edges (ids out of range) are dropped."""
    K = E_self.shape[1]
    sums = torch.zeros((n_self + 1, 2 * K), dtype=E_self.dtype, device=E_self.device)
    for c0 in range(0, self_ids.shape[0], chunk_len):
        cs, co = self_ids[c0 : c0 + chunk_len], other_ids[c0 : c0 + chunk_len]
        self_rows = gather_rows(E_self, cs)
        other_rows = gather_rows(E_other, co)
        rate = torch.clamp_min(edge_dot(self_rows, other_rows), RATE_FLOOR)
        alloc = (x[c0 : c0 + chunk_len] / rate)[:, None] * self_rows * other_rows
        ids = cs.long()
        ids = torch.where((ids >= 0) & (ids < n_self), ids, n_self)
        sums.index_add_(0, ids, torch.cat([alloc, other_rows], dim=1))
    s_alloc, s_other = reduced(reduce, sums[:n_self, :K], sums[:n_self, K:])
    return _factor_update(s_alloc, s_other, E_rate_prior, counts, shape0)


def _factor_update(s_alloc, s_other, E_rate_prior, counts, shape0):
    has = (counts > 0)[:, None]
    prior = E_rate_prior[:, None]
    a_out = torch.where(has, shape0 + s_alloc, torch.full_like(s_alloc, shape0))
    b_out = torch.where(has, prior + s_other, prior.expand_as(s_other))
    return a_out, b_out


def _expectations(state: dict, a, a_prime, c, c_prime):
    K = state["a_theta"].shape[1]
    a_xi = a_prime + K * a  # constant shapes
    a_eta = c_prime + K * c
    return (state["a_theta"] / state["b_theta"], state["a_beta"] / state["b_beta"],
            a_xi / state["b_xi"], a_eta / state["b_eta"])


def sweep(state: dict, data: RatingsCOO, a: float, a_prime: float,
          b_prime: float, c: float, c_prime: float, d_prime: float,
          chunk_len: int | None = None, reduce=None) -> dict:
    """One CAVI iteration over the flat dual-sorted COO; with ``chunk_len``
    (engine "flat_chunked") the edge passes run in chunks of that many
    edges.  ``reduce``: under a data-parallel mesh, the sum of each block's
    statistics over the ranks' shares of the edges (``parallel.mesh``).
    It runs no kernel."""
    E_theta, E_beta, E_xi, E_eta = _expectations(state, a, a_prime, c, c_prime)
    if chunk_len is None:
        def block(*args):
            return _hpf_factor_block(*args, reduce=reduce)
    else:
        def block(*args):
            return _hpf_factor_block_chunked(*args, chunk_len, reduce=reduce)

    a_theta, b_theta = block(
        E_theta, E_beta, E_xi, data.u_by_u, data.i_by_u, data.x_by_u,
        data.user_counts, a, data.n_users)
    E_theta = a_theta / b_theta
    b_xi = b_prime + torch.sum(E_theta, dim=1)

    a_beta, b_beta = block(
        E_beta, E_theta, E_eta, data.i_by_i, data.u_by_i, data.x_by_i,
        data.item_counts, c, data.n_items)
    E_beta = a_beta / b_beta
    b_eta = d_prime + torch.sum(E_beta, dim=1)

    return {"a_theta": a_theta, "b_theta": b_theta, "a_beta": a_beta,
            "b_beta": b_beta, "b_xi": b_xi, "b_eta": b_eta}


def sweep_blocked(state: dict, blocked, user_counts: torch.Tensor,
                  item_counts: torch.Tensor, a: float, a_prime: float,
                  b_prime: float, c: float, c_prime: float,
                  d_prime: float, precision: str = "high", reduce=None) -> dict:
    """Same iteration as :func:`sweep`, with the two edge passes computed
    over the hybrid layout (``data.blocked.BlockedCOO``): sparse tail by
    kernel K1, dense head tiers by kernel K2 at ``precision`` ("fast" or
    "high").  Under a data-parallel mesh ``blocked`` is the rank's band
    (``parallel.mesh.shard_blocked``) and ``reduce`` sums the statistics."""
    from pmf_tpu_torch.ops.cavi_edge import poisson_edge_stats

    E_theta, E_beta, E_xi, E_eta = _expectations(state, a, a_prime, c, c_prime)
    head = blocked.head

    s_alloc, s_other = poisson_edge_stats(E_theta, E_beta, blocked.by_user,
                                          head=head, head_side="user",
                                          precision=precision)
    s_alloc, s_other = reduced(reduce, s_alloc, s_other)
    a_theta, b_theta = _factor_update(s_alloc, s_other, E_xi, user_counts, a)
    E_theta = a_theta / b_theta
    b_xi = b_prime + torch.sum(E_theta, dim=1)

    s_alloc_i, s_other_i = poisson_edge_stats(E_beta, E_theta, blocked.by_item,
                                              head=head, head_side="item",
                                              precision=precision)
    s_alloc_i, s_other_i = reduced(reduce, s_alloc_i, s_other_i)
    a_beta, b_beta = _factor_update(s_alloc_i, s_other_i, E_eta, item_counts, c)
    E_beta = a_beta / b_beta
    b_eta = d_prime + torch.sum(E_beta, dim=1)

    return {"a_theta": a_theta, "b_theta": b_theta, "a_beta": a_beta,
            "b_beta": b_beta, "b_xi": b_xi, "b_eta": b_eta}


def eval_metrics(state: dict, ev: EvalSet, reduce=None):
    """(val RMSE, val macro-MAE) as 0-d tensors on the state's device;
    ``reduce`` sums them over a mesh's shares of the rows
    (``eval.metrics.masked_metrics``)."""
    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]
    pred = edge_dot(gather_rows(E_theta, ev.u), gather_rows(E_beta, ev.i))
    pred = torch.where(ev.valid, pred, 0.0)
    return masked_metrics(ev.x, pred, ev.real, ev.class_id, ev.n_classes, reduce)


class HPF(FactorModel):
    """HPF-CAVI with the JAX package's fit/predict surface."""

    def fit(self, train_df, val_df=None, device=None, elbo_every: int = 0,
            resume_from=None, checkpoint_dir=None, checkpoint_every: int = 10,
            profile_dir=None, mesh=None, state_sharding=None):
        """``device``: None = the CUDA card (raises without one); "cpu"
        runs the kernels' plain versions on the host.  ``elbo_every=N``
        records the auxiliary-variable ELBO in fit_history every N
        iterations (0 = off).  ``resume_from``: a checkpoint directory
        whose state replaces the fresh init; ``checkpoint_dir``: save the
        state every ``checkpoint_every`` iterations; ``profile_dir``: a
        ``torch.profiler`` trace of the loop.  ``mesh``
        (``parallel.make_mesh``): data-parallel training, each rank's share
        of the edges and of the validation rows, the statistics summed over
        the ranks, the state replicated; ``state_sharding="rows"``: the
        state's rows sharded over the mesh and ring sweeps
        (``parallel.tp``)."""
        cfg = self.config
        if self._check_sharding(state_sharding, mesh, elbo_every):
            from pmf_tpu_torch.parallel.tp import fit_tp, hpf_family

            return fit_tp(self, hpf_family(cfg), train_df, val_df, resume_from,
                          checkpoint_dir, checkpoint_every, profile_dir, mesh)
        self.device = self._fit_device(device, mesh)
        data = self._build_train(train_df, mesh)
        self.n_users, self.n_items = data.n_users, data.n_items
        if cfg.verbose and (mesh is None or mesh.is_writer):
            print(f"Inferred n_users={self.n_users}, n_items={self.n_items}", flush=True)
        state = self._initial_state(
            init_state(self.n_users, self.n_items, cfg, self.device), resume_from, mesh)
        reduce = mesh.sum if mesh else None

        engine = resolve_engine(cfg.engine, data.nnz, self.device)
        self.engine_used = engine
        hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
        precision = blocked_precision(engine)
        if precision is not None:
            self.blocked = blocked = self._blocked_layout(train_df, 5 << 29, mesh)

            def sweep_fn(s, d):
                return sweep_blocked(s, blocked, d.user_counts, d.item_counts, *hyper,
                                     precision=precision, reduce=reduce)
        else:
            chunk_len = CHUNK_LEN if engine == "flat_chunked" else None

            def sweep_fn(s, d):
                return sweep(s, d, *hyper, chunk_len=chunk_len, reduce=reduce)

        val = self._build_eval(val_df, mesh) if val_df is not None else None
        loop = FitLoop(sweep_fn, lambda s, ev: eval_metrics(s, ev, reduce), cfg.max_iter,
                       cfg.tol, poisson_stop_rule, name="HPF",
                       checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                       edge_visits_per_iter=2 * data.nnz,  # theta + beta passes
                       elbo_every=elbo_every or 1,
                       **self._mesh_loop_args(
                           mesh, cfg.verbose, profile_dir,
                           self._make_elbo_fn(train_df) if elbo_every else None))
        self.state = loop.run(state, data, val)
        self.fit_history = loop.history
        self.n_sweeps = loop.n_sweeps
        self.sweep_once = lambda s: sweep_fn(s, data)
        return self

    def _make_elbo_fn(self, train):
        """``train`` on the +1-shifted scale passed to fit()."""
        from pmf_tpu_torch.eval.elbo import hpf_elbo

        cfg = self.config
        u, i, x, nc = self._elbo_edges(train)
        return lambda s: hpf_elbo(s, u, i, x, cfg.a, cfg.a_prime, cfg.b_prime,
                                  cfg.c, cfg.c_prime, cfg.d_prime, n_chunks=nc)

    def _point_estimates(self):
        return (self.state["a_theta"] / self.state["b_theta"],
                self.state["a_beta"] / self.state["b_beta"])
