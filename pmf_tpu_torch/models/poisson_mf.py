"""Poisson matrix factorization with mean-field CAVI, with optional
extended user-activity / item-popularity scalar factors.

  * plain:    x_ui ~ Poisson(theta_u^T beta_i), theta, beta ~ Gamma(a0, b0)
  * extended: x_ui ~ Poisson(phi_u psi_i theta_u^T beta_i), with scalar
    Gamma factors phi (user activity) and psi (item popularity)

Each coordinate block is one edge sweep: the multinomial allocation
``x * (theta_k beta_k) / (theta^T beta)`` per edge and per-row sums for
shapes and rates.  Rows without observations reset to the prior every
iteration.  In the extended variant the allocation divides by the
unweighted dot (the scalars cancel), the factor rate is the
scalar-weighted sum of other rows, and a row's scalar rate reads that
row's freshly updated factor (a per-row refresh, so the batched two-pass
form -- update all thetas, walk the edges again, update all phis -- equals
the sequential loop).  The state is a dict of tensors with the JAX
package's keys: 4 (plain) or 8 (extended; the scalar keys are 1-D).

Engines: "flat" computes the edge statistics with gathers and
``index_add_`` segment sums over the dual-sorted COO; "blocked_high" runs
the hybrid layout through the CUDA kernels on the card (plain: K1 and K2
through ``ops.cavi_edge``; extended: K7, K8 and K2 through
``ops.ext_edge``), or through their plain versions on the CPU.
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
    as_triples,
    blocked_precision,
    poisson_stop_rule,
    reduced,
    resolve_engine,
)
from pmf_tpu_torch.ops.segment import edge_dot, gather_rows, sorted_segment_sum
from pmf_tpu_torch.utils.device import resolve_device

RATE_FLOOR = 1e-10
STATE_KEYS = ("a_theta", "b_theta", "a_beta", "b_beta")
EXT_STATE_KEYS = STATE_KEYS + ("a_phi", "b_phi", "a_psi", "b_psi")


@dataclasses.dataclass
class PoissonMFConfig:
    n_factors: int = 20
    a0: float = 0.3
    b0: float = 1.0
    max_iter: int = 100
    tol: Optional[float] = 1e-4
    random_state: int = 42
    verbose: bool = True
    extended: bool = False  # scalar activity factors phi, psi
    dtype: str = "float32"
    # "flat" (gather + index_add_), "blocked_high" / "blocked_mid" /
    # "blocked_fast" (hybrid layout through the CUDA kernels, the head at
    # three bf16 terms or one) or "auto" (flat below 300k edges or on the
    # CPU, else blocked_high); any other name runs flat, as in the JAX
    # package.
    engine: str = "auto"


def _init_state_numpy(n_users: int, n_items: int, cfg: PoissonMFConfig) -> dict:
    """Initial Gamma state as numpy arrays, drawn in the JAX package's
    order (a_theta, a_beta, then a_phi, a_psi when extended; every rate
    starts at b0), so both packages start from the same bits."""
    rng = np.random.default_rng(cfg.random_state)
    K = cfg.n_factors
    dt = np.dtype(cfg.dtype)
    a0, b0 = cfg.a0, cfg.b0
    state = {
        "a_theta": (a0 + rng.gamma(1.0, 0.1, size=(n_users, K))).astype(dt),
        "b_theta": np.full((n_users, K), b0, dtype=dt),
        "a_beta": (a0 + rng.gamma(1.0, 0.1, size=(n_items, K))).astype(dt),
        "b_beta": np.full((n_items, K), b0, dtype=dt),
    }
    if cfg.extended:
        state.update(
            a_phi=(a0 + rng.gamma(1.0, 0.1, size=n_users)).astype(dt),
            b_phi=np.full((n_users,), b0, dtype=dt),
            a_psi=(a0 + rng.gamma(1.0, 0.1, size=n_items)).astype(dt),
            b_psi=np.full((n_items,), b0, dtype=dt),
        )
    return state


def _keys(state: dict) -> tuple:
    return EXT_STATE_KEYS if "a_phi" in state else STATE_KEYS


def state_from_numpy(state_np: dict, device=None, dtype=None) -> dict:
    """numpy Gamma state (the JAX package's 4 or 8 keys) -> dict of tensors
    on ``device`` (None = the card)."""
    device = resolve_device(device)
    out = {}
    for k in _keys(state_np):
        t = torch.from_numpy(np.array(state_np[k]))  # a writable copy
        out[k] = t.to(device=device, dtype=dtype if dtype is not None else t.dtype)
    return out


def state_to_numpy(state: dict) -> dict:
    """dict of tensors -> numpy Gamma state (host copies)."""
    return {k: state[k].detach().cpu().numpy() for k in _keys(state)}


def init_state(n_users: int, n_items: int, cfg: PoissonMFConfig,
               device=None) -> dict:
    return state_from_numpy(_init_state_numpy(n_users, n_items, cfg), device)


def _prior_where(has, stat, prior: float):
    """prior + stat where the row has observations, else the prior."""
    return torch.where(has, prior + stat, torch.full_like(stat, prior))


def _plain_block(E_self, E_other, self_ids, other_ids, x, counts, a0, b0, n_self,
                 reduce=None):
    """One plain-Poisson coordinate block: allocation, then shape and rate
    segment sums (summed over a mesh by ``reduce``).  Empty rows reset to
    the (a0, b0) prior."""
    self_rows = gather_rows(E_self, self_ids)
    other_rows = gather_rows(E_other, other_ids)
    rate = torch.clamp_min(edge_dot(self_rows, other_rows), RATE_FLOOR)
    alloc = (x / rate)[:, None] * self_rows * other_rows
    has = (counts > 0)[:, None]
    s_alloc, s_other = reduced(reduce, sorted_segment_sum(alloc, self_ids, n_self),
                               sorted_segment_sum(other_rows, self_ids, n_self))
    return _prior_where(has, s_alloc, a0), _prior_where(has, s_other, b0)


def _extended_block(E_self, E_other, s_other, self_ids, other_ids, x, counts,
                    a0, b0, n_self, reduce=None):
    """One extended-Poisson coordinate block, updating the K-factor row
    (theta or beta) and its scalar factor (phi or psi): returns
    (a_fac, b_fac, a_s, b_s).  ``reduce`` sums each pass's statistics over
    a mesh, the factor pass's before the rows update."""
    self_rows = gather_rows(E_self, self_ids)
    other_rows = gather_rows(E_other, other_ids)
    s_edges = gather_rows(s_other, other_ids)

    dot = torch.clamp_min(edge_dot(self_rows, other_rows), RATE_FLOOR)
    alloc = (x / dot)[:, None] * self_rows * other_rows
    has = (counts > 0)[:, None]
    s_alloc, s_wother = reduced(
        reduce, sorted_segment_sum(alloc, self_ids, n_self),
        sorted_segment_sum(other_rows * s_edges[:, None], self_ids, n_self))
    a_fac = _prior_where(has, s_alloc, a0)
    b_fac = _prior_where(has, s_wother, b0)
    E_fac = a_fac / b_fac

    # Scalar factor: shape a0 + sum x; the rate uses the UPDATED factor row.
    dot_new = edge_dot(gather_rows(E_fac, self_ids), other_rows)
    has1 = counts > 0
    s_x, s_sdot = reduced(reduce, sorted_segment_sum(x, self_ids, n_self),
                          sorted_segment_sum(s_edges * dot_new, self_ids, n_self))
    return a_fac, b_fac, _prior_where(has1, s_x, a0), _prior_where(has1, s_sdot, b0)


def sweep(state: dict, data: RatingsCOO, a0: float, b0: float,
          extended: bool, reduce=None) -> dict:
    """One CAVI iteration over the flat dual-sorted COO: user block, then
    item block, expectations refreshed between the blocks.  ``reduce``:
    under a data-parallel mesh, the sum of the statistics over the ranks'
    shares of the edges (``parallel.mesh``)."""
    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]

    if not extended:
        a_theta, b_theta = _plain_block(
            E_theta, E_beta, data.u_by_u, data.i_by_u, data.x_by_u,
            data.user_counts, a0, b0, data.n_users, reduce)
        E_theta = a_theta / b_theta
        a_beta, b_beta = _plain_block(
            E_beta, E_theta, data.i_by_i, data.u_by_i, data.x_by_i,
            data.item_counts, a0, b0, data.n_items, reduce)
        return {"a_theta": a_theta, "b_theta": b_theta, "a_beta": a_beta,
                "b_beta": b_beta}

    E_psi = state["a_psi"] / state["b_psi"]
    a_theta, b_theta, a_phi, b_phi = _extended_block(
        E_theta, E_beta, E_psi, data.u_by_u, data.i_by_u, data.x_by_u,
        data.user_counts, a0, b0, data.n_users, reduce)
    E_theta = a_theta / b_theta
    E_phi = a_phi / b_phi
    a_beta, b_beta, a_psi, b_psi = _extended_block(
        E_beta, E_theta, E_phi, data.i_by_i, data.u_by_i, data.x_by_i,
        data.item_counts, a0, b0, data.n_items, reduce)
    return {"a_theta": a_theta, "b_theta": b_theta, "a_beta": a_beta,
            "b_beta": b_beta, "a_phi": a_phi, "b_phi": b_phi, "a_psi": a_psi,
            "b_psi": b_psi}


def sweep_blocked(state: dict, blocked, user_counts: torch.Tensor,
                  item_counts: torch.Tensor, a0: float, b0: float,
                  precision: str = "high", reduce=None) -> dict:
    """The plain iteration of :func:`sweep`, with the two edge passes
    computed over the hybrid layout (``data.blocked.BlockedCOO``): sparse
    tail by kernel K1, dense head tiers by kernel K2 at ``precision``.
    Under a data-parallel mesh ``blocked`` is the rank's band
    (``parallel.mesh.shard_blocked``) and ``reduce`` sums the statistics."""
    from pmf_tpu_torch.ops.cavi_edge import poisson_edge_stats

    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]
    head = blocked.head

    s_alloc, s_other = poisson_edge_stats(E_theta, E_beta, blocked.by_user,
                                          head=head, head_side="user",
                                          precision=precision)
    s_alloc, s_other = reduced(reduce, s_alloc, s_other)
    has = (user_counts > 0)[:, None]
    a_theta = _prior_where(has, s_alloc, a0)
    b_theta = _prior_where(has, s_other, b0)
    E_theta = a_theta / b_theta

    s_alloc_i, s_other_i = poisson_edge_stats(E_beta, E_theta, blocked.by_item,
                                              head=head, head_side="item",
                                              precision=precision)
    s_alloc_i, s_other_i = reduced(reduce, s_alloc_i, s_other_i)
    has_i = (item_counts > 0)[:, None]
    return {"a_theta": a_theta, "b_theta": b_theta,
            "a_beta": _prior_where(has_i, s_alloc_i, a0),
            "b_beta": _prior_where(has_i, s_other_i, b0)}


def sweep_blocked_extended(state: dict, blocked, user_counts: torch.Tensor,
                           item_counts: torch.Tensor, sx_user: torch.Tensor,
                           sx_item: torch.Tensor, a0: float, b0: float,
                           precision: str = "high", reduce=None) -> dict:
    """The extended iteration of :func:`sweep` over the hybrid layout: per
    block the factor pass (K7 on the tail, K2 and linear products on the
    head), the row update, then the scalar pass (K8) with the NEW rows, on
    the other table and head products the factor pass made.
    ``sx_user`` / ``sx_item`` are the per-row rating sums (constant across
    iterations, made once).  ``precision`` is the head's and ``reduce`` the
    mesh's sum, as in :func:`sweep_blocked`."""
    from pmf_tpu_torch.ops.ext_edge import ext_factor_stats, ext_scalar_stats

    head = blocked.head

    def block(E_self, E_other, s_other, p, counts, sx, head_side):
        has1 = counts > 0
        has = has1[:, None]
        S_alloc, S_wother, tables = ext_factor_stats(
            E_self, E_other, s_other, p, head=head, head_side=head_side,
            keep_tables=True, precision=precision)
        S_alloc, S_wother = reduced(reduce, S_alloc, S_wother)
        a_fac = _prior_where(has, S_alloc, a0)
        b_fac = _prior_where(has, S_wother, b0)
        S_sdot = ext_scalar_stats(a_fac / b_fac, E_other, s_other, p, head=head,
                                  head_side=head_side, factor=tables,
                                  precision=precision)
        (S_sdot,) = reduced(reduce, S_sdot)
        return (a_fac, b_fac, _prior_where(has1, sx, a0),
                _prior_where(has1, S_sdot, b0))

    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]
    E_psi = state["a_psi"] / state["b_psi"]

    a_theta, b_theta, a_phi, b_phi = block(
        E_theta, E_beta, E_psi, blocked.by_user, user_counts, sx_user, "user")
    E_theta = a_theta / b_theta
    E_phi = a_phi / b_phi
    a_beta, b_beta, a_psi, b_psi = block(
        E_beta, E_theta, E_phi, blocked.by_item, item_counts, sx_item, "item")
    return {"a_theta": a_theta, "b_theta": b_theta, "a_beta": a_beta,
            "b_beta": b_beta, "a_phi": a_phi, "b_phi": b_phi, "a_psi": a_psi,
            "b_psi": b_psi}


def eval_metrics(state: dict, ev: EvalSet, extended: bool, reduce=None):
    """(val RMSE, val macro-MAE) as 0-d tensors on the state's device;
    out-of-range pairs predict 0; ``reduce`` sums them over a mesh's shares
    of the rows (``eval.metrics.masked_metrics``)."""
    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]
    pred = edge_dot(gather_rows(E_theta, ev.u), gather_rows(E_beta, ev.i))
    if extended:
        pred = pred * gather_rows(state["a_phi"] / state["b_phi"], ev.u)
        pred = pred * gather_rows(state["a_psi"] / state["b_psi"], ev.i)
    pred = torch.where(ev.valid, pred, 0.0)
    return masked_metrics(ev.x, pred, ev.real, ev.class_id, ev.n_classes, reduce)


class PoissonMF(FactorModel):
    """Plain and extended Poisson MF with the JAX package's fit/predict
    surface."""

    def fit(self, train_df, val_df=None, device=None, elbo_every: int = 0,
            resume_from=None, checkpoint_dir=None, checkpoint_every: int = 10,
            profile_dir=None, mesh=None, state_sharding=None):
        """``device``: None = the CUDA card (raises without one); "cpu"
        runs the kernels' plain versions on the host.  ``elbo_every=N``
        records the auxiliary-variable ELBO in fit_history every N
        iterations (0 = off).  ``resume_from``, ``checkpoint_dir``,
        ``checkpoint_every``, ``profile_dir``, ``mesh`` and
        ``state_sharding`` as in ``HPF.fit``."""
        cfg = self.config
        if self._check_sharding(state_sharding, mesh, elbo_every):
            from pmf_tpu_torch.parallel.tp import fit_tp, poisson_family

            return fit_tp(self, poisson_family(cfg), train_df, val_df, resume_from,
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
        precision = blocked_precision(engine)
        if precision is not None:
            # head_bytes: 2.5 GiB, the JAX package's tuned budget.
            self.blocked = blocked = self._blocked_layout(train_df, 5 << 29, mesh)
            if cfg.extended:
                u, i, x = as_triples(train_df)
                # Per-row rating sums: constant across iterations.
                sx_user, sx_item = (
                    torch.from_numpy(np.bincount(ids, weights=x, minlength=n)
                                     .astype(self._dtype)).to(self.device)
                    for ids, n in ((u, self.n_users), (i, self.n_items)))

                def sweep_fn(s, d):
                    return sweep_blocked_extended(
                        s, blocked, d.user_counts, d.item_counts, sx_user,
                        sx_item, cfg.a0, cfg.b0, precision=precision, reduce=reduce)
            else:

                def sweep_fn(s, d):
                    return sweep_blocked(s, blocked, d.user_counts,
                                         d.item_counts, cfg.a0, cfg.b0,
                                         precision=precision, reduce=reduce)
        else:

            def sweep_fn(s, d):
                return sweep(s, d, cfg.a0, cfg.b0, cfg.extended, reduce=reduce)

        def eval_fn(s, ev):
            return eval_metrics(s, ev, cfg.extended, reduce)

        val = self._build_eval(val_df, mesh) if val_df is not None else None
        loop = FitLoop(sweep_fn, eval_fn, cfg.max_iter, cfg.tol,
                       poisson_stop_rule,
                       name="PoissonMF" + ("-ext" if cfg.extended else ""),
                       checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every,
                       # extended walks each block's edges again for the scalars
                       edge_visits_per_iter=(4 if cfg.extended else 2) * data.nnz,
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
        from pmf_tpu_torch.eval.elbo import poisson_elbo

        cfg = self.config
        u, i, x, nc = self._elbo_edges(train)
        return lambda s: poisson_elbo(s, u, i, x, cfg.a0, cfg.b0,
                                      extended=cfg.extended, n_chunks=nc)

    def _point_estimates(self):
        return (self.state["a_theta"] / self.state["b_theta"],
                self.state["a_beta"] / self.state["b_beta"])

    def predict(self, user_ids, item_ids) -> np.ndarray:
        """Out-of-range (unseen) pairs predict 0; the extended prediction
        multiplies by E[phi] E[psi]."""
        preds = super().predict(user_ids, item_ids)
        if self.config.extended:
            scale = 1.0
            for ids, a, b in ((user_ids, "a_phi", "b_phi"), (item_ids, "a_psi", "b_psi")):
                E = (self.state[a] / self.state[b]).detach().cpu().numpy()
                # Clipped ids only meet pairs that already predict 0.
                scale = scale * E[np.clip(np.asarray(ids, dtype=np.int64), 0, len(E) - 1)]
            preds = preds * scale
        return preds
