"""Gaussian matrix factorization with mean-field CAVI, optional biases.

Model (the biased variant when ``use_bias``):
    r_ij ~ N(mu + b_i + b_j + theta_i^T beta_j, sigma^2)
    theta_i ~ N(0, eta_theta^2 I),  beta_j ~ N(0, eta_beta^2 I),
    b ~ N(0, eta_bias^2)

Each sweep runs the coordinate blocks in the order theta -> beta
[-> user bias -> item bias]; each block reads the previous block's fresh
values.  ``bias_update="lagged"`` runs theta -> b_user -> beta -> b_item
with b_user's interaction term against the previous betas, so the bias
statistics ride the factor passes.  ``covariance="diag"`` keeps diagonal
covariances (rows, K) with a per-coordinate update.  Rows with no
observations keep their values, unlike the Poisson family's reset.  The
state is a dict of tensors with the JAX package's keys.

Engines: "flat" uses gathers and ``index_add_`` segment sums over the
dual-sorted COO and a batched Cholesky; "blocked_high" runs the hybrid
layout through the CUDA kernels K3 (factor pass), K5 (bias pass), K6
(diag pass) and K4 (Gauss-Jordan inverse) on the card, or through their
plain versions on the CPU.  The JAX package's TPU tile settings
(``block_size``, ``chunk_size``, ``group``) are accepted and ignored: the
CSR tail has no tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pmf_tpu_torch.data.coo import EvalSet, RatingsCOO
from pmf_tpu_torch.eval.metrics import macro_mae, masked_metrics, rmse
from pmf_tpu_torch.models.base import (
    FactorModel,
    FitLoop,
    as_triples,
    blocked_precision,
    gaussian_stop_rule,
    reduced,
    resolve_engine,
)
from pmf_tpu_torch.ops.segment import edge_dot, gather_rows, sorted_segment_sum
from pmf_tpu_torch.ops.solve import batched_psd_inverse
from pmf_tpu_torch.utils.device import resolve_device

STATE_KEYS = ("m_theta", "V_theta", "m_beta", "V_beta", "b_user", "b_item")


@dataclasses.dataclass
class GaussianMFConfig:
    n_factors: int = 10
    sigma2: float = 1.0
    eta_theta2: float = 1.0
    eta_beta2: float = 1.0
    eta_bias2: float = 1.0
    max_iter: int = 20
    tol: Optional[float] = 1e-3
    random_state: int = 42
    verbose: bool = True
    use_bias: bool = True
    dtype: str = "float32"
    # "flat", "blocked_high" / "blocked_mid" / "blocked_fast" (the head
    # products at two bf16 parts or one) or "auto" (flat below 300k edges
    # or on the CPU); any other name runs flat, as in the JAX package.
    engine: str = "auto"
    # "full": K x K posterior covariances; "diag": (rows, K) diagonals.
    covariance: str = "full"
    # "exact": theta, beta, b_user, b_item; "lagged": theta, b_user, beta,
    # b_item with the bias statistics taken on the factor passes.
    bias_update: str = "exact"
    # TPU tile settings of the JAX package; the CSR tail ignores them.
    block_size: Optional[int] = None
    chunk_size: Optional[int] = None
    group: Optional[int] = None


def _init_state_numpy(n_users: int, n_items: int, cfg: GaussianMFConfig) -> dict:
    """Initial state as numpy arrays with the JAX package's draws:
    default_rng(seed), theta then beta standard normals scaled by 0.1,
    identity (or unit diagonal) covariances, zero biases."""
    rng = np.random.default_rng(cfg.random_state)
    K = cfg.n_factors
    dt = np.dtype(cfg.dtype)
    m_theta = (0.1 * rng.standard_normal((n_users, K))).astype(dt)
    m_beta = (0.1 * rng.standard_normal((n_items, K))).astype(dt)
    if cfg.covariance == "diag":
        v_theta = np.ones((n_users, K), dtype=dt)
        v_beta = np.ones((n_items, K), dtype=dt)
    else:
        eye = np.eye(K, dtype=dt)
        v_theta = np.broadcast_to(eye, (n_users, K, K))
        v_beta = np.broadcast_to(eye, (n_items, K, K))
    return {"m_theta": m_theta, "V_theta": v_theta, "m_beta": m_beta,
            "V_beta": v_beta, "b_user": np.zeros((n_users,), dtype=dt),
            "b_item": np.zeros((n_items,), dtype=dt)}


def state_from_numpy(state_np: dict, device=None, dtype=None) -> dict:
    """numpy state (the JAX package's keys) -> dict of tensors on
    ``device`` (None = the card)."""
    device = resolve_device(device)
    out = {}
    for k in STATE_KEYS:
        t = torch.from_numpy(np.array(state_np[k]))  # a writable copy
        out[k] = t.to(device=device, dtype=dtype if dtype is not None else t.dtype)
    return out


def state_to_numpy(state: dict) -> dict:
    """dict of tensors -> numpy state (host copies)."""
    return {k: state[k].detach().cpu().numpy() for k in STATE_KEYS}


def init_state(n_users: int, n_items: int, cfg: GaussianMFConfig,
               device=None) -> dict:
    return state_from_numpy(_init_state_numpy(n_users, n_items, cfg), device)


def _finish_factor(m_self, V_self, S_w, S_A, counts, eta2, sigma2, inverse):
    """m, V from the factor statistics: V = (I/eta^2 + S_A/sigma^2)^-1,
    m = V S_w / sigma^2; rows without observations keep their values."""
    K = m_self.shape[1]
    eye = torch.eye(K, dtype=m_self.dtype, device=m_self.device)
    V_new = inverse(eye / eta2 + S_A / sigma2)
    m_new = torch.einsum("rkl,rl->rk", V_new, S_w) / sigma2
    has = (counts > 0)[:, None]
    return (torch.where(has, m_new, m_self),
            torch.where(has[:, :, None], V_new, V_self))


def _finish_diag(m_self, v_self, S_mr, S_sq, S_mm, counts, eta2, sigma2):
    """Per-coordinate update from the diag statistics (Jacobi form):
    prec = 1/eta^2 + S_sq/sigma^2, m = (S_mr + m_self S_mm)/(sigma^2 prec)."""
    prec = 1.0 / eta2 + S_sq / sigma2
    m_new = (S_mr + m_self * S_mm) / (sigma2 * prec)
    has = (counts > 0)[:, None]
    return torch.where(has, m_new, m_self), torch.where(has, 1.0 / prec, v_self)


def _factor_block(m_self, V_self, m_other, V_other, b_self, b_other, self_ids,
                  other_ids, x, counts, eta2, sigma2, n_self, use_bias, reduce=None):
    """One full-covariance factor block over the flat COO (edges sorted by
    ``self_ids``); ``reduce`` sums its statistics over a mesh.  Returns
    updated (m_self, V_self)."""
    K = m_self.shape[1]
    A_other = V_other + m_other[:, :, None] * m_other[:, None, :]
    A_edges = gather_rows(A_other.reshape(-1, K * K), other_ids)
    S_A = sorted_segment_sum(A_edges, self_ids, n_self).reshape(n_self, K, K)
    m_other_e = gather_rows(m_other, other_ids)
    resid = (x - gather_rows(b_self, self_ids) - gather_rows(b_other, other_ids)
             if use_bias else x)
    S_w = sorted_segment_sum(m_other_e * resid[:, None], self_ids, n_self)
    S_w, S_A = reduced(reduce, S_w, S_A)
    return _finish_factor(m_self, V_self, S_w, S_A, counts, eta2, sigma2,
                          batched_psd_inverse)


def _factor_block_diag(m_self, v_self, m_other, v_other, b_self, b_other,
                       self_ids, other_ids, x, counts, eta2, sigma2, n_self,
                       use_bias, reduce=None):
    """Diagonal-covariance factor block: coordinate k's update given the
    other coordinates' current means (the cross terms)."""
    m_other_e = gather_rows(m_other, other_ids)
    sq_e = gather_rows(v_other + m_other * m_other, other_ids)
    resid = (x - gather_rows(b_self, self_ids) - gather_rows(b_other, other_ids)
             if use_bias else x)
    pred = edge_dot(gather_rows(m_self, self_ids), m_other_e)
    S_sq = sorted_segment_sum(sq_e, self_ids, n_self)
    S_mr = sorted_segment_sum(m_other_e * (resid - pred)[:, None], self_ids, n_self)
    S_mm = sorted_segment_sum(m_other_e * m_other_e, self_ids, n_self)
    S_mr, S_sq, S_mm = reduced(reduce, S_mr, S_sq, S_mm)
    return _finish_diag(m_self, v_self, S_mr, S_sq, S_mm, counts, eta2, sigma2)


def _bias_update(b_self, s, counts, eta_bias2, sigma2):
    """Closed-form bias update from the residual sums s: precision
    1/eta_b^2 + N/sigma^2; rows without observations keep their values."""
    prec = 1.0 / eta_bias2 + counts / sigma2
    return torch.where(counts > 0, s / (prec * sigma2), b_self)


def _bias_block(b_self, b_other, m_self, m_other, self_ids, other_ids, x,
                counts, eta_bias2, sigma2, n_self, reduce=None):
    """Scalar bias block on the residual r - b_other - <theta, beta>."""
    interaction = edge_dot(gather_rows(m_self, self_ids),
                           gather_rows(m_other, other_ids))
    resid = x - gather_rows(b_other, other_ids) - interaction
    (s,) = reduced(reduce, sorted_segment_sum(resid, self_ids, n_self))
    return _bias_update(b_self, s, counts, eta_bias2, sigma2)


def _bias_block_lagged(b_self, m_self_new, S_m, S_x, S_b, counts, eta_bias2,
                       sigma2):
    """Bias block from row-level sums: s = S_x - S_b - <m_self, S_m>."""
    s = S_x - S_b - torch.sum(m_self_new * S_m, dim=1)
    return _bias_update(b_self, s, counts, eta_bias2, sigma2)


def sweep(state: dict, data: RatingsCOO, sigma2: float, eta_theta2: float,
          eta_beta2: float, eta_bias2: float, use_bias: bool,
          covariance: str = "full", bias_update: str = "exact",
          reduce=None) -> dict:
    """One CAVI iteration over the flat dual-sorted COO.  ``reduce``: under a
    data-parallel mesh, the sum of the statistics over the ranks' shares of
    the edges (``parallel.mesh``)."""
    block = _factor_block if covariance == "full" else _factor_block_diag
    lagged = use_bias and bias_update == "lagged"
    by_u = (data.u_by_u, data.i_by_u, data.x_by_u)
    by_i = (data.i_by_i, data.u_by_i, data.x_by_i)
    m_theta, V_theta = block(
        state["m_theta"], state["V_theta"], state["m_beta"], state["V_beta"],
        state["b_user"], state["b_item"], *by_u, data.user_counts, eta_theta2,
        sigma2, data.n_users, use_bias, reduce)
    b_user, b_item = state["b_user"], state["b_item"]
    if lagged:
        S_m_u = sorted_segment_sum(gather_rows(state["m_beta"], data.i_by_u),
                                   data.u_by_u, data.n_users)
        S_b_u = sorted_segment_sum(gather_rows(b_item, data.i_by_u),
                                   data.u_by_u, data.n_users)
        S_x_u = sorted_segment_sum(data.x_by_u, data.u_by_u, data.n_users)
        S_m_u, S_b_u, S_x_u = reduced(reduce, S_m_u, S_b_u, S_x_u)
        b_user = _bias_block_lagged(b_user, m_theta, S_m_u, S_x_u, S_b_u,
                                    data.user_counts, eta_bias2, sigma2)
    m_beta, V_beta = block(
        state["m_beta"], state["V_beta"], m_theta, V_theta, state["b_item"],
        b_user, *by_i, data.item_counts, eta_beta2, sigma2, data.n_items,
        use_bias, reduce)
    if lagged:
        S_m_i = sorted_segment_sum(gather_rows(m_theta, data.u_by_i),
                                   data.i_by_i, data.n_items)
        S_b_i = sorted_segment_sum(gather_rows(b_user, data.u_by_i),
                                   data.i_by_i, data.n_items)
        S_x_i = sorted_segment_sum(data.x_by_i, data.i_by_i, data.n_items)
        S_m_i, S_b_i, S_x_i = reduced(reduce, S_m_i, S_b_i, S_x_i)
        b_item = _bias_block_lagged(b_item, m_beta, S_m_i, S_x_i, S_b_i,
                                    data.item_counts, eta_bias2, sigma2)
    elif use_bias:
        b_user = _bias_block(b_user, b_item, m_theta, m_beta, *by_u,
                             data.user_counts, eta_bias2, sigma2, data.n_users,
                             reduce)
        b_item = _bias_block(b_item, b_user, m_beta, m_theta, *by_i,
                             data.item_counts, eta_bias2, sigma2, data.n_items,
                             reduce)
    return {"m_theta": m_theta, "V_theta": V_theta, "m_beta": m_beta,
            "V_beta": V_beta, "b_user": b_user, "b_item": b_item}


def sweep_blocked(state: dict, blocked, user_counts: torch.Tensor,
                  item_counts: torch.Tensor, sigma2: float, eta_theta2: float,
                  eta_beta2: float, eta_bias2: float, use_bias: bool,
                  covariance: str = "full", bias_update: str = "exact",
                  precision: str = "high", reduce=None) -> dict:
    """Same iteration as :func:`sweep` over the hybrid layout
    (``data.blocked.BlockedCOO``): the edge passes by kernels K3 (factor),
    K5 (bias) and K6 (diag) on the tail plus the head's linear products,
    the K x K inverses by kernel K4.  Lagged biases ride the factor
    passes (K3's bias columns), so that mode runs no bias pass.
    ``precision`` ("fast" or "high") sets the head products' bf16
    parts; the tail kernels and K4 run in float32 at every precision.
    Under a data-parallel mesh ``blocked`` is the rank's band
    (``parallel.mesh.shard_blocked``) and ``reduce`` sums the statistics
    before each update; the inverses are every rank's own, replicated."""
    from pmf_tpu_torch.ops.gaussian_edge import (
        gaussian_bias_stats,
        gaussian_diag_stats,
        gaussian_factor_stats,
    )
    from pmf_tpu_torch.ops.gj_inverse import batched_psd_inverse_gj

    head = blocked.head
    if covariance == "diag" and bias_update == "lagged" and use_bias:
        raise ValueError(
            "bias_update='lagged' requires covariance='full' in the blocked "
            "engine (the diag pass carries no bias statistics); use the flat "
            "engine for lagged diag mode")

    def factor_update(m_old, V_old, S_w, S_A, counts, eta2):
        return _finish_factor(m_old, V_old, S_w, S_A, counts, eta2, sigma2,
                              batched_psd_inverse_gj)

    def diag_block(m_self, v_self, m_other, v_other, b_self, b_other, pass_,
                   counts, eta2, side):
        S_mr, S_sq, S_mm = gaussian_diag_stats(
            m_other, v_other, m_self, b_self, b_other, pass_, use_bias=use_bias,
            head=head, head_side=side, precision=precision)
        S_mr, S_sq, S_mm = reduced(reduce, S_mr, S_sq, S_mm)
        return _finish_diag(m_self, v_self, S_mr, S_sq, S_mm, counts, eta2, sigma2)

    b_user, b_item = state["b_user"], state["b_item"]
    lagged = False
    if covariance == "diag":
        m_theta, V_theta = diag_block(
            state["m_theta"], state["V_theta"], state["m_beta"], state["V_beta"],
            b_user, b_item, blocked.by_user, user_counts, eta_theta2, "user")
        m_beta, V_beta = diag_block(
            state["m_beta"], state["V_beta"], m_theta, V_theta, b_item, b_user,
            blocked.by_item, item_counts, eta_beta2, "item")
    elif use_bias and bias_update == "lagged":
        lagged = True
        S_w, S_A, S_m_u, S_x_u, S_b_u = gaussian_factor_stats(
            state["m_beta"], state["V_beta"], b_user, b_item, blocked.by_user,
            use_bias=True, with_bias_stats=True, head=head, head_side="user",
            precision=precision)
        S_w, S_A, S_m_u, S_x_u, S_b_u = reduced(reduce, S_w, S_A, S_m_u, S_x_u, S_b_u)
        m_theta, V_theta = factor_update(state["m_theta"], state["V_theta"],
                                         S_w, S_A, user_counts, eta_theta2)
        b_user = _bias_block_lagged(b_user, m_theta, S_m_u, S_x_u, S_b_u,
                                    user_counts, eta_bias2, sigma2)
        S_w_i, S_A_i, S_m_i, S_x_i, S_b_i = gaussian_factor_stats(
            m_theta, V_theta, b_item, b_user, blocked.by_item, use_bias=True,
            with_bias_stats=True, head=head, head_side="item", precision=precision)
        S_w_i, S_A_i, S_m_i, S_x_i, S_b_i = reduced(reduce, S_w_i, S_A_i, S_m_i,
                                                    S_x_i, S_b_i)
        m_beta, V_beta = factor_update(state["m_beta"], state["V_beta"],
                                       S_w_i, S_A_i, item_counts, eta_beta2)
        b_item = _bias_block_lagged(b_item, m_beta, S_m_i, S_x_i, S_b_i,
                                    item_counts, eta_bias2, sigma2)
    else:
        S_w, S_A = gaussian_factor_stats(
            state["m_beta"], state["V_beta"], b_user, b_item, blocked.by_user,
            use_bias=use_bias, head=head, head_side="user", precision=precision)
        S_w, S_A = reduced(reduce, S_w, S_A)
        m_theta, V_theta = factor_update(state["m_theta"], state["V_theta"],
                                         S_w, S_A, user_counts, eta_theta2)
        S_w_i, S_A_i = gaussian_factor_stats(
            m_theta, V_theta, b_item, b_user, blocked.by_item,
            use_bias=use_bias, head=head, head_side="item", precision=precision)
        S_w_i, S_A_i = reduced(reduce, S_w_i, S_A_i)
        m_beta, V_beta = factor_update(state["m_beta"], state["V_beta"],
                                       S_w_i, S_A_i, item_counts, eta_beta2)

    if use_bias and not lagged:
        s_u = gaussian_bias_stats(m_theta, m_beta, b_item, blocked.by_user,
                                  head=head, head_side="user", precision=precision)
        (s_u,) = reduced(reduce, s_u)
        b_user = _bias_update(b_user, s_u, user_counts, eta_bias2, sigma2)
        s_i = gaussian_bias_stats(m_beta, m_theta, b_user, blocked.by_item,
                                  head=head, head_side="item", precision=precision)
        (s_i,) = reduced(reduce, s_i)
        b_item = _bias_update(b_item, s_i, item_counts, eta_bias2, sigma2)
    return {"m_theta": m_theta, "V_theta": V_theta, "m_beta": m_beta,
            "V_beta": V_beta, "b_user": b_user, "b_item": b_item}


def eval_metrics(state: dict, ev: EvalSet, use_bias: bool, reduce=None):
    """Centred-scale (val RMSE, val macro-MAE) over in-range rows, as 0-d
    tensors on the state's device; ``reduce`` sums them over a mesh's
    shares of the rows (``eval.metrics.masked_metrics``)."""
    pred = edge_dot(gather_rows(state["m_theta"], ev.u),
                    gather_rows(state["m_beta"], ev.i))
    if use_bias:
        pred = (pred + gather_rows(state["b_user"], ev.u)
                + gather_rows(state["b_item"], ev.i))
    return masked_metrics(ev.x, pred, ev.valid, ev.class_id, ev.n_classes, reduce)


class GaussianMF(FactorModel):
    """Gaussian CAVI with the JAX package's fit/predict surface."""

    def __init__(self, config: GaussianMFConfig):
        super().__init__(config)
        self.global_mean = 0.0

    def fit(self, train_df, val_df=None, global_mean: float = 0.0, device=None,
            elbo_every: int = 0, resume_from=None, checkpoint_dir=None,
            checkpoint_every: int = 10, profile_dir=None, mesh=None,
            state_sharding=None):
        """Ratings are centred by the caller (``global_mean`` is recorded).
        ``device``: None = the CUDA card (raises without one); "cpu" runs
        the kernels' plain versions on the host.  ``elbo_every=N`` records
        the exact mean-field ELBO every N iterations (0 = off) and gates it
        non-decreasing: the exact block order is coordinate ascent on it
        (relative slack 1e-6 on "flat", 1e-4 on the blocked engines, whose
        statistics round differently; no gate for lagged biases).
        ``resume_from``, ``checkpoint_dir``, ``checkpoint_every``,
        ``profile_dir``, ``mesh`` and ``state_sharding`` as in ``HPF.fit``;
        a row-sharded fit takes lagged biases only on a blocked engine with
        full covariances, as the JAX package's."""
        cfg = self.config
        self.global_mean = float(global_mean)
        if self._check_sharding(state_sharding, mesh, elbo_every):
            from pmf_tpu_torch.parallel.tp import fit_tp, gaussian_family

            return fit_tp(self, gaussian_family(cfg), train_df, val_df, resume_from,
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
        hyper = (cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2, cfg.eta_bias2,
                 cfg.use_bias)
        modes = dict(covariance=cfg.covariance, bias_update=cfg.bias_update)
        precision = blocked_precision(engine)
        if precision is not None:
            # head_bytes: 3.75 GiB, the JAX package's Gaussian budget
            # (centred ratings carry an x_lo plane, 6 B a cell).
            self.blocked = blocked = self._blocked_layout(train_df, 15 << 28, mesh)

            def sweep_fn(s, d):
                return sweep_blocked(s, blocked, d.user_counts, d.item_counts,
                                     *hyper, **modes, precision=precision,
                                     reduce=reduce)
        else:

            def sweep_fn(s, d):
                return sweep(s, d, *hyper, **modes, reduce=reduce)

        val = self._build_eval(val_df, mesh) if val_df is not None else None
        loop = FitLoop(sweep_fn, lambda s, ev: eval_metrics(s, ev, cfg.use_bias, reduce),
                       cfg.max_iter, cfg.tol, gaussian_stop_rule, name="GaussianMF",
                       checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every,
                       # theta + beta passes, plus the two bias passes
                       edge_visits_per_iter=(4 if cfg.use_bias else 2) * data.nnz,
                       elbo_every=elbo_every or 1,
                       elbo_monotone=(None if cfg.bias_update == "lagged"
                                      else 1e-6 if precision is None else 1e-4),
                       **self._mesh_loop_args(
                           mesh, cfg.verbose, profile_dir,
                           self._make_elbo_fn(train_df) if elbo_every else None))
        self.state = loop.run(state, data, val)
        self.fit_history = loop.history
        self.n_sweeps = loop.n_sweeps
        self.sweep_once = lambda s: sweep_fn(s, data)
        return self

    def _make_elbo_fn(self, train):
        """state -> exact mean-field ELBO over the (centred) train edges."""
        from pmf_tpu_torch.eval.elbo import gaussian_elbo

        cfg = self.config
        width = cfg.n_factors ** 2 if cfg.covariance == "full" else cfg.n_factors
        u, i, x, nc = self._elbo_edges(train, width)
        return lambda s: gaussian_elbo(
            s, u, i, x, cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2, cfg.eta_bias2,
            use_bias=cfg.use_bias, covariance=cfg.covariance, n_chunks=nc)

    def _point_estimates(self):
        return self.state["m_theta"], self.state["m_beta"]

    def _score_offsets(self):
        """With biases the ranking depends on b_item, and the reported
        score includes the mean and b_user, as predict() does."""
        if not self.config.use_bias:
            return None, None, self.global_mean
        return self.state["b_user"], self.state["b_item"], self.global_mean

    def predict(self, user_ids, item_ids, global_mean: float = 0.0) -> np.ndarray:
        """Out-of-range (unseen) pairs predict ``global_mean``."""
        u = np.asarray(user_ids, dtype=np.int64)
        i = np.asarray(item_ids, dtype=np.int64)
        valid = (u < self.n_users) & (i < self.n_items) & (u >= 0) & (i >= 0)
        theta = self.state["m_theta"].detach().cpu().double().numpy()
        beta = self.state["m_beta"].detach().cpu().double().numpy()
        preds = np.zeros(len(u), dtype=np.float64)
        if valid.any():
            p = np.sum(theta[u[valid]] * beta[i[valid]], axis=1)
            if self.config.use_bias:
                bu = self.state["b_user"].detach().cpu().double().numpy()
                bi = self.state["b_item"].detach().cpu().double().numpy()
                p = p + bu[u[valid]] + bi[i[valid]]
            preds[valid] = p
        return preds + global_mean

    def _in_range(self, df, global_mean):
        u, i, x = as_triples(df)
        mask = (u < self.n_users) & (i < self.n_items)
        if not mask.any():
            return None
        return x[mask] + global_mean, self.predict(u[mask], i[mask], global_mean)

    def evaluate_rmse(self, df, global_mean: float = 0.0) -> float:
        pair = self._in_range(df, global_mean)
        return float("nan") if pair is None else rmse(*pair)

    def evaluate_macro_mae(self, df, global_mean: float = 0.0) -> float:
        pair = self._in_range(df, global_mean)
        return float("nan") if pair is None else macro_mae(*pair)
