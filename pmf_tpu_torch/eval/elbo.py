"""Evidence lower bounds for the CAVI families.

Gaussian MF: the exact mean-field ELBO of the conjugate model, with the
biases as point (MAP) coordinates whose Gaussian prior enters as a
penalty; the exact CAVI sweep is coordinate ascent on it, so it must not
decrease from sweep to sweep.

Poisson MF, its extended variant and HPF use the standard
auxiliary-variable bound (Jensen over per-edge multinomial allocations),
evaluated at the OPTIMAL allocations phi* ~ exp(E[log theta_k] +
E[log beta_k]): the tightest bound of this family for the current q.  The
sweeps allocate by ratios of means instead of geometric means, so
per-sweep monotonicity of this bound is empirical, not guaranteed.

The edge terms stream in chunks (no (nnz, K) intermediate at full size).
"""

from __future__ import annotations

import math

import torch

from pmf_tpu_torch.ops.segment import edge_dot, gather_rows

_LOG2PI = 1.8378770664093453


def _kl_gamma(a, b, a0: float, b0: float) -> torch.Tensor:
    """KL(Gamma(a, b) || Gamma(a0, b0)), summed over all entries."""
    return torch.sum(
        (a - a0) * torch.special.digamma(a)
        - torch.lgamma(a)
        + math.lgamma(a0)
        + a0 * (torch.log(b) - math.log(b0))
        + a * (b0 - b) / b
    )


def _kl_gaussian_full(m, V, eta2: float) -> torch.Tensor:
    """KL(N(m, V) || N(0, eta2 I)), summed over rows; V (R, K, K),
    symmetrized first as the JAX package's Cholesky does.  A V that is not
    positive definite gives NaN, as there (no check, so no host read)."""
    R, K = m.shape
    chol = torch.linalg.cholesky_ex(0.5 * (V + V.mT)).L
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1, dim2=2)))
    tr = torch.sum(torch.diagonal(V, dim1=1, dim2=2))
    sq = torch.sum(m * m)
    return 0.5 * ((tr + sq) / eta2 - R * K + R * K * math.log(eta2) - logdet)


def _kl_gaussian_diag(m, v, eta2: float) -> torch.Tensor:
    return 0.5 * torch.sum(v / eta2 + m * m / eta2 - 1.0 + math.log(eta2)
                           - torch.log(v))


def gaussian_elbo(state: dict, u, i, x, sigma2: float, eta_theta2: float,
                  eta_beta2: float, eta_bias2: float, use_bias: bool = True,
                  covariance: str = "full", n_chunks: int = 8) -> torch.Tensor:
    """Exact ELBO of the Gaussian mean-field posterior (biases as MAP
    coordinates); ``u``, ``i`` integer edge ids and ``x`` ratings on the
    centred scale used by fit(), on the state's device.  The edge term
    streams in ``n_chunks`` chunks and stays on the device: nothing is
    read to the host."""
    m_t, m_b = state["m_theta"], state["m_beta"]
    V_t, V_b = state["V_theta"], state["V_beta"]
    dtype, dev = m_t.dtype, m_t.device
    K = m_t.shape[1]
    nnz = u.shape[0]
    if covariance == "full":
        A_t = (V_t + m_t[:, :, None] * m_t[:, None, :]).reshape(-1, K * K)
        A_b = (V_b + m_b[:, :, None] * m_b[:, None, :]).reshape(-1, K * K)
    else:
        sq_t = V_t + m_t * m_t
        sq_b = V_b + m_b * m_b

    L = max(-(-nnz // n_chunks), 1)
    sum_sq = torch.zeros((), dtype=dtype, device=dev)
    for lo in range(0, nnz, L):
        cu, ci, cx = u[lo : lo + L], i[lo : lo + L], x[lo : lo + L]
        mu = gather_rows(m_t, cu)
        mi = gather_rows(m_b, ci)
        r = cx
        if use_bias:
            r = r - gather_rows(state["b_user"], cu) - gather_rows(state["b_item"], ci)
        pred = edge_dot(mu, mi)
        if covariance == "full":
            tr = edge_dot(gather_rows(A_t, cu), gather_rows(A_b, ci))
        else:
            # E[(theta^T beta)^2] under a fully factorized q:
            # sum_k sq_t sq_b + sum_{k != l} (m_t m_b)_k (m_t m_b)_l
            mm = mu * mi
            tr = (edge_dot(gather_rows(sq_t, cu), gather_rows(sq_b, ci))
                  + pred * pred - edge_dot(mm, mm))
        sum_sq = sum_sq + torch.sum(r * r - 2.0 * r * pred + tr)
    log_s2 = torch.log(torch.tensor(sigma2, dtype=dtype, device=dev))
    ll = -0.5 * nnz * (_LOG2PI + log_s2) - sum_sq / (2.0 * sigma2)

    if covariance == "full":
        kl = _kl_gaussian_full(m_t, V_t, eta_theta2) + _kl_gaussian_full(
            m_b, V_b, eta_beta2)
    else:
        kl = _kl_gaussian_diag(m_t, V_t, eta_theta2) + _kl_gaussian_diag(
            m_b, V_b, eta_beta2)
    elbo = ll - kl
    if use_bias:
        bu, bi = state["b_user"], state["b_item"]
        log_e2 = torch.log(torch.tensor(eta_bias2, dtype=dtype, device=dev))
        elbo = (elbo - torch.sum(bu * bu) / (2.0 * eta_bias2)
                - torch.sum(bi * bi) / (2.0 * eta_bias2)
                - 0.5 * (bu.shape[0] + bi.shape[0]) * (_LOG2PI + log_e2))
    return elbo


def _auto_chunks(nnz: int, width: int) -> int:
    """Chunk count keeping per-chunk gathered intermediates ~<= 64 MB."""
    per_chunk = max((1 << 24) // max(width, 1), 1 << 12)
    return max(8, -(-nnz // per_chunk))


def _poisson_edge_bound(Elog_t, Elog_b, E_t, E_b, u, i, x, extra_log=None,
                        extra_mean=None, n_chunks: int = 8) -> torch.Tensor:
    """sum_e [ x_e * (logsumexp_k(Elog terms) [+ extra_log_e])
               - E[lambda_e] ] - log Gamma(x_e + 1), streamed in chunks."""
    nnz = u.shape[0]
    L = max(-(-nnz // n_chunks), 1)
    out = torch.zeros((), dtype=E_t.dtype, device=E_t.device)
    for lo in range(0, nnz, L):
        cu, ci, cx = u[lo : lo + L], i[lo : lo + L], x[lo : lo + L]
        s = gather_rows(Elog_t, cu) + gather_rows(Elog_b, ci)  # (L, K)
        logz = torch.logsumexp(s, dim=1)
        lam = edge_dot(gather_rows(E_t, cu), gather_rows(E_b, ci))
        if extra_log is not None:
            logz = logz + extra_log[0][cu] + extra_log[1][ci]
            lam = lam * extra_mean[0][cu] * extra_mean[1][ci]
        out = out + torch.sum(cx * logz - lam - torch.lgamma(cx + 1.0))
    return out


def _elog(a, b):
    """E[log g] of g ~ Gamma(a, b)."""
    return torch.special.digamma(a) - torch.log(b)


def poisson_elbo(state: dict, u, i, x, a0: float, b0: float,
                 extended: bool = False, n_chunks: int = 8) -> torch.Tensor:
    """Auxiliary-variable ELBO of (extended) Poisson MF at the optimal
    per-edge allocations; ``u``, ``i`` integer edge ids and ``x`` ratings
    on the state's device."""
    a_t, b_t = state["a_theta"], state["b_theta"]
    a_b, b_b = state["a_beta"], state["b_beta"]
    extra_log = extra_mean = None
    kl = _kl_gamma(a_t, b_t, a0, b0) + _kl_gamma(a_b, b_b, a0, b0)
    if extended:
        a_p, b_p = state["a_phi"], state["b_phi"]
        a_s, b_s = state["a_psi"], state["b_psi"]
        extra_log = (_elog(a_p, b_p), _elog(a_s, b_s))
        extra_mean = (a_p / b_p, a_s / b_s)
        kl = kl + _kl_gamma(a_p, b_p, a0, b0) + _kl_gamma(a_s, b_s, a0, b0)
    ll = _poisson_edge_bound(_elog(a_t, b_t), _elog(a_b, b_b), a_t / b_t,
                             a_b / b_b, u, i, x, extra_log, extra_mean, n_chunks)
    return ll - kl


def hpf_elbo(state: dict, u, i, x, a: float, a_prime: float, b_prime: float,
             c: float, c_prime: float, d_prime: float,
             n_chunks: int = 8) -> torch.Tensor:
    """Auxiliary-variable ELBO of HPF (Gopalan et al. structure) at the
    optimal per-edge allocations, including the hierarchical xi/eta terms."""
    a_t, b_t = state["a_theta"], state["b_theta"]
    a_b, b_b = state["a_beta"], state["b_beta"]
    K = a_t.shape[1]
    b_xi, b_eta = state["b_xi"], state["b_eta"]
    # The xi/eta shapes are scalars, constant through training.
    a_xi = torch.tensor(a_prime + K * a, dtype=a_t.dtype, device=a_t.device)
    a_eta = torch.tensor(c_prime + K * c, dtype=a_t.dtype, device=a_t.device)

    Elog_t, Elog_b = _elog(a_t, b_t), _elog(a_b, b_b)
    E_t, E_b = a_t / b_t, a_b / b_b
    Elog_xi, E_xi = _elog(a_xi, b_xi), a_xi / b_xi
    Elog_eta, E_eta = _elog(a_eta, b_eta), a_eta / b_eta

    ll = _poisson_edge_bound(Elog_t, Elog_b, E_t, E_b, u, i, x, n_chunks=n_chunks)

    def gamma_entropy(sa, sb):
        return torch.sum(sa - torch.log(sb) + torch.lgamma(sa)
                         + (1.0 - sa) * torch.special.digamma(sa))

    # E log p(theta | a, xi) - E log q(theta)   (rate = xi_u per row)
    p_theta = torch.sum(a * Elog_xi[:, None] + (a - 1.0) * Elog_t
                        - E_xi[:, None] * E_t - math.lgamma(a))
    p_beta = torch.sum(c * Elog_eta[:, None] + (c - 1.0) * Elog_b
                       - E_eta[:, None] * E_b - math.lgamma(c))
    p_xi = torch.sum(a_prime * math.log(b_prime) + (a_prime - 1.0) * Elog_xi
                     - b_prime * E_xi - math.lgamma(a_prime))
    p_eta = torch.sum(c_prime * math.log(d_prime) + (c_prime - 1.0) * Elog_eta
                      - d_prime * E_eta - math.lgamma(c_prime))
    # + Gamma entropies (-E log q) for all four variational factor groups.
    return (ll + p_theta + p_beta + p_xi + p_eta
            + gamma_entropy(a_t, b_t) + gamma_entropy(a_b, b_b)
            + gamma_entropy(a_xi, b_xi) + gamma_entropy(a_eta, b_eta))

