"""The dense part of a blocked HPF-MAP step: kernel K10 and its plain version.

Per row of the parameter tables [theta | xi] and [beta | eta] (K+1
columns), given K9's sums of the step (``ops.map_grad``), one step computes
the frequency-scaled prior gradients, the softplus chain rule, Adam (the
update of ``ops.adam``) and the step's loss, and the softplus of the moved
tables that K9 reads at the next step.  It stands for the step body of the
JAX package's ``train_epoch_blocked``, which XLA fuses into one program.

``map_dense_step_plain`` is that arithmetic in PyTorch, as
``models/hpf_map.py::train_steps_grouped`` ran it before K10: the CPU's
path and the oracle.  ``dense_run`` holds the tables of one run of steps
(one grouping), checked once; ``map_dense_step`` moves them by one step:
on CUDA tables it launches K10 (``csrc/map_dense.cu``), one launch for both
tables, or raises; on CPU tables it runs the plain version.

On the card K10 updates the parameters and the Adam moments IN PLACE (the
JAX package's epoch donates them), writes the next softplus tables over the
ones K9 just read, and sets the accumulator rows it has read back to
zeros, so K9's accumulators are zeroed once a run and not every step.  The
step's loss goes into one float64 slot a block, summed once after the run:
no host read inside the loop of steps, no float atomics.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops.adam import B1, B2, adam_update

MAP_DENSE_LAUNCHES = _build.LaunchCounter()
ROWS_A_BLOCK = 32  # csrc/map_dense.cu: kRowsABlock, rows a block of K10 takes
KERNEL_TYPES = (torch.float32, torch.float64)  # the parameter types K10 takes


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) at every x (``torch.nn.functional.softplus``
    switches to the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_priors(theta, xi, beta, eta, cfg_scalars):
    """Per-row negative log-Gamma prior terms (lp_theta + lp_xi per user
    row, lp_beta + lp_eta per item row)."""
    a, a_prime, b_prime, c, c_prime, d_prime = cfg_scalars
    lp_theta = torch.sum(-a * torch.log(xi)[:, None] + xi[:, None] * theta
                         - (a - 1.0) * torch.log(theta), dim=1)
    lp_beta = torch.sum(-c * torch.log(eta)[:, None] + eta[:, None] * beta
                        - (c - 1.0) * torch.log(beta), dim=1)
    lp_xi = -(a_prime - 1.0) * torch.log(xi) + b_prime * xi
    lp_eta = -(c_prime - 1.0) * torch.log(eta) + d_prime * eta
    return lp_theta + lp_xi, lp_beta + lp_eta


def blocks_of(n_rows: int) -> int:
    """K10's blocks over a table of ``n_rows`` rows: its loss slots."""
    return -(-n_rows // ROWS_A_BLOCK)


def map_dense_step_plain(params, opt_state, u_sp, i_sp, acc_u, acc_i, user_scale,
                         item_scale, cfg_scalars, lr: float):
    """Plain K10: one step from K9's accumulators ``acc_u`` (n_users, K+2)
    and ``acc_i`` (n_items, K+1) and the softplus'd tables ``u_sp``,
    ``i_sp`` of ``params`` (in the step's working dtype).  Returns (new
    params, new Adam state, the step's loss as a 0-d tensor)."""
    a, a_prime, b_prime, c, c_prime, d_prime = cfg_scalars
    dt = params["user"].dtype
    K = u_sp.shape[1] - 1
    theta, xi = u_sp[:, :K], u_sp[:, K]
    beta, eta = i_sp[:, :K], i_sp[:, K]

    # Frequency-scaled prior gradients, dense and row-local: weight =
    # the row's count in this batch times 1/count(entity).
    wu = acc_u[:, K] * user_scale
    wi = acc_i[:, K] * item_scale
    g_theta = acc_u[:, :K] + wu[:, None] * (xi[:, None] - (a - 1.0) / theta)
    g_xi = wu * (-a * K / xi + theta.sum(1) - (a_prime - 1.0) / xi + b_prime)
    g_beta = acc_i[:, :K] + wi[:, None] * (eta[:, None] - (c - 1.0) / beta)
    g_eta = wi * (-c * K / eta + beta.sum(1) - (c_prime - 1.0) / eta + d_prime)
    # Softplus chain rule: d softplus(p) / dp = sigmoid(p).
    grads = {
        "user": (torch.cat([g_theta, g_xi[:, None]], 1)
                 * torch.sigmoid(params["user"].to(u_sp.dtype))).to(dt),
        "item": (torch.cat([g_beta, g_eta[:, None]], 1)
                 * torch.sigmoid(params["item"].to(i_sp.dtype))).to(dt),
    }
    lp_user, lp_item = log_priors(theta, xi, beta, eta, cfg_scalars)
    loss = (acc_u[:, K + 1].sum() + torch.sum(wu * lp_user)
            + torch.sum(wi * lp_item))
    params, opt_state = adam_update(grads, opt_state, params, lr)
    return params, opt_state, loss


@dataclasses.dataclass
class DenseRun:
    """The tables of one run of blocked steps.  ``u_sp``, ``i_sp``: the
    softplus of the parameters as they stand (K9's inputs, float32 on the
    card); ``acc``: K9's accumulators, on the card allocated once and kept
    zero between steps by K10, on the host None (K9 allocates each step's);
    ``loss``: on the card K10's float64 slots (a block each), on the host
    the running total; ``args``: on the card K10's pointer arguments and
    its host array of prior scalars, checked once."""

    params: dict
    opt_state: dict
    u_sp: torch.Tensor
    i_sp: torch.Tensor
    acc: tuple | None
    user_scale: torch.Tensor
    item_scale: torch.Tensor
    cfg_scalars: tuple
    lr: float
    loss: torch.Tensor
    args: tuple | None = None

    def result(self):
        """(params, Adam state, the run's loss as a 0-d tensor: on the
        card in float32, or float64 for float64 parameters)."""
        total = self.loss
        if self.args is not None:
            total = total.sum().to(torch.promote_types(torch.float32,
                                                       self.params["user"].dtype))
        return self.params, self.opt_state, total


def _priors(cfg_scalars, K: int):
    """The 12 Python floats K10 takes, as the plain version forms them: a
    side's a - 1, -a * K, a' - 1, b', -a, -(a' - 1) (users; then items
    with c, c', d'), in a ctypes array."""
    a, a_prime, b_prime, c, c_prime, d_prime = cfg_scalars
    vals = [v for s, s_p, r_p in ((a, a_prime, b_prime), (c, c_prime, d_prime))
            for v in (s - 1.0, -s * K, s_p - 1.0, r_p, -s, -(s_p - 1.0))]
    return (ctypes.c_double * len(vals))(*vals)


def _check_tables(params, state, user_scale, item_scale) -> None:
    """K10's checks of what it is given, made once a run: the parameters,
    both moments and the scales on one device, of one type K10 takes, of
    one K >= 1, each side's rows alike, contiguous."""
    dev, dt = params["user"].device, params["user"].dtype
    if dt not in KERNEL_TYPES:
        raise TypeError(f"K10 takes float32 or float64 parameters, got {dt}")
    if params["user"].dim() != 2:
        raise ValueError(f"params['user'] must be (n, K+1), got "
                         f"{tuple(params['user'].shape)}")
    k1 = params["user"].shape[1]
    _build.check_k(k1 - 1, "map-dense kernel (tables carry K+1 columns)")
    for side, scale in (("user", user_scale), ("item", item_scale)):
        n = params[side].shape[0]
        for name, t, shape in ((f"params['{side}']", params[side], (n, k1)),
                               (f"mu['{side}']", state["mu"][side], (n, k1)),
                               (f"nu['{side}']", state["nu"][side], (n, k1)),
                               (f"{side}_scale", scale, (n,))):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, the parameters on {dev}")
            if t.dtype != dt:
                raise TypeError(f"{name} must be {dt}, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def dense_run(params: dict, opt_state: dict, user_scale, item_scale, cfg_scalars,
              lr: float) -> DenseRun:
    """The tables of a run of steps from ``params`` and ``opt_state``
    (``ops.adam``'s): on the card the parameters and moments themselves
    (made contiguous; K10 moves them in place), the softplus tables and
    zeroed accumulators and loss slots, checked once; on the host the
    tables as given, the step's dtype the parameters'."""
    state = {"count": opt_state["count"], "mu": dict(opt_state["mu"]),
             "nu": dict(opt_state["nu"])}
    params = dict(params)
    if not params["user"].is_cuda:
        return DenseRun(params, state, softplus(params["user"]), softplus(params["item"]),
                        None, user_scale, item_scale, tuple(cfg_scalars), lr,
                        torch.zeros((), dtype=params["user"].dtype,
                                    device=params["user"].device))
    for tab in (params, state["mu"], state["nu"]):
        for k in ("user", "item"):
            tab[k] = tab[k].contiguous()
    _check_tables(params, state, user_scale, item_scale)
    dev, k1 = params["user"].device, params["user"].shape[-1]
    run = DenseRun(
        params, state, softplus(params["user"].to(torch.float32)),
        softplus(params["item"].to(torch.float32)),
        (torch.zeros((params["user"].shape[0], k1 + 1), device=dev),
         torch.zeros((params["item"].shape[0], k1), device=dev)),
        user_scale, item_scale, tuple(cfg_scalars), lr,
        torch.zeros(blocks_of(params["user"].shape[0]) + blocks_of(params["item"].shape[0]),
                    dtype=torch.float64, device=dev))
    priors = _priors(run.cfg_scalars, k1 - 1)
    ptr = [t.data_ptr() for t in (params["user"], state["mu"]["user"], state["nu"]["user"],
                                  run.acc[0], user_scale, run.u_sp)]
    ptr_i = [t.data_ptr() for t in (params["item"], state["mu"]["item"], state["nu"]["item"],
                                    run.acc[1], item_scale, run.i_sp)]
    run.args = ((*ptr, params["user"].shape[0], *ptr_i, params["item"].shape[0], k1 - 1,
                 int(params["user"].dtype == torch.float64), ctypes.addressof(priors),
                 run.loss.data_ptr()), priors)
    return run


def map_dense_step(run: DenseRun) -> None:
    """One step of ``run`` from its accumulators (K9's sums of the step):
    K10 on the card, one launch for both tables, which leaves the
    accumulators zero again; the plain version on the host."""
    if run.args is None:
        params, state, loss = map_dense_step_plain(
            run.params, run.opt_state, run.u_sp, run.i_sp, *run.acc, run.user_scale,
            run.item_scale, run.cfg_scalars, run.lr)
        run.params, run.opt_state, run.loss = params, state, run.loss + loss
        run.acc = None  # not cleared: the next step's K9 allocates its own
        run.u_sp, run.i_sp = softplus(params["user"]), softplus(params["item"])
        return
    count = run.opt_state["count"] + 1
    args, _ = run.args
    _build.launch_on("pmf_map_dense", MAP_DENSE_LAUNCHES, run.params["user"].device,
                     (*args, float(run.lr), 1.0 - B1 ** count, 1.0 - B2 ** count))
    run.opt_state["count"] = count
