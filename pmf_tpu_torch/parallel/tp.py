"""Tensor-parallel training: row-sharded factor state with ring sweeps.

The port of ``pmf_tpu/parallel/tp.py``.  Each rank of the ring owns a
contiguous range of ``users_per`` balanced user rows and ``items_per``
item rows and holds only those rows of the state for the whole fit.  The
edges of a direction are cut into D buckets a rank: bucket s of rank d
holds d's edges whose OTHER row lives on rank (d + s) % D, sorted by self
row.  A coordinate block runs D ring steps: step s consumes bucket s
against the visiting table, then every rank sends the table it holds to
rank d - 1 and receives rank d + 1's (``dist.batch_isend_irecv`` in the
ring's group), so at step s rank d holds shard (d + s) % D.  The final
step does not rotate.  The flat ring sums each step's edges with
``index_add_`` and runs no kernel; ``parallel.tp_blocked`` runs the
kernels inside the same ring.

Row ownership is count-balanced (``balance_perms``): rows are dealt to the
ranks round-robin in descending count order, the JAX package's deal, so
both packages put every row on the same rank.  On a ("data", "model")
mesh (``make_mesh_2d``) the ring runs over "model", each bucket's edges
are dealt round-robin over "data" (``_dp_split``'s order), and the ring's
accumulators are summed over the data axis once a pass.

The fits (``fit(mesh=, state_sharding="rows")``, ``fit_tp``) keep the
state in balanced row order, padded to a multiple of D rows; validation
gathers the point-estimate tables over the ring (means only, never the
covariances) and sums the metrics of each rank's share of the rows; at the
end the state is gathered, unpermuted and cut to the real rows on every
rank.  Checkpoints are the JAX package's TP form: the padded, balanced
state, gathered and written by rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from pmf_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, shard_eval_set


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def ring_axis(mesh: Mesh) -> str:
    """The axis the ring rotates over: "model" on a 2-D mesh, else "data"."""
    return MODEL_AXIS if MODEL_AXIS in mesh.axis_names else DATA_AXIS


def tp_degree(mesh: Mesh) -> int:
    """Ring length: the number of row shards."""
    return mesh.shape[ring_axis(mesh)]


def dp_degree(mesh: Mesh) -> int:
    """Edge-parallel replicas per row shard (1 on a 1-D mesh)."""
    return mesh.dp if MODEL_AXIS in mesh.axis_names else 1


def ring_index(mesh: Mesh) -> int:
    """This rank's row shard."""
    return mesh.coords[ring_axis(mesh)]


def dp_index(mesh: Mesh) -> int:
    """This rank's edge share within its row shard."""
    return mesh.coords[DATA_AXIS] if MODEL_AXIS in mesh.axis_names else 0


def describe_tp(mesh: Mesh) -> str:
    """Mesh role string for the models' verbose prints."""
    dp = dp_degree(mesh)
    return f"(TP ring {tp_degree(mesh)}" + (f" x DP {dp}" if dp > 1 else "") + ")"


def sum_dp(mesh: Mesh, *accs: torch.Tensor) -> list:
    """The ring's accumulators summed over the data axis of a hybrid mesh
    (each replica consumed its share of every bucket); as they are
    otherwise."""
    return mesh.sum(*accs, axis=DATA_AXIS) if dp_degree(mesh) > 1 else list(accs)


def _hop(tables: list, mesh: Mesh) -> list:
    """One ring hop: send the tables to ring index d - 1, receive d + 1's
    (one message of their flat concatenation)."""
    ax = ring_axis(mesh)
    ranks, D, d = mesh.ranks(ax), tp_degree(mesh), ring_index(mesh)
    send = torch.cat([t.reshape(-1) for t in tables])
    recv = torch.empty_like(send)
    group = mesh.group(ax)
    ops = [dist.P2POp(dist.isend, send, ranks[(d - 1) % D], group),
           dist.P2POp(dist.irecv, recv, ranks[(d + 1) % D], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out, at = [], 0
    for t in tables:
        out.append(recv[at : at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def ring(tables: list, body: Callable, mesh: Mesh) -> None:
    """D ring steps: ``body(s, tables)`` consumes bucket s against the
    visiting tables, then the tables rotate one hop.  The last step does
    not rotate (its hop would be discarded); with D = 1 there is no hop."""
    D = tp_degree(mesh)
    for s in range(D):
        body(s, tables)
        if s < D - 1:
            tables = _hop(tables, mesh)


# ------------------------------------------------------------- layout --

@dataclasses.dataclass(frozen=True)
class TPBucket:
    """One (rank, ring step) bucket of one direction, in local rows: self
    ids in [0, self_per), other ids in [0, other_per) of the visiting
    shard, sorted by self row."""

    self_loc: torch.Tensor  # (n,) int64
    other_loc: torch.Tensor  # (n,) int64
    x: torch.Tensor  # (n,) ratings


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """This rank's buckets of the flat ring: ``by_user[s]`` (user rows
    self), ``by_item[s]`` (item rows self), and its rows' observation
    counts (``users_per`` and ``items_per``)."""

    by_user: tuple
    by_item: tuple
    user_counts: torch.Tensor
    item_counts: torch.Tensor
    n_users: int
    n_items: int
    n_users_pad: int
    n_items_pad: int
    users_per: int
    items_per: int
    n_devices: int
    nnz: int

    @property
    def n_buckets(self) -> int:
        return len(self.by_user) + len(self.by_item)


def _dp_split(arrays, dp: int, p: int) -> list:
    """Replica p's round-robin share of a bucket's edges over the data axis
    (every dp-th edge from the p-th: strided slices of a self-sorted bucket
    stay self-sorted)."""
    return [a[p::dp] for a in arrays]


def _bucketize(self_ids, other_ids, x, self_per, other_per, D, d, dp, p, device):
    """Rank d's D buckets of one direction (self-sorted, edge order kept
    among ties); with dp > 1 replica p's round-robin share of each."""
    own = self_ids // self_per == d
    s, o, xv = self_ids[own], other_ids[own], x[own]
    step = (o // other_per - d) % D
    order = np.lexsort((s, step))
    s, o, xv, step = s[order], o[order], xv[order], step[order]
    bounds = np.searchsorted(step, np.arange(D + 1))
    out = []
    for st in range(D):
        sl = slice(bounds[st], bounds[st + 1])
        part = _dp_split((s[sl] - d * self_per, o[sl] % other_per, xv[sl]), dp, p)
        out.append(TPBucket(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                              for a in part)))
    return tuple(out)


def build_tp_layout(u, i, x, n_users: int, n_items: int, mesh: Mesh,
                    dtype=np.float32) -> TPLayout:
    """This rank's share of the bucketed dual layout, on the mesh's device.
    Every rank calls it with the same edges (ids already balanced)."""
    u = np.asarray(u, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    x = np.asarray(x, dtype=dtype)
    D, dp, d, p = tp_degree(mesh), dp_degree(mesh), ring_index(mesh), dp_index(mesh)
    users_per = _round_up(n_users, D) // D
    items_per = _round_up(n_items, D) // D
    dev = mesh.device
    own_u = slice(d * users_per, (d + 1) * users_per)
    own_i = slice(d * items_per, (d + 1) * items_per)

    def counts(ids, n, own):
        return torch.from_numpy(np.bincount(ids, minlength=n)[own].astype(dtype)).to(dev)

    return TPLayout(
        by_user=_bucketize(u, i, x, users_per, items_per, D, d, dp, p, dev),
        by_item=_bucketize(i, u, x, items_per, users_per, D, d, dp, p, dev),
        user_counts=counts(u, users_per * D, own_u),
        item_counts=counts(i, items_per * D, own_i),
        n_users=n_users, n_items=n_items, n_users_pad=users_per * D,
        n_items_pad=items_per * D, users_per=users_per, items_per=items_per,
        n_devices=D, nnz=int(len(u)))


# ------------------------------------------------- balanced ownership --

@dataclasses.dataclass(frozen=True)
class BalancePerms:
    """Count-balanced global row permutations for TP ownership: rows dealt
    to the ranks round-robin in descending count order, new_id = (rank % D)
    * per + rank // D, so each rank receives every D-th rank of the
    popularity order.  ``u_old_of_new[n]`` is the original padded user row
    stored at balanced row n, ``u_new_of_old`` its inverse (likewise
    items).  A pure function of (ids, n_pad, D): resume re-derives it."""

    u_old_of_new: np.ndarray
    u_new_of_old: np.ndarray
    i_old_of_new: np.ndarray
    i_new_of_old: np.ndarray


def _balance_one(ids: np.ndarray, n_pad: int, D: int):
    per = n_pad // D
    counts = np.bincount(ids, minlength=n_pad)
    order = np.argsort(-counts, kind="stable").astype(np.int64)  # rank -> old
    rank = np.arange(n_pad, dtype=np.int64)
    new_ids = (rank % D) * per + rank // D  # rank -> new
    new_of_old = np.empty(n_pad, np.int32)
    old_of_new = np.empty(n_pad, np.int32)
    new_of_old[order] = new_ids
    old_of_new[new_ids] = order
    return old_of_new, new_of_old


def balance_perms(u, i, n_users_pad: int, n_items_pad: int, D: int) -> BalancePerms:
    """The count-balanced global row permutations of the training edges
    (see :class:`BalancePerms`), equal to the JAX package's."""
    uo, un = _balance_one(np.asarray(u), n_users_pad, D)
    io_, in_ = _balance_one(np.asarray(i), n_items_pad, D)
    return BalancePerms(u_old_of_new=uo, u_new_of_old=un, i_old_of_new=io_,
                        i_new_of_old=in_)


def permute_state_rows(state: dict, axis_of: dict, u_perm, i_perm) -> dict:
    """Row-gather every state array by the given permutation (old -> new
    with ``*_old_of_new``; ``*_new_of_old`` inverts).  Numpy arrays or
    tensors; shapes already padded."""
    def take(v, perm):
        if isinstance(v, torch.Tensor):
            return v[torch.from_numpy(np.asarray(perm, np.int64)).to(v.device)]
        return v[perm]

    return {k: take(v, u_perm if axis_of[k] == "u" else i_perm) for k, v in state.items()}


def remap_eval(ev, u_new_of_old, i_new_of_old):
    """An EvalSet's row ids in the balanced row space.  Ids at or past the
    padded row count (unseen users or items, which predict as the model's
    out-of-range value through ``valid``) pass through unchanged."""

    def one(ids, perm):
        perm = torch.from_numpy(np.asarray(perm, np.int64)).to(ids.device)
        ids = ids.long()
        safe = ids.clamp(0, perm.shape[0] - 1)
        return torch.where(ids < perm.shape[0], perm[safe], ids).to(torch.int32)

    return dataclasses.replace(ev, u=one(ev.u, u_new_of_old), i=one(ev.i, i_new_of_old))


def pad_state_rows(state: dict, axis_of: dict, n_users_pad: int, n_items_pad: int,
                   ones_keys=()) -> dict:
    """Pad each numpy state array's leading (row) dimension to the
    mesh-aligned size; keys in ``ones_keys`` pad with 1.0 (rate
    denominators: zero padding would make the padded rows' expectations
    0/0)."""
    out = {}
    for k, v in state.items():
        target = n_users_pad if axis_of[k] == "u" else n_items_pad
        pad = target - v.shape[0]
        if pad:
            fill = np.ones if k in ones_keys else np.zeros
            v = np.concatenate([v, fill((pad,) + v.shape[1:], v.dtype)], axis=0)
        out[k] = v
    return out


def slice_state_rows(state: dict, axis_of: dict, n_users: int, n_items: int) -> dict:
    return {k: v[: (n_users if axis_of[k] == "u" else n_items)] for k, v in state.items()}


def place_tp(state: dict, axis_of: dict, mesh: Mesh) -> dict:
    """The rank's rows of a padded, balanced state (numpy or tensors): ring
    index d holds rows [d * per, (d + 1) * per) of each array, as tensors
    on the mesh's device (replicated over "data" on a hybrid mesh).  The
    layouts are built on the rank's device already (``build_tp_layout``,
    ``tp_blocked.build_tp_blocked``), so this is all the placement left."""
    D, d = tp_degree(mesh), ring_index(mesh)
    out = {}
    for k, v in state.items():
        per = v.shape[0] // D
        t = v[d * per : (d + 1) * per]
        t = torch.from_numpy(np.array(t)) if isinstance(t, np.ndarray) else t
        out[k] = t.to(mesh.device).contiguous().clone()
    return out


def gather_state(state: dict, mesh: Mesh, keys=None) -> dict:
    """The full padded, balanced state (``keys`` of it, all when None) on
    every rank: each array gathered over the ring."""
    ax = ring_axis(mesh)
    return {k: mesh.gather(state[k], ax) for k in (keys or state)}


def state_from_jax_tp(state_np: dict, axis_of: dict, mesh: Mesh) -> dict:
    """The JAX package's TP state (numpy arrays, mesh-padded rows in
    balanced order, as its checkpoints hold it) as this rank's shards of
    the port's TP state."""
    return place_tp({k: np.asarray(v) for k, v in state_np.items()}, axis_of, mesh)


def state_to_jax_tp(state: dict, axis_of: dict, mesh: Mesh) -> dict:
    """The inverse of :func:`state_from_jax_tp`: the ranks' shards gathered
    into the JAX package's TP form (numpy, on every rank)."""
    return {k: v.cpu().numpy() for k, v in gather_state(state, mesh).items()}


GAUSSIAN_AXIS_OF = {"m_theta": "u", "V_theta": "u", "b_user": "u",
                    "m_beta": "i", "V_beta": "i", "b_item": "i"}
HPF_AXIS_OF = {"a_theta": "u", "b_theta": "u", "b_xi": "u",
               "a_beta": "i", "b_beta": "i", "b_eta": "i"}
HPF_PAD_ONES = ("b_theta", "b_beta", "b_xi", "b_eta")
POISSON_AXIS_OF = {"a_theta": "u", "b_theta": "u", "a_beta": "i", "b_beta": "i"}
POISSON_EXT_AXIS_OF = {**POISSON_AXIS_OF, "a_phi": "u", "b_phi": "u",
                       "a_psi": "i", "b_psi": "i"}
POISSON_PAD_ONES = ("b_theta", "b_beta", "b_phi", "b_psi")


# -------------------------------------------------------- flat sweeps --

def _segsum_ring(E_self_like, width: int, buckets, tables, step_fn, mesh):
    """Run one ring pass whose step ``step_fn(bucket, tables)`` returns
    each edge's contribution (n, width) to its self row; returns the
    (self_per, width) accumulator summed over the data axis."""
    acc = E_self_like.new_zeros((E_self_like.shape[0], width))

    def body(s, tabs):
        b = buckets[s]
        acc.index_add_(0, b.self_loc, step_fn(b, tabs))

    ring(tables, body, mesh)
    (acc,) = sum_dp(mesh, acc)
    return acc


def tp_sweep_hpf(state: dict, layout: TPLayout, a, a_prime, b_prime, c, c_prime,
                 d_prime, *, mesh: Mesh) -> dict:
    """One HPF CAVI iteration with row-sharded Gamma state, in the
    reference's theta -> xi -> beta -> eta order: two ring passes (the xi
    and eta blocks are row-local)."""
    from pmf_tpu_torch.models.hpf import RATE_FLOOR, _expectations, _factor_update

    K = state["a_theta"].shape[1]
    E_theta, E_beta, E_xi, E_eta = _expectations(state, a, a_prime, c, c_prime)

    def factor_block(E_self, E_other, E_rate_prior, buckets, counts, shape0):
        def step(b, tabs):
            sr, orow = E_self[b.self_loc], tabs[0][b.other_loc]
            rate = torch.clamp_min(torch.sum(sr * orow, -1), RATE_FLOOR)
            return torch.cat([(b.x / rate)[:, None] * sr * orow, orow], 1)

        acc = _segsum_ring(E_self, 2 * K, buckets, [E_other], step, mesh)
        return _factor_update(acc[:, :K], acc[:, K:], E_rate_prior, counts, shape0)

    a_t, b_t = factor_block(E_theta, E_beta, E_xi, layout.by_user, layout.user_counts, a)
    E_theta = a_t / b_t
    b_xi = b_prime + torch.sum(E_theta, dim=1)
    a_b, b_b = factor_block(E_beta, E_theta, E_eta, layout.by_item, layout.item_counts, c)
    E_beta = a_b / b_b
    b_eta = d_prime + torch.sum(E_beta, dim=1)
    return {"a_theta": a_t, "b_theta": b_t, "a_beta": a_b, "b_beta": b_b,
            "b_xi": b_xi, "b_eta": b_eta}


def tp_sweep_poisson(state: dict, layout: TPLayout, a0, b0, *, extended: bool,
                     mesh: Mesh) -> dict:
    """One Poisson-MF CAVI iteration with row-sharded Gamma state: user
    block, refresh, item block.  The extended variant's scalar rate needs
    the freshly updated factor rows, so it is a second ring pass a side."""
    from pmf_tpu_torch.models.poisson_mf import RATE_FLOOR, _prior_where

    K = state["a_theta"].shape[1]
    E_theta = state["a_theta"] / state["b_theta"]
    E_beta = state["a_beta"] / state["b_beta"]

    def plain_block(E_self, E_other, buckets, counts):
        def step(b, tabs):
            sr, orow = E_self[b.self_loc], tabs[0][b.other_loc]
            rate = torch.clamp_min(torch.sum(sr * orow, -1), RATE_FLOOR)
            return torch.cat([(b.x / rate)[:, None] * sr * orow, orow], 1)

        acc = _segsum_ring(E_self, 2 * K, buckets, [E_other], step, mesh)
        has = (counts > 0)[:, None]
        return _prior_where(has, acc[:, :K], a0), _prior_where(has, acc[:, K:], b0)

    if not extended:
        a_t, b_t = plain_block(E_theta, E_beta, layout.by_user, layout.user_counts)
        E_theta = a_t / b_t
        a_b, b_b = plain_block(E_beta, E_theta, layout.by_item, layout.item_counts)
        return {"a_theta": a_t, "b_theta": b_t, "a_beta": a_b, "b_beta": b_b}

    def ext_block(E_self, E_other, s_other, buckets, counts):
        def step1(b, tabs):
            E_vis, s_vis = tabs
            sr, orow = E_self[b.self_loc], E_vis[b.other_loc]
            dot = torch.clamp_min(torch.sum(sr * orow, -1), RATE_FLOOR)
            return torch.cat([(b.x / dot)[:, None] * sr * orow,
                              s_vis[b.other_loc][:, None] * orow, b.x[:, None]], 1)

        acc = _segsum_ring(E_self, 2 * K + 1, buckets, [E_other, s_other], step1, mesh)
        has = (counts > 0)[:, None]
        a_fac = _prior_where(has, acc[:, :K], a0)
        b_fac = _prior_where(has, acc[:, K : 2 * K], b0)
        E_fac = a_fac / b_fac

        def step2(b, tabs):
            E_vis, s_vis = tabs
            dot_new = torch.sum(E_fac[b.self_loc] * E_vis[b.other_loc], -1)
            return (s_vis[b.other_loc] * dot_new)[:, None]

        sdot = _segsum_ring(E_self, 1, buckets, [E_other, s_other], step2, mesh)
        has1 = counts > 0
        return (a_fac, b_fac, _prior_where(has1, acc[:, 2 * K], a0),
                _prior_where(has1, sdot[:, 0], b0))

    E_psi = state["a_psi"] / state["b_psi"]
    a_t, b_t, a_phi, b_phi = ext_block(E_theta, E_beta, E_psi, layout.by_user,
                                       layout.user_counts)
    E_theta = a_t / b_t
    E_phi = a_phi / b_phi
    a_b, b_b, a_psi, b_psi = ext_block(E_beta, E_theta, E_phi, layout.by_item,
                                       layout.item_counts)
    return {"a_theta": a_t, "b_theta": b_t, "a_beta": a_b, "b_beta": b_b,
            "a_phi": a_phi, "b_phi": b_phi, "a_psi": a_psi, "b_psi": b_psi}


def tp_sweep_gaussian(state: dict, layout: TPLayout, sigma2, eta_theta2, eta_beta2,
                      eta_bias2, *, use_bias: bool, covariance: str,
                      mesh: Mesh) -> dict:
    """One Gaussian CAVI iteration with row-sharded state, in the
    reference's exact block order theta, beta, b_user, b_item as four ring
    passes; the row solves stay local (batched Cholesky)."""
    from pmf_tpu_torch.models.gaussian_mf import (
        _bias_update, _finish_diag, _finish_factor)
    from pmf_tpu_torch.ops.solve import batched_psd_inverse

    m_t, V_t = state["m_theta"], state["V_theta"]
    m_b, V_b = state["m_beta"], state["V_beta"]
    b_u, b_i = state["b_user"], state["b_item"]
    K = m_t.shape[1]
    full = covariance == "full"

    def resid(b, b_self, tabs):
        return b.x - b_self[b.self_loc] - tabs[-1][b.other_loc] if use_bias else b.x

    def factor_block(m_self, V_self, m_other, V_other, b_self, b_other, buckets,
                     counts, eta2):
        bias_tab = [b_other] if use_bias else []
        if full:
            A = (V_other + m_other[:, :, None] * m_other[:, None, :]).reshape(-1, K * K)

            def step(b, tabs):
                m_e = tabs[1][b.other_loc]
                return torch.cat([tabs[0][b.other_loc],
                                  m_e * resid(b, b_self, tabs)[:, None]], 1)

            acc = _segsum_ring(m_self, K * K + K, buckets, [A, m_other] + bias_tab,
                               step, mesh)
            return _finish_factor(m_self, V_self, acc[:, K * K :],
                                  acc[:, : K * K].reshape(-1, K, K), counts, eta2,
                                  sigma2, batched_psd_inverse)
        sq = V_other + m_other * m_other

        def step(b, tabs):
            m_e = tabs[1][b.other_loc]
            pred = torch.sum(m_self[b.self_loc] * m_e, -1)
            return torch.cat([tabs[0][b.other_loc],
                              m_e * (resid(b, b_self, tabs) - pred)[:, None],
                              m_e * m_e], 1)

        acc = _segsum_ring(m_self, 3 * K, buckets, [sq, m_other] + bias_tab, step, mesh)
        return _finish_diag(m_self, V_self, acc[:, K : 2 * K], acc[:, :K],
                            acc[:, 2 * K :], counts, eta2, sigma2)

    def bias_block(b_self, b_other, m_self, m_other, buckets, counts):
        def step(b, tabs):
            inter = torch.sum(m_self[b.self_loc] * tabs[0][b.other_loc], -1)
            return (b.x - tabs[1][b.other_loc] - inter)[:, None]

        s = _segsum_ring(m_self, 1, buckets, [m_other, b_other], step, mesh)[:, 0]
        return _bias_update(b_self, s, counts, eta_bias2, sigma2)

    m_t, V_t = factor_block(m_t, V_t, m_b, V_b, b_u, b_i, layout.by_user,
                            layout.user_counts, eta_theta2)
    m_b, V_b = factor_block(m_b, V_b, m_t, V_t, b_i, b_u, layout.by_item,
                            layout.item_counts, eta_beta2)
    if use_bias:
        b_u = bias_block(b_u, b_i, m_t, m_b, layout.by_user, layout.user_counts)
        b_i = bias_block(b_i, b_u, m_b, m_t, layout.by_item, layout.item_counts)
    return {"m_theta": m_t, "V_theta": V_t, "m_beta": m_b, "V_beta": V_b,
            "b_user": b_u, "b_item": b_i}


# ---------------------------------------------------------------- fits --

@dataclasses.dataclass(frozen=True)
class TPFamily:
    """What ``fit_tp`` needs of a model family."""

    name: str
    axis_of: dict
    pad_ones: tuple
    init_numpy: Callable  # (n_users, n_items) -> numpy state
    flat: Callable  # (state, layout, mesh) -> state
    blocked: Callable  # (state, layout, mesh, precision) -> state
    eval: Callable  # (state, ev, reduce) -> (rmse, macro-MAE) tensors
    eval_keys: tuple  # the state keys ``eval`` reads
    stop_rule: Callable
    edge_passes: int
    head: Optional[str]  # the blocked layout's head: "auto" or None


def hpf_family(cfg) -> TPFamily:
    from pmf_tpu_torch.models import hpf
    from pmf_tpu_torch.models.base import poisson_stop_rule
    from pmf_tpu_torch.parallel import tp_blocked

    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    return TPFamily(
        name="HPF", axis_of=HPF_AXIS_OF, pad_ones=HPF_PAD_ONES,
        init_numpy=lambda n, m: hpf._init_state_numpy(n, m, cfg),
        flat=lambda s, lo, mesh: tp_sweep_hpf(s, lo, *hyper, mesh=mesh),
        blocked=lambda s, lo, mesh, prec: tp_blocked.tp_sweep_hpf_blocked(
            s, lo, *hyper, mesh=mesh, precision=prec),
        eval=lambda s, ev, reduce: hpf.eval_metrics(s, ev, reduce=reduce),
        eval_keys=("a_theta", "b_theta", "a_beta", "b_beta"),
        stop_rule=poisson_stop_rule, edge_passes=2, head="auto")


def poisson_family(cfg) -> TPFamily:
    from pmf_tpu_torch.models import poisson_mf
    from pmf_tpu_torch.models.base import poisson_stop_rule
    from pmf_tpu_torch.parallel import tp_blocked

    ext = cfg.extended
    blocked = (tp_blocked.tp_sweep_poisson_ext_blocked if ext
               else tp_blocked.tp_sweep_poisson_blocked)
    keys = poisson_mf.EXT_STATE_KEYS if ext else poisson_mf.STATE_KEYS
    return TPFamily(
        name="PoissonMF" + ("-ext" if ext else ""),
        axis_of=POISSON_EXT_AXIS_OF if ext else POISSON_AXIS_OF,
        pad_ones=POISSON_PAD_ONES,
        init_numpy=lambda n, m: poisson_mf._init_state_numpy(n, m, cfg),
        flat=lambda s, lo, mesh: tp_sweep_poisson(s, lo, cfg.a0, cfg.b0, extended=ext,
                                                  mesh=mesh),
        blocked=lambda s, lo, mesh, prec: blocked(s, lo, cfg.a0, cfg.b0, mesh=mesh,
                                                  precision=prec),
        eval=lambda s, ev, reduce: poisson_mf.eval_metrics(s, ev, ext, reduce=reduce),
        eval_keys=keys, stop_rule=poisson_stop_rule, edge_passes=4 if ext else 2,
        head="auto")


def gaussian_family(cfg) -> TPFamily:
    from pmf_tpu_torch.models import gaussian_mf
    from pmf_tpu_torch.models.base import gaussian_stop_rule
    from pmf_tpu_torch.parallel import tp_blocked

    hyper = (cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2, cfg.eta_bias2)
    return TPFamily(
        name="GaussianMF", axis_of=GAUSSIAN_AXIS_OF, pad_ones=(),
        init_numpy=lambda n, m: gaussian_mf._init_state_numpy(n, m, cfg),
        flat=lambda s, lo, mesh: tp_sweep_gaussian(
            s, lo, *hyper, use_bias=cfg.use_bias, covariance=cfg.covariance, mesh=mesh),
        blocked=lambda s, lo, mesh, prec: tp_blocked.tp_sweep_gaussian_blocked(
            s, lo, *hyper, use_bias=cfg.use_bias, covariance=cfg.covariance,
            mesh=mesh, precision=prec, bias_update=cfg.bias_update),
        eval=lambda s, ev, reduce: gaussian_mf.eval_metrics(s, ev, cfg.use_bias,
                                                            reduce=reduce),
        eval_keys=("m_theta", "m_beta", "b_user", "b_item"),
        stop_rule=gaussian_stop_rule, edge_passes=4 if cfg.use_bias else 2, head=None)


@dataclasses.dataclass
class TPRun:
    """What a TP fit leaves on its model beside the gathered state: the
    rank's layout, its padded balanced rows of the final state, one more
    sweep of the fit's own ring (state -> state) and the permutations."""

    layout: object
    state: dict
    sweep: Callable
    balance: BalancePerms


def fit_tp(model, family: TPFamily, train_df, val_df, resume_from, checkpoint_dir,
           checkpoint_every, profile_dir, mesh: Mesh):
    """Row-sharded training of a CAVI model (``fit(mesh=,
    state_sharding="rows")``): the state's rows stay on their ranks through
    every sweep, evaluation and checkpoint; on return ``model.state`` is
    the whole fitted state on every rank and ``model.tp`` the
    :class:`TPRun`."""
    from pmf_tpu_torch.data.coo import build_eval_set
    from pmf_tpu_torch.models.base import FitLoop, as_triples, blocked_precision, resolve_engine
    from pmf_tpu_torch.parallel.tp_blocked import build_tp_blocked

    cfg = model.config
    u, i, x = as_triples(train_df)
    model.n_users, model.n_items = int(u.max()) + 1, int(i.max()) + 1
    model.device = mesh.device
    verbose = cfg.verbose and mesh.is_writer
    if verbose:
        print(f"Inferred n_users={model.n_users}, n_items={model.n_items} "
              f"{describe_tp(mesh)}", flush=True)
    engine = resolve_engine(cfg.engine, len(u), mesh.device)
    model.engine_used = engine
    precision = blocked_precision(engine)
    if getattr(cfg, "use_bias", False) and getattr(cfg, "bias_update", "exact") != "exact" \
            and not (precision is not None and cfg.covariance == "full"):
        raise ValueError(
            "TP mode supports bias_update='lagged' only with a blocked engine and "
            "covariance='full' (the flat ring and the diag kernel carry no "
            f"bias-stat payload); got engine={engine!r}, covariance={cfg.covariance!r}")
    D = tp_degree(mesh)
    bal = balance_perms(u, i, _round_up(model.n_users, D), _round_up(model.n_items, D), D)
    ub, ib = bal.u_new_of_old[u], bal.i_new_of_old[i]
    if precision is None:
        layout = build_tp_layout(ub, ib, x, model.n_users, model.n_items, mesh,
                                 dtype=model._dtype)

        def sweep(s):
            return family.flat(s, layout, mesh)
    else:
        layout = build_tp_blocked(ub, ib, x, model.n_users, model.n_items, mesh,
                                  dtype=model._dtype, head=family.head)

        def sweep(s):
            return family.blocked(s, layout, mesh, precision)
    axis_of = family.axis_of
    init = permute_state_rows(
        pad_state_rows(family.init_numpy(model.n_users, model.n_items), axis_of,
                       layout.n_users_pad, layout.n_items_pad, family.pad_ones),
        axis_of, bal.u_old_of_new, bal.i_old_of_new)
    # The whole padded state exists on the host only; each rank moves its
    # own rows to its device.
    state = place_tp(model._initial_state(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in init.items()},
        resume_from), axis_of, mesh)

    val = None
    if val_df is not None:
        vu, vi, vx = as_triples(val_df)
        ev = build_eval_set(vu, vi, vx, model.n_users, model.n_items,
                            dtype=model._dtype, device="cpu")
        val = shard_eval_set(remap_eval(ev, bal.u_new_of_old, bal.i_new_of_old), mesh,
                             whole_mesh=True)

    def eval_fn(s, ev):
        tables = gather_state(s, mesh, family.eval_keys)
        return family.eval(tables, ev, lambda *t: mesh.sum(*t, axis=None))

    def save(path, s, meta):
        mesh.save_state(path, gather_state(s, mesh), meta)

    loop = FitLoop(lambda s, _: sweep(s), eval_fn, cfg.max_iter, cfg.tol,
                   family.stop_rule, verbose=verbose, name=family.name + "[tp]",
                   checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                   profile_dir=profile_dir if mesh.is_writer else None,
                   edge_visits_per_iter=family.edge_passes * layout.nnz, saver=save)
    state = loop.run(state, layout, val)
    full = permute_state_rows(gather_state(state, mesh), axis_of, bal.u_new_of_old,
                              bal.i_new_of_old)
    model.state = slice_state_rows(full, axis_of, model.n_users, model.n_items)
    model.fit_history = loop.history
    model.n_sweeps = loop.n_sweeps
    model.tp = TPRun(layout, state, sweep, bal)
    return model
