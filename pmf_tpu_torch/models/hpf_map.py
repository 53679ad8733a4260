"""HPF by minibatch MAP/SGD.

Same generative model as :mod:`pmf_tpu_torch.models.hpf`, optimized by
Adam on softplus-constrained unconstrained parameters:

  * Poisson NLL  sum(lambda - x log lambda)  with lambda clamped >= 1e-6.
  * Exact negative log-Gamma prior terms for theta|xi, beta|eta, xi, eta.
  * Frequency-scaled priors: each batch occurrence of user u weighs its
    prior by 1/count(u), so the prior of every entity is applied exactly
    once per epoch.

The scalar entity parameters ride as the LAST column of the factor tables:
params = {"user": (n_users, K+1) [theta | xi], "item": (n_items, K+1)
[beta | eta]}.  The optimizer state is explicit (``ops.adam``).

Engines.  "flat": uniformly shuffled batches of ``batch_size`` ratings,
the last one padded and masked, gradients by autograd on ``batch_loss``.
"blocked_high": the ratings lie in count-reordered, tile-major order, cut
into segments of ``batch_size // mix`` ratings; one Adam step takes ``mix``
segments drawn from the epoch's shuffle of the segments.  Once an epoch
both directions' edges are regrouped on the device by (step, self row)
(``ops.map_grad.group_steps``), and each step's NLL gradients come from
two launches of the CUDA kernel K9 (``ops.map_grad``) on the card, one a
direction, or from its plain version on the CPU.  The prior terms, the softplus chain
rule, Adam and the loss, dense and row-local, are one launch of K10
(``ops.map_dense``) on the card, which also writes the softplus tables the
next step's K9 reads; the CPU runs its plain version.  The blocked
batches are unions of tile-band segments instead of uniform draws: the
same estimator family with another batch composition, so "auto" stays
flat.  "blocked_mid" and "blocked_fast" run the same float32 K9 (the
reference's differ only in its TPU gathers' bf16 parts); any name that does
not start with "blocked" runs flat.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pmf_tpu_torch.data.blocked import _count_perms
from pmf_tpu_torch.data.coo import EvalSet
from pmf_tpu_torch.eval.metrics import masked_metrics
from pmf_tpu_torch.models.base import FactorModel, as_triples, profiled
from pmf_tpu_torch.ops.adam import adam_init, adam_update
from pmf_tpu_torch.ops.map_dense import dense_run, log_priors, map_dense_step, softplus
from pmf_tpu_torch.ops.map_grad import group_steps, map_grad_grouped
from pmf_tpu_torch.ops.segment import edge_dot, gather_rows
from pmf_tpu_torch.utils.device import resolve_device

LAMBDA_FLOOR = 1e-6
TILE = 512  # rows per tile side of the tile-major edge order
PARAM_KEYS = ("user", "item")


@dataclasses.dataclass
class HPFMapConfig:
    n_factors: int = 20
    a: float = 0.3
    a_prime: float = 1.0
    b_prime: float = 1.0
    c: float = 0.3
    c_prime: float = 1.0
    d_prime: float = 1.0
    lr: float = 0.001
    # Dense Adam touches every parameter each step, so small batches are
    # dominated by optimizer traffic; use >= 2^16 at scale.
    batch_size: int = 1024
    epochs: int = 20
    device: str = "tpu"  # kept for best_hyperparams.txt compatibility; unused
    verbose: bool = True
    random_state: int = 42
    dtype: str = "float32"
    # "flat" (uniform batches, autograd), "blocked_high" (tile-band
    # segments through kernel K9) or "auto" (= flat, see the module text).
    # "blocked_mid" and "blocked_fast" run the same K9 in float32 (the
    # reference's differ only in its TPU gathers' bf16 parts); any other
    # name runs flat, as in the JAX package.  ``engine_used`` records it.
    engine: str = "auto"
    # Blocked engine only: segments of batch_size // mix ratings
    # accumulated per Adam step, drawn from the epoch-wide segment shuffle.
    mix: int = 8


def _init_params_numpy(n_users: int, n_items: int, cfg: HPFMapConfig) -> dict:
    """Gaussian(0, 0.1) init of the unconstrained parameters, drawn in the
    JAX package's order (theta, beta, xi, eta), so both packages start
    from the same bits."""
    rng = np.random.default_rng(cfg.random_state)
    K = cfg.n_factors
    dt = np.dtype(cfg.dtype)
    theta = (0.1 * rng.standard_normal((n_users, K))).astype(dt)
    beta = (0.1 * rng.standard_normal((n_items, K))).astype(dt)
    xi = (0.1 * rng.standard_normal(n_users)).astype(dt)
    eta = (0.1 * rng.standard_normal(n_items)).astype(dt)
    return {"user": np.concatenate([theta, xi[:, None]], axis=1),
            "item": np.concatenate([beta, eta[:, None]], axis=1)}


def params_from_numpy(params_np: dict, device=None) -> dict:
    """numpy {"user", "item"} tables -> dict of tensors on ``device``
    (None = the card)."""
    device = resolve_device(device)
    # np.array: a writable copy
    return {k: torch.from_numpy(np.array(params_np[k])).to(device) for k in PARAM_KEYS}


def params_to_numpy(params: dict) -> dict:
    return {k: params[k].detach().cpu().numpy() for k in PARAM_KEYS}


def opt_state_from_numpy(count, mu: dict, nu: dict, device=None) -> dict:
    """Adam's (count, mu, nu), as numpy arrays taken from optax's
    ``ScaleByAdamState``, -> the explicit state of ``ops.adam``."""
    return {"count": int(count), "mu": params_from_numpy(mu, device),
            "nu": params_from_numpy(nu, device)}


def opt_state_to_numpy(state: dict):
    return (np.asarray(state["count"], np.int32), params_to_numpy(state["mu"]),
            params_to_numpy(state["nu"]))


def init_params(n_users: int, n_items: int, cfg: HPFMapConfig, device=None) -> dict:
    return params_from_numpy(_init_params_numpy(n_users, n_items, cfg), device)


def batch_loss(params, u, i, x, mask, user_scale, item_scale, cfg_scalars):
    """Masked MAP loss of one batch; ``mask`` zeroes padded rows."""
    urows = softplus(gather_rows(params["user"], u))
    irows = softplus(gather_rows(params["item"], i))
    theta, xi = urows[:, :-1], urows[:, -1]
    beta, eta = irows[:, :-1], irows[:, -1]
    m = mask.to(theta.dtype)

    lam = torch.clamp_min(edge_dot(theta, beta), LAMBDA_FLOOR)
    nll = torch.sum(m * (lam - x * torch.log(lam)))

    u_scale = gather_rows(user_scale, u) * m
    i_scale = gather_rows(item_scale, i) * m
    lp_user, lp_item = log_priors(theta, xi, beta, eta, cfg_scalars)
    return nll + torch.sum(lp_user * u_scale) + torch.sum(lp_item * i_scale)


def train_epoch(params, opt_state, perm, ui_all, x_all, user_scale, item_scale,
                cfg_scalars, lr: float, batch_size: int, mesh=None):
    """One flat epoch: batch the padded edge list in the order ``perm`` (a
    permutation of its n_pad rows) and take one Adam step per batch.

    ``ui_all``: (n_pad, 2) int32 with columns [u-or-minus-one, i]; padding
    rows carry u == -1 (the batch mask).  ``mesh``: data-parallel SGD, each
    rank takes its contiguous share of every batch and the gradients and
    losses are summed over the data axis before Adam, which every rank
    applies to its replica.  Returns (params, opt_state, sum of the batch
    losses as a 0-d tensor on the device)."""
    n = ui_all.shape[0]
    n_batches = n // batch_size
    perm = torch.as_tensor(perm, device=ui_all.device).long()
    uib = ui_all[perm].view(n_batches, batch_size, 2)
    xb = x_all[perm].view(n_batches, batch_size)
    if mesh is not None:
        from pmf_tpu_torch.parallel.mesh import DATA_AXIS

        part = batch_size // mesh.dp
        cut = slice(mesh.coords[DATA_AXIS] * part, (mesh.coords[DATA_AXIS] + 1) * part)
        uib, xb = uib[:, cut], xb[:, cut]
    total = torch.zeros((), dtype=params["user"].dtype, device=ui_all.device)
    for b in range(n_batches):
        rows = uib[b]
        bm = rows[:, 0] >= 0
        bu = rows[:, 0].clamp_min(0)
        leaves = {k: params[k].detach().requires_grad_(True) for k in PARAM_KEYS}
        loss = batch_loss(leaves, bu, rows[:, 1], xb[b], bm, user_scale,
                          item_scale, cfg_scalars)
        g_user, g_item = torch.autograd.grad(loss, [leaves["user"], leaves["item"]])
        loss = loss.detach()
        if mesh is not None:
            g_user, g_item, loss = mesh.sum(g_user, g_item, loss)
        params, opt_state = adam_update({"user": g_user, "item": g_item},
                                        opt_state, params, lr)
        total = total + loss
    return params, opt_state, total


@dataclasses.dataclass(frozen=True)
class MapBlockedLayout:
    """The ratings in count-reordered (new) row space and tile-major order,
    cut into segments: edges ``seg_off[s] .. seg_off[s + 1]`` form segment
    s.  Parameters, scales and eval ids live in new space for the whole
    blocked fit.  ``group`` regroups both directions for a segment order."""

    u: torch.Tensor  # (nnz,) int32 new-space user ids
    i: torch.Tensor  # (nnz,) int32 new-space item ids
    x: torch.Tensor  # (nnz,) ratings
    seg_off: np.ndarray  # (n_segments + 1,) int64 host offsets
    u_old_of_new: torch.Tensor  # (n_users,) int64
    u_new_of_old: torch.Tensor
    i_old_of_new: torch.Tensor  # (n_items,) int64
    i_new_of_old: torch.Tensor
    n_segments: int  # a multiple of mix; the trailing ones may be empty
    n_real_segments: int  # segments that hold ratings
    mix: int
    n_users: int
    n_items: int
    nnz: int

    def nbytes(self) -> int:
        return self.u.nbytes + self.i.nbytes + self.x.nbytes

    def segment(self, s: int):
        """(u_new, i_new, x) of segment ``s`` in its tile-major order."""
        lo, hi = int(self.seg_off[s]), int(self.seg_off[s + 1])
        return self.u[lo:hi].long(), self.i[lo:hi].long(), self.x[lo:hi]

    def group(self, seg_order, mix: int, K: int, piece: int | None = None):
        """(by user, by item) ``StepGroups`` of the segments ``seg_order``
        (host ints), ``mix`` a step, runs cut into pieces of at most
        ``piece`` edges (``map_grad.piece_of(K)`` by default), to K = 128
        runs of at most ``map_grad.short_of(K)`` edges in the short class:
        the user direction's self rows are users, the item direction's
        items."""
        return (group_steps(self.u, self.i, self.x, self.seg_off, seg_order, mix,
                            self.n_users, K, piece),
                group_steps(self.i, self.u, self.x, self.seg_off, seg_order, mix,
                            self.n_items, K, piece))

    @classmethod
    def from_segments(cls, segments, perms, n_users: int, n_items: int,
                      mix: int, device=None, dtype=np.float32):
        """The layout over segments given from outside: a list of
        (u_new, i_new, x) arrays in new-space ids (empty ones allowed),
        its length a multiple of ``mix``; ``perms`` = (u_old_of_new,
        u_new_of_old, i_old_of_new, i_new_of_old)."""
        device = resolve_device(device)
        if len(segments) % max(mix, 1):
            raise ValueError(f"{len(segments)} segments are not a multiple of "
                             f"mix={mix}")
        lens = [len(s[0]) for s in segments]

        def cat(col, dt):
            parts = [np.asarray(s[col], dtype=dt) for s in segments]
            return torch.from_numpy(np.concatenate(parts) if parts
                                    else np.zeros(0, dt)).to(device)

        return _layout_from_edges(cat(0, np.int64), cat(1, np.int64), cat(2, dtype),
                                  lens, perms, n_users, n_items, mix, device)


def _layout_from_edges(nu, ni, x, seg_lens, perms, n_users, n_items, mix,
                       device) -> MapBlockedLayout:
    """``nu``, ``ni`` (int64) and ``x``: the edges on ``device`` in segment
    order; ``seg_lens``: edges per segment."""
    seg_off = np.zeros(len(seg_lens) + 1, dtype=np.int64)
    np.cumsum(seg_lens, out=seg_off[1:])
    u_o2n, u_n2o, i_o2n, i_n2o = (
        torch.from_numpy(np.asarray(p, np.int64)).to(device) for p in perms)
    return MapBlockedLayout(
        u=nu.to(torch.int32), i=ni.to(torch.int32), x=x.contiguous(), seg_off=seg_off,
        u_old_of_new=u_o2n, u_new_of_old=u_n2o,
        i_old_of_new=i_o2n, i_new_of_old=i_n2o,
        n_segments=len(seg_lens),
        n_real_segments=int(np.count_nonzero(seg_lens)),
        mix=int(mix), n_users=int(n_users), n_items=int(n_items), nnz=int(nu.shape[0]))


def build_map_layout(u, i, x, n_users: int, n_items: int, batch_size: int,
                     mix: int = 1, dtype=np.float32, device=None) -> MapBlockedLayout:
    """The blocked engine's layout: rows relabelled by descending count
    (stable), the ratings stably sorted into tile-major order by
    (u_new // 512, i_new // 512), and that order cut into uniform segments
    of ``max(batch_size // mix, 1)`` ratings (the last one shorter).  The
    segment count is padded to a multiple of ``mix`` with empty segments.
    Each Adam step takes ``mix`` segments of the epoch's segment shuffle,
    so its batch spans ``mix`` distant tile bands instead of one.
    ``device`` None = the card; the sorts run there."""
    device = resolve_device(device)
    mix = max(int(mix), 1)
    u = np.asarray(u, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    u_o2n, u_n2o = _count_perms(u, n_users)
    i_o2n, i_n2o = _count_perms(i, n_items)
    nu = torch.from_numpy(u_n2o[u].astype(np.int64)).to(device)
    ni = torch.from_numpy(i_n2o[i].astype(np.int64)).to(device)
    xs = torch.from_numpy(np.asarray(x, dtype=dtype)).to(device)
    n_item_tiles = -(-n_items // TILE)
    _, order = torch.sort((nu // TILE) * n_item_tiles + ni // TILE, stable=True)
    nnz = len(u)
    seg_len = max(batch_size // mix, 1)
    n_real = max(-(-nnz // seg_len), 1)
    n_segments = -(-n_real // mix) * mix
    seg_lens = [min(seg_len, nnz - k * seg_len) for k in range(n_real)]
    seg_lens += [0] * (n_segments - n_real)
    return _layout_from_edges(nu[order], ni[order], xs[order], seg_lens,
                              (u_o2n, u_n2o, i_o2n, i_n2o), n_users, n_items,
                              mix, device)


def train_epoch_blocked(params, opt_state, perm, lay: MapBlockedLayout,
                        user_scale, item_scale, cfg_scalars, lr: float, mix: int):
    """One epoch of shuffled tile-band SGD: the layout's segments in the
    order ``perm`` (host integers; an epoch passes a permutation of all
    n_segments, a shorter list runs that many whole steps), one Adam step
    per ``mix`` of them.  params, scales and the layout are in new
    (count-reordered) row space.  The epoch first regroups both
    directions' edges by (step, self row) on the device (``lay.group``);
    then each step takes one gradient launch a direction.  On the card the
    step's tables are float32; on the CPU they keep the parameters' dtype.
    Nothing is read to the host inside the loop of steps."""
    order = np.asarray(perm, dtype=np.int64).reshape(-1)
    if lay.n_segments % mix or len(order) % mix:
        raise ValueError(f"layout n_segments={lay.n_segments} or the {len(order)} "
                         f"segments given are not a multiple of mix={mix} "
                         "(build_map_layout pads to the mix used at build)")
    groups = lay.group(order, mix, params["user"].shape[1] - 1)
    return train_steps_grouped(params, opt_state, groups, user_scale, item_scale,
                               cfg_scalars, lr)


def train_steps_grouped(params, opt_state, groups, user_scale, item_scale,
                        cfg_scalars, lr: float):
    """Every step of a grouping (``MapBlockedLayout.group``), one Adam
    step each: two K9 launches and one of K10 (``ops.map_dense``), the
    dense part, on the card; their plain versions on the CPU.  On the card
    the parameters and Adam moments are moved in place (as the JAX
    package's epoch donates them): use the ones returned.  Returns
    (params, opt_state, sum of the step losses as a 0-d tensor on the
    device)."""
    run = dense_run(params, opt_state, user_scale, item_scale, cfg_scalars, lr)
    for step in range(groups[0].n_steps):
        run.acc = map_grad_grouped(run.u_sp, run.i_sp, groups, step, LAMBDA_FLOOR,
                                   run.acc)
        map_dense_step(run)
    return run.result()


def eval_metrics(params: dict, ev: EvalSet, reduce=None):
    """(val RMSE, val macro-MAE) as 0-d tensors on the params' device;
    ``reduce`` sums them over a mesh's shares of the rows."""
    theta = softplus(params["user"][:, :-1])
    beta = softplus(params["item"][:, :-1])
    pred = edge_dot(gather_rows(theta, ev.u), gather_rows(beta, ev.i))
    pred = torch.where(ev.valid, pred, 0.0)
    return masked_metrics(ev.x, pred, ev.real, ev.class_id, ev.n_classes, reduce)


def _permute_rows(params, opt_state, u_perm, i_perm):
    """Apply row permutations to the parameter tables AND the Adam moments
    (the elementwise optimizer state rides with its parameter row, so the
    update trajectory is invariant to the relabeling)."""
    def f(t):
        return {"user": t["user"][u_perm], "item": t["item"][i_perm]}

    return f(params), {"count": opt_state["count"], "mu": f(opt_state["mu"]),
                       "nu": f(opt_state["nu"])}


# The epoch shuffle's generator state: a key of the port's own.  A JAX
# checkpoint holds ``rng_key_data`` (a JAX PRNG key) in its place, which no
# torch generator can continue.
GEN_KEY = "torch_generator_state"


def _leaf_slots(keys) -> list:
    """``leaf_<n>``'s content in the JAX package's leaf order: the params
    by sorted key, then Adam's count, mu and nu (each by sorted key)."""
    return ([("p", k) for k in keys] + [("count", None)]
            + [(m, k) for m in ("mu", "nu") for k in keys])


def _pack_ckpt(params, opt_state, gen_state, epoch) -> dict:
    """(params, Adam state, generator state, epoch) as a flat array dict
    for ``utils.checkpoint.save_state``."""
    tables = {"p": params, "mu": opt_state["mu"], "nu": opt_state["nu"]}
    out = {f"leaf_{n}": (np.int32(opt_state["count"]) if kind == "count"
                         else tables[kind][k])
           for n, (kind, k) in enumerate(_leaf_slots(sorted(params)))}
    out[GEN_KEY] = gen_state.numpy()
    out["epoch"] = np.int32(epoch)
    return out


def _unpack_ckpt(flat: dict, params_template: dict):
    """Inverse of :func:`_pack_ckpt` given params of matching shapes (on
    the fit's device, in its dtype): (params, opt_state, generator state,
    epoch)."""
    if GEN_KEY not in flat:
        which = ("a JAX package HPFMap checkpoint: its epoch RNG is a JAX key, "
                 "which no torch generator continues, so resume it in the JAX "
                 "package" if "rng_key_data" in flat
                 else "not an HPFMap checkpoint of this package")
        raise ValueError(f"checkpoint has no {GEN_KEY}: {which}")
    keys = sorted(params_template)
    slots = _leaf_slots(keys)
    found = {}
    for n, (kind, k) in enumerate(slots):
        if f"leaf_{n}" not in flat:
            raise ValueError(
                f"checkpoint is missing leaf_{n} (have {len(slots)} expected "
                "leaves): saved by an incompatible model/optimizer?")
        leaf = np.asarray(flat[f"leaf_{n}"])
        want = () if kind == "count" else tuple(params_template[k].shape)
        if leaf.shape != want:
            raise ValueError(f"checkpoint leaf_{n} shape {leaf.shape} does not "
                             f"match the model/optimizer state ({want})")
        found[(kind, k)] = leaf
    t = params_template[keys[0]]

    def tab(kind):
        return {k: torch.from_numpy(found[(kind, k)]).to(device=t.device, dtype=t.dtype)
                for k in keys}

    opt_state = {"count": int(found[("count", None)]), "mu": tab("mu"), "nu": tab("nu")}
    return tab("p"), opt_state, torch.from_numpy(np.asarray(flat[GEN_KEY])), int(flat["epoch"])


class HPFMap(FactorModel):
    """The MAP/SGD HPF path with the JAX package's fit/predict surface,
    with exact mid-training checkpoint and resume (Adam moments and the
    epoch shuffle's generator included)."""

    def fit(self, train_df, val_df=None, device=None, resume_from=None,
            checkpoint_dir=None, checkpoint_every: int = 5, profile_dir=None,
            mesh=None):
        """``device``: None = the CUDA card (raises without one); "cpu"
        runs the gradient kernel's plain version on the host.
        ``checkpoint_dir``: save params, Adam state, the generator state
        and the epoch every ``checkpoint_every`` epochs, rows in their
        original order on both engines; ``resume_from``: continue such a
        checkpoint of this package from the epoch after it;
        ``profile_dir``: a ``torch.profiler`` trace of the epochs.
        ``mesh`` (``parallel.make_mesh``): data-parallel SGD, every rank
        drawing the same shuffle and taking its share of each batch
        (``batch_size`` a multiple of the data axis), the gradients summed
        before Adam; a blocked engine runs flat under a mesh, as in the JAX
        package, and ``engine_used`` says so."""
        cfg = self.config
        self.device = dev = self._fit_device(device, mesh)
        writer = mesh is None or mesh.is_writer
        u, i, x = as_triples(train_df)
        self.n_users = int(u.max()) + 1
        self.n_items = int(i.max()) + 1
        if cfg.verbose and writer:
            print(f"Inferred n_users={self.n_users}, n_items={self.n_items}", flush=True)
        engine = "flat" if cfg.engine == "auto" else cfg.engine
        blocked = engine.startswith("blocked") and mesh is None
        if engine.startswith("blocked") and mesh is not None and cfg.verbose and writer:
            print("HPFMap: blocked engine has no mesh path yet; using flat DP batches",
                  flush=True)
        self.engine_used = engine if blocked else "flat"
        if mesh is not None and cfg.batch_size % mesh.dp:
            raise ValueError(f"batch_size={cfg.batch_size} not divisible by {mesh.dp} "
                             "mesh devices")

        dt = self._dtype
        nnz = len(u)
        B = cfg.batch_size

        def scale(ids, n):  # 1/count with a 1e-6 guard
            return torch.from_numpy(
                (1.0 / (np.bincount(ids, minlength=n) + 1e-6)).astype(dt)).to(dev)

        user_scale, item_scale = scale(u, self.n_users), scale(i, self.n_items)
        cfg_scalars = tuple(float(v) for v in (cfg.a, cfg.a_prime, cfg.b_prime,
                                               cfg.c, cfg.c_prime, cfg.d_prime))
        params = init_params(self.n_users, self.n_items, cfg, dev)
        opt_state = adam_init(params)
        gen = torch.Generator(device=dev).manual_seed(cfg.random_state)
        start_epoch = 1
        if resume_from is not None:
            from pmf_tpu_torch.utils.checkpoint import load_state

            flat, _ = load_state(resume_from)
            params, opt_state, gen_state, done_epoch = _unpack_ckpt(flat, params)
            gen.set_state(gen_state)
            start_epoch = done_epoch + 1
            if cfg.verbose:
                print(f"Resumed from {resume_from} after epoch {done_epoch}", flush=True)
        val = self._build_eval(val_df, mesh) if val_df is not None else None
        export_fn = lambda p, s: (p, s)  # noqa: E731

        if blocked:
            # Params, Adam moments, scales and eval ids live in new row
            # space for the whole fit; the final state export unpermutes.
            self.layout = lay = build_map_layout(
                u, i, x, self.n_users, self.n_items, B, mix=cfg.mix, dtype=dt,
                device=dev)
            params, opt_state = _permute_rows(params, opt_state, lay.u_old_of_new,
                                              lay.i_old_of_new)
            user_scale = user_scale[lay.u_old_of_new]
            item_scale = item_scale[lay.i_old_of_new]
            if val is not None:
                val = dataclasses.replace(
                    val,
                    u=lay.u_new_of_old[val.u.long().clamp(0, self.n_users - 1)],
                    i=lay.i_new_of_old[val.i.long().clamp(0, self.n_items - 1)])
            if cfg.verbose:
                print(f"HPFMap engine={engine}: {lay.n_segments // lay.mix} "
                      f"steps/epoch of mix={lay.mix} segments x "
                      f"{max(B // lay.mix, 1)} ratings", flush=True)

            def epoch_fn(p, s):
                perm = torch.randperm(lay.n_segments, generator=gen, device=dev)
                return train_epoch_blocked(p, s, perm.cpu().numpy(), lay, user_scale,
                                           item_scale, cfg_scalars, cfg.lr, lay.mix)

            def export_fn(p, s):  # noqa: F811
                return _permute_rows(p, s, lay.u_new_of_old, lay.i_new_of_old)
        else:
            n_pad = max((nnz + B - 1) // B, 1) * B
            # Packed (n_pad, 2) int32 [u | i]; padding rows carry u == -1,
            # so the mask needs no array of its own (see train_epoch).
            ui = np.full((n_pad, 2), -1, dtype=np.int32)
            ui[:nnz, 0] = u
            ui[:nnz, 1] = i
            ui[nnz:, 1] = 0
            ui_all = torch.from_numpy(ui).to(dev)
            x_pad = np.zeros((n_pad,), dtype=dt)
            x_pad[:nnz] = x
            x_all = torch.from_numpy(x_pad).to(dev)

            def epoch_fn(p, s):
                perm = torch.randperm(n_pad, generator=gen, device=dev)
                return train_epoch(p, s, perm, ui_all, x_all, user_scale,
                                   item_scale, cfg_scalars, cfg.lr, B, mesh)

        if mesh is not None:
            from pmf_tpu_torch.parallel.mesh import replicate

            params = replicate(params, mesh)
        self.fit_history = []
        self.best_val_rmse = float("inf")
        with profiled(profile_dir if writer else None):
            self._run_epochs(cfg, start_epoch, params, opt_state, nnz, epoch_fn,
                             val, export_fn, gen, checkpoint_dir, checkpoint_every,
                             mesh)
        return self

    def _run_epochs(self, cfg, start_epoch, params, opt_state, nnz, epoch_fn, val,
                    export_fn, gen, checkpoint_dir, checkpoint_every, mesh=None):
        from pmf_tpu_torch.utils.checkpoint import save_state

        reduce = None if mesh is None else mesh.sum
        save = save_state if mesh is None else mesh.save_state
        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.perf_counter()
            params, opt_state, loss = epoch_fn(params, opt_state)
            # Reading the loss waits for the epoch's device work.
            record = {"epoch": epoch, "train_loss": float(loss)}
            record["epoch_seconds"] = time.perf_counter() - t0
            record["updates_per_sec"] = nnz / record["epoch_seconds"]
            msg = f"HPFMap epoch {epoch}/{cfg.epochs} | loss {record['train_loss']:.1f}"
            if val is not None:
                val_rmse, val_macro = (float(v) for v in eval_metrics(params, val,
                                                                      reduce))
                record.update(val_rmse=val_rmse, val_macro_mae=val_macro)
                self.best_val_rmse = min(self.best_val_rmse, val_rmse)
                msg += f" | val RMSE {val_rmse:.4f}"
            if cfg.verbose and (mesh is None or mesh.is_writer):
                print(msg, flush=True)
            self.fit_history.append(record)
            if checkpoint_dir and epoch % checkpoint_every == 0:
                # Rows in original order (export_fn unpermutes the blocked
                # engine's), so a checkpoint resumes on either engine.
                cp, cs = export_fn(params, opt_state)
                save(checkpoint_dir, _pack_ckpt(cp, cs, gen.get_state(), epoch),
                     {"epoch": epoch, "name": "HPFMap"})
        self.state, _ = export_fn(params, opt_state)
        return self

    def _point_estimates(self):
        return (softplus(self.state["user"][:, :-1]),
                softplus(self.state["item"][:, :-1]))
