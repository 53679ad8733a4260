"""Shared model machinery: the host-side fit loop around CAVI sweeps.

Each CAVI iteration is one sweep over the whole rating set; the early-stop
decision stays on the host between sweeps.  PyTorch queues device work
asynchronously, so the loop queues the copy of this iteration's
validation scalars, dispatches the next sweep, and only then waits for
the copy (the one host-device sync per iteration): the card keeps working
through the round trip.

With ``checkpoint_dir`` the loop saves the state of sweep ``it`` at the
top of every ``checkpoint_every``-th iteration, before the next sweep is
dispatched: that copy waits for sweep ``it`` alone, and iterations that
save nothing read nothing more than before.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pmf_tpu_torch.data.coo import EvalSet, RatingsCOO, build_eval_set, build_ratings
from pmf_tpu_torch.eval.metrics import macro_mae, rmse
from pmf_tpu_torch.utils.device import ScalarReader, mark


def as_triples(data) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Accept a pandas DataFrame with columns u/i/rating, a dict, or a
    (u, i, x) tuple of arrays; return numpy triples."""
    if isinstance(data, tuple) and len(data) == 3:
        u, i, x = data
    elif hasattr(data, "columns"):
        u = data["u"].to_numpy()
        i = data["i"].to_numpy()
        x = data["rating"].to_numpy()
    elif isinstance(data, dict):
        u, i, x = data["u"], data["i"], data["rating"]
    else:
        raise TypeError(f"Unsupported ratings container: {type(data)!r}")
    return (
        np.asarray(u, dtype=np.int64),
        np.asarray(i, dtype=np.int64),
        np.asarray(x, dtype=np.float64),
    )


class FitLoop:
    """Drives sweeps with host-side early stopping.

    ``stop_rule(prev_rmse, rmse, tol) -> bool`` encodes the per-model rule.
    ``n_sweeps`` counts the sweeps dispatched, the discarded speculative
    one included.  ``checkpoint_dir``: save the state of every
    ``checkpoint_every``-th iteration there (``utils.checkpoint``, or
    ``saver(path, state, meta)``: under a mesh, rank 0 writes and every
    rank waits); ``profile_dir``: trace the whole loop with
    ``torch.profiler`` into that directory (a Chrome trace,
    ``trace.json``)."""

    def __init__(self, sweep_fn: Callable, eval_fn: Optional[Callable],
                 max_iter: int, tol, stop_rule: Callable, verbose: bool = False,
                 name: str = "CAVI", checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 10, profile_dir: Optional[str] = None,
                 edge_visits_per_iter: Optional[int] = None,
                 elbo_fn: Optional[Callable] = None, elbo_every: int = 1,
                 elbo_monotone: Optional[float] = None,
                 saver: Optional[Callable] = None):
        self.sweep_fn = sweep_fn
        self.eval_fn = eval_fn
        self.max_iter = max_iter
        self.tol = tol
        self.stop_rule = stop_rule
        self.verbose = verbose
        self.name = name
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.profile_dir = profile_dir
        # Ratings touched per iteration (nnz x edge passes); when set, each
        # history record carries ``updates_per_sec``.
        self.edge_visits_per_iter = edge_visits_per_iter
        # Convergence diagnostic: ``elbo_fn(state) -> scalar`` is evaluated
        # every ``elbo_every`` iterations and recorded as ``elbo``.
        # ``elbo_monotone`` (a relative tolerance) enforces non-decrease,
        # valid where the sweep is exact coordinate ascent on that ELBO.
        self.elbo_fn = elbo_fn
        self.elbo_every = max(int(elbo_every), 1)
        self.elbo_monotone = elbo_monotone
        self._prev_elbo: Optional[float] = None
        self.saver = saver
        self.history: list[dict] = []
        self.n_sweeps = 0

    def _sweep(self, state, data):
        """Dispatch one sweep; returns (state, wait for that sweep)."""
        self.n_sweeps += 1
        state = self.sweep_fn(state, data)
        return state, mark(next(iter(state.values())))

    def _timed(self, record: dict, t0: float, state: dict) -> float:
        """Close iteration ``record`` (time, rate, the ELBO when due);
        returns the next iteration's start: ELBO time is not sweep time."""
        record["iter_seconds"] = time.perf_counter() - t0
        if self.edge_visits_per_iter:
            record["updates_per_sec"] = self.edge_visits_per_iter / record["iter_seconds"]
        self._maybe_elbo(state, record)
        return time.perf_counter()

    def _maybe_checkpoint(self, state: dict, it: int) -> None:
        """Save sweep ``it``'s state (called before the next sweep is
        queued, so the host copy waits for sweep ``it`` alone)."""
        if self.checkpoint_dir and it % self.checkpoint_every == 0:
            from pmf_tpu_torch.utils.checkpoint import save_state

            (self.saver or save_state)(self.checkpoint_dir, state,
                                       {"iteration": it, "name": self.name})

    def _maybe_elbo(self, state: dict, record: dict) -> None:
        it = record["iteration"]
        if self.elbo_fn is None or it % self.elbo_every:
            return
        elbo = float(self.elbo_fn(state))
        record["elbo"] = elbo
        prev = self._prev_elbo
        if (self.elbo_monotone is not None and prev is not None
                and elbo < prev - self.elbo_monotone * (1.0 + abs(prev))):
            raise RuntimeError(
                f"{self.name}: ELBO decreased at iteration {it} "
                f"({prev!r} -> {elbo!r}): the sweep is coordinate ascent on "
                "this objective, so a decrease beyond rounding indicates a "
                "bug (or mismatched train data passed to elbo_every)")
        self._prev_elbo = elbo

    def run(self, state: dict, data, val: Optional[EvalSet]) -> dict:
        """The returned state is the one the stop decision was made on; at
        most one speculative sweep past the stop point is discarded."""
        with profiled(self.profile_dir):
            return self._run(state, data, val)

    def _run(self, state: dict, data, val: Optional[EvalSet]) -> dict:
        if self.max_iter <= 0:
            return state
        prev_val_rmse = None
        reader = ScalarReader()
        state, done = self._sweep(state, data)  # iteration 1 dispatch
        t0 = time.perf_counter()
        for it in range(1, self.max_iter + 1):
            cur, cur_done = state, done
            self._maybe_checkpoint(cur, it)
            record = {"iteration": it, "iter_seconds": None}
            if val is not None and self.eval_fn is not None:
                scalars = reader.start(*self.eval_fn(cur, val))
                if it < self.max_iter:
                    # Speculative dispatch: queued on the device behind the
                    # eval scalars' copy, before the host waits for it.
                    state, done = self._sweep(cur, data)
                val_rmse, val_macro = scalars()  # device sync point
                record.update(val_rmse=val_rmse, val_macro_mae=val_macro)
                t0 = self._timed(record, t0, cur)
                if self.verbose:
                    ups = record.get("updates_per_sec")
                    print(
                        f"{self.name} iter {it}/{self.max_iter} | "
                        f"val RMSE {val_rmse:.4f} | macro-MAE {record['val_macro_mae']:.4f} | "
                        f"{record['iter_seconds']:.3f}s"
                        + (f" | {ups/1e6:.1f}M updates/s" if ups else "")
                        + (f" | ELBO {record['elbo']:.6g}" if "elbo" in record else ""),
                        flush=True,
                    )
                self.history.append(record)
                if prev_val_rmse is not None and self.stop_rule(
                        prev_val_rmse, val_rmse, self.tol):
                    if self.verbose:
                        print("Early stopping on validation improvement.", flush=True)
                    return cur
                prev_val_rmse = val_rmse
            else:
                if it < self.max_iter:
                    state, done = self._sweep(cur, data)
                # Wait for sweep `it` (not the one just queued) so the time
                # measures compute, not dispatch.
                cur_done()
                t0 = self._timed(record, t0, cur)
                self.history.append(record)
        return state


@contextlib.contextmanager
def profiled(profile_dir: Optional[str]):
    """Trace the enclosed work with ``torch.profiler`` (host and, where
    CUDA is present, device activity) into ``profile_dir/trace.json``;
    nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def resolve_engine(engine: str, nnz: Optional[int] = None, device=None) -> str:
    """"auto" -> "flat" on the CPU, as in the JAX package, and on the card
    below 300k edges (layout build time dominates a short fit there);
    "blocked_high" (the hybrid kernels) otherwise.  ``device`` is the
    fit's resolved device; None means the card."""
    if engine != "auto":
        return engine
    if device is not None and torch.device(device).type == "cpu":
        return "flat"
    if nnz is not None and nnz < 300_000:
        return "flat"
    return "blocked_high"


# The blocked engines' head precision.  The JAX package's "mid" differs
# from "high" only in its TPU tail gathers' bf16 parts, which the port does
# not have, so it runs "high"; any other name that starts with "blocked"
# runs "high" there too.
BLOCKED_PRECISION = {"blocked_fast": "fast", "blocked_mid": "high",
                     "blocked_high": "high"}


def blocked_precision(engine: str) -> str | None:
    """The head precision of a blocked engine, None for any engine that
    runs flat (every name that does not start with "blocked")."""
    if not engine.startswith("blocked"):
        return None
    return BLOCKED_PRECISION.get(engine, "high")


def reduced(reduce: Optional[Callable], *stats: torch.Tensor) -> tuple:
    """``stats`` summed over a mesh's data axis by ``reduce`` (the sweeps'
    hook, ``parallel.mesh.Mesh.sum``: each rank computed them over its own
    edges), or as they are on one device."""
    return stats if reduce is None else tuple(reduce(*stats))


def gaussian_stop_rule(prev: float, cur: float, tol) -> bool:
    improvement = prev - cur
    return tol is not None and 0.0 <= improvement < tol


def poisson_stop_rule(prev: float, cur: float, tol) -> bool:
    improvement = prev - cur
    return tol is not None and improvement < tol


class FactorModel:
    """Base for the CAVI models: boundary conversion, prediction, metrics."""

    def __init__(self, config):
        self.config = config
        self.n_users: Optional[int] = None
        self.n_items: Optional[int] = None
        self.state: Optional[dict] = None
        self.device: Optional[torch.device] = None
        self.fit_history: list[dict] = []

    def _point_estimates(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(user_factors, item_factors) point estimates (means)."""
        raise NotImplementedError

    def _initial_state(self, default_state: dict, resume_from: Optional[str],
                       mesh=None) -> dict:
        """A checkpointed state in place of the fresh one when resuming,
        on the fresh state's device and in its dtypes; under a
        data-parallel mesh, rank 0's, broadcast (``parallel.mesh.replicate``)."""
        if mesh is not None:
            from pmf_tpu_torch.parallel.mesh import replicate

            return replicate(self._initial_state(default_state, resume_from), mesh)
        if resume_from is None:
            return default_state
        from pmf_tpu_torch.utils.checkpoint import load_state

        restored, _ = load_state(resume_from)
        for k, v in default_state.items():
            want = tuple(v.shape)
            have = k in restored and tuple(restored[k].shape)
            if have != want:
                hint = ""
                # Tensor-parallel checkpoints of the JAX package store
                # mesh-padded row counts: a mismatch in the leading
                # dimension alone almost always means one of those.
                if have and have[1:] == want[1:] and have[0] != want[0]:
                    hint = (" — the leading (row) dimension differs; TP "
                            "(state_sharding='rows') checkpoints store mesh-"
                            "padded row counts, so resume them with the same "
                            "state_sharding mode and tp degree as the fit that "
                            "saved them")
                raise ValueError(
                    f"checkpoint at {resume_from} does not match model state "
                    f"(key {k}: {have} vs {want}){hint}")
        return {k: torch.from_numpy(np.asarray(restored[k])).to(device=v.device,
                                                                dtype=v.dtype)
                for k, v in default_state.items()}

    @property
    def _dtype(self):
        return np.dtype(getattr(self.config, "dtype", "float32"))

    def _build_train(self, train, mesh=None) -> RatingsCOO:
        """The training COO on the fit's device; under a mesh, the rank's
        share of it (built on the host, then cut)."""
        u, i, x = as_triples(train)
        if mesh is None:
            return build_ratings(u, i, x, dtype=self._dtype, device=self.device)
        from pmf_tpu_torch.parallel.mesh import shard_ratings

        return shard_ratings(build_ratings(u, i, x, dtype=self._dtype, device="cpu"),
                             mesh)

    def _build_eval(self, df, mesh=None) -> EvalSet:
        """The validation rows on the fit's device; under a mesh, the rank's
        share of them."""
        u, i, x = as_triples(df)
        if mesh is None:
            return build_eval_set(u, i, x, self.n_users, self.n_items,
                                  dtype=self._dtype, device=self.device)
        from pmf_tpu_torch.parallel.mesh import shard_eval_set

        return shard_eval_set(build_eval_set(u, i, x, self.n_users, self.n_items,
                                             dtype=self._dtype, device="cpu"), mesh)

    def _fit_device(self, device, mesh) -> torch.device:
        """The fit's device: the mesh's under a mesh (a ``device`` given
        beside it must name the same), else ``resolve_device(device)``."""
        from pmf_tpu_torch.utils.device import resolve_device

        if mesh is None:
            return resolve_device(device)
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device!r} differs from the mesh's {mesh.device}")
        return mesh.device

    @staticmethod
    def _mesh_loop_args(mesh, verbose: bool, profile_dir, elbo_fn) -> dict:
        """FitLoop arguments under a data-parallel mesh: rank 0 prints,
        profiles and writes checkpoints; the ELBO every rank sees (and
        gates) is rank 0's."""
        if mesh is None:
            return dict(verbose=verbose, profile_dir=profile_dir, elbo_fn=elbo_fn)
        return dict(verbose=verbose and mesh.is_writer,
                    profile_dir=profile_dir if mesh.is_writer else None,
                    elbo_fn=None if elbo_fn is None
                    else (lambda s: mesh.decide(elbo_fn(s))),
                    saver=mesh.save_state)

    def _blocked_layout(self, train, head_bytes: int, mesh=None):
        """The hybrid layout of the training edges on the fit's device, its
        head tiers picked within ``head_bytes`` (the JAX package's budgets,
        so the tiers equal the reference's); under a mesh, the rank's band
        of it, the tiers' rows a multiple of the data axis."""
        from pmf_tpu_torch.data.blocked import build_blocked

        u, i, x = as_triples(train)
        blocked = build_blocked(u, i, x, n_users=self.n_users, n_items=self.n_items,
                                dtype=self._dtype, reorder=True, head="auto",
                                head_bytes=head_bytes,
                                head_row_mult=mesh.dp if mesh else 1,
                                device=self.device)
        if mesh is None:
            return blocked
        from pmf_tpu_torch.parallel.mesh import shard_blocked

        return shard_blocked(blocked, mesh)

    @staticmethod
    def _check_sharding(state_sharding, mesh, elbo_every) -> bool:
        """Whether the fit runs row-sharded (TP); raises on what the TP fits
        do not take, with the JAX package's messages."""
        if state_sharding == "rows":
            if elbo_every:
                raise ValueError("elbo_every is not supported with TP "
                                 "(row-sharded) fits yet")
            if mesh is None:
                raise ValueError("state_sharding='rows' requires a mesh")
            return True
        if state_sharding not in (None, "replicated"):
            raise ValueError(f"unknown state_sharding {state_sharding!r}")
        return False

    def _elbo_edges(self, train, width: Optional[int] = None):
        """(u, i, x, n_chunks): the train edges as tensors on the fit's
        device and the chunk count that bounds the ELBO's gathers of
        ``width`` floats an edge (default K)."""
        from pmf_tpu_torch.eval.elbo import _auto_chunks

        u, i, x = as_triples(train)
        dev = self.device
        return (torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev),
                torch.from_numpy(x.astype(self._dtype)).to(dev),
                _auto_chunks(len(u), width or self.config.n_factors))

    def _make_elbo_fn(self, train) -> Callable:
        """state -> ELBO over the train edges (``fit(elbo_every=)``, ``elbo``)."""
        raise NotImplementedError(f"{type(self).__name__} has no ELBO yet")

    def elbo(self, train) -> float:
        """Auxiliary-variable ELBO of the fitted state over ``train`` (on
        the scale passed to fit); see ``eval.elbo``."""
        return float(self._make_elbo_fn(train)(self.state))

    def _score_offsets(self):
        """(user_bias, item_bias, mean) additive score terms for serving;
        models whose predict() is not a pure dot product override it so
        recommend() ranks by the same score."""
        return None, None, 0.0

    def recommend(self, user_ids, k: int = 10, train=None, batch: int = 1024,
                  train_index=None, mesh=None):
        """Top-k unseen items per user on the state's device.  ``train``:
        a ratings container whose (u, i) pairs are excluded; for repeated
        calls pass ``train_index`` from ``eval.recommend.build_exclusion_index``
        (or ``exclusion_index_from_coo``) instead.  ``mesh``: the queried
        users cut over the mesh's ranks (``eval.recommend.recommend_sharded``;
        every rank gets the whole answer).  Returns (items, scores) as numpy
        arrays of shape (len(user_ids), k)."""
        from pmf_tpu_torch.eval.recommend import recommend as _rec
        from pmf_tpu_torch.eval.recommend import recommend_sharded

        theta, beta = self._point_estimates()
        user_bias, item_bias, mean = self._score_offsets()
        tu = ti = None
        if train is not None:
            tu, ti, _ = as_triples(train)
        if mesh is not None:
            return recommend_sharded(theta, beta, user_ids, k=k, train_u=tu,
                                     train_i=ti, mesh=mesh, item_bias=item_bias,
                                     user_bias=user_bias, mean=mean, batch=batch,
                                     train_index=train_index)
        return _rec(theta, beta, user_ids, k=k, train_u=tu, train_i=ti,
                    batch=batch, item_bias=item_bias, user_bias=user_bias,
                    mean=mean, train_index=train_index)

    def predict(self, user_ids, item_ids) -> np.ndarray:
        """Out-of-range (unseen) pairs predict 0."""
        u = np.asarray(user_ids, dtype=np.int64)
        i = np.asarray(item_ids, dtype=np.int64)
        valid = (u < self.n_users) & (i < self.n_items) & (u >= 0) & (i >= 0)
        theta, beta = self._point_estimates()
        theta = theta.detach().cpu().numpy()
        beta = beta.detach().cpu().numpy()
        preds = np.zeros(len(u), dtype=np.float64)
        if valid.any():
            preds[valid] = np.sum(theta[u[valid]] * beta[i[valid]],
                                  axis=-1).astype(np.float64)
        return preds

    def evaluate_rmse(self, df) -> float:
        u, i, x = as_triples(df)
        return rmse(x, self.predict(u, i))

    def evaluate_macro_mae(self, df) -> float:
        u, i, x = as_triples(df)
        return macro_mae(x, self.predict(u, i))
