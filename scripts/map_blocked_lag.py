#!/usr/bin/env python3
"""Where the blocked HPF-MAP fit lags the flat one: the JAX package's two
engines on cuts of the bench, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/map_blocked_lag.py [--cuts 64,32,16] [--k 20]
        [--port]

The data is the bench's (``chip_smoke.py``'s phases data and mdata:
``synth`` at 162,000 x 59,000 ids and 25M ratings, seed 0, 100,000 held
out) cut to 1/c of its users, items, ratings, held-out ratings and batch
(65536 / c), as ``tests/test_torch_maplr.py`` cuts it, so every cut keeps
the bench's 380 Adam steps an epoch and its mix of 8 segments a step.  At
each cut the JAX package's ``HPFMap`` fits flat and ``blocked_high`` (its
Pallas kernel in interpret mode) at lr 0.001 for 3 epochs; ``--port`` adds
the port's blocked fit on the CPU (its plain versions).  Each fit prints
its val RMSE by epoch and its seconds; the last line of each cut, the
blocked fit's last val RMSE over the flat fit's.

What the cut changes: a tile band of 512 users holds about 79,000 ratings
at every cut, while a segment holds 8192 / c, so a band spans about 10 c
segments of the epoch's 3,040 and a step of 8 segments touches a given
band with a chance of about 1 - (1 - 10 c / 3040)^8: 96% at 1/128, 2.6%
at full width.  A row that no step touches moves only by its momentum.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cut_bench(cut: int):
    from pmf_tpu_torch.data.synthetic import synth

    n_users, n_items, nnz = 162_000 // cut, 59_000 // cut, 25_000_000 // cut
    u, i, x = synth(n_users, n_items, nnz, seed=0)
    rng = np.random.default_rng(1)
    val = n_users + rng.choice(nnz - n_users, size=100_000 // cut, replace=False)
    keep = np.ones(nnz, bool)
    keep[val] = False
    return (u[keep], i[keep], x[keep]), (u[~keep], i[~keep], x[~keep])


def fit(mod, train, val, cut, k, engine, **kw):
    cfg = mod.HPFMapConfig(n_factors=k, lr=0.001, batch_size=65536 // cut, epochs=3,
                           verbose=False, engine=engine)
    t0 = time.perf_counter()
    model = mod.HPFMap(cfg).fit(train, val, **kw)
    return [h["val_rmse"] for h in model.fit_history], time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cuts", default="64,32,16")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pmf_tpu.models import hpf_map as j_map

    for cut in (int(c) for c in args.cuts.split(",")):
        train, val = cut_bench(cut)
        runs = {"jax flat": (j_map, "flat", {}), "jax blocked": (j_map, "blocked_high", {})}
        if args.port:
            import torch

            from pmf_tpu_torch.models import hpf_map as t_map

            torch.set_num_threads(1)
            runs["port blocked"] = (t_map, "blocked_high", {"device": "cpu"})
        last = {}
        for name, (mod, engine, kw) in runs.items():
            hist, secs = fit(mod, train, val, cut, args.k, engine, **kw)
            last[name] = hist[-1]
            print(f"cut 1/{cut} K={args.k} {name}: val RMSE "
                  + " -> ".join(f"{v:.6f}" for v in hist) + f" | {secs:.1f} s", flush=True)
        print(f"cut 1/{cut}: jax blocked / jax flat last val RMSE "
              f"{last['jax blocked'] / last['jax flat']:.4f}", flush=True)


if __name__ == "__main__":
    main()
