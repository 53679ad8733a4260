#!/usr/bin/env python3
"""Drive ``chip_smoke.py``'s HPF-MAP phases alone on one CUDA card, and
time forms of K10 in turns.

    python3 scripts/probe_k10.py [--forms DIR ...]

K10 (``pmf_tpu_torch/csrc/map_dense.cu``) is the dense part of the blocked
HPF-MAP step.  The probe builds the kernels, makes the bench's ratings,
then runs phases mdata, msmall, mfit (with its witness through the plain
dense part), k10, resume (HPF-MAP), mprofile and mhugefit as the whole
script runs them.  With ``--forms``, each DIR is another tree (a copy of
``pmf_tpu_torch/`` under DIR, its own ``csrc/map_dense.cu``): before the
phases, every tree's K10 runs on the same real steps of the bench's MAP
layout at K = 20, 50, 128, 160 and 300 (from the initial state), is held
against this tree's plain version (per column, ``chip_smoke.column_check``)
and is timed by CUDA events, one launch at a time with the step's K9
sums put back before each, in turns (this tree, the others, the others
reversed, this tree).  Every line goes to standard output and to
``chip_smoke.LOG_PATH``; the last line says how long it took.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

FORM_KS = (20, 50, 128, 160, 300)


def _tree_op(tree: str, name: str, build):
    """``tree``'s pmf_tpu_torch/ops/<name>.py, launching through ``build``."""
    path = os.path.join(os.path.abspath(tree), "pmf_tpu_torch", "ops", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{os.path.basename(tree)}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    mod._build = build
    return mod


def _tree_build(tree: str):
    path = os.path.join(os.path.abspath(tree), "pmf_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(f"{os.path.basename(tree)}_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    return build


def phase_forms(train, trees: dict) -> None:
    """Every tree's K10 on the same real steps, held to the plain version
    and timed in turns (``trees``: name -> its ops.map_dense)."""
    import torch

    from pmf_tpu_torch.models import hpf_map as hm

    lay = hm.build_map_layout(*train, cs.N_USERS, cs.N_ITEMS, cs.MAP_BATCH, mix=cs.MAP_MIX,
                              device="cuda")
    scales = cs._map_scales(lay, train)
    order = np.random.default_rng(12).permutation(lay.n_segments)
    names = list(trees)
    turns = names + names[::-1]
    for k in FORM_KS:
        cfg = hm.HPFMapConfig(n_factors=k, lr=cs.MAP_LR)
        scal = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
        params = hm.init_params(lay.n_users, lay.n_items, cfg, device="cuda")
        params = {side: v[perm].contiguous() for (side, v), perm in
                  zip(params.items(), (lay.u_old_of_new, lay.i_old_of_new))}
        inputs = cs._k10_inputs(lay, params, order, scales, scal, cfg.lr)
        ref, _ = cs._k10_plain(inputs, scales, scal, cfg.lr)
        acc_u, acc_i = inputs[2], inputs[3]
        runs, worst = {}, {}
        for name, md in trees.items():
            params_c = {s: v.clone() for s, v in inputs[0].items()}
            opt = inputs[1]
            state = {"count": opt["count"], "mu": {s: v.clone() for s, v in opt["mu"].items()},
                     "nu": {s: v.clone() for s, v in opt["nu"].items()}}
            run = md.dense_run(params_c, state, *scales, scal, cfg.lr)
            run.acc[0].copy_(acc_u)
            run.acc[1].copy_(acc_i)
            md.map_dense_step(run)
            got = cs._k10_tables(run)
            worst[name] = max(cs.column_check(got[t][s], ref[t][s])[1]
                              for t in ref for s in ref[t])
            if not worst[name] <= cs.COL_RTOL:
                raise AssertionError(f"forms K={k} {name}: column {worst[name]}")
            runs[name] = run
        times = {name: [] for name in names}
        for name in turns:
            run, md = runs[name], trees[name]

            def put_back(run=run):
                run.acc[0].copy_(acc_u)
                run.acc[1].copy_(acc_i)

            times[name].append(cs.launch_ms(lambda run=run, md=md: md.map_dense_step(run),
                                            put_back))
        b_ms, _, _ = cs._k10_bound(lay.n_users, lay.n_items, k,
                                   (int(torch.count_nonzero(acc_u[:, k])),
                                    int(torch.count_nonzero(acc_i[:, k]))))
        cs.log(f"  forms K={k} (bound {b_ms:.4f} ms): " + " | ".join(
            f"{name} {' '.join(f'{t:.4f}' for t in times[name])} ms, mean "
            f"{np.mean(times[name]):.4f}, worst column {worst[name]:.2e}" for name in names))
        del runs, inputs, params
        cs.gc_cuda()
    cs.log(f"phase forms: ok | {names}")


def main() -> int:
    ap = argparse.ArgumentParser(description="chip_smoke.py's HPF-MAP phases alone")
    ap.add_argument("--forms", nargs="*", default=[], metavar="DIR")
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = cs.phase_device()
    builds = {os.path.basename(os.path.normpath(d)): _tree_build(d) for d in args.forms}
    with ThreadPoolExecutor(max(len(builds), 1)) as pool:
        done = [pool.submit(b.build) for b in builds.values()]
        cs.phase_build()
        for f in done:
            f.result()
    train, val, blocked, split = cs.phase_data()
    del blocked, split
    cs.gc_cuda()
    if builds:
        from pmf_tpu_torch.ops import map_dense

        trees = {"this": map_dense}
        trees.update({name: _tree_op(d, "map_dense", builds[name])
                      for name, d in zip(builds, args.forms)})
        phase_forms(train, trees)
    lay, order, groups, seg_groups, secs = cs.phase_mdata(train)
    pieces = groups[0].n_pieces + groups[1].n_pieces
    del lay, order, groups, seg_groups
    cs.gc_cuda()
    cs.phase_msmall()
    model, _ = cs.phase_mfit(train, val, smi)
    cs.phase_k10(model, train)
    cs.gc_cuda()
    cs.phase_mresume(model, train, val, smi)
    cs.phase_mprofile(model, train, smi)
    del model
    cs.gc_cuda()
    cs.phase_mhugefit(train, val, smi, pieces)
    cs.log(f"probe_k10: every phase passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
