#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pmf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero and prints no
result line:

1. device  -- card name and power limit (nvidia-smi), torch/CUDA versions.
2. build   -- compile the CUDA kernels from ``pmf_tpu_torch/csrc``.
3. data    -- the benchmark's Zipf data (162k users x 59k items x 25M
              ratings, seed 0) and the hybrid layout the fit builds.
4. K1      -- sparse-tail edge kernel vs its plain version, both directions.
5. K2      -- dense-head tier kernel vs its plain version, every tier and
              side.
6. small   -- three blocked sweeps on the card vs the host (plain kernels)
              on a small input with an explicit two-tier head.
7. fit     -- ``HPF.fit(engine="blocked_high")`` at K=20 for 4 sweeps, with
              the kernel launch counters reset just before and read after.
8. profile -- steady sweep time, and one sweep under torch.profiler.

Then one JSON line of per-kernel numbers, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_USERS, N_ITEMS, NNZ, K = 162_000, 59_000, 25_000_000, 20
N_VAL = 100_000
FIT_SWEEPS = 4
# Published H100 SXM peaks: HBM bytes/s and float32 CUDA-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Kernel vs plain version: f32 sums of positive terms taken in another
# order; relative error per element.
RTOL = 1e-4
TIMING_REPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, ref) -> tuple[float, float]:
    """(max abs error, max elementwise relative error)."""
    import torch

    diff = (got.double() - ref.double()).abs()
    rel = diff / ref.double().abs().clamp_min(1e-30)
    rel = torch.where(diff == 0, torch.zeros_like(rel), rel)
    return float(diff.max()), float(rel.max())


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase device: ok | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    return smi


def phase_build():
    from pmf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    secs = time.perf_counter() - t0
    _build.load_library()
    report = [ln.strip() for ln in open(str(path) + ".log")
              if "registers" in ln or "spill" in ln] if os.path.exists(
                  str(path) + ".log") else []
    log(f"phase build: ok | {path.name} in {secs:.1f}s")
    for ln in report:
        log(f"  ptxas {ln}")


def phase_data():
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.synthetic import synth

    t0 = time.perf_counter()
    u, i, x = synth(N_USERS, N_ITEMS, NNZ, seed=0)
    # Validation: N_VAL ratings drawn past the id-coverage prefix, so the
    # training split still holds every user and item.
    rng = np.random.default_rng(1)
    val_idx = N_USERS + rng.choice(NNZ - N_USERS, size=N_VAL, replace=False)
    is_val = np.zeros(NNZ, dtype=bool)
    is_val[val_idx] = True
    train = (u[~is_val], i[~is_val], x[~is_val])
    val = (u[is_val], i[is_val], x[is_val])
    t_data = time.perf_counter() - t0

    t0 = time.perf_counter()
    blocked = build_blocked(*train, n_users=N_USERS, n_items=N_ITEMS,
                            reorder=True, head="auto", head_bytes=5 << 29,
                            device="cuda")
    torch.cuda.synchronize()
    t_layout = time.perf_counter() - t0
    tiers = [(h.row_start, h.hu, h.hi) for h in blocked.head or ()]
    head_bytes = sum(h.x_hi.nbytes + h.m.nbytes
                     + (h.x_lo.nbytes if h.x_lo is not None else 0)
                     for h in blocked.head or ())
    n_train = len(train[0])
    log(f"phase data: ok | {N_USERS}x{N_ITEMS} train {n_train} val {N_VAL} "
        f"K={K} | synth {t_data:.1f}s | host layout build {t_layout:.1f}s")
    log(f"  tiers (row_start, rows, hi): {tiers} | head cell bytes {head_bytes}")
    for name, p in (("by_user", blocked.by_user), ("by_item", blocked.by_item)):
        log(f"  tail {name}: nnz {p.nnz} ({p.nnz / n_train:.1%} of edges) | "
            f"longest row {p.max_row_len()}")
    return train, val, blocked


def _new_space_tables(blocked):
    import torch

    from pmf_tpu_torch.models.hpf import HPFConfig, init_state

    state = init_state(N_USERS, N_ITEMS, HPFConfig(n_factors=K), device="cuda")
    e_theta = state["a_theta"] / state["b_theta"]
    e_beta = state["a_beta"] / state["b_beta"]
    return (e_theta[blocked.by_user.self_old_of_new].contiguous(),
            e_beta[blocked.by_item.self_old_of_new].contiguous())


def phase_k1(blocked):
    from pmf_tpu_torch.ops.cavi_edge import (
        RATE_FLOOR, tail_edge_stats, tail_edge_stats_plain)

    e_user, e_item = _new_space_tables(blocked)
    res = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
               n_bytes=0.0, n_flops=0.0)
    for name, p, es, eo in (("user", blocked.by_user, e_user, e_item),
                            ("item", blocked.by_item, e_item, e_user)):
        args = (es, eo, p.row_ptr, p.other, p.x, RATE_FLOOR)
        got = tail_edge_stats(*args)
        ref = tail_edge_stats_plain(*args)
        abs_err, rel_err = compare(got, ref)
        ms = cuda_ms(lambda: tail_edge_stats(*args))
        plain_ms = cuda_ms(lambda: tail_edge_stats_plain(*args), reps=3)
        n_bytes = (es.nbytes + eo.nbytes + p.row_ptr.nbytes + p.other.nbytes
                   + p.x.nbytes + got.nbytes)
        n_flops = p.nnz * (5 * K + 1)  # dot 2K, alloc 2K, other sum K, divide
        b_ms, b_by = bound(n_bytes, n_flops)
        log(f"  K1 {name}: nnz {p.nnz} | max abs err {abs_err:.3e} rel "
            f"{rel_err:.3e} (tol {RTOL}) | kernel {ms:.4f} ms | plain "
            f"{plain_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
        if not rel_err <= RTOL:
            raise AssertionError(f"K1 {name}: relative error {rel_err} > {RTOL}")
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        res["n_bytes"] += n_bytes
        res["n_flops"] += n_flops
    res["bound_ms"], res["bound_by"] = bound(res["n_bytes"], res["n_flops"])
    log(f"phase K1: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    return res


def phase_k2(blocked):
    import torch

    from pmf_tpu_torch.ops.cavi_edge import RATE_FLOOR
    from pmf_tpu_torch.ops.dense_head import (
        fused_alloc_tier, fused_alloc_tier_plain)

    e_user, e_item = _new_space_tables(blocked)
    res = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, n_bytes=0.0, n_flops=0.0)
    for t, h in enumerate(blocked.head or ()):
        theta_h = e_user[h.row_start : h.row_start + h.hu].contiguous()
        beta_h = torch.nn.functional.pad(e_item[: h.hi], (0, 0, 0, h.hip - h.hi))
        # Plain version in row chunks of <= 2^27 cells per temporary.
        chunk = max(1, (1 << 27) // h.hip)
        for item_side in (False, True):
            kw = dict(rate_floor=RATE_FLOOR, item_side=item_side)
            args = (theta_h, beta_h, h.x_hi, h.m, h.x_lo)
            got = fused_alloc_tier(*args, **kw)
            ref = fused_alloc_tier_plain(*args, row_chunk=chunk, **kw)
            abs_err, rel_err = compare(got, ref)
            ms = cuda_ms(lambda: fused_alloc_tier(*args, **kw))
            plain_ms = cuda_ms(
                lambda: fused_alloc_tier_plain(*args, row_chunk=chunk, **kw), reps=3)
            cells_bytes = sum(a.nbytes for a in (h.x_hi, h.m, h.x_lo) if a is not None)
            n_bytes = cells_bytes + theta_h.nbytes + beta_h.nbytes + got.nbytes
            # Per real cell: rate dot 2K, compare + divide 2, two K-wide FMAs 4K.
            n_flops = h.hu * h.hi * (6 * K + 2)
            b_ms, b_by = bound(n_bytes, n_flops)
            side = "item" if item_side else "user"
            log(f"  K2 tier {t} ({h.row_start}, {h.hu}, {h.hi}) {side}: max abs "
                f"err {abs_err:.3e} rel {rel_err:.3e} (tol {RTOL}) | kernel "
                f"{ms:.4f} ms | plain {plain_ms:.4f} ms | bound {b_ms:.4f} ms "
                f"({b_by})")
            if not rel_err <= RTOL:
                raise AssertionError(
                    f"K2 tier {t} {side}: relative error {rel_err} > {RTOL}")
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["max_abs_err"] = max(res["max_abs_err"], abs_err)
            res["n_bytes"] += n_bytes
            res["n_flops"] += n_flops
    res["bound_ms"], res["bound_by"] = bound(res["n_bytes"], res["n_flops"])
    log(f"phase K2: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    return res


def phase_small():
    """Blocked sweeps on the card vs the host on one small input."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.coo import build_ratings
    from pmf_tpu_torch.data.synthetic import synth_ratings
    from pmf_tpu_torch.models import hpf

    u, i, x = synth_ratings(3000, 1500, 120_000, seed=5)
    x = x + 1.0
    cfg = hpf.HPFConfig(n_factors=K)
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    head = [(0, 256, 1500), (256, 768, 300)]
    states = {}
    for dev in ("cpu", "cuda"):
        blocked = build_blocked(u, i, x, reorder=True, head=head, head_r0=256,
                                device=dev)
        flat = build_ratings(u, i, x, device=dev)
        s = hpf.init_state(flat.n_users, flat.n_items, cfg, device=dev)
        for _ in range(3):
            s = hpf.sweep_blocked(s, blocked, flat.user_counts, flat.item_counts,
                                  *hyper)
        states[dev] = hpf.state_to_numpy(s)
    worst = 0.0
    for k, ref in states["cpu"].items():
        got = states["cuda"][k]
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"small: {k} shape {got.shape} or not finite")
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-5, err_msg=k)
        worst = max(worst, float(np.max(np.abs(got - ref) / np.abs(ref))))
    torch.cuda.synchronize()
    log(f"phase small: ok | 3 sweeps card vs host, max rel diff {worst:.3e} "
        f"(tol 5e-4)")


def phase_fit(train, val, smi):
    import torch

    from pmf_tpu_torch.models.hpf import HPF, HPFConfig, state_to_numpy
    from pmf_tpu_torch.ops.cavi_edge import TAIL_LAUNCHES
    from pmf_tpu_torch.ops.dense_head import HEAD_LAUNCHES

    model = HPF(HPFConfig(n_factors=K, max_iter=FIT_SWEEPS, tol=None,
                          verbose=False, engine="blocked_high"))
    TAIL_LAUNCHES.reset()
    HEAD_LAUNCHES.reset()
    t0 = time.perf_counter()
    model.fit(train, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": TAIL_LAUNCHES.count, "K2": HEAD_LAUNCHES.count}
    n_tiers = len(model.blocked.head or ())
    for rec in model.fit_history:
        log(f"  sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | "
            f"{rec['updates_per_sec'] / 1e6:.1f}M updates/s | val RMSE "
            f"{rec['val_rmse']:.6f} | {smi}")
    want = {"K1": 2 * model.n_sweeps, "K2": 2 * n_tiers * model.n_sweeps}
    if launches != want or n_tiers == 0:
        raise AssertionError(f"fit launches {launches}, expected {want} "
                             f"({model.n_sweeps} sweeps, {n_tiers} tiers)")
    state = state_to_numpy(model.state)
    for k, v in state.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"fit state {k} has non-finite values")
    rmses = [rec["val_rmse"] for rec in model.fit_history]
    if len(rmses) != FIT_SWEEPS or not np.all(np.isfinite(rmses)):
        raise AssertionError(f"val RMSE history {rmses}")
    if not all(b <= a for a, b in zip(rmses[:3], rmses[1:3])):
        raise AssertionError(f"val RMSE rose over the first sweeps: {rmses}")
    log(f"phase fit: ok | {model.n_sweeps} sweeps in {wall:.1f}s wall (layout "
        f"build included) | launches {launches} | {n_tiers} tiers")
    return model, launches


def phase_profile(model, train, smi):
    """Steady sweep time (CUDA events over chained sweeps) and one sweep
    under torch.profiler: device time by kernel and the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pmf_tpu_torch.models.hpf import sweep_blocked

    cfg = model.config
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    user_counts, item_counts = (
        torch.bincount(torch.from_numpy(ids).cuda(), minlength=n).float()
        for ids, n in ((train[0], N_USERS), (train[1], N_ITEMS)))
    state = dict(model.state)

    def one_sweep():
        nonlocal state
        state = sweep_blocked(state, model.blocked, user_counts, item_counts,
                              *hyper)

    ms = cuda_ms(one_sweep, reps=5)
    log(f"  steady sweep: {ms:.4f} ms | {2 * len(train[0]) / ms / 1e3:.1f}M "
        f"updates/s | {smi}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_sweep()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"phase profile: ok | one sweep: device busy {busy:.4f} ms of "
        f"{wall_ms:.4f} ms window (idle share {1 - busy / wall_ms:.1%})")
    for dev_ms, n, key in rows[:8]:
        log(f"  {dev_ms:9.4f} ms  {n:3d}x  {key[:90]}")


def main() -> int:
    smi = phase_device()
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    train, val, blocked = phase_data()
    k1 = phase_k1(blocked)
    k2 = phase_k2(blocked)
    del blocked
    torch.cuda.empty_cache()
    phase_small()
    model, launches = phase_fit(train, val, smi)
    phase_profile(model, train, smi)

    def entry(name, source, replaces, res, n):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None}

    kernels = [
        entry("cavi_edge_tail", "pmf_tpu_torch/csrc/cavi_edge.cu",
              "pmf_tpu/ops/pallas/cavi_edge.py:93", k1, launches["K1"]),
        entry("dense_head_tier", "pmf_tpu_torch/csrc/dense_head.cu",
              "pmf_tpu/ops/dense_head.py:85", k2, launches["K2"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
