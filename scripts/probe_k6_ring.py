#!/usr/bin/env python3
"""Time K6's ring form (``csrc/tail_groups.cuh::tail_ring_kernel``) against
its earlier forms and its variants on one CUDA card.

    python3 scripts/probe_k6_ring.py [--ks 160,200,255,256,300,384,511]

K6 is the diag Gaussian tail pass of ``pmf_tpu_torch``.  The script builds
the port's kernels (``ops/_build.py``) and, beside them, one library of
probe entry points compiled from the same header: the register form
``tail_group_kernel<kDiag, 32, 2, 2>`` (K6's form at 33 to 64 words a row
before the ring form), ``tail_wide_kernel<kDiag>`` (past 64 words), and
the ring form at several rounds of D edges and rings of S rounds.  On the
bench's Gaussian tail (``chip_smoke.py``'s phase gdata: 162,000 x 59,000
ids, 25M ratings) with random tables at each K it times, a sweep (both
directions) by CUDA events: the port's wrapper, each variant, the earlier
form, and the ring form on one record [m | b | v + m^2] a row (the
JAX kernel's own layout: one contiguous copy an edge).  Every variant's
output is held to the wrapper's (per column, ``COL_RTOL``), the wrapper's
to the plain version at K = 160.  At K = 160 it also times the wrapper with
every edge's other id set to 0 (every gather served by one row) and on the
item pass's ids cut to 40,000 rows.  Every line also goes to
``chiprun_out/probe_k6_ring.log``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

cs.LOG_PATH = os.path.join(ROOT, "chiprun_out", "probe_k6_ring.log")

# (V, D, S) instances of the ring form: D edges a round, S rounds a ring.
# The port's own is (V, kRingInFlight, kRingStages).
VARIANTS = [(4, 3), (4, 2), (2, 3), (2, 4), (8, 2)]
MAX_SMEM = 232_448  # bytes of dynamic shared memory a CTA may ask for
TURN_REPS = 3

PROBE_SRC = r"""
#include "tail_groups.cuh"
using namespace tail_groups;
#define ARGS const float* mb_s, const float* mb_o, const float* sq_o, \
    const int64_t* row_ptr, const int32_t* other, const float* x, int n_self, int n_long, \
    int K, int rec_stride, int sq_stride, float* out, void* stream
#define TABLES const Tables t{mb_s, mb_o, sq_o, row_ptr, other, x}
#define RING(V, D, S) \
  extern "C" int k6_ring_##V##_##D##_##S(ARGS) { \
    TABLES; \
    return launch_ring<V, D, S>(t, n_self, K, rec_stride, sq_stride, out, \
                                static_cast<cudaStream_t>(stream)); }
%s
extern "C" int k6_group(ARGS) {
  TABLES;
  return launch_instance<kDiag, 32, 2, 2>(t, n_self, n_long, K, 0.f, out,
                                          static_cast<cudaStream_t>(stream));
}
extern "C" int k6_wide(ARGS) {
  tail_wide_kernel<kDiag><<<(n_self + kWarps - 1) / kWarps, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      mb_s, mb_o, sq_o, row_ptr, other, x, n_self, K, 0.f, out);
  return (int)cudaGetLastError();
}
"""


def build_probe():
    """The probe library, built with the port's nvcc flags into
    ``pmf_tpu_torch/_build/probe_k6/``; its ptxas lines logged."""
    from pmf_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "probe_k6"
    out_dir.mkdir(parents=True, exist_ok=True)
    rings = "\n".join(f"RING({v}, {d}, {s})" for v in (2, 3, 4) for d, s in VARIANTS)
    src = out_dir / "probe.cu"
    src.write_text(PROBE_SRC % rings)
    lib = out_dir / "libprobe_k6.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
         "-I", str(_build.SRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit("probe build failed:\n" + proc.stdout + proc.stderr)
    cs.log(f"probe library built in {time.perf_counter() - t0:.1f} s")
    for ln in cs._ptxas_report(proc.stdout + proc.stderr, {}):
        cs.log(f"  ptxas {ln}")
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ["k6_group", "k6_wide"] + [f"k6_ring_{v}_{d}_{s}" for v in (2, 3, 4)
                                           for d, s in VARIANTS]:
        fn = getattr(so, name)
        fn.argtypes = [P] * 6 + [I] * 5 + [P, P]
        fn.restype = ctypes.c_int
    return so


def gauss_tail():
    """phase gdata's layout on the bench's ids and split."""
    from pmf_tpu_torch.data.synthetic import synth

    u, i, _ = synth(cs.N_USERS, cs.N_ITEMS, cs.NNZ, seed=0)
    rng = np.random.default_rng(1)
    val_idx = cs.N_USERS + rng.choice(cs.NNZ - cs.N_USERS, size=cs.N_VAL, replace=False)
    is_val = np.zeros(cs.NNZ, dtype=bool)
    is_val[val_idx] = True
    return cs.phase_gdata((u, i, is_val))[2]


def ring_smem(k, d, s):
    from pmf_tpu_torch.ops._tail import DOT_WARPS, dot_ring_words

    return DOT_WARPS * 16 * dot_ring_words(-(-(k + 1) // 4) + -(-k // 4), d, s)


def main(argv=None) -> int:
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge
    from pmf_tpu_torch.ops._tail import launch_plan

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="160,200,255,256,300,384,511")
    args = ap.parse_args(argv)
    ks = [int(k) for k in args.ks.split(",")]
    from concurrent.futures import ThreadPoolExecutor

    smi = cs.phase_device()
    with ThreadPoolExecutor(1) as pool:  # the probe's nvcc beside the port's
        probe = pool.submit(build_probe)
        cs.phase_build()
        so = probe.result()
    blocked = gauss_tail()
    dirs = (blocked.by_user, blocked.by_item)

    def call(name, tabs, p, k, rec_stride, sq_stride, other=None):
        mb_s, mb_o, sq_o = tabs
        out = torch.empty((p.n_self, 3 * k), device="cuda")
        err = getattr(so, name)(
            mb_s.data_ptr(), mb_o.data_ptr(), sq_o.data_ptr(), p.row_ptr.data_ptr(),
            (p.other if other is None else other).data_ptr(), p.x.data_ptr(), p.n_self,
            p.long_rows, k, rec_stride, sq_stride, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} K={k}: CUDA error {err}")
        return out

    def turns(fns):
        """{label: mean ms a sweep} over the labels in order, then reversed."""
        got = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                got[name].append(cs.cuda_ms(fns[name], reps=TURN_REPS))
        return {name: (float(np.mean(v)), v) for name, v in got.items()}

    for k in ks:
        W, Wq = -(-(k + 1) // 4), -(-k // 4)
        V = -(-W // 32)
        tabs = [cs._tail_tabs("K6", p.n_self, p.n_other, k, 70 + k + j)
                for j, p in enumerate(dirs)]
        joined = [(t[0], torch.cat([t[1], t[2]], dim=1).contiguous()) for t in tabs]
        want = [cs._tail_kernel("K6", t, p, k) for t, p in zip(tabs, dirs)]
        plan = launch_plan(k, "K6")
        if k == 160:
            for t, p, w in zip(tabs, dirs, want):
                err, ok = cs._tail_error("K6", w, cs._tail_plain_rows("K6", t, p, k))
                if not ok:
                    raise AssertionError(f"K6 K={k}: column error {err} vs plain")
            cs.log(f"  K={k}: the wrapper ({plan['form']}) vs plain per column: ok")
        fns = {f"wrapper ({plan['form']})": lambda t=tabs, k=k: [
            cs._tail_kernel("K6", tt, p, k) for tt, p in zip(t, dirs)]}
        old = "k6_group" if W <= 64 else "k6_wide"
        fns[old] = lambda t=tabs, k=k, old=old: [call(old, tt, p, k, W, Wq)
                                                for tt, p in zip(t, dirs)]
        for d, s in VARIANTS:
            if ring_smem(k, d, s) > MAX_SMEM:
                cs.log(f"  K={k} ring D={d} S={s}: {ring_smem(k, d, s)} B a CTA, past "
                       f"{MAX_SMEM}: not run")
                continue
            name = f"k6_ring_{V}_{d}_{s}"
            fns[name] = lambda t=tabs, k=k, name=name: [call(name, tt, p, k, W, Wq)
                                                       for tt, p in zip(t, dirs)]
        jname = f"k6_ring_{V}_4_3"
        fns[f"{jname} joined"] = lambda j=joined, k=k: [
            call(jname, (ms, jt, jt[:, 4 * W:]), p, k, W + Wq, W + Wq)
            for (ms, jt), p in zip(j, dirs)]
        worst = {}
        for name, fn in fns.items():
            outs = fn()
            col = max(cs.column_check(o, w)[1] for o, w in zip(outs, want))
            if col > cs.COL_RTOL:
                raise AssertionError(f"{name} K={k}: column error {col} vs the wrapper")
            worst[name] = col
            if name != old and not all(torch.equal(o, o2) for o, o2 in zip(outs, fn())):
                raise AssertionError(f"{name} K={k}: two launches differ in bits")
        del outs
        res = turns(fns)
        for name, (mean, v) in res.items():
            cs.log(f"  K={k} W={W} {name}: {mean:.4f} ms a sweep (turns "
                   + ", ".join(f"{x:.4f}" for x in v) + f") | column error vs the "
                   f"wrapper {worst[name]:.2e}")
        if k == 160:
            zeros = [torch.zeros_like(p.other) for p in dirs]
            cut = [p.other % 40_000 if j == 1 else p.other for j, p in enumerate(dirs)]
            for label, others in (("ids at row 0", zeros), ("item ids mod 40,000", cut)):
                fn = lambda others=others: [  # noqa: E731
                    ge.diag_tail_stats(*tt, p.row_ptr, o, p.x, K=k, long_rows=p.long_rows)
                    for tt, p, o in zip(tabs, dirs, others)]
                per = [cs.cuda_ms(lambda tt=tt, p=p, o=o: ge.diag_tail_stats(
                    *tt, p.row_ptr, o, p.x, K=k, long_rows=p.long_rows), reps=TURN_REPS)
                       for tt, p, o in zip(tabs, dirs, others)]
                cs.log(f"  K={k} wrapper, {label}: {cs.cuda_ms(fn, reps=TURN_REPS):.4f} ms "
                       f"a sweep (user {per[0]:.4f}, item {per[1]:.4f})")
            per = [cs.cuda_ms(lambda tt=tt, p=p: cs._tail_kernel("K6", tt, p, k),
                              reps=TURN_REPS) for tt, p in zip(tabs, dirs)]
            grp = [cs.cuda_ms(lambda tt=tt, p=p: call("k6_group", tt, p, k, W, Wq),
                              reps=TURN_REPS) for tt, p in zip(tabs, dirs)]
            cs.log(f"  K={k} by direction, user / item: wrapper {per[0]:.4f} / "
                   f"{per[1]:.4f}, k6_group {grp[0]:.4f} / {grp[1]:.4f}")
            sect = sum(cs._tail_reckoning("K6", p, k, t[0].nbytes, 12 * k * p.n_self)
                       for t, p in zip(tabs, dirs))
            cs.log(f"  K={k} per-edge sectors {sect / 1e9:.3f} GB "
                   f"({sect / cs.HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s)")
        del tabs, joined, want
        cs.gc_cuda()
    cs.log(f"probe k6 ring: ok | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
