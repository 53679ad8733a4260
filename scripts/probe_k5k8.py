#!/usr/bin/env python3
"""Time K5's and K8's sum form (``csrc/tail_groups.cuh::tail_sum_kernel``)
against their earlier forms and its variants on one CUDA card.

    python3 scripts/probe_k5k8.py [--ks 128,144,160,176,200,224,240,255,256,300,384,511]
                                  [--windows 1,2,3,4,6] [--scan-ks 160,255,384]

K5 is the Gaussian bias tail pass of ``pmf_tpu_torch``, K8 the extended
Poisson scalar pass.  The script builds the port's kernels
(``ops/_build.py``) and, beside them, one library of probe entry points
compiled from the same header: the register form's ``tail_group_kernel<
mode, 32, 2, 4>`` (both modes' form at 33 to 64 words a row before the sum
form), ``tail_wide_kernel<mode>`` (past 64 words), and the sum form at
several rounds of D edges and rings of S rounds, with each instance's
resident CTAs an SM.  On the bench's tails (``chip_smoke.py``'s phases data and gdata:
162,000 x 59,000 ids, 25M ratings; K8 on the Poisson layout, K5 on the
Gaussian one) with random tables at each K it times a sweep (both
directions) by CUDA events in turns: the port's wrapper with the other-id
windows its plan gives (``_tail.tail_windows``) and without, the earlier
form, each variant with and without the same windows.  Every output is held
to the port's without windows per column (``COL_RTOL``) and to itself on a
repeat (equal bits); the port to the plain version at K = 160.  At K = 160
it also times, by direction, the port and the earlier form with every
edge's other id set to 0 (every gather served by one row) and with the
item pass's other ids cut to 40,000 rows (the user table's L2 misses); at
the K of ``--scan-ks`` each pass in each ``--windows`` count of other-id
windows (one launch).  Every line also goes to
``chiprun_out/probe_k5k8.log``.
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

cs.LOG_PATH = os.path.join(ROOT, "chiprun_out", "probe_k5k8.log")

# (D, S) instances of the sum form beside the port's own (kSumInFlight,
# kSumStages): D edges a round, S rounds a ring.
VARIANTS = [(4, 3), (4, 4), (8, 2), (2, 6)]
VECS = (2, 3, 4)
MODES = {"K5": 5, "K8": 8}
MAX_SMEM = 232_448  # bytes of dynamic shared memory a CTA may ask for
TURN_REPS = 3

PROBE_SRC = r"""
#include "tail_groups.cuh"
using namespace tail_groups;
constexpr int kMode5 = kBias, kMode8 = kScalar;
#define ARGS const float* e_s, const float* e_o, const int64_t* row_ptr, \
    const int32_t* other, const float* x, int n_self, int n_long, int K, int n_win, \
    const int64_t* win_ptr, const int32_t* win_other, const float* win_x, float* part, \
    unsigned* count, float* out, void* stream
#define TABLES const Tables t{e_s, e_o, nullptr, row_ptr, other, x}
#define SUM(M, V, D, S) \
  extern "C" int k##M##_sum_##V##_##D##_##S(ARGS) { \
    TABLES; \
    const Windows win{n_win, win_ptr, win_other, win_x, part, count}; \
    return launch_sum<kMode##M, V, D, S>(t, n_self, K, win, out, \
                                         static_cast<cudaStream_t>(stream)); } \
  extern "C" int k##M##_sum_##V##_##D##_##S##_ctas(int K) { \
    auto kernel = tail_sum_kernel<kMode##M, V, D, S>; \
    const int smem = kDotWarps * 16 * dot_ring_words(plan_words(kMode##M, K), D, S); \
    if (smem > 48 * 1024) \
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    int n = 0; \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * kDotWarps, smem); \
    return n; }
#define OLD(M) \
  extern "C" int k##M##_group(ARGS) { \
    TABLES; \
    return launch_instance<kMode##M, 32, 2, kInFlight>(t, n_self, n_long, K, 0.f, out, \
                                                      static_cast<cudaStream_t>(stream)); } \
  extern "C" int k##M##_group_ctas(int K) { \
    int n = 0; \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        &n, tail_group_kernel<kMode##M, 32, 2, kInFlight>, kThreads, 0); \
    return n; } \
  extern "C" int k##M##_wide(ARGS) { \
    tail_wide_kernel<kMode##M><<<(n_self + kWarps - 1) / kWarps, kThreads, 0, \
                                 static_cast<cudaStream_t>(stream)>>>( \
        e_s, e_o, nullptr, row_ptr, other, x, n_self, K, 0.f, out); \
    return (int)cudaGetLastError(); }
OLD(5)
OLD(8)
%s
"""


def _sum_names(mode):
    return [f"k{MODES[mode]}_sum_{v}_{d}_{s}" for v in VECS for d, s in VARIANTS]


def build_probe():
    """The probe library, built with the port's nvcc flags into
    ``pmf_tpu_torch/_build/probe_k5k8/``; its ptxas lines logged."""
    from pmf_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "probe_k5k8"
    out_dir.mkdir(parents=True, exist_ok=True)
    sums = "\n".join(f"SUM({m}, {v}, {d}, {s})" for m in MODES.values() for v in VECS
                     for d, s in VARIANTS)
    src = out_dir / "probe.cu"
    src.write_text(PROBE_SRC % sums)
    lib = out_dir / "libprobe_k5k8.so"
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
    for mode in MODES:
        m = MODES[mode]
        for name in [f"k{m}_group", f"k{m}_wide"] + _sum_names(mode):
            fn = getattr(so, name)
            fn.argtypes = [P] * 5 + [I] * 4 + [P] * 7
            fn.restype = ctypes.c_int
        for name in [f"k{m}_group"] + _sum_names(mode):
            fn = getattr(so, name + "_ctas")
            fn.argtypes = [I]
            fn.restype = ctypes.c_int
    return so


def sum_smem(k, d, s):
    from pmf_tpu_torch.ops._tail import DOT_WARPS, dot_ring_words

    return DOT_WARPS * 16 * dot_ring_words(-(-(k + 1) // 4), d, s)


def main(argv=None) -> int:
    import torch

    from pmf_tpu_torch.ops import ext_edge as ee
    from pmf_tpu_torch.ops import gaussian_edge as ge
    from pmf_tpu_torch.ops._tail import build_windows, launch_plan, tail_windows, window_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="128,144,160,176,200,224,240,255,256,300,384,511")
    ap.add_argument("--windows", default="1,2,3,4,6")
    ap.add_argument("--scan-ks", default="160,255,384",
                    help="the K at which each pass is timed in every --windows count")
    args = ap.parse_args(argv)
    ks = [int(k) for k in args.ks.split(",")]
    n_windows = [int(n) for n in args.windows.split(",") if n]
    scan_ks = {int(k) for k in args.scan_ks.split(",") if k}
    from concurrent.futures import ThreadPoolExecutor

    smi = cs.phase_device()
    with ThreadPoolExecutor(1) as pool:  # the probe's nvcc beside the port's
        probe = pool.submit(build_probe)
        cs.phase_build()
        so = probe.result()
    _, _, pblocked, split = cs.phase_data()
    gblocked = cs.phase_gdata(split)[2]
    lays = {"K5": gblocked, "K8": pblocked}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def port(mode, tabs, p, k, windows=None, other=None):
        """The port's wrapper on ``p`` (``other`` in place of its ids), with
        ``windows`` (None: no windows)."""
        o = p.other if other is None else other
        kw = dict(K=k, long_rows=p.long_rows, windows=windows)
        if mode == "K8":
            return ee.ext_scalar_tail(*tabs, p.row_ptr, o, **kw)
        return ge.bias_tail_stats(*tabs, p.row_ptr, o, p.x, **kw)

    def call(name, tabs, p, k, other=None, windows=None):
        """A probe entry on ``p``'s tail with ``windows``."""
        e_s, e_o = (None, tabs[0]) if len(tabs) == 1 else tabs
        width = 1 if name.startswith("k8") else k + 2
        out = torch.empty((p.n_self,) if width == 1 else (p.n_self, k + 2), device="cuda")
        win = [a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in window_args(windows, p.n_self, width, out.device)]
        err = getattr(so, name)(
            None if e_s is None else e_s.data_ptr(), e_o.data_ptr(), p.row_ptr.data_ptr(),
            (p.other if other is None else other).data_ptr(), p.x.data_ptr(), p.n_self,
            p.long_rows, k, *win, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} K={k}: CUDA error {err}")
        return out

    def turns(fns):
        """{label: (mean ms a sweep, turns)} over the labels in order, then
        reversed."""
        got = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                got[name].append(cs.cuda_ms(fns[name], reps=TURN_REPS))
        return {name: (float(np.mean(v)), v) for name, v in got.items()}

    def cols(out):
        return out[:, None] if out.dim() == 1 else out

    for mode in MODES:
        m = MODES[mode]
        dirs = (lays[mode].by_user, lays[mode].by_item)
        for k in ks:
            W = -(-(k + 1) // 4)
            V = -(-W // 32)
            tabs = [cs._tail_tabs(mode, p.n_self, p.n_other, k, 70 + k + j)
                    for j, p in enumerate(dirs)]
            plan = launch_plan(k, mode)
            wins = [tail_windows(p, k, mode) for p in dirs]
            n_win = "/".join(str(1 if w is None else w.n) for w in wins)
            want = [port(mode, t, p, k) for t, p in zip(tabs, dirs)]
            if k == 160:
                for t, p, w, win in zip(tabs, dirs, want, wins):
                    for out in (w, port(mode, t, p, k, win)):
                        err, ok = cs._tail_error(mode, out,
                                                 cs._tail_plain_rows(mode, t, p, k))
                        if not ok:
                            raise AssertionError(f"{mode} K={k}: error {err} vs plain")
                cs.log(f"  {mode} K={k}: the port ({plan['form']}) vs plain, windows "
                       f"{n_win} and none: ok")
            old = f"k{m}_group" if W <= 64 else f"k{m}_wide"
            fns = {f"port ({plan['form']}, windows {n_win})": lambda t=tabs, k=k, wins=wins: [
                port(mode, tt, p, k, w) for tt, p, w in zip(t, dirs, wins)],
                "port, no windows": lambda t=tabs, k=k: [
                    port(mode, tt, p, k) for tt, p in zip(t, dirs)]}
            fns[old] = lambda t=tabs, k=k, old=old: [call(old, tt, p, k)
                                                    for tt, p in zip(t, dirs)]
            ctas = {}
            if W <= 64:
                ctas[old] = f"{getattr(so, old + '_ctas')(k) * 8} warps an SM"
            for d, s in VARIANTS:
                if sum_smem(k, d, s) > MAX_SMEM:
                    cs.log(f"  {mode} K={k} sum D={d} S={s}: {sum_smem(k, d, s)} B a CTA, "
                           f"past {MAX_SMEM}: not run")
                    continue
                name = f"k{m}_sum_{V}_{d}_{s}"
                blocks = getattr(so, name + "_ctas")(k)
                for label, ws in ((name, (None, None)), (f"{name} windows {n_win}", wins)):
                    if label != name and all(w is None for w in ws):
                        continue
                    fns[label] = lambda t=tabs, k=k, name=name, ws=ws: [
                        call(name, tt, p, k, windows=w) for tt, p, w in zip(t, dirs, ws)]
                    ctas[label] = (f"{blocks} CTAs ({4 * blocks} warps) an SM, "
                                   f"{sum_smem(k, d, s)} B a CTA")
            worst, bits = {}, {}
            for name, fn in fns.items():
                outs = fn()
                col = max(cs.column_check(cols(o), cols(w))[1] for o, w in zip(outs, want))
                if col > cs.COL_RTOL:
                    raise AssertionError(f"{name} K={k}: column error {col} vs the port")
                worst[name] = col
                bits[name] = all(torch.equal(o, w) for o, w in zip(outs, want))
                if not all(torch.equal(o, o2) for o, o2 in zip(outs, fn())):
                    raise AssertionError(f"{name} K={k}: two launches differ in bits")
            del outs
            res = turns(fns)
            for name, (mean, v) in res.items():
                cs.log(f"  {mode} K={k} W={W} {name}: {mean:.4f} ms a sweep (turns "
                       + ", ".join(f"{x:.4f}" for x in v) + ") | vs the port without "
                       "windows: "
                       + ("equal bits" if bits[name] else f"column error {worst[name]:.2e}")
                       + (f" | {ctas[name]}" if name in ctas else ""))
            if k in scan_ks:
                for j, (p, tt) in enumerate(zip(dirs, tabs)):
                    no_win = cs.cuda_ms(lambda: port(mode, tt, p, k), reps=TURN_REPS)
                    for nw in n_windows:
                        w = build_windows(p.row_ptr, p.other, p.x, p.n_other, nw)
                        col = cs.column_check(cols(port(mode, tt, p, k, w)), cols(want[j]))[1]
                        w_ms = cs.cuda_ms(lambda w=w: port(mode, tt, p, k, w), reps=TURN_REPS)
                        cs.log(f"  {mode} K={k} {('user', 'item')[j]} pass in {nw} windows "
                               f"of {-(-p.n_other // nw)} other rows, one launch: "
                               f"{w_ms:.4f} ms (no windows {no_win:.4f}) | column error vs "
                               f"no windows {col:.2e}")
                        del w
            if k == 160:
                by = {}
                zeros = [torch.zeros_like(p.other) for p in dirs]
                cut = [p.other % 40_000 if j == 1 else p.other for j, p in enumerate(dirs)]
                for label, others in (("as is", [p.other for p in dirs]),
                                      ("ids at row 0", zeros),
                                      ("item ids mod 40,000", cut)):
                    for name in ("port", old):
                        per = [cs.cuda_ms(
                            (lambda tt=tt, p=p, o=o: port(mode, tt, p, k, other=o))
                            if name == "port" else
                            (lambda tt=tt, p=p, o=o: call(old, tt, p, k, other=o)),
                            reps=TURN_REPS) for tt, p, o in zip(tabs, dirs, others)]
                        by[(label, name)] = per
                        cs.log(f"  {mode} K={k} {name} (no windows), {label}: user "
                               f"{per[0]:.4f}, item {per[1]:.4f} ms")
                for name in ("port", old):
                    full = by[("as is", name)][1]
                    cut_ms = by[("item ids mod 40,000", name)][1]
                    zero_ms = by[("ids at row 0", name)][1]
                    cs.log(f"  {mode} K={k} {name}: the item pass's share above its ids-cut "
                           f"time {(full - cut_ms) / full:.1%}, above ids-at-0 "
                           f"{(full - zero_ms) / full:.1%}")
                sect = sum(cs._tail_reckoning(
                    mode, p, k, sum(t[i].nbytes for i in cs.SELF_TABS[mode]),
                    4 * p.n_self * (k + 2 if mode == "K5" else 1))
                    for t, p in zip(tabs, dirs))
                cs.log(f"  {mode} K={k} per-edge sectors {sect / 1e9:.3f} GB "
                       f"({sect / cs.HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s) | {n_sm} SMs")
            del tabs, want
            cs.gc_cuda()
    cs.log(f"probe k5k8: ok | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
