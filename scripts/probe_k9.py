#!/usr/bin/env python3
"""Break down K9's time (``csrc/map_grad.cu``, the HPF-MAP gradient kernel)
and time the stream form (``scripts/probe_k9_stream.cuh``, tried and not
kept in the port) against the port's one-warp-a-piece forms on one CUDA
card.

    python3 scripts/probe_k9.py --part breakdown [--ks 20,50,128,160] [--parent DIR]
    python3 scripts/probe_k9.py --part stream [--ks 129,160,200,256,257,300,384,512]
    python3 scripts/probe_k9.py --part parts
    python3 scripts/probe_k9.py --part parent --parent DIR

K9 is the gradient pass of ``pmf_tpu_torch``'s blocked HPF-MAP engine.  The
data is the bench's HPF-MAP layout (``chip_smoke.py``'s phases data and
mdata: 162,000 x 59,000 ids, 25M ratings less 100,000 held out,
``batch_size=65536``, ``mix=8``, the same epoch order) with softplus'd
random tables at each K.  Every time is one epoch of launches (380 steps,
both directions or one) captured in a CUDA graph and replayed, by CUDA
events: no host pacing.  The labels of a table are timed in turns (in
order, then reversed).

Part "breakdown", at each K of ``--ks``.  To K = 128 (the runs form): the
runs by length class (1, 2-4, 5-32, 33-128, > 128 edges) and each step's
classes and grid; the port against the plain version on real steps (the
step of the longest item run among them) and a second launch in bits;
then per direction, in turns, the port as it is, with its edge walk and
with its long runs' merge compiled out, on other short-run thresholds and
piece lengths and, with ``--parent DIR`` (a checkout of another commit),
the parent's form as it is, without its edge loop, its merge, its lane
form's reduce-scatter, and with its grid sized by each step's own pieces
in place of the largest step's; the step of the longest item run alone
with and without the merge; the ptxas lines and resident warps an SM of
each instance timed.  Past K = 128: the wide form whole, without its edge
loop, without its merge, and with every other id at row 0 (each gather
served by one row), in turns; the ptxas lines and the resident warps an
SM of ``map_grad_wide_kernel<5>`` and of the stream form's instances; and
the port's wrapper against the plain version on real steps (not timed).
Part "stream": at each K, the parent's plan (one warp a piece on pieces of
<= 128 edges), the port's wrapper (one warp a piece on its own grouping)
and the stream form's variants on that grouping, in turns; at K = 300 the
stream form on other pieces and spans; at K = 50 and 128 the stream form
beside the port.  Part "parts": the stream form at K = 160 with its
copies, its waits or its batched merge loads cut out of the source, and on
other pieces and spans.  Part "parent": ``chip_smoke.py``'s phase k9
parent alone.  The probe libraries are compiled from the sources (this
tree's, the stream header, the parent's) with parts cut out by text, one
``nvcc`` each, beside the port's build, into
``pmf_tpu_torch/_build/probe_k9/``.  Every line also goes to
``chiprun_out/probe_k9_<part>.log``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


# (D, S) of the stream form timed beside the plan's at each F.
VARIANTS = {5: [(4, 3), (4, 2), (2, 3), (8, 2), (4, 4)], 7: [(4, 3)], 8: [(4, 3)],
            9: [(4, 3), (2, 3)], 10: [(4, 3), (2, 3)], 12: [(4, 3), (2, 3)],
            16: [(2, 3), (4, 3), (4, 2)], 2: [(4, 3)], 4: [(4, 3)]}
SPAN_EDGES = 16  # a span's pieces start inside one window of this many edges of the step
REPS = 3
PTXAS: dict = {}  # the probe library's ptxas lines by kernel

# Patches of the source: (anchor, replacement) pairs, each anchor found once.
OTHER_COPY = "            if (k < K) cp_async4(rows + d * K + k, orow + k);\n"
SELF_COPY = "          if (k < K) cp_async4(rows + D * K + k, srow + k);\n"
X_COPY = "      if (lane < n) cp_async4(ring_x + st * D + lane, pc.x + ebase + e0 + lane);\n"
ASYNC4 = ('  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(s), "l"(src) : '
          '"memory");\n}\n\n__device__ __forceinline__ void cp_async_commit()')
STREAM_CUTS = {  # the stream header cut, timed at K = 160 by --part parts
    "sync": [(ASYNC4, '  (void)s;\n  *static_cast<float*>(dst) = __ldg(static_cast<const float*>(src));'
                      '\n}\n\n__device__ __forceinline__ void cp_async_commit()')],
    "noother": [(OTHER_COPY, "")],
    "noself": [(SELF_COPY, "")],
    "nox": [(X_COPY, "")],
    "wait0": [("    cp_async_wait<S - 1>();  // round r has landed",
               "    cp_async_wait<0>();  // round r has landed")],
    "serialmerge": [("constexpr int kMergeLoads = 8;", "constexpr int kMergeLoads = 1;")],
}
CUTS = {
    "noedges": ("    for (int64_t base = begin; base < end; base += 32) {\n"
                "      const int64_t left = end - base;\n"
                "      const int n = left < 32 ? (int)left : 32;\n"
                "      int my_o = 0;\n"
                "      float my_x = 0.f;\n"
                "      if (lane < n) {\n"
                "        my_o = pc.other[base + lane];\n"
                "        my_x = pc.x[base + lane];\n"
                "      }\n"
                "      int j = 0;",
                "    for (int64_t base = begin; base < begin; base += 32) {\n"
                "      const int64_t left = end - base;\n"
                "      const int n = left < 32 ? (int)left : 32;\n"
                "      int my_o = 0;\n"
                "      float my_x = 0.f;\n"
                "      if (lane < n) {\n"
                "        my_o = pc.other[base + lane];\n"
                "        my_x = pc.x[base + lane];\n"
                "      }\n"
                "      int j = 0;"),
    "nomerge": ("  store_row(scratch + (int64_t)(p - p0) * width, v, count, nll, K, with_nll, lane);\n"
                "  merge_run(pc, p, p0, row, n, width, out, scratch, counters, lane);\n",
                "  store_row(scratch + (int64_t)(p - p0) * width, v, count, nll, K, with_nll, lane);\n"),
}

# The runs form (this tree, K <= 128) and the parent's forms at K <= 128,
# each cut by text: (anchor, replacement) pairs.
RUNS_CUTS = {
    "runs_noedges": [("  for (int base = 0; base < span; base += G) {",
                      "  for (int base = 0; base < 0; base += G) {")],
    "runs_nomerge": [("  if (n_run > 1) merge_run(pc, p, p0, row, n_run, width, out, scratch, "
                      "counters, lane);\n}\n", "}\n")],
}
PARENT_CUTS = {
    "parent": [],
    "parent_noedges": [("    for (int64_t e = begin + lane; e < end; e += 32) {",
                        "    for (int64_t e = begin + lane; e < begin; e += 32) {"),
                       CUTS["noedges"]],
    "parent_nomerge": [CUTS["nomerge"]],
    "parent_noreduce": [("    const float total[1] = {warp_reduce_scatter(v, lane)};",
                         "    const float total[1] = {v[0]};")],
}
CUT_SRC = r"""
#include "%(source)s"
extern "C" int probe_occupancy(int which, int* blocks) {
  switch (which) {
%(cases)s
    default: return (int)cudaErrorInvalidValue;
  }
}
"""

PROBE_SRC = r"""
#include "%(source)s"
#include "%(stream)s"
#define ARGS const float* self_tab, const float* other_tab, const int32_t* step_off, \
    int step, int max_pieces, const int64_t* piece_ptr, const int32_t* piece_row, \
    const int32_t* piece_first, const int32_t* piece_count, const int32_t* step_span, \
    const int32_t* span_first, int max_spans, const int32_t* other, const float* x, int K, \
    float lam_floor, int with_nll, float* out, float* scratch, unsigned* counters, \
    void* stream
#define PREP \
  const Pieces pc{step_off, piece_ptr, piece_row, piece_first, piece_count, other, x}; \
  const Spans sp{step_span, span_first}; \
  const cudaStream_t st = static_cast<cudaStream_t>(stream); \
  const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock
#define OLD(KERNEL) \
  KERNEL<<<blocks, kWarpsPerBlock * 32, 0, st>>>(self_tab, other_tab, pc, step, K, \
      lam_floor, with_nll, out, scratch, counters)
// The one-warp-a-piece forms: map_grad_wide_kernel<F> at F = ceil(K / 32)
// up to 8, the general form past it.
extern "C" int probe_old(ARGS) {
  PREP;
  (void)sp;
  switch ((K + 31) / 32) {
    case 5: OLD(map_grad_wide_kernel<5>); break;
    case 6: OLD(map_grad_wide_kernel<6>); break;
    case 7: OLD(map_grad_wide_kernel<7>); break;
    case 8: OLD(map_grad_wide_kernel<8>); break;
    default: OLD(map_grad_general_kernel);
  }
  return (int)cudaGetLastError();
}
extern "C" int probe_occupancy_wide(int F, int* blocks) {
  switch (F) {
    case 5: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, map_grad_wide_kernel<5>, kWarpsPerBlock * 32, 0);
    case 8: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, map_grad_wide_kernel<8>, kWarpsPerBlock * 32, 0);
    default: return (int)cudaErrorInvalidValue;
  }
}
#define STREAM(F, D, S) \
  extern "C" int probe_stream_##F##_##D##_##S(ARGS) { \
    PREP; \
    (void)blocks; \
    return launch_stream<F, D, S>(self_tab, other_tab, pc, sp, step, max_spans, K, \
                                  lam_floor, with_nll, out, scratch, counters, st); \
  } \
  extern "C" int probe_occupancy_##F##_##D##_##S(int K, int* blocks) { \
    const int smem = kStreamWarps * 4 * stream_ring_floats(K, D, S); \
    if (smem > 48 * 1024)  /* as launch_stream: a smaller cap would refuse a wider K */ \
      cudaFuncSetAttribute(map_grad_stream_kernel<F, D, S>, \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        blocks, map_grad_stream_kernel<F, D, S>, kStreamWarps * 32, smem); \
  }
%(streams)s
"""


def _cut(text: str, patches, name: str, what: str) -> str:
    for anchor, repl in patches:
        if text.count(anchor) != 1:
            raise SystemExit(f"probe cut {name}: its anchor is not found once in {what}")
        text = text.replace(anchor, repl)
    return text


def build_probe(name: str, streams: bool):
    """One probe library: csrc/map_grad.cu with the cut ``name`` ("full",
    "noedges", "nomerge" or one of STREAM_CUTS), the stream form's header
    after it, and their entry points, built with the port's nvcc flags into
    ``pmf_tpu_torch/_build/probe_k9/``; (library, ptxas lines)."""
    from pmf_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "probe_k9"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = _cut((_build.SRC_DIR / "map_grad.cu").read_text(),
                [CUTS[name]] if name in CUTS else [], name, "map_grad.cu")
    (out_dir / f"map_grad_{name}.cu").write_text(text)
    stream = _cut(open(os.path.join(ROOT, "scripts", "probe_k9_stream.cuh")).read(),
                  STREAM_CUTS.get(name, []), name, "probe_k9_stream.cuh")
    (out_dir / f"stream_{name}.cuh").write_text(stream)
    pairs = [(f, d, s) for f, v in VARIANTS.items() for d, s in v] if streams is True \
        else list(streams or [])
    src = out_dir / f"probe_{name}.cu"
    src.write_text(PROBE_SRC % {"source": f"map_grad_{name}.cu",
                                "stream": f"stream_{name}.cuh", "streams": "\n".join(
        f"STREAM({f}, {d}, {s})" for f, d, s in pairs)})
    lib = out_dir / f"libprobe_k9_{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
         "-I", str(_build.SRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"probe build {name} failed:\n" + proc.stdout + proc.stderr)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = [P, P, P, I, I, P, P, P, P, P, P, I, P, P, I, F, I, P, P, P, P]
    names = ["probe_old"] + [f"probe_stream_{f}_{d}_{s}" for f, d, s in pairs]
    for n in names:
        getattr(so, n).argtypes = sig
        getattr(so, n).restype = I
    so.probe_occupancy_wide.argtypes = [I, ctypes.POINTER(I)]
    for f, d, s in pairs:
        getattr(so, f"probe_occupancy_{f}_{d}_{s}").argtypes = [I, ctypes.POINTER(I)]
    report = cs._ptxas_report(proc.stdout + proc.stderr, {})
    return so, report, time.perf_counter() - t0


def build_cut(name: str, source: str, patches, kernels):
    """One probe library: ``source`` (a map_grad.cu) with ``patches`` (pairs
    whose anchor is not found are left out and named) and an occupancy
    export for each of ``kernels``; (library, ptxas lines, seconds, cuts
    not found)."""
    from pmf_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "probe_k9"
    out_dir.mkdir(parents=True, exist_ok=True)
    text, missed = open(source).read(), []
    for anchor, repl in patches:
        if text.count(anchor) == 1:
            text = text.replace(anchor, repl)
        else:
            missed.append(anchor.strip()[:40])
    (out_dir / f"{name}.cu").write_text(text)
    src = out_dir / f"probe_{name}.cu"
    cases = "\n".join(
        f"    case {n}: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, {k}, "
        f"kWarpsPerBlock * 32, 0);" for n, k in enumerate(kernels))
    src.write_text(CUT_SRC % {"source": f"{name}.cu", "cases": cases})
    lib = out_dir / f"libprobe_k9_{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
         "-I", str(_build.SRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"probe build {name} failed:\n" + proc.stdout + proc.stderr)
    so = ctypes.CDLL(str(lib))
    for entry in ("pmf_map_grad", "pmf_map_grad_runs"):
        if hasattr(so, entry) and entry in _build.SIGNATURES:
            getattr(so, entry).argtypes = _build.SIGNATURES[entry]
            getattr(so, entry).restype = ctypes.c_int
    so.probe_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return so, cs._ptxas_report(proc.stdout + proc.stderr, {}), time.perf_counter() - t0, missed


def map_layout():
    """phase mdata's layout and epoch order on the bench's training split."""
    from pmf_tpu_torch.data.synthetic import synth
    from pmf_tpu_torch.models.hpf_map import build_map_layout

    u, i, x = synth(cs.N_USERS, cs.N_ITEMS, cs.NNZ, seed=0)
    rng = np.random.default_rng(1)
    val_idx = cs.N_USERS + rng.choice(cs.NNZ - cs.N_USERS, size=cs.N_VAL, replace=False)
    keep = np.ones(cs.NNZ, dtype=bool)
    keep[val_idx] = False
    lay = build_map_layout(u[keep], i[keep], x[keep], cs.N_USERS, cs.N_ITEMS, cs.MAP_BATCH,
                           mix=cs.MAP_MIX, device="cuda")
    rng = np.random.default_rng(3)
    rng.permutation(lay.n_segments)
    return lay, rng.permutation(lay.n_segments)


Spans = collections.namedtuple("Spans", "step_span span_first max_spans span_edges")


def spans(g, span_edges: int) -> Spans:
    """The stream form's spans of the grouping ``g``: span j is the pieces
    ``span_first[j] .. span_first[j + 1]``, those of one step whose first
    edge lies in one window of ``span_edges`` edges from the step's first
    edge on (so fewer than ``span_edges`` + the longest piece's edges);
    step s owns spans ``step_span[s] .. step_span[s + 1]``."""
    import torch

    dev = g.piece_ptr.device
    step_of = torch.repeat_interleave(torch.arange(g.n_steps, device=dev),
                                      torch.diff(g.step_off), output_size=g.n_pieces)
    start = g.piece_ptr[:-1]
    window = (start - g.piece_ptr[g.step_off[:-1].long()][step_of]) // span_edges
    new_span = torch.ones(g.n_pieces, dtype=torch.bool, device=dev)
    new_span[1:] = (window[1:] != window[:-1]) | (step_of[1:] != step_of[:-1])
    starts = torch.nonzero(new_span).squeeze(1)
    span_first = torch.cat([starts, torch.tensor([g.n_pieces], device=dev)])
    step_span = torch.searchsorted(starts, g.step_off.to(starts.dtype))
    most = int(torch.diff(step_span).max()) if g.n_steps else 0
    return Spans(step_span.to(torch.int32), span_first.to(torch.int32), most, span_edges)


def grouping(lay, order, k, span_edges=SPAN_EDGES, piece=None):
    """Both directions' grouping of the epoch at ``k`` factors, runs cut
    into pieces of at most ``piece`` edges (the port's ``piece_of(k)`` by
    default), each with its spans of ``span_edges`` as an attribute
    ``spans`` (set past the frozen dataclass: the port's groupings carry
    none)."""
    from pmf_tpu_torch.ops import map_grad as mg

    groups = (mg.group_steps(lay.u, lay.i, lay.x, lay.seg_off, order, cs.MAP_MIX, lay.n_users,
                             k, piece),
              mg.group_steps(lay.i, lay.u, lay.x, lay.seg_off, order, cs.MAP_MIX, lay.n_items,
                             k, piece))
    for g in groups:
        object.__setattr__(g, "spans", spans(g, span_edges))
    return groups


def piece_stats(groups) -> None:
    import torch

    for name, g in zip(("by_user", "by_item"), groups):
        lens = torch.diff(g.piece_ptr)
        bins = [(1, 1), (2, 4), (5, 32), (33, 128)]
        counts = [int(((lens >= lo) & (lens <= hi)).sum()) for lo, hi in bins]
        edges = [int(lens[(lens >= lo) & (lens <= hi)].sum()) for lo, hi in bins]
        multi = g.piece_count > 1
        runs_multi = int((multi & (g.piece_first == torch.arange(
            g.n_pieces, device=lens.device, dtype=torch.int32))).sum())
        cs.log(f"  {name}: {g.n_pieces / g.n_steps:.1f} pieces a step ("
               + ", ".join(f"{lo}-{hi} edges {c / g.n_steps:.1f} ({e / lens.sum().item():.1%} "
                           f"of edges)" for (lo, hi), c, e in zip(bins, counts, edges))
               + f") | runs {g.n_runs / g.n_steps:.1f} a step, of more than one piece "
               f"{runs_multi / g.n_steps:.2f} a step ({int(multi.sum()) / g.n_steps:.1f} "
               f"pieces) | spans of {g.spans.span_edges} "
               f"{(g.spans.span_first.shape[0] - 1) / g.n_steps:.1f} a step (most "
               f"{g.spans.max_spans})")


def caller(so, name, groups, u_sp, i_sp, accs, other=None, steps=None):
    """A call that launches entry ``name`` of ``so`` twice a step, every step
    of ``groups`` or ``steps`` (``other``: replacement other ids, a pair)."""
    import torch

    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR

    fn = getattr(so, name)
    k = u_sp.shape[1] - 1
    dirs = [(u_sp, i_sp, groups[0], 1, accs[0]), (i_sp, u_sp, groups[1], 0, accs[1])]
    others = other or (groups[0].other, groups[1].other)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(groups[0].n_steps) if steps is None else steps:
            for (st, ot, g, nll, acc), o in zip(dirs, others):
                sp = g.spans
                err = fn(st.data_ptr(), ot.data_ptr(), g.step_off.data_ptr(), s,
                         g.max_step_pieces, g.piece_ptr.data_ptr(), g.piece_row.data_ptr(),
                         g.piece_first.data_ptr(), g.piece_count.data_ptr(),
                         sp.step_span.data_ptr(), sp.span_first.data_ptr(), sp.max_spans,
                         o.data_ptr(), g.x.data_ptr(), k, LAMBDA_FLOOR, nll, acc.data_ptr(),
                         g.scratch.data_ptr(), g.counters.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name} K={k} step {s}: CUDA error {err}")

    return run


def port_call(groups, u_sp, i_sp, accs):
    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops.map_grad import map_grad_pieces

    def run():
        for s in range(groups[0].n_steps):
            map_grad_pieces(u_sp, i_sp, groups[0], s, LAMBDA_FLOOR, True, accs[0])
            map_grad_pieces(i_sp, u_sp, groups[1], s, LAMBDA_FLOOR, False, accs[1])

    return run


def accumulators(u_sp, i_sp):
    import torch

    k = u_sp.shape[1] - 1
    return (torch.zeros((u_sp.shape[0], k + 2), device="cuda"),
            torch.zeros((i_sp.shape[0], k + 1), device="cuda"))


def turns(fns: dict) -> dict:
    """{label: (mean ms an epoch, [turns])}: each call replayed from a CUDA
    graph, the labels in order, then reversed."""
    graphs = {name: cs.graph_of(fn) for name, fn in fns.items()}
    got = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            got[name].append(cs.graph_ms(graphs[name], reps=REPS))
    return {name: (float(np.mean(v)), v) for name, v in got.items()}


def step_check(label, fn, groups, u_sp, i_sp, accs, lay, order, steps=(0, 7, 191, 379)):
    """``fn``'s accumulators of a few steps against the plain version per
    column (COL_RTOL), counts exact; returns the worst column ratio."""
    import torch

    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops.map_grad import map_grad_plain

    k = u_sp.shape[1] - 1
    worst = 0.0
    sub = [(s, order[s * cs.MAP_MIX:(s + 1) * cs.MAP_MIX]) for s in steps]
    for s, seg_ids in sub:
        for a in accs:
            a.zero_()
        fn(s)
        ref_u, ref_i = map_grad_plain(u_sp, i_sp, *cs._step_coo(lay, seg_ids), LAMBDA_FLOOR)
        for got, ref in zip(accs, (ref_u, ref_i)):
            _, col, ok = cs.column_check(got, ref)
            if not ok or not torch.equal(got[:, k], ref[:, k]):
                raise AssertionError(f"{label} K={k} step {s}: column error {col} vs plain")
            worst = max(worst, col)
    return worst


def one_step(so, name, groups, u_sp, i_sp, accs):
    """A call of one step (both directions) through entry ``name`` of
    ``so``, or through the port's wrapper where ``name`` is None."""
    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops.map_grad import map_grad_pieces

    if name is None:
        def run(s):
            map_grad_pieces(u_sp, i_sp, groups[0], s, LAMBDA_FLOOR, True, accs[0])
            map_grad_pieces(i_sp, u_sp, groups[1], s, LAMBDA_FLOOR, False, accs[1])

        return run
    return lambda s: caller(so, name, groups, u_sp, i_sp, accs, steps=[s])()


def part_breakdown(libs, lay, order, k=cs.K_HUGE):
    """The wide form past K = 128 (``map_grad_wide_kernel<5>``'s cuts)."""
    import torch

    from pmf_tpu_torch.ops.map_grad import kernel_of

    groups = grouping(lay, order, k)
    piece_stats(groups)
    u_sp, i_sp = cs._map_tables(lay, k)
    accs = accumulators(u_sp, i_sp)
    zeros = (torch.zeros_like(groups[0].other), torch.zeros_like(groups[1].other))
    fns = {"wide<5>": caller(libs["full"][0], "probe_old", groups, u_sp, i_sp, accs),
           "wide<5> without its edge loop": caller(libs["noedges"][0], "probe_old", groups,
                                                   u_sp, i_sp, accs),
           "wide<5> without its merge": caller(libs["nomerge"][0], "probe_old", groups,
                                               u_sp, i_sp, accs),
           "wide<5>, other ids at row 0": caller(libs["full"][0], "probe_old", groups,
                                                 u_sp, i_sp, accs, zeros)}
    worst = step_check("wide<5>", one_step(libs["full"][0], "probe_old", groups, u_sp, i_sp,
                                           accs), groups, u_sp, i_sp, accs, lay, order)
    cs.log(f"  K={k} wide<5> vs plain on 4 steps: worst column {worst:.3e}")
    for name, (mean, v) in turns(fns).items():
        cs.log(f"  K={k} {name}: {mean:.4f} ms an epoch of {2 * groups[0].n_steps} launches "
               f"(graph replays, turns " + ", ".join(f"{t:.4f}" for t in v) + ")")
    n = ctypes.c_int(0)
    libs["full"][0].probe_occupancy_wide(5, ctypes.byref(n))
    cs.log(f"  map_grad_wide_kernel<5>: {PTXAS.get('map_grad_wide_kernel<5>')} | "
           f"{n.value} CTAs of 8 warps an SM ({8 * n.value} warps)")
    worst = step_check("the port's wrapper", one_step(None, None, groups, u_sp, i_sp, accs),
                       groups, u_sp, i_sp, accs, lay, order)
    again = [a.clone() for a in accs]
    for a in accs:
        a.zero_()
    one_step(None, None, groups, u_sp, i_sp, accs)(379)
    bits = all(torch.equal(a, b) for a, b in zip(accs, again))
    cs.log(f"  K={k} the port's wrapper ({kernel_of(k)}) vs plain on 4 steps: worst column "
           f"{worst:.3e}; a second launch equal in bits {bits} (not timed)")
    if not bits:
        raise AssertionError("the port's wrapper: a second launch differs in bits")


def _dir_call(so, entry, g, self_tab, other_tab, acc, with_nll, own_grid=False, steps=None):
    """A call that launches ``entry`` of ``so`` for one direction of every
    step of ``g`` (or ``steps``): the parent's ``pmf_map_grad`` (its grid
    from the largest step, or with ``own_grid`` from each step's own
    pieces) or this tree's ``pmf_map_grad_runs``."""
    import torch

    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR

    fn = getattr(so, entry)
    k = self_tab.shape[1] - 1
    own = np.diff(g.step_off.cpu().numpy())
    tail = (g.piece_ptr.data_ptr(), g.piece_row.data_ptr(), g.piece_first.data_ptr(),
            g.piece_count.data_ptr(), g.other.data_ptr(), g.x.data_ptr(), k, LAMBDA_FLOOR,
            int(with_nll), acc.data_ptr(), g.scratch.data_ptr(), g.counters.data_ptr())

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(g.n_steps) if steps is None else steps:
            if entry == "pmf_map_grad_runs":
                head = (int(g.step_first[s]), int(g.step_long[s]), int(g.step_short[s]))
            else:
                head = (g.step_off.data_ptr(), s, int(own[s]) if own_grid else g.max_step_pieces)
            err = fn(self_tab.data_ptr(), other_tab.data_ptr(), *head, *tail, stream)
            if err:
                raise RuntimeError(f"{entry} K={k} step {s}: CUDA error {err}")

    return run


def _port_dir(g, self_tab, other_tab, acc, with_nll, steps=None):
    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops.map_grad import map_grad_pieces

    def run():
        for s in range(g.n_steps) if steps is None else steps:
            map_grad_pieces(self_tab, other_tab, g, s, LAMBDA_FLOOR, with_nll, acc)

    return run


def _occupancy(so, which) -> int:
    n = ctypes.c_int(0)
    err = so.probe_occupancy(which, ctypes.byref(n))
    return n.value if err == 0 else -1


@contextlib.contextmanager
def short_run(edges: int):
    """The port's grouping with short runs of at most ``edges`` edges."""
    from pmf_tpu_torch.ops import map_grad

    kept = map_grad.SHORT_RUN
    map_grad.SHORT_RUN = edges
    try:
        yield
    finally:
        map_grad.SHORT_RUN = kept


def breakdown_runs(libs, lay, order, k, pm) -> None:
    """The runs form at ``k`` <= 128 beside its cuts, other thresholds and
    pieces and, with a parent (``pm``: its ops/map_grad.py), the parent's
    form and its cuts, per direction in turns (module text)."""
    import torch

    from pmf_tpu_torch.ops.map_grad import PIECE, kernel_of, short_of

    groups = lay.group(order, cs.MAP_MIX, k)
    for name, g in zip(("by_user", "by_item"), groups):
        cs._log_run_classes(f"K={k} {name}", g)
    u_sp, i_sp = cs._map_tables(lay, k)
    accs = accumulators(u_sp, i_sp)
    longest, n_long = cs._longest_run_step(groups[1])
    checked = (0, 7, 191, 379, longest)
    worst = step_check("the port", one_step(None, None, groups, u_sp, i_sp, accs), groups,
                       u_sp, i_sp, accs, lay, order, steps=checked)
    again = [a.clone() for a in accs]
    for a in accs:
        a.zero_()
    one_step(None, None, groups, u_sp, i_sp, accs)(longest)
    bits = all(torch.equal(a, b) for a, b in zip(accs, again))
    cs.log(f"  K={k} the port {kernel_of(k)} vs plain on steps {checked} (step {longest}: the "
           f"longest item run, {n_long} edges): worst column {worst:.3e}; a second launch "
           f"equal in bits {bits}")
    if not bits or not worst <= cs.COL_RTOL:
        raise AssertionError(f"K={k}: the runs form disagrees")
    pgroups = None
    if pm is not None:
        pgroups = (pm.group_steps(lay.u, lay.i, lay.x, lay.seg_off, order, cs.MAP_MIX,
                                  lay.n_users, k),
                   pm.group_steps(lay.i, lay.u, lay.x, lay.seg_off, order, cs.MAP_MIX,
                                  lay.n_items, k))
    other_groups = {}
    for sh, pc in ((8, PIECE), (32, PIECE), (short_of(k), 32), (short_of(k), 128), (32, 128)):
        with short_run(sh):
            other_groups[f"short <= {sh}, pieces of <= {pc}"] = lay.group(
                order, cs.MAP_MIX, k, piece=pc)
    for d, (name, with_nll) in enumerate((("by user", True), ("by item", False))):
        tabs = (u_sp, i_sp) if with_nll else (i_sp, u_sp)
        acc = accs[d]
        fns = {f"this {kernel_of(k)} (short <= {short_of(k)}, pieces <= {PIECE})":
               _port_dir(groups[d], *tabs, acc, with_nll)}
        for c in RUNS_CUTS:
            fns[f"this, {c}"] = _dir_call(libs[c][0], "pmf_map_grad_runs", groups[d], *tabs,
                                          acc, with_nll)
        for v, g2 in other_groups.items():
            fns[f"this, {v}"] = _port_dir(g2[d], *tabs, acc, with_nll)
        if pgroups is not None:
            pg = pgroups[d]
            for c in PARENT_CUTS:
                fns[c] = _dir_call(libs[c][0], "pmf_map_grad", pg, *tabs, acc, with_nll)
            fns["parent, grid by the step's own pieces"] = _dir_call(
                libs["parent"][0], "pmf_map_grad", pg, *tabs, acc, with_nll, own_grid=True)
        for label, (mean, v) in turns(fns).items():
            cs.log(f"  K={k} {name} {label}: {mean:.4f} ms an epoch of {groups[0].n_steps} "
                   "launches (turns " + ", ".join(f"{t:.4f}" for t in v) + ")")
    # The step of the longest item run alone (20 launches a replay).
    tabs = (i_sp, u_sp)
    fns = {"this": _port_dir(groups[1], *tabs, accs[1], False, steps=[longest] * 20),
           "this, runs_nomerge": _dir_call(libs["runs_nomerge"][0], "pmf_map_grad_runs",
                                           groups[1], *tabs, accs[1], False,
                                           steps=[longest] * 20)}
    if pgroups is not None:
        for c in ("parent", "parent_nomerge"):
            fns[c] = _dir_call(libs[c][0], "pmf_map_grad", pgroups[1], *tabs, accs[1], False,
                               steps=[longest] * 20)
    for label, (mean, v) in turns(fns).items():
        cs.log(f"  K={k} by item, step {longest} ({n_long}-edge run) {label}: "
               f"{mean / 20 * 1e3:.2f} us a launch (turns "
               + ", ".join(f"{t / 20 * 1e3:.2f}" for t in v) + ")")
    del groups, other_groups, pgroups, accs, u_sp, i_sp
    cs.gc_cuda()


def part_stream(libs, lay, order, ks):
    """At each K: the parent's plan (one warp a piece, pieces of <= 128
    edges), this tree's wrapper, and the stream form's (D, S) variants on
    this tree's grouping, in turns; the stream form's pieces and spans at
    K = 300; the stream form at K = 50 and 128 beside the port."""
    from pmf_tpu_torch.ops.map_grad import PIECE, kernel_of

    so = libs["full"][0]
    for k in ks:
        f = -(-k // 32)
        groups = grouping(lay, order, k)
        old = grouping(lay, order, k, piece=PIECE)
        u_sp, i_sp = cs._map_tables(lay, k)
        accs = accumulators(u_sp, i_sp)
        fns = {"parent (pieces of <= 128)": caller(so, "probe_old", old, u_sp, i_sp, accs),
               f"this {kernel_of(k)}": port_call(groups, u_sp, i_sp, accs)}
        for d, s in VARIANTS.get(f, []):
            name = f"stream D={d} S={s}"
            ent = f"probe_stream_{f}_{d}_{s}"
            fns[name] = caller(so, ent, groups, u_sp, i_sp, accs)
            worst = step_check(name, one_step(so, ent, groups, u_sp, i_sp, accs),
                               groups, u_sp, i_sp, accs, lay, order, steps=(7, 379))
            n = ctypes.c_int(0)
            getattr(so, f"probe_occupancy_{f}_{d}_{s}")(k, ctypes.byref(n))
            cs.log(f"  K={k} {name}: {PTXAS.get(f'map_grad_stream_kernel<{f}, {d}, {s}>')}"
                   f" | {n.value} CTAs of 4 warps an SM | worst column vs plain {worst:.3e}")
        worst = step_check("this", one_step(None, None, groups, u_sp, i_sp, accs), groups,
                           u_sp, i_sp, accs, lay, order, steps=(7, 379))
        b_ms, b_by, _ = cs._map_bound(groups, k)
        for name, (mean, v) in turns(fns).items():
            cs.log(f"  K={k} {name}: {mean:.4f} ms an epoch (turns "
                   + ", ".join(f"{t:.4f}" for t in v) + f") | bound {b_ms:.4f} ms ({b_by})"
                   + (f" | vs plain {worst:.3e}" if name.startswith("this") else ""))
        if k == 300:
            fns = {}
            d, s = VARIANTS[f][0]
            for pc, se in ((32, 8), (32, 16), (32, 32), (64, 16), (16, 16)):
                g2 = grouping(lay, order, k, se, pc)
                fns[f"stream D={d} S={s}, pieces of <= {pc}, spans of {se}"] = caller(
                    so, f"probe_stream_{f}_{d}_{s}", g2, u_sp, i_sp, accs)
            for name, (mean, v) in turns(fns).items():
                cs.log(f"  K={k} {name}: {mean:.4f} ms an epoch (turns "
                       + ", ".join(f"{t:.4f}" for t in v) + ")")
            del fns, g2
        del groups, old, u_sp, i_sp, accs
        cs.gc_cuda()
    for k in (cs.K_WIDE, 128):
        f = -(-k // 32)
        groups = grouping(lay, order, k)
        u_sp, i_sp = cs._map_tables(lay, k)
        accs = accumulators(u_sp, i_sp)
        fns = {f"one warp a piece {kernel_of(k)}": port_call(groups, u_sp, i_sp, accs),
               "stream D=4 S=3": caller(so, f"probe_stream_{f}_4_3", groups, u_sp, i_sp,
                                        accs)}
        worst = step_check("stream", one_step(so, f"probe_stream_{f}_4_3", groups, u_sp,
                                              i_sp, accs), groups, u_sp, i_sp, accs, lay,
                           order, steps=(7, 379))
        for name, (mean, v) in turns(fns).items():
            cs.log(f"  K={k} {name}: {mean:.4f} ms an epoch (turns "
                   + ", ".join(f"{t:.4f}" for t in v) + f") | stream vs plain {worst:.3e}")
        del groups, u_sp, i_sp, accs
        cs.gc_cuda()


def part_parts(libs, lay, order):
    """The stream form at K = 160 (D = 4, S = 3) on the parent's pieces (<=
    128 edges) and spans of 64 edges beside the parent's plan, with parts
    cut out and with the other ids at row 0; then on other pieces and
    spans."""
    import torch

    from pmf_tpu_torch.ops.map_grad import PIECE

    k = cs.K_HUGE
    groups = grouping(lay, order, k, 64, PIECE)
    u_sp, i_sp = cs._map_tables(lay, k)
    accs = accumulators(u_sp, i_sp)
    zeros = (torch.zeros_like(groups[0].other), torch.zeros_like(groups[1].other))
    fns = {"parent": caller(libs["full"][0], "probe_old", groups, u_sp, i_sp, accs),
           "stream": caller(libs["full"][0], "probe_stream_5_4_3", groups, u_sp, i_sp, accs),
           "stream, other ids at row 0": caller(libs["full"][0], "probe_stream_5_4_3", groups,
                                                u_sp, i_sp, accs, zeros)}
    for c in STREAM_CUTS:
        fns[f"stream {c}"] = caller(libs[c][0], "probe_stream_5_4_3", groups, u_sp, i_sp, accs)
    for pc, se in ((128, 8), (128, 32), (64, 32), (32, 32), (32, 16), (16, 16), (16, 32)):
        g2 = grouping(lay, order, k, se, pc)
        fns[f"stream, pieces of <= {pc}, spans of {se}"] = caller(
            libs["full"][0], "probe_stream_5_4_3", g2, u_sp, i_sp, accs)
        if se == 32:
            fns[f"parent, pieces of <= {pc}"] = caller(libs["full"][0], "probe_old", g2,
                                                      u_sp, i_sp, accs)
    for name, (mean, v) in turns(fns).items():
        cs.log(f"  K={k} {name}: {mean:.4f} ms an epoch (turns "
               + ", ".join(f"{t:.4f}" for t in v) + ")")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("breakdown", "stream", "parts", "parent"),
                    required=True)
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of another commit: part parent runs chip_smoke.py's "
                         "phase k9 parent; part breakdown adds that tree's forms at K <= 128")
    ap.add_argument("--ks", default=None,
                    help="comma-separated K (breakdown: 20,50,128,160; stream: "
                         "129,160,200,256,257,300,384,512)")
    args = ap.parse_args(argv)
    cs.LOG_PATH = os.path.join(ROOT, "chiprun_out", f"probe_k9_{args.part}.log")
    smi = cs.phase_device()
    if args.part == "parent":
        if not args.parent:
            raise SystemExit("--part parent needs --parent DIR")
        cs._load_parent(args.parent)
        cs.phase_build()
        lay, order = map_layout()
        cs.phase_k9_parent(lay, order)
        cs.log(f"probe k9 parent: ok | {smi}")
        return 0
    ks = [int(k) for k in (args.ks or ("20,50,128,160" if args.part == "breakdown" else
                                       "129,160,200,256,257,300,384,512")).split(",")]
    cuts = {"breakdown": ("full", "noedges", "nomerge") if max(ks) > 128 else (),
            "stream": ("full",), "parts": ("full", *STREAM_CUTS)}[args.part]
    pm = None
    runs_libs = {}
    if args.part == "breakdown" and min(ks) <= 128:
        from pmf_tpu_torch.ops import _build, map_grad

        insts = sorted({map_grad.kernel_of(k) for k in ks if k <= 128})
        runs_libs = {c: (os.path.join(str(_build.SRC_DIR), "map_grad.cu"), RUNS_CUTS[c],
                         [f"map_grad_runs_kernel<{g}, {v}>" for _, g, v in insts])
                     for c in RUNS_CUTS}
        if args.parent:
            cs._load_parent(args.parent)
            pm = cs._parent_op("map_grad")  # its grouping and plan; its kernels are cut below
            cs.PARENT.clear()  # so that phase_build builds no parent library
            psrc = os.path.join(os.path.abspath(args.parent), "pmf_tpu_torch", "csrc",
                                "map_grad.cu")
            pk = sorted({pm.kernel_of(k) for k in ks if k <= 128})
            names = [f"map_grad_kernel<{v[1]}>" if v[0] == "lane" else
                     f"map_grad_wide_kernel<{v[1]}>" for v in pk if v[0] in ("lane", "wide")]
            runs_libs.update({c: (psrc, PARENT_CUTS[c], names) for c in PARENT_CUTS})
    with ThreadPoolExecutor(max(len(cuts) + len(runs_libs), 1)) as pool:
        futs = {c: pool.submit(build_probe, c, True if c == "full" else
                               [(5, 4, 3)] if c in STREAM_CUTS else False) for c in cuts}
        rfuts = {c: pool.submit(build_cut, c, *v) for c, v in runs_libs.items()}
        cs.phase_build()
        libs = {c: f.result() for c, f in futs.items()}
        rlibs = {c: f.result() for c, f in rfuts.items()}
    for c, (_, report, secs) in libs.items():
        cs.log(f"probe library {c} built in {secs:.1f} s")
        for ln in report:
            if c == "full":
                PTXAS[ln.split(":")[0]] = ln.split(": ", 1)[1]
            if c == "full" or "wide_kernel<5>" in ln:
                cs.log(f"  ptxas ({c}) {ln}")
    for c, (so, report, secs, missed) in rlibs.items():
        kernels = runs_libs[c][2]
        occ = ", ".join(f"{kn} {8 * _occupancy(so, n)} warps an SM"
                        for n, kn in enumerate(kernels))
        cs.log(f"probe library {c} built in {secs:.1f} s | resident: {occ}"
               + (f" | cuts not found: {missed}" if missed else ""))
        for ln in report:
            if any(ln.startswith(kn + ":") for kn in kernels):
                cs.log(f"  ptxas ({c}) {ln}")
    libs.update({c: (so,) for c, (so, *_) in rlibs.items()})
    t0 = time.perf_counter()
    lay, order = map_layout()
    cs.log(f"layout: {lay.n_segments} segments, {lay.nnz} ratings in "
           f"{time.perf_counter() - t0:.1f} s")
    if args.part == "breakdown":
        for k in ks:
            if k <= 128:
                breakdown_runs(libs, lay, order, k, pm)
            else:
                part_breakdown(libs, lay, order, k)
    elif args.part == "parts":
        part_parts(libs, lay, order)
    else:
        part_stream(libs, lay, order, ks)
    cs.log(f"probe k9 {args.part}: ok | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
