#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pmf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``: a checkout of another commit (for instance the parent,
unpacked by ``git archive`` into a git-ignored directory); its kernels
build beside this tree's, and phase k2 parent (after k2fast) times its K2
and this one at K = 20, 50 and 160, both precisions, in turns parent,
this, this, parent; phase k4 parent (after k4wide) holds K4's rows and
tile and panel instances' ptxas lines equal to that build's (K4 is the
parent's), times both trees' K4 at K = 50, 80, 160 and 239 a sweep in the
same turns and at 240, 256, 300 and 384 on the K = 256 fit's sides, within
3% of the parent, the outputs equal in bits;
phase k3 parent (after k3wide) times both trees' K3 a sweep in the same
turns at K = 20, 50, 80, 128 on the bench's Gaussian tail (within 3%, the
same code) and at K = 160 there and K = 256 on the XL CSR (faster in every
turn), its output equal in bits where the plan's form sums in CSR order;
phase tail parent (after huge timing) holds every row-group instance this
tree keeps to the parent build's ptxas line, K1 (both modes) and K7 equal
in bits at K = 20, 50, 128, 160, 200, 256, 300 and 512, K8 (K = 20, 50,
127, 128, 143: the register form) equal in bits and within 3% of the
parent, and both trees' K8 in turns at K = 144, 160, 200, 255, 256, 300
and 511 (the sum form against the parent's register and wide forms,
faster in every turn, equal in bits to 255 on a pass without other-id
windows); after huge timing (Gaussian) the same for K5 (the register form
to 159, the sum form from 160) and K6 (K = 20, 50, 127, then the ring form
at K = 160, 200, 255, 256, 300, 511 and 512);
phase k9 parent (after K9) holds every K9 instance both builds keep to
the parent build's ptxas line, times both trees' K9 an epoch (a CUDA
graph's replay) in the same turns at K = 20, 50 and 128 (equal in bits,
within 3%) and at K = 129, 160, 200, 256, 257, 300 and 512 (this tree's
plan, the same kernels on pieces of 32 edges in place of 128, within
1e-4 per column of the parent's and faster in every turn).

Phases, one status line each; any failure exits non-zero and prints no
result line:

1. device  -- card name and power limit (nvidia-smi), torch/CUDA versions.
2. build   -- compile the CUDA kernels from ``pmf_tpu_torch/csrc``.
3. data    -- the benchmark's Zipf data (162k users x 59k items x 25M
              ratings, seed 0) and the hybrid layout the fit builds.
3a. cache  -- the layout cache: ``build_blocked`` as ``HPF.fit`` calls it,
              cold into an empty directory under ``_smoke_tmp/``, then warm
              (seconds, the entry's MB); every tensor of the hit equal in
              bits to the cold build's and to phase data's, one sweep on
              each equal in bits.  The cache is off until phase fastfit, so
              every fit before it builds its layout cold, as a user's first
              fit does; from fastfit on the fits read and write that
              directory.
4. K1      -- sparse-tail edge kernel vs its plain version, both directions,
              with its per-edge sector reckoning and its long rows alone,
              and its tables built into new space by gather and by scatter.
5. K2      -- dense-head tier kernel vs its plain version, every tier and
              side, with its bound's three lines and the share of the
              card's memory rate; before the data, K2small: the same
              kernel vs the plain version in float64 over every padding of
              K, ragged rows, narrow heads and the three cell kinds.
5a. k2fast -- K2's one-term instance (precision "fast") vs its plain
              version on the same tiers (1e-3 relative, equal bits on a
              repeat), its bound, stage bytes and CTAs/SM, its error
              against the float64 "high" plain version, the high
              instance's time against PERF.md note (p); then every K where
              the plan changes, K = 50 and 128 on small shapes.
6. small   -- three blocked sweeps on the card vs the host (plain kernels)
              on a small input with an explicit two-tier head.
7. fit     -- ``HPF.fit(engine="blocked_high")`` at K=20 for 4 sweeps, with
              the kernel launch counters reset just before and read after.
8. profile -- steady sweep time, and one sweep under torch.profiler.
8a. serve  -- on phase fit's model: ``save_model`` / ``load_model`` onto
              the card (equal bits, seconds, MB); the exclusion index from
              the training COO equal to ``build_exclusion_index``'s;
              ``recommend`` top-10 for all 162k users at batch 1024 (seconds,
              users/s, one call traced: busy and idle share), held against a
              float64 host oracle on 2,048 users and checked on the card for
              training items; ``ranking_metrics`` on the 100k held-out pairs
              and ``sampled_ranking_metrics`` with 100 negatives (values,
              seconds); the recommend CLI on 1,000 users from the saved
              checkpoint, its CSV equal to ``recommend``'s.  No kernel of the
              port launches (counters checked).
8b. resume -- ``HPF.fit`` for 2 sweeps with ``checkpoint_every=2``, then
              resumed for 2 more: equal in bits to phase fit's unbroken
              4-sweep state; checkpoint save and load seconds and MB.

Between phases 5 and 6, on the same layout's tail: K7 and K8, the
extended-Poisson factor and scalar-rate tail kernels vs their plain
versions on [e | s] records, both directions, with their per-edge sector
reckonings, long rows alone and the linear library forms of K8.  After
phase 8 the HPF model is freed, then the Poisson-MF CAVI path on the same
ratings: psmall (three blocked sweeps card vs host, plain and extended),
pfit (``PoissonMF.fit(engine="blocked_high")``, 4 sweeps plain then 4
extended, with launch counters), pprofile (steady sweep times of both, one
plain and one extended sweep under the profiler, the head-product launches
of a sweep and of its scalar passes) and pelbo (a 2-sweep plain fit with
``elbo_every=1``).

Beside K1, on the same tail: K1raw, the tail kernel's mode "raw" vs its
plain version and its linear library form.  After the Poisson phases, on
the same ratings, the HPF-MAP/SGD path: mdata (the segment layout at
batch_size=65536, mix=8, and one epoch's grouping by (step, self row),
timed), K9 (the minibatch-gradient kernel vs its plain version on real
steps, two launches of a step equal in bits, and one whole epoch of its
launches, 2 a step, timed by CUDA events and by the profiler; at K = 50
and 160 again on one real step against the plain version, and at K = 160
also by CUDA events around a replay of the epoch's launches captured in a
CUDA graph, which the host does not pace), msmall
(three blocked and three flat epochs card vs host on a small input), mfit
(``HPFMap.fit`` for 3 epochs, engine "blocked_high" then "flat", with
launch counters: K9 twice and K10, the dense part, once a step; the
blocked fit again through the plain dense part on the card's tensors,
its loss and val RMSE each epoch within 1e-4 of the fit through K10), k10
(K10 against its plain version on a real step at K = 20 on mfit's fitted
state and at K = 50, 128 and 300 from the initial state, per column, the
loss, the accumulators cleared, a repeat equal in bits; its time by CUDA
events beside its bytes bound, with no row to clear, and the plain
version's), resume (HPF-MAP) (a blocked fit of 1 epoch with
``checkpoint_every=1``, resumed for 2 more: equal in bits to mfit's blocked
params), mprofile (20 steady blocked steps under the profiler: K9, K10
and the run's other launches) and
mhugefit (``HPFMap.fit`` at K = 160 at full width, 3 blocked epochs: per
epoch seconds, edge-visits/s, loss and val RMSE; K9 twice a step, K10 once
and no other kernel; the state finite, the loss falling, the host's val
RMSE equal to the history's; the peak beside its reckoning; K9 and K10 on
the fit's state against their plain versions; 20 steady steps by CUDA
events and under the profiler, K9's share beside the dense part's).

Before the data, phase bigk: K1 (both modes), K7, K5, K6 and K8 at every K
where their row-group plan changes, equal bits on a repeat (phase
k17small), K3 and K4 at every K where their geometry changes (phase
k34small), every kernel at K = 50
and K = 128 vs its plain version on small shapes (K2 on both sides with
both M types), then
at K = 50 the small, psmall, gsmall and msmall card-vs-host runs.  Past
K = 128 inside phase bigk, phase hugek: every kernel at K = 129, 160,
256, 300 and on both sides of every boundary its module lists
(``hugek_plan``; K2 at both precisions; K3 past 128 in the plan's form,
the group form and the slab form at 64 and 512 floats), then the four
card-vs-host runs
at K = 160 (gsmall on a 600 x 300 input, 2 sweeps).  Beside the
real-data phases, "bigk timing": every kernel's time at K = 50 on the
real tail, tiers, matrices and steps; "huge timing": the same at K = 160
with the bound at K = 160 (K2 at both K also against its plain version on
every tier, its launch plan logged with passes over the cells and the
instance's registers and spills; the library forms of K1 raw, K3, K5 and
K8, and K7's S_wother half; each row-group kernel's per-edge sector
reckoning beside its time).  After huge timing, phase k3wide: K3's wide forms (``factor_plan``: the
slab form, its chunk sized to L2, or the group form where rows share other
rows) on the bench's Gaussian tail at K = 160 and on the XL CSR (phase
gxldata's) at K = 256 and 300, both directions: the plan, the kernel
against its plain version per column, equal bits on a repeat, two timed
turns, ``torch.sparse.mm`` of the pass-through bulk, the bounds per-edge
gather, table once and grouped, every K3 instance's ptxas line.  Then
phase k4wide: K4's CTA and panel forms against
the plain version at K - 1 and K of every boundary of
``gj_inverse.boundary_ks``, ``cta_boundary_ks`` and ``panel_boundary_ks``
and at 239, every K4 instance's ptxas line, and its time at K = 80, 128,
160 on 162k + 59k matrices, at K = 200, 239 on 59k and at K = 240, 256,
300, 384, 512 on 6,040 + 3,706 beside ``torch.linalg.inv`` and its
bounds.  After phase resume, phase hugefit:
``HPF(n_factors=160)`` and ``HPF(n_factors=50)`` at full width, 4 sweeps
each with launch counters, one sweep traced (K2, K1, the rest), read by
phase roofline as hpf_k160 and hpf_k50; then phase exthugefit:
``PoissonMF(n_factors=160, extended=True)`` at full width, 4 sweeps with
launch counters (K7 and K8 twice a sweep, K2 twice a tier), finite state,
a val RMSE that never rises, the fit's peak memory, one steady sweep by
CUDA events (read by phase roofline as ext_k160) and one traced for the
shares of K2, K7 and K8 (K8's sum form: its ms and share of the sweep).

Those are freed, then the Gaussian-MF CAVI path:

9.  gdata    -- the benchmark's N(0, 1) ratings on the same ids and split,
                and the layout ``GaussianMF.fit`` builds (3.75 GiB head).
10. K3/K5/K6 -- the factor, bias and diag tail kernels vs their plain
                versions, both directions, under a per-column criterion
                fit for signed sums, equal bits on a repeat;
                ``torch.sparse.mm`` as the library reference of K3's and
                K5's pass-through bulk.  K3's bytes reckoned three ways
                (per-edge gather, table once, and banded: the table in
                bands of other rows sized to L2); K5's and K6's per-edge
                sectors and their long rows' time alone; K5's record
                table built into new space by scatter and by gather.
11. ghead    -- the head tiers' linear products (library matmuls), timed.
12. K4       -- the Gauss-Jordan inverse on the real theta/beta precision
                matrices vs its plain version and float64 ``linalg.inv``,
                equal bits on a second launch, bytes and FP32 bounds.
13. gsmall   -- three blocked sweeps on the card vs the host, exact, lagged
                and diag, on a small input with a two-tier head.
14. gfit     -- ``GaussianMF.fit(engine="blocked_high")`` at K=20: 4 sweeps
                exact full covariance, then 2 diag, with launch counters.
15. gprofile -- steady sweep times, and one exact and one diag sweep under
                the profiler (busy time, idle share, parts).
16. gelbo    -- ``GaussianMF.fit(elbo_every=1)`` on the blocked engine, 3
                exact then 2 diag sweeps: the ELBO finite and never falling
                by more than the fit's 1e-4 relative gate; its own time per
                evaluation (CUDA events).
16'. gwidefit -- the exact fit at K = 80 at full width (``n_factors=80``,
                4 sweeps, ``elbo_every=1``): peak memory beside its
                reckoning, launches as gfit's, the state finite, the ELBO
                monotone within 1e-4; K4 on the user precisions after
                sweep 1 against its plain version; one sweep traced (busy,
                idle share, K4 beside K3 and the head products).
16''. gxlfit -- the same at K = 256 on a rating log of MovieLens 1M's
                shape (6,040 x 3,706 x 1,000,209 ratings, 10,000 held out;
                phase gxldata): no head, K3's wide instance, K4's panel
                form, K5's sum form (its traced ms).
16'''. gdiaghugefit -- the diag fit at K = 160 at full width on phase
                gdata's ratings (4 sweeps, ``elbo_every=1``): peak memory
                beside its reckoning (state, K6's tables, the head tiers'
                transients), launches (K5 and K6 twice a sweep, nothing
                else), the state and every ELBO finite (whether it rose
                logged); K6 on the state of sweep 2 against its plain
                version, bits of a repeat, timed by CUDA events; one sweep
                by CUDA events and one traced (K5's, the head products' and
                the glue's shares; K6's from the events).

Then the other engines:

16a. fastfit -- ``blocked_fast`` fits at full width with the cache on (the
                HPF and extended Poisson layouts, of phase cache's data,
                read from its entry; the Gaussian one built and written):
                HPF 4 sweeps, extended Poisson and exact Gaussian 2
                each, launch counters reset before and read after (K2's
                fast instance on the Poisson family); val RMSE within 5e-3
                of the blocked_high fits' at each sweep; busy ms a sweep at
                fast and high; one ``blocked_mid`` sweep equal in bits to a
                ``blocked_high`` one.
16b. mesh    -- the multi-device modes (``pmf_tpu_torch.parallel``) at
                world size 1 over NCCL (a file rendezvous under
                ``_smoke_tmp/``), the cache on: the data-parallel HPF fit
                (blocked_high, 4 sweeps) against phase fit's (1e-6
                relative, equal bits said); the tensor-parallel blocked
                ring (``state_sharding="rows"``) for HPF, extended Poisson
                and exact Gaussian, 2 sweeps each, against the
                single-device blocked_high fits at the reference's gates
                (3e-4 / 3e-5, Gaussian 2e-3 / 2e-4, val RMSE 1e-3), the
                extended one the first fit that launches K1 "raw" (one of
                its launches held against the plain version); the flat
                ring against the flat fit in float64 (1e-6); the
                data-parallel HPFMap epoch against the single-device one;
                ``recommend_sharded`` for every user against
                ``recommend``.  Each fit's launches, peak memory and one
                sweep's busy time with its heaviest kernels; the TP
                layouts' buckets and tiers; the TP layout's cache entry
                (the HPF ring's layout cold into an empty directory, then
                warm: seconds, MB, equal fields, one sweep equal in bits).
16c. chunked -- HPF ``flat_chunked`` vs ``flat`` at full width, 2 sweeps,
                in float32 (and ``flat`` again: the atomics' run-to-run
                difference) and in float64, where the states must agree
                within 1e-5 relative; peak device memory of each.

Then the experiment surface (the CLIs through their ``main``; where
matplotlib is absent, the runs that would plot call the CLIs' compute
functions and say so):

17. cli    -- phase data's splits written as processed CSVs and read back
              by ``data.pipeline.load_all_splits`` (equal; seconds); phase
              native on the training CSV: the C++ parser against pandas,
              ``build_ratings`` and the CSR tail by the radix sort against
              numpy (equal; seconds), failing if the library did not load;
              ``train_full.main --model hpf_cavi`` on them at K=20, 4
              sweeps (K1, K2), its embeddings and test predictions checked
              against a host recomputation; at a mid size (2M ratings,
              40k x 12k, 3 iterations) ``run_single.main`` for all six
              models, ``compare --ranking``, ``tune.main --n_trials 2
              --seeds_per_trial 3`` and ``best_k`` with 3 seeds over 3 K,
              each fit's kernels checked from the launch counters.
17a. torchrun -- inside phase cli, after its six run_single:
              ``python -m torch.distributed.run --standalone
              --nproc_per_node 1`` runs this script's ``--torchrun-child``:
              ``run_single --mesh_devices 1`` for HPF and the Gaussian
              model with biases (as phase cli ran them, ``--engine
              blocked_high``) and ``recommend --mesh_devices 1`` on the
              HPF run's checkpoint, NCCL at world size 1 from ``env://``;
              launches equal to the runs without a mesh, states and
              metrics equal in bits, the recommendations CSV equal byte
              for byte.
18. mseed  -- ``tune.multi_seed``: HPF, S=3, K=20 at the tuner's size,
              each seed equal to its single flat fit to 1e-4 relative; on
              the 24.9M training set, 2 vmapped sweeps timed, peak memory.
19. repro  -- ``reproduce.main`` on a 700k-row synthetic Food.com clone
              (369k training ratings, blocked engines), one tuner trial a
              model, the artifact set checked.

20. roofline -- ``utils.roofline.roofline_fields`` of the HPF, plain and
               extended Poisson and exact Gaussian sweeps' work counts
               over the busy times of phases profile, pprofile and
               gprofile, against the peaks of the card's own name; a
               share above 100% fails the run.

Then one JSON line of per-kernel numbers, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  The peaks and ``bound``
come from ``pmf_tpu_torch/utils/roofline.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# The card's peaks (HBM bytes/s, FP32 and dense bf16 FLOP/s) and the bound
# of a kernel's bytes and FP32 operations, from the port's roofline module.
from pmf_tpu_torch.utils import roofline
from pmf_tpu_torch.utils.roofline import (
    BF16_FLOPS_PER_S,
    FP32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    bound,
)

N_USERS, N_ITEMS, NNZ, K = 162_000, 59_000, 25_000_000, 20
N_VAL = 100_000
FIT_SWEEPS = 4
# Kernel vs plain version: f32 sums of positive terms taken in another
# order; relative error per element.
RTOL = 1e-4
TIMING_REPS = 10


LOG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                        "chip_smoke.log")


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line to standard output and to ``chiprun_out/chip_smoke.log``
    beside this script (a git-ignored directory; the file is started anew
    by ``phase_device``); a phase's status line ends with the seconds since
    the script started."""
    if msg.startswith("phase "):
        msg += f" | at {time.perf_counter() - T_START:.1f} s"
    print(msg, flush=True)
    with open(LOG_PATH, "a") as f:
        f.write(msg + "\n")


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


def launch_ms(fn, before, reps: int = TIMING_REPS) -> float:
    """Mean device time of ``fn`` alone (CUDA events around each call),
    ``before()`` run ahead of each call outside the timed span; one call
    first as warm-up."""
    import torch

    pairs = []
    for _ in range(reps + 1):
        before()
        pairs.append((torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)))
        pairs[-1][0].record()
        fn()
        pairs[-1][1].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs[1:]) / reps


def graph_of(fn):
    """``fn``'s launches captured in a CUDA graph (after one call outside
    the capture, which builds and sets up whatever it launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    torch.cuda.synchronize()
    return graph


def graph_ms(graph, reps: int = TIMING_REPS) -> float:
    """Mean device time of a replay of ``graph`` over ``reps`` replays
    (CUDA events): the captured launches without the host's pace."""
    return cuda_ms(graph.replay, reps)


def compare(got, ref) -> tuple[float, float]:
    """(max abs error, max elementwise relative error)."""
    import torch

    diff = (got.double() - ref.double()).abs()
    rel = diff / ref.double().abs().clamp_min(1e-30)
    rel = torch.where(diff == 0, torch.zeros_like(rel), rel)
    return float(diff.max()), float(rel.max())


WARM_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def profile_once(fn, expect: dict, warm: bool = True, attempts: int = 3):
    """One call of ``fn`` under torch.profiler: (device rows sorted by time
    as (ms, count, name), busy ms, window ms on the host clock).
    ``expect`` maps a kernel-name part to the launches one call makes; a
    trace that holds fewer of them lost events, so the call is profiled
    again (``attempts`` traces at most), a shortfall that stays is logged
    and the trace that held the most of them is returned.  With ``warm`` the trace first runs 8 short sleep kernels,
    left out of the rows: fault F2 (PERF.md, PR 6), the first kernel
    records of a trace go missing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = None
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if warm:
                for _ in range(8):
                    torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and WARM_KERNEL not in e.key),
                      reverse=True)
        seen = {part: sum(n for _, n, key in rows if part in key) for part in expect}
        if best is None or sum(seen.values()) > best[0]:
            best = (sum(seen.values()), rows, wall_ms)
        if seen == expect:
            break
        log(f"  trace {attempt + 1}{'' if warm else ' (no warm-up)'} holds launches "
            f"{seen}, one call makes {expect}")
    _, rows, wall_ms = best
    return rows, sum(r[0] for r in rows), wall_ms


def _head_launches(model) -> dict:
    """K2's launches in one sweep of ``model``: each tier once a side."""
    n_tiers = len(model.blocked.head or ())
    return {"head_user_kernel": n_tiers, "head_item_kernel": n_tiers}


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel id."""
    from pmf_tpu_torch.ops import (
        cavi_edge, dense_head, ext_edge, gaussian_edge, gj_inverse, map_dense, map_grad)

    return {"K1": cavi_edge.TAIL_LAUNCHES, "K1raw": cavi_edge.TAIL_RAW_LAUNCHES,
            "K2": dense_head.HEAD_LAUNCHES, "K2fast": dense_head.HEAD_FAST_LAUNCHES,
            "K3": gaussian_edge.FACTOR_LAUNCHES, "K4": gj_inverse.GJ_LAUNCHES,
            "K5": gaussian_edge.BIAS_LAUNCHES, "K6": gaussian_edge.DIAG_LAUNCHES,
            "K7": ext_edge.FACTOR_LAUNCHES, "K8": ext_edge.SCALAR_LAUNCHES,
            "K9": map_grad.MAP_GRAD_LAUNCHES, "K10": map_dense.MAP_DENSE_LAUNCHES}


def reset_counters() -> dict:
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    return counters


def gc_cuda():
    """Free what the last phase left: Python garbage, then the cached
    device blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    open(LOG_PATH, "w").close()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from importlib import metadata

    # Versions from the installed metadata: nothing is imported here.
    versions = []
    for name in ("pandas", "matplotlib", "scikit-learn"):
        try:
            versions.append(f"{name} {metadata.version(name)}")
        except metadata.PackageNotFoundError:
            versions.append(f"{name} absent")
    log(f"phase device: ok | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()} | "
        + ", ".join(versions))
    return smi


# The build's ptxas report, by kernel name with its template arguments
# (e.g. "head_pass_kernel<160, 1, 0, 3, 0>"): "N registers, <spill line>".
PTXAS: dict = {}


def _ptxas_report(text: str, into: dict = PTXAS) -> list:
    """One line per compiled kernel from ``ptxas -v``: its name (template
    argument kept), registers and spills; each also kept in ``into``."""
    import re

    out, name = [], "?"
    for ln in text.splitlines():
        if "Function properties for" in ln:
            mangled = ln.rsplit(" ", 1)[-1]
            name, rest = mangled, ""
            if mangled.startswith("_ZN"):  # the last of _ZN's length-prefixed names
                rest = mangled[3:]
                while (m := re.match(r"\d+", rest)):
                    name, rest = (rest[m.end(): m.end() + int(m.group())],
                                  rest[m.end() + int(m.group()):])
            targs = re.match(r"I((?:L[ib]\d+E)+)E", rest)
            if targs:
                name += "<" + ", ".join(re.findall(r"L[ib](\d+)E",
                                                   targs.group(1))) + ">"
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            into[name] = f"{regs.group(1) if regs else '?'} registers, {spill}"
            out.append(f"{name}: {into[name]}")
    return out


# With ``--parent DIR`` (a checkout of another commit, e.g. by git archive
# into a git-ignored directory): that tree's build module, whose kernels
# build into DIR's own _build/.  Phase k2 parent then times that tree's K2
# (its ops/dense_head.py over that build) in turns beside this one's.
PARENT: dict = {}


def _load_parent(parent_dir):
    import importlib.util

    path = os.path.join(os.path.abspath(parent_dir), "pmf_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    PARENT.update(dir=parent_dir, build=build)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from pmf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the parent's nvcc processes alongside
        parent = pool.submit(PARENT["build"].build) if PARENT else None
        path = _build.build()
        secs = time.perf_counter() - t0
        if parent:
            PARENT["lib"] = parent.result()
            log(f"  parent {PARENT['dir']}: {PARENT['lib'].name} built "
                f"{time.perf_counter() - t0:.1f}s")
    _build.load_library()
    log_path = str(path) + ".log"
    report = _ptxas_report(open(log_path).read()) if os.path.exists(log_path) else []
    from pmf_tpu_torch.data import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("build: the native ingest library did not build or load")
    log(f"phase build: ok | {path.name} in {secs:.1f}s | "
        f"{native.library_path().name} (g++) in {time.perf_counter() - t0:.1f}s")
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
    return train, val, blocked, (u, i, is_val)


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
        got = tail_edge_stats(*args, long_rows=p.long_rows)
        ref = tail_edge_stats_plain(*args)
        abs_err, rel_err = compare(got, ref)
        ms = cuda_ms(lambda: tail_edge_stats(*args, long_rows=p.long_rows))
        plain_ms = cuda_ms(lambda: tail_edge_stats_plain(*args), reps=3)
        n_bytes = (es.nbytes + eo.nbytes + p.row_ptr.nbytes + p.other.nbytes
                   + p.x.nbytes + got.nbytes)
        n_flops = p.nnz * (5 * K + 1)  # dot 2K, alloc 2K, other sum K, divide
        b_ms, b_by = bound(n_bytes, n_flops)
        log(f"  K1 {name}: nnz {p.nnz} | max abs err {abs_err:.3e} rel "
            f"{rel_err:.3e} (tol {RTOL}) | kernel {ms:.4f} ms | plain "
            f"{plain_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
        _tail_notes("K1", name, (es, eo), p, K, ms, got.nbytes)
        _log_tail_tables("K1", name, p)
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


def phase_k1raw(blocked):
    """K1's mode "raw" vs its plain version on the real tail, both
    directions.  "raw" is linear, sum_e e_s * e_o = e_s * sum_e e_o, so one
    library call computes it: torch.sparse.mm of the tail's pattern by the
    other table, scaled by the self rows."""
    import torch

    from pmf_tpu_torch.ops.cavi_edge import tail_edge_stats, tail_edge_stats_plain

    e_user, e_item = _new_space_tables(blocked)
    res = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0,
               n_bytes=0.0, n_flops=0.0)
    for name, p, es, eo in (("user", blocked.by_user, e_user, e_item),
                            ("item", blocked.by_item, e_item, e_user)):
        args = (es, eo, p.row_ptr, p.other, None)
        got = tail_edge_stats(*args, mode="raw", long_rows=p.long_rows)
        ref = tail_edge_stats_plain(*args, mode="raw")
        abs_err, rel_err = compare(got, ref)
        pattern = _csr_ones(p)

        def library(es=es, eo=eo, pattern=pattern):
            s_other = torch.sparse.mm(pattern, eo)
            return torch.cat([es * s_other, s_other], dim=1)

        _, lib_rel = compare(library(), ref)
        ms = cuda_ms(lambda: tail_edge_stats(*args, mode="raw", long_rows=p.long_rows))
        plain_ms = cuda_ms(lambda: tail_edge_stats_plain(*args, mode="raw"), reps=3)
        lib_ms = cuda_ms(library)
        n_bytes = (es.nbytes + eo.nbytes + p.row_ptr.nbytes + p.other.nbytes
                   + got.nbytes)
        n_flops = p.nnz * 3 * K  # product and sum K each, other sum K
        b_ms, b_by = bound(n_bytes, n_flops)
        log(f"  K1raw {name}: nnz {p.nnz} | max abs err {abs_err:.3e} rel "
            f"{rel_err:.3e} (tol {RTOL}) | kernel {ms:.4f} ms | plain "
            f"{plain_ms:.4f} ms | library e_s * sparse.mm(pattern, e_o) "
            f"{lib_ms:.4f} ms (rel {lib_rel:.3e}) | bound {b_ms:.4f} ms ({b_by})")
        if not (rel_err <= RTOL and lib_rel <= RTOL):
            raise AssertionError(f"K1raw {name}: relative error {rel_err} (kernel) "
                                 f"or {lib_rel} (library form) > {RTOL}")
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["library_ms"] += lib_ms
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        res["n_bytes"] += n_bytes
        res["n_flops"] += n_flops
    res["bound_ms"], res["bound_by"] = bound(res["n_bytes"], res["n_flops"])
    log(f"phase K1raw: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, library {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def _k2_bound(rows, hip, m_f32, has_lo, n_bytes, fast=False, k=K):
    """The three lines of K2's bound over one tier and side, in ms: the
    bytes; the tensor-core flops as the kernel issues them (K pads to
    ceil(K / 8) blocks of 8 in depth and in width; per 16 x 16 cells the
    rate product takes three terms over two n8 tiles, half an
    mma.m16n8k16 a block, then W three terms and M two, three for a
    float32 M, an mma a block; 4096 flops an mma); and the float32
    elementwise work a cell (clamp, reciprocal, multiply, the subtraction of
    W's split, 1.5 adds into the running sums; one add for x_lo; a select
    and a subtraction for a float32 M).  ``fast`` (the one-term instance):
    one mma a block for each product, no split of W or M.  At ``k`` past
    K = 32 the count is the function's (ceil(k / 8) blocks, R once), not
    the padding of the pass form's chunks."""
    blocks = -(-k // 8)
    mmas = 3 * blocks if fast else (3 + 3 + (3 if m_f32 else 2)) * blocks
    split = 0 if fast else 1
    cells = rows * hip
    return {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
            "tensor operations": cells * mmas * 4096 / 256 / BF16_FLOPS_PER_S * 1e3,
            "elementwise operations": cells * (4.5 + split + has_lo + (1 + split) * m_f32)
            / FP32_FLOPS_PER_S * 1e3}


def _k2_plan_note(plan, k, item_side, m_f32, fast=False) -> str:
    """One K2 launch's plan (passes over the cells, stages, threads,
    resident CTAs an SM, splits, shared memory) and its instance's
    registers and spills from the build's ptxas report."""
    from pmf_tpu_torch.ops.dense_head import pass_width

    terms = 1 if fast else 3
    if k <= 32:
        name = (f"head_{'item' if item_side else 'user'}_kernel<{-(-k // 8)}, "
                f"{int(m_f32)}, {terms}>")
    else:
        name = (f"head_pass_kernel<{pass_width(k)}, {int(m_f32)}, {int(item_side)}, "
                f"{terms}, {int(plan.p_ring)}>")
    return (f"passes {plan.passes}, {plan.stages} stages, {plan.threads} threads, "
            f"{plan.ctas_per_sm} CTAs/SM, {plan.splits} splits, {plan.smem_bytes} B "
            f"shared | {name}: {PTXAS.get(name, 'no ptxas line')}")


def phase_k2(blocked):
    import torch

    from pmf_tpu_torch.ops.cavi_edge import RATE_FLOOR
    from pmf_tpu_torch.ops.dense_head import (
        fused_alloc_tier, fused_alloc_tier_plain, plan_launch)

    e_user, e_item = _new_space_tables(blocked)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    lines = {}
    for t, h in enumerate(blocked.head or ()):
        theta_h = e_user[h.row_start : h.row_start + h.hu].contiguous()
        beta_h = torch.nn.functional.pad(e_item[: h.hi], (0, 0, 0, h.hip - h.hi))
        # Plain version in row chunks of <= 2^27 cells per temporary.
        chunk = max(1, (1 << 27) // h.hip)
        m_f32, has_lo = h.m.dtype == torch.float32, h.x_lo is not None
        for item_side in (False, True):
            kw = dict(rate_floor=RATE_FLOOR, item_side=item_side)
            args = (theta_h, beta_h, h.x_hi, h.m, h.x_lo)
            got = fused_alloc_tier(*args, **kw)
            ref = fused_alloc_tier_plain(*args, row_chunk=chunk, **kw)
            abs_err, rel_err = compare(got, ref)
            ms = cuda_ms(lambda: fused_alloc_tier(*args, **kw))
            plain_ms = cuda_ms(
                lambda: fused_alloc_tier_plain(*args, row_chunk=chunk, **kw), reps=3)
            # The bytes the function needs: the cells of the hi real columns.
            # The layout stores hip >= hi columns, the rest zeros, and the
            # kernel reads those too (logged as "stored").
            stored_bytes = sum(a.nbytes for a in (h.x_hi, h.m, h.x_lo) if a is not None)
            cells_bytes = stored_bytes * h.hi // h.hip
            n_bytes = cells_bytes + theta_h.nbytes + beta_h[: h.hi].nbytes + got.nbytes
            tier_lines = _k2_bound(h.hu, h.hip, m_f32, has_lo, n_bytes)
            by = max(tier_lines, key=tier_lines.get)
            plan = plan_launch(h.hu, h.hip, K, item_side, m_f32, has_lo, n_sm)
            rate = cells_bytes / ms / 1e6
            side = "item" if item_side else "user"
            log(f"  K2 tier {t} ({h.row_start}, {h.hu}, {h.hi}) {side}: M "
                f"{str(h.m.dtype)[6:]}, x_lo {has_lo} | max abs err {abs_err:.3e} "
                f"rel {rel_err:.3e} (tol {RTOL}) | kernel {ms:.4f} ms | plain "
                f"{plain_ms:.4f} ms | bound {tier_lines[by]:.4f} ms ({by}) | cells "
                f"{rate:.1f} GB/s, {rate * 1e9 / HBM_BYTES_PER_S:.1%} of "
                f"{HBM_BYTES_PER_S / 1e12} TB/s (stored {stored_bytes / ms / 1e6:.1f} "
                f"GB/s) | {_k2_plan_note(plan, K, item_side, m_f32)}")
            if not rel_err <= RTOL:
                raise AssertionError(
                    f"K2 tier {t} {side}: relative error {rel_err} > {RTOL}")
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["max_abs_err"] = max(res["max_abs_err"], abs_err)
            for name, v in tier_lines.items():
                lines[name] = lines.get(name, 0.0) + v
    by = max(lines, key=lines.get)
    res["bound_ms"] = lines[by]
    res["bound_by"] = "bytes" if by == "bytes" else "operations"
    log(f"phase K2: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({by}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in lines.items()) + ")")
    return res


K2SMALL_KS = (1, 4, 7, 20, 24, 32)
K2SMALL_ROWS = (8, 70, 3000)
K2SMALL_HIPS = (64, 128, 960)
K2SMALL_FLOOR = 0.05


def _k2small_cells(kind, rows, hip, hi, gen):
    """Random cell planes on the card, columns past ``hi`` empty: integer
    (no x_lo, bf16 M), fractional (x_lo) or m_f32 (some multiplicities
    above 256, so a float32 M and an x_lo)."""
    import torch

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    m = torch.floor(4 * rand(rows, hip) ** 3)  # about half the cells empty
    if kind == "m_f32":
        m = torch.where(rand(rows, hip) < 0.02, torch.floor(300 + 3000 * rand(rows, hip)), m)
    m[:, hi:] = 0
    per_edge = torch.floor(1 + 5 * rand(rows, hip))
    if kind != "integer":
        per_edge = per_edge + 0.37 * rand(rows, hip)
    x = m * per_edge
    x_hi = x.to(torch.bfloat16)
    x_lo = None if kind == "integer" else (x - x_hi.float()).to(torch.bfloat16)
    return x_hi, x_lo, m if kind == "m_f32" else m.to(torch.bfloat16)


def phase_k2small():
    """K2 against its plain version in float64 where the real tiers do not
    reach: every width of K's padding, rows that do not fill a tile, narrow
    and ragged heads, the three cell kinds, both sides, rates under the
    floor, empty columns past ``hi``; and two launches give equal bits."""
    import torch

    from pmf_tpu_torch.ops.dense_head import fused_alloc_tier, fused_alloc_tier_plain

    gen = torch.Generator(device="cuda").manual_seed(7)
    worst, n_cases, floored = 0.0, 0, 0
    for rows in K2SMALL_ROWS:
        for hip in K2SMALL_HIPS:
            hi = hip - 13
            for kind in ("integer", "fractional", "m_f32"):
                x_hi, x_lo, m = _k2small_cells(kind, rows, hip, hi, gen)
                for k in K2SMALL_KS:
                    theta = 0.02 + torch.rand(rows, k, generator=gen, device="cuda")
                    theta[::5] *= 1e-3  # rates under the floor
                    beta = 0.02 + torch.rand(hip, k, generator=gen, device="cuda")
                    beta[hi:] = 0
                    floored += int(((theta @ beta.T)[:, :hi] < K2SMALL_FLOOR).sum())
                    for item_side in (False, True):
                        kw = dict(rate_floor=K2SMALL_FLOOR, item_side=item_side)
                        got = fused_alloc_tier(theta, beta, x_hi, m, x_lo, **kw)
                        again = fused_alloc_tier(theta, beta, x_hi, m, x_lo, **kw)
                        ref = fused_alloc_tier_plain(theta.double(), beta.double(),
                                                     x_hi, m, x_lo, **kw)
                        _, rel = compare(got, ref)
                        tag = (f"K2small rows {rows} hip {hip} K {k} {kind} "
                               f"{'item' if item_side else 'user'}")
                        if got.shape != ref.shape or not rel <= RTOL:
                            raise AssertionError(f"{tag}: relative error {rel} > {RTOL}")
                        if not torch.equal(got, again):
                            raise AssertionError(f"{tag}: two launches differ in bits")
                        worst = max(worst, rel)
                        n_cases += 1
    log(f"phase K2small: ok | {n_cases} cases (K {K2SMALL_KS}, rows {K2SMALL_ROWS}, "
        f"hip {K2SMALL_HIPS}, 3 cell kinds, both sides) vs plain float64: worst rel "
        f"{worst:.3e} (tol {RTOL}); {floored} rates under the floor; repeated "
        f"launches equal in bits")


BIGK_KS = (50, 128)  # the K of the bigk phase's checks
K_WIDE = 50  # the K at which every kernel is also timed on the real data
# Past K = 128 (phase hugek): every kernel at these K and at K - 1 and K of
# each boundary its module lists (``boundary_ks``), on small shapes.
HUGEK_KS = (129, 160, 256, 300)
K_HUGE = 160  # every kernel timed on the real data; the full-width HPF fit
# The input of the checks past K = 300 and of the K = 160 Gaussian
# card-vs-host run: (users, items, ratings), a head of (row_start, rows,
# items) tiers and its row multiple.
TINY = (600, 300, 12_000)
TINY_HEAD = ([(0, 64, 300), (64, 128, 100)], 64)
HUGE_K4_MATS = 264  # K4's matrices a check where its form is "panel"
# K4 far past the CTA form, on a few matrices: K = 1000 (the strips in
# shared memory, one CTA an SM) and the first K whose strips go to global
# memory (``gj_inverse.boundary_ks``'s last past 600).
HUGE_K4_FAR = (1000,)


def _pos(gen, *shape):
    import torch

    return 0.05 + torch.rand(*shape, generator=gen, device="cuda")


def _bigk_poisson_tail(blocked, k):
    """K1 (both modes), K7 and K8 at ``k`` on a small tail, both
    directions: worst relative error of each (positive sums)."""
    import torch

    from pmf_tpu_torch.ops import cavi_edge as ce
    from pmf_tpu_torch.ops import ext_edge as ee
    from pmf_tpu_torch.ops._tail import padded_rows

    gen = torch.Generator(device="cuda").manual_seed(31 + k)
    worst = dict.fromkeys(("K1", "K1raw", "K7", "K8"), 0.0)
    for p in (blocked.by_user, blocked.by_item):
        es, es_new, eo, so = (_pos(gen, p.n_self, k), _pos(gen, p.n_self, k),
                              _pos(gen, p.n_other, k), _pos(gen, p.n_other))
        # K1's tables, K7's and K8's self rows and [e | s] records
        es_p, esn_p, eo_p = padded_rows(es), padded_rows(es_new), padded_rows(eo)
        rec = ee.es_record(eo, so)
        csr = (p.row_ptr, p.other)
        for name, kern, plain, args in (
                ("K1", lambda *a: ce.tail_edge_stats(*a, K=k, long_rows=p.long_rows),
                 lambda *a: ce.tail_edge_stats_plain(*a, K=k),
                 (es_p, eo_p, *csr, p.x)),
                ("K1raw", lambda *a: ce.tail_edge_stats(*a, mode="raw", K=k,
                                                        long_rows=p.long_rows),
                 lambda *a: ce.tail_edge_stats_plain(*a, mode="raw", K=k),
                 (es_p, eo_p, *csr, None)),
                ("K7", lambda *a: ee.ext_factor_tail(*a, K=k, long_rows=p.long_rows),
                 lambda *a: ee.ext_factor_tail_plain(*a, K=k),
                 (es_p, rec, *csr, p.x)),
                ("K8", lambda *a: ee.ext_scalar_tail(*a, K=k, long_rows=p.long_rows),
                 lambda *a: ee.ext_scalar_tail_plain(*a, K=k),
                 (esn_p, rec, *csr))):
            got, ref = kern(*args), plain(*args)
            _, rel = compare(got, ref)
            if got.shape != ref.shape or not rel <= RTOL:
                raise AssertionError(f"bigk {name} K={k}: relative error {rel} > {RTOL}")
            worst[name] = max(worst[name], rel)
    return worst


# --------------------------------- row groups: K1, K7, K5, K6 and K8 --

TAIL_KERNELS = ("K1", "K1raw", "K7", "K5", "K6", "K8")
GAUSS_TAIL = ("K5", "K6")  # signed sums: held per column (COL_RTOL)
# Positions of the self-row tables in a kernel's tables (cut to the long
# rows in _tail_notes).
SELF_TABS = {"K1": (0,), "K1raw": (0,), "K7": (0,), "K5": (), "K6": (0,), "K8": (0,)}


def _tail_tabs(kid, n_self, n_other, k, seed):
    """A kernel's tables in the wrapper's order, padded as the kernel takes
    them: positive (e_self, e_other) for K1, (e_self, [e_other | s_other])
    for K7 and K8; Gaussian-state ([m_other | b_other],) for K5, ([m_self | b_self],
    [m_other | b_other], sq_other) for K6, sq = v + m^2."""
    import torch

    from pmf_tpu_torch.ops._tail import padded_rows
    from pmf_tpu_torch.ops.ext_edge import es_record
    from pmf_tpu_torch.ops.gaussian_edge import record_table

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kid not in GAUSS_TAIL:
        es, eo = padded_rows(_pos(gen, n_self, k)), _pos(gen, n_other, k)
        if kid in ("K7", "K8"):
            return es, es_record(eo, _pos(gen, n_other))
        return es, padded_rows(eo)
    m_s, m_o = (0.1 * torch.randn(n, k, generator=gen, device="cuda")
                for n in (n_self, n_other))
    b_s, b_o = (0.1 * torch.randn(n, generator=gen, device="cuda")
                for n in (n_self, n_other))
    sq_o = 0.1 + 0.5 * torch.rand(n_other, k, generator=gen, device="cuda") + m_o * m_o
    mb_o = record_table(m_o, b_o)
    return (mb_o,) if kid == "K5" else (record_table(m_s, b_s), mb_o, padded_rows(sq_o))


def _tail_kernel(kid, tabs, p, k, mods=None, windows="plan"):
    """The kept K1 ("K1", "K1raw"), K7, K5, K6 or K8 wrapper on padded
    tables, as the fits call it (``p.long_rows`` rows a warp each; K5 and
    K8 on a layout's TailCSR with the other-id windows the frames give them,
    ``_tail.tail_windows``, or ``windows`` where given); ``mods`` another
    tree's (cavi_edge, ext_edge, gaussian_edge) modules, given the same
    windows where its K5 and K8 take them."""
    import inspect

    from pmf_tpu_torch.data.blocked import TailCSR
    from pmf_tpu_torch.ops import cavi_edge as ce
    from pmf_tpu_torch.ops import ext_edge as ee
    from pmf_tpu_torch.ops import gaussian_edge as ge
    from pmf_tpu_torch.ops._tail import tail_windows

    kw = dict(K=k, long_rows=p.long_rows)
    if mods is not None:
        ce, ee, ge = mods
        fn = ee.ext_scalar_tail if kid == "K8" else ge.bias_tail_stats
        if kid in ("K5", "K8") and isinstance(p, TailCSR) \
                and "windows" in inspect.signature(fn).parameters:
            kw["windows"] = tail_windows(p, k, kid)  # a parent with windows walks them too
    elif kid in ("K5", "K8") and windows != "plan":
        kw["windows"] = windows
    elif kid in ("K5", "K8") and isinstance(p, TailCSR):
        kw["windows"] = tail_windows(p, k, kid)
    if kid == "K1raw":
        return ce.tail_edge_stats(*tabs, p.row_ptr, p.other, None, mode="raw", **kw)
    if kid == "K8":
        return ee.ext_scalar_tail(*tabs, p.row_ptr, p.other, **kw)
    fn = {"K1": ce.tail_edge_stats, "K7": ee.ext_factor_tail,
          "K5": ge.bias_tail_stats, "K6": ge.diag_tail_stats}[kid]
    return fn(*tabs, p.row_ptr, p.other, p.x, **kw)


def _tail_plain(kid, tabs, p, k):
    from pmf_tpu_torch.ops import cavi_edge as ce
    from pmf_tpu_torch.ops import ext_edge as ee
    from pmf_tpu_torch.ops import gaussian_edge as ge

    if kid in ("K1", "K1raw"):
        raw = kid == "K1raw"
        return ce.tail_edge_stats_plain(*tabs, p.row_ptr, p.other, None if raw else p.x,
                                        mode="raw" if raw else "cavi", K=k)
    if kid == "K8":
        return ee.ext_scalar_tail_plain(*tabs, p.row_ptr, p.other, max_edges=1 << 22,
                                        K=k)
    fn = {"K7": ee.ext_factor_tail_plain, "K5": ge.bias_tail_stats_plain,
          "K6": ge.diag_tail_stats_plain}[kid]
    return fn(*tabs, p.row_ptr, p.other, p.x, max_edges=1 << 22, K=k)


def _tail_plain_rows(kid, tabs, p, k, max_edges=1 << 22):
    """``_tail_plain`` on runs of whole self rows of at most ``max_edges``
    edges each, so that its per-edge temporaries stay a few GB on the real
    tail past K = 128."""
    import types

    import torch

    from pmf_tpu_torch.ops._tail import row_chunks

    outs = []
    for r0, r1 in row_chunks(p.row_ptr, max_edges):
        e0, e1 = int(p.row_ptr[r0]), int(p.row_ptr[r1])
        sub = types.SimpleNamespace(row_ptr=p.row_ptr[r0 : r1 + 1] - e0,
                                    other=p.other[e0:e1], x=p.x[e0:e1])
        outs.append(_tail_plain(kid, tuple(t[r0:r1] if i in SELF_TABS[kid] else t
                                           for i, t in enumerate(tabs)), sub, k))
    return torch.cat(outs)


def _tail_error(kid, got, ref):
    """(error, ok): relative per element for K1 and K7's positive sums, per
    column for K5 and K6's signed ones."""
    if kid in GAUSS_TAIL:
        _, col, ok = column_check(got, ref)
        return col, ok and got.shape == ref.shape
    _, rel = compare(got, ref)
    return rel, rel <= RTOL and got.shape == ref.shape


def _row_sectors(p, stride_floats, width_floats):
    """32-byte sectors the tail's edges touch gathering an other row of
    ``width_floats`` at ``stride_floats`` a row."""
    import torch

    off = (p.other.long() * (4 * stride_floats)) % 32
    return int(torch.sum((off + 4 * width_floats + 31) // 32))


def _tail_reckoning(kid, p, k, self_bytes, out_bytes):
    """Bytes of one tail pass if every gather came from HBM: each edge's id
    (and rating) once, the 32-byte sectors of its other row at
    ``tail_stride`` of its columns (K5's and K6's [m | b] records and K7's
    and K8's [e | s] records, K + 1; K6 also its v + m^2 row, K), and the
    self table, row pointers and output once."""
    from pmf_tpu_torch.ops._tail import columns, tail_stride

    S, Sq = tail_stride(columns(k, kid)), tail_stride(k)
    sectors = _row_sectors(p, S, S) + (_row_sectors(p, Sq, Sq) if kid == "K6" else 0)
    per_edge = 4 + (0 if kid in ("K1raw", "K8") else 4)
    return p.nnz * per_edge + 32 * sectors + self_bytes + p.row_ptr.nbytes + out_bytes


def _tail_notes(kid, name, tabs, p, k, ms, out_bytes):
    """Log the per-edge sector reckoning of a row-group pass and the time
    of its long rows alone: the first rows of new space up to the last row
    above 4x the mean length, launched as a pass of their own."""
    import types

    import torch

    self_bytes = sum(tabs[i].nbytes for i in SELF_TABS[kid])
    per_edge = _tail_reckoning(kid, p, k, self_bytes, out_bytes)
    lens = p.row_ptr[1:] - p.row_ptr[:-1]
    cut = 4 * p.nnz / max(p.n_self, 1)
    above = torch.nonzero(lens > cut)
    n_long = int(above.max()) + 1 if above.numel() else 0
    line = (f"  {kid} {name} K={k}: per-edge sectors {per_edge:.0f} B "
            f"({per_edge / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s) | longest row "
            f"{int(lens.max())}")
    if n_long:
        sub = types.SimpleNamespace(row_ptr=p.row_ptr[: n_long + 1], other=p.other,
                                    x=p.x, n_self=n_long,
                                    long_rows=min(p.long_rows, n_long))
        cut_tabs = tuple(t[:n_long] if i in SELF_TABS[kid] else t
                         for i, t in enumerate(tabs))
        long_ms = cuda_ms(lambda: _tail_kernel(kid, cut_tabs, sub, k))
        edges = int(p.row_ptr[n_long])
        line += (f" | rows 0..{n_long - 1} hold every row above {cut:.0f} edges "
                 f"({edges} edges, {edges / p.nnz:.1%}): alone {long_ms:.4f} ms, the "
                 f"pass {ms:.4f} ms")
    log(line)


def _tail_geometry_ks():
    """Every K where a row-group kernel's plan changes (K - 1 and K of each
    ``_tail.boundary_ks``, past K = 128 too), HUGEK_KS, and K = 3, 7, 20,
    50, 70, 127 (padded strides and the timed K)."""
    from pmf_tpu_torch.ops._tail import boundary_ks

    ks = {3, 7, 20, 50, 70, 127, *HUGEK_KS}
    for kid in TAIL_KERNELS:
        ks |= {k for b in boundary_ks(kid) for k in (b - 1, b) if k >= 1}
    return sorted(ks)


K17_WINDOWS = 3  # the other-id windows phase k17small gives K5's and K8's sum form


def phase_k17small(blocked, gblocked):
    """K1 (both modes), K7, K5, K6 and K8 against their plain versions at
    every K where a row-group plan changes, both directions of a small tail (with
    rows long enough for a warp each; the Gaussian ratings for K5 and K6),
    equal bits on a repeat; K5 and K8 in their sum form also walking
    K17_WINDOWS windows of other ids (``_tail.build_windows``; the small
    tables fit the L2, so their plan walks none)."""
    import torch

    from pmf_tpu_torch.ops._tail import build_windows, launch_plan

    ks = _tail_geometry_ks()
    worst = dict.fromkeys(TAIL_KERNELS, 0.0)
    windowed = set()
    for k in ks:
        for kid in TAIL_KERNELS:
            lay = gblocked if kid in GAUSS_TAIL else blocked
            for seed, p in enumerate((lay.by_user, lay.by_item)):
                tabs = _tail_tabs(kid, p.n_self, p.n_other, k, 90 + 2 * k + seed)
                ref = _tail_plain(kid, tabs, p, k)
                runs = [("plan", "plan")]
                if launch_plan(k, kid)["form"] == "sum":
                    runs.append((f"{K17_WINDOWS} windows", build_windows(
                        p.row_ptr, p.other, p.x, p.n_other, K17_WINDOWS)))
                    windowed.add(k)
                for label, win in runs:
                    got = _tail_kernel(kid, tabs, p, k, windows=win)
                    err, ok = _tail_error(kid, got, ref)
                    tag = f"k17small {kid} K={k} {'user' if seed == 0 else 'item'} {label}"
                    if not ok:
                        raise AssertionError(f"{tag}: error {err} over tolerance")
                    if not torch.equal(got, _tail_kernel(kid, tabs, p, k, windows=win)):
                        raise AssertionError(f"{tag}: two launches differ in bits")
                    worst[kid] = max(worst[kid], err)
    torch.cuda.synchronize()
    log(f"phase k17small: ok | K in {ks} (K5's and K8's sum form also in {K17_WINDOWS} "
        f"windows of other ids at {sorted(windowed)}) | worst error vs plain: "
        + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
        + f" (K1, K1raw, K7, K8 relative, tol {RTOL}; K5, K6 per column, tol {COL_RTOL}) "
        "| repeats equal in bits")


def _bigk_gauss_tail(blocked, k):
    """K3 (exact and lagged), K5 and K6 at ``k`` on a small tail, both
    directions: worst column error of each (signed sums)."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge

    worst = dict.fromkeys(("K3", "K5", "K6"), 0.0)
    for _, p, (m_s, _, b_s, _), (m_o, V_o, b_o, v_o) in _new_space_gauss(blocked, k):
        aug3 = _k3_table(m_o, V_o, b_o, k)
        csr = (p.row_ptr, p.other, p.x)
        cases = [("K3", kern, lambda wbs=wbs: ge.factor_tail_stats_plain(
                      aug3, *csr, k, wbs, max_edges=1 << 13))
                 for wbs in (False, True) for kern in _k3_forms(aug3, p, k, wbs).values()]
        for kid in GAUSS_TAIL:
            tabs = _gauss_tail_tabs(kid, m_s, b_s, m_o, v_o, b_o)
            cases.append((kid, lambda kid=kid, tabs=tabs: _tail_kernel(kid, tabs, p, k),
                          lambda kid=kid, tabs=tabs: _tail_plain(kid, tabs, p, k)))
        for name, kern, plain in cases:
            got, ref = kern(), plain()
            _, col, ok = column_check(got, ref)
            if got.shape != ref.shape or not ok:
                raise AssertionError(f"bigk {name} K={k}: column error {col} > {COL_RTOL}")
            if not torch.equal(got, kern()):
                raise AssertionError(f"bigk {name} K={k}: two runs differ in bits")
            worst[name] = max(worst[name], col)
    return worst


def _gauss_tail_tabs(kid, m_s, b_s, m_o, v_o, b_o):
    """K5's or K6's tables in new space, padded as gaussian_bias_stats and
    gaussian_diag_stats build them."""
    from pmf_tpu_torch.ops._tail import padded_rows
    from pmf_tpu_torch.ops.gaussian_edge import record_table

    mb_o = record_table(m_o, b_o)
    if kid == "K5":
        return (mb_o,)
    return record_table(m_s, b_s), mb_o, padded_rows(v_o + m_o * m_o)


def _k3_forms(aug, p, k, wbs=False) -> dict:
    """K3 at ``k`` on one CSR, as callables: to K = 128 its one form; past
    it the plan's (the wrapper, on the CSR's schedule), and the group form
    and the slab form at its narrowest and widest chunks, each by giving
    the plan the inputs that select it (a pair count, L2 bytes)."""
    from pmf_tpu_torch.ops import gaussian_edge as ge

    args = (aug, p.row_ptr, p.other, p.x, k, wbs)
    if k <= ge.FACTOR_NARROW_MAX_K:
        return {"plan": lambda: ge.factor_tail_stats(*args)}
    sched = ge.build_factor_schedule(p.row_ptr, p.other, p.x, p.n_other, grouped=True)
    return {"plan": lambda: ge.factor_tail_stats(*args, schedule=sched),
            "group": lambda: ge.launch_factor(*args, sched, pairs=1, l2=0),
            "slab 64": lambda: ge.launch_factor(*args, sched, pairs=0, l2=0),
            "slab 512": lambda: ge.launch_factor(*args, sched, pairs=0, l2=1 << 62)}


def _k3_trace(k, blocked) -> dict:
    """K3's kernels in a sweep's trace at ``k`` (name piece -> launches a
    sweep): one a direction to K = 128; past it the slab copy and two of the
    form each direction's plan takes (its instance for the chunks that hold
    factors and the one for the rest)."""
    from pmf_tpu_torch.ops import gaussian_edge as ge

    if k <= ge.FACTOR_NARROW_MAX_K:
        return {"::factor_kernel": 2}
    out = {"factor_copy_kernel": 2}
    for p in (blocked.by_user, blocked.by_item):
        s = ge.factor_schedule(p)
        form = ge.factor_plan(k, p.n_other, p.nnz, s.pairs)["form"]
        key = f"factor_{form}_kernel"
        out[key] = out.get(key, 0) + 2
    return out


def _small_k34(blocked, ks=(1, 2, 5, 7, 8, 9, 16, 17, 20, 24, 25, 30, 31, 32, 33, 48,
                            49, 64, 65, 100, 128), n_mats=1003):
    """K3 (lagged) and K4 (``n_mats`` matrices, 1003: no multiple of any
    packing) at every K where the kernels' geometry changes, against
    their plain versions."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge
    from pmf_tpu_torch.ops.gj_inverse import (
        batched_psd_inverse_gj, batched_psd_inverse_gj_plain)

    worst3 = worst4 = 0.0
    for k in ks:
        for _, p, _, (m_o, V_o, b_o, _) in _new_space_gauss(blocked, k):
            aug = _k3_table(m_o, V_o, b_o, k)
            args = (aug, p.row_ptr, p.other, p.x, k, True)
            ref = ge.factor_tail_stats_plain(*args, max_edges=1 << 13)
            for form, kern in _k3_forms(aug, p, k, True).items():
                col, ok = column_check(kern(), ref)[1:]
                if not ok:
                    raise AssertionError(f"K3 K={k} {form}: column error {col} > {COL_RTOL}")
                worst3 = max(worst3, col)
        P = _spd(n_mats, k, 60 + k)
        ref = batched_psd_inverse_gj_plain(P)
        ref64 = torch.linalg.inv(P.double())
        scale = ref64.abs().amax(dim=(1, 2))
        got = batched_psd_inverse_gj(P)
        err = max(float(((got - ref).abs().amax(dim=(1, 2)) / scale).max()),
                  float(((got.double() - ref64).abs().amax(dim=(1, 2)) / scale).max()))
        if not err <= INV_RTOL:
            raise AssertionError(f"K4 K={k}: error {err} > {INV_RTOL}")
        worst4 = max(worst4, err)
    torch.cuda.synchronize()
    log(f"phase k34small: ok | K in {list(ks)} | {blocked.by_user.n_self} x "
        f"{blocked.by_item.n_self}, {blocked.by_user.nnz} ratings, {n_mats} matrices "
        f"| K3 worst column error {worst3:.3e} "
        f"(tol {COL_RTOL}), K4 worst per-matrix error {worst4:.3e} (tol {INV_RTOL})")


def _bigk_head(k, shapes=((70, 128), (3000, 960)), precision="high"):
    """K2 at ``k`` vs its plain version in float64: ``shapes``, the three
    cell kinds (bf16 and float32 M), both sides, a second launch in bits;
    at ``precision`` "fast" the one-term instance, at k2fast's small-shape
    gate FAST_SMALL_RTOL."""
    import torch

    from pmf_tpu_torch.ops.dense_head import fused_alloc_tier, fused_alloc_tier_plain

    tol = RTOL if precision == "high" else FAST_SMALL_RTOL
    gen = torch.Generator(device="cuda").manual_seed(70 + k)
    worst = 0.0
    for rows, hip in shapes:
        hi = hip - 13
        for kind in ("integer", "fractional", "m_f32"):
            x_hi, x_lo, m = _k2small_cells(kind, rows, hip, hi, gen)
            theta = 0.02 + torch.rand(rows, k, generator=gen, device="cuda")
            beta = 0.02 + torch.rand(hip, k, generator=gen, device="cuda")
            beta[hi:] = 0
            for item_side in (False, True):
                kw = dict(rate_floor=K2SMALL_FLOOR, item_side=item_side,
                          precision=precision)
                got = fused_alloc_tier(theta, beta, x_hi, m, x_lo, **kw)
                again = fused_alloc_tier(theta, beta, x_hi, m, x_lo, **kw)
                ref = fused_alloc_tier_plain(theta.double(), beta.double(), x_hi, m,
                                             x_lo, **kw)
                _, rel = compare(got, ref)
                tag = (f"bigk K2 {precision} K={k} rows {rows} hip {hip} {kind} "
                       f"{'item' if item_side else 'user'}")
                if got.shape != ref.shape or not rel <= tol:
                    raise AssertionError(f"{tag}: relative error {rel} > {tol}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{tag}: two launches differ in bits")
                worst = max(worst, rel)
    return worst


def _spd(n, k, seed, chunk=8192):
    """n random K x K positive-definite matrices on the card, 0.5 I + A A^T,
    made ``chunk`` at a time (no n x K x K temporary beside the result)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    P = torch.empty((n, k, k), device="cuda")
    for r0 in range(0, n, chunk):
        A = 0.1 * torch.randn(min(chunk, n - r0), k, k, generator=g, device="cuda")
        torch.bmm(A, A.transpose(1, 2), out=P[r0 : r0 + A.shape[0]])
        P[r0 : r0 + A.shape[0]].diagonal(dim1=1, dim2=2).add_(0.5)
    return P


def _bigk_inverse(k, n=3000):
    """K4 at ``k`` vs its plain version and float64 inv, per matrix, on
    ``n`` matrices."""
    import torch

    from pmf_tpu_torch.ops.gj_inverse import (
        batched_psd_inverse_gj, batched_psd_inverse_gj_plain)

    P = _spd(n, k, 40 + k)
    got = batched_psd_inverse_gj(P)
    ref = batched_psd_inverse_gj_plain(P)
    ref64 = torch.linalg.inv(P.double())
    scale = ref64.abs().amax(dim=(1, 2))
    err = max(float(((got - ref).abs().amax(dim=(1, 2)) / scale).max()),
              float(((got.double() - ref64).abs().amax(dim=(1, 2)) / scale).max()))
    if not err <= INV_RTOL:
        raise AssertionError(f"bigk K4 K={k}: error {err} > {INV_RTOL}")
    return err


def _bigk_map(u, i, x, k, lay=None):
    """K9 at ``k`` on a small layout (``lay``, or one built here): three
    steps of an epoch grouping (the first, the last, the one with the
    longest item run), with pieces of PIECE edges, of the plan's
    ``piece_of(k)`` and of 16 (so that many runs span several pieces; to
    K = 128 the short runs then hold at most 16 edges)."""
    from pmf_tpu_torch.models.hpf_map import build_map_layout
    from pmf_tpu_torch.ops.map_grad import PIECE, piece_of

    mix = 4
    if lay is None:
        lay = build_map_layout(u, i, x, int(u.max()) + 1, int(i.max()) + 1, 4096,
                               mix=mix, device="cuda")
    u_sp, i_sp = _map_tables(lay, k)
    order = np.random.default_rng(9).permutation(lay.n_segments)
    worst = 0.0
    for piece in sorted({PIECE, piece_of(k), 16}, reverse=True):
        groups = lay.group(order, mix, k, piece)
        n_steps = groups[0].n_steps
        longest, edges = _longest_run_step(groups[1])
        for step in sorted({0, n_steps - 1, longest}):
            seg_ids = order[step * mix : (step + 1) * mix].tolist()
            worst = max(worst, _check_map_step(
                lay, u_sp, i_sp, seg_ids, f"bigk K9 K={k} piece {piece} step {step}"
                + (f" (longest item run, {edges} edges)" if step == longest else ""),
                groups, step)[1])
    return worst


def phase_bigk():
    """Every kernel at K = 50 and K = 128 vs its plain version on small
    shapes, at the K = 20 phases' tolerances (RTOL for positive sums,
    COL_RTOL per column for signed ones, INV_RTOL for K4); then, at K = 50,
    one card-vs-host fit per family (the small, psmall, gsmall and msmall
    phases)."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.synthetic import synth_ratings

    u, i, x = synth_ratings(3000, 1500, 120_000, seed=5)
    x = (x + 1.0).astype(np.float32)
    blocked = build_blocked(u, i, x, reorder=True, device="cuda")
    gx = np.random.default_rng(2).standard_normal(len(u)).astype(np.float32)
    gblocked = build_blocked(u, i, gx, reorder=True, device="cuda")
    phase_k17small(blocked, gblocked)
    _small_k34(gblocked)
    for k in BIGK_KS:
        worst = _bigk_poisson_tail(blocked, k)
        worst.update(_bigk_gauss_tail(gblocked, k))
        worst["K2"] = _bigk_head(k)
        worst["K4"] = _bigk_inverse(k)
        worst["K9"] = _bigk_map(u, i, x, k)
        torch.cuda.synchronize()
        log(f"phase bigk K={k}: ok | worst error vs plain: "
            + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
            + f" (K1, K1raw, K2, K7, K8 relative, tol {RTOL}; K3, K5, K6, K9 per "
            f"column, tol {COL_RTOL}; K4 per matrix, tol {INV_RTOL})")
    phase_hugek(u, i, x, blocked, gblocked)
    del blocked, gblocked
    phase_small(K_WIDE)
    phase_psmall(K_WIDE)
    phase_gsmall(K_WIDE)
    phase_msmall(K_WIDE)
    t0 = time.perf_counter()
    # At K = 160 one sweep (epoch) a family, cut from 3 to keep the script
    # within its time limit (101.6 s at 3 on the H100): the kernels past 128
    # are held against their plain versions in phase hugek, and the runs
    # at K_WIDE keep 3.
    phase_small(K_HUGE, sweeps=1)
    phase_psmall(K_HUGE, sweeps=1)
    phase_gsmall(K_HUGE, shape=TINY, head=TINY_HEAD, sweeps=1)
    phase_msmall(K_HUGE, epochs=1)
    log(f"  card-vs-host runs at K={K_HUGE}: {time.perf_counter() - t0:.1f} s")


def _beside(bounds, lo=129):
    """K - 1 and K of each boundary at or past ``lo``."""
    return {k for b in bounds if b >= lo for k in (b - 1, b)}


def hugek_plan() -> dict:
    """The K of phase hugek per kernel: HUGEK_KS, and K - 1 and K of each
    boundary past 128 that the kernel's module lists: K3's wide instance
    and its b leaving the first chunk, K4's panel form, each tile width of
    its CTA form (from 65), each change of the panel plan to 600 and
    HUGE_K4_FAR, K9's instances;
    for K2 every boundary past 32 (the pass form's chunk widths, two
    passes, P in the ring, for each kind of cell tile and precision).  The
    row-group kernels' are phase k17small's."""
    from pmf_tpu_torch.ops import dense_head, gaussian_edge, gj_inverse, map_grad

    base = set(HUGEK_KS)
    kinds = [(item, m_f32, lo) for item in (False, True)
             for m_f32, lo in ((False, False), (False, True), (True, True))]
    return {
        "K3": sorted(base | _beside(gaussian_edge.factor_boundary_ks())),
        "K4": sorted(base | _beside(gj_inverse.boundary_ks())
                     | _beside(gj_inverse.cta_boundary_ks(), lo=65)
                     | _beside(gj_inverse.panel_boundary_ks(600))
                     | set(HUGE_K4_FAR) | set(gj_inverse.boundary_ks(5000)[-1:])),
        "K9": sorted(base | _beside(map_grad.boundary_ks())),
        # the runs form's boundaries (K <= 128), held on phase bigk's small layout
        "K9runs": sorted(k for k in _beside(map_grad.boundary_ks(), lo=1) if 1 <= k <= 128),
        "K2": sorted(base | {k for kind in kinds
                             for k in _beside(dense_head.boundary_ks(*kind), lo=33)}),
        "K2fast": sorted(base | {k for kind in kinds
                                 for k in _beside(dense_head.boundary_ks(*kind, True),
                                                  lo=33)}),
    }


def phase_hugek(u, i, x, blocked, gblocked):
    """Every kernel past K = 128 vs its plain version (phase bigk's
    tolerances), at the K of ``hugek_plan``: K1 (both modes), K7, K8, K5,
    K6 at HUGEK_KS on phase bigk's small input (and at every boundary in
    phase k17small); K3 and K4 up to K = 300 there (K4 on HUGE_K4_MATS
    matrices where its form is global) and past it on the TINY input; K2
    at both precisions, on both small shapes up to K = 300 and on the
    narrow one past it; K9 on one small MAP layout."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.synthetic import synth_ratings
    from pmf_tpu_torch.models.hpf_map import build_map_layout
    from pmf_tpu_torch.ops.gj_inverse import form

    t0 = time.perf_counter()
    plan = hugek_plan()
    for k in HUGEK_KS:
        worst = _bigk_poisson_tail(blocked, k)
        worst.update(_bigk_gauss_tail(gblocked, k))
        torch.cuda.synchronize()
        log(f"  hugek tail K={k}: ok | worst error vs plain: "
            + ", ".join(f"{n} {v:.3e}" for n, v in worst.items()))
    tu, ti, _ = synth_ratings(*TINY, seed=8)
    tx = np.random.default_rng(4).standard_normal(len(tu)).astype(np.float32)
    tiny = build_blocked(tu, ti, tx, reorder=True, device="cuda")
    small_k = [k for k in plan["K3"] if k <= 300]
    _small_k34(gblocked, ks=small_k, n_mats=HUGE_K4_MATS)
    _small_k34(tiny, ks=[k for k in plan["K3"] if k > 300], n_mats=HUGE_K4_MATS)
    k4 = {k: _bigk_inverse(k, 3000 if form(k) != "panel" else HUGE_K4_MATS if k <= 600
                           else 4 if k <= 1000 else 1)
          for k in plan["K4"]}
    log(f"  hugek K4: ok | per-matrix error vs plain and float64 inv (tol {INV_RTOL}): "
        + ", ".join(f"K={k} {form(k)} {v:.3e}" for k, v in k4.items()))
    for precision, key in (("high", "K2"), ("fast", "K2fast")):
        worst = {k: _bigk_head(k, precision=precision) if k <= 300 else
                 _bigk_head(k, shapes=((70, 128),), precision=precision)
                 for k in plan[key]}
        torch.cuda.synchronize()
        log(f"  hugek {key}: ok | worst relative error vs plain float64 (tol "
            f"{RTOL if precision == 'high' else FAST_SMALL_RTOL}): "
            + ", ".join(f"K={k} {v:.3e}" for k, v in worst.items()))
    lay = build_map_layout(u, i, x, int(u.max()) + 1, int(i.max()) + 1, 4096, mix=4,
                           device="cuda")
    worst = {k: _bigk_map(u, i, x, k, lay) for k in plan["K9runs"] + plan["K9"]}
    torch.cuda.synchronize()
    log(f"  hugek K9: ok | worst column error vs plain (tol {COL_RTOL}): "
        + ", ".join(f"K={k} {v:.3e}" for k, v in worst.items()))
    log(f"phase hugek: ok | K per kernel {plan} (the row-group kernels' in phase "
        f"k17small) | {time.perf_counter() - t0:.1f} s")


def phase_wide_poisson(blocked, k=K_WIDE):
    """At ``k`` factors on the real data (K_WIDE, K_HUGE): K1, K1raw, K7
    and K8 on the tail and K2 at both precisions on the tiers, both
    directions: device time (CUDA events) and the bound at ``k``, reckoned
    as phases K1, K7, K8 and K2 reckon theirs at K = 20 (each input read
    once, each output written once; K2's work without its padding).  Each
    tail kernel first
    against its plain version on the same tables (on runs of rows, at
    RTOL), both directions; K2 also against its plain
    version on every tier and side, as phases K2 and k2fast do at K = 20:
    "high" at RTOL, "fast" at FAST_SMALL_RTOL, one bf16 step of W (at K =
    160 the kernel's R, summed chunk by chunk, flips more of W's roundings
    than at K = 20, and a head column of few cells shows a flip whole),
    with the share of elements past FAST_RTOL logged.  Beside each tail
    kernel's time its per-edge sector reckoning (``_tail_reckoning``), and
    K7's S_wother half alone by torch.sparse.mm (note (b) of PERF.md's
    kernel table).  Returns {kid: {ms, bound_ms, bound_by, library_ms}}, the
    tail kernels with ``sector_ms`` and K7 with ``half_ms``."""
    import torch

    from pmf_tpu_torch.ops._tail import padded_rows
    from pmf_tpu_torch.ops.dense_head import (
        PASS_MAX_K, fused_alloc_tier, fused_alloc_tier_plain, plan_launch)
    from pmf_tpu_torch.ops.ext_edge import es_record

    gen = torch.Generator(device="cuda").manual_seed(5)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    reps = TIMING_REPS if k <= K_WIDE else 3
    kids = ("K1", "K1raw", "K2", "K2fast", "K7", "K8")
    ms, n_bytes, n_flops = (dict.fromkeys(kids, 0.0) for _ in range(3))
    tail_worst, lib_ms, sectors = {}, {}, {}
    for name, p in (("user", blocked.by_user), ("item", blocked.by_item)):
        es, eo, so = _pos(gen, p.n_self, k), _pos(gen, p.n_other, k), _pos(gen, p.n_other)
        es_p, eo_p, rec = padded_rows(es), padded_rows(eo), es_record(eo, so)
        csr = p.row_ptr.nbytes + p.other.nbytes
        out2 = 4 * 2 * k * p.n_self
        for kid, tabs, nb, flops in (
                ("K1", (es_p, eo_p), es.nbytes + eo.nbytes + csr + p.x.nbytes + out2,
                 5 * k + 1),
                ("K1raw", (es_p, eo_p), es.nbytes + eo.nbytes + csr + out2, 3 * k),
                ("K7", (es_p, rec), es.nbytes + eo.nbytes + so.nbytes + csr + p.x.nbytes
                 + out2, 6 * k + 1),
                ("K8", (es_p, rec), es.nbytes + eo.nbytes + so.nbytes + csr
                 + 4 * p.n_self, 2 * k + 1)):
            err, ok = _tail_error(kid, _tail_kernel(kid, tabs, p, k),
                                  _tail_plain_rows(kid, tabs, p, k))
            if not ok:
                raise AssertionError(f"wide {kid} K={k} on the real tail: relative "
                                     f"error {err} > {RTOL}")
            tail_worst[kid] = max(tail_worst.get(kid, 0.0), err)
            dir_ms = cuda_ms(lambda: _tail_kernel(kid, tabs, p, k), reps=reps)
            ms[kid] += dir_ms
            if k == K_HUGE and kid in ("K1", "K7"):  # the long rows alone (the dot form)
                _tail_notes(kid, name, tabs, p, k, dir_ms, 4 * p.n_self * 2 * k)
            n_bytes[kid] += nb
            n_flops[kid] += p.nnz * flops
            out_bytes = 4 * p.n_self * (1 if kid == "K8" else 2 * k)
            sectors[kid] = sectors.get(kid, 0) + _tail_reckoning(
                kid, p, k, tabs[0].nbytes, out_bytes)
        # The linear kernels' library forms (notes (e), (g) of PERF.md's
        # kernel table), on the same tables: K1 raw as e_s * S and S, S =
        # sparse.mm(pattern, e_o); K8 as the row dot of e_s with
        # sparse.mm(pattern, s_o e_o).
        pattern = _csr_ones(p)

        def k1raw_lib(es=es, eo=eo, pattern=pattern):
            s_other = torch.sparse.mm(pattern, eo)
            return torch.cat([es * s_other, s_other], dim=1)

        def k8_lib(es=es, eo=eo, so=so, pattern=pattern):
            return torch.sum(es * torch.sparse.mm(pattern, so[:, None] * eo), dim=1)

        for kid, fn in (("K1raw", k1raw_lib), ("K8", k8_lib)):
            lib_ms[kid] = lib_ms.get(kid, 0.0) + cuda_ms(fn, reps=reps)
        # K7's S_wother half alone (its allocation half has no library form)
        half = lambda so=so, eo=eo, pattern=pattern: torch.sparse.mm(  # noqa: E731
            pattern, so[:, None] * eo)
        lib_ms["K7 half"] = lib_ms.get("K7 half", 0.0) + cuda_ms(half, reps=reps)
        del es, eo, so, es_p, eo_p, rec, pattern, half
    lines = {"K2": {}, "K2fast": {}}
    worst = dict.fromkeys(lines, 0.0)
    past, n_out = 0, 0  # K2fast elements past FAST_RTOL
    for h in blocked.head or ():
        theta = _pos(gen, h.hu, k)
        beta = torch.nn.functional.pad(_pos(gen, h.hi, k), (0, 0, 0, h.hip - h.hi))
        cells = (h.x_hi, h.m, h.x_lo)
        m_f32, has_lo = h.m.dtype == torch.float32, h.x_lo is not None
        cells_bytes = sum(a.nbytes for a in cells if a is not None) * h.hi // h.hip
        chunk = max(1, (1 << 27) // h.hip)
        for item_side in (False, True):
            for kid, prec, tol in (("K2", "high", RTOL),
                                   ("K2fast", "fast", FAST_SMALL_RTOL)):
                kw = dict(rate_floor=1e-10, item_side=item_side, precision=prec)
                got = fused_alloc_tier(theta, beta, *cells, **kw)
                ref = fused_alloc_tier_plain(theta, beta, *cells, row_chunk=chunk, **kw)
                _, rel = compare(got, ref)
                if prec == "fast":
                    d = (got.double() - ref.double()).abs()
                    past += int((d > FAST_RTOL * ref.double().abs()).sum())
                    n_out += got.numel()
                if got.shape != ref.shape or not rel <= tol:
                    raise AssertionError(f"huge {kid} tier ({h.row_start}, {h.hu}, {h.hi}) "
                                         f"item_side={item_side}: relative error {rel} > "
                                         f"{tol}")
                worst[kid] = max(worst[kid], rel)
                del ref
                t_ms = cuda_ms(lambda: fused_alloc_tier(theta, beta, *cells, **kw), reps=reps)
                ms[kid] += t_ms
                plan = plan_launch(h.hu, h.hip, k, item_side, m_f32, has_lo, n_sm,
                                   prec == "fast")
                log(f"  {kid} K={k} tier ({h.row_start}, {h.hu}, {h.hi}) "
                    f"{'item' if item_side else 'user'}: rel {rel:.3e} | {t_ms:.4f} ms | "
                    f"{_k2_plan_note(plan, k, item_side, m_f32, prec == 'fast')}")
                if plan.passes != -(-k // PASS_MAX_K):
                    raise AssertionError(f"{kid} K={k}: {plan.passes} passes over the cells")
                nb = cells_bytes + theta.nbytes + beta[: h.hi].nbytes + got.nbytes
                for name, v in _k2_bound(h.hu, h.hip, m_f32, has_lo, nb,
                                         fast=prec == "fast", k=k).items():
                    lines[kid][name] = lines[kid].get(name, 0.0) + v
    out = {}
    for kid in kids:
        if kid in lines:
            by = max(lines[kid], key=lines[kid].get)
            b_ms, b_by = lines[kid][by], "bytes" if by == "bytes" else "operations"
        else:
            b_ms, b_by = bound(n_bytes[kid], n_flops[kid])
        out[kid] = dict(ms=ms[kid], bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms.get(kid))
        if kid in sectors:
            out[kid]["sector_ms"] = sectors[kid] / HBM_BYTES_PER_S * 1e3
    out["K7"]["half_ms"] = lib_ms["K7 half"]
    log(f"phase {'bigk' if k == K_WIDE else 'huge'} timing (Poisson, real data, K={k}): "
        "ok | per sweep "
        + ", ".join(f"{n} {v['ms']:.4f} ms" + (f" (bound {v['bound_ms']:.4f}, "
                                                  f"{v['bound_by']})" if "bound_ms" in v
                                                  else "")
                    + (f" per-edge sectors {v['sector_ms']:.4f} ms" if "sector_ms" in v
                       else "")
                    + (f" library {v['library_ms']:.4f} ms" if v["library_ms"] else "")
                    + (f" S_wother half by torch.sparse.mm {v['half_ms']:.4f} ms"
                       if "half_ms" in v else "")
                    for n, v in out.items())
        + " | tail vs plain, both directions: worst rel "
        + ", ".join(f"{n} {v:.3e}" for n, v in tail_worst.items())
        + f" (tol {RTOL}) | K2 vs plain on every tier: worst rel {worst['K2']:.3e} (tol "
        f"{RTOL}), fast {worst['K2fast']:.3e} (tol {FAST_SMALL_RTOL:.3e}; {past} of {n_out} elements "
        f"past {FAST_RTOL})")
    return out


def phase_huge_gauss(blocked):
    """At K_HUGE on the real Gaussian tail: K5 and K6, both directions,
    and K4 on 162k and 59k matrices, each side alone: device time (CUDA
    events) and the bound at K_HUGE reckoned as phases K4, K5 and K6 do at
    K = 20; K5 and K6 first against their plain versions on the same tables
    (per column, COL_RTOL).  K3 at K_HUGE is phase k3wide's.  Returns
    {kid: {ms, bound_ms, bound_by}}."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge
    from pmf_tpu_torch.ops._tail import padded_rows

    k = K_HUGE
    gen = torch.Generator(device="cuda").manual_seed(6)
    kids = ("K5", "K6", "K4")
    ms, n_bytes, n_flops = (dict.fromkeys(kids, 0.0) for _ in range(3))
    worst, lib_ms, sectors = {}, {}, {}
    for p in (blocked.by_user, blocked.by_item):
        ones = _csr_ones(p)
        m_s, m_o = 0.1 * _pos(gen, p.n_self, k), 0.1 * _pos(gen, p.n_other, k)
        b_s, b_o, v_o = _pos(gen, p.n_self), _pos(gen, p.n_other), _pos(gen, p.n_other, k)
        csr = p.row_ptr.nbytes + p.other.nbytes + p.x.nbytes
        for kid, tabs, nb, flops in (
                ("K5", (ge.record_table(m_o, b_o),),
                 m_o.nbytes + b_o.nbytes + csr + 4 * (k + 2) * p.n_self, k + 2),
                ("K6", (ge.record_table(m_s, b_s), ge.record_table(m_o, b_o),
                        padded_rows(v_o + m_o * m_o)),
                 m_s.nbytes + b_s.nbytes + m_o.nbytes + b_o.nbytes + v_o.nbytes + csr
                 + 4 * 3 * k * p.n_self, 7 * k + 2)):
            err, ok = _tail_error(kid, _tail_kernel(kid, tabs, p, k),
                                  _tail_plain_rows(kid, tabs, p, k))
            if not ok:
                raise AssertionError(f"huge {kid} on the real tail: column error {err} > "
                                     f"{COL_RTOL}")
            worst[kid] = max(worst.get(kid, 0.0), err)
            ms[kid] += cuda_ms(lambda: _tail_kernel(kid, tabs, p, k), reps=3)
            n_bytes[kid] += nb
            n_flops[kid] += p.nnz * flops
            sectors[kid] = sectors.get(kid, 0) + _tail_reckoning(
                kid, p, k, sum(tabs[i].nbytes for i in SELF_TABS[kid]),
                4 * p.n_self * (k + 2 if kid == "K5" else 3 * k))
        mb = torch.cat([m_o, b_o[:, None]], dim=1)  # note (b): K5's CSR-ones @ [m | b]
        lib_ms["K5"] = lib_ms.get("K5", 0.0) + cuda_ms(lambda: torch.sparse.mm(ones, mb),
                                                       reps=3)
        del ones, mb
    from pmf_tpu_torch.ops.gj_inverse import batched_psd_inverse_gj

    for n, seed in ((N_USERS, 1), (N_ITEMS, 2)):
        P = _spd(n, k, seed)
        ms["K4"] += cuda_ms(lambda: batched_psd_inverse_gj(P), reps=2)
        del P
        torch.cuda.empty_cache()
    b_bytes, b_ops = _k4_bounds(N_USERS + N_ITEMS, k)
    out = {kid: dict(ms=ms[kid], library_ms=lib_ms.get(kid),
                     sector_ms=sectors[kid] / HBM_BYTES_PER_S * 1e3,
                     **dict(zip(("bound_ms", "bound_by"), bound(n_bytes[kid], n_flops[kid]))))
           for kid in ("K5", "K6")}
    out["K4"] = dict(ms=ms["K4"], bound_ms=max(b_bytes, b_ops),
                     bound_by="bytes" if b_bytes >= b_ops else "operations")
    log(f"phase huge timing (Gaussian, real data, K={k}): ok | per sweep "
        + ", ".join(f"{n} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, {v['bound_by']})"
                    + (f" per-edge sectors {v['sector_ms']:.4f} ms" if "sector_ms" in v
                       else "")
                    + (f" library {v['library_ms']:.4f} ms" if v.get("library_ms") else "")
                    for n, v in out.items())
        + f" | K3 in phase k3wide | K4 on {N_USERS} + {N_ITEMS} matrices | tail vs "
        "plain, both directions: worst column error "
        + ", ".join(f"{n} {v:.3e}" for n, v in worst.items()) + f" (tol {COL_RTOL})")
    return out


K3_XL_KS = (256, 300)  # phase k3wide on the XL CSR (XL_K and past it)
K3_TURN_REPS = 2  # launches a timed turn of K3 past K = 128


def _k3_random_table(n_other, k, seed):
    """K3's padded table of random records (made directly, without the
    (rows, K, K) covariances it packs): 0.1 U(0, 1) - 0.03, zero pad."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge

    gen = torch.Generator(device="cuda").manual_seed(seed)
    aug = 0.1 * torch.rand(n_other, ge.factor_stride(k), generator=gen, device="cuda") - 0.03
    aug[:, k + 1 + ge.tri_size(k):] = 0
    return aug


def _xl_layout(train):
    """The XL CSR as GaussianMF.fit builds it (no head below 4M ratings)."""
    from pmf_tpu_torch.data.blocked import build_blocked

    return build_blocked(*train, n_users=XL_USERS, n_items=XL_ITEMS, reorder=True,
                         head="auto", head_bytes=GAUSS_HEAD_BYTES, device="cuda")


def phase_k3wide(gblocked, xl):
    """K3's wide forms where the port runs them at full size: the bench's
    Gaussian tail at K_HUGE and the XL CSR (``xl``) at K3_XL_KS, both
    directions, on random tables.  Each: the plan (form, chunk, CTA rows,
    the pair count and edges a pair), the kernel against its plain version
    per column (COL_RTOL), a second launch equal in bits, two turns of
    K3_TURN_REPS launches by CUDA events, torch.sparse.mm of the CSR's
    pattern by the same records (the pass-through bulk), and the bounds:
    per-edge gather, table once, grouped (each distinct (group, other)
    pair's record once), with the slab form's CSR rereads; then every K3
    instance's ptxas line.  Returns {"bench": huge-timing entry, "xl":
    {k: entry}}."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge

    t0 = time.perf_counter()
    res = {}
    to_ms = lambda n: n / HBM_BYTES_PER_S * 1e3  # noqa: E731
    for label, k, lay in [("bench", K_HUGE, gblocked)] + [("XL", k, xl) for k in K3_XL_KS]:
        T = ge.tri_size(k)
        tot = dict(ms=0.0, library_ms=0.0, n_bytes=0.0, n_flops=0.0, per_edge=0.0,
                   grouped=0.0, max_abs_err=0.0, turns=[0.0, 0.0], forms=[])
        for name, p in (("user", lay.by_user), ("item", lay.by_item)):
            sched = ge.factor_schedule(p)
            plan = ge.factor_plan(k, p.n_other, p.nnz, sched.pairs,
                                  ge.device_l2_bytes(p.x.device))
            aug = _k3_random_table(p.n_other, k, k + len(name))
            args = (aug, p.row_ptr, p.other, p.x, k)
            got = ge.factor_tail_stats(*args, schedule=sched)
            ref = ge.factor_tail_stats_plain(*args, max_edges=1 << 16)
            abs_err, worst, ok = column_check(got, ref)
            del ref
            if not ok:
                raise AssertionError(f"k3wide {label} K={k} {name}: column error {worst} > "
                                     f"{COL_RTOL}")
            if not torch.equal(got, ge.factor_tail_stats(*args, schedule=sched)):
                raise AssertionError(f"k3wide {label} K={k} {name}: two runs differ in bits")
            del got
            torch.cuda.empty_cache()
            turns = [cuda_ms(lambda: ge.factor_tail_stats(*args, schedule=sched),
                             reps=K3_TURN_REPS) for _ in range(2)]
            ones = _csr_ones(p)
            bulk = aug[:, : k + 1 + T].contiguous()
            lib = cuda_ms(lambda: torch.sparse.mm(ones, bulk), reps=K3_TURN_REPS)
            del ones, bulk, aug
            torch.cuda.empty_cache()
            r = ge.factor_reckoning(p, k, l2_bytes=ge.device_l2_bytes(p.x.device))
            flops = p.nnz * (3 * k + 1 + T)
            b_ms, b_by = bound(r["table_once"], flops)
            log(f"  k3wide {label} K={k} {name}: n_self {p.n_self} n_other {p.n_other} nnz "
                f"{p.nnz} | pairs {sched.pairs} ({p.nnz / max(sched.pairs, 1):.3f} edges a "
                f"pair) | plan {plan} | kernel {turns[0]:.4f} {turns[1]:.4f} ms | "
                f"torch.sparse.mm {lib:.4f} ms | bound {b_ms:.4f} ms ({b_by}, table once) | "
                f"per-edge gather {to_ms(r['per_edge']):.4f}, grouped "
                f"{to_ms(r['grouped']):.4f} ms, CSR rereads {r['csr_rereads'] / 1e9:.3f} GB "
                f"({to_ms(r['csr_rereads']):.4f} ms) | max abs err {abs_err:.3e}, worst "
                f"column {worst:.3e} (tol {COL_RTOL}) | repeat equal in bits")
            tot["ms"] += (turns[0] + turns[1]) / 2
            tot["turns"] = [a + b for a, b in zip(tot["turns"], turns)]
            tot["library_ms"] += lib
            tot["n_bytes"] += r["table_once"]
            tot["n_flops"] += flops
            tot["per_edge"] += r["per_edge"]
            tot["grouped"] += r["grouped"]
            tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
            tot["forms"].append(f"{name} {plan['form']} {plan['chunk']}")
        tot["bound_ms"], tot["bound_by"] = bound(tot["n_bytes"], tot["n_flops"])
        log(f"  k3wide {label} K={k}: per sweep kernel {tot['ms']:.4f} ms (turns "
            f"{tot['turns'][0]:.4f}, {tot['turns'][1]:.4f}) | torch.sparse.mm "
            f"{tot['library_ms']:.4f} ms | bounds: table once {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']}), per-edge gather {to_ms(tot['per_edge']):.4f}, grouped "
            f"{to_ms(tot['grouped']):.4f} | forms {tot['forms']}")
        if label == "bench":
            res["bench"] = tot
        else:
            res.setdefault("xl", {})[k] = tot
    for name, line in sorted(PTXAS.items()):
        if "factor_" in name:
            log(f"  k3wide ptxas {name}: {line}")
    log(f"phase k3wide: ok | bench K={K_HUGE} {res['bench']['ms']:.4f} ms a sweep, XL "
        + ", ".join(f"K={k} {v['ms']:.4f} ms" for k, v in res["xl"].items())
        + f" | {time.perf_counter() - t0:.1f} s")
    return res


K3_PARENT_SAME_KS = (K, K_WIDE, 80, 128)  # the K <= 128 forms: the parent's code
K3_SAME_TOL = 0.03


def phase_k3_parent(gblocked, xl):
    """With ``--parent``: K3 of this tree and of the parent tree on random
    tables, a sweep (both directions) in turns parent, this, this, parent:
    at K3_PARENT_SAME_KS on the bench tail within K3_SAME_TOL of the parent
    (the same code); at K_HUGE on the bench tail and XL_K on the XL CSR
    faster in every turn where the parent's ``factor_plan`` differs from
    this tree's, within K3_SAME_TOL where it is the same.  Outputs equal in
    bits where the plan's form sums in CSR order (the slab form and the
    K <= 128 forms); the group form's largest difference from the parent
    logged."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge

    trees = {"this": ge, "parent": _parent_op("gaussian_edge")}
    cells = ([("bench", k, gblocked) for k in K3_PARENT_SAME_KS + (K_HUGE,)]
             + [("XL", XL_K, xl)])
    for label, k, lay in cells:
        tabs = [(p, _k3_random_table(p.n_other, k, 40 + k)) for p in (lay.by_user, lay.by_item)]

        def sweep(tree):
            return [ge.factor_tail_of(aug, p, k) if tree is ge else
                    tree.factor_tail_stats(aug, p.row_ptr, p.other, p.x, k)
                    for p, aug in tabs]

        notes, plans_same = [], []
        for (p, _), a, b in zip(tabs, sweep(trees["this"]), sweep(trees["parent"])):
            form = "chunked" if k <= ge.FACTOR_NARROW_MAX_K else ge.factor_plan(
                k, p.n_other, p.nnz, ge.factor_schedule(p).pairs)["form"]
            if k > ge.FACTOR_NARROW_MAX_K and hasattr(trees["parent"], "factor_plan"):
                pairs = ge.factor_schedule(p).pairs
                plans_same.append(trees["parent"].factor_plan(k, p.n_other, p.nnz, pairs)
                                  == ge.factor_plan(k, p.n_other, p.nnz, pairs))
            if form == "group":
                scale = b.abs().amax(dim=0).clamp_min(1e-30)
                worst = float(((a - b).abs().amax(dim=0) / scale).max())
                notes.append(f"{form}: worst column difference {worst:.3e}")
            elif not torch.equal(a, b):
                raise AssertionError(f"k3 parent {label} K={k}: the {form} form differs "
                                     "from the parent in bits")
            else:
                notes.append(f"{form}: equal in bits")
            del a, b
        reps = K3_TURN_REPS if k > ge.FACTOR_NARROW_MAX_K else TIMING_REPS
        turns = [cuda_ms(lambda t=t: sweep(trees[t]), reps=reps) for t in K2_AB_TURNS]
        mean = {t: float(np.mean([ms for u, ms in zip(K2_AB_TURNS, turns) if u == t]))
                for t in ("parent", "this")}
        log(f"  k3 parent {label} K={k}: turns "
            + ", ".join(f"{t} {ms:.4f}" for t, ms in zip(K2_AB_TURNS, turns))
            + f" ms a sweep | this / parent {mean['this'] / mean['parent'] - 1:+.2%} | "
            + "; ".join(notes))
        if k in K3_PARENT_SAME_KS or (plans_same and all(plans_same)):
            if not mean["this"] <= (1 + K3_SAME_TOL) * mean["parent"]:
                raise AssertionError(f"k3 parent K={k}: {mean} past {K3_SAME_TOL:.0%}")
        elif max(ms for t, ms in zip(K2_AB_TURNS, turns) if t == "this") >= min(
                ms for t, ms in zip(K2_AB_TURNS, turns) if t == "parent"):
            raise AssertionError(f"k3 parent {label} K={k}: this tree not faster in every "
                                 "turn")
        del tabs
        torch.cuda.empty_cache()
    log(f"phase k3 parent: ok | {PARENT['dir']} | bench K {list(K3_PARENT_SAME_KS)} within "
        f"{K3_SAME_TOL:.0%}, K={K_HUGE} and XL K={XL_K} faster in every turn where the "
        "plans differ, else within it")


# Phase tail parent: K1 (both modes) and K7 (unchanged at every K) equal in
# bits at TAIL_SAME_KS["K1"] and TAIL_DOT_KS; K6, K5 and K8 timed in turns
# at TAIL_SAME_KS + TAIL_TIMED: where this tree's plan is the parent's (K6
# everywhere against a parent that has its ring form; K5 to 159, K8 to 143)
# equal bits within TAIL_SAME_TOL, where it is not (K5's and K8's sum form
# against the parent's register and wide forms) faster in every turn.
TAIL_SAME_KS = {"K1": (K, K_WIDE, 128), "K6": (K, K_WIDE, 127),
                "K5": (K, K_WIDE, 127, 128, 159), "K8": (K, K_WIDE, 127, 128, 143)}
TAIL_DOT_KS = (K_HUGE, 200, 256, 300, 512)
TAIL_RING_KS = (K_HUGE, 200, 255, 256, 300, 511, 512)
TAIL_SUM_KS = (K_HUGE, 200, 255, 256, 300, 511)  # K5's and K8's sum form
# The kernels timed in turns, and the K past their unchanged forms.
TAIL_TIMED = {"K6": TAIL_RING_KS, "K5": TAIL_SUM_KS, "K8": (144,) + TAIL_SUM_KS}
TAIL_SAME_TOL = 0.03


def _tail_ptxas_against_parent():
    theirs: dict = {}
    _ptxas_report(open(str(PARENT["lib"]) + ".log").read(), theirs)
    mine = {n: v for n, v in PTXAS.items() if n.startswith("tail_")}
    prev = {n: v for n, v in theirs.items() if n.startswith("tail_")}
    gone = sorted(set(prev) - set(mine))
    new = sorted(set(mine) - set(prev))
    kept = sorted(set(mine) & set(prev))
    if gone or not all(n.startswith("tail_sum_kernel<") for n in new):
        raise AssertionError(f"tail parent: instances gone {gone}, new {new}")
    differ = [n for n in kept if mine[n] != prev[n]]
    if differ:
        raise AssertionError(f"tail parent: ptxas differs from the parent's for {differ}")
    log(f"  tail parent: {len(kept)} kept row-group instances' ptxas lines equal the "
        f"parent's; gone {gone}; new {new}")


TAIL_UNCHANGED = ("K1", "K1raw", "K7")


def phase_tail_parent(blocked, kids=TAIL_UNCHANGED + ("K8",)):
    """With ``--parent``, on ``blocked``'s tail (random tables, both
    directions a sweep): with K1 among ``kids``, every row-group instance
    this tree keeps has the parent build's ptxas line (none gone; new ones
    only of K5's and K8's sum form, against a parent without it);
    K1 "cavi", K1 raw and K7 (TAIL_UNCHANGED) of both trees are equal in
    bits at TAIL_SAME_KS["K1"] + TAIL_DOT_KS; K8 (the Poisson tail), or K6
    and K5 (the Gaussian layout's tail, after huge timing), of both trees
    timed by CUDA events in turns parent, this, this, parent at
    TAIL_SAME_KS + TAIL_TIMED: equal in bits and within TAIL_SAME_TOL
    wherever this tree's plan (``_tail.launch_plan``) is the parent's; where
    it is not, within COL_RTOL per column of the parent (the sum form equal
    in bits where the parent ran the register form on a pass without
    windows) and faster in every turn.
    Returns {kid: {k: (this tree's mean ms, the parent's)}} of the timed
    kernels."""
    import torch

    from pmf_tpu_torch.ops._tail import SUM_KERNELS, launch_plan, tail_windows

    if "K1" in kids:
        _tail_ptxas_against_parent()
    trees = {"this": None, "parent": tuple(_parent_op(n) for n in
                                           ("cavi_edge", "ext_edge", "gaussian_edge"))}
    parent_plan = _parent_op("_tail").launch_plan
    dirs = (blocked.by_user, blocked.by_item)
    timed = {}
    for kid in kids:
        ks = TAIL_SAME_KS[kid] + TAIL_TIMED[kid] if kid in TAIL_TIMED else \
            TAIL_SAME_KS["K1"] + TAIL_DOT_KS
        for k in ks:
            tabs = [_tail_tabs(kid, p.n_self, p.n_other, k, 70 + k + j)
                    for j, p in enumerate(dirs)]

            def sweep(tree, tabs=tabs, k=k):
                return [_tail_kernel(kid, t, p, k, trees[tree]) for t, p in zip(tabs, dirs)]

            new = launch_plan(k, kid) != parent_plan(k, kid)  # a form the parent lacks
            # This tree keeps the parent's float order in every plan but the
            # new forms, and in the sum form where the parent ran the register
            # form (K <= 255) on a direction that walks no windows.
            windows = [tail_windows(p, k, kid) if kid in SUM_KERNELS else None for p in dirs]
            kept = [not new or (kid in SUM_KERNELS and k <= 255 and w is None)
                    for w in windows]
            pairs = list(zip(sweep("this"), sweep("parent")))
            equal = [torch.equal(a, b) for a, b in pairs]
            if not all(e or not keep for e, keep in zip(equal, kept)):
                raise AssertionError(f"tail parent {kid} K={k}: the trees differ in bits "
                                     f"(user, item: {equal})")
            if all(equal):
                note = "equal in bits"
            else:
                col = max(column_check(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1))[1]
                          for a, b in pairs)
                if not col <= COL_RTOL:
                    raise AssertionError(f"tail parent {kid} K={k}: column difference {col}")
                note = (f"equal in bits (user, item) {equal}, windows "
                        f"{[1 if w is None else w.n for w in windows]}, largest column "
                        f"difference {col:.3e}")
            del pairs
            if kid in TAIL_TIMED:
                reps = TIMING_REPS if k <= 128 else 3
                turns = [cuda_ms(lambda t=t: sweep(t), reps=reps) for t in K2_AB_TURNS]
                by = {t: [ms for u, ms in zip(K2_AB_TURNS, turns) if u == t]
                      for t in ("parent", "this")}
                mean = {t: float(np.mean(v)) for t, v in by.items()}
                timed.setdefault(kid, {})[k] = (mean["this"], mean["parent"])
                note = ("turns " + ", ".join(f"{t} {ms:.4f}" for t, ms in zip(K2_AB_TURNS, turns))
                        + f" ms a sweep | this / parent {mean['this'] / mean['parent'] - 1:+.2%}"
                        f" | {note}")
                if new and not max(by["this"]) < min(by["parent"]):
                    raise AssertionError(f"tail parent {kid} K={k}: the new form is not "
                                         f"faster in every turn: {note}")
                if not new and not mean["this"] <= (1 + TAIL_SAME_TOL) * mean["parent"]:
                    raise AssertionError(f"tail parent {kid} K={k}: {mean} past "
                                         f"{TAIL_SAME_TOL:.0%}")
            log(f"  tail parent {kid} K={k} ({tail_trace(kid, k)}): {note}")
            del tabs
            torch.cuda.empty_cache()
    log(f"phase tail parent ({', '.join(kids)}): ok | {PARENT['dir']} | "
        + "; ".join(f"{kid} at {list(TAIL_SAME_KS[kid])} equal in bits and within "
                    f"{TAIL_SAME_TOL:.0%}, at {list(TAIL_TIMED[kid])} in turns "
                    f"{', '.join(K2_AB_TURNS)}" if kid in TAIL_TIMED else
                    f"{kid} equal in bits at {list(TAIL_SAME_KS['K1'] + TAIL_DOT_KS)}"
                    for kid in kids))
    return timed


K4_WIDE_KS = (80, 128, K_HUGE)  # K4's CTA form timed on 162k + 59k matrices
K4_ITEM_KS = (200, 239)  # and on 59k (phase k4wide)
# The panel form, on the K = 256 fit's 6,040 + 3,706 matrices.
K4_XL_KS = (240, 256, 300, 384, 512)
K4_PARENT_KS = (K_WIDE, 80, K_HUGE, 239)  # phase k4 parent, in turns, a sweep
K4_PARENT_XL_KS = (240, 256, 300, 384)  # and on the XL sides
K4_SAME_TOL = 0.03
K4_CHECK_MATS = 67  # matrices a check beside each boundary of the CTA form
K4_CHUNK = 16_384  # matrices a K4 comparison takes at once (no R x K x K temporaries)


def _k4_sides(k):
    """(matrices, seed) of K4's launches a sweep timed at ``k``: the user
    and item sides to K_HUGE, the item side alone past it; the K = 256
    fit's two sides at K4_XL_KS."""
    if k in K4_XL_KS:
        return (XL_USERS, 3), (XL_ITEMS, 4)
    return ((N_USERS, 1), (N_ITEMS, 2)) if k <= K_HUGE else ((N_ITEMS, 2),)


def _k4_form_note(k):
    from pmf_tpu_torch.ops.gj_inverse import cta_plan, form, panel_plan

    if form(k) == "cta":
        p = cta_plan(k)
        return (f"tile {p['tile']}, {p['reg_rows']} rows in registers, "
                f"{p['ctas_per_sm']} CTAs an SM")
    if form(k) == "panel":
        p = panel_plan(k)
        return (f"panel b = {p['b']}, {p['ctas_per_sm']} CTAs an SM, "
                f"{p['smem_bytes']} B shared, strips in global memory {p['global_panels']}")
    return "rows"


def _once_ms(fn) -> float:
    """Device time of one call of ``fn`` (CUDA events), no warm-up."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_k4wide():
    """K4's CTA and panel forms: against the plain version and float64 inv,
    per matrix, on K4_CHECK_MATS matrices at K - 1 and K of every
    ``boundary_ks`` value from 65 (the CTA and panel forms), every
    ``panel_boundary_ks`` value to 600 (each change of the panel plan) and
    at 239, a second launch equal in bits; every K4 instance's ptxas line;
    then device time (CUDA events) of a sweep's launches (``_k4_sides``) at
    K4_WIDE_KS, K4_ITEM_KS and K4_XL_KS beside one ``torch.linalg.inv``
    call on each side's batch (warmed on 256 of its matrices) and
    ``_k4_bounds``, K4 faster than the library at K4_XL_KS.  Returns {k:
    {ms, library_ms, bound_ms, bound_by, n}}."""
    import torch

    from pmf_tpu_torch.ops.gj_inverse import (
        batched_psd_inverse_gj, batched_psd_inverse_gj_plain, boundary_ks, form,
        panel_boundary_ks)

    t0 = time.perf_counter()
    worst = {}
    for k in sorted(_beside(boundary_ks(), lo=65) | _beside(panel_boundary_ks(600))
                    | {239}):
        P = _spd(K4_CHECK_MATS, k, 70 + k)
        got = batched_psd_inverse_gj(P)
        if not torch.equal(got, batched_psd_inverse_gj(P)):
            raise AssertionError(f"k4wide K={k}: two launches differ in bits")
        ref = batched_psd_inverse_gj_plain(P)
        ref64 = torch.linalg.inv(P.double())
        scale = ref64.abs().amax(dim=(1, 2))
        worst[k] = max(float(((got - ref).abs().amax(dim=(1, 2)) / scale).max()),
                       float(((got.double() - ref64).abs().amax(dim=(1, 2)) / scale).max()))
        if not worst[k] <= INV_RTOL:
            raise AssertionError(f"k4wide K={k}: error {worst[k]} > {INV_RTOL}")
    log(f"  k4wide: per-matrix error vs plain and float64 inv (tol {INV_RTOL}), "
        f"{K4_CHECK_MATS} matrices, repeats equal in bits: "
        + ", ".join(f"K={k} {form(k)} {v:.3e}" for k, v in worst.items()))
    for name, line in PTXAS.items():
        if "gj_inverse" in name:
            log(f"  k4wide ptxas {name}: {line}")
    out = {}
    for k in K4_WIDE_KS + K4_ITEM_KS + K4_XL_KS:
        sides = _k4_sides(k)
        ms = lib = 0.0
        for n, seed in sides:
            P = _spd(n, k, seed)
            ms += cuda_ms(lambda: batched_psd_inverse_gj(P), reps=3)
            torch.linalg.inv(P[:256])
            lib += _once_ms(lambda: torch.linalg.inv(P))
            del P
            torch.cuda.empty_cache()
        R = sum(n for n, _ in sides)
        b_bytes, b_ops = _k4_bounds(R, k)
        out[k] = dict(ms=ms, library_ms=lib, bound_ms=max(b_bytes, b_ops),
                      bound_by="bytes" if b_bytes >= b_ops else "operations", n=R)
        log(f"  k4wide K={k}: {' + '.join(str(n) for n, _ in sides)} matrices | kernel "
            f"{ms:.4f} ms a sweep | torch.linalg.inv {lib:.4f} ms | bound: bytes "
            f"{b_bytes:.4f} ms, FP32 {b_ops:.4f} ms ({ms / max(b_bytes, b_ops):.2f}x) | "
            f"{form(k)}: {_k4_form_note(k)}")
        if k in K4_XL_KS and not ms < lib:
            raise AssertionError(f"k4wide K={k}: K4 {ms} ms not faster than "
                                 f"torch.linalg.inv {lib} ms")
    log(f"phase k4wide: ok | K {list(out)} | {time.perf_counter() - t0:.1f} s")
    return out


def phase_k4_parent():
    """With ``--parent`` (a tree whose K4 this one keeps): every K4
    instance's ptxas line (rows, tile and panel forms) equal to the parent
    build's; then K4 of this tree and of the parent tree at K4_PARENT_KS and
    K4_PARENT_XL_KS, on a sweep's matrices (``_k4_sides``), the outputs
    equal in bits, timed a sweep at a time by CUDA events in turns parent,
    this, this, parent, within K4_SAME_TOL of the parent.  Returns {k:
    {turn label: mean ms}}."""
    import torch

    from pmf_tpu_torch.ops import gj_inverse

    theirs: dict = {}
    _ptxas_report(open(str(PARENT["lib"]) + ".log").read(), theirs)
    mine = {n: v for n, v in PTXAS.items() if n.startswith("gj_inverse")}
    prev = {n: v for n, v in theirs.items() if n.startswith("gj_inverse")}
    if not mine or mine != prev:
        raise AssertionError(f"k4 parent: K4's ptxas {mine} vs the parent's {prev}")
    log(f"  k4 parent: the {len(mine)} K4 instances' ptxas lines equal the parent's")
    trees = {"this": gj_inverse, "parent": _parent_op("gj_inverse")}
    out = {}
    for k in K4_PARENT_KS + K4_PARENT_XL_KS:
        turns, same = [0.0] * len(K2_AB_TURNS), True
        for n, seed in _k4_sides(k):
            P = _spd(n, k, seed)
            a, b = (trees[t].batched_psd_inverse_gj(P) for t in ("this", "parent"))
            same = same and torch.equal(a, b)
            del a, b
            reps = TIMING_REPS if k <= K_WIDE else 2
            for j, t in enumerate(K2_AB_TURNS):
                turns[j] += cuda_ms(lambda t=t: trees[t].batched_psd_inverse_gj(P), reps=reps)
            del P
            torch.cuda.empty_cache()
        if not same:
            raise AssertionError(f"k4 parent K={k}: the trees' outputs differ in bits")
        mean = {t: float(np.mean([ms for u, ms in zip(K2_AB_TURNS, turns) if u == t]))
                for t in ("parent", "this")}
        out[k] = mean
        log(f"  k4 parent K={k}: turns "
            + ", ".join(f"{t} {ms:.4f}" for t, ms in zip(K2_AB_TURNS, turns))
            + f" ms a sweep | this / parent {mean['this'] / mean['parent'] - 1:+.2%} | "
            "outputs equal in bits")
        if not mean["this"] <= (1 + K4_SAME_TOL) * mean["parent"]:
            raise AssertionError(f"k4 parent K={k}: {mean} past {K4_SAME_TOL:.0%}")
    log(f"phase k4 parent: ok | {PARENT['dir']} | K {list(K4_PARENT_KS + K4_PARENT_XL_KS)} "
        f"a sweep within {K4_SAME_TOL:.0%} of the parent, in turns {', '.join(K2_AB_TURNS)}")
    return out


# blocked_high's val RMSE against engine flat's, a sweep, at K_WIDE: a sound
# head reads 1.03e-6, a one-bf16-term head (engine blocked_fast) 5.4e-6.
HUGEFIT_FLAT_RTOL = 3e-6


def phase_hugefit(train, val, smi, k=K_HUGE):
    """The wide path at full width: ``HPF(n_factors=k,
    engine="blocked_high").fit`` on the real data for FIT_SWEEPS sweeps
    (K_HUGE, and K_WIDE), the launch counters reset just before and
    read just after (K1 twice a sweep, K2 twice a tier and sweep); finite
    state and a val RMSE that never rises; then one steady sweep timed by
    CUDA events and traced: busy ms split into K2, K1 and the rest.  At
    K_WIDE the model itself lets the val RMSE rise on the fourth sweep
    (about 1e-5 relative; engine "flat", which runs no K2, does the same),
    so there the history is held sweep by sweep to a flat fit's within
    HUGEFIT_FLAT_RTOL, and a rise passes only where the flat fit rises at
    the same sweep; a blocked_fast fit's gap to the flat one is logged
    beside that limit.  Returns {"hpf_k<k>": (the sweep's work count, busy ms)}
    for phase roofline."""
    import torch

    from pmf_tpu_torch.models.hpf import HPF, HPFConfig, state_to_numpy, sweep_blocked

    model = HPF(HPFConfig(n_factors=k, max_iter=FIT_SWEEPS, tol=None,
                          verbose=False, engine="blocked_high"))
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kid: c.count for kid, c in counters.items()}
    n_tiers = len(model.blocked.head or ())
    for rec in model.fit_history:
        log(f"  K={k} sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | "
            f"{rec['updates_per_sec'] / 1e6:.1f}M updates/s | val RMSE "
            f"{rec['val_rmse']:.6f} | {smi}")
    want = dict.fromkeys(launches, 0)
    want.update(K1=2 * model.n_sweeps, K2=2 * n_tiers * model.n_sweeps)
    if launches != want or n_tiers == 0:
        raise AssertionError(f"hugefit launches {launches}, expected {want}")
    for name, v in state_to_numpy(model.state).items():
        if (v.ndim == 2 and v.shape[1] != k) or not np.all(np.isfinite(v)):
            raise AssertionError(f"hugefit state {name}: shape {v.shape} or not finite")
    rmses = [rec["val_rmse"] for rec in model.fit_history]
    if len(rmses) != FIT_SWEEPS or not np.all(np.isfinite(rmses)):
        raise AssertionError(f"hugefit val RMSE history {rmses}")
    rises = [b > a for a, b in zip(rmses, rmses[1:])]
    if k == K_WIDE:
        flat = HPF(HPFConfig(n_factors=k, max_iter=FIT_SWEEPS, tol=None, verbose=False,
                             engine="flat"))
        flat.fit(train, val)
        f_rmses = [rec["val_rmse"] for rec in flat.fit_history]
        del flat
        gap = max(abs(a - b) / b for a, b in zip(rmses, f_rmses))
        if not gap <= HUGEFIT_FLAT_RTOL:
            raise AssertionError(f"hugefit K={k}: val RMSE {rmses} against engine flat's "
                                 f"{f_rmses}: {gap} > {HUGEFIT_FLAT_RTOL}")
        rises = [r and not b > a for r, a, b in zip(rises, f_rmses, f_rmses[1:])]
        # How far a head that differs from the exact one moves this check:
        # engine blocked_fast (K2 at one bf16 term a product), logged only.
        fast = HPF(HPFConfig(n_factors=k, max_iter=FIT_SWEEPS, tol=None, verbose=False,
                             engine="blocked_fast"))
        fast.fit(train, val)
        fast_gap = max(abs(a["val_rmse"] - b) / b for a, b in zip(fast.fit_history, f_rmses))
        del fast
        log(f"  K={k} engine flat (no K2): val RMSE {f_rmses} | worst relative gap "
            f"{gap:.3e} (tol {HUGEFIT_FLAT_RTOL}) | engine blocked_fast's {fast_gap:.3e}")
    if any(rises):
        raise AssertionError(f"hugefit val RMSE rose: {rmses}")

    cfg = model.config
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    user_counts, item_counts = (
        torch.bincount(torch.from_numpy(ids).cuda(), minlength=n).float()
        for ids, n in ((train[0], N_USERS), (train[1], N_ITEMS)))
    state = dict(model.state)

    def one_sweep():
        nonlocal state
        state = sweep_blocked(state, model.blocked, user_counts, item_counts, *hyper)

    ms = cuda_ms(one_sweep, reps=2)
    k1 = tail_trace("K1", k)
    rows, busy, wall_ms = profile_once(one_sweep, {k1: 2, "head_pass_kernel": 2 * n_tiers})
    groups, _ = trace_parts(rows, {"K2 head kernels": K2_KERNELS, f"K1 {k1}": (k1,)})
    log(f"phase hugefit: ok | K={k}, {model.n_sweeps} sweeps in {wall:.1f}s wall "
        f"(layout build included) | launches {launches} | val RMSE {rmses} | steady "
        f"sweep {ms:.4f} ms (CUDA events) | one sweep traced: busy {busy:.4f} ms of "
        f"{wall_ms:.4f} ms (idle share {1 - busy / wall_ms:.1%}) | {smi}")
    log_parts(groups, busy)
    for dev_ms, n, key in rows[:6]:
        log(f"  {dev_ms:9.4f} ms  {n:3d}x  {key[:90]}")
    traffic = roofline.hpf_blocked_traffic(model.blocked, k)
    del model, state
    return {f"hpf_k{k}": (traffic, busy)}


def phase_exthugefit(train, val, smi, k=K_HUGE):
    """The extended Poisson path at full width: ``PoissonMF(n_factors=k,
    extended=True, engine="blocked_high").fit`` on phase fit's data for
    FIT_SWEEPS sweeps, the launch counters reset just before and read just
    after (K7 and K8 twice a sweep, K2 twice a tier and sweep); finite
    state of the right shapes, a val RMSE that never rises (where it rises,
    held sweep by sweep to an engine-flat fit's within HUGEFIT_FLAT_RTOL,
    and a rise passes only where the flat fit rises at the same sweep);
    the peak device memory of the fit; then one steady sweep timed by CUDA
    events and one traced for its parts' shares (fault F2: a trace can
    lose records, so the sweep's time is the events').  Returns the fit's
    launches, the sweep's event ms, K7's traced ms and the sweep's work
    count (``traffic``, for phase roofline as ext_k<k>)."""
    import torch

    from pmf_tpu_torch.models.poisson_mf import PoissonMF, PoissonMFConfig, state_to_numpy

    def fit(engine):
        return PoissonMF(PoissonMFConfig(n_factors=k, max_iter=FIT_SWEEPS, tol=None,
                                         verbose=False, engine=engine, extended=True))

    gc_cuda()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = fit("blocked_high")
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {kid: c.count for kid, c in counters.items()}
    n_tiers = len(model.blocked.head or ())
    for rec in model.fit_history:
        log(f"  extended K={k} sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | "
            f"{rec['updates_per_sec'] / 1e6:.1f}M updates/s | val RMSE "
            f"{rec['val_rmse']:.6f} | {smi}")
    n = model.n_sweeps
    want = dict.fromkeys(launches, 0)
    want.update(K7=2 * n, K8=2 * n, K2=2 * n_tiers * n)
    if launches != want or n_tiers == 0:
        raise AssertionError(f"exthugefit launches {launches}, expected {want}")
    shapes = {"a_theta": (N_USERS, k), "b_theta": (N_USERS, k), "a_beta": (N_ITEMS, k),
              "b_beta": (N_ITEMS, k), "a_phi": (N_USERS,), "b_phi": (N_USERS,),
              "a_psi": (N_ITEMS,), "b_psi": (N_ITEMS,)}
    state = state_to_numpy(model.state)
    if {key: v.shape for key, v in state.items()} != shapes or not all(
            np.all(np.isfinite(v)) for v in state.values()):
        raise AssertionError("exthugefit: state shapes or values "
                             f"{ {key: v.shape for key, v in state.items()} }")
    del state
    rmses = [rec["val_rmse"] for rec in model.fit_history]
    if len(rmses) != FIT_SWEEPS or not np.all(np.isfinite(rmses)):
        raise AssertionError(f"exthugefit val RMSE history {rmses}")
    rises = [b > a for a, b in zip(rmses, rmses[1:])]
    if any(rises):
        flat = fit("flat")
        flat.fit(train, val)
        f_rmses = [rec["val_rmse"] for rec in flat.fit_history]
        del flat
        gap = max(abs(a - b) / b for a, b in zip(rmses, f_rmses))
        log(f"  extended K={k}: val RMSE rose {rmses}; engine flat (no K2, K7, K8) "
            f"{f_rmses}, worst relative gap {gap:.3e} (tol {HUGEFIT_FLAT_RTOL})")
        if not gap <= HUGEFIT_FLAT_RTOL:
            raise AssertionError(f"exthugefit: val RMSE {rmses} against engine flat's "
                                 f"{f_rmses}: {gap} > {HUGEFIT_FLAT_RTOL}")
        rises = [r and not b > a for r, a, b in zip(rises, f_rmses, f_rmses[1:])]
    if any(rises):
        raise AssertionError(f"exthugefit val RMSE rose: {rmses}")

    step = _poisson_sweep_fn(model.config, model.blocked, train, N_USERS, N_ITEMS, "cuda")
    box = [dict(model.state)]

    def one_sweep():
        box[0] = step(box[0])

    ms = cuda_ms(one_sweep, reps=2)
    k7, k8 = tail_trace("K7", k), tail_trace("K8", k)
    rows, busy, wall_ms = profile_once(
        one_sweep, {k7: 2, k8: 2, "head_pass_kernel": 2 * n_tiers})
    groups, gemm_n = trace_parts(rows, {"K2 head kernels": K2_KERNELS, f"K7 {k7}": (k7,),
                                        f"K8 {k8}": (k8,)})
    k7_ms, k8_ms = groups[f"K7 {k7}"], groups[f"K8 {k8}"]
    log(f"phase exthugefit: ok | K={k}, {n} sweeps in {wall:.1f}s wall (layout build "
        f"included) | launches {launches} | val RMSE {rmses} | peak {peak / 1e9:.3f} GB "
        f"({(peak - held) / 1e9:.3f} GB above the {held / 1e9:.3f} GB held before) | steady "
        f"sweep {ms:.4f} ms (CUDA events) | one sweep traced: busy {busy:.4f} ms of "
        f"{wall_ms:.4f} ms (idle share {1 - busy / wall_ms:.1%}), K7 {k7_ms:.4f} ms "
        f"({k7_ms / busy:.1%} of the traced busy), K8 ({k8}) {k8_ms:.4f} ms "
        f"({k8_ms / busy:.1%} of the traced busy, {k8_ms / ms:.1%} of the events' sweep), "
        f"head-product launches {gemm_n} | {smi}")
    log_parts(groups, busy)
    for dev_ms, cnt, key in rows[:8]:
        log(f"  {dev_ms:9.4f} ms  {cnt:3d}x  {key[:90]}")
    traffic = roofline.poisson_ext_blocked_traffic(model.blocked, k)
    del model, box
    return dict(launches=launches, sweep_ms=ms, k7_ms=k7_ms, k8_ms=k8_ms, traffic=traffic)


def phase_wide_gauss(blocked):
    """Device time at K_WIDE factors of K3 (exact, with its byte
    reckonings), K5, K6 on the real Gaussian tail (with their bounds,
    reckoned as phase huge timing's) and K4 on 162k + 59k matrices (beside
    torch.linalg.inv, with its bounds), by CUDA events; and K4 at K = 128
    on 59k matrices.  Returns ({kid: ms}, torch.linalg.inv's ms at
    K_WIDE)."""
    import torch

    k = K_WIDE
    ms = dict.fromkeys(("K3", "K5", "K6", "K4"), 0.0)
    k3 = phase_k3(blocked, k, f"bigk timing K3 (K={k})", check=False)
    ms["K3"] = k3["ms"]
    n_bytes, n_flops = dict.fromkeys(GAUSS_TAIL, 0.0), dict.fromkeys(GAUSS_TAIL, 0.0)
    for _, p, (m_s, _, b_s, _), (m_o, _, b_o, v_o) in _new_space_gauss(blocked, k):
        csr = p.row_ptr.nbytes + p.other.nbytes + p.x.nbytes
        reckoning = {"K5": (m_o.nbytes + b_o.nbytes + csr + 4 * (k + 2) * p.n_self, k + 2),
                     "K6": (m_s.nbytes + b_s.nbytes + m_o.nbytes + b_o.nbytes + v_o.nbytes
                            + csr + 4 * 3 * k * p.n_self, 7 * k + 2)}
        for kid in GAUSS_TAIL:
            tabs = _gauss_tail_tabs(kid, m_s, b_s, m_o, v_o, b_o)
            ms[kid] += cuda_ms(lambda: _tail_kernel(kid, tabs, p, k))
            n_bytes[kid] += reckoning[kid][0]
            n_flops[kid] += p.nnz * reckoning[kid][1]
    P = _spd(N_ITEMS, 128, 3)
    _k4_check(P, f"K=128, {N_ITEMS} matrices", 128, check_plain=False)
    del P
    k4 = dict(library_ms=0.0, n=0)
    for n, seed in ((N_USERS, 1), (N_ITEMS, 2)):
        P = _spd(n, k, seed)
        r = _k4_check(P, f"K={k}, {n} matrices", k, check_plain=False)
        ms["K4"] += r["ms"]
        k4["library_ms"] += r["library_ms"]
        k4["n"] += n
        del P
    torch.cuda.empty_cache()
    b_bytes, b_ops = _k4_bounds(k4["n"], k)
    tail_bounds = {kid: bound(n_bytes[kid], n_flops[kid]) for kid in GAUSS_TAIL}
    log(f"phase bigk timing (Gaussian, real data, K={k}): ok | per sweep "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
        + " | " + ", ".join(f"{kid} bound {b:.4f} ms ({by})"
                            for kid, (b, by) in tail_bounds.items())
        + f" | K4 beside torch.linalg.inv {k4['library_ms']:.4f} ms, bound: bytes {b_bytes:.4f} ms, "
        f"FP32 {b_ops:.4f} ms")
    return ms, k4["library_ms"]


def phase_small(k=K, sweeps=3):
    """``sweeps`` blocked sweeps on the card vs the host on one small
    input, at ``k`` factors."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.coo import build_ratings
    from pmf_tpu_torch.data.synthetic import synth_ratings
    from pmf_tpu_torch.models import hpf

    u, i, x = synth_ratings(3000, 1500, 120_000, seed=5)
    x = x + 1.0
    cfg = hpf.HPFConfig(n_factors=k)
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    head = [(0, 256, 1500), (256, 768, 300)]
    states = {}
    for dev in ("cpu", "cuda"):
        blocked = build_blocked(u, i, x, reorder=True, head=head, head_r0=256,
                                device=dev)
        flat = build_ratings(u, i, x, device=dev)
        s = hpf.init_state(flat.n_users, flat.n_items, cfg, device=dev)
        for _ in range(sweeps):
            s = hpf.sweep_blocked(s, blocked, flat.user_counts, flat.item_counts,
                                  *hyper)
        states[dev] = hpf.state_to_numpy(s)
    worst = 0.0
    for key, ref in states["cpu"].items():
        got = states["cuda"][key]
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"small: {key} shape {got.shape} or not finite")
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-5, err_msg=key)
        worst = max(worst, float(np.max(np.abs(got - ref) / np.abs(ref))))
    torch.cuda.synchronize()
    log(f"phase small (K={k}): ok | {sweeps} sweeps card vs host, max rel diff {worst:.3e} "
        f"(tol 5e-4)")


def phase_fit(train, val, smi):
    import torch

    from pmf_tpu_torch.models.hpf import HPF, HPFConfig, state_to_numpy

    model = HPF(HPFConfig(n_factors=K, max_iter=FIT_SWEEPS, tol=None,
                          verbose=False, engine="blocked_high"))
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    n_tiers = len(model.blocked.head or ())
    for rec in model.fit_history:
        log(f"  sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | "
            f"{rec['updates_per_sec'] / 1e6:.1f}M updates/s | val RMSE "
            f"{rec['val_rmse']:.6f} | {smi}")
    want = dict.fromkeys(launches, 0)
    want.update(K1=2 * model.n_sweeps, K2=2 * n_tiers * model.n_sweeps)
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


K2_KERNELS = ("head_user_kernel", "head_item_kernel", "head_pass_kernel",
              "sum_partials_kernel", "split_planes_kernel")
# The row-group kernels in a trace: tail_<form>_kernel<mode, ...>, mode 0
# (K1 "cavi"), 1 (K1 "raw"), 2 (K7), 3 (K5), 4 (K6) or 5 (K8), the form
# their plan takes at K (``_tail.launch_plan``: "group", "dot" for K1
# "cavi" and K7 past 32 words a row, "sum" for K5 and K8 there, "wide").
TAIL_MODES = {"K1": 0, "K1raw": 1, "K7": 2, "K5": 3, "K6": 4, "K8": 5}


def tail_trace(kid, k=K):
    """The name piece of the row-group kernel ``kid`` launches at ``k``."""
    from pmf_tpu_torch.ops._tail import launch_plan

    form = launch_plan(k, kid)["form"]
    if form == "ring":  # K6's alone: no mode among its template arguments
        return "tail_ring_kernel<"
    return f"tail_{form}_kernel<{TAIL_MODES[kid]}" + (">" if form == "wide" else ",")


# At K = 20 (the phases on the bench's widths).
K1_TRACE, K7_TRACE = tail_trace("K1"), tail_trace("K7")
K5_TRACE, K6_TRACE, K8_TRACE = tail_trace("K5"), tail_trace("K6"), tail_trace("K8")
GEMM_PARTS = ("gemm", "cutlass", "sm90_xmma", "nvjet")


def trace_parts(rows, parts):
    """Device ms of a trace's rows by part: ``parts`` maps a part's label
    to the kernel-name pieces it takes; then "head products (gemm)" (the
    library matmuls) and "other".  Also the matmuls' launches."""
    groups = dict.fromkeys(list(parts) + ["head products (gemm)", "other"], 0.0)
    gemm_launches = 0
    for dev_ms, n, key in rows:
        k = key.lower()
        group = next((g for g, pieces in parts.items()
                      if any(piece.lower() in k for piece in pieces)), None)
        if group is None:
            gemm = any(piece in k for piece in GEMM_PARTS)
            group = "head products (gemm)" if gemm else "other"
            gemm_launches += n if gemm else 0
        groups[group] += dev_ms
    return groups, gemm_launches


def log_parts(groups, busy):
    if busy > 0:
        log("  by part: " + ", ".join(f"{k} {v:.4f} ms ({v / busy:.1%})"
                                       for k, v in groups.items()))


def phase_profile(model, train, smi):
    """Steady sweep time (CUDA events over chained sweeps) and one sweep
    under torch.profiler: device time by kernel, K2's share of it and the
    idle share.  Returns {"hpf": (the sweep's work count, busy ms)} for
    phase roofline."""
    import torch

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
    rows, busy, wall_ms = profile_once(
        one_sweep, {K1_TRACE: 2, **_head_launches(model)})
    k2_ms = sum(ms for ms, _, key in rows if any(name in key for name in K2_KERNELS))
    log(f"phase profile: ok | one sweep: device busy {busy:.4f} ms of "
        f"{wall_ms:.4f} ms window (idle share {1 - busy / wall_ms:.1%}) | K2 "
        f"{k2_ms:.4f} ms ({k2_ms / busy:.1%} of busy)")
    log_parts(trace_parts(rows, {"K2 head kernels": K2_KERNELS,
                                 "K1 tail_group_kernel<0>": (K1_TRACE,)})[0], busy)
    for dev_ms, n, key in rows[:8]:
        log(f"  {dev_ms:9.4f} ms  {n:3d}x  {key[:90]}")
    return {"hpf": (roofline.hpf_blocked_traffic(model.blocked, K), busy)}


# ----------------------------------------------------------------- serving --

SERVE_K, SERVE_BATCH = 10, 1024
ORACLE_USERS, CLI_USERS, SAMPLED_NEGATIVES = 2048, 1000, 100
# Checkpoints and CSVs of the serving and resume phases: a git-ignored
# directory beside this script, removed when each phase ends.
SMOKE_TMP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_tmp")


def _dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e6


def _fresh_dir(name: str) -> str:
    import shutil

    path = os.path.join(SMOKE_TMP, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _oracle_check(served, users, items, scores, row_ptr, items_by_user):
    """Float64 host oracle on ``users``: each user's scores of every item
    with its training items removed.  Top-k items equal wherever the k-th
    and (k+1)-th oracle scores differ by more than 1e-4 relative; sorted
    scores agree to 1e-5 relative.  Returns (max relative score error,
    users whose k-th/(k+1)-th gap was too small to order)."""
    theta, beta = (t.double().cpu().numpy() for t in served._point_estimates())
    worst, close = 0.0, 0
    for s in range(0, len(users), 256):
        block = users[s : s + 256]
        dense = theta[block] @ beta.T
        for row, u in enumerate(block):
            sc = dense[row]
            sc[items_by_user[row_ptr[u] : row_ptr[u + 1]]] = -np.inf
            top = np.argpartition(-sc, SERVE_K + 1)[: SERVE_K + 1]
            top = top[np.argsort(-sc[top], kind="stable")]
            want = sc[top]
            got = scores[s + row]
            err = float(np.max(np.abs(got - want[:SERVE_K]) / np.abs(want[:SERVE_K])))
            if err > 1e-5:
                raise AssertionError(f"serve: user {u} scores {got} vs oracle "
                                     f"{want[:SERVE_K]}")
            worst = max(worst, err)
            gap = (want[SERVE_K - 1] - want[SERVE_K]) / abs(want[SERVE_K - 1])
            if gap > 1e-4:
                if set(items[s + row]) != set(top[:SERVE_K]):
                    raise AssertionError(f"serve: user {u} items {items[s + row]} "
                                         f"vs oracle {top[:SERVE_K]}")
            else:
                close += 1
    return worst, close


def phase_serve(model, train, val, smi):
    """The serving path on phase fit's HPF model: save_model, load_model
    onto the card (equal bits), the exclusion index from the training COO
    against build_exclusion_index, recommend top-10 for every user
    (timed, and once under the profiler) held against a float64 host
    oracle on ORACLE_USERS users and checked on the card for train items,
    ranking_metrics on the held-out pairs, sampled_ranking_metrics with
    100 negatives, and the recommend CLI on CLI_USERS users."""
    import shutil

    import pandas as pd
    import torch

    from pmf_tpu_torch.cli.recommend import main as recommend_cli
    from pmf_tpu_torch.data.coo import build_ratings
    from pmf_tpu_torch.eval.ranking import ranking_metrics, sampled_ranking_metrics
    from pmf_tpu_torch.eval.recommend import build_exclusion_index, exclusion_index_from_coo
    from pmf_tpu_torch.utils.checkpoint import load_model, save_model

    counters = reset_counters()
    ck = _fresh_dir("serve")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_model(model, ck)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_model(ck)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        for k, v in model.state.items():
            got = served.state[k]
            if got.device != v.device or not torch.equal(got, v):
                raise AssertionError(f"serve: loaded {k} differs from the fitted state")
        log(f"  checkpoint: save_model {t_save:.2f} s, load_model {t_load:.2f} s, "
            f"{_dir_mb(ck):.1f} MB | state equal in bits on {served.device}")

        nnz = len(train[0])
        t0 = time.perf_counter()
        coo = build_ratings(*train, n_users=N_USERS, n_items=N_ITEMS, device="cuda")
        row_ptr_coo, items_coo = exclusion_index_from_coo(coo)
        t_coo = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = build_exclusion_index(train[0], train[1], n_users=N_USERS,
                                      n_items=N_ITEMS, device="cuda")
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t0
        row_ptr, items_dev = index
        if not np.array_equal(row_ptr_coo, row_ptr) \
                or not torch.equal(items_coo[:nnz], items_dev):
            raise AssertionError("serve: exclusion index from the COO differs")
        del coo, items_coo
        log(f"  exclusion index: build_exclusion_index {t_index:.2f} s, from the "
            f"training COO (build_ratings included) {t_coo:.2f} s: equal")

        users = np.arange(N_USERS)

        def serve_all():
            return served.recommend(users, k=SERVE_K, batch=SERVE_BATCH,
                                    train_index=index)

        serve_all()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items, scores = serve_all()
        secs = time.perf_counter() - t0
        rows, busy, wall_ms = profile_once(serve_all, {})
        if items.shape != (N_USERS, SERVE_K) or not np.all(np.isfinite(scores)) \
                or items.min() < 0 or items.max() >= N_ITEMS:
            raise AssertionError(f"serve: items {items.shape}, scores finite "
                                 f"{np.all(np.isfinite(scores))}")
        if not np.all(np.diff(scores, axis=1) <= 0):
            raise AssertionError("serve: scores not in descending order")
        log(f"  recommend top-{SERVE_K} for {N_USERS} users at batch {SERVE_BATCH}: "
            f"{secs:.4f} s ({N_USERS / secs:.0f} users/s) | one call traced: device "
            f"busy {busy:.4f} ms of {wall_ms:.4f} ms window (idle share "
            f"{1 - busy / wall_ms:.1%}) | {smi}")
        for dev_ms, n, key in rows[:6]:
            log(f"  {dev_ms:9.4f} ms  {n:4d}x  {key[:90]}")

        rng = np.random.default_rng(2)
        pick = np.sort(rng.choice(N_USERS, size=ORACLE_USERS, replace=False))
        items_by_user = items_dev.cpu().numpy()
        worst, close = _oracle_check(served, pick, items[pick], scores[pick],
                                     row_ptr, items_by_user)
        # Every user, on the card: no recommended item is a training item.
        train_keys = torch.sort(torch.from_numpy(train[0]).cuda() * N_ITEMS
                                + torch.from_numpy(train[1]).cuda()).values
        rec_keys = (torch.from_numpy(users).cuda()[:, None] * N_ITEMS
                    + torch.from_numpy(items).cuda()).reshape(-1)
        at = torch.searchsorted(train_keys, rec_keys).clamp_max(nnz - 1)
        n_seen = int(torch.sum(train_keys[at] == rec_keys))
        del train_keys, rec_keys, at
        if n_seen:
            raise AssertionError(f"serve: {n_seen} recommended items are training items")
        log(f"  oracle (float64, host) on {ORACLE_USERS} users: scores within "
            f"{worst:.2e} relative (tol 1e-5), items equal where the 10th/11th gap "
            f"> 1e-4 ({ORACLE_USERS - close} users; {close} closer) | no training "
            f"item among the {N_USERS * SERVE_K} recommendations (card check)")

        theta, beta = served._point_estimates()
        t0 = time.perf_counter()
        full = ranking_metrics(theta, beta, train[0], train[1], val[0], val[1])
        t_rank = time.perf_counter() - t0
        t0 = time.perf_counter()
        sampled = sampled_ranking_metrics(theta, beta, train[0], train[1], val[0],
                                          val[1], n_negatives=SAMPLED_NEGATIVES)
        t_sampled = time.perf_counter() - t0
        for name, out in (("ranking_metrics", full), ("sampled", sampled)):
            vals = [v for k, v in out.items() if "@" in k]
            if out["n_pairs"] != len(val[0]) or not out["mean_rank"] >= 1.0 \
                    or not all(0.0 <= v <= 1.0 for v in vals):
                raise AssertionError(f"serve: {name} {out}")
        log(f"  ranking_metrics on {len(val[0])} held-out pairs: {t_rank:.2f} s | "
            + ", ".join(f"{k} {v:.6g}" for k, v in full.items() if k != "n_pairs"))
        log(f"  sampled_ranking_metrics ({SAMPLED_NEGATIVES} negatives): "
            f"{t_sampled:.2f} s | "
            + ", ".join(f"{k} {v:.6g}" for k, v in sampled.items()
                        if k not in ("n_pairs", "n_negatives")))

        cli_users = np.arange(CLI_USERS) * (N_USERS // CLI_USERS) + 1
        mine = np.isin(train[0], cli_users)
        csv_in, csv_out = os.path.join(ck, "train.csv"), os.path.join(ck, "rec.csv")
        pd.DataFrame({"u": train[0][mine], "i": train[1][mine],
                      "rating": train[2][mine]}).to_csv(csv_in, index=False)
        t0 = time.perf_counter()
        recommend_cli(["--checkpoint", ck, "--users", *map(str, cli_users), "--k",
                       str(SERVE_K), "--train", csv_in, "--out", csv_out])
        t_cli = time.perf_counter() - t0
        got = pd.read_csv(csv_out)
        want_items, want_scores = served.recommend(
            cli_users, k=SERVE_K, train=(train[0][mine], train[1][mine], train[2][mine]))
        if not (np.array_equal(got["u"], np.repeat(cli_users, SERVE_K))
                and np.array_equal(got["i"], want_items.reshape(-1))
                and np.allclose(got["score"], want_scores.reshape(-1), rtol=1e-6,
                                atol=0)):
            raise AssertionError("serve: the CLI's CSV differs from recommend's")
        log(f"  CLI: {CLI_USERS} users from the saved checkpoint, "
            f"{int(mine.sum())} training rows: {t_cli:.2f} s, CSV equal to recommend's")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    # Serving runs none of the port's kernels: every counter stays 0.
    launches = {k: c.count for k, c in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"serve: kernel launches {launches}, expected none")
    log(f"phase serve: ok | save {t_save:.2f} s / load {t_load:.2f} s | "
        f"recommend {N_USERS / secs:.0f} users/s | ranking {t_rank:.2f} s, sampled "
        f"{t_sampled:.2f} s | recall@10 {full['recall@10']:.6g}, hr@10 "
        f"{sampled['hr@10']:.6g}")


def _check_equal_states(label, got: dict, want: dict):
    import torch

    for k, v in want.items():
        if not torch.equal(got[k], v):
            diff = float((got[k].double() - v.double()).abs().max())
            raise AssertionError(f"{label}: {k} differs from the unbroken fit "
                                 f"(max abs {diff:.3e})")


def _save_load_times(state: dict, name: str):
    """(save s, load s, MB) of ``state`` through utils.checkpoint."""
    import torch

    from pmf_tpu_torch.utils.checkpoint import load_state, save_state

    path = _fresh_dir(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_state(path, state)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = load_state(path)
    on_card = {k: torch.from_numpy(v).cuda() for k, v in back.items()}
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    del on_card
    return t_save, t_load, _dir_mb(path)


def phase_resume(model, train, val, smi):
    """HPF.fit for 2 sweeps with checkpoint_every=2, then a fit resumed
    from that checkpoint for FIT_SWEEPS - 2 more: its final state equals
    phase fit's unbroken FIT_SWEEPS-sweep state in bits.  Same data, K
    and engine as phase fit."""
    import shutil

    import torch

    from pmf_tpu_torch.models.hpf import HPF, HPFConfig

    ck = _fresh_dir("resume_hpf")
    try:
        counters = reset_counters()
        t0 = time.perf_counter()
        cfg = dict(n_factors=K, tol=None, verbose=False, engine="blocked_high")
        first = HPF(HPFConfig(max_iter=2, **cfg)).fit(train, val, checkpoint_dir=ck,
                                                      checkpoint_every=2)
        n_first = first.n_sweeps
        del first
        resumed = HPF(HPFConfig(max_iter=FIT_SWEEPS - 2, **cfg)).fit(
            train, val, resume_from=ck)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        n_tiers = len(resumed.blocked.head or ())
        sweeps = n_first + resumed.n_sweeps
        want = dict.fromkeys(launches, 0)
        want.update(K1=2 * sweeps, K2=2 * n_tiers * sweeps)
        if launches != want:
            raise AssertionError(f"resume launches {launches}, expected {want}")
        _check_equal_states("resume (HPF)", resumed.state, model.state)
        t_save, t_load, mb = _save_load_times(model.state, "resume_hpf_times")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(os.path.join(SMOKE_TMP, "resume_hpf_times"), ignore_errors=True)
    log(f"phase resume (HPF): ok | 2 sweeps + checkpoint, then {FIT_SWEEPS - 2} "
        f"resumed = the unbroken {FIT_SWEEPS}-sweep state in bits | {wall:.1f}s wall "
        f"(two fits, layout builds included) | launches {launches} | state save "
        f"{t_save:.2f} s, load to the card {t_load:.2f} s, {mb:.1f} MB | {smi}")


# ----------------------------------------------------------------- Poisson --

PFIT_SWEEPS = 4
PELBO_SWEEPS = 2


def _ext_tables(n_self, n_other, seed):
    """Random positive new-space tables on the card: self rows, refreshed
    self rows, other rows and the other side's scalars."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def pos(*shape):
        return 0.05 + torch.rand(*shape, generator=g, device="cuda")

    return pos(n_self, K), pos(n_self, K), pos(n_other, K), pos(n_other)


def _log_tail_tables(kid, name, p):
    """Log the time of building a pass's self and other tables of K
    columns into new space, padded: gathered by ``*_old_of_new`` into the
    padded rows, and scattered by ``*_new_of_old`` after one padding cat
    (``_tail.tail_tables``)."""
    import torch

    from pmf_tpu_torch.ops._tail import padded_rows, tail_tables

    es, eo = torch.rand(p.n_self, K, device="cuda"), torch.rand(p.n_other, K, device="cuda")
    gathered = (padded_rows(es, p.self_old_of_new), padded_rows(eo, p.other_old_of_new))
    if not all(torch.equal(a, b) for a, b in zip(gathered, tail_tables(es, eo, p))):
        raise AssertionError(f"{kid} {name}: scattered tables differ from gathered ones")
    gather_ms = cuda_ms(lambda: (padded_rows(es, p.self_old_of_new),
                                 padded_rows(eo, p.other_old_of_new)))
    scatter_ms = cuda_ms(lambda: tail_tables(es, eo, p))
    log(f"  {kid} {name} tables of {p.n_self} + {p.n_other} rows into new space: "
        f"gathered {gather_ms:.4f} ms, scattered {scatter_ms:.4f} ms (equal in bits)")


def phase_k7k8(blocked):
    """K7 and K8 vs their plain versions on the real tail, both directions,
    on the [e | s] records the frames build, equal bits on a repeat.
    K8 is linear, so two library forms compute it: the row dot of the
    refreshed rows with K7's second output, and torch.sparse.mm of the
    tail's pattern by s * E_other followed by that row dot."""
    import torch

    from pmf_tpu_torch.ops import ext_edge as ee

    res7 = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, n_bytes=0.0, n_flops=0.0)
    res8 = dict(res7, identity_ms=0.0, sparse_ms=0.0)
    half_ms = 0.0
    for seed, (name, p) in enumerate((("user", blocked.by_user),
                                      ("item", blocked.by_item))):
        es, es_new, eo, so = _ext_tables(p.n_self, p.n_other, 21 + seed)
        rec = ee.es_record(eo, so)
        tabs = {"K7": (es, rec), "K8": (es_new, rec)}
        csr = (p.row_ptr, p.other)
        args7 = (es, rec, *csr, p.x, ee.RATE_FLOOR)
        args8 = (es_new, rec, *csr)
        ref = {"K7": ee.ext_factor_tail_plain(*args7, max_edges=1 << 22),
               "K8": ee.ext_scalar_tail_plain(*args8, max_edges=1 << 22)}
        runs = {kid: (lambda kid=kid: _tail_kernel(kid, tabs[kid], p, K))
                for kid in ("K7", "K8")}
        got = {}
        for kid, run in runs.items():
            got[kid] = run()
            _, rel = compare(got[kid], ref[kid[:2]])
            if not rel <= RTOL:
                raise AssertionError(f"{kid} {name}: relative error {rel} > {RTOL}")
            if not torch.equal(got[kid], run()):
                raise AssertionError(f"{kid} {name}: two launches differ in bits")
        pattern = _csr_ones(p)
        sparse8 = lambda: torch.sum(  # noqa: E731
            es_new * torch.sparse.mm(pattern, so[:, None] * eo), dim=1)
        identity8 = lambda: torch.sum(es_new * got["K7"][:, K:], dim=1)  # noqa: E731
        for label, form in (("identity", identity8), ("sparse.mm", sparse8)):
            _, rel = compare(form(), ref["K8"])
            if not rel <= RTOL:
                raise AssertionError(f"K8 {name}: library form {label} differs "
                                     f"from the plain version by {rel}")
        # the functions' inputs once: the real columns, not the records' padding
        inputs = sum(t.nbytes for t in (eo, so, *csr))
        for kid, res, plain, a, n_bytes, flops in (
                ("K7", res7, ee.ext_factor_tail_plain, args7,
                 inputs + es.nbytes + p.x.nbytes, 6 * K + 1),
                ("K8", res8, ee.ext_scalar_tail_plain, args8,
                 inputs + es_new.nbytes, 2 * K + 1)):
            abs_err, rel_err = compare(got[kid], ref[kid])
            ms = cuda_ms(runs[kid])
            plain_ms = cuda_ms(lambda: plain(*a, max_edges=1 << 22), reps=3)
            n_bytes += got[kid].nbytes
            b_ms, b_by = bound(n_bytes, p.nnz * flops)
            log(f"  {kid} {name}: nnz {p.nnz} | max abs err {abs_err:.3e} rel "
                f"{rel_err:.3e} (tol {RTOL}) | repeat equal in bits | kernel {ms:.4f} ms "
                f"| plain {plain_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
            _tail_notes(kid, name, tabs[kid], p, K, ms, got[kid].nbytes)
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["max_abs_err"] = max(res["max_abs_err"], abs_err)
            res["n_bytes"] += n_bytes
            res["n_flops"] += p.nnz * flops
        _log_tail_tables("K7", name, p)
        ident_ms, sparse_ms = cuda_ms(identity8), cuda_ms(sparse8)
        side_half = cuda_ms(lambda: torch.sparse.mm(pattern, so[:, None] * eo))
        half_ms += side_half
        res8["identity_ms"] += ident_ms
        res8["sparse_ms"] += sparse_ms
        log(f"  K8 {name} library forms: rowsum(E_new * S_wother) {ident_ms:.4f} ms "
            f"(reads K7's output, not the edges) | torch.sparse.mm + row dot "
            f"{sparse_ms:.4f} ms || K7 {name}: its S_wother half alone by "
            f"torch.sparse.mm {side_half:.4f} ms")
    for res in (res7, res8):
        res["bound_ms"], res["bound_by"] = bound(res["n_bytes"], res["n_flops"])
    res7["library_ms"] = None  # a per-edge x / max(<.,.>, floor) inside the sums
    # K8's library time is the call on K8's own inputs; the identity form
    # reads K7's output and stays on its log line.
    res8["library_ms"] = res8["sparse_ms"]
    log(f"phase K7: ok | per sweep: kernel {res7['ms']:.4f} ms, plain "
        f"{res7['plain_ms']:.4f} ms, bound {res7['bound_ms']:.4f} ms "
        f"({res7['bound_by']}), library: none for the allocation half; the "
        f"S_wother half alone by torch.sparse.mm {half_ms:.4f} ms")
    log(f"phase K8: ok | per sweep: kernel {res8['ms']:.4f} ms, plain "
        f"{res8['plain_ms']:.4f} ms, bound {res8['bound_ms']:.4f} ms "
        f"({res8['bound_by']}), library: identity {res8['identity_ms']:.4f} ms, "
        f"sparse.mm {res8['sparse_ms']:.4f} ms")
    return res7, res8


def _poisson_sweep_fn(cfg, blocked, train, n_users, n_items, device,
                      precision="high"):
    """state -> state: one blocked Poisson sweep as ``PoissonMF.fit`` runs
    it, from the training triples, with the head at ``precision``."""
    import torch

    from pmf_tpu_torch.models import poisson_mf as pm

    u, i, x = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in train)
    counts = [torch.bincount(ids, minlength=n).float()
              for ids, n in ((u, n_users), (i, n_items))]
    if not cfg.extended:
        return lambda s: pm.sweep_blocked(s, blocked, *counts, cfg.a0, cfg.b0,
                                          precision=precision)
    sx = [torch.bincount(ids, weights=x.double(), minlength=n).float()
          for ids, n in ((u, n_users), (i, n_items))]
    return lambda s: pm.sweep_blocked_extended(s, blocked, *counts, *sx,
                                               cfg.a0, cfg.b0, precision=precision)


def phase_psmall(k=K, sweeps=3):
    """``sweeps`` (three) blocked Poisson sweeps on the card vs the host (plain
    kernels), plain and extended, on one small input with a two-tier
    head, at the JAX package's blocked-vs-flat gate, at ``k`` factors."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.synthetic import synth_ratings
    from pmf_tpu_torch.models import poisson_mf as pm

    u, i, x = synth_ratings(3000, 1500, 120_000, seed=5)
    n_users, n_items = int(u.max()) + 1, int(i.max()) + 1
    head = [(0, 256, 1500), (256, 768, 300)]
    worst = {}
    for extended in (False, True):
        cfg = pm.PoissonMFConfig(n_factors=k, extended=extended)
        states = {}
        for dev in ("cpu", "cuda"):
            blocked = build_blocked(u, i, x, reorder=True, head=head, head_r0=256,
                                    device=dev)
            step = _poisson_sweep_fn(cfg, blocked, (u, i, x.astype(np.float32)),
                                     n_users, n_items, dev)
            s = pm.init_state(n_users, n_items, cfg, device=dev)
            for _ in range(sweeps):
                s = step(s)
            states[dev] = pm.state_to_numpy(s)
        name = "extended" if extended else "plain"
        if len(states["cuda"]) != (8 if extended else 4):
            raise AssertionError(f"psmall {name}: state keys {sorted(states['cuda'])}")
        w = 0.0
        for key, ref in states["cpu"].items():
            got = states["cuda"][key]
            if got.shape != ref.shape or not np.all(np.isfinite(got)):
                raise AssertionError(f"psmall {name}: {key} shape or not finite")
            np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-5,
                                       err_msg=f"{name} {key}")
            w = max(w, float(np.max(np.abs(got - ref) / np.abs(ref))))
        worst[name] = w
    torch.cuda.synchronize()
    log(f"phase psmall (K={k}): ok | {sweeps} sweeps card vs host (rtol 5e-4, atol 1e-5), max rel "
        "diff: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def _run_pfit(train, val, smi, extended, sweeps, elbo_every=0):
    import torch

    from pmf_tpu_torch.models.poisson_mf import (
        PoissonMF, PoissonMFConfig, state_to_numpy)

    name = "extended" if extended else "plain"
    model = PoissonMF(PoissonMFConfig(n_factors=K, max_iter=sweeps, tol=None,
                                      verbose=False, engine="blocked_high",
                                      extended=extended))
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val, elbo_every=elbo_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    n_tiers = len(model.blocked.head or ())
    for rec in model.fit_history:
        log(f"  {name} sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | "
            f"{rec['updates_per_sec'] / 1e6:.1f}M updates/s | val RMSE "
            f"{rec['val_rmse']:.6f}"
            + (f" | ELBO {rec['elbo']:.6e}" if "elbo" in rec else "") + f" | {smi}")
    n = model.n_sweeps
    want = dict.fromkeys(launches, 0)
    want.update(K2=2 * n_tiers * n)
    want.update({"K7": 2 * n, "K8": 2 * n} if extended else {"K1": 2 * n})
    if launches != want or n_tiers == 0:
        raise AssertionError(f"pfit {name} launches {launches}, expected {want} "
                             f"({n} sweeps, {n_tiers} tiers)")
    state = state_to_numpy(model.state)
    shapes = {"a_theta": (N_USERS, K), "b_theta": (N_USERS, K),
              "a_beta": (N_ITEMS, K), "b_beta": (N_ITEMS, K)}
    if extended:
        shapes.update(a_phi=(N_USERS,), b_phi=(N_USERS,), a_psi=(N_ITEMS,),
                      b_psi=(N_ITEMS,))
    if {k: v.shape for k, v in state.items()} != shapes:
        raise AssertionError(f"pfit {name}: state shapes "
                             f"{ {k: v.shape for k, v in state.items()} }")
    for k, v in state.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"pfit {name} state {k} has non-finite values")
    rmses = [rec["val_rmse"] for rec in model.fit_history]
    if len(rmses) != sweeps or not np.all(np.isfinite(rmses)):
        raise AssertionError(f"pfit {name} val RMSE history {rmses}")
    # The reported val RMSE equals the host's from the returned state.
    host = model.evaluate_rmse(val)
    if not abs(host - rmses[-1]) < 1e-4:
        raise AssertionError(f"pfit {name}: host val RMSE {host} vs {rmses[-1]}")
    return model, launches, rmses, host, wall


def phase_pfit(train, val, smi):
    """PoissonMF.fit(engine="blocked_high") on the Zipf ratings (no shift):
    PFIT_SWEEPS plain (K1 twice and K2 twice per tier a sweep), then
    PFIT_SWEEPS extended (K7, K8 twice and K2 twice per tier a sweep).  The
    plain fit's val RMSE must not rise; the extended fit's history is
    printed and only held finite (the reference's extended fit stalls
    early at this scale)."""
    out = {}
    for extended in (False, True):
        name = "extended" if extended else "plain"
        model, launches, rmses, host, wall = _run_pfit(train, val, smi, extended,
                                                       PFIT_SWEEPS)
        if not extended and not all(b <= a for a, b in zip(rmses, rmses[1:])):
            raise AssertionError(f"pfit plain: val RMSE rose over the sweeps: {rmses}")
        log(f"phase pfit ({name}): ok | {model.n_sweeps} sweeps in {wall:.1f}s wall "
            f"(layout build included) | launches {launches} | val RMSE "
            + " -> ".join(f"{r:.6f}" for r in rmses) + f" (host {host:.6f})")
        out[name] = (model, launches)
    return out


def _scalar_pass_products(model):
    """Matmul launches of one ``ext_scalar_stats`` a side of the fitted
    extended model's state, building its own tables and on the factor
    pass's: {side: (own, on the factor pass's)}."""
    from pmf_tpu_torch.ops import ext_edge as ee

    st, lay = model.state, model.blocked
    e = {k: st["a_" + k] / st["b_" + k] for k in ("theta", "beta", "phi", "psi")}
    out = {}
    for side, p, (E_self, E_other, s_other) in (
            ("user", lay.by_user, (e["theta"], e["beta"], e["psi"])),
            ("item", lay.by_item, (e["beta"], e["theta"], e["phi"]))):
        kw = dict(head=lay.head, head_side=side)
        *_, tables = ee.ext_factor_stats(E_self, E_other, s_other, p, keep_tables=True,
                                         **kw)
        counts = []
        for factor in (None, tables):
            rows, _, _ = profile_once(lambda: ee.ext_scalar_stats(
                E_self, E_other, s_other, p, factor=factor, **kw), {})
            counts.append(trace_parts(rows, {})[1])
        out[side] = tuple(counts)
    return out


def phase_pprofile(models, train, smi):
    """Steady sweep times (CUDA events over chained sweeps) of the plain and
    extended Poisson sweeps; one plain and one extended sweep under
    torch.profiler (busy time, idle share, parts, matmul launches); the
    matmul launches of one scalar pass with and without the factor pass's
    tables.  Returns each sweep's work count and busy ms for phase
    roofline."""
    nnz = len(train[0])
    sweeps = {}
    for name, (model, _) in models.items():
        step = _poisson_sweep_fn(model.config, model.blocked, train, N_USERS,
                                 N_ITEMS, "cuda")
        box = [dict(model.state)]

        def one_sweep(step=step, box=box):
            box[0] = step(box[0])

        sweeps[name] = one_sweep
    steady = {}
    for name, one_sweep in sweeps.items():
        steady[name] = cuda_ms(one_sweep, reps=5)
        visits = 4 if name == "extended" else 2
        log(f"  steady {name} sweep: {steady[name]:.4f} ms | "
            f"{visits * nnz / steady[name] / 1e3:.1f}M updates/s ({visits} x nnz) "
            f"| {smi}")
    heads = _head_launches(models["extended"][0])
    rows, busy, wall_ms = profile_once(sweeps["plain"], {K1_TRACE: 2, **heads})
    out = {"poisson": (roofline.hpf_blocked_traffic(models["plain"][0].blocked, K), busy)}
    log(f"  one plain sweep: device busy {busy:.4f} ms of {wall_ms:.4f} ms window "
        f"(idle share {1 - busy / wall_ms:.1%})")
    log_parts(trace_parts(rows, {"K2 head kernels": K2_KERNELS,
                                 "K1 tail_group_kernel<0>": (K1_TRACE,)})[0], busy)
    rows, busy, wall_ms = profile_once(sweeps["extended"],
                                       {K7_TRACE: 2, K8_TRACE: 2, **heads})
    out["extended"] = (roofline.poisson_ext_blocked_traffic(
        models["extended"][0].blocked, K), busy)
    groups, gemm_n = trace_parts(rows, {"K2 head kernels": K2_KERNELS,
                                        "K7 tail_group_kernel<2>": (K7_TRACE,),
                                        "K8 tail_group_kernel<5>": (K8_TRACE,)})
    log(f"phase pprofile: ok | one extended sweep: device busy {busy:.4f} ms of "
        f"{wall_ms:.4f} ms window (idle share {1 - busy / wall_ms:.1%}) | head-product "
        f"launches {gemm_n}")
    log_parts(groups, busy)
    for dev_ms, n, key in rows[:12]:
        log(f"  {dev_ms:9.4f} ms  {n:3d}x  {key[:90]}")
    scalar = _scalar_pass_products(models["extended"][0])
    own = sum(n for n, _ in scalar.values())
    log("  head-product launches of one scalar pass (building its own tables, on "
        "the factor pass's): "
        + ", ".join(f"{side} {a}, {b}" for side, (a, b) in scalar.items())
        + f" | a sweep: {gemm_n} on the factor pass's tables, {gemm_n + own} "
        "building their own")
    return out


def phase_pelbo(train, val, smi):
    """One plain fit of PELBO_SWEEPS sweeps with elbo_every=1: the ELBO
    values must be finite (their rise per sweep is empirical, not gated)."""
    model, _, _, _, wall = _run_pfit(train, val, smi, False, PELBO_SWEEPS,
                                     elbo_every=1)
    elbos = [rec.get("elbo") for rec in model.fit_history]
    if len(elbos) != PELBO_SWEEPS or None in elbos or not np.all(np.isfinite(elbos)):
        raise AssertionError(f"pelbo: ELBO history {elbos}")
    log(f"phase pelbo: ok | {PELBO_SWEEPS} plain sweeps with elbo_every=1 in "
        f"{wall:.1f}s wall | ELBO " + " -> ".join(f"{e:.6e}" for e in elbos))


# ----------------------------------------------------------------- HPF-MAP --

MAP_BATCH, MAP_MIX, MAP_EPOCHS, MAP_LR = 65536, 8, 3, 0.001
MPROFILE_STEPS = 20


def _longest_run_step(g) -> tuple[int, int]:
    """(step, edges) of the longest run in a grouping (a run's length
    summed onto its first piece)."""
    import torch

    lens = torch.diff(g.piece_ptr)
    run_len = torch.zeros(g.n_pieces, dtype=torch.int64, device=lens.device)
    run_len.index_add_(0, g.piece_first.long(), lens)
    p = int(torch.argmax(run_len))
    step = int(torch.searchsorted(g.step_off.long(),
                                  torch.tensor([p], device=lens.device), right=True)[0]) - 1
    return step, int(run_len[p])


RUN_CLASSES = ((1, 1), (2, 4), (5, 32), (33, 128), (129, 1 << 40))  # edges a run


def _log_run_classes(label, g) -> None:
    """The grouping's runs by length class (RUN_CLASSES), a step on average,
    with their share of the edges; with the runs form (K <= 128) each
    step's long pieces, short runs and the blocks a launch takes."""
    import torch

    from pmf_tpu_torch.ops.map_grad import kernel_of

    lens = torch.diff(g.piece_ptr)
    run_len = torch.zeros(g.n_pieces, dtype=torch.int64, device=lens.device)
    run_len.index_add_(0, g.piece_first.long(), lens)
    run_len = run_len[g.piece_first.long() == torch.arange(g.n_pieces, device=lens.device)]
    parts = []
    for lo, hi in RUN_CLASSES:
        m = (run_len >= lo) & (run_len <= hi)
        parts.append(f"{lo}-{hi if hi < 1 << 40 else 'inf'} edges {int(m.sum()) / g.n_steps:.1f} "
                     f"({int(run_len[m].sum()) / max(int(run_len.sum()), 1):.1%} of edges)")
    note = ""
    if g.short:
        grp = kernel_of(g.scratch.shape[1] - 2)[1]
        blocks = -(-g.step_long // 8) + -(-g.step_short // (8 * (32 // grp)))
        note = (f" | runs form (short <= {g.short}): long pieces a step {g.step_long.mean():.1f} "
                f"(most {g.step_long.max()}), short runs {g.step_short.mean():.1f} (most "
                f"{g.step_short.max()}), blocks a launch {blocks.mean():.1f} (most "
                f"{blocks.max()}) against {-(-g.max_step_pieces // 8)} at one warp a piece "
                f"on the largest step's grid")
    log(f"  {label}: runs a step " + ", ".join(parts) + f" | longest {int(run_len.max())}"
        + note)


def _timed_group(lay, order, mix, k):
    """(groups, seconds): one grouping on the card, host clock around it
    with the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = lay.group(order, mix, k)
    torch.cuda.synchronize()
    return groups, time.perf_counter() - t0


def phase_mdata(train):
    """The blocked MAP engine's segment layout on the HPF ratings, and one
    epoch's grouping by (step, self row): runs, pieces and the grouping's
    time (once with a cold allocator, then a second order)."""
    import torch

    from pmf_tpu_torch.models.hpf_map import build_map_layout
    from pmf_tpu_torch.ops.map_grad import PIECE

    t0 = time.perf_counter()
    lay = build_map_layout(*train, N_USERS, N_ITEMS, MAP_BATCH, mix=MAP_MIX,
                           device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    groups, g_first = _timed_group(lay, rng.permutation(lay.n_segments), MAP_MIX, K)
    order = rng.permutation(lay.n_segments)
    groups, g_secs = _timed_group(lay, order, MAP_MIX, K)
    seg_groups, _ = _timed_group(lay, order, 1, K)  # runs inside one segment
    rows, busy, wall_ms = profile_once(lambda: lay.group(order, MAP_MIX, K), {})
    log(f"  grouping under the profiler: device busy {busy:.4f} ms of {wall_ms:.4f} "
        f"ms | " + " | ".join(f"{ms:.3f} ms {n}x {key[:60]}" for ms, n, key in rows[:6]))
    for name, g, sg in (("by_user", groups[0], seg_groups[0]),
                        ("by_item", groups[1], seg_groups[1])):
        log(f"  {name}: a step holds {g.n_runs / g.n_steps:.0f} row runs "
            f"({lay.nnz / g.n_runs:.1f} edges a run; {sg.n_runs / lay.n_real_segments:.0f} "
            f"a segment) cut into {g.n_pieces / g.n_steps:.0f} pieces of <= {PIECE} "
            f"edges (most in a step {g.max_step_pieces}) | longest run "
            f"{_longest_run_step(g)[1]} edges in a step, {_longest_run_step(sg)[1]} in a "
            f"segment")
        _log_run_classes(f"{name} K={K}", g)
    log(f"phase mdata: ok | {lay.n_segments} segments ({lay.n_real_segments} hold "
        f"ratings) of {MAP_BATCH // MAP_MIX} | {lay.n_segments // MAP_MIX} steps an "
        f"epoch at mix={MAP_MIX} | {lay.nbytes()} bytes on the card | build "
        f"{secs:.1f}s | grouping of an epoch {g_secs * 1e3:.1f} ms (first "
        f"{g_first * 1e3:.1f} ms)")
    if lay.n_real_segments != -(-lay.nnz // (MAP_BATCH // MAP_MIX)):
        raise AssertionError(f"mdata: {lay.n_real_segments} real segments")
    return lay, order, groups, seg_groups, g_secs


def _map_tables(lay, k=K):
    """Softplus'd initial tables in the layout's row space."""
    from pmf_tpu_torch.models import hpf_map as hm

    params = hm.init_params(lay.n_users, lay.n_items, hm.HPFMapConfig(n_factors=k),
                            device="cuda")
    return (hm.softplus(params["user"][lay.u_old_of_new]).contiguous(),
            hm.softplus(params["item"][lay.i_old_of_new]).contiguous())


def _step_coo(lay, seg_ids):
    import torch

    return tuple(torch.cat(c) for c in zip(*(lay.segment(s) for s in seg_ids)))


def _check_map_step(lay, u_sp, i_sp, seg_ids, label, groups=None, step=0):
    """K9 vs map_grad_plain on one step (the step's own grouping, or
    ``step`` of ``groups``): per-column criterion on the signed sums, counts
    exactly, the total nll relatively, and a second launch equal in bits.
    Returns (max abs error, worst column ratio)."""
    import torch

    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops.map_grad import map_grad_grouped, map_grad_plain

    k = u_sp.shape[1] - 1
    if groups is None:
        groups, step = lay.group(seg_ids, len(seg_ids), k), 0
    got_u, got_i = map_grad_grouped(u_sp, i_sp, groups, step, LAMBDA_FLOOR)
    again_u, again_i = map_grad_grouped(u_sp, i_sp, groups, step, LAMBDA_FLOOR)
    ref_u, ref_i = map_grad_plain(u_sp, i_sp, *_step_coo(lay, seg_ids), LAMBDA_FLOOR)
    abs_u, worst_u, ok_u = column_check(got_u, ref_u)
    abs_i, worst_i, ok_i = column_check(got_i, ref_i)
    counts = bool(torch.equal(got_u[:, k], ref_u[:, k])
                  and torch.equal(got_i[:, k], ref_i[:, k]))
    bits = bool(torch.equal(got_u, again_u) and torch.equal(got_i, again_i))
    _, rel_n = compare(got_u[:, k + 1].double().sum(), ref_u[:, k + 1].double().sum())
    n_edges = int(ref_u[:, k].sum())
    log(f"  {label}: {n_edges} edges | worst column max|err|/max|plain| user "
        f"{worst_u:.3e} item {worst_i:.3e} (tol {COL_RTOL}) | counts equal {counts} "
        f"| total nll rel {rel_n:.3e} (tol {RTOL}) | second launch equal in bits "
        f"{bits}")
    if not (ok_u and ok_i and counts and bits and rel_n <= RTOL):
        raise AssertionError(f"{label}: kernel and plain version disagree")
    return max(abs_u, abs_i), max(worst_u, worst_i)


def _map_bound(groups, k, lay=None):
    """K9's bound over every step of ``groups`` in ms: per direction and
    step its edges (8 B), its pieces' list (20 B), each run's self row and
    stored accumulator row, and each other row the step touches (= the
    other direction's runs); the flops of both directions' edges."""
    row = 4 * (k + 1)
    n_bytes = 0.0
    for g, opp, width in ((groups[0], groups[1], k + 2), (groups[1], groups[0], k + 1)):
        n_bytes += (g.other.nbytes + g.x.nbytes + 20 * g.n_pieces
                    + (row + 4 * width) * g.n_runs + row * opp.n_runs)
    n_flops = 2 * int(groups[0].step_edges.sum()) * (4 * k + 6)
    return bound(n_bytes, n_flops) + (n_bytes,)


K9_KERNELS = ("map_grad_runs_kernel", "map_grad_wide_kernel", "map_grad_general_kernel")
K9_PHASE_KS = (K, K_WIDE, 128)  # phase K9: the runs form on real steps, graph replays


def phase_k9(lay, order, groups, seg_groups, group_secs):
    """K9 vs its plain version on real steps of the layout (the first, the
    last and two drawn from a seeded generator, each grouped alone, and the
    epoch grouping's step that holds the longest item run), then one whole
    epoch of its launches timed by CUDA events (the host's enqueue beside
    it) and by the profiler's device sum; then at K9_PHASE_KS (the runs
    form) and K_HUGE an epoch by CUDA graph replays after real steps of
    that grouping against the plain version (five at K = 50 and 128).
    The w * beta and w * theta sums and the per-row nll sums are signed
    and cancel, so they are held per output column; the counts
    exactly; the step's total nll relatively; a second launch in bits."""
    import torch

    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops.map_grad import map_grad_plain

    u_sp, i_sp = _map_tables(lay)
    rng = np.random.default_rng(4)
    n_steps = lay.n_segments // MAP_MIX
    steps = {"first": list(range(MAP_MIX)),
             "last": list(range(lay.n_segments - MAP_MIX, lay.n_segments)),
             "drawn a": rng.choice(lay.n_segments, MAP_MIX, replace=False).tolist(),
             "drawn b": rng.choice(lay.n_segments, MAP_MIX, replace=False).tolist()}
    res = dict(max_abs_err=0.0, library_ms=None)
    for name, seg_ids in steps.items():
        res["max_abs_err"] = max(res["max_abs_err"], _check_map_step(
            lay, u_sp, i_sp, seg_ids, f"K9 step {name} {seg_ids}")[0])
    step, longest = _longest_run_step(groups[1])
    seg_ids = order[step * MAP_MIX : (step + 1) * MAP_MIX].tolist()
    res["max_abs_err"] = max(res["max_abs_err"], _check_map_step(
        lay, u_sp, i_sp, seg_ids, f"K9 epoch step {step} (longest item run, "
        f"{longest} edges)", groups, step)[0])

    epoch_launches = _epoch_launches(u_sp, i_sp, groups)
    t0 = time.perf_counter()
    epoch_launches()
    enqueue_s = time.perf_counter() - t0
    res["ms"] = cuda_ms(epoch_launches, reps=3)
    launches = 2 * int(np.count_nonzero(groups[0].step_edges))
    rows, _, _ = profile_once(epoch_launches, {"map_grad": launches}, attempts=5)
    res["device_ms"] = sum(r[0] for r in rows if any(n in r[2] for n in K9_KERNELS))
    traced = sum(r[1] for r in rows if any(n in r[2] for n in K9_KERNELS))
    if not traced:
        raise AssertionError("phase K9: the profiler traced no K9 launch in 5 traces")
    # The plain version, one step at a time over the same epoch.
    plain_ms = 0.0
    for step in range(n_steps):
        coo = _step_coo(lay, order[step * MAP_MIX : (step + 1) * MAP_MIX])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        map_grad_plain(u_sp, i_sp, *coo, LAMBDA_FLOOR)
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
    res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"], n_bytes = _map_bound(groups, K)
    seg_bound, _, seg_bytes = _map_bound(seg_groups, K)
    res["group_ms"] = group_secs * 1e3
    log(f"phase K9: ok | one epoch: {launches} launches, CUDA events "
        f"{res['ms']:.4f} ms ({res['ms'] / launches * 1e3:.2f} us a launch; the host "
        f"enqueued them in {enqueue_s * 1e3:.1f} ms), profiler device sum "
        f"{res['device_ms']:.4f} ms over {traced} traced launches "
        f"({res['device_ms'] / traced * 1e3:.2f} us a launch) "
        f"| grouping {res['group_ms']:.1f} ms | plain {plain_ms:.4f} ms in {n_steps} "
        f"steps | bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
        f"{n_bytes / 1e9:.3f} GB; on the segments' runs as PR 5 reckoned it "
        f"{seg_bound:.4f} ms, {seg_bytes / 1e9:.3f} GB) | library: none (a nonlinear "
        f"weight inside the sums)")
    res["at"] = {k: _k9_at(lay, order, k, checks=1 if k == K else 5) for k in K9_PHASE_KS}
    res["k50_ms"] = res["at"][K_WIDE]["ms"]
    res["k160"] = _k9_at(lay, order, K_HUGE)
    log("  K9 an epoch by CUDA graph replays: " + ", ".join(
        f"K={k} {r['graph_ms']:.4f} ms (bound {r['bound_ms']:.4f})"
        for k, r in sorted({**res["at"], K_HUGE: res["k160"]}.items())))
    return res


def _epoch_launches(u_sp, i_sp, groups):
    """A call that launches K9 twice for every step of ``groups``, storing
    into accumulators of its own (zeroed once)."""
    import torch

    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops.map_grad import map_grad_pieces

    k = u_sp.shape[1] - 1
    acc_u = torch.zeros((u_sp.shape[0], k + 2), device="cuda")
    acc_i = torch.zeros((i_sp.shape[0], k + 1), device="cuda")

    def launches():
        for s in range(groups[0].n_steps):
            map_grad_pieces(u_sp, i_sp, groups[0], s, LAMBDA_FLOOR, True, acc_u)
            map_grad_pieces(i_sp, u_sp, groups[1], s, LAMBDA_FLOOR, False, acc_i)

    return launches


def _k9_at(lay, order, k, graph=True, checks=1):
    """One epoch of K9 launches at ``k`` factors on the same layout and
    segment order, after real steps of that grouping against the plain
    version (``_check_map_step``: per column, counts exact, a second launch
    equal in bits): the middle one, or with ``checks`` = 5 the first, the
    last, two drawn and the one of the longest item run.  Returns {ms:
    profiler device ms, events_ms: CUDA events ms (the host's enqueue paces
    them), graph_ms: with ``graph``, CUDA events around a replay of the
    epoch's launches captured in a CUDA graph (no host pacing), else None;
    bound_ms, bound_by} (``_map_bound``)."""
    from pmf_tpu_torch.ops.map_grad import kernel_of, piece_of

    u_sp, i_sp = _map_tables(lay, k)
    groups = lay.group(order, MAP_MIX, k)
    n_steps = groups[0].n_steps
    steps = {n_steps // 2: "middle"}
    if checks == 5:
        rng = np.random.default_rng(k)
        longest, edges = _longest_run_step(groups[1])
        steps = {0: "first", n_steps - 1: "last",
                 **{int(s): "drawn" for s in rng.choice(n_steps, 2, replace=False)},
                 longest: f"longest item run, {edges} edges"}
    for step, what in sorted(steps.items()):
        _check_map_step(lay, u_sp, i_sp, order[step * MAP_MIX:(step + 1) * MAP_MIX].tolist(),
                        f"bigk K9 K={k} {kernel_of(k)} real step {step} ({what}; pieces of "
                        f"<= {piece_of(k)})", groups, step)
    epoch = _epoch_launches(u_sp, i_sp, groups)
    ms = cuda_ms(epoch, reps=2)
    g_ms = None
    if graph:
        replay = graph_of(epoch)
        g_ms = graph_ms(replay, reps=3)
        del replay
    rows, _, _ = profile_once(epoch, {"map_grad": 2 * groups[0].n_steps})
    dev = sum(r[0] for r in rows if any(n in r[2] for n in K9_KERNELS))
    b_ms, b_by, _ = _map_bound(groups, k)
    log(f"  bigk K9 K={k} {kernel_of(k)}: one epoch of launches {ms:.4f} ms (CUDA events), "
        f"{dev:.4f} ms (profiler device sum)"
        + (f", {g_ms:.4f} ms (CUDA graph replay)" if graph else "")
        + f" | bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=dev, events_ms=ms, graph_ms=g_ms, bound_ms=b_ms, bound_by=b_by)


def phase_msmall(k=K, epochs=3):
    """``epochs`` (three) blocked and as many flat epochs on the card vs the host (plain
    gradients) on one small input, from the same segment orders and
    permutations, at ``k`` factors."""
    import torch

    from pmf_tpu_torch.data.synthetic import synth_ratings
    from pmf_tpu_torch.models import hpf_map as hm
    from pmf_tpu_torch.ops.adam import adam_init

    u, i, x = synth_ratings(3000, 1500, 120_000, seed=5)
    x = (x + 1.0).astype(np.float32)
    n_users, n_items, nnz = int(u.max()) + 1, int(i.max()) + 1, len(u)
    cfg = hm.HPFMapConfig(n_factors=k)
    scal = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    B, mix = 4096, 4
    n_pad = -(-nnz // B) * B
    ui = np.full((n_pad, 2), -1, dtype=np.int32)
    ui[:nnz, 0], ui[:nnz, 1], ui[nnz:, 1] = u, i, 0
    x_pad = np.zeros(n_pad, dtype=np.float32)
    x_pad[:nnz] = x
    scales = [(1.0 / (np.bincount(ids, minlength=n) + 1e-6)).astype(np.float32)
              for ids, n in ((u, n_users), (i, n_items))]
    rng = np.random.default_rng(6)
    out = {}
    for dev in ("cpu", "cuda"):
        us, is_ = (torch.from_numpy(s).to(dev) for s in scales)
        lay = hm.build_map_layout(u, i, x, n_users, n_items, B, mix=mix, device=dev)
        if dev == "cpu":
            seg_perms = [rng.permutation(lay.n_segments) for _ in range(epochs)]
            flat_perms = [rng.permutation(n_pad) for _ in range(epochs)]
        params = hm.init_params(n_users, n_items, cfg, device=dev)
        p, st = hm._permute_rows(params, adam_init(params), lay.u_old_of_new,
                                 lay.i_old_of_new)
        for perm in seg_perms:
            p, st, loss_b = hm.train_epoch_blocked(
                p, st, perm, lay, us[lay.u_old_of_new], is_[lay.i_old_of_new], scal,
                MAP_LR, mix)
        p, _ = hm._permute_rows(p, st, lay.u_new_of_old, lay.i_new_of_old)
        q, st = params, adam_init(params)
        ui_t, x_t = torch.from_numpy(ui).to(dev), torch.from_numpy(x_pad).to(dev)
        for perm in flat_perms:
            q, st, loss_f = hm.train_epoch(q, st, perm, ui_t, x_t, us, is_, scal,
                                           MAP_LR, B)
        out[dev] = {"blocked": hm.params_to_numpy(p), "flat": hm.params_to_numpy(q),
                    "losses": (float(loss_b), float(loss_f))}
    worst = {}
    for engine in ("blocked", "flat"):
        w = 0.0
        for key, ref in out["cpu"][engine].items():
            got = out["cuda"][engine][key]
            if got.shape != ref.shape or not np.all(np.isfinite(got)):
                raise AssertionError(f"msmall {engine}: {key} shape or not finite")
            np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-5,
                                       err_msg=f"{engine} {key}")
            w = max(w, float(np.max(np.abs(got - ref) / (1e-5 + 5e-4 * np.abs(ref)))))
        worst[engine] = w
    log(f"phase msmall (K={k}): ok | {epochs} epochs card vs host (rtol 5e-4, atol 1e-5), worst "
        f"|diff| / (atol + rtol |host|): "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
        + f" | last epoch loss card {out['cuda']['losses']} host {out['cpu']['losses']}")


def _run_mfit(train, val, smi, engine):
    import torch

    from pmf_tpu_torch.models.hpf_map import HPFMap, HPFMapConfig, params_to_numpy

    model = HPFMap(HPFMapConfig(n_factors=K, lr=MAP_LR, batch_size=MAP_BATCH,
                                mix=MAP_MIX, epochs=MAP_EPOCHS, verbose=False,
                                engine=engine))
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    nnz = len(train[0])
    for rec in model.fit_history:
        log(f"  {engine} epoch {rec['epoch']}: {rec['epoch_seconds']:.4f} s | "
            f"{nnz / rec['epoch_seconds'] / 1e6:.1f}M edge-visits/s | loss "
            f"{rec['train_loss']:.6e} | val RMSE {rec['val_rmse']:.6f} | {smi}")
    want = dict.fromkeys(launches, 0)
    if engine == "blocked_high":
        # One launch a direction a step that holds ratings: every step does,
        # since fewer than mix segments are empty padding.
        lay = model.layout
        assert lay.n_segments - lay.n_real_segments < MAP_MIX
        want["K9"] = 2 * (lay.n_segments // MAP_MIX) * MAP_EPOCHS
        # and one K10 launch a step, every step (the dense part moves every row)
        want["K10"] = (lay.n_segments // MAP_MIX) * MAP_EPOCHS
    if launches != want or model.engine_used != engine:
        raise AssertionError(f"mfit {engine} launches {launches}, expected {want}")
    state = params_to_numpy(model.state)
    shapes = {"user": (N_USERS, K + 1), "item": (N_ITEMS, K + 1)}
    for k, v in state.items():
        if v.shape != shapes[k] or not np.all(np.isfinite(v)):
            raise AssertionError(f"mfit {engine} state {k}: shape {v.shape} or "
                                 f"non-finite values")
    losses = [rec["train_loss"] for rec in model.fit_history]
    if len(losses) != MAP_EPOCHS or not np.all(np.isfinite(losses))             or not losses[-1] < losses[0]:
        raise AssertionError(f"mfit {engine}: train loss history {losses}")
    # The reported val RMSE equals the host's from the returned state.
    host = model.evaluate_rmse(val)
    last = model.fit_history[-1]["val_rmse"]
    if not abs(host - last) < 1e-4:
        raise AssertionError(f"mfit {engine}: host val RMSE {host} vs {last}")
    secs = [rec["epoch_seconds"] for rec in model.fit_history]
    log(f"phase mfit ({engine}): ok | {MAP_EPOCHS} epochs in {wall:.1f}s wall (set-up "
        f"included) | first epoch {secs[0]:.4f} s, later epochs "
        + ", ".join(f"{t:.4f}" for t in secs[1:])
        + f" s ({nnz / np.mean(secs[1:]) / 1e6:.1f}M edge-visits/s) | launches "
        f"{launches} | loss {losses[0]:.6e} -> {losses[-1]:.6e} | val RMSE "
        f"{model.fit_history[0]['val_rmse']:.6f} -> {last:.6f} (host {host:.6f})")
    return model, launches


# Phase mfit's witness: the blocked fit through the plain dense part on the
# card's tensors against the fit through K10, loss and val RMSE each epoch
# (K10's row sums of theta and of the log prior are taken in another order).
MFIT_WITNESS_RTOL = 1e-4


@contextlib.contextmanager
def _plain_dense_part():
    """HPFMap's blocked steps through the plain dense part on the card's
    tensors in place of K10: ``map_dense_step_plain``, the next softplus
    tables from the moved parameters, the loss into the run's first slot,
    K9's accumulators zeroed after the step (as K10 leaves them).  Only
    this script calls it."""
    from pmf_tpu_torch.models import hpf_map as hm
    from pmf_tpu_torch.ops import map_dense as md

    def step(run):
        params, state, loss = md.map_dense_step_plain(
            run.params, run.opt_state, run.u_sp, run.i_sp, *run.acc, run.user_scale,
            run.item_scale, run.cfg_scalars, run.lr)
        run.params, run.opt_state = params, state
        run.loss[0] += loss
        run.u_sp, run.i_sp = (md.softplus(params[k].float()) for k in ("user", "item"))
        for acc in run.acc:
            acc.zero_()

    saved, hm.map_dense_step = hm.map_dense_step, step
    try:
        yield
    finally:
        hm.map_dense_step = saved


def _mfit_witness(model, train, val, smi):
    """Phase mfit's blocked fit again through the plain dense part
    (``_plain_dense_part``): its launches (K9 only), and its loss and val
    RMSE each epoch within MFIT_WITNESS_RTOL of the fit through K10."""
    import torch

    from pmf_tpu_torch.models.hpf_map import HPFMap

    counters = reset_counters()
    t0 = time.perf_counter()
    with _plain_dense_part():
        witness = HPFMap(model.config).fit(train, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    want = dict.fromkeys(launches, 0)
    want["K9"] = 2 * (witness.layout.n_segments // MAP_MIX) * MAP_EPOCHS
    if launches != want:
        raise AssertionError(f"mfit witness launches {launches}, expected {want}")
    worst = 0.0
    for got, ref in zip(model.fit_history, witness.fit_history):
        for key in ("train_loss", "val_rmse"):
            rel = abs(got[key] - ref[key]) / abs(ref[key])
            worst = max(worst, rel)
            log(f"  mfit witness epoch {got['epoch']} {key}: K10 {got[key]:.8e}, plain "
                f"{ref[key]:.8e} (rel {rel:.3e}) | plain epoch {ref['epoch_seconds']:.4f} s")
    if not worst <= MFIT_WITNESS_RTOL or len(witness.fit_history) != MAP_EPOCHS:
        raise AssertionError(f"mfit witness: rel {worst:.3e} past {MFIT_WITNESS_RTOL}")
    log(f"  mfit witness (the plain dense part, K9 as always): {MAP_EPOCHS} epochs in "
        f"{wall:.1f}s wall | worst rel {worst:.3e} (tol {MFIT_WITNESS_RTOL}) | {smi}")


def phase_mfit(train, val, smi):
    """HPFMap.fit at batch_size 65536, mix 8, 3 epochs: the blocked engine
    (2 K9 launches and one of K10 a step, the grouping once an epoch) and
    its witness through the plain dense part (``_mfit_witness``), then the
    flat one (no kernel)."""
    blocked, launches = _run_mfit(train, val, smi, "blocked_high")
    _mfit_witness(blocked, train, val, smi)
    flat, flaunches = _run_mfit(train, val, smi, "flat")
    del flat
    return blocked, {k: launches[k] + flaunches[k] for k in launches}


def phase_mresume(model, train, val, smi):
    """HPFMap.fit blocked for 1 epoch with checkpoint_every=1, then resumed
    for MAP_EPOCHS - 1 more: params equal phase mfit's unbroken blocked
    state in bits (Adam moments and the shuffle's generator ride in the
    checkpoint)."""
    import shutil

    import torch

    from pmf_tpu_torch.models.hpf_map import HPFMap, HPFMapConfig
    from pmf_tpu_torch.utils.checkpoint import load_state

    ck = _fresh_dir("resume_map")
    try:
        counters = reset_counters()
        cfg = dict(n_factors=K, lr=MAP_LR, batch_size=MAP_BATCH, mix=MAP_MIX,
                   verbose=False, engine="blocked_high")
        t0 = time.perf_counter()
        HPFMap(HPFMapConfig(epochs=1, **cfg)).fit(train, val, checkpoint_dir=ck,
                                                  checkpoint_every=1)
        resumed = HPFMap(HPFMapConfig(epochs=MAP_EPOCHS, **cfg)).fit(
            train, val, resume_from=ck)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        want = dict.fromkeys(launches, 0)
        want["K9"] = 2 * (resumed.layout.n_segments // MAP_MIX) * MAP_EPOCHS
        want["K10"] = (resumed.layout.n_segments // MAP_MIX) * MAP_EPOCHS
        if launches != want:
            raise AssertionError(f"mresume launches {launches}, expected {want}")
        epochs = [rec["epoch"] for rec in resumed.fit_history]
        if epochs != list(range(2, MAP_EPOCHS + 1)):
            raise AssertionError(f"mresume: resumed epochs {epochs}")
        _check_equal_states("resume (HPF-MAP)", resumed.state, model.state)
        flat, _ = load_state(ck)
        t_save, t_load, mb = _save_load_times(flat, "resume_map_times")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(os.path.join(SMOKE_TMP, "resume_map_times"), ignore_errors=True)
    log(f"phase resume (HPF-MAP): ok | blocked, 1 epoch + checkpoint, then "
        f"{MAP_EPOCHS - 1} resumed = the unbroken {MAP_EPOCHS}-epoch params in bits | "
        f"{wall:.1f}s wall (two fits, set-up included) | launches {launches} | "
        f"checkpoint (params, Adam, generator) save {t_save:.2f} s, load to the card "
        f"{t_load:.2f} s, {mb:.1f} MB | {smi}")


MPROFILE_OTHER = 9  # launches of a run of steps besides K9 and K10 (phase mprofile)


def _map_scales(lay, train):
    """1/count scales of the layout's rows in its row space, as
    HPFMap.fit makes them."""
    import torch

    return tuple(torch.from_numpy((1.0 / (np.bincount(ids, minlength=n) + 1e-6))
                                  .astype(np.float32)).cuda()[perm]
                 for ids, n, perm in ((train[0], lay.n_users, lay.u_old_of_new),
                                      (train[1], lay.n_items, lay.i_old_of_new)))


def phase_mprofile(model, train, smi, label="mprofile"):
    """MPROFILE_STEPS steady blocked steps from the fitted state, grouped
    beforehand, under torch.profiler: busy time, idle share, K9's share and
    the dense part's (K10, one launch a step; the run's other launches,
    once a run: the first softplus tables, the zeroed accumulators and
    loss slots, the loss's sum, at most MPROFILE_OTHER).  Returns {step_ms
    (CUDA events), busy_ms, window_ms, k9_ms, k9_share, dense_ms,
    dense_share, k10_ms} (shares of the traced busy time)."""
    from pmf_tpu_torch.models import hpf_map as hm
    from pmf_tpu_torch.ops.adam import adam_init

    cfg, lay = model.config, model.layout
    scal = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    scales = _map_scales(lay, train)
    params, opt = hm._permute_rows(model.state, adam_init(model.state),
                                   lay.u_old_of_new, lay.i_old_of_new)
    box = [params, opt]
    order = np.random.default_rng(8).permutation(lay.n_segments)
    groups = lay.group(order[: MPROFILE_STEPS * MAP_MIX], MAP_MIX, cfg.n_factors)
    n_real = int(np.count_nonzero(groups[0].step_edges))

    def steps():
        box[0], box[1], _ = hm.train_steps_grouped(box[0], box[1], groups, *scales,
                                                   scal, cfg.lr)

    ms = cuda_ms(steps, reps=3)
    log(f"  {label} steady blocked step (K={cfg.n_factors}): {ms / MPROFILE_STEPS:.4f} ms "
        f"({MAP_BATCH / (ms / MPROFILE_STEPS) / 1e3:.1f}M edge-visits/s) | {smi}")
    rows, busy, wall_ms = profile_once(steps, {"map_grad": 2 * n_real,
                                               K10_KERNEL: MPROFILE_STEPS})

    def part(rows_of):
        return sum(r[0] for r in rows_of), sum(r[1] for r in rows_of)

    k9, n_k9 = part([r for r in rows if any(n in r[2] for n in K9_KERNELS)])
    k10, n_k10 = part([r for r in rows if K10_KERNEL in r[2]])
    other = [r for r in rows if K10_KERNEL not in r[2]
             and not any(n in r[2] for n in K9_KERNELS)]
    other_ms, n_other = part(other)
    log(f"{'phase ' if label == 'mprofile' else '  '}{label}: ok | {MPROFILE_STEPS} blocked "
        f"steps: device busy {busy:.4f} ms of {wall_ms:.4f} ms window (idle share "
        f"{1 - busy / wall_ms:.1%})")
    if busy > 0 and n_k9:
        log(f"  by part: K9 {k9:.4f} ms ({k9 / busy:.1%}) in {n_k9} traced launches "
            f"of {2 * n_real} ({k9 / n_k9 * 2e3:.2f} us a step); the dense part "
            f"{busy - k9:.4f} ms ({1 - k9 / busy:.1%}): K10 {k10:.4f} ms ({k10 / busy:.1%}) in "
            f"{n_k10} launches ({n_k10 / MPROFILE_STEPS:.2f} a step, "
            f"{k10 / max(n_k10, 1) * 1e3:.2f} us each), the run's other launches "
            f"{other_ms:.4f} ms in {n_other} (once a run, at most {MPROFILE_OTHER})")
    for dev_ms, n, key in rows[:12]:
        log(f"  {dev_ms:9.4f} ms  {n:4d}x  {key[:90]}")
    if n_k10 > MPROFILE_STEPS or n_other > MPROFILE_OTHER or n_k9 > 2 * n_real:
        raise AssertionError(f"{label}: launches K9 {n_k9}, K10 {n_k10}, other {n_other} "
                             f"in {MPROFILE_STEPS} steps: " + "; ".join(
                                 f"{n}x {key[:60]}" for _, n, key in other))
    return dict(step_ms=ms / MPROFILE_STEPS, busy_ms=busy, window_ms=wall_ms, k9_ms=k9,
                k9_share=k9 / busy if busy > 0 else float("nan"), k10_ms=k10,
                dense_ms=busy - k9, dense_share=1 - k9 / busy if busy > 0 else float("nan"))


K10_KERNEL = "map_dense_kernel"
K10_KS = (K_WIDE, 128, 300)  # phase k10's K beside K (the fitted state); K_HUGE: mhugefit
K10_WARM = 3  # K10 steps that give a checked step its Adam moments
K10_OPS = 40  # K10's operations an element (a transcendental function counted once)


def _k10_inputs(lay, params, order, scales, scal, lr):
    """A real step of the layout at the parameters' K: K10_WARM blocked
    steps (K9 and K10) from fresh Adam moments on the first segments of
    ``order``, then the next step's K9 accumulators.  Returns (params,
    opt_state, acc_u, acc_i) in the layout's row space."""
    from pmf_tpu_torch.models import hpf_map as hm
    from pmf_tpu_torch.ops.adam import adam_init
    from pmf_tpu_torch.ops.map_grad import map_grad_grouped

    k = params["user"].shape[1] - 1
    params = {side: v.clone() for side, v in params.items()}
    warm = lay.group(order[: K10_WARM * MAP_MIX], MAP_MIX, k)
    params, opt, _ = hm.train_steps_grouped(params, adam_init(params), warm, *scales, scal,
                                            lr)
    step = lay.group(order[K10_WARM * MAP_MIX : (K10_WARM + 1) * MAP_MIX], MAP_MIX, k)
    acc_u, acc_i = map_grad_grouped(hm.softplus(params["user"]), hm.softplus(params["item"]),
                                    step, 0, hm.LAMBDA_FLOOR)
    return params, opt, acc_u, acc_i


def _k10_run(inputs, scales, scal, lr):
    """A run of K10 over copies of ``inputs`` (``_k10_inputs``), the
    step's K9 sums in its accumulators."""
    from pmf_tpu_torch.ops import map_dense as md

    params, opt, acc_u, acc_i = inputs
    state = {"count": opt["count"], "mu": {k: v.clone() for k, v in opt["mu"].items()},
             "nu": {k: v.clone() for k, v in opt["nu"].items()}}
    run = md.dense_run({k: v.clone() for k, v in params.items()}, state, *scales, scal, lr)
    run.acc[0].copy_(acc_u)
    run.acc[1].copy_(acc_i)
    return run


def _k10_plain(inputs, scales, scal, lr, sp=None):
    """The plain version on ``inputs`` (it moves nothing in place), from
    the softplus tables ``sp`` (made from the parameters if None): (tables
    as ``_k10_tables`` names them, the loss)."""
    from pmf_tpu_torch.ops import map_dense as md

    params, opt, acc_u, acc_i = inputs
    if sp is None:
        sp = (md.softplus(params["user"].float()), md.softplus(params["item"].float()))
    p, state, loss = md.map_dense_step_plain(params, opt, *sp, acc_u, acc_i, *scales, scal,
                                             lr)
    return {"params": p, "mu": state["mu"], "nu": state["nu"],
            "softplus": {k: md.softplus(v.float()) for k, v in p.items()}}, loss


def _k10_tables(run):
    return {"params": run.params, "mu": run.opt_state["mu"], "nu": run.opt_state["nu"],
            "softplus": {"user": run.u_sp, "item": run.i_sp}}


def _k10_bound(n_users, n_items, k, touched, elt=4):
    """K10's bound in ms: each row's parameters and both moments read and
    written, its K9 row and scale read, its softplus row written, the
    ``touched`` rows' K9 rows (users', items') cleared; K10_OPS FP32
    operations an element.  (ms, by, bytes)."""
    rows, row = n_users + n_items, (k + 1) * elt
    n_bytes = (rows * (6 * row + 4 * (k + 1) + elt) + 4 * (n_users * (k + 2) + n_items * (k + 1))
               + 4 * (touched[0] * (k + 2) + touched[1] * (k + 1)))
    return bound(n_bytes, K10_OPS * rows * (k + 1)) + (n_bytes,)


def _check_k10(label, inputs, scales, scal, lr, timed=True):
    """K10 against ``map_dense_step_plain`` on one step's inputs (CUDA
    tensors): per column (COL_RTOL) of the parameters, both moments and the
    next softplus tables, the loss relatively (RTOL), the accumulators left
    zero, the count advanced; a second launch on the same inputs equal in
    bits in every table and loss slot.  With ``timed``, K10 alone by CUDA
    events (``launch_ms``: launches in place on one run, the step's K9
    sums put back before each), on accumulators of zeros (no row to clear:
    clear_ms is the difference), the two zero-fills that clearing saves,
    and the plain version with the next softplus tables.  Returns
    {max_abs_err, worst, ms, plain_ms, idle_ms, clear_ms, fill_ms,
    bound_ms, bound_by, bytes}."""
    import torch

    from pmf_tpu_torch.ops import map_dense as md

    params, opt, acc_u, acc_i = inputs
    k = params["user"].shape[1] - 1
    touched = (int(torch.count_nonzero(acc_u[:, k])), int(torch.count_nonzero(acc_i[:, k])))
    runs = [_k10_run(inputs, scales, scal, lr) for _ in range(2)]
    for run in runs:
        md.map_dense_step(run)
    ref, ref_loss = _k10_plain(inputs, scales, scal, lr)
    got, again = (_k10_tables(run) for run in runs)
    err, worst, ok, bits, same = 0.0, 0.0, True, True, []
    for name, tabs in ref.items():
        for side, want in tabs.items():
            a, w, good = column_check(got[name][side], want)
            err, worst, ok = max(err, a), max(worst, w), ok and good
            bits = bits and torch.equal(got[name][side], again[name][side])
            if name != "softplus":
                same.append(float((got[name][side] == want).float().mean()))
    loss = float(runs[0].result()[2])
    _, rel_loss = compare(torch.tensor(loss), ref_loss.detach().cpu())
    bits = bits and torch.equal(runs[0].loss, runs[1].loss)
    cleared = all(int(torch.count_nonzero(a)) == 0 for a in runs[0].acc)
    counted = runs[0].opt_state["count"] == opt["count"] + 1
    res = dict(max_abs_err=err, worst=worst)
    note = ""
    if timed:
        run = runs[0]

        def put_back():
            run.acc[0].copy_(acc_u)
            run.acc[1].copy_(acc_i)

        res["ms"] = launch_ms(lambda: md.map_dense_step(run), put_back)
        res["idle_ms"] = launch_ms(lambda: md.map_dense_step(run),
                                   lambda: [a.zero_() for a in run.acc])
        res["clear_ms"] = res["ms"] - res["idle_ms"]
        res["fill_ms"] = cuda_ms(lambda: [a.zero_() for a in run.acc])
        sp = (md.softplus(params["user"].float()), md.softplus(params["item"].float()))
        res["plain_ms"] = cuda_ms(lambda: _k10_plain(inputs, scales, scal, lr, sp))
        res["bound_ms"], res["bound_by"], res["bytes"] = _k10_bound(
            params["user"].shape[0], params["item"].shape[0], k, touched)
        note = (f" | K10 {res['ms']:.4f} ms by CUDA events (bound {res['bound_ms']:.4f}, "
                f"{res['bound_by']}, {res['bytes'] / 1e6:.1f} MB; "
                f"{res['bound_ms'] / res['ms']:.1%} of it); with no row to clear "
                f"{res['idle_ms']:.4f} ms (clearing {res['clear_ms']:+.4f} ms against the "
                f"two zero-fills it saves, {res['fill_ms']:.4f} ms) | plain (with the next "
                f"softplus tables) "
                f"{res['plain_ms']:.4f} ms")
    log(f"  {label}: {touched[0]} + {touched[1]} rows in the step | worst column "
        f"max|err|/max|plain| {worst:.3e} (tol {COL_RTOL}), max |err| {err:.3e} | loss rel "
        f"{rel_loss:.3e} (tol {RTOL}) | equal in bits to plain: {min(same):.4%} of the "
        f"parameter and moment entries (least table) | accumulators cleared {cleared} | "
        f"second launch equal in bits {bits}" + note)
    if not (ok and bits and cleared and counted and rel_loss <= RTOL):
        raise AssertionError(f"{label}: K10 and its plain version disagree")
    return res


def _k10_at(lay, params, train, cfg, label, timed=True):
    """``_check_k10`` on a real step of ``lay`` from ``params`` (the
    layout's row space) at cfg's priors and lr."""
    scal = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    scales = _map_scales(lay, train)
    order = np.random.default_rng(12).permutation(lay.n_segments)
    inputs = _k10_inputs(lay, params, order, scales, scal, cfg.lr)
    return _check_k10(label, inputs, scales, scal, cfg.lr, timed)


def phase_k10(model, train):
    """K10 against its plain version and timed on real steps of phase
    mfit's layout (``_k10_at``): at K on the fitted state, at K10_KS from
    the initial state (K9 at each K gives the step's sums).  Returns K's
    result with {"at": {k: result}}."""
    from pmf_tpu_torch.models import hpf_map as hm

    lay = model.layout
    fitted = {k: v[perm].contiguous() for (k, v), perm in
              zip(model.state.items(), (lay.u_old_of_new, lay.i_old_of_new))}
    res = _k10_at(lay, fitted, train, model.config, f"K10 K={K} on phase mfit's state")
    res["at"] = {}
    for k in K10_KS:
        cfg = hm.HPFMapConfig(n_factors=k, lr=MAP_LR)
        params = hm.init_params(lay.n_users, lay.n_items, cfg, device="cuda")
        params = {side: v[perm].contiguous() for (side, v), perm in
                  zip(params.items(), (lay.u_old_of_new, lay.i_old_of_new))}
        res["at"][k] = _k10_at(lay, params, train, cfg, f"K10 K={k} from the initial state")
        del params
        gc_cuda()
    log(f"phase k10: ok | K={K}: {res['ms']:.4f} ms a step (bound {res['bound_ms']:.4f}), "
        f"plain {res['plain_ms']:.4f} ms | " + ", ".join(
            f"K={k} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})" for k, r in res["at"].items())
        + f" | worst column {max([res['worst']] + [r['worst'] for r in res['at'].values()]):.3e}")
    return res


MHUGE_EPOCHS = 3  # phase mhugefit: the blocked HPF-MAP fit at K_HUGE
# Its learning rate: at K = 160 the start predicts about 77 for ratings of 1..5;
# MAP_LR (0.001) leaves the val RMSE at 35 after 3 epochs, 0.01 is where the JAX
# package's fit converges on a cut of this data (tests/test_torch_maplr.py).
MHUGE_LR = 0.01
# Its last val RMSE stays below this, falling every epoch.  On an H100 it reads
# 12.38 -> 5.19 -> 2.86 (the same to 6 digits over four runs; at lr 0.001 56.18
# -> 43.98 -> 35.34), while its witnesses end near 1.48: the flat engine at full
# width, and both engines on the 1/MHUGE_CUT cut.  So the card and the width
# converge; the blocked engine's full-width batches (mix tile-band segments a
# step) converge more slowly, as at K = 20 (phase mfit: blocked 2.69, flat 1.92).
# The lag is the engine's own, not the port's: on the CPU at K = 20 and lr 0.001
# (scripts/map_blocked_lag.py) the JAX package's blocked fit lags its flat fit
# wherever its layout keeps the bench's 380 steps an epoch, at 1/4 of the bench
# 2.353 against 1.906 (the port's blocked 2.396), and the lag grows with the
# width (the port's blocked fit 1.96, 1.99, 2.11, 2.26, 2.40 at 1/64 .. 1/4, flat
# 1.89-1.93); on the reference's own segments the port's blocked fit follows the
# reference's epoch by epoch (tests/test_torch_map_dense.py, at 1/64).
MHUGE_RMSE = 3.0
# Each witness's last val RMSE stays below this (tests/test_torch_maplr.py's
# CONVERGED), and on the cut the blocked fit's last within MHUGE_CUT_RTOL of the
# flat one's (the CPU test's tolerance against the JAX package's fit).
MHUGE_WITNESS_RMSE = 2.0
MHUGE_CUT_RTOL = 0.03


MHUGE_CUT = 128  # the witnesses' cut of the bench: tests/test_torch_maplr.py's


def _mhuge_fit(train, val, k, engine, batch_size):
    """One HPFMap fit at ``k`` and lr MHUGE_LR for MHUGE_EPOCHS epochs: its
    val RMSE history, checked finite and falling every epoch."""
    from pmf_tpu_torch.models.hpf_map import HPFMap, HPFMapConfig

    model = HPFMap(HPFMapConfig(n_factors=k, lr=MHUGE_LR, batch_size=batch_size,
                                mix=MAP_MIX, epochs=MHUGE_EPOCHS, verbose=False, engine=engine))
    model.fit(train, val)
    rmse = [rec["val_rmse"] for rec in model.fit_history]
    if model.engine_used != engine or not (np.all(np.isfinite(rmse)) and np.all(np.diff(rmse) < 0)
                                           and rmse[-1] < MHUGE_WITNESS_RMSE):
        raise AssertionError(f"mhugefit witness {engine}: val RMSE {rmse} does not fall below "
                             f"{MHUGE_WITNESS_RMSE}")
    return rmse


def _mhuge_witnesses(train, val, k):
    """Fits beside mhugefit's blocked one that tell its engine from its
    width: the flat engine at full width, and both engines on the bench cut
    to 1/MHUGE_CUT of its users, items, ratings, held-out ratings and batch
    (tests/test_torch_maplr.py's cut, where the CPU holds both to the JAX
    package's fit), each at lr MHUGE_LR, each falling below MHUGE_WITNESS_RMSE,
    the cut's blocked fit within MHUGE_CUT_RTOL of its flat one at the end:
    {name: val RMSE history}."""
    from pmf_tpu_torch.data.synthetic import synth

    out = {"flat, full width": _mhuge_fit(train, val, k, "flat", MAP_BATCH)}
    n_users, n_items, nnz = N_USERS // MHUGE_CUT, N_ITEMS // MHUGE_CUT, NNZ // MHUGE_CUT
    u, i, x = synth(n_users, n_items, nnz, seed=0)
    held = n_users + np.random.default_rng(1).choice(nnz - n_users, size=N_VAL // MHUGE_CUT,
                                                      replace=False)
    keep = np.ones(nnz, bool)
    keep[held] = False
    cut = (u[keep], i[keep], x[keep]), (u[~keep], i[~keep], x[~keep])
    for engine in ("flat", "blocked_high"):
        out[f"{engine}, 1/{MHUGE_CUT} cut"] = _mhuge_fit(*cut, k, engine,
                                                         MAP_BATCH // MHUGE_CUT)
    for name, rmse in out.items():
        log(f"  mhugefit witness {name}: val RMSE " + " -> ".join(f"{v:.6f}" for v in rmse))
    flat, blocked = (out[f"{e}, 1/{MHUGE_CUT} cut"][-1] for e in ("flat", "blocked_high"))
    if not abs(blocked - flat) <= MHUGE_CUT_RTOL * flat:
        raise AssertionError(f"mhugefit witness: on the cut blocked {blocked} against flat {flat}")
    return out


def _map_reckoning(n_users, n_items, nnz, k, n_pieces):
    """Bytes the blocked MAP fit at ``k`` holds on the card, reckoned before
    it runs: {params, Adam moments (both moved in place by K10), the
    softplus'd tables and K9's accumulators of a run of steps, K10's loss
    slots, the layout, both directions' groupings}."""
    from pmf_tpu_torch.ops.map_dense import blocks_of

    rows = n_users + n_items
    params = 4 * rows * (k + 1)
    return {"params": params, "adam": 2 * params, "softplus": params,
            "accumulators": 4 * (n_users * (k + 2) + n_items * (k + 1)),
            "loss slots": 8 * (blocks_of(n_users) + blocks_of(n_items)),
            # ids and ratings of the edges, the two row permutations each way
            "layout": 12 * nnz + 16 * rows,
            # each direction's (other, x) an edge and 20 bytes a piece
            "groupings": 2 * 8 * nnz + 20 * n_pieces}


def phase_mhugefit(train, val, smi, n_pieces, k=K_HUGE):
    """HPFMap.fit at ``k`` factors at full width (the bench's ratings,
    batch_size 65536, mix 8, MHUGE_EPOCHS epochs at lr MHUGE_LR, engine
    blocked_high): per epoch seconds, edge-visits/s, loss and val RMSE; K9
    = 2 x steps x epochs and no other kernel; the state finite, the loss
    falling, the val RMSE falling every epoch and ending below MHUGE_RMSE,
    the host's val RMSE equal to the history's; the peak beside its reckoning
    (``n_pieces``: both directions' pieces of an epoch, phase mdata's); K9
    on the fit's state against its plain version (per column, counts
    exact, a second launch in bits); MPROFILE_STEPS steady steps by CUDA
    events and under the profiler; then its witnesses (``_mhuge_witnesses``)."""
    import torch

    from pmf_tpu_torch.models.hpf_map import (HPFMap, HPFMapConfig, params_to_numpy,
                                              softplus)
    from pmf_tpu_torch.ops.map_grad import kernel_of

    reck = _map_reckoning(N_USERS, N_ITEMS, len(train[0]), k, n_pieces)
    gc_cuda()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = HPFMap(HPFMapConfig(n_factors=k, lr=MHUGE_LR, batch_size=MAP_BATCH, mix=MAP_MIX,
                                epochs=MHUGE_EPOCHS, verbose=False, engine="blocked_high"))
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    launches = {kid: c.count for kid, c in counters.items()}
    lay = model.layout
    want = dict.fromkeys(launches, 0)
    want["K9"] = 2 * (lay.n_segments // MAP_MIX) * MHUGE_EPOCHS
    want["K10"] = (lay.n_segments // MAP_MIX) * MHUGE_EPOCHS
    if launches != want or model.engine_used != "blocked_high":
        raise AssertionError(f"mhugefit launches {launches}, expected {want}")
    nnz = len(train[0])
    for rec in model.fit_history:
        log(f"  mhugefit epoch {rec['epoch']}: {rec['epoch_seconds']:.4f} s | "
            f"{nnz / rec['epoch_seconds'] / 1e6:.1f}M edge-visits/s | loss "
            f"{rec['train_loss']:.6e} | val RMSE {rec['val_rmse']:.6f} | {smi}")
    state = params_to_numpy(model.state)
    for name, v in state.items():
        n = N_USERS if name == "user" else N_ITEMS
        if v.shape != (n, k + 1) or not np.all(np.isfinite(v)):
            raise AssertionError(f"mhugefit state {name}: shape {v.shape} or non-finite values")
    losses = [rec["train_loss"] for rec in model.fit_history]
    if len(losses) != MHUGE_EPOCHS or not np.all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"mhugefit: train loss history {losses}")
    host = model.evaluate_rmse(val)
    last = model.fit_history[-1]["val_rmse"]
    if not abs(host - last) < 1e-4:
        raise AssertionError(f"mhugefit: host val RMSE {host} vs {last}")
    rmse = [rec["val_rmse"] for rec in model.fit_history]
    if not (np.all(np.diff(rmse) < 0) and rmse[-1] < MHUGE_RMSE):
        raise AssertionError(f"mhugefit: val RMSE {rmse} does not fall below {MHUGE_RMSE} "
                             f"at lr {MHUGE_LR}")
    reck_gb = sum(reck.values()) / 1e9
    log(f"  mhugefit memory: peak {peak_gb:.3f} GB above the {held / 1e9:.3f} GB held before "
        f"the fit | reckoned {reck_gb:.3f} GB: " + ", ".join(
            f"{name} {v / 1e9:.3f}" for name, v in reck.items()))
    # K9 on the fit's state: one real step in the layout's row space.
    u_sp = softplus(model.state["user"][lay.u_old_of_new].float()).contiguous()
    i_sp = softplus(model.state["item"][lay.i_old_of_new].float()).contiguous()
    seg_ids = np.random.default_rng(10).choice(lay.n_segments, MAP_MIX, replace=False).tolist()
    err, col = _check_map_step(lay, u_sp, i_sp, seg_ids,
                               f"mhugefit K9 {kernel_of(k)} on the fit's state {seg_ids}")
    del u_sp, i_sp
    fitted = {name: v[perm].contiguous() for (name, v), perm in
              zip(model.state.items(), (lay.u_old_of_new, lay.i_old_of_new))}
    k10 = _k10_at(lay, fitted, train, model.config, f"mhugefit K10 K={k} on the fit's state")
    del fitted
    secs = [rec["epoch_seconds"] for rec in model.fit_history]
    prof = phase_mprofile(model, train, smi, label="mhugefit")
    del model
    gc_cuda()
    witness = _mhuge_witnesses(train, val, k)
    log(f"phase mhugefit (K={k}): ok | {MHUGE_EPOCHS} epochs in {wall:.1f}s wall (set-up "
        f"included) | epochs " + ", ".join(f"{t:.4f}" for t in secs)
        + f" s ({nnz / np.mean(secs[1:]) / 1e6:.1f}M edge-visits/s after the first) | "
        f"launches {launches} | lr {MHUGE_LR} | loss {losses[0]:.6e} -> {losses[-1]:.6e} | "
        f"val RMSE " + " -> ".join(f"{v:.6f}" for v in rmse) + f" (host {host:.6f}, "
        f"gate < {MHUGE_RMSE}) | K9 on "
        f"the fit's state: worst column {col:.3e} | K10 on it: worst column "
        f"{k10['worst']:.3e}, {k10['ms']:.4f} ms (bound {k10['bound_ms']:.4f}) | steady step "
        f"{prof['step_ms']:.4f} ms, K9 {prof['k9_share']:.1%}, the dense part "
        f"{prof['dense_share']:.1%} of busy | peak {peak_gb:.3f} GB (reckoned {reck_gb:.3f})")
    return dict(launches=launches, epoch_s=secs, peak_gb=peak_gb, reckoned_gb=reck_gb,
                max_abs_err=err, val_rmse=rmse, witness=witness, k10=k10, **prof)


K9_PARENT_KS = (K, K_WIDE, 128, 129, K_HUGE, 200, 256, 257, 300, 512)  # phase k9 parent
K9_SAME_TOL = 0.03


def _k9_plan(mod, k) -> tuple:
    """A tree's K9 plan at ``k``: its instance, piece length and short-run
    threshold (0 for a tree without the runs form)."""
    return (mod.kernel_of(k), mod.piece_of(k),
            mod.short_of(k) if hasattr(mod, "short_of") else 0)


def _k9_ptxas_against_parent():
    """Each K9 instance of both builds: the ones both hold with the
    parent's ptxas line; the new ones logged with theirs."""
    theirs: dict = {}
    _ptxas_report(open(str(PARENT["lib"]) + ".log").read(), theirs)
    mine = {n: v for n, v in PTXAS.items() if n.startswith("map_grad_")}
    prev = {n: v for n, v in theirs.items() if n.startswith("map_grad_")}
    kept = sorted(set(mine) & set(prev))
    new = sorted(set(mine) - set(prev))
    differ = [n for n in kept if mine[n] != prev[n]]
    if differ:
        raise AssertionError(f"k9 parent: ptxas differs from the parent's for {differ}")
    log(f"  k9 parent: instances gone {sorted(set(prev) - set(mine))}; new "
        + ", ".join(f"{n} ({mine[n]})" for n in new) + "; kept "
        + ", ".join(kept) + " as the parent's")


def _k9_host_turns(epoch, n, reps=3):
    """The host's side of K9's launch path, both trees in turns parent,
    this, this, parent: seconds to enqueue ``epoch(tree)`` (a host clock
    around the loop of launches, the card synchronised before it and after
    the clock stops), ``reps`` epochs a turn; logged in µs a launch (``n``
    launches an epoch)."""
    import torch

    by = {"parent": [], "this": []}
    for t in K2_AB_TURNS:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch(t)
            by[t].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
    log("  k9 parent host launch path (an epoch's enqueue, min / median µs a launch): "
        + ", ".join(f"{t} {min(v) / n * 1e6:.2f} / {float(np.median(v)) / n * 1e6:.2f}"
                    for t, v in by.items()))


def phase_k9_parent(lay, order):
    """With ``--parent``: K9 of this tree and of the parent tree on the
    bench's MAP layout (random softplus'd tables, the same epoch order),
    one epoch of launches (both directions, every step) captured in a CUDA
    graph and replayed, by CUDA events, in turns parent, this, this,
    parent, at K9_PARENT_KS.  Where the two trees' plans differ
    (``_k9_plan``: this tree's runs form to K = 128 against the parent's
    one warp a piece), this tree's accumulators are within COL_RTOL per
    column of the parent's and faster in every turn; where they are the
    same (past K = 128), equal in bits and the means within K9_SAME_TOL.
    At K the host's launch path of both trees in turns (``_k9_host_turns``).
    Returns {k: (this tree's mean ms, the parent's)}."""
    import torch

    from pmf_tpu_torch.models.hpf_map import LAMBDA_FLOOR
    from pmf_tpu_torch.ops import map_grad as mg

    _k9_ptxas_against_parent()
    pm = _parent_op("map_grad")
    out = {}
    for k in K9_PARENT_KS:
        u_sp, i_sp = _map_tables(lay, k)
        groups = {"this": lay.group(order, MAP_MIX, k),
                  "parent": (pm.group_steps(lay.u, lay.i, lay.x, lay.seg_off, order, MAP_MIX,
                                            lay.n_users, k),
                             pm.group_steps(lay.i, lay.u, lay.x, lay.seg_off, order, MAP_MIX,
                                            lay.n_items, k))}
        ops = {"this": mg, "parent": pm}
        accs = {t: (torch.zeros((u_sp.shape[0], k + 2), device="cuda"),
                    torch.zeros((i_sp.shape[0], k + 1), device="cuda")) for t in groups}

        def epoch(tree, k=k, u_sp=u_sp, i_sp=i_sp):
            g, op, (acc_u, acc_i) = groups[tree], ops[tree], accs[tree]
            for s in range(g[0].n_steps):
                op.map_grad_pieces(u_sp, i_sp, g[0], s, LAMBDA_FLOOR, True, acc_u)
                op.map_grad_pieces(i_sp, u_sp, g[1], s, LAMBDA_FLOOR, False, acc_i)

        graphs = {t: graph_of(lambda t=t: epoch(t)) for t in groups}
        if k == K:
            _k9_host_turns(epoch, 2 * groups["this"][0].n_steps)
        differ = _k9_plan(pm, k) != _k9_plan(mg, k)
        if differ:
            col = max(column_check(a, b)[1] for a, b in zip(accs["this"], accs["parent"]))
            if not col <= COL_RTOL:
                raise AssertionError(f"k9 parent K={k}: column difference {col}")
            note = f"largest column difference {col:.3e}"
        elif all(torch.equal(a, b) for a, b in zip(accs["this"], accs["parent"])):
            note = "equal in bits"
        else:
            raise AssertionError(f"k9 parent K={k}: the trees differ in bits")
        turns = [graph_ms(graphs[t], reps=3) for t in K2_AB_TURNS]
        by = {t: [ms for u, ms in zip(K2_AB_TURNS, turns) if u == t] for t in ("parent", "this")}
        mean = {t: float(np.mean(v)) for t, v in by.items()}
        out[k] = (mean["this"], mean["parent"])
        note = ("turns " + ", ".join(f"{t} {ms:.4f}" for t, ms in zip(K2_AB_TURNS, turns))
                + f" ms an epoch | this / parent {mean['this'] / mean['parent'] - 1:+.2%} | "
                + note)
        log(f"  k9 parent K={k} (this {_k9_plan(mg, k)}, parent {_k9_plan(pm, k)}): {note}")
        if differ and not max(by["this"]) < min(by["parent"]):
            raise AssertionError(f"k9 parent K={k}: this tree's plan is not faster in every "
                                 f"turn: {note}")
        if not differ and not mean["this"] <= (1 + K9_SAME_TOL) * mean["parent"]:
            raise AssertionError(f"k9 parent K={k}: {mean} past {K9_SAME_TOL:.0%}")
        del graphs, groups, accs, u_sp, i_sp
        gc_cuda()
    log(f"phase k9 parent: ok | {PARENT['dir']} | K {list(K9_PARENT_KS)}: faster in every "
        f"turn where the plans differ, else equal in bits and within {K9_SAME_TOL:.0%}")
    return out


# ---------------------------------------------------------------- Gaussian --

GAUSS_HEAD_BYTES = 15 << 28  # GaussianMF.fit's head budget
GFIT_SWEEPS = 4
GDIAG_SWEEPS = 2
# Kernel vs plain version for the signed Gaussian sums (m_o * resid
# cancels, so an elementwise relative error is meaningless near zero):
# each output column's largest error against that column's largest
# magnitude.  f32 sums of up to a few thousand terms in another order
# stay near 1e-6 of it.
COL_RTOL = 1e-4
# K4 vs plain and vs float64 inv, per matrix: largest error against the
# matrix's largest entry.
INV_RTOL = 1e-4


def column_check(got, ref, rows=1 << 14):
    """(max abs error, worst column ratio max|got-ref| / max|ref|, ok), in
    chunks of ``rows`` rows (no float64 copy of a whole output at once)."""
    import torch

    diff = torch.zeros(got.shape[1:], dtype=torch.float64, device=got.device)
    scale = torch.zeros_like(diff)
    for r in range(0, got.shape[0], rows):
        g, f = got[r : r + rows].double(), ref[r : r + rows].double()
        diff = torch.maximum(diff, (g - f).abs().amax(dim=0))
        scale = torch.maximum(scale, f.abs().amax(dim=0))
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / scale.clamp_min(1e-300))
    return (float(diff.max()), float(ratio.max()),
            bool((diff <= COL_RTOL * scale).all()))


def phase_gdata(split):
    """The bench's Gaussian ratings on the same ids and split, and the
    layout GaussianMF.fit builds."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked

    u, i, is_val = split
    t0 = time.perf_counter()
    x = np.random.default_rng(1).standard_normal(NNZ).astype(np.float32)
    train = (u[~is_val], i[~is_val], x[~is_val])
    val = (u[is_val], i[is_val], x[is_val])
    blocked = build_blocked(*train, n_users=N_USERS, n_items=N_ITEMS,
                            reorder=True, head="auto",
                            head_bytes=GAUSS_HEAD_BYTES, device="cuda")
    torch.cuda.synchronize()
    t_layout = time.perf_counter() - t0
    heads = blocked.head or ()
    tiers = [(h.row_start, h.hu, h.hi) for h in heads]
    cell_bytes = sum(h.x_hi.nbytes + h.m.nbytes
                     + (h.x_lo.nbytes if h.x_lo is not None else 0) for h in heads)
    cells = sum(h.hu * h.hip for h in heads)
    has_lo = [h.x_lo is not None for h in heads]
    n_train = len(train[0])
    log(f"phase gdata: ok | train {n_train} val {N_VAL} N(0,1) ratings K={K} | "
        f"host layout build {t_layout:.1f}s")
    log(f"  tiers (row_start, rows, hi): {tiers} | head cells {cells} (budget "
        f"{GAUSS_HEAD_BYTES // 6} at 6 B) | head cell bytes {cell_bytes} | "
        f"x_lo present {has_lo}")
    if not heads or not all(has_lo):
        raise AssertionError("gdata: expected a head with x_lo planes")
    for name, p in (("by_user", blocked.by_user), ("by_item", blocked.by_item)):
        log(f"  tail {name}: nnz {p.nnz} ({p.nnz / n_train:.1%} of edges) | "
            f"longest row {p.max_row_len()}")
    return train, val, blocked


def _gauss_tables(n, seed, k=K):
    """Random Gaussian-state rows on the card: means m, SPD covariances V,
    biases b and diagonal variances v."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    m = 0.1 * torch.randn(n, k, generator=g, device="cuda")
    A = 0.1 * torch.randn(n, k, k, generator=g, device="cuda")
    V = 0.5 * torch.eye(k, device="cuda") + A @ A.transpose(1, 2)
    b = 0.1 * torch.randn(n, generator=g, device="cuda")
    v = 0.1 + 0.5 * torch.rand(n, k, generator=g, device="cuda")
    return m, V, b, v


def _new_space_gauss(blocked, k=K):
    """Per direction: (name, pass, self rows, other rows), each table set
    permuted into the pass's new space."""
    users = _gauss_tables(blocked.by_user.n_self, 11, k)
    items = _gauss_tables(blocked.by_item.n_self, 12, k)
    out = []
    for name, p, s, o in (("user", blocked.by_user, users, items),
                          ("item", blocked.by_item, items, users)):
        out.append((name, p, tuple(t[p.self_old_of_new] for t in s),
                    tuple(t[p.other_old_of_new] for t in o)))
    return out


def _csr_ones(p):
    """The tail's CSR pattern with unit values (the library reference)."""
    import warnings

    import torch

    with warnings.catch_warnings():  # beta-state and invariant-check notices
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(p.row_ptr, p.other.long(),
                                       torch.ones(p.nnz, device="cuda"),
                                       size=(p.n_self, p.n_other))


def _tail_phase(kid, blocked, n_flops_per_edge, library=None, no_library=""):
    """K5 or K6 vs its plain version (column criterion) on the tables the
    fits build, equal bits on a repeat, times and bound, the per-edge
    sector reckoning and the long rows alone, both directions; returns the
    per-sweep sums.  ``library`` times torch.sparse.mm over the
    pass-through bulk; ``no_library`` says why a pass has none."""
    import torch

    res = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, n_bytes=0.0, n_flops=0.0,
               library_ms=0.0 if library else None)
    for name, p, (m_s, _, b_s, _), (m_o, _, b_o, v_o) in _new_space_gauss(blocked):
        tabs = _gauss_tail_tabs(kid, m_s, b_s, m_o, v_o, b_o)
        got = _tail_kernel(kid, tabs, p, K)
        ref = _tail_plain(kid, tabs, p, K)
        abs_err, worst, ok = column_check(got, ref)
        if not ok:
            raise AssertionError(f"{kid} {name}: column error {worst} > {COL_RTOL}")
        if not torch.equal(got, _tail_kernel(kid, tabs, p, K)):
            raise AssertionError(f"{kid} {name}: two runs differ in bits")
        ms = cuda_ms(lambda: _tail_kernel(kid, tabs, p, K))
        plain_ms = cuda_ms(lambda: _tail_plain(kid, tabs, p, K), reps=3)
        # the function's inputs once (their real columns, not the padding)
        inputs = (m_o, b_o) if kid == "K5" else (m_s, b_s, m_o, b_o, v_o)
        n_bytes = (sum(t.nbytes for t in inputs) + p.row_ptr.nbytes + p.other.nbytes
                   + p.x.nbytes + got.nbytes)
        n_flops = p.nnz * n_flops_per_edge
        b_ms, b_by = bound(n_bytes, n_flops)
        lib = f" | library: none ({no_library})"
        if library:
            lib_ms = cuda_ms(library(p, m_o, b_o))
            res["library_ms"] += lib_ms
            lib = f" | library (torch.sparse.mm, pass-through bulk only) {lib_ms:.4f} ms"
        log(f"  {kid} {name}: nnz {p.nnz} | max abs err {abs_err:.3e} | worst "
            f"column max|err|/max|plain| {worst:.3e} (tol {COL_RTOL}) | repeat equal in "
            f"bits | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms{lib} | bound "
            f"{b_ms:.4f} ms ({b_by})")
        _tail_notes(kid, name, tabs, p, K, ms, got.nbytes)
        if kid == "K5":  # the other side's [m | b] table, scattered or gathered
            _log_permutation(name, p)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        res["n_bytes"] += n_bytes
        res["n_flops"] += n_flops
    res["bound_ms"], res["bound_by"] = bound(res["n_bytes"], res["n_flops"])
    log(f"phase {kid}: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})" + (f", library {res['library_ms']:.4f} ms"
                                  if library else ""))
    return res


def _log_permutation(name, p):
    """Log the time of building an [m | b] record table into new space by
    scattering with ``other_new_of_old`` (as the frames do) and by
    gathering with ``other_old_of_new``."""
    import torch

    from pmf_tpu_torch.ops.gaussian_edge import record_table

    m = torch.rand(p.n_other, K, device="cuda")
    b = torch.rand(p.n_other, device="cuda")
    scatter_ms = cuda_ms(lambda: record_table(m, b, p.other_new_of_old))
    gather_ms = cuda_ms(lambda: record_table(m, b)[p.other_old_of_new])
    log(f"  K5 {name} record table of {p.n_other} rows into new space: scattered "
        f"{scatter_ms:.4f} ms, gathered {gather_ms:.4f} ms")


def _k3_table(m, V, b, k=K):
    """K3's padded [m | b | tri | 0] table of new-space rows."""
    from pmf_tpu_torch.ops import gaussian_edge as ge

    return ge.factor_table(m, b, (V + m[:, :, None] * m[:, None, :]).reshape(-1, k * k))


BAND_L2_SHARE = 0.5  # share of L2 one band of K3's other table may fill


def _k3_banded(p, k, table_once):
    """K3's banded reckoning: the bands of other rows whose records fill
    at most BAND_L2_SHARE of the card's L2, and the bytes of a pass band by
    band (the table once, the ids and ratings once, and the output rows
    that a band after the first touches read and written once more)."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge

    l2 = torch.cuda.get_device_properties(p.row_ptr.device).L2_cache_size
    n = max(-(-p.n_other * 4 * ge.factor_stride(k) // int(l2 * BAND_L2_SHARE)), 1)
    rows = -(-p.n_other // n)
    self_of_edge = torch.repeat_interleave(
        torch.arange(p.n_self, device=p.row_ptr.device), p.row_ptr[1:] - p.row_ptr[:-1])
    touched = torch.bincount((p.other.long() // rows) * p.n_self + self_of_edge,
                             minlength=n * p.n_self).view(n, p.n_self) > 0
    row_out = 4 * (2 * k + ge.tri_size(k))
    return n, table_once + 2 * int(touched[1:].sum()) * row_out


def phase_k3(blocked, k=K, label="K3", check=True):
    """K3, the factor tail pass, both directions: the kernel vs its plain
    version (per-column criterion), equal bits on a repeat, its three byte
    reckonings (per-edge gather, table once, banded by ``_k3_banded``);
    library: CSR-ones @ [m | b | tri] by torch.sparse.mm, the pass-through
    bulk.  Without ``check`` (the K = 50 timing) no plain version runs."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge

    T = ge.tri_size(k)
    res = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0,
               n_bytes=0.0, n_flops=0.0, per_edge_bytes=0.0, banded_bytes=0.0)
    for name, p, s, o in _new_space_gauss(blocked, k):
        m, V, b, _ = o
        aug = _k3_table(m, V, b, k)
        del V
        args = (aug, p.row_ptr, p.other, p.x, k, False)
        abs_err = worst = float("nan")
        if check:
            got = ge.factor_tail_stats(*args)
            ref = ge.factor_tail_stats_plain(*args, max_edges=1 << 21)
            abs_err, worst, ok = column_check(got, ref)
            if not ok:
                raise AssertionError(f"{label} {name}: column error {worst} > {COL_RTOL}")
            if not torch.equal(got, ge.factor_tail_stats(*args)):
                raise AssertionError(f"{label} {name}: two runs differ in bits")
            del got, ref
        unpadded = aug[:, : k + 1 + T].contiguous()
        turns = [cuda_ms(lambda: ge.factor_tail_stats(*args)) for _ in range(2)]
        plain_ms = cuda_ms(lambda: ge.factor_tail_stats_plain(*args, max_edges=1 << 21),
                           reps=3) if check else float("nan")
        csr = _csr_ones(p)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, unpadded))
        del csr
        r = ge.factor_reckoning(p, k, False)
        n_bands, banded = _k3_banded(p, k, r["table_once"])
        ms = (turns[0] + turns[1]) / 2
        n_flops = p.nnz * (3 * k + 1 + T)
        b_ms, b_by = bound(r["table_once"], n_flops)
        to_ms = lambda n: n / HBM_BYTES_PER_S * 1e3  # noqa: E731
        log(f"  {label} {name}: nnz {p.nnz} | n_other {p.n_other} | record "
            f"{4 * (k + 1 + T)} B, stride {4 * ge.factor_stride(k)} B | one pass (B 1)"
            + (f" | max abs err {abs_err:.3e} | worst column {worst:.3e} (tol {COL_RTOL})"
               " | repeat equal in bits" if check else ""))
        log(f"  {label} {name} bytes: per-edge gather {r['per_edge']:.0f} "
            f"({to_ms(r['per_edge']):.4f} ms) | table once {r['table_once']:.0f} "
            f"({to_ms(r['table_once']):.4f} ms) | banded (B {n_bands}, L2 share "
            f"{BAND_L2_SHARE}) {banded:.0f} ({to_ms(banded):.4f} ms)")
        log(f"  {label} {name} times: kernel {turns[0]:.4f} {turns[1]:.4f} ms | plain "
            f"{plain_ms:.4f} ms | library (torch.sparse.mm, pass-through bulk only) "
            f"{lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["library_ms"] += lib_ms
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        res["n_bytes"] += r["table_once"]
        res["per_edge_bytes"] += r["per_edge"]
        res["banded_bytes"] += banded
        res["n_flops"] += n_flops
        del aug, unpadded
        torch.cuda.empty_cache()
    res["bound_ms"], res["bound_by"] = bound(res["n_bytes"], res["n_flops"])
    log(f"phase {label}: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}, table once; per-edge gather "
        f"{res['per_edge_bytes'] / HBM_BYTES_PER_S * 1e3:.4f}, banded "
        f"{res['banded_bytes'] / HBM_BYTES_PER_S * 1e3:.4f}), library "
        f"{res['library_ms']:.4f} ms")
    return res


def phase_k5(blocked):
    """K5, the bias tail pass; library: CSR-ones @ [m | b] (all but sum x)."""
    import torch

    def library(p, m_o, b_o):
        csr, mb = _csr_ones(p), torch.cat([m_o, b_o[:, None]], dim=1)
        return lambda: torch.sparse.mm(csr, mb)

    return _tail_phase("K5", blocked, K + 2, library)


def phase_k6(blocked):
    """K6, the diag tail pass; no library call computes it (a per-edge
    dot with the self row weights every term)."""
    # per edge: dot 2K, resid 2, m * (resid - pred) 2K, sq K, m^2 2K
    return _tail_phase("K6", blocked, 7 * K + 2,
                       no_library="a per-edge dot with the self row weights every term")


def phase_ghead(blocked):
    """The Gaussian head products per tier and side (library matmuls):
    K3's [m | b m | tri | b] and X @ m products, and K5's [m | b]."""
    import torch

    from pmf_tpu_torch.ops import gaussian_edge as ge
    from pmf_tpu_torch.ops.dense_head import head_products, head_products_t

    rows = {}
    for name, p, s, o in _new_space_gauss(blocked):
        m, V, b, _ = o
        tri = ge.pack_tri((V + m[:, :, None] * m[:, None, :]).reshape(-1, K * K), K)
        rows[name] = torch.cat([m, b[:, None] * m, tri, b[:, None]], dim=1)
    total = 0.0
    for t, h in enumerate(blocked.head or ()):
        planes = 2 + (h.x_lo is not None)
        for side in ("user", "item"):
            if side == "user":
                tab = torch.nn.functional.pad(rows["user"][: h.hi],
                                              (0, 0, 0, h.hip - h.hi))
                fn = head_products
            else:
                tab = rows["item"][h.row_start : h.row_start + h.hu]
                fn = head_products_t
            m_tab = tab[:, :K].contiguous()
            mb_tab = torch.cat([tab[:, :K], tab[:, -1:]], dim=1)
            ms_f = cuda_ms(lambda: fn(h, tab, m_tab), reps=5)
            ms_b = cuda_ms(lambda: fn(h, mb_tab, None), reps=5)
            cell_bytes = sum(a.nbytes for a in (h.x_hi, h.m, h.x_lo) if a is not None)
            # bf16 tensor-core products: M @ two table planes, X planes @ m
            n_flops = 2.0 * h.hu * h.hip * (2 * tab.shape[1] + (planes - 1) * 2 * K
                                            + 2 * mb_tab.shape[1])
            t_bytes = (h.m.nbytes + cell_bytes + 2 * tab.nbytes
                       + 4 * (h.hu if side == "user" else h.hip)
                       * (tab.shape[1] + K + K + 1))
            b_ms = max(t_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS_PER_S) * 1e3
            total += ms_f + ms_b
            log(f"  head tier {t} ({h.row_start}, {h.hu}, {h.hi}) {side}: factor "
                f"products {ms_f:.4f} ms | bias products {ms_b:.4f} ms | bound "
                f"{b_ms:.4f} ms")
    log(f"phase ghead: ok | bf16 planes, torch.mm(out_dtype=float32) | per exact "
        f"sweep {total:.4f} ms")


def _real_precisions(blocked):
    """The theta- and beta-block precision matrices I/eta^2 + S_A/sigma^2
    of one factor pass from the initial state (default hyperparameters)."""
    import torch

    from pmf_tpu_torch.models.gaussian_mf import GaussianMFConfig, init_state
    from pmf_tpu_torch.ops.gaussian_edge import gaussian_factor_stats

    cfg = GaussianMFConfig(n_factors=K)
    st = init_state(N_USERS, N_ITEMS, cfg, device="cuda")
    eye = torch.eye(K, device="cuda")
    out = []
    for side, p, m_o, V_o, b_s, b_o, eta2 in (
            ("user", blocked.by_user, st["m_beta"], st["V_beta"], st["b_user"],
             st["b_item"], cfg.eta_theta2),
            ("item", blocked.by_item, st["m_theta"], st["V_theta"], st["b_item"],
             st["b_user"], cfg.eta_beta2)):
        _, S_A = gaussian_factor_stats(m_o, V_o, b_s, b_o, p, head=blocked.head,
                                       head_side=side)
        out.append(eye / eta2 + S_A / cfg.sigma2)
    del st
    return out


def _k4_bounds(R, k):
    """(bytes ms, FP32 ms) of inverting R K x K matrices in place: each
    matrix read and written once; K pivots x K rows x K multiply-adds."""
    return (2 * R * 4 * k * k / HBM_BYTES_PER_S * 1e3,
            R * 2 * k**3 / FP32_FLOPS_PER_S * 1e3)


def _k4_check(P, name, k=K, check_plain=True):
    """K4 on P vs float64 inv (and its plain version), per matrix, and the
    kernel and torch.linalg.inv timed."""
    import torch

    from pmf_tpu_torch.ops.gj_inverse import (
        batched_psd_inverse_gj, batched_psd_inverse_gj_plain)

    got = batched_psd_inverse_gj(P)
    if not torch.equal(got, batched_psd_inverse_gj(P)):
        raise AssertionError(f"K4 {name}: two launches differ in bits")
    ref64 = torch.linalg.inv(P.double())
    scale = ref64.abs().amax(dim=(1, 2))
    err64 = float(((got.double() - ref64).abs().amax(dim=(1, 2)) / scale).max())
    err_plain, abs_err = float("nan"), float("nan")
    if check_plain:
        ref = batched_psd_inverse_gj_plain(P)
        err_plain = float(((got - ref).abs().amax(dim=(1, 2)) / scale).max())
        abs_err = float((got - ref).abs().max())
        del ref
    resid = float((P.double() @ got.double()
                   - torch.eye(k, device="cuda", dtype=torch.float64)).abs().max())
    del ref64
    reps = 10 if k <= 32 else 3
    t = [cuda_ms(lambda: batched_psd_inverse_gj(P), reps) for _ in range(2)]
    lib_ms = cuda_ms(lambda: torch.linalg.inv(P), reps)
    plain_ms = cuda_ms(lambda: batched_psd_inverse_gj_plain(P), 3) if check_plain \
        else float("nan")
    R = P.shape[0]
    b_bytes, b_ops = _k4_bounds(R, k)
    log(f"  K4 {name}: {R} x {k}x{k} | per-matrix max|err|/max|inv| vs plain "
        f"{err_plain:.3e}, vs float64 inv {err64:.3e} (tol {INV_RTOL}) | max|P V - I| "
        f"{resid:.3e} | repeat equal in bits | kernel {t[0]:.4f} {t[1]:.4f} ms | plain "
        f"{plain_ms:.4f} "
        f"ms | torch.linalg.inv {lib_ms:.4f} ms | bound: bytes {b_bytes:.4f} ms, FP32 "
        f"{b_ops:.4f} ms")
    if not (err64 <= INV_RTOL and (not check_plain or err_plain <= INV_RTOL)):
        raise AssertionError(f"K4 {name}: error {err_plain} / {err64} > {INV_RTOL}")
    return dict(ms=(t[0] + t[1]) / 2, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=abs_err, n_bytes=2.0 * P.nbytes,
                n_flops=2.0 * R * k**3)


def phase_k4(blocked):
    res = dict.fromkeys(("ms", "plain_ms", "library_ms", "max_abs_err",
                         "n_bytes", "n_flops"), 0.0)
    for name, P in zip(("theta", "beta"), _real_precisions(blocked)):
        r = _k4_check(P.contiguous(), name)
        for key in res:
            res[key] = max(res[key], r[key]) if key == "max_abs_err" else res[key] + r[key]
    res["bound_ms"], res["bound_by"] = bound(res["n_bytes"], res["n_flops"])
    log(f"phase K4: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, torch.linalg.inv "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}; bytes {res['n_bytes'] / HBM_BYTES_PER_S * 1e3:.4f}, FP32 "
        f"{res['n_flops'] / FP32_FLOPS_PER_S * 1e3:.4f})")
    return res


def phase_gsmall(k=K, shape=(3000, 1500, 120_000),
                 head=([(0, 256, 1500), (256, 768, 300)], 256), sweeps=3):
    """``sweeps`` blocked Gaussian sweeps on the card vs the host (plain
    kernels) on one small input of ``shape`` (users, items, ratings) with a
    two-tier ``head`` (tiers, row multiple), in the exact, lagged and diag
    modes, at the JAX package's blocked-vs-flat gate, at ``k`` factors."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.coo import build_ratings
    from pmf_tpu_torch.data.synthetic import synth_ratings
    from pmf_tpu_torch.models import gaussian_mf as gm

    u, i, _ = synth_ratings(*shape, seed=5)
    x = np.random.default_rng(2).standard_normal(len(u)).astype(np.float32)
    tiers, head_r0 = head
    worst = {}
    for cov, upd in (("full", "exact"), ("full", "lagged"), ("diag", "exact")):
        cfg = gm.GaussianMFConfig(n_factors=k, covariance=cov, bias_update=upd)
        states = {}
        for dev in ("cpu", "cuda"):
            blocked = build_blocked(u, i, x, reorder=True, head=tiers, head_r0=head_r0,
                                    device=dev)
            flat = build_ratings(u, i, x, device=dev)
            s = gm.init_state(flat.n_users, flat.n_items, cfg, device=dev)
            for _ in range(sweeps):
                s = gm.sweep_blocked(s, blocked, flat.user_counts, flat.item_counts,
                                     cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2,
                                     cfg.eta_bias2, True, cov, upd)
            states[dev] = gm.state_to_numpy(s)
        w = 0.0
        for key, ref in states["cpu"].items():
            got = states["cuda"][key]
            if got.shape != ref.shape or not np.all(np.isfinite(got)):
                raise AssertionError(f"gsmall {cov}/{upd}: {key} shape or not finite")
            np.testing.assert_allclose(got, ref, rtol=5e-3, atol=2e-5,
                                       err_msg=f"{cov}/{upd} {key}")
            w = max(w, float(np.max(np.abs(got - ref) / (2e-5 + 5e-3 * np.abs(ref)))))
        worst[f"{cov}/{upd}"] = w
    torch.cuda.synchronize()
    log(f"phase gsmall (K={k}): ok | {shape[0]} x {shape[1]}, {shape[2]} ratings | "
        f"{sweeps} sweeps card vs host (rtol 5e-3, atol 2e-5), worst "
        f"|diff| / (atol + rtol |host|): "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))


def _train_rmse(state, train, n=1_000_000):
    """RMSE of the biased prediction on the first n training ratings."""
    import torch

    u, i, x = (torch.from_numpy(np.ascontiguousarray(a[:n])).cuda() for a in train)
    pred = (torch.sum(state["m_theta"][u] * state["m_beta"][i], dim=1)
            + state["b_user"][u] + state["b_item"][i])
    return float(torch.sqrt(torch.mean((x - pred) ** 2)))


def _run_gfit(train, val, smi, covariance, sweeps, want_of):
    import torch

    from pmf_tpu_torch.models.gaussian_mf import (
        GaussianMF, GaussianMFConfig, init_state, state_to_numpy)

    cfg = GaussianMFConfig(n_factors=K, max_iter=sweeps, tol=None, verbose=False,
                           engine="blocked_high", covariance=covariance)
    model = GaussianMF(cfg)
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val, global_mean=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    for rec in model.fit_history:
        log(f"  {covariance} sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | "
            f"{rec['updates_per_sec'] / 1e6:.1f}M updates/s | val RMSE "
            f"{rec['val_rmse']:.6f} | {smi}")
    want = dict.fromkeys(launches, 0)
    want.update(want_of(model))
    if launches != want:
        raise AssertionError(f"gfit {covariance} launches {launches}, expected {want}")
    state = state_to_numpy(model.state)
    shapes = {"m_theta": (N_USERS, K), "m_beta": (N_ITEMS, K),
              "V_theta": (N_USERS, K, K) if covariance == "full" else (N_USERS, K),
              "V_beta": (N_ITEMS, K, K) if covariance == "full" else (N_ITEMS, K),
              "b_user": (N_USERS,), "b_item": (N_ITEMS,)}
    for k, v in state.items():
        if v.shape != shapes[k] or not np.all(np.isfinite(v)):
            raise AssertionError(f"gfit {covariance} state {k}: shape {v.shape} "
                                 f"or non-finite values")
    rmses = [rec["val_rmse"] for rec in model.fit_history]
    if len(rmses) != sweeps or not np.all(np.isfinite(rmses)):
        raise AssertionError(f"gfit {covariance} val RMSE history {rmses}")
    # The reported val RMSE equals the host's from the returned state.
    host = model.evaluate_rmse(val)
    if not abs(host - rmses[-1]) < 1e-4:
        raise AssertionError(f"gfit {covariance}: host val RMSE {host} vs {rmses[-1]}")
    # The fit explains training ratings better than its initial state.
    init = init_state(N_USERS, N_ITEMS, cfg, device="cuda")
    tr0, tr1 = _train_rmse(init, train), _train_rmse(model.state, train)
    del init
    if not tr1 < tr0:
        raise AssertionError(f"gfit {covariance}: train RMSE {tr0} -> {tr1}")
    log(f"phase gfit ({covariance}): ok | {model.n_sweeps} sweeps in {wall:.1f}s "
        f"wall (layout build included) | launches {launches} | val RMSE "
        f"{rmses[0]:.6f} -> {rmses[-1]:.6f} (host {host:.6f}) | train RMSE "
        f"(first 1M) {tr0:.6f} -> {tr1:.6f}")
    return model, launches


def phase_gfit(train, val, smi):
    """GaussianMF.fit(engine="blocked_high"): exact full covariance for
    GFIT_SWEEPS sweeps (K3, K4, K5 twice a sweep), then the diag
    configuration for GDIAG_SWEEPS (K6 and K5 twice a sweep)."""
    full, launches = _run_gfit(
        train, val, smi, "full", GFIT_SWEEPS,
        lambda m: {"K3": 2 * m.n_sweeps, "K4": 2 * m.n_sweeps, "K5": 2 * m.n_sweeps})
    diag, dlaunches = _run_gfit(
        train, val, smi, "diag", GDIAG_SWEEPS,
        lambda m: {"K5": 2 * m.n_sweeps, "K6": 2 * m.n_sweeps})
    return full, diag, {k: launches[k] + dlaunches[k] for k in launches}


def phase_gprofile(full, diag, train, smi):
    """Steady sweep times (CUDA events over chained sweeps) of both
    configurations, and one exact and one diag sweep under torch.profiler:
    busy time, idle share and parts.  The diag sweep's steady time is paced
    by the host; its busy time shows K6.  Returns {"gaussian": (the exact
    sweep's work count, busy ms)} for phase roofline."""
    import torch

    from pmf_tpu_torch.models.gaussian_mf import sweep_blocked

    user_counts, item_counts = (
        torch.bincount(torch.from_numpy(ids).cuda(), minlength=n).float()
        for ids, n in ((train[0], N_USERS), (train[1], N_ITEMS)))
    nnz = len(train[0])

    def chained(model):
        """One sweep from the last one's state (the fit's final state first)."""
        cfg = model.config
        box = [dict(model.state)]

        def one_sweep():
            box[0] = sweep_blocked(box[0], model.blocked, user_counts, item_counts,
                                   cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2,
                                   cfg.eta_bias2, cfg.use_bias, cfg.covariance,
                                   cfg.bias_update)
        return one_sweep

    steady = {}
    sweeps = {"full": chained(full), "diag": chained(diag)}
    for name, one_sweep in sweeps.items():
        steady[name] = cuda_ms(one_sweep, reps=5)
        log(f"  steady {name} sweep: {steady[name]:.4f} ms | "
            f"{4 * nnz / steady[name] / 1e3:.1f}M updates/s (4 x nnz) | {smi}")
    expect = {"::factor_kernel": 2, "gj_inverse": 2, K5_TRACE: 2}
    # Fault F2: a trace without the warm-up kernels, then the trace read.
    rows, _, _ = profile_once(sweeps["full"], expect, warm=False, attempts=1)
    seen = {part: sum(n for _, n, key in rows if part in key) for part in expect}
    log(f"  F2 probe: a trace without warm-up holds launches {seen}")
    parts = {"full": {"K3 factor_kernel": ("::factor_kernel",),
                      "K5 tail_group_kernel<3>": (K5_TRACE,),
                      "K4 gj_inverse_kernel": ("gj_inverse",)},
             "diag": {"K6 tail_group_kernel<4>": (K6_TRACE,),
                      "K5 tail_group_kernel<3>": (K5_TRACE,)}}
    expects = {"full": expect, "diag": {K6_TRACE: 2, K5_TRACE: 2}}
    out = {}
    for name, label in (("full", "exact"), ("diag", "diag")):
        rows, busy, wall_ms = profile_once(sweeps[name], expects[name])
        if name == "full":
            cfg = full.config
            out["gaussian"] = (roofline.gaussian_blocked_traffic(
                full.blocked, K, bias_update=cfg.bias_update, use_bias=cfg.use_bias), busy)
        log(f"phase gprofile: ok | one {label} sweep: device busy {busy:.4f} ms of "
            f"{wall_ms:.4f} ms window (idle share {1 - busy / wall_ms:.1%})")
        log_parts(trace_parts(rows, parts[name])[0], busy)
        for dev_ms, n, key in rows[:12]:
            log(f"  {dev_ms:9.4f} ms  {n:3d}x  {key[:90]}")
    return out


GELBO_EXACT_SWEEPS, GELBO_DIAG_SWEEPS = 3, 2
GELBO_GATE = 1e-4  # GaussianMF.fit's monotone slack on the blocked engine


def phase_gelbo(train, val, smi):
    """GaussianMF.fit(elbo_every=1) on the blocked engine: 3 exact sweeps,
    then 2 diag.  The fit's own gate raises if the ELBO falls by more than
    1e-4 relative; here the history is checked again, each value finite,
    and the ELBO's own time per evaluation taken by CUDA events."""
    import torch

    from pmf_tpu_torch.models.gaussian_mf import GaussianMF, GaussianMFConfig

    for covariance, sweeps, want_of in (
            ("full", GELBO_EXACT_SWEEPS, lambda n: {"K3": 2 * n, "K4": 2 * n,
                                                    "K5": 2 * n}),
            ("diag", GELBO_DIAG_SWEEPS, lambda n: {"K5": 2 * n, "K6": 2 * n})):
        model = GaussianMF(GaussianMFConfig(
            n_factors=K, max_iter=sweeps, tol=None, verbose=False,
            engine="blocked_high", covariance=covariance))
        counters = reset_counters()
        t0 = time.perf_counter()
        model.fit(train, val, global_mean=0.0, elbo_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        want = dict.fromkeys(launches, 0)
        want.update(want_of(model.n_sweeps))
        if launches != want:
            raise AssertionError(f"gelbo {covariance} launches {launches}, "
                                 f"expected {want}")
        elbos = [rec.get("elbo") for rec in model.fit_history]
        if len(elbos) != sweeps or None in elbos or not np.all(np.isfinite(elbos)):
            raise AssertionError(f"gelbo {covariance}: ELBO history {elbos}")
        for a, b in zip(elbos, elbos[1:]):
            if b < a - GELBO_GATE * (1.0 + abs(a)):
                raise AssertionError(f"gelbo {covariance}: ELBO fell {a} -> {b}")
        elbo_fn = model._make_elbo_fn(train)
        again = float(elbo_fn(model.state))
        if not abs(again - elbos[-1]) <= 1e-6 * abs(elbos[-1]):
            raise AssertionError(f"gelbo {covariance}: ELBO of the final state "
                                 f"{again} vs the history's {elbos[-1]}")
        ms = cuda_ms(lambda: elbo_fn(model.state), reps=3)
        log(f"phase gelbo ({covariance}): ok | {sweeps} sweeps with elbo_every=1 in "
            f"{wall:.1f}s wall | launches {launches} | ELBO "
            + " -> ".join(f"{e:.8e}" for e in elbos)
            + f" (gate {GELBO_GATE:g} relative) | ELBO evaluation {ms:.4f} ms "
            f"(CUDA events) | {smi}")
        del model, elbo_fn


GWIDE_K = 80  # phase gwidefit: the exact Gaussian fit at full width
GWIDE_SWEEPS = 4
# Phase gxlfit: the exact fit at K = 256 on a rating log of MovieLens 1M's
# shape (GroupLens "MovieLens 1M" README: 6,040 users, 3,706 rated movies,
# 1,000,209 ratings), 10,000 of them held out; no head tiers below 4M
# ratings (data/blocked.py::_pick_tiers), so its layout is the tail alone.
# The generator drops repeated (user, item) pairs: asked for 1,000,209 it
# keeps 511,962 over these ids, asked for XL_DRAW it keeps 1,023,855, of
# which the first XL_NNZ (in its random order) are the log.
XL_USERS, XL_ITEMS, XL_NNZ, XL_VAL, XL_K = 6_040, 3_706, 1_000_209, 10_000, 256
XL_DRAW = 2_600_000


def _gwide_reckoning(n_users, n_items, n_train, k, head_bytes):
    """Peak device bytes of the exact fit at ``k``, reckoned from shapes
    at the user block's update: the layout (the head budget and a tail of
    16 bytes an edge), the state, the user side's statistics table
    (N_users x (2K + T + 2)), K3's records of the item side (N_items x
    factor_stride(K)) and past K = 128 their slab-major copy, four N_users x
    K x K tensors at once (S_A, the
    precisions, K4's output, the new covariances) and the ELBO's two
    N x K x K tables of the previous sweep (one a side)."""
    from pmf_tpu_torch.ops.gaussian_edge import factor_stride

    tri = k * (k + 1) // 2
    parts = {"layout": head_bytes + 16 * n_train,
             "state": 4 * (n_users + n_items) * (k + k * k + 1),
             "statistics": 4 * n_users * (2 * k + tri + 2),
             "K3 records": 4 * n_items * factor_stride(k),
             # past K = 128 K3's slab-major copy of them, about their size
             "K3 slab copy": 4 * n_items * factor_stride(k) if k > 128 else 0,
             "user block": 4 * 4 * n_users * k * k,
             "ELBO tables": 4 * (n_users + n_items) * k * k}
    return sum(parts.values()), parts


def phase_gxldata():
    """MovieLens 1M's shape at random (``data/synthetic.py::synth_ratings``,
    seed 0, XL_NNZ distinct pairs), the ratings centred, XL_VAL of them
    held out at random."""
    from pmf_tpu_torch.data.synthetic import synth_ratings

    t0 = time.perf_counter()
    u, i, x = (a[:XL_NNZ] for a in synth_ratings(XL_USERS, XL_ITEMS, XL_DRAW, seed=0))
    x = x.astype(np.float32)
    mean = float(x.mean())
    x -= mean
    val = np.zeros(len(u), bool)
    val[np.random.default_rng(0).choice(len(u), XL_VAL, replace=False)] = True
    train, hold = (u[~val], i[~val], x[~val]), (u[val], i[val], x[val])
    log(f"phase gxldata: ok | {XL_USERS} users x {XL_ITEMS} items, {len(u)} ratings (mean "
        f"{mean:.4f} taken out), {len(train[0])} train, {XL_VAL} held out | "
        f"{time.perf_counter() - t0:.1f} s")
    return train, hold


def phase_gwidefit(train, val, smi, k=GWIDE_K, n_users=N_USERS, n_items=N_ITEMS,
                   head_bytes=GAUSS_HEAD_BYTES, label="gwidefit"):
    """``GaussianMF(n_factors=k, covariance="full", engine="blocked_high")``
    at full width for GWIDE_SWEEPS sweeps with ``elbo_every=1`` on ``n_users``
    x ``n_items`` (phase gwidefit: K = 80 on the bench's ratings; phase
    gxlfit: K = 256 on MovieLens 1M's shape): peak device memory against
    ``_gwide_reckoning``, launches (K3, K4, K5 twice a sweep, as phase
    gfit), the state finite at its shapes, the ELBO monotone within
    GELBO_GATE relative; K4 on the precision matrices the fit forms after
    sweep 1 (the user side of sweep 2) against its plain version, per
    matrix, K4_CHUNK at a time; one sweep from the fit's state traced: busy
    ms, idle share, K4's share beside K3's, the head products' and the
    glue's.  Returns {"launches", "busy_ms", "k4_ms"}."""
    import torch

    from pmf_tpu_torch.models.gaussian_mf import (
        GaussianMF, GaussianMFConfig, init_state, state_to_numpy, sweep_blocked)
    from pmf_tpu_torch.ops.gaussian_edge import gaussian_factor_stats
    from pmf_tpu_torch.ops.gj_inverse import (
        batched_psd_inverse_gj, batched_psd_inverse_gj_plain, cta_plan, form, panel_plan)

    reckon, parts = _gwide_reckoning(n_users, n_items, len(train[0]), k, head_bytes)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  {label} K={k}: peak reckoned {reckon / 1e9:.3f} GB ("
        + ", ".join(f"{n} {b / 1e9:.3f}" for n, b in parts.items())
        + f") of {total / 1e9:.3f} GB | K4 form {form(k)}: "
        f"{cta_plan(k) or panel_plan(k)}")
    cfg = GaussianMFConfig(n_factors=k, covariance="full", engine="blocked_high",
                           max_iter=GWIDE_SWEEPS, tol=None, verbose=False)
    model = GaussianMF(cfg)
    held = torch.cuda.memory_allocated()  # earlier phases' tensors, not the fit's
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val, global_mean=0.0, elbo_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kid: c.count for kid, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n = model.n_sweeps
    want = dict.fromkeys(launches, 0)
    want.update({"K3": 2 * n, "K4": 2 * n, "K5": 2 * n})
    if n != GWIDE_SWEEPS or launches != want:
        raise AssertionError(f"{label}: {n} sweeps, launches {launches}, expected {want}")
    elbos = [rec.get("elbo") for rec in model.fit_history]
    if None in elbos or not np.all(np.isfinite(elbos)):
        raise AssertionError(f"{label}: ELBO history {elbos}")
    for rec in model.fit_history:
        log(f"  K={k} sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | ELBO "
            f"{rec['elbo']:.8e} | val RMSE {rec['val_rmse']:.6f} | {smi}")
    for a, b in zip(elbos, elbos[1:]):
        if b < a - GELBO_GATE * (1.0 + abs(a)):
            raise AssertionError(f"{label}: ELBO fell {a} -> {b}")
    shapes = {"m_theta": (n_users, k), "m_beta": (n_items, k),
              "V_theta": (n_users, k, k), "V_beta": (n_items, k, k),
              "b_user": (n_users,), "b_item": (n_items,)}
    for name, v in state_to_numpy(model.state).items():
        if v.shape != shapes[name] or not np.all(np.isfinite(v)):
            raise AssertionError(f"{label} state {name}: shape {v.shape} or non-finite")
    log(f"  {label}: {n} sweeps in {wall:.1f} s wall (layout build and ELBOs included) "
        f"| peak {peak / 1e9:.3f} GB allocated, {(peak - held) / 1e9:.3f} above the "
        f"{held / 1e9:.3f} held before the fit (reckoned {reckon / 1e9:.3f}), "
        f"{(total - peak) / 1e9:.3f} GB spare | launches {launches}")

    counts = _counts_on_card(train, n_users, n_items)
    args = (cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2, cfg.eta_bias2, cfg.use_bias,
            cfg.covariance, cfg.bias_update)
    st1 = sweep_blocked(init_state(n_users, n_items, cfg, device="cuda"), model.blocked,
                        *counts, *args)
    _, S_A = gaussian_factor_stats(st1["m_beta"], st1["V_beta"], st1["b_user"],
                                   st1["b_item"], model.blocked.by_user,
                                   head=model.blocked.head, head_side="user")
    del st1
    P = torch.eye(k, device="cuda") / cfg.eta_theta2 + S_A / cfg.sigma2
    del S_A
    worst = 0.0
    for r0 in range(0, P.shape[0], K4_CHUNK):
        c = P[r0 : r0 + K4_CHUNK]
        got, ref = batched_psd_inverse_gj(c), batched_psd_inverse_gj_plain(c)
        scale = ref.abs().amax(dim=(1, 2))
        worst = max(worst, float(((got - ref).abs().amax(dim=(1, 2)) / scale).max()))
    del P, got, ref
    if not worst <= INV_RTOL:
        raise AssertionError(f"{label}: K4 on the sweep-1 precisions {worst} > {INV_RTOL}")
    log(f"  {label}: K4 on the {n_users} user precisions after sweep 1 vs plain: worst "
        f"per-matrix error {worst:.3e} (tol {INV_RTOL})")

    box = [dict(model.state)]

    def one_sweep():
        box[0] = sweep_blocked(box[0], model.blocked, *counts, *args)

    # K5's kernel: the row groups, or past 32 words a row the sum form
    k5 = tail_trace("K5", k)
    k3 = _k3_trace(k, model.blocked)
    expect = {**k3, "gj_inverse": 2, k5: 2}
    rows, busy, wall_ms = profile_once(one_sweep, expect)
    groups = trace_parts(rows, {"K3 factor_kernel": tuple(k3),
                                "K4 gj_inverse": ("gj_inverse",),
                                f"K5 {k5.rstrip(',')}": (k5,)})[0]
    log_parts(groups, busy)
    for dev_ms, cnt, key in rows[:8]:
        log(f"  {dev_ms:9.4f} ms  {cnt:3d}x  {key[:90]}")
    head = groups["head products (gemm)"]
    k4_ms, k3_ms = groups["K4 gj_inverse"], groups["K3 factor_kernel"]
    k5_ms = groups[f"K5 {k5.rstrip(',')}"]
    glue = groups["other"]
    log(f"phase {label}: ok | GaussianMF K={k} exact, {n} sweeps | one sweep busy "
        f"{busy:.4f} ms of {wall_ms:.4f} ms (idle share {1 - busy / wall_ms:.1%}) | K4 "
        f"{k4_ms:.4f} ms ({k4_ms / busy:.1%}), K3 ({', '.join(k3)}) {k3_ms:.4f} ms "
        f"({k3_ms / busy:.1%}), K5 ({k5.rstrip(',')}) {k5_ms:.4f} ms ({k5_ms / busy:.2%}), "
        f"head products {head:.4f} ms ({head / busy:.1%}), glue {glue:.4f} ms "
        f"({glue / busy:.1%}) | peak {(peak - held) / 1e9:.3f} GB above the held "
        f"(reckoned {reckon / 1e9:.3f}) | {smi}")
    del model, box
    return {"launches": launches, "busy_ms": busy, "k4_ms": k4_ms, "k3_ms": k3_ms,
            "k5_ms": k5_ms, "peak_gb": (peak - held) / 1e9, "reckoned_gb": reckon / 1e9}


GDIAG_HUGE_SWEEPS = 4  # phase gdiaghugefit: the diag Gaussian fit at K_HUGE


def _gdiag_reckoning(tiers, n_train, k, head_bytes):
    """Peak device bytes of the diag fit at ``k`` on the bench's ids,
    reckoned from shapes: the layout (the head budget and 16 bytes a tail
    edge), the state (m and v of both sides, the biases), K6's tables of
    the larger direction ([m | b] records of both sides, v + m^2 of the
    other), two N x 3K statistics tables, and the largest of the head
    tiers' transients (``ops/gaussian_edge.py::_diag_head_out``; ``tiers``
    as (hu, hip); w = 4K + T, T = K(K+1)/2; in floats a row).  The rows
    that build the table (the head items on the user side, the tier's users
    on the item side) hold their outer products beside the triangle (K^2 +
    T), then the triangle, the table and its bf16 split (T + 4w: the split's
    float32 hi and remainder beside the two planes); the product's rows
    hold the first plane's product beside the sum (3w), then the sum beside
    its unpacking (w + K^2)."""
    from pmf_tpu_torch.ops._tail import tail_stride

    T = k * (k + 1) // 2
    w = 4 * k + T
    S1, Sq = tail_stride(k + 1), tail_stride(k)
    table, product = max(k * k + T, T + 4 * w), max(3 * w, w + k * k)

    def user(hu, hip):
        return 4 * hip * table + 4 * hu * product

    def item(hu, hip):
        return 4 * hu * table + 4 * hip * product

    parts = {"layout": head_bytes + 16 * n_train,
             "state": 4 * (N_USERS + N_ITEMS) * (2 * k + 1),
             "K6 tables": 4 * max(N_USERS * S1 + N_ITEMS * (S1 + Sq),
                                  N_ITEMS * S1 + N_USERS * (S1 + Sq)),
             "statistics": 2 * 4 * max(N_USERS, N_ITEMS) * 3 * k,
             "head tier": max(max(user(hu, hip), item(hu, hip)) for hu, hip in tiers)}
    return sum(parts.values()), parts


def phase_gdiaghugefit(train, val, smi, tiers, k=K_HUGE):
    """``GaussianMF(n_factors=k, covariance="diag", engine="blocked_high")``
    at full width on phase gdata's ratings for GDIAG_HUGE_SWEEPS sweeps with
    ``elbo_every=1``: the peak device memory against ``_gdiag_reckoning``
    (``tiers``: phase gdata's (hu, hip), the layout the fit builds);
    launches (K5 and K6 twice a sweep, nothing else); the state finite at
    its shapes, the ELBO finite every sweep and logged with whether it rose
    (noise ratings: no gate here beyond the fit's own); K6 on the state of
    sweep 2 (both directions, the tables the frame builds) against its
    plain version per column at COL_RTOL, equal in bits on a repeat, and
    timed there by CUDA events; one sweep timed by CUDA events, and one
    traced for its parts' shares (fault F2: a trace can lose a launch, so
    K6's share is its events' ms over the sweep's).  Returns the launches,
    the sweep's ms, K6's ms by events and its share, K5's traced ms, the
    peak."""
    import torch

    from pmf_tpu_torch.models.gaussian_mf import (
        GaussianMF, GaussianMFConfig, init_state, state_to_numpy, sweep_blocked)
    from pmf_tpu_torch.ops import gaussian_edge as ge
    from pmf_tpu_torch.ops._tail import band_rows, new_space_rows

    reckon, parts = _gdiag_reckoning(tiers, len(train[0]), k, GAUSS_HEAD_BYTES)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  gdiaghugefit K={k}: peak reckoned {reckon / 1e9:.3f} GB ("
        + ", ".join(f"{n} {b / 1e9:.3f}" for n, b in parts.items())
        + f") of {total / 1e9:.3f} GB | head tiers (hu, hip) {list(tiers)} | K6 "
        f"{tail_trace('K6', k)}, K5 {tail_trace('K5', k)}")
    cfg = GaussianMFConfig(n_factors=k, covariance="diag", engine="blocked_high",
                           max_iter=GDIAG_HUGE_SWEEPS, tol=None, verbose=False)
    model = GaussianMF(cfg)
    gc_cuda()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    model.fit(train, val, global_mean=0.0, elbo_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kid: c.count for kid, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n = model.n_sweeps
    want = dict.fromkeys(launches, 0)
    want.update({"K5": 2 * n, "K6": 2 * n})
    if n != GDIAG_HUGE_SWEEPS or launches != want:
        raise AssertionError(f"gdiaghugefit: {n} sweeps, launches {launches}, "
                             f"expected {want}")
    elbos = [rec.get("elbo") for rec in model.fit_history]
    if None in elbos or not np.all(np.isfinite(elbos)):
        raise AssertionError(f"gdiaghugefit: ELBO history {elbos}")
    for rec in model.fit_history:
        log(f"  diag K={k} sweep {rec['iteration']}: {rec['iter_seconds']:.4f} s | ELBO "
            f"{rec['elbo']:.8e} | val RMSE {rec['val_rmse']:.6f} | {smi}")
    rose = [b > a for a, b in zip(elbos, elbos[1:])]
    shapes = {"m_theta": (N_USERS, k), "m_beta": (N_ITEMS, k), "V_theta": (N_USERS, k),
              "V_beta": (N_ITEMS, k), "b_user": (N_USERS,), "b_item": (N_ITEMS,)}
    for name, v in state_to_numpy(model.state).items():
        if v.shape != shapes[name] or not np.all(np.isfinite(v)):
            raise AssertionError(f"gdiaghugefit state {name}: shape {v.shape} or non-finite")
    log(f"  gdiaghugefit: {n} sweeps in {wall:.1f} s wall (layout build and ELBOs "
        f"included) | ELBO rose at every sweep: {all(rose)} ({rose}) | peak "
        f"{peak / 1e9:.3f} GB allocated, {(peak - held) / 1e9:.3f} above the "
        f"{held / 1e9:.3f} held before the fit (reckoned {reckon / 1e9:.3f}), "
        f"{(total - peak) / 1e9:.3f} GB spare | launches {launches}")

    counts = _counts_on_card(train, N_USERS, N_ITEMS)
    args = (cfg.sigma2, cfg.eta_theta2, cfg.eta_beta2, cfg.eta_bias2, cfg.use_bias,
            cfg.covariance, cfg.bias_update)
    st = init_state(N_USERS, N_ITEMS, cfg, device="cuda")
    for _ in range(2):
        st = sweep_blocked(st, model.blocked, *counts, *args)
    worst, k6_ms = 0.0, 0.0
    for p, (m_s, b_s), (m_o, v_o, b_o) in (
            (model.blocked.by_user, (st["m_theta"], st["b_user"]),
             (st["m_beta"], st["V_beta"], st["b_item"])),
            (model.blocked.by_item, (st["m_beta"], st["b_item"]),
             (st["m_theta"], st["V_theta"], st["b_user"]))):
        tabs = (band_rows(ge.record_table(m_s, b_s, p.self_new_of_old), p),
                ge.record_table(m_o, b_o, p.other_new_of_old),
                new_space_rows(torch.addcmul(v_o, m_o, m_o), p.other_new_of_old))
        got = _tail_kernel("K6", tabs, p, k)
        err, ok = _tail_error("K6", got, _tail_plain_rows("K6", tabs, p, k))
        if not ok:
            raise AssertionError(f"gdiaghugefit: K6 on the sweep-2 state, column error "
                                 f"{err} > {COL_RTOL}")
        if not torch.equal(got, _tail_kernel("K6", tabs, p, k)):
            raise AssertionError("gdiaghugefit: K6 on the sweep-2 state, two launches "
                                 "differ in bits")
        worst = max(worst, err)
        k6_ms += cuda_ms(lambda: _tail_kernel("K6", tabs, p, k), reps=3)
        del tabs, got
    del st
    log(f"  gdiaghugefit: K6 on the state of sweep 2 vs plain, both directions: worst "
        f"column error {worst:.3e} (tol {COL_RTOL}) | repeats equal in bits | "
        f"{k6_ms:.4f} ms a sweep (CUDA events)")

    box = [dict(model.state)]

    def one_sweep():
        box[0] = sweep_blocked(box[0], model.blocked, *counts, *args)

    ms = cuda_ms(one_sweep, reps=2)
    k5, k6 = tail_trace("K5", k), tail_trace("K6", k)
    rows, busy, wall_ms = profile_once(one_sweep, {k5: 2, k6: 2})
    groups = trace_parts(rows, {f"K6 {k6}": (k6,), f"K5 {k5}": (k5,)})[0]
    k6_traced, k5_ms = groups[f"K6 {k6}"], groups[f"K5 {k5}"]
    head, glue = groups["head products (gemm)"], groups["other"]
    log_parts(groups, busy)
    for dev_ms, cnt, key in rows[:8]:
        log(f"  {dev_ms:9.4f} ms  {cnt:3d}x  {key[:90]}")
    log(f"phase gdiaghugefit: ok | GaussianMF K={k} diag, {n} sweeps | a sweep "
        f"{ms:.4f} ms (CUDA events) | one sweep traced: busy {busy:.4f} ms of "
        f"{wall_ms:.4f} ms (idle share {1 - busy / wall_ms:.1%}), K6 {k6_traced:.4f} ms "
        f"({k6_traced / busy:.2%}; by CUDA events {k6_ms:.4f} ms, {k6_ms / ms:.2%} of the "
        f"sweep), K5 {k5_ms:.4f} ms ({k5_ms / busy:.2%}), head products "
        f"{head:.4f} ms ({head / busy:.1%}), glue {glue:.4f} ms ({glue / busy:.1%}) | "
        f"peak {(peak - held) / 1e9:.3f} GB above the held (reckoned "
        f"{reckon / 1e9:.3f}) | {smi}")
    del model, box
    return {"launches": launches, "sweep_ms": ms, "busy_ms": busy, "k6_ms": k6_ms,
            "k6_share": k6_ms / ms, "k5_ms": k5_ms, "peak_gb": (peak - held) / 1e9,
            "reckoned_gb": reckon / 1e9}


# ---- The experiment surface: CLIs, multi-seed fits, the reproduction chain.

MID_USERS, MID_ITEMS, MID_NNZ, MID_HELD = 40_000, 12_000, 2_000_000, 20_000
CLI_ITERS = 3  # iterations of every mid-size CLI fit (HPF-MAP: 1 epoch)
TRAIN_FULL_SWEEPS = 4
MSEED_SEEDS, MSEED_ITERS, MSEED_SMALL = (0, 1, 2), 2, (50_000, 10_000)
MSEED_RTOL = 1e-4  # seed k vs the single flat fit: float32 atomics on both
# 700k raw rows over synth_foodcom_raw's default ids: 369,106 training
# ratings after preprocessing, over the 300k edges from which "auto" takes
# the blocked engines.  Its default 1.13M rows (706k ratings) kept this
# phase at 52-54 s, past the new phases' budget (PERF.md, PR 12).
REPRO_RAW, REPRO_USERS, REPRO_ITEMS, REPRO_MIN_TRAIN = 700_000, 25_076, 178_265, 300_000
# The kernels each mid-size CLI fit must launch, and no other.  K2 is not
# among them: the layout has head tiers only from 4M ratings on
# (data/blocked.py::_pick_tiers), so it runs in train_full's full-width
# fit, not at the mid size or in the reproduction's clone.
CLI_KERNELS = {"gaussian": {"K3", "K4"}, "gaussian_bias": {"K3", "K4", "K5"},
               "poisson": {"K1"}, "poisson_extended": {"K7", "K8"},
               "hpf_cavi": {"K1"}, "hpf_map": {"K9", "K10"}}


def _have(module: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(module) is not None


def _write_int_csv(path: str, columns: dict) -> None:
    """A CSV of non-negative integer columns with pandas' bytes
    (``to_csv(index=False)``): every field's digits at a fixed width, the
    leading zeros then dropped by one boolean selection (faster than
    pandas' own writer)."""
    mats, keeps = [], []
    for k, a in enumerate(columns.values()):
        a = np.asarray(a, dtype=np.int32)
        width = len(str(int(a.max())))
        digits = np.empty((len(a), width), dtype=np.uint8)
        q = a.copy()
        for j in range(width - 1, -1, -1):
            digits[:, j] = q % 10
            q //= 10
        mats.append(digits + np.uint8(ord("0")))
        keep = a[:, None] >= 10 ** np.arange(width - 1, -1, -1, dtype=np.int32)
        keep[:, -1] = True
        keeps.append(keep)
        mats.append(np.full((len(a), 1), ord("," if k < len(columns) - 1 else "\n"),
                            dtype=np.uint8))
        keeps.append(np.ones((len(a), 1), dtype=bool))
    body = np.concatenate(mats, axis=1)[np.concatenate(keeps, axis=1)]
    with open(path, "wb") as f:
        f.write((",".join(columns) + "\n").encode())
        f.write(body.tobytes())


def _write_splits(processed: str, splits: dict) -> float:
    """interactions_{train,validation,test}.csv (u, i, rating) and a
    dict_i.csv (recipe_id, i) into ``processed``; returns the seconds."""
    os.makedirs(processed, exist_ok=True)
    t0 = time.perf_counter()
    for name, (u, i, x) in splits.items():
        _write_int_csv(os.path.join(processed, f"interactions_{name}.csv"),
                       {"u": u, "i": i, "rating": x.astype(np.int64)})
    n_items = int(max(s[1].max() for s in splits.values())) + 1
    _write_int_csv(os.path.join(processed, "dict_i.csv"),
                   {"recipe_id": 7 + 10 * np.arange(n_items), "i": np.arange(n_items)})
    return time.perf_counter() - t0


def _launched(counters) -> dict:
    return {k: c.count for k, c in counters.items() if c.count}


def _check_kernels(label, counters, want):
    """``want``: the set of kernels that launched, or their exact counts."""
    got = _launched(counters)
    if (set(got) if isinstance(want, set) else got) != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return got


def _mid_data():
    """The mid-size splits: Zipf ids (``synth``, seed 2), 20k validation
    and 20k test ratings drawn past the id-coverage prefix."""
    from pmf_tpu_torch.data.synthetic import synth

    u, i, x = synth(MID_USERS, MID_ITEMS, MID_NNZ, seed=2)
    held = MID_USERS + np.random.default_rng(3).choice(
        MID_NNZ - MID_USERS, size=2 * MID_HELD, replace=False)
    is_train = np.ones(MID_NNZ, dtype=bool)
    is_train[held] = False
    pick = lambda m: (u[m], i[m], x[m])  # noqa: E731
    return {"train": pick(is_train), "validation": pick(held[:MID_HELD]),
            "test": pick(held[MID_HELD:])}


def phase_cli(train, val, smi):
    """The CLIs on the card.  At full width: phase data's splits written as
    processed CSVs and read back through ``data.pipeline.load_all_splits``
    (equal), then ``train_full.main --model hpf_cavi`` at K=20 for 4
    sweeps (K1, K2) with its exports checked against a host recomputation.
    At the mid size (2M ratings, 40k x 12k, over the 300k cutover):
    ``run_single.main`` for all six models, ``compare`` with ranking,
    ``tune.main`` with 3 seeds a trial and ``best_k`` with 3 seeds over 3
    K; each fit's kernels checked from the launch counters.  The CLIs' layout
    cache starts empty here, so train_full's fit builds and writes its
    layout, as a user's first run does."""
    import contextlib
    import shutil

    import pandas as pd
    import torch

    from pmf_tpu_torch import config as cfg_io
    from pmf_tpu_torch.cli import best_k, compare, run_single, train_full, tune
    from pmf_tpu_torch.data import layout_cache
    from pmf_tpu_torch.data.pipeline import load_all_splits
    from pmf_tpu_torch.models import (
        GaussianMFConfig, HPFConfig, HPFMapConfig, PoissonMFConfig)

    plots = _have("matplotlib")
    root = _fresh_dir("cli")
    os.environ[layout_cache.ENV_VAR] = _fresh_dir("cli_layouts")
    try:
        # -- full width: CSVs, then train_full.
        half = len(val[0]) // 2
        splits = {"train": train, "validation": tuple(a[:half] for a in val),
                  "test": tuple(a[half:] for a in val)}
        processed = os.path.join(root, "data", "processed")
        sample = os.path.join(root, "sample.csv")
        cut = {"u": train[0][:100_000], "i": train[1][:100_000],
               "rating": train[2][:100_000].astype(np.int64)}
        _write_int_csv(sample, cut)
        pd.DataFrame(cut).to_csv(sample + ".pd", index=False)
        with open(sample, "rb") as mine, open(sample + ".pd", "rb") as theirs:
            if mine.read() != theirs.read():
                raise AssertionError("cli: the CSV writer's bytes differ from pandas'")
        t_write = _write_splits(processed, splits)
        mb = _dir_mb(processed)
        t0 = time.perf_counter()
        frames = load_all_splits(processed)
        t_read = time.perf_counter() - t0
        for name, df in zip(splits, frames):
            u, i, x = splits[name]
            if not (np.array_equal(df["u"], u) and np.array_equal(df["i"], i)
                    and np.array_equal(df["rating"], x.astype(np.float64))):
                raise AssertionError(f"cli: {name} read back differs from the arrays")
        del frames
        log(f"  CSVs: {len(train[0])} + {half} + {len(val[0]) - half} rows, {mb:.1f} MB "
            f"written in {t_write:.2f} s, read by load_all_splits in {t_read:.2f} s "
            f"(equal) | {smi}")
        phase_native(processed, train, smi)

        hp = os.path.join(root, "best_hyperparams.txt")
        cfg_io.write_best_hyperparams({cfg_io.HPF_CAVI_KEY: HPFConfig(
            n_factors=K, max_iter=TRAIN_FULL_SWEEPS, tol=None)}, hp)
        out = os.path.join(root, "data")
        counters = reset_counters()
        t0 = time.perf_counter()
        models = train_full.main(["--model", "hpf_cavi", "--processed_dir", processed,
                                  "--data_dir", out, "--hyperparams", hp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        model = models["hpf_cavi"]
        n_tiers = len(model.blocked.head or ())
        got = _check_kernels("cli train_full", counters, {
            "K1": 2 * TRAIN_FULL_SWEEPS, "K2": 2 * n_tiers * TRAIN_FULL_SWEEPS})
        if n_tiers == 0 or model.n_sweeps != TRAIN_FULL_SWEEPS:
            raise AssertionError(f"cli train_full: {model.n_sweeps} sweeps, {n_tiers} tiers")
        emb = os.path.join(out, "embeddings", "hpf_cavi")
        users = pd.read_csv(os.path.join(emb, "user_embeddings.csv")).to_numpy()
        items = pd.read_csv(os.path.join(emb, "item_embeddings.csv"))
        preds = pd.read_csv(os.path.join(out, "predictions", "hpf_cavi",
                                         "test_predictions.csv"))
        if users.shape != (N_USERS, K) or items.shape != (N_ITEMS, K + 1) \
                or items.columns[0] != "recipe_id" or len(preds) != len(val[0]) - half:
            raise AssertionError(f"cli train_full: exports {users.shape}, {items.shape}, "
                                 f"{len(preds)} predictions")
        if not np.array_equal(items["recipe_id"], 7 + 10 * np.arange(N_ITEMS)):
            raise AssertionError("cli train_full: item rows lost the recipe-id map")
        pu, pi = preds["u"].to_numpy(), preds["i"].to_numpy()
        host = np.sum(users[pu] * items.to_numpy()[pi, 1:], axis=1) - 1.0
        err = float(np.max(np.abs(preds["y_pred"].to_numpy() - host)
                           / np.maximum(np.abs(host), 1.0)))
        if not np.all(np.isfinite(users)) or err > 1e-5:
            raise AssertionError(f"cli train_full: y_pred vs the host's dot: {err}")
        log(f"  train_full --model hpf_cavi: {N_USERS}x{N_ITEMS}, {len(train[0])} "
            f"ratings, K={K}, {model.n_sweeps} sweeps: {wall:.1f} s wall (CSV read "
            f"included; the layout built and written to an empty cache), fit "
            f"{model.fit_seconds:.1f} s, export "
            f"{model.export_seconds:.1f} s ({_dir_mb(emb):.1f} MB of embeddings) | "
            f"launches {got} | {n_tiers} tiers | y_pred vs host dot "
            f"{err:.2e} | {smi}")
        del models, model, users, items, preds
        shutil.rmtree(os.path.join(root, "data"))
        gc_cuda()

        # -- mid size: run_single, compare, tune, best_k.
        t_mid = time.perf_counter()
        mid = _mid_data()
        processed = os.path.join(root, "mid", "processed")
        _write_splits(processed, mid)
        base = ["--processed_dir", processed]
        plain = {}  # the runs phase torchrun repeats under a mesh
        for name in sorted(run_single.DEFAULTS):
            extra = (["--engine", "blocked_high", "--max_iter", "1"] if name == "hpf_map"
                     else ["--max_iter", str(CLI_ITERS)])
            if name in TORCHRUN_MODELS:
                extra = ["--engine", "blocked_high", *extra]
            counters = reset_counters()
            t0 = time.perf_counter()
            res = run_single.main(["--model", name, *base, *extra])
            torch.cuda.synchronize()
            model = res["_model"]
            got = _check_kernels(f"cli run_single {name}", counters, CLI_KERNELS[name])
            if name in TORCHRUN_MODELS:
                plain[name] = {"argv": ["--model", name, *base, *extra], "launches": got,
                               "metrics": {k: res[k] for k in CLI_METRICS},
                               "state": {k: v.clone() for k, v in model.state.items()}}
                if name == "hpf_cavi":
                    from pmf_tpu_torch.utils.checkpoint import save_model

                    save_model(model, os.path.join(root, "mid", "hpf_ckpt"))
            if not all(np.isfinite(res[f"{s}_rmse"]) for s in ("train", "val", "test")):
                raise AssertionError(f"cli run_single {name}: {res}")
            log(f"  run_single {name}: engine {model.engine_used}, "
                f"{time.perf_counter() - t0:.1f} s wall, fit {res['fit_seconds']:.1f} s | "
                f"val RMSE {res['val_rmse']:.6f} | launches {got}")
            del res, model
        gc_cuda()
        phase_torchrun(os.path.join(root, "mid"), plain, smi)
        del plain
        gc_cuda()

        hp = os.path.join(root, "mid", "best_hyperparams.txt")
        small = dict(n_factors=K, max_iter=CLI_ITERS, verbose=False)
        cfg_io.write_best_hyperparams({
            cfg_io.GAUSSIAN_KEY: GaussianMFConfig(**small, sigma2=0.5, eta_theta2=0.1,
                                                  eta_beta2=0.01, eta_bias2=0.01,
                                                  use_bias=True),
            cfg_io.POISSON_KEY: PoissonMFConfig(**small),
            cfg_io.HPF_CAVI_KEY: HPFConfig(**small),
            cfg_io.HPF_MAP_KEY: HPFMapConfig(n_factors=K, epochs=1, batch_size=4096,
                                             verbose=False, engine="blocked_high"),
        }, hp)
        counters = reset_counters()
        t0 = time.perf_counter()
        if plots:
            table = compare.main([*base, "--hyperparams", hp, "--ranking",
                                  "--plot", os.path.join(root, "mid", "cmp.png"),
                                  "--params_out", os.path.join(root, "mid", "cmp.txt")])
        else:
            log("  compare: matplotlib is not installed here, so compare_models "
                "(compare.main's fits, without its plot) runs in place of compare.main")
            mid_frames = load_all_splits(processed)
            table, _ = compare.compare_models(*mid_frames, cfg_io.load_best_hyperparams(hp),
                                              ranking=True)
        if table is None or len(table) != 4 or not np.all(
                np.isfinite(table[["test_rmse", "test_recall@10"]].to_numpy())):
            raise AssertionError(f"cli compare: {table}")
        got = _check_kernels("cli compare", counters,
                             {"K1", "K3", "K4", "K5", "K9", "K10"})
        log(f"  compare --ranking: 4 models in {time.perf_counter() - t0:.1f} s | "
            + "; ".join(f"{r['model']}: test RMSE {r['test_rmse']:.4f}, recall@10 "
                        f"{r['test_recall@10']:.4f}, fit {r['fit_seconds']:.1f} s"
                        for _, r in table.iterrows()) + f" | launches {got}")

        t0 = time.perf_counter()
        tuned = tune.main([*base, "--n_trials", "2", "--seeds_per_trial", "3",
                           "--out", os.path.join(root, "mid", "tuned.txt")])
        if sorted(tuned) != sorted(tune.ARTIFACT_KEY.values()):
            raise AssertionError(f"cli tune: {sorted(tuned)}")
        log(f"  tune --n_trials 2 --seeds_per_trial 3: {time.perf_counter() - t0:.1f} s | "
            + "; ".join(f"{k}: K={c.n_factors}, seed {c.random_state}"
                        for k, c in tuned.items()))

        t0 = time.perf_counter()
        ks = [10, 20, 30]
        if plots:
            with contextlib.chdir(root):  # its figures go under ./reports
                rows, best = best_k.main([*base, "--model", "hpf_cavi", "--k_min", "10",
                                          "--k_max", "30", "--k_step", "10", "--max_iter",
                                          str(CLI_ITERS), "--seeds", "3"])
        else:
            log("  best_k: matplotlib is not installed here, so best_k.sweep "
                "(best_k.main's fits, without its plots) runs in place of best_k.main")
            rows = best_k.sweep("hpf_cavi", *mid_frames[:2], ks, max_iter=CLI_ITERS,
                                seeds=3)
            best = max(rows, key=lambda r: r["val_lpl"])
        if [r["K"] for r in rows] != ks or not all(
                np.isfinite(r["val_lpl"]) and len(r["per_seed"]) == 3 for r in rows):
            raise AssertionError(f"cli best_k: {rows}")
        log(f"  best_k hpf_cavi --seeds 3, K in {ks}: {time.perf_counter() - t0:.1f} s | "
            + "; ".join(f"K={r['K']}: val LPL {r['val_lpl']:.1f}" for r in rows)
            + f" | best K {best['K']}")
        log(f"phase cli: ok | full-width CSVs {t_write:.1f} s write / {t_read:.1f} s "
            f"read, train_full {wall:.1f} s; mid size {MID_NNZ} ratings: six run_single, "
            f"compare, tune, best_k in {time.perf_counter() - t_mid:.1f} s | {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


TORCHRUN_MODELS = ("hpf_cavi", "gaussian_bias")
TORCHRUN_SECONDS = 400  # the child's limit, its process start included
CLI_METRICS = [f"{s}_{m}" for s in ("train", "val", "test") for m in ("rmse", "macro_mae")]


def torchrun_child(workdir: str) -> int:
    """The child of phase torchrun, one rank under ``torch.distributed.run``:
    each command of ``workdir/commands.json`` with ``--mesh_devices 1``
    appended, the launch counters reset just before each and read just
    after; rank 0 writes each fit's state (npz), metrics and launches and
    prints them with the recommend CLI's launches as one JSON line."""
    import torch

    from pmf_tpu_torch.cli import recommend, run_single

    with open(os.path.join(workdir, "commands.json")) as f:
        commands = json.load(f)
    out = {}
    for name, argv in commands["run_single"].items():
        counters = reset_counters()
        res = run_single.main([*argv, "--mesh_devices", "1"])
        torch.cuda.synchronize()
        out[name] = {"metrics": {k: res[k] for k in CLI_METRICS},
                     "launches": _launched(counters)}
        np.savez(os.path.join(workdir, f"mesh_{name}.npz"),
                 **{k: v.cpu().numpy() for k, v in res["_model"].state.items()})
    counters = reset_counters()
    recommend.main([*commands["recommend"], "--mesh_devices", "1"])
    torch.cuda.synchronize()
    out["recommend"] = {"launches": _launched(counters)}
    if int(os.environ.get("RANK", 0)) == 0:
        with open(os.path.join(workdir, "mesh.json"), "w") as f:
            json.dump(out, f)
        print(json.dumps(out), flush=True)
    return 0


def phase_torchrun(mid_dir, plain, smi):
    """The CLIs under ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` with ``--mesh_devices 1`` (NCCL at world size 1,
    ``env://``) on phase cli's mid-size data: ``run_single`` for HPF and
    the Gaussian model with biases as phase cli ran them (``plain``: their
    argv, launches, metrics and states), and ``recommend`` on the HPF
    run's checkpoint.  The child (this script's ``--torchrun-child``) must
    end with 0; its fits must launch the kernels the runs without a mesh
    launched and equal them in bits, and its recommendations CSV must equal
    the one without a mesh byte for byte."""
    import torch

    from pmf_tpu_torch.cli import recommend

    t_phase = time.perf_counter()
    wd = os.path.join(mid_dir, "torchrun")
    os.makedirs(wd)
    ckpt = os.path.join(mid_dir, "hpf_ckpt")
    rec = ["--checkpoint", ckpt]
    t0 = time.perf_counter()
    recommend.main([*rec, "--out", os.path.join(wd, "plain_rec.csv")])
    t_rec = time.perf_counter() - t0
    with open(os.path.join(wd, "commands.json"), "w") as f:
        json.dump({"run_single": {n: p["argv"] for n, p in plain.items()},
                   "recommend": [*rec, "--out", os.path.join(wd, "mesh_rec.csv")]}, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), "--torchrun-child", wd]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TORCHRUN_SECONDS)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun: the child exited {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    with open(os.path.join(wd, "mesh.json")) as f:
        got = json.load(f)
    for name, p in plain.items():
        mesh = got[name]
        if mesh["launches"] != p["launches"]:
            raise AssertionError(f"torchrun {name}: launches {mesh['launches']} under the "
                                 f"mesh, {p['launches']} without")
        with np.load(os.path.join(wd, f"mesh_{name}.npz")) as z:
            same = sorted(z.files) == sorted(p["state"]) and all(
                torch.equal(torch.from_numpy(z[k]), p["state"][k].cpu()) for k in z.files)
        if not (same and mesh["metrics"] == p["metrics"]):
            raise AssertionError(f"torchrun {name}: the mesh run differs from the run "
                                 f"without a mesh ({mesh['metrics']} vs {p['metrics']})")
        log(f"  torchrun run_single {name} --mesh_devices 1: launches {mesh['launches']} "
            f"| state and metrics equal in bits to the run without a mesh | val RMSE "
            f"{mesh['metrics']['val_rmse']:.6f}")
    with open(os.path.join(wd, "plain_rec.csv"), "rb") as a, \
            open(os.path.join(wd, "mesh_rec.csv"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("torchrun: the recommendations CSV differs from the one "
                                 "without a mesh")
    log(f"  torchrun recommend --mesh_devices 1: CSV equal byte for byte to the one "
        f"without a mesh ({t_rec:.1f} s in this process) | launches "
        f"{got['recommend']['launches']}")
    log(f"phase torchrun: ok | one child of torch.distributed.run (nccl, world size 1) "
        f"ran 2 fits and recommend in {wall:.1f} s wall (process start included) | phase "
        f"{time.perf_counter() - t_phase:.1f} s | {smi}")


def _timed_seed_sweeps(cfg, train, n_iter):
    """The pieces ``multi_seed_fit`` is made of, each vmapped sweep timed
    alone by CUDA events: (state, build_ratings seconds, sweep seconds,
    peak MiB, MiB allocated before the seeds' state)."""
    import torch

    from pmf_tpu_torch.data.coo import build_ratings
    from pmf_tpu_torch.tune import multi_seed

    t0 = time.perf_counter()
    data = build_ratings(*train, dtype=np.float32, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    state = multi_seed.stacked_init(cfg, data.n_users, data.n_items, MSEED_SEEDS, "cuda")
    step = multi_seed.vmapped_sweep(cfg, data)
    secs = []
    for _ in range(n_iter):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state = step(state)
        end.record()
        torch.cuda.synchronize()
        secs.append(start.elapsed_time(end) / 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    for key, v in state.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"mseed: {key} has non-finite values")
    return state, t_build, secs, peak_mb, base_mb


def _sweep_note(n_train, secs, peak_mb, base_mb):
    S = len(MSEED_SEEDS)
    return (f"vmapped sweeps {', '.join(f'{s:.4f}' for s in secs)} s "
            f"({2 * S * n_train / min(secs) / 1e6:.1f}M updates/s over the seeds) | "
            f"peak {peak_mb:.0f} MiB over {base_mb:.0f} MiB before")


def phase_mseed(train, val, smi):
    """``tune.multi_seed`` on the card.  At the tuner's size (50k train /
    10k val drawn from phase data): ``multi_seed_fit`` for S=3 HPF seeds
    at K=20, each equal to the port's single flat fit of that seed to 1e-4
    relative per element, the seeds different.  At that size and on the
    full 24.9M training set: each vmapped sweep timed by CUDA events, the
    peak memory, a finite state."""
    import dataclasses

    import torch

    from pmf_tpu_torch.models.hpf import HPF, HPFConfig
    from pmf_tpu_torch.tune import multi_seed

    rng = np.random.default_rng(42)
    tr_idx = rng.choice(len(train[0]), size=MSEED_SMALL[0], replace=False)
    va_idx = rng.choice(len(val[0]), size=MSEED_SMALL[1], replace=False)
    tr = tuple(a[tr_idx] for a in train)
    va = tuple(a[va_idx] for a in val)
    cfg = HPFConfig(n_factors=K, max_iter=3, tol=None, verbose=False, engine="flat")
    counters = reset_counters()
    t0 = time.perf_counter()
    stacked, metrics = multi_seed.multi_seed_fit(cfg, tr, va, seeds=MSEED_SEEDS)
    torch.cuda.synchronize()
    t_small = time.perf_counter() - t0
    worst = 0.0
    for k, seed in enumerate(MSEED_SEEDS):
        solo = HPF(dataclasses.replace(cfg, random_state=seed)).fit(tr, va)
        for key, v in solo.state.items():
            _, rel = compare(stacked[key][k], v)
            worst = max(worst, rel)
        if abs(metrics[k]["val_rmse"] - solo.fit_history[-1]["val_rmse"]) > 1e-4:
            raise AssertionError(f"mseed: seed {seed} val RMSE {metrics[k]} vs the "
                                 f"single fit's {solo.fit_history[-1]}")
    if worst > MSEED_RTOL:
        raise AssertionError(f"mseed: a seed differs from its single fit by {worst:.3e}")
    if torch.equal(stacked["a_theta"][0], stacked["a_theta"][1]):
        raise AssertionError("mseed: seeds 0 and 1 gave the same state")
    _check_kernels("mseed", counters, {})  # the flat sweep: no kernel
    del stacked, solo
    gc_cuda()
    _, _, secs, peak_mb, base_mb = _timed_seed_sweeps(cfg, tr, cfg.max_iter)
    log(f"  multi_seed_fit HPF S={len(MSEED_SEEDS)} K={K} on {MSEED_SMALL[0]} / "
        f"{MSEED_SMALL[1]} ratings, 3 sweeps: {t_small:.2f} s | each seed vs its single "
        f"flat fit: max relative error {worst:.3e} (gate {MSEED_RTOL:g}) | val RMSE "
        + ", ".join(f"{m['val_rmse']:.6f}" for m in metrics) + " | "
        + _sweep_note(MSEED_SMALL[0], secs, peak_mb, base_mb))
    gc_cuda()

    state, t_build, secs, peak_mb, base_mb = _timed_seed_sweeps(cfg, train, MSEED_ITERS)
    log(f"phase mseed: ok | full {len(train[0])} ratings, S={len(MSEED_SEEDS)}, K={K}: "
        f"build_ratings {t_build:.1f} s, " + _sweep_note(len(train[0]), secs, peak_mb, base_mb)
        + f" (total {torch.cuda.get_device_properties(0).total_memory / 2**20:.0f}) | {smi}")
    del state
    gc_cuda()


def phase_repro(smi):
    """``reproduce.main`` on a synthetic Food.com clone whose compare and
    train_full fits take 369k training edges (blocked engines: K1, K3,
    K4, K5), one tuner trial a model; the artifact set of
    ``tests/test_reproduce.py`` checked.  Without matplotlib the plotting
    stages run as their compute functions (said on a line of their own)."""
    import json
    import shutil

    import torch

    from pmf_tpu_torch import config as cfg_io
    from pmf_tpu_torch.analysis import exploratory, forecasts
    from pmf_tpu_torch.cli import compare, reproduce
    from pmf_tpu_torch.data.pipeline import load_all_splits

    wd = _fresh_dir("repro")
    plots = _have("matplotlib")
    try:
        argv = ["--workdir", wd, "--synthetic_clone", str(REPRO_RAW), "--clone_users",
                str(REPRO_USERS), "--clone_items", str(REPRO_ITEMS), "--n_trials", "1"]
        counters = reset_counters()
        t0 = time.perf_counter()
        if plots:
            res = reproduce.main(argv)
        else:
            log("  repro: matplotlib is not installed here, so reproduce.main runs "
                "the stages preprocess, tune and train_full, and compare_models, "
                "forecasts.write_report and exploratory.split_stats (compare's and "
                "the analysis stage's computations, without their plots) run after it")
            res = reproduce.main([*argv, "--stages", "preprocess", "tune", "train_full"])
            processed = os.path.join(wd, "data", "processed")
            frames = load_all_splits(processed)
            hp = cfg_io.load_best_hyperparams(os.path.join(wd, "best_hyperparams.txt"))
            table, used = compare.compare_models(*frames, hp)
            if table is None or len(table) != 4:
                raise AssertionError(f"repro compare: {table}")
            compare.write_params(used, os.path.join(wd, "model_comparison_params.txt"))
            forecasts.write_report(forecasts.collect(os.path.join(wd, "data")),
                                   os.path.join(wd, "reports"))
            exploratory.split_stats(*frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _check_kernels("repro", counters, {"K1", "K3", "K4", "K5"})
        want = ["data/processed/interactions_train.csv", "data/processed/dict_i.csv",
                "best_hyperparams.txt", "model_comparison_params.txt",
                "data/embeddings/gaussian_mf/user_embeddings.csv",
                "data/embeddings/gaussian_mf/config.txt",
                "data/predictions/hpf_cavi/test_predictions.csv",
                "reports/forecast_metrics.csv", "reports/forecast_analysis.md",
                "reproduce_manifest.json"]
        if plots:
            want.append("model_comparison_plots.png")
        missing = [rel for rel in want if not os.path.exists(os.path.join(wd, rel))]
        with open(os.path.join(wd, "reproduce_manifest.json")) as f:
            manifest = json.load(f)
        n_train = sum(1 for _ in open(os.path.join(
            wd, "data", "processed", "interactions_train.csv"))) - 1
        if missing or manifest["stages"]["train_full"]["embeddings"] != [
                "gaussian_mf", "hpf_cavi", "hpf_pytorch", "poisson_mf"] or n_train < REPRO_MIN_TRAIN:
            raise AssertionError(f"repro: missing {missing}, manifest {manifest['stages']}, "
                                 f"{n_train} training rows")
        log(f"phase repro: ok | clone of {REPRO_RAW} raw rows -> {n_train} training "
            f"ratings | {wall:.1f} s wall | {len(want)} artifacts present"
            + ("" if plots else " (no plot: matplotlib absent)")
            + f" | launches {got} | {smi}")
    finally:
        shutil.rmtree(wd, ignore_errors=True)


# ---------------------------------------- K2 fast, the engines, host ingest --

# K2 "fast" vs its plain version on the real tiers: float sums in another
# order, and rare one-ulp bf16 flips of W near a rounding boundary (the
# kernel divides by __fdividef).
FAST_RTOL = 1e-3
# On small shapes a row may hold a few cells, so a flip shows whole: each
# element's W terms are positive, so flips move it by at most one bf16 step
# of W, 2^-8 relative, beside the float sums' order (RTOL).
FAST_SMALL_RTOL = 2.0 ** -8 + RTOL
K2_NOTE_P_MS = (2.7607 + 2.7866 + 2.7920 + 2.7749) / 4  # PERF.md note (p), K2 high
FASTFIT_RMSE = 5e-3  # the reference's test_fast_engine_converges_like_flat
FAST_EXT_SWEEPS = FAST_GAUSS_SWEEPS = 2
CHUNKED_SWEEPS = 2
# flat vs flat_chunked in float64, where the atomics' order no longer shows.
CHUNKED_RTOL = 1e-5


def phase_k2fast(blocked, k2):
    """K2's one-term instance (precision "fast") on the four real tiers,
    both sides, at K=20 vs its plain version (gate FAST_RTOL, equal bits on
    a repeat): ms, the bound's three lines, stage bytes, CTAs/SM and the
    error against the float64 plain version at "high" (the bf16 level);
    the high instance's time against PERF.md note (p); then at every K
    where the plan changes (K2small's shapes and K = 50, 128) vs the plain
    version in float64."""
    import torch

    from pmf_tpu_torch.ops.cavi_edge import RATE_FLOOR
    from pmf_tpu_torch.ops.dense_head import (
        fused_alloc_tier, fused_alloc_tier_plain, plan_launch)

    e_user, e_item = _new_space_tables(blocked)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    lines, worst_high, worst_norm = {}, 0.0, 0.0
    for t, h in enumerate(blocked.head or ()):
        theta_h = e_user[h.row_start : h.row_start + h.hu].contiguous()
        beta_h = torch.nn.functional.pad(e_item[: h.hi], (0, 0, 0, h.hip - h.hi))
        chunk = max(1, (1 << 27) // h.hip)
        m_f32, has_lo = h.m.dtype == torch.float32, h.x_lo is not None
        cells = (h.x_hi, h.m, h.x_lo)
        for item_side in (False, True):
            kw = dict(rate_floor=RATE_FLOOR, item_side=item_side)

            def fast(kw=kw):
                return fused_alloc_tier(theta_h, beta_h, *cells, precision="fast", **kw)

            def plain(kw=kw):
                return fused_alloc_tier_plain(theta_h, beta_h, *cells, row_chunk=chunk,
                                              precision="fast", **kw)

            got, again = fast(), fast()
            abs_err, rel_err = compare(got, plain())
            exact = fused_alloc_tier_plain(theta_h.double(), beta_h.double(), *cells,
                                           row_chunk=chunk, **kw)
            high_abs, high_rel = compare(got, exact)
            high_norm = high_abs / float(exact.abs().max())
            del exact
            ms = cuda_ms(fast)
            plain_ms = cuda_ms(plain, reps=3)
            stored_bytes = sum(a.nbytes for a in cells if a is not None)
            cells_bytes = stored_bytes * h.hi // h.hip
            n_bytes = cells_bytes + theta_h.nbytes + beta_h[: h.hi].nbytes + got.nbytes
            tier_lines = _k2_bound(h.hu, h.hip, m_f32, has_lo, n_bytes, fast=True)
            by = max(tier_lines, key=tier_lines.get)
            plan = plan_launch(h.hu, h.hip, K, item_side, m_f32, has_lo, n_sm, fast=True)
            side = "item" if item_side else "user"
            log(f"  K2fast tier {t} ({h.row_start}, {h.hu}, {h.hi}) {side}: max abs err "
                f"{abs_err:.3e} rel {rel_err:.3e} (tol {FAST_RTOL}) | vs float64 high: "
                f"rel {high_rel:.3e}, {high_norm:.3e} of the largest | kernel {ms:.4f} ms "
                f"| plain {plain_ms:.4f} ms | bound {tier_lines[by]:.4f} ms ({by}) | "
                f"cells {cells_bytes / ms / 1e6:.1f} GB/s | "
                f"{_k2_plan_note(plan, K, item_side, m_f32, fast=True)}")
            if not rel_err <= FAST_RTOL:
                raise AssertionError(f"K2fast tier {t} {side}: relative error "
                                     f"{rel_err} > {FAST_RTOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"K2fast tier {t} {side}: two launches differ")
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["max_abs_err"] = max(res["max_abs_err"], abs_err)
            worst_high, worst_norm = max(worst_high, high_rel), max(worst_norm, high_norm)
            for name, v in tier_lines.items():
                lines[name] = lines.get(name, 0.0) + v
    by = max(lines, key=lines.get)
    res["bound_ms"] = lines[by]
    res["bound_by"] = "bytes" if by == "bytes" else "operations"
    log(f"  K2 high {k2['ms']:.4f} ms a sweep against PERF.md note (p)'s "
        f"{K2_NOTE_P_MS:.4f}: {k2['ms'] / K2_NOTE_P_MS - 1:+.1%}; fast / high "
        f"{res['ms'] / k2['ms']:.3f}")

    gen = torch.Generator(device="cuda").manual_seed(17)
    worst, n_cases = 0.0, 0
    for rows in K2SMALL_ROWS:
        for hip in K2SMALL_HIPS:
            hi = hip - 13
            for kind in ("integer", "fractional", "m_f32"):
                x_hi, x_lo, m = _k2small_cells(kind, rows, hip, hi, gen)
                for k in K2SMALL_KS + BIGK_KS:
                    theta = 0.02 + torch.rand(rows, k, generator=gen, device="cuda")
                    theta[::5] *= 1e-3  # rates under the floor
                    beta = 0.02 + torch.rand(hip, k, generator=gen, device="cuda")
                    beta[hi:] = 0
                    for item_side in (False, True):
                        kw = dict(rate_floor=K2SMALL_FLOOR, item_side=item_side,
                                  precision="fast")
                        got = fused_alloc_tier(theta, beta, x_hi, m, x_lo, **kw)
                        again = fused_alloc_tier(theta, beta, x_hi, m, x_lo, **kw)
                        ref = fused_alloc_tier_plain(theta.double(), beta.double(),
                                                     x_hi, m, x_lo, **kw)
                        _, rel = compare(got, ref)
                        tag = (f"K2fast small rows {rows} hip {hip} K {k} {kind} "
                               f"{'item' if item_side else 'user'}")
                        if got.shape != ref.shape or not rel <= FAST_SMALL_RTOL:
                            raise AssertionError(f"{tag}: relative error {rel}")
                        if not torch.equal(got, again):
                            raise AssertionError(f"{tag}: two launches differ in bits")
                        worst = max(worst, rel)
                        n_cases += 1
    log(f"phase k2fast: ok | per sweep: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({by}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in lines.items())
        + f") | vs float64 high: worst rel {worst_high:.3e}, {worst_norm:.3e} of the "
        f"largest | {n_cases} small cases (K {K2SMALL_KS + BIGK_KS}) vs plain float64: "
        f"worst rel {worst:.3e} (tol {FAST_SMALL_RTOL:.3e}), repeats equal in bits")
    return res


def _parent_op(name):
    """The ``--parent`` tree's ops/<name>.py, launching through that tree's
    build module (its kernels, its own launch counters)."""
    import importlib.util

    path = os.path.join(os.path.abspath(PARENT["dir"]), "pmf_tpu_torch", "ops",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass of the module looks itself up there
    spec.loader.exec_module(mod)
    mod._build = PARENT["build"]
    return mod


K2_AB_TURNS = ("parent", "this", "this", "parent")


def phase_k2_parent(blocked):
    """With ``--parent``: K2 of this tree and of the parent tree at K,
    K_WIDE and K_HUGE on the real tiers, both precisions, every tier and
    side (random positive tables from a seed), timed a sweep at a time by
    CUDA events in turns parent, this, this, parent.  At "high" the two
    trees' outputs agree within RTOL; at "fast" their worst relative
    difference is logged (each holds FAST_SMALL_RTOL against the plain
    version in phase wide_poisson).  Returns {(k, precision): {turn label:
    ms}}."""
    import torch

    from pmf_tpu_torch.ops import dense_head

    trees = {"this": dense_head, "parent": _parent_op("dense_head")}
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for k in (K, K_WIDE, K_HUGE):
        reps = TIMING_REPS if k <= K_WIDE else 3
        tiers = []
        for h in blocked.head or ():
            beta = torch.nn.functional.pad(_pos(gen, h.hi, k), (0, 0, 0, h.hip - h.hi))
            tiers.append((_pos(gen, h.hu, k), beta, (h.x_hi, h.m, h.x_lo)))
        for prec in ("high", "fast"):
            def sweep(mod, prec=prec):
                return [mod.fused_alloc_tier(th, be, *cells, rate_floor=1e-10,
                                             item_side=side, precision=prec)
                        for th, be, cells in tiers for side in (False, True)]

            worst = max(compare(a, b)[1]
                        for a, b in zip(sweep(trees["this"]), sweep(trees["parent"])))
            if prec == "high" and not worst <= RTOL:
                raise AssertionError(f"k2 parent K={k}: this tree and the parent differ "
                                     f"by {worst} > {RTOL}")
            turns = [cuda_ms(lambda t=t: sweep(trees[t]), reps=reps) for t in K2_AB_TURNS]
            mean = {t: float(np.mean([ms for u, ms in zip(K2_AB_TURNS, turns) if u == t]))
                    for t in ("parent", "this")}
            out[(k, prec)] = mean
            log(f"  k2 parent K={k} {prec}: turns "
                + ", ".join(f"{t} {ms:.4f}" for t, ms in zip(K2_AB_TURNS, turns))
                + f" ms a sweep | this / parent {mean['this'] / mean['parent'] - 1:+.2%} | "
                f"worst rel difference {worst:.3e}")
    log(f"phase k2 parent: ok | {PARENT['dir']} | K {K}, {K_WIDE}, {K_HUGE}, both "
        f"precisions, in turns {', '.join(K2_AB_TURNS)}")
    return out


def _counts_on_card(train, n_users=N_USERS, n_items=N_ITEMS):
    import torch

    return [torch.bincount(torch.from_numpy(ids).cuda(), minlength=n).float()
            for ids, n in ((train[0], n_users), (train[1], n_items))]


def phase_fastfit(train, val, gtrain, gval, high_rmse, smi):
    """The "blocked_fast" fits at full width with the layout cache on (the
    HPF and extended Poisson layouts, of phase cache's data, read from its
    entry; the Gaussian one built and written): HPF for FIT_SWEEPS sweeps,
    extended Poisson and exact Gaussian for 2 each, with the launch
    counters reset just before and read just after; each val RMSE within
    FASTFIT_RMSE of the blocked_high fit's at the same sweep (phases fit,
    pfit, gfit); each model's busy ms a sweep at "fast" and at "high" under
    the profiler; and one HPF "blocked_mid" sweep equal in bits to a
    "blocked_high" one."""
    import torch

    from pmf_tpu_torch.data import layout_cache
    from pmf_tpu_torch.models import gaussian_mf as gm
    from pmf_tpu_torch.models import hpf
    from pmf_tpu_torch.models.base import blocked_precision
    from pmf_tpu_torch.models.poisson_mf import PoissonMF, PoissonMFConfig

    runs = {
        "hpf": lambda: hpf.HPF(hpf.HPFConfig(
            n_factors=K, max_iter=FIT_SWEEPS, tol=None, verbose=False,
            engine="blocked_fast")).fit(train, val),
        "extended": lambda: PoissonMF(PoissonMFConfig(
            n_factors=K, max_iter=FAST_EXT_SWEEPS, tol=None, verbose=False,
            engine="blocked_fast", extended=True)).fit(train, val),
        "gaussian": lambda: gm.GaussianMF(gm.GaussianMFConfig(
            n_factors=K, max_iter=FAST_GAUSS_SWEEPS, tol=None, verbose=False,
            engine="blocked_fast")).fit(gtrain, gval, global_mean=0.0),
    }
    models, launches, walls, hits = {}, {}, {}, {}
    cdir = os.environ[layout_cache.ENV_VAR]
    counters = reset_counters()
    before = {k: 0 for k in counters}
    for name, run in runs.items():
        n_entries = len(os.listdir(cdir))
        t0 = time.perf_counter()
        models[name] = run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        hits[name] = len(os.listdir(cdir)) == n_entries
        now = {k: c.count for k, c in counters.items()}
        launches[name] = {k: v - before[k] for k, v in now.items() if v - before[k]}
        before = now
    total = _launched(counters)
    tiers = {n: len(m.blocked.head or ()) for n, m in models.items()}
    sweeps = {n: m.n_sweeps for n, m in models.items()}
    want = {"hpf": {"K1": 2 * sweeps["hpf"], "K2fast": 2 * tiers["hpf"] * sweeps["hpf"]},
            "extended": {"K7": 2 * sweeps["extended"], "K8": 2 * sweeps["extended"],
                         "K2fast": 2 * tiers["extended"] * sweeps["extended"]},
            "gaussian": {k: 2 * sweeps["gaussian"] for k in ("K3", "K4", "K5")}}
    for name, m in models.items():
        rmses = [rec["val_rmse"] for rec in m.fit_history]
        ref = high_rmse[name][: len(rmses)]
        gap = max(abs(a - b) for a, b in zip(rmses, ref))
        state_ok = all(bool(torch.all(torch.isfinite(v))) for v in m.state.values())
        how = "read from the cache" if hits[name] else "built and written to the cache"
        log(f"  fastfit {name}: {m.n_sweeps} sweeps in {walls[name]:.1f} s wall (layout "
            f"{how}) | launches {launches[name]} | val RMSE "
            + " -> ".join(f"{r:.6f}" for r in rmses) + " | blocked_high "
            + " -> ".join(f"{r:.6f}" for r in ref) + f" | largest gap {gap:.2e} | {smi}")
        if launches[name] != want[name] or (name != "gaussian" and tiers[name] == 0):
            raise AssertionError(f"fastfit {name}: launches {launches[name]}, expected "
                                 f"{want[name]} ({tiers[name]} tiers)")
        if m.engine_used != "blocked_fast" or not state_ok or not gap < FASTFIT_RMSE:
            raise AssertionError(f"fastfit {name}: engine {m.engine_used}, finite "
                                 f"{state_ok}, val RMSE gap {gap} (tol {FASTFIT_RMSE})")

    # Busy time of one sweep from each fit's final state, at both precisions.
    counts = _counts_on_card(train)
    gcounts = _counts_on_card(gtrain)
    h, e, g = models["hpf"], models["extended"], models["gaussian"]
    hh = (h.config.a, h.config.a_prime, h.config.b_prime, h.config.c, h.config.c_prime,
          h.config.d_prime)
    gc = g.config
    gh = (gc.sigma2, gc.eta_theta2, gc.eta_beta2, gc.eta_bias2, gc.use_bias)
    sweep_of = {
        "hpf": lambda p: lambda: hpf.sweep_blocked(dict(h.state), h.blocked, *counts,
                                                   *hh, precision=p),
        "extended": lambda p: (lambda step: lambda: step(dict(e.state)))(
            _poisson_sweep_fn(e.config, e.blocked, train, N_USERS, N_ITEMS, "cuda",
                              precision=p)),
        "gaussian": lambda p: lambda: gm.sweep_blocked(dict(g.state), g.blocked, *gcounts,
                                                       *gh, precision=p),
    }
    expects = {"hpf": {K1_TRACE: 2, **_head_launches(h)},
               "extended": {K7_TRACE: 2, K8_TRACE: 2, **_head_launches(e)},
               "gaussian": {"::factor_kernel": 2, "gj_inverse": 2, K5_TRACE: 2}}
    busy = {}
    for name in models:
        # One sweep from the same state at both precisions: the fast head
        # moves the state by about the bf16 level.  These also make what a
        # layout keeps after its first sweep at a precision (M's planes).
        fast, high = sweep_of[name]("fast")(), sweep_of[name]("high")()
        moved = max(_normwise(fast[k], v) for k, v in high.items())
        for p in ("fast", "high"):
            busy[name, p] = profile_once(sweep_of[name](p), expects[name])[1]
        log(f"  fastfit {name}: one sweep busy {busy[name, 'fast']:.4f} ms at fast, "
            f"{busy[name, 'high']:.4f} ms at high ({busy[name, 'fast'] / busy[name, 'high']:.3f}) "
            f"| one sweep's state at fast vs high: {moved:.3e} of a tensor's largest entry")
        if not moved > 0:
            raise AssertionError(f"fastfit {name}: a fast sweep equals a high one")

    # blocked_mid computes what blocked_high does, in bits: the engines map
    # it to the same head precision.
    state = hpf.init_state(N_USERS, N_ITEMS, h.config, device="cuda")
    mid = hpf.sweep_blocked(dict(state), h.blocked, *counts, *hh,
                            precision=blocked_precision("blocked_mid"))
    high = hpf.sweep_blocked(dict(state), h.blocked, *counts, *hh,
                             precision=blocked_precision("blocked_high"))
    if not all(torch.equal(mid[k], high[k]) for k in high):
        raise AssertionError("fastfit: a blocked_mid sweep differs from blocked_high's")
    log(f"phase fastfit: ok | launches {total} | HPF blocked_mid sweep "
        f"equal in bits to blocked_high's")
    return total, busy


def _normwise(got, ref) -> float:
    """max |got - ref| / max |ref|: the error against the tensor's scale."""
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


# ------------------------------------------------------- the mesh modes --

MESH_SWEEPS = 2
DP_RTOL = 1e-6  # the data-parallel fits against the single-device ones
# The reference's own gates for its blocked ring (tests/test_tp_blocked.py):
# states 3e-4 relative / 3e-5 absolute and val RMSE within 1e-3 (HPF and
# Poisson), 2e-3 / 2e-4 (Gaussian).
TP_RTOL, TP_ATOL, TP_RMSE = 3e-4, 3e-5, 1e-3
TP_GAUSS_RTOL, TP_GAUSS_ATOL = 2e-3, 2e-4
FLAT_TP_RTOL = 1e-6  # the flat ring against the flat fit, both float64
K1RAW_TRACE = tail_trace("K1raw")


def _gate(label, got: dict, want: dict, rtol: float, atol: float) -> tuple:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; returns
    (the worst of |got - want| / (atol + rtol |want|), equal in bits)."""
    import torch

    worst, bits = 0.0, True
    for k, w in want.items():
        g = got[k].to(w.device)
        bits = bits and torch.equal(g, w)
        diff = (g.double() - w.double()).abs()
        ratio = float((diff / (atol + rtol * w.double().abs())).max())
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: {k} differs by up to {float(diff.max()):.3e} "
                                 f"(rtol {rtol}, atol {atol})")
        worst = max(worst, ratio)
    return worst, bits


def _mesh_run(label, fit, smi, want: dict):
    """One fit with the launch counters reset just before and read just
    after, the peak device memory above what was held, the wall; raises
    unless the launches are ``want(model)`` and the state finite."""
    import torch

    gc_cuda()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    model = fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launched(counters)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    expected = {k: v for k, v in want(model).items() if v}
    if launches != expected:
        raise AssertionError(f"mesh {label}: launches {launches}, expected {expected}")
    for k, v in model.state.items():
        if not bool(torch.all(torch.isfinite(v))):
            raise AssertionError(f"mesh {label}: state {k} has non-finite values")
    rmses = [rec["val_rmse"] for rec in model.fit_history]
    log(f"  mesh {label}: {len(model.fit_history)} iterations in {wall:.1f} s wall | "
        f"launches {launches} | peak {peak:.0f} MiB above the {base / 2**20:.0f} MiB "
        "held | val RMSE " + " -> ".join(f"{r:.6f}" for r in rmses) + f" | {smi}")
    return model, launches


def _tp_expect(model, kernels: dict) -> dict:
    """Launches of a TP blocked fit: ``kernels`` maps a counter to its
    launches a bucket and sweep ("tiers" for one a tier)."""
    lay = model.tp.layout
    tiers = sum(len(b.head) for b in lay.by_user + lay.by_item)
    return {k: model.n_sweeps * (tiers if n == "tiers" else n * lay.n_buckets)
            for k, n in kernels.items()}


def _tp_note(model) -> str:
    lay = model.tp.layout
    return (f"{lay.n_buckets} buckets (D={lay.n_devices}) | tiers by user "
            f"{list(getattr(lay, 'tiers_user', ()))}, by item "
            f"{list(getattr(lay, 'tiers_item', ()))}")


def _busy(label, step, expect: dict) -> float:
    """Busy ms of one more sweep of a fit, under the profiler, and its
    heaviest kernels."""
    rows, busy, wall_ms = profile_once(step, expect)
    log(f"  mesh {label}: one sweep busy {busy:.4f} ms of {wall_ms:.4f} ms window "
        f"(idle share {1 - busy / wall_ms:.1%})")
    for dev_ms, n, key in rows[:6]:
        log(f"    {dev_ms:9.4f} ms  {n:3d}x  {key[:90]}")
    return busy


def _single(cls, cfg_cls, data, fit_kw=None, **cfg):
    """A fit of K factors, no early stop; ``fit_kw`` (the mesh) to ``fit``."""
    train, val, extra = data
    return cls(cfg_cls(n_factors=K, tol=None, verbose=False, **cfg)).fit(
        train, val, **extra, **(fit_kw or {}))


def phase_mesh(train, val, gtrain, gval, fit_ref, smi):
    """The multi-device modes at world size 1 on an NCCL process group
    (``init_method`` a file under ``_smoke_tmp/``, torn down at the end),
    with the layout cache on: the data-parallel HPF fit (blocked_high,
    FIT_SWEEPS sweeps) against phase fit's; the TP blocked ring
    (``state_sharding="rows"``) for HPF, extended Poisson (the first fit
    that launches K1 "raw") and exact Gaussian, MESH_SWEEPS sweeps each,
    against the single-device blocked_high fits at the reference's gates;
    the TP flat ring for HPF against the flat fit, both float64; the
    data-parallel HPFMap (1 epoch, flat) against the single-device one;
    ``recommend_sharded`` for every user against ``recommend``.  Each fit's
    launches, peak memory and one sweep's busy time; returns the extended
    ring's launches."""
    import shutil

    import torch
    import torch.distributed as dist

    from pmf_tpu_torch.eval.recommend import build_exclusion_index
    from pmf_tpu_torch.models import gaussian_mf as gm
    from pmf_tpu_torch.models import hpf, hpf_map
    from pmf_tpu_torch.models.poisson_mf import PoissonMF, PoissonMFConfig
    from pmf_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    wd = _fresh_dir("mesh")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(wd, 'rdv')}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        pdata = (train, val, {})
        gdata = (gtrain, gval, {"global_mean": 0.0})

        # 1. Data-parallel HPF against phase fit (the same fit on one device).
        dp, _ = _mesh_run("dp hpf blocked_high", lambda: hpf.HPF(hpf.HPFConfig(
            n_factors=K, max_iter=FIT_SWEEPS, tol=None, verbose=False,
            engine="blocked_high")).fit(train, val, mesh=mesh), smi,
            lambda m: {"K1": 2 * m.n_sweeps,
                       "K2": 2 * len(m.blocked.head or ()) * m.n_sweeps})
        ref_state, ref_rmse = fit_ref
        worst, bits = _gate("dp hpf", dp.state, ref_state, DP_RTOL, 0.0)
        rmse = [rec["val_rmse"] for rec in dp.fit_history]
        if not np.allclose(rmse, ref_rmse, rtol=DP_RTOL, atol=0):
            raise AssertionError(f"mesh dp hpf: val RMSE {rmse} vs {ref_rmse}")
        _busy("dp hpf", lambda: dp.sweep_once(dict(dp.state)),
              {K1_TRACE: 2, **_head_launches(dp)})
        log(f"  mesh dp hpf vs phase fit: worst {worst:.3e} of the gate (rtol {DP_RTOL}) | "
            f"state and history equal in bits: {bits and rmse == ref_rmse}")

        # 2-4. The TP blocked ring against the single-device blocked fits.
        rings = {
            "hpf": (lambda fit_kw=None: _single(hpf.HPF, hpf.HPFConfig, pdata, fit_kw,
                                                max_iter=MESH_SWEEPS,
                                                engine="blocked_high"),
                    {"K1": 1, "K2": "tiers"}, {"K1": 2, "K2": 2}, TP_RTOL, TP_ATOL,
                    {K1_TRACE: 1, "head_user_kernel": "tiers"}),
            "extended": (lambda fit_kw=None: _single(
                PoissonMF, PoissonMFConfig, pdata, fit_kw, max_iter=MESH_SWEEPS,
                extended=True, engine="blocked_high"),
                         {"K1": 2, "K1raw": 1, "K2": "tiers"},
                         {"K7": 2, "K8": 2, "K2": 2}, TP_RTOL, TP_ATOL,
                         {K1_TRACE: 2, K1RAW_TRACE: 1, "head_user_kernel": "tiers"}),
            "gaussian": (lambda fit_kw=None: _single(
                gm.GaussianMF, gm.GaussianMFConfig, gdata, fit_kw, max_iter=MESH_SWEEPS,
                engine="blocked_high"),
                         {"K3": 1, "K5": 1}, {"K3": 2, "K4": 2, "K5": 2},
                         TP_GAUSS_RTOL, TP_GAUSS_ATOL,
                         {"::factor_kernel": 1, K5_TRACE: 1}),
        }
        raw_launches = None
        for name, (run, tp_k, one_k, rtol, atol, trace) in rings.items():
            tp, launches = _mesh_run(
                f"tp {name} blocked_high",
                lambda: run(dict(mesh=mesh, state_sharding="rows")), smi,
                lambda m: _tp_expect(m, tp_k))
            one, _ = _mesh_run(f"one-device {name} blocked_high", run, smi,
                               lambda m: {k: n * m.n_sweeps for k, n in one_k.items()}
                               if name == "gaussian" else
                               {k: n * m.n_sweeps * (len(m.blocked.head or ())
                                                     if k == "K2" else 1)
                                for k, n in one_k.items()})
            worst, _ = _gate(f"tp {name}", tp.state, one.state, rtol, atol)
            gap = max(abs(a["val_rmse"] - b["val_rmse"])
                      for a, b in zip(tp.fit_history, one.fit_history))
            if not gap < TP_RMSE:
                raise AssertionError(f"mesh tp {name}: val RMSE gap {gap} >= {TP_RMSE}")
            lay = tp.tp.layout
            tiers = sum(len(b.head) for b in lay.by_user + lay.by_item)
            expect = {k: tiers if n == "tiers" else n * lay.n_buckets
                      for k, n in trace.items()}
            _busy(f"tp {name}", lambda: tp.tp.sweep(dict(tp.tp.state)),
                  {k: v for k, v in expect.items() if v})
            log(f"  mesh tp {name} vs one device: worst {worst:.3e} of the gate (rtol "
                f"{rtol}, atol {atol}) | val RMSE gap {gap:.3e} (tol {TP_RMSE}) | "
                + _tp_note(tp))
            if name == "extended":
                raw_launches = launches["K1raw"]
                _check_raw_launch(tp.tp.layout.by_user[0].tail, K)
            del tp, one
        tp_cache = _tp_cache(train, mesh, smi)
        # 5. The flat ring against the flat fit, float64 at full width.
        flat_tp, _ = _mesh_run("tp hpf flat float64", lambda: _single(
            hpf.HPF, hpf.HPFConfig, pdata, dict(mesh=mesh, state_sharding="rows"),
            max_iter=MESH_SWEEPS, engine="flat", dtype="float64"), smi, lambda m: {})
        flat_one, _ = _mesh_run("one-device hpf flat float64", lambda: _single(
            hpf.HPF, hpf.HPFConfig, pdata, max_iter=MESH_SWEEPS, engine="flat",
            dtype="float64"), smi, lambda m: {})
        worst, _ = _gate("tp hpf flat", flat_tp.state, flat_one.state, FLAT_TP_RTOL, 0.0)
        _busy("tp hpf flat", lambda: flat_tp.tp.sweep(dict(flat_tp.tp.state)), {})
        log(f"  mesh tp hpf flat vs flat: worst {worst:.3e} of the gate (rtol "
            f"{FLAT_TP_RTOL}) | {_tp_note(flat_tp)}")
        del flat_tp, flat_one

        # 6. Data-parallel HPFMap, and recommend_sharded.
        mcfg = dict(n_factors=K, batch_size=65536, epochs=1, verbose=False, engine="flat")
        mdp, _ = _mesh_run("dp hpf_map flat", lambda: hpf_map.HPFMap(
            hpf_map.HPFMapConfig(**mcfg)).fit(train, val, mesh=mesh), smi, lambda m: {})
        mone, _ = _mesh_run("one-device hpf_map flat", lambda: hpf_map.HPFMap(
            hpf_map.HPFMapConfig(**mcfg)).fit(train, val), smi, lambda m: {})
        worst, bits = _gate("dp hpf_map", mdp.state, mone.state, DP_RTOL, DP_RTOL)
        log(f"  mesh dp hpf_map vs one device: worst {worst:.3e} of the gate | equal in "
            f"bits: {bits} | loss {mdp.fit_history[0]['train_loss']:.6e}")
        del mdp, mone
        users = np.arange(N_USERS)
        index = build_exclusion_index(train[0], train[1], n_users=N_USERS,
                                      n_items=N_ITEMS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items_s, scores_s = dp.recommend(users, k=SERVE_K, batch=SERVE_BATCH,
                                         train_index=index, mesh=mesh)
        t_sharded = time.perf_counter() - t0
        items, scores = dp.recommend(users, k=SERVE_K, batch=SERVE_BATCH,
                                     train_index=index)
        if not (np.array_equal(items_s, items) and np.array_equal(scores_s, scores)):
            raise AssertionError("mesh: recommend_sharded differs from recommend")
        log(f"  mesh recommend_sharded: {N_USERS} users top-{SERVE_K} in {t_sharded:.2f} s, "
            "items and scores equal to recommend's")
        del dp
    finally:
        dist.destroy_process_group()
        shutil.rmtree(wd, ignore_errors=True)
    log(f"phase mesh: ok | world size 1 over nccl | {time.perf_counter() - t_phase:.1f} s "
        f"| K1 raw launches from the extended TP fit: {raw_launches} | TP layout cache: "
        f"{tp_cache} | {smi}")
    return {"K1raw": raw_launches}


def _layout_differences(a, b, path="layout") -> list:
    """The fields where two layouts (dataclasses of tensors, sizes and
    tuples) differ: tensors in dtype, shape or bits, the rest in value."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [path]
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a) if f.compare
                for d in _layout_differences(getattr(a, f.name), getattr(b, f.name),
                                             f"{path}.{f.name}")]
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            return [path]
        return [d for n, (x, y) in enumerate(zip(a, b))
                for d in _layout_differences(x, y, f"{path}[{n}]")]
    return [] if a == b else [path]


def _tp_cache(train, mesh, smi) -> str:
    """The TP blocked layout's cache entry at full width: the HPF ring's
    layout (as ``fit(state_sharding="rows")`` builds it) built cold into
    an empty directory, then read back warm (seconds, the entry's MB); the
    two equal field by field, and one ring sweep on each equal in bits."""
    import shutil

    import torch

    from pmf_tpu_torch.models.hpf import HPFConfig
    from pmf_tpu_torch.parallel import tp, tp_blocked

    u, i, x = train
    fam = tp.hpf_family(HPFConfig(n_factors=K))
    D = tp.tp_degree(mesh)
    bal = tp.balance_perms(u, i, -(-N_USERS // D) * D, -(-N_ITEMS // D) * D, D)
    ub, ib = bal.u_new_of_old[u], bal.i_new_of_old[i]
    cdir = _fresh_dir("tp_layouts")
    lays, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lays.append(tp_blocked.build_tp_blocked(ub, ib, x, N_USERS, N_ITEMS, mesh,
                                                dtype=np.float32, head=fam.head,
                                                cache_dir=cdir))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    mb = _dir_mb(cdir)
    bad = _layout_differences(lays[1], lays[0])
    if bad:
        raise AssertionError(f"mesh: the warm TP layout differs from the cold one in {bad}")
    init = tp.permute_state_rows(
        tp.pad_state_rows(fam.init_numpy(N_USERS, N_ITEMS), fam.axis_of,
                          lays[0].n_users_pad, lays[0].n_items_pad, fam.pad_ones),
        fam.axis_of, bal.u_old_of_new, bal.i_old_of_new)
    cold, warm = (fam.blocked(tp.place_tp(init, fam.axis_of, mesh), lay, mesh, "high")
                  for lay in lays)
    if not all(torch.equal(cold[k], warm[k]) for k in cold):
        raise AssertionError("mesh: a ring sweep on the warm TP layout differs from one "
                             "on the cold layout")
    tiers = sum(len(b.head) for b in lays[0].by_user + lays[0].by_item)
    del lays, cold, warm
    shutil.rmtree(cdir, ignore_errors=True)
    note = (f"cold build {secs[0]:.2f} s, warm {secs[1]:.2f} s, entry {mb:.1f} MB, "
            "equal field by field, one sweep equal in bits")
    log(f"  mesh tp cache (HPF ring layout, {tiers} tiers): {note} | {smi}")
    return note


def _check_raw_launch(p, k):
    """One K1 "raw" launch on a ring bucket's tail against its plain version
    (relative RTOL), on random positive tables at the bucket's shape."""
    import torch

    from pmf_tpu_torch.ops._tail import tail_stride
    from pmf_tpu_torch.ops.cavi_edge import tail_edge_stats, tail_edge_stats_plain

    g = torch.Generator(device="cuda").manual_seed(5)
    S = tail_stride(k)

    def tab(n):
        t = torch.zeros((n, S), device="cuda")
        t[:, :k] = torch.rand((n, k), generator=g, device="cuda") + 0.1
        return t

    e_self, e_other = tab(p.rows), tab(p.n_other)
    got = tail_edge_stats(e_self, e_other, p.row_ptr, p.other, None, mode="raw", K=k,
                          long_rows=p.long_rows)
    ref = tail_edge_stats_plain(e_self, e_other, p.row_ptr, p.other, None, mode="raw",
                                K=k)
    err, rel = compare(got, ref)
    if not rel <= RTOL:
        raise AssertionError(f"mesh: a ring bucket's K1 raw launch vs plain rel {rel}")
    log(f"  mesh K1 raw on bucket (user, step 0): {p.rows} rows, {p.nnz} edges, "
        f"{p.long_rows} long rows | vs plain max abs {err:.3e}, rel {rel:.3e} "
        f"(tol {RTOL})")


def phase_chunked(train, val, smi):
    """HPF "flat_chunked" (chunks of 2^20 edges) against "flat" at full
    width for CHUNKED_SWEEPS sweeps, in float32 (then "flat" again), and in
    float64: no kernel launched, the peak device memory of each.  Both
    engines sum rows with float32 atomics in an order that changes from run
    to run, and the heaviest rows hold some 10^5 terms, so in float32 they
    differ at about 2e-5 relative, as the flat fit differs from its repeat
    (both logged); in float64 that noise is gone, and the chunked state must
    be within CHUNKED_RTOL of the flat one, element by element."""
    import torch

    from pmf_tpu_torch.models.hpf import HPF, HPFConfig

    out = {}
    for tag, engine, dtype in (("flat", "flat", "float32"),
                               ("chunked", "flat_chunked", "float32"),
                               ("flat again", "flat", "float32"),
                               ("flat f64", "flat", "float64"),
                               ("chunked f64", "flat_chunked", "float64")):
        gc_cuda()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters()
        t0 = time.perf_counter()
        m = HPF(HPFConfig(n_factors=K, max_iter=CHUNKED_SWEEPS, tol=None, verbose=False,
                          engine=engine, dtype=dtype)).fit(train, val)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        if _launched(counters) or m.engine_used != engine:
            raise AssertionError(f"chunked {tag}: launches {_launched(counters)}, "
                                 f"engine {m.engine_used}")
        rmses = [rec["val_rmse"] for rec in m.fit_history]
        log(f"  {engine} ({dtype}): {m.n_sweeps} sweeps in {wall:.1f} s wall | sweep "
            + ", ".join(f"{rec['iter_seconds']:.4f}" for rec in m.fit_history)
            + " s | val RMSE " + " -> ".join(f"{r:.6f}" for r in rmses)
            + f" | peak {peak:.0f} MiB above the {base / 2**20:.0f} MiB held | {smi}")
        out[tag] = (m.state, peak)

    def worst(a, b):
        sa, sb = out[a][0], out[b][0]
        return (max(compare(sa[k], v)[1] for k, v in sb.items()),
                max(_normwise(sa[k], v) for k, v in sb.items()))

    elem, norm = worst("chunked", "flat")
    noise, noise_norm = worst("flat again", "flat")
    exact, _ = worst("chunked f64", "flat f64")
    if not exact <= CHUNKED_RTOL:
        raise AssertionError(f"chunked: the float64 state differs from flat's by "
                             f"{exact} > {CHUNKED_RTOL}")
    log(f"phase chunked: ok | float64: flat_chunked vs flat worst rel {exact:.3e} (tol "
        f"{CHUNKED_RTOL}) | float32: flat_chunked vs flat {elem:.3e} elementwise, "
        f"{norm:.3e} of a tensor's largest entry; flat vs its repeat {noise:.3e}, "
        f"{noise_norm:.3e} | peak float32 {out['chunked'][1]:.0f} vs "
        f"{out['flat'][1]:.0f} MiB, float64 {out['chunked f64'][1]:.0f} vs "
        f"{out['flat f64'][1]:.0f} MiB")


def _numpy_ingest():
    """The native runtime switched off: its functions take their numpy and
    pandas fallbacks until the context ends."""
    import contextlib

    from pmf_tpu_torch.data import native

    @contextlib.contextmanager
    def off():
        saved = native.get_lib
        native.get_lib = lambda: None
        try:
            yield
        finally:
            native.get_lib = saved

    return off()


def phase_native(processed, train, smi):
    """The native ingest runtime (``native/ingest.cpp`` through
    ``data/native.py``): phase cli's training CSV parsed natively and by
    pandas, ``build_ratings`` and the CSR tail build with the radix sort and
    with numpy; equal arrays, seconds of each.  Fails if the library did
    not build and load here."""
    import torch

    from pmf_tpu_torch.data import native
    from pmf_tpu_torch.data.blocked import _tail_host
    from pmf_tpu_torch.data.coo import build_ratings

    if not native.available():
        raise AssertionError("native: the ingest library did not build or load")
    path = os.path.join(processed, "interactions_train.csv")
    calls = dict(native.CALLS)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    secs = {}
    parsed, secs["parse native"] = timed(lambda: native.parse_interactions_csv(path))
    with _numpy_ingest():
        ref, secs["parse pandas"] = timed(lambda: native.parse_interactions_csv(path))
    if not all(np.array_equal(a, b) for a, b in zip(parsed, ref)):
        raise AssertionError("native: the parse differs from pandas'")
    del parsed, ref
    r_nat, secs["build_ratings native"] = timed(lambda: build_ratings(*train, device="cuda"))
    with _numpy_ingest():
        r_np, secs["build_ratings numpy"] = timed(lambda: build_ratings(*train, device="cuda"))
    for f in ("u_by_u", "i_by_u", "x_by_u", "u_by_i", "i_by_i", "x_by_i", "user_counts",
              "item_counts"):
        if not torch.equal(getattr(r_nat, f), getattr(r_np, f)):
            raise AssertionError(f"native: build_ratings {f} differs from numpy's")
    del r_nat, r_np
    u, i, x = train
    ids = (np.arange(N_USERS), np.arange(N_ITEMS))
    for name, (s, o, n_s, n_o, perms) in {
            "by_user": (u, i, N_USERS, N_ITEMS, ids + ids),
            "by_item": (i, u, N_ITEMS, N_USERS, ids[::-1] + ids[::-1])}.items():
        args = (s, o, x, n_s, n_o, perms, False, np.float32)
        (h_nat, m_nat), secs[f"tail {name} native"] = timed(lambda: _tail_host(*args))
        with _numpy_ingest():
            (h_np, m_np), secs[f"tail {name} numpy"] = timed(lambda: _tail_host(*args))
        if m_nat != m_np or not all(np.array_equal(h_nat[k], h_np[k]) for k in h_nat):
            raise AssertionError(f"native: the {name} CSR differs from numpy's")
    used = {k: native.CALLS[k] - calls.get(k, 0) for k in native.CALLS}
    if used != {"parse_csv": 1, "radix_argsort": 4}:
        raise AssertionError(f"native: library calls {used}")
    log(f"phase native: ok | {len(train[0])} rows: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f" | arrays and permutations equal | library calls {used} | {smi}")


def phase_cache(train, blocked, smi):
    """The layout cache at full width: ``build_blocked`` as ``HPF.fit``
    calls it, cold into an empty directory under ``_smoke_tmp/`` (the
    build and the entry's write), then warm (the entry's read and the
    head's scatter on the card).  Every tensor of the hit equal in bits to
    the cold build's and to phase data's uncached layout, one sweep on each
    equal in bits.  Returns the directory, which ``main`` makes the layout
    cache (``PMF_TPU_TORCH_LAYOUT_CACHE``) from phase fastfit on."""
    import torch

    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.models import hpf
    from pmf_tpu_torch.models.base import as_triples

    u, i, x = as_triples(train)  # the arrays the fits pass
    cdir = _fresh_dir("layouts")
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, dtype=np.float32, reorder=True,
              head="auto", head_bytes=5 << 29, device="cuda", cache_dir=cdir)
    secs = {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        built = build_blocked(u, i, x, **kw)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if name == "cold":
            cold = built
    warm = built
    entries = os.listdir(cdir)
    for other, label in ((cold, "cold build"), (blocked, "phase data's layout")):
        bad = _layout_differences(warm, other)
        if bad:
            raise AssertionError(f"cache: the hit differs from the {label} in {bad}")
    cfg = hpf.HPFConfig(n_factors=K)
    hyper = (cfg.a, cfg.a_prime, cfg.b_prime, cfg.c, cfg.c_prime, cfg.d_prime)
    counts = _counts_on_card(train)
    state = hpf.init_state(N_USERS, N_ITEMS, cfg, device="cuda")
    s_cold = hpf.sweep_blocked(dict(state), cold, *counts, *hyper)
    s_warm = hpf.sweep_blocked(dict(state), warm, *counts, *hyper)
    if not all(torch.equal(s_cold[k], s_warm[k]) for k in s_cold):
        raise AssertionError("cache: a sweep on the hit differs from one on the cold build")
    log(f"phase cache: ok | {len(entries)} entry, {_dir_mb(cdir):.1f} MB | cold "
        f"(build and write) {secs['cold']:.2f} s, warm (read and scatter) "
        f"{secs['warm']:.2f} s | every tensor of the hit equal in bits to the cold build "
        f"and to phase data's | one sweep on each equal in bits | the fits read "
        f"{cdir} from phase fastfit on | {smi}")
    return cdir


def phase_roofline(sweeps: dict, smi):
    """``utils.roofline.roofline_fields`` of each exact sweep's work count
    (``hpf_blocked_traffic``, ``poisson_ext_blocked_traffic``,
    ``gaussian_blocked_traffic``) over its busy time from phases profile,
    pprofile and gprofile, against the peaks of the card's own name; a
    share above 100% fails the run (the count would be wrong)."""
    for name, (traffic, busy_ms) in sweeps.items():
        f = roofline.roofline_fields(traffic, busy_ms / 1e3)
        log(f"  roofline {name} sweep: busy {busy_ms:.4f} ms | {f['bytes_per_iter']} B "
            f"(tail {f['tail_bytes_per_iter']}, head {f['head_bytes_per_iter']}) | "
            f"{f['effective_gbps']:.2f} GB/s, pct_hbm_roofline "
            f"{f['pct_hbm_roofline']:.3f} | {f['effective_tflops']:.4f} TFLOP/s, "
            f"pct_mfu_bf16 {f['pct_mfu_bf16']:.4f} | "
            f"{f['card']} | {smi}")
        if not (0 < f["pct_hbm_roofline"] <= 100 and 0 < f["pct_mfu_bf16"] <= 100):
            raise AssertionError(f"roofline {name}: a share outside (0, 100]: {f}")
    log(f"phase roofline: ok | {len(sweeps)} sweeps | {smi}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of another commit whose kernels the parent phases "
                         "time in turns")
    ap.add_argument("--torchrun-child", metavar="DIR",
                    help="run phase torchrun's commands of DIR/commands.json under a mesh "
                         "(this process started by torch.distributed.run)")
    args = ap.parse_args(argv)
    if args.torchrun_child:
        return torchrun_child(args.torchrun_child)
    t_start = time.perf_counter()
    smi = phase_device()
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.parent:
        _load_parent(args.parent)
    phase_build()
    phase_k2small()
    phase_bigk()
    gc_cuda()
    train, val, blocked, split = phase_data()
    layouts = phase_cache(train, blocked, smi)
    k1 = phase_k1(blocked)
    k1raw = phase_k1raw(blocked)
    k2 = phase_k2(blocked)
    k2f = phase_k2fast(blocked, k2)
    if PARENT:
        phase_k2_parent(blocked)
    k7, k8 = phase_k7k8(blocked)
    wide = {kid: r["ms"] for kid, r in phase_wide_poisson(blocked).items()}
    huge = phase_wide_poisson(blocked, K_HUGE)
    if PARENT:
        phase_tail_parent(blocked)
    del blocked
    torch.cuda.empty_cache()
    phase_small()
    model, launches = phase_fit(train, val, smi)
    high_rmse = {"hpf": [rec["val_rmse"] for rec in model.fit_history]}
    fit_ref = ({k: v.clone() for k, v in model.state.items()}, high_rmse["hpf"])
    sweeps = phase_profile(model, train, smi)
    phase_serve(model, train, val, smi)
    phase_resume(model, train, val, smi)
    del model
    gc_cuda()
    sweeps.update(phase_hugefit(train, val, smi))
    gc_cuda()
    sweeps.update(phase_hugefit(train, val, smi, K_WIDE))
    gc_cuda()
    exthuge = phase_exthugefit(train, val, smi)
    sweeps[f"ext_k{K_HUGE}"] = (exthuge["traffic"], exthuge["sweep_ms"])
    gc_cuda()

    phase_psmall()
    pmodels = phase_pfit(train, val, smi)
    high_rmse["extended"] = [rec["val_rmse"] for rec in pmodels["extended"][0].fit_history]
    sweeps.update(phase_pprofile(pmodels, train, smi))
    for _, plaunches in pmodels.values():
        launches = {k: launches[k] + plaunches[k] for k in launches}
    del pmodels
    gc_cuda()
    phase_pelbo(train, val, smi)

    mlay, morder, mgroups, mseg_groups, mgroup_secs = phase_mdata(train)
    k9 = phase_k9(mlay, morder, mgroups, mseg_groups, mgroup_secs)
    if PARENT:
        phase_k9_parent(mlay, morder)
    m_pieces = mgroups[0].n_pieces + mgroups[1].n_pieces
    del mlay, mgroups, mseg_groups
    gc_cuda()
    phase_msmall()
    mmodel, mlaunches = phase_mfit(train, val, smi)
    k10 = phase_k10(mmodel, train)
    gc_cuda()
    phase_mresume(mmodel, train, val, smi)
    mprof = phase_mprofile(mmodel, train, smi)
    del mmodel
    gc_cuda()
    mhuge = phase_mhugefit(train, val, smi, m_pieces)
    gc_cuda()

    gtrain, gval, gblocked = phase_gdata(split)
    gtiers = [(h.hu, h.hip) for h in gblocked.head]
    k3 = phase_k3(gblocked)
    k5 = phase_k5(gblocked)
    k6 = phase_k6(gblocked)
    phase_ghead(gblocked)
    k4 = phase_k4(gblocked)
    gwide_ms, k4_lib50 = phase_wide_gauss(gblocked)
    wide.update(gwide_ms)
    wide["K9"] = k9["k50_ms"]
    gc_cuda()
    huge.update(phase_huge_gauss(gblocked))
    huge["K9"] = k9["k160"]
    gc_cuda()
    if PARENT:
        phase_tail_parent(gblocked, ("K6", "K5"))
        gc_cuda()
    xtrain, xval = phase_gxldata()
    xl = _xl_layout(xtrain)
    k3w = phase_k3wide(gblocked, xl)
    huge["K3"] = k3w["bench"]
    gc_cuda()
    if PARENT:
        phase_k3_parent(gblocked, xl)
    del gblocked, xl
    gc_cuda()
    k4w = phase_k4wide()
    gc_cuda()
    if PARENT:
        phase_k4_parent()
        gc_cuda()
    phase_gsmall()
    full, diag, glaunches = phase_gfit(gtrain, gval, smi)
    high_rmse["gaussian"] = [rec["val_rmse"] for rec in full.fit_history]
    sweeps.update(phase_gprofile(full, diag, gtrain, smi))
    del full, diag
    gc_cuda()
    phase_gelbo(gtrain, gval, smi)
    gc_cuda()
    gwide = phase_gwidefit(gtrain, gval, smi)
    gc_cuda()
    gxl = phase_gwidefit(xtrain, xval, smi, k=XL_K, n_users=XL_USERS, n_items=XL_ITEMS,
                         head_bytes=0, label="gxlfit")
    del xtrain, xval
    gc_cuda()
    gdiag = phase_gdiaghugefit(gtrain, gval, smi, gtiers)
    gc_cuda()
    # The layout cache, off until here so that every fit above builds its
    # layout cold (each wall a user's first fit).
    from pmf_tpu_torch.data import layout_cache

    os.environ[layout_cache.ENV_VAR] = layouts
    flaunches, _ = phase_fastfit(train, val, gtrain, gval, high_rmse, smi)
    gc_cuda()
    mesh_launches = phase_mesh(train, val, gtrain, gval, fit_ref, smi)
    del gtrain, gval, fit_ref
    gc_cuda()
    phase_chunked(train, val, smi)
    gc_cuda()

    t_new = time.perf_counter()
    phase_cli(train, val, smi)
    phase_mseed(train, val, smi)
    del train, val
    gc_cuda()
    phase_repro(smi)
    log(f"  phases cli, mseed and repro: {time.perf_counter() - t_new:.1f} s")
    phase_roofline(sweeps, smi)

    def entry(name, source, replaces, res, n, kid, **more):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms"), f"ms_k{K_WIDE}": wide[kid],
                f"ms_k{K_HUGE}": huge[kid]["ms"],
                f"bound_ms_k{K_HUGE}": huge[kid]["bound_ms"],
                f"bound_by_k{K_HUGE}": huge[kid]["bound_by"],
                f"library_ms_k{K_HUGE}": huge[kid].get("library_ms"),
                **({f"sector_ms_k{K_HUGE}": huge[kid]["sector_ms"]}
                   if "sector_ms" in huge[kid] else {}), **more}

    gsrc = "pmf_tpu_torch/csrc/gaussian_edge.cu"
    kernels = [
        entry("cavi_edge_tail", "pmf_tpu_torch/csrc/cavi_edge.cu",
              "pmf_tpu/ops/pallas/cavi_edge.py:93", k1, launches["K1"], "K1",
              note=f"_k{K_HUGE}: the dot form (tail_dot_kernel, "
                   "pmf_tpu_torch/csrc/tail_groups.cuh) on the bench tail"),
        entry("dense_head_tier", "pmf_tpu_torch/csrc/dense_head.cu",
              "pmf_tpu/ops/dense_head.py:85", k2, launches["K2"], "K2"),
        entry("dense_head_tier_fast", "pmf_tpu_torch/csrc/dense_head.cu",
              "pmf_tpu/ops/dense_head.py:85", k2f, flaunches["K2fast"], "K2fast",
              note="precision \"fast\" (engine blocked_fast): one bf16 term a "
                   "product; launches from phase fastfit's blocked_fast fits"),
        entry("gaussian_factor_tail", gsrc,
              "pmf_tpu/ops/pallas/gaussian_edge.py:90", k3, glaunches["K3"], "K3",
              **{f"{key}_k{k}_xl": v[key] for k, v in k3w["xl"].items()
                 for key in ("ms", "bound_ms", "library_ms")},
              **{f"forms_k{k}_xl": v["forms"] for k, v in k3w["xl"].items()},
              forms_k160=k3w["bench"]["forms"],
              launches_k256_xl=gxl["launches"]["K3"], sweep_ms_k256_xl=gxl["k3_ms"],
              note="_k160: the bench tail (phase k3wide); _k256_xl, _k300_xl: the "
                   f"{XL_USERS} x {XL_ITEMS} CSR of phase gxlfit; sweep_ms_k256_xl: K3's "
                   "share of its traced sweep"),
        entry("gj_inverse", "pmf_tpu_torch/csrc/gj_inverse.cu",
              "pmf_tpu/ops/pallas/gj_inverse.py:25", k4, glaunches["K4"], "K4",
              **{f"library_ms_k{K_WIDE}": k4_lib50,
                 **{f"{key}_k{k}": r[key] for k, r in k4w.items()
                    for key in ("ms", "library_ms", "bound_ms")
                    if k != K_HUGE or key == "library_ms"},
                 f"launches_k{GWIDE_K}": gwide["launches"]["K4"],
                 f"sweep_busy_ms_k{GWIDE_K}": gwide["busy_ms"],
                 f"sweep_ms_k{GWIDE_K}": gwide["k4_ms"],
                 f"launches_k{XL_K}": gxl["launches"]["K4"],
                 f"sweep_busy_ms_k{XL_K}": gxl["busy_ms"],
                 f"sweep_ms_k{XL_K}": gxl["k4_ms"]},
              note=f"_k80 .. _k239: phase k4wide (the CTA form, a sweep's matrices), "
                   f"_k240 .. _k512: the panel form on the K={XL_K} fit's "
                   f"{XL_USERS} + {XL_ITEMS} matrices; launches_k*, sweep_*: phases "
                   f"gwidefit (K={GWIDE_K}) and gxlfit (K={XL_K}), exact fits (K4's ms "
                   f"in one traced sweep of sweep_busy_ms)"),
        entry("gaussian_bias_tail", gsrc,
              "pmf_tpu/ops/pallas/gaussian_edge.py:175", k5, glaunches["K5"], "K5",
              **{f"launches_k{K_HUGE}_diag": gdiag["launches"]["K5"],
                 f"sweep_k5_ms_k{K_HUGE}_diag": gdiag["k5_ms"],
                 f"launches_k{XL_K}_xl": gxl["launches"]["K5"],
                 f"sweep_k5_ms_k{XL_K}_xl": gxl["k5_ms"]},
              note=f"_k{K_HUGE}: the sum form (tail_sum_kernel, "
                   "pmf_tpu_torch/csrc/tail_groups.cuh; the item pass in windows of "
                   f"other ids) on the bench tail; *_diag, *_xl: K5's launches and its "
                   f"ms in one traced sweep of phases gdiaghugefit (K={K_HUGE}) and "
                   f"gxlfit (K={XL_K})"),
        entry("gaussian_diag_tail", gsrc,
              "pmf_tpu/ops/pallas/gaussian_edge.py:242", k6, glaunches["K6"], "K6",
              **{f"launches_k{K_HUGE}_diag": gdiag["launches"]["K6"],
                 f"sweep_ms_k{K_HUGE}_diag": gdiag["sweep_ms"],
                 f"sweep_k6_ms_k{K_HUGE}_diag": gdiag["k6_ms"],
                 f"peak_gb_k{K_HUGE}_diag": gdiag["peak_gb"]},
              note=f"_k{K_HUGE}: the ring form (tail_ring_kernel, "
                   "pmf_tpu_torch/csrc/tail_groups.cuh) on the bench tail; *_diag: phase "
                   f"gdiaghugefit's diag fit at K={K_HUGE} (a sweep and K6's two launches "
                   "on its sweep-2 tables by CUDA events, the fit's peak above the memory "
                   "held)"),
        entry("ext_factor_tail", "pmf_tpu_torch/csrc/ext_edge.cu",
              "pmf_tpu/ops/pallas/ext_edge.py:59", k7, launches["K7"], "K7",
              **{f"s_wother_half_ms_k{K_HUGE}": huge["K7"]["half_ms"],
                 f"launches_k{K_HUGE}_ext": exthuge["launches"]["K7"],
                 f"sweep_ms_k{K_HUGE}_ext": exthuge["sweep_ms"],
                 f"sweep_k7_ms_k{K_HUGE}_ext": exthuge["k7_ms"]},
              note=f"_k{K_HUGE}: the dot form (tail_dot_kernel) on the bench tail; "
                   f"*_ext: phase exthugefit's extended fit at K={K_HUGE} (its steady "
                   "sweep by CUDA events, K7's ms in one traced sweep)"),
        entry("ext_scalar_tail", "pmf_tpu_torch/csrc/ext_edge.cu",
              "pmf_tpu/ops/pallas/ext_edge.py:107", k8, launches["K8"], "K8",
              **{f"launches_k{K_HUGE}_ext": exthuge["launches"]["K8"],
                 f"sweep_k8_ms_k{K_HUGE}_ext": exthuge["k8_ms"]},
              note=f"_k{K_HUGE}: the sum form (tail_sum_kernel; the item pass in "
                   "windows of other ids) on the bench tail; *_ext: phase exthugefit's "
                   f"extended fit at K={K_HUGE} (K8's ms in one traced sweep)"),
        entry("map_grad", "pmf_tpu_torch/csrc/map_grad.cu",
              "pmf_tpu/ops/pallas/map_grad.py:56", k9, mlaunches["K9"], "K9",
              device_ms=k9["device_ms"], group_ms=k9["group_ms"],
              **{f"graph_ms_k{k}": r["graph_ms"] for k, r in k9["at"].items()},
              **{f"bound_ms_k{k}": r["bound_ms"] for k, r in k9["at"].items()
                 if k != K_WIDE},
              **{f"graph_ms_k{K_HUGE}": huge["K9"]["graph_ms"],
                 f"val_rmse_k{K_HUGE}_map": mhuge["val_rmse"],
                 f"launches_k{K_HUGE}_map": mhuge["launches"]["K9"],
                 f"step_ms_k{K_HUGE}_map": mhuge["step_ms"],
                 f"step_k9_share_k{K_HUGE}_map": mhuge["k9_share"],
                 f"peak_gb_k{K_HUGE}_map": mhuge["peak_gb"]},
              note="ms (CUDA events), device_ms, ms_k50 and ms_k160 (profiler sums), "
                   "plain_ms and bound_ms are per epoch of launches; graph_ms_k* a "
                   "CUDA graph replay of the epoch's launches; to K=128 the runs form "
                   "(map_grad_runs_kernel), _k160: the wide form on pieces of <= 32 "
                   "edges; *_map: phase mhugefit's blocked HPF-MAP fit at K=160, lr "
                   f"{MHUGE_LR} (its launches, val RMSE by epoch, a steady step by CUDA "
                   "events, K9's share of the step's traced busy time, the fit's peak "
                   "above the memory held); group_ms is the epoch's regrouping"),
        {"name": "map_dense", "route": "cuda", "source": "pmf_tpu_torch/csrc/map_dense.cu",
         "replaces": "pmf_tpu/models/hpf_map.py:377", "launches": mlaunches["K10"],
         **{key: k10[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         **{f"{key}_k{k}": r[key] for k, r in k10["at"].items()
            for key in ("ms", "plain_ms", "bound_ms")},
         f"ms_k{K_HUGE}": mhuge["k10"]["ms"], f"plain_ms_k{K_HUGE}": mhuge["k10"]["plain_ms"],
         f"bound_ms_k{K_HUGE}": mhuge["k10"]["bound_ms"],
         f"bound_by_k{K_HUGE}": mhuge["k10"]["bound_by"],
         "clear_ms": k10["clear_ms"], "fill_ms": k10["fill_ms"],
         f"clear_ms_k{K_HUGE}": mhuge["k10"]["clear_ms"],
         f"fill_ms_k{K_HUGE}": mhuge["k10"]["fill_ms"],
         "step_ms": mprof["step_ms"], "step_dense_share": mprof["dense_share"],
         f"launches_k{K_HUGE}_map": mhuge["launches"]["K10"],
         f"step_ms_k{K_HUGE}_map": mhuge["step_ms"],
         f"step_dense_share_k{K_HUGE}_map": mhuge["dense_share"],
         "note": "no Pallas kernel: the XLA fusion of train_epoch_blocked's step body (the "
                 "prior gradients, the softplus chain rule, Adam, the loss); ms, plain_ms, "
                 "bound_ms a step by CUDA events on a real step of phase mfit's layout (K=20 "
                 "on its fitted state, K=50, 128, 300 from the initial state, K=160 on phase "
                 "mhugefit's fitted state), each launch with the step's K9 sums; clear_ms "
                 "its time less that on accumulators of zeros, fill_ms the two zero-fills "
                 "that clearing saves; step_*: a steady blocked "
                 "step by CUDA events and the dense part's share of its traced busy time "
                 "(phases mprofile, mhugefit)"},
        entry("cavi_edge_tail_raw", "pmf_tpu_torch/csrc/cavi_edge.cu",
              "pmf_tpu/ops/pallas/cavi_edge.py:93", k1raw,
              mesh_launches["K1raw"], "K1raw",
              note="mode \"raw\": launches from phase mesh's extended Poisson "
                   "fit on the tensor-parallel blocked ring (pass 2, a bucket a "
                   "direction and sweep); no single-device fit runs it"),
    ]
    import shutil

    for name in ("layouts", "cli_layouts", "tp_layouts"):
        shutil.rmtree(os.path.join(SMOKE_TMP, name), ignore_errors=True)
    log(f"  gdiaghugefit (diag Gaussian, K={K_HUGE}): a sweep {gdiag['sweep_ms']:.4f} ms "
        f"by CUDA events (traced busy {gdiag['busy_ms']:.4f} ms), K6 {gdiag['k6_ms']:.4f} ms "
        f"by CUDA events ({gdiag['k6_share']:.2%} of the sweep) | peak "
        f"{gdiag['peak_gb']:.3f} GB (reckoned {gdiag['reckoned_gb']:.3f})")
    log(f"  mhugefit (HPF-MAP, K={K_HUGE}): epochs "
        + ", ".join(f"{t:.4f}" for t in mhuge["epoch_s"])
        + f" s | a steady step {mhuge['step_ms']:.4f} ms by CUDA events, K9 "
        f"{mhuge['k9_share']:.2%} of its traced busy {mhuge['busy_ms'] / MPROFILE_STEPS:.4f} "
        f"ms, the dense part {mhuge['dense_share']:.2%} (K10 {mhuge['k10_ms'] / MPROFILE_STEPS:.4f} "
        f"ms a step traced) | peak {mhuge['peak_gb']:.3f} GB (reckoned "
        f"{mhuge['reckoned_gb']:.3f}) | last val "
        f"RMSE {mhuge['val_rmse'][-1]:.6f}, witnesses " + ", ".join(
            f"{name} {v[-1]:.6f}" for name, v in mhuge["witness"].items()))
    log(f"  mprofile (HPF-MAP, K={K}): a steady step {mprof['step_ms']:.4f} ms by CUDA events, "
        f"traced busy {mprof['busy_ms'] / MPROFILE_STEPS:.4f} ms of "
        f"{mprof['window_ms'] / MPROFILE_STEPS:.4f} (idle share "
        f"{1 - mprof['busy_ms'] / mprof['window_ms']:.2%}), the dense part "
        f"{mprof['dense_share']:.2%} | K10 alone {k10['ms']:.4f} ms (bound {k10['bound_ms']:.4f}), "
        f"at K={K_HUGE} {mhuge['k10']['ms']:.4f} ms (bound {mhuge['k10']['bound_ms']:.4f})")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
