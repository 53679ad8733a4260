"""K5's and K8's sum form past 32 words a row
(``csrc/tail_groups.cuh::tail_sum_kernel``), on the CPU.

Its plan (``ops/_tail.py::launch_plan``, form "sum"): at every K from 120
to 520 equal to what the header's predicates (``plan_sum``, ``plan_wide``,
read from the source text) choose, every column of the record held by
exactly one (lane, word, component), its ring inside a CTA's shared memory
at K = 511, its boundaries (K5 from K = 160, K8 from 144: the register
form's ``G = 32, V = 2`` below, from K = 128), and K1 raw's plan unchanged
at every K to 600.  A numpy float32
emulation of the form's order (a warp a row, its edges in rounds of D,
lane l summing words l, l + 32, ... of each record in edge order: K5 the
record and the rating; K8 s_o * e_o by multiply-adds, s_o read from the
record, then one dot with the self row and a butterfly) against the float64
plain versions ``bias_tail_stats_plain`` and ``ext_scalar_tail_plain`` on
rows of 0, 1, 31, 32 and 757 edges, at each K of the form beside each of
its boundaries and at 160, 256 and 511: per element at 1e-4 relative on positive
data, per column at 1e-4 of the column's largest magnitude on K5's signed
Gaussian data.  To K = 255 that emulation equals, in float32 bits, the
register form's ``G = 32, V = 2`` emulation it replaces.  The other-id
windows (``_tail.window_count``, ``build_windows``, ``window_args``): their
count on the bench's shapes, each row's edges regrouped by window in CSR
order, and the windowed order (each window's partial, then the nonempty
windows' partials added in window order) against the float64 plain
versions per column.  The port's K5 and
K8 passes at the form's first K (160, 144) against the JAX package's Pallas
passes in interpret mode, at the gates of ``tests/test_torch_k5k6.py`` and
``tests/test_torch_k8.py``."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.data.synthetic import synth_ratings
from pmf_tpu.ops.pallas import ext_edge as jext
from pmf_tpu.ops.pallas import gaussian_edge as jge
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import _build, _tail, ext_edge
from pmf_tpu_torch.ops import gaussian_edge as ge
from tests.test_torch_gaussian_edge import _assert_tier_gate
from tests.test_torch_k5k6 import _group_sums, _row_out
from tests.test_torch_k6dot import _parent_plan
from tests.test_torch_tailwide import _fma

torch.set_num_threads(1)

RTOL = 1e-4
SMEM_PER_CTA = 232_448  # bytes of dynamic shared memory a CTA may ask for (H100)
HDR = (_build.SRC_DIR / "tail_groups.cuh").read_text()
KERNELS = _tail.SUM_KERNELS
MODE = {"K1": 0, "K1raw": 1, "K7": 2, "K5": 3, "K6": 4, "K8": 5}
SUM_KS = {kid: [k for k in range(1, 601) if _tail.launch_plan(k, kid)["form"] == "sum"]
          for kid in KERNELS}
FIRST = {kid: ks[0] for kid, ks in SUM_KS.items()}  # K5 160, K8 144
LAST = 511
LENGTHS = [0, 1, 31, 32, 757, 5]


# ---------------------------------------------------------------- plan --

def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HDR).group(1))


def _body(fn):
    """The expression a one-statement constexpr predicate of the header
    returns, in Python: && and, || or, its ternary chain as conditionals."""
    text = HDR[HDR.index(f"constexpr bool {fn}(int mode, int K) {{"):]
    text = text[text.index("return") + len("return"): text.index(";")]
    text = re.sub(r"\s+", " ", text).replace("&&", " and ").replace("||", " or ")
    arms = text.split(":")
    if len(arms) == 1:
        return text
    expr = arms[-1]
    for arm in reversed(arms[:-1]):
        cond, val = arm.split("?")
        expr = f"(({val}) if ({cond}) else ({expr}))"
    return expr


def _header_plan(kid, K):
    """The form the header's predicates give ``kid`` at K: "sum", "wide" or
    "group" (K5 and K8 take no dot or ring form)."""
    env = {f"k{n}": _const(f"k{n}") for n in ("SumMaxVec", "DotMaxVec", "RingMaxVec",
                                            "MaxSpan", "SumBiasFrom", "SumScalarFrom")}
    env.update(kCavi=0, kRaw=1, kExt=2, kBias=3, kDiag=4, kScalar=5, mode=MODE[kid], K=K)
    env["plan_words"] = lambda mode, K: (K + (1 if mode >= 2 else 0) + 3) // 4
    env["plan_span"] = lambda mode, K: 1 << (env["plan_words"](mode, K) - 1).bit_length()
    if eval(_body("plan_wide"), env):
        return "wide"
    return "sum" if eval(_body("plan_sum"), env) else "group"


@pytest.mark.parametrize("kid", KERNELS)
def test_plan_matches_the_header_predicates(kid):
    """``launch_plan``'s form for K5 and K8 at every K from 120 to 520 is
    the one the header's ``plan_sum`` and ``plan_wide`` choose."""
    forms = [_tail.launch_plan(k, kid)["form"] for k in range(120, 521)]
    assert forms == [_header_plan(kid, k) for k in range(120, 521)]
    assert set(forms) == {"group", "sum", "wide"}


def test_sum_form_takes_k5_from_160_and_k8_from_144():
    """K5 takes the sum form from K = 160 (41 words a record), K8 from K = 144
    (37 words), to K = 511 (128 words), every K between; the register form's
    G = 32, V = 2 below from K = 128 (33 words), where it ran faster; no
    other kernel takes the sum form."""
    assert FIRST == {"K5": 160, "K8": 144}
    assert -(-(LAST + 1) // 4) == 32 * _tail.SUM_MAX_VEC
    for kid in KERNELS:
        assert SUM_KS[kid] == list(range(FIRST[kid], LAST + 1))
        assert -(-(FIRST[kid] + 1) // 4) == _tail.SUM_FIRST_WORDS[kid]
        for k in range(128, FIRST[kid]):
            p = _tail.launch_plan(k, kid)
            assert (p["form"], p["lanes"], p["vec"]) == ("group", 32, 2)
        assert _tail.launch_plan(LAST + 1, kid)["form"] == "wide"
    for kid in _tail.PLAN_KERNELS:
        if kid not in KERNELS:
            assert all(_tail.launch_plan(k, kid)["form"] != "sum" for k in range(1, 601))


@pytest.mark.parametrize("kid", KERNELS)
def test_sum_plan_covers_every_column_once(kid):
    """At every K of the sum form: 32 lanes a row, V = ceil(W / 32) words a
    lane, lane l words l, l + 32, ...: each of the record's K + 1 columns
    held once; D and S the header's; the CTA's rings in shared memory."""
    for K in SUM_KS[kid]:
        p = _tail.launch_plan(K, kid)
        W = -(-(K + 1) // 4)
        assert p["form"] == "sum" and not p["wide"] and p["chunks"] == 1
        assert (p["lanes"], p["vec"], p["words"]) == (32, -(-W // 32), W)
        assert p["stride"] == 4 * W == _tail.tail_stride(K + 1)
        assert p["rows_per_warp"] == 1 and p["rows_per_cta"] == _tail.DOT_WARPS
        assert (p["in_flight"], p["stages"]) == (_tail.SUM_IN_FLIGHT, _tail.SUM_STAGES)
        assert p["batch"] % p["in_flight"] == 0
        held = [4 * (32 * v + lane) + j for lane in range(32) for v in range(p["vec"])
                for j in range(4) if 32 * v + lane < W and 4 * (32 * v + lane) + j <= K]
        assert sorted(held) == list(range(K + 1)), K
        ring = _tail.dot_ring_words(W, _tail.SUM_IN_FLIGHT, _tail.SUM_STAGES)
        assert p["smem"] == _tail.DOT_WARPS * 16 * ring


def test_sum_ring_fits_a_cta_at_k511():
    """The widest ring (K = 511, 128 words a record) inside a CTA's dynamic
    shared memory, and the widest of the form."""
    widest = _tail.launch_plan(LAST, "K5")["smem"]
    assert widest == max(_tail.launch_plan(k, kid)["smem"] for kid in KERNELS
                         for k in SUM_KS[kid]) <= SMEM_PER_CTA


def test_sum_form_boundaries():
    """K5's and K8's boundaries from 128: the register form's G = 32, the sum
    form's start, each word a lane more, then the wide form (K8's second
    chunk of e_s words at 513)."""
    for kid, tail in (("K5", [512]), ("K8", [512, 513])):
        bounds = [b for b in _tail.boundary_ks(kid) if b >= 128]
        assert bounds == [128, FIRST[kid], 256, 384] + tail
        for b in bounds:
            assert _tail.launch_plan(b - 1, kid) != _tail.launch_plan(b, kid)


def test_sum_plan_mirrors_the_kernel_source():
    assert _const("kSumInFlight") == _tail.SUM_IN_FLIGHT
    assert _const("kSumStages") == _tail.SUM_STAGES
    assert _const("kSumMaxVec") == _tail.SUM_MAX_VEC
    assert _tail.SUM_KERNELS == ("K5", "K8")
    assert _tail.SUM_FIRST_WORDS == {"K5": _const("kSumBiasFrom"),
                                     "K8": _const("kSumScalarFrom")}
    assert "constexpr int D = kSumInFlight, S = kSumStages;" in HDR
    vecs = {_tail.launch_plan(k, "K5")["vec"] for k in SUM_KS["K5"]}
    built = {int(v) for v in re.findall(r"case (\d+): return launch_sum<kMode, \1, D, S>",
                                        HDR)}
    assert vecs == built == set(range(2, _tail.SUM_MAX_VEC + 1))
    launcher = HDR[HDR.index("int launch_sum("):]
    launcher = launcher[: launcher.index("\n}\n")]
    assert ("const int smem = kDotWarps * 16 * dot_ring_words(plan_words(kMode, K), D, S);"
            in launcher)
    # the register form's G = 32, V = 2 instance stays built for K5 and K8
    # below their sum form (and for K1 raw)
    for kid in KERNELS:
        group = [k for k in range(1, 600) if _tail.launch_plan(k, kid)["form"] == "group"]
        assert group == list(range(1, FIRST[kid]))
        assert (_tail.launch_plan(group[-1], kid)["lanes"],
                _tail.launch_plan(group[-1], kid)["vec"]) == (32, 2)
    assert ("if (!plan_dot(mode, K) && !plan_ring(mode, K) && plan_lanes(mode, K) == G &&\n"
            "        plan_vec(mode, K) == V && !plan_sum(mode, K))") in HDR


def test_k1_raw_plan_unchanged():
    """K1 raw keeps the register form's G = 32, V = 2 to K = 256 and the
    wide form past it, at every K to 600."""
    for k in range(1, 601):
        assert _tail.launch_plan(k, "K1raw") == _parent_plan(k, "K1raw"), k
    assert _tail.launch_plan(200, "K1raw")["lanes"] == 32


# ------------------------------------------------------------ emulation --

def _lane_words(W, V):
    """(32, V) word indices lane l holds (l + 32 v) and which exist."""
    words = 32 * np.arange(V)[None, :] + np.arange(32)[:, None]
    return words, words < W


def _butterfly(part):
    """group_sum<32>: lane l adds lane l ^ off, off = 16 .. 1; (32,)."""
    lane = np.arange(32)
    off = 16
    while off:
        part = part + part[lane ^ off]
        off //= 2
    assert np.all(part == part[0])
    return part[0]


def _self_words(es_row, K, V):
    """The lanes' words of the self row with its pad columns zeroed:
    (32, V, 4)."""
    Ws = -(-K // 4)
    words, held = _lane_words(Ws, V)
    row = np.zeros(4 * Ws, np.float32)
    row[:K] = es_row[:K]
    out = np.zeros((32, V, 4), np.float32)
    out[held] = row.reshape(Ws, 4)[words[held]]
    return out


def _row_end(kid, K, acc, acc_x, es_row):
    """What the row's warp writes: K5 [sum m | sum b | sum x] (K + 2,), K8
    the dot of its sums with the self row, one butterfly."""
    V = acc.shape[1]
    if kid == "K8":
        es = _self_words(es_row, K, V)
        part = np.zeros(32, np.float32)
        for v in range(V):
            for j in range(4):  # the lane's multiply-adds: words in order, x y z w
                part = _fma(es[:, v, j], acc[:, v, j], part)
        return _butterfly(part)
    W = -(-(K + 1) // 4)
    words, held = _lane_words(W, V)
    out = np.zeros(K + 2, np.float32)
    for lane in range(32):
        for v in range(V):
            for j in range(4):
                k = 4 * words[lane, v] + j
                if held[lane, v] and k <= K:
                    out[k] = acc[lane, v, j]
    out[K + 1] = acc_x
    return out


def _emulate_row(kid, K, rec, edges, es_row=None):
    """One row as its warp walks it in the sum form: rounds of D edges, each
    lane's words of each record summed in edge order."""
    plan = _tail.launch_plan(K, kid)
    V, W, D = plan["vec"], plan["words"], plan["in_flight"]
    assert plan["form"] == "sum"
    words, held = _lane_words(W, V)
    acc = np.zeros((32, V, 4), np.float32)
    acc_x = np.float32(0)
    for base in range(0, len(edges), D):
        for d in range(D):  # the round's records, read from the ring
            if base + d >= len(edges):
                break
            o, xv = edges[base + d]
            eo = np.zeros((32, V, 4), np.float32)
            eo[held] = rec[o].reshape(W, 4)[words[held]]
            if kid == "K8":
                acc = _fma(rec[o, K], eo, acc)  # s_o, column K of the record
            else:
                acc = acc + eo
                acc_x = np.float32(acc_x + np.float32(xv))
    return _row_end(kid, K, acc, acc_x, es_row)


def _register_k8_row(K, rec, edges, es_row):
    """K8's register form at G = 32, V = 2 (``tail_group_kernel<5, 32, 2,
    4>``): batches of 32 edges, the edges past the row's end adding zeros,
    s_o shared from the lane holding column K, one multiply-add an element
    an edge."""
    W = -(-(K + 1) // 4)
    words, held = _lane_words(W, 2)
    acc = np.zeros((32, 2, 4), np.float32)
    for base in range(0, -(-len(edges) // 32) * 32, 32):
        for e in range(32):
            eo = np.zeros((32, 2, 4), np.float32)
            if base + e < len(edges):
                o, _ = edges[base + e]
                eo[held] = rec[o].reshape(W, 4)[words[held]]
            sv = eo[(K // 4) % 32, (K // 4) // 32, K % 4]
            acc = _fma(sv, eo, acc)
    return _row_end("K8", K, acc, 0, es_row)


def _case(kid, K, signed, seed, n_other=300):
    """Rows of LENGTHS edges, the padded record table and the self rows."""
    rng = np.random.default_rng(seed)
    n = len(LENGTHS)
    if kid == "K8":
        e_s, e_o = (rng.gamma(1.0, 1.0, (r, K)) for r in (n, n_other))
        s_o = rng.gamma(1.0, 1.0, n_other)
        rec = ext_edge.es_record(torch.from_numpy(e_o.astype(np.float32)),
                                 torch.from_numpy(s_o.astype(np.float32))).numpy()
        es = np.zeros((n, _tail.tail_stride(K)), np.float32)
        es[:, :K] = e_s
    else:
        m_o = 0.1 * rng.standard_normal((n_other, K)) if signed else \
            rng.uniform(0, 1, (n_other, K))
        b_o = 0.1 * rng.standard_normal(n_other) if signed else rng.uniform(0, 1, n_other)
        rec = ge.record_table(torch.from_numpy(m_o.astype(np.float32)),
                              torch.from_numpy(b_o.astype(np.float32))).numpy()
        es = None
    rows = [[(int(rng.integers(n_other)),
              float(rng.standard_normal() if signed else rng.integers(1, 6)))
             for _ in range(c)] for c in LENGTHS]
    return rec, es, rows


def _plain(kid, K, rec, es, rows):
    csr = (torch.tensor(np.cumsum([0] + [len(r) for r in rows])),
           torch.tensor([o for r in rows for o, _ in r], dtype=torch.int32))
    t64 = lambda a: torch.from_numpy(a).double()  # noqa: E731
    if kid == "K8":
        return ext_edge.ext_scalar_tail_plain(t64(es), t64(rec), *csr, K=K).numpy()
    x = torch.tensor([xv for r in rows for _, xv in r], dtype=torch.float64)
    return ge.bias_tail_stats_plain(t64(rec), *csr, x, K=K).numpy()


def _emulated(kid, K, rec, es, rows):
    return np.stack([_emulate_row(kid, K, rec, r, None if es is None else es[g])
                     for g, r in enumerate(rows)])


EMU_CASES = [(kid, k) for kid in KERNELS for k in sorted(
    {k for b in _tail.boundary_ks(kid) for k in (b - 1, b) if FIRST[kid] <= k <= LAST}
    | {160, 256, 511})]


@pytest.mark.parametrize("kid,K", EMU_CASES)
def test_sum_emulation_matches_the_float64_plain_version(K, kid):
    rec, es, rows = _case(kid, K, signed=False, seed=4200 + K)
    got, ref = _emulated(kid, K, rec, es, rows), _plain(kid, K, rec, es, rows)
    assert got.shape == ref.shape and np.all(got[0] == 0)  # the empty row
    assert np.all(ref >= 0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("K", [K for kid, K in EMU_CASES if kid == "K5"])
def test_k5_sum_emulation_on_signed_sums_per_column(K):
    rec, es, rows = _case("K5", K, signed=True, seed=5200 + K)
    got, ref = _emulated("K5", K, rec, es, rows), _plain("K5", K, rec, es, rows)
    scale = np.abs(ref).max(axis=0)
    assert np.all(np.abs(got - ref).max(axis=0) <= RTOL * scale)


@pytest.mark.parametrize("kid,K", [("K8", 144), ("K8", 145)] + [
    (kid, K) for kid in KERNELS for K in (160, 200, 254, 255)])
def test_sum_emulation_equals_the_register_form_in_bits(K, kid):
    """Where the register form's G = 32, V = 2 instance ran before (to K =
    255), the sum form keeps each lane's words and each word's edge order:
    equal float32 bits, signed K5 data and positive K8 data."""
    rec, es, rows = _case(kid, K, signed=kid == "K5", seed=6200 + K)
    got = _emulated(kid, K, rec, es, rows)
    if kid == "K8":
        want = np.stack([_register_k8_row(K, rec, r, es[g]) for g, r in enumerate(rows)])
    else:  # tests/test_torch_k5k6.py's emulation of the register form's walk
        no_self = np.zeros(rec.shape[1], np.float32)  # K5 reads no self row
        want = np.stack([_row_out("K5", K, _group_sums("K5", K, no_self, (rec, None), r,
                                                       len(r))) for r in rows])
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------- windows --

H100_L2 = 50 * 1024 * 1024


BENCH_NNZ = 4_738_523  # the bench tail's edges a direction


def test_window_count_on_the_bench_shapes():
    """Windows where the gathered records exceed 1.5 times the L2, on
    passes of long rows: at K = 160 the item pass (162,000 user records,
    106.3 MB; 59,000 rows of 80 edges) 3; the user pass none (59,000 item
    records, 38.7 MB; and at K = 384 91.6 MB, but 162,000 rows of 29 edges);
    none below the sum form or for other kernels; at most MAX_WINDOWS."""
    item = (BENCH_NNZ, 59_000, H100_L2)  # nnz, self rows, L2 bytes
    user = (BENCH_NNZ, 162_000, H100_L2)
    assert _tail.window_count(160, 162_000, *item, "K5") == 3
    assert _tail.window_count(160, 162_000, *item, "K8") == 3
    assert _tail.window_count(144, 162_000, *item, "K8") == 3
    assert _tail.window_count(143, 162_000, *item, "K8") == 1  # the register form
    assert _tail.window_count(160, 59_000, *user, "K8") == 1
    assert _tail.window_count(384, 59_000, *user, "K5") == 1
    assert _tail.window_count(127, 162_000, *item, "K5") == 1  # the register form
    assert _tail.window_count(160, 162_000, *item, "K6") == 1  # K5 and K8 alone
    assert _tail.window_count(511, 162_000, *item, "K5") == _tail.MAX_WINDOWS
    for k in SUM_KS["K5"][::37]:
        n = _tail.window_count(k, 162_000, *item, "K5")
        table = 162_000 * 4 * _tail.tail_stride(k + 1)
        want = 1 if table <= _tail.WINDOW_MIN_L2 * H100_L2 else min(
            _tail.MAX_WINDOWS, -(-table // int(_tail.WINDOW_L2_SHARE * H100_L2)),
            BENCH_NNZ // (59_000 * _tail.WINDOW_MIN_EDGES))
        assert n == want


def _windowed_case(seed, n_win, n_other=300):
    rng = np.random.default_rng(seed)
    rows = [[(int(rng.integers(n_other)), float(rng.standard_normal())) for _ in range(c)]
            for c in LENGTHS]
    row_ptr = torch.tensor(np.cumsum([0] + LENGTHS))
    other = torch.tensor([o for r in rows for o, _ in r], dtype=torch.int32)
    x = torch.tensor([xv for r in rows for _, xv in r], dtype=torch.float32)
    return rows, row_ptr, other, x, _tail.build_windows(row_ptr, other, x, n_other, n_win)


@pytest.mark.parametrize("n_win", [2, 3, 8])
def test_windows_regroup_each_row_by_window(n_win):
    """``build_windows``: ptr[0] and ptr[n] the row pointers; each window's
    edges of a row are that row's edges whose other id lies in the window,
    in CSR order."""
    n_other = 300
    rows, row_ptr, other, x, w = _windowed_case(11 + n_win, n_win, n_other)
    size = -(-n_other // n_win)
    assert w.n == n_win and tuple(w.ptr.shape) == (n_win + 1, len(rows))
    assert torch.equal(w.ptr[0], row_ptr[:-1]) and torch.equal(w.ptr[-1], row_ptr[1:])
    for r, edges in enumerate(rows):
        for u in range(n_win):
            lo, hi = int(w.ptr[u, r]), int(w.ptr[u + 1, r])
            want = [(o, xv) for o, xv in edges if u * size <= o < (u + 1) * size]
            got = list(zip(w.other[lo:hi].tolist(), w.x[lo:hi].tolist()))
            assert got == [(o, np.float32(xv)) for o, xv in want]


def _emulate_windowed(kid, K, rec, w, es=None):
    """The windowed sum form: each window's partial as the form walks that
    window's edges, then the row's nonempty windows' partials added in window
    order (from a zero) by the warp that arrives last."""
    rows = w.ptr.shape[1]
    out = []
    for r in range(rows):
        total = None
        for u in range(w.n):
            lo, hi = int(w.ptr[u, r]), int(w.ptr[u + 1, r])
            if lo == hi:
                continue
            edges = list(zip(w.other[lo:hi].tolist(), w.x[lo:hi].tolist()))
            part = _emulate_row(kid, K, rec, edges, None if es is None else es[r])
            total = (np.zeros_like(part) if total is None else total) + part
        width = () if kid == "K8" else (K + 2,)
        out.append(np.zeros(width, np.float32) if total is None else total)
    return np.stack(out)


@pytest.mark.parametrize("kid,K", [(kid, K) for kid in KERNELS
                                   for K in (FIRST[kid], 256, 511)])
def test_windowed_order_matches_the_float64_plain_version(K, kid):
    """The windows' order (K5 on signed Gaussian data per column, K8 on
    positive data per element) against the float64 plain version, in 3
    windows; a window count of 1 is the unwindowed form in bits."""
    rec, es, rows = _case(kid, K, signed=kid == "K5", seed=7200 + K)
    row_ptr = torch.tensor(np.cumsum([0] + LENGTHS))
    other = torch.tensor([o for r in rows for o, _ in r], dtype=torch.int32)
    x = torch.tensor([xv for r in rows for _, xv in r], dtype=torch.float32)
    ref = _plain(kid, K, rec, es, rows)
    got = _emulate_windowed(kid, K, rec, _tail.build_windows(row_ptr, other, x, 300, 3), es)
    assert got.shape == ref.shape and np.all(got[0] == 0)
    if kid == "K5":
        scale = np.abs(ref).max(axis=0)
        assert np.all(np.abs(got - ref).max(axis=0) <= RTOL * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    one = _emulate_windowed(kid, K, rec, _tail.build_windows(row_ptr, other, x, 300, 1), es)
    plain = _emulated(kid, K, rec, es, rows)
    assert np.array_equal(one.view(np.uint32), (plain + np.float32(0)).view(np.uint32))


def test_window_args_of_the_entries():
    """The entries' window arguments: none (n = 1, null pointers) without
    windows; with them the pointers, the regrouped edges, n partial rows a
    self row and a zeroed count a self row."""
    assert _tail.window_args(None, 5, 7, "cpu") == (1, None, None, None, None, None)
    assert _tail.window_args(None, 5, 1, "cpu", with_x=False) == (1, None, None, None, None)
    _, _, _, _, w = _windowed_case(3, 3)
    n, ptr, other, x, part, count = _tail.window_args(w, len(LENGTHS), 9, "cpu")
    assert (n, ptr, other, x) == (3, w.ptr, w.other, w.x)
    assert part.shape == (3, len(LENGTHS), 9) and part.dtype == torch.float32
    assert count.shape == (len(LENGTHS),) and not count.any()
    assert len(_tail.window_args(w, len(LENGTHS), 1, "cpu", with_x=False)) == 5
    with pytest.raises(ValueError, match="pointers"):
        _tail.window_args(w, len(LENGTHS) + 1, 9, "cpu")


def test_window_entries_mirror_the_kernel_source():
    """The K5 and K8 entries pass their window arguments to
    ``tail_groups::launch`` in the order ``window_args`` gives them, and the
    ctypes signatures carry them."""
    hdr = HDR
    for entry, fields in (("gaussian_edge.cu", "n_win, win_ptr, win_other, win_x, part, count"),
                          ("ext_edge.cu", "n_win, win_ptr, win_other, nullptr, part, count")):
        src = (_build.SRC_DIR / entry).read_text()
        assert f"const tail_groups::Windows win{{{fields}}};" in src, entry
    assert "struct Windows {" in hdr and "const dim3 grid((n_self + kDotWarps - 1) / " \
        "kDotWarps, win.n);" in hdr
    assert len(_build.SIGNATURES["pmf_gauss_bias"]) == 15
    assert len(_build.SIGNATURES["pmf_ext_scalar"]) == 14


# ------------------------------------------------- against the reference --

def _layouts(x):
    u, i, _ = RATINGS
    jb = j_build_blocked(u, i, x, n_users=60, n_items=40, block_users=32, block_items=32,
                         chunk_size=16, group=2, reorder=True, head=None)
    tb = t_build_blocked(u, i, x, n_users=60, n_items=40, reorder=True, head=None,
                         device="cpu")
    return jb, tb


RATINGS = synth_ratings(60, 40, 400, seed=24)
SIDES = pytest.mark.parametrize("side", ["user", "item"])


@SIDES
def test_bias_stats_at_the_first_sum_k_match_jax(side):
    """K5's pass at K = 160 (the sum form's first K; on the CPU its plain
    version) against the JAX package's Pallas pass in interpret mode, at
    the reference's precision-tier gate (1e-4 of the largest magnitude)."""
    K = FIRST["K5"]
    x = RATINGS[2]
    jb, tb = _layouts((x - x.mean()).astype(np.float32))
    jp, tp = (jb.by_user, tb.by_user) if side == "user" else (jb.by_item, tb.by_item)
    rng = np.random.default_rng(K)
    n_self, n_other = (60, 40) if side == "user" else (40, 60)
    m_s = (0.1 * rng.standard_normal((n_self, K))).astype(np.float32)
    m_o = (0.1 * rng.standard_normal((n_other, K))).astype(np.float32)
    b_o = (0.3 * rng.standard_normal(n_other)).astype(np.float32)
    ref = jge.gaussian_bias_stats(jnp.asarray(m_s), jnp.asarray(m_o), jnp.asarray(b_o), jp,
                                  precision="high", interpret=True)
    got = ge.gaussian_bias_stats(torch.from_numpy(m_s), torch.from_numpy(m_o),
                                 torch.from_numpy(b_o), tp)
    assert got.shape == ref.shape and tp.nnz > 100
    _assert_tier_gate(got.numpy(), ref, side)


@SIDES
def test_scalar_stats_at_the_first_sum_k_match_jax(side):
    """K8's pass at K = 144 (the sum form's first K) against the JAX
    package's Pallas pass in interpret mode, at the reference's engine gate
    (5e-4 / 1e-5)."""
    K = FIRST["K8"]
    jb, tb = _layouts((RATINGS[2] + 1.0).astype(np.float32))
    jp, tp = (jb.by_user, tb.by_user) if side == "user" else (jb.by_item, tb.by_item)
    rng = np.random.default_rng(K + 1)
    n_self, n_other = (60, 40) if side == "user" else (40, 60)
    es_new = rng.gamma(1.0, 1.0, (n_self, K)).astype(np.float32)
    eo = rng.gamma(1.0, 1.0, (n_other, K)).astype(np.float32)
    so = rng.gamma(1.0, 1.0, n_other).astype(np.float32)
    ref = jext.ext_scalar_stats(jnp.asarray(es_new), jnp.asarray(eo), jnp.asarray(so), jp,
                                precision="high", interpret=True)
    got = ext_edge.ext_scalar_stats(torch.from_numpy(es_new), torch.from_numpy(eo),
                                    torch.from_numpy(so), tp)
    assert got.shape == ref.shape and tp.nnz > 100
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=1e-5)
