"""K6's ring form past 32 words a row (``csrc/tail_groups.cuh::
tail_ring_kernel``), on the CPU.

Its plan (``ops/_tail.py::launch_plan``, form "ring"): every column of the
[m | b] record and of the v + m^2 row held by exactly one (lane, word,
component) at every K the form takes, its ring inside a CTA's shared
memory at the widest K, and its constants and boundaries equal to the
header's.  The plans of K1 (both modes), K7, K5 and K8 at every K to 600,
and K6's below the ring form, equal to the parent's plan (the register,
dot and wide forms as they were).  A numpy float32 emulation of the form's
order (a warp a row, its edges in rounds of D, each lane's partial dot
over its words of m by multiply-adds, the transposed reduction of a
round's D dots, the coefficient ((x - b_s) - b_o) - dot taken by the lane
that holds an edge's dot, the three sums in edge order) against the
float64 plain version ``diag_tail_stats_plain`` on rows of 0, 1, 31, 32
and 757 edges: per element at 1e-4 relative on positive data, where no
sum cancels, and per column at 1e-4 of the column's largest magnitude on
signed Gaussian data (the card's criterion for these signed sums)."""

import re

import numpy as np
import pytest
import torch

from pmf_tpu_torch.ops import _build, _tail
from pmf_tpu_torch.ops import gaussian_edge as ge
from tests.test_torch_tailwide import _fma, _warp_dots

torch.set_num_threads(1)

RTOL = 1e-4
SMEM_PER_CTA = 232_448  # bytes of dynamic shared memory a CTA may ask for (H100)
HDR = (_build.SRC_DIR / "tail_groups.cuh").read_text()
RING_KS = [k for k in range(1, 601) if _tail.launch_plan(k, "K6")["form"] == "ring"]
FIRST, LAST = RING_KS[0], RING_KS[-1]


# ---------------------------------------------------------------- plan --

def test_ring_form_takes_k6_from_33_words():
    """K6 takes the ring form from K = 128 (33 words a record) to its last
    K, every K between, and no other kernel takes it."""
    assert FIRST == 128 and RING_KS == list(range(FIRST, LAST + 1))
    assert -(-(LAST + 1) // 4) == 32 * _tail.RING_MAX_VEC
    assert _tail.launch_plan(FIRST - 1, "K6")["form"] == "group"
    assert _tail.launch_plan(LAST + 1, "K6")["form"] == "wide"
    for kid in _tail.PLAN_KERNELS:
        if kid not in _tail.RING_KERNELS:
            assert all(_tail.launch_plan(k, kid)["form"] != "ring" for k in range(1, 601))


def test_ring_plan_covers_every_column_once():
    """At every K of the ring form: 32 lanes a row, V = ceil(W / 32) words
    a lane, lane l words l, l + 32, ...: each of the record's K + 1 columns
    and each of the v + m^2 row's K columns held once; the CTA's rings in
    shared memory."""
    for K in RING_KS:
        p = _tail.launch_plan(K, "K6")
        W, Wq = -(-(K + 1) // 4), -(-K // 4)
        assert p["form"] == "ring" and not p["wide"] and p["chunks"] == 1
        assert (p["lanes"], p["vec"], p["words"]) == (32, -(-W // 32), W)
        assert p["stride"] == 4 * W == _tail.tail_stride(K + 1)
        assert p["rows_per_warp"] == 1 and p["rows_per_cta"] == _tail.DOT_WARPS
        d = _tail.RING_IN_FLIGHT if p["vec"] == 2 else _tail.RING_WIDE_IN_FLIGHT
        assert (p["in_flight"], p["stages"]) == (d, _tail.RING_STAGES)
        assert p["batch"] % p["in_flight"] == 0
        for words, cols in ((W, K + 1), (Wq, K)):
            held = [4 * (32 * v + lane) + j for lane in range(32) for v in range(p["vec"])
                    for j in range(4)
                    if 32 * v + lane < words and 4 * (32 * v + lane) + j < cols]
            assert sorted(held) == list(range(cols)), K
        ring = _tail.dot_ring_words(W + Wq, d, _tail.RING_STAGES)
        assert p["smem"] == _tail.DOT_WARPS * 16 * ring


def test_ring_fits_a_cta_at_the_widest_k():
    """The widest ring of each D (at the last K of V = 2, and at the
    form's last K) inside a CTA's dynamic shared memory."""
    for d in (_tail.RING_IN_FLIGHT, _tail.RING_WIDE_IN_FLIGHT):
        ks = [k for k in RING_KS if _tail.launch_plan(k, "K6")["in_flight"] == d]
        widest = _tail.launch_plan(ks[-1], "K6")["smem"]
        assert widest == max(_tail.launch_plan(k, "K6")["smem"] for k in ks) <= SMEM_PER_CTA
    assert ks[-1] == LAST


def test_ring_form_boundaries():
    """K6's boundaries from 128: the ring form's start, each word a lane
    more, then the wide form (and its chunk boundary)."""
    bounds = [b for b in _tail.boundary_ks("K6") if b >= 128]
    vec_starts = [FIRST] + [k for k in RING_KS[1:]
                            if _tail.launch_plan(k, "K6")["vec"]
                            != _tail.launch_plan(k - 1, "K6")["vec"]]
    assert vec_starts == [128, 256, 384][: _tail.RING_MAX_VEC - 1]
    assert bounds[: len(vec_starts) + 1] == vec_starts + [LAST + 1]
    for b in bounds:
        assert _tail.launch_plan(b - 1, "K6") != _tail.launch_plan(b, "K6")


def test_ring_plan_mirrors_the_kernel_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", HDR).group(1))

    assert const("kRingInFlight") == _tail.RING_IN_FLIGHT
    assert const("kRingWideInFlight") == _tail.RING_WIDE_IN_FLIGHT
    assert const("kRingStages") == _tail.RING_STAGES
    assert const("kRingMaxVec") == _tail.RING_MAX_VEC
    assert const("kDotWarps") == _tail.DOT_WARPS
    assert _tail.RING_KERNELS == ("K6",) and "K6" not in _tail.DOT_KERNELS
    assert ("return mode == kDiag && plan_words(mode, K) > 32 && plan_words(mode, K) <= "
            "32 * kRingMaxVec;") in HDR  # plan_ring
    assert ": mode == kDiag               ? plan_words(mode, K) > 32 * kRingMaxVec" in HDR
    assert "if (!plan_dot(mode, K) && !plan_ring(mode, K) && plan_lanes(mode, K) == G" in HDR
    vecs = {_tail.launch_plan(k, "K6")["vec"] for k in RING_KS}
    built = dict(re.findall(r"case (\d+): return launch_ring<\1, (Dw?), S>", HDR))
    assert vecs == {int(v) for v in built} == set(range(2, _tail.RING_MAX_VEC + 1))
    assert built == {str(v): "D" if v == 2 else "Dw" for v in vecs}  # D at V = 2 alone
    # the launch's shared memory: the record's words and the v + m^2 row's
    assert ("const int smem = kDotWarps * 16 * dot_ring_words(plan_words(kDiag, K) + "
            "(K + 3) / 4, D, S);") in HDR
    assert "constexpr int D = kRingInFlight, Dw = kRingWideInFlight, S = kRingStages;" in HDR


def _parent_plan(k, kernel):
    """``launch_plan`` as it stood before the ring form: the register form,
    K1 "cavi"'s and K7's dot form, the wide form."""
    cols = k + 1 if kernel in ("K5", "K6", "K7", "K8") else k
    words = -(-cols // 4)
    span = 1 << (words - 1).bit_length()
    if kernel in ("K1", "K7") and 32 < words <= 128:
        return dict(form="dot", lanes=32, vec=-(-words // 32), words=words,
                    stride=4 * words, batch=32, in_flight=4, stages=3, rows_per_warp=1,
                    rows_per_cta=4, wide=False, chunks=1,
                    smem=4 * 16 * (3 * 4 * words + 3))
    if span > 64:
        summed = words if kernel == "K5" else -(-k // 4)
        return dict(form="wide", lanes=32, vec=2, words=words, stride=4 * words, batch=32,
                    in_flight=1, rows_per_warp=1, rows_per_cta=8, wide=True,
                    chunks=-(-summed // 64))
    vec = 1 if span <= (16 if kernel in ("K5", "K6") else 8) else 2
    lanes = span // vec
    return dict(form="group", lanes=lanes, vec=vec, words=words, stride=4 * words,
                batch=max(lanes, 8), in_flight=2 if kernel == "K6" else 4,
                rows_per_warp=32 // lanes, rows_per_cta=256 // lanes, wide=False, chunks=1)


@pytest.mark.parametrize("kernel", _tail.PLAN_KERNELS)
def test_other_plans_unchanged(kernel):
    """Every plan but K6's from K = 128 to the ring form's last K, and K5's
    and K8's where their sum form runs (``tests/test_torch_k5k8ring.py``),
    is the parent's, at every K to 600."""
    for k in range(1, 601):
        if kernel == "K6" and FIRST <= k <= LAST:
            continue
        if kernel in _tail.SUM_KERNELS and _tail.launch_plan(k, kernel)["form"] == "sum":
            assert 144 <= k <= 511, (kernel, k)
            continue
        assert _tail.launch_plan(k, kernel) == _parent_plan(k, kernel), (kernel, k)


# ------------------------------------------------------------ emulation --

def _emulate_row(K, mb_s, mb_o, sq_o, edges):
    """One row as its warp walks it: (3K,) float32."""
    plan = _tail.launch_plan(K, "K6")
    V, W, D = plan["vec"], plan["words"], plan["in_flight"]
    Wq = -(-K // 4)
    f32 = np.float32
    words = 32 * np.arange(V)[None, :] + np.arange(32)[:, None]  # (32, V): lane, slot
    held = words < Wq  # the words a lane sums: m's and v + m^2's
    self_row = mb_s[: 4 * Wq].copy()
    self_row[K:] = 0  # b_s and the pad zeroed
    ms = np.zeros((32, V, 4), f32)
    ms[held] = self_row.reshape(Wq, 4)[words[held]]
    b_s = f32(mb_s[K])
    mo_w = mb_o[:, : 4 * Wq].reshape(mb_o.shape[0], Wq, 4)
    sq_w = sq_o[:, : 4 * Wq].reshape(sq_o.shape[0], Wq, 4)
    acc_a, acc_o, acc_c = (np.zeros((32, V, 4), f32) for _ in range(3))
    for base in range(0, len(edges), D):
        mo = np.zeros((D, 32, V, 4), f32)
        sq = np.zeros((D, 32, V, 4), f32)
        xs, bo = np.zeros(D, f32), np.zeros(D, f32)
        for d in range(D):
            if base + d < len(edges):
                o, xv = edges[base + d]
                mo[d][held] = mo_w[o][words[held]]
                sq[d][held] = sq_w[o][words[held]]
                xs[d], bo[d] = xv, mb_o[o, K]  # b_o: column K of the record
        part = np.zeros((D, 32), f32)
        for v in range(V):
            for j in range(4):  # the lane's multiply-adds: words in order, x y z w
                part = _fma(ms[None, :, v, j], mo[:, :, v, j], part)
        dot = _warp_dots(part).reshape(D, 32 // D)
        assert np.all(dot == dot[:, :1])  # every lane of an edge's set holds its dot
        coef = ((xs - b_s) - bo) - dot[:, 0]  # the register form's float order
        for d in range(D):  # the coefficients shared, sums in edge order
            acc_a = _fma(coef[d], mo[d], acc_a)
            acc_c = _fma(mo[d], mo[d], acc_c)
            if base + d < len(edges):
                acc_o = acc_o + sq[d]
    out = np.zeros(3 * K, f32)
    for lane in range(32):
        for v in range(V):
            for j in range(4):
                k = 4 * (32 * v + lane) + j
                if 32 * v + lane < Wq and k < K:
                    out[k], out[K + k], out[2 * K + k] = (
                        acc_a[lane, v, j], acc_o[lane, v, j], acc_c[lane, v, j])
    return out


def _case(K, signed, seed):
    rng = np.random.default_rng(seed)
    n_other, lengths = 300, [0, 1, 31, 32, 757, 5]
    S = _tail.tail_stride(K)
    n = len(lengths)
    if signed:  # Gaussian state and centred ratings
        m_s, m_o = (0.1 * rng.standard_normal((r, K)) for r in (n, n_other))
        b_s, b_o = (0.1 * rng.standard_normal(r) for r in (n, n_other))
        rows = [[(int(rng.integers(n_other)), float(rng.standard_normal())) for _ in range(c)]
                for c in lengths]
    else:  # every term positive: x - b_s - b_o - <m_s, m_o> >= 1
        m_s, m_o = (rng.uniform(0, 1 / K, (r, K)) for r in (n, n_other))
        b_s, b_o = (rng.uniform(0, 0.25, r) for r in (n, n_other))
        rows = [[(int(rng.integers(n_other)), float(rng.integers(2, 7))) for _ in range(c)]
                for c in lengths]
    sq_o = rng.uniform(0.1, 0.6, (n_other, K)) + m_o * m_o
    sq_o = np.pad(sq_o, ((0, 0), (0, S - K))).astype(np.float32)

    def records(m, b):
        return ge.record_table(torch.from_numpy(m.astype(np.float32)),
                               torch.from_numpy(b.astype(np.float32))).numpy()

    mb_s, mb_o = records(m_s, b_s), records(m_o, b_o)
    got = np.stack([_emulate_row(K, mb_s[g], mb_o, sq_o, r) for g, r in enumerate(rows)])
    row_ptr = torch.tensor(np.cumsum([0] + lengths))
    other = torch.tensor([o for r in rows for o, _ in r], dtype=torch.int32)
    x = torch.tensor([xv for r in rows for _, xv in r], dtype=torch.float64)
    t64 = lambda a: torch.from_numpy(a).double()  # noqa: E731
    ref = ge.diag_tail_stats_plain(t64(mb_s), t64(mb_o), t64(sq_o), row_ptr, other, x,
                                   K=K).numpy()
    assert got.shape == ref.shape and np.all(got[0] == 0)  # the empty row
    return got, ref


EMU_KS = sorted({FIRST, 160, 255, 256, LAST})


@pytest.mark.parametrize("K", EMU_KS)
def test_ring_emulation_matches_the_float64_plain_version(K):
    got, ref = _case(K, signed=False, seed=2200 + K)
    assert np.all(ref >= 0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("K", EMU_KS)
def test_ring_emulation_on_signed_sums_per_column(K):
    got, ref = _case(K, signed=True, seed=3200 + K)
    scale = np.abs(ref).max(axis=0)
    assert np.all(np.abs(got - ref).max(axis=0) <= RTOL * scale)
