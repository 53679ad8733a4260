"""The dot form of K1 "cavi" and K7 past 32 words a row
(``csrc/tail_groups.cuh::tail_dot_kernel``), on the CPU.

Its plan (``ops/_tail.py::launch_plan``, form "dot"): every factor held by
exactly one (lane, word, component) at every K the form takes, and its
constants equal to the header's.  A numpy float32 emulation of the form's
order (a warp a row, its edges in rounds of D, each lane's partial dot
over its words by multiply-adds, the transposed reduction of a round's D
dots, the coefficient taken by the lane that holds an edge's dot, sums
linear in e_o in edge order and e_s applied at the row's end) against the
float64 plain versions at 1e-4 relative, the card's kernel-vs-plain
tolerance, on rows of 0, 1, 31, 32 and 757 edges."""

import re

import numpy as np
import pytest
import torch

from pmf_tpu_torch.ops import _build, _tail, cavi_edge, ext_edge

torch.set_num_threads(1)

RTOL = 1e-4
FLOOR = 1e-10
SMEM_PER_CTA = 232_448  # bytes of dynamic shared memory a CTA may ask for (H100)
KIND = {"cavi": "K1", "ext": "K7"}
HDR = (_build.SRC_DIR / "tail_groups.cuh").read_text()


# ---------------------------------------------------------------- plan --

@pytest.mark.parametrize("kernel", _tail.DOT_KERNELS)
def test_dot_plan_covers_every_column_once(kernel):
    """From K1's K = 129 and K7's K = 128 to K = 300 the dot form takes the
    row: 32 lanes, V = ceil(W / 32) words a lane, lane l words l, l + 32,
    ...; each of the row's columns (K7: K + 1, s_o too) held once; its
    rings fit a CTA's shared memory."""
    first = 129 if kernel == "K1" else 128
    assert _tail.launch_plan(first - 1, kernel)["form"] == "group"
    for K in range(first, 301):
        p = _tail.launch_plan(K, kernel)
        cols = _tail.columns(K, kernel)
        W = -(-cols // 4)
        assert p["form"] == "dot" and not p["wide"] and p["chunks"] == 1
        assert (p["lanes"], p["vec"], p["words"]) == (32, -(-W // 32), W)
        assert p["stride"] == 4 * W == _tail.tail_stride(cols)
        assert p["rows_per_warp"] == 1 and p["rows_per_cta"] == _tail.DOT_WARPS
        assert (p["in_flight"], p["stages"]) == (_tail.DOT_IN_FLIGHT, _tail.DOT_STAGES)
        held = [4 * (32 * v + lane) + j for lane in range(32) for v in range(p["vec"])
                for j in range(4) if 32 * v + lane < W and 4 * (32 * v + lane) + j < cols]
        assert sorted(held) == list(range(cols))
        assert p["smem"] == _tail.DOT_WARPS * 16 * _tail.dot_ring_words(W) <= SMEM_PER_CTA


@pytest.mark.parametrize("kernel", _tail.DOT_KERNELS)
def test_dot_form_boundaries(kernel):
    """The dot form's boundaries: its start, each word a lane more, and
    the wide form past 32 * DOT_MAX_VEC words; the other modes keep theirs
    (K1 raw the register form, K8 the sum form at K = 160)."""
    bounds = _tail.boundary_ks(kernel)
    want = [129, 257, 385, 513] if kernel == "K1" else [128, 256, 384, 512, 513]
    assert [b for b in bounds if b >= 128] == want
    for b in want:
        assert _tail.launch_plan(b - 1, kernel) != _tail.launch_plan(b, kernel)
    last = _tail.launch_plan(want[-1] if kernel == "K1" else 512, kernel)
    assert last["form"] == "wide" and last["words"] > 32 * _tail.DOT_MAX_VEC
    assert _tail.launch_plan(160, "K1raw")["form"] == "group"
    assert _tail.launch_plan(160, "K8")["form"] == "sum"  # K5's and K8's form past 32


def test_dot_plan_mirrors_the_kernel_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", HDR).group(1))

    assert const("kDotWarps") == _tail.DOT_WARPS
    assert const("kDotInFlight") == _tail.DOT_IN_FLIGHT
    assert const("kDotStages") == _tail.DOT_STAGES
    assert const("kDotMaxVec") == _tail.DOT_MAX_VEC
    assert "return S * D * W + (S * D + 3) / 4;" in HDR  # dot_ring_words
    assert ("return (mode == kCavi || mode == kExt) && plan_words(mode, K) > 32 &&\n"
            "         plan_words(mode, K) <= 32 * kDotMaxVec;") in HDR  # plan_dot
    assert "return (plan_words(mode, K) + 31) / 32;" in HDR  # plan_dot_vec
    # one instance a V the plan takes, and the launch's shared memory
    vecs = {_tail.launch_plan(K, kid)["vec"] for K in range(1, 600)
            for kid in _tail.DOT_KERNELS if _tail.launch_plan(K, kid)["form"] == "dot"}
    built = {int(v) for v in re.findall(r"case (\d+): return launch_dot<kMode, \1>", HDR)}
    assert vecs == built == set(range(2, _tail.DOT_MAX_VEC + 1))
    assert "const int smem = kDotWarps * 16 * dot_ring_words(plan_words(kMode, K), D, S);" in HDR


# ------------------------------------------------------------ emulation --

def _fma(a, b, c):
    """float32 a * b + c rounded once (the product of two float32 values
    is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _warp_dots(p):
    """The kernel's ``warp_dots``: p (D, 32) partial dots of D edges by
    lane; log2(D) halving steps at lane offsets 16, 8, ..., then a
    butterfly; returns (32,), lane l the dot of edge l // (32 // D)."""
    D = p.shape[0]
    lane = np.arange(32)
    p = p.copy()
    j = 0
    while D >> j > 1:
        n, off = D >> (j + 1), 16 >> j
        hi = (lane & off) != 0
        for i in range(n):
            send = np.where(hi, p[i], p[i + n])
            keep = np.where(hi, p[i + n], p[i])
            p[i] = keep + send[lane ^ off]
        j += 1
    v = p[0]
    off = 32 // D // 2
    while off:
        v = v + v[lane ^ off]
        off //= 2
    return v


def _emulate_row(mode, K, es_row, eo, edges, D=_tail.DOT_IN_FLIGHT):
    """One row as its warp walks it: (2K,) float32."""
    plan = _tail.launch_plan(K, KIND[mode])
    V, W = plan["vec"], plan["words"]
    Ws = -(-K // 4)
    f32 = np.float32
    words = 32 * np.arange(V)[None, :] + np.arange(32)[:, None]  # (32, V): lane, slot
    self_w = np.zeros((32, V, 4), f32)
    row = es_row.copy()
    row[K:] = 0  # the self row's pad columns
    ok_s = words < Ws
    self_w[ok_s] = row.reshape(Ws, 4)[words[ok_s]]
    eo_w = eo.reshape(eo.shape[0], W, 4)
    acc_a = np.zeros((32, V, 4), f32)
    acc_o = np.zeros((32, V, 4), f32)
    for base in range(0, len(edges), D):
        rows = np.zeros((D, 32, V, 4), f32)
        xs = np.zeros(D, f32)
        for d in range(D):
            if base + d < len(edges):
                o, xv = edges[base + d]
                rows[d][words < W] = eo_w[o][words[words < W]]
                xs[d] = xv
        part = np.zeros((D, 32), f32)
        for v in range(V):
            for j in range(4):  # the lane's multiply-adds: words in order, x y z w
                part = _fma(self_w[None, :, v, j], rows[:, :, v, j], part)
        dot = _warp_dots(part)
        held = dot.reshape(D, 32 // D)
        assert np.all(held == held[:, :1])  # every lane of an edge's set holds its dot
        coef = xs / np.maximum(held[:, 0], f32(FLOOR))  # one division a lane
        for d in range(D):  # the coefficients shared, sums in edge order
            acc_a = _fma(coef[d], rows[d], acc_a)
            if mode == "ext":  # s_o, column K of the record
                wk = K // 4  # word of column K: lane wk % 32, slot wk // 32
                s_o = rows[d, wk % 32, wk // 32, K % 4]
                acc_o = _fma(s_o, rows[d], acc_o)
            else:
                acc_o = acc_o + rows[d]
    out = np.zeros(2 * K, f32)
    for lane in range(32):
        for v in range(V):
            for j in range(4):
                k = 4 * (32 * v + lane) + j
                if 32 * v + lane < Ws and k < K:
                    out[k] = self_w[lane, v, j] * acc_a[lane, v, j]
                    out[K + k] = acc_o[lane, v, j]
    return out


def _dot_ks(kernel):
    """Every K of the dot form beside its boundaries (K - 1 and K), and
    K = 160 and 256."""
    ks = {160, 256}
    for b in _tail.boundary_ks(kernel):
        ks |= {k for k in (b - 1, b) if k >= 1 and _tail.launch_plan(k, kernel)["form"] == "dot"}
    return sorted(ks)


EMU_CASES = [(mode, K) for mode in ("cavi", "ext") for K in _dot_ks(KIND[mode])]


@pytest.mark.parametrize("mode,K", EMU_CASES)
def test_dot_emulation_matches_the_float64_plain_version(mode, K):
    rng = np.random.default_rng(2100 + K)
    n_other = 300
    S = _tail.launch_plan(K, KIND[mode])["stride"]
    lengths = [0, 1, 31, 32, 757, 5]
    rows = [[(int(rng.integers(n_other)), float(rng.integers(1, 6))) for _ in range(n)]
            for n in lengths]
    es = np.zeros((len(rows), _tail.tail_stride(K)), np.float32)
    eo = np.zeros((n_other, S), np.float32)
    es[:, :K] = rng.gamma(1.0, 1.0, (len(rows), K))
    eo[:, :K] = rng.gamma(1.0, 1.0, (n_other, K))
    if mode == "ext":  # K7's [e | s] records: s_o in column K
        eo[:, K] = rng.gamma(1.0, 1.0, n_other)
    got = np.stack([_emulate_row(mode, K, es[g], eo, r) for g, r in enumerate(rows)])
    row_ptr = torch.tensor(np.cumsum([0] + lengths))
    other = torch.tensor([o for r in rows for o, _ in r], dtype=torch.int32)
    x = torch.tensor([xv for r in rows for _, xv in r], dtype=torch.float64)
    es64, eo64 = torch.from_numpy(es).double(), torch.from_numpy(eo).double()
    if mode == "ext":
        ref = ext_edge.ext_factor_tail_plain(es64, eo64, row_ptr, other, x, FLOOR, K=K)
    else:
        ref = cavi_edge.tail_edge_stats_plain(es64, eo64, row_ptr, other, x, FLOOR, K=K)
    ref = ref.numpy()
    assert got.shape == ref.shape
    assert np.all(got[0] == 0)  # the empty row
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("D", [2, 4, 8, 32])
def test_warp_dots_order(D):
    """The transposed reduction sums each edge's 32 partials once: lane l
    ends with edge l // (32 // D)'s whole dot, whatever D divides 32."""
    rng = np.random.default_rng(D)
    p = rng.integers(-50, 50, (D, 32)).astype(np.float32)  # exact in float32
    got = _warp_dots(p)
    assert np.array_equal(got, np.repeat(p.sum(axis=1), 32 // D))
