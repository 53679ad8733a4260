"""K1's and K7's row groups (``csrc/tail_groups.cuh``), on the CPU.

The launch plan (``ops/_tail.py::launch_plan``, which mirrors the
kernel's choice of G lanes a row and V float4 words a lane from K): every
factor held by exactly one (lane, word, component), and its constants
equal to the header's.  A numpy float32 emulation of a warp of row groups
as the kernel computes it (each lane's partial dot over its words, the
in-group butterfly, the batch loads and their broadcasts, edges past a
row's end adding zeros, sums in edge order), and of a long row given a
whole warp (contiguous shares, the groups' sums met by a butterfly),
against the float64 plain version, per element at 1e-4 relative (the
card's kernel-vs-plain tolerance).  The padded-table builders, the plain
versions ignoring pad columns, and ``poisson_edge_stats`` /
``ext_factor_stats`` on the padded tables against the JAX package's
Pallas passes in interpret mode at the reference's engine gate (5e-4 /
1e-5)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.ops.pallas import ext_edge as jext
from pmf_tpu.ops.pallas.cavi_edge import poisson_edge_stats as j_edge_stats
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import _build, _tail, cavi_edge, ext_edge

torch.set_num_threads(1)

PLAN_KS = [1, 3, 4, 5, 8, 20, 31, 32, 33, 50, 64, 65, 100, 128]
RTOL = 1e-4
FLOOR = 1e-10


@pytest.mark.parametrize("K", PLAN_KS)
def test_launch_plan_covers_every_factor_once(K):
    plan = _tail.launch_plan(K)
    G, V, W = plan["lanes"], plan["vec"], plan["words"]
    assert G in (1, 2, 4, 8, 16, 32) and 4 * G * V >= K
    assert W == -(-K // 4) and plan["stride"] == 4 * W == _tail.tail_stride(K)
    assert G * V < 2 * W or G * V == 1  # the power of two at or above W
    assert plan["rows_per_warp"] * G == 32
    assert plan["rows_per_cta"] == plan["rows_per_warp"] * _tail.GROUP_WARPS
    assert plan["batch"] % G == 0 and plan["batch"] % plan["in_flight"] == 0
    held = [4 * (v * G + lane) + j for lane in range(G) for v in range(V)
            for j in range(4) if v * G + lane < W and 4 * (v * G + lane) + j < K]
    assert sorted(held) == list(range(K))


def test_launch_plan_mirrors_the_kernel_source():
    src = (_build.SRC_DIR / "tail_groups.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWarps") == _tail.GROUP_WARPS
    assert const("kInFlight") == _tail.GROUP_IN_FLIGHT
    assert const("kMaxSpan") == _tail.GROUP_MAX_SPAN
    assert const("kWideWords") == _tail.WIDE_WORDS
    assert const("kOneWord") == _tail.GROUP_ONE_WORD
    assert "return g < 8 ? 8 : g;" in src  # batch_of
    # K8 is mode kScalar, with K1's one word a lane up to kOneWord words
    assert "K8" in _tail.PLAN_KERNELS and "kScalar = 5" in src
    assert "return mode == kBias || mode == kDiag ? kRecordOneWord : kOneWord;" in src
    assert _tail.WIDE_KERNELS == ("K5", "K6")
    built = set(re.findall(r"PMF_TAIL_PLAN\((\d+), (\d+)\)\n", src))
    plans = {(str(p["lanes"]), str(p["vec"])) for K in range(1, 600)
             for kid in _tail.PLAN_KERNELS
             for p in [_tail.launch_plan(K, kid)] if not p["wide"]}
    assert plans == built  # every plan of the register form built, and nothing else
    with pytest.raises(ValueError, match="K >= 1"):
        _tail.launch_plan(0)


# ------------------------------------------------------------ emulation --

def _group_sums(mode, K, s_row, eo, edges, span, floor=FLOOR):
    """One group's (G, V, 4) accumulators over ``edges`` (other id, rating)
    as the kernel walks them: batches of B edges, lane gl loading edges
    base + gl + G q and edge e broadcast from lane e % G, ``span`` edges
    walked (past the group's own, zeros), each lane's partial dot over its
    words, the in-group butterfly, sums in edge order, in float32.  Mode
    "ext" (K7) reads [e | s] records ``eo`` and takes s_o from the lane
    holding column K."""
    plan = _tail.launch_plan(K, "K7" if mode == "ext" else "K1")
    G, V, W, B = plan["lanes"], plan["vec"], plan["words"], plan["batch"]
    Ws = -(-K // 4)  # words of a self row
    f32 = np.float32
    lane_w = np.array([[v * G + gl for v in range(V)] for gl in range(G)])  # (G, V)
    valid_w = lane_w < W
    valid_s = lane_w < Ws
    eo_w = eo.reshape(eo.shape[0], W, 4)
    row = s_row.copy()
    row[K:] = 0  # the kernel zeroes the self row's pad columns
    s_w = np.zeros((G, V, 4), f32)
    s_w[valid_s] = row.reshape(Ws, 4)[lane_w[valid_s]]
    wb = K // 4  # K7: the word holding s_o, lane wb % G, slot wb // G
    acc_a = np.zeros((G, V, 4), f32)
    acc_o = np.zeros((G, V, 4), f32)
    for base in range(0, span, B):
        loaded = {(gl, q): (edges[base + gl + G * q] if base + gl + G * q < len(edges)
                            else (0, 0.0)) for gl in range(G) for q in range(B // G)}
        for e in range(B):
            o, xv = loaded[(e % G, e // G)]
            ok = base + e < len(edges)
            o_w = np.zeros((G, V, 4), f32)
            if ok:
                o_w[valid_w] = eo_w[o][lane_w[valid_w]]
            xv = f32(xv if ok else 0.0)
            sv = o_w[wb % G, wb // G, K % 4] if mode == "ext" else f32(0.0)
            if mode == "raw":
                acc_a += s_w * o_w
                acc_o += o_w
                continue
            p = s_w * o_w
            part = np.zeros(G, f32)
            for v in range(V):
                for j in range(4):
                    part += p[:, v, j]
            off = G // 2
            while off:  # the butterfly: lane l adds lane l ^ off
                part = part + part[np.arange(G) ^ off]
                off //= 2
            assert np.all(part == part[0])  # every lane holds one dot
            coef = xv / np.maximum(part[0], f32(floor))
            acc_a += coef * p
            acc_o += (sv * o_w) if mode == "ext" else o_w
    return acc_a, acc_o


def _row_out(K, acc_a, acc_o):
    """The (2K,) output row the group's lanes write (columns below K)."""
    G, V, _ = acc_a.shape
    W = -(-K // 4)
    out = np.zeros(2 * K, np.float32)
    for gl in range(G):
        for v in range(V):
            for j in range(4):
                k = 4 * (v * G + gl) + j
                if v * G + gl < W and k < K:
                    out[k], out[K + k] = acc_a[gl, v, j], acc_o[gl, v, j]
    return out


def _emulate_warp(mode, K, es, eo, rows):
    """One warp of row groups: ``rows`` (per group a list of edges) walked
    together to the longest; (len(rows), 2K)."""
    span = max(len(r) for r in rows)
    return np.stack([_row_out(K, *_group_sums(mode, K, es[g], eo, edges, span))
                     for g, edges in enumerate(rows)])


def _emulate_split(mode, K, es_row, eo, edges):
    """One long row given a whole warp: group j walks the j-th contiguous
    share of ceil(n / R) edges, then the groups' sums meet by a butterfly
    over lane offsets G, 2G, ..., 16; (2K,)."""
    R = _tail.launch_plan(K, "K7" if mode == "ext" else "K1")["rows_per_warp"]
    share = -(-len(edges) // R)
    parts = [edges[min(j * share, len(edges)):(j + 1) * share] for j in range(R)]
    span = max(len(pt) for pt in parts)
    sums = [_group_sums(mode, K, es_row, eo, pt, span) for pt in parts]
    acc = [np.stack([a for a, _ in sums]), np.stack([o for _, o in sums])]
    step = 1
    while step < R:  # lane offset G * step: group j adds group j ^ step
        acc = [a + a[np.arange(R) ^ step] for a in acc]
        step *= 2
    return _row_out(K, acc[0][0], acc[1][0])


def _warp_rows(G, rows_per_warp, n_other, rng):
    """Row lengths 0, 1, G - 1, G and 757 (the longest item row of the
    benchmark's tail), the rest of the warp's rows short."""
    lengths = [0, 1, max(G - 1, 0), G, 757] + [int(n) for n in
                                               rng.integers(0, 12, rows_per_warp)]
    lengths = lengths[:max(rows_per_warp, 5)]
    return [[(int(rng.integers(n_other)), float(rng.integers(1, 6))) for _ in range(n)]
            for n in lengths]


@pytest.mark.parametrize("mode", ["cavi", "raw", "ext"])
@pytest.mark.parametrize("K", PLAN_KS)
def test_group_emulation_matches_the_float64_plain_version(K, mode):
    plan = _tail.launch_plan(K, "K7" if mode == "ext" else "K1")
    rng = np.random.default_rng(1000 + K)
    n_other, S = 300, plan["stride"]
    rows = _warp_rows(plan["lanes"], plan["rows_per_warp"], n_other, rng)
    n_rows = len(rows)
    es = np.zeros((n_rows, _tail.tail_stride(K)), np.float32)
    eo = np.zeros((n_other, S), np.float32)
    es[:, :K] = rng.gamma(1.0, 1.0, (n_rows, K))
    eo[:, :K] = rng.gamma(1.0, 1.0, (n_other, K))
    if mode == "ext":  # K7's [e | s] records: s_o in column K
        eo[:, K] = rng.gamma(1.0, 1.0, n_other)
    got = np.zeros((n_rows, 2 * K), np.float32)
    rpw = plan["rows_per_warp"]
    for w0 in range(0, n_rows, rpw):  # a warp's rows share its batch walk
        got[w0:w0 + rpw] = _emulate_warp(mode, K, es[w0:w0 + rpw], eo,
                                         rows[w0:w0 + rpw])
    # The same rows, each given a whole warp (TailCSR.long_rows).
    split = np.stack([_emulate_split(mode, K, es[g], eo, r)
                      for g, r in enumerate(rows)])
    row_ptr = torch.tensor(np.cumsum([0] + [len(r) for r in rows]))
    other = torch.tensor([o for r in rows for o, _ in r], dtype=torch.int32)
    x = torch.tensor([xv for r in rows for _, xv in r], dtype=torch.float64)
    es64, eo64 = torch.from_numpy(es).double(), torch.from_numpy(eo).double()
    if mode == "ext":
        ref = ext_edge.ext_factor_tail_plain(es64, eo64, row_ptr, other, x, FLOOR, K=K)
    else:
        ref = cavi_edge.tail_edge_stats_plain(es64, eo64, row_ptr, other, x, FLOOR,
                                              mode, K=K)
    ref = ref.numpy()
    assert got.shape == ref.shape
    empty = [i for i, r in enumerate(rows) if not r]
    assert np.all(got[empty] == 0) and np.all(split[empty] == 0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    np.testing.assert_allclose(split, ref, rtol=RTOL, atol=0)


# ------------------------------------------------------- padded tables --

@pytest.mark.parametrize("K", [3, 4, 20, 50, 70])
def test_padded_rows(K):
    rng = np.random.default_rng(K)
    tab = torch.from_numpy(rng.standard_normal((9, K)).astype(np.float32))
    rows = torch.tensor([4, 0, 8, 8, 2], dtype=torch.int32)
    S = _tail.tail_stride(K)
    for sel, want in ((None, tab), (rows, tab[rows.long()])):
        out = _tail.padded_rows(tab, sel)
        assert out.shape == (want.shape[0], S) and out.is_contiguous()
        assert out.data_ptr() % 16 == 0
        torch.testing.assert_close(out[:, :K], want, rtol=0, atol=0)
        assert torch.all(out[:, K:] == 0)


def test_tail_tables_follow_the_pass(small_ratings):
    u, i, x = small_ratings
    rng = np.random.default_rng(3)
    th = torch.from_numpy(rng.random((120, 5)))
    be = torch.from_numpy(rng.random((80, 5)))
    for reorder in (True, False):
        tb = t_build_blocked(u, i, x + 1.0, n_users=120, n_items=80, reorder=reorder,
                             device="cpu")
        for p, s, o in ((tb.by_user, th, be), (tb.by_item, be, th)):
            ts, to = _tail.tail_tables(s, o, p)
            assert ts.shape == (s.shape[0], 8) and to.shape == (o.shape[0], 8)
            if reorder:
                s, o = s[p.self_old_of_new.long()], o[p.other_old_of_new.long()]
            torch.testing.assert_close(ts[:, :5], s, rtol=0, atol=0)
            torch.testing.assert_close(to[:, :5], o, rtol=0, atol=0)


def _nan_padded(t, S):
    out = torch.full((t.shape[0], S), float("nan"), dtype=t.dtype)
    out[:, : t.shape[1]] = t
    return out


@pytest.mark.parametrize("K", [5, 20, 50])
def test_plain_versions_ignore_pad_columns(small_ratings, K):
    u, i, x = small_ratings
    tb = t_build_blocked(u, i, x + 1.0, n_users=120, n_items=80, reorder=True,
                         device="cpu")
    rng = np.random.default_rng(K)
    p = tb.by_user
    es = torch.from_numpy(rng.gamma(1.0, 1.0, (120, K)).astype(np.float32))
    eo = torch.from_numpy(rng.gamma(1.0, 1.0, (80, K)).astype(np.float32))
    so = torch.from_numpy(rng.gamma(1.0, 1.0, 80).astype(np.float32))
    S = _tail.tail_stride(K) + 4  # garbage past K, beyond the stride too
    pes, peo = _nan_padded(es, S), _nan_padded(eo, S)
    for mode in cavi_edge.MODES:
        want = cavi_edge.tail_edge_stats(es, eo, p.row_ptr, p.other, p.x, mode=mode)
        got = cavi_edge.tail_edge_stats(pes, peo, p.row_ptr, p.other, p.x, mode=mode,
                                        K=K)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    rec = torch.cat([eo, so[:, None]], dim=1)  # K7's [e | s] records
    want = ext_edge.ext_factor_tail(es, rec, p.row_ptr, p.other, p.x)
    got = ext_edge.ext_factor_tail(pes, _nan_padded(rec, S + 4), p.row_ptr, p.other, p.x,
                                   K=K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------- the frames against the JAX package --

def _spy(monkeypatch, module, name, seen):
    """Record the width and K of every call of ``module.name``."""
    fn = getattr(module, name)

    def spy(e_self, e_other, *args, K=None, **kw):
        seen.append((e_self.shape[1], e_other.shape[1], K))
        return fn(e_self, e_other, *args, K=K, **kw)

    monkeypatch.setattr(module, name, spy)


def _layouts(small_ratings, head=(16, 24)):
    u, i, x = small_ratings
    x = x + 1.0
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True, head=head,
                         head_r0=4, device="cpu")
    return jb, tb


@pytest.mark.parametrize("K", [20, 50, 70])
def test_poisson_edge_stats_on_padded_tables_match_jax(small_ratings, monkeypatch, K):
    jb, tb = _layouts(small_ratings)
    rng = np.random.default_rng(40 + K)
    th = rng.gamma(1.0, 1.0, (120, K)).astype(np.float32)
    be = rng.gamma(1.0, 1.0, (80, K)).astype(np.float32)
    seen = []
    _spy(monkeypatch, cavi_edge, "tail_edge_stats", seen)
    for side, es, eo, jp, tp in (("user", th, be, jb.by_user, tb.by_user),
                                 ("item", be, th, jb.by_item, tb.by_item)):
        ref = j_edge_stats(jnp.asarray(es), jnp.asarray(eo), jp, interpret=True,
                           precision="high", head=jb.head, head_side=side)
        got = cavi_edge.poisson_edge_stats(torch.from_numpy(es), torch.from_numpy(eo),
                                           tp, head=tb.head, head_side=side)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=1e-5,
                                       err_msg=side)
    S = _tail.tail_stride(K)
    assert seen == [(S, S, K)] * 2


@pytest.mark.parametrize("K", [20, 50, 70])
def test_ext_factor_stats_on_padded_tables_match_jax(small_ratings, monkeypatch, K):
    jb, tb = _layouts(small_ratings)
    rng = np.random.default_rng(60 + K)
    th = rng.gamma(1.0, 1.0, (120, K)).astype(np.float32)
    be = rng.gamma(1.0, 1.0, (80, K)).astype(np.float32)
    phi = rng.gamma(1.0, 1.0, 120).astype(np.float32)
    psi = rng.gamma(1.0, 1.0, 80).astype(np.float32)
    seen = []
    _spy(monkeypatch, ext_edge, "ext_factor_tail", seen)  # the self rows, the records
    for side, es, eo, so, jp, tp in (("user", th, be, psi, jb.by_user, tb.by_user),
                                     ("item", be, th, phi, jb.by_item, tb.by_item)):
        ref = jext.ext_factor_stats(jnp.asarray(es), jnp.asarray(eo), jnp.asarray(so),
                                    jp, precision="high", interpret=True, head=jb.head,
                                    head_side=side)
        got = ext_edge.ext_factor_stats(*(torch.from_numpy(t) for t in (es, eo, so)),
                                        tp, head=tb.head, head_side=side)
        for g, r, name in zip(got, ref, ("S_alloc", "S_wother")):
            assert g.shape == r.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=1e-5,
                                       err_msg=f"{side} {name}")
    assert seen == [(_tail.tail_stride(K), _tail.tail_stride(K + 1), K)] * 2
