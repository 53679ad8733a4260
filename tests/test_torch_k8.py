"""K8's row groups (mode kScalar of ``csrc/tail_groups.cuh``), on the CPU.

The launch plan K8 takes (``ops/_tail.py::launch_plan``): every column
of its [e | s] records held by exactly one (lane, word, component).  A
numpy float32 emulation of a warp of K8 row groups as the kernel computes
it (the batch loads and their broadcasts, the records in the lanes'
float4 words and s_o from the lane holding column K, each lane summing
s_o * e_o over its words in edge order, edges past a row's end adding
zeros, then the lane's dot with its words of the self row and one
in-group butterfly), and of a long row given a whole warp (contiguous
shares met by a butterfly), against the float64 plain version per
element at 1e-4 relative (the card's kernel-vs-plain tolerance).  The
plain version ignoring pad columns (and column K's s_o in the dot), the
tables built by scatter equal in bits to those built by gather, and
``ext_scalar_stats`` on the factor pass's tables and head products: equal
in bits to the pass that builds its own, with no permutation of the other
side and no head product of its own, and against the JAX package's
Pallas pass in interpret mode at the reference's engine gate (5e-4 /
1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.ops.pallas import ext_edge as jext
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.models import poisson_mf
from pmf_tpu_torch.ops import _tail, ext_edge
from tests.test_torch_k1k7 import _warp_rows

torch.set_num_threads(1)

K8_KS = [1, 4, 5, 8, 20, 32, 33, 50, 64, 128]
RTOL = 1e-4
HEADS = [None, (16, 24), [(0, 8, 40), (8, 24, 12)]]
HEAD_IDS = ["tail_only", "one_tier", "staircase"]
SIDES = pytest.mark.parametrize("side", ["user", "item"])


# ---------------------------------------------------------------- plan --

@pytest.mark.parametrize("K", K8_KS)
def test_k8_plan_covers_every_column_once(K):
    """Every column of the [e | s] records (K + 1) is held by exactly one
    (lane, word, component); K7 takes the same plan below its dot form;
    from K = 144 the sum form (``tests/test_torch_k5k8ring.py``)."""
    plan = _tail.launch_plan(K, "K8")
    G, V, W = plan["lanes"], plan["vec"], plan["words"]
    assert W == -(-(K + 1) // 4) and plan["stride"] == 4 * W == _tail.tail_stride(K + 1)
    assert G in (1, 2, 4, 8, 16, 32) and plan["rows_per_warp"] * G == 32
    assert G * V < 2 * W or G * V == 1  # the power of two at or above W
    assert plan["batch"] % G == 0 and plan["batch"] % plan["in_flight"] == 0
    held = [4 * (v * G + lane) + j for lane in range(G) for v in range(V)
            for j in range(4) if v * G + lane < W and 4 * (v * G + lane) + j < K + 1]
    assert sorted(held) == list(range(K + 1))
    if _tail.launch_plan(K, "K7")["form"] == "group":  # K7's dot form starts at 128
        assert plan == _tail.launch_plan(K, "K7")
    assert plan["form"] == "group"  # the sum form from K = 144


# ------------------------------------------------------------ emulation --

def _group_acc(K, rec, edges, span):
    """One group's (G, V, 4) sums of s_o * e_o over ``edges`` (other ids)
    as the kernel walks them: batches of B edges, lane gl loading edges
    base + gl + G q and edge e broadcast from lane e % G, ``span`` edges
    walked (past the group's own, zeros), the [e | s] record's words in
    the lanes and s_o from the lane holding column K, one product and add
    an element an edge (column K too), in edge order, in float32."""
    plan = _tail.launch_plan(K, "K8")
    G, V, W, B = plan["lanes"], plan["vec"], plan["words"], plan["batch"]
    lane_w = np.array([[v * G + gl for v in range(V)] for gl in range(G)])
    valid = lane_w < W
    eo_w = rec.reshape(rec.shape[0], W, 4)
    wb = K // 4  # the word holding column K: lane wb % G, slot wb // G
    acc = np.zeros((G, V, 4), np.float32)
    for base in range(0, span, B):
        loaded = {(gl, q): (edges[base + gl + G * q] if base + gl + G * q < len(edges)
                            else 0) for gl in range(G) for q in range(B // G)}
        for e in range(B):
            o = loaded[(e % G, e // G)]
            ok = base + e < len(edges)
            o_w = np.zeros((G, V, 4), np.float32)
            if ok:
                o_w[valid] = eo_w[o][lane_w[valid]]
            acc += o_w[wb % G, wb // G, K % 4] * o_w
    return acc


def _lane_dots(K, es_row, acc):
    """Each lane's dot of its self-row words (ceil(K / 4) of them, pad
    columns zeroed, so column K's sum of s_o^2 adds nothing) with its sums,
    added in the kernel's order: (G,)."""
    G, V, _ = acc.shape
    W = -(-K // 4)
    row = es_row.copy()
    row[K:] = 0
    part = np.zeros(G, np.float32)
    for gl in range(G):
        for v in range(V):
            w = v * G + gl
            for j in range(4):
                if w < W:
                    part[gl] += row[4 * w + j] * acc[gl, v, j]
    return part


def _butterfly(vals):
    """The xor butterfly over the leading axis: lane l adds lane l ^ off."""
    off = vals.shape[0] // 2
    while off:
        vals = vals + vals[np.arange(vals.shape[0]) ^ off]
        off //= 2
    assert np.all(vals == vals[0])
    return vals


def _emulate_warp(K, es, rec, rows):
    """One warp of K8 row groups walked together to the longest row."""
    span = max(len(r) for r in rows)
    return np.array([_butterfly(_lane_dots(K, es[g], _group_acc(K, rec, r, span)))[0]
                     for g, r in enumerate(rows)], np.float32)


def _emulate_split(K, es_row, rec, edges):
    """One long row given a whole warp: group j walks the j-th contiguous
    share, each group's dot met in the group, then the groups' by a
    butterfly over lane offsets G, 2G, ..., 16."""
    R = _tail.launch_plan(K, "K8")["rows_per_warp"]
    share = -(-len(edges) // R)
    parts = [edges[min(j * share, len(edges)):(j + 1) * share] for j in range(R)]
    span = max(len(pt) for pt in parts)
    sums = np.array([_butterfly(_lane_dots(K, es_row, _group_acc(K, rec, pt, span)))[0]
                     for pt in parts], np.float32)
    return _butterfly(sums)[0]


@pytest.mark.parametrize("K", K8_KS)
def test_k8_group_emulation_matches_the_float64_plain_version(K):
    plan = _tail.launch_plan(K, "K8")
    rng = np.random.default_rng(2000 + K)
    n_other = 300
    rows = [[o for o, _ in r] for r in _warp_rows(plan["lanes"], plan["rows_per_warp"],
                                                  n_other, rng)]
    n_rows = len(rows)
    es = np.zeros((n_rows, _tail.tail_stride(K)), np.float32)
    es[:, :K] = rng.gamma(1.0, 1.0, (n_rows, K))
    e_o = torch.from_numpy(rng.gamma(1.0, 1.0, (n_other, K)).astype(np.float32))
    s_o = torch.from_numpy(rng.gamma(1.0, 1.0, n_other).astype(np.float32))
    rec = ext_edge.es_record(e_o, s_o).numpy()
    assert rec.shape == (n_other, plan["stride"])
    rpw = plan["rows_per_warp"]
    got = np.concatenate([_emulate_warp(K, es[w0:w0 + rpw], rec, rows[w0:w0 + rpw])
                          for w0 in range(0, n_rows, rpw)])
    split = np.array([_emulate_split(K, es[g], rec, r) for g, r in enumerate(rows)])
    row_ptr = torch.tensor(np.cumsum([0] + [len(r) for r in rows]))
    other = torch.tensor([o for r in rows for o in r], dtype=torch.int32)
    ref = ext_edge.ext_scalar_tail_plain(
        torch.from_numpy(es).double(), torch.from_numpy(rec).double(), row_ptr, other,
        K=K).numpy()
    assert got.shape == ref.shape == (n_rows,)
    empty = [i for i, r in enumerate(rows) if not r]
    assert np.all(got[empty] == 0) and np.all(split[empty] == 0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    np.testing.assert_allclose(split, ref, rtol=RTOL, atol=0)


# ------------------------------------------------------- tables, plain --

def _nan_padded(t, S):
    out = torch.full((t.shape[0], S), float("nan"), dtype=t.dtype)
    out[:, : t.shape[1]] = t
    return out


@pytest.mark.parametrize("K", [5, 20, 50])
def test_k8_plain_version_ignores_pad_columns(small_ratings, K):
    u, i, x = small_ratings
    p = t_build_blocked(u, i, x + 1.0, n_users=120, n_items=80, reorder=True,
                        device="cpu").by_user
    rng = np.random.default_rng(K)
    es, eo = (torch.from_numpy(rng.gamma(1.0, 1.0, (n, K)).astype(np.float32))
              for n in (120, 80))
    so = torch.from_numpy(rng.gamma(1.0, 1.0, 80).astype(np.float32))
    S = _tail.tail_stride(K + 1) + 4  # garbage past the columns, beyond the stride too
    rec = torch.cat([eo, so[:, None]], dim=1)
    want = ext_edge.ext_scalar_tail(es, rec, p.row_ptr, p.other)
    got = ext_edge.ext_scalar_tail(_nan_padded(es, S), _nan_padded(rec, S), p.row_ptr,
                                   p.other, K=K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # column K holds s_o, which the dot leaves out: the padded record of
    # es_record gives the same sums as s_o applied apart
    padded = ext_edge.es_record(eo, so)
    assert padded.shape[1] == _tail.tail_stride(K + 1) and torch.all(padded[:, K + 1:] == 0)
    torch.testing.assert_close(ext_edge.ext_scalar_tail(es, padded, p.row_ptr, p.other),
                               want, rtol=0, atol=0)
    dots = torch.zeros(120, dtype=torch.float64)
    e64, r64 = es.double(), rec.double()
    for r in range(120):
        for j in range(int(p.row_ptr[r]), int(p.row_ptr[r + 1])):
            o = int(p.other[j])
            dots[r] += r64[o, K] * torch.dot(e64[r], r64[o, :K])
    torch.testing.assert_close(want.double(), dots, rtol=1e-5, atol=0)


@pytest.mark.parametrize("K", [3, 4, 20, 50])
def test_tail_tables_by_scatter_equal_those_by_gather(small_ratings, K):
    u, i, x = small_ratings
    tb = t_build_blocked(u, i, x + 1.0, n_users=120, n_items=80, reorder=True,
                         device="cpu")
    rng = np.random.default_rng(K)
    th, be = (torch.from_numpy(rng.random((n, K)).astype(np.float32)) for n in (120, 80))
    for p, s, o in ((tb.by_user, th, be), (tb.by_item, be, th)):
        got = _tail.tail_tables(s, o, p)
        want = (_tail.padded_rows(s, p.self_old_of_new),
                _tail.padded_rows(o, p.other_old_of_new))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            assert torch.equal(g, w)
        assert torch.equal(_tail.new_space_rows(s, p.self_new_of_old), want[0])


# ------------------------------------------- the frame on the factor pass --

def _layouts(small_ratings, head):
    u, i, x = small_ratings
    x = x + 1.0  # integer ratings: the head planes hold X exactly
    jb = j_build_blocked(u, i, x, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True, head=head,
                         head_r0=4, device="cpu")
    return jb, tb


def _pass_tables(side, K, seed):
    """(E_self, E_other, s_other, E_self_new) of one pass, float32."""
    rng = np.random.default_rng(seed)
    n_self, n_other = (120, 80) if side == "user" else (80, 120)
    g = lambda *shape: rng.gamma(1.0, 1.0, size=shape).astype(np.float32)  # noqa: E731
    return g(n_self, K), g(n_other, K), g(n_other), g(n_self, K)


@SIDES
@pytest.mark.parametrize("head", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("K", [20, 50])
def test_scalar_stats_on_the_factor_tables_match_jax(small_ratings, monkeypatch, K,
                                                     head, side):
    jb, tb = _layouts(small_ratings, head)
    es, eo, so, es_new = _pass_tables(side, K, 70 + K)
    jp, tp = (jb.by_user, tb.by_user) if side == "user" else (jb.by_item, tb.by_item)
    t = [torch.from_numpy(a) for a in (es, eo, so, es_new)]
    kw = dict(head=tb.head, head_side=side)
    *_, tables = ext_edge.ext_factor_stats(t[0], t[1], t[2], tp, keep_tables=True, **kw)
    assert len(tables.sw) == len(tb.head or ())
    built = ext_edge.ext_scalar_stats(t[3], t[1], t[2], tp, **kw)
    # On the factor pass's tables: no permutation of the other side, no
    # head product of its own.
    for name in ("es_record", "products"):
        monkeypatch.setattr(ext_edge, name, lambda *a, name=name: pytest.fail(name))
    got = ext_edge.ext_scalar_stats(t[3], t[1], t[2], tp, factor=tables, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, built)
    ref = jext.ext_scalar_stats(jnp.asarray(es_new), jnp.asarray(eo), jnp.asarray(so),
                                jp, precision="high", interpret=True, head=jb.head,
                                head_side=side)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=1e-5)


def test_extended_sweep_hands_the_factor_tables_on(small_ratings, monkeypatch):
    """Each block's scalar pass gets what its factor pass kept, and the
    sweep equals one whose scalar passes build their own, in bits."""
    u, i, x = small_ratings
    x = (x + 1.0).astype(np.float32)
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True, head=(16, 24),
                         head_r0=4, device="cpu")
    cfg = poisson_mf.PoissonMFConfig(n_factors=6, extended=True)
    state = poisson_mf.init_state(120, 80, cfg, device="cpu")
    counts = [torch.bincount(torch.from_numpy(ids), minlength=n).float()
              for ids, n in ((u, 120), (i, 80))]
    sx = [torch.bincount(torch.from_numpy(ids), weights=torch.from_numpy(x).double(),
                         minlength=n).float() for ids, n in ((u, 120), (i, 80))]
    scalar = ext_edge.ext_scalar_stats
    seen = []

    def spy(*args, factor=None, **kw):
        seen.append(factor)
        return scalar(*args, factor=factor, **kw)

    monkeypatch.setattr(ext_edge, "ext_scalar_stats", spy)
    got = poisson_mf.sweep_blocked_extended(state, tb, *counts, *sx, cfg.a0, cfg.b0)
    assert len(seen) == 2 and all(isinstance(f, ext_edge.FactorTables) for f in seen)
    monkeypatch.setattr(ext_edge, "ext_scalar_stats",
                        lambda *args, factor=None, **kw: scalar(*args, **kw))
    want = poisson_mf.sweep_blocked_extended(state, tb, *counts, *sx, cfg.a0, cfg.b0)
    assert set(got) == set(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
