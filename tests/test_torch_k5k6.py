"""K5's and K6's row groups (modes kBias and kDiag of
``csrc/tail_groups.cuh``), on the CPU.

The launch plans the two kernels take (``ops/_tail.py::launch_plan``):
every column of their [m | b] records held by exactly one (lane, word,
component), and the entry points routed through the header's plans.  A
numpy float32 emulation of a warp of K5 and K6 row groups as the kernel
computes it (the [m | b] records, and K6's sq_o = v_o + m_o^2, in the
lanes' float4 words; K6's b_o from the lane holding column K, b_s from the
self record, its dot by the in-group butterfly and its coefficient
((x - b_s) - b_o) - dot; the batch loads and their broadcasts; edges past
a row's end adding zeros; sums in edge order), and of a long row given a
whole warp (contiguous shares met by a butterfly), against the float64
plain version (K6 at K = 128: its ring form's emulation, from
``tests/test_torch_k6dot.py``): per element at 1e-4 relative on positive data, where no
sum cancels, and per column at 1e-4 of the column's largest magnitude on
signed Gaussian data (the card's criterion for these signed sums).  The
padded-table builders (``record_table``), the plain versions ignoring pad
columns, and
``gaussian_bias_stats`` / ``gaussian_diag_stats`` on the padded tables
against the JAX package's Pallas passes in interpret mode at the
reference's precision-tier gate (1e-4 of the largest magnitude per
statistic)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.data.blocked import build_blocked as j_build_blocked
from pmf_tpu.ops.pallas import gaussian_edge as jge
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import _build, _tail
from pmf_tpu_torch.ops import gaussian_edge as ge
from tests.test_torch_gaussian_edge import _assert_tier_gate
from tests.test_torch_k1k7 import PLAN_KS, _warp_rows
from tests.test_torch_k6dot import _emulate_row as emulate_ring_row

torch.set_num_threads(1)

RTOL = 1e-4
KERNELS = ["K5", "K6"]


# ---------------------------------------------------------------- plan --

@pytest.mark.parametrize("kid", KERNELS)
@pytest.mark.parametrize("K", PLAN_KS)
def test_k5_k6_plan_covers_every_column_once(K, kid):
    """Every column of the [m | b] records the kernel gathers (K + 1;
    K6's v + m^2 rows, K columns, in the same lanes' words) is held by
    exactly one (lane, word, component)."""
    plan = _tail.launch_plan(K, kid)
    G, V, W = plan["lanes"], plan["vec"], plan["words"]
    cols = K + 1
    assert plan["stride"] == _tail.tail_stride(cols) == 4 * W
    assert G in (1, 2, 4, 8, 16, 32) and plan["rows_per_warp"] * G == 32
    assert G * V < 2 * W or G * V == 1  # the power of two at or above W
    assert plan["batch"] % G == 0 and plan["batch"] % plan["in_flight"] == 0
    held = [4 * (v * G + lane) + j for lane in range(G) for v in range(V)
            for j in range(4) if v * G + lane < W and 4 * (v * G + lane) + j < cols]
    assert sorted(held) == list(range(cols))
    assert not plan["wide"] and plan["chunks"] == 1
    # the register form; from K = 128 K6's ring form (K5's sum form from 160)
    assert plan["form"] == ("ring" if kid == "K6" and K >= 128 else "group")


def test_k5_k6_plans_mirror_the_kernel_source():
    """The entry points launch modes kBias and kDiag through
    ``tail_groups::launch``; the record kernels' constants (one word a lane
    up to kRecordOneWord words, K6's kDiagInFlight edges in flight) and
    their K + 1 columns equal ``launch_plan``'s; every register-form plan
    of K5 and K6 is among the built instances (from K = 128 K6's ring form:
    ``tests/test_torch_k6dot.py``; K5's sum form:
    ``tests/test_torch_k5k8ring.py``)."""
    src = (_build.SRC_DIR / "gaussian_edge.cu").read_text()
    hdr = (_build.SRC_DIR / "tail_groups.cuh").read_text()
    for entry, mode in (("pmf_gauss_bias", "kBias"), ("pmf_gauss_diag", "kDiag")):
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[: body.index("\n}\n")]
        assert f"tail_groups::launch<tail_groups::{mode}>" in body, entry

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", hdr).group(1))

    assert const("kRecordOneWord") == _tail.RECORD_ONE_WORD
    assert const("kDiagInFlight") == _tail.DIAG_IN_FLIGHT
    # is_record(): K5, K6 and K7, K8 ([e | s]), the modes from kExt on
    assert "constexpr bool is_record(int mode) { return mode >= kExt; }" in hdr
    assert re.search(r"kExt = 2, kBias = 3, kDiag = 4, kScalar = 5 \};", hdr)
    assert "return is_record(mode) ? K + 1 : K;" in hdr  # columns()
    assert _tail.RECORD_KERNELS == (*KERNELS, "K7", "K8")
    # one_word(): only K5 and K6 take one word a lane up to kRecordOneWord
    assert "return mode == kBias || mode == kDiag ? kRecordOneWord : kOneWord;" in hdr
    assert _tail.WIDE_KERNELS == tuple(KERNELS)
    assert re.search(r"mode == kBias \? K \+ 2 :", hdr)
    built = set(re.findall(r"PMF_TAIL_PLAN\((\d+), (\d+)\)\n", hdr))
    for kid in KERNELS:
        plans = {(str(p["lanes"]), str(p["vec"])) for K in range(1, 600)
                 for p in [_tail.launch_plan(K, kid)] if p["form"] == "group"}
        assert plans <= built, kid
    with pytest.raises(ValueError, match="unknown row-group kernel"):
        _tail.launch_plan(20, "K3")


# ------------------------------------------------------------ emulation --

def _words(tab, o, lane_w, valid):
    """(G, V, 4) float32: the lanes' float4 words of row ``o`` of ``tab``
    (zeros where a lane holds no word)."""
    G, V = lane_w.shape
    out = np.zeros((G, V, 4), np.float32)
    out[valid] = tab[o].reshape(-1, 4)[lane_w[valid]]
    return out


def _group_sums(kid, K, self_row, tabs, edges, span):
    """One group's sums over ``edges`` (other id, rating) as the kernel
    walks them: batches of B edges, lane gl loading edges base + gl + G q
    and edge e broadcast from lane e % G, ``span`` edges walked (past the
    group's own, zeros), in float32.  Returns (acc_a, acc_o, acc_c, acc_x):
    K5 fills acc_o (the sums of its [m | b] records) and acc_x (sum x); K6
    acc_a, acc_o and acc_c (its three column blocks)."""
    plan = _tail.launch_plan(K, kid)
    G, V, W, B = plan["lanes"], plan["vec"], plan["words"], plan["batch"]
    f32 = np.float32
    lane_w = np.array([[v * G + gl for v in range(V)] for gl in range(G)])
    valid = lane_w < W
    mb_o, sq_o = tabs  # the [m | b] records, and K6's v + m^2 rows
    Wq = -(-K // 4)  # words of a v + m^2 row
    valid_q = lane_w < Wq
    es = np.zeros(4 * W, f32)
    es[:K] = self_row[:K]  # the kernel zeroes the self row's b and pad columns
    b_s = f32(self_row[K])
    es = _words(es[None], 0, lane_w, valid)
    acc_a, acc_o, acc_c = (np.zeros((G, V, 4), f32) for _ in range(3))
    acc_x = f32(0)
    for base in range(0, span, B):
        loaded = {(gl, q): (edges[base + gl + G * q] if base + gl + G * q < len(edges)
                            else (0, 0.0)) for gl in range(G) for q in range(B // G)}
        for e in range(B):
            o, xv = loaded[(e % G, e // G)]
            ok = base + e < len(edges)
            zero = np.zeros((G, V, 4), f32)
            eo = _words(mb_o, o, lane_w, valid) if ok else zero
            xv = f32(xv if ok else 0.0)
            if kid == "K5":
                acc_o += eo
                acc_x += xv
                continue
            # b_o: column K, from the lane holding word K // 4
            sv = eo[(K // 4) % G, (K // 4) // G, K % 4]
            sq = _words(sq_o, o, lane_w, valid_q) if ok else zero
            p = es * eo
            part = np.zeros(G, f32)
            for v in range(V):
                for j in range(4):
                    part += p[:, v, j]
            off = G // 2
            while off:  # the butterfly: lane l adds lane l ^ off
                part = part + part[np.arange(G) ^ off]
                off //= 2
            assert np.all(part == part[0])  # every lane holds one dot
            coef = ((xv - b_s) - sv) - part[0]
            acc_a += coef * eo
            acc_o += sq
            acc_c += eo * eo
    return acc_a, acc_o, acc_c, acc_x


def _row_out(kid, K, sums):
    """The output row the group's lanes write: (K + 2,) for K5, (3K,) for
    K6."""
    acc_a, acc_o, acc_c, acc_x = sums
    G, V, _ = acc_a.shape
    W = -(-(K + 1) // 4)
    out = np.zeros(K + 2 if kid == "K5" else 3 * K, np.float32)
    for gl in range(G):
        for v in range(V):
            for j in range(4):
                k = 4 * (v * G + gl) + j
                if v * G + gl < W and k < K + 1:
                    if kid == "K5":
                        out[k] = acc_o[gl, v, j]  # [sum m | sum b]
                    elif k < K:
                        out[k], out[K + k], out[2 * K + k] = (
                            acc_a[gl, v, j], acc_o[gl, v, j], acc_c[gl, v, j])
    if kid == "K5":
        out[K + 1] = acc_x
    return out


def _emulate_warp(kid, K, selfs, tabs, rows):
    """One warp of row groups: ``rows`` walked together to the longest."""
    span = max(len(r) for r in rows)
    return np.stack([_row_out(kid, K, _group_sums(kid, K, selfs[g], tabs, edges, span))
                     for g, edges in enumerate(rows)])


def _emulate_split(kid, K, self_row, tabs, edges):
    """One long row given a whole warp: group j walks the j-th contiguous
    share of ceil(n / R) edges, then the groups' sums meet by a butterfly
    over lane offsets G, 2G, ..., 16."""
    R = _tail.launch_plan(K, kid)["rows_per_warp"]
    share = -(-len(edges) // R)
    parts = [edges[min(j * share, len(edges)):(j + 1) * share] for j in range(R)]
    span = max(len(pt) for pt in parts)
    sums = [_group_sums(kid, K, self_row, tabs, pt, span) for pt in parts]
    acc = [np.stack([s[i] for s in sums]) for i in range(4)]
    step = 1
    while step < R:  # lane offset G * step: group j adds group j ^ step
        acc = [a + a[np.arange(R) ^ step] for a in acc]
        step *= 2
    return _row_out(kid, K, [a[0] for a in acc])


def _case(kid, K, signed, seed):
    """A warp's rows (lengths 0, 1, G - 1, G, 757 and short ones), padded
    tables, and the emulations against the float64 plain version."""
    plan = _tail.launch_plan(K, kid)
    rng = np.random.default_rng(seed)
    n_other, S = 300, _tail.tail_stride(K)
    rows = _warp_rows(plan["lanes"], plan["rows_per_warp"], n_other, rng)
    n_rows = len(rows)
    if signed:  # Gaussian state and centred ratings
        m_s, m_o = (0.1 * rng.standard_normal((n, K)) for n in (n_rows, n_other))
        b_s, b_o = (0.1 * rng.standard_normal(n) for n in (n_rows, n_other))
        rows = [[(o, rng.standard_normal()) for o, _ in r] for r in rows]
    else:  # every term positive: x - b_s - b_o - <m_s, m_o> >= 0.5
        m_s, m_o = (rng.uniform(0, 1 / K, (n, K)) for n in (n_rows, n_other))
        b_s, b_o = (rng.uniform(0, 0.25, n) for n in (n_rows, n_other))
        rows = [[(o, x + 1.0) for o, x in r] for r in rows]
    sq_o = rng.uniform(0.1, 0.6, (n_other, K)) + m_o * m_o
    sq_o = np.pad(sq_o, ((0, 0), (0, S - K))).astype(np.float32)

    def records(m, b):
        return ge.record_table(torch.from_numpy(m.astype(np.float32)),
                               torch.from_numpy(b.astype(np.float32))).numpy()

    mb_s, mb_o = records(m_s, b_s), records(m_o, b_o)
    tabs, selfs = (mb_o, sq_o), list(mb_s)
    rpw = plan["rows_per_warp"]
    if plan["form"] == "ring":  # K6 from K = 128: a warp a row, long rows too
        got = split = np.stack([emulate_ring_row(K, selfs[g], mb_o, sq_o, r)
                                for g, r in enumerate(rows)])
    else:
        got = np.concatenate([_emulate_warp(kid, K, selfs[w0:w0 + rpw], tabs,
                                            rows[w0:w0 + rpw])
                              for w0 in range(0, n_rows, rpw)])
        split = np.stack([_emulate_split(kid, K, selfs[g], tabs, r)
                          for g, r in enumerate(rows)])
    csr = (torch.tensor(np.cumsum([0] + [len(r) for r in rows])),
           torch.tensor([o for r in rows for o, _ in r], dtype=torch.int32),
           torch.tensor([x for r in rows for _, x in r], dtype=torch.float64))
    t64 = lambda a: torch.from_numpy(a).double()  # noqa: E731
    if kid == "K5":
        ref = ge.bias_tail_stats_plain(t64(mb_o), *csr, K=K)
    else:
        ref = ge.diag_tail_stats_plain(t64(mb_s), t64(mb_o), t64(sq_o), *csr, K=K)
    empty = [i for i, r in enumerate(rows) if not r]
    assert np.all(got[empty] == 0) and np.all(split[empty] == 0)
    return got, split, ref.numpy()


@pytest.mark.parametrize("kid", KERNELS)
@pytest.mark.parametrize("K", PLAN_KS)
def test_group_emulation_matches_the_float64_plain_version(K, kid):
    got, split, ref = _case(kid, K, signed=False, seed=2000 + K)
    assert got.shape == ref.shape and np.all(ref >= 0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    np.testing.assert_allclose(split, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("kid", KERNELS)
@pytest.mark.parametrize("K", PLAN_KS)
def test_group_emulation_on_signed_sums_per_column(K, kid):
    got, split, ref = _case(kid, K, signed=True, seed=3000 + K)
    scale = np.abs(ref).max(axis=0)
    for out in (got, split):
        assert np.all(np.abs(out - ref).max(axis=0) <= RTOL * scale)


# ------------------------------------------------------- padded tables --

def _nan_padded(t, S):
    out = torch.full((t.shape[0], S), float("nan"), dtype=t.dtype)
    out[:, : t.shape[1]] = t
    return out


@pytest.mark.parametrize("K", [5, 20, 50])
def test_plain_versions_ignore_pad_columns(small_ratings, K):
    u, i, x = small_ratings
    p = t_build_blocked(u, i, x - x.mean(), n_users=120, n_items=80, reorder=True,
                        device="cpu").by_user
    rng = np.random.default_rng(K)
    m_s = torch.from_numpy(rng.standard_normal((120, K)).astype(np.float32))
    m_o, sq_o = (torch.from_numpy(rng.standard_normal((80, K)).astype(np.float32))
                 for _ in range(2))
    b_s, b_o = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                for n in (120, 80))
    S = _tail.tail_stride(K) + 4  # garbage past K, beyond the stride too
    csr = (p.row_ptr, p.other, p.x)
    mb = torch.cat([m_o, b_o[:, None]], dim=1)
    want = ge.bias_tail_stats(mb, *csr)
    got = ge.bias_tail_stats(_nan_padded(mb, _tail.tail_stride(K + 1) + 4), *csr, K=K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    padded = ge.record_table(m_o, b_o)
    assert padded.shape == (80, _tail.tail_stride(K + 1)) and padded.data_ptr() % 16 == 0
    assert torch.all(padded[:, K + 1 :] == 0)
    torch.testing.assert_close(ge.bias_tail_stats(padded, *csr, K=K), want, rtol=0, atol=0)
    old_of_new = torch.from_numpy(rng.permutation(80))
    new_of_old = torch.empty_like(old_of_new)
    new_of_old[old_of_new] = torch.arange(80)
    torch.testing.assert_close(ge.record_table(m_o, b_o, new_of_old), padded[old_of_new],
                               rtol=0, atol=0)
    mb_s = torch.cat([m_s, b_s[:, None]], dim=1)
    S1 = _tail.tail_stride(K + 1) + 4
    want = ge.diag_tail_stats(mb_s, mb, sq_o, *csr)
    got = ge.diag_tail_stats(_nan_padded(mb_s, S1), _nan_padded(mb, S1),
                             _nan_padded(sq_o, S), *csr, K=K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _spy(monkeypatch, name, seen):
    """Record the tables' widths, K and long_rows of every call of
    ``gaussian_edge.name``."""
    fn = getattr(ge, name)

    def spy(*args, K=None, long_rows=0, **kw):  # kw: K5's windows (none on the host)
        seen.append(([a.shape[1] for a in args if a.dim() == 2], K, long_rows))
        assert kw.get("windows") is None
        return fn(*args, K=K, long_rows=long_rows, **kw)

    monkeypatch.setattr(ge, name, spy)


def _gauss_sides(small_ratings, K, head, seed):
    """(side, self (m, b, v), other (m, b, v), JAX pass, port pass) on the
    centred ratings, both directions."""
    u, i, x = small_ratings
    xc = (x - x.mean()).astype(np.float32)
    jb = j_build_blocked(u, i, xc, n_users=120, n_items=80, block_users=32,
                         block_items=32, chunk_size=16, group=2, reorder=True,
                         head=head, head_r0=4)
    tb = t_build_blocked(u, i, xc, n_users=120, n_items=80, reorder=True, head=head,
                         head_r0=4, device="cpu")
    rng = np.random.default_rng(seed)

    def tables(n):
        return (0.3 * rng.standard_normal((n, K)).astype(np.float32),
                (0.5 * rng.standard_normal(n)).astype(np.float32),
                rng.gamma(1.0, 0.5, (n, K)).astype(np.float32))

    users, items = tables(120), tables(80)
    return jb, tb, (("user", users, items, jb.by_user, tb.by_user),
                    ("item", items, users, jb.by_item, tb.by_item))


HEADS = pytest.mark.parametrize("head", [None, (16, 24)], ids=["tail_only", "head"])


@HEADS
@pytest.mark.parametrize("K", [20, 50, 70])
def test_bias_stats_on_padded_tables_match_jax(small_ratings, monkeypatch, K, head):
    jb, tb, sides = _gauss_sides(small_ratings, K, head, 80 + K)
    seen = []
    _spy(monkeypatch, "bias_tail_stats", seen)
    for side, (m_s, _, _), (m_o, b_o, _), jp, tp in sides:
        ref = jge.gaussian_bias_stats(jnp.asarray(m_s), jnp.asarray(m_o),
                                      jnp.asarray(b_o), jp, precision="high",
                                      interpret=True, head=jb.head, head_side=side)
        got = ge.gaussian_bias_stats(torch.from_numpy(m_s), torch.from_numpy(m_o),
                                     torch.from_numpy(b_o), tp, head=tb.head,
                                     head_side=side)
        assert got.shape == ref.shape
        _assert_tier_gate(got.numpy(), ref, side)
    S = _tail.tail_stride(K + 1)  # the [m | b] record
    assert seen == [([S], K, tb.by_user.long_rows), ([S], K, tb.by_item.long_rows)]


@HEADS
@pytest.mark.parametrize("K", [20, 50, 70])
def test_diag_stats_on_padded_tables_match_jax(small_ratings, monkeypatch, K, head):
    jb, tb, sides = _gauss_sides(small_ratings, K, head, 90 + K)
    seen = []
    _spy(monkeypatch, "diag_tail_stats", seen)
    for side, (m_s, b_s, _), (m_o, b_o, v_o), jp, tp in sides:
        ref = jge.gaussian_diag_stats(*(jnp.asarray(a) for a in (m_o, v_o, m_s, b_s,
                                                                 b_o)),
                                      jp, use_bias=True, precision="high",
                                      interpret=True, head=jb.head, head_side=side)
        got = ge.gaussian_diag_stats(*(torch.from_numpy(a) for a in (m_o, v_o, m_s, b_s,
                                                                     b_o)),
                                     tp, use_bias=True, head=tb.head, head_side=side)
        for n, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape
            _assert_tier_gate(g.numpy(), r, f"{side} stat {n}")
    S, S1 = _tail.tail_stride(K), _tail.tail_stride(K + 1)
    assert seen == [([S1, S1, S], K, tb.by_user.long_rows),
                    ([S1, S1, S], K, tb.by_item.long_rows)]


def test_layout_holds_both_inverse_permutations(small_ratings):
    """``other_new_of_old`` inverts ``other_old_of_new`` (the K5 and K6
    tables are scattered with it), and equals the other pass's
    ``self_new_of_old``."""
    u, i, x = small_ratings
    tb = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True, device="cpu")
    for p, q in ((tb.by_user, tb.by_item), (tb.by_item, tb.by_user)):
        n = p.n_other
        assert torch.equal(p.other_new_of_old[p.other_old_of_new], torch.arange(n))
        assert torch.equal(p.other_new_of_old, q.self_new_of_old)
        tab = torch.rand(n, 8)
        torch.testing.assert_close(_tail.scattered_rows(tab, p.other_new_of_old),
                                   tab[p.other_old_of_new], rtol=0, atol=0)


def test_diag_table_builder_leaves_the_inputs_alone(small_ratings):
    """sq = v + m^2 is built in a fresh padded table, in place there only:
    the caller's v is untouched, reordered or not, padded or not."""
    u, i, x = small_ratings
    for reorder in (True, False):
        p = t_build_blocked(u, i, x - x.mean(), n_users=120, n_items=80,
                            reorder=reorder, device="cpu").by_user
        for K in (4, 5):
            rng = np.random.default_rng(K)
            m_o, v_o = (torch.from_numpy(rng.random((80, K))) for _ in range(2))
            m_s, b_s, b_o = (torch.from_numpy(rng.random(s)) for s in ((120, K), 120, 80))
            before = v_o.clone()
            ge.gaussian_diag_stats(m_o, v_o, m_s, b_s, b_o, p)
            torch.testing.assert_close(v_o, before, rtol=0, atol=0)
