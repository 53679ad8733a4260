"""K3's wide forms (K > 128), on the CPU.

``csrc/gaussian_edge.cu`` runs K3 past K = 128 in one of two forms that
``ops/gaussian_edge.py::factor_plan`` picks from the data: the slab form
(chunks of 512 .. 64 record floats whose column slab fits the L2, each
row's edges summed in CSR order) and the group form (32 self rows a CTA,
each distinct other row of the group staged once into shared memory a
window of 64 at a time, each row's edges summed in the order of their
other ids).  No card here: numpy emulations of both schedules, step for
step (chunks, rows, edges in flight, windows and slots), held to
``factor_tail_stats_plain`` in float64 (1e-12 of a column's largest entry)
and, summing in float32 as the kernels do, in bits to the plain version
over each form's order of edges; the group form's schedule on its
invariants over empty rows, rows past a window, groups that share every
other row or none, a band and TP bucket pieces; the pair count against a
brute-force count; ``factor_plan`` against the C host plan block built
with g++; and both emulations through ``gaussian_factor_stats`` against the
JAX factor pass (interpret mode) at K = 129, at the precision-tier gate."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pmf_tpu_torch.data.blocked import TailCSR, band_of
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.ops import _build
from pmf_tpu_torch.ops import gaussian_edge as ge
from pmf_tpu_torch.parallel.tp_blocked import _bucket

torch.set_num_threads(1)

WIDE_KS = [129, 160, 256, 300]
# The wide side of every boundary of factor_boundary_ks() past 128 (129,
# and 511 | 512, where b leaves the slab form's widest chunk); K = 128 keeps
# the chunked form (tests/test_torch_k3k4.py, the plan test below).
EDGE_KS = [129, 511, 512]
F64_RTOL = 1e-12  # float64 sums in another order, of a column's largest entry
H100_L2 = ge.H100_L2_BYTES


def _tail(rows, n_other, seed=0) -> TailCSR:
    """A CSR tail from per-row lists of other ids, N(0, 1) ratings."""
    counts = np.array([len(r) for r in rows], np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    other = np.concatenate([np.asarray(r, np.int32) for r in rows] + [np.zeros(0, np.int32)])
    x = np.random.default_rng(seed).standard_normal(len(other)).astype(np.float32)
    none = torch.empty(0, dtype=torch.int64)
    return TailCSR(row_ptr=torch.from_numpy(row_ptr), other=torch.from_numpy(other),
                   x=torch.from_numpy(x), self_old_of_new=none, other_old_of_new=none,
                   self_new_of_old=none, other_new_of_old=none, n_self=len(rows),
                   n_other=n_other, nnz=len(other), reordered=False)


def _cases():
    """name -> TailCSR: the small layout's two directions, and CSRs built
    for the schedule's edge cases."""
    rng = np.random.default_rng(5)
    out = {}
    u, i, x = (rng.integers(0, 120, 1500), rng.integers(0, 80, 1500),
               rng.standard_normal(1500).astype(np.float32))
    lay = t_build_blocked(u, i, x, n_users=120, n_items=80, reorder=True, device="cpu")
    out["by_user"], out["by_item"] = lay.by_user, lay.by_item
    # empty rows between full ones; a row far past a window of 64 slots
    rows = [list(rng.integers(0, 300, 5)) if r % 3 else [] for r in range(70)]
    rows[10] = list(rng.permutation(300)[:200]) + [7, 7, 7]  # duplicates kept
    out["empty_and_long"] = _tail(rows, 300, 1)
    # a group whose 64 rows share every other row, then one that shares none
    share = [list(rng.permutation(12)) for _ in range(64)]
    none = [[64 + 3 * r, 65 + 3 * r, 66 + 3 * r] for r in range(64)]
    out["share_all_then_none"] = _tail(share + none, 64 + 3 * 64, 2)
    out["band"] = band_of(lay.by_item, 17, 71)
    out["tp_pieces"] = _bucket(lay.by_user, (), 4).tail
    return out


CASES = _cases()


def _table(n_other, K, seed):
    rng = np.random.default_rng(seed)
    aug = (rng.standard_normal((n_other, ge.factor_stride(K))) * 0.3).astype(np.float32)
    aug[:, K + 1 + ge.tri_size(K):] = 0
    return aug


def _store(out_row, acc, acc_m, acc_x, K, wbs, first):
    """The kernels' store_wide over a whole record's floats c (0 .. stride)."""
    T = ge.tri_size(K)
    out_row[:K] = acc[:K]
    out_row[K : 2 * K] = acc_m
    out_row[2 * K : 2 * K + T] = acc[K + 1 : K + 1 + T]
    if wbs:
        out_row[2 * K + T + 1] = acc[K]
        if first:
            out_row[2 * K + T] = acc_x


def emulate_slab(aug, p, K, wbs, plan, dtype=np.float64):
    """The slab kernel of ``plan``: per chunk of ``plan["chunk"]`` floats
    (blocks chunk-major) and self row, the row's lanes read ``lanes`` ids
    and ratings at a time and load ``edges`` records before adding them, in
    CSR order; b_o is read only in chunks that hold factors, x summed only
    in the first.  Every chunk's floats are independent, so the chunks are
    emulated side by side on the whole record; returns (out, b_o reads)."""
    assert plan["form"] == "slab"
    tab = aug.astype(dtype)
    rp, ot, xs = p.row_ptr.numpy(), p.other.numpy(), p.x.numpy().astype(dtype)
    stride, W, E, LPR = plan["stride"], plan["chunk"], plan["edges"], plan["lanes"]
    assert plan["chunks"] * W >= stride > (plan["chunks"] - 1) * W
    f_chunks = -(-K // W)  # chunks with a factor: the only ones that read b_o
    T = ge.tri_size(K)
    out = np.zeros((p.rows, 2 * K + T + (2 if wbs else 0)), dtype)
    b_reads = 0
    for r in range(p.rows):
        acc, acc_m, acc_x = (np.zeros(stride, dtype), np.zeros(K, dtype), dtype(0))
        for base in range(rp[r], rp[r + 1], LPR):
            n = min(LPR, rp[r + 1] - base)
            for j in range(0, n, E):
                cnt = min(E, n - j)
                loads = [(tab[ot[base + j + q]], tab[ot[base + j + q], K], xs[base + j + q])
                         for q in range(cnt)]
                b_reads += cnt * f_chunks
                for v, b_o, xv in loads:
                    _add(acc, acc_m, v, dtype(xv - b_o), K)
                    acc_x += xv
        _store(out[r], acc, acc_m, acc_x, K, wbs, True)
    return out, b_reads


def _add(acc, acc_m, v, r, K):
    """The kernels' add_wide over a whole record: the factors (floats < K)
    summed into acc_m and, each product rounded, weighted by r = x - b_o
    into acc; the other floats into acc as they are."""
    acc_m += v[:K]
    acc[:K] += v[:K] * r
    acc[K:] += v[K:]


def emulate_group(aug, sched, K, wbs, dtype=np.float64):
    """The group kernel: per chunk (emulated side by side on the whole
    record) and group of FACTOR_GROUP_ROWS rows, each window's distinct
    other rows staged (record and b_o) into slots, then warp w's rows
    R w .. R w + R - 1 (R = rows / 8) in turn, each row's edges of the
    window FACTOR_GROUP_EDGES at a time from a batch of 32 slots and ratings
    read at the edge where the next group would leave it; every slot read
    must be staged."""
    G, S, E = ge.FACTOR_GROUP_ROWS, ge.FACTOR_GROUP_SLOTS, ge.FACTOR_GROUP_EDGES
    R = G // 8
    tab = aug.astype(dtype)
    stride = tab.shape[1]
    gp_other, gp_ptr, gw_ptr, w_off, e_slot, e_x = (t.numpy() for t in sched.arrays())
    e_x = e_x.astype(dtype)
    T = ge.tri_size(K)
    out = np.zeros((sched.rows, 2 * K + T + (2 if wbs else 0)), dtype)
    for g in range(len(gp_ptr) - 1):
        dist = gp_other[gp_ptr[g] : gp_ptr[g + 1]]
        n_win = -(-len(dist) // S)
        assert gw_ptr[g + 1] - gw_ptr[g] == n_win
        acc = np.zeros((G, stride), dtype)
        acc_m = np.zeros((G, K), dtype)
        acc_x = np.zeros(G, dtype)
        for w in range(n_win):
            staged = dist[w * S : (w + 1) * S]
            buf, bsm = tab[staged], tab[staged, K]
            for warp in range(8):
                off0 = (gw_ptr[g] + w) * G + warp * R
                offs = w_off[off0 : off0 + R + 1]
                e, w_end = offs[0], offs[R]

                def edge(row, i):
                    slot = e_slot[i]
                    assert 0 <= slot < len(staged)
                    _add(acc[row], acc_m[row], buf[slot], dtype(e_x[i] - bsm[slot]), K)
                    acc_x[row] += e_x[i]

                base = e
                for rr in range(R):
                    while e < offs[rr + 1]:
                        cnt = min(E, offs[rr + 1] - e)
                        if e + cnt > base + 32:
                            base = e
                        assert base <= e and e + cnt <= min(base + 32, w_end)
                        for q in range(cnt):
                            edge(warp * R + rr, e + q)
                        e += cnt
        for row in range(G):
            if g * G + row < sched.rows:
                _store(out[g * G + row], acc[row], acc_m[row], acc_x[row], K, wbs, True)
    return out


def _plain(aug, p, K, wbs, dtype=torch.float64):
    return ge.factor_tail_stats_plain(torch.from_numpy(aug).to(dtype), p.row_ptr, p.other,
                                      p.x, K, wbs).numpy()


def _close(got, ref, what):
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-300)
    err = (np.abs(got - ref).max(axis=0) / scale).max() if ref.size else 0.0
    assert err <= F64_RTOL, f"{what}: {err}"


def _sorted_by_other(p: TailCSR) -> TailCSR:
    """The same CSR with each row's edges in the order of their other ids
    (stable): the group form's order of sums."""
    rp = p.row_ptr.numpy()
    rows = np.repeat(np.arange(p.rows), np.diff(rp))
    order = np.lexsort((np.arange(p.nnz), p.other.numpy(), rows))
    return dataclasses.replace(p, other=p.other[torch.from_numpy(order)].contiguous(),
                               x=p.x[torch.from_numpy(order)].contiguous())


# ------------------------------------------------------------- the plan --

def _c_plan(tmp_path):
    """``csrc/gaussian_edge.cu``'s host plan block built alone with the host
    compiler: (K, n_other, nnz, pairs, l2) -> (form, chunk, lanes, edges,
    rows, smem, stride)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = (_build.SRC_DIR / "gaussian_edge.cu").read_text()
    block = text[text.index("// BEGIN host plan"):text.index("// END host plan")]
    src = tmp_path / "k3_plan.cpp"
    src.write_text("#include <stdint.h>\nnamespace {\n" + block + "}\n"
                   'extern "C" void plan(int K, int64_t n_other, int64_t nnz, int64_t pairs,'
                   " int64_t l2, int64_t* o) {\n"
                   "  const FactorPlan p = factor_plan(K, n_other, nnz, pairs, l2);\n"
                   "  o[0] = p.form; o[1] = p.chunk; o[2] = p.lanes; o[3] = p.edges;\n"
                   "  o[4] = p.rows; o[5] = p.smem; o[6] = factor_stride_of(K);\n}\n")
    lib = tmp_path / "libk3_plan.so"
    subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).plan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_int64] * 4 + [ctypes.POINTER(ctypes.c_int64)]

    def plan(*args):
        out = (ctypes.c_int64 * 7)()
        fn(*args, out)
        return tuple(out)
    return plan


@pytest.mark.parametrize("K", [1, 30, 31, 64, 128, 129, 160, 256, 300, 511, 512, 1000])
def test_factor_plan_matches_the_c_host_plan(tmp_path, K):
    """Every form on both sides of each slab chunk's L2 edge (n_other at
    the last row a chunk's slab fits, and one past) and of the group
    threshold (2 edges a pair, and one pair more)."""
    plan = _c_plan(tmp_path)
    n_edges = [H100_L2 // 2 // (4 * c) + d for c in (64, 128, 256, 512) for d in (0, 1)]
    for n_other in [1, 3706, 6040, 59_000, 162_000, 10**7] + n_edges:
        for nnz, pairs in ((1000, 0), (1000, 500), (1000, 501), (4_738_523, 4_500_000),
                           (990_209, 200_000)):
            for l2 in (H100_L2, 40 * 2**20):
                p = ge.factor_plan(K, n_other, nnz, pairs, l2)
                got = plan(K, n_other, nnz, pairs, l2)
                assert got == (ge.FACTOR_FORMS.index(p["form"]), p["chunk"], p["lanes"],
                               p["edges"], p["rows"], p["smem_bytes"], p["stride"]), \
                    (K, n_other, nnz, pairs, l2)
                assert p["chunks"] == -(-p["stride"] // p["chunk"])


def test_factor_plan_on_the_real_shapes():
    """The bench tail (59,000 and 162,000 other rows, about 1.05 edges a
    pair) takes the slab form at 128 and 64 floats on an H100's L2; the
    XL CSR's shape (3,706 and 6,040 other rows, about 5 edges a pair) the
    group form; K <= 128 keeps its forms whatever the data."""
    for n_other, chunk in ((59_000, 128), (162_000, 64)):
        p = ge.factor_plan(160, n_other, 4_738_523, 4_500_000)
        assert (p["form"], p["chunk"], p["lanes"], p["edges"], p["rows"]) == (
            "slab", chunk, chunk // 16, 2, 8 * 32 // (chunk // 16))
    assert ge.factor_plan(160, 25_600, 10, 9)["chunk"] == 512
    assert ge.factor_plan(160, 51_200, 10, 9)["chunk"] == 256
    assert ge.factor_plan(160, 102_400, 10, 9)["chunk"] == 128
    for n_other in (3706, 6040):
        p = ge.factor_plan(256, n_other, 990_209, 200_000)
        assert (p["form"], p["chunk"], p["rows"], p["smem_bytes"]) == (
            "group", 128, 32, 2 * 64 * 129 * 4)
    assert ge.factor_plan(128, 10, 1000, 1)["form"] == "chunked"
    assert ge.factor_plan(30, 10, 1000, 1)["form"] == "whole"
    assert ge.factor_plan(129, 10, 1000, 500)["form"] == "group"
    assert ge.factor_plan(129, 10, 1000, 501)["form"] == "slab"
    assert ge.factor_boundary_ks() == [1, 31, 129, 512]


# ---------------------------------------------------------- the schedule --

@pytest.mark.parametrize("case", sorted(CASES))
def test_group_pairs_match_a_brute_force_count(case):
    p = CASES[case]
    rp, ot = p.row_ptr.numpy(), p.other.numpy()
    brute = len({(r // ge.FACTOR_GROUP_ROWS, int(o)) for r in range(p.rows)
                 for o in ot[rp[r] : rp[r + 1]]})
    assert ge.group_pairs(p.row_ptr, p.other, p.n_other) == brute
    s = ge.build_factor_schedule(p.row_ptr, p.other, p.x, p.n_other, grouped=True)
    assert s.pairs == brute and s.gp_other.numel() == brute
    K = 129
    r = ge.factor_reckoning(p, K)
    T = ge.tri_size(K)
    fixed = p.nnz * 8 + p.n_self * 4 * (2 * K + T)
    assert r["grouped"] == fixed + brute * 4 * (K + 1 + T)
    chunks = -(-ge.factor_stride(K) // ge.factor_plan(K, p.n_other)["chunk"])
    assert r["csr_rereads"] == p.nnz * 8 * (chunks - 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_schedule_holds_each_edge_once_in_its_window(case):
    """Each edge once, in the slot of its other row in its group's window;
    each group's distinct other rows ascending; each (window, row) cell's
    edges contiguous and in the order of their other ids; a second build
    equal; the schedule kept on the TailCSR and not carried by replace."""
    p = CASES[case]
    G, S = ge.FACTOR_GROUP_ROWS, ge.FACTOR_GROUP_SLOTS
    s = ge.build_factor_schedule(p.row_ptr, p.other, p.x, p.n_other, grouped=True)
    again = ge.build_factor_schedule(p.row_ptr, p.other, p.x, p.n_other, grouped=True)
    assert all(torch.equal(a, b) for a, b in zip(s.arrays(), again.arrays()))
    gp_other, gp_ptr, gw_ptr, w_off, e_slot, e_x = (t.numpy() for t in s.arrays())
    rp, ot, xs = p.row_ptr.numpy(), p.other.numpy(), p.x.numpy()
    assert w_off[-1] == p.nnz and len(w_off) == gw_ptr[-1] * G + 1
    seen = []
    for g in range(len(gp_ptr) - 1):
        dist = gp_other[gp_ptr[g] : gp_ptr[g + 1]]
        assert (np.diff(dist) > 0).all()
        for w in range(gw_ptr[g], gw_ptr[g + 1]):
            for r in range(G):
                row = g * G + r
                a, b = w_off[w * G + r], w_off[w * G + r + 1]
                if row >= p.rows:
                    assert a == b
                    continue
                others = dist[(w - gw_ptr[g]) * S + e_slot[a:b]]
                assert (e_slot[a:b] < S).all() and (np.diff(others) >= 0).all()
                seen += [(row, int(o), float(v)) for o, v in zip(others, e_x[a:b])]
    edges = [(r, int(o), float(v)) for r in range(p.rows)
             for o, v in zip(ot[rp[r] : rp[r + 1]], xs[rp[r] : rp[r + 1]])]
    assert sorted(seen) == sorted(edges)
    q = dataclasses.replace(p)
    assert ge.factor_schedule(p) is ge.factor_schedule(p)
    assert "_factor_schedule" not in dataclasses.replace(p).__dict__ and q is not p


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plan_takes_the_group_form_where_rows_share(case):
    p = CASES[case]
    s = ge.factor_schedule(p)
    plan = ge.factor_plan(160, p.n_other, p.nnz, s.pairs)
    assert s.grouped == (plan["form"] == "group")
    assert s.grouped == (p.nnz >= 2 * s.pairs > 0)


# -------------------------------------------------------- the emulations --

def _slab_case(name, K, chunk, wbs_all=(False, True)):
    p = CASES[name]
    aug = _table(p.n_other, K, K + chunk)
    plan = ge.factor_plan(K, p.n_other, l2_bytes=p.n_other * chunk * 4)
    assert plan["chunk"] == chunk
    for wbs in wbs_all:
        got, b_reads = emulate_slab(aug, p, K, wbs, plan)
        _close(got, _plain(aug, p, K, wbs), f"{name} K={K} chunk {chunk}")
        assert b_reads == p.nnz * -(-K // chunk)


@pytest.mark.parametrize("K", WIDE_KS)
@pytest.mark.parametrize("chunk", [64, 128, 256, 512])
def test_slab_emulation_matches_plain(K, chunk):
    """The slab form at ``chunk`` (its plan for a table whose slabs of that
    width fill the L2) against the plain version in float64, with the
    bias-stat columns: a direction of the small layout, its TP pieces, and
    empty rows beside a long one."""
    for name in ("by_user", "tp_pieces", "empty_and_long"):
        _slab_case(name, K, chunk, (True,))


@pytest.mark.parametrize("K", EDGE_KS)
@pytest.mark.parametrize("chunk", [64, 512])
def test_slab_emulation_on_both_sides_of_the_boundaries(K, chunk):
    """At 129 and 511 | 512 (b_o past the widest chunk), both column sets."""
    _slab_case("empty_and_long", K, chunk)


def _group_case(name, K, wbs_all=(False, True)):
    p = CASES[name]
    aug = _table(p.n_other, K, K)
    s = ge.build_factor_schedule(p.row_ptr, p.other, p.x, p.n_other, grouped=True)
    for wbs in wbs_all:
        _close(emulate_group(aug, s, K, wbs), _plain(aug, p, K, wbs), f"{name} K={K}")


@pytest.mark.parametrize("K", WIDE_KS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_group_emulation_matches_plain(K, case):
    _group_case(case, K, (True,))


@pytest.mark.parametrize("K", EDGE_KS)
@pytest.mark.parametrize("case", ["empty_and_long", "share_all_then_none"])
def test_group_emulation_on_both_sides_of_the_boundaries(K, case):
    _group_case(case, K)



@pytest.mark.parametrize("case", sorted(CASES))
def test_each_form_sums_in_its_order_in_float32(case):
    """Summing in float32 with every product rounded (as the kernels do
    without contraction), the slab form equals the plain version on the CSR
    in bits and the group form the plain version on the CSR with each row's
    edges in the order of their other ids."""
    p, K = CASES[case], 129
    aug = _table(p.n_other, K, 3)
    plan = ge.factor_plan(K, p.n_other, l2_bytes=0)
    s = ge.build_factor_schedule(p.row_ptr, p.other, p.x, p.n_other, grouped=True)
    for wbs in (False, True):
        slab, _ = emulate_slab(aug, p, K, wbs, plan, np.float32)
        assert np.array_equal(slab, _plain(aug, p, K, wbs, torch.float32))
        group = emulate_group(aug, s, K, wbs, np.float32)
        assert np.array_equal(group, _plain(aug, _sorted_by_other(p), K, wbs, torch.float32))


@pytest.mark.parametrize("form", ["slab", "group"])
def test_wide_forms_match_the_jax_factor_pass(monkeypatch, small_ratings, form):
    """``gaussian_factor_stats`` with its tail pass run by the emulation of
    each form against the JAX factor pass (Pallas interpret mode) at
    K = 129, both directions, with the bias statistics, at the
    precision-tier gate (1e-4 of each statistic's largest entry)."""
    from pmf_tpu.ops.pallas import gaussian_edge as jge
    from tests.test_torch_bigk import _gauss_case, _t, _tier_gate

    K = 129

    def tail_pass(aug, row_ptr, other, x, K, wbs=False, schedule=None):
        p = _tail([[0]], 1)  # row_ptr, other, x of the call
        p = dataclasses.replace(p, row_ptr=row_ptr, other=other, x=x,
                                n_self=row_ptr.shape[0] - 1, n_other=aug.shape[0],
                                nnz=other.shape[0])
        a = aug.numpy()
        if form == "slab":
            out, _ = emulate_slab(a, p, K, wbs, ge.factor_plan(K, p.n_other, l2_bytes=0))
        else:
            out = emulate_group(a, ge.build_factor_schedule(row_ptr, other, x, p.n_other,
                                                            grouped=True), K, wbs)
        return torch.from_numpy(out.astype(np.float32))

    monkeypatch.setattr(ge, "factor_tail_stats", tail_pass)
    sides, jb, tb = _gauss_case(small_ratings, K, 3 * K)
    for side, (_, _, b_s, _), (m_o, V_o, b_o, _), jp, tp in sides:
        ref = jge.gaussian_factor_stats(
            m_o, V_o, b_s, b_o, jp, use_bias=True, precision="high", interpret=True,
            with_bias_stats=True, head=jb.head, head_side=side)
        got = ge.gaussian_factor_stats(_t(m_o), _t(V_o), _t(b_s), _t(b_o), tp,
                                       use_bias=True, with_bias_stats=True,
                                       head=tb.head, head_side=side)
        assert len(got) == len(ref) == 5
        for n, (g, r) in enumerate(zip(got, ref)):
            _tier_gate(g.numpy(), r, f"{form} {side} stat {n}")
