"""K9 past K = 128 on the CPU (``csrc/map_grad.cu``, one warp a piece):
the launch plan against the kernel source, the groupings' pieces of
``piece_of(K)`` edges, and a float32 numpy emulation of the kernels' order
of sums (a warp dot an edge, F factors a lane, sums in edge order, a run's
partials added in piece order) against the float64 plain version at
``tests/test_torch_map_grad.py``'s gate."""

import re

import numpy as np
import pytest
import torch

from pmf_tpu_torch.models import hpf_map as t_map
from pmf_tpu_torch.ops import _build, map_grad
from tests.test_torch_map_grad import map_data, softplus_tables

torch.set_num_threads(1)

FLOOR = t_map.LAMBDA_FLOOR
RTOL, ATOL = 2e-4, 2e-5  # tests/test_torch_map_grad.py's gate
RUNS = (1, 2, 31, 32, 33, 128, 129, 757)  # edges of the user rows of the emulated step
EMULATED_KS = (129, 160, 200, 256, 257, 300, 512)


def test_launch_plan_mirrors_the_kernel_source():
    src = (_build.SRC_DIR / "map_grad.cu").read_text()
    assert int(re.search(r"constexpr int kWideMaxF = (\d+);", src).group(1)) \
        == map_grad.WIDE_MAX_F
    runs = re.findall(r"if \(K <= (\d+)\) PMF_MAP_GRAD_RUNS\((\d+), (\d+)\);", src)
    runs = [tuple(int(v) for v in r) for r in runs]
    assert runs == [(8, 4, 2), (16, 4, 4), (24, 4, 6), (32, 4, 8), (48, 8, 6), (64, 8, 8),
                    (96, 16, 6)]  # then (16, 8) to RUNS_MAX_K
    assert "else PMF_MAP_GRAD_RUNS(16, 8);" in src
    assert "if (K < 1 || K > 128 || n_long < 0 || n_short < 0)" in src
    assert map_grad.RUNS_MAX_K == 128
    lo = 1
    for hi, g, v in runs + [(128, 16, 8)]:
        assert {map_grad.kernel_of(k) for k in range(lo, hi + 1)} == {("runs", g, v)}
        lo = hi + 1
    wide = [int(f) for f in re.findall(r"PMF_MAP_GRAD_LAUNCH\(map_grad_wide_kernel<(\d+)>\)",
                                       src)]
    assert wide == [5, 6, 7]  # then kWideMaxF
    assert "if (K <= 128) return (int)cudaErrorInvalidValue;" in src
    assert "else if (K <= 32 * kWideMaxF) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<kWideMaxF>);" \
        in src
    assert "else PMF_MAP_GRAD_LAUNCH(map_grad_general_kernel);" in src
    kinds = {k: map_grad.kernel_of(k) for k in (32, 33, 128, 129, 160, 256, 257, 600)}
    assert kinds == {32: ("runs", 4, 8), 33: ("runs", 8, 6), 128: ("runs", 16, 8),
                     129: ("wide", 5), 160: ("wide", 5), 256: ("wide", 8), 257: ("general",),
                     600: ("general",)}
    assert [map_grad.piece_of(k) for k in (1, 20, 128, 129, 160, 256, 257, 600)] \
        == [map_grad.PIECE] * 3 + [map_grad.PIECE_WIDE] * 5
    # The piece length changes where the wide form's fifth instance starts.
    assert map_grad.boundary_ks() == [1, 9, 17, 25, 33, 49, 65, 97, 129, 161, 193, 225, 257]


@pytest.mark.parametrize("K", [128, 129, 160, 300])
@pytest.mark.parametrize("mix", [1, 3])
def test_layout_grouping_cuts_runs_at_the_piece_of_k(mix, K):
    """``MapBlockedLayout.group`` at ``K`` factors cuts each run into pieces
    of ``piece_of(K)`` edges (the last shorter), the long runs in several
    pieces."""
    u, i, x, n_users, n_items = map_data(n_users=20, n_items=600, nnz=8000, seed=3)
    lay = t_map.build_map_layout(u, i, x, n_users, n_items, batch_size=mix * 1000, mix=mix,
                                 device="cpu")
    order = np.random.default_rng(mix).permutation(lay.n_segments)
    piece = map_grad.piece_of(K)
    several = 0
    for g in lay.group(order, mix, K):
        lens = np.diff(g.piece_ptr.numpy())
        first, count = g.piece_first.numpy(), g.piece_count.numpy()
        assert (lens >= 1).all() and (lens <= piece).all()
        last = first + count - 1
        assert (lens[np.arange(g.n_pieces) != last] == piece).all()
        several += int((count > 1).sum())
    assert several > 0


# ------------------------------------------------------------ emulation --

def _fma(a, b, c):
    """float32 fma: the product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _warp_sum(part):
    """``warp_sum`` over the last axis (32 lanes): the xor butterfly at
    offsets 16, 8, 4, 2, 1; every lane ends with the same float."""
    lanes = np.arange(32)
    off = 16
    while off:
        part = part + part[..., lanes ^ off]
        off //= 2
    return part[..., 0]


def emulate(self_tab, other_tab, g, step, lam_floor, with_nll, out):
    """One direction of ``step`` as ``map_grad_wide_kernel<F>`` (K <= 256)
    and ``map_grad_general_kernel`` (past it) sum it, in float32: lane l
    holds factors l, l + 32, ... (F = ceil(K / 32) a lane), a piece's
    edges in order, each dot the lane partials (a product, then fmas over
    f) met by the butterfly; a run of several pieces summed from its
    partial rows in piece order.  Both forms take this order."""
    f32 = np.float32
    K = self_tab.shape[1] - 1
    F = -(-K // 32)
    kk = np.arange(32)[:, None] + 32 * np.arange(F)[None, :]  # (32, F)
    valid = kk < K
    width = K + 1 + int(with_nll)

    def lane_rows(tab, ids):
        v = tab[np.asarray(ids)][:, np.minimum(kk, K - 1)].astype(f32)
        v[:, ~valid] = 0
        return v

    ptr, other, x = g.piece_ptr.numpy(), g.other.numpy(), g.x.numpy().astype(f32)
    prow, pfirst, pcount = g.piece_row.numpy(), g.piece_first.numpy(), g.piece_count.numpy()
    step_off = g.step_off.numpy()
    rows = {}
    for p in range(step_off[step], step_off[step + 1]):
        es = lane_rows(self_tab, [prow[p]])[0]
        eo = lane_rows(other_tab, other[ptr[p]:ptr[p + 1]])  # (n, 32, F)
        part = es[None, :, 0] * eo[:, :, 0]
        for f in range(1, F):
            part = _fma(es[None, :, f], eo[:, :, f], part)
        dot = _warp_sum(part)
        xv = x[ptr[p]:ptr[p + 1]]
        lam = np.maximum(dot, f32(lam_floor))
        w = np.where(dot >= f32(lam_floor), f32(1) - xv / lam, f32(0))
        en = lam - xv * np.log(lam)
        acc, nll = np.zeros((32, F), f32), f32(0)
        for e in range(len(xv)):
            acc = _fma(w[e], eo[e], acc)
            nll = f32(nll + en[e])
        row = np.zeros(width, f32)
        row[kk[valid]] = acc[valid]
        row[K] = ptr[p + 1] - ptr[p]
        if with_nll:
            row[K + 1] = nll
        rows[p] = row
    for p in range(step_off[step], step_off[step + 1]):
        if p == pfirst[p]:
            s = rows[p].copy()
            for q in range(p + 1, p + pcount[p]):
                s = s + rows[q]
            out[prow[p]] = s


def _step_of_runs(seed=0):
    """One step whose user rows hold runs of RUNS edges (distinct items),
    and a few users of 1-5 edges beside them."""
    rng = np.random.default_rng(seed)
    n_items = 800
    u, i = [], []
    for row, n in enumerate(RUNS):
        u.append(np.full(n, row))
        i.append(rng.choice(n_items, n, replace=False))
    extra = rng.integers(1, 6, 12)
    for j, n in enumerate(extra):
        u.append(np.full(n, len(RUNS) + j))
        i.append(rng.choice(n_items, n, replace=False))
    u, i = np.concatenate(u), np.concatenate(i)
    perm = rng.permutation(len(u))
    x = rng.integers(1, 6, len(u)).astype(np.float64) + 1.0
    ident = (np.arange(len(RUNS) + len(extra)),) * 2 + (np.arange(n_items),) * 2
    return t_map.MapBlockedLayout.from_segments([(u[perm], i[perm], x[perm])], ident,
                                                len(RUNS) + len(extra), n_items, 1,
                                                device="cpu")


@pytest.mark.parametrize("piece", [None, map_grad.PIECE, 8])
@pytest.mark.parametrize("K", EMULATED_KS)
def test_emulated_order_matches_plain_float64(K, piece):
    """The emulation on both directions of a step with runs of 1 to 757
    edges, at the plan's pieces (``piece_of(K)``, None) and at 128 and 8
    edges, against the COO plain version in float64."""
    lay = _step_of_runs()
    u_sp, i_sp = softplus_tables(lay.n_users, lay.n_items, K, np.float32, seed=K)
    dirs = [map_grad.group_steps(lay.u, lay.i, lay.x, lay.seg_off, [0], 1, lay.n_users, K,
                                 piece),
            map_grad.group_steps(lay.i, lay.u, lay.x, lay.seg_off, [0], 1, lay.n_items, K,
                                 piece)]
    assert int(np.diff(dirs[0].piece_ptr.numpy()).max()) == (piece or map_grad.piece_of(K))
    nu, ni, xs = lay.segment(0)
    ref = map_grad.map_grad_plain(torch.from_numpy(u_sp).double(),
                                  torch.from_numpy(i_sp).double(), nu, ni, xs.double(), FLOOR)
    lens = np.diff(dirs[0].piece_ptr.numpy())
    run_len = np.bincount(dirs[0].piece_row.numpy(), weights=lens)
    assert sorted(run_len[:len(RUNS)]) == list(RUNS)
    for (g, tabs, with_nll), want in zip(
            ((dirs[0], (u_sp, i_sp), True), (dirs[1], (i_sp, u_sp), False)), ref):
        out = np.zeros((tabs[0].shape[0], K + 1 + int(with_nll)), np.float32)
        emulate(*tabs, g, 0, FLOOR, with_nll, out)
        want = want.numpy()
        np.testing.assert_array_equal(out[:, K], want[:, K])  # counts exactly
        np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
