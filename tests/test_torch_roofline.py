"""``utils/roofline.py``: ``roofline_fields`` against the JAX package's on
the same traffic and seconds (the percentages differ by exactly the ratio
of the two cards' peaks), the HPF, extended Poisson and Gaussian counts
against hand counts on a small layout with one head tier, the counts'
independence of row splits and long-row thresholds, and the card table."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pmf_tpu_torch.data.blocked import build_blocked
from pmf_tpu_torch.parallel.mesh import Mesh
from pmf_tpu_torch.utils import roofline

torch.set_num_threads(1)

H100 = roofline.PEAKS[roofline.H100]
TRAFFIC = [({"bytes_per_iter": 12_345_678_901, "macs_per_iter": 3_300_000_000_000,
             "head": {"bytes": 2_345_678_901}}, 0.0123),
           ({"bytes_per_iter": 987_654_321, "macs_per_iter": 45_678_901,
             "head": {"bytes": 0}}, 0.00071)]
N_USERS, N_ITEMS, K = 20, 16, 3
TIER = (0, 8, 8)  # user rows [0, 8) x item columns [0, 8)


@pytest.mark.parametrize("traffic,seconds", TRAFFIC)
def test_fields_equal_the_jax_fields(traffic, seconds):
    from pmf_tpu.utils import roofline as jroof

    got = roofline.roofline_fields(traffic, seconds, card=roofline.H100)
    want = jroof.roofline_fields(traffic, seconds)
    for key in ("bytes_per_iter", "tail_bytes_per_iter", "head_bytes_per_iter"):
        assert got[key] == want[key], key
    for key in ("effective_gbps", "effective_tflops"):
        assert round(got[key], 1) == want[key], key
    for key, jkey, mine, theirs in (
            ("pct_hbm_roofline", "pct_hbm_roofline", H100.hbm_bytes_per_s,
             jroof.V5E_HBM_BYTES_PER_S),
            ("pct_mfu_bf16", "pct_mxu_roofline_bf16", H100.bf16_flops_per_s,
             jroof.V5E_BF16_FLOPS)):
        as_v5e = got[key] * mine / theirs
        assert round(as_v5e, 1) == want[jkey], key
        rate = (traffic["bytes_per_iter"] if key == "pct_hbm_roofline"
                else 2 * traffic["macs_per_iter"]) / seconds
        assert math.isclose(as_v5e, 100 * rate / theirs, rel_tol=1e-12)
    assert got["card"] == "NVIDIA H100 80GB HBM3"


def _ratings(seed=0, nnz=60):
    """A few dozen distinct (user, item) pairs, ratings 1..5 (bf16-exact)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, 3 * nnz)
    i = rng.integers(0, N_ITEMS, 3 * nnz)
    _, first = np.unique(u * N_ITEMS + i, return_index=True)
    first = np.sort(first)[:nnz]
    return u[first], i[first], rng.integers(1, 6, nnz).astype(np.float32)


def _layout(head=(TIER,)):
    u, i, x = _ratings()
    return build_blocked(u, i, x, n_users=N_USERS, n_items=N_ITEMS, reorder=True,
                         head=list(head) if head else None, head_r0=8, device="cpu")


def test_the_layout_is_what_the_hand_counts_assume():
    lay = _layout()
    (t,) = lay.head
    assert (t.hu, t.hi, t.hip, t.x_lo, t.m.dtype) == (8, 8, 512, None, torch.bfloat16)
    assert lay.by_user.nnz == lay.by_item.nnz == 60 - int(t.m.float().sum()) > 0


def _tail_edges(lay):
    return lay.by_user.nnz


def test_hpf_count_equals_a_hand_count():
    lay = _layout()
    n = _tail_edges(lay)
    # theta: edges (id 4 + rating 4), 21 row pointers of 8, the item table
    # 16 x K, the user table and [S_alloc | S_other] 20 x 3K; the tier:
    # 8 x 8 real cells of x_hi and m (2 + 2 bytes; the columns' padding to
    # 512 left out), its 8 user and 8 item rows.
    tier = 8 * 8 * 4 + (8 * K + 8 * K) * 4
    theta = n * 8 + 21 * 8 + 16 * K * 4 + 20 * 3 * K * 4 + tier
    beta = n * 8 + 17 * 8 + 20 * K * 4 + 16 * 3 * K * 4 + tier
    got = roofline.hpf_blocked_traffic(lay, K)
    assert got["bytes_per_iter"] == theta + beta
    assert got["head"]["bytes"] == 2 * tier
    # R, W @ B, M @ B over 8 x 8 cells a side; K1's 5K + 1 an edge.
    assert got["macs_per_iter"] == 2 * 3 * 64 * K
    assert got["fp32_flops_per_iter"] == 2 * n * (5 * K + 1)


def test_extended_poisson_count_equals_a_hand_count():
    lay = _layout()
    n = _tail_edges(lay)
    tier1 = 8 * 8 * 4 + (8 * K + 8 * 2 * K) * 4  # planes; Theta rows, B and s B rows
    tier2 = 8 * 2 * K * 4  # the new rows and M @ (s B) rows
    factor = {"theta": n * 8 + 21 * 8 + 16 * (K + 1) * 4 + 20 * 3 * K * 4 + tier1,
              "beta": n * 8 + 17 * 8 + 20 * (K + 1) * 4 + 16 * 3 * K * 4 + tier1}
    scalar = {"theta": n * 4 + 21 * 8 + 16 * (K + 1) * 4 + 20 * (K + 1) * 4 + tier2,
              "beta": n * 4 + 17 * 8 + 20 * (K + 1) * 4 + 16 * (K + 1) * 4 + tier2}
    got = roofline.poisson_ext_blocked_traffic(lay, K)
    for side in ("theta", "beta"):
        assert got[f"{side}_factor"]["bytes"] == factor[side], side
        assert got[f"{side}_scalar"]["bytes"] == scalar[side], side
    assert got["bytes_per_iter"] == sum(factor.values()) + sum(scalar.values())
    assert got["macs_per_iter"] == 2 * 3 * 64 * K
    assert got["fp32_flops_per_iter"] == 2 * (n * (6 * K + 1) + n * (2 * K + 1)
                                              + 8 * 2 * K)


@pytest.mark.parametrize("bias_update", ["exact", "lagged"])
def test_gaussian_count_equals_a_hand_count(bias_update):
    lay = _layout()
    n = _tail_edges(lay)
    T = K * (K + 1) // 2
    lagged = bias_update == "lagged"
    w_tab = 2 * K + T + 1  # [m | b m | tri | b]
    tier_f = 8 * 8 * 4 + 8 * w_tab * 4  # x_hi and m planes, the other rows
    tier_b = 8 * 8 * 2 + 8 * (K + 1) * 4  # m planes, the other [m | b] rows
    out_f = 2 * K + T + (2 if lagged else 0)
    want = 0
    for n_self, n_other in ((N_USERS, N_ITEMS), (N_ITEMS, N_USERS)):
        want += (n * 8 + (n_self + 1) * 8 + n_other * (K + 1 + T) * 4
                 + n_self * out_f * 4 + tier_f)  # the factor pass
        want += 2 * n_self * K * K * 4  # the inverses
        if not lagged:
            want += (n * 8 + (n_self + 1) * 8 + n_other * (K + 1) * 4
                     + n_self * (K + 2) * 4 + tier_b)  # the bias pass
    got = roofline.gaussian_blocked_traffic(lay, K, bias_update=bias_update)
    assert got["bytes_per_iter"] == want
    assert got["macs_per_iter"] == 2 * 64 * ((w_tab + K) + (0 if lagged else K + 1))
    edge = 3 * K + 1 + T + (0 if lagged else K + 2)
    assert got["fp32_flops_per_iter"] == 2 * n * edge + 2 * (N_USERS + N_ITEMS) * K**3


def test_precision_fast_reads_one_bf16_plane_of_x_and_m():
    lay = _layout()
    (t,) = lay.head
    f32_m = dataclasses.replace(lay, head=(dataclasses.replace(
        t, m=t.m.float(), x_lo=torch.zeros_like(t.x_hi)),))
    high = roofline.hpf_blocked_traffic(f32_m, K, "high")["head"]["bytes"]
    fast = roofline.hpf_blocked_traffic(f32_m, K, "fast")["head"]["bytes"]
    assert high - fast == 2 * 8 * 8 * (2 + 2)  # x_lo and M's second half, 2 passes


def _mesh():
    """A one-rank mesh, for the layout builds (no process group)."""
    return Mesh(axis_names=("data",), shape={"data": 1}, rank=0, coords={"data": 0},
                device=torch.device("cpu"), groups={"data": (None, (0,))})


def _tp_layout(**kw):
    from pmf_tpu_torch.parallel import tp_blocked

    u, i, x = _ratings()
    return tp_blocked.build_tp_blocked(u, i, x, N_USERS, N_ITEMS, _mesh(), cache_dir="",
                                       **kw)


@pytest.mark.parametrize("count", ["hpf", "ext", "gauss"])
def test_counts_ignore_row_splits_and_the_long_row_threshold(count):
    fn = {"hpf": roofline.hpf_blocked_traffic,
          "ext": roofline.poisson_ext_blocked_traffic,
          "gauss": roofline.gaussian_blocked_traffic}[count]
    whole, split = _tp_layout(), _tp_layout(split_row=2)
    assert all(b.pieces is not None for b in split.by_user + split.by_item)
    assert fn(split, K)["bytes_per_iter"] == fn(whole, K)["bytes_per_iter"]
    lay = _layout(head=None)
    no_long = dataclasses.replace(
        lay, by_user=dataclasses.replace(lay.by_user, long_rows=lay.by_user.rows),
        by_item=dataclasses.replace(lay.by_item, long_rows=0))
    assert fn(no_long, K) == fn(lay, K)
    # The head planes' columns padded to 1024 instead of 512.
    headed = _layout()
    (t,) = headed.head
    pad = dataclasses.replace(
        t, x_hi=torch.nn.functional.pad(t.x_hi, (0, 512)),
        m=torch.nn.functional.pad(t.m, (0, 512)),
        x_sum_item=torch.nn.functional.pad(t.x_sum_item, (0, 512)))
    assert pad.hip == 2 * t.hip
    assert fn(dataclasses.replace(headed, head=(pad,)), K) == fn(headed, K)
    # A ring of one holds the one-device layout's edges, rows and tables.
    assert fn(whole, K)["bytes_per_iter"] == fn(lay, K)["bytes_per_iter"]


def test_an_unknown_card_raises(monkeypatch):
    traffic, seconds = TRAFFIC[0]
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.roofline_fields(traffic, seconds, card="NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.roofline_fields(traffic, seconds)


def _card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)


def test_bound_uses_the_cards_peaks(monkeypatch):
    _card(monkeypatch, "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.bound(1.0, 1.0)
    _card(monkeypatch, roofline.H100)
    ms, by = roofline.bound(3.35e9, 1.0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = roofline.bound(1.0, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    assert roofline.HBM_BYTES_PER_S == 3.35e12 and roofline.FP32_FLOPS_PER_S == 67e12
    assert roofline.BF16_FLOPS_PER_S == 989e12
