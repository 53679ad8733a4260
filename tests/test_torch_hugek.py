"""The port past K = 128: every kernel's plain version against the JAX
package's Pallas kernel (interpret mode) at K in {129, 160, 300}, the
blocked fits of every family past 128 against the JAX fits at the gates of
``test_torch_bigk.py``, and the geometry of the kernels' forms past 128:
the row-group plan at every boundary, K2's launch plan on the real tiers
and the arithmetic of its pass form, K4's form on each side of
239/240 and its elimination, K3's and K9's boundaries."""

import numpy as np
import pytest
import torch

from pmf_tpu.models import gaussian_mf as jg
from pmf_tpu.models import hpf as jhpf
from pmf_tpu.models import poisson_mf as jpmf
from pmf_tpu_torch.data.blocked import build_blocked as t_build_blocked
from pmf_tpu_torch.models import gaussian_mf as tg
from pmf_tpu_torch.models import hpf as thpf
from pmf_tpu_torch.models import poisson_mf as tpmf
from pmf_tpu_torch.ops import _tail, dense_head, gaussian_edge, gj_inverse, map_grad
from tests import test_torch_bigk as bigk
from tests.test_torch_bigk import jax_map_layout  # noqa: F401  (a fixture)

torch.set_num_threads(1)

HUGE_KS = pytest.mark.parametrize("K", [129, 160, 300])
M_F32 = pytest.mark.parametrize("m_f32", [False, True], ids=["m_bf16", "m_f32"])


# ------------------------------------------------ plain vs JAX, K > 128 --
# The bodies are test_torch_bigk.py's K > 32 tests, at K past 128.

@HUGE_KS
def test_k1_edge_stats_match_jax(small_ratings, K):
    bigk.test_k1_edge_stats_match_jax(small_ratings, K)


@HUGE_KS
def test_k1_raw_mode_matches_jax_kernel(small_ratings, K):
    bigk.test_k1_raw_mode_matches_jax_kernel(small_ratings, K)


@HUGE_KS
@M_F32
def test_k2_head_stats_match_jax(small_ratings, K, m_f32):
    bigk.test_k2_head_stats_match_jax(small_ratings, K, m_f32)


@HUGE_KS
@pytest.mark.parametrize("with_bias_stats", [False, True])
def test_k3_factor_stats_match_jax(small_ratings, K, with_bias_stats):
    bigk.test_k3_factor_stats_match_jax(small_ratings, K, with_bias_stats)


def test_k4_plain_matches_jax_kernel():
    """K4 against the JAX Pallas kernel in interpret mode at K = 129 (44 s
    in one process on a cold JAX compile cache, nearly all compiling the
    kernel's unrolled pivots; at K = 160 and 300 the compile takes 61 and
    383 s: those run in the ``slow`` test below, and tier 1 holds them
    against the JAX package's plain inverse).  Its compile is not shared
    with the K = 129 full-covariance fit's: JAX caches whole programs,
    and there the kernel is traced inside the jitted sweep."""
    bigk.test_k4_plain_matches_jax_kernel(129)


@pytest.mark.parametrize("K", [160, 300])
def test_k4_plain_matches_jax_plain_inverse(K):
    """K4's plain version against ``pmf_tpu.ops.solve.batched_psd_inverse``
    (the JAX package's Cholesky inverse, the flat engine's) at the gate of
    the interpret-mode comparison."""
    import jax.numpy as jnp

    from pmf_tpu.ops.solve import batched_psd_inverse

    rng = np.random.default_rng(K)
    A = rng.standard_normal((40, K, K + 3)) * 0.5
    mats = (np.eye(K) / 0.4 + A @ np.transpose(A, (0, 2, 1)) / 0.5).astype(np.float32)
    ref = np.asarray(batched_psd_inverse(jnp.asarray(mats)))
    got = gj_inverse.batched_psd_inverse_gj_plain(torch.from_numpy(mats))
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=0, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("K", [160, 300])
def test_k4_plain_matches_jax_kernel_past_160(K):
    """As ``test_k4_plain_matches_jax_kernel`` at K = 160 and 300: it
    passes, but the interpret-mode kernel compiles for 61 and 383 s."""
    bigk.test_k4_plain_matches_jax_kernel(K)


@HUGE_KS
def test_k5_bias_stats_match_jax(small_ratings, K):
    bigk.test_k5_bias_stats_match_jax(small_ratings, K)


@HUGE_KS
def test_k6_diag_stats_match_jax(small_ratings, K):
    bigk.test_k6_diag_stats_match_jax(small_ratings, K)


@HUGE_KS
def test_k7_factor_stats_match_jax(small_ratings, K):
    bigk.test_k7_factor_stats_match_jax(small_ratings, K)


@HUGE_KS
def test_k8_scalar_stats_match_jax(small_ratings, K):
    bigk.test_k8_scalar_stats_match_jax(small_ratings, K)


@HUGE_KS
def test_k9_step_matches_jax_kernel(jax_map_layout, K):
    bigk.test_k9_step_matches_jax_kernel(jax_map_layout, K)


# --------------------------------------------- blocked fits past K = 128 --

def test_hpf_blocked_fit_at_k160_matches_jax(small_splits):
    train, val = bigk._shifted(small_splits)
    kw = dict(n_factors=160, max_iter=4, tol=None, verbose=False, engine="blocked_high")
    jm = jhpf.HPF(jhpf.HPFConfig(**kw)).fit(train, val)
    tm = thpf.HPF(thpf.HPFConfig(**kw)).fit(train, val, device="cpu")
    bigk._same_history(tm, jm)


@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
def test_poisson_blocked_fit_at_k160_matches_jax(small_splits, extended):
    train, val, _ = small_splits
    kw = dict(n_factors=160, max_iter=4, tol=None, verbose=False,
              engine="blocked_high", extended=extended)
    jm = jpmf.PoissonMF(jpmf.PoissonMFConfig(**kw)).fit(train, val)
    tm = tpmf.PoissonMF(tpmf.PoissonMFConfig(**kw)).fit(train, val, device="cpu")
    bigk._same_history(tm, jm)


def _gaussian_fit_pair(splits, **kw):
    (tu, ti, tx), (vu, vi, vx), _ = splits
    mean = float(tx.mean())
    train, val = (tu, ti, tx - mean), (vu, vi, vx - mean)
    kw = dict(max_iter=4, tol=None, verbose=False, engine="blocked_high") | kw
    jm = jg.GaussianMF(jg.GaussianMFConfig(**kw)).fit(train, val, global_mean=mean)
    tm = tg.GaussianMF(tg.GaussianMFConfig(**kw)).fit(train, val, global_mean=mean,
                                                      device="cpu")
    return tm, jm


def test_gaussian_full_blocked_fit_at_k129_matches_jax():
    """The full-covariance blocked fit just past 128, on a 40 x 30 split
    of 400 ratings and 2 sweeps.  It takes 70 s in one process on a cold
    JAX compile cache, nearly all of it the JAX side compiling its jitted
    sweep with the interpret-mode kernels at K = 129 inside (the
    Gauss-Jordan kernel pads both sides' batches to 128 matrices, so one
    shape): no smaller split or fewer sweeps shortens that; the port's
    side 0.8 s."""
    from pmf_tpu.data.synthetic import synth_splits

    tm, jm = _gaussian_fit_pair(synth_splits(40, 30, 400, seed=11), n_factors=129,
                                covariance="full", max_iter=2)
    bigk._same_history(tm, jm)


def test_gaussian_diag_blocked_fit_at_k160_matches_jax(small_splits):
    """The diag fit at K = 160 with factor priors of variance 0.1, under
    which the JAX fit itself converges (val RMSE 1.42-1.43 against the
    ratings' spread of 1.32).  With the default priors, as the K = 50 test
    runs, both packages diverge alike on this split (val RMSE 104 after
    3 sweeps, 1.9e6 after 4), and a larger split (400 x 250, 20k ratings)
    diverges too."""
    tm, jm = _gaussian_fit_pair(small_splits, n_factors=160, covariance="diag",
                                eta_theta2=0.1, eta_beta2=0.1)
    rmses = [rec["val_rmse"] for rec in jm.fit_history]
    assert max(rmses) < 2.0, rmses  # near the ratings' scale: the reference converges
    bigk._same_history(tm, jm)


@pytest.mark.slow
def test_gaussian_full_blocked_fit_at_k160_matches_jax(small_splits):
    """The full-covariance blocked fit at K = 160 on the K = 50 test's
    split: it passes, but the JAX side's interpret-mode kernels take
    minutes at this K on a CPU."""
    tm, jm = _gaussian_fit_pair(small_splits, n_factors=160, covariance="full")
    bigk._same_history(tm, jm)


def test_hpf_map_blocked_epoch_at_k160_matches_jax():
    bigk.hpf_map_blocked_epoch_matches_jax(160)


# ------------------------------------------------ geometry past K = 128 --

@pytest.mark.parametrize("kernel", _tail.PLAN_KERNELS)
def test_tail_plan_at_every_boundary(kernel):
    """On each side of every boundary the row-group plan covers each
    summed word once: the register form's G lanes of V words, or the wide
    form's chunks of WIDE_WORDS (two words a lane of a warp); the plan
    changes exactly there."""
    bounds = _tail.boundary_ks(kernel)
    assert bounds[0] == 1 and any(b > 256 for b in bounds)
    for b in bounds[1:]:
        before, at = _tail.launch_plan(b - 1, kernel), _tail.launch_plan(b, kernel)
        assert before != at
        for K in (b - 1, b):
            p = _tail.launch_plan(K, kernel)
            words = -(-_tail.columns(K, kernel) // 4)
            assert p["words"] == words and p["stride"] == 4 * words
            if p["wide"]:
                assert words > _tail.GROUP_MAX_SPAN and (p["lanes"], p["vec"]) == (32, 2)
                summed = words if kernel == "K5" else -(-K // 4)
                held = [c * _tail.WIDE_WORDS + 32 * v + lane for c in range(p["chunks"])
                        for v in range(2) for lane in range(32)]
                assert set(range(summed)) <= set(held) and len(set(held)) == len(held)
                assert p["chunks"] == -(-summed // _tail.WIDE_WORDS)
            else:
                assert p["lanes"] * p["vec"] >= words and p["chunks"] == 1
    assert not _tail.launch_plan(256, "K1")["wide"] and _tail.launch_plan(257, "K1")["wide"]
    assert not _tail.launch_plan(255, "K7")["wide"] and _tail.launch_plan(256, "K7")["wide"]


HUGE_PLAN_KS = [129, 160, 256, 300]


def _k2_kinds():
    return [(item, m_f32, lo, fast) for item in (False, True)
            for m_f32, lo in ((False, False), (False, True), (True, True))
            for fast in (False, True)]


@pytest.mark.parametrize("rows,hip", bigk.REAL_TIERS)
def test_k2_plan_fits_shared_memory_past_k128(rows, hip):
    """The pass form's shared memory fits one CTA at K = 129, 160, 256,
    300 and on each side of its P-in-the-ring boundary, for every kind of
    tile and both precisions; ceil(K / 160) passes over the cells, each a
    chunk of at most 160 factors; one resident CTA an SM (the launch
    bounds past a chunk of 64); P rides the ring exactly past the
    boundary, with two stages (else three or four)."""
    for item, m_f32, lo, fast in _k2_kinds():
        bounds = dense_head.boundary_ks(item, m_f32, lo, fast)
        ring = bounds[-1]
        assert bounds[:5] == [33, 65, 97, 129, 161] and ring > 161
        for K in HUGE_PLAN_KS + [ring - 1, ring]:
            plan = dense_head.plan_launch(rows, hip, K, item, m_f32, lo, 132, fast)
            n_pass, cw = dense_head.passes(K), dense_head.pass_width(K)
            assert n_pass == -(-K // 160) == plan.passes
            assert (plan.passes == 1) == (K <= 160)
            assert plan.depth == n_pass * cw and cw <= 160 and cw % 32 == 0
            assert plan.depth - K < 32 * n_pass
            assert plan.p_ring == (K >= ring)
            assert plan.stages == dense_head.pass_stages(K, item, m_f32, lo, fast,
                                                         plan.p_ring)
            assert plan.stages == 2 if plan.p_ring else plan.stages in (3, 4)
            assert plan.smem_bytes == dense_head.pass_smem_bytes(
                K, item, m_f32, lo, fast, plan.p_ring, plan.stages) <= dense_head.SMEM_PER_CTA
            assert plan.ctas_per_sm == 1
            assert plan.ctas_per_sm * (plan.smem_bytes + 1024) <= dense_head.SMEM_PER_SM
            serial = -(-(rows if item else hip) // plan.q_tile)
            assert (plan.splits - 1) * plan.tiles_per_split < serial
            assert plan.splits * plan.tiles_per_split >= serial
    big = dense_head.plan_launch(70, 128, 5000, False, True, True, 132)
    assert big.p_ring and big.smem_bytes <= dense_head.SMEM_PER_CTA and big.passes == 32


@pytest.mark.parametrize("K", [160, 300])
@pytest.mark.parametrize("item_side", [False, True], ids=["user", "item"])
def test_k2_staged_depth_arithmetic_matches_plain_float64(small_ratings, K, item_side):
    """The pass form past its first chunk width (one pass at K = 160, two
    at 300, R summed chunk by chunk in the order of each pass) holds the
    card check's 1e-4 against the plain version in float64."""
    bigk.check_pass_arithmetic(small_ratings, K, item_side)


def test_k4_form_on_each_side_of_240():
    """The CTA form while its K x (K + 1) matrix and two buffers fit a
    CTA's shared memory (to K = 239), then the global form, which keeps
    the first rows that fit beside the buffers."""
    assert [gj_inverse.form(k) for k in (64, 65, 239, 240, 300)] == [
        "rows", "cta", "cta", "global", "global"]
    assert gj_inverse.cta_smem_bytes(239) <= gj_inverse.SMEM_PER_CTA
    assert gj_inverse.cta_smem_bytes(240) > gj_inverse.SMEM_PER_CTA
    assert gj_inverse.boundary_ks()[-2:] == [65, 240]
    for k in (240, 256, 300, 1000):
        rs = gj_inverse.global_shared_rows(k)
        assert 0 < rs < k and 4 * (2 * k + rs * (k + 1)) <= gj_inverse.SMEM_PER_CTA
        assert 4 * (2 * k + (rs + 1) * (k + 1)) > gj_inverse.SMEM_PER_CTA
    assert gj_inverse.global_shared_rows(30_000) == 0  # the buffers alone do not fit


def _gj_host_plan(tmp_path):
    """The dispatch's plan of ``csrc/gj_inverse.cu`` (its "host plan"
    block, plain C++) built alone with the host compiler: K -> (form,
    CTA-form bytes, the global form's shared rows, its bytes, its buffers
    in shared memory)."""
    import ctypes
    import shutil
    import subprocess

    from pmf_tpu_torch.ops import _build

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = (_build.SRC_DIR / "gj_inverse.cu").read_text()
    block = text[text.index("// BEGIN host plan"):text.index("// END host plan")]
    src = tmp_path / "gj_plan.cpp"
    src.write_text("#include <stdint.h>\nnamespace {\n" + block + "}\n"
                   'extern "C" void plan(int K, int64_t* o) {\n'
                   "  const GlobalPlan g = global_plan(K);\n"
                   "  o[0] = form_of(K); o[1] = cta_smem_bytes(K);\n"
                   "  o[2] = g.rs; o[3] = g.smem; o[4] = g.buffers;\n}\n")
    lib = tmp_path / "libgj_plan.so"
    subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]

    def plan(k):
        out = (ctypes.c_int64 * 5)()
        fn(k, out)
        return tuple(out)
    return plan


def test_k4_dispatch_plan_matches_the_wrapper_at_any_k(tmp_path):
    """The CUDA dispatch picks the form ``gj_inverse.form`` names, and the
    global form keeps ``global_shared_rows`` rows, at every boundary and
    far past the K where the CTA form's bytes pass 2^31 (23,170) and the
    buffers leave shared memory (29,056)."""
    plan = _gj_host_plan(tmp_path)
    forms = ("rows", "cta", "global")
    for k in (1, 64, 65, 239, 240, 300, 1000, 23_169, 23_170, 23_171, 29_056, 29_057,
              46_341, 100_000, 2**31 // 8):
        f, cta_bytes, rs, smem, buffers = plan(k)
        assert forms[f] == gj_inverse.form(k), k
        assert cta_bytes == gj_inverse.cta_smem_bytes(k), k
        if forms[f] == "global":
            assert rs == gj_inverse.global_shared_rows(k), k
            assert buffers == (8 * k <= gj_inverse.SMEM_PER_CTA), k
            assert 0 <= smem <= gj_inverse.SMEM_PER_CTA, k
            assert smem == (4 * (2 * k + rs * (k + 1)) if buffers else 0), k


@pytest.mark.parametrize("K", [240, 300])
def test_k4_global_form_elimination_equals_the_plain_version(K):
    """The global form takes the CTA form's in-place steps (its split of
    rows between shared and global memory moves values, not operations):
    equal to the plain [A | I] form in float64."""
    rng = np.random.default_rng(K)
    A = rng.standard_normal((3, K, K + 3)) * 0.5
    mats = np.eye(K) / 0.4 + A @ np.transpose(A, (0, 2, 1)) / 0.5
    ref = gj_inverse.batched_psd_inverse_gj_plain(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(bigk._gj_in_place(mats), ref, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(ref @ mats, np.broadcast_to(np.eye(K), mats.shape),
                               atol=1e-9)


def test_k3_and_k9_boundaries():
    """K3: the wide instance from K = 129, b_o past the first chunk of 512
    floats from K = 512.  K9: an instance for each 32 factors a lane up to
    K = 256, the general form past it."""
    assert gaussian_edge.factor_boundary_ks() == [1, 31, 129, 512]
    assert map_grad.boundary_ks() == [1, 9, 17, 25, 33, 65, 97, 129, 161, 193, 225, 257]
    assert map_grad.kernel_of(256) == ("wide", 8) and map_grad.kernel_of(257) == ("general",)
    with pytest.raises(ValueError, match="K >= 1"):
        map_grad.kernel_of(0)
