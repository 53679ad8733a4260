"""Boundaries of the port: it imports neither JAX nor the JAX package,
its entry points run on the CUDA card unless the caller names the CPU,
and its kernel wrappers launch or raise on a CUDA tensor, never falling
back to the plain version."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import pmf_tpu_torch
from pmf_tpu_torch.models import gaussian_mf, hpf_map, poisson_mf
from pmf_tpu_torch.models.hpf import HPF, HPFConfig
from pmf_tpu_torch.ops import (
    _build,
    _tail,
    cavi_edge,
    dense_head,
    ext_edge,
    gaussian_edge,
    gj_inverse,
    map_grad,
)
from pmf_tpu_torch.utils import device as device_mod

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pmf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    banned = _imported_roots(path) & {"jax", "jaxlib", "pmf_tpu"}
    assert not banned, f"{path} imports {banned}"


def test_port_package_files_are_scanned():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "hpf.py", "cavi_edge.py", "dense_head.py",
            "blocked.py", "gaussian_mf.py", "gaussian_edge.py", "gj_inverse.py",
            "solve.py", "poisson_mf.py", "ext_edge.py", "elbo.py",
            "_tail.py", "hpf_map.py", "map_grad.py", "adam.py", "checkpoint.py",
            "config.py", "recommend.py", "ranking.py", "synthetic.py",
            "metrics.py"} <= names
    rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"pmf_tpu_torch/cli/recommend.py", "pmf_tpu_torch/eval/recommend.py",
            "pmf_tpu_torch/utils/checkpoint.py"} <= rel
    assert {f"pmf_tpu_torch/{m}.py" for m in (
        "utils/mapping", "data/pipeline", "tune/multi_seed", "cli/common",
        "cli/run_single", "cli/tune", "cli/best_k", "cli/compare", "cli/train_full",
        "cli/reproduce", "analysis/forecasts", "analysis/exploratory",
        "analysis/top_dimensions", "analysis/embedding_viz", "data/native",
        "data/layout_cache", "parallel/__init__", "parallel/mesh", "parallel/tp",
        "parallel/tp_blocked", "utils/roofline", "utils/platform")} <= rel
    assert Path(pmf_tpu_torch.__file__).parent == REPO / "pmf_tpu_torch"


def test_importing_parallel_starts_no_group_and_touches_no_card():
    """The lazy rule holds for torch.distributed too: importing the mesh
    modules (and the models that use them) starts no process group and
    initialises no CUDA device."""
    import subprocess
    import sys

    code = ("import torch, torch.distributed as dist\n"
            "import pmf_tpu_torch, pmf_tpu_torch.parallel\n"
            "from pmf_tpu_torch.parallel import mesh, tp, tp_blocked\n"
            "from pmf_tpu_torch.eval import recommend\n"
            "assert not dist.is_initialized(), 'a process group started'\n"
            "assert not torch.cuda.is_initialized(), 'CUDA initialised'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is absent"):
        device_mod.resolve_device("cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert device_mod.resolve_device(None) == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_fit_without_device_raises_without_cuda(monkeypatch, small_splits):
    _no_cuda(monkeypatch)
    train, val, _ = small_splits
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HPF(HPFConfig(n_factors=4, max_iter=2, verbose=False)).fit(train, val)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gaussian_mf.GaussianMF(gaussian_mf.GaussianMFConfig(
            n_factors=4, max_iter=2, verbose=False)).fit(train, val)


@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
def test_poisson_fit_without_device_raises_without_cuda(monkeypatch, small_splits,
                                                        extended):
    _no_cuda(monkeypatch)
    train, val, _ = small_splits
    cfg = poisson_mf.PoissonMFConfig(n_factors=4, max_iter=2, verbose=False,
                                     extended=extended)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        poisson_mf.PoissonMF(cfg).fit(train, val)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        poisson_mf.init_state(120, 80, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        poisson_mf.state_from_numpy(poisson_mf._init_state_numpy(12, 8, cfg))
    # Named, the CPU runs the plain versions.
    m = poisson_mf.PoissonMF(cfg).fit(train, val, device="cpu")
    assert m.device == torch.device("cpu") and len(m.fit_history) == 2


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path, small_splits):
    """load_model, the recommend CLI and the exclusion index default to the
    card and raise without one; named, the CPU serves."""
    from pmf_tpu_torch.cli.recommend import main as rec_main
    from pmf_tpu_torch.eval.recommend import build_exclusion_index
    from pmf_tpu_torch.utils.checkpoint import load_model, save_model

    train, _, _ = small_splits
    model = HPF(HPFConfig(n_factors=3, max_iter=1, verbose=False)).fit(
        (train[0], train[1], train[2] + 1), device="cpu")
    ck = str(tmp_path / "ck")
    save_model(model, ck)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(ck)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec_main(["--checkpoint", ck, "--out", str(tmp_path / "r.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_exclusion_index(train[0], train[1])
    assert load_model(ck, device="cpu").state["a_theta"].device == torch.device("cpu")
    rows = rec_main(["--checkpoint", ck, "--users", "0", "--k", "3", "--device",
                     "cpu", "--out", str(tmp_path / "r.csv")])
    assert len(rows) == 3


def test_builders_without_device_raise_without_cuda(monkeypatch, small_ratings):
    from pmf_tpu_torch.data.blocked import build_blocked
    from pmf_tpu_torch.data.coo import build_eval_set, build_ratings
    from pmf_tpu_torch.models.hpf import init_state

    _no_cuda(monkeypatch)
    u, i, x = small_ratings
    for call in (lambda: build_ratings(u, i, x),
                 lambda: build_eval_set(u, i, x, 120, 80),
                 lambda: build_blocked(u, i, x, reorder=True),
                 lambda: init_state(120, 80, HPFConfig(n_factors=3)),
                 lambda: gaussian_mf.init_state(
                     120, 80, gaussian_mf.GaussianMFConfig(n_factors=3))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: reaches a wrapper's kernel
    branch without a card."""

    @property
    def is_cuda(self):
        return True


def _cuda_looking(t):
    return t.contiguous().as_subclass(_CudaLooking)


@pytest.fixture
def broken_build(monkeypatch, tmp_path):
    """The kernel library cannot be built: no compiler."""

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    _build.load_library.cache_clear()
    yield
    _build.load_library.cache_clear()


def _forbid(monkeypatch, module, name):
    def called(*args, **kwargs):
        raise AssertionError(f"{name} ran for a CUDA tensor")

    monkeypatch.setattr(module, name, called)


def test_tail_wrapper_raises_instead_of_falling_back(monkeypatch, broken_build):
    _forbid(monkeypatch, cavi_edge, "tail_edge_stats_plain")
    es = _cuda_looking(torch.rand(4, 4))  # K = 3, padded to tail_stride(3) = 4
    eo = _cuda_looking(torch.rand(5, 4))
    row_ptr = _cuda_looking(torch.tensor([0, 1, 1, 2, 3]))
    other = _cuda_looking(torch.tensor([0, 4, 2], dtype=torch.int32))
    x = _cuda_looking(torch.ones(3))
    before = cavi_edge.TAIL_LAUNCHES.count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cavi_edge.tail_edge_stats(es, eo, row_ptr, other, x, K=3)
    assert cavi_edge.TAIL_LAUNCHES.count == before


def test_head_wrapper_raises_instead_of_falling_back(monkeypatch, broken_build):
    _forbid(monkeypatch, dense_head, "fused_alloc_tier_plain")
    theta = _cuda_looking(torch.rand(8, 4))
    beta = _cuda_looking(torch.rand(512, 4))
    x_hi = _cuda_looking(torch.ones(8, 512, dtype=torch.bfloat16))
    m = _cuda_looking(torch.ones(8, 512, dtype=torch.bfloat16))
    before = dense_head.HEAD_LAUNCHES.count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dense_head.fused_alloc_tier(theta, beta, x_hi, m, rate_floor=1e-10)
    assert dense_head.HEAD_LAUNCHES.count == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    es = _cuda_looking(torch.rand(4, 0))  # K = 0
    with pytest.raises(ValueError, match="K >= 1"):
        cavi_edge.tail_edge_stats(es, es, _cuda_looking(torch.zeros(5, dtype=torch.int64)),
                                  _cuda_looking(torch.zeros(0, dtype=torch.int32)),
                                  _cuda_looking(torch.zeros(0)))
    theta = _cuda_looking(torch.rand(8, 4))
    beta = _cuda_looking(torch.rand(512, 4))
    x_hi = _cuda_looking(torch.ones(8, 512))  # f32, not bf16
    with pytest.raises(TypeError, match="x_hi"):
        dense_head.fused_alloc_tier(theta, beta, x_hi, x_hi, rate_floor=1e-10)


def _head_args(rows=8, hip=128, K=4, m_dtype=torch.bfloat16, x_lo=False):
    """CUDA-looking arguments of one K2 launch (theta, beta, x_hi, m, x_lo)."""
    return [_cuda_looking(torch.rand(rows, K)), _cuda_looking(torch.rand(hip, K)),
            _cuda_looking(torch.ones(rows, hip, dtype=torch.bfloat16)),
            _cuda_looking(torch.ones(rows, hip, dtype=m_dtype)),
            _cuda_looking(torch.zeros(rows, hip, dtype=torch.bfloat16)) if x_lo else None]


HEAD_REJECTS = {
    # K has no upper bound: K = 129 passes every check and reaches the build
    "K_above_32": (RuntimeError, "nvcc not found", lambda: _head_args(K=129)),
    "K_zero": (ValueError, "K >= 1", lambda: _head_args(K=0)),
    "width_not_64s": (ValueError, "multiple of 64", lambda: _head_args(hip=96)),
    "no_rows": (ValueError, "rows >= 1", lambda: _head_args(rows=0)),
    "m_float64": (TypeError, "m must be", lambda: _head_args(m_dtype=torch.float64)),
    "x_lo_float32": (TypeError, "x_lo must be", lambda: [
        *_head_args()[:4], _cuda_looking(torch.zeros(8, 128))]),
    "theta_float64": (TypeError, "theta_h must be", lambda: [
        _cuda_looking(torch.rand(8, 4, dtype=torch.float64)), *_head_args()[1:]]),
    "beta_rows": (ValueError, "beta_h has shape", lambda: [
        _head_args()[0], _cuda_looking(torch.rand(64, 4)), *_head_args()[2:]]),
    "x_hi_rows": (ValueError, "x_hi has shape", lambda: [
        *_head_args()[:2], _cuda_looking(torch.ones(9, 128, dtype=torch.bfloat16)),
        *_head_args()[3:]]),
    "x_lo_on_another_device": (ValueError, "is on", lambda: [
        *_head_args()[:4],
        _cuda_looking(torch.zeros(8, 128, dtype=torch.bfloat16, device="meta"))]),
    "m_strided": (ValueError, "contiguous and 16-byte aligned", lambda: [
        *_head_args()[:3],
        torch.ones(8, 256, dtype=torch.bfloat16)[:, ::2].as_subclass(_CudaLooking), None]),
    "x_hi_misaligned": (ValueError, "contiguous and 16-byte aligned", lambda: [
        *_head_args()[:2],
        torch.ones(8 * 128 + 1, dtype=torch.bfloat16)[1:].view(8, 128)
        .as_subclass(_CudaLooking), *_head_args()[3:]]),
}


@pytest.mark.parametrize("case", sorted(HEAD_REJECTS))
def test_head_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, broken_build,
                                                            case):
    """Every argument check of K2's wrapper raises before the library is
    built or the card is asked anything."""
    exc, match, args = HEAD_REJECTS[case]
    _forbid(monkeypatch, dense_head, "fused_alloc_tier_plain")
    theta, beta, x_hi, m, x_lo = args()
    before = dense_head.HEAD_LAUNCHES.count
    for item_side in (False, True):
        with pytest.raises(exc, match=match):
            dense_head.fused_alloc_tier(theta, beta, x_hi, m, x_lo, rate_floor=1e-10,
                                        item_side=item_side)
    assert dense_head.HEAD_LAUNCHES.count == before


def test_head_wrapper_launches_without_a_try_or_a_library_matmul():
    """``fused_alloc_tier`` holds no try/except around its launch and calls
    no library product; the kernel source holds no atomics."""
    import inspect

    tree = ast.parse(inspect.getsource(dense_head.fused_alloc_tier))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    called = {n.func.attr if isinstance(n.func, ast.Attribute) else
              getattr(n.func, "id", "") for n in ast.walk(tree)
              if isinstance(n, ast.Call)}
    assert not called & {"mm", "matmul", "bmm", "einsum", "addmm", "compile"}
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.BinOp)
                and isinstance(n.op, ast.MatMult)]
    assert {"launch", "fused_alloc_tier_plain", "plan_launch"} <= called
    src = (_build.SRC_DIR / "dense_head.cu").read_text()
    import re

    assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.", src)
    assert "mma.sync.aligned.m16n8k16" in src and "cp.async.cg" in src
    assert "ldmatrix" in src
    includes = re.findall(r"#include\s*[<\"]([^>\"]+)", src)
    assert sorted(includes) == ["cuda_bf16.h", "cuda_runtime.h", "stdint.h"]
    assert 'extern "C" int pmf_dense_head_tier(' in src
    assert len(_build.SIGNATURES["pmf_dense_head_tier"]) == 16


def _csr(n_self, n_other, nnz):
    """A CUDA-looking CSR tail with ``nnz`` edges on row 0."""
    row_ptr = torch.full((n_self + 1,), nnz, dtype=torch.int64)
    row_ptr[0] = 0
    other = torch.arange(nnz, dtype=torch.int32) % n_other
    return tuple(_cuda_looking(t) for t in (row_ptr, other, torch.ones(nnz)))


K = 4
GAUSSIAN_WRAPPERS = {
    "K3": (gaussian_edge, "factor_tail_stats", "FACTOR_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(5, gaussian_edge.factor_stride(K))),
                    *_csr(3, 5, 4), K)),
    "K5": (gaussian_edge, "bias_tail_stats", "BIAS_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(5, 8)), *_csr(3, 5, 4))),  # K = 7
    "K6": (gaussian_edge, "diag_tail_stats", "DIAG_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(3, 8)), _cuda_looking(torch.rand(5, 8)),
                    _cuda_looking(torch.rand(5, K)), *_csr(3, 5, 4), K)),
    "K4": (gj_inverse, "batched_psd_inverse_gj", "GJ_LAUNCHES",
           lambda: (_cuda_looking(torch.eye(K).expand(6, K, K)),)),
}


@pytest.mark.parametrize("kernel", sorted(GAUSSIAN_WRAPPERS))
def test_gaussian_wrappers_raise_instead_of_falling_back(monkeypatch, broken_build,
                                                         kernel):
    module, name, counter, args = GAUSSIAN_WRAPPERS[kernel]
    _forbid(monkeypatch, module, name + "_plain")
    before = getattr(module, counter).count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(module, name)(*args())
    assert getattr(module, counter).count == before


def test_gaussian_wrappers_reject_what_the_kernels_do_not_take():
    csr = _csr(3, 5, 4)
    with pytest.raises(ValueError, match="K >= 1"):
        gaussian_edge.factor_tail_stats(_cuda_looking(torch.rand(5, 4)), *csr, 0)
    with pytest.raises(ValueError, match="aug must be"):
        gaussian_edge.factor_tail_stats(_cuda_looking(torch.rand(5, 9)), *csr, K)
    with pytest.raises(TypeError, match="aug"):
        gaussian_edge.factor_tail_stats(
            _cuda_looking(torch.rand(5, gaussian_edge.factor_stride(K),
                                     dtype=torch.float64)), *csr, K)
    with pytest.raises(ValueError, match="K >= 1"):
        gaussian_edge.bias_tail_stats(_cuda_looking(torch.rand(5, 1)), *csr)
    with pytest.raises(TypeError, match="x must be"):
        gaussian_edge.bias_tail_stats(_cuda_looking(torch.rand(5, 8)), *csr[:2],
                                      _cuda_looking(torch.ones(4, dtype=torch.float64)))
    with pytest.raises(ValueError, match=r"tail_stride\(K \+ 1\) = 8"):
        gaussian_edge.bias_tail_stats(_cuda_looking(torch.rand(5, K + 1)), *csr, K=K)
    with pytest.raises(ValueError, match="K >= 1"):
        narrow = _cuda_looking(torch.rand(5, 1))
        gaussian_edge.diag_tail_stats(_cuda_looking(torch.rand(3, 1)), narrow, narrow,
                                      *csr)
    mb5, sq5 = _cuda_looking(torch.rand(5, 8)), _cuda_looking(torch.rand(5, K))
    with pytest.raises(TypeError, match="mb_self"):
        gaussian_edge.diag_tail_stats(
            _cuda_looking(torch.rand(3, 8, dtype=torch.float64)), mb5, sq5, *csr, K=K)
    with pytest.raises(ValueError, match=r"tail_stride\(K\) = 4"):
        gaussian_edge.diag_tail_stats(_cuda_looking(torch.rand(3, 8)), mb5, mb5, *csr, K=K)
    with pytest.raises(ValueError, match="mb_self rows"):
        gaussian_edge.diag_tail_stats(mb5, mb5, sq5, *csr, K=K)
    with pytest.raises(ValueError, match="long_rows"):
        gaussian_edge.diag_tail_stats(_cuda_looking(torch.rand(3, 8)), mb5, sq5, *csr, K=K,
                                      long_rows=4)
    with pytest.raises(ValueError, match="K >= 1"):
        gj_inverse.batched_psd_inverse_gj(_cuda_looking(torch.rand(2, 0, 0)))
    with pytest.raises(TypeError, match="float32"):
        gj_inverse.batched_psd_inverse_gj(
            _cuda_looking(torch.rand(2, 3, 3, dtype=torch.float64)))


# (self rows of K = 4 columns, [e | s] records of tail_stride(K + 1) = 8)
EXT_WRAPPERS = {
    "K7": ("ext_factor_tail", "FACTOR_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(3, K)), _cuda_looking(torch.rand(5, 8)),
                    *_csr(3, 5, 4))),
    "K8": ("ext_scalar_tail", "SCALAR_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(3, K)), _cuda_looking(torch.rand(5, 8)),
                    *_csr(3, 5, 4)[:2])),
}


@pytest.mark.parametrize("kernel", sorted(EXT_WRAPPERS))
def test_ext_wrappers_raise_instead_of_falling_back(monkeypatch, broken_build, kernel):
    name, counter, args = EXT_WRAPPERS[kernel]
    _forbid(monkeypatch, ext_edge, name + "_plain")
    before = getattr(ext_edge, counter).count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(ext_edge, name)(*args())
    assert getattr(ext_edge, counter).count == before


@pytest.mark.parametrize("kernel", sorted(EXT_WRAPPERS))
def test_ext_wrappers_reject_what_the_kernels_do_not_take(kernel):
    name, _, args = EXT_WRAPPERS[kernel]
    fn = getattr(ext_edge, name)
    good = args()
    empty = _cuda_looking(torch.rand(3, 0))  # K = 0
    with pytest.raises(ValueError, match="K >= 1"):
        fn(empty, _cuda_looking(torch.rand(5, 4)), *good[2:])
    with pytest.raises(TypeError, match="es_other"):
        fn(good[0], _cuda_looking(torch.rand(5, 8, dtype=torch.float64)), *good[2:])
    with pytest.raises(ValueError, match=r"tail_stride\(K \+ 1\) = 8"):
        fn(good[0], _cuda_looking(torch.rand(5, K)), *good[2:])  # no s column
    with pytest.raises(ValueError, match=r"tail_stride\(K\) = 4"):
        fn(_cuda_looking(torch.rand(3, 8)), *good[1:], K=K)  # self rows of a record
    with pytest.raises(TypeError, match="other must be"):
        fn(*good[:3], _cuda_looking(torch.zeros(4, dtype=torch.int64)), *good[4:])
    with pytest.raises(ValueError, match="is on"):
        fn(good[0], _cuda_looking(torch.rand(5, 8, device="meta")), *good[2:])
    with pytest.raises(ValueError, match="CSR shapes"):
        fn(_cuda_looking(torch.rand(2, K)), *good[1:])  # row_ptr has 4 entries


def _tail_call(kernel, es, eo, **kw):
    """K1 ("K1", "K1raw"), K7 or K8 (the [e | s] records ``eo``), K5 (its
    [m | b] table ``eo``) or K6 (the [m | b] tables ``es`` and ``eo``) on
    CUDA-looking tables over a 4-edge tail."""
    row_ptr, other, x = _csr(3, 5, 4)
    if kernel == "K5":
        return gaussian_edge.bias_tail_stats(eo, row_ptr, other, x, **kw)
    if kernel == "K6":  # v + m^2 padded for the K named
        K = kw.get("K")
        sq = eo if K is None else _cuda_looking(torch.rand(5, _tail.tail_stride(K)))
        return gaussian_edge.diag_tail_stats(es, eo, sq, row_ptr, other, x, **kw)
    if kernel == "K7":  # eo: the [e | s] records
        return ext_edge.ext_factor_tail(es, eo, row_ptr, other, x, **kw)
    if kernel == "K8":
        return ext_edge.ext_scalar_tail(es, eo, row_ptr, other, **kw)
    raw = kernel == "K1raw"
    return cavi_edge.tail_edge_stats(es, eo, row_ptr, other, None if raw else x,
                                     mode="raw" if raw else "cavi", **kw)


@pytest.mark.parametrize("kernel", ["K1", "K1raw", "K7", "K5", "K6", "K8"])
def test_tail_group_wrappers_take_only_padded_tables(monkeypatch, broken_build, kernel):
    """On the card K1, K7, K5, K6 and K8 take only tables of tail_stride(K)
    columns (the [m | b] and [e | s] records tail_stride(K + 1)) that start on
    16 bytes, and K >= 1: anything else raises before the build,
    never pads quietly and never runs the plain version."""
    module, plain = {"K7": (ext_edge, "ext_factor_tail_plain"),
                     "K8": (ext_edge, "ext_scalar_tail_plain"),
                     "K5": (gaussian_edge, "bias_tail_stats_plain"),
                     "K6": (gaussian_edge, "diag_tail_stats_plain")}.get(
                         kernel, (cavi_edge, "tail_edge_stats_plain"))
    _forbid(monkeypatch, module, plain)
    counters = (cavi_edge.TAIL_LAUNCHES, cavi_edge.TAIL_RAW_LAUNCHES,
                ext_edge.FACTOR_LAUNCHES, gaussian_edge.BIAS_LAUNCHES,
                gaussian_edge.DIAG_LAUNCHES, ext_edge.SCALAR_LAUNCHES)
    before = [c.count for c in counters]

    def tab(n, w):
        return _cuda_looking(torch.rand(n, w))

    with pytest.raises(ValueError, match="padded to tail_stride"):
        _tail_call(kernel, tab(3, 5), tab(5, 5))  # K = 5, unpadded
    with pytest.raises(ValueError, match="padded to tail_stride"):
        _tail_call(kernel, tab(3, 8), tab(5, 8), K=3)  # padded for another K
    with pytest.raises(ValueError, match="K >= 1"):
        _tail_call(kernel, tab(3, 4), tab(5, 4), K=0)
    # K5 reads no self table; K7 and K8 check their records apart from it
    with pytest.raises(ValueError, match="padded to tail_stride"
                       if kernel in ("K5", "K7", "K8") else "differ in K"):
        _tail_call(kernel, tab(3, 8), tab(5, 5), K=5)
    misaligned = torch.rand(5 * 8 + 1)[1:].view(5, 8).as_subclass(_CudaLooking)
    with pytest.raises(ValueError, match="start on 16 bytes"):
        _tail_call(kernel, tab(3, 8), misaligned, K=5)
    with pytest.raises(RuntimeError, match="nvcc not found"):  # reaches the build
        _tail_call(kernel, tab(3, 8), tab(5, 8), K=5)
    assert [c.count for c in counters] == before


def test_kernel_sources_name_what_they_replace():
    srcs = {p.name: p.read_text() for p in _build.sources()}
    replaces = {
        "cavi_edge.cu": ["pmf_tpu/ops/pallas/cavi_edge.py::_kernel"],
        "dense_head.cu": ["pmf_tpu/ops/dense_head.py::_fused_kernel"],
        "gaussian_edge.cu": [
            "pmf_tpu/ops/pallas/gaussian_edge.py::_factor_kernel",
            "pmf_tpu/ops/pallas/gaussian_edge.py::_bias_kernel",
            "pmf_tpu/ops/pallas/gaussian_edge.py::_diag_kernel"],
        "gj_inverse.cu": ["pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel"],
        "gj_tile.cuh": ["pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel"],
        "gj_tile_lo.cu": ["pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel"],
        "gj_tile_hi.cu": ["pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel"],
        "gj_panel.cu": ["pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel"],
        "ext_edge.cu": ["pmf_tpu/ops/pallas/ext_edge.py::_factor_kernel",
                        "pmf_tpu/ops/pallas/ext_edge.py::_scalar_kernel"],
        "map_grad.cu": ["pmf_tpu/ops/pallas/map_grad.py::_kernel"],
        "map_dense.cu": ["pmf_tpu/models/hpf_map.py::train_epoch_blocked"],
        "tail_groups.cuh": ["pmf_tpu/ops/pallas/cavi_edge.py::_kernel",
                            "pmf_tpu/ops/pallas/ext_edge.py::_factor_kernel",
                            "pmf_tpu/ops/pallas/gaussian_edge.py::_bias_kernel",
                            "::_diag_kernel"],
    }
    assert set(srcs) == set(replaces)
    for name, funcs in replaces.items():
        assert all(f in srcs[name] for f in funcs), name
        assert "What bounds" in srcs[name]
    assert 'modes "cavi" and\n// "raw"' in srcs["cavi_edge.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    assert len(_build.source_hash()) == 16
    every = "".join(srcs.values())
    assert np.all([f'extern "C" int {name}(' in every for name in _build.SIGNATURES])


# ------------------------------------------------------------ HPF-MAP, K9 --


def test_map_entry_points_without_device_raise_without_cuda(monkeypatch, small_splits):
    _no_cuda(monkeypatch)
    train, val, _ = small_splits
    cfg = hpf_map.HPFMapConfig(n_factors=3, epochs=1, batch_size=512, verbose=False)
    u, i, x = train
    for call in (lambda: hpf_map.HPFMap(cfg).fit(train, val),
                 lambda: hpf_map.init_params(12, 8, cfg),
                 lambda: hpf_map.params_from_numpy(hpf_map._init_params_numpy(12, 8, cfg)),
                 lambda: hpf_map.opt_state_from_numpy(
                     0, *(hpf_map._init_params_numpy(12, 8, cfg),) * 2),
                 lambda: hpf_map.build_map_layout(u, i, x, 150, 90, 512, mix=2),
                 lambda: hpf_map.MapBlockedLayout.from_segments(
                     [(u, i, x)], (np.arange(150), np.arange(150), np.arange(90),
                                   np.arange(90)), 150, 90, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # Named, the CPU runs the plain version; the config's device string is
    # a compatibility field and selects nothing.
    assert cfg.device == "tpu"
    m = hpf_map.HPFMap(cfg).fit(train, val, device="cpu")
    assert m.device == torch.device("cpu") and len(m.fit_history) == 1


def _map_groups(K=4, n_users=3, n_items=5, seg_ids=(0,)):
    """CUDA-looking (by user, by item) groupings of a two-segment layout:
    segment 0 holds four edges over users 0 and 2, segment 1 none; runs
    cut into pieces of 2 edges, so user 0's run of 3 is a long run of two
    pieces that merge through the scratch rows."""
    segs = [(np.array([0, 0, 0, 2]), np.array([0, 1, 4, 2]), np.ones(4)),
            (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))]
    ident = (np.arange(n_users),) * 2 + (np.arange(n_items),) * 2
    lay = hpf_map.MapBlockedLayout.from_segments(segs, ident, n_users, n_items, 1,
                                                 device="cpu")
    groups = lay.group(list(seg_ids), len(seg_ids), K, piece=2)
    out = []
    for g in groups:
        # The card's grouping carries its scratch rows; the CPU's none.
        g = dataclasses.replace(g, scratch=torch.zeros(g.max_step_pieces, K + 2))
        out.append(dataclasses.replace(g, **{
            f.name: _cuda_looking(getattr(g, f.name)) for f in dataclasses.fields(g)
            if isinstance(getattr(g, f.name), torch.Tensor)}))
    return out


def _map_args(K=4, with_nll=True, n_self=3, n_other=5):
    """CUDA-looking arguments of one K9 launch: the user direction of step
    0 (two rows over four edges), or the item direction with the sizes
    swapped."""
    by_user, by_item = _map_groups(K)
    g = by_user if with_nll else by_item
    if not with_nll:
        n_self, n_other = n_other, n_self
    return [_cuda_looking(torch.rand(n_self, K + 1)),
            _cuda_looking(torch.rand(n_other, K + 1)), g, 0, 1e-6, with_nll,
            _cuda_looking(torch.zeros(n_self, K + 1 + int(with_nll)))]


@pytest.mark.parametrize("with_nll", [True, False], ids=["user", "item"])
def test_map_grad_wrapper_raises_instead_of_falling_back(monkeypatch, broken_build,
                                                         with_nll):
    _forbid(monkeypatch, map_grad, "map_grad_pieces_plain")
    before = map_grad.MAP_GRAD_LAUNCHES.count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        map_grad.map_grad_pieces(*_map_args(with_nll=with_nll))
    assert map_grad.MAP_GRAD_LAUNCHES.count == before


def test_map_grad_step_raises_instead_of_falling_back(monkeypatch, broken_build):
    """The whole step on CUDA-looking tables reaches the kernel, not the
    plain version."""
    _forbid(monkeypatch, map_grad, "map_grad_pieces_plain")
    args = _map_args()
    groups = _map_groups()
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: args[6])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        map_grad.map_grad_grouped(args[0], args[0], groups, 0, 1e-6)


def test_map_grad_wrapper_rejects_what_the_kernel_does_not_take():
    good = _map_args()

    def call(**repl):
        names = ("self_tab", "other_tab", "g", "step", "lam_floor", "with_nll", "out")
        a = dict(zip(names, good))
        a.update(repl)
        return map_grad.map_grad_pieces(*a.values())

    with pytest.raises(ValueError, match="K >= 1"):
        call(self_tab=_cuda_looking(torch.rand(3, 1)), other_tab=_cuda_looking(torch.rand(5, 1)))
    with pytest.raises(TypeError, match="self_tab"):
        call(self_tab=_cuda_looking(torch.rand(3, 5, dtype=torch.float64)))
    with pytest.raises(TypeError, match="other_tab"):
        call(other_tab=_cuda_looking(torch.rand(5, 5, dtype=torch.float64)))
    with pytest.raises(TypeError, match="out"):
        call(out=_cuda_looking(torch.zeros(3, 6, dtype=torch.float64)))
    g = good[2]
    with pytest.raises(TypeError, match="piece_row must be"):
        call(g=dataclasses.replace(g, piece_row=_cuda_looking(g.piece_row.long())))
    with pytest.raises(TypeError, match="other must be"):
        call(g=dataclasses.replace(g, other=_cuda_looking(g.other.long())))
    with pytest.raises(TypeError, match="x must be"):
        call(g=dataclasses.replace(g, x=_cuda_looking(g.x.double())))
    with pytest.raises(ValueError, match="differ in K"):
        call(other_tab=_cuda_looking(torch.rand(5, 6)))
    with pytest.raises(ValueError, match="out must be"):
        call(out=_cuda_looking(torch.zeros(3, 5)))  # the item width, with_nll set
    with pytest.raises(ValueError, match="too small"):
        call(g=dataclasses.replace(g, scratch=_cuda_looking(torch.zeros(0, 6))))
    with pytest.raises(ValueError, match="outside"):
        call(step=1)
    with pytest.raises(ValueError, match="is on"):
        call(other_tab=_cuda_looking(torch.rand(5, 5, device="meta")))


def test_map_grad_wrapper_skips_an_empty_segment_without_a_build(broken_build):
    args = _map_args()
    by_user, _ = _map_groups(seg_ids=(1,))  # the empty segment
    args[2] = by_user
    before = map_grad.MAP_GRAD_LAUNCHES.count
    map_grad.map_grad_pieces(*args)  # nothing to launch, so nothing to build
    assert map_grad.MAP_GRAD_LAUNCHES.count == before
    assert float(args[6].abs().max()) == 0.0


def test_raw_tail_wrapper_raises_instead_of_falling_back(monkeypatch, broken_build):
    _forbid(monkeypatch, cavi_edge, "tail_edge_stats_plain")
    es = _cuda_looking(torch.rand(3, K))
    eo = _cuda_looking(torch.rand(5, K))
    row_ptr, other, _ = _csr(3, 5, 4)
    before = (cavi_edge.TAIL_LAUNCHES.count, cavi_edge.TAIL_RAW_LAUNCHES.count)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cavi_edge.tail_edge_stats(es, eo, row_ptr, other, None, mode="raw")
    assert before == (cavi_edge.TAIL_LAUNCHES.count, cavi_edge.TAIL_RAW_LAUNCHES.count)


def test_raw_tail_wrapper_rejects_what_the_kernel_does_not_take():
    row_ptr, other, _ = _csr(3, 5, 4)
    empty = _cuda_looking(torch.rand(3, 0))
    with pytest.raises(ValueError, match="K >= 1"):
        cavi_edge.tail_edge_stats(empty, _cuda_looking(torch.rand(5, 0)), row_ptr,
                                  other, None, mode="raw")
    with pytest.raises(TypeError, match="e_other"):
        cavi_edge.tail_edge_stats(_cuda_looking(torch.rand(3, K)),
                                  _cuda_looking(torch.rand(5, K, dtype=torch.float64)),
                                  row_ptr, other, None, mode="raw")
    with pytest.raises(ValueError, match="unknown mode"):
        cavi_edge.tail_edge_stats(_cuda_looking(torch.rand(3, K)),
                                  _cuda_looking(torch.rand(5, K)), row_ptr, other,
                                  None, mode="rate")


def test_map_grad_source_names_what_it_replaces_and_its_entry_point():
    src = (_build.SRC_DIR / "map_grad.cu").read_text()
    assert "Replaces: pmf_tpu/ops/pallas/map_grad.py::_kernel" in src
    assert "__shfl_xor_sync" in src and "atomicAdd" not in src
    assert "atomicInc(" in src  # the arrival counters are integers
    assert 'extern "C" int pmf_map_grad(' in src
    assert len(_build.SIGNATURES["pmf_map_grad"]) == 18
    # K <= 128: the runs form's entry, the step's first piece and classes in
    # place of step_off, step and max_pieces
    assert 'extern "C" int pmf_map_grad_runs(' in src
    assert len(_build.SIGNATURES["pmf_map_grad_runs"]) == 18
    raw = (_build.SRC_DIR / "cavi_edge.cu").read_text()
    assert 'extern "C" int pmf_cavi_edge_raw(' in raw
    assert len(_build.SIGNATURES["pmf_cavi_edge_raw"]) == 9  # with the long-row count
