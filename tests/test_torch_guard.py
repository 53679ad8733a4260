"""Boundaries of the port: it imports neither JAX nor the JAX package,
its entry points run on the CUDA card unless the caller names the CPU,
and its kernel wrappers launch or raise on a CUDA tensor, never falling
back to the plain version."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import pmf_tpu_torch
from pmf_tpu_torch.models import gaussian_mf, poisson_mf
from pmf_tpu_torch.models.hpf import HPF, HPFConfig
from pmf_tpu_torch.ops import (
    _build,
    cavi_edge,
    dense_head,
    ext_edge,
    gaussian_edge,
    gj_inverse,
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
            "_tail.py"} <= names
    assert Path(pmf_tpu_torch.__file__).parent == REPO / "pmf_tpu_torch"


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
    es = _cuda_looking(torch.rand(4, 3))
    eo = _cuda_looking(torch.rand(5, 3))
    row_ptr = _cuda_looking(torch.tensor([0, 1, 1, 2, 3]))
    other = _cuda_looking(torch.tensor([0, 4, 2], dtype=torch.int32))
    x = _cuda_looking(torch.ones(3))
    before = cavi_edge.TAIL_LAUNCHES.count
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cavi_edge.tail_edge_stats(es, eo, row_ptr, other, x)
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
    es = _cuda_looking(torch.rand(4, 40))  # K > 32
    with pytest.raises(ValueError, match="K <= 32"):
        cavi_edge.tail_edge_stats(es, es, _cuda_looking(torch.zeros(5, dtype=torch.int64)),
                                  _cuda_looking(torch.zeros(0, dtype=torch.int32)),
                                  _cuda_looking(torch.zeros(0)))
    theta = _cuda_looking(torch.rand(8, 4))
    beta = _cuda_looking(torch.rand(512, 4))
    x_hi = _cuda_looking(torch.ones(8, 512))  # f32, not bf16
    with pytest.raises(TypeError, match="x_hi"):
        dense_head.fused_alloc_tier(theta, beta, x_hi, x_hi, rate_floor=1e-10)


def _csr(n_self, n_other, nnz):
    """A CUDA-looking CSR tail with ``nnz`` edges on row 0."""
    row_ptr = torch.full((n_self + 1,), nnz, dtype=torch.int64)
    row_ptr[0] = 0
    other = torch.arange(nnz, dtype=torch.int32) % n_other
    return tuple(_cuda_looking(t) for t in (row_ptr, other, torch.ones(nnz)))


K = 4
T = K * (K + 1) // 2
GAUSSIAN_WRAPPERS = {
    "K3": (gaussian_edge, "factor_tail_stats", "FACTOR_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(5, K + 1 + T)), *_csr(3, 5, 4), K)),
    "K5": (gaussian_edge, "bias_tail_stats", "BIAS_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(5, K + 1)), *_csr(3, 5, 4))),
    "K6": (gaussian_edge, "diag_tail_stats", "DIAG_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(5, 2 * K + 1)),
                    _cuda_looking(torch.rand(3, K + 1)), *_csr(3, 5, 4))),
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
    with pytest.raises(ValueError, match="K <= 30"):
        gaussian_edge.factor_tail_stats(
            _cuda_looking(torch.rand(5, 31 + 1 + 31 * 32 // 2)), *csr, 31)
    with pytest.raises(ValueError, match="aug must be"):
        gaussian_edge.factor_tail_stats(_cuda_looking(torch.rand(5, 9)), *csr, K)
    with pytest.raises(TypeError, match="aug"):
        gaussian_edge.factor_tail_stats(
            _cuda_looking(torch.rand(5, K + 1 + T, dtype=torch.float64)), *csr, K)
    with pytest.raises(ValueError, match="K <= 31"):
        gaussian_edge.bias_tail_stats(_cuda_looking(torch.rand(5, 33)), *csr)
    with pytest.raises(TypeError, match="x must be"):
        gaussian_edge.bias_tail_stats(_cuda_looking(torch.rand(5, K + 1)), *csr[:2],
                                      _cuda_looking(torch.ones(4, dtype=torch.float64)))
    with pytest.raises(ValueError, match="K <= 32"):
        gaussian_edge.diag_tail_stats(_cuda_looking(torch.rand(5, 67)),
                                      _cuda_looking(torch.rand(3, 34)), *csr)
    with pytest.raises(TypeError, match="self_tab"):
        gaussian_edge.diag_tail_stats(
            _cuda_looking(torch.rand(5, 2 * K + 1)),
            _cuda_looking(torch.rand(3, K + 1, dtype=torch.float64)), *csr)
    with pytest.raises(ValueError, match="K <= 32"):
        gj_inverse.batched_psd_inverse_gj(_cuda_looking(torch.rand(2, 33, 33)))
    with pytest.raises(TypeError, match="float32"):
        gj_inverse.batched_psd_inverse_gj(
            _cuda_looking(torch.rand(2, 3, 3, dtype=torch.float64)))


EXT_WRAPPERS = {
    "K7": ("ext_factor_tail", "FACTOR_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(3, K)), _cuda_looking(torch.rand(5, K)),
                    _cuda_looking(torch.rand(5)), *_csr(3, 5, 4))),
    "K8": ("ext_scalar_tail", "SCALAR_LAUNCHES",
           lambda: (_cuda_looking(torch.rand(3, K)), _cuda_looking(torch.rand(5, K)),
                    _cuda_looking(torch.rand(5)), *_csr(3, 5, 4)[:2])),
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
    wide = _cuda_looking(torch.rand(3, 33))  # K > 32
    with pytest.raises(ValueError, match="K <= 32"):
        fn(wide, _cuda_looking(torch.rand(5, 33)), *good[2:])
    with pytest.raises(TypeError, match="e_other"):
        fn(good[0], _cuda_looking(torch.rand(5, K, dtype=torch.float64)), *good[2:])
    with pytest.raises(TypeError, match="s_other"):
        fn(*good[:2], _cuda_looking(torch.rand(5, dtype=torch.float64)), *good[3:])
    with pytest.raises(ValueError, match="s_other must be"):
        fn(*good[:2], _cuda_looking(torch.rand(4)), *good[3:])  # one scalar short
    with pytest.raises(ValueError, match="differ in K"):
        fn(good[0], _cuda_looking(torch.rand(5, K + 1)), *good[2:])
    with pytest.raises(TypeError, match="other must be"):
        fn(*good[:4], _cuda_looking(torch.zeros(4, dtype=torch.int64)), *good[5:])
    with pytest.raises(ValueError, match="is on"):
        fn(good[0], _cuda_looking(torch.rand(5, K, device="meta")), *good[2:])
    with pytest.raises(ValueError, match="CSR shapes"):
        fn(_cuda_looking(torch.rand(2, K)), *good[1:])  # row_ptr has 4 entries


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
        "ext_edge.cu": ["pmf_tpu/ops/pallas/ext_edge.py::_factor_kernel",
                        "pmf_tpu/ops/pallas/ext_edge.py::_scalar_kernel"],
    }
    assert set(srcs) == set(replaces)
    for name, funcs in replaces.items():
        assert all(f in srcs[name] for f in funcs), name
        assert "What bounds" in srcs[name]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    assert len(_build.source_hash()) == 16
    every = "".join(srcs.values())
    assert np.all([f'extern "C" int {name}(' in every for name in _build.SIGNATURES])
