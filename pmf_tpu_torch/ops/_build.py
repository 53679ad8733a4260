"""Build and load the port's CUDA kernels.

``load_library()`` compiles every ``pmf_tpu_torch/csrc/*.cu`` with
``nvcc`` for ``sm_90a`` (one compiler process per source, all started
together), links them into one shared library with a plain C interface
under ``pmf_tpu_torch/_build/`` keyed by a hash of the sources, and loads
it with ctypes.  A later call (or process) with unchanged sources reuses
the library.  Any build failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

class KernelError(RuntimeError):
    """The kernels did not build or load, or a launch reported a CUDA
    error: a fault of the card or its toolchain, not of one fit."""


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
_D = ctypes.c_double
# C entry points: name -> argtypes (every entry returns cudaError_t as int).
SIGNATURES = {
    # e_self, e_other, row_ptr, other, x, n_self, n_long, K, rate_floor, out,
    # stream
    "pmf_cavi_edge": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    # e_self, e_other, row_ptr, other, n_self, n_long, K, out, stream
    "pmf_cavi_edge_raw": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    # theta, beta, x_hi, x_lo, m, m_is_f32, rows, hip, K, rate_floor,
    # item_side, n_splits, planes, partial, out, stream
    "pmf_dense_head_tier": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                            _P, _P, _P, _P],
    # the same, precision "fast" (one bf16 term a product)
    "pmf_dense_head_tier_fast": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                                 _P, _P, _P, _P],
    # aug, stride, row_ptr, other, x, n_self, K, with_bias_stats, n_other, nnz,
    # pairs, l2_bytes (the plan's inputs), gp_other, gp_ptr, gw_ptr, w_off,
    # e_slot, e_x (the group form's schedule, or nulls), slabs (the wide
    # forms' slab-major copy of the table), out, stream
    "pmf_gauss_factor": [_P, _I, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # mb_other, row_ptr, other, x, n_self, n_long, K, n_win, win_ptr,
    # win_other, win_x, part, count, out, stream
    "pmf_gauss_bias": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # mb_self, mb_other, sq_other, row_ptr, other, x, n_self, n_long, K, out,
    # stream
    "pmf_gauss_diag": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # mats, R, K, out, scratch, stream
    "pmf_gj_inverse": [_P, _I, _I, _P, _P, _P],
    # e_self, es_other, row_ptr, other, x, n_self, n_long, K, rate_floor, out,
    # stream
    "pmf_ext_factor": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    # e_self_new, es_other, row_ptr, other, n_self, n_long, K, n_win, win_ptr,
    # win_other, part, count, out, stream
    "pmf_ext_scalar": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # self_tab, other_tab, step_off, step, max_pieces, piece_ptr, piece_row,
    # piece_first, piece_count, other, x, K, lam_floor, with_nll, out,
    # scratch, counters, stream
    "pmf_map_grad": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F, _I, _P, _P,
                     _P, _P],
    # self_tab, other_tab, p0, n_long, n_short, piece_ptr, piece_row,
    # piece_first, piece_count, other, x, K, lam_floor, with_nll, out,
    # scratch, counters, stream
    "pmf_map_grad_runs": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F, _I, _P, _P,
                          _P, _P],
    # p_u, mu_u, nu_u, acc_u, scale_u, sp_u, n_u, the same for items, K,
    # is_double, priors (12 host doubles), partials, lr, c1, c2, stream
    "pmf_map_dense": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P, _P,
                      _D, _D, _D, _P],
}


def sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpmf_kernels_{source_hash()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile and link the kernels if the keyed library is missing.
    The compiler's resource report lands in ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources():
            if src.suffix != ".cu":
                continue
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelError("nvcc failed for " + ", ".join(failed) + ":\n"
                              + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelError("linking the kernel library failed:\n" + link.stdout)
        Path(str(out) + ".log").write_text("\n".join(logs))
        os.replace(tmp_so, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"loading {path} failed: {e}") from e
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pmf_error_string.argtypes = [ctypes.c_int]
    lib.pmf_error_string.restype = ctypes.c_char_p
    return lib


class LaunchCounter:
    """Kernel launches made through one wrapper (a plain integer)."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def check_k(k: int, what: str) -> None:
    """Raise unless ``k`` >= 1: every kernel takes any K from 1 on, and
    ``what`` names the kernel in the error."""
    if not k >= 1:
        raise ValueError(f"{what} needs K >= 1, got K={k}")


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.pmf_error_string(err).decode(errors="replace")
        raise KernelError(f"{name}: CUDA error {err} ({msg})")


@functools.cache
def entry(name: str):
    """The ctypes function of C entry point ``name`` (argtypes set)."""
    return getattr(load_library(), name)


def launch_on(name: str, counter: LaunchCounter, device, args: tuple) -> None:
    """Call C entry point ``name`` with ``args`` (data pointers and numbers,
    the stream left out) on ``device``'s current stream, entering no
    device context when ``device`` is the current one.  Raises on a
    reported CUDA error; counts the launch only when it was made."""
    import torch

    fn = entry(name)
    if torch.cuda.current_device() == device.index:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        check(load_library(), err, name)
    counter.count += 1


def launch(name: str, counter: LaunchCounter, device, *args) -> None:
    """``launch_on`` with tensors passed as their data pointers and None as
    a null pointer."""
    import torch

    launch_on(name, counter, device,
              tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args))
