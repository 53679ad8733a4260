"""Batched Gauss-Jordan inverse of small positive-definite matrices.

The Gaussian CAVI blocks invert one K x K precision matrix per user or
item row.  ``batched_psd_inverse_gj`` is the wrapper of kernel K4
(``csrc/gj_inverse.cu``, replacing
``pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel``): on a CUDA tensor it
launches the kernel (or raises), on a CPU tensor it runs
``batched_psd_inverse_gj_plain``, the same unrolled elimination in plain
PyTorch.  No pivoting: every elimination step of a positive-definite
matrix leaves a positive-definite trailing block, so pivots stay
positive.

K4 inverts in place (column p of A becomes column p of the inverse at
pivot p), one row a thread, the matrices of a CTA packed across its
threads, scaling the pivot row by one reciprocal; ``launch_plan`` gives
the geometry the kernel picks for a K.  Past K = 64 a CTA inverts one
matrix in shared memory while it fits (``form``: "cta" up to K = 239), then
with its first ``global_shared_rows(K)`` rows in shared memory and the rest
in global memory ("global"), at any K.
"""

from __future__ import annotations

import torch

from pmf_tpu_torch.ops import _build

GJ_LAUNCHES = _build.LaunchCounter()
ROWS_MAX_K = 64  # csrc/gj_inverse.cu: kRowsMaxK
SMEM_PER_CTA = 232_448  # kSmemPerCta


def cta_smem_bytes(k: int) -> int:
    """Shared memory of the CTA form: the K x (K + 1) matrix and two
    K-float buffers."""
    return 4 * (k * (k + 1) + 2 * k)


def form(k: int) -> str:
    """The kernel's form for ``k``: "rows" (a row a thread) up to K = 64,
    "cta" (a CTA a matrix in shared memory) while ``cta_smem_bytes`` fits a
    CTA, then "global" (a CTA a matrix in global memory)."""
    _build.check_k(k, "Gauss-Jordan kernel")
    if k <= ROWS_MAX_K:
        return "rows"
    return "cta" if cta_smem_bytes(k) <= SMEM_PER_CTA else "global"


def global_shared_rows(k: int) -> int:
    """Rows of the matrix the global form keeps in shared memory beside
    its two K-float buffers (0 where the buffers alone do not fit)."""
    if 8 * k > SMEM_PER_CTA:
        return 0
    return min(k, (SMEM_PER_CTA - 8 * k) // (4 * (k + 1)))


def boundary_ks(k_max: int = 600) -> list:
    """The first K of each form and of each row-form instance up to
    ``k_max``: the tests and chip_smoke.py hold K4 on both sides of each."""
    out, last = [], None
    for k in range(1, k_max + 1):
        p = launch_plan(k)
        key = (form(k), p and p["kmax"])
        if key != last:
            out.append(k)
            last = key
    return out


def row_stride(k: int) -> int:
    """The kernel's shared-memory row stride: K rounded up to 4 floats,
    made 4 mod 8 so that float4 reads of eight rows hit distinct banks."""
    s = -(-k // 4) * 4
    return s + 4 if s % 8 == 0 else s


def rows_warps(k: int, wmax: int) -> int:
    """Warps a CTA: the fewest of 1..wmax that leave the smallest share of
    threads idle (32 w // K matrices of K rows each)."""
    best = 1
    for w in range(2, wmax + 1):
        if (32 * w // k) * k * 32 * best > (32 * best // k) * k * 32 * w:
            best = w
    return best


def launch_plan(k: int) -> dict | None:
    """The row-per-thread geometry for ``k`` (``csrc/gj_inverse.cu``'s
    dispatch): registers a row ``kmax``, ``warps`` a CTA holding
    ``matrices`` matrices (thread t row t % K of matrix t // K), shared row
    ``stride``; None past K = 64, where a CTA inverts one matrix (``form``)."""
    _build.check_k(k, "Gauss-Jordan kernel")
    for kmax, wmax in ((8, 8), (16, 8), (24, 8), (32, 8), (40, 4), (48, 4), (52, 4),
                       (56, 4), (64, 4)):
        if k <= kmax:
            w = rows_warps(k, wmax)
            return dict(kmax=kmax, warps=w, matrices=32 * w // k, stride=row_stride(k))
    return None


def batched_psd_inverse_gj_plain(mats: torch.Tensor) -> torch.Tensor:
    """(R, K, K) -> (R, K, K): Gauss-Jordan over the augmented [A | I],
    pivot by pivot, in the input's dtype."""
    R, K, _ = mats.shape
    eye = torch.eye(K, dtype=mats.dtype, device=mats.device).expand(R, K, K)
    aug = torch.cat([mats, eye], dim=2)  # (R, K, 2K)
    for p in range(K):
        row = aug[:, p, :] / aug[:, p, p : p + 1]
        col = aug[:, :, p].clone()
        aug = aug - col[:, :, None] * row[:, None, :]
        aug[:, p, :] = row
    return aug[:, :, K:]


def _check_cuda_args(mats: torch.Tensor) -> None:
    if mats.dim() != 3 or mats.shape[1] != mats.shape[2]:
        raise ValueError(f"expected (R, K, K) matrices, got {tuple(mats.shape)}")
    _build.check_k(mats.shape[1], "Gauss-Jordan kernel")
    if mats.dtype != torch.float32:
        raise TypeError(f"mats must be torch.float32, got {mats.dtype}")
    if mats.shape[0] >= 2**31:
        raise ValueError("too many matrices for one launch")


def batched_psd_inverse_gj(mats: torch.Tensor) -> torch.Tensor:
    """K4: invert (R, K, K) positive-definite matrices.  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    if not mats.is_cuda:
        return batched_psd_inverse_gj_plain(mats)
    _check_cuda_args(mats)
    mats = mats.contiguous()
    R, K, _ = mats.shape
    out = torch.empty_like(mats)
    scratch = mats.new_empty((R, 2 * K)) if 8 * K > SMEM_PER_CTA and R > 0 else None
    _build.launch("pmf_gj_inverse", GJ_LAUNCHES, mats.device, mats, R, K, out, scratch)
    return out
