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
pivot p).  Up to K = 64 one row a thread, the matrices of a CTA packed
across its threads, scaling the pivot row by one reciprocal;
``launch_plan`` gives the geometry the kernel picks for a K.  From K = 65
to 239 (``form`` "cta") a CTA of 16 x 16 threads inverts one matrix held
in registers, thread (ty, tx) keeping the T x T tile of entries (16 r +
ty, 16 c + tx), T = ceil(K / 16), the warp holding each pivot row
publishing it to the others through named barriers; ``cta_plan`` gives
its geometry (tile rows in registers and in shared
memory, CTAs an SM, shared bytes).  Past it ("panel") a CTA inverts one
matrix held in global memory, its pivots in panels of b: the panel's
pivot block eliminated alone, then the panel's rows and columns, then the
rest of the matrix once, each entry through the panel's pivots in order;
``panel_plan`` gives b, the CTAs an SM and the shared bytes, at any K.
"""

from __future__ import annotations

import torch

from pmf_tpu_torch.ops import _build

GJ_LAUNCHES = _build.LaunchCounter()
ROWS_MAX_K = 64  # csrc/gj_inverse.cu: kRowsMaxK
SMEM_PER_CTA = 232_448  # kSmemPerCta
# The CTA form's plan: csrc/gj_tile.cuh's host plan block.
TILE_GRID = 16  # kTileGrid: the CTA form's threads, 16 x 16
TILE_THREADS = TILE_GRID * TILE_GRID
REGS_PER_SM = 65_536  # kRegsPerSm
WORDS_ONE_CTA = 210  # kWordsOneCta
TILE_CTAS = (4, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1)  # kTileCtas: CTAs an SM for T = 5..15
TILE_MAX_K = 239  # kCtaMaxK: the CTA form's last K
# The panel form's plan: csrc/gj_inverse.cu's host plan block.
SMEM_PER_SM = 233_472  # kSmemPerSm: 228 KB an SM, 1 KB of it reserved a CTA
PANEL_THREADS = 256  # gj_panel.cu: kThreads
PANEL_MAX_B = 32  # kPanelMaxB: a strip's values in registers
PANEL_MIN_B = 8  # kPanelMinB
PANEL_CTAS = 2  # kPanelCtas: the launch bound
PANEL_MIN_B2 = 16  # kPanelMinB2: the fewest pivots a panel with two CTAs an SM
PANEL_TILE = (8, 4)  # a thread's entries of the rest, rows x columns
PANEL_BLOCK = (128, 64)  # the rest's blocks: 16 x 16 threads of PANEL_TILE


def form(k: int) -> str:
    """The kernel's form for ``k``: "rows" (a row a thread) up to K = 64,
    "cta" (a CTA a matrix in registers) to TILE_MAX_K, then "panel" (a CTA
    a matrix in global memory, its pivots in panels)."""
    _build.check_k(k, "Gauss-Jordan kernel")
    if k <= ROWS_MAX_K:
        return "rows"
    return "cta" if k <= TILE_MAX_K else "panel"


def panel_stride(k: int) -> int:
    """The strips' row stride: K rounded up to 4 floats."""
    return -(-k // 4) * 4


def panel_words(k: int, b: int, in_global: bool) -> int:
    """Floats of the panel form's shared memory: the pivot block's two
    buffers, its rows and columns (4 b x b4), the pivots (b4) and, unless
    ``in_global``, the
    strips' rows and columns (2 b x stride) and 8 floats of slack."""
    b4 = -(-b // 4) * 4
    return 4 * b * b4 + b4 + (0 if in_global else 2 * b * panel_stride(k) + 8)


def panel_plan(k: int) -> dict | None:
    """The panel form's geometry for ``k`` (``csrc/gj_inverse.cu``'s
    ``panel_plan``; None below it): ``b`` pivots a panel, the largest
    multiple of 8 up to PANEL_MAX_B whose shared memory leaves two CTAs an
    SM if it is at least PANEL_MIN_B2, else the largest that fits one CTA, else
    PANEL_MAX_B with the strips' rows and columns in global scratch
    (``global_panels``, ``scratch_floats`` a matrix); ``ctas_per_sm`` as
    shared memory allows, ``smem_bytes``, ``stride``; ``threads`` 256,
    each holding a ``tile`` of 8 x 4 entries of each 128 x 64 ``block`` of
    the rest."""
    if form(k) != "panel":
        return None

    def fits(b, ctas):
        nbytes = 4 * panel_words(k, b, False)
        return ctas * (nbytes + 1024) <= SMEM_PER_SM and nbytes <= SMEM_PER_CTA

    b = ctas = 0
    for c in range(PANEL_CTAS, 0, -1):
        b = next((t for t in range(PANEL_MAX_B, (PANEL_MIN_B2 if c > 1 else PANEL_MIN_B) - 1,
                                   -8)
                  if fits(t, c)), 0)
        if b:
            ctas = c
            break
    in_global = b == 0
    if in_global:
        b = PANEL_MAX_B
    smem = 4 * panel_words(k, b, in_global)
    if in_global:
        ctas = PANEL_CTAS if PANEL_CTAS * (smem + 1024) <= SMEM_PER_SM else 1
    return dict(b=b, threads=PANEL_THREADS, tile=PANEL_TILE, block=PANEL_BLOCK,
                ctas_per_sm=ctas, smem_bytes=smem, global_panels=in_global,
                stride=panel_stride(k),
                scratch_floats=2 * b * panel_stride(k) if in_global else 0)


def boundary_ks(k_max: int = 600) -> list:
    """The first K of each form, of each row-form instance and of each
    panel-form instance (the strips in shared or in global memory) up to
    ``k_max``: the tests and chip_smoke.py hold K4 on both sides of each."""
    out, last = [], None
    for k in range(1, k_max + 1):
        p, q = launch_plan(k), panel_plan(k)
        key = (form(k), p and p["kmax"], q and q["global_panels"])
        if key != last:
            out.append(k)
            last = key
    return out


def panel_boundary_ks(k_max: int = 1200) -> list:
    """Each K of the panel form up to ``k_max`` where ``panel_plan`` (b,
    CTAs an SM, strips in global memory) changes, its first K included."""
    out, last = [], None
    for k in range(TILE_MAX_K + 1, k_max + 1):
        q = panel_plan(k)
        key = (q["b"], q["ctas_per_sm"], q["global_panels"])
        if key != last:
            out.append(k)
            last = key
    return out


def tile_pad(t: int) -> int:
    """A thread's stride in the CTA form's row buffers: T rounded up to 4
    floats, made 4 mod 8 (float4 reads of 8 threads touch 32 banks)."""
    s = -(-t // 4) * 4
    return s + 4 if s % 8 == 0 else s


def tile_words(t: int, reg_rows: int) -> int:
    """Words a thread of the CTA form keeps in registers: its tile rows
    there and its T row values."""
    return reg_rows * t + t


def reg_cap(ctas: int) -> int:
    """Registers a thread may hold with ``ctas`` CTAs of 256 threads an SM
    (in units of 8, at most 255)."""
    return min(255, REGS_PER_SM // (TILE_THREADS * ctas) // 8 * 8)


def cta_plan(k: int) -> dict | None:
    """The CTA form's geometry for ``k`` (``csrc/gj_tile.cuh``'s
    ``cta_plan``; None outside 65 <= K <= TILE_MAX_K): ``threads`` 256 as a
    ``grid`` of 16 x 16, thread (ty, tx) holding the ``tile`` of T x T
    entries (16 r + ty, 16 c + tx), T = ceil(K / 16); the launch bound's
    ``ctas_per_sm`` (TILE_CTAS, as timed on the card: more CTAs spill the
    tiles); ``reg_rows`` of its tile rows in registers, all but where one
    CTA fills an SM, there those whose ``words`` (tile rows and row
    values) fit WORDS_ONE_CTA, and ``smem_rows`` in shared memory;
    ``tpad``, the row buffers' stride a thread; ``stride``, the staging
    chunks' row stride
    (K rounded up to 4 floats); ``smem_bytes``: two row buffers, two
    staging chunks of 16 rows and the shared tile rows."""
    if form(k) != "cta":
        return None
    t = -(-k // TILE_GRID)
    ctas = TILE_CTAS[t - 5]
    reg_rows = t
    if ctas == 1:
        while reg_rows > 0 and tile_words(t, reg_rows) > WORDS_ONE_CTA:
            reg_rows -= 1
    tp, stride = tile_pad(t), -(-k // 4) * 4
    words = 2 * TILE_GRID * tp + 2 * TILE_GRID * stride + (t - reg_rows) * t * TILE_THREADS
    return dict(threads=TILE_THREADS, grid=(TILE_GRID, TILE_GRID), tile=(t, t),
                reg_rows=reg_rows, smem_rows=t - reg_rows, ctas_per_sm=ctas,
                words=tile_words(t, reg_rows), tpad=tp, stride=stride,
                smem_bytes=4 * words)


def cta_boundary_ks() -> list:
    """Each K of the CTA form (65 to TILE_MAX_K) where ``cta_plan``'s geometry
    (tile, rows in registers, CTAs an SM) changes, its first K included:
    the tests and chip_smoke.py hold K4 on both sides of each."""
    out, last, k = [], None, ROWS_MAX_K + 1
    while form(k) == "cta":
        p = cta_plan(k)
        key = (p["tile"], p["reg_rows"], p["ctas_per_sm"])
        if key != last:
            out.append(k)
            last = key
        k += 1
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
    plan = panel_plan(K)
    scratch = (mats.new_empty(R * plan["scratch_floats"] + 8)
               if plan and plan["global_panels"] and R > 0 else None)
    _build.launch("pmf_gj_inverse", GJ_LAUNCHES, mats.device, mats, R, K, out, scratch)
    return out
