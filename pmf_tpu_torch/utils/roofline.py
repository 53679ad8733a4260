"""The card's roofline: the least bytes and operations a blocked sweep's
work needs, and the share of the card's peaks that a measured time
reaches.

The port of ``pmf_tpu/utils/roofline.py``, which counts the TPU kernels'
own traffic (chunk tables, one-hot matrix-unit MACs).  This module counts
the work over the port's layouts instead: a single device's
``data.blocked.BlockedCOO`` (a CSR tail a direction, dense head tiers
read by both passes), a data-parallel rank's band of one, or a TP rank's
``parallel.tp_blocked.TPBlockedLayout`` (a CSR tail and head tiers a ring
bucket).  It counts what any kernel must move, not one kernel's way of
moving it, so a kernel redesign leaves the count as it is.  Per pass:

* each tail edge's other id once, and its rating where the pass reads
  ratings;
* the row pointers once (one a self row, however a kernel splits rows);
* each factor table the pass reads once, at its real columns: the other
  table once per tail (once per ring bucket), the self table once;
* the pass's output once;
* for each head tier, its planes' real cells once for each product that
  reads them, and the tier's rows of the product's operand tables once.

Left out: 32-byte sectors, record padding (``ops._tail.tail_stride``),
the head planes' column padding (``hip``), long-row splits, launch plans, the tables' permutation into new space and
the elementwise row updates.  ``chip_smoke.py``'s per-edge sector
reckonings are a second, implementation-aware figure; they are never the
denominator of a share.

Operations: each head product is 2 * cells * columns (cells = a tier's
rows times its real columns), counted as bf16 tensor-core work, as the
port runs them; the tail's per-edge arithmetic and the row solves as FP32.

The card's peaks live in ``PEAKS``, keyed by ``torch.cuda.get_device_name``;
an unknown card raises rather than borrow another card's peaks.
"""

from __future__ import annotations

import dataclasses

H100 = "NVIDIA H100 80GB HBM3"


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's published peaks: HBM bytes/s, dense bf16 tensor-core and
    FP32 CUDA-core FLOP/s (a multiply-add is 2 FLOPs)."""

    name: str
    hbm_bytes_per_s: float
    bf16_flops_per_s: float
    fp32_flops_per_s: float


PEAKS = {H100: Peaks(H100, 3.35e12, 989e12, 67e12)}  # H100 SXM5 data sheet

HBM_BYTES_PER_S = PEAKS[H100].hbm_bytes_per_s
BF16_FLOPS_PER_S = PEAKS[H100].bf16_flops_per_s
FP32_FLOPS_PER_S = PEAKS[H100].fp32_flops_per_s

# FP32 operations an edge of each tail pass: K1 (dot 2K, allocation 2K,
# other sum K, divide), K7 (K1's and the scalar-weighted sum), K8 (dot and
# scalar), K3 (the pass-through [m | tri] sums and m (x - b)) and K5.
EDGE_FLOPS = {
    "cavi": lambda K: 5 * K + 1,
    "ext_factor": lambda K: 6 * K + 1,
    "ext_scalar": lambda K: 2 * K + 1,
    "gauss_factor": lambda K: 3 * K + 1 + K * (K + 1) // 2,
    "gauss_bias": lambda K: K + 2,
}
MODEL = "analytic lower bound of the work (see pmf_tpu_torch/utils/roofline.py)"


def peaks(card: str | None = None) -> Peaks:
    """The peaks of ``card`` (a ``torch.cuda.get_device_name`` string);
    None reads the name from the card, raising without one."""
    if card is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the card whose peaks to use")
        card = torch.cuda.get_device_name()
    if card not in PEAKS:
        raise ValueError(f"no published peaks for {card!r} (known: {sorted(PEAKS)})")
    return PEAKS[card]


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of ``n_bytes`` of
    memory traffic and ``n_flops`` FP32 operations on the card (its name
    read as ``peaks`` reads it)."""
    pk = peaks()
    t_bytes = n_bytes / pk.hbm_bytes_per_s * 1e3
    t_ops = n_flops / pk.fp32_flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _plane_bytes(tier, planes, precision: str) -> int:
    """Bytes a cell of ``tier``'s planes that a product reads: X as
    its bf16 high plane (and the remainder plane at "high"), M as stored
    (as one bf16 plane at "fast")."""
    n = 0
    if "x" in planes:
        n += 2 + (2 if tier.x_lo is not None and precision != "fast" else 0)
    if "m" in planes:
        n += 2 if precision == "fast" else tier.m.element_size()
    return n


def head_traffic(tier, self_rows: int, other_rows: int, *, planes=(),
                 self_width: int = 0, other_width: int = 0, product_width: int = 0,
                 row_flops: int = 0, precision: str = "high",
                 float_bytes: int = 4) -> dict:
    """One pass's work over one head tier: its stored ``planes`` ("x",
    "m") read once, ``self_width`` columns of its ``self_rows`` and
    ``other_width`` of its ``other_rows`` read once, products of
    ``product_width`` output columns in all over its cells (bf16 tensor
    operations) and ``row_flops`` FP32 operations a self row.  The planes
    count their ``hu * hi`` real cells, not the columns padded to ``hip``."""
    cells = tier.hu * tier.hi
    return {"bytes": (cells * _plane_bytes(tier, planes, precision)
                      + (self_rows * self_width + other_rows * other_width) * float_bytes),
            "flops_bf16": 2 * cells * product_width,
            "flops_fp32": self_rows * row_flops}


def _passes(layout) -> dict:
    """{"theta": (segments, self rows, rows updated), "beta": ...}: a
    segment is (tail, its self rows, its other table's rows, [(tier, self
    rows, other rows)]); "self rows" are the rows whose table the pass
    reads and whose output it writes (a band under a mesh), "rows
    updated" the rows whose solve the rank makes."""
    if isinstance(layout.by_user, tuple):  # a TP rank's ring buckets
        def side(buckets, n_rows):
            segs = [(b.tail, b.rows, b.tail.n_other, [(t, t.hu, t.hi) for t in b.head])
                    for b in buckets]
            span = (max(b.row0 + b.rows for b in buckets) - min(b.row0 for b in buckets))
            return segs, span, n_rows

        return {"theta": side(layout.by_user, layout.users_per),
                "beta": side(layout.by_item, layout.items_per)}
    head = layout.head or ()
    u, i = layout.by_user, layout.by_item
    return {"theta": ([(u, u.rows, u.n_other, [(t, t.hu, t.hi) for t in head])],
                      u.rows, u.n_self),
            "beta": ([(i, i.rows, i.n_other, [(t, t.hi, t.hu) for t in head])],
                     i.rows, i.n_self)}


def _float_bytes(layout) -> int:
    tail = layout.by_user[0].tail if isinstance(layout.by_user, tuple) else layout.by_user
    return tail.x.element_size()


def _edge_pass(segments, self_rows: int, float_bytes: int, *, self_width: int,
               other_width: int, out_width: int, reads_x: bool, edge_flops: int,
               head) -> dict:
    """One pass over a direction's tails and tiers (``head(tier, self
    rows, other rows)`` gives a tier's ``head_traffic``)."""
    tail_b = self_rows * (self_width + out_width) * float_bytes
    head_b = flops_bf16 = flops_fp32 = 0
    for p, rows, n_other, tiers in segments:
        tail_b += (p.nnz * (p.other.element_size() + (p.x.element_size() if reads_x else 0))
                   + (rows + 1) * p.row_ptr.element_size() + n_other * other_width * float_bytes)
        flops_fp32 += p.nnz * edge_flops
        for tier, s_rows, o_rows in tiers:
            h = head(tier, s_rows, o_rows)
            head_b += h["bytes"]
            flops_bf16 += h["flops_bf16"]
            flops_fp32 += h["flops_fp32"]
    return {"bytes": tail_b + head_b, "tail_bytes": tail_b, "head_bytes": head_b,
            "flops_bf16": flops_bf16, "flops_fp32": flops_fp32}


def _sweep(parts: dict) -> dict:
    """The parts and their sums, under the reference's keys
    (``bytes_per_iter``, ``macs_per_iter`` the bf16 tensor multiply-adds,
    ``head["bytes"]``) and the FP32 operations."""
    total = {k: sum(p[k] for p in parts.values())
             for k in ("bytes", "head_bytes", "flops_bf16", "flops_fp32")}
    return {**parts, "head": {"bytes": total["head_bytes"]},
            "bytes_per_iter": total["bytes"], "macs_per_iter": total["flops_bf16"] // 2,
            "fp32_flops_per_iter": total["flops_fp32"]}


def hpf_blocked_traffic(layout, K: int, precision: str = "high") -> dict:
    """An HPF or plain Poisson sweep: a theta and a beta pass.  The tail
    (K1) reads the self and other factor tables and the ratings and writes
    [S_alloc | S_other]; each tier's rate statistics [W | M] @ B read its
    planes once and its rows of both tables, with three products of K
    columns (R = Theta B^T, W @ B, M @ B)."""
    fb = _float_bytes(layout)

    def head(t, s, o):
        return head_traffic(t, s, o, planes=("x", "m"), self_width=K, other_width=K,
                            product_width=3 * K, precision=precision, float_bytes=fb)

    return _sweep({name: _edge_pass(segs, rows, fb, self_width=K, other_width=K,
                                    out_width=2 * K, reads_x=True,
                                    edge_flops=EDGE_FLOPS["cavi"](K), head=head)
                   for name, (segs, rows, _) in _passes(layout).items()})


def poisson_ext_blocked_traffic(layout, K: int, precision: str = "high") -> dict:
    """An extended Poisson sweep, a factor and a scalar pass a direction.
    Factor (K7): the self factors, the other [E | s] records and the
    ratings in, [S_alloc | S_wother] out; each tier's planes once, its rows
    of Theta, B and s * B, and R, W @ B and M @ (s * B).  Scalar (K8): the
    new self factors and the records in, no ratings, a column out; each
    tier's rows of the new factors and of the factor pass's M @ (s * B),
    their row dot in FP32."""
    fb = _float_bytes(layout)
    parts = {}
    for name, (segs, rows, _) in _passes(layout).items():
        parts[f"{name}_factor"] = _edge_pass(
            segs, rows, fb, self_width=K, other_width=K + 1, out_width=2 * K,
            reads_x=True, edge_flops=EDGE_FLOPS["ext_factor"](K),
            head=lambda t, s, o: head_traffic(
                t, s, o, planes=("x", "m"), self_width=K, other_width=2 * K,
                product_width=3 * K, precision=precision, float_bytes=fb))
        parts[f"{name}_scalar"] = _edge_pass(
            segs, rows, fb, self_width=K, other_width=K + 1, out_width=1,
            reads_x=False, edge_flops=EDGE_FLOPS["ext_scalar"](K),
            head=lambda t, s, o: head_traffic(t, s, o, self_width=2 * K,
                                              row_flops=2 * K, float_bytes=fb))
    return _sweep(parts)


def gaussian_blocked_traffic(layout, K: int, precision: str = "high",
                             bias_update: str = "exact", use_bias: bool = True) -> dict:
    """A Gaussian sweep (full covariance), per direction: the factor pass
    (K3: the other [m | b | tri(V + m m^T)] records and the ratings in,
    [S_w | S_m | S_A] out (and the lagged bias statistics); each tier's M
    planes against [m | b m | tri | b] and its X planes against m), the
    rows' K x K inverses (the precision matrices in, the covariances out,
    2 K^3 FP32 operations a row) and, with exact biases, the bias pass
    (K5: [m | b] records and the ratings in, K + 2 columns out; each tier's
    M planes against [m | b])."""
    T = K * (K + 1) // 2
    lagged = use_bias and bias_update == "lagged"
    fb = _float_bytes(layout)
    w_tab = 2 * K + T + 1
    parts = {}
    for name, (segs, rows, n_rows) in _passes(layout).items():
        parts[f"{name}_factor"] = _edge_pass(
            segs, rows, fb, self_width=0, other_width=K + 1 + T,
            out_width=2 * K + T + (2 if lagged else 0), reads_x=True,
            edge_flops=EDGE_FLOPS["gauss_factor"](K),
            head=lambda t, s, o: head_traffic(
                t, s, o, planes=("x", "m"), other_width=w_tab, product_width=w_tab + K,
                precision=precision, float_bytes=fb))
        parts[f"{name}_inverse"] = {"bytes": 2 * n_rows * K * K * fb,
                                    "tail_bytes": 2 * n_rows * K * K * fb, "head_bytes": 0,
                                    "flops_bf16": 0, "flops_fp32": 2 * n_rows * K**3}
        if use_bias and not lagged:
            parts[f"{name}_bias"] = _edge_pass(
                segs, rows, fb, self_width=0, other_width=K + 1, out_width=K + 2,
                reads_x=True, edge_flops=EDGE_FLOPS["gauss_bias"](K),
                head=lambda t, s, o: head_traffic(
                    t, s, o, planes=("m",), other_width=K + 1, product_width=K + 1,
                    precision=precision, float_bytes=fb))
    return _sweep(parts)


def roofline_fields(traffic: dict, iter_seconds: float, card: str | None = None) -> dict:
    """A traffic count and a measured time as the reference's fields, each
    against ``card``'s peaks (None: the card's own name).  ``pct_mfu_bf16``
    is the time the operations need at their classes' peaks (bf16 tensor
    cores for ``macs_per_iter``, FP32 for ``fp32_flops_per_iter``) over the
    measured time; a count of the reference's shape, without FP32
    operations, is all bf16 tensor work.  Unrounded."""
    pk = peaks(card)
    b = traffic["bytes_per_iter"]
    bf16 = 2.0 * traffic["macs_per_iter"]
    fp32 = float(traffic.get("fp32_flops_per_iter", 0))
    head_b = traffic.get("head", {}).get("bytes", 0)
    return {
        "bytes_per_iter": int(b),
        "pct_hbm_roofline": 100.0 * b / iter_seconds / pk.hbm_bytes_per_s,
        "effective_gbps": b / iter_seconds / 1e9,
        "pct_mfu_bf16": 100.0 * (bf16 / pk.bf16_flops_per_s
                                 + fp32 / pk.fp32_flops_per_s) / iter_seconds,
        "effective_tflops": (bf16 + fp32) / iter_seconds / 1e12,
        "tail_bytes_per_iter": int(b - head_b),
        "head_bytes_per_iter": int(head_b),
        "model": MODEL,
        "card": pk.name,
    }
