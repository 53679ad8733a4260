"""Meshes of ranks for multi-device training, over ``torch.distributed``.

The JAX package drives every device of a mesh from one process (SPMD under
``shard_map``, ``pmf_tpu/parallel/mesh.py``).  The port runs one process a
rank: the caller (``torchrun``, or a test harness) starts the default
process group, and ``make_mesh`` / ``make_mesh_2d`` describe it.  The
backend is NCCL for ranks on CUDA cards and gloo for ranks on the CPU; a
CUDA mesh over any other backend raises, it never falls back.  Each rank's
device is explicit: ``cuda:{LOCAL_RANK}``, or the CPU when the caller asks
for it.

Every rank must make the same calls in the same order, or a collective
hangs: the same full training set on every rank (each builds the same host
layout, then keeps its share), the same initial state (from the config's
seed through numpy), every decision taken from numbers that a collective
made equal on every rank (the validation metrics are all-reduced sums, the
ELBO is rank 0's, broadcast), rank 0 alone writing checkpoints and printing,
followed by a barrier.

Data parallelism (``fit(mesh=)``): both sorted copies of the edges are cut
contiguously over the "data" axis (``shard_ratings``), so each row's edges
lie on at most two ranks; the counts stay global.  Each sweep computes its
per-row statistics over the rank's edges, sums them over the data axis
(``Mesh.sum``, the sweeps' ``reduce`` hook) and every rank applies the same
row update to its replica of the state.  A blocked layout is cut the same
way (``shard_blocked``): each rank keeps a band of each direction's CSR
tail, cut where the edge count reaches nnz / dp, and a band of each head
tier's rows.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from pmf_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh over the default process group.

    ``axis_names`` is ("data",) or ("data", "model"); ``shape`` and
    ``coords`` map each axis to its size and to this rank's index on it.
    ``groups`` maps each axis to (process group, global ranks in axis
    order): the ranks that share every other coordinate with this one.
    The group is None where the axis spans the whole world (the default
    group).  Global rank r sits at data index r // tp, model index r % tp,
    as the JAX package's ``devices.reshape(dp, tp)``."""

    axis_names: tuple
    shape: dict
    rank: int
    coords: dict
    device: torch.device
    groups: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def tp(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone prints and writes checkpoints."""
        return self.rank == 0

    def group(self, axis: str | None):
        """The process group of ``axis``; None, the default group, for the
        whole mesh (``axis`` None) or an axis that spans it."""
        return None if axis is None else self.groups[axis][0]

    def ranks(self, axis: str) -> tuple:
        return self.groups[axis][1]

    def sum(self, *tensors: torch.Tensor, axis: str | None = DATA_AXIS) -> list:
        """The tensors summed over ``axis`` (every rank when None): one
        all-reduce of their flat concatenation (one for each dtype); equal
        on every rank."""
        out = list(tensors)
        for dt in {t.dtype for t in tensors}:
            idx = [n for n, t in enumerate(tensors) if t.dtype == dt]
            flat = torch.cat([tensors[n].reshape(-1) for n in idx])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group(axis))
            at = 0
            for n in idx:
                t = tensors[n]
                out[n] = flat[at : at + t.numel()].view(t.shape)
                at += t.numel()
        return out

    def gather(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``tensor`` (equal shapes) along ``axis``,
        concatenated on dim 0 in axis order."""
        parts = [torch.empty_like(tensor) for _ in self.ranks(axis)]
        dist.all_gather(parts, tensor.contiguous(), group=self.group(axis))
        return torch.cat(parts)

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``tensor`` on every rank (in place)."""
        dist.broadcast(tensor, src=0)
        return tensor

    def decide(self, value) -> float:
        """Rank 0's scalar on every rank, so a decision taken from it is the
        same everywhere (the ELBO's monotone gate); read through
        ``utils.device.ScalarReader``."""
        from pmf_tpu_torch.utils.device import ScalarReader

        t = torch.as_tensor(value, dtype=torch.float64, device=self.device).reshape(1)
        return ScalarReader().start(self.broadcast(t.clone())[0])()[0]

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def save_state(self, path: str, state: dict, meta: dict | None = None) -> None:
        """``utils.checkpoint.save_state`` on rank 0, then a barrier: no rank
        goes on (or reads the checkpoint) before it is written."""
        from pmf_tpu_torch.utils.checkpoint import save_state

        if self.is_writer:
            save_state(path, state, meta)
        self.barrier()


def _check_group(n_ranks: int | None, device) -> tuple:
    """(world size, this rank's device) of the default process group, or
    raise: no group, a size other than ``n_ranks``, or a backend that
    cannot carry the device's tensors."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh runs one process a rank over torch.distributed's default "
            "process group: start it with torch.distributed.init_process_group "
            "(torchrun gives each process its rank and address) before make_mesh")
    world = dist.get_world_size()
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"a mesh of {n_ranks} ranks needs a process group of as "
                         f"many, this one has {world}")
    if device is None:
        resolve_device(None)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        device = f"cuda:{local}"
    dev = resolve_device(device)
    backend = str(dist.get_backend())
    if dev.type == "cuda":
        if "nccl" not in backend:
            raise RuntimeError(f"a CUDA mesh needs the nccl backend; the process "
                               f"group runs {backend!r}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    elif "gloo" not in backend:
        raise RuntimeError(f"a CPU mesh needs the gloo backend; the process group "
                           f"runs {backend!r}")
    return world, dev


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A 1-D ("data",) mesh over every rank of the default process group
    (whose size must equal ``n_devices`` when given).  ``device``: None =
    the card ``cuda:{LOCAL_RANK}`` (raises without one); "cpu" for ranks on
    the host."""
    world, dev = _check_group(n_devices, device)
    rank = dist.get_rank()
    return Mesh(axis_names=(DATA_AXIS,), shape={DATA_AXIS: world}, rank=rank,
                coords={DATA_AXIS: rank}, device=dev,
                groups={DATA_AXIS: (None, tuple(range(world)))})


def make_mesh_2d(dp: int, tp: int, device=None) -> Mesh:
    """A (dp, tp) mesh with axes ("data", "model") for hybrid training:
    edges split over "data", factor-state rows over "model".  Every rank
    creates every subgroup, in one order (all the data groups, then all
    the model groups), as ``torch.distributed.new_group`` requires."""
    world, dev = _check_group(dp * tp, device)
    rank = dist.get_rank()
    p, d = divmod(rank, tp)

    def make(rank_sets):
        mine = None
        for ranks in rank_sets:
            ranks = tuple(ranks)
            g = None if len(ranks) == world else dist.new_group(list(ranks))
            if rank in ranks:
                mine = (g, ranks)
        return mine

    data = make([[q * tp + e for q in range(dp)] for e in range(tp)])
    model = make([[q * tp + e for e in range(tp)] for q in range(dp)])
    return Mesh(axis_names=(DATA_AXIS, MODEL_AXIS),
                shape={DATA_AXIS: dp, MODEL_AXIS: tp}, rank=rank,
                coords={DATA_AXIS: p, MODEL_AXIS: d}, device=dev,
                groups={DATA_AXIS: data, MODEL_AXIS: model})


def share(n: int, index: int, parts: int) -> slice:
    """Part ``index`` of ``parts`` contiguous parts of n items, as
    ``numpy.array_split`` cuts them."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return slice(lo, lo + base + (index < extra))


def _data_share(n: int, mesh: Mesh) -> slice:
    return share(n, mesh.coords[DATA_AXIS], mesh.dp)


def shard_ratings(data, mesh: Mesh):
    """The rank's share of a ``data.coo.RatingsCOO`` built on any device:
    each sorted copy cut contiguously over the "data" axis (so each row's
    edges lie on at most two ranks), moved to the mesh's device.  Counts,
    sizes and ``nnz`` stay global; ``nnz_padded`` becomes the share's
    length."""
    dev = mesh.device
    sl = _data_share(data.nnz_padded, mesh)

    def cut(t):
        return t[sl].to(dev).clone()

    return dataclasses.replace(
        data, u_by_u=cut(data.u_by_u), i_by_u=cut(data.i_by_u), x_by_u=cut(data.x_by_u),
        u_by_i=cut(data.u_by_i), i_by_i=cut(data.i_by_i), x_by_i=cut(data.x_by_i),
        user_counts=data.user_counts.to(dev), item_counts=data.item_counts.to(dev),
        nnz_padded=sl.stop - sl.start)


def shard_eval_set(ev, mesh: Mesh, whole_mesh: bool = False):
    """The rank's share of a ``data.coo.EvalSet`` (rows cut contiguously
    over the "data" axis, or over every rank with ``whole_mesh``), on the
    mesh's device; the class values stay whole.  Metrics over the shares
    are summed by the fits (``eval.metrics.masked_metrics``)."""
    sl = (share(ev.n_rows_padded, mesh.rank, mesh.size) if whole_mesh
          else _data_share(ev.n_rows_padded, mesh))
    dev = mesh.device

    def cut(t):
        return t[sl].to(dev).clone()

    return dataclasses.replace(
        ev, u=cut(ev.u), i=cut(ev.i), x=cut(ev.x), real=cut(ev.real),
        valid=cut(ev.valid), class_id=cut(ev.class_id),
        class_value=ev.class_value.to(dev), n_rows_padded=sl.stop - sl.start)


def replicate(tree: dict, mesh: Mesh) -> dict:
    """A dict of tensors on the mesh's device, equal on every rank: rank
    0's values, broadcast, so replicas cannot drift."""
    return {k: mesh.broadcast(v.detach().to(mesh.device).contiguous().clone())
            for k, v in tree.items()}


def shard_state_rows(state: dict, mesh: Mesh) -> dict:
    """The rank's rows of each state tensor whose leading dimension the
    "data" axis divides (``dp`` equal contiguous parts); other tensors
    whole.  On the mesh's device."""
    out = {}
    for k, v in state.items():
        if v.dim() >= 1 and v.shape[0] % mesh.dp == 0:
            v = v[_data_share(v.shape[0], mesh)]
        out[k] = v.to(mesh.device).clone()
    return out


def _band_head(tier, index: int, parts: int):
    """Rows band ``index`` of ``parts`` of a dense head tier, as a tier of
    its own (copies, so the whole tier can be freed).  Its column rating
    sums (the Gaussian bias statistics' S_x on the item side) are the whole
    tier's on band 0 and zero on the others, so their sum over the bands is
    exact."""
    from pmf_tpu_torch.data.blocked import DenseHead

    if tier.hu % parts:
        raise ValueError(f"a head tier of {tier.hu} rows does not cut into {parts} "
                         "bands: build the layout with head_row_mult=dp")
    rows = tier.hu // parts
    sl = slice(index * rows, (index + 1) * rows)
    return DenseHead(
        x_hi=tier.x_hi[sl].clone(),
        x_lo=None if tier.x_lo is None else tier.x_lo[sl].clone(),
        m=tier.m[sl].clone(), x_sum_user=tier.x_sum_user[sl].clone(),
        x_sum_item=tier.x_sum_item.clone() if index == 0
        else torch.zeros_like(tier.x_sum_item),
        hu=rows, hi=tier.hi, r0=min(tier.r0, rows), row_start=tier.row_start + sl.start)


def band_csr(p, index: int, parts: int):
    """Band ``index`` of ``parts`` of a CSR tail's rows, cut by edges
    (``data.blocked.band_bounds``) into a ``TailCSR`` of its own."""
    from pmf_tpu_torch.data.blocked import band_bounds, band_of

    r0, r1 = band_bounds(p.row_ptr.cpu().numpy(), parts)[index]
    return band_of(p, r0, r1)


def shard_blocked(blocked, mesh: Mesh):
    """The rank's share of a ``data.blocked.BlockedCOO``: band ``p`` of dp
    of each direction's tail and of each head tier's rows (the tiers'
    rows a multiple of dp: ``build_blocked(head_row_mult=dp)``), for the
    blocked sweeps' ``reduce`` hook to sum."""
    p, dp = mesh.coords[DATA_AXIS], mesh.dp
    head = blocked.head
    return dataclasses.replace(
        blocked, by_user=band_csr(blocked.by_user, p, dp),
        by_item=band_csr(blocked.by_item, p, dp),
        head=None if head is None else tuple(_band_head(t, p, dp) for t in head))
