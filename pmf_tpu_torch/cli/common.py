"""Shared CLI plumbing: the device, data access with a synthetic
fallback, centring and shifting, timing and headers.

Every entry point also accepts ``--synthetic N`` to run on generated data
(the Kaggle dataset is not redistributable), and ``--device`` (default:
the CUDA card; it raises without one).  ``setup_runtime`` resolves the
device and, on the card, builds and loads the kernel library, so a
missing card or a kernel that fails to build stops the command before
any model runs.  It also turns on the layout cache
(``data.layout_cache``) under ``.torch_cache/layouts`` in the repository
unless ``PMF_TPU_TORCH_LAYOUT_CACHE`` is set (empty: off), so tune ->
compare -> train_full reload the blocked layout instead of rebuilding it.

``--mesh_devices N`` (run_single, compare, train_full, recommend) runs a
command over N ranks, one process a rank, under ``torchrun
--nproc_per_node N`` (``mesh_session``): every rank runs the same command
and fits data-parallel (``parallel.mesh``), every decision comes from
numbers the ranks share, and rank 0 alone prints and writes files.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import pandas as pd
import torch

from pmf_tpu_torch.data import layout_cache
from pmf_tpu_torch.data.pipeline import load_all_splits
from pmf_tpu_torch.data.synthetic import synth_splits
from pmf_tpu_torch.ops._build import KernelError
from pmf_tpu_torch.utils.device import resolve_device

LAYOUT_CACHE_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".torch_cache", "layouts")

# Raised out of every CLI's per-model isolation: a fault of the card or of
# its kernels is not one model's failure.
DEVICE_FAULTS = (KernelError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def setup_runtime(device=None) -> torch.device:
    """Resolve ``device`` (None = the card, raising without one); on the
    card, build and load the kernel library now.  Sets the layout cache's
    default directory where the environment names none."""
    os.environ.setdefault(layout_cache.ENV_VAR, LAYOUT_CACHE_DEFAULT)
    dev = resolve_device(device)
    if dev.type == "cuda":
        from pmf_tpu_torch.ops import _build

        _build.load_library()
    return dev


def add_mesh_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh_devices", type=int, default=0, metavar="N",
                        help="fit over an N-rank data-parallel mesh, one process a "
                             "rank: start the command under torchrun "
                             "--nproc_per_node N (0 = one device)")


@contextlib.contextmanager
def mesh_session(n_devices: int, device, command: str):
    """The mesh of ``--mesh_devices`` (None for 0) over the default process
    group.  A group that is already running is used and left running;
    else one is started from torchrun's environment (``env://``: nccl for
    the card, gloo for ``--device cpu``) and destroyed at the end.  Without
    either it raises, naming the torchrun line: it never falls back to one
    device and never starts processes of its own.  On ranks other than 0
    the standard output goes nowhere; on leaving, every rank waits at a
    barrier for the others."""
    if not n_devices:
        yield None
        return
    import torch.distributed as dist

    from pmf_tpu_torch.parallel import make_mesh

    dev = resolve_device(device)
    started = not dist.is_initialized()
    if started:
        if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                f"--mesh_devices {n_devices} runs one process a rank and no process "
                f"group is running: start the command as torchrun --nproc_per_node "
                f"{n_devices} -m pmf_tpu_torch.cli.{command} ... (or python -m "
                "torch.distributed.run)")
        world = int(os.environ["WORLD_SIZE"])
        if world != n_devices:
            raise ValueError(f"--mesh_devices {n_devices} under torchrun with "
                             f"WORLD_SIZE={world}: give --nproc_per_node {n_devices}")
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                                init_method="env://")
    try:
        # A card named without an index means each rank's own card.
        mesh = make_mesh(n_devices, device=None if dev.type == "cuda" and dev.index is None
                         else dev)
        with contextlib.ExitStack() as stack:
            if not mesh.is_writer:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            yield mesh
        mesh.barrier()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def isolated(label: str, fn, mesh=None):
    """``fn()``, or None when it raised on any rank: the failure is
    printed as "<label> FAILED: ..." and, under a mesh, the ranks agree on
    it (one all-reduce) after ``fn`` returns, so every rank skips the same
    models and no rank enters the next fit's collectives alone.  That
    holds for a failure before a fit's first collective or after its
    last; a rank that fails inside a fit leaves the others waiting in that
    fit's collective, and the world ends through the backend's timeout or
    torchrun.  A fault of the card or of its kernels (``DEVICE_FAULTS``)
    raises."""
    err = None
    try:
        out = fn()
    except DEVICE_FAULTS:
        raise
    except Exception as e:  # isolation, as in the reference
        out, err = None, e
    if mesh is not None:
        import torch

        (flag,) = mesh.sum(torch.tensor([float(err is not None)], device=mesh.device),
                           axis=None)
        if err is None and float(flag[0]) > 0:
            err = "on another rank"
    if err is not None:
        print(f"{label} FAILED: {err}", flush=True)
        return None
    return out


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device of every fit (default: the CUDA card; "
                             "'cpu' runs the kernels' plain versions on the host)")


def add_data_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--processed_dir", default="data/processed", help="processed CSV directory"
    )
    parser.add_argument(
        "--synthetic",
        type=int,
        default=0,
        metavar="N",
        help="use synthetic data with N ratings instead of data/processed",
    )
    parser.add_argument("--synthetic_users", type=int, default=2000)
    parser.add_argument("--synthetic_items", type=int, default=800)
    parser.add_argument("--seed", type=int, default=0, help="synthetic data seed")


def get_splits(args):
    """Return (train_df, val_df, test_df) as u/i/rating DataFrames."""
    if args.synthetic:
        (tu, ti, tx), (vu, vi, vx), (su, si, sx) = synth_splits(
            args.synthetic_users, args.synthetic_items, args.synthetic, seed=args.seed
        )

        def mk(u, i, x):
            return pd.DataFrame({"u": u, "i": i, "rating": x})

        return mk(tu, ti, tx), mk(vu, vi, vx), mk(su, si, sx)
    return load_all_splits(args.processed_dir)


def center(train_df, *others):
    """Center by the train mean; returns (centered frames..., mean)."""
    mean = float(train_df["rating"].mean())
    out = []
    for df in (train_df, *others):
        c = df.copy()
        c["rating"] = c["rating"] - mean
        out.append(c)
    return (*out, mean)


def shift(df, delta: float):
    c = df.copy()
    c["rating"] = c["rating"] + delta
    return c


class Timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.seconds = time.time() - self.t0


def print_header(title: str) -> None:
    print(f"\n=== {title} ===", flush=True)
