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
"""

from __future__ import annotations

import argparse
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
