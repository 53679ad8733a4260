"""Checkpoint and resume.

A checkpoint is a directory holding ``state.npz`` (one array per state
key) and ``meta.json`` (the config, dimensions, iteration).  That is the
JAX package's own npz form, with its key names and dtypes, so either
package loads the other's checkpoint.  The JAX package writes orbax
(``state.orbax``) where orbax is installed; the port cannot read that
form and says so.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from pmf_tpu_torch.utils.device import resolve_device


def _to_host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_state(path: str, state: dict, meta: dict | None = None) -> None:
    """Save a dict of tensors or arrays (+ JSON ``meta``) into directory
    ``path``.  A ``state.orbax`` left there is removed first: the JAX
    package's loader prefers it and would read the stale state."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    host_state = {k: _to_host(v) for k, v in state.items()}
    shutil.rmtree(os.path.join(path, "state.orbax"), ignore_errors=True)
    np.savez(os.path.join(path, "state.npz"), **host_state)
    if meta is not None:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, default=str)


def load_state(path: str) -> tuple[dict, dict]:
    """(state as numpy arrays, meta) saved by :func:`save_state` or by the
    JAX package in its npz form."""
    path = os.path.abspath(path)
    npz_path = os.path.join(path, "state.npz")
    orbax_path = os.path.join(path, "state.orbax")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            state = {k: z[k] for k in z.files}
    elif os.path.exists(orbax_path):
        raise ValueError(
            f"{orbax_path} is an orbax checkpoint, which this package cannot "
            "read (orbax needs JAX); save the model from the JAX package "
            "without orbax installed to get its state.npz form")
    else:
        raise FileNotFoundError(f"No checkpoint under {path}")
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def save_model(model, path: str) -> None:
    """Checkpoint a fitted model (state + config + dimensions)."""
    meta = {
        "model_class": type(model).__name__,
        "config": dataclasses.asdict(model.config),
        "n_users": model.n_users,
        "n_items": model.n_items,
        "global_mean": getattr(model, "global_mean", None),
    }
    save_state(path, model.state, meta)


def load_model(path: str, device=None):
    """Rebuild a fitted model of this package from a checkpoint, its state
    on ``device`` (None = the card; raises without one)."""
    import pmf_tpu_torch
    from pmf_tpu_torch.config import filter_config_kwargs

    device = resolve_device(device)
    state, meta = load_state(path)
    name = meta.get("model_class")
    if name not in pmf_tpu_torch.__all__ or name.endswith("Config"):
        raise ValueError(f"checkpoint at {path} holds an unknown model class {name!r}")
    cls = getattr(pmf_tpu_torch, name)
    config_cls = getattr(pmf_tpu_torch, name + "Config")
    model = cls(config_cls(**filter_config_kwargs(config_cls, meta["config"])))
    model.n_users = meta["n_users"]
    model.n_items = meta["n_items"]
    if meta.get("global_mean") is not None:
        model.global_mean = float(meta["global_mean"])
    model.device = device
    model.state = {k: torch.from_numpy(v).to(device) for k, v in state.items()}
    return model
