"""Config persistence: the ``best_hyperparams.txt`` round trip.

The artifact holds ``ModelName: {repr of asdict(config)}`` lines under a
two-line header, and readers keep only the keys the target config
dataclass has (configs drift).  The format and the model-name keys equal
the JAX package's, so a file written by either package reads in the
other.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict

HEADER = "BEST CONFIGURATIONS\n===================\n"

# Model-name keys of the artifact.
GAUSSIAN_KEY = "GaussianMF"
POISSON_KEY = "PoissonMF"
HPF_CAVI_KEY = "HPF_CAVI"
HPF_MAP_KEY = "HPF_PyTorch"  # kept for artifact compatibility


def write_best_hyperparams(configs: Dict[str, Any], path: str = "best_hyperparams.txt") -> None:
    """Write tuned configs (dataclasses or dicts; None entries skipped)."""
    with open(path, "w") as f:
        f.write(HEADER)
        for name, cfg in configs.items():
            if cfg is None:
                continue
            d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
            f.write(f"{name}: {d!r}\n")


def load_best_hyperparams(path: str = "best_hyperparams.txt") -> Dict[str, dict]:
    """Parse a ``best_hyperparams.txt`` into {model_name: config_dict};
    a missing file gives {} and unparsable lines are skipped."""
    out: Dict[str, dict] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if ":" not in line or line.startswith(("BEST", "===")):
                continue
            name, _, payload = line.partition(":")
            payload = payload.strip()
            if not payload.startswith("{"):
                continue
            try:
                out[name.strip()] = ast.literal_eval(payload)
            except (ValueError, SyntaxError):
                continue
    return out


def filter_config_kwargs(config_cls, raw: dict) -> dict:
    """Drop keys the target config dataclass does not have."""
    fields = {f.name for f in dataclasses.fields(config_cls)}
    return {k: v for k, v in raw.items() if k in fields}
