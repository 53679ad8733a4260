"""Batch recommendation CLI: the serving surface.

    python -m pmf_tpu_torch.cli.recommend --checkpoint CKPT_DIR [--users 0 1 2]
        [--k 10] [--train interactions_train.csv] [--batch 1024]
        [--out recommendations.csv] [--device cuda|cpu] [--mesh_devices N]

Loads a fitted model checkpoint (``utils.checkpoint.save_model``, of this
package or the JAX package's npz form) onto ``--device`` (default: the
CUDA card; raises without one), scores every item for the requested
users there (dense matmuls + top-k), excludes each user's own training
items when a u,i,rating CSV is given, and writes one (u, rank, i, score)
row per recommendation.  With ``--mesh_devices N`` (under ``torchrun
--nproc_per_node N``) the queried users are cut over the ranks
(``eval.recommend.recommend_sharded``), every rank gets every row, and
rank 0 alone writes the CSV.
"""

from __future__ import annotations

import argparse

import numpy as np
import pandas as pd

from pmf_tpu_torch.cli.common import add_mesh_arg, mesh_session


def main(argv=None):
    parser = argparse.ArgumentParser(description="Top-k recommendations")
    parser.add_argument("--checkpoint", required=True,
                        help="directory written by checkpoint.save_model")
    parser.add_argument("--users", type=int, nargs="*", default=None,
                        help="user ids (default: all users)")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--train", default=None,
                        help="training interactions CSV (u,i,rating) whose "
                             "items are excluded per user")
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--out", default="recommendations.csv")
    parser.add_argument("--device", default=None,
                        help="torch device of the scoring (default: the CUDA card)")
    add_mesh_arg(parser)
    args = parser.parse_args(argv)
    with mesh_session(args.mesh_devices, args.device, "recommend") as mesh:
        return _run(args, mesh)


def _run(args, mesh):
    from pmf_tpu_torch.utils.checkpoint import load_model

    model = load_model(args.checkpoint, device=mesh.device if mesh else args.device)
    users = (np.asarray(args.users, dtype=np.int64) if args.users
             else np.arange(model.n_users, dtype=np.int64))
    train = None
    if args.train:
        from pmf_tpu_torch.data.native import parse_interactions_csv

        train = parse_interactions_csv(args.train)
    items, scores = model.recommend(users, k=args.k, train=train, batch=args.batch,
                                    mesh=mesh)
    rows = pd.DataFrame({
        "u": np.repeat(users, args.k),
        "rank": np.tile(np.arange(1, args.k + 1), len(users)),
        "i": items.reshape(-1),
        "score": scores.reshape(-1),
    })
    if mesh is None or mesh.is_writer:
        rows.to_csv(args.out, index=False)
    print(f"Wrote {len(rows)} recommendations for {len(users)} users -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
