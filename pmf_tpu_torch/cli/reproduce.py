"""One-command reproduction of the experiment surface, from raw CSVs to
the reference's artifact set:

    # drop the Kaggle CSVs (interactions_{train,validation,test}.csv)
    # into data/raw, or pass --download to fetch them, then
    python -m pmf_tpu_torch.cli.reproduce --workdir runs/repro [--device cuda|cpu]

``--synthetic_clone N`` first writes a Food.com-shaped synthetic raw
dataset (``data.synthetic.synth_foodcom_raw``) into the raw dir and runs
the same chain.  ``--device`` (default: the CUDA card; it raises
without one) is resolved once and passed to every stage that fits.

Stages (each skippable via --stages):

  preprocess   raw CSVs -> processed splits (``data.pipeline``)
  tune         random tuner -> best_hyperparams.txt (``cli.tune``)
  compare      4-model comparison -> model_comparison_plots.png +
               model_comparison_params.txt (``cli.compare``)
  train_full   full training + export -> embeddings CSVs, config.txt,
               test_predictions.csv (``cli.train_full``)
  analysis     forecast diagnostics -> reports/forecast_metrics.csv +
               forecast_analysis.md (``analysis.forecasts``), plus the
               exploratory report (``analysis.exploratory``)
"""

from __future__ import annotations

import argparse
import json
import os

from pmf_tpu_torch.cli.common import add_device_arg, print_header, setup_runtime

STAGES = ("preprocess", "tune", "compare", "train_full", "analysis")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Raw CSVs -> full reference artifact reproduction")
    ap.add_argument("--workdir", default="runs/repro",
                    help="output root for every artifact")
    ap.add_argument("--raw_dir", default=None,
                    help="raw Kaggle CSV dir (default WORKDIR/data/raw)")
    ap.add_argument("--processed_dir", default=None,
                    help="processed split dir (default WORKDIR/data/processed)")
    ap.add_argument("--download", action="store_true",
                    help="fetch + unzip the Kaggle dataset into raw_dir first")
    ap.add_argument("--synthetic_clone", type=int, default=0, metavar="N_RAW",
                    help="write a Food.com-shaped synthetic raw dataset of "
                         "N_RAW interactions into raw_dir before preprocessing "
                         "(0 = expect real CSVs)")
    ap.add_argument("--clone_users", type=int, default=2000)
    ap.add_argument("--clone_items", type=int, default=900)
    ap.add_argument("--stages", nargs="+", default=list(STAGES),
                    choices=STAGES)
    ap.add_argument("--n_trials", type=int, default=5,
                    help="tuner trials per model (reference default 5)")
    ap.add_argument("--seed", type=int, default=7)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = setup_runtime(args.device)

    wd = args.workdir
    raw_dir = args.raw_dir or os.path.join(wd, "data", "raw")
    processed_dir = args.processed_dir or os.path.join(wd, "data", "processed")
    reports_dir = os.path.join(wd, "reports")
    data_root = os.path.dirname(processed_dir) or "."
    os.makedirs(wd, exist_ok=True)
    os.makedirs(reports_dir, exist_ok=True)
    results = {"workdir": wd, "device": str(device), "stages": {}}

    if args.download:
        from pmf_tpu_torch.data.pipeline import download_dataset, unzip_files

        print_header("download")
        download_dataset(raw_dir)
        unzip_files(raw_dir)
    if args.synthetic_clone:
        from pmf_tpu_torch.data.synthetic import synth_foodcom_raw

        print_header(f"synthetic clone ({args.synthetic_clone} raw rows)")
        stats = synth_foodcom_raw(
            raw_dir, n_users=args.clone_users, n_items=args.clone_items,
            n_raw=args.synthetic_clone, seed=args.seed)
        results["stages"]["synthetic_clone"] = stats
        print(stats, flush=True)

    data_args = ["--processed_dir", processed_dir]
    fit_args = [*data_args, "--device", str(device)]
    hyper_path = os.path.join(wd, "best_hyperparams.txt")

    if "preprocess" in args.stages:
        from pmf_tpu_torch.data.pipeline import preprocess_data

        print_header("preprocess")
        preprocess_data(raw_dir, processed_dir)
        results["stages"]["preprocess"] = {
            "processed_dir": processed_dir,
            "files": sorted(os.listdir(processed_dir)),
        }

    if "tune" in args.stages:
        from pmf_tpu_torch.cli.tune import main as tune_main

        print_header("tune")
        tune_main([*fit_args, "--n_trials", str(args.n_trials), "--out", hyper_path])
        results["stages"]["tune"] = {"best_hyperparams": hyper_path}

    if "compare" in args.stages:
        from pmf_tpu_torch.cli.compare import main as compare_main

        print_header("compare")
        cmp = compare_main([
            *fit_args,
            "--hyperparams", hyper_path,
            "--plot", os.path.join(wd, "model_comparison_plots.png"),
            "--params_out", os.path.join(wd, "model_comparison_params.txt")])
        results["stages"]["compare"] = (
            cmp.to_dict(orient="records") if cmp is not None else None)

    if "train_full" in args.stages:
        from pmf_tpu_torch.cli.train_full import main as train_main

        print_header("train_full")
        train_main([*fit_args, "--model", "all",
                    "--hyperparams", hyper_path,
                    "--data_dir", data_root,
                    "--map_data_dir", data_root])
        results["stages"]["train_full"] = {
            "embeddings": sorted(os.listdir(os.path.join(data_root, "embeddings"))),
        }

    if "analysis" in args.stages:
        from pmf_tpu_torch.analysis.exploratory import main as explore_main
        from pmf_tpu_torch.analysis.forecasts import main as forecasts_main

        print_header("analysis")
        forecasts_main(["--data_dir", data_root, "--report_dir", reports_dir])
        explore_main([*data_args, "--out_dir",
                      os.path.join(reports_dir, "figures", "exploratory")])
        results["stages"]["analysis"] = {"reports": sorted(os.listdir(reports_dir))}

    out = os.path.join(wd, "reproduce_manifest.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print_header(f"done -> {out}")
    return results


if __name__ == "__main__":
    main()
