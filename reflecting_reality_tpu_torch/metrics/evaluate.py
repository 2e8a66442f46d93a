"""Offline evaluation, the port's counterpart of
`reflecting_reality_tpu/metrics/evaluate.py` (reference:
metrics/evaluate_metrics.py).

The same flags, CSV schema and three modes, plus `--device` (default the
card; `cpu` scores on the CPU):
- calc: the requested metrics for each of the N seeds of every test image,
  NaN-resume aware (only missing cells are computed), per-shard CSVs merged
  with combine_first at the end (:158-230, :292-381).
- best: metrics only on the best seed by --select_metric (:246-289).
- avg:  eval_best.csv and eval_avg.csv from the calc CSVs (:277-289,
  :446-460); it reads no ground truth.

`--shard_id/--num_shards` split the images as `split_between_processes`
does; each shard is a process the user starts.  `h5py` is imported only
where a ground-truth file is read, so `avg` runs without it.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List

import numpy as np
import pandas as pd

from reflecting_reality_tpu_torch.core.device import resolve_device
from reflecting_reality_tpu_torch.data.synmirror import MIRROR_PROMPT, extract_data_from_hdf5
from reflecting_reality_tpu_torch.metrics.calculator import MetricsCalculator
from reflecting_reality_tpu_torch.parallel.mesh import split_between_processes

logger = logging.getLogger(__name__)

# Metric families (reference evaluate_metrics.py:20-43)
full_metrics = ["PSNR", "LPIPS", "SSIM"]
object_metrics = ["obj_PSNR", "obj_LPIPS", "obj_SSIM"]
mirror_metrics = ["mirror_PSNR", "mirror_LPIPS", "mirror_SSIM"]
mask_metrics = ["mask_PSNR", "mask_LPIPS", "mask_SSIM"]
text_align_metrics = ["CLIP_Similarity"]
img_quality_metrics = ["Image_Reward", "HPS_V2.1", "Aesthetic_Score"]
selection_metrics = ["mask_SSIM", "mask_PSNR", "mask_LPIPS"]
reflection_metrics = ["IoU"]
all_metrics = (
    full_metrics + object_metrics + mirror_metrics + mask_metrics
    + reflection_metrics + text_align_metrics + img_quality_metrics
)
columns = ["uid"] + all_metrics

# max/min direction per metric (reference :44-62)
metric_lambda_dict = {m: (min if "LPIPS" in m else max) for m in all_metrics}


def transform_uid(df: pd.DataFrame) -> pd.DataFrame:
    path = df["path"].str.split("/").str[-1]
    df["uid"] = df["uid"] + "_" + path.str.split(".").str[0]
    return df


def get_metrics_to_compute(metrics: List[str]) -> List[str]:
    out: List[str] = []
    groups = {
        "full": full_metrics, "object": object_metrics, "mirror": mirror_metrics,
        "mask": mask_metrics, "text_align": text_align_metrics,
        "img_quality": img_quality_metrics,
    }
    for m in metrics:
        if m == "all":
            return list(all_metrics)
        if m in groups:
            out += groups[m]
        elif m in all_metrics:
            out.append(m)
    return out


def get_uids_and_eval_df(args):
    uids = [u.split(".")[0] for u in os.listdir(args.infer_dir) if u.endswith(".png")]
    eval_dfs = []
    for i in range(args.num_images_per_validation):
        eval_csv = os.path.join(args.infer_dir, f"{args.output_csv}_{i}.csv")
        if not args.overwrite and os.path.exists(eval_csv):
            df = pd.read_csv(eval_csv)
            for col in columns:
                if col not in df.columns:
                    df[col] = float("nan")
        else:
            df = pd.DataFrame({c: [float("nan")] * len(uids) for c in columns})
            df["uid"] = uids
        eval_dfs.append(df)
    return uids, eval_dfs


def split_generated_image(n: int, gen_image):
    """2xN/2 grid sheet -> list of sub images (reference :130-155)."""
    w, h = gen_image.size
    return [
        gen_image.crop(((i % 2) * w // 2, (i // 2) * h // 2,
                        (i % 2) * w // 2 + w // 2, (i // 2) * h // 2 + h // 2))
        for i in range(n)
    ]


def save_dfs(args, eval_dfs, shard_id):
    for i, df in enumerate(eval_dfs):
        df.to_csv(os.path.join(args.infer_dir, f"{args.output_csv}_{i}_{shard_id}.csv"),
                  index=False)


def merge_csv_files(args, delete_intermediate=False):
    for i in range(args.num_images_per_validation):
        final_csv = os.path.join(args.infer_dir, f"{args.output_csv}_{i}.csv")
        dfs = []
        for f in sorted(os.listdir(args.infer_dir)):
            if f.startswith(f"{args.output_csv}_{i}_") and f.endswith(".csv"):
                dfs.append(pd.read_csv(os.path.join(args.infer_dir, f)))
                if delete_intermediate:
                    os.remove(os.path.join(args.infer_dir, f))
        if dfs:
            final = dfs[0]
            for df in dfs[1:]:
                final = final.combine_first(df)
            final.to_csv(final_csv, index=False)


def get_best_df_index(dfs, row_idx, select_metric):
    direction = metric_lambda_dict[select_metric]
    vals = [
        df.at[row_idx, select_metric]
        if not pd.isna(df.at[row_idx, select_metric])
        else (float("-inf") if direction == max else float("inf"))
        for df in dfs
    ]
    return int(np.argmax(vals) if direction == max else np.argmin(vals))


def check_select_metric_exists(args, eval_dfs):
    for i, df in enumerate(eval_dfs):
        if args.select_metric not in df.columns:
            raise ValueError(f"{args.select_metric} not in {args.output_csv}_{i}.csv")
        if df[args.select_metric].isnull().values.any():
            nan_uids = df[df[args.select_metric].isnull()]["uid"].values
            raise ValueError(
                f"{args.select_metric} has NaN values in {args.output_csv}_{i}.csv: {nan_uids}"
            )


def calculate_best_metrics_df(args) -> pd.DataFrame:
    files = [os.path.join(args.infer_dir, f"{args.output_csv}_{i}.csv")
             for i in range(args.num_images_per_validation)]
    if not all(os.path.exists(f) for f in files):
        raise ValueError(f"Missing eval csv files in {args.infer_dir}")
    eval_dfs = [pd.read_csv(f) for f in files]
    check_select_metric_exists(args, eval_dfs)

    cols = eval_dfs[0].columns.to_list() + ["select_img_index"]
    metric_cols = [c for c in cols if c in all_metrics]
    best = pd.DataFrame(columns=cols)
    for i, uid in enumerate(eval_dfs[0]["uid"].values):
        j = get_best_df_index(eval_dfs, i, args.select_metric)
        best.at[i, "select_img_index"] = int(j)
        best.at[i, "uid"] = uid
        for m in metric_cols:
            best.at[i, m] = eval_dfs[j].at[i, m]
    best.to_csv(os.path.join(args.infer_dir, f"{args.output_csv}_best.csv"), index=False)
    return best


def calculate_avg_df(args, best_df: pd.DataFrame | None = None):
    if best_df is None:
        best_df = pd.read_csv(os.path.join(args.infer_dir, f"{args.output_csv}_best.csv"))
    best_df = best_df.reindex(columns=all_metrics, fill_value=0)
    avg = best_df.astype(float).mean()
    out = pd.DataFrame({"Metric": avg.index, "Dataset Average": avg.values})
    print(out.to_string(index=False))
    out.to_csv(os.path.join(args.infer_dir, f"{args.output_csv}_avg.csv"), index=False)
    return out


def run(args, calculator: MetricsCalculator | None = None):
    from PIL import Image

    test_df = transform_uid(pd.read_csv(os.path.join(args.train_data_dir, args.csv)))
    metrics_to_compute = get_metrics_to_compute(args.metrics)
    uids, eval_dfs = get_uids_and_eval_df(args)
    logger.info("metrics to compute: %s", metrics_to_compute)

    if args.mode == "best":
        check_select_metric_exists(args, eval_dfs)

    calc = calculator or MetricsCalculator(
        metrics_to_compute, data_dir=args.train_data_dir, cache_dir=args.cache_dir,
        lpips_weights=getattr(args, "lpips_weights", None),
        device=getattr(args, "device", None),
    )

    shard_id = args.shard_id
    for uid in split_between_processes(uids, args.shard_id, args.num_shards):
        gen_image_path = os.path.join(args.infer_dir, f"{uid}.png")
        try:
            import h5py

            row = test_df[test_df["uid"] == uid].iloc[0]
            caption = args.mirror_prompt + str(row[args.captions_column])
            with h5py.File(os.path.join(args.train_data_dir, str(row["path"])), "r") as f:
                gt_data = extract_data_from_hdf5(f)
            gt_data["file_path"] = str(row["path"])
            gen_images = split_generated_image(
                args.num_images_per_validation, Image.open(gen_image_path)
            )

            for metric_name in metrics_to_compute:
                if args.mode == "best":
                    row_index = eval_dfs[0][eval_dfs[0]["uid"] == uid].index[0]
                    j = get_best_df_index(eval_dfs, row_index, args.select_metric)
                    if pd.isna(eval_dfs[j].at[row_index, metric_name]):
                        eval_dfs[j].at[row_index, metric_name] = calc.compute_metric(
                            metric_name, gen_images[j], gt_data, caption
                        )
                    continue
                for i, gen in enumerate(gen_images):
                    row_index = eval_dfs[i][eval_dfs[i]["uid"] == uid].index[0]
                    if pd.isna(eval_dfs[i].at[row_index, metric_name]):
                        eval_dfs[i].at[row_index, metric_name] = calc.compute_metric(
                            metric_name, gen, gt_data, caption
                        )
        except FileNotFoundError:
            logger.error("Inference image %s not found; skipping.", gen_image_path)
        except Exception:  # per-sample resilience, reference :365-369
            logger.exception("Error processing %s", gen_image_path)

    save_dfs(args, eval_dfs, shard_id)
    if args.num_shards == 1 or args.shard_id == 0:
        merge_csv_files(args, delete_intermediate=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SynMirror metric evaluation (PyTorch port)")
    p.add_argument("--train_data_dir", type=str, default="data/blenderproc")
    p.add_argument("--csv", type=str, default="test.csv")
    p.add_argument("--captions_column", type=str, default="auto_caption",
                   choices=["caption", "auto_caption"])
    p.add_argument("--mirror_prompt", type=str, default=MIRROR_PROMPT)
    p.add_argument("--cache_dir", type=str, default="sam_cache")
    p.add_argument("--infer_dir", type=str,
                   default="runs/logs/sd15_full/checkpoint-20000/inference")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--num_images_per_validation", type=int, default=4)
    p.add_argument("--metrics", type=str, nargs="+", default=["mask"],
                   choices=["all", "full", "object", "mirror", "mask",
                            "text_align", "img_quality"] + all_metrics)
    p.add_argument("--mode", type=str, default="calc", choices=["calc", "best", "avg"])
    p.add_argument("--select_metric", type=str, default="mask_SSIM")
    p.add_argument("--output_csv", type=str, default="eval")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="LPIPS-squeeze weights: the .npz of the JAX package's "
                        "tools/convert_lpips.py, or a torch checkpoint (.pt/.pth)")
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)     # the card unless asked otherwise, in every mode
    if args.mode == "best" and args.select_metric not in selection_metrics:
        raise ValueError(f"select_metric {args.select_metric} not in {selection_metrics}")
    if args.mode == "avg":
        best = calculate_best_metrics_df(args)
        calculate_avg_df(args, best)
    else:
        run(args)


if __name__ == "__main__":
    main()
