"""Kaggle submission encoder (port of mde_tpu/tools/create_prediction_csv.py).

    python -m mde_tpu_torch.tools.create_prediction_csv [--predictions-dir DIR]
        [--test-list FILE] [--output predictions.csv]

For each pair of the test list: load ``predictions/<depth>.npy``, flatten,
round to 2 decimals with numpy, join the values formatted "%.2f" with commas,
UTF-8 encode, zlib-compress at level 9, base64; one row an image, its id the
depth file's name without extension (``test_NNNNNN_depth``), under the
columns ``id,Depths`` (reference create_prediction_csv.py:16-55).

The CSV is written with the standard library, byte for byte what the JAX
tool's ``DataFrame.to_csv(index=False)`` writes on Linux: ``\\n`` line ends,
and no quoting (neither an id nor the base64 alphabet holds a comma or a
quote).
"""

from __future__ import annotations

import argparse
import base64
import csv
import os
import zlib

import numpy as np


def compress_depth_values(depth_values) -> str:
    depth_bytes = ",".join(f"{x:.2f}" for x in depth_values).encode("utf-8")
    return base64.b64encode(zlib.compress(depth_bytes, level=9)).decode("utf-8")


def process_depth_maps(predictions_dir: str, test_list_file: str, output_csv: str) -> None:
    with open(test_list_file, "r") as f:
        file_pairs = [line.strip().split() for line in f if line.strip()]

    rows = []
    for _, depth_path in file_pairs:
        file_id = os.path.splitext(os.path.basename(depth_path))[0]
        depth = np.load(os.path.join(predictions_dir, depth_path))
        rows.append((file_id, compress_depth_values(np.round(depth.flatten(), 2))))

    with open(output_csv, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(("id", "Depths"))
        writer.writerows(rows)
    print(f"CSV file saved to: {output_csv}")
    print(f"Shape of the CSV: {(len(rows), 2)}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Encode predictions.csv for Kaggle")
    p.add_argument("--predictions-dir", default="predictions")
    p.add_argument("--test-list", default="data/test_list.txt")
    p.add_argument("--output", default="predictions.csv")
    args = p.parse_args(argv)
    process_depth_maps(args.predictions_dir, args.test_list, args.output)


if __name__ == "__main__":
    main()
