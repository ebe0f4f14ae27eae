"""BOP19 results CSV writer and reader (the port's copy of
ossid_code_tpu/eval/bop_csv.py): the reference's format, so bop_toolkit's
unchanged `eval_bop19.py` reads it; the same rows give the same bytes as the
JAX package's writer. The toolkit's evaluation runs only where the toolkit
is installed (`BOP_TOOLKIT_PATH`, read when called); the port waits for it
to finish."""

from __future__ import annotations

import csv
import os
import subprocess
import sys

import numpy as np

from ossid_code_torch.core.config import roots


def save_results_bop(results, output_folder, result_name, dataset_name, split_name="test",
                     pose_key="pose", score_key="score", time_key="time", run_eval_script=False):
    """results: dicts with scene_id / im_id / obj_id and a 4x4 pose in meters
    (millimeters in the CSV). Returns the CSV's path."""
    os.makedirs(output_folder, exist_ok=True)
    result_name = result_name.replace("_", "-")
    output_filename = f"{result_name}_{dataset_name}-{split_name}.csv"
    output_path = os.path.join(output_folder, output_filename)

    with open(output_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["scene_id", "im_id", "obj_id", "score", "R", "t", "time"])
        writer.writeheader()
        for r in results:
            mat = np.asarray(r[pose_key], np.float64).copy()
            mat[:3, 3] = mat[:3, 3] * 1000.0
            writer.writerow({
                "scene_id": r["scene_id"],
                "im_id": r["im_id"],
                "obj_id": r["obj_id"],
                "score": r.get(score_key, 1),
                "R": " ".join(str(x) for x in mat[:3, :3].flatten()),
                "t": " ".join(str(x) for x in mat[:3, 3].flatten()),
                "time": r.get(time_key, -1),
            })

    if run_eval_script:
        toolkit = roots().BOP_TOOLKIT_PATH
        if os.path.exists(os.path.join(toolkit, "scripts", "eval_bop19.py")):
            subprocess.run([sys.executable, "scripts/eval_bop19.py", "--renderer_type=cpp",
                            f"--result_filenames={output_filename}"], cwd=toolkit, check=True)
        else:
            print(f"bop_toolkit not found at {toolkit}; skipping external eval")
    return output_path


def read_results_bop(path):
    """The CSV's rows back: ids, score, time and the pose (meters)."""
    results = []
    with open(path) as f:
        for row in csv.DictReader(f):
            pose = np.eye(4)
            pose[:3, :3] = np.asarray([float(x) for x in row["R"].split()]).reshape(3, 3)
            pose[:3, 3] = np.asarray([float(x) for x in row["t"].split()])
            results.append({
                "obj_id": int(row["obj_id"]),
                "scene_id": int(row["scene_id"]),
                "im_id": int(row["im_id"]),
                "score": float(row["score"]),
                "time": float(row["time"]),
                "pose": pose,
            })
    return results
