"""A copy of the benchmark with two tiny cells, for runs on the CPU.

`make_copy(dest)` copies `benchmark/` and `BENCHMARK.json` into `dest`,
links the program beside them, and adds by files and entries alone (as a
later change would) two configurations cut from the committed ones
(128x160 frames, DenseNet blocks 2/2/2, 4 or 6 templates, a 128-point
scorer), two traffic mixes, and their cells' limits: `tiny_ttt` (a prefix
of 8 targets with finetune events every 4, passes of 8 from its snapshot)
and `tiny_serve` (passes of 8 targets, no finetune). On the CPU the program
runs its plain paths, the same arithmetic as the reference, so every number
the check compares reads 0 on a sound run.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = {"tiny_ttt": "lmo_t10_ttt", "tiny_serve": "lmo_t160_serve"}
# a sound CPU run reads 0 on every number; these leave room for round-off only
SERVE_LIMITS = {"det_p90": 1e-5, "score_gap": 1e-5, "pose_mm": 1e-3, "pose_deg": 1e-3, "schedule_steps": 0,
                "schedule_events": 0}
LIMITS = {"tiny_serve": SERVE_LIMITS,
          "tiny_ttt": dict(SERVE_LIMITS, det_unpaired=0.02, grad_gap=1e-4, update_gap=1e-4, window_loss_gap=1e-5,
                           window_update_gap=1e-4)}


def make_copy(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name in ("ossid_code_torch", "native"):
        os.symlink(REPO / name, dest / name)
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    by_name = {c["name"]: c for c in spec["configs"]}
    for cell, real in CELLS.items():
        w = next(x for x in spec["workloads"] if x["name"] == real)
        c = json.loads((dest / by_name[w["config"]]["file"]).read_text())
        c["name"] = f"{cell}_config"
        c["model"].update(img_h=128, img_w=160, densenet_blocks=[2, 2, 2], heatmap_h=7, heatmap_w=9)
        c["dataset"].update(n_local_test=4 if cell == "tiny_ttt" else 6, shorter_length=128,
                            heatmap_shorter_length=7)
        c["scorer"].update(num_points=128, refine_top=4, depth_crop=64)
        c["ppf"]["max_poses"] = 32
        c["loop"].update(finetune_interval=4, finetune_batch_size=2)
        path = f"benchmark/configs/{c['name']}.json"
        (dest / path).write_text(json.dumps(c))
        spec["configs"].append({"name": c["name"], "source": by_name[w["config"]]["source"], "file": path,
                                "reduced": by_name[w["config"]]["reduced"], "why": "a CPU test"})
        t = json.loads((dest / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        t.update(name=cell, frames=10 if cell == "tiny_ttt" else 4, pass_targets=8, check_targets=2,
                 prefix_targets=8 if cell == "tiny_ttt" else 0, warmup_targets=0 if cell == "tiny_ttt" else 2)
        (dest / "benchmark" / "traffic" / f"{cell}.json").write_text(json.dumps(t))
        (dest / "benchmark" / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS[cell]))
        spec["workloads"].append({"name": cell, "config": c["name"], "traffic": cell, "chips": 1, "why": "a CPU test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


def run_cell(copy: Path, workload: str, seed: int, *extra: str, seconds: float = 1.0, trace: int = 0,
             timeout: float = 900) -> tuple:
    """(exit code, the result's last line as a dict or None, standard error)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu", *extra],
                       cwd=copy, env=env, capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, result, p.stderr
