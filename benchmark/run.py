"""The benchmark of `ossid_code_torch` on the card: one cell, one run.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name from `BENCHMARK.json`: its
configuration (the entry's `file`, `configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the limits of its check
(`limits/<workload>.json`) and each metric's reader
(`metrics/<metric>.py`, a `read(run)` that returns a number or None).

A run: checks the card (and exits non-zero without one, or with fewer than
the cell asks for); builds the world from the seed under a temporary
directory; builds the program on it with weights made on the card from the
seed; runs set-up (the traffic's prefix or warm-up through the loop); then
measures whole passes for `--seconds` (with `--trace 1`, one traced pass
instead); frees the program's state; holds the window's outputs against the
plain reference (`check.py`); and prints each number compared beside its
limit as the last lines of standard error, and the result as the last line
of standard output. It exits non-zero, and prints no result, if the process
has loaded JAX or the JAX package.

Options for the benchmark's own tests, never for a measured run:
`--device cpu` (skips the look for a card), `--control bf16` (the port's
bf16 detection, scoring and finetune: the check's control) and `--fault
<name>` (faults.py).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "ossid_code_tpu")
# kernel and extension caches: fixed directories inside the checkout
CACHE = ROOT / ".bench_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(spec: dict, workload: str) -> tuple:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload}; known: {', '.join(cells)}")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return cell, config


def metrics_of(spec: dict, cell: dict, traced: bool) -> list:
    """The cell's metrics: its end-to-end ones, or with a trace its
    per-layer ones (those that list it, or list no cells)."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_info() -> dict:
    """The card's name and power limit, from nvidia-smi where it answers."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out[0] if out else None}


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--control", choices=("bf16",), default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    # the world's and the weights' generators take non-negative seeds
    args.seed %= 2**63
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, config_entry = cell_of(spec, args.workload)
    if importlib.util.find_spec("ossid_code_torch") is None:
        log("the program (ossid_code_torch) is not beside the benchmark: nothing to measure")
        return 4
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"the cell needs {cell['chips']} CUDA device(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    device = torch.device(args.device)

    from benchmark import check, counts, trace
    from benchmark.drive import Session

    with open(ROOT / config_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = HERE / "limits" / f"{cell['name']}.json"
    # keys that start with "_" are notes (what the check does not compare)
    limits = load_json(limits_path) if limits_path.exists() else {}
    not_compared = {k: v for k, v in limits.items() if k.startswith("_")}
    limits = {k: v for k, v in limits.items() if not k.startswith("_")}
    readers = {m["name"]: reader(m["name"]) for m in metrics_of(spec, cell, bool(args.trace))}
    card = card_info() if device.type == "cuda" else {}

    with tempfile.TemporaryDirectory(prefix="ossid_bench_") as root:
        session = Session(config, traffic, args.seed, device, root, control=args.control, fault=args.fault)
        lp = config["loop"]
        # the training check follows the first three steps of the first event
        first_event = -(-int(lp.get("finetune_interval", 0)) // int(lp.get("finetune_batch_size", 1)))
        capture = session.prepare(capture_steps=min(3, first_event) if lp["finetune"] else 0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.2f} s: {json.dumps(session.setup_stages)}")

        calls, traced = None, None
        if args.trace:
            calls = trace.KernelCalls()
            if device.type == "cuda":
                calls.install()
            traced = trace.Profiled(device)
        passes = session.measure(args.seconds, traced)
        if calls is not None:
            calls.remove()
        peak = int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else 0
        t_read = time.perf_counter()
        tr = trace.read(traced.prof, session.hooks.log.spans) if traced is not None else None
        hooks = session.hooks
        records = hooks.records
        run = types.SimpleNamespace(
            config=config, traffic=traffic, setup_s=setup_s, passes=passes, records=records,
            rows=[r["row"] for r in records], stats=session.stats, spec_hit_rate=session.spec_hit_rate,
            detects=hooks.detects, score_hypos=list(hooks.score_hypos), steps=hooks.steps, trace=tr,
            kernel_calls=calls, counts=counts, card=card)
        metrics = {}
        for name, read in readers.items():
            value = read(run)
            if value is not None:
                unit = next(m["unit"] for m in spec["end_to_end"] + spec["per_layer"] if m["name"] == name)
                metrics[name] = {"value": float(value), "unit": unit}
        if tr is not None:
            log(f"trace read in {time.perf_counter() - t_read:.2f} s: "
                f"{json.dumps({k: v for k, v in tr.items() if k != 'breakdown'})}")

        snapshot = getattr(session, "snapshot", None)
        init = {"dtoid": session.dtoid_init, "zephyr": session.zephyr_init}
        world = session.world
        session.release()
        t_check = time.perf_counter()
        numbers, info = check.judge(config, traffic, world, device, args.seed, records, passes, init, capture,
                                    snapshot)
        log(f"check in {time.perf_counter() - t_check:.2f} s: {json.dumps(info)}")

    # every limit names a number the run has to yield: one that is missing fails
    compared = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    unlimited = {k: v for k, v in numbers.items() if k not in limits}
    correct = bool(compared) and info["eligible_targets"] > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    attempted = sum(len(session.pass_targets()) for _ in passes)
    completed = sum(p["targets"] for p in passes)
    result = {"correct": correct, "attempted": attempted, "failed": attempted - completed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                         "count": int(cell["chips"]) if device.type == "cuda" else 0,
                         "memory_peak_bytes": peak}}
    if tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    result["card"] = card.get("nvidia_smi")
    result["passes"] = [round(p["seconds"], 4) for p in passes]
    result["checked"] = compared

    found = banned_modules()
    if found:
        log(f"the process has loaded {', '.join(found)}: the benchmark runs the port alone")
        return 5
    for k, v in not_compared.items():
        log(f"not compared, {k[1:]}: {v}")
    if unlimited:
        log(f"numbers with no limit (not compared): {json.dumps(unlimited)}")
    for k, c in compared.items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}{'' if ok else '  FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
