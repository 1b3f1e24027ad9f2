#!/usr/bin/env python3
"""The benchmark's cells for two checkouts of the port, in turns, on one
CUDA card: parent against change in one run of the machine.

    python3 scripts/torch_bench_turns.py --parent DIR [--change DIR]
        [--workloads A,B] [--runs 5] [--trace-first] [--out DIR]

Each run of a cell is one process of that checkout's ``benchmark/run.py
--workload NAME`` (its own entry points, checks and kernels, built in its own
tree). Per cell the two checkouts alternate parent, change, change,
parent, ... over ``--runs`` rounds, so that drift on the card spreads over
both. ``--trace-first`` traces each checkout's first run of a cell (the rest
run with ``--no-trace``). Prints, per cell and metric, each side's runs,
median and range and the change's median over the parent's, then every
run's ``correct`` and last one JSON line ``{"ok", "workloads": {NAME:
{metric: {"parent", "change"}}}, "device"}``; ``ok`` is false if a run
failed or read ``correct`` false.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CELL_TIMEOUT_S = 1800


def run_cell(root: Path, name: str, trace: bool, out_dir: Path | None,
             tag: str) -> dict | None:
    cmd = [sys.executable, str(root / "benchmark" / "run.py"), "--workload",
           name]
    if not trace:
        cmd.append("--no-trace")
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=CELL_TIMEOUT_S, cwd=str(root))
    if out_dir is not None:
        (out_dir / f"{name}.{tag}.log").write_text(
            proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    try:
        last = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        last = None
    if proc.returncode != 0 or last is None:
        sys.stderr.write(proc.stderr[-3000:])
        return None
    return last


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="the parent's checkout")
    p.add_argument("--change", default=str(REPO),
                   help="the change's checkout (default: this repository)")
    p.add_argument("--workloads", default=None,
                   help="comma-separated cells (default: every cell)")
    p.add_argument("--runs", type=int, default=5,
                   help="rounds of each cell, one run of each side a round")
    p.add_argument("--trace-first", action="store_true",
                   help="trace each side's first run of a cell")
    p.add_argument("--out", default=None, help="directory for every log")
    args = p.parse_args(argv)
    roots = {"parent": Path(args.parent).resolve(),
             "change": Path(args.change).resolve()}
    bm = json.loads((roots["change"] / "BENCHMARK.json").read_text())
    names = (args.workloads.split(",") if args.workloads
             else [w["name"] for w in bm["workloads"]])
    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    results = {n: {"parent": [], "change": []} for n in names}
    failed, device = [], None
    for name in names:
        for r in range(args.runs):
            order = ("parent", "change") if r % 2 == 0 else ("change",
                                                             "parent")
            for side in order:
                last = run_cell(roots[side], name,
                                args.trace_first and r == 0, out_dir,
                                f"{side}.run{r}")
                if last is None:
                    failed.append(f"{name} {side} run {r}: failed")
                    continue
                device = last["device"]
                print(json.dumps({"side": side, "run": r, **last}),
                      flush=True)
                results[name][side].append(last)
                if not last["correct"]:
                    failed.append(f"{name} {side} run {r}: correct false")
    summary = {}
    for name in names:
        summary[name] = {}
        metrics = {m for side in results[name].values() for r in side
                   for m, v in r["metrics"].items() if v is not None}
        for m in sorted(metrics):
            med = {}
            for side, runs in results[name].items():
                vals = [r["metrics"][m] for r in runs
                        if r["metrics"].get(m) is not None]
                if vals:
                    med[side] = statistics.median(vals)
                    print(f"[{name}] {m} {side}: {vals}, median "
                          f"{med[side]:.6g}, range {min(vals):.6g}-"
                          f"{max(vals):.6g}", flush=True)
            if len(med) == 2 and med["parent"]:
                print(f"[{name}] {m} change / parent: "
                      f"{med['change'] / med['parent']:.4f}", flush=True)
            summary[name][m] = med
    for f in failed:
        print(f"FAILED {f}")
    print(json.dumps({"ok": not failed, "workloads": summary,
                      "card": smi, "device": device}), flush=True)
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
