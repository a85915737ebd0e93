"""Driver: run every (arch x shape x mesh) dry-run cell of the port as a
subprocess.

The counterpart of :mod:`repro.launch.dryrun_all`.  Each cell runs in its
own process (``python -m repro_torch.launch.dryrun``: the fake process
group is the process's default group, and isolation bounds a cell's
host memory).  Results land in
``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--jobs 3] [--mesh both]
      [--arch A ...] [--shape S ...] [--force] [--summary]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor, as_completed

from repro_torch.configs import ARCHS, SHAPES


def cell_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")


def run_one(arch: str, shape: str, mesh: str, out_dir: str, timeout: int) -> dict:
    out = cell_path(out_dir, arch, shape, mesh)
    cmd = [
        sys.executable, "-m", "repro_torch.launch.dryrun",
        "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out,
    ]
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", "src")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        if os.path.exists(out):
            with open(out) as f:
                return json.load(f)
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                "error": (proc.stderr or proc.stdout)[-2000:]}
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "timeout"}


def summary(out_dir: str, archs, shapes) -> str:
    """A markdown table of the records in ``out_dir``: a row per (arch,
    shape), for each mesh the predicted peak a rank (GiB; the card holds
    80), TFLOP a rank, and the collectives' bytes by kind (GB: all-gather,
    reduce-scatter, all-reduce counted twice), or why the cell was
    skipped."""
    lines = ["| arch | shape | single: peak GiB, TFLOP, AG / RS / AR GB | multi: peak GiB, "
             "TFLOP, AG / RS / AR GB |", "| --- | --- | --- | --- |"]
    for a in archs:
        for s in shapes:
            cells = []
            for m in ("single", "multi"):
                path = cell_path(out_dir, a, s, m)
                if not os.path.exists(path):
                    cells.append("not run")
                    continue
                with open(path) as f:
                    rec = json.load(f)
                if rec["status"] != "ok":
                    cells.append(rec["status"])
                    continue
                pd, kind = rec["per_device"], rec["collectives"]["per_kind"]
                cells.append(f"{pd['peak_hbm_est'] / 2**30:.2f}, {pd['flops'] / 1e12:.2f}, "
                             + " / ".join(f"{kind[k] / 1e9:.2f}" for k in
                                          ("all-gather", "reduce-scatter", "all-reduce")))
            lines.append(f"| {a} | {s} | {cells[0]} | {cells[1]} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=[s.name for s in SHAPES])
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=7200)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--summary", action="store_true",
                    help="print a markdown table of every record in --out-dir at the end")
    args = ap.parse_args()

    os.makedirs(args.out_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [
        (a, s, m)
        for a in args.arch
        for s in args.shape
        for m in meshes
        if args.force or not os.path.exists(cell_path(args.out_dir, a, s, m))
    ]
    print(f"{len(cells)} cells to run with {args.jobs} workers", flush=True)
    ok = bad = 0
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        futs = {
            pool.submit(run_one, a, s, m, args.out_dir, args.timeout): (a, s, m)
            for a, s, m in cells
        }
        for fut in as_completed(futs):
            a, s, m = futs[fut]
            rec = fut.result()
            status = rec.get("status")
            if status in ("ok", "skipped"):
                ok += 1
            else:
                bad += 1
            extra = ""
            if status == "ok":
                extra = f"trace={rec.get('trace_s')}s"
            elif status == "error":
                extra = rec.get("error", "")[:160].replace("\n", " ")
            print(f"[{ok + bad}/{len(cells)}] {a} {s} {m}: {status} {extra}", flush=True)
    print(f"done: {ok} ok/skipped, {bad} failed")
    if args.summary:
        print(summary(args.out_dir, args.arch, args.shape))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
