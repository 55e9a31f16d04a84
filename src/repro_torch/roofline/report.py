"""Assemble the roofline tables of a dry run from artifacts/dryrun/*.json
(a copy of the JAX package's reporter: JSON cells in, markdown out).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir artifacts/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load_cells(d: str) -> List[Dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x * 1e6:.1f}µs"
    if x < 0.1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.3f}s"


def dryrun_table(cells: List[Dict], mesh: str) -> str:
    rows = ["| arch | shape | ok | compile | device HBM bytes (prod) | collectives (prod module) |",
            "|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("mesh") != mesh or c.get("variant", "baseline") != "baseline":
            continue
        if c.get("skipped"):
            rows.append(f"| {c['arch']} | {c['shape']} | SKIP ({c['reason'][:40]}…) | | | |")
            continue
        ok = "✓" if c.get("ok") else "✗ " + c.get("error", "")[:40]
        ma = c.get("production", {}).get("memory_analysis", {})
        mem = ma.get("argument_size_in_bytes", 0) + ma.get("temp_size_in_bytes", 0)
        counts = c.get("production", {}).get("collective_counts", {})
        cc = ", ".join(f"{k}×{v}" for k, v in sorted(counts.items()))
        rows.append(
            f"| {c['arch']} | {c['shape']} | {ok} | "
            f"{c.get('production', {}).get('compile_s', '?')}s | "
            f"{mem / 1e9:.2f} GB | {cc} |")
    return "\n".join(rows)


def roofline_table(cells: List[Dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | compute | memory | collective | bound | 6ND/HLO | roofline-MFU |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("mesh") != mesh or c.get("variant", "baseline") != "baseline":
            continue
        if c.get("skipped") or not c.get("ok"):
            continue
        t = c.get("roofline", {})
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['bound']}** | {t.get('useful_compute_ratio', 0):.2f} | "
            f"{t.get('roofline_mfu', 0):.3f} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    n_ok = sum(1 for c in cells if c.get("ok") and not c.get("skipped"))
    n_skip = sum(1 for c in cells if c.get("skipped"))
    n_fail = sum(1 for c in cells if not c.get("ok"))
    print(f"cells: {len(cells)} total, {n_ok} ok, {n_skip} skipped, "
          f"{n_fail} FAILED\n")
    print("## Dry-run matrix\n")
    print(dryrun_table(cells, args.mesh))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(cells, "single"))


if __name__ == "__main__":
    main()
