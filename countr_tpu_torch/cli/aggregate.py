"""Multi-run result aggregation and comparison plotting (counterpart of
``countr_tpu/cli/aggregate.py``; reference: util/misc.py:565-620
``log_test_results`` / ``plot_test_results``): scan a suite directory for
run subdirectories holding a JSON-lines ``log.txt``, average each run's
numeric fields, write a ``logs.csv`` table sorted by run name (name column
first), and plot MAE/RMSE/NAE per run on a log-scale y axis where
matplotlib imports. Host code only: it takes no ``--device``.

Usage:
  python -m countr_tpu_torch.cli.aggregate <suite_dir> [--no_plot]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Optional


def _mean_of_log(path: str) -> Dict[str, float]:
    """Mean of every numeric field over all JSON lines (the reference's
    pd.read_json(...).mean())."""
    sums: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            for k, v in rec.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                sums[k] = sums.get(k, 0.0) + float(v)
                counts[k] = counts.get(k, 0) + 1
    return {k: sums[k] / counts[k] for k in sums}


def log_test_results(test_dir: str) -> List[Dict]:
    """Aggregate every run dir under ``test_dir`` into logs.csv
    (reference: util/misc.py:564-581). Returns the table rows."""
    rows = []
    for name in sorted(os.listdir(test_dir)):
        d = os.path.join(test_dir, name)
        log = os.path.join(d, "log.txt")
        if not (os.path.isdir(d) and os.path.exists(log)):
            continue
        row: Dict = {"name": name}
        row.update(_mean_of_log(log))
        rows.append(row)
    rows.sort(key=lambda r: r["name"])
    cols: List[str] = ["name"]
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    out = os.path.join(test_dir, "logs.csv")
    with open(out, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return rows


def plot_test_results(test_dir: str) -> Optional[str]:
    """MAE/RMSE/NAE per run, log-scale y (reference:
    util/misc.py:601-620, plotly scatter -> matplotlib here). Returns
    the plot path, or None when matplotlib or the metrics are absent."""
    rows = []
    csv_path = os.path.join(test_dir, "logs.csv")
    if not os.path.exists(csv_path):
        log_test_results(test_dir)
    with open(csv_path, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f):
            rows.append(rec)
    rows.sort(key=lambda r: r["name"])
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    names = [r["name"] for r in rows]
    fig, ax = plt.subplots(figsize=(max(6, len(names)), 4))
    plotted = False
    for metric, color in (("MAE", "#1f77b4"), ("RMSE", "#ff7f0e"),
                          ("NAE", "#2ca02c")):
        vals = []
        for r in rows:
            v = r.get(metric, "")
            vals.append(float(v) if v not in ("", None) else float("nan"))
        if any(v == v for v in vals):
            ax.plot(names, vals, color=color, label=metric)
            plotted = True
    if not plotted:
        plt.close(fig)
        return None
    ax.set_yscale("log")
    ax.legend()
    ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    out = os.path.join(test_dir, "plot.jpeg")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def _fmt(v) -> str:
    return f"{v:.2f}" if isinstance(v, float) else "-"


def main(args) -> None:
    rows = log_test_results(args.test_dir)
    print(f"aggregated {len(rows)} runs -> {os.path.join(args.test_dir, 'logs.csv')}")
    for r in rows:
        mae = r.get("MAE")
        rmse = r.get("RMSE")
        print(f"  {r['name']}: MAE {_fmt(mae)} RMSE {_fmt(rmse)}")
    if not args.no_plot:
        out = plot_test_results(args.test_dir)
        if out:
            print(f"plot -> {out}")


def get_args(argv=None):
    p = argparse.ArgumentParser("aggregate test-run results")
    p.add_argument("test_dir", type=str,
                   help="directory containing one subdirectory per run")
    p.add_argument("--no_plot", action="store_true")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(get_args())
