"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``configs``: its file under ``benchmark/configs/``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``driver`` names the file
under ``benchmark/drivers/`` that builds the program, warms up, runs the
measured window and checks what it produced against the plain
reference. With ``--trace 0`` the result holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each read by its own
file ``benchmark/metrics/<name>.py`` from what the driver recorded.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` in a
traced run), and last ``checks``, each number compared beside its limit;
the same numbers are the last lines of standard error. Without a CUDA
card, or with fewer cards than the cell asks for, it exits 2 and prints
no result; with JAX or the JAX package loaded after the window, 3; with a
check failed it prints ``correct: false`` and exits 0."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import common  # noqa: E402


def applies(metric: dict, workload: str, reported=()) -> bool:
    """Whether ``metric`` belongs in this cell's line: listed for it, or,
    without a list, for an end-to-end metric every cell, and for a
    per-layer one every cell that reports what it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = common.load_json(common.ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    centry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = common.load_json(common.ROOT / centry["file"])
    traffic = common.load_json(common.BENCH / "traffic" / f"{wl['traffic']}.json")
    common.set_cache_env()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available: "
              "no result", file=sys.stderr)
        return 2
    driver = common.load_module(common.BENCH / "drivers" / f"{traffic['driver']}.py")
    ctx = common.Context(workload=wl, config=config, traffic=traffic, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace), t_start=T_START,
                         chips=wl["chips"])
    out = driver.run(ctx)

    e2e = [m for m in spec["end_to_end"] if applies(m, wl["name"])]
    metrics = {}
    if not args.trace:
        for m in e2e:
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    else:
        reported = {m["name"] for m in e2e}
        for m in spec["per_layer"]:
            if not applies(m, wl["name"], reported):
                continue
            reader = common.load_module(common.BENCH / "metrics" / f"{m['name']}.py")
            value = reader.read(out.layer)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                ctx.note(f"{m['name']}: nothing to read")

    found = common.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}: no result", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": wl["chips"],
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": not out.faults and all(c.ok for c in out.checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device, "nvidia_smi": common.smi(), "extra": out.extra}
    if args.trace:
        tr = out.layer.get("trace") or {}
        device["busy_s"] = tr.get("busy_s", 0.0)
        device["window_s"] = tr.get("window_s", 0.0)
        if tr.get("breakdown"):
            result["breakdown"] = tr["breakdown"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    for f in out.faults:
        print(f"fault: {f}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} <= {c.limit!r}: {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
