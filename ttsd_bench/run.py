"""Run one cell of the benchmark once:

    python -m ttsd_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration file
and a traffic file (``ttsd_bench/workloads/<traffic>.json``, whose
``entry`` picks the path the window drives); the per-layer metrics of a
traced run are read by ``ttsd_bench/metrics/<name>.py``; the limits of
the numbers that decide ``correct`` are ``ttsd_bench/limits/<cell>.json``.
The run builds its weights and traffic from ``--seed``, warms the cell's
shapes, measures for ``--seconds``, judges what it served (every row of a
batch window, a sample of a server window)
with the plain reference, and prints one JSON line last.

Exits non-zero, printing no result, without the CUDA devices the cell
asks for, when a module whose top-level name is jax, jaxlib, flax or
moss_ttsd_tpu was loaded, and when a traced run labels fewer decode steps
than its traffic's ``trace_steps``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "moss_ttsd_tpu")
MISSING_MS = 1e9      # a latency percentile that falls on a missing request


def banned_modules(modules) -> list:
    """Loaded modules whose top-level name is one of ``BANNED``, compared
    whole: ``moss_ttsd_torch`` is not ``moss_ttsd_tpu``."""
    return sorted({m for m in modules if m.split(".")[0] in BANNED})


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _read(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def parts(config: str, traffic: str) -> dict:
    """A configuration and a traffic mix found by their names, whether a
    cell of ``BENCHMARK.json`` pairs them or not (the sweep and the
    readings take them so): no limits and no metric lists."""
    return {"cell": {"name": f"{config}+{traffic}", "chips": 1},
            "cfg": _read(f"ttsd_bench/configs/{config}.json"),
            "traffic": _read(f"ttsd_bench/workloads/{traffic}.json"),
            "limits": {}, "end_to_end": [], "per_layer": []}


def load_cell(name: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metric lists,
    all found by name from ``BENCHMARK.json``."""
    bench = benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"unknown workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    moved = {m["name"]: m for m in bench["end_to_end"]}

    def here(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if here(m)]
    per_layer = [m for m in bench["per_layer"]
                 if (here(m) if "workloads" in m else here(moved[m["moves"]]))]
    return {"cell": cell, "cfg": _read(conf["file"]),
            "traffic": _read(f"ttsd_bench/workloads/{cell['traffic']}.json"),
            "limits": _read(f"ttsd_bench/limits/{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own nvcc build root is ``build/moss_ttsd_torch``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = ROOT / "build" / "ttsd_bench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _number(v: float) -> float:
    return MISSING_MS if math.isinf(v) else float(v)


def execute(spec: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", quant: str = "config", rate=None,
            control=None, t_start: float = T_START) -> dict:
    """Run the cell and judge it; the result line's fields (no device
    check: ``main`` makes it)."""
    import torch
    from . import cells, check, readers
    cell, t = spec["cell"], spec["traffic"]
    unknown = set(spec["limits"]) - set(check.NUMBERS)
    if unknown:
        raise SystemExit("limits name no number of check.py: "
                         + ", ".join(sorted(unknown)))
    args = cells.Args(cfg=spec["cfg"], traffic=t,
                      seed=seed, seconds=seconds, trace=trace,
                      t_start=t_start, device=device, quant=quant, rate=rate)
    res, pipe = cells.ENTRIES[t["entry"]](args)
    del pipe
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        got = (res["layer"].get("trace") or {}).get("steps", 0)
        if got < t["trace_steps"]:
            # the probes wrap the port's step; a step they no longer see
            # would silently drop the trace's metrics from the line
            raise SystemExit(f"the traced run labelled {got} of "
                             f"{t['trace_steps']} decode steps: the probe in "
                             "cells.py no longer sees the program's step")
    t_check = time.perf_counter()
    numbers = check.judge(spec["cfg"], res["kind"], res["samples"], seed,
                          device, t if res["kind"] == "server" else None,
                          control)
    res["notes"]["check_s"] = time.perf_counter() - t_check
    limits = spec["limits"]
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in check.NUMBERS if k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = readers.load(m["name"])(res["layer"], spec["cfg"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": _number(res["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": (torch.cuda.get_device_name(0)
                               if device == "cuda" else device),
                      "count": cell["chips"],
                      "memory_peak_bytes": res["peak"]},
           "notes": {k: (None if isinstance(v, float) and math.isinf(v)
                         else v) for k, v in res["notes"].items()}}
    tr = res["layer"].get("trace") if trace else None
    if tr and tr.get("window_s"):
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        out["notes"]["trace_stop_s"] = tr.get("stop_s")
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = load_cell(a.workload)
    cache_dirs()
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(spec, a.seed, a.seconds, bool(a.trace))
    bad = banned_modules(sys.modules)
    if bad:
        print(f"loaded modules that must not be: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    out["notes"]["seed"] = a.seed
    out["notes"]["card"] = power_limit()
    print(json.dumps(out["notes"]), file=sys.stderr)
    for k, v in out["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
