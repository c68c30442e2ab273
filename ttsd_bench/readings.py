"""The readings that the limits of ``check.NUMBERS`` are set from, for one
configuration and traffic mix, in one process: sound runs of the program
over many seeds, and the controls and planted faults on some of them.

    python -m ttsd_bench.readings --config moss-ttsd-v0.5-bf16 \
        --traffic dialogue-b8 --seeds 11,12,13 --seconds 1 \
        [--judge lm:fp8,codec:fp8] [--program int8] \
        [--fault unchanged,half_batch] [--control_seeds 3] \
        [--out chiprun_out/readings.json]

Each seed runs the window (``--seconds`` short: a batch mix then runs one
batch, a server mix the requests due in that time) and judges its sample
with the reference. On the first ``--control_seeds`` seeds: ``--judge``
adds lower-precision references in the program's place (``check.judge``'s
controls) on the same sample; ``--program int8`` also runs the program
with its own int8 weight path switched on, and ``--fault`` with each
fault of ``faults.py`` planted, each judged by the unchanged reference.
The benchmark's own runs never run a control or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--judge", default="")
    p.add_argument("--program", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--control_seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    spec = run.parts(a.config, a.traffic)
    run.cache_dirs()
    import torch
    from . import cells, check, faults
    t = spec["traffic"]
    pool = t if t["entry"] == "server" else None
    seeds = [int(s) for s in a.seeds.split(",")]
    judges = [j for j in a.judge.split(",") if j]
    rows = []
    for i, seed in enumerate(seeds):
        variants = [("program", "config", None)]
        if i < a.control_seeds:
            if a.program:
                variants.append((f"program:{a.program}", a.program, None))
            variants += [(f"fault:{f}", "config", f)
                         for f in a.fault.split(",") if f]
        for name, quant, fault in variants:
            t0 = time.perf_counter()
            args = cells.Args(cfg=spec["cfg"], traffic=t,
                              seed=seed, seconds=a.seconds, trace=False,
                              t_start=t0, quant=quant)
            with (faults.planted(fault) if fault
                  else contextlib.nullcontext()):
                res, pipe = cells.ENTRIES[t["entry"]](args)
            del pipe
            gc.collect()
            torch.cuda.empty_cache()
            row = {"seed": seed, "variant": name, "e2e": res["e2e"],
                   "failed": res["failed"], "attempted": res["attempted"],
                   "numbers": check.judge(spec["cfg"], res["kind"],
                                          res["samples"], seed, "cuda", pool)}
            if name == "program" and i < a.control_seeds:
                for j in judges:
                    row[j] = check.judge(spec["cfg"], res["kind"],
                                         res["samples"], seed, "cuda", pool,
                                         control=j)
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), file=sys.stderr, flush=True)
            rows.append(row)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    bad = run.banned_modules(sys.modules)
    print(json.dumps({"rows": len(rows), "banned": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
