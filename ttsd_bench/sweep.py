"""The one rate sweep of a server mix: its window at several fixed
arrival rates, each reporting TTFA p50 / p90, the frame-gap p90, the
median TTFA of the first and the last third of the requests (a queue
that grows makes the last third wait longer), and the share refused.

    python -m ttsd_bench.sweep --config moss-ttsd-v0.5-bf16 \
        --traffic pool-stream --rates 1.5,2.5,3.5,4.5 --seconds 30 --seed 5

The knee is the highest rate whose queue does not grow and whose
requests all succeed; the cell runs at about four fifths of it
(``rate_per_s`` in its traffic file).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=5)
    a = p.parse_args(argv)
    spec = run.parts(a.config, a.traffic)
    run.cache_dirs()
    import torch
    from . import cells
    for rate in (float(r) for r in a.rates.split(",")):
        args = cells.Args(cfg=spec["cfg"],
                          traffic=spec["traffic"], seed=a.seed,
                          seconds=a.seconds, trace=False,
                          t_start=time.perf_counter(), rate=rate)
        res, _ = cells.ENTRIES[spec["traffic"]["entry"]](args)
        gc.collect()
        torch.cuda.empty_cache()
        n = res["notes"]
        print(json.dumps({
            "rate_per_s": rate, "requests": res["attempted"],
            "failed": res["failed"], "refused": n["refused"],
            "ttfa_p50_ms": n["ttfa_p50_ms"],
            "ttfa_p90_ms": res["e2e"]["ttfa_p90_ms"],
            "frame_gap_p90_ms": res["e2e"]["frame_gap_p90_ms"],
            "ttfa_p50_first_third_ms": n["ttfa_p50_first_third_ms"],
            "ttfa_p50_last_third_ms": n["ttfa_p50_last_third_ms"],
            "late_max_s": n["late_max_s"]}), flush=True)
    print(json.dumps({"banned": run.banned_modules(sys.modules)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
