"""The serve cell's rate sweep: the highest rate sustained without a
growing backlog (the knee), found once on the card.

    python portbench/sweep.py --workload vitb16-serve-w8a8 \\
        --seed <n> --seconds <s> --rates <r> ... [--rehearse]

One process builds the cell's Predictor and batcher once (the harness's
set-up), then runs the cell's open loop for ``--seconds`` at each rate in
turn. For each it prints the requests, the answered rate, the median and
95th-percentile latency over the whole window and over its first and
last fifth of requests, and whether the backlog grew: the last fifth's
median latency more than twice the first fifth's and above the batching
budget plus 20 ms. The knee is the highest rate below the first that
grew. The cell's ``rate_per_s`` is then set at four fifths of it, by hand,
in ``traffic/<traffic>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os.path as osp
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="vitb16-serve-w8a8")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    from portbench import harness
    run = harness.load_cell(args.workload, args.rehearse)
    harness.set_environment(run.traffic)

    import numpy as np
    import torch

    from portbench.tracing import NoSlice
    run.seed, run.seconds, run.trace = args.seed, args.seconds, 0
    run.device = torch.device("cpu" if args.rehearse else "cuda:0")
    drv = harness._driver(run.traffic["driver"]).Driver(run)
    with contextlib.redirect_stdout(sys.stderr):
        drv.setup()
    knee, grew_at = None, None
    budget = run.traffic["max_wait_ms"] * 1e-3
    for rate in args.rates:
        drv.tr["rate_per_s"] = rate
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            e2e = drv.window(args.seconds, NoSlice())
        wall = time.perf_counter() - t
        due, lat = drv.latency
        fifth = max(len(lat) // 5, 1)
        first, last = np.median(lat[:fifth]), np.median(lat[-fifth:])
        grew = bool(last > 2 * first and last > budget + 0.02)
        rec = {"rate_per_s": rate, "requests": len(lat),
               "answered_per_s": (len(lat) - e2e["failed"]) / wall,
               "failed": e2e["failed"],
               "p50_ms": float(np.median(lat) * 1e3),
               "p95_ms": e2e["metrics"]["serve_p95_ms"],
               "first_fifth_p50_ms": float(first * 1e3),
               "last_fifth_p50_ms": float(last * 1e3),
               "backlog_grew": grew, **e2e["notes"]}
        print(json.dumps(rec), flush=True)
        if grew or e2e["failed"]:
            grew_at = rate
            break
        knee = rate
    drv.release()
    print(json.dumps({"knee_per_s": knee, "first_growing_per_s": grew_at,
                      "four_fifths_per_s": None if knee is None
                      else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    here = osp.dirname(osp.abspath(__file__))
    sys.path[:] = [q for q in sys.path if osp.abspath(q or ".") != here]
    sys.path.insert(0, osp.dirname(here))
    sys.exit(main())
