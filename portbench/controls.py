"""The readings the limits of ``limits/<cell>.json`` are set from.

    python portbench/controls.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] \\
        [--fault <name> --fault-seeds <n> ...] [--rehearse]

In one process (kernels built once), for each of ``--seeds``: a run of
the cell as the harness makes it (set-up, a window of ``--seconds``, the
program's state freed) and its compared numbers, the lower readings. For
each of ``--control-seeds``: the control, the reference computed one
precision below the configuration's (fp8 for bf16, int4 for int8) put in
the program's place on that seed's inputs. For each of ``--fault-seeds``:
the numbers with ``--fault`` planted in the port (``faults.py``). One
JSON line per reading, then the largest program reading and the smallest
control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os.path as osp
import sys

#: the control of each configured precision: the nearest one below it
CONTROL = {"bf16": "fp8", "w8a8": "int4"}


def _run(workload, seed, seconds, rehearse, fault=None):
    import torch

    from portbench import faults, harness
    from portbench.tracing import NoSlice
    run = harness.load_cell(workload, rehearse)
    run.seed, run.seconds, run.trace = seed, seconds, 0
    run.device = torch.device("cpu" if rehearse else "cuda:0")
    kind = run.traffic["driver"]
    drv = harness._driver(kind).Driver(run)
    undo = faults.plant(fault, kind) if fault else None
    try:
        with contextlib.redirect_stdout(sys.stderr):
            drv.setup()
            e2e = drv.window(seconds, NoSlice())
            drv.release()
            checks = drv.check()
    finally:
        if undo:
            undo()
    return run, drv, checks, e2e


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    from portbench import harness
    harness.set_environment(harness.load_cell(args.workload,
                                              args.rehearse).traffic)
    lower, upper = {}, {}

    def emit(kind, seed, checks, extra=None):
        print(json.dumps({"kind": kind, "seed": seed, "checks": checks,
                          **(extra or {})}), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        run, drv, checks, e2e = _run(args.workload, seed, args.seconds,
                                     args.rehearse)
        if seed in args.seeds:
            emit("program", seed, checks, {"failed": e2e["failed"]})
            for k, v in checks.items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in args.control_seeds:
            quant = run.traffic.get("quantize")
            ctl = drv.control(CONTROL[quant or run.config["precision"]])
            emit("control", seed, ctl)
            for k, v in ctl.items():
                upper.setdefault("control", {})
                upper["control"][k] = min(upper["control"].get(k, v), v)
    for seed in args.fault_seeds:
        _, _, checks, e2e = _run(args.workload, seed, args.seconds,
                                 args.rehearse, args.fault)
        emit("fault:" + args.fault, seed, checks, {"failed": e2e["failed"]})
        for k, v in checks.items():
            upper.setdefault(args.fault, {})
            upper[args.fault][k] = min(upper[args.fault].get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    here = osp.dirname(osp.abspath(__file__))
    sys.path[:] = [q for q in sys.path if osp.abspath(q or ".") != here]
    sys.path.insert(0, osp.dirname(here))
    sys.exit(main())
