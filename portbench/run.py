"""Run one cell of the port's benchmark; see ``harness.py``.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--rehearse]
"""

import faulthandler
import os
import os.path as osp
import sys
import time


def _since_process_start() -> float:
    """Seconds from this process's start to now (Linux ``/proc``; the
    interpreter's own start-up, which precedes the first line here)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    t0 = time.perf_counter() - _since_process_start()
    # a crash in native code prints every thread's Python stack
    faulthandler.enable()
    here = osp.dirname(osp.abspath(__file__))
    sys.path[:] = [p for p in sys.path if osp.abspath(p or ".") != here]
    sys.path.insert(0, osp.dirname(here))
    from portbench.harness import main
    sys.exit(main(t0=t0))
