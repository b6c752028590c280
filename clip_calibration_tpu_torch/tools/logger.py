"""Stdout tee logger (reference: ``tools/logger.py:19-81``).

``setup_logger(output)`` replaces ``sys.stdout`` with a tee that mirrors all
prints into a log file; the reference stack relies on this because
``parse_test_res.py`` scrapes metrics from those log files.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
import time


def mkdir_if_missing(dirname: str) -> None:
    if dirname and not osp.exists(dirname):
        os.makedirs(dirname, exist_ok=True)


class Logger:
    """Write console output to an external text file."""

    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(osp.dirname(fpath))
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def __getattr__(self, name):
        # delegate isatty/fileno/encoding/... so libraries probing
        # sys.stdout keep working after the tee is installed
        if name == "console":  # not yet set during __init__
            raise AttributeError(name)
        return getattr(self.console, name)

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)
            self.file.flush()

    def flush(self):
        try:
            self.console.flush()
            if self.file is not None:
                self.file.flush()
                os.fsync(self.file.fileno())
        except (ValueError, OSError):
            pass  # interpreter teardown / closed capture stream

    def close(self):
        try:
            self.console.flush()
        except (ValueError, OSError):
            pass
        if self.file is not None:
            self.file.close()
            self.file = None


def setup_logger(output: str | None = None) -> None:
    if output is None:
        return
    if output.endswith(".txt") or output.endswith(".log"):
        fpath = output
    else:
        fpath = osp.join(output, "log.txt")
    if osp.exists(fpath):
        # keep old log files by renaming with timestamp
        fpath += time.strftime("-%Y-%m-%d-%H-%M-%S")
    sys.stdout = Logger(fpath)
