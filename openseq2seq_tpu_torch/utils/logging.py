"""Console logging utilities (the port's copy of
``openseq2seq_tpu/utils/logging.py``; reference: ``deco_print`` convention in
``open_seq2seq/utils/utils.py:373-377`` and ``--enable_logs`` stdout tee
in ``utils/utils.py:748-789``)."""
from __future__ import annotations

import os
import subprocess
import sys
import time


def deco_print(line: str, offset: int = 0, start: str = "*** ", end: str = "\n"):
    print(" " * offset + start + str(line), end=end, flush=True)


class Tee:
    """Tee a stream to a file (``--enable_logs`` behavior)."""

    def __init__(self, stream, path):
        self.stream = stream
        self.file = open(path, "a", buffering=1)

    def write(self, data):
        self.stream.write(data)
        self.file.write(data)

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def close(self):
        self.file.close()


def enable_logs(logdir: str) -> tuple:
    """Tee stdout/stderr into ``logdir/logs/`` and snapshot argv + git
    state, mirroring the reference's ``--enable_logs``."""
    logs_dir = os.path.join(logdir, "logs")
    os.makedirs(logs_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    out = Tee(sys.stdout, os.path.join(logs_dir, "stdout_{}.log".format(stamp)))
    err = Tee(sys.stderr, os.path.join(logs_dir, "stderr_{}.log".format(stamp)))
    sys.stdout, sys.stderr = out, err
    with open(os.path.join(logs_dir, "cmd_{}.log".format(stamp)), "w") as f:
        f.write(" ".join(sys.argv) + "\n")
    _snapshot_git(logs_dir, stamp)
    return out, err


def _snapshot_git(logs_dir: str, stamp: str) -> None:
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                              text=True, timeout=10).stdout.strip()
        diff = subprocess.run(["git", "diff"], capture_output=True,
                              text=True, timeout=10).stdout
        with open(os.path.join(logs_dir, "git_info_{}.log".format(stamp)), "w") as f:
            f.write("HEAD: {}\n\n{}".format(head, diff))
    except Exception:
        pass
