#!/usr/bin/env python3
"""Run one cell of the benchmark once: see `perfbench/harness/cli.py`.

    python3 perfbench/run.py --workload washer1348k_512.sdf --seed 7 --seconds 45 --trace 0
"""

import os
import sys
import time


def _process_start() -> float:
    """This process's start on `time.perf_counter`'s clock (Linux; the
    first line of this file elsewhere)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return now - (float(f.read().split()[0]) - started)
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Every kernel cache at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".benchcache", sub)
sys.path[:0] = [HERE, ROOT]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
