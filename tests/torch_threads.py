"""Importing this caps torch's intra-op threads in a pytest-xdist worker.

Every port test module imports it. Under ``-n N`` each of the N worker
processes would otherwise run torch's CPU operations on as many OpenMP
threads as the machine has cores, and N such pools spinning at their
barriers on the same cores slow a test of many small operations by two
orders of magnitude (one `tests/test_torch_jfa.py` case on an 8-core
x86-64 host: 2.3 s alone, 8 s in six concurrent processes of one
thread each, 580 s in six of eight). A worker takes its share of the cores instead; a run without
workers keeps torch's default. Results do not depend on the thread
count of these operations.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
