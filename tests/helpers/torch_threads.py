"""Split the machine's cores among the pytest-xdist workers' torch threads.

Each process's torch starts one intra-op thread per core, so N xdist
workers run N threads a core, and the small ops of the port's tests wait
on each other's threads: on an 8-core machine beside a 6-worker run,
building ViT-Test (width 128) took 3.0 s against 0.08 s with one thread.
Under xdist each worker takes cores // workers threads (at least one); a
run without xdist keeps torch's default. The port's test modules import
this module, and every xdist worker imports every test module when it
collects.
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // WORKERS))
