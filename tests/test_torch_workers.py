"""One torch thread a pytest-xdist worker.

The tier-1 run starts several xdist workers on the host's cores, and
each would start a pool of one torch thread a core: the pools contend,
and the port tests' small CPU ops (tile plans, masks, plain references)
spend most of their time waiting on each other's threads.  Every worker
imports every test module while it collects, so importing this one sets
its worker to one torch thread, and sets ``OMP_NUM_THREADS`` for the
gloo ranks the worker spawns (they start torch afresh and read it).
A run in one process keeps torch's default.
"""

import os

import torch

WORKER = os.environ.get("PYTEST_XDIST_WORKER")
if WORKER:
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)


def test_xdist_workers_run_one_torch_thread():
    """Under xdist a worker and the ranks it spawns run one torch thread;
    alone, torch keeps its own default."""
    if WORKER:
        assert torch.get_num_threads() == 1
        assert os.environ["OMP_NUM_THREADS"] == "1"
    else:
        assert torch.get_num_threads() >= 1
