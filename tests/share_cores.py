"""The CPU cores shared out between pytest-xdist workers.

Each worker is a process of its own, and PyTorch's intra-op pool takes every
core in each of them: its OpenMP threads then spin against the other
workers' (a train_net test that takes 8 s alone took 600 s beside five
copies of itself on 8 cores, and 6 s with one thread each).  The PyTorch
port's test modules import this module, which gives each worker its share of
the cores; a run without workers keeps them all.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // WORKERS))
