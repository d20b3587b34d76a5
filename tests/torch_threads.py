"""Gives each xdist worker one torch intra-op thread.

Every ``tests/test_torch_*.py`` imports this module first. Under
``pytest -n N`` each worker would otherwise start one torch thread per
core, so N workers ran N times as many busy threads as the machine has
cores, and the port's tests spent most of their CPU waiting on each other.
Their tensors are small and their time is operator dispatch, which one
thread serves fastest (``tests/test_torch_elliptic.py`` alone on one
worker: 109 s with eight threads, 53 s with one). A run without xdist
keeps torch's default.
"""

import os

import torch

if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0")) > 0:
  torch.set_num_threads(1)
