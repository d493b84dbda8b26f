"""Fixtures that keep the port's tests light on a shared tier-1 host.

Tier-1 runs six pytest-xdist workers on one host. Every worker imports
every test module while it collects, and each worker process lives, with
all it allocated, until the whole run ends. So the port's test modules
import torch (about 110 MB a process) only when their first test runs, and
hand what they freed back to the OS when they end. Import both fixtures
into a test module to use them.
"""

import ctypes
import gc

import jax
import pytest


@pytest.fixture(scope="module")
def torch():
    """torch, imported when a test first asks for it, on 2 threads."""
    import torch

    torch.set_num_threads(2)
    return torch


@pytest.fixture(scope="module", autouse=True)
def release_heap_after_module():
    yield
    jax.clear_caches()  # compiled flax models and their constants
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc only
    if trim is not None:
        trim(0)
