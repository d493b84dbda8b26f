"""The card the port runs on."""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> str:
    """Raise unless a CUDA device is present; return the card's
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` line
    (first card), to print beside every measurement."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs only on the GPU")
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]
