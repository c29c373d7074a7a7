"""Device selection: CUDA unless the caller asks for the CPU, never a silent
fallback."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA was asked for (the
    default) and is not available.  Pass device="cpu" to run the plain
    PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev


def gpu_line() -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line, which goes
    beside every time a program of the port prints."""
    import subprocess
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
