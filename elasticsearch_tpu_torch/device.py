"""The explicit device of every entry point.

The port runs on CUDA. A caller that wants the CPU (the parity tests)
says so with ``device="cpu"``. Without CUDA and without that word, an
entry point raises: it never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the first CUDA device; ``"cpu"`` the CPU; any
    ``"cuda[:n]"`` that CUDA device. Raises where CUDA is asked for
    (explicitly or by default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "elasticsearch_tpu_torch runs on CUDA and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def resolve_devices(devices=None, device: DeviceLike = None) -> list:
    """A node's device list, the grid the mesh (parallel/) lays its
    shards and replicas over: ``devices`` as given (each through
    ``resolve_device``; the CPU tests give ``["cpu"] * 8``), else every
    visible CUDA card ``cuda:0 .. n-1`` when ``device`` is CUDA, else
    the one ``device``. Raises where CUDA is asked for and missing."""
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("a device list holds at least one device")
        return out
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
