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
