"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means CUDA, and raises when there is none: the port never
    moves to the CPU on its own. The CPU runs only when asked for
    (`device="cpu"`), and there every kernel wrapper takes its plain
    PyTorch version. A CUDA device always carries its index, so that
    devices compare equal to those of the tensors made on them.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "janus_tpu_torch runs on CUDA and no CUDA device is available; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
