"""Small helpers shared by the port's modules: `resolve_device`, and the
tree helpers of `trees`. Counterpart of boardlaw_tpu/utils/; `parallel`,
`memory`, `profiling` and `recording` are imported by name."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Never falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but CUDA is not available")
    return device


from .trees import (  # noqa: E402,F401
    map_tree,
    stack,
    concat,
    where,
    index,
    leading_shape,
    flatten_leading,
    unflatten_leading,
)
