"""The port's one device rule.

Every entry point takes an explicit ``device``; the default is ``"cuda"``.
A CUDA request on a machine without a card raises — there is no silent
CPU fallback. Only a caller that asks for ``"cpu"`` (the tests do) runs on
the CPU, where every kernel wrapper takes its plain torch version.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is requested and
    no card is visible. Also pins full-f32 matmuls: the JAX objectives use
    ``Precision.HIGHEST``, so TF32 is off for matmuls and convolutions."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected "
                         "'cuda', 'cuda:N' or 'cpu'")
    return dev
