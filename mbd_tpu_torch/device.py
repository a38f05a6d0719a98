"""Where the port's tensors live.

Every entry point of ``mbd_tpu_torch`` (``envs.get_env``, the env
constructors, the model loaders, ``make_schedule``) places its tensors on
``"cuda"`` unless the caller names another device. Without a card that
default raises here, so that nothing quietly runs on the CPU; a CPU run
asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mbd_tpu_torch runs on the CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return device
