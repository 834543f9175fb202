"""Device choice for the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means the first CUDA card. Without one this raises instead of
    quietly picking the CPU: the CPU is used only when the caller asks for it
    (`device="cpu"`), as the tests do.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
