"""Device choice for the port's entry points."""

import torch


def resolve_device(device=None, index=None) -> torch.device:
    """The device an entry point runs on.

    None means CUDA card `index` (the current card when index is None).
    Without CUDA this raises, for None and for a CUDA device alike, instead
    of quietly picking the CPU: the CPU is used only when the caller asks
    for it (`device="cpu"`), as the tests do.
    """
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if index is None else index)
    return torch.device(device)
