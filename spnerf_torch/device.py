"""Device choice for the port's entry points, and the card's identity."""

import subprocess

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


def card_info(device=None):
    """(name, power limit) of CUDA card `device` (the current card when
    None) as `nvidia-smi --query-gpu=name,power.limit` gives them, e.g.
    ("NVIDIA H100 80GB HBM3", "700.00 W"); None where nvidia-smi does not
    answer or lists no card of that UUID. The card is found by its UUID,
    so torch's index under CUDA_VISIBLE_DEVICES names the right row."""
    uuid = str(torch.cuda.get_device_properties(
        resolve_device(device)).uuid).lower()
    try:
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    for row in rows:
        row_uuid, rest = row.split(",", 1)
        if row_uuid.strip().lower().removeprefix("gpu-") == uuid:
            name, limit = rest.rsplit(",", 1)
            return name.strip(), limit.strip()
    return None
