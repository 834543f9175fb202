#!/usr/bin/env python
"""Train SP-NeRF with the PyTorch/CUDA port. Command-line compatible with
`python main.py ...`, plus `--device` (default cuda:<gpu_id>; `cpu` runs on
the CPU)."""

from spnerf_torch.cli.train import main

if __name__ == "__main__":
    main()
