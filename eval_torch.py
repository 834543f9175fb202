#!/usr/bin/env python
"""Offline metrics over a run's saved validation outputs with the
PyTorch/CUDA port. Command-line compatible with `python eval.py ...`, plus
`--device` (default cuda:0; `cpu` runs on the CPU)."""

from spnerf_torch.cli.evaluate import main

if __name__ == "__main__":
    main()
