"""Density-only proposal field: the PyTorch version of the JAX package's
`models/proposal.py`. A small hash encoding and a two-layer MLP -> sigma,
paired with `ops/proposal.py`: its only job is to place the main field's
samples.

Its hash table's gradient goes through the table-gradient router
(`ops/dtab.py`): the kernels on CUDA, the plain version on the CPU. It
computes in float32 whatever the main field's compute dtype, as the JAX
package's does.
"""

import torch.nn.functional as F
from torch import nn

from .hashgrid import HashGridEncoding
from .spnerf import TorchDense, softplus


class ProposalField(nn.Module):
    """xyz (N, 3) -> sigma (N,). The flax names map to the port's as
    HashGridEncoding_0/table -> encoding.table, TorchDense_i -> dense.i."""

    def __init__(self, n_levels=8, n_features=2, log2_table_size=16,
                 max_resolution=512, hidden=32, generator=None):
        super().__init__()
        self.encoding = HashGridEncoding(
            n_levels=n_levels, n_features=n_features,
            log2_table_size=log2_table_size, max_resolution=max_resolution,
            generator=generator)
        self.dense = nn.ModuleList([
            TorchDense(n_levels * n_features, hidden, generator=generator),
            TorchDense(hidden, 1, generator=generator)])

    def forward(self, xyz):
        h = F.relu(self.dense[0](self.encoding(xyz)))
        return softplus(self.dense[1](h))[..., 0]
