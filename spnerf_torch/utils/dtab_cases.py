"""Edge cases of the table-gradient kernels (`spnerf_torch/ops/dtab.py`):
the per-level B2, B3 and B3′, held to `dtab_plain`, and the batched B4, held
to `dtab_batched_plain`. `chip_smoke.py` and the card tests
(`tests/test_torch_cuda.py`) both take them from here.

    ids, ct, t_eff = edge_case("wide", device, fmajor=True, ids64=True)
    ref = spnerf_torch.ops.dtab.dtab_plain(ids, ct, t_eff, fmajor=True)
    ids, ct, T = batched_edge_case("out_of_range", device, ids64=True)
    ref = spnerf_torch.ops.dtab.dtab_batched_plain(ids, ct, T)
"""

import numpy as np
import torch

EDGE_CASES = {  # kind: (t_eff, F, M)
    "one_id": (2 ** 19, 4, 300_000),  # every row on one id
    "out_of_range": (2 ** 19, 4, 300_000),  # a fifth outside [0, t_eff)
    "one_row": (2 ** 19, 4, 1),
    "no_rows": (2 ** 19, 4, 0),
    "ragged_tile": (2 ** 19, 4, 3 * 2048 + 77),  # M not a multiple of a tile
    "ragged_slice": (10_000, 4, 50_000),  # t_eff not a multiple of a slice
    "f1": (2 ** 19, 1, 300_000),
    "f3": (30_000, 3, 100_000),
    "f8": (2 ** 16, 8, 100_000),
    # more table windows than B3 has slices, and a tenth of the rows on the
    # first 8,192 table rows, so that the slices there are split
    "wide": (2 ** 21 + 5, 4, 300_000),
}


def edge_case(kind, device, fmajor, ids64, seed=0):
    """(ids, ct, t_eff) of EDGE_CASES[kind] on `device`: ids (M,) int64 or
    int32 (ids64), ct float32, (F, M) when fmajor else (M, F), contiguous.
    The one-id case has integer cotangents, so that its sum of 300,000 rows
    is exact in float32 whatever the order of the additions. Ids outside
    [0, t_eff) lie at both ends: -2^40 (-2^31 as int32), -1, t_eff and
    t_eff + 7."""
    g = np.random.default_rng(seed)
    t_eff, F, M = EDGE_CASES[kind]
    ids = g.integers(0, t_eff, M)
    ct = g.normal(size=(M, F)).astype(np.float32)
    if kind == "one_id":
        ids[:] = t_eff - 1 - 12_345
        ct = g.integers(-3, 4, (M, F)).astype(np.float32)
    elif kind == "out_of_range":
        bad = g.uniform(size=M) < 0.2
        ids = np.where(bad, g.choice([-(2 ** 40), -1, t_eff, t_eff + 7], M),
                       ids)
    elif kind == "wide":
        ids[:M // 10] = g.integers(0, 8192, M // 10)
    if fmajor:
        ct = np.ascontiguousarray(ct.T)
    return _ids(ids, ids64, device), torch.from_numpy(ct).to(device), t_eff


def _ids(ids, ids64, device):
    """int64 ids, or int32 ones clipped to the int32 range."""
    if not ids64:
        ids = np.clip(ids, -(2 ** 31), 2 ** 31 - 1).astype(np.int32)
    return torch.from_numpy(ids).to(device)


BATCHED_CASES = {  # kind: (L, T, F, M)
    "one_level": (1, 2 ** 19, 4, 300_000),
    "no_rows": (3, 2 ** 16, 4, 0),
    "one_row": (3, 2 ** 16, 4, 1),
    # M not a multiple of 32 nor of a block's 1,024 rows: warps and tiles
    # straddle two levels
    "ragged": (3, 2 ** 16, 4, 3 * 1024 + 77),
    # a fifth of level 1 outside [0, T), among levels 0 and 2 in range
    "out_of_range": (3, 2 ** 16, 4, 100_000),
    "one_id": (3, 2 ** 16, 4, 100_000),  # every row of level 1 on one id
    "f1": (3, 2 ** 16, 1, 100_000),
    "f3": (3, 2 ** 16, 3, 100_000),
    "f8": (3, 2 ** 16, 8, 100_000),
}


def batched_edge_case(kind, device, ids64, seed=0):
    """(ids, ct, T) of BATCHED_CASES[kind] on `device`: ids (L, M) int64 or
    int32 (ids64), ct (L, M, F) float32, contiguous. Ids outside [0, T), in
    level 1 only: -2^40, -1, T and T + 2^32 (as int32 clipped to -2^31,
    -1, T and 2^31 - 1), which must be dropped, not wrapped onto a row or
    spilled into the next level. The one-id level has integer cotangents,
    so that its sum is exact in float32 whatever the order of the
    additions."""
    g = np.random.default_rng(seed)
    L, T, F, M = BATCHED_CASES[kind]
    ids = g.integers(0, T, (L, M))
    ct = g.normal(size=(L, M, F)).astype(np.float32)
    if kind == "out_of_range":
        bad = g.uniform(size=M) < 0.2
        far = [-(2 ** 40), -1, T, T + 2 ** 32]
        ids[1] = np.where(bad, g.choice(far, M), ids[1])
    elif kind == "one_id":
        ids[1] = T - 1 - 12_345
        ct[1] = g.integers(-3, 4, (M, F))
    return (_ids(ids, ids64, device), torch.from_numpy(ct).to(device), T)
