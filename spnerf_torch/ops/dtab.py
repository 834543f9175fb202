"""Gradient of the hash table: the kernels B2 and B3, their plain version,
and the router that picks between them as the JAX package does.

Every function here computes, for ids (M,) in [0, t_eff) and a
feature-major cotangent ct_fm (F, M),

    dtab[f, t] = sum_m [ids_m == t] * ct_fm[f, m]        -> (F, t_eff) f32

* `dtab_dense` (B2, `csrc/dtab.cu`) replaces the Pallas kernel `dtab_pallas`
  (`spnerf_tpu/ops/pallas/dtab.py`): a scatter-add with float atomics,
  accumulated per block in shared memory when the table fits there.
* `dtab_sorted` (B3) replaces the accumulating branch of
  `dtab_sorted_window` (same file): a stable sort of the ids, then a
  segmented sum that writes every run of equal ids once. Deterministic.
* `dtab_plain` is the plain version, `index_add_`; CPU tensors use it.
* `dtab` routes a call as `_matmul_dtab` routes it on an accelerator
  (`spnerf_tpu/models/hashgrid.py`): to B3 when the sorted-window kernel
  would run there (`window_eligible`), to B2 otherwise. On a CUDA tensor it
  launches a kernel or raises; it never falls back to the plain version.

`launches` counts kernel launches by name, process-wide.
"""

import ctypes

import torch

LANES = 1024  # lane width of the TPU kernels' output tile: B = LANES // F
MBLK = 1024  # index rows per grid step of the TPU kernels
WIN = 16  # sorted-window width in A-rows
MAX_F = 8  # csrc/dtab.cu MAXF
SEG = 256  # csrc/dtab.cu SEG: sorted rows per chunk

launches = {"dtab_dense": 0, "dtab_sorted": 0}


def window_eligible(T, F, M):
    """True when the TPU's sorted-window path applies and should win:
    lane-aligned power-of-two split, enough table rows A that the dense
    kernel's FLOP surplus dwarfs the sort (A >= 16 * WIN), and sorted blocks
    spanning well under one window (mean span A * MBLK / M <= WIN / 4)."""
    if F not in (1, 2, 4, 8) or T % (LANES // F):
        return False
    A = T // (LANES // F)
    return A % WIN == 0 and A >= 16 * WIN and M * WIN >= 4 * A * MBLK


def route(t_eff, F, M):
    """"sorted" (B3) or "dense" (B2) for a call of these shapes. Shapes the
    TPU kernels do not take (F outside 1, 2, 4, 8 or t_eff not a multiple
    of LANES // F) go to B2, which takes any shape."""
    return "sorted" if window_eligible(t_eff, F, M) else "dense"


def dtab_plain(ids, ct_fm, t_eff):
    """The plain version: `index_add_` into a zeroed (F, t_eff) table."""
    out = torch.zeros((ct_fm.shape[0], t_eff), dtype=torch.float32,
                      device=ct_fm.device)
    return out.index_add_(1, ids.long(), ct_fm.float())


def _check(ids, ct_fm, t_eff):
    if ids.device.type != "cuda":
        raise ValueError("the dtab kernels take CUDA tensors")
    if ct_fm.device != ids.device:
        raise ValueError(f"ct_fm on {ct_fm.device}, ids on {ids.device}")
    F, M = ct_fm.shape
    if ids.shape != (M,):
        raise ValueError(f"ids {tuple(ids.shape)} do not match ct_fm "
                         f"{tuple(ct_fm.shape)}")
    if not 1 <= F <= MAX_F:
        raise ValueError(f"the dtab kernels take 1 <= F <= {MAX_F}, got {F}")
    if M >= 2 ** 31 or F * t_eff >= 2 ** 31:
        raise ValueError("the dtab kernels index with 32-bit ints")
    return (ids.to(torch.int32).contiguous(),
            ct_fm.to(torch.float32).contiguous(), F, M)


def _lib():
    from . import _build

    lib = _build.load("dtab")
    lib.spnerf_dtab_dense.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    lib.spnerf_dtab_dense.restype = ctypes.c_int
    lib.spnerf_dtab_sorted.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    lib.spnerf_dtab_sorted.restype = ctypes.c_int
    lib.spnerf_dtab_error_string.argtypes = [ctypes.c_int]
    lib.spnerf_dtab_error_string.restype = ctypes.c_char_p
    return lib


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _raise_on(lib, err, name):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.spnerf_dtab_error_string(err).decode())


def dtab_dense(ids, ct_fm, t_eff):
    """B2 on CUDA tensors. Float atomics: the last bits vary run to run."""
    ids, ct, F, M = _check(ids, ct_fm, t_eff)
    out = torch.zeros((F, t_eff), dtype=torch.float32, device=ids.device)
    if M:
        lib = _lib()
        err = lib.spnerf_dtab_dense(ids.data_ptr(), ct.data_ptr(), M, F,
                                    t_eff, out.data_ptr(), _stream(ids.device))
        _raise_on(lib, err, "dtab_dense")
        launches["dtab_dense"] += 1
    return out


def sort_ids(ids):
    """The stable sort B3 runs before its kernel: (sorted ids, permutation)."""
    return torch.sort(ids.to(torch.int32), stable=True)


def dtab_sorted_kernel(ids_s, perm, ct_fm, t_eff):
    """B3's kernel alone, on the output of `sort_ids`."""
    ids_s, ct, F, M = _check(ids_s, ct_fm, t_eff)
    perm = perm.to(torch.int64).contiguous()
    out = torch.zeros((F, t_eff), dtype=torch.float32, device=ids_s.device)
    if M:
        scratch = torch.empty(2 * -(-M // SEG) * F, dtype=torch.float32,
                              device=ids_s.device)
        lib = _lib()
        err = lib.spnerf_dtab_sorted(ids_s.data_ptr(), perm.data_ptr(),
                                     ct.data_ptr(), M, F, t_eff,
                                     out.data_ptr(), scratch.data_ptr(),
                                     _stream(ids_s.device))
        _raise_on(lib, err, "dtab_sorted")
        launches["dtab_sorted"] += 1
    return out


def dtab_sorted(ids, ct_fm, t_eff):
    """B3 on CUDA tensors: sort, then the segmented-sum kernel. The result
    is the same bits from run to run."""
    ids_s, perm = sort_ids(ids)
    return dtab_sorted_kernel(ids_s, perm, ct_fm, t_eff)


def dtab(ids, ct_fm, t_eff, F, impl=None):
    """Router: (M,) ids, (F, M) cotangent -> (F, t_eff) table gradient.

    CPU tensors take the plain version. CUDA tensors take B3 or B2 as
    `route` says, or the plain version when the caller asks for it with
    impl="plain" (a reference run, never a fallback)."""
    if ct_fm.shape[0] != F:
        raise ValueError(f"ct_fm has {ct_fm.shape[0]} features, expected {F}")
    if impl not in (None, "plain"):
        raise ValueError(f"unknown dtab impl {impl!r}")
    if impl == "plain" or ids.device.type == "cpu":
        return dtab_plain(ids, ct_fm, t_eff)
    if route(t_eff, F, ids.shape[0]) == "sorted":
        return dtab_sorted(ids, ct_fm, t_eff)
    return dtab_dense(ids, ct_fm, t_eff)
