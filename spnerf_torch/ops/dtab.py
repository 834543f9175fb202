"""Gradient of the hash table: the kernels B2, B3, B3′ and B4, their plain
versions, and the routers that pick between them as the JAX package does.

Every per-level function here computes, for ids (M,) in [0, t_eff) and a
cotangent of M rows of F values,

    dtab[t, f] = sum_m [ids_m == t] * ct[m, f]

in one of two layouts: feature-major (`fmajor=True`, the flat table's:
ct (F, M) -> (F, t_eff)) or t-major (`fmajor=False`, the (L, T, F) table's:
ct (M, F) -> (t_eff, F)). Results are float32.

* `dtab_dense` (B2, `csrc/dtab.cu`) replaces the Pallas kernel `dtab_pallas`
  (`spnerf_tpu/ops/pallas/dtab.py`): one pass over the rows, each warp's
  equal ids merged by shuffles, float atomics into the table, which stays
  in L2 (B4's kernel at one level).
* `dtab_sorted` (B3) replaces the accumulating branch of
  `dtab_sorted_window` (same file), which accumulates per window of table
  rows: a stable partition of the rows by slice of table rows, then one
  block per slice sums its rows in shared memory in their order and writes
  the whole slice once. No sort, no zero fill; deterministic.
* `dtab_sorted_partials` (B3′) replaces its non-accumulating branch
  (`SPNERF_HASH_SW_ACC=0`), partials per block then a scatter: each block
  merges the equal ids of a tile of rows in a shared-memory hash table and
  adds one partial per distinct id to the table with float atomics.
* `dtab_plain` is the plain version of all three, `index_add_`; CPU tensors
  use it.
* `dtab` routes a call as `_matmul_dtab` routes it on an accelerator
  (`spnerf_tpu/models/hashgrid.py`): to B3 (or B3′ when
  `SPNERF_HASH_SW_ACC` is not "1", read at call time) when the sorted-window
  kernel would run there (`window_eligible`), to B2 otherwise.

The batched form takes all L levels of an (L, T, F) table at once:
ids (L, M), ct (L, M, F) -> (L, T, F), ids outside [0, T) dropped per level.

* `dtab_batched` (B4) replaces `dtab_sorted_window_batched` (same file):
  one pass over the L * M rows level by level, row m of level l adding to
  table row l * T + id, each warp's equal rows merged, one 16-byte float
  atomic a row at F = 4. No sort.
* `dtab_batched_plain` is its plain version, one `index_add_`.
* `dtab_levels` routes it: the plain version on CPU tensors or with
  impl="plain", B4 otherwise.

On a CUDA tensor a router launches a kernel or raises; it never falls back
to the plain version. `launches` counts kernel launches by name,
process-wide.
"""

import collections
import ctypes
import functools
import os

import torch

LANES = 1024  # lane width of the TPU kernels' output tile: B = LANES // F
MBLK = 1024  # index rows per grid step of the TPU kernels
WIN = 16  # sorted-window width in A-rows
MAX_F = 8  # csrc/dtab.cu MAXF
INT32_LIMIT = 2 ** 31

launches = {"dtab_dense": 0, "dtab_sorted": 0, "dtab_sorted_partials": 0,
            "dtab_batched": 0}


def window_eligible(T, F, M):
    """True when the TPU's sorted-window path applies and should win:
    lane-aligned power-of-two split, enough table rows A that the dense
    kernel's FLOP surplus dwarfs the sort (A >= 16 * WIN), and sorted blocks
    spanning well under one window (mean span A * MBLK / M <= WIN / 4)."""
    if F not in (1, 2, 4, 8) or T % (LANES // F):
        return False
    A = T // (LANES // F)
    return A % WIN == 0 and A >= 16 * WIN and M * WIN >= 4 * A * MBLK


def route(t_eff, F, M, sw_acc=None):
    """"sorted" (B3), "partials" (B3′) or "dense" (B2) for a call of these
    shapes. Shapes the TPU kernels do not take (F outside 1, 2, 4, 8 or
    t_eff not a multiple of LANES // F) go to B2, which takes any shape.
    sw_acc: None reads SPNERF_HASH_SW_ACC now; as in the JAX package,
    anything but "1" selects the non-accumulating branch (B3′)."""
    if not window_eligible(t_eff, F, M):
        return "dense"
    if sw_acc is None:
        sw_acc = os.environ.get("SPNERF_HASH_SW_ACC", "1") == "1"
    return "sorted" if sw_acc else "partials"


def dtab_plain(ids, ct, t_eff, fmajor=True):
    """The plain version: `index_add_` into a zeroed table. Ids outside
    [0, t_eff) are dropped, as the kernels and the JAX package's
    `_matmul_dtab` drop them: they go to one extra row, which is cut."""
    F = ct.shape[0] if fmajor else ct.shape[1]
    shape = (F, t_eff + 1) if fmajor else (t_eff + 1, F)
    ids = ids.long()
    kept = torch.where((ids >= 0) & (ids < t_eff), ids, t_eff)
    out = torch.zeros(shape, dtype=torch.float32, device=ct.device)
    out.index_add_(1 if fmajor else 0, kept, ct.float())
    return out[:, :t_eff].contiguous() if fmajor else out[:t_eff]


def _shapes(ids, ct, t_eff, fmajor):
    """(F, M) of a per-level call; raises on shapes the kernels do not
    take."""
    if ct.dim() != 2:
        raise ValueError(f"ct {tuple(ct.shape)} is not 2-D")
    F, M = ct.shape if fmajor else ct.shape[::-1]
    if ids.shape != (M,):
        raise ValueError(f"ids {tuple(ids.shape)} do not match ct "
                         f"{tuple(ct.shape)} (fmajor={fmajor})")
    if not 1 <= F <= MAX_F:
        raise ValueError(f"the dtab kernels take 1 <= F <= {MAX_F}, got {F}")
    if t_eff < 1 or M >= INT32_LIMIT or F * t_eff >= INT32_LIMIT:
        raise ValueError("the dtab kernels index with 32-bit ints")
    if ids.device.type != "cuda":
        raise ValueError("the dtab kernels take CUDA tensors")
    if ct.device != ids.device:
        raise ValueError(f"ct on {ct.device}, ids on {ids.device}")
    return F, M


def _ids(ids):
    """int32 or int64 ids as they come (no copy when contiguous; other
    integer types widened to int64) and the ids64 flag. Never narrowed: a
    cast to int32 would wrap an id outside [0, 2^31) onto a real row."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.long()
    return ids.contiguous(), int(ids.dtype == torch.int64)


def _ids_ct(ids, ct, t_eff, fmajor):
    """The per-level kernels' inputs: ids as `_ids` gives them, a float32 ct
    as it comes (no copy when contiguous), F, M and the ids64 flag."""
    F, M = _shapes(ids, ct, t_eff, fmajor)
    ids, ids64 = _ids(ids)
    return ids, ct.to(torch.float32).contiguous(), F, M, ids64


_LIB = None


def _lib():
    """The dtab library, its entry points' argtypes set once."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("dtab")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, args in (
                ("spnerf_dtab_scatter", [ptr, i32, ptr] + [i32] * 5
                 + [ptr] * 2),
                ("spnerf_dtab_owner_plan",
                 [i32] * 4 + [ctypes.POINTER(ctypes.c_longlong)]),
                ("spnerf_dtab_owner", [ptr, i32, ptr] + [i32] * 4
                 + [ptr] * 2 + [ctypes.c_longlong, ptr]),
                ("spnerf_dtab_tile_agg", [ptr, i32, ptr] + [i32] * 4
                 + [ptr] * 2)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i32
        lib.spnerf_dtab_error_string.argtypes = [i32]
        lib.spnerf_dtab_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _stream(device):
    """The handle of PyTorch's current stream on `device`, as
    `torch.cuda.current_stream(device).cuda_stream` gives it, without
    building a Stream object on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _raise_on(lib, err, name):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.spnerf_dtab_error_string(err).decode())


def _table(F, t_eff, fmajor, device):
    """An uninitialised float32 table gradient in the call's layout: every
    kernel writes or zeroes it itself."""
    shape = (F, t_eff) if fmajor else (t_eff, F)
    return torch.empty(shape, dtype=torch.float32, device=device)


def _scatter(name, ids, ids64, ct, L, M, F, T, fmajor, out):
    """B2's and B4's C call, `spnerf_dtab_scatter`: a memset of `out`, then
    one launch unless there are no rows (counted under `name`)."""
    lib = _lib()
    err = lib.spnerf_dtab_scatter(ids.data_ptr(), ids64, ct.data_ptr(), L, M,
                                  F, T, int(not fmajor), out.data_ptr(),
                                  _stream(ids.device))
    _raise_on(lib, err, name)
    if M:
        launches[name] += 1
    return out


def dtab_dense(ids, ct, t_eff, fmajor=True):
    """B2 on CUDA tensors: a memset and one pass of warp-merged float-atomic
    adds. The last bits vary run to run."""
    ids, ct, F, M, ids64 = _ids_ct(ids, ct, t_eff, fmajor)
    out = _table(F, t_eff, fmajor, ids.device)
    return _scatter("dtab_dense", ids, ids64, ct, 1, M, F, t_eff, fmajor, out)


OwnerPlan = collections.namedtuple("OwnerPlan", "S wps n_slices scratch_words")


@functools.lru_cache(maxsize=None)
def owner_plan(M, F, t_eff, device_index):
    """B3's plan on CUDA device `device_index`, from the C side
    (`csrc/dtab.cu` `owner_plan`), kept per shape: windows of S table rows,
    wps windows a slice, n_slices slices, and the 32-bit words of scratch
    the call needs."""
    lib = _lib()
    plan = (ctypes.c_longlong * 4)()
    _raise_on(lib, lib.spnerf_dtab_owner_plan(M, F, t_eff, device_index, plan),
              "dtab_sorted (plan)")
    return OwnerPlan(*plan)


def dtab_sorted(ids, ct, t_eff, fmajor=True):
    """B3 on CUDA tensors: owner-computes table slices, five launches in one
    C call, no sort and no zero fill. The result is the same bits from run
    to run."""
    ids, ct, F, M, ids64 = _ids_ct(ids, ct, t_eff, fmajor)
    index = ids.device.index
    plan = owner_plan(M, F, t_eff, torch.cuda.current_device()
                      if index is None else index)
    out = _table(F, t_eff, fmajor, ids.device)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=ids.device)
    lib = _lib()
    err = lib.spnerf_dtab_owner(ids.data_ptr(), ids64, ct.data_ptr(), M, F,
                                t_eff, int(not fmajor), out.data_ptr(),
                                scratch.data_ptr(), plan.scratch_words,
                                _stream(ids.device))
    _raise_on(lib, err, "dtab_sorted")
    if M:
        launches["dtab_sorted"] += 1
    return out


def dtab_sorted_partials(ids, ct, t_eff, fmajor=True):
    """B3′ on CUDA tensors: equal ids merged per tile of rows in shared
    memory, then float-atomic adds into the table, zeroed in the same C
    call. The last bits vary run to run."""
    ids, ct, F, M, ids64 = _ids_ct(ids, ct, t_eff, fmajor)
    out = _table(F, t_eff, fmajor, ids.device)
    lib = _lib()
    err = lib.spnerf_dtab_tile_agg(ids.data_ptr(), ids64, ct.data_ptr(), M,
                                   F, t_eff, int(not fmajor), out.data_ptr(),
                                   _stream(ids.device))
    _raise_on(lib, err, "dtab_sorted_partials")
    if M:
        launches["dtab_sorted_partials"] += 1
    return out


_KERNELS = {"dense": dtab_dense, "sorted": dtab_sorted,
            "partials": dtab_sorted_partials}


def dtab(ids, ct, t_eff, F, impl=None, fmajor=True, sw_acc=None):
    """Router: (M,) ids and a cotangent of F features -> the table gradient,
    (F, t_eff) for a feature-major ct (F, M), (t_eff, F) for a t-major ct
    (M, F) (fmajor=False).

    CPU tensors take the plain version. CUDA tensors take B3, B3′ or B2 as
    `route` says (sw_acc: None reads SPNERF_HASH_SW_ACC), or the plain
    version when the caller asks for it with impl="plain" (a reference run,
    never a fallback)."""
    got = ct.shape[0] if fmajor else ct.shape[-1]
    if got != F:
        raise ValueError(f"ct has {got} features, expected {F}")
    if impl not in (None, "plain"):
        raise ValueError(f"unknown dtab impl {impl!r}")
    if impl == "plain" or ids.device.type == "cpu":
        return dtab_plain(ids, ct, t_eff, fmajor)
    name = route(t_eff, F, ids.shape[0], sw_acc)
    return _KERNELS[name](ids, ct, t_eff, fmajor)


# ------------------------------------------------------------- batched, B4

def dtab_batched_plain(ids, ct, T):
    """The plain version of B4: one `index_add_` into a zeroed (L * T, F)
    table at rows l * T + id; ids outside [0, T) go to one extra row that is
    dropped."""
    L, M = ids.shape
    F = ct.shape[-1]
    ids = ids.long()
    offs = torch.arange(L, device=ids.device)[:, None] * T
    rows = torch.where((ids >= 0) & (ids < T), ids + offs, L * T)
    out = torch.zeros((L * T + 1, F), dtype=torch.float32, device=ct.device)
    out.index_add_(0, rows.reshape(-1), ct.reshape(L * M, F).float())
    return out[:L * T].reshape(L, T, F)


def dtab_batched(ids, ct, T):
    """B4 on CUDA tensors: ids (L, M), ct (L, M, F) -> (L, T, F), ids
    outside [0, T) dropped in their own level. A memset and one pass of
    warp-merged float-atomic adds, B2's kernel over all levels at once. The
    last bits vary run to run."""
    if ids.dim() != 2 or ct.dim() != 3 or ct.shape[:2] != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and ct {tuple(ct.shape)} "
                         f"are not (L, M) and (L, M, F)")
    L, M = ids.shape
    F = ct.shape[2]
    if not 1 <= F <= MAX_F:
        raise ValueError(f"the dtab kernels take 1 <= F <= {MAX_F}, got {F}")
    if L * T >= INT32_LIMIT or L * M >= INT32_LIMIT \
            or F * L * T >= INT32_LIMIT:
        raise ValueError(f"B4's keys l * T + id are 32-bit: L={L}, T={T}, "
                         f"M={M}, F={F} do not fit")
    if ids.device.type != "cuda":
        raise ValueError("the dtab kernels take CUDA tensors")
    if ct.device != ids.device:
        raise ValueError(f"ct on {ct.device}, ids on {ids.device}")
    ids, ids64 = _ids(ids)
    out = torch.empty((L, T, F), dtype=torch.float32, device=ids.device)
    return _scatter("dtab_batched", ids, ids64,
                    ct.to(torch.float32).contiguous(), L, M, F, T, False, out)


def dtab_levels(ids, ct, T, impl=None):
    """Router of the batched form: ids (L, M), ct (L, M, F) -> (L, T, F).
    CPU tensors and impl="plain" take the plain version, CUDA tensors B4."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown dtab impl {impl!r}")
    if impl == "plain" or ids.device.type == "cpu":
        return dtab_batched_plain(ids, ct, T)
    return dtab_batched(ids, ct, T)
