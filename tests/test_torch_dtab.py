"""The hash-table gradient (`spnerf_torch/ops/dtab.py`) against the JAX
package's Pallas kernels in interpret mode, and its routers against the
routing of `_matmul_dtab` and `HashGridEncoding` on an accelerator.

The plain version (what CPU tensors run, and what the card's kernels are
held to) is compared with `dtab_pallas` (B2), `dtab_sorted_window` (B3,
accumulating column branch; B3′, its non-accumulating branch under
SPNERF_HASH_SW_ACC=0, in both layouts) and `dtab_sorted_window_batched` (B4)
on the cases of `tests/test_pallas.py`: uniform ids, skewed ids that force
the sorted window's tail fallback, a row count that is not a multiple of the
kernels' block, ids at the end of the table, F = 2 and 8, and for B4 a level
of direct-coarse ids. Tolerances as there: 1e-4 against B2 and 1e-3 against
B3, B3′ and B4 (float32 sums in other orders over up to thousands of rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.ops.pallas import dtab as jdtab
from spnerf_torch.models.hashgrid import HashGridEncoding, use_batched
from spnerf_torch.ops import dtab as tdtab
from spnerf_torch.utils import dtab_cases

CASES = {
    "uniform": (2 ** 15, 4, 20000, "uniform"),
    "skewed_tail": (2 ** 15, 4, 20000, "skewed"),
    "padded_rows": (2 ** 14, 2, 5000, "uniform"),
    "table_end": (2 ** 14, 4, 3000, "end"),
    "f8": (2 ** 13, 8, 4097, "uniform"),
}


def case_inputs(name):
    T, F, M, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    ids = rng.integers(0, T, M)
    if kind == "skewed":
        ids[: M // 2] = rng.integers(0, 64, M // 2)  # a block spans > 2 windows
    elif kind == "end":
        ids = rng.integers(T - 200, T, M)
    ct_fm = rng.normal(size=(F, M)).astype(np.float32)
    return T, F, ids.astype(np.int32), ct_fm


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("kernel", ["dense", "sorted_window"])
def test_plain_matches_pallas_kernels(name, kernel):
    T, F, ids, ct_fm = case_inputs(name)
    if kernel == "dense":
        ref = jdtab.dtab_pallas(jnp.asarray(ids), jnp.asarray(ct_fm), T, F,
                                f32=True, fmajor=True, interpret=True)
        atol = 1e-4
    else:
        ref = jdtab.dtab_sorted_window(jnp.asarray(ids), jnp.asarray(ct_fm), T,
                                       F, fmajor=True, interpret=True)
        atol = 1e-3
    before = dict(tdtab.launches)
    out = tdtab.dtab(torch.from_numpy(ids), torch.from_numpy(ct_fm), T, F)
    assert tdtab.launches == before  # CPU tensors launch nothing
    assert out.shape == (F, T) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=0)
    # the plain version is the scatter-add itself
    exact = np.zeros((F, T), np.float64)
    np.add.at(exact.T, ids, ct_fm.T.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), exact, atol=1e-4, rtol=0)


def boundary_grid():
    grid = []
    for log2T in range(8, 21):
        T = 2 ** log2T
        for F in (1, 2, 3, 4, 8):
            ms = {0, 1024, 524288, 1048576}
            if F in (1, 2, 4, 8) and T % (jdtab.LANES // F) == 0:
                A = T // (jdtab.LANES // F)
                edge = 4 * A * jdtab.MBLK // jdtab.WIN  # M at equality
                ms |= {edge - 1, edge, edge + 1}
            grid += [(T, F, M) for M in sorted(ms) if M >= 0]
    return grid


def test_window_eligible_matches_jax():
    grid = boundary_grid()
    assert len(grid) > 300
    for T, F, M in grid:
        assert tdtab.window_eligible(T, F, M) == jdtab.window_eligible(T, F, M), \
            (T, F, M)
    # level 2 of the hash step's coarse pass sits exactly on the boundary
    assert tdtab.window_eligible(2 ** 19, 4, 524288)
    assert not tdtab.window_eligible(2 ** 19, 4, 524288 - 1)


def test_router_sends_hash_step_levels_as_the_tpu_does():
    """L8 F4 T=2^19, batch 1024, 64 coarse + 64 guided + 128 solar samples:
    3 dense (level 0 in each pass) and 21 sorted-window calls per step."""
    enc = HashGridEncoding(n_levels=8, n_features=4, log2_table_size=19)
    t_effs = enc.level_table_sizes()
    assert t_effs == [8192, 65536] + [524288] * 6
    counts = {"dense": 0, "sorted": 0}
    for samples in (64, 64, 128):  # coarse, guided, solar
        M = 1024 * samples * 8  # rows: points x corners
        for t_eff in t_effs:
            r = tdtab.route(t_eff, 4, M)
            counts[r] += 1
            # the JAX package's choice on an accelerator (_matmul_dtab)
            uses_pallas = t_eff % (jdtab.LANES // 4) == 0
            jax_sorted = uses_pallas and jdtab.window_eligible(t_eff, 4, M)
            assert (r == "sorted") == jax_sorted, (t_eff, M)
    assert counts == {"dense": 3, "sorted": 21}


def test_router_shapes_outside_the_tpu_kernels_go_dense():
    assert tdtab.route(64, 4, 10 ** 6) == "dense"  # t_eff < LANES // F
    assert tdtab.route(2 ** 19, 3, 10 ** 6) == "dense"  # F not a power of 2


def test_kernel_wrappers_refuse_cpu_tensors():
    ids = torch.zeros(4, dtype=torch.int32)
    ct = torch.zeros(2, 4)
    for fn in (tdtab.dtab_dense, tdtab.dtab_sorted):
        with pytest.raises(ValueError, match="CUDA"):
            fn(ids, ct, 8)
    with pytest.raises(ValueError, match="impl"):
        tdtab.dtab(ids, ct, 8, 2, impl="fast")
    with pytest.raises(ValueError, match="features"):
        tdtab.dtab(ids, ct, 8, 3)


def test_plain_drops_nothing_and_keeps_dtype():
    ids = torch.tensor([3, 3, 0, 7], dtype=torch.int64)
    ct = torch.arange(8, dtype=torch.float64).reshape(2, 4)
    out = tdtab.dtab(ids, ct, 8, 2)
    assert out.dtype == torch.float32
    expect = torch.zeros(2, 8)
    expect[:, 3] = ct[:, 0] + ct[:, 1]
    expect[:, 0] = ct[:, 2]
    expect[:, 7] = ct[:, 3]
    assert torch.equal(out, expect)


@pytest.mark.parametrize("fmajor", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_non_accumulating_window(monkeypatch, name, fmajor):
    """B3′'s function: the JAX sorted window with SPNERF_HASH_SW_ACC=0 (read
    at trace time, hence the cleared cache) in both layouts, against the
    router on CPU tensors under the same env."""
    T, F, ids, ct_fm = case_inputs(name)
    ct = ct_fm if fmajor else np.ascontiguousarray(ct_fm.T)
    monkeypatch.setenv("SPNERF_HASH_SW_ACC", "0")
    jdtab.dtab_sorted_window.clear_cache()
    try:
        ref = jdtab.dtab_sorted_window(jnp.asarray(ids), jnp.asarray(ct), T,
                                       F, fmajor=fmajor, interpret=True)
        ref = np.asarray(ref)
    finally:
        jdtab.dtab_sorted_window.clear_cache()
    before = dict(tdtab.launches)
    out = tdtab.dtab(torch.from_numpy(ids), torch.from_numpy(ct), T, F,
                     fmajor=fmajor)
    assert tdtab.launches == before
    assert out.shape == ((F, T) if fmajor else (T, F))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)


def batched_case(rng):
    """The three levels of tests/test_pallas.py: uniform, direct-coarse ids
    below 4,913, and a level skewed onto 64 ids (the TPU kernel's tail)."""
    T, F, M = 2 ** 15, 4, 70000
    lvl0 = rng.integers(0, T, M)
    lvl1 = rng.integers(0, 4913, M)
    lvl2 = rng.integers(0, T, M)
    lvl2[: M // 2] = rng.integers(0, 64, M // 2)
    ids = np.stack([lvl0, lvl1, lvl2]).astype(np.int32)
    ct = rng.normal(size=(3, M, F)).astype(np.float32)
    return T, F, ids, ct


def test_batched_plain_matches_pallas(rng):
    T, F, ids, ct = batched_case(rng)
    ref = jdtab.dtab_sorted_window_batched(jnp.asarray(ids), jnp.asarray(ct),
                                           T, F, interpret=True)
    before = dict(tdtab.launches)
    out = tdtab.dtab_levels(torch.from_numpy(ids), torch.from_numpy(ct), T)
    assert tdtab.launches == before
    assert out.shape == (3, T, F) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)
    # and the per-level plain version, level by level
    for l in range(3):
        one = tdtab.dtab_plain(torch.from_numpy(ids[l]),
                               torch.from_numpy(ct[l]), T, fmajor=False)
        np.testing.assert_allclose(out[l].numpy(), one.numpy(), atol=1e-5,
                                   rtol=0)


def test_batched_plain_drops_out_of_range_ids_per_level():
    """An id outside [0, T) is dropped in its own level; it does not land in
    the next level's rows at l * T + id."""
    T = 8
    ids = torch.tensor([[T, 2, -1], [T - 1, 9, 0]], dtype=torch.int32)
    ct = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2)
    out = tdtab.dtab_batched_plain(ids, ct, T)
    expect = torch.zeros(2, T, 2)
    expect[0, 2] = ct[0, 1]
    expect[1, T - 1] = ct[1, 0]
    expect[1, 0] = ct[1, 2]
    assert torch.equal(out, expect)


def test_router_sw_acc_sends_window_calls_to_partials(monkeypatch):
    """SPNERF_HASH_SW_ACC=0, read at call time, sends the hash step's 21
    window calls to B3′; the 3 dense calls stay on B2. An explicit sw_acc
    overrides the env."""
    t_effs = HashGridEncoding(n_levels=8, n_features=4,
                              log2_table_size=19).level_table_sizes()
    shapes = [(t_eff, 1024 * s * 8) for s in (64, 64, 128) for t_eff in t_effs]

    def counts():
        c = {"dense": 0, "sorted": 0, "partials": 0}
        for t_eff, M in shapes:
            c[tdtab.route(t_eff, 4, M)] += 1
        return c

    monkeypatch.delenv("SPNERF_HASH_SW_ACC", raising=False)
    assert counts() == {"dense": 3, "sorted": 21, "partials": 0}
    monkeypatch.setenv("SPNERF_HASH_SW_ACC", "0")
    assert counts() == {"dense": 3, "sorted": 0, "partials": 21}
    assert tdtab.route(2 ** 19, 4, 524288, sw_acc=True) == "sorted"
    assert tdtab.route(8192, 4, 524288, sw_acc=False) == "dense"
    monkeypatch.setenv("SPNERF_HASH_SW_ACC", "1")
    assert tdtab.route(2 ** 19, 4, 524288, sw_acc=False) == "partials"
    assert counts() == {"dense": 3, "sorted": 21, "partials": 0}


def test_batched_gate_matches_jax_conditions():
    """`use_batched` against the JAX package's gate (`HashGridEncoding`:
    impl "matmul_vjp", the (L, T, F) table, SPNERF_HASH_SW_BATCHED=1, an
    accelerator, window_eligible(T, F, n * 8)) on a grid around the
    window_eligible edge."""
    n_cases = 0
    for log2T in (13, 15, 17, 19):
        T = 2 ** log2T
        for F in (2, 4, 8):
            A = T // (jdtab.LANES // F)
            edge = -(-4 * A * jdtab.MBLK // (jdtab.WIN * 8))  # points
            for n in (1, edge - 1, edge, edge + 1, 65536):
                for impl in ("auto", "matmul_vjp", "xla", "sorted_vjp"):
                    for flat in (True, False):
                        for sw in (True, False):
                            for dev in ("cpu", "cuda"):
                                jimpl = ("matmul_vjp" if impl == "auto"
                                         and dev != "cpu" else impl)
                                ref = (jimpl == "matmul_vjp" and not flat
                                       and sw and dev != "cpu"
                                       and jdtab.window_eligible(T, F, n * 8))
                                got = use_batched(impl, flat, dev, T, F, n,
                                                  sw_batched=sw)
                                assert got == ref, (T, F, n, impl, flat, sw,
                                                    dev)
                                n_cases += 1
    assert n_cases > 1000


def test_new_kernel_wrappers_refuse_cpu_tensors():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tdtab.dtab_sorted_partials(ids, torch.zeros(2, 4), 8)
    with pytest.raises(ValueError, match="CUDA"):
        tdtab.dtab_sorted(ids, torch.zeros(4, 2), 8, fmajor=False)
    with pytest.raises(ValueError, match="CUDA"):
        tdtab.dtab_batched(ids.reshape(2, 2), torch.zeros(2, 2, 4), 8)
    with pytest.raises(ValueError, match="32-bit"):
        tdtab.dtab_batched(ids.reshape(2, 2), torch.zeros(2, 2, 4), 2 ** 30)
    with pytest.raises(ValueError, match="impl"):
        tdtab.dtab_levels(ids.reshape(2, 2), torch.zeros(2, 2, 4), 8,
                          impl="fast")
    with pytest.raises(ValueError, match="features"):
        tdtab.dtab(ids, torch.zeros(4, 2), 8, 3, fmajor=False)


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", ["dense", "sorted", "partials"])
def test_per_level_wrappers_refuse_bad_inputs(name, ids_dtype):
    """B2, B3 and B3′ refuse CPU tensors, F outside 1..8 and ids that do not
    match the cotangent, in both layouts and with int32 or int64 ids, before
    anything reaches a kernel."""
    fn = {"dense": tdtab.dtab_dense, "sorted": tdtab.dtab_sorted,
          "partials": tdtab.dtab_sorted_partials}[name]
    ids = torch.zeros(6, dtype=ids_dtype)
    before = dict(tdtab.launches)
    for fmajor in (True, False):
        def ct(F, M=6):
            return torch.zeros((F, M) if fmajor else (M, F))
        with pytest.raises(ValueError, match="CUDA"):
            fn(ids, ct(4), 8, fmajor=fmajor)
        for F in (0, 9):
            with pytest.raises(ValueError, match="1 <= F <= 8"):
                fn(ids, ct(F), 8, fmajor=fmajor)
        with pytest.raises(ValueError, match="do not match"):
            fn(ids, ct(4, M=5), 8, fmajor=fmajor)
        with pytest.raises(ValueError, match="do not match"):
            fn(ids.reshape(2, 3), ct(4), 8, fmajor=fmajor)
        with pytest.raises(ValueError, match="32-bit"):
            fn(ids, ct(4), 2 ** 31 // 4, fmajor=fmajor)
    assert tdtab.launches == before


@pytest.mark.parametrize("kind", sorted(dtab_cases.EDGE_CASES))
def test_edge_cases_and_their_plain_version(kind):
    """The edge cases the card holds B3 and B3′ to (`utils/dtab_cases.py`),
    built on the CPU in both layouts with int64 and int32 ids: their shapes,
    types and layouts, and `dtab_plain` against numpy's `add.at` over
    the ids in [0, t_eff) in float64, within 1e-5 of the largest entry."""
    t_eff, F, M = dtab_cases.EDGE_CASES[kind]
    for fmajor in (True, False):
        for ids64 in (True, False):
            ids, ct, t = dtab_cases.edge_case(kind, "cpu", fmajor, ids64)
            assert t == t_eff and ids.shape == (M,)
            assert ids.dtype == (torch.int64 if ids64 else torch.int32)
            assert ct.dtype == torch.float32 and ct.is_contiguous()
            assert ct.shape == ((F, M) if fmajor else (M, F))
            if kind == "one_id":
                assert (ids == ids[0]).all()
            if kind == "out_of_range":
                assert (ids < 0).any() and (ids >= t_eff).any()
            out = tdtab.dtab_plain(ids, ct, t_eff, fmajor)
            assert out.shape == ((F, t_eff) if fmajor else (t_eff, F))
            keep = ((ids >= 0) & (ids < t_eff)).numpy()
            rows = (ct.t() if fmajor else ct).numpy()[keep]
            ref = np.zeros((t_eff, F))
            np.add.at(ref, ids.numpy()[keep], rows.astype(np.float64))
            got = (out.t() if fmajor else out).numpy()
            assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(),
                                                          1.0)


@pytest.mark.parametrize("kind", sorted(dtab_cases.BATCHED_CASES))
def test_batched_edge_cases_and_their_plain_version(kind):
    """The edge cases the card holds B4 to (`utils/dtab_cases.py`), built on
    the CPU with int64 and int32 ids: their shapes, types and out-of-range
    ids, and `dtab_batched_plain` against numpy's `add.at` over each level's
    ids in [0, T) in float64, level by level, within 1e-5 of the level's
    largest entry: nothing wraps onto a row or spills into the next level."""
    L, T, F, M = dtab_cases.BATCHED_CASES[kind]
    for ids64 in (True, False):
        ids, ct, t = dtab_cases.batched_edge_case(kind, "cpu", ids64)
        assert t == T and ids.shape == (L, M) and ct.shape == (L, M, F)
        assert ids.dtype == (torch.int64 if ids64 else torch.int32)
        assert ct.dtype == torch.float32 and ct.is_contiguous()
        keep = ((ids >= 0) & (ids < T)).numpy()
        if kind == "out_of_range":
            assert keep[0].all() and keep[2].all() and not keep[1].all()
            far = ids[1].numpy()[~keep[1]]
            if ids64:
                assert set(far) == {-(2 ** 40), -1, T, T + 2 ** 32}
            else:
                assert set(far) == {-(2 ** 31), -1, T, 2 ** 31 - 1}
        else:
            assert keep.all()
        if kind == "one_id":
            assert (ids[1] == ids[1, 0]).all()
        out = tdtab.dtab_batched_plain(ids, ct, T)
        assert out.shape == (L, T, F) and out.dtype == torch.float32
        for l in range(L):
            ref = np.zeros((T, F))
            np.add.at(ref, ids[l].numpy()[keep[l]],
                      ct[l].numpy()[keep[l]].astype(np.float64))
            err = np.abs(out[l].numpy() - ref).max()
            assert err <= 1e-5 * max(np.abs(ref).max(), 1.0), (l, err)


def test_kernel_ids_are_never_narrowed():
    """The kernels' id operand keeps int64 ids at their width (a cast to
    int32 would send -2^40 to row 0 and 2^32 + 5 to row 5), keeps int32 as
    it is and widens other integer types to int64, without a copy where the
    ids are contiguous and int32 or int64."""
    wide = torch.tensor([-(2 ** 40), 2 ** 32 + 5, 3])
    ids, ids64 = tdtab._ids(wide)
    assert ids64 == 1 and ids is wide
    narrow = wide[2:].to(torch.int32)
    ids, ids64 = tdtab._ids(narrow)
    assert ids64 == 0 and ids is narrow
    ids, ids64 = tdtab._ids(torch.tensor([1, 2], dtype=torch.int16))
    assert ids64 == 1 and ids.dtype == torch.int64
    ids, ids64 = tdtab._ids(torch.arange(6).reshape(2, 3).t())
    assert ids.is_contiguous() and ids64 == 1


@pytest.mark.parametrize("fmajor", [True, False])
def test_plain_drops_out_of_range_ids_as_jax(fmajor, monkeypatch):
    """The router on CPU tensors (the plain version) drops ids outside
    [0, t_eff), int64 ones at -2^40 included, as the JAX package's
    `_matmul_dtab` does on the CPU (float32 operands), within 1e-6; the JAX
    side takes the ids clipped to int32, both still out of range."""
    from spnerf_tpu.models.hashgrid import _matmul_dtab

    monkeypatch.setenv("SPNERF_HASH_MATMUL_F32", "1")
    t_eff, F = 8, 4
    ids = np.array([0, 1, 8, -1, -(2 ** 40)])
    ct = np.random.default_rng(0).normal(size=(len(ids), F)).astype(
        np.float32)
    ct_in = np.ascontiguousarray(ct.T) if fmajor else ct
    ref = np.asarray(_matmul_dtab(
        jnp.asarray(np.clip(ids, -(2 ** 31), 2 ** 31 - 1).astype(np.int32)),
        jnp.asarray(ct_in), t_eff, F, fmajor=fmajor))
    want = np.zeros((t_eff, F), np.float32)
    want[0], want[1] = ct[0], ct[1]
    np.testing.assert_allclose(ref.T if fmajor else ref, want, atol=1e-6)
    for id_dtype in (torch.int64, torch.int32):
        t_ids = torch.from_numpy(np.clip(ids, -(2 ** 31), 2 ** 31 - 1)
                                 if id_dtype == torch.int32 else ids)
        out = tdtab.dtab(t_ids.to(id_dtype), torch.from_numpy(ct_in), t_eff,
                         F, fmajor=fmajor)
        assert out.shape == ((F, t_eff) if fmajor else (t_eff, F))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
