"""The port's manipulations against heat_tpu on the same seeded numpy
inputs: every name of heat_tpu's ``manipulations.__all__`` but sorting,
``topk`` and the set operations; ``diff``/``ediff1d``; the factories, the
type helpers and the random draws the port lacked; and the window-fetch
scheduler.

One table of cases runs twice: in process at world size 1 against heat_tpu
on one device, and in ONE spawned 3-rank gloo world shared by the module
against heat_tpu on three devices (``TPUCommunication(jax.devices()[:3])``).
Three ranks are the smallest world whose window-fetch rounds hold moves
that are neither the identity nor a swap. The shapes split unevenly (7
rows over 3 ranks: 3, 3, 1; 10 rows: 4, 4, 2) and a 1-row array leaves
ranks 1 and 2 empty. Each world-3 case pins its collectives: a window op
makes exactly as many ``permute`` rounds as heat_tpu's
``_schedule_block_fetch`` gives on the same demands (read from heat_tpu's
own functions), and no ring or window route gathers. The scheduler test
holds the port's copy of the plan against heat_tpu's, round for round, at
p = 2, 3, 4 and 8.

Tolerance: bitwise, as every case moves data, subtracts once (``diff``),
fills or ramps; ``linspace``/``logspace`` within 4 ulp of the result type
(the elementwise functions' contract), a float ``mean`` pad within 4 ulp (its
sum's order), and the random draws are held to the port's own
contract (world-size invariant, in range, a permutation), not to heat_tpu's
bits.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core import _manips as hjm  # noqa: E402
from heat_tpu.core.communication import TPUCommunication  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import _manips as tm  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
C1 = TPUCommunication(jax.devices()[:1])
C3 = TPUCommunication(jax.devices()[:3])
WORLD = 3


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _data(dtype, shape=(7, 5), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype in ("int32", "int64"):
        return rng.integers(-4, 5, shape).astype(dtype)
    x = rng.uniform(-3, 3, shape)
    if dtype == "complex64":
        return (x + 1j * rng.uniform(-3, 3, shape)).astype(np.complex64)
    return x.astype(dtype)


def _arrays():
    """name -> (data, split) of the world arrays."""
    return {
        "A": (_data("float32", seed=1), 0), "B": (_data("float32", seed=2), 1),
        "C": (_data("float32", seed=3), None), "E": (_data("float32", (1, 5), seed=4), 0),
        "F": (_data("float32", (4, 5), seed=5), 0), "V": (_data("float32", (10,), seed=6), 0),
        "I": (_data("int32", seed=7), 0), "Vb": (_data("bool", (10,), seed=8), 0),
        "Z": (_data("complex64", (7,), seed=9), 0), "T3": (_data("float32", (4, 6, 5), seed=10), 1),
        "W5": (_data("float32", (5,), seed=11), 0), "R": (_data("float32", (5,), seed=12), None),
    }


def _build_env(lib, kw, arrays):
    env = {"lib": lib, "np": np}
    for name, (a, split) in arrays.items():
        env[name] = lib.array(a, split=split, **kw)

    def meta(x):
        return tuple(x.gshape), x.split, x.dtype.__name__

    def draws(lib):
        """The port's draws after one seed: at any world size the same."""
        lib.random.seed(7)
        x = lib.array(np.arange(28.0).reshape(7, 4), split=0)
        state = lib.random.get_state()
        out = (lib.random.rand(7, 3, split=0), lib.random.randn(9, split=0),
               lib.random.randint(-5, 5, (6, 2), split=1),
               lib.random.uniform(-2.0, 3.0, (7, 3), split=0),
               lib.random.normal(1.0, 2.0, (5, 4), split=1),
               lib.random.random_sample((4, 7), split=1),
               lib.random.standard_normal((3, 3)), lib.random.randperm(11, split=0),
               lib.random.permutation(x), lib.random.permutation(9))
        lib.random.set_state(state)
        return out + (lib.random.rand(7, 3, split=0), state[1:3])

    env.update(meta=meta, draws=draws)
    return env


def _rounds(kind, *args, p=WORLD):
    """The rounds heat_tpu's own program builder schedules for a window op
    on ``p`` devices (its jitted program is built, never compiled): a list
    per call of ``_schedule_block_fetch``."""
    got = []
    schedule = hjm._schedule_block_fetch
    me = threading.get_ident()

    def capture(demands, p_):
        rounds = schedule(demands, p_)
        if threading.get_ident() == me:  # not a reference computed beside it
            got.append([(list(perm), table.tolist()) for perm, table in rounds])
        return rounds

    comm = C3 if p == WORLD else TPUCommunication(jax.devices()[:p])
    saved = (hjm._schedule_block_fetch, dict(hjm._MANIP_CACHE))
    hjm._schedule_block_fetch = capture
    hjm._MANIP_CACHE.clear()
    try:
        c = lambda n: -(-n // p)  # noqa: E731
        f32 = jnp.dtype(jnp.float32)
        if kind == "roll":
            n, shift = args
            hjm.ring_roll_fn((c(n) * p, 2), f32, 0, n, shift, comm)
        elif kind == "flip":
            (n,) = args
            hjm.ring_flip_fn((c(n) * p, 2), f32, 0, n, comm)
        elif kind == "concat":
            ns = args[0]
            hjm.ring_concat_fn([(c(m) * p, 2) for m in ns], f32, 0, list(ns), c(sum(ns)), comm)
        elif kind == "repeat":
            n, rep = args
            hjm.ring_repeat_fn((c(n) * p, 2), f32, 0, n, rep, c(n * rep), comm)
        elif kind == "slice":
            n, start, step, length = args
            hjm.ring_slice_fn((c(n) * p, 2), f32, 0, start, step, length, c(length), comm)
        elif kind == "pad":
            n, before, after, mode = args
            hjm.ring_pad_fn((c(n) * p, 2), f32, 0, n, before, after, mode, comm)
        elif kind == "diff":
            (n,) = args
            hjm.split_diff_fn((c(n) * p, 2), f32, 0, n, comm)
        elif kind == "reshape":
            rows_in, row_in, rows_out, row_out = args
            hjm.ring_reshape_fn((c(rows_in) * p, row_in), f32, (rows_out, row_out),
                                c(rows_out), comm)
    finally:
        hjm._schedule_block_fetch = saved[0]
        hjm._MANIP_CACHE.clear()
        hjm._MANIP_CACHE.update(saved[1])
    return got


def _permutes(*ops):
    """heat_tpu's number of rounds for window ops at p = 3, as the
    collective count of a case."""
    return {"permute": sum(len(r) for op in ops for r in _rounds(*op))}


# name -> (expression, collectives at world size 3, options)
CASES = {
    # concatenation and stacking
    "concat_split0": ("lib.concatenate([A, F], 0)", _permutes(("concat", (7, 4)))),
    "concat_split1": ("lib.concatenate([B, B], 1)", _permutes(("concat", (5, 5)))),
    "concat_nonsplit_axis": ("lib.concatenate([A, A], 1)", {}),
    "concat_replicated": ("lib.concatenate([A, C], 0)", _permutes(("concat", (7, 7)))),
    "concat_empty_ranks": ("lib.concatenate([E, A, E], 0)", _permutes(("concat", (1, 7, 1)))),
    "concat_types": ("lib.concatenate([I, A], 0)", _permutes(("concat", (7, 7)))),
    "stack_axis1": ("lib.stack([A, A], 1)", {}),
    "stack_axis0": ("lib.stack([A, I], 0)", {}),
    "stack_mixed": ("lib.stack([B, C], 2)", {"all_gather": 1}),
    "hstack_1d": ("lib.hstack([V, V])", _permutes(("concat", (10, 10)))),
    "vstack": ("lib.vstack([A, F])", _permutes(("concat", (7, 4)))),
    "column_stack": ("lib.column_stack([V, V])", {}),
    "row_stack": ("lib.row_stack([A, E])", _permutes(("concat", (7, 1)))),
    "dstack": ("lib.dstack([A, A])", {}),
    # reshape family
    "reshape_ring": ("lib.reshape(A, (5, 7))", _permutes(("reshape", 7, 5, 5, 7))),
    "reshape_local": ("A.reshape(7, 5, 1)", {}),
    "reshape_new_split": ("lib.reshape(T3, (24, 5), new_split=1)",
                          {"all_to_all": 2, **_permutes(("reshape", 4, 30, 24, 5))}),
    "flatten": ("lib.flatten(A)", _permutes(("reshape", 7, 5, 35, 1))),
    "ravel_split1": ("B.ravel()", {"all_to_all": 1, **_permutes(("reshape", 7, 5, 35, 1))}),
    "squeeze_split_axis": ("lib.squeeze(E)", {"all_gather": 1}),
    "squeeze_other": ("T3[:, :, 2:3].squeeze(2)", {}),
    "expand_dims": ("lib.expand_dims(A, 0)", {}),
    "expand_dims_method": ("B.expand_dims(-1)", {}),
    # flips, rolls, rotations
    "flip_split": ("lib.flip(A, 0)", _permutes(("flip", 7))),
    "flip_all": ("A.flip()", _permutes(("flip", 7))),
    "flip_nonsplit": ("lib.flip(B, 0)", {}),
    "fliplr_split": ("lib.fliplr(B)", _permutes(("flip", 5))),
    "flipud_empty_ranks": ("lib.flipud(E)", _permutes(("flip", 1))),
    "roll_split": ("lib.roll(A, 3, 0)", _permutes(("roll", 7, 3))),
    "roll_negative": ("lib.roll(A, -9, 0)", _permutes(("roll", 7, -9 % 7))),
    "roll_two_axes": ("lib.roll(B, (2, 1), (0, 1))", _permutes(("roll", 5, 1))),
    "roll_flat_1d": ("lib.roll(V, 4)", _permutes(("roll", 10, 4))),
    "roll_flat_2d": ("lib.roll(A, 2)", {"all_gather": 1}),
    "rot90": ("lib.rot90(A)", {}),
    "rot90_k2": ("lib.rot90(A, 2)", _permutes(("flip", 7))),
    "rot90_k3": ("lib.rot90(A, 3)", _permutes(("flip", 5))),
    "rot90_axes": ("B.rot90(1, (1, 0))", {}),
    "swapaxes": ("lib.swapaxes(A, 0, 1)", {}),
    "swapaxes_method": ("T3.swapaxes(0, 2)", {}),
    "moveaxis": ("lib.moveaxis(T3, 0, -1)", {}),
    # pads
    "pad_constant": ("lib.pad(A, ((1, 2), (0, 1)))",
                     _permutes(("concat", (1, 7, 2)))),
    "pad_constant_value": ("lib.pad(B, ((2, 0), (1, 3)), constant_values=-1.5)",
                           _permutes(("concat", (1, 5, 3)))),
    "pad_edge": ("lib.pad(A, 2, mode='edge')", _permutes(("pad", 7, 2, 2, "edge"))),
    "pad_reflect": ("lib.pad(A, ((3, 2), (1, 1)), mode='reflect')",
                    _permutes(("pad", 7, 3, 2, "reflect"))),
    "pad_symmetric": ("lib.pad(B, ((1, 1), (2, 3)), mode='symmetric')",
                      _permutes(("pad", 5, 2, 3, "symmetric"))),
    "pad_wrap": ("lib.pad(A, ((9, 4), (0, 0)), mode='wrap')",
                 _permutes(("pad", 7, 9, 4, "wrap"))),
    "pad_empty_ranks": ("lib.pad(E, ((2, 1), (0, 0)))", _permutes(("concat", (2, 1, 1)))),
    "pad_empty_mode": ("lib.pad(A, ((1, 0), (0, 2)), mode='empty')",
                       _permutes(("concat", (1, 7)))),
    "pad_constant_pairs": ("lib.pad(A, ((1, 2), (3, 0)), constant_values=((-1.0, 2.0), "
                           "(5.0, 7.5)))", {"all_gather": 1}),
    "pad_linear_ramp": ("lib.pad(A, ((2, 3), (1, 2)), mode='linear_ramp')", {"all_gather": 1}),
    "pad_linear_ramp_int": ("lib.pad(I, ((0, 0), (1, 3)), mode='linear_ramp')", {}),
    "pad_maximum": ("lib.pad(B, ((1, 2), (0, 0)), mode='maximum')", {}),
    "pad_minimum": ("lib.pad(A, 2, mode='minimum')", {"all_gather": 1}),
    "pad_mean": ("lib.pad(A, ((1, 1), (2, 0)), mode='mean')", {"all_gather": 1}, {"ulps": 4}),
    "pad_mean_int": ("lib.pad(I, ((0, 0), (2, 1)), mode='mean')", {}),
    "pad_median": ("lib.pad(I, ((2, 1), (1, 1)), mode='median')", {"all_gather": 1}),
    "pad_median_float": ("lib.pad(B, ((0, 0), (2, 2)), mode='median')", {"all_gather": 1}),
    # repeat and tile
    "repeat_split": ("lib.repeat(A, 2, 0)", _permutes(("repeat", 7, 2))),
    "repeat_nonsplit": ("lib.repeat(A, 3, 1)", {}),
    "repeat_1d": ("lib.repeat(V, 2)", _permutes(("repeat", 10, 2))),
    "repeat_flat": ("lib.repeat(A, 2)", _permutes(("reshape", 7, 5, 35, 1), ("repeat", 35, 2))),
    "repeat_counts": ("lib.repeat(A, np.array([1, 0, 2, 1, 3, 0, 1]), 0)", {"ring_step": 2}),
    "tile_split": ("lib.tile(A, (2, 1))", _permutes(("concat", (7, 7)))),
    "tile_other": ("lib.tile(B, (2, 1))", {}),
    "tile_scalar": ("lib.tile(A, 2)", {}),
    "tile_new_axes": ("lib.tile(V, (2, 2))", {"all_gather": 1}),
    # diagonals
    "diag_construct": ("lib.diag(V)", {}),
    "diag_construct_offset": ("lib.diag(W5, 2)", _permutes(("concat", (5, 2)))),
    "diag_construct_negative": ("lib.diag(W5, -1)", _permutes(("concat", (1, 5)))),
    "diagonal": ("lib.diagonal(A)", {"exscan": 1, "all_reduce": 1, "ring_step": 2}),
    "diagonal_offset": ("lib.diagonal(A, 1)", {"exscan": 1, "all_reduce": 1, "ring_step": 2}),
    "diagonal_split1": ("lib.diagonal(B, -2)", {}),
    "diag_of_matrix": ("lib.diag(C, 1)", {}),
    # broadcasting, splitting
    "broadcast_to": ("lib.broadcast_to(V, (3, 10))", {}),
    "broadcast_arrays": ("lib.broadcast_arrays(A, R)", {}),
    "split": ("lib.split(A, [2, 5], 0)", {"all_gather": 1}),
    "array_split": ("lib.array_split(B, 3, 1)", {"all_gather": 1}),
    "vsplit": ("lib.vsplit(A, [3])", {"all_gather": 1}),
    "hsplit": ("lib.hsplit(B, [1, 4])", {"all_gather": 1}),
    "dsplit": ("lib.dsplit(T3, [2])", {"all_gather": 1}),
    "shape": ("lib.shape(A)", {}),
    "resplit": ("lib.resplit(A, 1)", {"all_to_all": 1}),
    # differences
    "diff_split": ("lib.diff(A, axis=0)", _permutes(("diff", 7))),
    "diff_twice": ("lib.diff(A, 2, axis=0)", _permutes(("diff", 7), ("diff", 6))),
    "diff_nonsplit": ("lib.diff(A, axis=1)", {}),
    "diff_prepend_append": ("lib.diff(V, prepend=0.5, append=V[:2])",
                            _permutes(("slice", 10, 0, 1, 2), ("concat", (1, 10)),
                                      ("concat", (11, 2)), ("diff", 13))),
    "diff_bool": ("lib.diff(Vb)", _permutes(("diff", 10))),
    "diff_short_axis": ("lib.diff(E, axis=0)", {"all_gather": 1}),
    "ediff1d": ("lib.ediff1d(A)", _permutes(("reshape", 7, 5, 35, 1), ("diff", 35))),
    "ediff1d_tails": ("lib.ediff1d(V, to_begin=[-1.0], to_end=np.array([9.0, 8.0]))",
                      _permutes(("diff", 10), ("concat", (1, 9, 2)))),
    # factories
    "full": ("lib.full((7, 4), 2.5, split=0)", {}),
    "full_infer": ("lib.full((7,), 3, dtype=None, split=0)", {}),
    "full_complex": ("lib.full((2, 3), 1 + 2j, split=1)", {}),
    "full_like": ("lib.full_like(A, 1)", {}),
    "zeros_like": ("lib.zeros_like(B)", {}),
    "ones_like": ("lib.ones_like(I, dtype=lib.float64)", {}),
    "empty_like": ("meta(lib.empty_like(T3))", {}),
    "eye": ("lib.eye(7, split=0)", {}),
    "eye_split1": ("lib.eye((5, 8), split=1, dtype=lib.int32)", {}),
    "linspace": ("lib.linspace(-1.0, 2.0, 11, split=0)", {}, {"ulps": 4}),
    "linspace_open": ("lib.linspace(0.0, 5.0, 7, endpoint=False, retstep=True, split=0)", {},
                      {"ulps": 4}),
    "logspace": ("lib.logspace(0.0, 2.0, 7, split=0)", {}, {"ulps": 4}),
    "meshgrid": ("lib.meshgrid(V, W5)", {"all_gather": 1}),
    "meshgrid_ij": ("lib.meshgrid(W5, V, np.arange(3.0), indexing='ij')", {"all_gather": 1}),
    "tri": ("lib.tri(5, 7, 1, split=0)", {}),
    "tril_indices": ("lib.tril_indices(5, 1, split=0)", {}),
    "triu_indices": ("lib.triu_indices(4, -1, 6)", {}),
    "vander": ("lib.vander(W5, 4)", {}),
    "asarray": ("lib.asarray(np.arange(6.0), is_split=0)", {}),
    "from_partitioned": ("lib.from_partitioned(np.arange(4))", {}),
    # type helpers
    "heat_type_of": ("(lib.heat_type_of(A).__name__, lib.heat_type_of(3).__name__, "
                     "lib.heat_type_of([1.5]).__name__)", {}),
    "issubdtype": ("(lib.issubdtype(lib.int32, lib.integer), lib.issubdtype(lib.float32, "
                   "lib.integer), lib.issubdtype('f', lib.float32), "
                   "lib.heat_type_is_inexact(lib.float16), "
                   "lib.heat_type_is_complexfloating(lib.complex64))", {}),
    "iscomplex": ("(lib.iscomplex(Z), lib.isreal(Z), lib.iscomplex(A))", {}),
}


def _pack(v):
    if isinstance(v, (tuple, list)):
        return tuple(_pack(u) for u in v)
    if hasattr(v, "lshape_map") and hasattr(v, "gshape"):  # a DNDarray of either package
        vals = np.asarray(v.numpy())
        return {"values": vals.astype(np.float32) if vals.dtype.name == "bfloat16" else vals,
                "dtype": v.dtype.__name__, "gshape": tuple(v.gshape), "split": v.split,
                "lshape_map": np.asarray(v.lshape_map)}
    return v


def _same(got, want, ulps=0):
    """A packed port result against a packed heat_tpu one: type, gshape,
    split, lshape_map, values bitwise (or within ``ulps`` ulp)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same(g, w, ulps)
        return
    if not isinstance(want, dict):
        assert got == want or (isinstance(want, float) and abs(got - want) <= 1e-6 * abs(want)), \
            (got, want)
        return
    assert got["dtype"] == want["dtype"], (got["dtype"], want["dtype"])
    assert got["gshape"] == want["gshape"], (got["gshape"], want["gshape"])
    assert got["split"] == want["split"], (got["split"], want["split"])
    np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
    g, w = got["values"], want["values"]
    if ulps:
        np.testing.assert_array_max_ulp(g, w, ulps)
    else:
        np.testing.assert_array_equal(g, w)


def _on_mesh(v, comm):
    """A packed heat_tpu result with the lshape_map of ``comm``'s mesh (a
    factory without a ``comm`` argument makes its array on heat_tpu's
    default mesh)."""
    if isinstance(v, tuple):
        return tuple(_on_mesh(u, comm) for u in v)
    if isinstance(v, dict):
        v = dict(v, lshape_map=comm.lshape_map(v["gshape"], v["split"]))
    return v


_ENVS = {}
_REFS = {}


def _heat_tpu(expr, comm):
    """``expr`` evaluated by heat_tpu on ``comm``'s mesh (the arrays are
    made once per mesh: no case writes into them)."""
    if comm not in _ENVS:
        _ENVS[comm] = _build_env(hj, {"comm": comm}, _arrays())
    return _on_mesh(_pack(eval(expr, dict(_ENVS[comm]))), comm)  # noqa: S307


@pytest.fixture(scope="module", autouse=True)
def references():
    """heat_tpu's result of every case on both meshes, computed in a pool
    of threads from the module's start (XLA compiles outside the GIL; the
    compiles are most of this module's time); a test waits for its own."""
    from concurrent.futures import ThreadPoolExecutor

    for comm in (C1, C3):
        _heat_tpu("None", comm)  # the arrays, before the threads share them
    pool = ThreadPoolExecutor(max_workers=min(6, os.cpu_count() or 1))
    for comm in (C1, C3):
        for case in CASES:
            _REFS[case, comm] = pool.submit(_heat_tpu, CASES[case][0], comm)
    yield
    pool.shutdown(cancel_futures=True)
    _REFS.clear()


def _reference(case, comm):
    return _REFS[case, comm].result()


def _opts(case):
    return CASES[case][2] if len(CASES[case]) > 2 else {}


@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_heat_tpu(case):
    expr = CASES[case][0]
    ht.get_comm().reset_stats()
    got = _pack(eval(expr, _build_env(ht, {}, _arrays())))  # noqa: S307
    assert ht.get_comm().stats == {}
    _same(got, _reference(case, C1), _opts(case).get("ulps", 0))


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_block_fetch_plans_equal_heat_tpu(p):
    """The port's copy of ``_demand_blocks``/``_schedule_block_fetch`` and
    each operation's demands give heat_tpu's rounds, pair for pair and
    table for table, over uneven lengths."""
    def ours(rounds):
        return [(list(perm), table.tolist()) for perm, table in rounds]

    for n in (1, 5, 7, 10, 17, 64):
        for shift in (1, n // 2 + 1, 3 * n - 1):
            assert [ours(tm.plan_roll(n, shift % n, p))] == _rounds("roll", n, shift % n, p=p)
        assert [ours(tm.plan_flip(n, p))] == _rounds("flip", n, p=p)
        assert [ours(tm.plan_repeat(n, 3, p))] == _rounds("repeat", n, 3, p=p)
        for ns in ((n, 4), (1, n, 2)):
            assert [ours(r) for r in tm.plan_concat(ns, p)] == _rounds("concat", ns, p=p)
        for start, step in ((1, 3), (n - 1, -2)):
            length = len(range(start, -1 if step < 0 else n, step))
            if length:
                assert [ours(tm.plan_slice(n, start, step, length, p))] == \
                    _rounds("slice", n, start, step, length, p=p)
        for mode in ("edge", "reflect", "symmetric", "wrap"):
            if n > 1 or mode != "reflect":
                assert [ours(tm.plan_pad(n, 2, 5, mode, p))] == \
                    _rounds("pad", n, 2, 5, mode, p=p), mode
        if n > 1:
            assert [ours(tm.plan_diff(n, p))] == _rounds("diff", n, p=p)
        assert [ours(tm.plan_reshape(n, 6, 3 * n, 2, p))] == \
            _rounds("reshape", n, 6, 3 * n, 2, p=p)


def test_random_draws_are_in_range():
    """Shapes, types and ranges of the draws; ``randperm``/``permutation``
    are permutations."""
    env = _build_env(ht, {}, _arrays())
    d = env["draws"](ht)
    rand, randn, randint, uni, norm, sample, std, perm, rows, perm9, again, state = d
    assert rand.shape == (7, 3) and rand.dtype is ht.float32 and rand.split == 0
    r = rand.numpy()
    assert ((r >= 0) & (r < 1)).all() and np.array_equal(r, again.numpy())
    assert randn.shape == (9,) and np.isfinite(randn.numpy()).all()
    ri = randint.numpy()
    assert randint.dtype is ht.int64 and ((ri >= -5) & (ri < 5)).all() and randint.split == 1
    u = uni.numpy()
    assert ((u >= -2) & (u < 3)).all() and uni.dtype is ht.float32
    assert norm.shape == (5, 4) and sample.shape == (4, 7) and std.shape == (3, 3)
    assert sorted(perm.numpy().tolist()) == list(range(11)) and perm.dtype is ht.int64
    assert sorted(perm9.numpy().tolist()) == list(range(9))
    assert sorted(rows.numpy()[:, 0].tolist()) == list(range(0, 28, 4))
    assert state == (7, 0)


# --------------------------------------------------------------------------- #
# one 3-rank gloo world for the module                                        #
# --------------------------------------------------------------------------- #
_WORKER = r'''
import pickle, sys
from datetime import timedelta
import numpy as np
import torch.distributed as dist

rank, world, port, spec_path, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
import heat_tpu_torch as ht

ht.use_device("cpu")
with open(spec_path, "rb") as f:
    spec = pickle.load(f)
exec(spec["src"])
comm = ht.get_comm()
env = _build_env(ht, {}, spec["arrays"])
res = {}
for name, expr in spec["cases"].items():
    comm.reset_stats()
    r = eval(expr, dict(env))
    stats = {k: v["calls"] for k, v in comm.stats.items()}
    res[name] = (_pack(r), stats)
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(res, f)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(tmp, spec, world):
    """Start the worker on ``world`` gloo ranks with ``spec``; the ranks run
    while the module's world-1 tests do."""
    import inspect

    spec = dict(spec, src="\n".join(inspect.getsource(f) for f in (_build_env, _pack)))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    (tmp / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), str(world), port,
                               str(tmp / "spec.pkl"), str(tmp / "out.pkl")],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return tmp, procs


def finish_world(started, timeout=240):
    """The ranks' results; a rank that dies (gloo aborts on mismatched
    sizes) or hangs fails the caller."""
    tmp, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    cases = {k: v[0] for k, v in CASES.items()}
    cases["draws"] = "draws(lib)"
    spec = {"arrays": _arrays(), "cases": cases}
    handle = start_world(tmp_path_factory.mktemp("manipulations_world3"), spec, WORLD)
    yield handle
    for p in handle[1]:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def world3(started):
    return finish_world(started)


@pytest.mark.parametrize("case", list(CASES))
def test_world3_matches_heat_tpu(world3, case):
    expr, counts = CASES[case][:2]
    got, stats = world3[case]
    _same(got, _reference(case, C3), _opts(case).get("ulps", 0))
    assert stats == counts, (stats, counts)


def test_world3_draws_equal_world1(world3):
    """The draws do not depend on the number of ranks: the 3-rank world's
    equal world size 1's, value for value, with heat_tpu's split and a
    3-rank layout."""
    got, _ = world3["draws"]
    want = _pack(_build_env(ht, {}, _arrays())["draws"](ht))
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert (g["dtype"], g["gshape"], g["split"]) == (w["dtype"], w["gshape"], w["split"])
            np.testing.assert_array_equal(g["lshape_map"], C3.lshape_map(w["gshape"],
                                                                          w["split"]))
            np.testing.assert_array_equal(g["values"], w["values"])
        else:
            assert g == w
