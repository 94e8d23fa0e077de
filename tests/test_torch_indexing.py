"""The port's indexing against heat_tpu on the same seeded numpy inputs:
the key dispatch of ``DNDarray.__getitem__``/``__setitem__`` (split-axis
integer arrays and masks through the ring programs, mixed and paired keys,
split-axis slices through one window fetch, ``None``/``...``, the general
path), ``indexing.py`` (nonzero, where, take, compress, extract,
trim_zeros, unravel_index, ravel_multi_index, indices, take_along_axis,
put_along_axis), the balance and redistribute no-ops, and the four repaired
rounding and statistics faults.

One table of cases runs twice: in process at world size 1 against heat_tpu
on one device, and in ONE spawned 2-rank gloo world shared by the module
against heat_tpu on two devices (``TPUCommunication(jax.devices()[:2])``),
whose dispatch takes the same routes. The shapes split unevenly (7 rows or
5 columns over 2 ranks) and a 1-row array leaves rank 1 empty. Each world-2
case pins its collectives (``comm.stats``): ``x[idx]`` is one ring step,
``x[mask]`` one exclusive scan, one all-reduce and one ring step (heat_tpu
shifts the rows and their positions as two tensors, two steps; the port
packs them into one message), a scatter one ring step, a split-axis slice
written with a value every rank holds none, a window op its rounds of
``permute``; no ring or window route gathers. A split index out of range
on one rank makes every rank raise and write nothing.

Tolerance: every case moves data or compares, so values are bitwise
(``where`` adds a value to an exact zero), with NaN at the same places.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core.communication import TPUCommunication  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
C1 = TPUCommunication(jax.devices()[:1])
C2 = TPUCommunication(jax.devices()[:2])


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
    a = _data("float32", seed=1)
    return {
        "A": (a, 0), "B": (_data("float32", seed=2), 1), "C": (_data("float32", seed=3), None),
        "E": (_data("float32", (1, 5), seed=4), 0), "I": (_data("int32", (7,), seed=5), 0),
        "Bo": (_data("bool", seed=6), 0), "Z": (_data("complex64", (7,), seed=7), 0),
        "T3": (_data("float32", (4, 6, 5), seed=8), 1), "H": (_data("float16", seed=9), 1),
        "IDX": (np.array([6, 0, 3, 3, -1, 2]), 0),
        "V": (_data("float32", (6, 5), seed=10), 0), "Vs1": (_data("float32", (6, 5), seed=11), 1),
        "W2": (_data("float32", (7, 2), seed=12), 0),
        "TZ": (np.array([0, 0, 3, 0, 5, 0, 0], dtype=np.int64), 0),
        "IU": (np.array([0, 34, 17, 5, 12], dtype=np.int64), 0),
        "R1": (np.array([1, 6, 0, 3], dtype=np.int64), 0),
        "R2": (np.array([4, 0, 2, 1], dtype=np.int64), 0),
        "N": (np.array([[1.0, np.nan, -2.0], [np.nan, 0.0, 3.0]], dtype=np.float32), 0),
        "Bb": (np.array([[False, True, False, True], [True, False, True, False]]), 0),
        "K": (np.array([[-7, 7, -3, 5], [3, -2, 9, -8]], dtype=np.int32), 0),
        "S3": (_data("float32", (3, 5), seed=13), 0),
        "OR0": (np.array([9, 0, 1]), 0), "OR1": (np.array([1, 0, 9]), 0),
    }


def _consts():
    """Host data the cases use as keys and values."""
    a = _arrays()["A"][0]
    rng = np.random.default_rng(20)
    return {
        "idx": np.array([6, 0, 3, 3, -1]), "M0": a[:, 0] > 0, "M1": _arrays()["B"][0][0] > 0,
        "R": rng.uniform(-1, 1, 5).astype(np.float32),
        "VM": rng.uniform(-1, 1, (int((a[:, 0] > 0).sum()), 5)).astype(np.float32),
        "V3": rng.uniform(-1, 1, (3, 5)).astype(np.float32),
        "ARGS": np.argsort(a, 1), "ARG1": np.argsort(a, 1)[:, :2],
    }


def _build_env(lib, kw, arrays, consts):
    env = {"lib": lib, "np": np, **consts}
    for name, (a, split) in arrays.items():
        env[name] = lib.array(a, split=split, **kw)

    def setit(x, key, value):
        y = lib.copy(x)
        y[key] = value
        return y

    def putalong(x, idx, values, axis):
        y = lib.copy(x)
        lib.put_along_axis(y, idx, values, axis)
        return y

    def raises(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001
            return type(exc).__name__
        return None

    def setraise(x, key, value):
        """The error of ``y[key] = value`` on a copy, and the copy after it."""
        y = lib.copy(x)

        def write():
            y[key] = value

        return raises(write), y

    def balanced(x):
        y = lib.copy(x)
        y.balance_()
        y.redistribute_(target_map=y.lshape_map)
        return y, x.is_balanced(), lib.balance(x, copy=True), x.redistribute()

    env.update(setit=setit, putalong=putalong, raises=raises, setraise=setraise,
               balanced=balanced)
    return env


# name -> (expression, collectives at world size 2): the expression runs
# with ``lib`` the port (in the world, and in process at world size 1) and
# heat_tpu (on two devices, and on one)
CASES = {
    # getitem: the ring programs
    "rows_idx": ("A[idx]", {"ring_step": 1}),
    "rows_idx_split_index": ("A[IDX]", {"ring_step": 1}),
    "cols_idx_split1": ("B[:, idx % 5]", {"ring_step": 1}),
    "rows_idx_half": ("H[:, np.array([4, 0, 4])]", {"ring_step": 1}),
    "rows_mask": ("A[M0]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "rows_mask_dndarray": ("A[A[:, 0] > 0]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "cols_mask_split1": ("B[:, M1]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "mask_empty_rank": ("E[np.array([True])]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "mask_none_kept": ("A[A[:, 0] > 99]", {"exscan": 1, "all_reduce": 1}),
    "mask_complex": ("Z[lib.real(Z) > 0]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "mask_int": ("I[I > 0]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "mask_bool_data": ("Bo[M0]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "mixed_slice": ("A[idx, 2:4]", {"ring_step": 1}),
    "mixed_int": ("T3[1, np.array([5, 0, 2])]", {"ring_step": 1}),
    "mixed_off_split": ("B[idx, :]", {}),
    "mixed_mask": ("A[M0, 1]", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "paired": ("A[[1, 2, 6], [0, 4, 2]]", {"permute": 2, "ring_step": 1}),
    # getitem: window fetch, shard-local, general
    "step_slice": ("A[1::3]", {"permute": 1}),
    "neg_step_slice": ("A[::-2, 1:4]", {"permute": 1}),
    "slice_split1": ("B[:, 3:]", {"permute": 2}),
    "int_split": ("A[3]", {"all_gather": 1}),
    "int_int_split1": ("B[2, 3]", {"all_gather": 1}),
    "int_off_split": ("B[2]", {}),
    "newaxis": ("A[..., None]", {}),
    "newaxis_front": ("B[None, 1:3, :]", {}),
    "newaxis_general": ("B[None, :, 1:3]", {"all_gather": 1}),
    "ellipsis_int": ("T3[..., 2]", {}),
    "mask_2d": ("A[A > 0]", {"all_gather": 2}),
    "raises_out_of_range": ("raises(lambda: A[np.array([9])])", None),
    "raises_int_out_of_range": ("raises(lambda: A[7])", None),
    # a split index out of range on one rank: every rank raises, nothing is written
    "raises_split_index_out_of_range": ("raises(lambda: A[OR1])", {"ring_step": 1}),
    "raises_set_split_index": ("setraise(A, OR0, -1.0)", {"ring_step": 1}),
    "raises_set_mixed_split_index": ("setraise(A, (OR1, slice(1, 3)), 0.5)", {"ring_step": 1}),
    # indexing.py
    "nonzero": ("lib.nonzero(A > 0.5)", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "nonzero_split1": ("lib.nonzero(B > 0.5)",
                       {"all_to_all": 1, "exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "nonzero_method": ("(Bo).nonzero()", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "where_scalar": ("lib.where(A > 0, A, 0.0)", {}),
    "where_int_zero": ("lib.where(A > 0, A, 0)", {}),
    "where_int": ("lib.where(I > 0, I, 0)", {}),
    "where_bool": ("lib.where(Bo, Bo, False)", {}),
    "where_arrays": ("lib.where(A > 0, A, C)", {}),
    "where_one_arg": ("lib.where(I > 0)", {"exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "take_axis0": ("lib.take(A, idx, 0)", {"ring_step": 1}),
    "take_flat": ("lib.take(A, np.array([0, 34, 17]))", {"permute": 2, "ring_step": 1}),
    "compress": ("lib.compress(M0, A, 0)", {"ring_step": 1}),
    "extract": ("lib.extract(A > 0, A)",
                {"permute": 4, "exscan": 1, "all_reduce": 1, "ring_step": 1}),
    "trim_zeros": ("lib.trim_zeros(TZ)", None),
    "unravel_index": ("lib.unravel_index(IU, (5, 7))", None),
    "ravel_multi_index": ("lib.ravel_multi_index((R1, R2), (7, 5))", None),
    "indices": ("lib.indices((3, 4), split=0)", {}),
    "take_along_axis": ("lib.take_along_axis(A, ARGS, 1)", None),
    "take_along_split_axis": ("lib.take_along_axis(B, ARGS, 1)", None),
    "take_along_partial": ("lib.take_along_axis(A, ARG1, 1)", None),
    "put_along_axis": ("putalong(A, ARG1, 0.5, 1)", None),
    # setitem
    "set_idx": ("setit(A, idx, -1.0)", {"ring_step": 1}),
    "set_idx_rows": ("setit(A, np.array([2, 5, 0]), V3)", {"ring_step": 1}),
    "set_idx_duplicates": ("setit(A, np.array([2, 5, 2]), V3)", {"ring_step": 1}),
    "set_idx_split_value": ("setit(A, np.array([6, 0, 3, 1, 2, 4]), V)", {"ring_step": 1}),
    "set_idx_value_split1": ("setit(A, np.array([6, 0, 3, 1, 2, 4]), Vs1)",
                             {"all_to_all": 1, "ring_step": 1}),
    "set_cols_split1": ("setit(B, (slice(None), np.array([4, 0])), 2.5)", {"ring_step": 1}),
    "set_mask_scalar": ("setit(A, M0, 7.0)", {}),
    "set_mask_row": ("setit(A, M0, R)", {}),
    "set_mask_varying": ("setit(A, M0, VM)", {"ring_step": 1}),
    "set_slice_step": ("setit(A, slice(1, 6, 2), -2.0)", {}),
    "set_slice_sub": ("setit(A, (slice(2, 6), 1), 7.0)", {}),
    "set_slice_neg_step_rows": ("setit(A, (slice(None, None, -3), slice(1, 4)), V3[:, 1:4])", {}),
    "set_slice_split_value": ("setit(A, slice(6, 0, -2), S3)", {"ring_step": 1}),
    "set_int_row": ("setit(A, 3, R)", {}),
    "set_int_replicated_value": ("setit(A, (4, slice(0, 2)), C[4, :2])", {}),
    "set_mixed": ("setit(A, (idx, slice(1, 3)), 0.5)", {"ring_step": 2}),
    "set_kept_split_value": ("setit(A, (slice(None), slice(1, 3)), W2)", {}),
    "set_kept_replicated_value": ("setit(A, (slice(None), 2), C[:, 2])", {}),
    "set_newaxis": ("setit(B, (Ellipsis, None), 1.5)", {}),
    "set_empty_rank": ("setit(E, np.array([0]), 4.0)", {"ring_step": 1}),
    # balance / redistribute
    "balance": ("balanced(A)", {}),
    "redistribute_raises": ("raises(lambda: A.redistribute_(target_map=np.array([[5, 5], "
                            "[2, 5]])))", None),
    # the repaired faults
    "sign_nan": ("lib.sign(N)", {}),
    "round_int_negative_decimals": ("raises(lambda: lib.round(K, -1))", None),
    "argmax_bool_off_split": ("lib.argmax(Bb, 1)", {}),
    "argmin_bool_split": ("lib.argmin(Bb, 0)", None),
    "clip_int_float_bounds": ("lib.clip(K, -1.5, 2.5)", {}),
    "clip_int_float_max": ("lib.clip(K, None, 2.5)", {}),
}


def _pack(v):
    if isinstance(v, tuple):
        return tuple(_pack(u) for u in v)
    if hasattr(v, "lshape_map") and hasattr(v, "gshape"):  # a DNDarray of either package
        vals = np.asarray(v.numpy())
        return {"values": vals.astype(np.float32) if vals.dtype.name == "bfloat16" else vals,
                "dtype": v.dtype.__name__, "gshape": tuple(v.gshape), "split": v.split,
                "lshape_map": np.asarray(v.lshape_map)}
    return v


def _same(got, want, lmap=None):
    """A packed port result against a packed heat_tpu one: type, gshape,
    split, lshape_map (heat_tpu's for its mesh, or ``lmap``), values
    bitwise."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same(g, w, lmap)
        return
    if not isinstance(want, dict):
        assert got == want, (got, want)
        return
    assert got["dtype"] == want["dtype"], (got["dtype"], want["dtype"])
    assert got["gshape"] == want["gshape"], (got["gshape"], want["gshape"])
    assert got["split"] == want["split"], (got["split"], want["split"])
    np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
    np.testing.assert_array_equal(got["values"], want["values"])


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
        _ENVS[comm] = _build_env(hj, {"comm": comm}, _arrays(), _consts())
    return _on_mesh(_pack(eval(expr, dict(_ENVS[comm]))), comm)  # noqa: S307


@pytest.fixture(scope="module", autouse=True)
def references():
    """heat_tpu's result of every case on both meshes, computed in a pool
    of threads from the module's start (XLA compiles outside the GIL; the
    compiles are most of this module's time); a test waits for its own."""
    from concurrent.futures import ThreadPoolExecutor

    for comm in (C1, C2):
        _heat_tpu("None", comm)  # the arrays, before the threads share them
    pool = ThreadPoolExecutor(max_workers=min(6, os.cpu_count() or 1))
    for comm in (C1, C2):
        for case in CASES:
            _REFS[case, comm] = pool.submit(_heat_tpu, CASES[case][0], comm)
    yield
    pool.shutdown(cancel_futures=True)
    _REFS.clear()


def _reference(case, comm):
    return _REFS[case, comm].result()


@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_heat_tpu(case):
    expr, _ = CASES[case]
    ht.get_comm().reset_stats()
    got = _pack(eval(expr, _build_env(ht, {}, _arrays(), _consts())))  # noqa: S307
    assert ht.get_comm().stats == {}
    _same(got, _reference(case, C1))


# --------------------------------------------------------------------------- #
# one 2-rank gloo world for the module                                        #
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
res = {}
for name, expr in spec["cases"].items():
    env = _build_env(ht, {}, spec["arrays"], spec["consts"])
    comm.reset_stats()
    r = eval(expr, env)
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
    spec = {"arrays": _arrays(), "consts": _consts(),
            "cases": {k: v[0] for k, v in CASES.items()}}
    handle = start_world(tmp_path_factory.mktemp("indexing_world2"), spec, 2)
    yield handle
    for p in handle[1]:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def world2(started):
    return finish_world(started)


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_heat_tpu(world2, case):
    expr, counts = CASES[case]
    got, stats = world2[case]
    _same(got, _reference(case, C2))
    if counts is not None:
        assert stats == counts, (stats, counts)


def test_scatter_duplicates_resolve_in_rotation_order():
    """Duplicate positions of one scatter: within a block the last
    occurrence wins, across blocks the block rank r applies last (heat_tpu
    ``_indexing.py:19-21``); at world size 1 the last occurrence."""
    a = _arrays()["A"][0]
    x = ht.array(a, split=0)
    x[np.array([2, 5, 2])] = ht.array(np.array([[1.0] * 5, [2.0] * 5, [3.0] * 5],
                                               dtype=np.float32))
    want = a.copy()
    want[5], want[2] = 2.0, 3.0
    np.testing.assert_array_equal(x.numpy(), want)
