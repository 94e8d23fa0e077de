"""The case table of ``test_torch_data.py`` and heat_tpu's side of it.

A module of its own that imports neither the port nor, until a reference is
asked for, heat_tpu, so the processes computing heat_tpu's references start
quickly. ``_build_env(lib, spec, **kw)`` binds the same helpers to the port
(``lib = ht``) or to heat_tpu (``lib = hj``, ``kw`` its mesh).
"""

import numpy as np

from torch_world import pack


def __getattr__(name):
    """``C1`` and ``C2``: heat_tpu communicators of one and two devices."""
    if name in ("C1", "C2"):
        import jax
        from heat_tpu.core.communication import TPUCommunication

        comm = TPUCommunication(jax.devices()[:int(name[1])])
        globals()[name] = comm
        return comm
    raise AttributeError(name)


def _spec():
    rng = np.random.default_rng(15)
    n = 1003
    x = rng.standard_normal(41).astype(np.float32)
    x[[3, 17, 30]] = np.nan
    x[[5, 22]] = np.inf
    x[8] = -np.inf
    x[[11, 12]] = [-0.0, 0.0]
    x[[25, 26, 40]] = x[1]  # ties
    table = np.stack([rng.integers(-1, 6, 300).astype(np.float64),
                      rng.standard_normal(300)], axis=1)
    s32 = rng.standard_normal(300).astype(np.float32)
    s32[[7, 8, 200]] = s32[9]
    spec = {
        "K": rng.integers(-2, 9, n),  # negative and >= G keys are dropped
        "V": rng.standard_normal(n).astype(np.float32),
        "V2": rng.standard_normal((n, 2)),
        "VI": rng.integers(-50, 50, n).astype(np.int32),
        "X": x,
        "XI": rng.integers(-20, 20, 41),
        "LK": rng.integers(-1, 30, 57),  # duplicates and negative keys
        "LV": rng.standard_normal(57).astype(np.float32),
        "RK": rng.permutation(25)[:21].astype(np.int64),  # unique build keys
        "RV": rng.standard_normal(21),
        "T": table,
        "S32": s32,
        "S64": rng.standard_normal(300),
        "SI": rng.integers(-1000, 1000, 300).astype(np.int32),
    }
    spec["LKFAR"] = spec["LK"] + 100  # no key of the right side
    spec["KB"] = np.array([3, 3, 1, 0, 2, 2], np.int32)
    spec["VB"] = np.array([1, 0, 1, 1, 0, 1], bool)
    return spec


def _build_env(lib, spec, **kw):
    """``lib`` is ``ht`` (the port) or ``hj``; ``kw`` the heat_tpu mesh. The
    stream files are written once per process, into a folder that is
    removed when the process exits: the table and the float64 column as
    HDF5, the table's chunks as ``.npy`` files."""
    import os
    import tempfile

    import h5py

    G, ROWS = 7, 64  # groups; rows a chunk of the streams
    counters = ("io.stream_chunks", "io.stream_bytes", "data_engine.stream_chunks",
                "data_engine.dispatches", "data_engine.groupby_calls",
                "data_engine.topk_calls", "data_engine.quantile_calls",
                "data_engine.join_calls")
    g = globals()
    if "_DIR" not in g:
        g["_DIR"] = tempfile.TemporaryDirectory()
        with h5py.File(os.path.join(g["_DIR"].name, "t.h5"), "w") as f:
            f.create_dataset("table", data=spec["T"])
            f.create_dataset("s64", data=spec["S64"])
        for i in range(0, 300, ROWS):
            np.save(os.path.join(g["_DIR"].name, f"t{i:04d}.npy"), spec["T"][i:i + ROWS])
    d = g["_DIR"].name
    if lib.__name__ == "heat_tpu":
        from heat_tpu.utils import metrics
    else:
        metrics = lib.utils.metrics

    def arr(name, split=0, dtype=None):
        a = spec[name] if isinstance(name, str) else name
        out = lib.array(a, split=split, **kw)
        return out if dtype is None else out.astype(getattr(lib, dtype))

    def gb(op, vals="V", ksplit=0, vsplit=0, keys="K"):
        return lib.data.groupby(arr(keys, ksplit), G).agg(
            op, None if op == "count" else arr(vals, vsplit))

    def tk(name, k, largest=True, split=0):
        return lib.data.topk(arr(name, split), k, largest)

    def jn(lk="LK", lv="LV", rk="RK", rv="RV", splits=(0, 0, 0, 0), kdt=None):
        keys = [arr(lk, splits[0], kdt), arr(lv, splits[1]), arr(rk, splits[2], kdt),
                arr(rv, splits[3])]
        return lib.data.join(*keys)

    def chunks(name="T"):
        a = spec[name]
        return [arr(a[i:i + ROWS]) for i in range(0, len(a), ROWS)]

    def calls(name="T"):
        return lambda: iter(chunks(name))

    def h5(name="table"):
        dt = lib.float64
        return lib.load_hdf5(os.path.join(d, "t.h5"), name, dtype=dt, split=0, stream=True, **kw)

    def npy():
        files = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
        return lambda: (arr(np.load(os.path.join(d, f), mmap_mode="r")) for f in files)

    def off(fn):
        with lib.data.override(False):
            return fn()

    def counted(fn):
        """``fn()`` and the deltas of the engine's and the streams' counters."""
        before = metrics.counters()
        out = fn()
        after = metrics.counters()
        return out, np.array([after.get(c, 0) - before.get(c, 0) for c in counters])

    def gb_bool(split):
        """A groupby of bool values: the exception names of sum, min and
        max, then the mean and the count."""
        def agg(op):
            return lib.data.groupby_agg(arr("KB", split), 5, op, arr("VB", split))

        return (raised(*(lambda op=op: agg(op) for op in ("sum", "min", "max"))),
                agg("mean"), agg("count"))

    def raised(*calls):
        """The name of the exception each call raises."""
        names = []
        for call in calls:
            try:
                call()
                names.append("")
            except Exception as exc:  # noqa: BLE001 - the name is the result
                names.append(type(exc).__name__)
        return tuple(names)

    return {"lib": lib, "np": np, "arr": arr, "gb": gb, "tk": tk, "jn": jn, "chunks": chunks,
            "calls": calls, "h5": h5, "npy": npy, "off": off, "counted": counted,
            "raised": raised, "gb_bool": gb_bool, "data": lib.data}


PACKED = {"packed_all_reduce": 1}
MINMAX = {"all_reduce": 1}
# the join: one all-to-all of both sides' partitions, one all-reduce of the
# match counts, one all-to-all of the matches (none when nothing matched)
JOIN = {"all_to_all": 2, "all_reduce": 1}


def _passes(n):
    return {"packed_all_reduce": n}


# name -> (expression, collectives at world size 2, comparison); a name
# ending in "_w1" runs at world size 1 only (the engine's plain forms on
# the logical arrays)
CASES = {
    "gb_sum": ("gb('sum')", PACKED, "f32"),
    "gb_mean": ("gb('mean')", PACKED, "f64"),
    "gb_count": ("gb('count')", PACKED, "exact"),
    "gb_min": ("gb('min')", MINMAX, "exact"),
    "gb_max": ("gb('max')", MINMAX, "exact"),
    "gb_sum_block64": ("gb('sum', 'V2')", PACKED, "f64"),
    "gb_mean_block64": ("gb('mean', 'V2')", PACKED, "f64"),
    "gb_min_block64": ("gb('min', 'V2')", MINMAX, "exact"),
    "gb_sum_int": ("gb('sum', 'VI')", PACKED, "exact"),
    "gb_max_int": ("gb('max', 'VI')", MINMAX, "exact"),
    "gb_bool_values": ("[gb_bool(None), gb_bool(0)]", {"packed_all_reduce": 2}, "exact"),
    "gb_values_replicated": ("gb('mean', vsplit=None)", PACKED, "f64"),
    "gb_keys_replicated": ("gb('sum', ksplit=None, vsplit=None)", {}, "f32"),
    "topk_largest": ("tk('X', 5)", PACKED, "exact"),
    "topk_smallest": ("tk('X', 6, False)", PACKED, "exact"),
    "topk_whole_chunk": ("tk('X', 21)", PACKED, "exact"),
    "topk_int": ("tk('XI', 7)", PACKED, "exact"),
    "topk_int_smallest": ("tk('XI', 9, False)", PACKED, "exact"),
    "topk_replicated": ("tk('X', 4, split=None)", {}, "exact"),
    "join": ("jn()", JOIN, "exact"),
    "join_int32_keys": ("jn(kdt='int32')", JOIN, "exact"),
    "join_no_match": ("jn(lk='LKFAR')", {"all_to_all": 1, "all_reduce": 1}, "exact"),
    "join_f64_left_values": ("jn(lv='RV', lk='RK')", JOIN, "exact"),
    "sg_list_mean": ("data.stream_groupby(chunks(), 5, 'mean')", PACKED, "f64"),
    "sg_callable_sum": ("data.stream_groupby(calls(), 5, 'sum')", PACKED, "f64"),
    "sg_h5_max": ("data.stream_groupby(h5(), 5, 'max', rows_per_chunk=64)", MINMAX, "exact"),
    "sg_npy_count": ("data.stream_groupby(npy(), 5, 'count')", PACKED, "exact"),
    "sg_h5_min_counted": ("counted(lambda: data.stream_groupby(h5(), 5, 'min', "
                          "rows_per_chunk=100))", MINMAX, "exact"),
    "st_list": ("data.stream_topk(chunks(), 5, col=1)", PACKED, "exact"),
    "st_h5_smallest": ("data.stream_topk(h5(), 7, False, col=1, rows_per_chunk=64)", PACKED,
                       "exact"),
    "st_1d_k_past_chunk": ("data.stream_topk(chunks('S32')[:3], 40)", PACKED, "exact"),
    "sq_linear": ("data.stream_quantile(chunks('S32'), [0.0, 0.1, 0.5, 0.99, 1.0])",
                  _passes(4), "exact"),
    "sq_lower": ("data.stream_quantile(chunks('S32'), [0.1, 0.5, 0.99], "
                 "interpolation='lower')", _passes(4), "exact"),
    "sq_higher": ("data.stream_quantile(calls('S32'), [0.1, 0.5, 0.99], "
                  "interpolation='higher')", _passes(4), "exact"),
    "sq_nearest": ("data.stream_quantile(chunks('S32'), [0.1, 0.5, 0.99], "
                   "interpolation='nearest')", _passes(4), "exact"),
    "sq_midpoint": ("data.stream_quantile(chunks('S32'), [0.1, 0.5, 0.99], "
                    "interpolation='midpoint')", _passes(4), "exact"),
    "sq_scalar_int": ("data.stream_quantile(chunks('SI'), 0.3)", _passes(4), "exact"),
    "sq_h5_f64_counted": ("counted(lambda: data.stream_quantile(h5('s64'), [0.25, 0.75], "
                          "rows_per_chunk=128))", _passes(8), "exact"),
    "sq_nan": ("data.stream_quantile(chunks('X'), [0.5, 0.9])", _passes(4), "exact"),
    "gb_off_w1": ("off(lambda: [gb(op) for op in ('sum', 'mean', 'count', 'min', 'max')])", {},
                  "f32"),
    "topk_off_w1": ("off(lambda: (tk('X', 5), tk('XI', 9, False)))", {}, "exact"),
    "join_off_w1": ("off(jn)", {}, "exact"),
    "join_right_replicated_w1": ("jn(splits=(0, 0, None, None))", {}, "exact"),
    "refusals_w1": ("raised(lambda: gb('median'), lambda: gb('sum', keys='V'), "
                    "lambda: lib.data.groupby(arr('K'), 0).count(), "
                    "lambda: lib.data.groupby(arr('K'), 3).sum(None), lambda: tk('X', 42), "
                    "lambda: tk('V2', 2), lambda: jn(lk='LV'), "
                    "lambda: data.stream_quantile(chunks('S32'), 1.5), "
                    "lambda: data.stream_quantile(chunks('S32'), 0.5, interpolation='cubic'), "
                    "lambda: data.stream_groupby([], 3), lambda: data.stream_topk([], 3), "
                    "lambda: data.stream_topk(chunks('S32')[:1], 65))", {}, "exact"),
    "topk_counted_w1": ("counted(lambda: (tk('X', 3), gb('count'), jn()))", {}, "exact"),
}


def _preload():
    """heat_tpu, imported once before the reference jobs fork (its import
    starts no jax backend)."""
    import heat_tpu  # noqa: F401


def _heat_tpu(case, comm):
    import heat_tpu as hj

    return pack(eval(CASES[case][0], _build_env(hj, _spec(), comm=comm)))  # noqa: S307
