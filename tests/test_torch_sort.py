"""The port's sorting, set operations, order statistics, searches, counts
and calculus against heat_tpu, on the same seeded numpy inputs: every name
of ``_sort``, ``_setops``, ``data.ops``' order statistics, ``sort``/
``topk``/``unique``/the four set operations, ``isin``/``in1d``, the
statistics that wait for sorting, ``finfo``/``iinfo``; and the DNDarray's
``__array__`` and the methods it lacked.

One table of cases runs twice: in process at world size 1 against heat_tpu
on one device, and in ONE spawned 3-rank gloo world shared by the module
against heat_tpu on three devices (``TPUCommunication(jax.devices()[:3])``).
Three ranks drop comparators of the 4-input Batcher network, which two
hide. The shapes split unevenly (7 over 3 ranks: 3, 3, 1; 10: 4, 4, 2) and
a 1-row array leaves ranks 1 and 2 empty. The data holds ties, NaN, ±inf,
±0.0 and the integer extremes. Each world-3 case pins its collectives
(``comm.stats``): with R = ``len(batcher_rounds(3))`` = 3, a network sort
makes R ``permute``, a 1-D ``unique`` 2R + 1 (+1 with counts, +R and one
more ``exscan`` with the inverse), one ``all_reduce`` and one ``exscan``;
a percentile along the split axis R ``permute`` and one ``all_reduce`` of
its picks; over all axes ``bits`` all-reduces of the bisection (the data
engine) or the flat sort's R ``permute`` and one ``all_reduce``; ``topk``
one ``all_gather``; the counts one ``all_reduce`` after the extrema's two.

Tolerance: bitwise (values, type, gshape, split, lshape_map, the sign of
a zero) for the sorts, ``topk``, ``unique``, the set operations, ``isin``,
the searches, the integer counts and every percentile (each route keeps
heat_tpu's own formula), with two exceptions at world size 1
(``LOCAL_FMA``): XLA's CPU compiler fuses the local quantile's
linear sum into an FMA whose operand depends on the fusion, and
reassociates ``jnp.linspace``'s bin edges, so both are held within 2 ulp;
and one at world size 3 (``UNSTABLE_ZERO``): heat_tpu's local quantile
sorts unstably, so the sign of a zero pick in a lane holding both ±0 is
not defined by it. Weighted sums within rtol 1e-6 of float32 (the
numerics contract's reduction rtol: the scatter-add of a float weight is
not ordered on the card); ``interp``/``gradient``/``trapz`` and the
repaired elementwise methods within 4 ulp of the result type, the
repaired third and fourth moments within 1e-5 of their O(1) values
(``tests/test_torch_ops.py``'s contract).
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
from heat_tpu.core import _sort as hjs  # noqa: E402
from heat_tpu.core.communication import TPUCommunication  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import _manips as tm  # noqa: E402
from heat_tpu_torch.core import _sort as ts  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
C1 = TPUCommunication(jax.devices()[:1])
C3 = TPUCommunication(jax.devices()[:3])
WORLD = 3
R = len(hjs.batcher_rounds(WORLD))


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _arrays():
    """name -> (data, split) of the case arrays."""
    rng = np.random.default_rng(12)
    F = rng.integers(-3, 4, (7, 5)).astype(np.float32)  # ties
    F[1, 2] = F[6, 4] = np.nan
    F[4, 0], F[5, 3], F[2, 1] = np.inf, -np.inf, -0.0
    Vn = np.array([0.5, np.nan, -np.inf, 0.5, 2.0, np.inf, -1.0], np.float32)
    Vd = np.array([0.0, -0.0, 1.5, -2.0, 0.0, -0.0, 1.5], np.float64)
    Vl = np.array([3, -1, np.iinfo(np.int64).max, 3, 0, -1, np.iinfo(np.int64).min, 3, 7, 0])
    R_ = rng.integers(0, 2, (7, 3))
    R_[4] = R_[1]
    Rf = np.array([[0.5, 1.0], [np.nan, 1.0], [0.5, 1.0], [-0.0, 2.0], [0.0, 2.0],
                   [np.nan, 1.0], [0.5, -1.0]], np.float32)
    return {
        "F": (F, 0), "G": (np.ascontiguousarray(F.T), 1),
        "P": (rng.uniform(-2, 2, (7, 5)).astype(np.float32), 0),
        "V": (rng.uniform(-2, 2, 7).astype(np.float32), 0), "Vn": (Vn, 0),
        "Vh": (rng.integers(-3, 3, 7).astype(np.float16) / 2, 0), "Vd": (Vd, 0),
        "Vi": (rng.integers(-3, 4, 7).astype(np.int32), 0), "Vl": (Vl, 0),
        "Vb": (rng.integers(0, 2, 10).astype(bool), 0),
        "E": (rng.uniform(-1, 1, (1, 5)).astype(np.float32), 0),
        "R": (R_, 0), "Rf": (Rf, 0),
        "C": (rng.integers(0, 6, 10), 0), "W": (rng.uniform(0, 1, 10).astype(np.float32), 0),
        "W7": (rng.uniform(0, 1, 7).astype(np.float32), 0),
        "T": (np.array([-1.0, 0.0, 0.5, 2.0], np.float32), None),
        "Ts": (np.array([-1.5, -1.0, 0.0, 0.25, 0.5, 2.0], np.float32), 0),
        "Td": (np.array([2.0, 0.5, 0.0, -1.0]), None),
        "A": (rng.integers(0, 8, 12), 0), "B2": (rng.integers(4, 12, 9), 0),
        "Z": (np.array([1 + 2j, -1 + 0j, 1 - 1j, 1 + 2j, 0j, -1 - 3j], np.complex64), None),
        "X2": (rng.uniform(-1, 1, (10, 2)).astype(np.float32), 0),
    }


def _build_env(lib, kw, arrays):
    env = {"lib": lib, "np": np}
    for name, (a, split) in arrays.items():
        env[name] = lib.array(a, split=split, **kw)

    def engine_off(fn):
        with lib.data.override(False):
            return fn()

    def info(lib):
        fin = [lib.finfo(t) for t in (lib.float16, lib.bfloat16, lib.float32, lib.float64)]
        iin = [lib.iinfo(t) for t in (lib.bool, lib.uint8, lib.int8, lib.int16, lib.int32,
                                      lib.int64)]
        return tuple((f.bits, f.eps, f.max, f.min, f.tiny, float(f.resolution),
                      f.dtype.__name__) for f in fin) + \
            tuple((i.bits, i.max, i.min, i.dtype.__name__) for i in iin)

    env.update(engine_off=engine_off, info=info)
    return env


def _reshape_rounds(rows_in, row_in, rows_out, row_out):
    """Permute rounds of a split-0 reshape at p = 3 (the port's plans equal
    heat_tpu's: ``test_torch_manipulations.test_block_fetch_plans_equal_heat_tpu``)."""
    return len(tm.plan_reshape(rows_in, row_in, rows_out, row_out, WORLD))


def _concat_rounds(*ns):
    return sum(len(r) for r in tm.plan_concat(tuple(ns), WORLD))


def _slice_rounds(n, start, length):
    return len(tm.plan_slice(n, start, 1, length, WORLD))


def _gradient_rounds(n):
    """The six split-axis slices of a gradient and its concatenation."""
    return (_slice_rounds(n, 2, n - 2) + _slice_rounds(n, 0, n - 2) + _slice_rounds(n, 1, 1)
            + _slice_rounds(n, 0, 1) + _slice_rounds(n, n - 1, 1) + _slice_rounds(n, n - 2, 1)
            + _concat_rounds(1, n - 2, 1))


def _n_unique(name):
    return len(np.unique(_arrays()[name][0]))


def _unique_counts(inverse=False, counts=False, extra_permute=0):
    """A 1-D unique at p = 3: phase A R + 1 permutes and one all-reduce,
    phase B one exscan and R permutes (+1 with counts), phase C one exscan
    and R permutes."""
    permute = 2 * R + 1 + (1 if counts else 0) + (R if inverse else 0) + extra_permute
    return {"permute": permute, "all_reduce": 1, "exscan": 2 if inverse else 1}


# the local quantile's linear sum: XLA's CPU compiler fuses it into one FMA
# whose operand depends on the fusion (the low product for a 2-D lane, the
# high one for a raveled array); the port fuses the first. At world size 1
# it may differ from heat_tpu in the last bit. So may jnp.linspace's bin
# edges, which XLA reassociates (``i·(hi·fl(1/div))``).
LOCAL_FMA = {"ulps_world1": 2}
# heat_tpu's local quantile sorts unstably (``lax.sort``, jax ``_quantile``):
# in a lane holding both -0.0 and +0.0 the sign of a zero pick follows
# XLA's order for the array's padded shape; the values compare equal
UNSTABLE_ZERO = {"zero_sign": False}
SORTED = {"permute": R}
PICKS = {"permute": R, "all_reduce": 1}
MASK = {"exscan": 1, "all_reduce": 1, "ring_step": 2}


def _plus(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


# name -> (expression, collectives at world size 3, options)
CASES = {
    # sort
    "sort_split0": ("lib.sort(F, axis=0)", SORTED),
    "sort_split0_desc": ("lib.sort(F, axis=0, descending=True)", SORTED),
    "sort_nonsplit": ("lib.sort(F, axis=1)", {}),
    "sort_split1": ("lib.sort(G, axis=1, descending=True)", SORTED),
    "sort_int32": ("lib.sort(Vi)", SORTED),
    "sort_int64_extremes": ("lib.sort(Vl)", SORTED),
    "sort_int64_extremes_desc": ("lib.sort(Vl, descending=True)", SORTED),
    "sort_bool": ("lib.sort(Vb)", SORTED),
    "sort_float16": ("lib.sort(Vh, descending=True)", SORTED),
    "sort_float64_zeros": ("lib.sort(Vd)", SORTED),
    "sort_nan_inf": ("lib.sort(Vn)", SORTED),
    "sort_nan_inf_desc": ("lib.sort(Vn, descending=True)", SORTED),
    "sort_empty_ranks": ("lib.sort(E, axis=0)", SORTED),
    "sort_complex": ("lib.sort(Z)", {}),
    "sort_complex_desc": ("lib.sort(Z, descending=True)", {}),
    # topk
    "topk_nan": ("lib.topk(Vn, 3)", {"all_gather": 1}),
    "topk_smallest_nan": ("lib.topk(Vn, 4, largest=False)", {"all_gather": 1}),
    "topk_ties": ("lib.topk(Vi, 4)", {"all_gather": 1}),
    "topk_smallest_ties": ("lib.topk(Vl, 5, largest=False)", {"all_gather": 1}),
    "topk_past_chunk": ("lib.topk(Vl, 9)", {"all_gather": 1}),
    "topk_split_axis_2d": ("lib.topk(F, 3, dim=0, largest=False)", {"all_gather": 1}),
    "topk_nonsplit": ("lib.topk(F, 2, dim=1)", {}),
    "topk_bool": ("lib.topk(Vb, 3)", {"all_gather": 1}),
    # unique
    "unique_int32": ("lib.unique(Vi)", _unique_counts()),
    "unique_int32_all": ("lib.unique(Vi, return_inverse=True, return_counts=True)",
                         _unique_counts(True, True)),
    "unique_nan": ("lib.unique(Vn, return_counts=True)", _unique_counts(counts=True)),
    "unique_zeros_inverse": ("lib.unique(Vd, return_inverse=True)", _unique_counts(True)),
    "unique_int64_extremes": ("lib.unique(Vl, return_counts=True)", _unique_counts(counts=True)),
    "unique_bool": ("lib.unique(Vb, return_inverse=True)", _unique_counts(True)),
    "unique_flattened": ("lib.unique(F, return_inverse=True)",
                         _unique_counts(True, extra_permute=_reshape_rounds(7, 5, 35, 1)
                                        + _reshape_rounds(35, 1, 7, 5))),
    "unique_rows": ("lib.unique(R, axis=0, return_inverse=True, return_counts=True)",
                    _unique_counts(True, True)),
    "unique_rows_nan": ("lib.unique(Rf, axis=0)", _unique_counts()),
    "unique_columns": ("lib.unique(R, axis=1)", _plus(_unique_counts(), {"all_to_all": 1})),
    "unique_1d_axis0": ("lib.unique(Vi, axis=0, return_counts=True)",
                        _unique_counts(counts=True)),
    "unique_method": ("Vi.unique(return_inverse=True)", _unique_counts(True)),
    # set operations and membership
    "union1d": ("lib.union1d(A, B2)", _plus(_unique_counts(), {"permute": _concat_rounds(12, 9)})),
    "intersect1d": ("lib.intersect1d(A, B2)",
                    _plus(_unique_counts(), {"all_gather": 1}, MASK)),
    "intersect1d_assume_unique": ("lib.intersect1d(Vi, [3, 1, -9], assume_unique=True)",
                                  _plus(MASK, SORTED)),
    "setdiff1d": ("lib.setdiff1d(A, B2)", _plus(_unique_counts(), {"all_gather": 1}, MASK)),
    "setdiff1d_assume_unique": ("lib.setdiff1d(A, [1, 2], assume_unique=True)", MASK),
    "setxor1d": ("lib.setxor1d(A, B2)",
                 _plus(_unique_counts(), _unique_counts(), _unique_counts(counts=True), MASK,
                       {"permute": _concat_rounds(_n_unique("A"), _n_unique("B2"))})),
    "isin": ("lib.isin(A, [1, 3, 5])", {}),
    "isin_split_table_invert": ("lib.isin(Vn, Vn[2:5], invert=True)",
                                {"permute": _slice_rounds(7, 2, 3), "all_gather": 1}),
    "isin_float_int": ("lib.isin(V, A)", {"all_gather": 1}),
    "in1d": ("lib.in1d(R, B2)", {"permute": _reshape_rounds(7, 3, 21, 1), "all_gather": 1}),
    # percentiles
    **{f"percentile_split_axis_{m}": (f"lib.percentile(F, [10, 50, 90], axis=0, "
                                      f"interpolation='{m}')", PICKS)
       for m in ("linear", "lower", "higher", "nearest", "midpoint")},
    **{f"percentile_flat_{m}": (f"lib.percentile(P, [15, 50, 85], interpolation='{m}')",
                                {"all_reduce": 32}, LOCAL_FMA if m == "linear" else {})
       for m in ("linear", "lower", "higher", "nearest", "midpoint")},
    **{f"percentile_flat_engine_off_{m}": (
        f"engine_off(lambda: lib.percentile(P, [15, 50, 85], interpolation='{m}'))", PICKS,
        LOCAL_FMA if m == "linear" else {})
       for m in ("linear", "lower", "higher", "nearest", "midpoint")},
    "percentile_flat_nan": ("lib.percentile(F, 50)", {"all_reduce": 32}),
    "percentile_flat_nan_engine_off": ("engine_off(lambda: lib.percentile(F, [20, 70]))", PICKS),
    "percentile_int32": ("lib.percentile(Vi, 30)", {"all_reduce": 32}),
    "percentile_int64": ("lib.percentile(Vl, [5, 50])", {"all_reduce": 64}),
    "percentile_float64": ("lib.percentile(Vd, 37.5, interpolation='nearest')",
                           {"all_reduce": 64}),
    "percentile_float16": ("lib.percentile(Vh, 60)", {"all_reduce": 32}),
    "percentile_bool": ("lib.percentile(Vb, [40, 60])", PICKS),
    "percentile_split1": ("lib.percentile(G, 25, axis=1)", PICKS),
    "percentile_nonsplit_axis": ("lib.percentile(P, 40, axis=1)", {}),
    "percentile_keepdims": ("lib.percentile(P, [20, 80], axis=0, keepdims=True)", PICKS),
    "percentile_flat_keepdims": ("lib.percentile(P, 30, keepdims=True)", {"all_reduce": 32}),
    "percentile_q_2d": ("lib.percentile(P, [[10, 20], [30, 90]], axis=0)", PICKS),
    "percentile_empty_ranks": ("lib.percentile(E, 50, axis=0)", PICKS),
    "median": ("lib.median(P, axis=0)", PICKS),
    "median_method": ("P.median(keepdim=True)", {"all_reduce": 32}),
    "quantile": ("lib.quantile(P, [0.1, 0.5], axis=0, interpolation='nearest')", PICKS),
    "nanpercentile_axis": ("lib.nanpercentile(F, [30, 60], axis=0)", {"all_to_all": 1}),
    "nanpercentile_other_axis": ("lib.nanpercentile(F, 50, axis=1, keepdims=True)", {}),
    "nanpercentile_flat": ("lib.nanpercentile(F, 40)",
                           _plus({"permute": _reshape_rounds(7, 5, 35, 1)}, MASK,
                                 {"all_reduce": 32})),
    "nanmedian": ("lib.nanmedian(Vn)", _plus(MASK, {"all_reduce": 32})),
    "nanquantile": ("lib.nanquantile(F, [0.25, 0.75], axis=1)", {}, UNSTABLE_ZERO),
    # searches
    "searchsorted": ("lib.searchsorted(T, V)", {}),
    "searchsorted_right_nan": ("lib.searchsorted(T, Vn, side='right')", {}),
    "searchsorted_split_table": ("lib.searchsorted(Ts, V)", {"all_gather": 1}),
    "searchsorted_list": ("lib.searchsorted(T, [-2.0, 0.0, 0.5, 9.0])", {}),
    "bucketize": ("lib.bucketize(V, T)", {}),
    "bucketize_right": ("lib.bucketize(Vn, T, right=True)", {}),
    "digitize": ("lib.digitize(V, T)", {}),
    "digitize_decreasing_right": ("lib.digitize(Vn, Td, right=True)", {}),
    "interp": ("lib.interp(V, T, Td)", {}, {"ulps": 4}),
    "interp_left_right": ("lib.interp(Vn, [-1.0, 0.0, 1.0], [5.0, 3.0, 4.0], left=-9.0, "
                          "right=9.0)", {}, {"ulps": 4}),
    # counts
    "bincount": ("lib.bincount(C)", {"all_reduce": 3}),
    "bincount_weights": ("lib.bincount(C, weights=W)", {"all_reduce": 3}, {"rtol": 1e-6}),
    "bincount_minlength": ("lib.bincount(C, minlength=9)", {"all_reduce": 3}),
    "histc": ("lib.histc(V, 4)", {"all_reduce": 3}),
    "histc_range": ("lib.histc(V, 5, min=-1.0, max=1.0)", {"all_reduce": 1}),
    "histogram": ("lib.histogram(V, 4)", {"all_reduce": 3}, LOCAL_FMA),
    "histogram_range_density": ("lib.histogram(V, 5, range=(-2, 2), density=True)",
                                {"all_reduce": 1}, {"rtol": 1e-6}),
    "histogram_weights": ("lib.histogram(V, 3, weights=W7)", {"all_reduce": 3},
                          {"rtol": 1e-6}),
    "histogram_edges": ("lib.histogram(V, np.array([-2.0, -0.5, 0.0, 1.0, 3.0]))",
                        {"all_reduce": 1}),
    # each column's extrema, then bincount's extrema and its counts
    "histogramdd": ("lib.histogramdd(X2, bins=3)", {"all_reduce": 7}),
    "histogram2d": ("lib.histogram2d(X2[:, 0], X2[:, 1], bins=[2, 3])", {"all_reduce": 7}),
    # calculus
    "gradient": ("lib.gradient(V)", {"permute": _gradient_rounds(7)}, {"ulps": 4}),
    "gradient_split_axis": ("lib.gradient(P, axis=0)", {"permute": _gradient_rounds(7)},
                            {"ulps": 4}),
    "gradient_spacing": ("lib.gradient(P, 0.5, axis=1)", {}, {"ulps": 4}),
    "trapz": ("lib.trapz(V)", {"permute": 2 * _slice_rounds(7, 0, 6), "all_reduce": 1},
              {"ulps": 4}),
    "trapz_x": ("lib.trapz(P, x=np.linspace(0.0, 1.0, 5), axis=1)", {}, {"ulps": 4}),
    "trapz_dx_split_axis": ("lib.trapz(P, dx=0.25, axis=0)",
                            {"permute": _slice_rounds(7, 1, 6) + _slice_rounds(7, 0, 6),
                             "all_reduce": 1}, {"ulps": 4}),
    # types
    "finfo_iinfo": ("info(lib)", {}),
}

# the DNDarray's __array__ and the methods it lacked, world size 1
# name -> expression with ``x`` float32 (7, 5) split 0, ``i`` int32, ``c``
# complex64
REPAIRS = {
    "np_asarray": "np.asarray(x)",
    "np_asarray_int": "np.asarray(i)",
    "np_asarray_dtype": "np.asarray(x, dtype=np.float64)",
    "np_sum": "np.sum(i)",
    **{m: f"x.{m}()" for m in ("absolute", "ceil", "floor", "trunc", "fabs", "sign", "sgn",
                                "exp2", "expm1", "log1p", "square", "tan", "sinh", "cosh",
                                "tanh", "atan")},
    "log2": "abs(x).log2()", "log10": "abs(x).log10()",
    "acos": "(x / 4).acos()", "asin": "(x / 4).asin()",
    "atan2": "x.atan2(x + 1)", "round": "(x * 3.3).round(1)", "modf": "x.modf()",
    "conj": "c.conj()", "average": "x.average(axis=0)", "kurtosis": "x.kurtosis(axis=0)",
    "skew": "x.skew()", "median": "x.median(axis=1, keepdim=True)",
    "unique": "i.unique(return_counts=True)",
    "properties": "(x.balanced, x.pad, x.gnumel, x.gnbytes, x.nbytes, x.itemsize, x.lnumel, "
                  "x.lnbytes, x.stride(), x.strides, i.itemsize, i.nbytes)",
    "create_lshape_map": "x.create_lshape_map()",
    "cpu": "x.cpu() is x",
    "filled": "np.asarray(x.filled(0))",
    "valid_mask": "np.asarray(x.valid_mask())",
    "lloc_get": "np.asarray(x.lloc[1:3, 2])",
    "lloc_set": "set_lloc(x.copy())",
    "fill_diagonal": "x.copy().fill_diagonal(9.0)",
}
# elementwise floats within 4 ulp of the result type (two libms); the
# moments within 1e-5 of their O(1) values (test_torch_ops' contract)
_ELEMENTWISE = ("absolute", "ceil", "floor", "trunc", "fabs", "sign", "sgn", "exp2", "expm1",
                "log1p", "square", "tan", "sinh", "cosh", "tanh", "atan", "log2", "log10",
                "acos", "asin", "atan2", "round", "modf", "average")
REPAIR_TOL = {**{m: {"ulps": 4} for m in _ELEMENTWISE},
              "kurtosis": {"rtol": 1e-5, "atol": 1e-5}, "skew": {"rtol": 1e-5, "atol": 1e-5}}


def _repair_env(lib, kw):
    rng = np.random.default_rng(3)
    xs = rng.uniform(-3, 3, (7, 5)).astype(np.float32)
    env = {"np": np, "x": lib.array(xs, split=0, **kw),
           "i": lib.array(rng.integers(-4, 5, (7, 5)).astype(np.int32), split=0, **kw),
           "c": lib.array((xs + 1j).astype(np.complex64), **kw)}

    def set_lloc(y):
        y.lloc[2, 1:3] = -7.0
        return y

    env["set_lloc"] = set_lloc
    return env


def _pack(v):
    if isinstance(v, (tuple, list)):
        return tuple(_pack(u) for u in v)
    if hasattr(v, "lshape_map") and hasattr(v, "gshape"):  # a DNDarray of either package
        vals = np.asarray(v.numpy())
        return {"values": vals.astype(np.float32) if vals.dtype.name == "bfloat16" else vals,
                "dtype": v.dtype.__name__, "gshape": tuple(v.gshape), "split": v.split,
                "lshape_map": np.asarray(v.lshape_map)}
    if isinstance(v, np.ndarray) or hasattr(v, "__array__"):
        v = np.asarray(v)
        return {"array": v.astype(np.float32) if v.dtype.name == "bfloat16" else v}
    return v


def _same(got, want, ulps=0, rtol=0.0, atol=0.0, zero_sign=True):
    """A packed port result against a packed heat_tpu one: type, gshape,
    split, lshape_map, values bitwise (NaN equal to NaN; the sign of a zero
    too unless ``zero_sign`` is False), within ``ulps`` ulp, or within
    ``rtol``/``atol``."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same(g, w, ulps, rtol, atol, zero_sign)
        return
    if not isinstance(want, dict):
        assert type(got) is type(want) and got == want, (got, want)
        return
    if "array" in want:
        g, w = got["array"], want["array"]
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    else:
        for key in ("dtype", "gshape", "split"):
            assert got[key] == want[key], (key, got[key], want[key])
        np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
        g, w = got["values"], want["values"]
    if ulps:
        np.testing.assert_array_max_ulp(g, w, ulps)
    elif rtol:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)
        # NaN sign and payload aside, the bits of every float agree
        if g.dtype.kind == "f" and zero_sign:
            nan = np.isnan(g)
            np.testing.assert_array_equal(g[~nan].view(f"u{g.itemsize}"),
                                          w[~nan].view(f"u{w.itemsize}"))


def _on_mesh(v, comm):
    """A packed heat_tpu result with the lshape_map of ``comm``'s mesh (a
    factory without ``comm`` builds on heat_tpu's default mesh)."""
    if isinstance(v, tuple):
        return tuple(_on_mesh(u, comm) for u in v)
    if isinstance(v, dict) and "gshape" in v:
        v = dict(v, lshape_map=comm.lshape_map(v["gshape"], v["split"]))
    return v


_ENVS = {}
_REFS = {}


def _heat_tpu(expr, comm):
    """``expr`` evaluated by heat_tpu on ``comm``'s mesh."""
    if comm not in _ENVS:
        _ENVS[comm] = _build_env(hj, {"comm": comm}, _arrays())
    return _on_mesh(_pack(eval(expr, dict(_ENVS[comm]))), comm)  # noqa: S307


_REF_WORKER = r'''
import pickle, sys
sys.path.insert(0, sys.argv[1])
import test_torch_sort as T
out = {name: T._heat_tpu(T.CASES[name][0], T.C3) for name in sys.argv[3:]}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
'''
_REF_PROCS = 3


@pytest.fixture(scope="module", autouse=True)
def references(tmp_path_factory):
    """heat_tpu's result of every case on both meshes, computed from the
    module's start while its tests run: the one-device results in a pool of
    threads here, the three-device ones in three processes of their own
    (jax's tracing holds the GIL; the compiles are most of the time). A
    test waits for its own. The data engine's switch is global, so each
    process evaluates its cases one by one, and here the engine-off cases
    run before the pool starts."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("sort_references")
    (tmp / "refs.py").write_text(_REF_WORKER)
    names = list(CASES)
    procs = []
    for k in range(_REF_PROCS):
        out = tmp / f"refs{k}.pkl"
        procs.append((out, subprocess.Popen(
            [sys.executable, str(tmp / "refs.py"), str(REPO / "tests"), str(out)]
            + names[k::_REF_PROCS], cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    _heat_tpu("None", C1)
    pool = ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1))
    for case in CASES:
        if "engine_off" in CASES[case][0]:
            _REFS[case, C1] = pool.submit(lambda r: r, _heat_tpu(CASES[case][0], C1))
    for case in CASES:
        if (case, C1) not in _REFS:
            _REFS[case, C1] = pool.submit(_heat_tpu, CASES[case][0], C1)
    _REFS["procs"] = procs
    yield
    pool.shutdown(cancel_futures=True)
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _REFS.clear()
    _ENVS.clear()


def _reference(case, comm):
    """heat_tpu's packed result of ``case`` on ``comm``'s mesh."""
    if comm is C1:
        return _REFS[case, C1].result()
    if "world3" not in _REFS:
        got = {}
        for out, proc in _REFS["procs"]:
            log = proc.communicate(timeout=300)[0]
            assert proc.returncode == 0, log
            with open(out, "rb") as f:
                got.update(pickle.load(f))
        _REFS["world3"] = got
    return _REFS["world3"][case]


def _opts(case, world):
    opts = dict(CASES[case][2]) if len(CASES[case]) > 2 else {}
    ulps = opts.pop("ulps_world1", 0)
    if world == 1 and ulps:
        opts["ulps"] = ulps
    return opts


@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_heat_tpu(case):
    ht.get_comm().reset_stats()
    got = _pack(eval(CASES[case][0], _build_env(ht, {}, _arrays())))  # noqa: S307
    assert ht.get_comm().stats == {}
    _same(got, _reference(case, C1), **_opts(case, 1))


@pytest.mark.parametrize("case", list(REPAIRS))
def test_repaired_methods_match_heat_tpu(case):
    """``np.asarray`` of a DNDarray and the DNDarray methods and properties
    heat_tpu's class has: the same call on both packages, values and types
    compared."""
    got = _pack(eval(REPAIRS[case], _repair_env(ht, {})))  # noqa: S307
    want = _on_mesh(_pack(eval(REPAIRS[case], _repair_env(hj, {"comm": C1}))), C1)  # noqa: S307
    _same(got, want, **REPAIR_TOL.get(case, {}))


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_network_plans_equal_heat_tpu(p):
    """The Batcher rounds and role tables of the port equal heat_tpu's, and
    R(p) is 1, 3, 3, 6 at p = 2, 3, 4, 8; each unique phase runs them with
    heat_tpu's halo pairs."""
    assert ts.batcher_rounds(p) == hjs.batcher_rounds(p)
    rounds = ts.batcher_rounds(p)
    for mine, theirs in zip(ts._role_tables(rounds, p), hjs._role_tables(rounds, p)):
        np.testing.assert_array_equal(mine, theirs)
    assert len(rounds) == {2: 1, 3: 3, 4: 3, 8: 6}[p]
    for pairs in rounds:  # each round one partial permutation, both directions
        perm = pairs + [(b, a) for a, b in pairs]
        assert len({s for s, _ in perm}) == len(perm) == len({d for _, d in perm})


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


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The 3 ranks, started at the module's start; they run while the
    world-1 tests do."""
    import inspect

    tmp = tmp_path_factory.mktemp("sort_world3")
    spec = {"arrays": _arrays(), "cases": {k: v[0] for k, v in CASES.items()},
            "src": "\n".join(inspect.getsource(f) for f in (_build_env, _pack))}
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    (tmp / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), str(WORLD), port,
                               str(tmp / "spec.pkl"), str(tmp / "out.pkl")],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    yield tmp, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def world3(started):
    """The ranks' results; a rank that dies or hangs fails the caller."""
    tmp, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_world3_matches_heat_tpu(world3, case):
    expr, counts = CASES[case][:2]
    got, stats = world3[case]
    _same(got, _reference(case, C3), **_opts(case, WORLD))
    assert stats == counts, (stats, counts)
