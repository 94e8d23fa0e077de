"""The port's operator surface against heat_tpu, on the same seeded numpy
inputs: the elementwise modules (arithmetics, relational, logical,
rounding, exponential, trigonometrics, complex_math), the moments and
extrema of statistics, the cumulative operations, the op engine's
``out=``/``where=``, sanitation, memory, printing and manipulations.

At world size 1 the port runs in process against heat_tpu on a one-device
mesh (its values and types are its 8-device mesh's; the one-device mesh
compiles each program four times faster). At world size 2 the port runs
in ONE spawned gloo world shared by the module, against heat_tpu on a
two-device mesh, with uneven shapes (7 rows or 5 columns over 2 ranks, and
1 row: an empty shard) and the collective counts of ``comm.stats``.

Tolerances: ints and bools bitwise. Elementwise floats within 4 ulp of the
result type (two libms), of the larger operand for logaddexp (its result
cancels). Reductions and moments within rtol·S, S the same
reduction of |x| in float64 (Σ|x| for a sum), rtol 1e-6 for float32 and
1e-12 for float64, and for the half types 8 units of their rounding
(float16 2^-10 · 8, bfloat16 2^-7 · 8: heat_tpu and torch round partial
sums at other points). The third and fourth moments (skew, kurtosis),
ratios of differences, rtol 1e-5 (float32) of their O(1) values.
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
DTYPES = ["bool", "int32", "int64", "float16", "bfloat16", "float32", "float64", "complex64"]
FLOATS = ["float16", "bfloat16", "float32", "float64"]
EXACT = ["bool", "int32", "int64"]
_MANT = {"float16": 10, "bfloat16": 7, "float32": 23, "float64": 52, "complex64": 23,
         "complex128": 52}
_EMIN = {"float16": -14, "bfloat16": -126, "float32": -126, "float64": -1022,
         "complex64": -126, "complex128": -1022}
_RTOL = {"float16": 8 * 2.0 ** -10, "bfloat16": 8 * 2.0 ** -7, "float32": 1e-6,
         "float64": 1e-12, "complex64": 1e-6, "complex128": 1e-12}


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _data(dtype, shape=(7, 5), lo=-3.0, hi=3.0, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype in ("int32", "int64"):
        return rng.integers(int(np.floor(lo)), int(np.ceil(hi)) + 1, shape).astype(dtype)
    x = rng.uniform(lo, hi, shape)
    if dtype == "complex64":
        return (x + 1j * rng.uniform(lo, hi, shape)).astype(np.complex64)
    return x.astype({"float16": np.float16, "bfloat16": np.float32}.get(dtype, dtype))


def _arr(lib, a, dtype, split=None, comm=None):
    kw = {"comm": comm} if lib is hj else {}
    x = lib.array(a, split=split, **kw)
    return x.astype(lib.bfloat16) if dtype == "bfloat16" else x


def _np(x):
    v = np.asarray(x.numpy())
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def _ulp(w, name):
    a = np.abs(w.astype(np.complex128 if np.iscomplexobj(w) else np.float64))
    e = np.floor(np.log2(np.maximum(a, 2.0 ** _EMIN[name])))
    return 2.0 ** (e - _MANT[name])


def _same_meta(got, want):
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert tuple(got.gshape) == tuple(want.gshape), (got.gshape, want.gshape)
    assert got.split == want.split, (got.split, want.split)
    np.testing.assert_array_equal(got.lshape_map, want.lshape_map)


def _close(g, w, name, ulps=4, atol=None, ref=None, scale=None):
    """Values: exact types bitwise; floats within ``ulps`` ulp of the
    result type, or within ``atol`` where given; NaN and inf at the same
    places. Where ``ref`` (the float64 numpy value on the same inputs) is
    given, a value may also be no further from it than heat_tpu's plus that
    limit: heat_tpu's own functions are off by more in places (XLA's
    float64 arctanh by ~45 ulp, its float16 sinc rounds pi·x to float16)."""
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (g.shape, w.shape)
    if name in EXACT or name in ("uint8", "int8", "int16"):
        np.testing.assert_array_equal(g, w)
        return
    cplx = np.iscomplexobj(w)
    g64 = g.astype(np.complex128 if cplx else np.float64)
    w64 = w.astype(np.complex128 if cplx else np.float64)
    for part in ((np.real, np.imag) if cplx else (lambda v: v,)):
        gp, wp = part(g64), part(w64)
        np.testing.assert_array_equal(np.isnan(gp), np.isnan(wp))
        np.testing.assert_array_equal(np.isinf(gp) & (gp > 0), np.isinf(wp) & (wp > 0))
        np.testing.assert_array_equal(np.isinf(gp) & (gp < 0), np.isinf(wp) & (wp < 0))
    ok = np.isfinite(w64)
    err = np.abs(g64 - w64)[ok]
    basis = w64 if scale is None else np.maximum(np.abs(w64), scale)
    lim = (ulps * _ulp(basis, name) if atol is None else np.broadcast_to(atol, w64.shape))[ok]
    bad = err > lim
    if ref is not None:
        r = np.broadcast_to(ref, w64.shape)[ok]
        bad &= np.abs(g64[ok] - r) > np.abs(w64[ok] - r) + lim
    assert not bad.any(), f"{name}: {int(bad.sum())} values beyond limit, worst " \
                          f"{float((err - lim).max())} (got {g64[ok][bad][:4]}, want {w64[ok][bad][:4]})"


def _check(got, want, ulps=4, atol=None, ref=None, scale=None):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, ulps, atol)
        return
    _same_meta(got, want)
    _close(_np(got), _np(want), want.dtype.__name__, ulps, atol, ref, scale)


def _ref(fn, *xs):
    """``fn`` in float64 (complex128) on the inputs as the arrays hold them."""
    vals = [_np(x) for x in xs]
    vals = [v.astype(np.complex128 if np.iscomplexobj(v) else np.float64) for v in vals]
    with np.errstate(all="ignore"):
        return fn(*vals)


# float64 references of the functions where heat_tpu's values drift
_NP_REF = {"arctanh": np.arctanh, "sinc": np.sinc, "cosh": np.cosh, "sinh": np.sinh,
           "logaddexp": np.logaddexp, "logaddexp2": np.logaddexp2, "pow": np.power}


# --------------------------------------------------------------------------- #
# elementwise functions at world size 1, over every type heat_tpu takes       #
# --------------------------------------------------------------------------- #

# name -> (domain low, high, types heat_tpu refuses)
_UNARY = {
    "exp": (-3, 3, ()), "exp2": (-3, 3, ()), "expm1": (-3, 3, ()), "log": (0.1, 9, ()),
    "log2": (0.1, 9, ()), "log10": (0.1, 9, ()), "log1p": (0.1, 9, ()), "sqrt": (0, 9, ()),
    "square": (-3, 3, ()), "i0": (-3, 3, ("complex64",)),
    "arccos": (-0.9, 0.9, ()), "arccosh": (1.1, 4, ()), "arcsin": (-0.9, 0.9, ()),
    "arcsinh": (-3, 3, ()), "arctan": (-3, 3, ()), "arctanh": (-0.9, 0.9, ()),
    "cos": (-3, 3, ()), "cosh": (-3, 3, ()), "deg2rad": (-90, 90, ()),
    "rad2deg": (-3, 3, ()), "sin": (-3, 3, ()), "sinc": (-3, 3, ()), "sinh": (-3, 3, ()),
    "tan": (-1.2, 1.2, ()), "tanh": (-3, 3, ()),
    "abs": (-3, 3, ()), "ceil": (-3, 3, ("complex64",)), "fabs": (-3, 3, ("complex64",)),
    "fix": (-3, 3, ("complex64",)), "floor": (-3, 3, ("complex64",)),
    "nan_to_num": (-3, 3, ()), "round": (-3, 3, ("bool",)), "sgn": (-3, 3, ("bool",)),
    "sign": (-3, 3, ("bool",)), "trunc": (-3, 3, ("complex64",)),
    "modf": (-3, 3, ("complex64",)),
    "isfinite": (-3, 3, ()), "isinf": (-3, 3, ()), "isnan": (-3, 3, ()),
    "isneginf": (-3, 3, ("complex64",)), "isposinf": (-3, 3, ("complex64",)),
    "logical_not": (-3, 3, ()), "signbit": (-3, 3, ("complex64",)),
    "angle": (-3, 3, ()), "conjugate": (-3, 3, ()), "imag": (-3, 3, ()), "real": (-3, 3, ()),
    "neg": (-3, 3, ("bool",)), "pos": (-3, 3, ()),
    "invert": (-3, 3, ("float16", "bfloat16", "float32", "float64", "complex64")),
}
# every type for one function of each type rule (the inexact rule of exp
# holds for cos), float32 for every function, float16 for some
_UNARY_ALL_TYPES = ("exp", "abs", "floor", "round", "sign", "angle", "invert", "square", "imag",
                    "signbit")
_UNARY_HALF = ("sinc", "tanh", "arctanh")
_UNARY_CASES = [(f, dt) for f, (_, _, no) in _UNARY.items() for dt in DTYPES if dt not in no
                and (f in _UNARY_ALL_TYPES or dt == "float32"
                     or (dt == "float16" and f in _UNARY_HALF)
                     or (dt == "int32" and f in ("modf", "sqrt")))]


@pytest.mark.parametrize("name,dtype", _UNARY_CASES, ids=[f"{f}-{d}" for f, d in _UNARY_CASES])
def test_unary_matches_heat_tpu(name, dtype):
    lo, hi, _ = _UNARY[name]
    a = _data(dtype, lo=lo, hi=hi, seed=len(name))
    x = _arr(ht, a, dtype, split=0)
    got = getattr(ht, name)(x)
    want = getattr(hj, name)(_arr(hj, a, dtype, split=0, comm=C1))
    _check(got, want, ref=_ref(_NP_REF[name], x) if name in _NP_REF else None)


# name -> types heat_tpu refuses (for the same type on both sides)
_BINARY = {
    "add": (), "sub": ("bool",), "mul": (), "div": (), "floordiv": ("complex64",),
    "fmod": ("complex64",), "mod": ("complex64",), "pow": (),
    "bitwise_and": ("float16", "bfloat16", "float32", "float64", "complex64"),
    "bitwise_or": ("float16", "bfloat16", "float32", "float64", "complex64"),
    "bitwise_xor": ("float16", "bfloat16", "float32", "float64", "complex64"),
    "left_shift": ("float16", "bfloat16", "float32", "float64", "complex64"),
    "right_shift": ("float16", "bfloat16", "float32", "float64", "complex64"),
    "heaviside": ("complex64",), "logaddexp": ("complex64",), "logaddexp2": ("complex64",),
    "arctan2": ("complex64",), "hypot": ("complex64",), "copysign": ("complex64",),
    "maximum": ("complex64",), "minimum": ("complex64",),
    "eq": (), "ne": (), "lt": ("complex64",), "le": ("complex64",), "gt": ("complex64",),
    "ge": ("complex64",), "logical_and": (), "logical_or": (), "logical_xor": (),
    "isclose": ("bool",),
}
_BINARY_ALL_TYPES = ("add", "div", "floordiv", "pow", "lt")
_BINARY_INT = ("fmod", "mod", "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
               "right_shift", "eq", "logical_and", "maximum")
_BINARY_CASES = [(f, dt) for f, no in _BINARY.items() for dt in DTYPES if dt not in no
                 and (f in _BINARY_ALL_TYPES or dt == "float32"
                      or (dt == "int32" and f in _BINARY_INT)
                      or (dt == "float16" and f == "logaddexp"))]
# operands kept away from zero where an integer divides (torch raises on a
# zero integer divisor of a CPU tensor; jnp returns a value)
_POSITIVE_RHS = ("floordiv", "fmod", "mod", "div", "pow", "left_shift", "right_shift")


def _rhs(name, dtype):
    if dtype == "bool" and name in _POSITIVE_RHS:
        return np.ones((7, 5), dtype=bool)
    if name in ("left_shift", "right_shift"):
        return _data(dtype, lo=0, hi=4, seed=2)
    if name == "pow":
        return _data(dtype, lo=0, hi=3, seed=2)
    if name in _POSITIVE_RHS:
        return _data(dtype, lo=1, hi=4, seed=2)
    return _data(dtype, seed=2)


@pytest.mark.parametrize("name,dtype", _BINARY_CASES, ids=[f"{f}-{d}" for f, d in _BINARY_CASES])
def test_binary_matches_heat_tpu(name, dtype):
    a = _data(dtype, lo=0.5 if name == "pow" else -3, seed=1)
    b = _rhs(name, dtype)
    x, y = _arr(ht, a, dtype, split=0), _arr(ht, b, dtype, split=0)
    got = getattr(ht, name)(x, y)
    want = getattr(hj, name)(_arr(hj, a, dtype, split=0, comm=C1),
                             _arr(hj, b, dtype, split=0, comm=C1))
    # logaddexp's result cancels: 4 ulp of the larger operand
    scale = np.maximum(np.abs(_np(x)), np.abs(_np(y))) if name.startswith("logaddexp") else None
    _check(got, want, ref=_ref(_NP_REF[name], x, y) if name in _NP_REF else None, scale=scale)


# mixed operand types: the promotion of two arrays, with the op's rule
_MIXED = [("add", "int32", "float16"), ("add", "bool", "int64"), ("add", "int32", "float32"),
          ("mul", "float32", "float64"), ("add", "bfloat16", "float16"),
          ("sub", "int64", "complex64"), ("div", "int32", "int64"), ("div", "bool", "int32"),
          ("floordiv", "bool", "bool"), ("pow", "bool", "bool"), ("mod", "int32", "float32"),
          ("arctan2", "int32", "int32"), ("lt", "int32", "float16"), ("eq", "bool", "float32")]


@pytest.mark.parametrize("name,d1,d2", _MIXED, ids=[f"{f}-{a}-{b}" for f, a, b in _MIXED])
def test_mixed_type_promotion_matches_heat_tpu(name, d1, d2):
    a, b = _data(d1, lo=1, hi=4, seed=3), _data(d2, lo=1, hi=4, seed=4)
    if d2 == "bool":
        b = np.ones_like(b)  # a zero integer divisor raises in torch
    got = getattr(ht, name)(_arr(ht, a, d1), _arr(ht, b, d2, split=1))
    want = getattr(hj, name)(_arr(hj, a, d1, comm=C1), _arr(hj, b, d2, split=1, comm=C1))
    _check(got, want)


def test_zero_dim_array_operand_promotes_like_heat_tpu():
    """A 0-d DNDarray is an array, not a weak scalar: float32 with a 0-d
    float64 is float64, float16 with a 0-d float32 float32, as heat_tpu
    gives them (torch's own rule keeps the shaped operand's type)."""
    pairs = [("float32", "float64"), ("float16", "float32"), ("bfloat16", "float64"),
             ("int32", "int64"), ("bool", "int32")]
    for d1, d2 in pairs:
        a, b = _data(d1, (3, 4), seed=24), _data(d2, (), seed=25)
        for op in ("+", "*"):
            got = eval(f"x {op} y", {"x": _arr(ht, a, d1, split=0), "y": _arr(ht, b, d2)})
            want = eval(f"x {op} y", {"x": _arr(hj, a, d1, split=0, comm=C1),
                                      "y": _arr(hj, b, d2, comm=C1)})
            _check(got, want)
    # the sum of a 0-d bool or int32 is int64, as of any other shape
    for d in ("bool", "int32"):
        b = _data(d, (), seed=26)
        _check(ht.sum(_arr(ht, b, d)), hj.sum(_arr(hj, b, d, comm=C1)))


_SCALARS = {"bool": True, "int": 3, "float": 0.3, "complex": 0.5 - 1j}


@pytest.mark.parametrize("scalar", list(_SCALARS))
@pytest.mark.parametrize("dtype", ["bool", "int32", "float16", "float32"])
def test_python_scalar_operands_match_heat_tpu(dtype, scalar):
    """A python scalar is weakly typed (its kind decides, not its width),
    on either side of the operator: ``x - s``, ``s / x`` and ``x > s``
    (``+`` and ``**`` in tests/test_torch_core.py)."""
    a = _data(dtype, lo=1, hi=4, seed=5)
    s = _SCALARS[scalar]
    exprs = ["s / x"] + (["x > s"] if scalar != "complex" else []) \
        + (["x - s"] if not (dtype == "bool" and scalar == "bool") else [])
    for expr in exprs:
        want = eval(expr, {"s": s, "x": _arr(hj, a, dtype, split=0, comm=C1)})  # noqa: S307
        got = eval(expr, {"s": s, "x": _arr(ht, a, dtype, split=0)})  # noqa: S307
        _check(got, want)


def test_aliases_are_the_same_functions():
    for alias, name in (("acos", "arccos"), ("asin", "arcsin"), ("atan", "arctan"),
                        ("atan2", "arctan2"), ("acosh", "arccosh"), ("asinh", "arcsinh"),
                        ("atanh", "arctanh"), ("radians", "deg2rad"), ("degrees", "rad2deg"),
                        ("absolute", "abs"), ("round_", None), ("conj", "conjugate"),
                        ("divide", "div"), ("floor_divide", "floordiv"), ("remainder", "mod"),
                        ("multiply", "mul"), ("subtract", "sub"), ("negative", "neg"),
                        ("positive", "pos"), ("power", "pow"), ("bitwise_not", "invert"),
                        ("cumproduct", "cumprod"), ("greater", "gt"), ("greater_equal", "ge"),
                        ("less", "lt"), ("less_equal", "le"), ("equal", None),
                        ("not_equal", "ne")):
        assert hasattr(hj, alias) and hasattr(ht, alias), alias
        if name is not None:
            assert getattr(ht, alias) is getattr(ht, name), alias
    assert hasattr(hj, "where") and ht.where is ht.indexing.where


def test_clip_round_decimals_and_scalar_predicates_match_heat_tpu():
    a = _data("float32", seed=6)
    for lib, kw in ((ht, {}), (hj, {"comm": C1})):
        x = lib.array(a, split=0, **kw)
        lib._r = (lib.clip(x, -1.0, 2.0), lib.clip(x, min=0.5), lib.round(x, 2),
                  lib.round(x * 10, -1), lib.abs(x, dtype=lib.float64), x.clip(-1, 1),
                  lib.nan_to_num(x / 0.0, posinf=9.0))
    _check(ht._r, hj._r)
    b = _data("float32", seed=7)
    for f in ("equal", "allclose"):
        for other in (a, a + 1e-7, b):
            assert getattr(ht, f)(ht.array(a), ht.array(other)) == \
                getattr(hj, f)(hj.array(a, comm=C1), hj.array(other, comm=C1)), f
    assert ht.equal(ht.array(a), ht.array(a[:3])) is False


# the faults ROADMAP queue 3 named, each against heat_tpu: sign of NaN, an
# integer round with decimals < 0, a bool argmax/argmin off the split axis,
# an integer clip with float bounds
_REPAIRED = {
    "sign_nan_float32": lambda lib, kw: lib.sign(lib.array(
        np.array([[np.nan, -1.5, 0.0], [2.0, np.nan, -0.0]], np.float32), split=0, **kw)),
    "sign_nan_float16": lambda lib, kw: lib.sign(lib.array(
        np.array([np.nan, -3.0, 0.5, np.nan], np.float16), split=0, **kw)),
    "round_int_negative_decimals": lambda lib, kw: lib.round(lib.array(
        np.array([[-7, 7, -3, 5], [3, -2, 9, -8]], np.int32), split=0, **kw), -1),
    "argmax_argmin_bool": lambda lib, kw: (lambda b: (lib.argmax(b, 1), lib.argmin(b, 0)))(
        lib.array(np.array([[False, True, False, True], [True, False, True, False]]), split=0,
                  **kw)),
    "clip_int_float_bounds": lambda lib, kw: (lambda k: (lib.clip(k, -1.5, 2.5),
                                                         lib.clip(k, None, 2.5)))(
        lib.array(np.array([[-7, 7, -3, 5], [3, -2, 9, -8]], np.int32), split=0, **kw)),
}


@pytest.mark.parametrize("case", list(_REPAIRED))
def test_repaired_faults_match_heat_tpu(case):
    """heat_tpu: NaN keeps its sign NaN; an integer round with decimals < 0
    raises NotImplementedError; argmax(b, 1) is int64 [0, 2] and
    argmin(b, 0) [1, 0, 0, 1]; an int32 clip with float bounds is float64."""
    fn = _REPAIRED[case]
    try:
        want = fn(hj, {"comm": C1})
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            fn(ht, {})
        return
    _check(fn(ht, {}), want, ulps=0)


# --------------------------------------------------------------------------- #
# reductions, moments and cumulative operations at world size 1               #
# --------------------------------------------------------------------------- #

def _scale(name, a, axis):
    """S of the tolerance: the reduction applied to |x| in float64."""
    x = np.abs(np.asarray(a).astype(np.complex128 if np.iscomplexobj(a) else np.float64))
    ax = axis
    if name in ("sum", "nansum", "cumsum", "nancumsum"):
        return x.sum(ax)
    if name in ("prod", "nanprod", "cumprod", "nancumprod"):
        return np.maximum(x, 1).prod(ax)
    if name in ("var", "nanvar"):
        return (x ** 2).mean(ax)
    if name in ("std", "nanstd"):
        return np.sqrt((x ** 2).mean(ax))
    return x.max(ax)


_SOME = ["bool", "int32", "float32"]
_REDUCE = {
    "sum": DTYPES, "mean": DTYPES, "cumsum": DTYPES, "prod": _SOME, "cumprod": _SOME,
    "var": ["int32", "float16", "bfloat16", "float32", "float64"], "std": ["float32"],
    "max": _SOME, "min": ["float32"], "all": ["int32"], "any": ["float32"], "argmax": _SOME,
    "argmin": ["float32"], "ptp": ["float32"], "nansum": ["float32"], "nanprod": ["float32"],
    "nanmax": ["float32"], "nanmin": ["float32"], "nanmean": ["float16", "float32"],
    "nanvar": ["float32"], "nanstd": ["float32"], "nanargmax": ["float32"],
    "nanargmin": ["float32"], "nancumsum": ["float32"], "nancumprod": ["float32"],
    "count_nonzero": ["float32"],
}
_REDUCE_CASES = [(f, dt, ax) for f, dts in _REDUCE.items() for dt in dts
                 for ax in ((None, 0) if f in ("sum", "var", "argmax") and dt == "float32"
                            else (0,))]


def _reduce_call(lib, name, x, axis):
    f = getattr(lib, name)
    if name in ("cumsum", "cumprod", "nancumsum", "nancumprod"):
        return f(x, axis)
    return f(x, axis=axis)


@pytest.mark.parametrize("name,dtype,axis", _REDUCE_CASES,
                         ids=[f"{f}-{d}-{a}" for f, d, a in _REDUCE_CASES])
def test_reduction_matches_heat_tpu(name, dtype, axis):
    lo, hi = (0.5, 1.5) if "prod" in name else (-3, 3)
    a = _data(dtype, lo=lo, hi=hi, seed=8)
    if name.startswith("nan") and dtype not in EXACT:
        a = a.copy()
        a[1, 2] = a[4, 0] = np.nan
    got = _reduce_call(ht, name, _arr(ht, a, dtype, split=0), axis)
    want = _reduce_call(hj, name, _arr(hj, a, dtype, split=0, comm=C1), axis)
    kind = want.dtype.__name__
    scale = _scale(name, np.nan_to_num(a.astype(np.float32) if dtype == "bfloat16" else a),
                   axis)
    if name.startswith("cum") or name.startswith("nancum"):
        scale = np.abs(np.nan_to_num(a.astype(np.float64) if dtype != "complex64" else a))
        scale = (np.maximum(scale, 1).cumprod(axis) if "prod" in name
                 else scale.cumsum(axis))
    _check(got, want, atol=_RTOL.get(kind, 0) * np.broadcast_to(scale, np.shape(_np(want)))
           if kind in _RTOL else None)


@pytest.mark.parametrize("dtype", ["float32"])
def test_third_and_fourth_moments_and_average_match_heat_tpu(dtype):
    a = _data(dtype, seed=9)
    w = _data("float32", lo=0.5, hi=2, seed=10)
    res = {}
    for lib, kw in ((ht, {}), (hj, {"comm": C1})):
        x = lib.array(a, split=0, **kw)
        res[lib] = (lib.skew(x, 0), lib.skew(x, None, unbiased=False), lib.kurtosis(x, 0),
                    lib.kurtosis(x, 1, Fischer=False), lib.var(x, 0, ddof=1),
                    lib.var(x, ddof=7 * 5), lib.std(x, 1, ddof=2), lib.mean(x, (0, 1)))
        res[lib, "avg"] = (lib.average(x, axis=0, weights=lib.array(w, split=0, **kw)),
                           lib.average(x, axis=1, weights=lib.array(w[0], **kw)),
                           lib.average(x), lib.average(x, 0, returned=True))
    for g, w_ in zip(res[ht], res[hj]):
        _check(g, w_, atol=1e-5 * max(1.0, float(np.nanmax(np.abs(_np(w_))))))
    _check(res[ht, "avg"], res[hj, "avg"], atol=1e-5 * 3)


def test_type_table_matches_heat_tpu():
    """The types torch gives otherwise: cumsum of int32 stays int32, the
    mean and variance of int32 are float64, its product int64, int32 /
    int32 and sqrt(int32) float32, the mean and variance of float16 stay
    float16, a bool cumsum is int64, argmax is int64 and replicated along
    the split axis, and var with ddof >= n is NaN."""
    i = _data("int32", lo=1, hi=9, seed=11)
    h = _data("float16", seed=12)
    bo = _data("bool", seed=13)
    res = {}
    for lib, kw in ((ht, {}), (hj, {"comm": C1})):
        x, y = lib.array(i, split=0, **kw), lib.array(i[::-1].copy(), split=0, **kw)
        hh, b = lib.array(h, split=0, **kw), lib.array(bo, split=0, **kw)
        res[lib] = (lib.cumsum(x, 0), lib.mean(x), lib.var(x), lib.prod(x), x / y, lib.sqrt(x),
                    lib.mean(hh), lib.var(hh), lib.cumsum(b, 0), lib.argmax(x, 0),
                    lib.var(x, 0, ddof=7))
    names = ["int32", "float64", "float64", "int64", "float32", "float32", "float16",
             "float16", "int64", "int64", "float64"]
    assert [r.dtype.__name__ for r in res[ht]] == names
    assert res[ht][9].split is None
    assert np.isnan(_np(res[ht][10])).all()
    for g, w in zip(res[ht], res[hj]):
        _check(g, w, atol=_RTOL.get(w.dtype.__name__, 0) * 64 * 8.0)


@pytest.mark.parametrize("shape,axis", [((3000, 3), 0), ((2, 2500, 3), 1)],
                         ids=["3000x3-axis0", "2x2500x3-axis1"])
def test_long_scans_run_in_blocks_like_heat_tpu(shape, axis):
    """A scan along an axis longer than ``_SCAN_BLOCK`` with few trailing
    elements runs in blocks (torch's own is one thread per trailing
    element): cumsum and cumprod of float32 and int32 as heat_tpu's, float32
    within 1e-6 of the running sum of |x| (of the running product of
    max(|x|, 1))."""
    from heat_tpu_torch.core import arithmetics

    assert shape[axis] > arithmetics._SCAN_BLOCK
    for dtype in ("float32", "int32"):
        a = _data(dtype, shape, lo=0.99 if dtype == "float32" else 0, hi=1.01 if dtype ==
                  "float32" else 1, seed=23)
        for name in ("cumsum", "cumprod"):
            got = getattr(ht, name)(ht.array(a, split=0), axis)
            want = getattr(hj, name)(hj.array(a, split=0, comm=C1), axis)
            scale = np.abs(a.astype(np.float64))
            scale = np.maximum(scale, 1).cumprod(axis) if name == "cumprod" else scale.cumsum(axis)
            _check(got, want, atol=1e-6 * scale if dtype == "float32" else None)


@pytest.mark.parametrize("shape,axis", [((601, 3), 0), ((2, 77, 3), 1)],
                         ids=["601x3-axis0", "2x77x3-axis1"])
def test_scan_block_recursion_matches_heat_tpu(monkeypatch, shape, axis):
    """With blocks of 8 the scan of the block totals is itself blocked
    (601 rows: 76 blocks, whose totals are scanned in 10 blocks), as on the card for
    axes longer than 1024²: cumsum and cumprod as heat_tpu's (int32
    bitwise, so a prior off by one block shows), and the float32 cumsum
    within chip_smoke.py's bound of the blocked scan, γ of
    ``scan_chain(n, block)`` times the running sum of |x|."""
    from heat_tpu_torch.core import arithmetics

    cs = _smoke_module()
    monkeypatch.setattr(arithmetics, "_SCAN_BLOCK", 8)
    n = shape[axis]
    assert -(-n // 8) > 8  # the block totals are scanned in blocks too
    for dtype in ("float32", "int32"):
        a = _data(dtype, shape, lo=0.99 if dtype == "float32" else -2,
                  hi=1.01 if dtype == "float32" else 2, seed=28)
        for name in ("cumsum", "cumprod"):
            got = getattr(ht, name)(ht.array(a, split=0), axis)
            want = getattr(hj, name)(hj.array(a, split=0, comm=C1), axis)
            absx = np.abs(a.astype(np.float64))
            scale = np.maximum(absx, 1).cumprod(axis) if name == "cumprod" else absx.cumsum(axis)
            _check(got, want, atol=1e-6 * scale if dtype == "float32" else None)
            if dtype == "float32" and name == "cumsum":
                err = np.abs(_np(got).astype(np.float64) - a.astype(np.float64).cumsum(axis))
                assert (err <= cs.gamma(cs.scan_chain(n, 8)) * scale).all()


def _smoke_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------- #
# out= / where=, DNDarray methods and dunders, indexing, setitem              #
# --------------------------------------------------------------------------- #

def test_out_and_where_match_heat_tpu():
    a, b = _data("float32", seed=14), _data("float32", seed=15)
    res = {}
    for lib, kw in ((ht, {}), (hj, {"comm": C1})):
        x, y = lib.array(a, split=0, **kw), lib.array(b, split=1, **kw)
        o1 = lib.zeros((7, 5), split=1, **kw)
        r1 = lib.add(x, y, out=o1)
        o2 = lib.array(b, split=0, **kw)
        lib.mul(x, 2.0, out=o2, where=x > 0)
        o3 = lib.zeros((7, 5), dtype=lib.int32, split=None, **kw)
        lib.sub(x, 0.5, out=o3, where=lib.array(a[0] > 0, **kw))
        o4 = lib.zeros((5,), **kw)
        lib.sum(x, 0, out=o4)
        o5 = lib.zeros((7, 5), split=0, **kw)
        lib.sqrt(lib.abs(x), out=o5)
        o6 = lib.zeros((7, 5), split=1, **kw)
        lib.cumsum(x, 0, out=o6)
        res[lib] = (o1, o2, o3, o4, o5, o6)
        assert r1 is o1
    _check(res[ht], res[hj], atol=1e-6 * 3 * 7)
    with pytest.raises(ValueError):
        ht.add(ht.array(a), 1.0, where=ht.array(a) > 0)
    with pytest.raises(ValueError):
        ht.add(ht.array(a), 1.0, out=ht.zeros((3,)))


def test_dndarray_methods_and_dunders_match_heat_tpu():
    a, b = _data("float32", lo=0.5, hi=3, seed=16), _data("int32", lo=1, hi=5, seed=17)
    z = _data("complex64", seed=18)
    res, scalars = {}, {}
    for lib, kw in ((ht, {}), (hj, {"comm": C1})):
        x, i, c = (lib.array(a, split=0, **kw), lib.array(b, split=1, **kw),
                   lib.array(z, split=0, **kw))
        res[lib] = (x.T, i.T, c.real, c.imag, x.prod(0), x.cumsum(0), x.cumprod(1), x.mean(0),
                    x.var(1), x.std(), x.max(0), x.argmax(1), x.min(), x.argmin(), x.all(0),
                    x.any(), x.abs(), x.exp(), x.log(), x.sqrt(), x.sin(), x.cos(),
                    x.clip(1, 2), x.isclose(x + 1e-6), lib.copy(x), lib.copy(i),
                    -x, +x, abs(-x), ~i, x // 0.7, 0.7 // x, x % 0.7, 2.0 % x, divmod(i, 3),
                    divmod(7, i), 3 & i, i | 4, i ^ 5, 6 ^ i, i << 1, 1 << i, i >> 1, 64 >> i,
                    2 ** x, x ** 0.5, x <= 1.5, x >= 1.5, x < i, x != i, 3 - x, 3 / x, 3 * x,
                    lib.resplit(x, 1), lib.scalar_to_1d(x[0, 0]), x[0, 0].astype(lib.float64))
        scalars[lib] = (bool(x[1, 1] > 1), int(i[2, 2]), float(x[3, 3]), complex(c[0, 0]),
                        len(x), x[0].tolist(), x.allclose(x), lib.sanitize_infinity(i),
                        lib.sanitize_infinity(x), x.item() if x.size == 1 else None,
                        list(range(9))[i[0, 0]], x in ("kmeans++", "random"))
    _check(res[ht], res[hj])
    assert scalars[ht] == scalars[hj]
    with pytest.raises(TypeError):
        hash(ht.array(a))
    with pytest.raises(TypeError):
        ht.sanitize_in(a)


def test_str_and_printing_match_heat_tpu(capsys):
    a = _data("float32", seed=19)
    x, y = ht.array(a, split=0), hj.array(a, split=0, comm=C1)
    assert str(x).split(", dtype=")[0] == str(y).split(", dtype=")[0]
    assert "dtype=ht.float32" in str(x) and "split=0" in repr(x)
    ht.print0("hello", x[0, 0])
    assert capsys.readouterr().out.startswith("hello DNDarray(")
    before = np.get_printoptions()
    try:
        ht.set_printoptions(precision=2)
        hj.set_printoptions(precision=2)
        assert str(x).split(", dtype=")[0] == str(y).split(", dtype=")[0]
        ht.set_printoptions(profile="full")
        assert np.get_printoptions()["threshold"] == int(1e9)
    finally:
        np.set_printoptions(**{k: v for k, v in before.items() if k != "legacy"})


_KEYS = [(slice(1, 6),), (slice(None, None, -2), 1), (2,), (-1, slice(1, 4)),
         (Ellipsis, 3), (slice(5, 1, -1), slice(None, None, 2)), (slice(3, 3),)]


@pytest.mark.parametrize("split", [1])
def test_basic_getitem_and_setitem_match_heat_tpu(split):
    a = _data("float32", seed=20)
    for key in _KEYS:
        got, want = ht.array(a, split=split)[key], hj.array(a, split=split, comm=C1)[key]
        _check(got, want)
        for value in (7.5, "row"):
            xt, xj = ht.array(a, split=split), hj.array(a, split=split, comm=C1)
            if value == "row":
                shape = np.shape(a[key])
                v = _data("float32", shape=shape[-1:] if shape else (), seed=21)
                vt, vj = ht.array(v), hj.array(v, comm=C1)
            else:
                vt = vj = value
            xt[key] = vt
            xj[key] = vj
            _check(xt, xj)


_DERIVED = {"resplit_1": lambda x: x.resplit(1), "resplit_none": lambda x: x.resplit(None),
            "resplit_noop": lambda x: x.resplit(0), "transpose": lambda x: x.T,
            "real": lambda x: x.real, "transpose_twice": lambda x: x.T.T,
            "reshape": lambda x: x.reshape((5, 7)), "squeeze": lambda x: x[:1].squeeze(),
            "expand_dims": lambda x: x.expand_dims(1), "swapaxes": lambda x: x.swapaxes(0, 1),
            "balance": lambda x: x.balance()}


@pytest.mark.parametrize("derive", list(_DERIVED))
def test_write_into_derived_array_leaves_source_like_heat_tpu(derive):
    """A write into the result of a resplit (a local move at world size 1),
    ``.T`` or ``real`` changes that result only, as heat_tpu's functional
    setitem does; so does a write into the source, for the result."""
    a = _data("float32", seed=27)
    res = {}
    for lib, kw in ((ht, {}), (hj, {"comm": C1})):
        x = lib.array(a, split=0, **kw)
        y = _DERIVED[derive](x)
        y[1] = 9.0
        x2 = lib.array(a, split=0, **kw)
        y2 = _DERIVED[derive](x2)
        x2[0] = -9.0
        res[lib] = (x, y, x2, y2)
    _check(res[ht], res[hj], ulps=0)


def test_sanitation_helpers():
    x = ht.array(_data("float32", seed=22), split=0)
    ht.sanitize_in(x)
    out = ht.zeros((7, 5), split=1)
    ht.sanitation.sanitize_out(out, (7, 5), 0, x.device)
    assert out.split == 0
    with pytest.raises(ValueError):
        ht.sanitation.sanitize_out(out, (5, 7), 0, x.device)
    with pytest.raises(TypeError):
        ht.sanitation.sanitize_out(np.zeros(3), (3,), None, x.device)
    one = ht.scalar_to_1d(ht.array(3.0))
    assert one.shape == (1,) and one.numpy().tolist() == [3.0]
    assert ht.scalar_to_1d(x) is x
    assert ht.sanitize_infinity(ht.array([1, 2], dtype=ht.int32)) == 2 ** 31 - 1
    assert ht.sanitize_infinity(x) == float("inf")


# --------------------------------------------------------------------------- #
# one 2-rank gloo world for the module                                        #
# --------------------------------------------------------------------------- #

# the arrays of the world-2 cases: name -> (data, split); uneven along the
# split axis (7 rows, 5 columns over 2 ranks) and one row (rank 1 empty)
def _world_arrays():
    nan = _data("float32", seed=30)
    nan[1, 2] = nan[4, 0] = nan[6, 4] = np.nan
    return {
        "A": (_data("float32", seed=31), 0), "B": (_data("float32", seed=32), 1),
        "C": (_data("float32", seed=33), None), "E": (_data("float32", (1, 5), seed=34), 0),
        "I": (_data("int32", lo=1, hi=9, seed=35), 0), "J": (_data("int32", lo=1, hi=5, seed=36), 1),
        "Bo": (_data("bool", seed=37), 0), "H": (_data("float16", seed=38), 0),
        "F": (_data("bfloat16", seed=39), "1bf16"), "Z": (_data("complex64", seed=40), 0),
        "W": (_data("float32", lo=0.5, hi=2, seed=41), 0), "N": (nan, 0),
        "T3": (_data("float32", (4, 6, 5), seed=42), 1), "R": (_data("float32", (5,), seed=43), None),
        "V": (_data("float32", (7,), lo=0.5, hi=2, seed=44), 0),
        "X": (_data("float32", lo=0.1, hi=0.9, seed=45), 1),
        "Y": (_data("float32", lo=0.1, hi=0.9, seed=46), 0),
        "K": (_data("int32", lo=1, hi=4, seed=47), 0), "Zc": (_data("complex64", seed=48), 1),
    }


# name -> (expression over the arrays, expected collective counts or None,
# options): the distributed cases, each held against heat_tpu: on two
# devices where ``ref="C2"`` (the alignment, indexing, assignment, out= and
# resplit cases, whose layout heat_tpu decides), else on one device (its
# values do not depend on the mesh, and its one-device programs compile
# faster), and all against heat_tpu's two-device lshape_map. With NaNs,
# heat_tpu's min along the split axis is the exception (one device: NaN,
# as numpy; two: 22.0 for the column, inf overall; eight: no NaN): the port
# keeps the NaN at every world size, as heat_tpu's one device gives it.
WORLD_CASES = {
    # op engine: alignment, broadcasting, scalars, out= / where=
    "add_split0_split1": ("A + B", {"all_to_all": 1}, {"ref": "C2"}),
    "sub_split_replicated": ("A - C", {}),
    "mul_row_broadcast": ("A * R", {}),
    "add_extent1_split": ("A + E", {"all_gather": 1}),
    "rdiv_scalar": ("1.0 / (A + 4)", {}), "rsub_scalar": ("2 - I", {}),
    "out_resplit": ("lib.add(A, 1.0, out=zeros((7, 5), 1))", None, {"ref": "C2"}),
    "where_mask": ("lib.mul(A, C, out=zeros((7, 5), 0), where=A > 0)", None, {"ref": "C2"}),
    "where_broadcast_mask": ("lib.sub(B, 1.0, out=zeros((7, 5), 1), where=R > 0)", None, {"ref": "C2"}),
    "floordiv_mixed_splits": ("I // J", {"all_to_all": 1}), "truediv_int": ("I / 3", {}),
    "le_mixed_splits": ("A <= B", {"all_to_all": 1}),
    "arctan2_mixed_splits": ("lib.arctan2(A, B)", {"all_to_all": 1}),
    "minimum_mixed_splits": ("lib.minimum(A, B)", {"all_to_all": 1}),
    "count_nonzero": ("lib.count_nonzero(I > 4, 0)", {"all_reduce": 1}),
    "all_split": ("lib.all(Bo, 0)", {"all_reduce": 1}), "any_all": ("lib.any(Bo)", {"all_reduce": 1}),
    "any_nonsplit": ("lib.any(Bo, 1)", {}),
    # reductions
    "sum_split": ("lib.sum(A, 0)", {"all_reduce": 1}), "sum_nonsplit": ("lib.sum(A, 1)", {}),
    "sum_all_B": ("B.sum()", {"all_reduce": 1}), "sum_empty_shard": ("lib.sum(E, 0)", {"all_reduce": 1}),
    "prod_split": ("lib.prod(I, 0)", {"all_reduce": 1}), "max_split": ("lib.max(A, 0)", {"all_reduce": 1}),
    "min_split_nan": ("lib.min(N, 0)", {"all_reduce": 1}),
    "max_keepdims": ("lib.max(B, 1, keepdims=True)", {"all_reduce": 1}),
    "min_nonsplit": ("lib.min(B, 0)", {}),
    "argmax_split": ("lib.argmax(A, 0)", {"all_gather": 1}), "argmin_flat_B": ("lib.argmin(B)", {"all_gather": 1}),
    "argmax_flat_A": ("lib.argmax(A)", {"all_gather": 1}), "argmin_empty_shard": ("lib.argmin(E, 0)", {"all_gather": 1}),
    "argmax_nonsplit": ("lib.argmax(B, 0)", {}), "argmax_nan": ("lib.argmax(N, 0)", {"all_gather": 1}),
    # moments
    "mean_split": ("lib.mean(A, 0)", {"all_reduce": 1}), "mean_nonsplit": ("lib.mean(A, 1)", {}),
    "mean_all": ("lib.mean(B)", {"all_reduce": 1}), "var_split": ("lib.var(A, 0)", {"all_reduce": 2}),
    "std_split": ("lib.std(A, 0)", {"all_reduce": 2}), "var_split1": ("lib.var(B, 1)", {"all_reduce": 2}),
    "var_nonsplit": ("lib.var(A, 1)", {}), "var_ddof": ("lib.var(A, ddof=1)", {"all_reduce": 2}),
    "std_3d": ("lib.std(T3, 1)", {"all_reduce": 2}),
    "average_split": ("lib.average(A, axis=0, weights=W)", {"packed_all_reduce": 1}),
    "average_1d_weights": ("lib.average(A, axis=0, weights=V)", {"packed_all_reduce": 1}),
    "average_nonsplit": ("lib.average(B, axis=0, weights=W)", None),
    "skew": ("lib.skew(A, 0)", None, {"atol": 1e-5}),
    "kurtosis": ("lib.kurtosis(B, 1)", None, {"atol": 1e-5}),
    "ptp": ("lib.ptp(A, 0)", {"all_reduce": 2}),
    "mean_int": ("lib.mean(I)", {"all_reduce": 1}), "var_int": ("lib.var(I, 0)", {"all_reduce": 2}),
    "mean_half": ("lib.mean(H, 0)", {"all_reduce": 1}), "var_half": ("lib.var(H)", {"all_reduce": 2}),
    "mean_bf16": ("lib.mean(F, 1)", {"all_reduce": 1}),
    # nan forms
    "nansum": ("lib.nansum(N, 0)", None), "nanprod": ("lib.nanprod(N, 1)", None),
    "nanmax": ("lib.nanmax(N, 0)", None), "nanmin": ("lib.nanmin(N)", None),
    "nanmean": ("lib.nanmean(N, 0)", None), "nanvar": ("lib.nanvar(N, 0, ddof=1)", None),
    "nanstd": ("lib.nanstd(N, 1)", None), "nanargmax": ("lib.nanargmax(N, 0)", None),
    "nanargmin": ("lib.nanargmin(N)", None),
    # cumulative
    "cumsum_split": ("lib.cumsum(A, 0)", {"exscan": 1}), "cumsum_nonsplit": ("lib.cumsum(A, 1)", {}),
    "cumsum_split1": ("lib.cumsum(B, 1)", {"exscan": 1}), "cumprod_split": ("lib.cumprod(I, 0)", {"exscan": 1}),
    "cumsum_empty_shard": ("lib.cumsum(E, 0)", {"exscan": 1}), "cumsum_bool": ("lib.cumsum(Bo, 0)", {"exscan": 1}),
    "cumsum_int32": ("lib.cumsum(I, 0)", {"exscan": 1}), "nancumsum": ("lib.nancumsum(N, 0)", {"exscan": 1}),
    "nancumprod": ("lib.nancumprod(N * 0.1 + 1, 0)", {"exscan": 1}),
    "cumsum_dtype": ("lib.cumsum(I, 0, dtype=lib.float64)", {"exscan": 1}),
    # manipulations, memory, indexing, setitem, conversions
    "resplit_0_1": ("lib.resplit(A, 1)", {"all_to_all": 1}, {"ref": "C2"}), "resplit_1_none": ("B.resplit(None)", {"all_gather": 1}, {"ref": "C2"}),
    "copy": ("lib.copy(B)", {}), "transpose": ("B.T", {}, {"ref": "C2"}),
    "getitem_split1_slice": ("B[:, 1:4]", None, {"ref": "C2"}), "getitem_split1_step": ("B[:, ::-2]", None, {"ref": "C2"}),
    "getitem_split1_int": ("B[2, 3]", None, {"ref": "C2"}), "getitem_split0_slice": ("A[2:6]", None, {"ref": "C2"}),
    "getitem_split0_int": ("A[-1]", None, {"ref": "C2"}), "getitem_3d": ("T3[:, 1:5:2, 0]", None, {"ref": "C2"}),
    "getitem_rows": ("A[np.array([6, 0, 3])]", None, {"ref": "C2"}),
    "getitem_replicated": ("C[::-2, 1:3]", {}, {"ref": "C2"}),
    "setitem_split0": ("setit(A, (slice(2, 6), 1), 7.0)", {}, {"ref": "C2"}),
    "setitem_split1_step": ("setit(B, (slice(None), slice(None, None, -2)), 0.5)", {}, {"ref": "C2"}),
    "setitem_row_value": ("setit(B, 3, C[3])", {}, {"ref": "C2"}),
    "setitem_int": ("setit(B, (1, 4), -2.0)", {}, {"ref": "C2"}),
    "setitem_replicated_value": ("setit(A, (slice(None), 2), C[:, 2])", {}, {"ref": "C2"}),
    "float_item": ("float(A[3, 3])", None), "len": ("len(B)", None), "tolist": ("B[1].tolist()", None),
    "bool_any": ("bool(lib.any(A > 2.5))", None), "str_body": ("str(B).split(', dtype=')[0]", None),
    "equal": ("lib.equal(A, A.resplit(1))", None), "allclose": ("lib.allclose(A, B)", None),
    # a write into a resplit, transposed, real or replicated-getitem result
    # leaves its source as it was
    "write_resplit": ("written(A.resplit(1), (2, 3), 9.0, A)", None, {"ref": "C2"}),
    "write_noop_resplit": ("written(A.resplit(0), 1, 9.0, A)", None, {"ref": "C2"}),
    "write_transpose": ("written(B.T, (slice(None), 2), 9.0, B)", None, {"ref": "C2"}),
    "write_real": ("written(lib.real(C), 0, 9.0, C)", None, {"ref": "C2"}),
    "write_getitem": ("written(C[1:3], 0, 9.0, C)", None, {"ref": "C2"}),
}

# the elementwise and the remaining logical functions at world size 2, on
# arrays split along axis 1 (5 columns over 2 ranks), against heat_tpu with
# the tolerances of the world-1 tests and heat_tpu's lshape_map for a
# two-device mesh
_LOCAL_ARGS = {"clip": "X, 0.2, 0.6", "round": "X * 10, 1", "nan_to_num": "X / 0.0",
               "isneginf": "-X / 0.0", "isposinf": "X / 0.0", "isinf": "X / 0.0",
               "isnan": "X - X / 0.0", "angle": "Zc", "conj": "Zc", "conjugate": "Zc", "imag": "Zc",
               "real": "Zc", "sgn": "Zc", "arccosh": "X + 1", "invert": "I", "bitwise_not": "I",
               "i0": "X", "allclose": "X, X + 1e-9", "equal": "X, X"}
_INT_BINARY = ("bitwise_and", "bitwise_or", "bitwise_xor", "left_shift", "right_shift",
               "floor_divide", "floordiv", "mod", "remainder", "fmod")


def _local_cases():
    """name -> (function, its arguments as an expression over the arrays)."""
    cases = {}
    for mod in ("arithmetics", "relational", "logical", "rounding", "exponential",
                "trigonometrics", "complex_math"):
        for f in getattr(ht.core, mod).__all__:
            fn = getattr(ht, f)
            if mod == "arithmetics" and f in ("sum", "prod") or "cum" in f:
                continue  # distributed: held against heat_tpu in WORLD_CASES
            nargs = fn.__code__.co_argcount - len(fn.__defaults__ or ())
            if f in _LOCAL_ARGS:
                args = _LOCAL_ARGS[f]
            elif nargs >= 2:
                args = "I, K" if f in _INT_BINARY else "X, Y"
            else:
                args = "X"
            cases[f"{mod}.{f}"] = (f, args)
    return cases


LOCAL_CASES = _local_cases()


def _build_env(lib, kw, arrays):
    env = {"lib": lib, "np": np}
    for name, (a, split) in arrays.items():
        if split == "1bf16":
            env[name] = lib.array(a, split=1, **kw).astype(lib.bfloat16)
        else:
            env[name] = lib.array(a, split=split, **kw)

    def zeros(shape, split):
        return lib.zeros(shape, split=split, **kw)

    def setit(x, key, value):
        y = lib.copy(x)
        y[key] = value
        return y

    def written(y, key, value, source):
        y[key] = value
        return y, source

    env.update(zeros=zeros, setit=setit, written=written)
    return env


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
exec(spec["env_src"])
env = _build_env(ht, {}, spec["arrays"])
comm = ht.get_comm()
res = {}
for name, expr in spec["cases"].items():
    comm.reset_stats()
    r = eval(expr, env)
    stats = {k: v["calls"] for k, v in comm.stats.items()}
    def pack(v):
        if isinstance(v, tuple):
            return tuple(pack(u) for u in v)
        if isinstance(v, ht.DNDarray):
            return {"values": v.numpy(), "dtype": v.dtype.__name__, "gshape": v.gshape,
                    "split": v.split, "lshape_map": v.lshape_map, "lshape": v.lshape}
        return v
    packed = pack(r)
    res[name] = (packed, stats)
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(res, f)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp, worker, spec, world=2, timeout=180):
    """Run ``worker`` on ``world`` gloo ranks with ``spec``; a rank that
    dies (gloo aborts on mismatched sizes) or hangs fails the caller."""
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    (tmp / "worker.py").write_text(worker)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), str(world), port,
                               str(tmp / "spec.pkl"), str(tmp / "out.pkl")],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
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


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    import inspect

    arrays = _world_arrays()
    cases = {k: v[0] for k, v in WORLD_CASES.items()}
    cases.update({k: f"lib.{f}({args})" for k, (f, args) in LOCAL_CASES.items()})
    spec = {"arrays": arrays, "cases": cases, "env_src": inspect.getsource(_build_env)}
    res = run_world(tmp_path_factory.mktemp("ops_world2"), _WORKER, spec)
    envs = {"C2": _build_env(hj, {"comm": C2}, arrays), "C1": _build_env(hj, {"comm": C1}, arrays),
            "port": _build_env(ht, {"device": "cpu"}, arrays)}
    return res, envs


def _check_packed(got, want, scale, atol=None, ref=None, ulp_scale=None):
    """A world-2 result (packed by the worker) against heat_tpu's: dtype,
    gshape, split, lshape_map and values, floats within 4 ulp (``ref`` and
    ``ulp_scale`` as :func:`_close` takes them), or rtol·S with S =
    ``scale`` for reductions, or within ``atol``."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _check_packed(g, w, scale, atol)
        return
    if not isinstance(want, (hj.DNDarray, ht.DNDarray)):
        assert got == want or (isinstance(want, float) and np.isclose(got, want, rtol=1e-6)), \
            (got, want)
        return
    assert got["dtype"] == want.dtype.__name__, (got["dtype"], want.dtype)
    assert tuple(got["gshape"]) == tuple(want.gshape)
    assert got["split"] == want.split, (got["split"], want.split)
    lmap = C2.lshape_map(want.gshape, want.split)
    np.testing.assert_array_equal(got["lshape_map"], lmap)
    assert tuple(got["lshape"]) == tuple(lmap[0])
    name = want.dtype.__name__
    if atol is None and scale is not None and name in _RTOL:
        atol = _RTOL[name] * scale
    _close(got["values"], _np(want), name, atol=atol, ref=ref, scale=ulp_scale)


# scale S of the reductions' tolerances in the world-2 cases (the inputs
# are of size <= 3, at most 35 elements are reduced into one)
_WORLD_SCALE = 3.0 * 35


@pytest.mark.parametrize("case", list(WORLD_CASES))
def test_world2_matches_heat_tpu(world2, case):
    res, envs = world2
    expr, counts, *opts = WORLD_CASES[case]
    opts = opts[0] if opts else {}
    got, stats = res[case]
    want = eval(expr, envs[opts.get("ref", "C1")])  # noqa: S307
    elementwise = counts == {} and not any(k in expr for k in ("sum", "mean", "var", "std"))
    atol = opts.get("atol")
    _check_packed(got, want, None if elementwise else _WORLD_SCALE, atol)
    if counts is not None:
        assert stats == counts, (stats, counts)


@pytest.mark.parametrize("case", list(LOCAL_CASES))
def test_world2_local_functions_match_heat_tpu(world2, case):
    """Within 4 ulp of heat_tpu's result, or no further from numpy's
    float64 value than heat_tpu's plus that (the functions of ``_NP_REF``),
    of the larger operand for logaddexp, as the world-1 tests hold them."""
    res, envs = world2
    got, _ = res[case]
    f, args = LOCAL_CASES[case]
    want = eval(f"lib.{f}({args})", envs["C1"])  # noqa: S307
    if not isinstance(want, (tuple, hj.DNDarray)):
        assert got == want, (got, want)
        return
    ref = ulp_scale = None
    f = getattr(ht, f).__name__  # an alias's function
    if f in _NP_REF or f.startswith("logaddexp"):
        xs = eval(f"({args},)", envs["port"])  # noqa: S307
        ref = _ref(_NP_REF[f], *xs) if f in _NP_REF else None
        if f.startswith("logaddexp"):
            ulp_scale = np.maximum(np.abs(_np(xs[0])), np.abs(_np(xs[1])))
    _check_packed(got, want, None, ref=ref, ulp_scale=ulp_scale)
