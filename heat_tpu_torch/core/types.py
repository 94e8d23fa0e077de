"""The heat type lattice over torch dtypes (heat_tpu ``core/types.py``).

Same classes, same promotion ladder and the same cast tables as heat_tpu;
each type is backed by a ``torch.dtype`` instead of a JAX dtype. heat_tpu
enables x64 at import, so its defaults are the 64-bit ones the lattice
names: python ``int`` is ``int64`` and python ``float`` is ``float32``
(the reference's torch-style inference), which holds here unchanged.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

__all__ = [
    "datatype", "generic", "number", "integer", "signedinteger",
    "unsignedinteger", "floating", "inexact", "complexfloating", "flexible",
    "bool", "bool_", "uint8", "ubyte", "int8", "byte", "int16", "short",
    "int32", "int", "int64", "long", "bfloat16", "float16", "half",
    "float32", "float", "float_", "float64", "double", "complex64", "cfloat",
    "csingle", "complex128", "cdouble", "canonical_heat_type",
    "heat_type_is_exact", "promote_types", "result_type",
    "can_cast", "accumulation_dtype", "heat_type_of", "heat_type_is_inexact",
    "heat_type_is_complexfloating", "issubdtype", "iscomplex", "isreal", "finfo", "iinfo",
]


class datatype:
    """Abstract base of all heat types (heat_tpu ``types.py:82``)."""

    _torch_type = None
    _char = None

    @classmethod
    def torch_type(cls) -> torch.dtype:
        return cls._torch_type

    @classmethod
    def char(cls):
        return cls._char


class generic(datatype):
    pass


class bool(generic):  # noqa: A001 — parity with the reference namespace
    _torch_type = torch.bool
    _char = "u1"


bool_ = bool


class number(generic):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class unsignedinteger(integer):
    pass


class inexact(number):
    pass


class floating(inexact):
    pass


class complexfloating(inexact):
    pass


class flexible(generic):
    pass


class uint8(unsignedinteger):
    _torch_type = torch.uint8
    _char = "B"


class int8(signedinteger):
    _torch_type = torch.int8
    _char = "b"


class int16(signedinteger):
    _torch_type = torch.int16
    _char = "h"


class int32(signedinteger):
    _torch_type = torch.int32
    _char = "i"


class int64(signedinteger):
    _torch_type = torch.int64
    _char = "l"


class bfloat16(floating):
    _torch_type = torch.bfloat16
    _char = "E"


class float16(floating):
    _torch_type = torch.float16
    _char = "e"


class float32(floating):
    _torch_type = torch.float32
    _char = "f"


class float64(floating):
    _torch_type = torch.float64
    _char = "d"


class complex64(complexfloating):
    _torch_type = torch.complex64
    _char = "F"


class complex128(complexfloating):
    _torch_type = torch.complex128
    _char = "D"


ubyte = uint8
byte = int8
short = int16
int = int32  # noqa: A001
long = int64
half = float16
float = float32  # noqa: A001
float_ = float32
double = float64
cfloat = complex64
csingle = complex64
cdouble = complex128

_ORDER = [bool, uint8, int8, int16, int32, int64,
          bfloat16, float16, float32, float64, complex64, complex128]

_TORCH_TO_HEAT = {t.torch_type(): t for t in _ORDER}

_PY_TO_HEAT = {
    builtins.bool: bool,
    builtins.int: int64,
    builtins.float: float32,
    builtins.complex: complex64,
}

_CHAR_TO_HEAT = {
    "?": bool, "B": uint8, "b": int8, "h": int16, "i": int32, "i4": int32,
    "l": int64, "i8": int64, "E": bfloat16, "e": float16, "f": float32,
    "f4": float32, "d": float64, "f8": float64, "F": complex64,
    "D": complex128, "u1": uint8,
}

_NP_TO_HEAT = {
    np.dtype(np.bool_): bool, np.dtype(np.uint8): uint8,
    np.dtype(np.int8): int8, np.dtype(np.int16): int16,
    np.dtype(np.int32): int32, np.dtype(np.int64): int64,
    np.dtype(np.float16): float16, np.dtype(np.float32): float32,
    np.dtype(np.float64): float64, np.dtype(np.complex64): complex64,
    np.dtype(np.complex128): complex128,
}


def canonical_heat_type(a_type) -> type:
    """Normalize any dtype-like (heat type, torch or numpy dtype, python
    type, type char) to a heat type class (heat_tpu ``types.py:277``)."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        if a_type._torch_type is None:
            raise TypeError(f"data type {a_type!r} is abstract")
        return a_type
    if isinstance(a_type, torch.dtype):
        if a_type in _TORCH_TO_HEAT:
            return _TORCH_TO_HEAT[a_type]
        raise TypeError(f"data type {a_type!r} not understood")
    if a_type in _PY_TO_HEAT:
        return _PY_TO_HEAT[a_type]
    if isinstance(a_type, str) and a_type in _CHAR_TO_HEAT:
        return _CHAR_TO_HEAT[a_type]
    if isinstance(a_type, str) and a_type == "bfloat16":
        return bfloat16
    try:
        return _NP_TO_HEAT[np.dtype(a_type)]
    except (TypeError, KeyError) as exc:
        raise TypeError(f"data type {a_type!r} not understood") from exc


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for integer/bool types (heat_tpu ``types.py:308``)."""
    dt = canonical_heat_type(ht_dtype)
    return issubclass(dt, integer) or dt is bool


def heat_type_of(obj) -> type:
    """The heat type of an object's elements (heat_tpu ``types.py:293``)."""
    from .dndarray import DNDarray

    if isinstance(obj, DNDarray):
        return obj.dtype
    if hasattr(obj, "dtype"):
        return canonical_heat_type(obj.dtype)
    if isinstance(obj, (builtins.bool, builtins.int, builtins.float, builtins.complex)):
        return _PY_TO_HEAT[type(obj)]
    if isinstance(obj, (list, tuple)):
        return canonical_heat_type(np.asarray(obj).dtype)
    raise TypeError(f"cannot determine heat type of {type(obj)}")


def heat_type_is_inexact(ht_dtype) -> builtins.bool:
    """True for floating and complex types (heat_tpu ``types.py:314``)."""
    return issubclass(canonical_heat_type(ht_dtype), inexact)


def heat_type_is_complexfloating(ht_dtype) -> builtins.bool:
    """True for complex types (heat_tpu ``types.py:319``)."""
    return issubclass(canonical_heat_type(ht_dtype), complexfloating)


def issubdtype(arg1, arg2) -> builtins.bool:
    """NumPy's abstract type test (heat_tpu ``types.py:323``): ``arg1`` a
    subtype of an abstract class, or the same concrete type."""
    abstract = {generic, number, integer, signedinteger, unsignedinteger, inexact, floating,
                complexfloating, flexible}
    if isinstance(arg2, type) and arg2 in abstract:
        try:
            return issubclass(canonical_heat_type(arg1), arg2)
        except TypeError:
            return False
    try:
        return canonical_heat_type(arg1) is canonical_heat_type(arg2)
    except TypeError:
        return False


def iscomplex(x):
    """Element-wise: a nonzero imaginary part (heat_tpu ``types.py:348``)."""
    from . import _operations, factories

    if heat_type_is_complexfloating(x.dtype):
        return _operations._local_op(lambda t: t.imag != 0, x)
    return factories.zeros(x.shape, dtype=bool, split=x.split, device=x.device, comm=x.comm)


def isreal(x):
    """Element-wise: a zero imaginary part (heat_tpu ``types.py:357``)."""
    from . import logical

    return logical.logical_not(iscomplex(x))


def promote_types(type1, type2) -> type:
    """Smallest common intuitively-castable type (heat_tpu ``types.py:381``):
    the first type on the ladder both operands cast to."""
    t1 = canonical_heat_type(type1)
    t2 = canonical_heat_type(type2)
    if {t1, t2} == {bfloat16, float16}:
        return float32
    for target in _ORDER:
        if can_cast(t1, target, "intuitive") and can_cast(t2, target, "intuitive"):
            return target
    return float64


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for a storage dtype (heat_tpu ``types.py:394``):
    bf16/f16 accumulate in float32, everything else in its own dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def _cast_tables():
    floats_up = {float32, float64, complex64, complex128}
    safe = {
        bool: set(_ORDER),
        uint8: {uint8, int16, int32, int64, bfloat16, float16} | floats_up,
        int8: {int8, int16, int32, int64, bfloat16, float16} | floats_up,
        int16: {int16, int32, int64} | floats_up,
        int32: {int32, int64, float64, complex128},
        int64: {int64, float64, complex128},
        bfloat16: {bfloat16} | floats_up,
        float16: {float16} | floats_up,
        float32: floats_up,
        float64: {float64, complex128},
        complex64: {complex64, complex128},
        complex128: {complex128},
    }
    intuitive = {k: set(v) for k, v in safe.items()}
    intuitive[int16] |= {bfloat16, float16}
    intuitive[int32] |= {float32, complex64}
    kinds = {bool: 0}
    for t in (uint8, int8, int16, int32, int64):
        kinds[t] = 1
    for t in (bfloat16, float16, float32, float64):
        kinds[t] = 2
    for t in (complex64, complex128):
        kinds[t] = 3
    return safe, intuitive, kinds


_SAFE, _INTUITIVE, _KINDS = _cast_tables()


def can_cast(from_, to, casting: str = "intuitive") -> builtins.bool:
    """Cast-safety test between heat types (heat_tpu ``types.py:527``,
    type arguments only)."""
    if casting not in ("no", "safe", "same_kind", "unsafe", "intuitive"):
        raise ValueError(f"unknown casting kind {casting!r}")
    to_t = canonical_heat_type(to)
    from_t = canonical_heat_type(from_)
    if casting == "unsafe":
        return True
    if casting == "no":
        return from_t is to_t
    if casting == "safe":
        return to_t in _SAFE[from_t]
    if casting == "intuitive":
        return to_t in _INTUITIVE[from_t]
    return to_t in _SAFE[from_t] or _KINDS[from_t] == _KINDS[to_t]


def _kind_rank(t) -> builtins.int:
    if issubclass(t, complexfloating):
        return 3
    if issubclass(t, floating):
        return 2
    if issubclass(t, integer):
        return 1
    return 0


def result_type(*arrays_and_types) -> type:
    """Promotion over arrays, dtypes and scalars (heat_tpu ``types.py:416``:
    precedence array(0) > type(1) > 0-d array(2) > python scalar(3); same
    kind → higher precedence wins, different kind → higher kind wins)."""
    from .dndarray import DNDarray

    def classify(arg):
        if isinstance(arg, DNDarray):
            return arg.dtype, (0 if arg.ndim > 0 else 2)
        if isinstance(arg, np.ndarray) or hasattr(arg, "dtype"):
            t = canonical_heat_type(arg.dtype)
            return t, (0 if len(getattr(arg, "shape", (1,))) > 0 else 2)
        try:
            return canonical_heat_type(arg), 1
        except TypeError:
            return canonical_heat_type(type(arg)), 3

    t1, p1 = classify(arrays_and_types[0])
    for arg in arrays_and_types[1:]:
        t2, p2 = classify(arg)
        if t1 == t2:
            p1 = min(p1, p2)
            continue
        if p1 == p2:
            t1 = promote_types(t1, t2)
            continue
        k1, k2 = _kind_rank(t1), _kind_rank(t2)
        if k1 == k2:
            t1 = t1 if p1 < p2 else t2
        else:
            t1 = t1 if k1 > k2 else t2
        p1 = min(p1, p2)
    return t1


class finfo:
    """Machine limits of a floating type (heat_tpu ``types.py:557``)."""

    def __new__(cls, ht_dtype):
        dt = canonical_heat_type(ht_dtype)
        if not issubclass(dt, (floating, complexfloating)):
            raise TypeError(f"data type {dt!r} not inexact")
        return super().__new__(cls)

    def __init__(self, ht_dtype):
        dt = canonical_heat_type(ht_dtype)
        info = torch.finfo(dt.torch_type())
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        # the resolution rounded to the type itself, as numpy's finfo gives it
        real = {complex64: float32, complex128: float64}.get(dt, dt).torch_type()
        self.resolution = builtins.float(torch.tensor(info.resolution, dtype=real))
        self.dtype = dt

    def __repr__(self):
        return (f"finfo(resolution={self.resolution}, min={self.min}, max={self.max}, "
                f"dtype={self.dtype.__name__})")


class iinfo:
    """Machine limits of an integer type (heat_tpu ``types.py:581``); bool
    counts as 8 bits from 0 to 1."""

    def __new__(cls, ht_dtype):
        dt = canonical_heat_type(ht_dtype)
        if not (issubclass(dt, integer) or dt is bool):
            raise TypeError(f"data type {dt!r} not an integer type")
        return super().__new__(cls)

    def __init__(self, ht_dtype):
        dt = canonical_heat_type(ht_dtype)
        if dt is bool:
            self.bits, self.max, self.min = 8, 1, 0
        else:
            info = torch.iinfo(dt.torch_type())
            self.bits = info.bits
            self.max = builtins.int(info.max)
            self.min = builtins.int(info.min)
        self.dtype = dt

    def __repr__(self):
        return f"iinfo(min={self.min}, max={self.max}, dtype={self.dtype.__name__})"
