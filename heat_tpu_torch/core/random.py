"""Parallel pseudo-random numbers (heat_tpu ``core/random.py``), bit for bit.

The global state is heat_tpu's ``(seed, counter)`` pair: every draw takes
the key ``fold_in(key(seed), counter)`` and advances the counter. The bits
are jax's partitionable Threefry-2x32 stream, the layout heat_tpu draws
with (``jax_threefry_partitionable``, x64 on):

* ``key(seed)`` is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, c)`` and key ``i`` of ``split(k)`` are ``threefry2x32(k, (0, c))``
  and ``threefry2x32(k, (0, i))``;
* the 32-bit word at flat index ``i`` of a draw is ``x0 ^ x1`` and the 64-bit
  word ``x0 << 32 | x1``, where ``(x0, x1) = threefry2x32(k, (i >> 32, i &
  0xFFFFFFFF))``.

So each rank computes the words of its own chunk's flat indices and nothing
else, and a draw's values do not depend on the number of processes. The
conversions are jax's own (``jax/_src/random.py``): ``uniform`` sets the
exponent of 1.0 under the mantissa bits and subtracts 1; ``randint`` takes
two draws from a split key and folds them into the span; ``normal`` is
``sqrt(2)·erfinv`` of a uniform on ``(nextafter(-1, 0), 1)``, with XLA's
``erfinv`` polynomials; a
permutation is ``num_rounds`` stable sorts on fresh 32-bit keys. The words
are computed in int32 torch ops (additions wrap, right shifts are masked),
on the draw's device, at most ``_CHUNK`` elements at a time.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from . import devices, types
from .communication import sanitize_comm
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["get_state", "normal", "permutation", "rand", "randint", "randn", "random",
           "random_integer", "random_sample", "randperm", "ranf", "sample", "seed",
           "set_state", "standard_normal", "uniform"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 24  # elements of one pass: bounds the integer temporaries on the card

__seed: Optional[int] = None
__counter: int = 0


def seed(seed: Optional[int] = None) -> None:
    """Reset the RNG state (heat_tpu ``random.py:58``)."""
    global __seed, __counter
    if seed is None:
        seed = int(time.time() * 256) % (2**63)
    __seed = int(seed)
    __counter = 0


def get_state():
    """The state tuple (heat_tpu ``random.py:67``)."""
    return ("Threefry", __seed, __counter, 0, 0.0)


def set_state(state) -> None:
    """Restore a state tuple (heat_tpu ``random.py:72``)."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state needs to be a tuple with 3 or 5 entries")
    if state[0] != "Threefry":
        raise ValueError(f"algorithm must be 'Threefry', got {state[0]}")
    __seed = int(state[1])
    __counter = int(state[2])


# --------------------------------------------------------------------------- #
# Threefry-2x32                                                               #
# --------------------------------------------------------------------------- #
def _threefry_host(key, x0: int, x1: int):
    """``threefry2x32`` of one counter pair, in Python integers."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _signed32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


def _threefry(key, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` of int32 counter tensors (the uint32 bit patterns),
    in place on ``x0``/``x1``."""
    k0, k1 = key
    ks = [_signed32(k) for k in (k0, k1, k0 ^ k1 ^ _PARITY)]
    x0.add_(ks[0])
    x1.add_(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            low = (x1 >> (32 - r)).bitwise_and_((1 << r) - 1)  # the bits rotated out
            x1.bitwise_left_shift_(r).bitwise_or_(low).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(_signed32((ks[(i + 2) % 3] + i + 1) & _M32))
    return x0, x1


def _key_of(seed_: int, counter: int):
    """``fold_in(key(seed), counter)`` (heat_tpu ``random.py:102``)."""
    return _threefry_host(((seed_ >> 32) & _M32, seed_ & _M32), 0, counter & _M32)


def _split(key):
    """The two keys of ``jax.random.split(key)``."""
    return _threefry_host(key, 0, 0), _threefry_host(key, 0, 1)


def _next_key():
    global __counter
    if __seed is None:
        seed()
    key = _key_of(__seed, __counter)
    __counter += 1
    return key


# --------------------------------------------------------------------------- #
# heat_tpu's sampling: jax.random.categorical on fold_in / split keys          #
# --------------------------------------------------------------------------- #
def _base_key(seed_: int):
    """``jax.random.key(seed)``: the words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed_ = int(seed_)
    return ((seed_ >> 32) & _M32, seed_ & _M32)


def _fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2**32``."""
    return _threefry_host(key, 0, int(data) & _M32)


def _threefry_keyed(keys: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` of the counters ``(0, x1)`` under one key a row:
    ``keys`` ``(R, 2)`` int32 word patterns, ``x1`` ``(n,)`` int32; returns
    the ``(R, n)`` pair. :func:`_threefry` with tensor keys."""
    k0, k1 = keys[:, :1], keys[:, 1:]
    ks = (k0, k1, k0 ^ k1 ^ _signed32(_PARITY))
    x0 = k0.expand(-1, x1.shape[0]).clone()
    x1 = x1[None, :] + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            low = (x1 >> (32 - r)).bitwise_and_((1 << r) - 1)
            x1 = x1.bitwise_left_shift(r).bitwise_or_(low).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return x0, x1


def _uniform_tiny(words: torch.Tensor) -> torch.Tensor:
    """jax's ``uniform(key, shape, float32, minval=tiny, maxval=1)`` of the
    32-bit words: ``floats * (1 - tiny) + tiny``, at least ``tiny``; ``1 -
    tiny`` is 1.0 in float32 (``random.py:_uniform``)."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp_min(_unit_floats(words, torch.float32) + tiny, tiny)


def _gumbel_argmax(words: torch.Tensor, logits: torch.Tensor, temperature: float):
    """``argmax(logits / T + gumbel)`` along the last axis, the gumbel noise
    ``-log(-log(u))`` of :func:`_uniform_tiny` (jax's ``categorical`` with
    its default ``mode="low"`` ``_gumbel``)."""
    z = logits.float() / torch.tensor(float(temperature), dtype=torch.float32,
                                      device=logits.device)
    g = -torch.log(-torch.log(_uniform_tiny(words)))
    return torch.argmax(g + z, dim=-1)


def _categorical(key, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``jax.random.categorical(key, logits / T, axis=-1)`` of float32
    ``logits`` ``(..., V)`` under one key: the noise at flat index ``i`` of
    the logits' shape, computed on their device."""
    flat = torch.arange(logits.numel(), dtype=torch.int64, device=logits.device)
    return _gumbel_argmax(_words(key, flat, False).view(logits.shape), logits, temperature)


def _categorical_rows(keys, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``categorical(keys[r], logits[r] / T)`` for each row ``r`` of ``(R,
    V)`` float32 ``logits``, one key a row (jax's ``vmap`` of
    ``categorical``): every row's noise at the flat indices ``0 .. V-1``."""
    dev = logits.device
    kt = torch.tensor([[_signed32(a), _signed32(b)] for a, b in keys], dtype=torch.int32,
                      device=dev)
    x0, x1 = _threefry_keyed(kt, torch.arange(logits.shape[-1], dtype=torch.int32, device=dev))
    return _gumbel_argmax(x0.bitwise_xor_(x1), logits, temperature)


def _local_flat(gshape, split, comm, device, lo: int, hi: int) -> torch.Tensor:
    """Global flat indices (int64) of elements ``lo .. hi`` of this rank's
    shard in its own row-major order."""
    j = torch.arange(lo, hi, dtype=torch.int64, device=device)
    if split is None or split == 0:
        offset = 0
        if split == 0:
            offset = comm.chunk(gshape, 0)[0] * int(np.prod(gshape[1:], dtype=np.int64))
        return j + offset
    offset, lshape, _ = comm.chunk(gshape, split)
    flat = torch.zeros_like(j)
    stride = 1
    for ax in range(len(gshape) - 1, -1, -1):
        pos = j % lshape[ax]
        j = j // lshape[ax]
        if ax == split:
            pos = pos + offset
        flat += pos * stride
        stride *= gshape[ax]
    return flat


def _words(key, flat: torch.Tensor, wide: bool) -> torch.Tensor:
    """The 32-bit words (int32 patterns) or, with ``wide``, the 64-bit words
    (int64 patterns) of a draw at the flat indices ``flat``."""
    x0 = (flat >> 32).to(torch.int32)
    x1 = (flat & _M32).to(torch.int32)
    x0, x1 = _threefry(key, x0, x1)
    if not wide:
        return x0.bitwise_xor_(x1)
    return (x0.to(torch.int64) << 32) | (x1.to(torch.int64) & _M32)


def _draw(key, gshape, split, comm, device, out_dtype: torch.dtype, wide: bool,
          convert) -> torch.Tensor:
    """This rank's shard of a draw of ``gshape``: ``convert(words)`` of its
    chunk's words, ``_CHUNK`` elements at a time."""
    gshape = tuple(gshape)
    _, lshape, _ = comm.chunk(gshape, split) if gshape else (0, (), ())
    dev = device.torch_device
    n = int(np.prod(lshape, dtype=np.int64))
    out = torch.empty(lshape, dtype=out_dtype, device=dev)
    flat_out = out.view(-1)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        words = _words(key, _local_flat(gshape, split, comm, dev, lo, hi), wide)
        flat_out[lo:hi] = convert(words)
    return out


# --------------------------------------------------------------------------- #
# jax's conversions                                                           #
# --------------------------------------------------------------------------- #
_FLOAT_BITS = {  # dtype -> (rng bits, mantissa bits, int type of its width, bits of 1.0)
    torch.float64: (64, 52, torch.int64, 0x3FF0000000000000),
    torch.float32: (32, 23, torch.int32, 0x3F800000),
    torch.float16: (16, 10, torch.int16, 0x3C00),
    torch.bfloat16: (8, 7, torch.int16, 0x3F80),
}


def _unit_floats(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """jax's ``uniform`` on [0, 1): the top ``nmant`` of the word's low
    ``rng bits`` under the exponent of 1.0, minus 1 (``random.py:_uniform``)."""
    rng_bits, nmant, view, one = _FLOAT_BITS[dtype]
    mant = (words >> (rng_bits - nmant)) & ((1 << nmant) - 1)
    return (mant | one).to(view).view(dtype) - 1


# XLA's erfinv (M. Giles, "Approximating the erfinv function", as
# ``chlo.erf_inv`` lowers it): per branch, the Horner coefficients in ``w``
# and the shift of the branch's argument (``w`` or ``sqrt(w)``)
_ERFINV32 = (
    (5.0, False, 2.5, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                       0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                       1.50140941)),
    (math.inf, True, 3.0, (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                           2.83297682)),
)
_ERFINV64 = (
    (6.25, False, 3.125, (
        -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
        1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
        6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
        2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
        1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
        4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
        0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
        0.24015818242558961693, 1.6536545626831027356)),
    (16.0, True, 3.25, (
        2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
        1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
        2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
        6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
        0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
        -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
        3.0838856104922207635)),
    (math.inf, True, 5.0, (
        -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
        -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
        2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
        -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
        7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
        1.0103004648645343977, 4.8499064014085844221)),
)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erfinv`` of float32 or float64 ``x``; ``erfinv(±1) = ±inf``."""
    w = -torch.log1p(-x * x)
    out = torch.zeros_like(x)
    lower = -math.inf
    for upper, root, shift, coef in (_ERFINV64 if x.dtype == torch.float64 else _ERFINV32):
        sel = (w >= lower) & (w < upper)
        if upper == math.inf:
            sel = w >= lower
        t = (torch.sqrt(w) if root else w) - shift
        p = torch.full_like(x, coef[0])
        for c in coef[1:]:
            p = c + p * t
        out = torch.where(sel, p, out)
        lower = upper
    return torch.where(x.abs() == 1, x * math.inf, out * x)


def _normal_of(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """jax's ``normal``: ``sqrt(2)·erfinv(u)``, ``u`` uniform on
    ``(nextafter(-1, 0), 1)`` (``random.py:_normal_real``)."""
    f = _unit_floats(words, dtype)
    lo = -1.0 + torch.finfo(dtype).eps / 2
    span = torch.tensor(1.0, dtype=dtype) - torch.tensor(lo, dtype=dtype)
    u = torch.clamp_min(f * span.to(f.device) + lo, lo)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype, device=u.device)
    if dtype == torch.float64:
        return sqrt2 * _erfinv(u)
    return sqrt2 * _erfinv(u.float()).to(dtype)


def _umod64(x: torch.Tensor, s: int) -> torch.Tensor:
    """``x mod s`` of int64 tensors read as uint64, for ``1 <= s < 2**64``."""
    if s >= 1 << 63:  # x < 2s: one conditional subtraction, compared unsigned
        flip = -(1 << 63)
        big = (x ^ flip) >= ((s - (1 << 64)) ^ flip)
        return torch.where(big, x - (s - (1 << 64)), x)
    r = torch.remainder(x, s)  # in [0, s) for the signed value
    c = (1 << 64) % s  # the signed value lacks 2**64 where the top bit is set
    fix = r - (s - c)
    fix = torch.where(fix < 0, fix + s, fix)
    return torch.where(x < 0, fix, r)


def _randint_of(hi: torch.Tensor, lo: torch.Tensor, low: int, high: int, dtype: torch.dtype):
    """jax's ``randint`` span arithmetic on two words per element
    (``random.py:_randint``), in unsigned ``nbits`` arithmetic."""
    info = torch.iinfo(dtype)
    nbits = info.bits
    mask = (1 << nbits) - 1
    out_of_range = high > info.max
    low_c = min(max(low, info.min), info.max)
    high_c = min(max(high, info.min), info.max)
    span = (high_c - low_c) & mask
    if high_c <= low_c:
        span = 1
    if out_of_range and high_c > low_c:
        span = (span + 1) & mask

    def rem(a, b):  # XLA's unsigned remainder: a rem 0 = a
        return a % b if b else a

    mult = rem(1 << (nbits // 2), span)
    mult = rem((mult * mult) & mask, span)
    if nbits == 64:
        if span == 0:
            off = lo
        else:
            mult_s = mult - (1 << 64) if mult >= 1 << 63 else mult
            off = _umod64(_umod64(hi, span) * mult_s + _umod64(lo, span), span)
        val = off + low_c
    else:
        h = hi.to(torch.int64) & mask
        l_ = lo.to(torch.int64) & mask
        if span:
            h, l_ = h % span, l_ % span
        off = (h * mult + l_) & mask
        if span:
            off = off % span
        val = (off + low_c) & mask
        val = val - (1 << nbits) * (val > info.max)
    return val.to(dtype)


# --------------------------------------------------------------------------- #
# the draws                                                                   #
# --------------------------------------------------------------------------- #
def _shape(d):
    if len(d) == 1 and isinstance(d[0], (tuple, list)):
        d = tuple(d[0])
    return sanitize_shape(d) if d else ()


def _setup(gshape, dtype, split, device, comm):
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(gshape, split) if split is not None and gshape else None
    return dtype, device, comm, split


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples (heat_tpu ``random.py:122``)."""
    gshape = _shape(d)
    dtype, device, comm, split = _setup(gshape, dtype, split, device, comm)
    tt = dtype.torch_type()
    if tt not in _FLOAT_BITS:
        raise TypeError(f"rand only draws floating types, got {dtype}")
    local = _draw(_next_key(), gshape, split, comm, device, tt, tt == torch.float64,
                  lambda w: _unit_floats(w, tt))
    return DNDarray(local, gshape, dtype, split, device, comm)


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples (heat_tpu ``random.py:192``)."""
    gshape = sanitize_shape(_shape(d) or (1,))
    dtype, device, comm, split = _setup(gshape, dtype, split, device, comm)
    tt = dtype.torch_type()
    if tt not in _FLOAT_BITS:
        raise TypeError(f"randn only draws floating types, got {dtype}")
    local = _draw(_next_key(), gshape, split, comm, device, tt, tt == torch.float64,
                  lambda w: _normal_of(w, tt))
    return DNDarray(local, gshape, dtype, split, device, comm)


def randint(low, high=None, size=None, dtype=None, split=None, device=None,
            comm=None) -> DNDarray:
    """Uniform integers in ``[low, high)`` (heat_tpu ``random.py:154``);
    int64 by default, as heat_tpu with x64."""
    if high is None:
        low, high = 0, low
    if size is None:
        size = ()
    gshape = sanitize_shape(size)
    dtype = types.int64 if dtype is None else types.canonical_heat_type(dtype)
    if not issubclass(dtype, types.integer):
        raise ValueError(f"Unsupported dtype for randint: {dtype}")
    if low >= high:
        raise ValueError(f"low >= high: {low}, {high}")
    dtype, device, comm, split = _setup(gshape, dtype, split, device, comm)
    tt = dtype.torch_type()
    info = torch.iinfo(tt)
    if info.bits < 32:  # jax samples 8- and 16-bit types at 32 bits, then casts
        low, high = min(max(low, info.min), info.max), min(max(high, info.min), info.max + 1)
    wide = info.bits == 64
    k1, k2 = _split(_next_key())
    higher = _draw(k1, gshape, split, comm, device, torch.int64 if wide else torch.int32, wide,
                   lambda w: w)
    lower = _draw(k2, gshape, split, comm, device, torch.int64 if wide else torch.int32, wide,
                  lambda w: w)
    local = _randint_of(higher, lower, int(low), int(high), tt if wide else torch.int32)
    return DNDarray(local.to(tt), gshape, dtype, split, device, comm)


random_integer = randint


def random_sample(shape=None, dtype=types.float32, split=None, device=None,
                  comm=None) -> DNDarray:
    """Uniform [0, 1) over a shape tuple (heat_tpu ``random.py:142``)."""
    return rand(*sanitize_shape((1,) if shape is None else shape), dtype=dtype, split=split,
                device=device, comm=comm)


random = random_sample
ranf = random_sample
sample = random_sample


def standard_normal(shape=None, dtype=types.float32, split=None, device=None,
                    comm=None) -> DNDarray:
    """Standard normal over a shape tuple (heat_tpu ``random.py:212``)."""
    return randn(*sanitize_shape((1,) if shape is None else shape), dtype=dtype, split=split,
                 device=device, comm=comm)


def normal(mean=0.0, std=1.0, shape=None, dtype=types.float32, split=None, device=None,
           comm=None) -> DNDarray:
    """Normal(mean, std) samples (heat_tpu ``random.py:219``)."""
    from . import arithmetics

    x = standard_normal(shape, dtype=dtype, split=split, device=device, comm=comm)
    return arithmetics.add(arithmetics.mul(x, std), mean)


def uniform(low=0.0, high=1.0, size=None, dtype=types.float32, split=None, device=None,
            comm=None) -> DNDarray:
    """Uniform [low, high) samples (heat_tpu ``random.py:227``)."""
    from . import arithmetics

    x = random_sample((1,) if size is None else size, dtype=dtype, split=split, device=device,
                      comm=comm)
    return arithmetics.add(arithmetics.mul(x, high - low), low)


def _shuffled_range(key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``num_rounds`` stable sorts of the
    range on fresh 32-bit keys (``random.py:_shuffle``)."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    flat = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = _split(key)
        keys = _words(sub, flat, False).to(torch.int64) & _M32
        x = x[torch.sort(keys, stable=True).indices]
    return x


def randperm(n: int, dtype=types.int64, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(n)`` (heat_tpu ``random.py:237``):
    every rank draws the whole permutation of the next key and keeps its
    chunk."""
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    gshape = (int(n),)
    if split is not None:
        split = sanitize_axis(gshape, split)
    perm = _shuffled_range(_next_key(), int(n), device.torch_device)
    _, _, slices = comm.chunk(gshape, split)
    local = perm[slices].to(dtype.torch_type())
    return DNDarray(local if split is None else local.clone(), gshape, dtype, split, device, comm)


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(x)``, or of an array's rows
    (heat_tpu ``random.py:258``): a split array's rows move through the
    ring gather (split 0) or on the shard (split elsewhere)."""
    from . import factories

    if isinstance(x, (int, np.integer)):
        return randperm(int(x), split=split, device=device, comm=comm)
    if not isinstance(x, DNDarray):
        x = factories.array(x, split=split, device=device, comm=comm)
    n = x.shape[0]
    perm = randperm(n, split=None, device=x.device, comm=x.comm)
    if x.split is not None and x.comm.size > 1 and n > 0:
        return x[perm.larray.cpu().numpy()]
    logical = x._logical()[perm.larray.to(x.larray.device)]
    return DNDarray.from_global(logical, x.split, x.device, x.comm, x.dtype)
