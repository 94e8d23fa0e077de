"""Parallel pseudo-random numbers (heat_tpu ``core/random.py``).

The global state is heat_tpu's ``(seed, counter)`` pair: every draw takes
the next counter value. A draw is cut along axis 0 into fixed blocks of
``_BLOCK_ROWS`` rows; block ``b`` comes from an explicit ``torch.Generator``
on the array's device, seeded from ``(seed, counter, b)``. Each rank draws
only the blocks that overlap its chunk, so the logical values do not depend
on the number of processes (heat_tpu ``random.py:9-13``).

The values are not heat_tpu's Threefry stream, and the card's generator
(Philox) gives other values than the CPU's: compare distributions, or feed
both packages the same numpy data. ``get_state``/``set_state`` keep
heat_tpu's tuple (its algorithm tag included, so that saved states
round-trip between the two packages' APIs); under a state, the port draws
its own stream.
"""

from __future__ import annotations

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

_BLOCK_ROWS = 1 << 16
_MASK64 = (1 << 64) - 1

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


def _next_key():
    global __counter
    if __seed is None:
        seed()
    key = (__seed, __counter)
    __counter += 1
    return key


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _block_seed(key, block: int) -> int:
    s, c = key
    return _splitmix64(_splitmix64(_splitmix64(s & _MASK64) ^ c) ^ block) >> 1


def _generate(gshape, split, device, comm, draw) -> torch.Tensor:
    """This rank's shard of a ``gshape`` draw; ``draw(shape, generator)``
    makes one block."""
    key = _next_key()
    dev = device.torch_device
    gen = torch.Generator(device=dev)
    if not gshape:
        gen.manual_seed(_block_seed(key, 0))
        return draw((), gen)
    n = gshape[0]
    lo, hi = 0, n
    if split == 0:
        offset, lshape, _ = comm.chunk(gshape, 0)
        lo, hi = offset, offset + lshape[0]
    parts = []
    for b in range(lo // _BLOCK_ROWS, -(-hi // _BLOCK_ROWS)):
        b0 = b * _BLOCK_ROWS
        rows = min(_BLOCK_ROWS, n - b0)
        gen.manual_seed(_block_seed(key, b))
        blk = draw((rows,) + tuple(gshape[1:]), gen)
        parts.append(blk[max(lo - b0, 0):min(hi - b0, rows)])
    if not parts:
        return draw((0,) + tuple(gshape[1:]), gen)
    local = parts[0] if len(parts) == 1 else torch.cat(parts)
    if split not in (None, 0):
        _, _, slices = comm.chunk(gshape, split)
        local = local[slices].clone()
    return local


def _shape(d):
    if len(d) == 1 and isinstance(d[0], (tuple, list)):
        d = tuple(d[0])
    return sanitize_shape(d) if d else ()


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples (heat_tpu ``random.py:122``)."""
    gshape = _shape(d)
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(gshape, split) if split is not None and gshape else None
    local = _generate(gshape, split, device, comm, lambda s, g: torch.rand(
        s, generator=g, dtype=dtype.torch_type(), device=g.device))
    return DNDarray(local, gshape, dtype, split, device, comm)


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples (heat_tpu ``random.py:192``)."""
    gshape = _shape(d)
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(gshape, split) if split is not None and gshape else None
    local = _generate(gshape, split, device, comm, lambda s, g: torch.randn(
        s, generator=g, dtype=dtype.torch_type(), device=g.device))
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
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(gshape, split) if split is not None and gshape else None
    local = _generate(gshape, split, device, comm, lambda s, g: torch.randint(
        int(low), int(high), s, generator=g, dtype=dtype.torch_type(), device=g.device))
    return DNDarray(local, gshape, dtype, split, device, comm)


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


def randperm(n: int, dtype=types.int64, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(n)`` (heat_tpu ``random.py:237``):
    every rank draws the whole permutation from the generator of the next
    key (so it does not depend on the number of ranks) and keeps its
    chunk."""
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    gshape = (int(n),)
    if split is not None:
        split = sanitize_axis(gshape, split)
    key = _next_key()
    gen = torch.Generator(device=device.torch_device)
    gen.manual_seed(_block_seed(key, 0))
    perm = torch.randperm(int(n), generator=gen, device=device.torch_device)
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
