"""Public test harness for downstream and user test suites (heat_tpu
``testing.py``, after the reference's ``basic_test.py``).

``assert_array_equal`` checks the distribution (each rank's shard shape
against the balanced chunk formula, and this rank's shard against its slice
of the expected array) and then the gathered values; ``assert_func_equal``
is the property-style "run the function for every split and compare with
NumPy" idiom; :class:`TestCase` binds both for ``unittest`` and pytest::

    import heat_tpu_torch as ht
    from heat_tpu_torch.testing import TestCase

    class TestMyOp(TestCase):
        def test_exp(self):
            self.assert_func_equal((4, 5), ht.exp, np.exp)

The port's shards are unpadded tensors of each process, so the per-rank
check covers every rank's ``lshape_map`` row and this process's own shard
(heat_tpu, one controller, reads every device's rows); in a world of
several processes each rank checks its own. Floats compare within 16 ulp of
the result type (bfloat16 by its own epsilon: numpy has no bfloat16, so a
bf16 array's values arrive as float32).
"""

from __future__ import annotations

import unittest
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .core import factories, types
from .core.communication import get_comm
from .core.devices import get_device
from .core.dndarray import DNDarray

__all__ = ["TestCase", "assert_array_equal", "assert_func_equal",
           "assert_func_equal_for_tensor"]


def _random_array(shape, dtype=np.float32, low=-10000, high=10000,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random NumPy array: ``standard_normal`` for floats, ``integers`` for
    ints (heat_tpu ``testing.py:40``)."""
    rng = rng or np.random.default_rng()
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal(shape).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(low, high, size=shape).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    if dtype == np.bool_:
        return rng.integers(0, 2, size=shape).astype(dtype)
    raise TypeError(f"unsupported dtype {dtype}: expected floating, integer, complex or bool")


def _compare(actual, desired, err_msg: str, eps: Optional[float] = None) -> None:
    """Exact for integer and bool data; within 16 ulp (``eps``, by default
    the result type's) for float and complex (heat_tpu ``testing.py:60``).
    The ground truth is first quantized to the returned type, where heat
    promotes ints to float32 and NumPy goes to float64."""
    actual = np.asarray(actual)
    desired = np.asarray(desired)
    ak, dk = actual.dtype.kind, desired.dtype.kind
    if {ak, dk} <= set("iub"):
        np.testing.assert_array_equal(actual, desired, err_msg=err_msg)
        return
    if ak in "fc" and not (ak == "f" and dk == "c"):
        # a real actual against a truly complex expectation must fail in the
        # complex comparison below, never drop the imaginary part
        desired = desired.astype(actual.dtype)
    if eps is None:
        eps = float(np.finfo(actual.dtype if ak in "fc" else desired.dtype).eps)
    cplx = "c" in {ak, dk}
    np.testing.assert_allclose(actual.astype(np.complex128 if cplx else np.float64),
                               desired.astype(np.complex128 if cplx else np.float64),
                               rtol=16 * eps, atol=16 * eps, err_msg=err_msg)


def _eps(x: DNDarray) -> Optional[float]:
    """bfloat16's epsilon for a bf16 array (its values arrive as float32),
    else None (the result type's)."""
    return torch.finfo(torch.bfloat16).eps if x.larray.dtype == torch.bfloat16 else None


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def assert_array_equal(heat_array: DNDarray, expected_array, check_dtype: bool = True) -> None:
    """Assert a DNDarray equals a NumPy reference, distribution first
    (heat_tpu ``testing.py:102``): it is a ``DNDarray``; the global shape
    matches; the type corresponds (``check_dtype=False`` skips this); every
    rank's ``lshape_map`` row is its balanced chunk and this rank's shard is
    its slice of the expected array; the gathered array equals the expected
    one."""
    if not isinstance(heat_array, DNDarray):
        raise AssertionError(f"not a DNDarray: {type(heat_array)}; the public API must return "
                             "wrapped distributed arrays")
    expected_array = np.asarray(expected_array)
    if tuple(heat_array.shape) != tuple(expected_array.shape):
        raise AssertionError(f"global shape mismatch: {tuple(heat_array.shape)} vs expected "
                             f"{tuple(expected_array.shape)}")
    if check_dtype and expected_array.dtype.kind not in "OUS":
        exp_ht = types.canonical_heat_type(expected_array.dtype)
        if types.canonical_heat_type(heat_array.dtype) is not exp_ht:
            raise AssertionError(f"dtype mismatch: {heat_array.dtype} vs expected "
                                 f"{expected_array.dtype} (heat type {exp_ht})")
    split = heat_array.split
    comm = heat_array.comm
    eps = _eps(heat_array)
    if split is not None and len(heat_array.shape) > 0:
        lmap = np.asarray(heat_array.lshape_map)
        for rank in range(comm.size):
            _, lshape, _ = comm.chunk(heat_array.shape, split, rank=rank)
            if tuple(lmap[rank]) != tuple(lshape):
                raise AssertionError(f"rank {rank}: lshape_map row {tuple(lmap[rank])} != "
                                     f"balanced chunk {tuple(lshape)} (split={split})")
        _, _, slices = comm.chunk(heat_array.shape, split)
        _compare(_host(heat_array.larray), expected_array[slices],
                 f"rank {comm.rank} shard content mismatch (split={split})", eps)
    _compare(heat_array.numpy(), expected_array,
             f"gathered content mismatch (dtype {heat_array.dtype.__name__})", eps)


def assert_func_equal_for_tensor(tensor, heat_func: Callable, numpy_func: Callable,
                                 heat_args: Optional[dict] = None,
                                 numpy_args: Optional[dict] = None,
                                 distributed_result: bool = True) -> None:
    """Run ``heat_func`` with ``split=None`` and every split axis on
    ``tensor`` and compare each result with ``numpy_func`` on the same data
    (heat_tpu ``testing.py:156``). ``distributed_result=False`` marks a
    replicated result (a global reduction): only its gathered value is
    compared."""
    heat_args = dict(heat_args or {})
    numpy_args = dict(numpy_args or {})
    tensor = np.asarray(tensor)
    expected = np.asarray(numpy_func(tensor, **numpy_args))
    for split in (None, *range(tensor.ndim)):
        a = factories.array(tensor, split=split)
        result = heat_func(a, **heat_args)
        if np.isscalar(result) or not isinstance(result, DNDarray):
            _compare(np.asarray(result), expected, f"scalar result mismatch for split={split}")
            continue
        if distributed_result and result.split is not None:
            assert_array_equal(result, expected, check_dtype=False)
        else:
            _compare(result.numpy(), expected, f"result mismatch for split={split}",
                     _eps(result))


def assert_func_equal(shape: Union[Sequence[int], tuple], heat_func: Callable,
                      numpy_func: Callable, distributed_result: bool = True,
                      heat_args: Optional[dict] = None, numpy_args: Optional[dict] = None,
                      data_types: Sequence = (np.int32, np.int64, np.float32, np.float64),
                      low: int = -10000, high: int = 10000, seed: Optional[int] = None) -> None:
    """Property-style check (heat_tpu ``testing.py:191``): random arrays of
    ``shape`` for every type in ``data_types``, each through
    :func:`assert_func_equal_for_tensor`; ``seed`` makes them
    reproducible."""
    if not isinstance(shape, (tuple, list)):
        raise ValueError(f"shape must be a list or tuple, got {type(shape)}")
    rng = np.random.default_rng(seed)
    for dtype in data_types:
        tensor = _random_array(shape, dtype=dtype, low=low, high=high, rng=rng)
        assert_func_equal_for_tensor(tensor=tensor, heat_func=heat_func, numpy_func=numpy_func,
                                     heat_args=heat_args, numpy_args=numpy_args,
                                     distributed_result=distributed_result)


class TestCase(unittest.TestCase):
    """Drop-in base class for user test suites (heat_tpu ``testing.py:220``)."""

    @property
    def comm(self):
        return get_comm()

    @property
    def device(self):
        return get_device()

    def get_rank(self) -> int:
        return self.comm.rank

    def get_size(self) -> int:
        return self.comm.size

    def assert_array_equal(self, heat_array, expected_array, check_dtype: bool = True):
        assert_array_equal(heat_array, expected_array, check_dtype=check_dtype)

    def assert_func_equal(self, shape, heat_func, numpy_func, **kwargs):
        assert_func_equal(shape, heat_func, numpy_func, **kwargs)

    def assert_func_equal_for_tensor(self, tensor, heat_func, numpy_func, **kwargs):
        assert_func_equal_for_tensor(tensor, heat_func, numpy_func, **kwargs)

    def assertTrue_memory_layout(self, tensor, order):
        """Layout assertion (heat_tpu ``testing.py:250``): the logical
        ``order`` attribute that ``sanitize_memory_layout`` records."""
        recorded = getattr(tensor, "order", "C")
        self.assertEqual(recorded, order, f"memory layout {recorded!r} != expected {order!r}")
