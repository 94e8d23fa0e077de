"""Core linear algebra (heat_tpu ``core/linalg/basics.py``).

``matmul`` follows heat_tpu's split-case plan (``core/fusion.py:1274-1291``)
on the shards, the local product one ``torch.matmul`` (float32 stays at
full precision: nothing here turns TF32 on):

========== ============================ ===================================
case       layouts                      collective
========== ============================ ===================================
local0     a.split=0, b replicated      none, output split 0
local1     a replicated, b.split=1      none, output split 1
psum       contracted axis sharded      one all-reduce, output replicated
           (a.split=1 and/or b.split=0)
replicated both replicated              none
gather     (0, 0), (0, 1), (1, 1)       one all-gather of the operand whose
                                        every row the local product needs
                                        (b, b, a), output split 0, 0, 1
========== ============================ ===================================

The output split is heat_tpu's in every case: 0 when ``a.split == 0``, else
1 when ``b.split == 1``, else None.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import arithmetics, statistics, types
from ..dndarray import DNDarray
from ..stride_tricks import broadcast_shape, sanitize_axis

__all__ = ["cross", "cond", "det", "slogdet", "kron", "tensordot", "dot", "inv", "matmul",
           "matrix_norm", "norm", "outer", "projection", "trace", "transpose", "tril", "triu",
           "vdot", "vecdot", "vector_norm", "einsum"]


def _wrap(t: torch.Tensor, split, like: DNDarray, dtype=None) -> DNDarray:
    return DNDarray.from_global(t, split, like.device, like.comm, dtype)


def _inexact_type(t: torch.Tensor) -> torch.dtype:
    """The type jnp.linalg computes an integer or bool input in (float64
    under x64)."""
    return t.dtype if (t.is_floating_point() or t.is_complex()) else torch.float64


def _product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One local ``torch.matmul``; bool operands as jnp gives them (an or of
    ands)."""
    if x.dtype == torch.bool:
        return torch.matmul(x.to(torch.int64), y.to(torch.int64)) > 0
    return torch.matmul(x, y)


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False) -> DNDarray:
    """Distributed matrix product (heat_tpu ``basics.py:65``), by the plan in
    the module docstring."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if a.ndim == 1 and b.ndim == 1:
        return dot(a, b)
    from .. import manipulations

    if a.ndim == 1:
        return manipulations.squeeze(matmul(a.reshape((1, a.shape[0])), b), axis=-2)
    if b.ndim == 1:
        return manipulations.squeeze(matmul(a, b.reshape((b.shape[0], 1))), axis=-1)
    if a.ndim != 2 or b.ndim != 2:
        return _matmul_batched(a, b)
    n, ka = a.shape
    kb, m = b.shape
    if ka != kb:
        raise ValueError(f"matmul shape mismatch: {a.shape} @ {b.shape}")
    dtype = types.promote_types(a.dtype, b.dtype)
    tt = dtype.torch_type()
    comm = a.comm
    sa, sb = a.split, b.split
    out_split = 0 if sa == 0 else (1 if sb == 1 else None)
    x, y = a.larray.to(tt), b.larray.to(tt)
    if comm.size > 1:
        if (sa == 1 or sb == 0) and sa in (1, None) and sb in (0, None):
            # psum: the contracted axis is sharded; a replicated side takes
            # this rank's chunk of it, and the partial products are summed
            koff, lshape, _ = comm.chunk((ka,), 0)
            if sa is None:
                x = x[:, koff:koff + lshape[0]]
            if sb is None:
                y = y[koff:koff + lshape[0]]
            return DNDarray(comm.Allreduce(_product(x, y)), (n, m), dtype, None, a.device, comm)
        if sa == 0 and sb in (0, 1):
            y = b._logical().to(tt)  # every row of b meets this rank's rows of a
        elif sa == 1 and sb == 1:
            x = a._logical().to(tt)  # every row of a meets this rank's columns of b
    return DNDarray(_product(x, y), (n, m), dtype, out_split, a.device, comm)


def _matmul_batched(a: DNDarray, b: DNDarray) -> DNDarray:
    """Batched matmul (heat_tpu ``basics.py:146``): a batch split that maps
    onto the output runs on the shards; otherwise both operands gather."""
    out_batch = broadcast_shape(a.shape[:-2], b.shape[:-2])
    out_shape = tuple(out_batch) + (a.shape[-2], b.shape[-1])
    ndim_out = len(out_shape)
    dtype = types.promote_types(a.dtype, b.dtype)
    tt = dtype.torch_type()
    split, primary = None, None
    for op in (a, b):
        if op.split is not None and op.split < op.ndim - 2:
            mapped = op.split + (ndim_out - op.ndim)
            if op.shape[op.split] == out_shape[mapped]:
                split, primary = mapped, op
                break
    if primary is None or 0 in out_shape or a.comm.size == 1:
        return _wrap(_product(a._logical().to(tt), b._logical().to(tt)), split, a, dtype)
    comm = a.comm
    local = []
    for op in (a, b):
        if op is primary:
            local.append(op.larray.to(tt))
            continue
        ax = split - (ndim_out - op.ndim)
        if op.split is not None:
            if op.split == ax and op.shape[op.split] == out_shape[split]:
                local.append(op.larray.to(tt))
                continue
            op = op.resplit(None)
        t = op.larray.to(tt)
        if ax >= 0 and op.shape[ax] == out_shape[split]:
            _, _, slices = comm.chunk(op.shape, ax)
            t = t[slices]
        local.append(t)
    return DNDarray(_product(local[0], local[1]), out_shape, dtype, split, a.device, comm)


def cross(a: DNDarray, b: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1,
          axis: int = -1) -> DNDarray:
    """Vector cross product (heat_tpu ``basics.py:211``): shard-local when
    both operands share a split off the vector axis, else on the logical
    arrays."""
    if axis != -1:
        axisa = axisb = axisc = axis
    va = sanitize_axis(a.shape, axisa)
    if (a.split is not None and a.split == b.split and a.gshape == b.gshape
            and va == sanitize_axis(b.shape, axisb) == sanitize_axis(a.shape, axisc)
            and a.split != va and a.shape[va] == 3):
        res = _cross(a.larray, b.larray, va, va, va)
        return DNDarray(res, a.gshape, types.canonical_heat_type(res.dtype), a.split, a.device,
                        a.comm)
    res = _cross(a._logical(), b._logical(), axisa, axisb, axisc)
    return _wrap(res, a.split if a.split is not None and a.split < res.ndim else None, a)


def _cross(x: torch.Tensor, y: torch.Tensor, axisa, axisb, axisc) -> torch.Tensor:
    """``numpy.cross`` of 2- or 3-vectors along the given axes: two
    2-vectors give the z component alone."""
    dt = torch.promote_types(x.dtype, y.dtype)
    x = torch.movedim(x.to(dt), axisa, -1)
    y = torch.movedim(y.to(dt), axisb, -1)
    planar = x.shape[-1] == 2 and y.shape[-1] == 2
    if x.shape[-1] == 2:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], -1)
    if y.shape[-1] == 2:
        y = torch.cat([y, y.new_zeros(y.shape[:-1] + (1,))], -1)
    z = torch.linalg.cross(*torch.broadcast_tensors(x, y), dim=-1)
    return z[..., 2] if planar else torch.movedim(z, -1, axisc)


def _square_check(a: DNDarray) -> None:
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected square matrix, got {a.shape}")


def _gauss_jordan(a: DNDarray):
    """The distributed Gauss-Jordan elimination of a 2-D inexact split
    matrix at world size > 1 (heat_tpu ``_gauss_jordan_path``): ``(inverse
    rows, det, logabsdet, sign)`` of ``a`` or, for split 1, of ``a.T``
    (``inv(A) = inv(Aᵀ)ᵀ``, ``det(A) = det(Aᵀ)``); else None."""
    if (a.ndim != 2 or a.split is None or a.comm.size == 1 or a.shape[0] == 0
            or not types.heat_type_is_inexact(a.dtype)):
        return None
    from ._gauss import gauss_jordan

    src = transpose(a) if a.split == 1 else a
    return gauss_jordan(src.larray.contiguous(), src.shape[0], src.comm), src


def det(a: DNDarray) -> DNDarray:
    """Determinant (heat_tpu ``basics.py:244``)."""
    _square_check(a)
    gj = _gauss_jordan(a)
    if gj is not None:
        (_, d, _, _), _ = gj
        return _wrap(d, None, a, a.dtype)
    x = a._logical()
    return _wrap(torch.linalg.det(x.to(_inexact_type(x))), None, a)


def slogdet(a: DNDarray):
    """``(sign, logabsdet)`` (heat_tpu ``basics.py:270``)."""
    _square_check(a)
    gj = _gauss_jordan(a)
    if gj is not None:
        (_, _, logabs, sgn), _ = gj
        return _wrap(sgn, None, a), _wrap(logabs, None, a)
    x = a._logical()
    sign, logabs = torch.linalg.slogdet(x.to(_inexact_type(x)))
    return _wrap(sign, None, a), _wrap(logabs, None, a)


def dot(a: DNDarray, b: DNDarray, out=None) -> DNDarray:
    """Dot product (heat_tpu ``basics.py:302``)."""
    if a.ndim == 1 and b.ndim == 1:
        result = arithmetics.sum(arithmetics.mul(a, b))
    elif a.ndim == 2 and b.ndim == 2:
        result = matmul(a, b)
    else:
        raise NotImplementedError("ht.dot supports 1-D · 1-D and 2-D @ 2-D")
    if out is not None:
        out.larray = result.larray
        return out
    return result


def inv(a: DNDarray) -> DNDarray:
    """Matrix inverse (heat_tpu ``basics.py:312``): split matrices by the
    distributed Gauss-Jordan, the rest by ``torch.linalg.inv``."""
    _square_check(a)
    gj = _gauss_jordan(a)
    if gj is not None:
        (rows, _, _, _), src = gj
        out = DNDarray(rows, src.gshape, src.dtype, 0, a.device, a.comm)
        return transpose(out) if a.split == 1 else out
    x = a._logical()
    return _wrap(torch.linalg.inv(x.to(_inexact_type(x))), a.split, a)


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix norm (heat_tpu ``basics.py:336``)."""
    a = x
    if a.ndim < 2:
        raise ValueError("matrix_norm requires at least a 2-D array")
    if axis is None:
        if a.ndim != 2:
            raise ValueError("axis must be given for >2-D arrays")
        axis = (0, 1)
    row_axis, col_axis = (sanitize_axis(a.shape, ax) for ax in axis)
    from .. import exponential

    if ord is None or ord == "fro":
        absd = a.abs()
        return exponential.sqrt(arithmetics.sum(arithmetics.mul(absd, absd),
                                                axis=(row_axis, col_axis), keepdims=keepdims))

    def abs_sum_then(statfn, sum_ax, red_ax):
        sums = arithmetics.sum(a.abs(), axis=sum_ax, keepdims=keepdims)
        if not keepdims and red_ax > sum_ax:
            red_ax -= 1
        return statfn(sums, axis=red_ax, keepdims=keepdims)

    if ord == 1:
        return abs_sum_then(statistics.max, row_axis, col_axis)
    if ord == np.inf:
        return abs_sum_then(statistics.max, col_axis, row_axis)
    if ord == -1:
        return abs_sum_then(statistics.min, row_axis, col_axis)
    if ord == -np.inf:
        return abs_sum_then(statistics.min, col_axis, row_axis)
    if ord in (2, -2, "nuc"):
        if a.ndim != 2:
            raise ValueError("singular-value norms require a 2-D matrix")
        from .svd import svd

        s = svd(a, compute_uv=False)._logical()
        val = s.sum() if ord == "nuc" else (s[0] if ord == 2 else s[-1])
        if keepdims:
            val = val.reshape((1, 1))
        return _wrap(val, None, a)
    raise ValueError(f"unsupported matrix norm order {ord}")


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector or matrix norm (heat_tpu ``basics.py:389``)."""
    a = x
    if axis is None and a.ndim <= 1:
        return vector_norm(a, axis=None, keepdims=keepdims, ord=ord)
    if axis is None and ord is None:
        from .. import exponential

        absd = a.abs()
        return exponential.sqrt(arithmetics.sum(arithmetics.mul(absd, absd)))
    if isinstance(axis, (int, np.integer)):
        return vector_norm(a, axis=axis, keepdims=keepdims, ord=ord)
    return matrix_norm(a, axis=axis, keepdims=keepdims, ord=ord)


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector norm (heat_tpu ``basics.py:406``)."""
    from .. import _operations, exponential

    a = x
    if ord is None or ord == 2:
        absd = a.abs()
        return exponential.sqrt(arithmetics.sum(arithmetics.mul(absd, absd), axis=axis,
                                                keepdims=keepdims))
    if ord == np.inf:
        return statistics.max(a.abs(), axis=axis, keepdims=keepdims)
    if ord == -np.inf:
        return statistics.min(a.abs(), axis=axis, keepdims=keepdims)
    if ord == 0:
        nz = _operations._local_op(
            lambda t: (t != 0).to(t.dtype if t.is_floating_point() else torch.float32), a)
        return arithmetics.sum(nz, axis=axis, keepdims=keepdims)
    if isinstance(ord, (int, float)):
        p = float(ord)
        powed = _operations._local_op(lambda t: t.abs() ** p, a)
        s = arithmetics.sum(powed, axis=axis, keepdims=keepdims)
        return _operations._local_op(lambda t: t ** (1.0 / p), s)
    raise ValueError(f"unsupported vector norm order {ord}")


def outer(a: DNDarray, b: DNDarray, out=None, split=None) -> DNDarray:
    """Outer product (heat_tpu ``basics.py:436``): a rank-1 ``matmul``."""
    a1 = a.reshape((a.size, 1)) if a.ndim == 1 else a.flatten().reshape((a.size, 1))
    b1 = b.reshape((1, b.size)) if b.ndim == 1 else b.flatten().reshape((1, b.size))
    if split == 1:
        a1 = a1.resplit(None)
        b1 = b1.resplit(1)
    result = matmul(a1, b1)
    if split is not None and result.split != split:
        result = result.resplit(split)
    if out is not None:
        out.larray = result.larray
        return out
    return result


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of ``a`` onto ``b`` (heat_tpu ``basics.py:453``)."""
    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"projection requires 1-D vectors, got {a.shape}, {b.shape}")
    return arithmetics.mul(arithmetics.div(dot(a, b), dot(b, b)), b)


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None,
          out=None) -> DNDarray:
    """Sum along a diagonal (heat_tpu ``basics.py:461``)."""
    from .. import manipulations

    d = manipulations.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)
    result = arithmetics.sum(d, axis=d.ndim - 1 if d.ndim > 1 else None)
    if dtype is not None:
        result = result.astype(types.canonical_heat_type(dtype))
    if out is not None:
        out.larray = result.larray
        return out
    return result


def transpose(a: DNDarray, axes=None) -> DNDarray:
    """Axis permutation (heat_tpu ``basics.py:478``): a local permute, the
    split axis remapped."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"a must be a DNDarray, got {type(a)}")
    from .. import manipulations

    return manipulations._transpose(a, axes)


def _tri_op(a: DNDarray, k: int, op) -> DNDarray:
    """tril/triu (heat_tpu ``basics.py:496``) on the shard: the diagonal
    moves by the shard's global offset along a split matrix axis."""
    if a.ndim == 1:
        t = a._logical()
        return _wrap(op(t.expand(a.shape[0], a.shape[0]), k), 0 if a.split is not None else None,
                     a)
    shift = 0
    if a.split is not None and a.split >= a.ndim - 2:
        offset = a.comm.chunk(a.shape, a.split)[0]
        shift = offset if a.split == a.ndim - 2 else -offset
    return DNDarray(op(a.larray, k + shift), a.gshape, a.dtype, a.split, a.device, a.comm)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """Lower-triangular part (heat_tpu ``basics.py:508``)."""
    return _tri_op(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """Upper-triangular part (heat_tpu ``basics.py:513``)."""
    return _tri_op(m, k, torch.triu)


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """Conjugated dot product (heat_tpu ``basics.py:520``)."""
    from .. import complex_math

    return dot(complex_math.conj(x1).flatten(), x2.flatten())


def vecdot(x1: DNDarray, x2: DNDarray, axis=None, keepdims: bool = False,
           keepdim=None) -> DNDarray:
    """Vector dot along an axis (heat_tpu ``basics.py:527``)."""
    from .. import complex_math

    if keepdim is not None:
        keepdims = keepdim
    m = arithmetics.mul(complex_math.conj(x1), x2)
    return arithmetics.sum(m, axis=m.ndim - 1 if axis is None else axis, keepdims=keepdims)


_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def tensordot(a: DNDarray, b: DNDarray, axes=2) -> DNDarray:
    """Tensor contraction over the given axes (heat_tpu ``basics.py:542``),
    through :func:`einsum`."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if isinstance(axes, (int, np.integer)):
        ax_a = list(range(a.ndim - int(axes), a.ndim))
        ax_b = list(range(int(axes)))
    else:
        ax_a, ax_b = axes
        ax_a = [ax_a] if isinstance(ax_a, (int, np.integer)) else list(ax_a)
        ax_b = [ax_b] if isinstance(ax_b, (int, np.integer)) else list(ax_b)
    ax_a = [sanitize_axis(a.shape, ax) for ax in ax_a]
    ax_b = [sanitize_axis(b.shape, ax) for ax in ax_b]
    if len(ax_a) != len(ax_b):
        raise ValueError("axes lists must have matching lengths")
    if len(set(ax_a)) != len(ax_a) or len(set(ax_b)) != len(ax_b):
        raise ValueError("duplicate contracted axes")
    if a.ndim + b.ndim - len(ax_a) > len(_LETTERS):
        raise ValueError("too many dimensions for tensordot")
    it = iter(_LETTERS)
    sa, sb = [""] * a.ndim, [""] * b.ndim
    for i, j in zip(ax_a, ax_b):
        sa[i] = sb[j] = next(it)
    sa = [s or next(it) for s in sa]
    sb = [s or next(it) for s in sb]
    out_sub = "".join(sa[i] for i in range(a.ndim) if i not in ax_a) + \
        "".join(sb[j] for j in range(b.ndim) if j not in ax_b)
    return einsum(f"{''.join(sa)},{''.join(sb)}->{out_sub}", a, b)


def kron(a: DNDarray, b: DNDarray) -> DNDarray:
    """Kronecker product (heat_tpu ``basics.py:581``): 1-D and 2-D operands
    through :func:`einsum` and one reshape."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if a.ndim > 2 or b.ndim > 2 or a.ndim == 0 or b.ndim == 0:
        return _wrap(torch.kron(a._logical(), b._logical()), None, a)
    from .. import manipulations

    if a.ndim == 1 and b.ndim == 1:
        return manipulations.reshape(einsum("i,j->ij", a, b), (a.shape[0] * b.shape[0],))
    a2 = a if a.ndim == 2 else a.reshape((1, a.shape[0]))
    b2 = b if b.ndim == 2 else b.reshape((1, b.shape[0]))
    return manipulations.reshape(einsum("ij,kl->ikjl", a2, b2),
                                 (a2.shape[0] * b2.shape[0], a2.shape[1] * b2.shape[1]))


def cond(x: DNDarray, p=None) -> DNDarray:
    """Condition number (heat_tpu ``basics.py:603``)."""
    if x.ndim != 2:
        raise ValueError("cond requires a 2-D matrix")
    if p in (None, 2, -2):
        from .svd import svd

        s = svd(x, compute_uv=False)._logical()
        return _wrap(s[-1] / s[0] if p == -2 else s[0] / s[-1], None, x)
    _square_check(x)
    return arithmetics.mul(matrix_norm(x, ord=p), matrix_norm(inv(x), ord=p))


def einsum(subscripts: str, *operands: DNDarray, out=None) -> DNDarray:
    """Einstein summation (heat_tpu ``basics.py:622``). The output keeps the
    split of its first label that is a split axis of an operand. Where every
    split operand is split along one label ``L`` that no operand repeats, the
    sum runs on the shards (replicated operands holding ``L`` take their
    chunk of it): shard-local when ``L`` survives, one all-reduce when it is
    contracted. Other layouts run on the logical arrays."""
    if "..." in subscripts:
        raise NotImplementedError("einsum with ellipsis is not supported")
    if not operands:
        raise ValueError("einsum needs at least one operand")
    if any(not isinstance(op, DNDarray) for op in operands):
        raise TypeError("all operands must be DNDarrays")
    expr = subscripts.replace(" ", "")
    if "->" in expr:
        in_part, out_part = expr.split("->")
    else:
        in_part = expr
        counts = Counter(c for c in in_part if c.isalpha())
        out_part = "".join(sorted(c for c, k in counts.items() if k == 1))
    in_specs = in_part.split(",")
    if len(in_specs) != len(operands):
        raise ValueError(f"{len(in_specs)} subscript groups for {len(operands)} operands")
    if len(set(out_part)) != len(out_part):
        raise ValueError("repeated output labels are not supported")
    sizes: dict = {}
    for op, spec in zip(operands, in_specs):
        if len(spec) != op.ndim:
            raise ValueError(f"subscript {spec!r} does not match operand ndim {op.ndim}")
        for ax, label in enumerate(spec):
            if sizes.setdefault(label, op.gshape[ax]) != op.gshape[ax]:
                raise ValueError(f"size of label {label!r} does not match between operands "
                                 f"({sizes[label]} vs {op.gshape[ax]})")
    out_split = None
    for pos, label in enumerate(out_part):
        if any(op.split is not None and spec[op.split] == label
               for op, spec in zip(operands, in_specs)):
            out_split = pos
            break
    first = operands[0]
    comm = first.comm
    dtype = operands[0].dtype
    for op in operands[1:]:
        dtype = types.promote_types(dtype, op.dtype)
    tt = dtype.torch_type()
    eq = in_part + "->" + out_part
    split_labels = {spec[op.split] for op, spec in zip(operands, in_specs) if op.split is not None}
    if comm.size > 1 and len(split_labels) == 1:
        (label,) = split_labels
        holders = [(op, spec) for op, spec in zip(operands, in_specs) if label in spec]
        if all(spec.count(label) == 1 for _, spec in holders):
            local = []
            for op, spec in zip(operands, in_specs):
                t = op.larray.to(tt)
                if op.split is None and label in spec:
                    ax = spec.index(label)
                    t = t[comm.chunk(op.shape, ax)[2]]
                local.append(t)
            res = torch.einsum(eq, *local)
            shape = tuple(sizes[lb] for lb in out_part)
            if label in out_part:
                result = DNDarray(res, shape, dtype, out_part.index(label), first.device, comm)
            else:
                result = DNDarray(comm.Allreduce(res), shape, dtype, None, first.device, comm)
                if out_split is not None:
                    result = result.resplit(out_split)
            return _einsum_out(result, out)
    res = torch.einsum(eq, *[op._logical().to(tt) for op in operands])
    return _einsum_out(DNDarray.from_global(res, out_split, first.device, comm, dtype), out)


def _einsum_out(result: DNDarray, out):
    if out is None:
        return result
    from .. import sanitation

    sanitation.sanitize_out(out, result.shape, result.split, result.device)
    out.larray = result.resplit(out.split).larray
    return out
