"""The fusion engine's whole-step programs (heat_tpu ``core/fusion.py``, the
switches ``:285-565``, ``packed_psum`` ``:3113``, ``value_and_grad``
``:3361``, ``trace_step`` ``:3478-3770``, ``fit_step_call`` ``:3772`` and
``stats`` ``:3818``).

A training step, an estimator's fit step or a data-engine exchange becomes
ONE cached program per argument signature, served from the fusion
:class:`~heat_tpu_torch.utils.program_cache.ProgramCache` with heat_tpu's
counters (``op_engine.fusion_step_flushes`` / ``_fallbacks``,
``op_engine.fit_step_flushes`` / ``_fallbacks``, ``fusion.program_*``).

What "trace" and "compile" mean here
------------------------------------
* *Trace* (:func:`trace_step` only): the first call of a signature runs the
  step on tensors that hold no data (``FakeTensorMode``). A body that reads
  a value on the host (``float()``, ``.item()``, ``.numpy()``, a branch on a
  value) fails there on every device, as a jax tracer does, and that
  signature runs eagerly from then on (``op_engine.fusion_step_fallbacks``).
  Kernel wrappers take their plain versions on such tensors (shapes only),
  and a collective of the communicators sends nothing and counts nothing.
* *Compile*: a :class:`_Program`. On the CPU it is the step itself, run
  eagerly. On a card, call 1 runs the step eagerly on the program's own
  stream (the warm-up: the kernels' library, their plans and cuBLAS's
  workspace settle there); call 2 captures it as a CUDA graph on the
  program's own memory pool and replays it; every later call is one
  replay. The launches and collectives a graph holds are recorded at
  capture and counted at each replay (``kernels.launches``, ``comm.stats``).

Arguments of a graph: each tensor slot is bound at capture to the caller's
own tensor when call 2 passes the tensor of call 1 (the points of a Lloyd
fit, parameters updated in place), else to a buffer of the program's own
that each call copies its argument into (a token batch, the centroids of
the last step). A bound slot whose storage later changes is copied into
when its argument was donated, and re-captured with a buffer of its own
otherwise. A slot the program writes in place and that has a buffer of its
own is copied back into the caller's tensor after the replay. Outputs that
are the caller's tensors come back as they are, every other output as a
clone, so a replay never overwrites a tensor the caller holds and did not
donate. A cached program holds its captured tensors and graph alive until
the cache evicts it.

Part (b) of heat_tpu's engine (the lazy op tape) and part (c) (the
quantized, chunked and hierarchical wire codecs, mesh tiers) are not
ported: :func:`stats` reports the tape's counters as 0 and the codecs at
their off settings, :func:`quant_key`, :func:`chunk_key` and
:func:`hier_key` return heat_tpu's tuples for "off", and
:func:`packed_psum` raises ``NotImplementedError`` for any other setting.

Switches: ``HEAT_TPU_TORCH_FUSION`` (the master), ``HEAT_TPU_TORCH_FUSION_STEP``
(traced steps and the model-level step programs) and
``HEAT_TPU_TORCH_FUSION_FIT`` (the fit-step programs), each on by default;
``0`` turns one off.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from . import capture
from .capture import abstract

__all__ = [
    "enabled",
    "set_enabled",
    "override",
    "step_enabled",
    "set_step_enabled",
    "step_override",
    "fit_enabled",
    "set_fit_enabled",
    "fit_override",
    "quant_key",
    "chunk_key",
    "hier_key",
    "program_cache",
    "packed_psum",
    "value_and_grad",
    "grad",
    "trace_step",
    "sync",
    "fit_step_call",
    "stats",
    "reset",
]


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default) not in ("0", "false", "False")


_ENABLED = _env_on("HEAT_TPU_TORCH_FUSION")
_STEP = _env_on("HEAT_TPU_TORCH_FUSION_STEP")
_FIT = _env_on("HEAT_TPU_TORCH_FUSION_FIT")
_MAX_PROGRAMS = 1024   # heat_tpu's HEAT_TPU_FUSION_MAX_PROGRAMS default

# heat_tpu's codec settings with its environment unset (part (c))
_QUANT, _QUANT_FLOOR, _QUANT_BLOCK = None, 256, 128
_CHUNKS, _CHUNK_FLOOR = 1, 4096
_HIER, _TIERS, _HIER_ICI, _HIER_FLOOR = True, None, None, 0

_PROGRAMS = None  # built on first use (utils imports back into core)


def program_cache():
    """The fusion :class:`~heat_tpu_torch.utils.program_cache.ProgramCache`
    (heat_tpu ``:450``), capped at 1,024 programs; crossing the cap drops
    every cached program and its graph."""
    global _PROGRAMS
    if _PROGRAMS is None:
        from ..utils.program_cache import ProgramCache

        _PROGRAMS = ProgramCache(name="fusion", aot=False, max_entries=_MAX_PROGRAMS)
    return _PROGRAMS


def _metrics():
    from ..utils import metrics

    return metrics


def _faults():
    from ..utils import faults

    return faults


# ---------------------------------------------------------------------- #
# switches                                                               #
# ---------------------------------------------------------------------- #
def enabled() -> bool:
    """Whether the engine is on (``HEAT_TPU_TORCH_FUSION``, default on)."""
    return _ENABLED


def set_enabled(flag: bool) -> bool:
    """Turn the engine on or off; returns the previous setting."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


@contextlib.contextmanager
def override(flag: bool):
    """Context manager form of :func:`set_enabled`."""
    prev = set_enabled(flag)
    try:
        yield
    finally:
        set_enabled(prev)


def step_enabled() -> bool:
    """Whether :func:`trace_step` and the model-level step programs are on
    (``HEAT_TPU_TORCH_FUSION_STEP``, default on; also requires the master
    switch)."""
    return _ENABLED and _STEP


def set_step_enabled(flag: bool) -> bool:
    """Turn the step programs on or off; returns the previous setting."""
    global _STEP
    prev = _STEP
    _STEP = bool(flag)
    return prev


@contextlib.contextmanager
def step_override(flag: bool):
    """Context manager form of :func:`set_step_enabled` (the traced-against-
    eager comparisons)."""
    prev = set_step_enabled(flag)
    try:
        yield
    finally:
        set_step_enabled(prev)


def fit_enabled() -> bool:
    """Whether the estimators' fit steps, the Lanczos inner loop and the
    KNN/GaussianNB predict programs dispatch through :func:`fit_step_call`
    (``HEAT_TPU_TORCH_FUSION_FIT``, default on; also requires the master
    switch)."""
    return _ENABLED and _FIT


def set_fit_enabled(flag: bool) -> bool:
    """Turn the fit-step programs on or off; returns the previous setting."""
    global _FIT
    prev = _FIT
    _FIT = bool(flag)
    return prev


@contextlib.contextmanager
def fit_override(flag: bool):
    """Context manager form of :func:`set_fit_enabled`."""
    prev = set_fit_enabled(flag)
    try:
        yield
    finally:
        set_fit_enabled(prev)


def quant_key() -> Tuple:
    """heat_tpu's quantization identity ``(codec, floor, block)`` for the
    exact wire (``:585``); the codecs come with part (c)."""
    return (_QUANT, _QUANT_FLOOR, _QUANT_BLOCK)


def chunk_key() -> Tuple:
    """heat_tpu's chunking identity ``(count, floor)`` for one chunk
    (``:631``)."""
    return (_CHUNKS, _CHUNK_FLOOR)


def hier_key() -> Tuple:
    """heat_tpu's hierarchy identity ``(enabled, tiers, ici codec, floor)``
    with no tier declared, which is the flat wire (``:729``)."""
    return (_HIER, _TIERS, _HIER_ICI, _HIER_FLOOR)


# ---------------------------------------------------------------------- #
# pytrees of DNDarrays and tensors                                       #
# ---------------------------------------------------------------------- #
def _isdnd(x) -> bool:
    from .dndarray import DNDarray

    return isinstance(x, DNDarray)


def _flatten(tree) -> Tuple[list, Any]:
    """``(leaves, treedef)``: the leaves of nested dicts, lists and tuples
    (dicts in insertion order, as the port's parameter trees are, so a
    rebuilt tree flattens as its original; None is an empty node);
    ``treedef`` is hashable."""
    leaves: list = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = list(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node), tuple(walk(v) for v in node))
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d[0] == "none":
            return None
        if d[0] == "leaf":
            return next(it)
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        kind, children = d
        vals = [build(c) for c in children]
        return kind(*vals) if hasattr(kind, "_fields") else kind(vals)

    return build(treedef)


def _key_val(v):
    """A type-aware hashable identity of a static value, or None to decline
    (heat_tpu ``:837``): floats key by ``repr``, everything carries its type
    name, tensors and arrays decline."""
    import numpy as np

    if isinstance(v, (np.ndarray, torch.Tensor)):
        return None
    if isinstance(v, (list, tuple)):
        parts = tuple(_key_val(x) for x in v)
        return None if any(p is None for p in parts) else ("tuple", parts)
    if isinstance(v, (float, complex, np.floating, np.complexfloating)):
        return (type(v).__name__, repr(v))
    try:
        hash(v)
    except TypeError:
        return None
    return (type(v).__name__, v)


def _comm_key(comm) -> Tuple:
    """The identity of a communicator in a program key."""
    return (type(comm).__name__, comm.size, comm.rank, id(comm.group),
            getattr(comm, "axis_name", None))


def _dnd_meta(x):
    """(rebuild metadata, signature entry) of one DNDarray leaf (heat_tpu
    ``:3343``)."""
    meta = ("dnd", x.gshape, x.dtype, x.split, x.device, x.comm)
    t = x.larray
    sig = ("dnd", tuple(x.gshape), str(t.dtype), tuple(t.shape), x.split, _comm_key(x.comm),
           str(t.device))
    return meta, sig


def _rebuild_dnd(meta, tensor):
    from .dndarray import DNDarray

    _, gshape, dtype, split, device, comm = meta
    return DNDarray(tensor, gshape, dtype, split, device, comm)


# ---------------------------------------------------------------------- #
# packed all-reduce                                                      #
# ---------------------------------------------------------------------- #
def _scope(axes) -> list:
    """The communicators of a reduction scope that span more than one rank:
    ``axes`` is a communicator, a sequence of them, or empty."""
    if axes is None:
        return []
    if hasattr(axes, "size") and hasattr(axes, "group"):
        axes = (axes,)
    return [c for c in axes if c.size > 1]


def packed_psum(values, axes, qinfo: Optional[dict] = None, quant: Optional[Tuple] = None,
                chunks: Optional[Tuple] = None, hier: Optional[Tuple] = None,
                replicated: Tuple = ()):
    """Sum mutually independent partials over the ranks of ``axes`` in ONE
    flattened all-reduce per dtype (heat_tpu ``:3113``): the values of one
    dtype are flattened, concatenated, reduced and split back, in order;
    each dtype group is one collective, counted as ``packed_all_reduce``.
    ``axes`` is the communicator of the reduction scope (or a sequence of
    them, reduced in turn); where the scope is one rank, the values come
    back untouched and nothing is sent. Returns a list in ``values``' order.

    Only the exact wire is ported: ``quant``, ``chunks`` and ``hier`` other
    than heat_tpu's off tuples, and a non-empty ``replicated``, raise
    ``NotImplementedError`` (the codecs and tiers are part (c) of heat_tpu's
    engine). ``qinfo`` is accepted and left as it is: the exact wire saves no
    bytes."""
    if quant is not None and quant[0] is not None:
        raise NotImplementedError("quantized packed collectives (heat_tpu fusion part (c)) "
                                  "are not ported")
    if chunks is not None and int(chunks[0]) > 1:
        raise NotImplementedError("chunked packed collectives (heat_tpu fusion part (c)) "
                                  "are not ported")
    if (hier is not None and hier[0] and hier[1] is not None) or replicated:
        raise NotImplementedError("hierarchical packed collectives (heat_tpu fusion part (c)) "
                                  "are not ported")
    values = list(values)
    for comm in _scope(axes):
        groups: Dict[torch.dtype, list] = {}
        for i, v in enumerate(values):
            groups.setdefault(v.dtype, []).append(i)
        for dtype, members in groups.items():
            flat = torch.cat([values[i].reshape(-1) for i in members])
            flat = comm._packed_allreduce_flat(flat)
            off = 0
            for i in members:
                n = values[i].numel()
                values[i] = flat[off:off + n].view(values[i].shape)
                off += n
    return values


# ---------------------------------------------------------------------- #
# value_and_grad                                                         #
# ---------------------------------------------------------------------- #
def value_and_grad(fun, argnums=0, has_aux=False):
    """``jax.value_and_grad`` over functions of ``DNDarray`` pytrees
    (heat_tpu ``:3361``), through ``torch.autograd.grad`` on aliases of the
    shards of the differentiated arguments (the caller's tensors stay
    untouched and need not require grad).

    ``fun`` returns a scalar (a 0-d ``DNDarray`` or tensor; with
    ``has_aux`` a ``(scalar, aux)`` pair). The loss comes back as a 0-d
    ``DNDarray``; the gradients as a tree of the differentiated arguments'
    shape, each ``DNDarray`` leaf with its parameter's ``gshape``, ``split``,
    device and communicator (a leaf the loss does not reach gets zeros).
    The port's shards carry no padding, so no cotangent reaches one. ``aux``
    may hold ``DNDarray`` leaves, which come back detached. Inside
    :func:`trace_step` the whole of it is part of the one step program."""
    multi = isinstance(argnums, (tuple, list))
    idxs = tuple(argnums) if multi else (int(argnums),)

    def wrapped(*args, **kwargs):
        from . import types
        from .communication import sanitize_comm
        from .devices import sanitize_device
        from .dndarray import DNDarray

        per_arg = [_flatten(args[i]) for i in idxs]
        metas, live, spans = [], [], []
        for leaves, _ in per_arg:
            start = len(live)
            for leaf in leaves:
                if _isdnd(leaf):
                    metas.append(_dnd_meta(leaf)[0])
                    t = leaf.larray.detach()
                else:
                    metas.append(("raw",))
                    t = torch.as_tensor(leaf).detach()
                live.append(t.requires_grad_(True) if t.is_floating_point() or t.is_complex()
                            else t)
            spans.append((start, len(live)))
        rebuilt = [_rebuild_dnd(m, t) if m[0] == "dnd" else t for m, t in zip(metas, live)]
        args2 = list(args)
        for j, i in enumerate(idxs):
            lo, hi = spans[j]
            args2[i] = _unflatten(per_arg[j][1], rebuilt[lo:hi])
        with torch.enable_grad():
            out = fun(*args2, **kwargs)
            aux = None
            if has_aux:
                out, aux = out
            val = out.larray if _isdnd(out) else torch.as_tensor(out)
            val = val.reshape(())
            diff = [t for t in live if t.requires_grad]
            got = iter(torch.autograd.grad(val, diff, allow_unused=True) if diff else ())
        gs = [next(got) if t.requires_grad else None for t in live]
        gs = [torch.zeros_like(t) if g is None else g for t, g in zip(live, gs)]
        gleaves = [_rebuild_dnd(m, g) if m[0] == "dnd" else g for m, g in zip(metas, gs)]
        grads = tuple(_unflatten(per_arg[j][1], gleaves[spans[j][0]:spans[j][1]])
                      for j in range(len(idxs)))
        if not multi:
            grads = grads[0]
        first = next((m for m in metas if m[0] == "dnd"), None)
        comm = first[5] if first is not None else sanitize_comm(None)
        device = first[4] if first is not None else sanitize_device(None)
        val = val.detach()
        vout = DNDarray(val, (), types.canonical_heat_type(val.dtype), None, device, comm)
        if not has_aux:
            return vout, grads
        aleaves, atree = _flatten(aux)
        aleaves = [_rebuild_dnd(_dnd_meta(a)[0], a.larray.detach()) if _isdnd(a)
                   else (a.detach() if isinstance(a, torch.Tensor) else a) for a in aleaves]
        return (vout, _unflatten(atree, aleaves)), grads

    return wrapped


def grad(fun, argnums=0, has_aux=False):
    """:func:`value_and_grad` without the value (heat_tpu ``:3467``)."""
    vg = value_and_grad(fun, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        out, grads = vg(*args, **kwargs)
        return (grads, out[1]) if has_aux else grads

    return wrapped


# ---------------------------------------------------------------------- #
# programs: eager on the CPU, a CUDA graph on a card                     #
# ---------------------------------------------------------------------- #
def _card_of(args) -> Optional[torch.device]:
    """The card the tensors of ``args`` lie on, or None where none does;
    raises for tensors on several devices."""
    dev = None
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            if dev is not None and a.device != dev:
                raise ValueError(f"a program's tensors must lie on one card, got {dev} and "
                                 f"{a.device}")
            dev = a.device
    if dev is not None:
        for a in args:
            if isinstance(a, torch.Tensor) and not a.is_cuda:
                raise ValueError(f"a program's tensors must lie on one card, got {dev} and "
                                 f"{a.device}")
    return dev


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()
            and a.dtype == b.dtype)


class _Program:
    """One program: ``fn`` over flat arguments (tensors, and values that
    key it), returning a tensor or a tree of them. On the CPU each call runs
    ``fn``. On a card call 1 runs it on the program's stream (the warm-up),
    call 2 captures a CUDA graph and replays it, every later call replays
    it. ``graph=False`` runs ``fn`` eagerly on the card too, for a program
    whose sizes are read on the host.

    Binding, per tensor slot: at the capture a slot whose argument is call
    1's tensor is bound to the caller's memory (the program keeps no
    reference to it: a later call whose tensor has the same address and
    layout reads and writes that memory), any other slot gets a buffer of
    the program's own that each call copies its argument into. A bound slot
    whose argument moves is copied into when its argument was donated;
    otherwise the graph is captured again, bound to the new tensor, and a
    slot that moves on two calls in a row gets a buffer of its own. After a
    replay, a slot the program writes in place and that has a buffer of its
    own is copied back into the caller's tensor. An output in a bound slot's
    memory comes back as a view of the caller's tensor, an output that is
    such a written slot as the caller's tensor, any other output as a clone
    of the graph's, so a replay never overwrites a tensor the caller holds
    and did not donate."""

    def __init__(self, fn, graph: bool = True):
        self.fn = fn
        self.use_graph = graph
        self.calls = 0
        self.captures = 0
        self.graph = None
        self.failed = None      # the error of a failed capture, raised again by later calls
        self._sig = None        # per slot: the signature the graph reads (or call 1's)
        self._owned = None      # per slot: the program's own buffer, or None
        self._moved = None      # per slot: whether the last call moved it
        self._stream = None
        self._mutated = ()
        self._outs = None       # (per output leaf: how to return it, treedef)
        self._tally = None

    def __call__(self, *args, donated=()):
        dev = _card_of(args) if self.use_graph else None
        if dev is None:
            self.calls += 1
            return self.fn(*args)
        if self.failed is not None:
            raise self.failed
        if self.calls == 0:
            out = self._warm_up(dev, args)
            self.calls = 1
            return out
        if self.graph is None:
            self._owned = [a.clone() if isinstance(a, torch.Tensor)
                           and _slot_sig(a) != sig else None
                           for a, sig in zip(args, self._sig)]
            self._moved = [o is not None for o in self._owned]
            self._capture(args)
        elif self._bind(args, donated):
            self._capture(args)
        self.calls += 1
        return self._replay(args)

    # -------------------------------------------------------------- #
    def _warm_up(self, dev, args):
        self._stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self.fn(*args)
        cur.wait_stream(self._stream)
        self._sig = [_slot_sig(a) for a in args]
        return out

    def _bind(self, args, donated) -> bool:
        """Check each slot against the graph; returns whether it must be
        captured again."""
        again = False
        for i, a in enumerate(args):
            sig = _slot_sig(a)
            own = self._owned[i]
            if own is not None:
                if _layout(sig) != _layout(_slot_sig(own)):
                    # another shape or type than the buffer's
                    self._owned[i] = a.clone() if sig[0] == "t" else None
                    again = True
                continue
            moved = sig != self._sig[i]
            if moved and sig[0] == "t" and _layout(sig) == _layout(self._sig[i]) \
                    and (i in donated or self._moved[i]):
                # a donated slot, or one that moves call after call: a buffer
                # of the program's own from now on
                self._owned[i] = a.clone()
            again = again or moved
            self._moved[i] = moved
        return again

    def _capture(self, args):
        """Capture ``fn`` over the bound arguments and the program's buffers."""
        # the graph captured before, its outputs and its pool go first: each
        # capture takes a pool of its own (a pool whose last graph is gone
        # cannot take another)
        self.graph = None
        self._outs = None
        pool = torch.cuda.graph_pool_handle()
        static = [a if own is None else own for a, own in zip(args, self._owned)]
        versions = [s._version if isinstance(s, torch.Tensor) else None for s in static]
        g = torch.cuda.CUDAGraph()
        with capture.recording() as tally:
            try:
                with torch.cuda.graph(g, pool=pool, stream=self._stream):
                    out = self.fn(*static)
            except Exception as err:
                self.failed = err
                raise
        self.captures += 1
        self.graph = g
        self._tally = tally
        self._sig = [_slot_sig(a) for a in args]
        self._mutated = tuple(i for i, (s, v) in enumerate(zip(static, versions))
                              if v is not None and s._version != v)
        bound = {a.untyped_storage().data_ptr(): i for i, (a, own) in
                 enumerate(zip(args, self._owned)) if isinstance(a, torch.Tensor) and own is None}
        leaves, treedef = _flatten(out)
        ways = []
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                ways.append(("value", t))
                continue
            slot = bound.get(t.untyped_storage().data_ptr())
            if slot is not None:
                ways.append(("view", slot, tuple(t.shape), t.stride(),
                             t.storage_offset() - args[slot].storage_offset()))
                continue
            own = next((i for i in self._mutated if self._owned[i] is not None
                        and _same_view(t, self._owned[i])), None)
            ways.append(("arg", own) if own is not None else ("clone", t))
        self._outs = (ways, treedef)

    def _replay(self, args):
        from . import kernels

        for a, own in zip(args, self._owned):
            if own is not None and a is not own:
                own.copy_(a)
        self.graph.replay()
        for i in self._mutated:
            if self._owned[i] is not None:
                args[i].copy_(self._owned[i])
        for name, n in self._tally["launches"].items():
            kernels.launches[name] += n
        for comm, kind, nbytes in self._tally["comm"]:
            comm._count(kind, nbytes)
        ways, treedef = self._outs
        res = []
        for w in ways:
            if w[0] == "value":
                res.append(w[1])
            elif w[0] == "view":
                a = args[w[1]]
                res.append(a.as_strided(w[2], w[3], a.storage_offset() + w[4]))
            elif w[0] == "arg":
                res.append(args[w[1]])
            else:
                res.append(w[1].clone())
        return _unflatten(treedef, res)


def _as_program(fn) -> "_Program":
    """``fn`` as a :class:`_Program` (a ``build`` may return one of its own,
    with ``graph=False``)."""
    return fn if isinstance(fn, _Program) else _Program(fn)


def _slot_sig(a) -> Tuple:
    """What a graph reads of one argument: a tensor's address and layout, or
    a value's key."""
    if isinstance(a, torch.Tensor):
        return ("t", a.data_ptr(), tuple(a.shape), a.stride(), a.dtype, a.device)
    return ("v", _key_val(a))


def _layout(sig) -> Tuple:
    """The part of a slot signature a buffer of the program's own keeps: a
    tensor's shape, type and device (its address and strides aside)."""
    return (sig[0], sig[2], sig[4], sig[5]) if sig[0] == "t" else sig


# ---------------------------------------------------------------------- #
# trace_step                                                             #
# ---------------------------------------------------------------------- #
class _Untraceable(Exception):
    """A step argument trace_step cannot key or trace."""


class _StepRecord:
    """One cached traced step (heat_tpu ``:3478``): its :class:`_Program`,
    the output rebuild metadata of its first run and the flat dynamic slots
    of its donated arguments, whose ``DNDarray``\\ s each call invalidates."""

    __slots__ = ("program", "out_meta", "delete_slots", "ran")

    def __init__(self, program, delete_slots=()):
        self.program = program
        self.out_meta = None
        self.delete_slots = tuple(delete_slots)
        self.ran = False


# the last block=False results, for the no-argument sync(): a card runs a
# stream's work in order, so waiting on the newest implies the older ones
_ASYNC_LOCK = threading.Lock()
_ASYNC_PENDING: list = []
_ASYNC_PENDING_CAP = 8


def _note_async(results) -> None:
    ev = None
    for t in results:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            break
    with _ASYNC_LOCK:
        _ASYNC_PENDING.append(ev)
        if len(_ASYNC_PENDING) > _ASYNC_PENDING_CAP:
            del _ASYNC_PENDING[:-_ASYNC_PENDING_CAP]


def sync(*trees) -> None:
    """The host barrier of the ``block=False`` steps (heat_tpu ``:3512``).
    With arguments, wait until the card has computed every ``DNDarray`` and
    tensor leaf of the given trees; with none, wait for the last (at most 8)
    ``block=False`` :func:`trace_step` results and forget them."""
    if trees:
        cards = set()
        for tree in trees:
            for leaf in _flatten(tree)[0]:
                t = leaf.larray if _isdnd(leaf) else leaf
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    cards.add(t.device)
        for card in cards:
            torch.cuda.current_stream(card).synchronize()
        return
    with _ASYNC_LOCK:
        pending = list(_ASYNC_PENDING)
        del _ASYNC_PENDING[:]
    for ev in pending:
        if ev is not None:
            ev.synchronize()


class _TracedStep:
    """The callable :func:`trace_step` returns (heat_tpu ``:3536``): one
    cached program per structural signature of the arguments."""

    def __init__(self, fn, donate_argnums=(), block=True, trace=True):
        self.fn = fn
        self.donate_argnums = tuple(sorted(set(int(i) for i in donate_argnums)))
        self.block = bool(block)
        # False for a step the port writes itself (the optimizer update):
        # it is capturable by construction, and its torch.optim state is not
        # functional, so it must not run on data-free tensors
        self.trace = trace
        # signatures whose first call failed to trace stay eager, each alone
        self._eager_keys = set()

    def __call__(self, *args, **kwargs):
        if not (_ENABLED and _STEP):
            return self.fn(*args, **kwargs)
        try:
            flat, treedef = _flatten((args, kwargs))
            metas, sig, phys = self._classify(flat)
        except _Untraceable:
            _metrics().inc("op_engine.fusion_step_fallbacks")
            return self.fn(*args, **kwargs)
        key = ("step", self.fn, treedef, sig, self.donate_argnums, self.block, quant_key(),
               chunk_key(), hier_key())
        if key in self._eager_keys:
            _metrics().inc("op_engine.fusion_step_fallbacks")
            return self.fn(*args, **kwargs)
        record = program_cache().get_custom(key, lambda: self._build(args, treedef, metas))
        primed = record.ran
        try:
            _faults().check("fusion.step.dispatch" if primed else "fusion.step.trace")
            if not primed and self.trace:
                self._abstract_run(record, phys)
            results = record.program(*phys, donated=record.delete_slots)
        except Exception:
            if primed:
                # a program that ran before failed at dispatch: a real error
                raise
            self._eager_keys.add(key)
            _metrics().inc("op_engine.fusion_step_fallbacks")
            return self.fn(*args, **kwargs)
        record.ran = True
        self._invalidate(flat, metas, record)
        if not self.block:
            _note_async(results)
        _metrics().inc("op_engine.fusion_step_flushes")
        ometa, otree = record.out_meta
        it = iter(results)
        oleaves = []
        for m in ometa:
            if m[0] == "static":
                oleaves.append(m[1])
            elif m[0] == "dnd":
                oleaves.append(_rebuild_dnd(m, next(it)))
            else:
                oleaves.append(next(it))
        return _unflatten(otree, oleaves)

    # -------------------------------------------------------------- #
    def _classify(self, flat):
        """Per leaf: rebuild metadata, signature entry and program argument.
        ``DNDarray`` and tensor leaves are the program's arguments; anything
        else is static and keys the program (an unhashable one, or a numpy
        array, cannot be keyed)."""
        metas, sig, phys = [], [], []
        for leaf in flat:
            if _isdnd(leaf):
                m, s = _dnd_meta(leaf)
                metas.append(m)
                sig.append(s)
                phys.append(leaf.larray)
            elif isinstance(leaf, torch.Tensor):
                if abstract(leaf):
                    raise _Untraceable("a data-free tensor (a nested trace)")
                metas.append(("raw",))
                sig.append(("arr", tuple(leaf.shape), str(leaf.dtype), str(leaf.device),
                            leaf.requires_grad))
                phys.append(leaf)
            else:
                k = _key_val(leaf)
                if k is None:
                    raise _Untraceable("an argument that cannot key a program")
                metas.append(("static", leaf))
                sig.append(("static", k))
        return metas, tuple(sig), phys

    def _build(self, args, treedef, metas):
        record = [None]

        def pure(*leaf_tensors):
            it = iter(leaf_tensors)
            rebuilt = []
            for m in metas:
                if m[0] == "static":
                    rebuilt.append(m[1])
                elif m[0] == "dnd":
                    rebuilt.append(_rebuild_dnd(m, next(it)))
                else:
                    rebuilt.append(next(it))
            args2, kwargs2 = _unflatten(treedef, rebuilt)
            out = self.fn(*args2, **kwargs2)
            oflat, otree = _flatten(out)
            ometa, outs = [], []
            for o in oflat:
                if _isdnd(o):
                    ometa.append(_dnd_meta(o)[0])
                    outs.append(o.larray)
                elif isinstance(o, torch.Tensor):
                    ometa.append(("raw",))
                    outs.append(o)
                else:
                    # a host-static output (a flag, a counter) is baked in
                    ometa.append(("static", o))
            record[0].out_meta = (tuple(ometa), otree)
            return tuple(outs)

        record[0] = _StepRecord(_Program(pure), self._donate_slots(args, metas))
        return record[0]

    def _abstract_run(self, record, phys) -> None:
        """The trace: the program once on data-free copies of its arguments."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode(allow_non_fake_inputs=True)
        fakes = [mode.from_tensor(t) for t in phys]
        with mode:
            record.program.fn(*fakes)

    def _donate_slots(self, args, metas):
        """Flat dynamic-argument slots of the donated arguments."""
        if not self.donate_argnums:
            return ()
        spans, pos = [], 0
        for a in args:
            n = len(_flatten(a)[0])
            spans.append((pos, pos + n))
            pos += n
        wanted = set()
        for i in self.donate_argnums:
            if i < len(spans):
                wanted.update(range(*spans[i]))
        out, dyn = [], 0
        for slot, m in enumerate(metas):
            if m[0] == "static":
                continue
            if slot in wanted:
                out.append(dyn)
            dyn += 1
        return tuple(out)

    def _invalidate(self, flat, metas, record) -> None:
        """Donation: the donated arguments' ``DNDarray``\\ s are dead after
        the call (reading one raises), as heat_tpu's donated buffers are."""
        if not record.delete_slots:
            return
        wanted = set(record.delete_slots)
        dyn = 0
        for leaf, m in zip(flat, metas):
            if m[0] == "static":
                continue
            if dyn in wanted and _isdnd(leaf):
                leaf._donate()
            dyn += 1


def trace_step(fn, donate_argnums=(), block=True):
    """A whole (functional) training step over ``DNDarray`` and tensor
    pytrees as ONE cached program per argument signature (heat_tpu
    ``:3733``).

    The first call of a signature traces ``fn`` on data-free tensors; a body
    that reads a value on the host (``float()``, ``.item()``, ``.numpy()``,
    a branch on a value) runs eagerly from then on, for that signature alone
    (``op_engine.fusion_step_fallbacks``). Python ints, floats, strings and
    other hashable values are static: they key the program. Each call that
    runs the program counts ``op_engine.fusion_step_flushes``; on a card the
    program is a CUDA graph (see the module's docstring). ``donate_argnums``
    marks positional arguments whose ``DNDarray``\\ s the call invalidates:
    reading one afterwards raises. ``block=False`` returns without waiting
    for the card (neither form syncs the host); :func:`sync` waits for the
    results. A program that ran before and fails at dispatch (the
    ``fusion.step.dispatch`` fault site, a donated argument passed again)
    raises.

    Escape hatch: ``HEAT_TPU_TORCH_FUSION_STEP=0`` (or :func:`step_override`)
    runs every wrapped step eagerly and counts nothing."""
    return _TracedStep(fn, donate_argnums, block=block)


# ---------------------------------------------------------------------- #
# fit steps                                                              #
# ---------------------------------------------------------------------- #
def dispatch(cache, key, build, args, eager=None, *, site=None, flush_counter,
             fallback_counter=None):
    """Run ONE program of ``cache`` on ``args``: the dispatch of
    :func:`fit_step_call`, the data engine's ``engine_call`` and the
    model-level step programs.

    The program key is ``key + (quant_key(), chunk_key(), hier_key())``;
    ``build(qk, ck, hk)`` returns the program's function over ``args``,
    which becomes a :class:`_Program` (a CUDA graph on a card), or a
    :class:`_Program` of its own. The fault ``site``, where given, fires
    before the program runs. Each dispatch counts ``flush_counter``. With an
    ``eager`` form, a failed build, capture or dispatch, or the fault,
    replays ``eager(*args)`` instead, counted in ``fallback_counter``,
    unless a donated argument was invalidated already (then it raises);
    without one, the error propagates."""
    qk, ck, hk = quant_key(), chunk_key(), hier_key()
    try:
        prog = cache.get_custom(tuple(key) + (qk, ck, hk),
                                lambda: _as_program(build(qk, ck, hk)))
        if site is not None:
            _faults().check(site)
        out = prog(*args)
    except Exception:
        if eager is None or any(getattr(a, "is_deleted", lambda: False)() for a in args):
            raise
        _metrics().inc(fallback_counter)
        return eager(*args)
    _metrics().inc(flush_counter)
    return out


def fit_step_call(key, build, args, eager):
    """Dispatch ONE fit/predict step program through the fusion program
    cache (heat_tpu ``:3772``): KMeans/KMedians/KMedoids Lloyd steps, the
    Lanczos inner loop, Lasso's coordinate sweeps, the KNN and GaussianNB
    predict programs.

    ``key`` is the caller's structural signature (shapes, dtypes, the
    communicator); the program key is ``("fit",) + key + (quant_key(),
    chunk_key(), hier_key())``. ``build(qk, ck, hk)`` returns the step's
    function over ``args``. ``eager(*args)`` computes the same step without
    the program: the path of the ``fit.step.dispatch`` fault site and of a
    failed build, capture or dispatch, counted in
    ``op_engine.fit_step_fallbacks`` (:func:`dispatch`). Each program
    dispatch counts ``op_engine.fit_step_flushes``."""
    return dispatch(program_cache(), ("fit",) + tuple(key), build, args, eager,
                    site="fit.step.dispatch", flush_counter="op_engine.fit_step_flushes",
                    fallback_counter="op_engine.fit_step_fallbacks")


# ---------------------------------------------------------------------- #
# observability                                                          #
# ---------------------------------------------------------------------- #
def stats() -> dict:
    """The engine's snapshot, with heat_tpu's exact key set (``:3818``;
    folded into ``ht.runtime_stats()``). The tape's switches are off and its
    counts 0 (part (b) is not ported), the codecs at their off settings
    (part (c))."""
    c = _metrics().counters()
    flushes = int(c.get("op_engine.fusion_flushes", 0))
    ops = int(c.get("op_engine.fusion_ops", 0))
    return {
        "enabled": _ENABLED,
        "reduce_enabled": False,
        "contract_enabled": False,
        "resplit_enabled": False,
        "step_enabled": _STEP,
        "step_flushes": int(c.get("op_engine.fusion_step_flushes", 0)),
        "step_fallbacks": int(c.get("op_engine.fusion_step_fallbacks", 0)),
        "fit_enabled": _FIT,
        "fit_step_flushes": int(c.get("op_engine.fit_step_flushes", 0)),
        "fit_step_fallbacks": int(c.get("op_engine.fit_step_fallbacks", 0)),
        "flushes": flushes,
        "flush_fallbacks": int(c.get("op_engine.fusion_flush_fallbacks", 0)),
        "inline_flushes": int(c.get("op_engine.fusion_inline_flushes", 0)),
        "reduce_flushes": int(c.get("op_engine.fusion_reduce_flushes", 0)),
        "contract_flushes": int(c.get("op_engine.fusion_contract_flushes", 0)),
        "resplit_flushes": int(c.get("op_engine.fusion_resplit_flushes", 0)),
        "resplit_nodes": int(c.get("op_engine.fusion_resplit_nodes", 0)),
        "resplit_fallbacks": int(c.get("op_engine.fusion_resplit_fallbacks", 0)),
        "fused_ops": ops,
        "ops_per_flush": round(ops / flushes, 3) if flushes else 0.0,
        "max_ops": None,
        "min_ops": None,
        "quant_codec": _QUANT,
        "quant_min_numel": _QUANT_FLOOR,
        "quant_collectives": int(c.get("op_engine.quant_collectives", 0)),
        "quant_bytes_saved": int(c.get("op_engine.quant_bytes_saved", 0)),
        "quant_fallbacks": int(c.get("op_engine.quant_fallbacks", 0)),
        "chunk_count": _CHUNKS,
        "chunk_min_numel": _CHUNK_FLOOR,
        "chunk_collectives": int(c.get("op_engine.chunk_collectives", 0)),
        "chunk_fallbacks": int(c.get("op_engine.chunk_fallbacks", 0)),
        "hier_enabled": _HIER,
        "mesh_tiers": None,
        "hier_ici_codec": _HIER_ICI,
        "hier_collectives": int(c.get("op_engine.hier_collectives", 0)),
        "hier_fallbacks": int(c.get("op_engine.hier_fallbacks", 0)),
        "program_cache": program_cache().stats(),
    }


def reset() -> None:
    """Drop every cached program and its graph (heat_tpu ``:3869``)."""
    program_cache().reset()
