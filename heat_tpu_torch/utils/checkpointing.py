"""Checkpoint and recover (heat_tpu ``utils/checkpointing.py``).

One API checkpoints DNDarrays, trees of tensors and numpy arrays (model
parameters), the port's optimizer state and estimators, with atomic writes.

**The layout is heat_tpu's**: a directory with ``manifest.json`` (the step
and one entry per state name) and ``arrays.npz`` (every array leaf), with
heat_tpu's entry kinds and leaf paths:

* ``"dndarray"``: the global array under the entry's name, with its split
  and dtype name; it loads as a DNDarray of that split and dtype;
* ``"scalar"``: an int, float, str, bool or None kept in the manifest;
* ``"pytree"``: nested dicts, lists, tuples and namedtuples, each array leaf
  under ``<name>::<path>`` with its kind (``"dndarray"`` or ``"array"``)
  and the container ``spec``. A tensor or numpy leaf saves as an
  ``"array"``; a bfloat16 tensor as its float32 values with ``"dtype":
  "bfloat16"`` beside the kind (heat_tpu reads those values as float32).

So a checkpoint either package writes loads in the other: a parameter tree
crosses through :func:`~heat_tpu_torch.utils.convert.transformer_tree_to_numpy`
and ``transformer_params_from_numpy``. DNDarrays and ``"array"`` leaves load
onto the port's default device (the card, unless ``use_device("cpu")``).

The port's optimizer state (a ``torch.optim`` optimizer that
:mod:`heat_tpu_torch.optim`'s ``tx.init(params)`` built) saves as an entry of
kind ``"optimizer"``, a port-only kind: its class (from an allow-listed
module), its settings, its ``state_dict`` tensors as leaves, and for each
parameter the array key of the tensor of the same state it updates. On load
the optimizer is rebuilt over the restored tensors, so training resumes
bit for bit. heat_tpu cannot read this kind (optax's state is another
structure).

:class:`CheckpointManager` keeps rotating checkpoints with quarantine of
corrupt steps; :func:`run_with_recovery` restarts a crashed training loop
from the newest good one. The fault sites ``checkpoint.leaf.write``,
``checkpoint.manifest.write``, ``checkpoint.manifest.read`` and
``checkpoint.leaf.read`` (:mod:`heat_tpu_torch.utils.faults`) raise where a
file system would.

At world size above 1 every rank gathers (``DNDarray.numpy``) and rank 0
writes; one barrier follows each save, and every rank raises where rank 0's
write failed.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import devices, factories, types
from ..core.communication import get_comm
from ..core.dndarray import DNDarray

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_estimator",
    "restore_estimator",
    "CheckpointManager",
    "run_with_recovery",
]

_MANIFEST = "manifest.json"

# namedtuple and optimizer classes are rebuilt on restore only from these
# top-level modules; another namedtuple comes back as a plain tuple with a
# warning, another optimizer raises
NAMEDTUPLE_ALLOWLIST = {"heat_tpu_torch", "torch"}


def _flatten(tree, prefix=""):
    """Nested dicts/lists/tuples of arrays -> (path -> leaf, spec); ``spec``
    is heat_tpu's JSON structure descriptor, so containers round-trip with
    their exact types."""
    out = {}
    if isinstance(tree, dict):
        spec = {"kind": "dict", "items": {}}
        for k, v in tree.items():
            sub, subspec = _flatten(v, f"{prefix}/{k}" if prefix else str(k))
            out.update(sub)
            spec["items"][k] = subspec
    elif isinstance(tree, (list, tuple)):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            cls = type(tree)
            spec = {"kind": "namedtuple", "cls": [cls.__module__, cls.__qualname__],
                    "items": []}
        else:
            spec = {"kind": "tuple" if isinstance(tree, tuple) else "list", "items": []}
        for i, v in enumerate(tree):
            sub, subspec = _flatten(v, f"{prefix}/{i}" if prefix else str(i))
            out.update(sub)
            spec["items"].append(subspec)
    else:
        spec = {"kind": "leaf", "path": prefix}
        out[prefix] = tree
    return out, spec


def _host(t: torch.Tensor):
    """A tensor as numpy for the npz, with the manifest's dtype note for
    bfloat16 (numpy has none: its float32 values are saved)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy(), {"dtype": "bfloat16"}
    return t.cpu().numpy(), {}


def save_checkpoint(path: str, state: Dict[str, Any], step: Optional[int] = None) -> None:
    """Write ``state`` (a dict of DNDarrays, trees of tensors or arrays,
    optimizers and scalars) atomically, heat_tpu's layout (``:72``)."""
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": step, "entries": {}}
    owner: Dict[int, str] = {}  # id of a saved tensor -> its array key
    optimizers = []

    for name, value in state.items():
        if isinstance(value, DNDarray):
            arrays[name] = value.numpy()
            manifest["entries"][name] = {"kind": "dndarray", "split": value.split,
                                         "dtype": value.dtype.__name__}
        elif isinstance(value, (int, float, str, bool)) or value is None:
            manifest["entries"][name] = {"kind": "scalar", "value": value}
        elif isinstance(value, torch.optim.Optimizer):
            optimizers.append((name, value))
        else:
            leaves, spec = _flatten(value)
            keys = {}
            for leaf_path, leaf in leaves.items():
                arr_key = f"{name}::{leaf_path}"
                if isinstance(leaf, DNDarray):
                    arrays[arr_key] = leaf.numpy()
                    keys[leaf_path] = {"kind": "dndarray", "split": leaf.split,
                                       "dtype": leaf.dtype.__name__}
                elif torch.is_tensor(leaf):
                    arrays[arr_key], note = _host(leaf)
                    keys[leaf_path] = {"kind": "array", **note}
                    owner[id(leaf)] = arr_key
                else:
                    arrays[arr_key] = np.asarray(leaf)
                    keys[leaf_path] = {"kind": "array"}
            manifest["entries"][name] = {"kind": "pytree", "leaves": keys, "spec": spec}
    for name, opt in optimizers:
        manifest["entries"][name] = _save_optimizer(name, opt, arrays, owner)

    comm = get_comm()
    err = None
    if comm.rank == 0:
        try:
            os.makedirs(path, exist_ok=True)
            # leaf payload FIRST, manifest LAST: the manifest marks a complete
            # checkpoint, so it never appears before the arrays it describes
            _atomic_write(path, "arrays.npz", ".tmp.npz", lambda tmp: np.savez(tmp, **arrays),
                          "checkpoint.leaf.write")

            def _write_manifest(tmp):
                with open(tmp, "w") as f:
                    json.dump(manifest, f)

            _atomic_write(path, _MANIFEST, ".json.tmp", _write_manifest,
                          "checkpoint.manifest.write")
        except BaseException as exc:  # noqa: BLE001 — every rank learns of it below
            err = exc
    # every rank raises when rank 0's write failed
    if comm.size > 1 and comm.Barrier(err is not None) and err is None:
        raise OSError(f"checkpoint {path!r}: rank 0 failed to write it")
    if err is not None:
        raise err


def _save_optimizer(name: str, opt: torch.optim.Optimizer, arrays, owner) -> dict:
    """The ``"optimizer"`` entry of ``opt``: its class and settings, its
    per-parameter state as array leaves under ``<name>::state/<i>/<key>``,
    and each parameter's array key in this checkpoint (the parameter itself
    under ``<name>::param/<i>`` where the state holds no tensor of it)."""
    cls = type(opt)
    sd = opt.state_dict()
    params = [p for group in opt.param_groups for p in group["params"]]
    param_keys = []
    for i, p in enumerate(params):
        key = owner.get(id(p))
        if key is None:
            key = f"{name}::param/{i}"
            arrays[key], _ = _host(p)
        param_keys.append(key)
    state = {}
    for i, st in sd["state"].items():
        entry = {}
        for k, v in st.items():
            if torch.is_tensor(v):
                arr_key = f"{name}::state/{i}/{k}"
                arrays[arr_key], note = _host(v)
                entry[k] = {"array": arr_key, "shape": list(v.shape), **note}
            else:
                entry[k] = {"value": v}
        state[str(i)] = entry
    groups = [{k: v for k, v in g.items()} for g in sd["param_groups"]]
    for g in groups:
        for k, v in g.items():
            if isinstance(v, tuple):
                g[k] = {"tuple": list(v)}
    return {"kind": "optimizer", "cls": [cls.__module__, cls.__qualname__],
            "defaults": {k: ({"tuple": list(v)} if isinstance(v, tuple) else v)
                         for k, v in opt.defaults.items()},
            "param_groups": groups, "state": state, "params": param_keys}


def _atomic_write(dirpath: str, final_name: str, suffix: str, write_fn, site: str) -> None:
    """Write ``final_name`` atomically (a temp file, then ``os.replace``),
    retrying ONCE on an ``OSError`` (``checkpoint.write_retries``); a second
    failure raises. The temp file never survives, and the final name is
    either the whole new payload or untouched (heat_tpu ``:126``)."""
    from . import faults as _faults
    from . import metrics as _metrics

    for attempt in (1, 2):
        fd, tmp = tempfile.mkstemp(dir=dirpath, suffix=suffix)
        os.close(fd)
        try:
            _faults.check(site)
            write_fn(tmp)
            os.replace(tmp, os.path.join(dirpath, final_name))
            return
        except BaseException as exc:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if not isinstance(exc, OSError) or attempt == 2:
                raise
            _metrics.inc("checkpoint.write_retries")


def _unflatten(leaves: Dict[str, Any], spec=None):
    """The container structure from path -> restored leaf (heat_tpu
    ``:160``); without a ``spec`` (legacy manifests) nested dicts."""
    if spec is not None:
        if spec["kind"] == "leaf":
            return leaves[spec["path"]]
        if spec["kind"] == "dict":
            return {k: _unflatten(leaves, s) for k, s in spec["items"].items()}
        rebuilt = [_unflatten(leaves, s) for s in spec["items"]]
        if spec["kind"] == "namedtuple":
            cls = _allowed_class(spec["cls"], NAMEDTUPLE_ALLOWLIST, "namedtuple")
            if cls is None or not (issubclass(cls, tuple) and hasattr(cls, "_fields")):
                return tuple(rebuilt)
            return cls(*rebuilt)
        return tuple(rebuilt) if spec["kind"] == "tuple" else rebuilt
    root: Dict[str, Any] = {}
    for path, leaf in leaves.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _allowed_class(cls_path, allow, what: str):
    """The class ``[module, qualname]`` where its top-level module is in
    ``allow`` and it imports; else None with a warning (manifests are data,
    not code)."""
    import importlib
    import warnings

    mod, qualname = cls_path
    reason = None
    if mod.partition(".")[0] not in allow:
        reason = "module not in allowlist"
    else:
        try:
            cls = importlib.import_module(mod)
            for part in qualname.split("."):
                cls = getattr(cls, part)
            if isinstance(cls, type):
                return cls
            reason = "not a class"
        except (ImportError, AttributeError):
            reason = "class not importable"
    warnings.warn(f"checkpoint {what} {cls_path} not rebuilt ({reason}); extend "
                  f"heat_tpu_torch.utils.checkpointing.NAMEDTUPLE_ALLOWLIST to restore "
                  f"custom classes", stacklevel=3)
    return None


def _tensor(raw: np.ndarray, meta: dict, device) -> torch.Tensor:
    """An ``"array"`` leaf as a tensor on ``device``. heat_tpu's bfloat16
    leaves arrive as numpy's 2-byte void type: their bits are bfloat16's."""
    if raw.dtype.kind == "V" and raw.dtype.itemsize == 2:
        return torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16).to(device)
    t = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
    if meta.get("dtype") == "bfloat16":
        t = t.to(torch.bfloat16)
    return t


def _dndarray(raw: np.ndarray, meta: dict, device) -> DNDarray:
    dtype = getattr(types, meta["dtype"])
    if raw.dtype.kind == "V" and raw.dtype.itemsize == 2:  # heat_tpu's bfloat16
        raw = _tensor(raw, meta, "cpu").float().numpy()
    return factories.array(raw, dtype=dtype, split=meta["split"], device=device)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Restore a checkpoint of either package (heat_tpu ``:211``): every
    name of the saved state, plus ``"__step__"``."""
    from . import faults as _faults

    dev = devices.get_device()
    tdev = dev.torch_device
    _faults.check("checkpoint.manifest.read")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    _faults.check("checkpoint.leaf.read")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}

    state: Dict[str, Any] = {"__step__": manifest.get("step")}
    restored: Dict[str, torch.Tensor] = {}  # array key -> tensor, for optimizers
    for name, meta in manifest["entries"].items():
        if meta["kind"] == "dndarray":
            state[name] = _dndarray(arrays[name], meta, dev)
        elif meta["kind"] == "scalar":
            state[name] = meta["value"]
        elif meta["kind"] == "pytree":
            leaf_meta = meta["leaves"]
            if isinstance(leaf_meta, list):  # legacy manifests: plain arrays
                leaf_meta = {p: {"kind": "array"} for p in leaf_meta}
            leaves: Dict[str, Any] = {}
            for leaf_path, lm in leaf_meta.items():
                key = f"{name}::{leaf_path}"
                if lm["kind"] == "dndarray":
                    leaves[leaf_path] = _dndarray(arrays[key], lm, dev)
                else:
                    leaves[leaf_path] = restored[key] = _tensor(arrays[key], lm, tdev)
            state[name] = _unflatten(leaves, meta.get("spec"))
    for name, meta in manifest["entries"].items():
        if meta["kind"] == "optimizer":
            state[name] = _load_optimizer(meta, arrays, restored, tdev)
    return state


def _untuple(v):
    return tuple(v["tuple"]) if isinstance(v, dict) and "tuple" in v else v


def _load_optimizer(meta, arrays, restored, device):
    """The optimizer of an ``"optimizer"`` entry, rebuilt over the restored
    tensors its parameters were saved as, its state loaded."""
    cls = _allowed_class(meta["cls"], NAMEDTUPLE_ALLOWLIST, "optimizer")
    if cls is None or not issubclass(cls, torch.optim.Optimizer):
        raise TypeError(f"checkpoint optimizer class {meta['cls']} cannot be rebuilt")
    params = []
    for key in meta["params"]:
        if key not in restored:
            restored[key] = _tensor(arrays[key], {}, device)
        params.append(restored[key])
    groups = []
    for g in meta["param_groups"]:
        g = {k: _untuple(v) for k, v in g.items()}
        g["params"] = [params[i] for i in g["params"]]
        groups.append(g)
    opt = cls(groups, **{k: _untuple(v) for k, v in meta["defaults"].items()})
    state = {}
    for i, entry in meta["state"].items():
        st = {}
        for k, v in entry.items():
            if "array" in v:
                st[k] = _tensor(arrays[v["array"]], v, device).reshape(v["shape"])
            else:
                st[k] = v["value"]
        state[int(i)] = st
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)
    return opt


def checkpoint_estimator(path: str, estimator, step: Optional[int] = None) -> None:
    """Checkpoint an estimator's settings and learned state (heat_tpu
    ``:249``): its DNDarray and scalar attributes."""
    state: Dict[str, Any] = {}
    for key, value in vars(estimator).items():
        clean = key.split("__")[-1] if "__" in key else key
        if isinstance(value, DNDarray):
            state[f"attr:{clean}"] = value
        elif isinstance(value, (int, float, str, bool)) or value is None:
            state[f"attr:{clean}"] = value
    state["__class__"] = type(estimator).__name__
    save_checkpoint(path, state, step=step)


def restore_estimator(path: str, estimator):
    """Restore the attributes :func:`checkpoint_estimator` saved, in place
    (heat_tpu ``:262``)."""
    state = load_checkpoint(path)
    cls = state.pop("__class__", None)
    if cls is not None and cls != type(estimator).__name__:
        raise TypeError(f"checkpoint holds a {cls}, not a {type(estimator).__name__}")
    state.pop("__step__", None)
    for key, value in state.items():
        if key.startswith("attr:"):
            name = key[len("attr:"):]
            for attr in vars(estimator):
                if attr == name or attr.endswith("__" + name):
                    setattr(estimator, attr, value)
                    break
            else:
                setattr(estimator, name, value)
    return estimator


class CheckpointManager:
    """Rotating training-loop checkpoints with resume discovery (heat_tpu
    ``:282``): ``save`` writes every ``every_steps`` steps (or when forced)
    and keeps the newest ``keep``; ``restore`` returns the newest complete
    checkpoint, quarantining corrupt ones.

    >>> mgr = CheckpointManager("run", every_steps=100, keep=3)
    >>> start, state = mgr.restore() or (0, init_state())
    >>> for step in range(start, total):
    ...     state = train_step(state)
    ...     mgr.save(step + 1, state)
    """

    def __init__(self, directory: str, every_steps: int = 1, keep: int = 3):
        if every_steps < 1 or keep < 1:
            raise ValueError("every_steps and keep must be >= 1")
        self.directory = directory
        self.every_steps = every_steps
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:012d}")

    def all_steps(self):
        """Steps with a complete (manifest present) checkpoint, ascending."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and os.path.exists(
                    os.path.join(self.directory, name, _MANIFEST)):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any], force: bool = False) -> bool:
        """Checkpoint ``state`` at ``step`` if due (or ``force``) and rotate;
        True when a checkpoint was written."""
        if not force and step % self.every_steps != 0:
            return False
        save_checkpoint(self._path(step), state, step=step)
        if get_comm().rank != 0:
            return True
        for old in self.all_steps()[:-self.keep]:
            _rmtree(self._path(old))
        # directories without a manifest are partial writes of a crash;
        # quarantined (".corrupt") ones are kept for the post-mortem
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("ckpt_") and not name.endswith(".corrupt")
                    and ".corrupt." not in name and full != self._path(step)
                    and not os.path.exists(os.path.join(full, _MANIFEST))):
                _rmtree(full)
        return True

    def restore(self):
        """``(step, state)`` of the newest complete checkpoint, or None. A
        checkpoint that fails to load is read once more
        (``checkpoint.read_retries``); one that fails twice is corrupt:
        it is renamed ``.corrupt`` (kept on disk, no longer a candidate),
        ``checkpoint.corrupt_skipped`` ticks and the next older step is
        tried (heat_tpu ``:347``)."""
        import warnings

        from . import metrics as _metrics

        for step in reversed(self.all_steps()):
            state = err = None
            for attempt in (1, 2):
                try:
                    state = load_checkpoint(self._path(step))
                    break
                except Exception as exc:  # noqa: BLE001 — any unreadable checkpoint
                    err = exc
                    if attempt == 1:
                        _metrics.inc("checkpoint.read_retries")
            if state is None:
                _metrics.inc("checkpoint.corrupt_skipped")
                warnings.warn(f"skipping corrupt checkpoint step {step} at {self._path(step)} "
                              f"(quarantined as .corrupt): {err!r}")
                self._quarantine(step)
                continue
            state.pop("__step__", None)
            return step, state
        return None

    def _quarantine(self, step: int) -> None:
        """Rename a corrupt checkpoint out of the candidates (best effort:
        a read-only file system must not fail the recovery)."""
        if get_comm().rank != 0:
            return
        src = self._path(step)
        dst = src + ".corrupt"
        n = 1
        while os.path.exists(dst):
            dst = f"{src}.corrupt.{n}"
            n += 1
        try:
            os.rename(src, dst)
        except OSError:
            pass


def _rmtree(path: str) -> None:
    import shutil

    shutil.rmtree(path, ignore_errors=True)


def run_with_recovery(train_fn, manager: CheckpointManager, init_state, max_restarts: int = 3,
                      backoff_s: float = 0.05, max_failures: Optional[int] = None):
    """Run a restartable training loop (heat_tpu ``:410``).

    ``train_fn(state, start_step, save) -> state`` runs the loop body,
    calling ``save(step, state)`` as it goes (the manager's cadence
    applies); it may raise anywhere. On an exception the loop restarts from
    the newest checkpoint, or from a fresh copy of ``init_state`` where
    there is none, at most ``max_restarts`` times (the next failure
    raises), with exponential backoff from ``backoff_s`` (capped at 30 s).
    Each restart ticks ``checkpoint.recovery_restarts``.
    ``max_failures`` is heat_tpu's older name for ``max_restarts``."""
    import time

    from . import metrics as _metrics

    if max_failures is not None:
        max_restarts = max_failures
    restarts = 0
    while True:
        restored = manager.restore()
        start, state = restored if restored else (0, _fresh_state(init_state))
        try:
            return train_fn(state, start, manager.save)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            _metrics.inc("checkpoint.recovery_restarts")
            time.sleep(min(30.0, backoff_s * (2.0 ** (restarts - 1))))


def _fresh_state(tree):
    """A copy of a state tree whose containers are new and whose mutable
    leaves are copied (heat_tpu ``:453``): tensors cloned (training updates
    them in place), numpy arrays copied, DNDarrays re-wrapped over a clone,
    optimizers deep-copied together with the tensors of the tree they
    update, anything else deep-copied where it can be."""
    import copy
    import warnings

    memo: Dict[int, Any] = {}

    def leaf(x):
        if isinstance(x, (int, float, complex, bool, str, bytes, type(None))):
            return x
        if torch.is_tensor(x):
            if id(x) not in memo:
                memo[id(x)] = x.detach().clone()
            return memo[id(x)]
        if isinstance(x, np.ndarray):
            return x.copy()
        if isinstance(x, DNDarray):
            return DNDarray(x.larray.clone(), x.gshape, x.dtype, x.split, x.device, x.comm)
        try:
            return copy.deepcopy(x, memo)
        except Exception as exc:  # noqa: BLE001 — share what refuses to copy
            warnings.warn(f"run_with_recovery: state leaf of type {type(x).__name__} could "
                          f"not be copied ({exc!r}) and is SHARED across retry attempts — it "
                          "must not be mutated by train_fn")
            return x

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return leaf(node)

    if not isinstance(tree, dict):
        return walk(tree)
    # the tensors first, so that an optimizer's deepcopy (memo keyed by id)
    # holds the copies of the state's own tensors
    plain = {k: walk(v) for k, v in tree.items() if not isinstance(v, torch.optim.Optimizer)}
    return {k: plain[k] if k in plain else leaf(v) for k, v in tree.items()}
