"""State carried across from numpy: array contents, fitted estimators and
model weights.

Heat's "weights" are array contents, fitted estimator state and the
transformer's parameters. Another framework (heat_tpu, numpy, sklearn) hands
them over as numpy arrays, e.g. ``np.asarray(km.cluster_centers_.numpy())``
or ``jax.tree.map(np.asarray, params)``; nothing of that framework is
imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..cluster.kmeans import KMeans
from ..core import factories
from ..core.devices import sanitize_device
from ..core.dndarray import DNDarray
from ..naive_bayes.gaussianNB import GaussianNB

__all__ = ["dense_stack_state_from_numpy", "dndarray_from_numpy",
           "gaussiannb_from_numpy_state", "kmeans_from_numpy_state",
           "transformer_params_from_numpy", "transformer_tree_to_numpy"]


def dndarray_from_numpy(arr: np.ndarray, split: Optional[int] = None, dtype=None,
                        device=None, comm=None) -> DNDarray:
    """A DNDarray holding ``arr``'s values, split along ``split``."""
    return factories.array(np.asarray(arr), dtype=dtype, split=split, device=device,
                           comm=comm)


def kmeans_from_numpy_state(state: Mapping, device=None, comm=None) -> KMeans:
    """A fitted :class:`KMeans` from ``{"cluster_centers_": (k, d) array,
    "n_clusters": k, ...}``; optional keys ``inertia_``, ``n_iter_``,
    ``max_iter``, ``tol`` and ``random_state`` are carried over too."""
    centers = np.asarray(state["cluster_centers_"])
    k = int(state.get("n_clusters", centers.shape[0]))
    if centers.ndim != 2 or centers.shape[0] != k:
        raise ValueError(f"cluster_centers_ must have shape ({k}, d), got {centers.shape}")
    params = {key: state[key] for key in ("max_iter", "tol", "random_state") if key in state}
    km = KMeans(n_clusters=k, **params)
    km._cluster_centers = dndarray_from_numpy(centers, None, device=device, comm=comm)
    km._inertia = state.get("inertia_")
    km._n_iter = state.get("n_iter_")
    return km


def gaussiannb_from_numpy_state(state: Mapping, device=None, comm=None) -> GaussianNB:
    """A fitted :class:`GaussianNB` from ``{"classes_": (k,), "theta_": (k, d),
    "var_": (k, d), "class_count_": (k,), "class_prior_": (k,), "epsilon_":
    float}`` (a fitted heat_tpu estimator's attributes as numpy arrays);
    optional keys ``priors`` and ``var_smoothing`` are carried over too. The
    moments stay float64, as heat_tpu keeps them."""
    classes = np.asarray(state["classes_"])
    k = classes.shape[0]
    theta = np.asarray(state["theta_"], dtype=np.float64)
    var = np.asarray(state["var_"], dtype=np.float64)
    if theta.ndim != 2 or theta.shape[0] != k or var.shape != theta.shape:
        raise ValueError(f"theta_ and var_ must have shape ({k}, d), got {theta.shape} "
                         f"and {var.shape}")
    params = {key: state[key] for key in ("priors", "var_smoothing") if key in state}
    nb = GaussianNB(**params)
    nb.classes_ = dndarray_from_numpy(classes, None, device=device, comm=comm)
    nb.theta_ = dndarray_from_numpy(theta, None, device=device, comm=comm)
    nb.var_ = dndarray_from_numpy(var, None, device=device, comm=comm)
    for key in ("class_count_", "class_prior_"):
        a = np.asarray(state[key], dtype=np.float64)
        if a.shape != (k,):
            raise ValueError(f"{key} must have shape ({k},), got {a.shape}")
        setattr(nb, key, dndarray_from_numpy(a, None, device=device, comm=comm))
    nb.epsilon_ = float(state["epsilon_"])
    return nb


def _layer_shapes(c) -> Dict[str, tuple]:
    """One layer's leaves in heat_tpu's tree, unsharded."""
    H, Dh, D, Fd = c.n_heads, c.head_dim, c.d_model, c.d_ff
    shapes = {"ln1": (D,), "wqkv": (D, 3, H, Dh), "wproj": (H, Dh, D), "ln2": (D,)}
    if c.moe_experts:
        E = c.moe_experts
        shapes.update({"router": (D, E), "w_up": (E, D, Fd), "w_down": (E, Fd, D)})
    else:
        shapes.update({"w_up": (D, Fd), "w_down": (Fd, D)})
    return shapes


def _layer_specs(model, c) -> Dict[str, tuple]:
    """The grid axis of each dimension of one layer's leaves (the stage
    specs without their ``(pp, Ls)``); all None without a model."""
    if model is None:
        return {name: (None,) * len(shape) for name, shape in _layer_shapes(c).items()}
    return {name: spec[2:] for name, spec in model.param_specs()["stages"].items()}


def transformer_params_from_numpy(tree: Mapping, config, device=None, dtype=None,
                                  model=None) -> Dict[str, Any]:
    """This rank's transformer parameters from heat_tpu's parameter tree, as
    numpy arrays: ``embed (V, D)``, ``final_ln (D,)``, ``unembed (D, V)``
    and ``stages`` with a leading ``(pp, Ls)`` on ``wqkv (D, 3, H, Dh)``,
    ``wproj (H, Dh, D)``, ``ln1``/``ln2 (D,)``, and ``w_up (D, F)`` and
    ``w_down (F, D)``, or with ``moe_experts`` ``router (D, E)``, ``w_up
    (E, D, F)`` and ``w_down (E, F, D)``. Any ``(pp, Ls)`` stacking of the
    ``n_layers`` layers is taken.

    With ``model`` (a :class:`~heat_tpu_torch.nn.TransformerLM`) each leaf
    is cut to this rank's shard by ``model.param_specs()``: the layers of
    its pp stage, its heads and MLP features over tp, its experts over dp.
    Without, the whole tree (a grid of one).

    Returns ``{"embed", "final_ln", "unembed", "layers": [one dict per layer
    of the stage]}``, every tensor on ``device`` (the card by default) in
    ``dtype``: ``config.compute_dtype`` by default, for serving, or
    ``torch.float32`` for training masters. Every tensor has a storage of
    its own, so each can be a leaf of autograd and be updated in place by
    an optimizer.
    """
    if isinstance(device, torch.device):
        dev = device
    else:
        dev = sanitize_device(device).torch_device
    c = config
    dtype = c.compute_dtype if dtype is None else dtype
    D, V = c.d_model, c.vocab
    if ("router" in tree["stages"]) != bool(c.moe_experts):
        raise ValueError(f"the tree's stages {sorted(tree['stages'])} do not match "
                         f"moe_experts={c.moe_experts}")
    want = {"embed": (V, D), "final_ln": (D,), "unembed": (D, V)}
    layer_shapes = _layer_shapes(c)
    specs = _layer_specs(model, c)
    sizes = model.grid.sizes if model is not None else {}
    pp = sizes.get("pp", 1)

    def check(a, shape, name):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(a.shape)}")
        return a

    def put(a):
        a = np.require(a, requirements=["C", "W"])  # copies only read-only or strided input
        return torch.from_numpy(a).to(device=dev, dtype=dtype, copy=True)

    def shard(a, spec):
        for d, axis in enumerate(spec):
            if axis is not None and sizes[axis] > 1:
                n = a.shape[d + 1] // sizes[axis]
                i = model.grid.coord(axis)
                a = a[(slice(None),) * (d + 1) + (slice(i * n, (i + 1) * n),)]
        return a

    out = {name: put(check(tree[name], shape, name)) for name, shape in want.items()}
    Ls = c.n_layers // pp
    stage = model.grid.coord("pp") if model is not None else 0
    stacked = {}
    for name, shape in layer_shapes.items():
        a = np.asarray(tree["stages"][name])
        if a.ndim != len(shape) + 2:
            raise ValueError(f"stages/{name}: expected a leading (pp, Ls) on {shape}, got "
                             f"{tuple(a.shape)}")
        n_layers = a.shape[0] * a.shape[1]
        if n_layers != c.n_layers:
            raise ValueError(f"stages/{name} holds {n_layers} layers, the config "
                             f"{c.n_layers}")
        a = check(a.reshape((n_layers,) + a.shape[2:]), (n_layers,) + shape, f"stages/{name}")
        stacked[name] = shard(a[stage * Ls:(stage + 1) * Ls], specs[name])
    out["layers"] = [{name: put(stacked[name][l]) for name in layer_shapes}
                     for l in range(Ls)]
    return out


def transformer_tree_to_numpy(params: Mapping, model=None) -> Dict[str, Any]:
    """heat_tpu's parameter tree from the port's parameters (or gradients,
    which share their layout): ``embed``, ``final_ln``, ``unembed`` and
    ``stages``, each stage key stacked over the layers with a leading
    ``(pp, Ls)``, as numpy arrays on the host (float32 for bfloat16 and
    float16 tensors, whose dtypes numpy lacks). With ``model`` the shards
    are gathered over the grid first (all-gathers over tp, dp and pp,
    collective: every rank calls it) and every rank gets the whole tree;
    without, ``(pp, Ls) = (1, n_layers)``."""

    def host(t):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()

    layers = params["layers"]
    grid = model.grid if model is not None else None
    stages = {}
    for name in layers[0]:
        a = torch.stack([p[name].detach() for p in layers])
        if grid is not None:
            for d, axis in enumerate(_layer_specs(model, model.cfg)[name]):
                if axis is not None:
                    a = grid.axis(axis).Allgather(a, axis=d + 1)
            a = grid.axis("pp").Allgather(a, axis=0)
            a = a.reshape((model.pp, model.layers_per_stage) + tuple(a.shape[1:]))
        else:
            a = a[None]
        stages[name] = host(a)
    out = {name: host(params[name]) for name in ("embed", "final_ln", "unembed")}
    out["stages"] = stages
    return out


def dense_stack_state_from_numpy(tree: Mapping, module: torch.nn.Module) -> Dict[str, Any]:
    """A ``state_dict`` for ``module``'s ``torch.nn.Linear`` layers from a
    flax ``Dense`` stack's parameters as numpy arrays (``{"params":
    {"Dense_0": {"kernel": (in, out), "bias": (out,)}, ...}}``, or the inner
    dictionary): ``Dense_i`` goes to the module's ``i``-th ``Linear`` in
    registration order, its kernel transposed to torch's ``(out, in)``.
    Load it with ``module.load_state_dict``."""
    layers = tree.get("params", tree)
    names = sorted((k for k in layers if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    linears = [(n, m) for n, m in module.named_modules() if isinstance(m, torch.nn.Linear)]
    if len(names) != len(linears):
        raise ValueError(f"{len(names)} Dense layers for {len(linears)} Linear layers")
    state = {}
    for key, (prefix, lin) in zip(names, linears):
        kernel = np.asarray(layers[key]["kernel"])
        if kernel.shape != (lin.in_features, lin.out_features):
            raise ValueError(f"{key}: kernel {kernel.shape} for Linear({lin.in_features}, "
                             f"{lin.out_features})")
        state[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T)).to(
            lin.weight.dtype)
        if lin.bias is not None:
            state[f"{prefix}.bias"] = torch.from_numpy(
                np.array(layers[key]["bias"])).to(lin.bias.dtype)
    return state
