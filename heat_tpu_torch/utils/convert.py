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

__all__ = ["dndarray_from_numpy", "gaussiannb_from_numpy_state", "kmeans_from_numpy_state",
           "transformer_params_from_numpy", "transformer_tree_to_numpy"]

_LAYER_KEYS = ("ln1", "wqkv", "wproj", "ln2", "w_up", "w_down")


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


def transformer_params_from_numpy(tree: Mapping, config, device=None,
                                  dtype=None) -> Dict[str, Any]:
    """The port's transformer parameters from heat_tpu's parameter tree, as
    numpy arrays: ``embed (V, D)``, ``final_ln (D,)``, ``unembed (D, V)``
    and ``stages`` with a leading ``(pp, Ls)`` on ``wqkv (D, 3, H, Dh)``,
    ``wproj (H, Dh, D)``, ``ln1``/``ln2 (D,)``, ``w_up (D, F)`` and
    ``w_down (F, D)``.

    Returns ``{"embed", "final_ln", "unembed", "layers": [one dict per
    layer with the stage keys]}``, every tensor on ``device`` (the card by
    default) in ``dtype``: ``config.compute_dtype`` by default, for serving,
    or ``torch.float32`` for training masters. Every tensor has a storage of
    its own (no layer is a view of a stacked array), so each can be a leaf
    of autograd and be updated in place by an optimizer. The layers run in
    stage order.
    """
    if isinstance(device, torch.device):
        dev = device
    else:
        dev = sanitize_device(device).torch_device
    c = config
    dtype = c.compute_dtype if dtype is None else dtype
    H, Dh, D, Fd, V = c.n_heads, c.head_dim, c.d_model, c.d_ff, c.vocab
    if "router" in tree["stages"]:
        raise NotImplementedError("the port runs the dense MLP only; MoE weights are a "
                                  "later slice")
    want = {"embed": (V, D), "final_ln": (D,), "unembed": (D, V)}
    layer_shapes = {"ln1": (D,), "wqkv": (D, 3, H, Dh), "wproj": (H, Dh, D), "ln2": (D,),
                    "w_up": (D, Fd), "w_down": (Fd, D)}

    def check(a, shape, name):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(a.shape)}")
        return a

    def put(a):
        a = np.require(a, requirements=["C", "W"])  # copies only read-only or strided input
        return torch.from_numpy(a).to(device=dev, dtype=dtype, copy=True)

    out = {name: put(check(tree[name], shape, name)) for name, shape in want.items()}
    stacked = {}
    for name in _LAYER_KEYS:
        a = np.asarray(tree["stages"][name])
        if a.ndim != len(layer_shapes[name]) + 2:
            raise ValueError(f"stages/{name}: expected a leading (pp, Ls) on "
                             f"{layer_shapes[name]}, got {tuple(a.shape)}")
        n_layers = a.shape[0] * a.shape[1]
        if n_layers != c.n_layers:
            raise ValueError(f"stages/{name} holds {n_layers} layers, the config "
                             f"{c.n_layers}")
        stacked[name] = check(a.reshape((n_layers,) + a.shape[2:]),
                              (n_layers,) + layer_shapes[name], f"stages/{name}")
    out["layers"] = [{name: put(stacked[name][l]) for name in _LAYER_KEYS}
                     for l in range(c.n_layers)]
    return out


def transformer_tree_to_numpy(params: Mapping) -> Dict[str, Any]:
    """heat_tpu's parameter tree from the port's parameters (or gradients,
    which share their layout): ``embed``, ``final_ln``, ``unembed`` and
    ``stages``, each stage key stacked over the layers with a leading
    ``(pp, Ls) = (1, n_layers)``, as numpy arrays on the host (float32 for
    bfloat16 and float16 tensors, whose dtypes numpy lacks)."""

    def host(t):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()

    layers = params["layers"]
    stages = {name: np.stack([host(p[name]) for p in layers])[None] for name in _LAYER_KEYS}
    out = {name: host(params[name]) for name in ("embed", "final_ln", "unembed")}
    out["stages"] = stages
    return out
