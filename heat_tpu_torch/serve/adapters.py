"""Model adapters (heat_tpu ``serve/adapters.py``): the repo's models as
:class:`~heat_tpu_torch.serve.executor.ServingExecutor` callables.

An executor callable takes one ``(bucket_rows, *feat)`` tensor on its
device and returns rows-leading output, each row depending on its input row
alone, with the parameters captured by closure. Two families are wired:

* the transformer LM (:func:`transformer_logits_fn`,
  :func:`serve_transformer`): the model's whole forward
  (``TransformerLM.logits_fn``), one flash-forward launch a layer on the
  card; ``decode=True`` gives the continuous-batching
  :class:`~heat_tpu_torch.serve.decode.DecodeEngine` instead;
* the estimators (:func:`estimator_predict_fn`, :func:`serve_estimator`):
  nearest-centroid labels for the cluster family (``argmin(|c|² - 2
  x·cᵀ)``) and the k-neighbours vote (the k smallest of ``|t|² - 2
  x·tᵀ`` in heat_tpu's stable order, then ``_vote``), the fitted state
  replicated onto the device once when the adapter is built.

The ``serve_*`` helpers return ready executors whose bucket policy keeps
every padded batch divisible as the model needs.

At world size above 1 each rank's executor answers the requests submitted
on that rank (the estimators' state is replicated once, a counted
all-gather where it is split); sharding one request stream over the ranks
waits for the multi-rank serving work, so the transformer's executor needs
a grid of one rank.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core.communication import sanitize_comm
from .bucketing import Pow2Buckets
from .executor import ServeConfig, ServingExecutor

__all__ = ["transformer_logits_fn", "serve_transformer", "estimator_predict_fn",
           "serve_estimator"]


# ---------------------------------------------------------------------- #
# transformer LM                                                         #
# ---------------------------------------------------------------------- #
def transformer_logits_fn(model, params) -> Callable:
    """``(B, S) int32 tokens -> (B, S, vocab)`` float32 logits, a closure
    over a :class:`~heat_tpu_torch.nn.TransformerLM` and its parameters
    (heat_tpu ``adapters.py:47``): the model's forward (``logits_fn``), on
    the model's device (``fn.device``)."""
    fwd = model.logits_fn()

    def fn(toks):
        return fwd(params, toks)

    fn.device = model.device
    return fn


def serve_transformer(model, params, seq_len: int, config: Optional[ServeConfig] = None,
                      decode: bool = False, **kwargs):
    """An executor serving ``model``'s forward at ``seq_len`` (heat_tpu
    ``adapters.py:64``).

    Requests are ``(rows, seq_len)`` int32 token arrays, answers their
    ``(rows, seq_len, vocab)`` float32 logits. The default bucket policy is
    powers of two, each a multiple of ``dp × n_micro`` (every padded batch
    divides over the data-parallel axis and the microbatches); the program
    cache's token names the model's widths, ``seq_len``, the grid and the
    device. ``kwargs`` go to :class:`ServingExecutor`.

    ``decode=True`` returns the continuous-batching
    :class:`~heat_tpu_torch.serve.DecodeEngine` instead: ``seq_len`` is its
    ``max_seq_len``, ``kwargs`` go to
    :class:`~heat_tpu_torch.serve.DecodeConfig` (``slots``, ``temperature``,
    ``seed``, ...), and ``config`` must be None.
    """
    c = model.cfg
    if decode:
        from .decode import DecodeConfig, DecodeEngine

        if config is not None:
            raise ValueError("decode=True takes DecodeConfig kwargs, not a ServeConfig")
        return DecodeEngine(model, params, DecodeConfig(max_seq_len=seq_len, **kwargs),
                            name="transformer-decode")
    if math.prod(model.grid.shape) > 1:
        raise NotImplementedError(
            "serve_transformer(decode=False) serves a grid of one rank: sharding one "
            "request stream over ranks is the multi-rank serving work")
    if seq_len % max(1, model.sp):
        raise ValueError(f"seq_len ({seq_len}) must divide over sp ({model.sp})")
    if config is None:
        q = model.dp_world * max(1, c.n_micro)
        config = ServeConfig(bucket_rows=Pow2Buckets(min_rows=q, multiple_of=q))
    token = ("transformer", c.vocab, c.d_model, c.n_layers, seq_len,
             tuple(model.grid.sizes.items()), str(model.device))
    return ServingExecutor(transformer_logits_fn(model, params), config, name="transformer",
                           cache_token=token, **kwargs)


# ---------------------------------------------------------------------- #
# estimators                                                             #
# ---------------------------------------------------------------------- #
def _replicated(x) -> torch.Tensor:
    """The whole of a DNDarray on every rank (one counted all-gather where
    it is split)."""
    return x.resplit(None).larray


def _centroid_assign_fn(centroids: torch.Tensor) -> Callable:
    """Nearest-centroid labels (heat_tpu ``adapters.py:114``): ``argmin(|c|²
    - 2 x·cᵀ)`` with the products accumulated in float32; the label-blind
    ``|x|²`` is dropped."""
    c = centroids
    c2 = torch.sum(c.float() * c.float(), dim=1)[None, :]

    def fn(x):
        xc = torch.matmul(x, c.to(x.dtype).T).float()
        return torch.argmin(c2 - 2.0 * xc, dim=1)

    fn.device = c.device
    return fn


def _knn_vote_fn(train_x: torch.Tensor, train_y: torch.Tensor, k: int) -> Callable:
    """``KNeighborsClassifier.predict`` as heat_tpu's adapter computes it
    (``adapters.py:135``): the ``k`` smallest of ``|t|² - 2 x·tᵀ`` in its
    stable ``lax.top_k`` order, then the vote (the most frequent label,
    the smallest on a tie)."""
    from ..classification.kneighborsclassifier import _k_smallest, _vote

    yt = train_y.reshape(-1)
    t2 = torch.sum(train_x.float() * train_x.float(), dim=1)[None, :]

    def fn(x):
        xc = torch.matmul(x, train_x.to(x.dtype).T).float()
        return _vote(yt[_k_smallest(t2 - 2.0 * xc, k)])

    fn.device = train_x.device
    return fn


def estimator_predict_fn(estimator, comm=None) -> Callable:
    """``(rows, d) -> (rows,)`` labels, a closure over a fitted estimator
    (heat_tpu ``adapters.py:161``): the cluster family (anything with
    ``cluster_centers_``: KMeans, KMedians, KMedoids) and
    :class:`~heat_tpu_torch.classification.KNeighborsClassifier`. The
    fitted state is replicated onto its device once, here."""
    sanitize_comm(comm)
    if hasattr(estimator, "cluster_centers_"):
        centers = estimator.cluster_centers_
        if centers is None:
            raise ValueError("estimator is not fitted (no cluster centers)")
        return _centroid_assign_fn(_replicated(centers))
    if getattr(estimator, "x", None) is not None and hasattr(estimator, "n_neighbors"):
        return _knn_vote_fn(_replicated(estimator.x), _replicated(estimator.y),
                            int(estimator.n_neighbors))
    raise TypeError(f"no serving adapter for {type(estimator).__name__}: expected a fitted "
                    "cluster estimator (cluster_centers_) or KNeighborsClassifier")


def serve_estimator(estimator, comm=None, config: Optional[ServeConfig] = None,
                    **kwargs) -> ServingExecutor:
    """An executor serving ``estimator.predict`` row batches (heat_tpu
    ``adapters.py:186``): requests are ``(rows, n_features)`` arrays,
    answers their ``(rows,)`` labels. Each rank answers its own requests,
    so the buckets are plain powers of two."""
    comm = sanitize_comm(comm)
    fn = estimator_predict_fn(estimator, comm)
    if config is None:
        config = ServeConfig(bucket_rows=Pow2Buckets())
    return ServingExecutor(fn, config, name=type(estimator).__name__.lower(),
                           cache_token=("estimator", comm.size, comm.rank, str(fn.device)),
                           **kwargs)
