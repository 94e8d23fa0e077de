"""Model adapters (heat_tpu ``serve/adapters.py``): the transformer LM as a
decode engine."""

from __future__ import annotations

__all__ = ["serve_transformer"]


def serve_transformer(model, params, seq_len: int, config=None, decode: bool = False,
                      **kwargs):
    """Serve ``model`` with ``params`` (heat_tpu ``adapters.py:64``).

    ``decode=True`` returns the continuous-batching
    :class:`~heat_tpu_torch.serve.DecodeEngine`: per-request autoregressive
    generation over a slot-based KV cache on the model's device, with
    ``seq_len`` as the engine's ``max_seq_len``; ``kwargs`` go to
    :class:`~heat_tpu_torch.serve.DecodeConfig` (``slots``, ``queue_limit``,
    ...). ``config`` must be None on this path. The batching forward
    executor (``decode=False``) is not ported yet and raises.
    """
    if not decode:
        raise NotImplementedError(
            "serve_transformer(decode=False), the batching ServingExecutor, is a later "
            "slice of the port; pass decode=True for the decode engine")
    from .decode import DecodeConfig, DecodeEngine

    if config is not None:
        raise ValueError("decode=True takes DecodeConfig kwargs, not a ServeConfig")
    return DecodeEngine(model, params, DecodeConfig(max_seq_len=seq_len, **kwargs),
                        name="transformer-decode")
