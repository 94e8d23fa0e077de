"""Serving (heat_tpu ``serve/``): the continuous-batching
:class:`DecodeEngine` for the transformer LM, its adapter
:func:`serve_transformer` and the typed serving errors.

>>> import heat_tpu_torch as ht
>>> grid = ht.MeshGrid((1, 1, 1, 1), ("dp", "pp", "tp", "sp"))
>>> model = ht.nn.TransformerLM(grid, ht.nn.TransformerLMConfig(...))
>>> eng = ht.serve.serve_transformer(model, model.init(0), 2048, decode=True, slots=8)
>>> eng.warmup()
>>> tokens = eng.submit(prompt, max_new_tokens=16).result()
"""

from . import decode
from . import errors
from .adapters import serve_transformer
from .decode import DECODE_STATS_KEYS, DecodeConfig, DecodeEngine
from .errors import ServeClosed, ServeDeadlineExceeded, ServeError, ServeOverloaded

__all__ = ["DecodeEngine", "DecodeConfig", "DECODE_STATS_KEYS", "serve_transformer",
           "ServeError", "ServeOverloaded", "ServeDeadlineExceeded", "ServeClosed"]
