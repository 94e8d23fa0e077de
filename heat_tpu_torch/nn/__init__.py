"""Neural network layer (heat_tpu ``nn/``).

heat_tpu's names: ``DataParallel`` and ``DataParallelMultiGPU``, the
functional ops (``F``), the attention entry points, the tensor-, pipeline-
and expert-parallel layers and the flagship ``TransformerLM``. Any other
name passes through to ``torch.nn`` (heat_tpu passes ``flax.linen``
through, with torch-style aliases; here its flax names ``Dense`` and
``Embed`` are aliases of ``Linear`` and ``Embedding``).
"""

import torch.nn as _nn

from .data_parallel import DataParallel, DataParallelMultiGPU
from . import functional
from . import functional as F
from . import attention
from .attention import local_attention, ring_attention, ulysses_attention
from . import parallel
from . import transformer
from .transformer import TransformerLM, TransformerLMConfig
from .parallel import (column_parallel_dense, pipeline_apply, row_parallel_dense, switch_moe,
                       tp_mlp)

__all__ = [
    "DataParallel",
    "DataParallelMultiGPU",
    "functional",
    "F",
    "attention",
    "local_attention",
    "ring_attention",
    "ulysses_attention",
    "parallel",
    "transformer",
    "TransformerLM",
    "TransformerLMConfig",
    "column_parallel_dense",
    "row_parallel_dense",
    "tp_mlp",
    "switch_moe",
    "pipeline_apply",
]

_ALIASES = {"Dense": "Linear", "Embed": "Embedding"}


def __getattr__(name):
    try:
        return getattr(_nn, _ALIASES.get(name, name))
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn' has no attribute {name!r}") from None
