"""Neural network layer (heat_tpu ``nn/``): local attention on the flash
kernels and the transformer LM's training and serving paths."""

from . import attention
from . import transformer
from .attention import local_attention
from .transformer import TransformerLM, TransformerLMConfig

__all__ = ["attention", "transformer", "local_attention", "TransformerLM",
           "TransformerLMConfig"]
