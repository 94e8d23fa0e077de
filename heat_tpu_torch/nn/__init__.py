"""Neural network layer (heat_tpu ``nn/``): local attention on the flash
kernel and the transformer LM's serving path."""

from . import attention
from . import transformer
from .attention import local_attention
from .transformer import TransformerLM, TransformerLMConfig

__all__ = ["attention", "transformer", "local_attention", "TransformerLM",
           "TransformerLMConfig"]
