"""Graph algorithms (heat_tpu ``graph``)."""

from .laplacian import Laplacian

__all__ = ["Laplacian"]
