"""Linear algebra for distributed DNDarrays (heat_tpu ``core/linalg/``)."""

from .basics import *  # noqa: F401,F403
from .qr import *  # noqa: F401,F403
from .solver import *  # noqa: F401,F403
from .svd import *  # noqa: F401,F403
