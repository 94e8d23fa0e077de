"""Core: the DNDarray, its types, devices, communication, factories and
the operations over it, re-exported flat as heat_tpu's core namespace is
(``ht.mean``, ``ht.where``, ``ht.concatenate``, ...), with the engine
switches (``ht.fusion``, ``ht.fusion_enabled``, ``ht.set_fusion``,
``ht.pallas_enabled``, ``ht.set_pallas``; heat_tpu ``core/__init__.py:56-59``)."""

from .constants import *  # noqa: F401,F403
from .types import *  # noqa: F401,F403
from .devices import Device, cpu, get_device, gpu, sanitize_device, use_device
from .communication import (Communication, MeshAxisComm, MeshGrid, Request, TorchCommunication,
                            distributed_init, get_comm, sanitize_comm, use_comm)
from .base import *  # noqa: F401,F403
from .stride_tricks import *  # noqa: F401,F403
from .dndarray import DNDarray
from .factories import *  # noqa: F401,F403
from .memory import *  # noqa: F401,F403
from .sanitation import *  # noqa: F401,F403
from .arithmetics import *  # noqa: F401,F403
from .relational import *  # noqa: F401,F403
from .logical import *  # noqa: F401,F403
from .rounding import *  # noqa: F401,F403
from .exponential import *  # noqa: F401,F403
from .trigonometrics import *  # noqa: F401,F403
from .complex_math import *  # noqa: F401,F403
from .statistics import *  # noqa: F401,F403
from .indexing import *  # noqa: F401,F403
from .manipulations import *  # noqa: F401,F403
from .printing import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .tiling import *  # noqa: F401,F403
from . import (arithmetics, base, complex_math, exponential, factories, indexing, io, linalg, logical,
               manipulations, memory, printing, random, relational, resharding, rounding,
               sanitation, statistics, tiling, trigonometrics)
from .kernels import pallas_enabled, set_pallas
from . import fusion
from .fusion import enabled as fusion_enabled, set_enabled as set_fusion
from .version import __version__
