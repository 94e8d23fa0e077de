"""Core: the DNDarray, its types, devices, communication and factories."""

from .constants import *  # noqa: F401,F403
from .types import *  # noqa: F401,F403
from .devices import Device, cpu, get_device, gpu, sanitize_device, use_device
from .communication import (MeshGrid, TorchCommunication, get_comm, sanitize_comm,
                            use_comm)
from .dndarray import DNDarray
from .factories import arange, array, empty, ones, zeros
from . import random
from .version import __version__
