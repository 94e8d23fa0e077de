"""Optimizers (heat_tpu ``optim/``): the torch.optim-style constructors with
optax's formulas and defaults, the data-parallel wrappers and DASO.

``tx = ht.optim.Adam(1e-3)``, ``opt_state = tx.init(params)``, then
``model.make_train_step(tx)``; or ``DataParallelOptimizer(tx)`` for
:class:`heat_tpu_torch.nn.DataParallel`.
"""

from .optimizers import SGD, Adadelta, Adagrad, Adam, AdamW, RMSprop, Transform
from .dp_optimizer import DASO, DataParallelOptimizer
from . import utils
from .utils import DetectMetricPlateau

__all__ = ["SGD", "Adam", "AdamW", "Adagrad", "Adadelta", "RMSprop", "Transform",
           "DataParallelOptimizer", "DASO", "DetectMetricPlateau", "utils"]
