"""Optimizers for the training entry points (heat_tpu ``optim/``).

:func:`SGD` and :func:`Adam` are the counterparts of heat_tpu's
constructors (``optim/dp_optimizer.py:31-55``), which return optax
transforms: ``tx = ht.optim.Adam(1e-3)``, ``opt_state = tx.init(params)``,
then ``model.make_train_step(tx)``. ``DataParallelOptimizer``, ``DASO`` and
the other constructors come with later slices (ROADMAP).
"""

from .optimizers import SGD, Adam, Transform

__all__ = ["SGD", "Adam", "Transform"]
