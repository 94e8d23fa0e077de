"""Bundled demo datasets (heat_tpu ``datasets``): synthetic stand-ins with
the shapes and file layout of the original Heat's ``heat/datasets/``
(``iris.csv``/``.h5``/``.nc``, ``iris_labels.csv``, ``diabetes.h5``); see
``_generate.py``."""

import os

__all__ = ["path"]


def path(name: str) -> str:
    """Absolute path of a bundled dataset file, e.g. ``path("iris.h5")``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
