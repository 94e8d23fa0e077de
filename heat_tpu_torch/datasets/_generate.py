"""Regenerates the bundled demo datasets (synthetic, deterministic; heat_tpu
``datasets/_generate.py``, the same seed and so the same files).

The reference ships small real datasets (``heat/datasets/``: iris.csv/h5,
diabetes.h5) for its examples and io/cluster/regression tests. We bundle
*synthetic* stand-ins with the same shapes and file layout — three labeled
Gaussian clusters in 4-D for ``iris`` (150x4, 3 classes of 50) and a sparse
linear-model regression set for ``diabetes`` (442x10 with targets) — so no
data files are copied from the reference.

Run ``python -m heat_tpu_torch.datasets._generate`` to rebuild the files in place.
"""

import os

import numpy as np


def make_iris(rng: np.random.Generator) -> tuple:
    centers = np.array(
        [[5.0, 3.4, 1.5, 0.25], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]], np.float32
    )
    scales = np.array(
        [[0.35, 0.38, 0.17, 0.10], [0.52, 0.31, 0.47, 0.20], [0.64, 0.32, 0.55, 0.27]], np.float32
    )
    xs, ys = [], []
    for c in range(3):
        xs.append(rng.normal(centers[c], scales[c], size=(50, 4)).astype(np.float32))
        ys.append(np.full(50, c, np.int64))
    return np.concatenate(xs), np.concatenate(ys)


def make_diabetes(rng: np.random.Generator) -> tuple:
    n, d = 442, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.sqrt((x**2).mean(0, keepdims=True))
    beta = np.array([0.0, -11.4, 25.7, 16.8, -44.6, 24.7, 7.8, 8.6, 35.1, 0.0], np.float32)
    y = x @ beta + rng.normal(scale=4.0, size=n).astype(np.float32) + 152.0
    return x, y.astype(np.float32)[:, None]


def main() -> None:
    import h5py

    here = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(20260729)

    x, y = make_iris(rng)
    with h5py.File(os.path.join(here, "iris.h5"), "w") as f:
        f.create_dataset("data", data=x)
    np.savetxt(os.path.join(here, "iris.csv"), x, delimiter=";", fmt="%.4f")
    np.savetxt(os.path.join(here, "iris_labels.csv"), y[:, None], delimiter=";", fmt="%d")
    # NetCDF copy (reference ships iris.nc) — written directly as classic
    # NetCDF-3 so every backend (netCDF4 or the scipy fallback) reads it
    from scipy.io import netcdf_file

    with netcdf_file(os.path.join(here, "iris.nc"), "w") as f:
        f.createDimension("dim_0", x.shape[0])
        f.createDimension("dim_1", x.shape[1])
        var = f.createVariable("data", x.dtype, ("dim_0", "dim_1"))
        var[:] = x

    xd, yd = make_diabetes(rng)
    with h5py.File(os.path.join(here, "diabetes.h5"), "w") as f:
        f.create_dataset("x", data=xd)
        f.create_dataset("y", data=yd)


if __name__ == "__main__":
    main()
