"""The port's file I/O, out-of-core streams, halos, tilings and bundled
datasets against heat_tpu, on the same seeded numpy data: a 13 x 5 float32
array (uneven over two ranks: 7 and 6 rows) and its int32 twin.

heat_tpu writes its files first (at one and at two devices); then one table
of cases runs twice: in process at world size 1 against heat_tpu on one
device, and in ONE spawned 2-rank gloo world shared by the module against
heat_tpu on two devices. The port reads heat_tpu's files, writes its own,
and heat_tpu reads those back. Every world-2 case pins its collectives: a
load makes none, a save one ``barrier`` a rank (each rank's write turn), a
column-split CSV save one ``all_to_all`` more, a halo two ``permute``
rounds, a tile read one ``broadcast`` from each rank that holds its rows.

Tolerance: none. Every value read or written is compared bitwise (NaN where
NaN), every file the port writes holds the values of heat_tpu's file of the
same array, and the CSV text round-trips float32 exactly (``%.18e``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu_torch as ht  # noqa: E402
from torch_world import finish_world, pack, start_world, stop_world  # noqa: E402


@functools.lru_cache(maxsize=None)
def _hj():
    """heat_tpu and its communicators of one and two devices, imported at
    first use (the card-only test runs where there is no jax)."""
    import jax

    import heat_tpu as hj
    from heat_tpu.core.communication import TPUCommunication

    return hj, TPUCommunication(jax.devices()[:1]), TPUCommunication(jax.devices()[:2])


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _data():
    rng = np.random.default_rng(14)
    a = rng.standard_normal((13, 5)).astype(np.float32)
    return {"A": a, "B": rng.integers(-50, 50, (13, 5)).astype(np.int32)}


def _write_inputs(d):
    """The files both packages read: heat_tpu's saves at one and at two
    devices, a NetCDF file with masked cells, CSV files of one row, one
    column and one cell, a UTF-16 CSV and a directory of ``.npy`` files."""
    from scipy.io import netcdf_file

    hj, c1, c2 = _hj()
    data = _data()
    a, b = data["A"], data["B"]
    for tag, comm in (("c1", c1), ("c2", c2)):
        x = hj.array(a, split=0, comm=comm)
        hj.save_hdf5(x, f"{d}/hj_{tag}.h5", "data")
        hj.save_netcdf(x, f"{d}/hj_{tag}.nc", "data")
        hj.save_csv(x, f"{d}/hj_{tag}.csv")
        hj.save_netcdf(hj.array(b, split=0, comm=comm), f"{d}/hj_{tag}_int.nc", "data")
    grid = np.arange(12).reshape(4, 3)
    with netcdf_file(f"{d}/masked.nc", "w") as f:
        f.createDimension("dim_0", 4)
        f.createDimension("dim_1", 3)
        v = f.createVariable("f", np.float32, ("dim_0", "dim_1"))
        v._FillValue = np.float32(-999.0)
        v[:] = np.where(grid % 5 == 0, -999.0, grid).astype(np.float32)
        v = f.createVariable("i", np.int32, ("dim_0", "dim_1"))
        v.missing_value = np.int32(-7)
        v[:] = np.where(grid % 4 == 0, -7, grid).astype(np.int32)
    with open(f"{d}/row.csv", "w") as f:
        f.write("# header\n1.5,2.5,3.5,4.5\n")
    with open(f"{d}/col.csv", "w") as f:
        f.write("1.5\n2.5\nx\n4.5\n5.5\n")
    with open(f"{d}/cell.csv", "w") as f:
        f.write("7.25\n")
    with open(f"{d}/wide16.csv", "w", encoding="utf-16") as f:
        f.write("".join(",".join(f"{v:.9g}" for v in r) + "\n" for r in a))
    import os

    os.makedirs(f"{d}/npy", exist_ok=True)
    np.save(f"{d}/npy/b.npy", a[7:])
    np.save(f"{d}/npy/a.npy", a[:7])


def _build_env(lib, spec, **kw):
    """``lib`` is ``ht`` (the port) or ``hj``; ``kw`` the heat_tpu mesh. File
    names ending in ``{tag}`` read heat_tpu's file of this world size."""
    d = spec["dir"]
    port = lib.__name__ == "heat_tpu_torch"
    comm = lib.get_comm() if port else kw["comm"]
    p = comm.size
    tag = f"c{p}"

    def arr(name, split=None):
        return lib.array(spec[name], split=split, **kw)

    def every_rank(t):
        """A per-rank value of the port on every rank, by a collective that
        is not counted (the world's result is rank 0's)."""
        import torch.distributed as dist

        if not dist.is_initialized():
            return [t]
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, t)
        return out

    def load(fn, name, *a, **k):
        return getattr(lib, fn)(f"{d}/{name.format(tag=tag)}", *a, **k, **kw)

    def csv_routed(name, **k):
        before = dict(lib.io.csv_routes) if port else None
        x = load("load_csv", name, **k)
        route = None if not port else [r for r in before if lib.io.csv_routes[r] > before[r]]
        return x, route

    def stream(rows, dtype=None):
        s = load("load_hdf5", "hj_{tag}.h5", "data", stream=True,
                 **({} if dtype is None else {"dtype": getattr(lib, dtype)}))
        chunks = list(s.iter_chunks(rows)) + list(s.iter_chunks(rows))
        return chunks, s.shape, s.chunks_read, s.bytes_read, s.peak_chunk_bytes

    def saved(fmt, split, name="A", **k):
        """Save an array, then read the file back with h5py, scipy or numpy
        (bitwise the file's values)."""
        path = f"{d}/{'pt' if port else 'hj'}_p{p}_s{split}_{name}{'_kw' if k else ''}.{fmt}"
        x = arr(name, split)
        if fmt == "h5":
            x.save_hdf5(path, "data", **k)
        elif fmt == "nc":
            x.save_netcdf(path, "data", **k)
        else:
            lib.save(x, path, **k)
        return path

    def read_file(path):
        if path.endswith(".h5"):
            import h5py

            with h5py.File(path, "r") as f:
                return f["data"][...]
        if path.endswith(".nc"):
            from scipy.io import netcdf_file

            with netcdf_file(path, "r", mmap=False) as f:
                return f.variables["data"][...].copy(), dict(f.dimensions)
        with open(path) as f:
            return f.read()

    def halos(split, h):
        """Each rank's ``[from_prev; shard; from_next]`` and its two edges;
        heat_tpu's padded blocks with the padding taken out."""
        x = arr("A", split)
        if port:
            x.get_halo(h)
            return (every_rank(x.array_with_halos(h)), every_rank(x.halo_prev),
                    every_rank(x.halo_next))
        if p == 1:
            return [np.asarray(x.array_with_halos(h))], [None], [None]
        k = split
        c = -(-x.shape[k] // p)
        n = x.shape[k]
        w = np.asarray(x.array_with_halos(h))
        blocks, prevs, nexts = [], [], []
        x.get_halo(h)
        hp, hn = np.asarray(x.halo_prev), np.asarray(x.halo_next)
        for r in range(p):
            lc = max(0, min(n, (r + 1) * c) - r * c)
            b = np.take(w, range(r * (c + 2 * h), (r + 1) * (c + 2 * h)), axis=k)
            body = np.take(b, range(h, h + lc), axis=k)
            blocks.append(np.concatenate(
                [np.take(b, range(h), axis=k), body,
                 np.take(b, range(h + c, c + 2 * h), axis=k)], axis=k))
            prevs.append(np.take(hp, range(r * h, (r + 1) * h), axis=k))
            nexts.append(np.take(hn, range(r * h, (r + 1) * h), axis=k))
        return blocks, prevs, nexts

    def refused(fn, *a):
        """The name of the error ``fn(*a)`` raises, on every rank."""
        try:
            fn(*a)
        except Exception as err:
            return type(err).__name__
        return None

    def split_tiles(split):
        x = arr("A", split)
        t = lib.SplitTiles(x)
        meta = (t.tile_ends_g, t.tile_dimensions, t.tile_locations, t.lshape_map,
                t.get_tile_size((p - 1, slice(0, 2))))
        got = [np.asarray(t[i, j]) for i in range(p) for j in range(p)]
        t[p - 1, 0] = 9.5
        return meta, got, x

    def square_tiles(shape, split, tpp):
        x = lib.array(np.arange(np.prod(shape), dtype=np.float32).reshape(shape),
                      split=split, **kw)
        t = lib.SquareDiagTiles(x, tiles_per_proc=tpp)
        meta = (t.row_indices, t.col_indices, t.tile_map, t.lshape_map,
                t.last_diagonal_process, t.tile_rows_per_process, t.tile_columns_per_process,
                t.get_start_stop((0, 0)))
        return meta, np.asarray(t[0, 0]), np.asarray(t.local_get((0, 0)))

    def dataset(name, *a, **k):
        if port:
            where = lib.datasets.path(name)
        else:
            import heat_tpu.datasets

            where = heat_tpu.datasets.path(name)
        return lib.load(where, *a, **k, **kw)

    return {"lib": lib, "arr": arr, "load": load, "csv_routed": csv_routed, "stream": stream,
            "saved": saved, "read_file": read_file, "halos": halos, "split_tiles": split_tiles,
            "refused": refused, "square_tiles": square_tiles, "dataset": dataset, "d": d}


B1 = {"barrier": 2}
# a diagonal tile read, then local_get: each rank's tile read in turn, each
# tile held by one rank; with one tile a process the diagonal tile's rows
# (0..8 of the virtual layout) lie on both ranks (7 and 6 rows): 2 + 2 + 1
SQ = {"broadcast": 3}
SQ1 = {"broadcast": 5}
# name -> (expression, collectives at world size 2, kind of comparison)
CASES = {
    **{f"h5_split{s}": (f"load('load_hdf5', 'hj_{{tag}}.h5', 'data', split={s})", {}, "exact")
       for s in (None, 0, 1)},
    "h5_fraction": ("load('load_hdf5', 'hj_{tag}.h5', 'data', load_fraction=0.5, split=0)", {},
                    "exact"),
    "h5_float64": ("load('load_hdf5', 'hj_{tag}.h5', 'data', dtype=lib.float64, split=1)", {},
                   "exact"),
    "h5_bf16": ("load('load_hdf5', 'hj_{tag}.h5', 'data', dtype=lib.bfloat16, split=0)", {},
                "exact"),
    "h5_via_load": ("load('load', 'hj_{tag}.h5', 'data', split=0)", {}, "exact"),
    **{f"nc_split{s}": (f"load('load_netcdf', 'hj_{{tag}}.nc', 'data', split={s})", {}, "exact")
       for s in (None, 0, 1)},
    "nc_int": ("load('load_netcdf', 'hj_{tag}_int.nc', 'data', dtype=lib.int32, split=0)", {},
               "exact"),
    "nc_masked_float": ("load('load_netcdf', 'masked.nc', 'f', split=0)", {}, "exact"),
    "nc_masked_int": ("load('load_netcdf', 'masked.nc', 'i', dtype=lib.int32, split=1)", {},
                      "exact"),
    **{f"csv_split{s}": (f"csv_routed('hj_{{tag}}.csv', split={s})", {}, "routed")
       for s in (None, 0, 1)},
    "csv_genfromtxt": ("csv_routed('wide16.csv', encoding='utf-16', split=0)", {}, "routed"),
    "csv_one_row": ("csv_routed('row.csv', header_lines=1, split=0)", {}, "routed"),
    "csv_one_column": ("csv_routed('col.csv', split=0)", {}, "routed"),
    "csv_one_cell": ("csv_routed('cell.csv')", {}, "routed"),
    "csv_float64": ("csv_routed('hj_{tag}.csv', dtype=lib.float64, split=0)", {}, "routed"),
    "npy_dir": ("load('load_npy_from_path', 'npy', split=0)", {}, "exact"),
    "stream": ("stream(4)", {}, "exact"),
    "stream_tail": ("stream(5, 'float64')", {}, "exact"),
    **{f"save_h5_split{s}": (f"read_file(saved('h5', {s}))", B1, "file") for s in (None, 0, 1)},
    **{f"save_nc_split{s}": (f"read_file(saved('nc', {s}))", B1, "file") for s in (None, 0, 1)},
    "save_nc_int": ("read_file(saved('nc', 0, 'B'))", B1, "file"),
    "save_csv_split0": ("read_file(saved('csv', 0))", B1, "file"),
    "save_csv_split1": ("read_file(saved('csv', 1))", dict(B1, all_to_all=1), "file"),
    "save_csv_header": ("read_file(saved('csv', 0, header_lines=['a', 'b'], sep=';'))", B1,
                        "file"),
    "halo_split0": ("halos(0, 2)", {"permute": 4}, "exact"),
    "halo_split1": ("halos(1, 1)", {"permute": 4}, "exact"),
    "halo_too_wide": ("refused(arr('A', 0).get_halo, 8)", {}, "exact"),
    "split_tiles": ("split_tiles(0)", {"broadcast": 4}, "exact"),
    "split_tiles_replicated": ("split_tiles(None)", {}, "exact"),
    "square_tiles_tall": ("square_tiles((13, 7), 0, 2)", SQ, "exact"),
    "square_tiles_tall_1": ("square_tiles((13, 7), 0, 1)", SQ1, "exact"),
    "square_tiles_wide": ("square_tiles((6, 11), 1, 2)", SQ, "exact"),
    "square_tiles_wide_0": ("square_tiles((6, 11), 0, 2)", SQ, "exact"),
    "dataset_iris_csv": ("dataset('iris.csv', sep=';', split=0)", {}, "exact"),
    "dataset_iris_h5": ("dataset('iris.h5', 'data', split=0)", {}, "exact"),
    "dataset_iris_nc": ("dataset('iris.nc', 'data', split=1)", {}, "exact"),
    "dataset_labels": ("dataset('iris_labels.csv', sep=';', dtype=lib.int64, split=0)", {},
                       "exact"),
    "dataset_diabetes": ("(dataset('diabetes.h5', 'x', split=0), "
                         "dataset('diabetes.h5', 'y', split=0))", {}, "exact"),
}


def _equal(got, want):
    """Bitwise, recursively; DNDarrays by values and layout."""
    if isinstance(want, dict) and "lshape_map" in want:
        assert (got["dtype"], got["gshape"], got["split"]) == \
            (want["dtype"], want["gshape"], want["split"])
        np.testing.assert_array_equal(got["lshape_map"], want["lshape_map"])
        np.testing.assert_array_equal(got["values"], want["values"])
        assert got["values"].dtype == want["values"].dtype
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert got == want
    elif isinstance(want, (np.ndarray, np.generic)):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want, (got, want)


def _check(case, got, want):
    kind = CASES[case][2]
    if kind == "routed":  # the port's load with its route beside heat_tpu's load
        (g, route), (w, _) = got, want
        _equal(g, w)
        encoded = "encoding=" in CASES[case][0]
        assert list(route) == (["genfromtxt"] if encoded else ["native"]), route
    elif kind == "file" and case.startswith("save_csv"):
        assert got == want  # the text, byte for byte
    else:
        _equal(got, want)


def _heat_tpu(case, spec, p):
    hj = _hj()[0]
    env = _build_env(hj, spec, comm=_hj()[p])
    return pack(eval(CASES[case][0], env))  # noqa: S307


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    d = tmp_path_factory.mktemp("io_files")
    _write_inputs(d)
    return dict(_data(), dir=str(d))


@pytest.fixture(scope="module")
def started(tmp_path_factory, spec):
    handle = start_world(tmp_path_factory.mktemp("io_world2"),
                         dict(spec, cases={k: v[0] for k, v in CASES.items()}), 2, (_build_env,))
    yield handle
    stop_world(handle)


@pytest.fixture(scope="module")
def world2(spec, started):
    """The world's results, and heat_tpu's on two devices, computed while
    the world runs."""
    want = {case: _heat_tpu(case, spec, 2) for case in CASES}
    return finish_world(started), want


@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_heat_tpu(spec, started, case):
    """(``started``: the world-2 ranks run beside these tests.)"""
    ht.get_comm().reset_stats()
    got = pack(eval(CASES[case][0], _build_env(ht, spec)))  # noqa: S307
    assert ht.get_comm().stats == {}
    _check(case, got, _heat_tpu(case, spec, 1))


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_heat_tpu(world2, case):
    got, stats = world2[0][case]
    _check(case, got, world2[1][case])
    assert stats == CASES[case][1], stats


@pytest.mark.parametrize("fmt", ["h5", "nc", "csv"])
def test_heat_tpu_reads_the_port_files(spec, world2, fmt):
    """heat_tpu loads the files the port wrote at world sizes 1 and 2 (the
    world-2 cases wrote theirs) and gets the array back."""
    hj, c1, c2 = _hj()
    d = spec["dir"]
    for split in (None, 0, 1):
        if fmt == "csv" and split is None:
            continue
        for p, comm in ((1, c1), (2, c2)):
            if p == 1:  # the world-1 file, written here
                eval(f"saved('{fmt}', {split})", _build_env(ht, spec))  # noqa: S307
            mine = f"{d}/pt_p{p}_s{split}_A.{fmt}"
            args = () if fmt == "csv" else ("data",)
            got = hj.load(mine, *args, split=split, comm=comm)
            want = hj.array(spec["A"], split=split, comm=comm)
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_errors_match_heat_tpu(spec):
    """The refusals heat_tpu makes, the port makes: a NetCDF-3 dtype, a
    streamed column split, a halo wider than a shard, a chunk size of 0, an
    unknown extension."""
    hj, c1, _ = _hj()
    d = spec["dir"]
    for lib, kw in ((ht, {}), (hj, {"comm": c1})):
        with pytest.raises(ValueError):
            lib.save_netcdf(lib.array(np.arange(3, dtype=np.int64), **kw), f"{d}/x.nc", "v")
        with pytest.raises(ValueError):
            lib.load_hdf5(f"{d}/hj_c1.h5", "data", split=1, stream=True, **kw)
        with pytest.raises(ValueError):
            next(iter(lib.load_hdf5(f"{d}/hj_c1.h5", "data", stream=True, **kw).iter_chunks(0)))
        with pytest.raises(ValueError):
            lib.load(f"{d}/x.txt", **kw)
        with pytest.raises(TypeError):
            lib.load_hdf5(3, "data", **kw)
    x = ht.array(_data()["A"], split=0)
    assert x.array_with_halos(20) is x.larray  # world size 1: the shard itself
    x.get_halo(3)
    assert x.halo_prev is None and x.halo_next is None
    with pytest.raises(TypeError):
        x.get_halo(-1)


def test_bundled_datasets_are_heat_tpus():
    """The port's bundled files are heat_tpu's, byte for byte."""
    _hj()
    import heat_tpu.datasets as hd

    for name in ("iris.csv", "iris.h5", "iris.nc", "iris_labels.csv", "diabetes.h5"):
        with open(ht.datasets.path(name), "rb") as a, open(hd.path(name), "rb") as b:
            assert a.read() == b.read(), name


def test_native_csv_failure_raises(tmp_path, monkeypatch):
    """A failing native parse raises from ``load_csv``: it is not re-parsed
    by ``genfromtxt``, which takes only encodings that are no ASCII superset
    or a machine where the parser does not build."""
    from heat_tpu_torch import native

    assert native.available(), "the native CSV parser does not build here"
    np.savetxt(tmp_path / "a.csv", _data()["A"], delimiter=",")
    before = dict(ht.io.csv_routes)
    with pytest.raises(OSError, match="fastcsv_parse_alloc failed"):
        ht.load_csv(str(tmp_path / "missing.csv"))

    def failing(*a, **k):
        raise OSError("parse failed")

    monkeypatch.setattr(native, "parse_csv_chunk", failing)
    with pytest.raises(OSError, match="parse failed"):
        ht.load_csv(str(tmp_path / "a.csv"), split=0)
    assert ht.io.csv_routes == before, ht.io.csv_routes


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_load_csv_native_onto_the_card(tmp_path):
    """``load_csv`` takes the native parser and puts the rows on the card."""
    a = _data()["A"]
    np.savetxt(tmp_path / "a.csv", a, delimiter=",")
    ht.use_device(None)
    before = ht.io.csv_routes["native"]
    x = ht.load_csv(str(tmp_path / "a.csv"), split=0)
    assert ht.io.csv_routes["native"] == before + 1
    assert x.larray.device.type == "cuda"
    np.testing.assert_array_equal(x.numpy(), a)
