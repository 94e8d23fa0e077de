"""The port's resplit planner (``core/resharding.py``) against heat_tpu's:
``plan_kind`` for every (from, to) pair of splits of 2-D and 3-D shapes,
even and uneven, at world size 2; and in ONE spawned 2-rank gloo world for
the module, every pair moved, its values equal to the input, its
``lshape_map`` and each rank's shard heat_tpu's for a two-device mesh, and
exactly one all-to-all and no all-gather for every split→split move (one
all-gather for split→None, nothing for None→split). Values are exact: a
resplit only moves elements.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core import resharding as jresharding  # noqa: E402
from heat_tpu.core.communication import TPUCommunication  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import resharding  # noqa: E402
from heat_tpu_torch.core.communication import TorchCommunication  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
C2 = TPUCommunication(jax.devices()[:2])
SHAPES = [(8, 6), (7, 5), (4, 6, 5), (3, 5, 7)]
TYPES = ["bool", "int32", "float16", "bfloat16", "float32", "complex64"]


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


class _SizedComm(TorchCommunication):
    """The port's communicator at a given world size, without a process
    group: the planner reads only ``size``."""

    def __init__(self, size):
        super().__init__()
        self._size = size

    @property
    def size(self):
        return self._size


def _pairs(ndim):
    splits = [None] + list(range(ndim))
    return [(a, b) for a in splits for b in splits]


def _data(shape, dtype="float32", seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * 4
    if dtype == "bool":
        return a > 0
    if dtype == "int32":
        return a.astype(np.int32)
    if dtype == "complex64":
        return (a + 1j * a[::-1]).astype(np.complex64)
    return a.astype(np.float16 if dtype == "float16" else np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_kind_matches_heat_tpu_at_world_size_2(shape):
    for a, b in _pairs(len(shape)):
        assert resharding.plan_kind(shape, a, b, _SizedComm(2)) == \
            jresharding.plan_kind(shape, a, b, C2), (shape, a, b)


def test_world_size_1_moves_are_local():
    x = ht.array(_data((7, 5)), split=0)
    assert resharding.plan_kind(x.gshape, 0, 1, x.comm) == "local"
    assert resharding.plan_kind((), None, None, x.comm) == "noop"
    x.comm.reset_stats()
    y = x.resplit(1).resplit(None).resplit(0)
    assert x.comm.stats == {}
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    assert (y.split, y.lshape) == (0, (7, 5))
    z = ht.array(_data((7, 5)))
    assert z.resplit_(1) is z and z.split == 1
    with pytest.raises(ValueError):
        _SizedComm(2).Alltoall(torch.zeros(2, 2), 0, 0, 2)


# --------------------------------------------------------------------------- #
# one 2-rank gloo world for the module                                        #
# --------------------------------------------------------------------------- #

def _cases():
    cases = []
    for shape in SHAPES:
        for a, b in _pairs(len(shape)):
            cases.append((f"{'x'.join(map(str, shape))}_{a}_{b}", shape, "float32", a, b))
    for dtype in TYPES:
        if dtype != "float32":
            cases.append((f"7x5_{dtype}_0_1", (7, 5), dtype, 0, 1))
    # one row over two ranks: rank 1 holds an empty shard
    cases += [("1x5_0_1", (1, 5), "float32", 0, 1), ("1x5_1_0", (1, 5), "float32", 1, 0),
              ("5x1_1_0", (5, 1), "float32", 1, 0), ("0x4_0_1", (0, 4), "float32", 0, 1)]
    return cases


CASES = _cases()

_WORKER = r'''
import pickle, sys
from datetime import timedelta
import numpy as np
import torch.distributed as dist

rank, world, port, spec_path, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
import heat_tpu_torch as ht
from heat_tpu_torch.core import resharding

ht.use_device("cpu")
with open(spec_path, "rb") as f:
    spec = pickle.load(f)
comm = ht.get_comm()
res = {}
for name, a, dtype, src, dst in spec["cases"]:
    x = ht.array(a, split=src)
    if dtype == "bfloat16":
        x = x.astype(ht.bfloat16)
    comm.reset_stats()
    y = x.resplit(dst)
    stats = {k: v["calls"] for k, v in comm.stats.items()}
    z = x.astype(x.dtype)
    z.resplit_(dst)
    res[name] = {"values": y.numpy(), "inplace": z.numpy(), "split": y.split,
                 "inplace_split": z.split, "lshape_map": y.lshape_map, "lshape": y.lshape,
                 "dtype": y.dtype.__name__, "stats": stats,
                 "kind": resharding.plan_kind(x.gshape, src, dst, comm)}
# a binary op of two different splits aligns the second by one all-to-all
A, B = ht.array(spec["a"], split=0), ht.array(spec["b"], split=1)
comm.reset_stats()
s = A + B
stats = {k: v["calls"] for k, v in comm.stats.items()}
res["binary_align"] = {"values": s.numpy(), "split": s.split, "stats": stats}
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(res, f)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every case on two gloo ranks in one world; a rank that dies (gloo
    aborts on mismatched sizes) or hangs fails the module."""
    tmp = tmp_path_factory.mktemp("resplit_world2")
    spec = {"cases": [(n, _data(shape, dtype, seed=i), dtype, a, b)
                      for i, (n, shape, dtype, a, b) in enumerate(CASES)],
            "a": _data((7, 5), seed=90), "b": _data((7, 5), seed=91)}
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    (tmp / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), "2", port,
                               str(tmp / "spec.pkl"), str(tmp / "out.pkl")],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f), spec


_EXPECTED = {"noop": {}, "local_slice": {}, "all_gather": {"all_gather": 1},
             "all_to_all": {"all_to_all": 1}, "gspmd": None}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_world2_resplit(world2, case):
    res, spec = world2
    name, shape, dtype, src, dst = case
    got = res[name]
    a = dict((c[0], c[1]) for c in spec["cases"])[name]
    want = torch.from_numpy(a).bfloat16().float().numpy() if dtype == "bfloat16" else a
    np.testing.assert_array_equal(got["values"], want)
    np.testing.assert_array_equal(got["inplace"], want)
    assert got["split"] == got["inplace_split"] == dst
    assert got["dtype"] == dtype
    lmap = C2.lshape_map(shape, dst)
    np.testing.assert_array_equal(got["lshape_map"], lmap)
    assert tuple(got["lshape"]) == tuple(lmap[0])
    kind = jresharding.plan_kind(shape, src, dst, C2)
    if kind != "gspmd":
        assert got["kind"] == kind
        assert got["stats"] == _EXPECTED[kind], (got["stats"], kind)
    else:  # an empty array: the port plans it like any other
        assert got["stats"] == _EXPECTED[got["kind"]]


@pytest.mark.parametrize("shape", [(7, 5), (4, 6, 5)], ids=["7x5", "4x6x5"])
def test_world2_resplit_matches_heat_tpu_resplit(world2, shape):
    """heat_tpu's own resplit of the same arrays on two devices: the same
    values, split and layout."""
    res, spec = world2
    inputs = dict((c[0], c[1]) for c in spec["cases"])
    for a, b in _pairs(len(shape)):
        name = f"{'x'.join(map(str, shape))}_{a}_{b}"
        y = hj.array(inputs[name], split=a, comm=C2).resplit(b)
        np.testing.assert_array_equal(res[name]["values"], np.asarray(y.numpy()))
        assert res[name]["split"] == y.split
        np.testing.assert_array_equal(res[name]["lshape_map"], y.lshape_map)


def test_world2_binary_op_of_two_splits_is_one_all_to_all(world2):
    res, spec = world2
    got = res["binary_align"]
    want = hj.array(spec["a"], split=0, comm=C2) + hj.array(spec["b"], split=1, comm=C2)
    assert got["stats"] == {"all_to_all": 1}
    assert got["split"] == want.split == 0
    np.testing.assert_array_equal(got["values"], np.asarray(want.numpy()))
