"""heat_tpu_torch core against heat_tpu: types, chunk layout, factories,
the default device rule, and the import boundary of the port."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import heat_tpu as hj  # noqa: E402
from heat_tpu.core import types as jtypes  # noqa: E402
from heat_tpu.core.communication import TPUCommunication  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import types as ttypes  # noqa: E402
from heat_tpu_torch.core.communication import TorchCommunication  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
TYPE_NAMES = ["bool", "uint8", "int8", "int16", "int32", "int64", "bfloat16",
              "float16", "float32", "float64", "complex64", "complex128"]


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


class _SizedComm(TorchCommunication):
    """The port's communicator at a given world size, without a process
    group: the chunk arithmetic only reads ``size`` and ``rank``."""

    def __init__(self, size):
        super().__init__()
        self._size = size

    @property
    def size(self):
        return self._size


def test_promote_types_matches_heat_tpu():
    for a in TYPE_NAMES:
        for b in TYPE_NAMES:
            want = jtypes.promote_types(getattr(jtypes, a), getattr(jtypes, b)).__name__
            got = ttypes.promote_types(getattr(ttypes, a), getattr(ttypes, b)).__name__
            assert got == want, (a, b)


def test_type_predicates_and_defaults():
    for name in TYPE_NAMES:
        assert (ttypes.heat_type_is_exact(getattr(ttypes, name))
                == jtypes.heat_type_is_exact(getattr(jtypes, name))), name
    for py in (bool, int, float, complex):
        assert (ttypes.canonical_heat_type(py).__name__
                == jtypes.canonical_heat_type(py).__name__)
    for name in ("bfloat16", "float16", "float32", "float64"):
        want = jtypes.accumulation_dtype(getattr(jtypes, name).jax_type())
        got = ttypes.accumulation_dtype(getattr(ttypes, name).torch_type())
        assert str(got).split(".")[-1] == str(want), name
    # heat_tpu enables x64: arange defaults to int64, rand to float32
    assert ht.arange(4).dtype.__name__ == hj.arange(4).dtype.__name__ == "int64"
    ht.random.seed(1)
    hj.random.seed(1)
    assert ht.random.rand(3).dtype.__name__ == hj.random.rand(3).dtype.__name__ == "float32"


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_chunk_layout_matches_heat_tpu(world):
    jcomm = TPUCommunication(jax.devices()[:world])
    tcomm = _SizedComm(world)
    for n in (0, 1, 7, 10, 13):
        assert tcomm.counts_displs(n) == jcomm.counts_displs(n)
        for shape, split in (((n,), 0), ((n, 3), 0), ((3, n), 1), ((n, 3), None)):
            np.testing.assert_array_equal(tcomm.lshape_map(shape, split),
                                          jcomm.lshape_map(shape, split))
            for r in range(world):
                assert tcomm.chunk(shape, split, rank=r) == jcomm.chunk(shape, split, rank=r)


@pytest.mark.parametrize("n", [0, 1, 10, 13, 1000])
def test_arange_sum_matches_heat_tpu(n):
    got = ht.arange(n, split=0).sum()
    want = hj.arange(n, split=0).sum()
    assert got.item() == want.item()
    assert got.dtype.__name__ == want.dtype.__name__
    assert got.shape == want.shape == ()


def test_factory_round_trips():
    rng = np.random.default_rng(0)
    for dt in (np.float32, np.float64, np.int32, np.int64, np.bool_):
        a = (rng.standard_normal((7, 3)) * 10).astype(dt)
        for split in (None, 0, 1):
            t, j = ht.array(a, split=split), hj.array(a, split=split)
            np.testing.assert_array_equal(t.numpy(), a)
            assert t.dtype.__name__ == j.dtype.__name__
            assert (t.gshape, t.split) == (j.gshape, j.split)
    for obj in ([1.5, 2.0], [1, 2, 3], [[True, False]], 3.0):
        t, j = ht.array(obj), hj.array(obj)
        assert t.dtype.__name__ == j.dtype.__name__, obj
        np.testing.assert_array_equal(t.numpy(), j.numpy())
    for make in ("zeros", "ones", "empty"):
        t = getattr(ht, make)((5, 4), split=0)
        j = getattr(hj, make)((5, 4), split=0)
        assert (t.gshape, t.split, t.dtype.__name__) == (j.gshape, j.split, j.dtype.__name__)
        np.testing.assert_array_equal(t.lshape_map, _SizedComm(1).lshape_map((5, 4), 0))
        if make != "empty":
            np.testing.assert_array_equal(t.numpy(), j.numpy())
    np.testing.assert_allclose(ht.arange(0.5, 3.0, 0.25, split=0).numpy(),
                               hj.arange(0.5, 3.0, 0.25, split=0).numpy(), rtol=1e-7)
    x = ht.array(np.arange(12.0).reshape(4, 3), split=0)
    np.testing.assert_array_equal(x.resplit(None).resplit(1).resplit(0).numpy(), x.numpy())
    np.testing.assert_array_equal(x[np.array([3, 0, -1])].numpy(), x.numpy()[[3, 0, -1]])
    np.testing.assert_array_equal(x[1:3, 1].numpy(), x.numpy()[1:3, 1])
    np.testing.assert_array_equal((x ** 2).min(axis=1).numpy(), (x.numpy() ** 2).min(axis=1))
    assert x.argmin(axis=0).numpy().tolist() == [0, 0, 0]
    np.testing.assert_array_equal(x[x.numpy() > 3].numpy(), x.numpy()[x.numpy() > 3])


_PROMO_EPS = {"float64": 2.0 ** -52, "float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("scalar_first", [False, True], ids=["array_op_scalar", "scalar_op_array"])
@pytest.mark.parametrize("op", ["+", "**"])
@pytest.mark.parametrize("scalar", [True, 3, 0.5], ids=["bool", "int", "float"])
@pytest.mark.parametrize("name", ["bool", "int32", "int64", "float32", "bfloat16"])
def test_scalar_promotion_matches_heat_tpu(name, scalar, op, scalar_first):
    """An array with a python scalar takes heat_tpu's dtype (its
    ``result_type``: a python float is float64, an int int64; bool ** bool
    is int32, as ``jnp.power`` gives) and its values, in both orders.
    Floats may differ by 4 ulp of the result type (another libm)."""
    base = np.array([0, 1, 2, 3, 5])
    data = base.astype(bool) if name == "bool" else base

    def apply(lib):
        a = lib.array(data).astype(getattr(lib, name))
        if op == "+":
            return scalar + a if scalar_first else a + scalar
        return scalar ** a if scalar_first else a ** scalar

    got, want = apply(ht), apply(hj)
    assert got.dtype.__name__ == want.dtype.__name__
    assert (got.gshape, got.split) == (want.gshape, want.split)
    g, w = (np.asarray(r.numpy()).astype(np.float64) for r in (got, want))
    np.testing.assert_allclose(g, w, rtol=4 * _PROMO_EPS.get(want.dtype.__name__, 0.0), atol=0)


def _rt_operand(lib, kind, name):
    if kind == "type":
        return getattr(lib, name)
    data = np.arange(3) if kind == "array" else np.array(1)
    return lib.array(data).astype(getattr(lib, name))


_RT_OTHERS = {"bool": True, "int": 3, "float": 0.5, "complex": 1j,
              "int64_array": ("array", "int64"), "float16_type": ("type", "float16"),
              "int8_0d": ("0d", "int8")}


@pytest.mark.parametrize("other", list(_RT_OTHERS))
@pytest.mark.parametrize("name", ["bool", "int32", "float32", "bfloat16", "float64"])
@pytest.mark.parametrize("kind", ["array", "0d", "type"])
def test_result_type_matches_heat_tpu(kind, name, other):
    """``types.result_type`` over an array, a 0-d array or a type with a
    python scalar, an array, a type or a 0-d array: heat_tpu's answer, in
    both orders."""
    o = _RT_OTHERS[other]

    def args(lib):
        second = _rt_operand(lib, *o) if isinstance(o, tuple) else o
        return _rt_operand(lib, kind, name), second

    for order in (1, -1):
        got = ttypes.result_type(*args(ht)[::order]).__name__
        want = jtypes.result_type(*args(hj)[::order]).__name__
        assert got == want, (order, got, want)


def test_default_device_needs_cuda_or_cpu_opt_in(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ht.use_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ht.zeros(3)
    with pytest.raises(RuntimeError, match="use_device"):
        ht.random.rand(2, 2)
    with pytest.raises(RuntimeError):
        ht.zeros(3, device="gpu")
    assert ht.zeros(3, device="cpu").larray.device.type == "cpu"
    ht.use_device("cpu")
    assert ht.arange(3).larray.device.type == "cpu"


def _forbidden(name):
    return name == "jax" or name.startswith("jax.") or name == "heat_tpu" \
        or name.startswith("heat_tpu.")


def test_port_imports_no_jax_and_no_heat_tpu():
    """``import heat_tpu_torch`` in a fresh interpreter loads no jax and no
    heat_tpu module, and no source of the port or of chip_smoke.py imports
    one."""
    code = ("import sys; before = set(sys.modules); import heat_tpu_torch; "
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'heat_tpu' or m.startswith('heat_tpu.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    files = sorted((REPO / "heat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


# heat_tpu's names the port does not carry: the mesh-tier switches (part (c)
# of the fusion engine), the Pallas kernel module (the port's kernels are
# heat_tpu_torch.core.kernels and csrc/) and the jax communicator class (the
# port's is TorchCommunication)
_ENGINE_NAMES = {"mesh_tiers", "set_mesh_tiers", "pallas_kernels", "TPUCommunication"}


_FLAT_NAMES: dict = {}


def _flat_names():
    """The public names of heat_tpu's and the port's flat namespaces as
    their own imports make them: read once, in a fresh process (in this one
    a submodule another test imported, such as ``heat_tpu.testing``, binds
    a name of its own)."""
    if not _FLAT_NAMES:
        code = ("import json, heat_tpu, heat_tpu_torch; print(json.dumps([sorted(n for n in "
                "dir(m) if not n.startswith('_')) for m in (heat_tpu, heat_tpu_torch)]))")
        res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                             env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        ref, port = json.loads(res.stdout.splitlines()[-1])
        _FLAT_NAMES.update(ref=set(ref), port=set(port))
    return _FLAT_NAMES["ref"], _FLAT_NAMES["port"]


@pytest.mark.parametrize("module", ["base", "printing", "sanitation", "memory",
                                    "stride_tricks", "communication", "serve",
                                    "utils.checkpointing", "utils.faults",
                                    "utils.program_cache"])
def test_public_names_match_heat_tpu(module):
    """Every name of heat_tpu's ``core/<module>.__all__`` is in the port's
    module and in its flat namespace, every name of the ``__all__`` of
    heat_tpu's ``serve`` and ``utils`` modules is in the port's module, and
    every public name of heat_tpu's flat namespace (``runtime_stats``
    among them) is in the port's (the engine switches aside)."""
    import importlib

    in_core = "." not in module and module != "serve"
    path = f"core.{module}" if in_core else module
    ref = importlib.import_module(f"heat_tpu.{path}")
    port = importlib.import_module(f"heat_tpu_torch.{path}")
    ref_flat, port_flat = _flat_names()
    want = [n for n in ref.__all__ if n not in _ENGINE_NAMES]
    assert [n for n in want if not hasattr(port, n)] == []
    if in_core:
        assert [n for n in want if n not in port_flat] == []
    else:
        assert sorted(port.__all__) == sorted(ref.__all__)
    assert sorted(n for n in ref_flat - _ENGINE_NAMES if n not in port_flat) == []
    assert "runtime_stats" in port_flat


def test_namespace_helpers_behave_as_heat_tpu():
    """The names the flat namespace gained, on heat_tpu's own inputs."""
    from heat_tpu.naive_bayes import GaussianNB as JNB

    nb = ht.naive_bayes.GaussianNB()
    for fn in ("is_classifier", "is_estimator", "is_regressor", "is_transformer"):
        assert getattr(ht, fn)(nb) == getattr(hj, fn)(JNB()), fn
    assert isinstance(ht.base.TransformMixin(), ht.TransformMixin)
    assert ht.get_printoptions() == hj.get_printoptions()
    x = ht.arange(5, split=0)
    ht.local_printing()
    try:
        assert "local=" in str(x)
    finally:
        ht.global_printing()
    assert "local=" not in str(x)
    assert ht.broadcast_shapes((3, 1), (1, 4), (4,)) == hj.broadcast_shapes((3, 1), (1, 4), (4,))
    assert ht.sanitize_slice(slice(-3, None), 7) == hj.sanitize_slice(slice(-3, None), 7)
    assert ht.sanitize_axis((2, 3), -1) == hj.sanitize_axis((2, 3), -1)
    assert ht.sanitize_shape(4) == hj.sanitize_shape(4)
    assert ht.sanitize_sequence((1, 2)) == hj.sanitize_sequence((1, 2))
    assert ht.sanitize_memory_order("K") == hj.sanitize_memory_order("K")
    with pytest.raises(NotImplementedError):
        ht.sanitize_memory_layout(x, "F")
    ht.sanitize_in_tensor(x.larray)
    with pytest.raises(TypeError):
        ht.sanitize_in_tensor(x)
    ht.sanitize_lshape(x, x.larray)
    with pytest.raises(ValueError):
        ht.sanitize_lshape(x, x.larray[:2])
    y = ht.sanitize_distribution(ht.arange(5), target=x)
    assert y.split == 0
    assert ht.Request(3).Wait() == 3 and ht.Request(3).Test()
    assert isinstance(ht.get_comm(), ht.Communication)
    assert ht.distributed_init() is ht.get_comm()  # no process group: a world of one
