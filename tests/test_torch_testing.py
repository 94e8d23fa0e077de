"""The port's public test harness (``heat_tpu_torch.testing``) on heat_tpu's
own harness cases (``tests/test_testing_harness.py``), including that it
catches the failures it exists to catch, and ``utils.profiling`` (heat_tpu
``utils/profiling.py``): a trace file is written, annotations nest on its
timeline, and ``Timer`` waits for what it is told to sync on.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch import testing as httest  # noqa: E402
from heat_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


class TestAssertArrayEqual:
    @pytest.mark.parametrize("split", [None, 0, 1])
    def test_accepts_matching_split_array(self, split):
        a = np.arange(31 * 3, dtype=np.float32).reshape(31, 3)
        httest.assert_array_equal(ht.array(a, split=split), a)

    def test_rejects_non_dndarray(self):
        with pytest.raises(AssertionError, match="not a DNDarray"):
            httest.assert_array_equal(np.ones(3), np.ones(3))

    def test_rejects_wrong_shape(self):
        with pytest.raises(AssertionError, match="global shape"):
            httest.assert_array_equal(ht.ones((4, 5), split=0), np.ones((5, 4)))

    def test_rejects_wrong_values(self):
        with pytest.raises(AssertionError):
            httest.assert_array_equal(ht.ones((4, 5), split=1), np.zeros((4, 5)))

    def test_rejects_a_shard_of_the_wrong_length(self, monkeypatch):
        """The distribution check: a split array whose lshape_map row is not
        the balanced chunk is refused before its values are compared."""
        x = ht.ones((4, 5), split=0)
        monkeypatch.setattr(x.comm, "lshape_map", lambda shape, split: np.array([[3, 5]]))
        with pytest.raises(AssertionError, match="balanced chunk"):
            httest.assert_array_equal(x, np.ones((4, 5), np.float32))

    def test_scalar_and_zero_size(self):
        # ht.array(3.5) is float32, where a bare np.asarray(3.5) is float64
        httest.assert_array_equal(ht.array(3.5), np.float32(3.5))
        httest.assert_array_equal(ht.zeros((0, 4), split=0), np.zeros((0, 4), dtype=np.float32))

    def test_rejects_wrong_dtype(self):
        x = ht.ones((3,), dtype=ht.int32, split=0)
        with pytest.raises(AssertionError, match="dtype mismatch"):
            httest.assert_array_equal(x, np.ones(3, dtype=np.float64))
        httest.assert_array_equal(ht.ones((3,), dtype=ht.float32), np.ones(3), check_dtype=False)

    def test_bfloat16_supported(self):
        """bf16 against its own values (numpy has no bfloat16: its values
        arrive as float32, so the type is not compared), and against float64
        ground truth by bf16's ulp (~7.8e-3), not float64's."""
        a = np.arange(8, dtype=np.float32)
        x = ht.array(a, dtype=ht.bfloat16, split=0)
        httest.assert_array_equal(x, x.numpy(), check_dtype=False)
        httest.assert_array_equal(x, a * (1 + 3e-3), check_dtype=False)
        eps = torch.finfo(torch.bfloat16).eps
        near = torch.from_numpy(a * (1 + 3e-3)).bfloat16().float().numpy()
        httest._compare(near, a.astype(np.float64), "within one bf16 ulp", eps)
        with pytest.raises(AssertionError):
            httest._compare((torch.from_numpy(a) + 1.0).bfloat16().float().numpy(),
                            a.astype(np.float64), "off by 1 must fail", eps)

    def test_real_actual_vs_complex_desired_fails(self):
        with pytest.raises(AssertionError):
            httest._compare(np.array([0.0, 2.0], np.float32), np.array([2j, 2.0 + 0j]),
                            "must not drop imag")
        httest._compare(np.array([1.0, 2.0], np.float32), np.array([1.0 + 0j, 2.0 + 0j]), "")


class TestAssertFuncEqual:
    def test_elementwise_passes(self):
        httest.assert_func_equal((4, 5), ht.exp, np.exp, data_types=(np.float32, np.float64),
                                 seed=0)

    def test_reduction_replicated_result(self):
        httest.assert_func_equal((3, 6), ht.any, np.any, distributed_result=False,
                                 data_types=(np.int32,), seed=1)

    def test_args_passthrough(self):
        httest.assert_func_equal((5, 4), ht.sum, np.sum, heat_args={"axis": 0},
                                 numpy_args={"axis": 0}, data_types=(np.float32, np.int64),
                                 seed=2)

    def test_mismatched_functions_fail(self):
        with pytest.raises(AssertionError):
            httest.assert_func_equal((4, 4), ht.exp, np.log, data_types=(np.float32,), seed=3)

    def test_for_tensor_every_split(self):
        t = np.random.default_rng(4).standard_normal((6, 7, 2)).astype(np.float32)
        httest.assert_func_equal_for_tensor(t, ht.floor, np.floor)

    def test_shape_validation(self):
        with pytest.raises(ValueError, match="shape"):
            httest.assert_func_equal(5, ht.exp, np.exp)


class TestTestCaseBase(httest.TestCase):
    """The unittest base class itself, run by pytest's unittest collector."""

    def setUp(self):
        ht.use_device("cpu")

    def test_comm_and_device(self):
        assert self.comm.size >= 1
        assert self.get_size() == self.comm.size
        assert self.get_rank() == 0
        assert self.device is not None

    def test_assert_methods_bound(self):
        a = np.arange(12, dtype=np.int32).reshape(3, 4)
        self.assert_array_equal(ht.array(a, split=0), a)
        self.assert_func_equal((3, 3), ht.sqrt, np.sqrt, data_types=(np.float64,), seed=5)

    def test_memory_layout_assertion(self):
        self.assertTrue_memory_layout(ht.ones((3, 3)), "C")


def _events(logdir):
    files = list(pathlib.Path(logdir).glob("*.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_a_file_and_annotations_nest(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("outer_span"):
            with profiling.annotate("inner_span"):
                (x @ x).sum()
    spans = {e["name"]: e for e in _events(tmp_path) if e.get("name") in ("outer_span",
                                                                         "inner_span")}
    outer, inner = spans["outer_span"], spans["inner_span"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()
    profiling.start_trace(str(tmp_path / "again"))
    with pytest.raises(RuntimeError, match="already"):
        profiling.start_trace(str(tmp_path / "again"))
    profiling.stop_trace()


def test_timer_waits_for_its_sync_target(monkeypatch):
    from heat_tpu_torch.utils import metrics

    waited = []
    monkeypatch.setattr(metrics, "_wait", waited.append)
    out = torch.ones(3)
    with profiling.Timer("step") as t:
        t.sync(out)
    assert waited == [out] and t.seconds >= 0 and t.name == "step"
    with profiling.Timer() as t2:
        pass
    assert len(waited) == 1 and t2.seconds >= 0
