"""The port's tracing module (``fedtorch_tpu_torch/utils/tracing.py``) on
the CPU: the ``SyncSentinel``'s bookkeeping through synthetic sync-debug
warnings (the CPU has no CUDA sync to report), the drain, the capture
helpers.

The sentinel's warnings are raised from code objects compiled under a
file name inside the package, so each one's site is named as a real
sync inside the port would be."""
import os
import warnings

import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
import fedtorch_tpu_torch
from fedtorch_tpu_torch.utils import tracing
from fedtorch_tpu_torch.utils.tracing import SYNC_WARNING, SyncSentinel

PKG = os.path.dirname(fedtorch_tpu_torch.__file__)


def _port_function(rel: str, body: str, name: str = "f"):
    """A function whose code lies at ``fedtorch_tpu_torch/<rel>``."""
    src = f"def {name}():\n" + "".join(f"    {ln}\n"
                                       for ln in body.splitlines())
    ns = {"warnings": warnings, "SYNC": SYNC_WARNING}
    exec(compile(src, os.path.join(PKG, rel), "exec"), ns)
    return ns[name]


def test_sites_are_named_by_the_innermost_port_frame():
    sync = _port_function("parallel/fake_round.py",
                          "warnings.warn(SYNC)\nwarnings.warn(SYNC)",
                          name="_round_core")
    caller = _port_function("cli.py", "inner()", name="outer")
    caller.__globals__["inner"] = sync
    with SyncSentinel() as s:
        sync()
        caller()
    assert s.count() == 4
    assert s.sites() == {"fedtorch_tpu_torch/parallel/fake_round.py:2": 2,
                         "fedtorch_tpu_torch/parallel/fake_round.py:3": 2}
    assert s.function_of("fedtorch_tpu_torch/parallel/fake_round.py:2") \
        == "_round_core"
    s.assert_syncs(4)
    with pytest.raises(AssertionError, match="fake_round.py:2 "
                                             r"\(_round_core\) x2"):
        s.assert_syncs(0)


def test_a_sync_outside_the_port_is_marked_so():
    with SyncSentinel() as s:
        warnings.warn(SYNC_WARNING)
    (site,) = s.sites()
    assert site.startswith("(outside the port) ")
    assert "test_torch_tracing.py" in site and s.count() == 1


def test_the_scope_holds_and_other_warnings_pass_through():
    f = _port_function("ops/fake.py", "warnings.warn(SYNC)")
    f()  # before the scope: not counted (shown once by the default filter)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with SyncSentinel() as s:
            f()
            warnings.warn("an unrelated warning")
        f()  # after the scope
    assert s.count() == 1
    texts = [str(w.message) for w in seen]
    assert "an unrelated warning" in texts
    assert texts.count(SYNC_WARNING) == 1  # the one after the scope


def test_the_debug_mode_is_armed_and_restored_on_an_exception(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    show = warnings.showwarning
    with pytest.raises(RuntimeError, match="round failed"):
        with SyncSentinel():
            assert modes == ["warn"]
            raise RuntimeError("round failed")
    assert modes == ["warn", 0]
    assert warnings.showwarning is show
    with SyncSentinel(arm=False):
        pass
    assert modes == ["warn", 0]


def test_a_watch_gives_the_sentinel_s_and_the_profiler_s_numbers():
    sync = _port_function("parallel/fake_round.py",
                          "warnings.warn(SYNC)\nreturn torch.ones(3).sum()")
    sync.__globals__["torch"] = torch
    out, n = tracing.watch(sync)
    assert float(out) == 3.0
    assert n["syncs"] == 1
    assert n["sync_sites"] == [dict(
        site="fedtorch_tpu_torch/parallel/fake_round.py:2", function="f",
        count=1)]
    # no CUDA runtime on the CPU, and a CPU window drains nothing
    assert (n["runtime_syncs"]["total"], n["runtime_syncs"]["unwarned"]) \
        == (0, 0)
    assert (n["dtoh"], n["htod"], n["quantizer"], n["kernel_launches"]) \
        == (0, 0, 0, 0)


def test_fetch_sync_drains_a_pytree_through_its_first_tensor():
    t = torch.arange(6.0).reshape(2, 3) + 4
    assert tracing.fetch_sync(t) == 4.0
    assert tracing.fetch_sync({"a": [None, (t * 2,)], "b": t}) == 8.0
    assert tracing.fetch_sync([torch.empty(0)]) is None
    assert tracing.fetch_sync(None) is None


def test_memory_summaries_are_empty_without_cuda():
    assert tracing.device_memory_stats() == {}
    assert tracing.live_buffer_summary() == {
        "total_bytes": None, "by_shape": {}}


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with tracing.trace(str(tmp_path)):
        with tracing.annotate("my.step"):
            torch.ones(4).sum()
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".trace.json")]
    text = open(tmp_path / path).read()
    assert "my.step" in text and "aten::sum" in text


def test_a_profile_window_counts_its_records_in_memory():
    m = torch.nn.Linear(8, 4)
    out, w = tracing.profile_window(lambda: m(torch.randn(3, 8)).sum())
    assert torch.isfinite(out) and w.trace_path is None
    sums = w.sums()
    assert sums[(False, "aten::addmm")][1] == 1
    assert w.runtime_syncs()["total"] == 0  # no CUDA runtime on the CPU
    assert w.memcpy_counts() == {"dtoh": 0, "htod": 0}


class _OldKinetoEvent:
    """A CUDA record as older torch builds give it: no activity_type,
    no start_ns."""

    def __init__(self, name, device, start_us, dur_ns, stream=7):
        self._v = (name, device, start_us, dur_ns, stream)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def device_index(self):
        return 0

    def device_resource_id(self):
        return self._v[4]

    def start_us(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def test_records_without_activity_type_are_read_by_device_type():
    evs = [_OldKinetoEvent("void qdq_ragged_stats_kernel(LeafTable)", "CUDA",
                           10, 4000),
           _OldKinetoEvent("Memcpy DtoH (Device -> Pinned)", "CUDA", 20, 1000),
           _OldKinetoEvent("cudaStreamSynchronize", "CPU", 19, 3000, 0),
           _OldKinetoEvent("cudaLaunchKernel", "CPU", 9, 500, 0),
           # the window's own edge padding: left out
           _OldKinetoEvent("void at::cuda::(anonymous namespace)::"
                           "spin_kernel(long)", "CUDA", 1, 1000)]
    w = tracing.ProfileWindow(None)
    w._events = evs
    assert {key[1][:13]: v for key, v in w.sums().items() if key[0]} == {
        "void qdq_ragg": (0.004, 1), "Memcpy DtoH (": (0.001, 1)}
    assert w.memcpy_counts() == {"dtoh": 1, "htod": 0}
    assert w.runtime_syncs()["cudaStreamSynchronize"] == 1
    assert w.sums()[(False, "cudaLaunchKernel")] == (0.0005, 1)


def test_a_card_window_s_own_drains_are_not_counted_as_unwarned():
    """On a card each sync-debug warning comes with one
    ``cudaStreamSynchronize``; every other synchronizing call beyond the
    window's own ``WINDOW_DRAINS`` is one the debug mode missed."""
    def window(device_syncs):
        evs = [_OldKinetoEvent("cudaStreamSynchronize", "CPU", 1, 10, 0)] \
            + [_OldKinetoEvent("cudaDeviceSynchronize", "CPU", 2 + i, 10, 0)
               for i in range(device_syncs)] \
            + [_OldKinetoEvent("cudaEventSynchronize", "CPU", 9, 10, 0)]
        w = tracing.ProfileWindow(None, cuda=True)
        w._events = evs
        return w.runtime_syncs()
    got = window(tracing.WINDOW_DRAINS)
    assert got[tracing.WARNED_SYNC_CALL] == 1
    assert (got["total"], got["unwarned"]) == (tracing.WINDOW_DRAINS + 2, 1)
    assert window(tracing.WINDOW_DRAINS + 2)["unwarned"] == 3
