"""The serve cell's `pipeline.graph_replay_share.lat` reader on a Chrome
trace built by hand and parsed by `Trace`."""

import types

import pytest

from bench_h100 import harness
from bench_h100.trace import Trace


def _op(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur}


def _call(name, ts, tid=1):
    return dict(_op(name, ts, 1, tid, cat="cuda_runtime"), args={"correlation": ts})


def _share(events):
    read = harness.metric_reader("pipeline.graph_replay_share.lat")
    return read(types.SimpleNamespace(trace_obj=Trace(events, wall_s=1e-4)))


UNETS = [_op("rr.unet#1", 0, 10), _op("rr.unet#5", 20, 10), _op("rr.unet#9", 40, 10),
         _op("rr.unet#12", 60, 10)]


@pytest.mark.parametrize("calls, share", [
    # the first two ranges launch a graph; the third's launch is on another
    # thread, the fourth launches kernels and a graph only after it ends
    ([_call("cudaGraphLaunch", 5), _call("cuGraphLaunch", 29),
      _call("cudaGraphLaunch", 45, tid=2), _call("cudaLaunchKernel", 65),
      _call("cudaGraphLaunch", 75)], 50.0),
    ([_call("cudaLaunchKernel", 5), _call("cudaLaunchKernel", 25)], 0.0),    # all eager
])
def test_graph_replay_share_reads_the_unet_ranges_that_launch_a_graph(calls, share):
    assert _share(UNETS + [_op("rr.brushnet#2", 70, 10)] + calls) == share


def test_graph_replay_share_is_absent_without_the_ranges():
    read = harness.metric_reader("pipeline.graph_replay_share.lat")
    assert _share([_op("rr.brushnet#2", 0, 10), _call("cudaGraphLaunch", 5)]) is None
    assert read(types.SimpleNamespace(trace_obj=None)) is None
