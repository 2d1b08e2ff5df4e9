"""scripts/xprof_top.py and xprof_by_source.py on a small recorded-form
trace: device events are summed by kernel and attributed to source
lines through the HLO written beside the trace."""
import gzip
import json
import os

import pytest

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")

HLO = """\
HloModule jit__step, entry_computation_layout={...}

FileNames
1 "/src/procgen2_tpu/games/bossfight.py"
2 "/src/procgen2_tpu/render/compositor.py"

FunctionNames
1 "observe_batch"
2 "composite_stamps"
3 "place_stamps"

FileLocations
1 {file_name_id=1 function_name_id=1 line=907 end_line=909 column=15 end_column=9}
2 {file_name_id=2 function_name_id=2 line=463 end_line=463 column=29 end_column=53}
3 {file_name_id=2 function_name_id=3 line=426 end_line=426 column=8 end_column=40}

StackFrames
1 {file_location_id=1 parent_frame_id=1}
2 {file_location_id=2 parent_frame_id=2}
3 {file_location_id=3 parent_frame_id=3}

ENTRY %main.1 (p0: bf16[8,64]) -> bf16[8,64] {
  %p0 = bf16[8,64]{1,0} parameter(0)
  %loop_transpose_fusion.1 = bf16[8,64]{1,0} fusion(%p0), kind=kLoop, calls=%fused_transpose, metadata={op_name="jit(_step)/transpose" stack_frame_id=3}
  ROOT %gemm_fusion_dot.3 = bf16[8,64]{1,0} fusion(%loop_transpose_fusion.1), kind=kCustom, calls=%gemm, metadata={op_name="jit(_step)/dot_general" stack_frame_id=1}
}
"""


def _event(pid, name, dur_us):
    return {"ph": "X", "pid": pid, "tid": 1, "ts": 0, "dur": dur_us,
            "name": name}


@pytest.fixture
def trace_dir(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(SCRIPTS)
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "/host:CPU"}},
        _event(1, "loop_transpose_fusion_1", 1000),
        _event(1, "loop_transpose_fusion_1", 500),
        _event(1, "gemm_fusion_dot_3", 2000),
        _event(1, "nvjet_tst_128x128", 250),
        _event(7, "python", 90000),  # host: not device time
    ]
    prof = tmp_path / "plugins" / "profile" / "t0"
    prof.mkdir(parents=True)
    with gzip.open(prof / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    with gzip.open(tmp_path / "step.hlo.txt.gz", "wt") as f:
        f.write(HLO)
    return str(tmp_path)


def test_device_events_keep_only_device_processes(trace_dir):
    import xprof_top

    _, events = xprof_top.device_events(trace_dir)
    assert sorted((n, ms) for n, ms, _ in events) == [
        ("gemm_fusion_dot_3", 2.0), ("loop_transpose_fusion_1", 0.5),
        ("loop_transpose_fusion_1", 1.0), ("nvjet_tst_128x128", 0.25)]


def test_kernels_attributed_to_source_lines(trace_dir, capsys, monkeypatch):
    import xprof_by_source

    src = xprof_by_source.kernel_sources(trace_dir)
    # innermost frame, then the nearest frame in a game module
    assert src["loop_transpose_fusion_1"] == (
        "compositor.py:426 place_stamps < bossfight.py:907 observe_batch")
    assert src["gemm_fusion_dot_3"] == "bossfight.py:907 observe_batch"
    monkeypatch.setattr("sys.argv", ["xprof_by_source.py", trace_dir])
    xprof_by_source.main()
    out = capsys.readouterr().out
    assert "2.000 ms   53.3%  bossfight.py:907 observe_batch" in out
    assert ("1.500 ms   40.0%  compositor.py:426 place_stamps < "
            "bossfight.py:907 observe_batch") in out
    assert "[nvjet_tst_128x128]" in out
