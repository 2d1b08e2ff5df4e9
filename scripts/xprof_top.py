#!/usr/bin/env python
"""Print top device-time ops from a jax.profiler trace directory.

Usage: python scripts/xprof_top.py TRACE_DIR [N]
Sums the durations of the device's kernel events (processes named
`/device:...`, e.g. `/device:GPU:0`) by kernel name from the
trace.json.gz that jax.profiler writes. On the GPU a fusion's kernel is
named after its HLO instruction (`loop_transpose_fusion_1`,
`gemm_fusion_dot_3`); library kernels (cuBLAS `nvjet_*`, ...) keep
their own names. scripts/xprof_by_source.py maps the fusions to source
lines.
"""
import collections
import glob
import gzip
import json
import sys


def device_events(logdir):
    """(trace path, [(kernel name, duration ms, args)]) of every event
    on a device process of the newest trace under `logdir`."""
    paths = sorted(glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True))
    if not paths:
        sys.exit(f"no trace.json.gz under {logdir}")
    with gzip.open(paths[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    dev_pids = {e["pid"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and e["args"].get("name", "").startswith("/device:")}
    return paths[-1], [
        (e.get("name", "?"), e.get("dur", 0) / 1e3, e.get("args") or {})
        for e in events if e.get("ph") == "X" and e.get("pid") in dev_pids]


def main():
    logdir = sys.argv[1]
    topn = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    path, events = device_events(logdir)
    by_op = collections.Counter()
    for name, ms, _ in events:
        by_op[name] += ms
    total = sum(by_op.values())
    print(f"trace: {path}")
    print(f"total device op time: {total:.3f} ms ({len(events)} events)\n")
    for name, ms in by_op.most_common(topn):
        print(f"{ms:9.3f} ms  {100 * ms / total:5.1f}%  {name[:100]}")


if __name__ == "__main__":
    main()
