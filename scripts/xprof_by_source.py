#!/usr/bin/env python
"""Sum device kernel time by Python source line (complements
xprof_top.py's per-kernel view).

Usage: python scripts/xprof_by_source.py TRACE_DIR [N]
TRACE_DIR holds a jax.profiler trace and the optimized HLO of the traced
program as `*.hlo.txt.gz` (`chip_smoke.py --trace DIR` writes both). A
fusion kernel is named after its HLO instruction; the instruction's
`stack_frame_id` indexes the module's StackFrames / FileLocations /
FileNames / FunctionNames tables. Each kernel is attributed to its
innermost frame (`file:line function`), followed by the nearest frame
in a game module (`< bossfight.py:907 observe_batch`) when that is
another file. Kernels with no instruction of their name (library calls
such as cuBLAS `nvjet_*`) are listed under their own name.
"""
import collections
import glob
import gzip
import os
import re
import sys

from xprof_top import device_events

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*\bstack_frame_id=(\d+)")
_TABLES = ("FileNames", "FunctionNames", "FileLocations", "StackFrames")
_ENTRY = re.compile(r'^(\d+) (?:"(.*)"|\{(.*)\})$')


def _frames(lines):
    """{frame id: [(file, line, function), ... outwards to the root]}."""
    tables, current = {t: {} for t in _TABLES}, None
    for line in lines:
        line = line.rstrip("\n")
        if line in _TABLES:
            current = tables[line]
            continue
        m = _ENTRY.match(line) if current is not None else None
        if not m:
            current = None
            continue
        current[int(m.group(1))] = m.group(2) if m.group(2) is not None \
            else dict(kv.split("=") for kv in m.group(3).split())
    names, funcs, locs, frames = (tables[t] for t in _TABLES)

    def chain(fid):
        out, seen = [], set()
        while fid in frames and fid not in seen:
            seen.add(fid)
            loc = locs[int(frames[fid]["file_location_id"])]
            out.append((names[int(loc["file_name_id"])], loc["line"],
                        funcs[int(loc["function_name_id"])]))
            # parent ids are printed one above the parent's own id
            # (0 = the outermost frame has none)
            fid = int(frames[fid]["parent_frame_id"]) - 1
        return out

    return chain


def _label(chain):
    """'file:line function' of the innermost frame, plus the nearest
    frame in a game module when it is in another file."""
    def fmt(f):
        return f"{os.path.basename(f[0])}:{f[1]} {f[2]}"

    if not chain:
        return "?"
    game = next((f for f in chain if f"{os.sep}games{os.sep}" in f[0]), None)
    if game is None or game[0] == chain[0][0]:
        return fmt(chain[0])
    return f"{fmt(chain[0])} < {fmt(game)}"


def kernel_sources(logdir):
    """{kernel name: source label} from every *.hlo.txt.gz under
    `logdir`; HLO names map to kernel names with `.`/`-` as `_`."""
    out = {}
    for path in glob.glob(f"{logdir}/**/*.hlo.txt.gz", recursive=True):
        with gzip.open(path, "rt") as f:
            lines = f.readlines()
        chain = _frames(lines)
        for line in lines:
            m = _INSTR.match(line)
            if m:
                out[re.sub(r"[.\-]", "_", m.group(1))] = _label(
                    chain(int(m.group(2))))
    return out


def main():
    logdir = sys.argv[1]
    topn = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    path, events = device_events(logdir)
    sources = kernel_sources(logdir)
    by_src = collections.Counter()
    for name, ms, _ in events:
        by_src[sources.get(name, f"[{name[:60]}]")] += ms
    total = sum(by_src.values())
    print(f"trace: {path}")
    print(f"total device op time: {total:.3f} ms; "
          f"{len(sources)} HLO instructions with a source frame\n")
    for src, ms in by_src.most_common(topn):
        print(f"{ms:9.3f} ms  {100 * ms / total:5.1f}%  {src}")


if __name__ == "__main__":
    main()
