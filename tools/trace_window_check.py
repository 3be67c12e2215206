#!/usr/bin/env python3
"""Whether a torch.profiler trace of a CUDA-graph replay holds every kernel
of the replay, as chip_smoke.py's launch gates count them.

    python3 tools/trace_window_check.py [--kernels N] [--traces R]

Captures one CUDA graph of N small kernels (N / 2 in-place scales of a
small tensor, then N / 2 in-place adds: a step's graph in size), then
traces its replay R times through chip_smoke.py's
``_device_kernel_counts`` with each guard in turn: 0 s (the replay
launched as the profiler's recorded window opens, the window closed as
soon as the card is idle) and TRACE_GUARD_S. Prints the card's name and
power limit, for each guard how many traces held other than N / 2 of
either kind and the fewest of each seen (a kernel lost from the first
half is lost at the window's head, from the second at its tail), and
last one JSON line. Exits 1 when CUDA is missing, 2 when a trace with the
guard chip_smoke.py uses came up short.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _kernel_name(fn):
    """The name of the one kernel ``fn()`` launches, as a trace reports
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    if len(keys) != 1:
        raise AssertionError(f"expected one kernel, the trace holds {keys}")
    return keys.pop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", type=int, default=11000)
    ap.add_argument("--traces", type=int, default=40)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_window_check: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    print(f"[card] {cs._card_line()}", flush=True)
    x = torch.ones(256, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    half = args.kernels // 2

    def kernels():
        for _ in range(half):
            x.mul_(1.0)
        for _ in range(half):
            x.add_(0.0)
    with torch.cuda.stream(side):
        kernels()  # the kernels loaded before the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        kernels()
    g.replay()
    torch.cuda.synchronize()
    names = (_kernel_name(lambda: x.mul_(1.0)),
             _kernel_name(lambda: x.add_(0.0)))
    print(f"[trace] counting {names[0]!r} and {names[1]!r}", flush=True)
    result = {}
    for guard in (0.0, cs.TRACE_GUARD_S):
        counts = [cs._device_kernel_counts(g.replay, names, guard)
                  for _ in range(args.traces)]
        off = [c for c in counts if c != (half, half)]
        head, tail = (min(c[i] for c in counts) for i in (0, 1))
        result[str(guard)] = {"traces": len(counts), "off": len(off),
                              "fewest_head": head, "fewest_tail": tail}
        print(f"[trace] guard {guard} s: {len(off)} of {len(counts)} traces "
              f"held other than {half} + {half} kernels (fewest of the "
              f"first half {head}, of the second {tail})", flush=True)
    print(json.dumps({"trace_window_check": result,
                      "kernels": 2 * half}), flush=True)
    return 2 if result[str(cs.TRACE_GUARD_S)]["off"] else 0


if __name__ == "__main__":
    sys.exit(main())
