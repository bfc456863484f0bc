"""Run one cell of the benchmark once and print its result as one JSON
line, the last of standard output:

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m gsbench.run ...``) from the root of a checkout on a
machine with an NVIDIA card.  Without a card, or with fewer than the cell
asks for, it exits with an error and prints no result.  With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profile of a steady stretch of the window.
The numbers that decide ``correct`` follow, each beside its limit, as the
last lines of standard error and under ``checks``, the result's last key.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root is the import root
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "--id=0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, res, device, trace: bool) -> dict:
    """The contract's JSON object of one run."""
    from gsbench import spec

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(res.trace)
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: res.metrics[m["name"]] for m in cell.end_to_end}
    out = dict(correct=res.correct, attempted=res.attempted, failed=res.failed,
               metrics={k: dict(value=v, unit=units[k]) for k, v in values.items()},
               device=device)
    if trace:
        out["device"] = dict(device, busy_s=res.trace.busy_s, window_s=res.trace.window_s)
        out["breakdown"] = dict(device_ops=res.trace.device_ops,
                                idle_gaps=res.trace.idle_gaps)
    out["checks"] = {k: {f: (x if x is None or math.isfinite(x) else str(x))
                         for f, x in c.items()} for k, c in res.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from gsbench import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    run = harness.make(cell, args.seed, device)
    res = run.run(args.seconds, bool(args.trace), T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=cell.chips,
               memory_peak_bytes=res.peak_bytes, power_limit_w=power_limit())
    line = result_line(cell, res, dev, bool(args.trace))
    for name, c in res.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
