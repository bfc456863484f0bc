"""The readings the limits of a ``scaffold`` cell are set from, without a
measured window, as ``readings.py`` gives them for a ``train`` cell:

    python3 gsbench/scaffold_readings.py --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--fault 1,2,3]

A sound reading compares the program's checked steps with the plain
reference's; the control puts the reference computed in bfloat16 in the
program's place; the fault takes the program's image loss over the top
half of the image (``readings.half_image_loss``).  The numbers are the
kind's own (``traffic/scaffold.py``'s ``numbers``); the output is
``readings.py``'s.
"""

import os
import sys

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from gsbench import harness, readings, spec  # noqa: E402


def reading(cell, seed: int, device, kind: str) -> dict:
    """One reading of ``kind`` ("sound", "control" or "fault") on ``seed``."""
    run = harness.make(cell, seed, device)
    undo = None
    if kind == "fault":
        from gaussian_splatting_torch import trainer

        undo = readings.half_image_loss(trainer)
    try:
        state, prog = run.program()
        del state
        want = run.reference()
        if kind == "control":
            prog = run.reference(torch.bfloat16)
    finally:
        if undo is not None:
            undo()
    numbers = spec.load_module("traffic", cell.traffic["kind"]).numbers(prog, want)
    return dict(workload=cell.name, seed=seed, kind=kind, **numbers)


def main(argv=None) -> int:
    readings.reading = reading  # readings.py's loop and output, this kind's readings
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
