"""The readings a cell's limits are set from, without a measured window:

    python3 gsbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--fault 1,2,3]

For each seed of ``--seeds``, the numbers ``correct`` compares between the
program's outcome and the plain reference's (a sound run); for each seed of
``--control``, the same numbers with the reference computed in bfloat16 put
in the program's place (the control); for each seed of ``--fault``, with
the program's loss taken over half of the image, the mean over the rest (a
training cell's planted fault).  One JSON line per reading on standard
output and in ``chiprun_out/readings/<cell>.jsonl``, then the largest sound
reading and the smallest control and fault readings of each number.
"""

import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from gsbench import check, harness, spec  # noqa: E402


def half_image_loss(trainer):
    """Plant the fault: the program's loss over the top half of the image."""
    full = trainer.train_loss

    def loss(image, gt, ssim_frac):
        h = image.shape[0] // 2
        return full(image[:h], gt[:h], ssim_frac)

    trainer.train_loss = loss
    return lambda: setattr(trainer, "train_loss", full)


def reading(cell, seed: int, device, kind: str) -> dict:
    """One reading of ``kind`` ("sound", "control" or "fault") on ``seed``."""
    run = harness.make(cell, seed, device)
    train = cell.traffic["kind"] == "train"
    undo = None
    if kind == "fault":
        from gaussian_splatting_torch import trainer

        undo = half_image_loss(trainer)
    try:
        if train:
            state, prog = run.program()
            del state
            ref = run.reference()
            if kind == "control":
                prog = run.reference(torch.bfloat16)
            numbers = check.train_numbers(prog, ref)
        else:
            prog = run.program()
            idx = sorted(prog)
            ref = run.reference(idx)
            if kind == "control":
                prog = run.reference(idx, torch.bfloat16)
            numbers = check.serve_numbers(prog, ref)
    finally:
        if undo is not None:
            undo()
    return dict(workload=cell.name, seed=seed, kind=kind, **numbers)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    cell = spec.load_cell(args.workload)
    out_dir = os.path.join("chiprun_out", "readings")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    with open(os.path.join(out_dir, f"{cell.name}.jsonl"), "a") as log:
        for kind, seeds in (("sound", args.seeds), ("control", args.control),
                            ("fault", args.fault)):
            for s in filter(None, seeds.split(",")):
                t0 = time.perf_counter()
                r = reading(cell, int(s), device, kind)
                r["seconds"] = time.perf_counter() - t0
                rows.append(r)
                line = json.dumps(r)
                print(line, flush=True)
                log.write(line + "\n")
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    names = [k for k in rows[0] if k not in ("workload", "seed", "kind", "seconds")] if rows else []
    for kind, pick in (("sound", max), ("control", min), ("fault", min)):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            print(json.dumps({"summary": kind, "seeds": len(got),
                              **{k: pick(r[k] for r in got) for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
