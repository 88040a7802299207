"""The controls of `correct`, and faults planted in a run, read at a cell's
own size. Not run by the benchmark's runs: it is how the limits in
cells/<workload>.json were set (PERF.md gives the readings).

    python3 portbench/control.py --workload <name> --seeds 11 12 13 [--fault <fault>]

Without --fault, the control: the plain reference put in the program's
place and computed in the precision below the configuration's
(reference/lowprec.py), judged as a run judges the program; with
--trunk-only, in the dense blocks alone. With --fault,
a run of the cell with that fault planted in the program (kinds/<kind>.py
`FAULTS`), on a short window. With --program, sound runs of the cell on a
short window, one process for all the seeds (the lower readings). Prints
one JSON line a seed with the numbers.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse
    import json

    from portbench import correct, harness

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--program", action="store_true",
                   help="the program's own numbers instead (sound runs, one process)")
    p.add_argument("--trunk-only", action="store_true",
                   help="the control's lower precision in the dense blocks alone")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload, ROOT)
    kind = harness.driver(cell)
    for seed in args.seeds:
        if args.program:
            run = kind.run(cell, seed, args.seconds, False, "cuda", 0.0)
            numbers = run.numbers
            print("\n".join(run.notes[1:]), file=sys.stderr)
        elif args.fault is None:
            numbers = kind.control(cell, seed, "cuda", trunk_only=args.trunk_only)
        else:
            with kind.FAULTS[args.fault](cell):
                run = kind.run(cell, seed, args.seconds, False, "cuda", 0.0)
            numbers = run.numbers
        ok, _ = correct.judge(numbers, cell.limits)
        label = ("program" if args.program else args.fault
                 or ("trunk-only control" if args.trunk_only else "control"))
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": label,
                          "numbers": numbers, "correct": ok}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
