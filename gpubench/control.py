"""Run a cell with its control, or one of the faults, in the program's
place, on the card, at the cell's own size, for several seeds in one
process:

    python3 -m gpubench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--fault <name>]

A line a seed on standard output: the seed, ``correct`` and each number
the check compared with its limit. The control (``faults.control``) has
to come out not correct on every seed. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json

from . import core, faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)

    _, _, _, mix = core.find_cell(core.load_spec(), args.workload)
    wrap = (faults.fault(args.fault, mix["check"]) if args.fault
            else faults.control(mix["check"]))
    for seed in map(int, args.seeds.split(",")):
        r = core.run_cell(args.workload, seed, args.seconds, False,
                          wrap=wrap)
        print(json.dumps({"seed": seed, "replacement": args.fault
                          or "control", "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
