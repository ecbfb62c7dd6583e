"""Run one cell of the benchmark once, on the card:

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
run's JSON result; everything else goes to standard error, whose last
lines are the numbers that decide ``correct``, each beside its limit. A
run sees exactly the cards the cell asks for (the first of those
visible). A run without a CUDA device, with fewer devices than the cell
asks for or cards of more than one kind, or that finds a module of the
JAX stack or the JAX package loaded once the window has closed, exits
with another code than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import core

    try:
        result = core.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    except (core.NoCard, core.ForbiddenModule) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {str(result['correct']).lower()}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
