"""Run one cell of the benchmark once and print its result line.

    python3 snsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for.  The last line of standard output is the result (see
README.md); the numbers the check compared, each with its limit, are the
last lines of standard error.  ``--control bf16`` judges the reference
computed in bfloat16 in the program's place (the check's control)."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from snsbench import harness, spec
    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"snsbench: {a.workload} needs {cell['chips']} CUDA device(s); "
              f"found {have}", file=sys.stderr)
        return 2
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           t_start=T_START, control=a.control)
    found = harness.banned_modules()
    if found:
        print(f"snsbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
