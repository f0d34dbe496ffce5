"""`python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.

Runs one cell of `BENCHMARK.json` once on the card and prints the result
as one JSON line, the last line of standard output; each number that
decided `correct` is printed beside its limit as the last lines of
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits 2; it exits 3 if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    from harness import guard, runner
    from harness.manifest import Manifest

    manifest = Manifest.load()
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card is available; nothing is measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = runner.run(cell, manifest, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), device=torch.device("cuda", 0), t0=t0)
    found = guard.forbidden_loaded()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
