"""Readings for the limits of `correct`: a cell's compared numbers on many
seeds, for the sound program and for a variant (the precision control or a
planted fault, faults.py), in one process on the card.

    python3 -m benchmark.control --workload kitti_gn --seeds 11,12,13 \
        --seconds 20 [--variants none,tf32] [--out chiprun_out/control.json]

Each (seed, variant) is one run of the cell as run.py makes it, at the
cell's own sizes, with a window of `--seconds`. Prints one JSON line per run
and, last, {variant: {number: [reading per seed]}} over every number the
check reads (those without a limit too). The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import io
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--variants", default="none,tf32")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import run

    table: dict = {}
    for variant in args.variants.split(","):
        for seed in args.seeds.split(","):
            buf = io.StringIO()
            rc = run.main(["--workload", args.workload, "--seed", seed, "--seconds", str(args.seconds),
                           "--trace", "0", "--device", args.device], out=buf,
                          variant=None if variant == "none" else variant)
            lines = buf.getvalue().strip().splitlines()
            line = json.loads(lines[-1]) if rc == 0 else {"rc": rc}
            numbers = json.loads(lines[-2])["numbers"] if rc == 0 else {}
            print(json.dumps({"variant": variant, "seed": seed, "numbers": numbers, **line}), flush=True)
            for name, value in numbers.items():
                table.setdefault(variant, {}).setdefault(name, []).append(value)
            table.setdefault(variant, {}).setdefault("correct", []).append(line.get("correct"))
    print(json.dumps(table), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
