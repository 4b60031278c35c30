"""The correctness control, run on the card at the cell's own size (the
benchmark's runs never run it):

    python -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 10

The system states no floating-point precision; the guarantee it states is
``serve.read.max-depth`` 5. The control is the program's own path with one
step less, ``serve.read.max-depth`` 4, judged against the reference at 5:
it has to come out not correct on every seed. Prints one JSON line per
seed with the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import sys

from .harness import REPO, run_cell
from .graph import load_json


def control_overrides(cfg: dict) -> dict:
    return {"serve.read.max-depth": int(cfg["program"]["serve"]["read"]["max-depth"]) - 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = load_json(REPO / next(c["file"] for c in bench["configs"] if c["name"] == cell["config"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       overrides=control_overrides(cfg),
                       log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "max-depth 4",
                          "correct": out["correct"], "compared": out["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
