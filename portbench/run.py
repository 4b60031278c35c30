"""Run one cell of ``BENCHMARK.json`` once:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (end to end with ``--trace 0``,
per layer with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the correctness check
compared, beside its limit. The same numbers are the last lines of
standard error. Exits non-zero, printing no result, without the cards, or
when ``jax``, ``jaxlib``, ``flax`` or ``keto_tpu`` was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".portbench-cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "keto_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: ``keto_tpu_torch`` is not ``keto_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel and build caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from portbench.harness import run_cell

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START, log=log)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    if args.trace:
        try:
            import subprocess

            limit = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            limit = "unknown"
        log(f"portbench: card and power limit: {limit}; roofline shares are of the "
            f"data-sheet peaks at 700 W")
    sys.stderr.flush()
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
