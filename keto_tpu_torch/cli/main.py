"""The keto_tpu_torch command line (counterpart of ``keto_tpu/cli/main.py``,
on ``argparse``).

    python -m keto_tpu_torch.cli serve -c config.json

``serve`` builds a Registry from the config file (JSON or TOML), warms the
check engine up on the CUDA card, starts the read and write REST planes,
and stops them gracefully on SIGINT or SIGTERM. The gRPC client commands
of the reference wait for the gRPC plane.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional, Sequence


def serve(config_file: Optional[str]) -> int:
    """Start the read (:4466) and write (:4467) servers."""
    from ..driver import Config, Registry

    registry = Registry(Config(config_file=config_file))
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda _signum, _frame: stop.set())
    read_port, write_port = registry.start_all()
    print(f"read API serving on :{read_port} (REST)", flush=True)
    print(f"write API serving on :{write_port} (REST)", flush=True)
    stop.wait()
    print("shutting down gracefully...", flush=True)
    registry.stop_all()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="keto_tpu_torch",
        description="keto_tpu_torch — Zanzibar-style permission server on CUDA.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    p_serve = sub.add_parser(
        "serve", help="start the read (:4466) and write (:4467) REST servers"
    )
    p_serve.add_argument("--config", "-c", dest="config_file", default=None)
    args = ap.parse_args(argv)
    if args.command == "serve":
        return serve(args.config_file)
    return 2


if __name__ == "__main__":
    sys.exit(main())
