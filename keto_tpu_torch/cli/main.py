"""The keto_tpu_torch command line (counterpart of ``keto_tpu/cli/main.py``,
on ``argparse``).

    python -m keto_tpu_torch.cli serve -c config.json [--workers N]

``serve`` builds a Registry from the config file (JSON or TOML), warms the
check engine up on the CUDA card, starts the read and write planes, and
stops them gracefully on SIGINT or SIGTERM. ``--workers N`` serves the read
port from N processes (forked read replicas sharing it through
SO_REUSEPORT, the closure engine in host query mode); 0 keeps the config's
``serve.read.workers``. The gRPC client commands of the reference wait for
ROADMAP 14.3.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional, Sequence


def serve(config_file: Optional[str], workers: int = 0) -> int:
    """Start the read (:4466) and write (:4467) servers."""
    from ..driver import Config, Registry

    values = {"serve": {"read": {"workers": workers}}} if workers > 0 else None
    registry = Registry(Config(values=values, config_file=config_file))
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
    p_serve.add_argument(
        "--workers", type=int, default=0,
        help="read-replica processes sharing the read port via SO_REUSEPORT "
        "(0 = use serve.read.workers from the config)",
    )
    args = ap.parse_args(argv)
    if args.command == "serve":
        return serve(args.config_file, args.workers)
    return 2


if __name__ == "__main__":
    sys.exit(main())
