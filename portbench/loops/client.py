"""A load-generating process: ``python -m portbench.loops.client``.

Protocol on its standard streams, with the harness that started it: the
harness writes two pickles, the plan every client shares and this
client's own part, then, once the program serves, one JSON line with its
ports; the client runs its loop's warm-up and prints ``ready``; the
harness writes the window's start (``time.monotonic()``); the client runs
its loop and writes its pickled records. It imports neither torch nor the
program.
"""

from __future__ import annotations

import json
import pickle
import sys

from . import load


def main() -> int:
    stdin, out = sys.stdin.buffer, sys.stdout.buffer
    plan = pickle.load(stdin)
    plan.update(pickle.load(stdin))
    loop = load(plan["traffic"]["loop"])
    plan.update(json.loads(stdin.readline()))
    try:
        loop.warm(plan)
    except RuntimeError as e:
        print(f"warm-up: {e}", file=sys.stderr)
        return 1
    out.write(b"ready\n")
    out.flush()
    t0 = float(stdin.readline())
    end = t0 + float(plan["seconds"])
    res = loop.run(plan, t0, end, end + float(plan["grace"]))
    pickle.dump(res, out, protocol=pickle.HIGHEST_PROTOCOL)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
