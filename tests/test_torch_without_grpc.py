"""keto_tpu_torch where grpc and protobuf do not import, on the CPU.

A subprocess hides ``grpc`` and ``google.protobuf`` (``sys.modules[name] =
None``), imports every port module outside the gRPC plane (all but the
CLI's ``__main__``, which would run the CLI), then brings a
``Registry(device="cpu")`` up and answers the cat-videos checks over REST.
``grpc_enabled`` must be false, exactly one log line must say that gRPC is
off and why (every other line is a request's ``http`` line), no module of the gRPC plane may have been imported, and a
config that sets a ``grpc-max-message-size`` must raise naming the missing
package instead of being ignored.

The client and the CLI, in a second subprocess with the same two packages
hidden: ``keto_tpu_torch.client`` imports, ``RestClient`` checks against a
REST-only server, ``GrpcClient`` is the one name that fails (naming grpc),
and ``cli check`` exits non-zero with a message naming grpc.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, json, logging, sys, urllib.request
from pathlib import Path

for name in ("grpc", "google.protobuf"):
    sys.modules[name] = None
repo = Path(sys.argv[1])
sys.path.insert(0, str(repo))

api = repo / "keto_tpu_torch" / "api"
plane = {api / n for n in ("services.py", "interceptors.py", "reflection.py",
                           "convert.py", "grpc_servers.py")} | {
    repo / "keto_tpu_torch" / "client" / "grpc_client.py",
    repo / "keto_tpu_torch" / "cli" / "remote.py",
}
imported = 0
for path in sorted((repo / "keto_tpu_torch").rglob("*.py")):
    if path in plane or (api / "gen") in path.parents or path.name == "__main__.py":
        continue
    rel = path.relative_to(repo).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    importlib.import_module(".".join(parts))
    imported += 1

records = []
handler = logging.Handler()
handler.emit = records.append
logging.getLogger("keto_tpu_torch").addHandler(handler)

from keto_tpu_torch.driver import Config, Registry
from keto_tpu_torch.utils.errors import ErrMalformedInput

base = {
    "namespaces": [{"id": 1, "name": "videos"}],
    "serve": {"read": {"port": 0, "host": "127.0.0.1"},
              "write": {"port": 0, "host": "127.0.0.1"}},
}
reg = Registry(Config(values=base), device="cpu")
read, write = reg.start_all()
try:
    for f in sorted((repo / "contrib/cat-videos-example/relation-tuples").glob("*.json")):
        doc = json.loads(f.read_text())
        doc.pop("$schema", None)
        req = urllib.request.Request(f"http://127.0.0.1:{write}/relation-tuples",
                                     data=json.dumps(doc).encode(), method="PUT")
        assert urllib.request.urlopen(req, timeout=60).status == 201
    answers = []
    for obj, rel, sub in (("/cats", "owner", "cat%20lady"),
                          ("/cats/1.mp4", "view", "cat%20lady"),
                          ("/cats/1.mp4", "view", "*"), ("/cats/2.mp4", "view", "*")):
        url = (f"http://127.0.0.1:{read}/check?namespace=videos&object={obj}"
               f"&relation={rel}&subject_id={sub}")
        try:
            answers.append(json.loads(urllib.request.urlopen(url, timeout=60).read()))
        except urllib.error.HTTPError as e:
            answers.append((e.code, json.loads(e.read())))
finally:
    reg.stop_all()

sized = dict(base, serve={**base["serve"], "read": {**base["serve"]["read"],
                                                    "grpc-max-message-size": 1 << 20}})
try:
    Registry(Config(values=sized), device="cpu").start_all()
    raised = None
except ErrMalformedInput as e:
    raised = e.message

print(json.dumps({
    "imported": imported,
    "grpc_enabled": reg.grpc_enabled,
    "logs": [r.getMessage() for r in records],
    "plane_loaded": sorted(m for m in sys.modules if m.startswith((
        "keto_tpu_torch.api.services", "keto_tpu_torch.api.grpc_servers",
        "keto_tpu_torch.api.convert", "keto_tpu_torch.api.gen",
        "keto_tpu_torch.api.reflection", "keto_tpu_torch.api.interceptors",
        "keto_tpu_torch.client.grpc_client", "keto_tpu_torch.cli.remote"))),
    "answers": answers,
    "raised": raised,
}))
"""


def test_the_port_serves_rest_alone_without_grpc_and_protobuf():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["imported"] > 40
    assert doc["grpc_enabled"] is False
    # one line says why gRPC is off; every other is a request's http line
    other = [m for m in doc["logs"] if m != "http"]
    assert len(other) == 1, doc["logs"]
    assert "gRPC is off" in other[0] and "grpc" in other[0]
    assert doc["logs"].count("http") == len(doc["logs"]) - 1 >= 4
    assert doc["plane_loaded"] == []
    assert doc["answers"] == [
        {"allowed": True}, {"allowed": True}, {"allowed": True},
        [403, {"allowed": False}],
    ]
    assert doc["raised"] and "serve.read.grpc-max-message-size" in doc["raised"]
    assert "grpc" in doc["raised"]


CLIENT_SCRIPT = r"""
import contextlib, io, json, sys
from pathlib import Path

for name in ("grpc", "google.protobuf"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])

import keto_tpu_torch.client as client
from keto_tpu_torch.cli.main import main
from keto_tpu_torch.driver import Config, Registry

reg = Registry(Config(values={
    "namespaces": [{"id": 1, "name": "videos"}],
    "serve": {"read": {"port": 0, "host": "127.0.0.1"},
              "write": {"port": 0, "host": "127.0.0.1"}},
}), device="cpu")
read, write = reg.start_all()
try:
    with client.RestClient(f"http://127.0.0.1:{read}", f"http://127.0.0.1:{write}") as c:
        c.create_relation_tuple("videos:/cats#owner@cat lady")
        answers = [c.check("videos:/cats#owner@cat lady").allowed,
                   c.check("videos:/cats#owner@dog guy").allowed]
    try:
        client.GrpcClient
        grpc_client = None
    except ImportError as e:
        grpc_client = str(e)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["--read-remote", f"127.0.0.1:{read}",
                   "check", "cat lady", "owner", "videos", "/cats"])
finally:
    reg.stop_all()
print(json.dumps({"answers": answers, "grpc_client": grpc_client, "rc": rc,
                  "stderr": err.getvalue(), "grpc_enabled": reg.grpc_enabled}))
"""


def test_the_client_and_the_cli_without_grpc_and_protobuf():
    proc = subprocess.run(
        [sys.executable, "-c", CLIENT_SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["grpc_enabled"] is False
    assert doc["answers"] == [True, False]
    assert doc["grpc_client"] and "grpc" in doc["grpc_client"]
    assert doc["rc"] != 0
    assert doc["stderr"].startswith("Error: ") and "grpc" in doc["stderr"]
