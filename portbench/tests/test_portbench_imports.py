"""Nothing the benchmark loads brings in JAX or the JAX package: checked
in a fresh interpreter, by whole top-level module names."""

import subprocess
import sys

from portbench.tests.conftest import REPO

PROBE = """
import sys
import portbench.run, portbench.harness, portbench.control
import portbench.loops.client, portbench.loops.closed_check, portbench.loops.closed_batch
from portbench.harness import metric_reader, ROOT
for p in (ROOT / "metrics").glob("*.py"):
    metric_reader(p.name[:-3])
import keto_tpu_torch.driver  # what system.py boots
bad = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "keto_tpu"})
print("BAD" if bad else "OK", bad, "keto_tpu_torch" in sys.modules)
"""


def test_no_jax_and_no_keto_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "OK [] True", out.stdout


def test_forbidden_names_compare_whole(monkeypatch):
    from portbench.run import forbidden_modules

    modules = dict(sys.modules)
    monkeypatch.setattr(sys, "modules", {**modules, "keto_tpu_torch.x": None,
                                         "jaxtyping": None})
    assert forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**modules, "keto_tpu.engine": None, "jax": None})
    assert forbidden_modules() == ["jax", "keto_tpu"]
