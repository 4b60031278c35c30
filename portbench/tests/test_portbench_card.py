"""One short run of a cell on a CUDA card: the result line as a caller
reads it. Skips without a card; run on the card's machine with
``pytest portbench/tests -m cuda``."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_one_run_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "github10m.batch",
                          "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"checks_per_s", "batch_p95_ms", "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")


def test_without_a_card_no_result_is_printed():
    """Where torch finds no card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "github10m.batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
