"""How ``correct`` is decided, on the CPU at a size a test run holds: the
harness's run with the card's look skipped (``device="cpu"``), a sound
program comes out correct through each loop kind; the control
(``serve.read.max-depth`` 4 against the reference at 5) and each fault
planted in the timed path come out not correct."""

import copy

import numpy as np
import pytest

from portbench.harness import run_cell
from portbench.tests.conftest import load

# a sparse role hierarchy, so that many checks need the whole depth of 5:
# resource -> role -> role -> role -> group -> user
DEEP = {
    "tuples": 3000,
    "pools": [
        {"name": "users", "prefix": "u", "count": 400},
        {"name": "groups", "namespace": "rbac", "prefix": "g", "relations": ["member"], "count": 40},
        {"name": "roles", "namespace": "rbac", "prefix": "role", "relations": ["member"], "count": 40},
        {"name": "resources", "namespace": "rbac", "prefix": "res", "relations": ["view"], "count": 400},
    ],
    "edges": [
        {"name": "membership", "share": 0.4, "src": "groups", "dst": {"users": 1}},
        {"name": "group_role", "share": 0.03, "src": "roles", "dst": {"groups": 1}},
        {"name": "role_role", "share": 0.013, "src": "roles", "dst": {"roles": 1}},
        {"name": "grant", "fill": True, "src": "resources", "dst": {"roles": 1}},
    ],
}
DEEP_ROWS = [{"share": 0.5, "path": ["grant", "role_role", "role_role", "group_role",
                                      "membership"]},
             {"share": 0.5}]
# each loop kind, at a size a test run holds, on the closure path
BATCH = {**load("traffic/batch_collab.json"), "batch_rows": 512, "warmup_batches": 1,
         "procs": 2, "clients": 2}
CHECK = {**load("traffic/check.json"), "connections": 8, "procs": 1, "warmup_requests": 2}
LOOPS = {"closed_batch": BATCH, "closed_check": CHECK}


def _run(bench, traffic, overrides=None, seconds=2.0):
    # the cell entry gives only the chips: the graph is DEEP, on the closure path
    cfg = {**copy.deepcopy(load("configs/rbac1m.json")), **copy.deepcopy(DEEP)}
    tr = {**traffic, "rows": DEEP_ROWS, "judge_rows": 2000, "grace_seconds": 10}
    return run_cell(bench, "github10m.batch", 424242, seconds, False, device="cpu",
                    overrides=overrides, config=cfg, traffic=tr, log=lambda m: None)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_sound_runs_are_correct(bench, loop):
    out = _run(bench, LOOPS[loop])
    assert out["correct"], out["compared"]
    assert out["compared"]["wrong_answers"]["value"] == 0
    assert out["metrics"]["checks_per_s"]["value"] > 0


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_control_depth_four_is_not_correct(bench, loop):
    out = _run(bench, LOOPS[loop], overrides={"serve.read.max-depth": 4})
    assert not out["correct"]
    assert out["compared"]["wrong_answers"]["value"] > 0


def _patch_answers(monkeypatch, alter):
    from keto_tpu_torch.engine.closure import ClosureCheckEngine

    real = ClosureCheckEngine._check_arrays

    def broken(self, *args, **kwargs):
        return alter(np.array(real(self, *args, **kwargs), dtype=bool))

    monkeypatch.setattr(ClosureCheckEngine, "_check_arrays", broken)


def _flip_every_third(a):
    a[::3] = ~a[::3]
    return a


def _half_left_out(a):
    a[len(a) // 2:] = False
    return a


@pytest.mark.parametrize("alter", [_flip_every_third, _half_left_out],
                         ids=["answer-altered", "half-the-batch-left-out"])
def test_faults_in_the_timed_path_are_not_correct(bench, monkeypatch, alter):
    _patch_answers(monkeypatch, alter)
    out = _run(bench, BATCH)
    assert not out["correct"]
    assert out["compared"]["wrong_answers"]["value"] > 0


def test_single_check_answer_altered_is_not_correct(bench, monkeypatch):
    _patch_answers(monkeypatch, lambda a: ~a)
    out = _run(bench, CHECK)
    assert not out["correct"]


def test_unanswered_requests_are_not_correct():
    """A request with no valid answer counts, whatever the others say."""
    from portbench import judge

    counts, attempted, failed, judged = judge.judge_run(
        None, 5, np.random.default_rng(1), 10,
        [{"client": 0, "i": 0, "rows": 1, "allowed": np.zeros(0, np.int8)}], None)
    assert counts == {"wrong_answers": 0, "unanswered": 1}
    assert (attempted, failed, judged) == (1, 1, 0)
    assert not judge.verdict(counts)[0]
