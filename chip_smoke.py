#!/usr/bin/env python3
"""Smoke run of keto_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--tuples N] [--checks N] [--oracle N]

Phases, in order; any failure exits non-zero:

1. build    compile every kernel in keto_tpu_torch/csrc with nvcc (sm_90a)
2. kernels  hold the masked-SpMV kernel against its plain PyTorch version,
            bitwise, at M in {256, 2048, 11520}, then a whole closure build
            with the kernel against one with the plain step (D byte-equal)
3. example  the cat-videos example and a depth-boundary chain on the card
4. main     an rbac1m store (1M tuples, the distribution of bench.py
            gen_rbac; BASELINE.json "Synthetic RBAC: 1M tuples",
            serve.read.max-depth 5), a ClosureCheckEngine on the card, a
            few thousand sampled checks; the kernel launch count of the full
            build, D against a plain-built D, answers against the host BFS
            oracle, then one interior and one leaf write and a re-check
5. numbers  kernel time per launch at the main path's shape beside its
            bound, the plain version and torch.matmul plus the mask (a
            yardstick only); full-build time; batch-check p50 and rate

The second-to-last line of output is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. Without CUDA, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"smoke check failed: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream (warmed)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_masks(gen, g, m, density, device):
    def bern(shape, p):
        return (
            torch.rand(shape, generator=gen, device=device) < p
        ).to(torch.bfloat16)

    f = bern((g, m), density)
    a = bern((m, m), density)
    r = torch.maximum(f, bern((g, m), density))
    f[0] = 0  # all-zero frontier row
    f[1] = 1  # all-one frontier row
    r[2] = 1  # fully reached row
    a[:, 3] = 0  # unreachable column
    a[4] = 1  # a node with an edge to every node
    return f.contiguous(), a.contiguous(), r.contiguous()


class IndexedTuples:
    """Read-only relationtuple.Manager over a columnar store's live edges,
    indexed by subject set: the host BFS oracle's view of the store without
    a full-column scan per query. Re-indexed when the store version moves."""

    def __init__(self, store):
        self.store = store
        self._version = None

    def _index(self):
        if self._version != self.store.version:
            src, dst, vocab, version = self.store.snapshot_ids()
            order = np.argsort(src, kind="stable")
            self._dst = dst[order]
            counts = np.bincount(src, minlength=len(vocab))
            self._indptr = np.concatenate([[0], np.cumsum(counts)])
            self._vocab = vocab
            self._version = version

    def get_relation_tuples(self, query, pagination=None):
        from keto_tpu_torch.relationtuple import RelationTuple
        from keto_tpu_torch.utils.pagination import (
            PaginationOptions,
            decode_page_token,
            encode_page_token,
        )

        self._index()
        pagination = pagination or PaginationOptions()
        nid = self._vocab.lookup((query.namespace, query.object, query.relation))
        if nid is None or nid + 1 >= len(self._indptr):
            return [], ""
        lo, hi = int(self._indptr[nid]), int(self._indptr[nid + 1])
        off = decode_page_token(pagination.token)
        per = pagination.per_page
        page = [
            RelationTuple(
                namespace=query.namespace,
                object=query.object,
                relation=query.relation,
                subject=self._vocab.subject_of(int(d)),
            )
            for d in self._dst[lo + off : min(hi, lo + off + per)]
        ]
        token = encode_page_token(off + per) if lo + off + per < hi else ""
        return page, token


def gen_rbac(n_tuples: int, rng: np.random.Generator):
    """users ∈ groups ∈ roles -> per-resource grants, with bench.py
    gen_rbac's pool sizes and edge mix, bulk-loaded into a columnar store.
    Returns the store, the key pools and the edges of each stage."""
    from keto_tpu_torch.store import ColumnarTupleStore

    def pool(items):
        arr = np.empty(len(items), dtype=object)
        arr[:] = items
        return arr

    n_users = max(n_tuples // 10, 100)
    n_groups = min(max(n_tuples // 100, 20), 20_000)
    n_roles = min(max(n_groups // 10, 5), 2_000)
    n_resources = max(n_tuples // 3, 50)
    users = pool([(f"u{i}",) for i in range(n_users)])
    groups = pool([("rbac", f"g{i}", "member") for i in range(n_groups)])
    roles = pool([("rbac", f"role{i}", "member") for i in range(n_roles)])
    resources = pool([("rbac", f"res{i}", "view") for i in range(n_resources)])
    store = ColumnarTupleStore()
    edges = {}

    def load(name, s, d):
        edges[name] = (s, d)
        store.bulk_load_edges(s.tolist(), d.tolist())

    k = int(n_tuples * 0.4)  # users -> groups
    load("membership", groups[rng.integers(n_groups, size=k)],
         users[rng.integers(n_users, size=k)])
    k = int(n_tuples * 0.1)  # groups -> roles
    load("group_role", roles[rng.integers(n_roles, size=k)],
         groups[rng.integers(n_groups, size=k)])
    k = min(int(n_tuples * 0.05), n_roles * n_roles // 2)  # role hierarchy
    load("role_role", roles[rng.integers(n_roles, size=k)],
         roles[rng.integers(n_roles, size=k)])
    grant_dst = pool(list(roles) + list(groups))
    grants_s, grants_d = [], []
    while len(store) < n_tuples:  # grants; top up collision losses
        k = n_tuples - len(store)
        s = resources[rng.integers(n_resources, size=k)]
        d = grant_dst[rng.integers(len(grant_dst), size=k)]
        store.bulk_load_edges(s.tolist(), d.tolist())
        grants_s.append(s)
        grants_d.append(d)
    edges["grant"] = (np.concatenate(grants_s), np.concatenate(grants_d))
    return store, {"users": users, "resources": resources}, edges


def to_tuple(src_key, dst_key):
    from keto_tpu_torch.relationtuple import RelationTuple, SubjectID, SubjectSet

    subject = (
        SubjectID(id=dst_key[0]) if len(dst_key) == 1 else SubjectSet(*dst_key)
    )
    return RelationTuple(*src_key, subject=subject)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tuples", type=int, default=1_000_000)
    ap.add_argument("--checks", type=int, default=4096)
    ap.add_argument("--oracle", type=int, default=256)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from keto_tpu_torch.engine import CheckEngine, ClosureCheckEngine
    from keto_tpu_torch.engine import masked_spmv
    from keto_tpu_torch.engine.closure import _m_pad_for
    from keto_tpu_torch.graph import SnapshotManager
    from keto_tpu_torch.ops.closure import pack_adjacency, unpack_adjacency
    from keto_tpu_torch.relationtuple import RelationTuple
    from keto_tpu_torch.store import InMemoryTupleStore
    from keto_tpu_torch.utils import kernels

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: full f32
    torch.backends.cudnn.allow_tf32 = False
    step = masked_spmv.masked_step
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t_all = time.perf_counter()

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = kernels.build()
    say(f"[build] {secs} wall={time.perf_counter() - t0:.3f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    say(card)

    # -- 2. kernel vs plain -----------------------------------------------------
    max_err = 0.0
    for m in (256, 2048, 11520):
        for density in (0.002, 0.05):
            f, a, r = random_masks(gen, 256, m, density, dev)
            kn, kr = step(f, a, r)
            pn, pr = masked_spmv.masked_step_plain(f, a, r)
            torch.cuda.synchronize()
            err = max(
                (kn.float() - pn.float()).abs().max().item(),
                (kr.float() - pr.float()).abs().max().item(),
            )
            max_err = max(max_err, err)
            require(
                torch.equal(kn, pn) and torch.equal(kr, pr),
                f"kernel != plain at M={m} density={density} (err {err})",
            )
    del f, a, r, kn, kr, pn, pr
    rng = np.random.default_rng(args.seed)
    m_small = 3000
    m_pad_small = _m_pad_for(m_small)
    n_e = 4 * m_small
    src = rng.integers(m_small, size=n_e)
    dst = rng.integers(m_small, size=n_e)
    packed = pack_adjacency(src, dst, m_pad_small)
    d_kernel = masked_spmv.build_closure_semiring(
        packed, m_small, m_pad=m_pad_small, k_max=4, device=dev
    )
    d_plain = masked_spmv.build_closure_semiring(
        packed, m_small, m_pad=m_pad_small, k_max=4, device=dev,
        step=masked_spmv.masked_step_plain,
    )
    require(torch.equal(d_kernel, d_plain), "kernel-built D != plain-built D")
    say(f"[kernels] bitwise equal at M=256,2048,11520; D equal at "
        f"m={m_small} m_pad={m_pad_small}; max_abs_err={max_err}")
    del d_kernel, d_plain

    # -- 3. cat-videos and the depth boundary ----------------------------------
    repo = Path(__file__).resolve().parent
    cat = InMemoryTupleStore()
    for path in sorted((repo / "contrib/cat-videos-example/relation-tuples").glob("*.json")):
        doc = json.loads(path.read_text())
        doc.pop("$schema", None)
        cat.write_relation_tuples(RelationTuple.from_dict(doc))
    expect = {
        "videos:/cats#owner@cat lady": True,
        "videos:/cats/1.mp4#owner@cat lady": True,
        "videos:/cats/1.mp4#view@cat lady": True,
        "videos:/cats/1.mp4#view@*": True,
        "videos:/cats/2.mp4#view@*": False,
    }
    cat_eng = ClosureCheckEngine(SnapshotManager(cat), device=dev)
    got = cat_eng.batch_check([RelationTuple.from_string(s) for s in expect])
    require(got == list(expect.values()), f"cat-videos answers {got}")
    chain = InMemoryTupleStore()
    chain.write_relation_tuples(
        *(RelationTuple.from_string(f"n:c{i}#m@(n:c{i + 1}#m)") for i in range(5)),
        RelationTuple.from_string("n:c5#m@alice"),
    )
    ch_eng = ClosureCheckEngine(SnapshotManager(chain), max_depth=5, device=dev)
    got = ch_eng.batch_check(
        [RelationTuple.from_string("n:c1#m@alice"),
         RelationTuple.from_string("n:c0#m@alice")]
    )
    require(got == [True, False], f"depth boundary 5/6 answers {got}")
    say("[example] cat-videos 5/5, depth boundary 5 allowed / 6 denied")

    # -- 4. main path at rbac1m -------------------------------------------------
    t0 = time.perf_counter()
    store, pools, edges = gen_rbac(args.tuples, rng)
    say(f"[main] store: {len(store)} tuples, {len(store.vocab)} nodes, "
        f"load {time.perf_counter() - t0:.3f}s")
    users, resources = pools["users"], pools["resources"]
    k = args.checks
    sample = [
        to_tuple(s, d)
        for s, d in zip(
            resources[rng.integers(len(resources), size=k)],
            users[rng.integers(len(users), size=k)],
        )
    ]
    mgr = SnapshotManager(store)
    eng = ClosureCheckEngine(mgr, max_depth=5, device=dev)
    oracle = CheckEngine(IndexedTuples(store), max_depth=5)

    masked_spmv.masked_step.launches = 0  # main path starts here
    t0 = time.perf_counter()
    allowed = eng.batch_check(sample)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    state = eng._state
    ig, m_pad = state.ig, state.m_pad
    expected = (m_pad // 256) * (5 - 2)  # groups x waves k = 2..k_max
    say(f"[main] interior m={ig.m} m_pad={m_pad} ii_edges={len(ig.ii_src)}; "
        f"first batch (build + {k} checks) {first_s:.3f}s, phases "
        f"{eng.last_build_phases}, allowed {sum(allowed)}/{k}")
    require(len(allowed) == k, "answer count")
    require(masked_spmv.masked_step.launches == expected,
            f"{masked_spmv.masked_step.launches} launches, expected {expected}")
    packed = pack_adjacency(ig.ii_src, ig.ii_dst, m_pad)
    d_plain = masked_spmv.build_closure_semiring(
        packed, ig.m, m_pad=m_pad, k_max=4, device=dev,
        step=masked_spmv.masked_step_plain,
    )
    require(torch.equal(state.d, d_plain), "rbac1m kernel D != plain D")
    del d_plain
    n_or = min(args.oracle, k)
    t0 = time.perf_counter()
    want = oracle.batch_check(sample[:n_or])
    bad = sum(a != b for a, b in zip(allowed[:n_or], want))
    say(f"[main] D byte-equal to plain; oracle {n_or} checks, "
        f"{sum(want)} allowed, {bad} disagree ({time.perf_counter() - t0:.1f}s)")
    require(bad == 0, f"{bad} answers disagree with the host oracle")

    # steady state: the resident closure answers batch after batch
    lat = []
    reps = 16
    for i in range(reps):
        batch = sample[i * 97 % k:] + sample[: i * 97 % k]
        t0 = time.perf_counter()
        eng.batch_check(batch)
        lat.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lat)) * 1e3
    rate = k * reps / sum(lat)

    # writes: a leaf edge (group -> new user), then an interior edge
    # (role -> role) that opens a path to a user four hops from a resource
    g_src, g_dst = edges["grant"]
    gi = next(i for i in range(len(g_src)) if g_dst[i][1].startswith("g"))
    res_g, grp = g_src[gi], g_dst[gi]
    store.write_relation_tuples(to_tuple(grp, ("smoke-user",)))
    probes = [to_tuple(res_g, ("smoke-user",))]
    got = eng.batch_check(probes + sample[:64])
    want = oracle.batch_check(probes + sample[:64])
    require(got == want and got[0], f"after leaf write: {got[:1]} vs {want[:1]}")
    gr_s, gr_d = edges["group_role"]
    mem_s, mem_d = edges["membership"]
    member_of = {}
    for s_key, d_key in zip(mem_s[:5000], mem_d[:5000]):
        member_of.setdefault(s_key, d_key)
    ri = next(i for i in range(len(gr_s)) if gr_d[i] in member_of)
    role_b, grp_b = gr_s[ri], gr_d[ri]
    user_b = member_of[grp_b]
    ai = next(i for i in range(len(g_src)) if g_dst[i][1].startswith("role")
              and g_dst[i] != role_b)
    res_a, role_a = g_src[ai], g_dst[ai]
    store.write_relation_tuples(to_tuple(role_a, role_b))
    probes = [to_tuple(res_a, user_b), to_tuple(res_a, grp_b)]
    got = eng.batch_check(probes + sample[:n_or])
    want = oracle.batch_check(probes + sample[:n_or])
    require(got == want, "answers after the interior write disagree with oracle")
    require(got[0], f"{probes[0]} should be allowed after the interior write")
    require(eng.n_full_builds == 1 and eng.n_incremental_builds == 2,
            f"builds full={eng.n_full_builds} incr={eng.n_incremental_builds}")
    launches = masked_spmv.masked_step.launches  # main path ends here
    require(launches == expected, f"{launches} launches after the writes")
    say(f"[main] writes: leaf + interior edge absorbed incrementally "
        f"(full={eng.n_full_builds}, incremental={eng.n_incremental_builds}); "
        f"{len(want)} re-checks equal the oracle")

    # -- 5. numbers -------------------------------------------------------------
    adj = unpack_adjacency(packed, m_pad, dev)
    f = adj[:256]
    r = f
    kern_ms = cuda_ms(lambda: step(f, adj, r), 20)
    plain_ms = cuda_ms(lambda: masked_spmv.masked_step_plain(f, adj, r), 5)

    def library():
        nxt = (f @ adj) > 0.5
        nb = nxt.to(torch.bfloat16)
        return nb * (1 - r), torch.maximum(r, nb)

    lib_ms = cuda_ms(library, 20)
    g, m = f.shape
    bytes_moved = (2 * g * m + m * m) * 2 + 2 * g * m * 2
    ops = 2 * g * m * m
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    build_ms = cuda_ms(
        lambda: masked_spmv.build_closure_semiring(
            packed, ig.m, m_pad=m_pad, k_max=4, device=dev
        ),
        3,
    )
    say(f"[numbers] card: {card}")
    say(f"[numbers] masked_spmv [{g}, {m}] x [{m}, {m}]: kernel {kern_ms:.4f} ms"
        f"/launch, bound {bound_ms:.4f} ms ({bound_by}), plain f32 "
        f"{plain_ms:.4f} ms, torch.matmul+mask {lib_ms:.4f} ms")
    say(f"[numbers] full build ({expected} launches + unpack) {build_ms:.3f} ms;"
        f" batch_check {k}: p50 {p50_ms:.3f} ms, {rate:.0f} checks/s")
    say(f"[numbers] total {time.perf_counter() - t_all:.1f}s")
    say(json.dumps({"kernels": [{
        "name": "masked_spmv",
        "route": "cuda",
        "source": "keto_tpu_torch/csrc/masked_spmv.cu",
        "replaces": "keto_tpu/engine/pallas_spmv.py:66",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
