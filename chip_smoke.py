#!/usr/bin/env python3
"""Smoke run of keto_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--tuples N] [--gh-tuples N]
                          [--checks N] [--oracle N]

Phases, in order; any failure exits non-zero:

1. build    compile every kernel in keto_tpu_torch/csrc with nvcc (sm_90a),
            one nvcc per source, all started together; build the native
            host tier (keto_tpu_torch/native/_hotpath.c) with gcc into
            keto_tpu_torch/_build/ and fail unless it loads and its tuple
            hash is this interpreter's
2. kernels  hold the masked-SpMV kernel (B1) against its plain PyTorch
            version, bitwise, at G 256 and M in {256, 2048, 11520}, at
            G 128 and M in {128, 384} (ragged 96-column stripes, CTAs that
            only pad the grid to whole clusters), and at the largest
            interior, M 17152, where an all-one row meets an all-one
            column and the count reaches M; then a whole closure build
            with the kernel against one with the plain step (D
            byte-equal); hold the packed-propagate kernel (B2) against
            its plain version, bitwise, at W in {128, 256} (rows with no
            in-edge, duplicate edges, a hub row with thousands of in-edges,
            probe and padding edges, the dummy row) and at N_pad 2^20
3. example  the cat-videos example and a depth-boundary chain on the card,
            through ClosureCheckEngine and through DeviceCheckEngine in the
            dense, scatter and packed modes; the cat-videos Expand through
            SnapshotExpandEngine and the host ExpandEngine
4. main     (closure) an rbac1m store (1M tuples, the distribution of
            bench.py gen_rbac; BASELINE.json "Synthetic RBAC: 1M tuples",
            serve.read.max-depth 5), a ClosureCheckEngine on the card, a
            few thousand sampled checks; the kernel launch count of the full
            build, D against a plain-built D, answers against the host BFS
            oracle (the first --oracle of them), then a leaf and an interior
            insert and delete, each
            absorbed by the write overlay and re-checked against the
            oracle, and the patched D against a plain build of the written
            snapshot;
            B1 numbers: time per launch at the main path's shape beside its
            bound (TFLOP/s and share of the bound), the plain version and
            torch.matmul plus the mask (a yardstick only); full-build time,
            and the same build with the wave step an identity (the unpack
            and distance fills alone); batch-check p50 and rate;
            [main:closure host], on the same store: the closure engine in
            host query mode (the numpy semiring build, no card) with D
            byte-equal to a B1 build of the same snapshot, host batches
            beside the device path's, device_view() answers, the matmul
            builder in host mode (built on the card, downloaded once), the
            placement probe's round trip and auto's choice (device), and a
            role -> role delete absorbed by the overlay and folded by the
            dirty-row rebuild, D and the carried D^T equal to a full host
            build; no B1 or B2 launch on this path;
            [native], after both: the native tier's call sites that took
            the C path over the phase (request_hashes, probe_index,
            closure_check must each have), then on the 4096 sample, the
            encode and the whole batch in device and in host query mode,
            each with the C tier and with its numpy twin (native.lib None
            for the call), 20 of each in turns: p50 ms and the ratio;
            every answer equal across the twins, the card's check_ids and
            the set-graph oracle
5. main     (packed) a github10m store (10M tuples, the pools and edge mix
            of bench.py gen_github; BASELINE.json "GitHub-style
            org/team/repo ACL: 10M tuples"), whose interior is above the
            closure limit, served by DeviceCheckEngine(mode="packed") on
            the card: 4096 repo#pull checks against the same loop with the
            plain propagate and the first --oracle against the host BFS
            oracle, the launch
            count against the loop's iterations, one write and a re-check;
            B2 against its plain version on the real edges; B2 numbers:
            time per launch beside its bound and the plain version, packed
            batch p50 and rate, peak device memory; then the packed
            engine behind the check batcher: the sample as single checks
            from 512 submitter threads through the pipelined batcher
            (pipeline_depth 2, encode_workers 2, the encoded cache on) and
            the serial one, answers equal to the phase's, checks/s, mean
            batch, most batches in flight, B2 launches, peak memory; one
            check_batch_encoded of the sample's ids twice, the second
            answered by the encoded cache with no B2 launch; [native]: the
            batch's encode (GraphSnapshot.encode_requests) with the C tier
            and with numpy, p50 of 20 in turns, ids and answers equal
6. serve    the serving seam at rbac1m: Registry(Config(...)) on the card
            with a columnar store, start_all (one closure build: 135 B1
            launches), then over HTTP (urllib, a thread pool): the
            cat-videos drive, 4096 sampled checks as POST /check/batch and
            as single GET /check from 64 clients, a leaf and an interior
            insert and delete each followed by a check that must reflect
            it, 1000 mixed random writes and 256 checks after them, every
            answer against a host oracle; no rebuild, exactly 135 B1
            launches, no B2 launch; then bounded freshness after a bulk
            load (stale answers with the old snaptoken, a new-snaptoken
            check that waits for the swap). Numbers: single-check p50/p99
            and rate at 64 clients, /check/batch p50 and rate, the mean
            batch the batcher formed, write-to-visible and overlay apply
            time per write class, bulk load to swap, peak device memory;
            on the same server, after the single checks (engine.cache_size
            0, as before the cache existed): the sample as a columnar
            /check/batch and as /check/batch-encoded frames from a VocabCache
            bootstrapped over /vocab/snapshot, answers equal to the oracle,
            p50 and rate; a write that interns a key, the stale frame's 409,
            sync over /vocab/deltas and the resend against the oracle;
            [serve:expand+list], on the same server after the mixed writes:
            the first list query (it rebuilds the closure: its B1 launches,
            its phases, the D^T transpose and the reverse CSRs), 64
            list-objects and 64 list-subjects over REST (8 of each equal to
            the card's check_ids over every resource or user, 2 of each
            against a host oracle on 256 candidates), one paged list-objects
            equal to the unpaged one and a 409 for its token after a write,
            64 GET /expand of rbac resources at max-depth 5 (16 node for
            node against the host ExpandEngine, 4 paged and stitched);
            every list answered by the reverse path. Numbers: list and
            expand p50/p99, items and tree nodes, the first list's split,
            peak device memory with D^T; last, a server with the default
            engine.cache_size: the sample as GET /check from 64 clients
            twice (hit share and p50 of each pass), then a write that flips
            a sampled answer and its delete, each seen by the next GET;
            [grpc], after the cat-videos drive: Check and Expand over gRPC
            on the muxed read port against the REST answers where grpc and
            protobuf import, else a line saying the plane is off and REST
            served alone
7. serve:overload  a fourth rbac1m server (engine.cache_size 0,
            overload.enabled, the OVERLOAD settings below): the serve
            phase's sample as GET /check from 256 clients of another
            process, request i with X-Request-Criticality critical, default
            or sheddable by i mod 3; every 200/403 equals the oracle, every
            429 carries Retry-After, critical gets no 429, sheddable is shed
            at least as often as default, the ladder reaches a shedding
            rung; after four quiet hysteresis windows it reads rung 0 and
            64 checks from one client get no 429. Numbers: the 429 share
            and accepted p50/p99 per class, accepted checks/s, transitions,
            the highest rung, the limiter's final limit, B1 launches
8. serve:pool  the read port from POOL_WORKERS processes: this script
            re-run with --pool-server in a fresh interpreter (the fork must
            not start from this process's threads) generates the serve
            phase's rbac1m store and calls start_all with
            serve.read.workers 4 and engine.cache_size 0 (host query mode,
            forked read replicas on one SO_REUSEPORT port); the serve
            phase's sample as GET /check from 64 clients in one client
            process (as the single-process drive) and in four, and from 256
            clients in four, every answer the oracle's; one list-objects
            and one Expand, 8 times each over fresh connections, equal to
            the server's check_ids over every resource and its host
            ExpandEngine; one replica SIGKILLed, respawned from the zygote,
            1024 answers after it the oracle's; a leaf insert and a role ->
            role delete on the write port, each followed by 24 consecutive
            agreeing fresh-connection checks; stop_all leaves no process.
            Numbers: p50/p99 and checks/s per drive beside the
            single-process drive's, host build and start_all, respawn
            time, write-to-visible over the pool, RSS and PSS per process
            after the writes, os.cpu_count(); 0 B1 and 0 B2 launches in the
            server
9. serve:wire  two more --pool-server interpreters at rbac1m, host query
            mode, cache off: serve.read.wire_workers WIRE_WORKERS with
            workers 1 (WIRE_WORKERS accept processes whose encoded frames
            reach the parent's one batcher over the shared-memory ring) and
            a single-process server; the sample as encoded frames of
            WIRE_ROWS rows from a VocabCache, WIRE_REPEATS times a drive,
            WIRE_DRIVES drives of each server in turns, from 64 clients in
            4 client processes started together, every answer the
            oracle's and ring frames counted; on the wire server a leaf
            insert, a frame from before it 409 from every process until
            the client resyncs and the resent frame showing the insert, a
            SIGKILLed wire worker retiring its lane alone and respawned,
            the frames after it right and still crossing the ring; no
            demotion to one process, stop_all leaves no process. Numbers:
            frames/s (median and range over the drives, with the drive's
            seconds), checks/s, p50/p99 of each server and the ratio,
            respawn time, os.cpu_count(); 0 B1 and 0 B2 launches
10. persist  rbac1m (the serve phase's generator and seed) loaded through the
            port's SQL store (SQLiteTupleStore, sqlite://<tmpdir>/keto.db) in
            chunks of PERSIST_CHUNK, then a Registry on that DSN in the
            default closure mode on the card: start_all split into the SQL
            read (the store's own snapshot()), the snapshot encode, the
            interior and the B1 build (its launches); the serve phase's 4096
            sample in process and over POST /check/batch equal to its
            set-graph oracle, a prefix equal to the host CheckEngine over
            the SQL store; PERSIST_WRITES mixed writes over REST (leaf
            inserts and deletes, group joins, group -> group inserts and
            deletes), each seen by the next GET /check (write-to-visible
            p50/p99); the database reopened in a fresh store holds every
            acked write. [persist:spawn]: the same database behind
            serve.read.workers SPAWN_WORKERS (spawned workers, host query
            mode), the sample as GET /check from 64 clients in 4 client
            processes equal to [persist]'s answers; checks/s, p50/p99, each
            process's RSS and card memory (nvidia-smi --query-compute-apps),
            each worker's boot seconds and whether it initialised CUDA; then
            KETO_WORKER_ALLOW_ACCEL=1 with 2 workers: the spawned worker
            builds D with B1 on the card in its own context (its ready line)
11. durable  this script re-run with --durable-server DIR (fresh
            interpreters): rbac1m on a columnar store with store.wal.dir and
            checkpoint.dir at the reference defaults (sync always,
            interval-versions 10 000, interval-s 300, keep 2), bulk-loaded
            (each bulk load cuts a synchronous checkpoint); DURABLE_WRITES
            acked REST writes (a tenth role -> role), the server SIGKILLed
            and restarted: the recovery report (checkpoint version, WAL
            records replayed, gap), checkpoint load and replay seconds,
            whether the CSR was primed, start_all and the restart to the
            first 4096-check batch answered on the card; every acked write
            read back over GET /relation-tuples, the batch equal to the
            set-graph oracle over the recovered store, a cold re-ingest of
            the same tuples timed beside it; then a graceful stop (the final
            checkpoint carries the CSR) and a third boot whose CSR is primed
12. cli     the CLI and the client SDK: `migrate status -c` on the [persist]
            database (nothing pending); an rbac1m server over it started by
            the CLI's own `serve -c` (this script re-run with --cli-server
            CFG, a fresh interpreter), 135 B1 launches at boot, REST + gRPC;
            the client verbs (status --block, check of an allowed and a
            denied sample tuple, relation-tuple create - and get --format
            json, version) each as a `python -m keto_tpu_torch.cli` process
            and in process in a fresh interpreter (--cli-client PLAN),
            seconds beside seconds, the same output and exit codes, and no
            CUDA context in the client's interpreter; the 4096 sample
            through RestClient (tuples, columns, encoded frames) and
            GrpcClient (tuples, columns), every answer equal and the first 64
            the host CheckEngine's over the SQL store; 256 serial single
            checks per client on one keep-alive connection (p50/p99), 64
            check_hedged calls (hedges fired, won, wasted), one expand and
            one list_objects equal through both clients; `debug snapshot`
            (its file list, and errors.txt naming exactly the routes not
            served yet); SIGTERM, serve's B1 launches over its life;
            `doctor` over [durable]'s WAL and checkpoints as a process,
            alongside the server's boot: no gap, the digest's count the
            tuples [durable] read back
13. config  config and the public port: `serve -c` in a fresh interpreter
            (this script re-run with --config-server CFG) over the [persist]
            database, its namespaces a watched directory (rbac, videos), TLS
            on both planes from tests/fixtures/tls, CORS for one origin, and
            KETO_SERVE_READ_PORT in its environment, which the read plane
            must bind; 135 B1 launches at boot, plaintext HTTP refused; the
            4096 sample as HTTPS /check/batch (RestClient with the fixture's
            CA) and as gRPC BatchCheck on a TLS channel to the same port,
            equal to [cli]'s answers and its host oracle's 64-prefix (p50
            beside [cli]'s plaintext p50); a CORS preflight, an allowed and a
            disallowed origin; a namespace file added while serving (404
            before, 201 after, seconds until visible); engine.pipeline_depth,
            engine.encode_workers and serve.read.max_freshness_wait_s edited
            in the file under CONFIG_CLIENTS HTTPS clients: no request
            fails, every answer the sample's, "hot knob reloaded" logged for
            each engine knob, /debug/config showing the new values; a dsn
            edit logged as immutable and an invalid file refused, the server
            still answering; SIGTERM, rc 0, no watcher thread left; B1
            launches at boot and over the server's life
14. fleet   a leader and two followers of rbac1m on the one card, each this
            script re-run with --fleet-server CFG (fresh interpreters), with
            lease election over [durable]'s WAL directory (the shared disk):
            the leader recovers [durable]'s store (replication.role leader)
            on ports chosen ahead; the followers, started beside it, wait for
            its feed, fetch its /replication/checkpoint, restore it, encode
            and build D with B1 (byte-equal to the plain build) and tail its
            WAL. FLEET_WRITES acked REST writes (a tenth
            role -> role), each read back on both followers with snaptoken=
            at its token from /replication/status (the wait path,
            write-to-visible p50/p99); a far token with a zero wait answers
            503, Retry-After and the lag (the bounce path); a write to a
            follower answers the read-only follower error with the leader
            hint; the 4096 sample on the leader and both followers equal to
            the set-graph oracle; /cluster/status with 3 members alive,
            keto_cluster_* per instance in both formats, a hedged check pair
            through ReplicatedRestClient stitched into one trace on the
            leader's /debug/traces; GET /check from FLEET_CLIENTS clients over
            both followers beside the leader alone; a follower's replica
            scrub clean, then replica.skip_delta: the next cycle finds the
            divergence and reseeds; the leader SIGKILLed mid-drive with its
            lease held: a follower wins the next term, replays the shared
            WAL, acks writes, no acked write lost and no phantom tuple, the
            term lineage strictly increasing, the other follower retargeted
            and converged; B1 launches of every node

[device]    the device-aware planes (breaker, HBM admission, supervisor,
            scrubber, /debug), on by default as in the reference. Every
            server above ends with /debug/device read back: breaker closed
            with no failure and no oracle-answered batch, no quarantined
            shape, backend cuda, no failover event. Drills, on the serve
            phase's first server after [serve:expand+list]: the HBM budget
            beside nvidia-smi's total; the breaker's own cost (p50 of the
            sample's batch_check through the breaker against the bare engine,
            10 in turns) in device query mode and in host query mode (the
            supervisor's CPU-failover mapping: a host residency built by the
            numpy builder, no B1, then home on the card, 135 B1); the scrub
            drill (scrub.device_bitflip poisons one cell of the card's D, the
            next cycle reports exactly that row, reset_residency rebuilds D
            with 135 B1 launches, byte-equal to the plain build, the next
            cycle clean, the sample the oracle's); /debug/scrub,
            /debug/overload, /debug/graph; /debug/profile?seconds=1 during a
            GET /check drive, whose archive must hold a CUDA kernel event. In
            the packed phase, after its measurements: the github10m engine
            wrapped as the registry wraps it (breaker, supervisor, pipelined
            CheckBatcher with HbmAdmission), drill batches of 256 rows of the
            sample held to its answers: device.oom (bisected, breaker closed),
            device.batch_nan x3 (open, oracle, half-open probe closes it,
            readiness down then up), device.lost and backend.probe_hang (the
            supervisor's child probe, reset_residency, warmup, force_probe),
            reconfigure 2 -> 0 -> 2 under 512 closed-loop submitters (no
            future lost), device.compile_fail (one shape quarantined, bucket
            8192 still launches B2), the bounded oracle (device.batch_nan
            sends the whole sample, one batch, to the registry's own oracle,
            the host CheckEngine over the store, under a BOUNDED_DEADLINE_S
            deadline: it returns by the deadline plus one row's oracle time,
            answered rows equal to the plain path, the rest failed typed), and
            a real CUDA out-of-memory classified "oom"; HBM admission must
            have learned at least one batch shape. Each drill prints a line; the drills' B1 and B2 launches
            are printed on their own [numbers] lines and stay out of the
            kernels line, which counts the main path's runs alone.

The second-to-last line of output is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. Without CUDA, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source
CLOSURE_INTERIOR_LIMIT = 16384  # ClosureCheckEngine's default interior_limit


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"smoke check failed: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def port(module: str, *names: str):
    """Names from a module of the port package, keto_tpu_torch.<module>:
    one object for one name, else a tuple. The package is imported late,
    inside the phases, so the script fails cleanly (and prints no result)
    where the package is missing."""
    base = f"keto_tpu_torch.{module}" if module else "keto_tpu_torch"
    mod = importlib.import_module(base)
    out = []
    for name in names:
        try:
            out.append(getattr(mod, name))
        except AttributeError:  # a submodule not yet imported
            out.append(importlib.import_module(f"{base}.{name}"))
    return out[0] if len(out) == 1 else tuple(out)


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


def profile_batch(fn) -> str:
    """One call of fn under torch.profiler: its wall time, the device's
    busy share (kernel time over wall time, one stream) and the kernels
    that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [
        (e.key[:48], e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(t for _, t, _ in kern)
    kern.sort(key=lambda k: -k[1])
    top = "; ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in kern[:6])
    return (f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
            f"({busy_ms / wall_ms:.1%}); top kernels: {top}")


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
    a[:, 5] = 1  # reached from every node: row 1 counts to M here
    return f.contiguous(), a.contiguous(), r.contiguous()


def propagate_case(rng, gen, n_pad, w, m, hub, device):
    """Inputs of one packed pass: a random frontier int32[n_pad, W] and m
    dst-sorted edges (duplicates, `hub` in-edges into one row, rows
    >= n_pad/2 with no in-edge, the dummy row as a source), then the probe
    edges of a batch of 32 W requests and the padding edges to the 1024
    multiple, as packed_batched_check appends them."""
    bsz = 32 * w
    n_out = n_pad + bsz
    src = rng.integers(n_pad, size=m)
    dst = rng.integers(n_pad // 2, size=m)
    dst[:hub] = 17
    src[hub : hub + 100] = src[hub + 100 : hub + 200]  # duplicate edges
    dst[hub : hub + 100] = dst[hub + 100 : hub + 200]
    src[-1] = n_pad - 1
    order = np.argsort(dst, kind="stable")
    pad = (-(m + bsz)) % 1024
    src_all = np.concatenate(
        [src[order], rng.integers(n_pad, size=bsz), np.full(pad, n_pad - 1)]
    ).astype(np.int32)
    dst_all = np.concatenate(
        [dst[order], n_pad + np.arange(bsz), np.full(pad, n_out - 1)]
    ).astype(np.int32)
    f = torch.randint(
        -(2**31), 2**31 - 1, (n_pad, w), generator=gen, device=device,
        dtype=torch.int32,
    )
    f[: n_pad // 8] = 0  # empty frontier rows
    return (
        f,
        torch.from_numpy(src_all).to(device),
        torch.from_numpy(dst_all).to(device),
        n_out,
    )


class IndexedTuples:
    """Read-only relationtuple.Manager over a columnar store's live edges,
    indexed by subject set: the host BFS oracle's view of the store without
    a full-column scan per query. Pages are kept once built (the oracle
    walks the same team rows check after check); everything is re-indexed
    when the store version moves."""

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
            self._pages = {}
            self._version = version

    def get_relation_tuples(self, query, pagination=None):
        RelationTuple = port("relationtuple", "RelationTuple")
        (PaginationOptions, decode_page_token, encode_page_token) = (
            port("utils.pagination", "PaginationOptions", "decode_page_token",
                 "encode_page_token")
        )

        self._index()
        pagination = pagination or PaginationOptions()
        nid = self._vocab.lookup((query.namespace, query.object, query.relation))
        if nid is None or nid + 1 >= len(self._indptr):
            return [], ""
        off = decode_page_token(pagination.token)
        per = pagination.per_page
        key = (nid, off, per)
        hit = self._pages.get(key)
        if hit is not None:
            return hit
        lo, hi = int(self._indptr[nid]), int(self._indptr[nid + 1])
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
        self._pages[key] = (page, token)
        return page, token


def pool(items):
    arr = np.empty(len(items), dtype=object)
    arr[:] = items
    return arr


def gen_rbac(n_tuples: int, rng: np.random.Generator, store=None):
    """users ∈ groups ∈ roles -> per-resource grants, with bench.py
    gen_rbac's pool sizes and edge mix, bulk-loaded into `store` (a new
    columnar store when None). Returns the store, the key pools and the
    edges of each stage."""
    ColumnarTupleStore = port("store", "ColumnarTupleStore")

    n_users = max(n_tuples // 10, 100)
    n_groups = min(max(n_tuples // 100, 20), 20_000)
    n_roles = min(max(n_groups // 10, 5), 2_000)
    n_resources = max(n_tuples // 3, 50)
    users = pool([(f"u{i}",) for i in range(n_users)])
    groups = pool([("rbac", f"g{i}", "member") for i in range(n_groups)])
    roles = pool([("rbac", f"role{i}", "member") for i in range(n_roles)])
    resources = pool([("rbac", f"res{i}", "view") for i in range(n_resources)])
    store = ColumnarTupleStore() if store is None else store
    n0 = len(store)
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
    while len(store) - n0 < n_tuples:  # grants; top up collision losses
        k = n_tuples - (len(store) - n0)
        s = resources[rng.integers(n_resources, size=k)]
        d = grant_dst[rng.integers(len(grant_dst), size=k)]
        store.bulk_load_edges(s.tolist(), d.tolist())
        grants_s.append(s)
        grants_d.append(d)
    edges["grant"] = (np.concatenate(grants_s), np.concatenate(grants_d))
    pools = {"users": users, "resources": resources, "groups": groups, "roles": roles}
    return store, pools, edges


def gen_github(n_tuples: int, rng: np.random.Generator):
    """Team membership and nesting, then per-repo permission grants to
    teams or direct collaborators, with bench.py gen_github's pool sizes and
    edge mix, bulk-loaded into a columnar store: 45% memberships, 3% team
    nesting, the rest grants (80% to teams, 20% to users) on
    gh:repoN#{pull,triage,push,admin}. A grant's repo#perm key is built
    only for the index drawn, from the same 4 * n_repos pool. Returns the
    store, the key pools and the edges of each stage."""
    ColumnarTupleStore = port("store", "ColumnarTupleStore")

    n_users = max(n_tuples // 8, 100)
    n_teams = min(max(n_tuples // 400, 20), 25_000)
    n_repos = max(n_tuples // 3, 50)
    perms = ("pull", "triage", "push", "admin")
    users = pool([(f"u{i}",) for i in range(n_users)])
    teams = pool([("gh", f"team{i}", "member") for i in range(n_teams)])
    store = ColumnarTupleStore()
    edges = {}

    def load(name, s, d):
        edges[name] = (s, d)
        store.bulk_load_edges(s.tolist(), d.tolist())

    k = int(n_tuples * 0.45)  # team membership
    load("membership", teams[rng.integers(n_teams, size=k)],
         users[rng.integers(n_users, size=k)])
    k = int(n_tuples * 0.03)  # team nesting
    load("nesting", teams[rng.integers(n_teams, size=k)],
         teams[rng.integers(n_teams, size=k)])
    grants_s, grants_d = [], []
    while len(store) < n_tuples:  # grants; top up collision losses
        k = n_tuples - len(store)
        to_team = rng.random(k) < 0.8
        d = np.where(
            to_team,
            teams[rng.integers(n_teams, size=k)],
            users[rng.integers(n_users, size=k)],
        )
        s = pool([("gh", f"repo{i >> 2}", perms[i & 3])
                  for i in rng.integers(4 * n_repos, size=k).tolist()])
        store.bulk_load_edges(s.tolist(), d.tolist())
        grants_s.append(s)
        grants_d.append(d)
    edges["grant"] = (np.concatenate(grants_s), np.concatenate(grants_d))
    return store, {"users": users, "n_repos": n_repos}, edges


def to_tuple(src_key, dst_key):
    (RelationTuple, SubjectID, SubjectSet) = (
        port("relationtuple", "RelationTuple", "SubjectID", "SubjectSet")
    )

    subject = (
        SubjectID(id=dst_key[0]) if len(dst_key) == 1 else SubjectSet(*dst_key)
    )
    return RelationTuple(*src_key, subject=subject)


def check_b2_small(rng, gen, dev) -> float:
    """B2 against its plain version at W in {128, 256} and at N_pad 2^20."""
    packed = port("ops", "packed")

    for n_pad, w, m, hub in (
        (4096, 128, 60_000, 5000),
        (1 << 14, 256, 200_000, 3000),
        (1 << 20, 128, 4_000_000, 2000),
    ):
        f, s, d, n_out = propagate_case(rng, gen, n_pad, w, m, hub, dev)
        got = packed.packed_propagate(f, s, d, n_out)
        want = packed.packed_propagate_plain(f, s, d, n_out)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"B2 != plain at N_pad={n_pad} W={w}")
        require(not got[n_pad // 2 : n_pad].any(), "rows with no in-edge")
    return 0.0  # bitwise equal: the largest absolute difference is 0


def run_example(repo: Path, dev) -> None:
    """cat-videos and the depth boundary through every check engine."""
    (ClosureCheckEngine, DeviceCheckEngine) = (
        port("engine", "ClosureCheckEngine", "DeviceCheckEngine")
    )
    SnapshotManager = port("graph", "SnapshotManager")
    RelationTuple = port("relationtuple", "RelationTuple")
    InMemoryTupleStore = port("store", "InMemoryTupleStore")

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
    chain = InMemoryTupleStore()
    chain.write_relation_tuples(
        *(RelationTuple.from_string(f"n:c{i}#m@(n:c{i + 1}#m)") for i in range(5)),
        RelationTuple.from_string("n:c5#m@alice"),
    )
    engines = {
        "closure": lambda mgr, **kw: ClosureCheckEngine(mgr, device=dev, **kw),
    }
    for mode in ("dense", "scatter", "packed"):
        engines[mode] = (
            lambda mgr, mode=mode, **kw: DeviceCheckEngine(
                mgr, mode=mode, device=dev, **kw
            )
        )
    for name, make in engines.items():
        got = make(SnapshotManager(cat)).batch_check(
            [RelationTuple.from_string(s) for s in expect]
        )
        require(got == list(expect.values()), f"{name}: cat-videos answers {got}")
        got = make(SnapshotManager(chain), max_depth=5).batch_check(
            [RelationTuple.from_string("n:c1#m@alice"),
             RelationTuple.from_string("n:c0#m@alice")]
        )
        require(got == [True, False], f"{name}: depth boundary 5/6 answers {got}")
    SnapshotExpandEngine = port("engine.device", "SnapshotExpandEngine")
    ExpandEngine = port("engine.expand", "ExpandEngine")
    SubjectSet = port("relationtuple", "SubjectSet")

    view = SubjectSet("videos", "/cats/1.mp4", "view")
    tree = SnapshotExpandEngine(SnapshotManager(cat)).build_tree(view)
    require(tree.to_dict() == ExpandEngine(cat).build_tree(view).to_dict(),
            "cat-videos Expand: the snapshot engine != the host engine")
    require(cat_videos_expand_ok(tree.to_dict()), f"cat-videos Expand: {tree}")
    say(f"[example] cat-videos 5/5, depth boundary 5 allowed / 6 denied, "
        f"engines {list(engines)}; Expand of {view}: a union of the owner "
        f"chain and the * leaf, both Expand engines")


def cat_videos_expand_ok(tree: dict) -> bool:
    """videos:/cats/1.mp4#view expands to a union of the owner chain
    (/cats/1.mp4#owner -> /cats#owner -> cat lady) and the * leaf."""
    def subject_set(obj, rel):
        return {"namespace": "videos", "object": obj, "relation": rel}

    return tree == {
        "type": "union",
        "subject_set": subject_set("/cats/1.mp4", "view"),
        "children": [
            {"type": "union", "subject_set": subject_set("/cats/1.mp4", "owner"),
             "children": [
                 {"type": "union", "subject_set": subject_set("/cats", "owner"),
                  "children": [{"type": "leaf", "subject_id": "cat lady"}]}]},
            {"type": "leaf", "subject_id": "*"},
        ],
    }


def run_rbac(args, rng, dev, card) -> dict:
    """The closure path at rbac1m, and B1's numbers."""
    (CheckEngine, ClosureCheckEngine) = (
        port("engine", "CheckEngine", "ClosureCheckEngine")
    )
    masked_spmv = port("engine", "masked_spmv")
    SnapshotManager = port("graph", "SnapshotManager")
    build_interior = port("graph.interior", "build_interior")
    packed_ops = port("ops", "packed")
    (pack_adjacency, unpack_adjacency) = (
        port("ops.closure", "pack_adjacency", "unpack_adjacency")
    )

    step = masked_spmv.masked_step
    t0 = time.perf_counter()
    store, pools, edges = gen_rbac(args.tuples, rng)
    say(f"[main:closure] store: {len(store)} tuples, {len(store.vocab)} nodes, "
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
    packed_ops.packed_propagate.launches = 0
    reset_native_calls()
    t0 = time.perf_counter()
    allowed = eng.batch_check(sample)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    state = eng._state
    ig, m_pad = state.ig, state.m_pad
    expected = (m_pad // 256) * (5 - 2)  # groups x waves k = 2..k_max
    say(f"[main:closure] interior m={ig.m} m_pad={m_pad} "
        f"ii_edges={len(ig.ii_src)}; first batch (build + {k} checks) "
        f"{first_s:.3f}s, phases {eng.last_build_phases}, allowed "
        f"{sum(allowed)}/{k}")
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
    sample_oracle = want
    bad = sum(a != b for a, b in zip(allowed[:n_or], want))
    say(f"[main:closure] D byte-equal to plain; oracle {n_or} checks, "
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
    say(f"[numbers] closure batch under the profiler: "
        f"{profile_batch(lambda: eng.batch_check(sample))}")

    # writes through the write overlay: a leaf edge (group -> new user),
    # then an interior edge (role -> role) that opens a path to a user four
    # hops from a resource, then the leaf delete and the interior delete;
    # none may rebuild the closure
    g_src, g_dst = edges["grant"]
    gi = next(i for i in range(len(g_src)) if g_dst[i][1].startswith("g"))
    res_g, grp = g_src[gi], g_dst[gi]
    leaf = to_tuple(grp, ("smoke-user",))
    store.write_relation_tuples(leaf)
    leaf_probes = [to_tuple(res_g, ("smoke-user",))]
    got = eng.batch_check(leaf_probes + sample[:64])
    want = oracle.batch_check(leaf_probes + sample[:64])
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
    interior = to_tuple(role_a, role_b)
    store.write_relation_tuples(interior)
    probes = [to_tuple(res_a, user_b), to_tuple(res_a, grp_b)]
    got = eng.batch_check(probes + sample[:n_or])
    want = oracle.batch_check(probes + sample[:n_or])
    require(got == want, "answers after the interior write disagree with oracle")
    require(got[0], f"{probes[0]} should be allowed after the interior write")
    ov = eng._overlay
    require(eng.n_full_builds == 1 and eng.n_incremental_builds == 0
            and ov.n_events == 2 and not ov.broken,
            f"builds full={eng.n_full_builds} incr={eng.n_incremental_builds}, "
            f"overlay events={ov.n_events} broken={ov.broken_reason!r}")
    # the overlay-patched D equals a fresh plain build of the same snapshot
    # when the interior node set is unchanged
    snap2 = mgr.snapshot()
    ig2 = build_interior(snap2)
    require(np.array_equal(ig2.interior_ids, ig.interior_ids),
            "the interior write changed the interior node set")
    d_fresh = masked_spmv.build_closure_semiring(
        pack_adjacency(ig2.ii_src, ig2.ii_dst, m_pad), ig2.m, m_pad=m_pad,
        k_max=4, device=dev, step=masked_spmv.masked_step_plain,
    )
    require(torch.equal(eng._state.d, d_fresh),
            "overlay-patched D != plain D of the written snapshot")
    del d_fresh, snap2, ig2
    store.delete_relation_tuples(leaf)
    got = eng.batch_check(leaf_probes + sample[:32])
    want = oracle.batch_check(leaf_probes + sample[:32])
    require(got == want and not got[0], f"after leaf delete: {got[:1]}")
    store.delete_relation_tuples(interior)
    got = eng.batch_check(probes + sample[:32])
    want = oracle.batch_check(probes + sample[:32])
    require(got == want, "answers after the interior delete disagree with oracle")
    require(eng.n_full_builds == 1 and eng.n_incremental_builds == 0
            and ov.n_events == 4 and ov.n_interior_deletes == 1
            and not ov.broken and eng._overlay is ov,
            f"builds full={eng.n_full_builds} incr={eng.n_incremental_builds}, "
            f"overlay events={ov.n_events} broken={ov.broken_reason!r}")
    launches = masked_spmv.masked_step.launches  # main path ends here
    require(launches == expected, f"{launches} launches after the writes")
    require(packed_ops.packed_propagate.launches == 0, "B2 ran on the closure path")
    say(f"[main:closure] writes: leaf + interior insert, leaf + interior "
        f"delete absorbed by the overlay (full={eng.n_full_builds}, "
        f"incremental={eng.n_incremental_builds}, overlay events "
        f"{ov.n_events}); patched D equal to a plain build of the written "
        f"snapshot; every re-check equals the oracle")

    # numbers: B1 at the main path's shape
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
    fills_ms = cuda_ms(  # the same build with no kernel: unpack and fills
        lambda: masked_spmv.build_closure_semiring(
            packed, ig.m, m_pad=m_pad, k_max=4, device=dev,
            step=lambda fr, a, re: (fr, re),
        ),
        3,
    )
    say(f"[numbers] card: {card}")
    say(f"[numbers] masked_spmv [{g}, {m}] x [{m}, {m}]: kernel {kern_ms:.4f} ms"
        f"/launch ({ops / kern_ms / 1e9:.1f} TFLOP/s, {bound_ms / kern_ms:.1%} "
        f"of the bound), bound {bound_ms:.4f} ms ({bound_by}), plain f32 "
        f"{plain_ms:.4f} ms, torch.matmul+mask {lib_ms:.4f} ms")
    say(f"[numbers] full build ({expected} launches + unpack) {build_ms:.3f} ms,"
        f" with an identity wave step (unpack and fills) {fills_ms:.3f} ms;"
        f" closure batch_check {k}: p50 {p50_ms:.3f} ms, {rate:.0f} checks/s")
    del adj, f, r
    torch.cuda.empty_cache()
    heng = closure_host(args, store, mgr, edges, sample, oracle,
                        p50_ms, rate, dev, card)
    calls = native_calls()
    require(all(calls[n] > 0 for n in ("request_hashes", "probe_index", "closure_check")),
            f"the closure path did not take the native tier: {calls}")
    say(f"[native] call sites that took the C path on the closure path (device "
        f"and host query mode): {native_sites(calls)}")
    native_rbac(eng, heng, store, sample, card)
    sharded_rbac(store, mgr, eng, oracle, sample, sample_oracle, p50_ms, edges, dev, card)
    return {
        "name": "masked_spmv",
        "route": "cuda",
        "source": "keto_tpu_torch/csrc/masked_spmv.cu",
        "replaces": "keto_tpu/engine/pallas_spmv.py:66",
        "launches": launches,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }


SHARD_REPS = 5  # timed 4096 batches of the two-stripe sharded tier
SHARD_WRITES = 4  # leaf writes before the incremental re-shard


def sharded_rbac(store, mgr, eng, oracle, sample, sample_oracle, closure_p50_ms, edges,
                 dev, card) -> None:
    """The sharded serving tier at rbac1m on the one card: a two-stripe mesh
    of the same device (its D built on the host and replicated), the sample
    equal to the closure engine's answers and its prefix to the oracle's
    (``sample_oracle``, taken at the phase's start: the store holds the same
    tuples again, the phase's writes deleted), SHARD_WRITES leaf writes, an
    incremental re-shard (not a full one) and equal answers again, then the
    per-shard residency HBM admission learned. Then a Registry with
    engine.sharding on: one device, so it falls through to the closure
    engine and logs the reference's line."""
    import logging

    ShardedServingEngine, make_mesh = port("parallel", "ShardedServingEngine", "make_mesh")
    HbmAdmission = port("engine.hbm", "HbmAdmission")
    Config, Registry = port("driver", "Config", "Registry")
    tag = "main:closure sharded"
    t_step = time.perf_counter()
    hbm = HbmAdmission()
    sh = ShardedServingEngine(mgr, mesh=make_mesh([dev, dev], data=1, edge=2), max_depth=5,
                              hbm=hbm)
    t0 = time.perf_counter()
    sh._residency(mgr.snapshot())
    build_s = time.perf_counter() - t0
    require(sh.n_full_reshards == 1, f"[{tag}] {sh.n_full_reshards} full re-shards at build")
    n_or = len(sample_oracle)
    closure = eng.batch_check(sample)
    got = sh.batch_check(sample)
    require(got == closure, f"[{tag}] {sum(a != b for a, b in zip(got, closure))} answers "
            "differ from the closure engine's")
    require(got[:n_or] == sample_oracle, f"[{tag}] the first {n_or} differ from the oracle's")
    lat = []
    for _ in range(SHARD_REPS):
        t0 = time.perf_counter()
        sh.batch_check(sample)
        lat.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lat)) * 1e3
    sb = sh.shard_bytes()
    say(f"[{tag}] two stripes on {dev} x2: full re-shard (host D + stripes + upload) "
        f"{build_s:.3f}s, m_pad {sh._host['m_pad']}; the {len(sample)} sample equal to the "
        f"closure engine's and the first {n_or} to the oracle; batch p50 {p50_ms:.3f} ms "
        f"(x{SHARD_REPS}) against the closure engine's {closure_p50_ms:.3f} ms; "
        f"shard_bytes per stripe {sb['per_shard_logical']} (total_per_shard "
        f"{sb['total_per_shard']}); escalated {sh.overflow_stats['escalated']}, host "
        f"fallback {sh.overflow_stats['host_fallback']} of {sh.overflow_stats['rows']} rows "
        f"({card})")

    # leaf writes: a new user joins a group per write; append-only, so the
    # tier re-shards incrementally
    g_src, g_dst = edges["grant"]
    grants = [i for i in range(len(g_src)) if g_dst[i][1].startswith("g")][:SHARD_WRITES]
    writes = [to_tuple(g_dst[i], (f"shard-user-{j}",)) for j, i in enumerate(grants)]
    probes = [to_tuple(g_src[i], (f"shard-user-{j}",)) for j, i in enumerate(grants)]
    store.write_relation_tuples(*writes)
    t0 = time.perf_counter()
    sh._residency(mgr.snapshot())
    reshard_s = time.perf_counter() - t0
    last = dict(sh.last_reshard)
    require(last.get("kind") == "incremental" and sh.n_full_reshards == 1
            and sh.n_incremental_reshards == 1,
            f"[{tag}] the writes re-sharded {last} (full {sh.n_full_reshards}, "
            f"incremental {sh.n_incremental_reshards})")
    batch = probes + sample
    got = sh.batch_check(batch)
    closure = eng.batch_check(batch)
    want = oracle.batch_check(batch[:len(probes) + n_or])
    require(got == closure, f"[{tag}] after the writes: "
            f"{sum(a != b for a, b in zip(got, closure))} answers differ from the closure "
            "engine's")
    require(got[:len(probes) + n_or] == want and all(got[:len(probes)]),
            f"[{tag}] after the writes: the probes {got[:len(probes)]} or the oracle prefix "
            "differ")
    residency = hbm.snapshot()["shard_residency"]
    require(len(residency) == 2 and all(v > 0 for v in residency.values()),
            f"[{tag}] HBM admission learned {residency}")
    store.delete_relation_tuples(*writes)
    say(f"[{tag}] {len(writes)} leaf writes: incremental re-shard {reshard_s:.3f}s "
        f"({last['dirty_rows']} dirty D rows, stripes {last['shards']}); the probes allowed "
        f"and the sample equal to the closure engine's and the oracle's again; HBM "
        f"admission's shard residency {residency} ({card})")
    del sh
    torch.cuda.empty_cache()

    # the registry on one card: engine.sharding falls through, with its line
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    server_log = logging.getLogger("keto_tpu_torch.server")
    level = server_log.level
    server_log.addHandler(handler)
    server_log.setLevel(logging.INFO)
    try:
        values = serve_config("auto")
        values["engine"]["sharding"] = {"enabled": True}
        reg = Registry(Config(values=values), device=dev)
        engine = reg.check_engine()
    finally:
        server_log.removeHandler(handler)
        server_log.setLevel(level)
    line = "engine.sharding enabled but mesh has one device; serving single-chip"
    devices = reg.mesh_devices()
    require(type(engine).__name__ == "ClosureCheckEngine" and line in records
            and len(devices) == 1,
            f"[{tag}] {devices} with engine.sharding: {type(engine).__name__}, {records}")
    say(f"[{tag}] a Registry with engine.sharding.enabled, mesh devices {devices}: "
        f"{type(engine).__name__}, logged {line!r}; the step took "
        f"{time.perf_counter() - t_step:.1f}s")


def closure_host(args, store, mgr, edges, sample, oracle,
                 device_p50_ms, device_rate, dev, card) -> None:
    """[main:closure host]: host query mode on the rbac1m store of
    [main:closure]. The host semiring build (numpy, no card) against the
    card's B1-built D; host batches beside the device path's; device_view()
    answers; the matmul builder in host mode (built on the card, downloaded
    once); the placement probe's round trip and what auto chose; last, a
    role -> role delete absorbed by the overlay and folded by the dirty-row
    rebuild, D and D^T against a full host build. No B1 or B2 launch."""
    import logging

    ClosureCheckEngine = port("engine", "ClosureCheckEngine")
    masked_spmv = port("engine", "masked_spmv")
    packed_ops = port("ops", "packed")
    build_closure_bitset = port("engine.semiring", "build_closure_bitset")
    build_interior = port("graph.interior", "build_interior")
    _m_pad_for = port("engine.closure", "_m_pad_for")
    pack_adjacency = port("ops.closure", "pack_adjacency")

    tag = "main:closure host"
    k = len(sample)
    n_or = min(args.oracle, k)
    # the card's B1-built D of the snapshot the host engine will build (its
    # launches are the comparison's, not the host path's)
    ig = build_interior(mgr.snapshot())
    m_pad = _m_pad_for(ig.m)
    d_card = masked_spmv.build_closure_semiring(
        pack_adjacency(ig.ii_src, ig.ii_dst, m_pad), ig.m, m_pad=m_pad, k_max=4,
        device=dev,
    ).cpu().numpy()
    masked_spmv.masked_step.launches = 0  # the host path starts here
    packed_ops.packed_propagate.launches = 0
    heng = ClosureCheckEngine(mgr, max_depth=5, query_mode="host", device=dev)
    t0 = time.perf_counter()
    host_allowed = heng.batch_check(sample)
    first_s = time.perf_counter() - t0
    phases = {n: round(v, 4) for n, v in heng.last_build_phases.items()}
    workers = heng._build_workers()
    require(host_allowed[:n_or] == oracle.batch_check(sample[:n_or]),
            "host-mode answers differ from the oracle")
    require(np.array_equal(heng._state.d_host, d_card),
            "host-built D != the card's B1-built D")
    say(f"[{tag}] first batch (host build + {k} checks) {first_s:.3f}s, phases "
        f"{phases}, {workers} build threads; D byte-equal to the card's "
        f"B1-built D; {n_or} answers equal the oracle")
    lat = []
    reps = 16
    for i in range(reps):
        batch = sample[i * 97 % k:] + sample[: i * 97 % k]
        t0 = time.perf_counter()
        heng.batch_check(batch)
        lat.append(time.perf_counter() - t0)
    host_p50 = float(np.median(lat)) * 1e3
    host_rate = k * reps / sum(lat)

    view = heng.device_view()
    require(view.batch_check(sample) == host_allowed, "device_view answers differ")
    lat = []
    for i in range(8):
        t0 = time.perf_counter()
        view.batch_check(sample)
        lat.append(time.perf_counter() - t0)
    view_p50 = float(np.median(lat)) * 1e3
    del view

    meng = ClosureCheckEngine(mgr, max_depth=5, query_mode="host",
                              builder="matmul", device=dev)
    require(meng.batch_check(sample[:n_or]) == host_allowed[:n_or],
            "matmul-builder answers differ")
    matmul_s = meng.last_build_phases["matmul"]
    require(np.array_equal(meng._state.d_host, d_card),
            "matmul-built host D != the card's B1-built D")
    del meng
    torch.cuda.empty_cache()

    probe_ms = []

    class _Probe(logging.Handler):
        def emit(self, record):
            if "query placement probe" in record.msg:
                probe_ms.append(float(record.args[0]))

    handler = _Probe()
    logger = logging.getLogger("keto_tpu_torch.engine")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        chose_host = ClosureCheckEngine(mgr, max_depth=5, device=dev).host_queries()
    finally:
        logger.removeHandler(handler)
    require(len(probe_ms) == 1 and not chose_host,
            f"auto on the card chose host ({probe_ms} ms round trip)")
    say(f"[{tag}] device_view() answers equal; the matmul builder in host mode: "
        f"D byte-equal, build on the card + download {matmul_s:.3f}s; auto "
        f"placement: median round trip {probe_ms[0]:.3f} ms -> device")

    # a role -> role delete: the overlay re-closes D on the host (and its
    # D^T mirror), then the fold takes the dirty-row rebuild
    t0 = time.perf_counter()
    heng.reverse_artifacts()  # the host D^T, carried by the rebuild below
    rev_s = time.perf_counter() - t0
    rr_s, rr_d = edges["role_role"]
    edge = next(to_tuple(a, b) for a, b in zip(rr_s, rr_d) if a != b)
    store.delete_relation_tuples(edge)
    t0 = time.perf_counter()
    got = heng.batch_check(sample[:n_or])
    absorb_s = time.perf_counter() - t0
    require(got == oracle.batch_check(sample[:n_or]),
            "host answers after the role delete differ from the oracle")
    ov = heng._overlay
    require(ov.n_interior_deletes == 1 and not ov.broken,
            f"the overlay did not absorb the delete ({ov.broken_reason!r})")
    t0 = time.perf_counter()
    heng._build_sync()
    fold_s = time.perf_counter() - t0
    inc = {n: round(v, 4) for n, v in heng.last_build_phases.items()}
    state = heng._state
    require(heng.n_full_builds == 1 and heng.n_incremental_builds == 1,
            f"the fold: full={heng.n_full_builds} incr={heng.n_incremental_builds}")
    ig = build_interior(mgr.snapshot())
    t0 = time.perf_counter()
    d_full = build_closure_bitset(ig.ii_src, ig.ii_dst, ig.m, state.m_pad, 4,
                                  workers=workers)
    full_s = time.perf_counter() - t0
    require(np.array_equal(state.d_host, d_full),
            "dirty-row D != a full host build of the written snapshot")
    require(state.d_rev is not None and np.array_equal(state.d_rev, d_full.T),
            "the carried D^T != the full build's transpose")
    require(heng.batch_check(sample[:n_or]) == oracle.batch_check(sample[:n_or]),
            "answers after the fold differ from the oracle")
    del d_full
    store.write_relation_tuples(edge)  # the store as [main:closure] left it
    b1 = masked_spmv.masked_step.launches  # the host path ends here
    b2 = packed_ops.packed_propagate.launches
    require(b1 == 0 and b2 == 0, f"host mode launched B1 {b1}, B2 {b2} times")
    say(f"[{tag}] role -> role delete {edge}: absorbed by the overlay in "
        f"{absorb_s:.3f}s (with {n_or} checks); folded by the dirty-row rebuild "
        f"in {fold_s:.3f}s ({heng.last_dirty_rows} of {ig.m} rows, phases {inc}); "
        f"D and the carried D^T equal a full host build ({full_s:.3f}s); "
        f"0 B1 and 0 B2 launches")
    say(f"[numbers] closure host ({card}; host os.cpu_count() {os.cpu_count()}): "
        f"host build {phases.get('kernel', 0):.3f}s (blocks "
        f"{phases.get('blocks', 0):.3f}s, interior {phases.get('interior', 0):.3f}s, "
        f"{workers} threads); batch_check {k}: host p50 {host_p50:.3f} ms, "
        f"{host_rate:.0f} checks/s against the device path's p50 "
        f"{device_p50_ms:.3f} ms, {device_rate:.0f} checks/s; device_view p50 "
        f"{view_p50:.3f} ms; matmul build on the card + download {matmul_s:.3f}s; "
        f"probe round trip {probe_ms[0]:.3f} ms; host D^T {rev_s:.3f}s; "
        f"role -> role delete: {heng.last_dirty_rows} dirty rows, fold "
        f"{fold_s:.3f}s")
    return heng


# the native host tier's wrappers, by the call site each serves
NATIVE_SITES = {
    "request_hashes": "NodeVocab.lookup_requests: the closure and snapshot encodes",
    "probe_index": "NodeVocab.lookup_hashes",
    "object_hashes": "NodeVocab.lookup_bulk",
    "closure_check": "ClosureCheckEngine._check_arrays (host query mode)",
    "gather_min_u8": "no caller, as in the reference",
}


def reset_native_calls() -> None:
    for fn in port("", "native").WRAPPERS:
        fn.calls = 0


def native_calls() -> dict:
    return {fn.__name__: fn.calls for fn in port("", "native").WRAPPERS}


def native_sites(calls: dict) -> str:
    return "; ".join(f"{name} x{n} ({NATIVE_SITES[name]})" for name, n in calls.items())


def twin_p50(fns: dict, reps: int = 20) -> tuple[dict, dict]:
    """Each fn with the native tier and with its numpy twin (native.lib None
    for the call), in turns (native, numpy, numpy, native, ...): the p50 ms
    of each and the last result of each."""
    native = port("", "native")
    lib = native.lib
    times = {name: {"native": [], "numpy": []} for name in fns}
    out = {name: {} for name in fns}
    try:
        for i in range(reps):
            for name, fn in fns.items():
                for tier in (("native", "numpy") if i % 2 == 0 else ("numpy", "native")):
                    native.lib = lib if tier == "native" else None
                    t0 = time.perf_counter()
                    out[name][tier] = fn()
                    times[name][tier].append(time.perf_counter() - t0)
    finally:
        native.lib = lib
    p50 = {name: {tier: float(np.median(v)) * 1e3 for tier, v in t.items()}
           for name, t in times.items()}
    return p50, out


def native_rbac(eng, heng, store, sample, card) -> None:
    """[native] at rbac1m: the encode and the whole batch of the 4096 sample
    in device query mode (eng, D on the card) and in host query mode (heng),
    each with the C tier and with its numpy twin in the same call; every
    answer equal across the twins, the card's check_ids and the oracle."""
    native = port("", "native")
    snap = eng.snapshots.snapshot()
    vocab = snap.vocab
    k = len(sample)
    # both query modes encode through the same vocab (one code path, timed
    # in each mode's turn)
    p50, out = twin_p50({
        "device encode": lambda: vocab.lookup_requests(sample),
        "device batch": lambda: eng.batch_check(sample),
        "host encode": lambda: heng.snapshots.snapshot().vocab.lookup_requests(sample),
        "host batch": lambda: heng.batch_check(sample),
    })
    for stage in ("device encode", "host encode"):
        for a, b in zip(out[stage]["native"], out[stage]["numpy"]):
            require(np.array_equal(a, b), f"[native] {stage}: ids differ from numpy's")
    s_ids, t_ids, is_id = out["device encode"]["native"]
    dummy = snap.dummy_node
    start = np.where((s_ids < 0) | (s_ids >= snap.padded_nodes), dummy, s_ids)
    target = np.where((t_ids < 0) | (t_ids >= snap.padded_nodes), dummy, t_ids)
    by_ids = eng.check_ids(start, target, is_id).tolist()
    t0 = time.perf_counter()
    want = SetGraphOracle(store).batch(sample)
    oracle_s = time.perf_counter() - t0
    for stage in ("device batch", "host batch"):
        for tier in ("native", "numpy"):
            require(out[stage][tier] == want,
                    f"[native] {stage} ({tier}) differs from the oracle")
    require(by_ids == want, "[native] the card's check_ids differ from the oracle")
    say(f"[native] {k} rbac1m checks: device and host batches, native and numpy, "
        f"the card's check_ids and the set-graph oracle ({oracle_s:.1f}s) all "
        f"equal ({sum(want)} allowed); encoded ids equal across the twins")
    say(f"[numbers] native ({card}; {native.so_path.name}, gcc {native.build_s:.3f}s; "
        f"p50 of 20 in turns, ms, native / numpy = ratio): "
        + "; ".join(f"{stage} {t['native']:.3f} / {t['numpy']:.3f} = "
                    f"{t['native'] / t['numpy']:.3f}" for stage, t in p50.items()))


def plain_check(eng, requests, depths=None):
    """The packed engine's answers for `requests` through the same loop
    with the plain propagate, and the number of passes the loop ran."""
    packed = port("ops", "packed")

    passes = []

    def counting(*a, **kw):
        passes.append(1)
        return packed.packed_propagate_plain(*a, **kw)

    enc = eng.encode_batch(requests, depths=depths)
    dg, dev = enc.dg, eng.device
    try:
        hit = packed.packed_batched_check(
            dg.src_by_dst, dg.dst_by_dst,
            torch.tensor(enc.start, device=dev),
            torch.tensor(enc.target, device=dev),
            torch.tensor(enc.depth, device=dev),
            padded_nodes=dg.padded_nodes, max_steps=eng.global_max_depth,
            row_ptr=dg.row_ptr, propagate=counting,
        )
        return hit[: enc.n].cpu().tolist(), len(passes)
    finally:
        enc.release()


def run_github(args, rng, dev) -> dict:
    """The packed path at github10m, and B2's numbers."""
    DEVSTATS = port("telemetry.devstats", "DEVSTATS")
    CheckEngine, DeviceCheckEngine = port("engine", "CheckEngine", "DeviceCheckEngine")
    masked_spmv = port("engine", "masked_spmv")
    SnapshotManager = port("graph", "SnapshotManager")
    build_interior = port("graph.interior", "build_interior")
    packed = port("ops", "packed")

    t0 = time.perf_counter()
    store, pools, edges = gen_github(args.gh_tuples, rng)
    say(f"[main:packed] store: {len(store)} tuples, {len(store.vocab)} nodes, "
        f"load {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    mgr = SnapshotManager(store)
    snap = mgr.snapshot()
    ig = build_interior(snap)
    say(f"[main:packed] snapshot: padded_nodes={snap.padded_nodes} "
        f"padded_edges={snap.padded_edges}; interior_nodes={ig.m} (closure "
        f"limit {CLOSURE_INTERIOR_LIMIT}) ({time.perf_counter() - t0:.1f}s)")
    require(ig.m > CLOSURE_INTERIOR_LIMIT,
            "interior fits the closure: not a packed-mode graph")
    del ig

    # 4096 repo#pull checks: uniform pairs (bench.py's sample) mixed with
    # pairs from real chains — a pull grant to a team and one of its
    # members (depth 2), and direct collaborator pull grants (depth 1)
    users, n_repos = pools["users"], pools["n_repos"]
    mem_s, mem_d = edges["membership"]
    member_of = {}
    for t_key, u_key in zip(mem_s[:200_000], mem_d[:200_000]):
        member_of.setdefault(t_key, u_key)
    g_src, g_dst = edges["grant"]
    chains, direct = [], []
    for s_key, d_key in zip(g_src, g_dst):
        if s_key[2] != "pull":
            continue
        if len(d_key) == 1:
            if len(direct) < 256:
                direct.append(to_tuple(s_key, d_key))
        elif d_key in member_of and len(chains) < 1024:
            chains.append(to_tuple(s_key, member_of[d_key]))
        if len(direct) == 256 and len(chains) == 1024:
            break
    k = args.checks
    n_uniform = k - len(chains) - len(direct)
    uniform = [
        to_tuple(("gh", f"repo{i}", "pull"), users[j])
        for i, j in zip(
            rng.integers(n_repos, size=n_uniform).tolist(),
            rng.integers(len(users), size=n_uniform).tolist(),
        )
    ]
    mixed = chains + direct + uniform
    sample = [mixed[i] for i in rng.permutation(len(mixed))]

    DEVSTATS.reset_peak()
    eng = DeviceCheckEngine(mgr, mode="packed", max_depth=5, device=dev)
    masked_spmv.masked_step.launches = 0  # main path starts here
    packed.packed_propagate.launches = 0
    t0 = time.perf_counter()
    allowed = eng.batch_check(sample)
    first_s = time.perf_counter() - t0
    first_launches = packed.packed_propagate.launches
    say(f"[main:packed] first batch (residency + {k} checks) {first_s:.3f}s, "
        f"allowed {sum(allowed)}/{k}, {first_launches} B2 launches")
    t0 = time.perf_counter()
    want, passes = plain_check(eng, sample)
    plain_s = time.perf_counter() - t0
    bad = sum(a != b for a, b in zip(allowed, want))
    say(f"[main:packed] plain-propagate loop: {passes} passes "
        f"({plain_s:.1f}s), {bad} of {k} answers disagree")
    require(bad == 0, f"{bad} packed answers disagree with the plain path")
    require(first_launches == passes > 0,
            f"{first_launches} launches, the loop ran {passes} passes")
    require(0 < sum(allowed) < k, "no allowed (or no denied) answers")
    oracle = CheckEngine(IndexedTuples(store), max_depth=5)
    n_or = min(args.oracle, k)
    t0 = time.perf_counter()
    want = oracle.batch_check(sample[:n_or])
    bad = sum(a != b for a, b in zip(allowed[:n_or], want))
    say(f"[main:packed] oracle {n_or} checks, {sum(want)} allowed, {bad} "
        f"disagree ({time.perf_counter() - t0:.1f}s)")
    require(bad == 0, f"{bad} packed answers disagree with the host oracle")

    # one write: a new user joins a team that holds a pull grant
    gi = next(i for i in range(len(g_src))
              if g_src[i][2] == "pull" and len(g_dst[i]) == 3)
    repo, team = g_src[gi], g_dst[gi]
    probe = to_tuple(repo, ("smoke-user",))
    require(not eng.batch_check([probe])[0], "allowed before the write")
    store.write_relation_tuples(to_tuple(team, ("smoke-user",)))
    before = packed.packed_propagate.launches
    recheck = [probe] + sample[:64]
    got = eng.batch_check(recheck)
    launches = packed.packed_propagate.launches  # main path ends here
    re_launches = launches - before
    want, passes = plain_check(eng, recheck)
    require(got == want and got[0], f"after the write: {got[:1]} vs {want[:1]}")
    require(got == oracle.batch_check(recheck), "re-check disagrees with oracle")
    require(re_launches == passes, f"{re_launches} launches, {passes} passes")
    require(masked_spmv.masked_step.launches == 0, "B1 ran on the packed path")
    say(f"[main:packed] write seen: {probe} allowed; {len(recheck)} re-checks "
        f"equal the plain path and the oracle ({re_launches} B2 launches)")

    # steady state at B = 4096
    lat = []
    reps = 8
    for i in range(reps):
        batch = sample[i * 97 % k:] + sample[: i * 97 % k]
        t0 = time.perf_counter()
        eng.batch_check(batch)
        lat.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lat)) * 1e3
    rate = k * reps / sum(lat)
    peak_gib = DEVSTATS.peak_bytes(span=True) / 2**30
    say(f"[numbers] packed batch under the profiler: "
        f"{profile_batch(lambda: eng.batch_check(sample))}")

    # [native]: the packed batch's encode (GraphSnapshot.encode_requests)
    # with the C tier and with its numpy twin, the answers equal
    reset_native_calls()
    snap = mgr.snapshot()
    enc, enc_out = twin_p50({"encode": lambda: snap.encode_requests(sample)})
    require(all(np.array_equal(a, b) for a, b in zip(enc_out["encode"]["native"],
                                                     enc_out["encode"]["numpy"])),
            "[native] packed encode: ids differ from numpy's")
    calls = native_calls()
    native_mod = port("", "native")
    lib = native_mod.lib
    native_mod.lib = None
    try:
        numpy_allowed = eng.batch_check(sample)
    finally:
        native_mod.lib = lib
    require(numpy_allowed == allowed == eng.batch_check(sample),
            "[native] packed answers differ between the twins")
    require(calls["request_hashes"] > 0, f"the packed encode took no C path: {calls}")
    say(f"[native] github10m packed batch of {k}: encode p50 native "
        f"{enc['encode']['native']:.3f} ms / numpy {enc['encode']['numpy']:.3f} ms = "
        f"{enc['encode']['native'] / enc['encode']['numpy']:.3f} (20 in turns); ids and "
        f"answers equal; C call sites: {native_sites(calls)}")

    pipe = packed_pipeline(eng, store, sample, allowed)

    # B2 on the real edges at github10m's shape: bitwise, then timed
    dg = eng._cached
    n_pad = dg.padded_nodes
    w = 4096 // 32
    n_out = n_pad + 4096
    n_real = dg.src_by_dst.shape[0]
    pad = (-(n_real + 4096)) % 1024
    targets = torch.randint(0, n_pad - 1, (4096,), device=dev, dtype=torch.int32)
    src_all = torch.cat([
        dg.src_by_dst, targets,
        torch.full((pad,), n_pad - 1, dtype=torch.int32, device=dev),
    ])
    dst_all = torch.cat([
        dg.dst_by_dst,
        n_pad + torch.arange(4096, dtype=torch.int32, device=dev),
        torch.full((pad,), n_out - 1, dtype=torch.int32, device=dev),
    ])
    row_ptr = packed.csr_row_ptr(dst_all, n_out)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    f = torch.randint(-(2**31), 2**31 - 1, (n_pad, w), generator=gen,
                      device=dev, dtype=torch.int32)
    got = packed.packed_propagate(f, src_all, dst_all, n_out, row_ptr=row_ptr)
    want = packed.packed_propagate_plain(f, src_all, dst_all, n_out, row_ptr=row_ptr)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "B2 != plain at github10m")
    del got, want
    kern_ms = cuda_ms(
        lambda: packed.packed_propagate(f, src_all, dst_all, n_out, row_ptr=row_ptr),
        10,
    )
    plain_ms = cuda_ms(
        lambda: packed.packed_propagate_plain(
            f, src_all, dst_all, n_out, row_ptr=row_ptr
        ),
        2,
    )
    m_edges = src_all.shape[0]
    distinct = int(torch.unique(src_all).numel())
    bytes_moved = distinct * w * 4 + n_out * w * 4 + m_edges * 8
    bound_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    say(f"[kernels] B2 bitwise equal to plain at github10m: N_pad={n_pad} "
        f"W={w} M={m_edges}")
    say(f"[numbers] packed_propagate [{n_pad}, {w}] x {m_edges} edges: kernel "
        f"{kern_ms:.4f} ms/launch, bound {bound_ms:.4f} ms (bytes: "
        f"{distinct} distinct sources x {w * 4} B + {n_out} rows x {w * 4} B "
        f"+ {m_edges} x 8 B), plain {plain_ms:.4f} ms, library none")
    say(f"[numbers] packed batch_check {k}: p50 {p50_ms:.3f} ms, "
        f"{rate:.0f} checks/s; peak device memory {peak_gib:.3f} GiB")
    say(f"[numbers] packed single checks from {pipe['threads']} submitter "
        f"threads, {k} checks: pipelined (pipeline_depth 2, encode_workers 2) "
        f"{pipe['pipelined']['rate']:.0f} checks/s, mean batch "
        f"{pipe['pipelined']['mean_batch']:.1f}, at most "
        f"{pipe['max_in_pipeline']} batches in the pipeline, "
        f"{pipe['pipelined']['launches']} B2 launches, peak device memory "
        f"{pipe['pipelined']['peak_gib']:.3f} GiB; serial "
        f"{pipe['serial']['rate']:.0f} checks/s, mean batch "
        f"{pipe['serial']['mean_batch']:.1f}, {pipe['serial']['launches']} B2 "
        f"launches, peak {pipe['serial']['peak_gib']:.3f} GiB; "
        f"check_batch_encoded of {k} ids: {pipe['encoded_launches']} B2 "
        f"launches, then {pipe['encoded_again_launches']} (all "
        f"{pipe['encoded_hits']} from the encoded cache)")
    del f, src_all, dst_all, row_ptr, targets
    torch.cuda.empty_cache()
    drills = device_packed(eng, store, sample, allowed)
    say(f"[numbers] [device] packed drills ({DRILL_ROWS}-row batches): device.lost "
        f"recovered in {drills['device.lost']:.3f}s, backend.probe_hang in "
        f"{drills['backend.probe_hang']:.3f}s; {drills['launches']} B2 launches; "
        f"{drills['wall_s']:.1f}s")
    return {
        "name": "packed_propagate",
        "route": "cuda",
        "source": "keto_tpu_torch/csrc/packed_propagate.cu",
        "replaces": "keto_tpu/ops/packed.py:60",
        "launches": launches + pipe["launches"],
        "drill_launches": drills["launches"],
        "drill_wall_s": drills["wall_s"],
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def packed_pipeline(eng, store, sample, want, threads: int = 512) -> dict:
    """The packed engine behind the check batcher, in both shapes: the
    sample as single checks from `threads` submitter threads (each waits
    for its answer, so batches of up to `threads` checks form), through the
    pipelined batcher (pipeline_depth 2, encode_workers 2, the encoded
    cache on) and through the serial one. Then one check_batch_encoded of
    the sample's ids, twice: the second is answered by the encoded cache
    with no B2 launch. Answers equal `want` (the phase's checked answers)."""
    DEVSTATS = port("telemetry.devstats", "DEVSTATS")
    from concurrent.futures import ThreadPoolExecutor

    CheckBatcher = port("engine.batcher", "CheckBatcher")
    packed = port("ops", "packed")
    out = {"threads": threads, "launches": 0}
    shapes = (
        ("serial", dict(pipeline_depth=0)),
        ("pipelined", dict(pipeline_depth=2, encode_workers=2,
                           encoded_cache_size=65536,
                           version_fn=lambda: store.version)),
    )
    for name, kw in shapes:
        batcher = CheckBatcher(eng, **kw)
        try:
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(batcher.check, sample[:threads]))  # warm threads
                batcher.n_batches = batcher.n_dispatched = 0
                torch.cuda.synchronize()
                DEVSTATS.reset_peak()
                packed.packed_propagate.launches = 0  # this drive starts here
                t0 = time.perf_counter()
                got = list(pool.map(batcher.check, sample))
                wall = time.perf_counter() - t0
            launches = packed.packed_propagate.launches  # ... and ends here
            out["launches"] += launches
            require(got == want, f"{name} batcher answers differ from the engine's")
            require(launches > 0, f"{name}: no B2 launch")
            out[name] = {
                "rate": len(sample) / wall,
                "mean_batch": batcher.mean_batch_size(),
                "launches": launches,
                "peak_gib": DEVSTATS.peak_bytes(span=True) / 2**30,
            }
            if name == "pipelined":
                stats = batcher.pipeline_stats()
                out["max_in_pipeline"] = stats["max_batches_in_pipeline"]
                require(stats["pipelined"] and stats["batches_in_pipeline"] == 0,
                        f"pipeline stats {stats}")
                s_ids, t_ids = eng.snapshots.snapshot().encode_requests(sample)
                # a fresh encoded cache, so the first call launches
                batcher.encoded_cache.clear()
                packed.packed_propagate.launches = 0
                first = batcher.check_batch_encoded(s_ids, t_ids)
                out["encoded_launches"] = packed.packed_propagate.launches
                h0 = batcher.encoded_cache.hits
                again = batcher.check_batch_encoded(s_ids, t_ids)
                out["encoded_again_launches"] = (
                    packed.packed_propagate.launches - out["encoded_launches"]
                )
                out["encoded_hits"] = batcher.encoded_cache.hits - h0
                out["launches"] += packed.packed_propagate.launches
                require(first == again == want, "check_batch_encoded answers differ")
                require(out["encoded_launches"] > 0
                        and out["encoded_again_launches"] == 0
                        and out["encoded_hits"] == len(sample),
                        f"encoded cache: {out}")
        finally:
            batcher.close()
    say(f"[main:packed] pipelined and serial batchers: {len(sample)} single "
        f"checks from {threads} threads each equal the phase's answers; "
        f"check_batch_encoded x2, the second from the encoded cache alone")
    return out


class SetGraphOracle:
    """Exact host oracle over a columnar store's live edges, fast enough for
    thousands of checks at rbac1m: a breadth-first search over subject-set
    nodes only, from the start set, then a test of the target's
    in-neighbours — allowed iff some in-neighbour u has dist(start, u) <=
    depth - 1. The semantics of the host BFS oracle (CheckEngine: a tuple
    path of length <= depth); the serve phase holds it against CheckEngine
    on a sample before using it. Built at one store version."""

    def __init__(self, store):
        subject_node_key = port("graph.vocab", "subject_node_key")

        self._key = subject_node_key
        src, dst, vocab, version = store.snapshot_ids()
        self.vocab, self.version, self.n = vocab, version, len(vocab)
        src, dst = src.astype(np.int64), dst.astype(np.int64)
        keep = vocab.is_set_array()[dst]
        order = np.argsort(src[keep], kind="stable")
        self.out_vals = dst[keep][order]
        self.out_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(src[keep], minlength=self.n))]
        )
        order = np.argsort(dst, kind="stable")
        self.in_vals = src[order]
        self.in_ptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=self.n))])
        self.dist = np.full(self.n, 127, dtype=np.int8)

    def _successors(self, rows: np.ndarray) -> np.ndarray:
        lo = self.out_ptr[rows]
        lens = self.out_ptr[rows + 1] - lo
        base = np.repeat(lo - np.cumsum(lens) + lens, lens)
        return self.out_vals[base + np.arange(int(lens.sum()))]

    def check(self, tup, depth: int = 5) -> bool:
        s = self.vocab.lookup((tup.namespace, tup.object, tup.relation))
        t = self.vocab.lookup(self._key(tup.subject))
        if s is None or t is None or s >= self.n or t >= self.n:
            return False
        preds = self.in_vals[self.in_ptr[t] : self.in_ptr[t + 1]]
        if not len(preds):
            return False
        dist = self.dist
        frontier = np.array([s], dtype=np.int64)
        dist[frontier] = 0
        touched = [frontier]
        try:
            for level in range(depth):
                if (dist[preds] <= level).any():
                    return True
                if level == depth - 1:
                    return False
                nxt = np.unique(self._successors(frontier))
                nxt = nxt[dist[nxt] == 127]
                if not len(nxt):
                    return False
                dist[nxt] = level + 1
                touched.append(nxt)
                frontier = nxt
            return False
        finally:
            for arr in touched:
                dist[arr] = 127

    def batch(self, tuples, depth: int = 5) -> list[bool]:
        return [self.check(t, depth) for t in tuples]


def http(method: str, url: str, body=None, timeout: float = 120.0, verify=True):
    """One request (the port's urllib helper); (status, parsed JSON body or
    None). ``verify`` is the https check (a CA path for the TLS fixture)."""
    fetch = port("utils.urlfetch", "fetch")
    data = None if body is None else json.dumps(body).encode()
    status, raw, _ = fetch(url, data, {"Content-Type": "application/json"}, timeout,
                           method, verify=verify)
    return status, (json.loads(raw) if raw else None)


def scrape(read: str, openmetrics: bool = False, verify=True):
    """GET /metrics as Prometheus text, or as OpenMetrics, parsed with the
    port's parser; a format error fails the phase."""
    fetch = port("utils.urlfetch", "fetch")
    parse_text = port("telemetry.openmetrics", "parse_text")
    headers = {"Accept": "application/openmetrics-text"} if openmetrics else {}
    status, raw, _ = fetch(f"{read}/metrics", None, headers, 60.0, "GET", verify=verify)
    require(status == 200, f"/metrics: {status}")
    doc = parse_text(raw.decode(), openmetrics=openmetrics)
    require(not doc.errors and doc.saw_eof == openmetrics,
            f"/metrics ({'OpenMetrics' if openmetrics else 'text'}): {doc.errors[:3]}")
    return doc


def is_request_line(line: str) -> bool:
    """A server's per-request log line (REST ``http``, gRPC ``grpc``, a
    debug-level ``span``), as opposed to its events."""
    return any(f"keto_tpu_torch.server: {w} " in line for w in ("http", "grpc", "span"))


def counter_sum(doc, name: str, **labels) -> float:
    """The sum of a family's samples whose labels hold ``labels``."""
    return sum(s.value for s in doc.samples_named(name)
               if all(s.labels.get(k) == v for k, v in labels.items()))


def attribution_shares(doc: dict) -> str:
    """/debug/attribution's stages as "stage share" pairs."""
    a = doc["attribution"]
    return (f"{a['requests']} requests, coverage {a['coverage']}: "
            + ", ".join(f"{s} {v['share_of_wall']:.4f}" for s, v in a["stages"].items()))


def tuple_query(t) -> str:
    from urllib.parse import urlencode

    q = {"namespace": t.namespace, "object": t.object, "relation": t.relation}
    if hasattr(t.subject, "id"):
        q["subject_id"] = t.subject.id
    else:
        q.update({"subject_set.namespace": t.subject.namespace,
                  "subject_set.object": t.subject.object,
                  "subject_set.relation": t.subject.relation})
    return urlencode(q)


def rest_check(read: str, t, depth: int = 0) -> bool:
    extra = f"&max-depth={depth}" if depth else ""
    status, doc = http("GET", f"{read}/check?{tuple_query(t)}{extra}")
    require(status in (200, 403) and doc == {"allowed": status == 200},
            f"GET /check {t}: {status} {doc}")
    return status == 200


def _run_clients(parts: list[dict]) -> tuple[list[dict], float]:
    """One client process (poolharness.client_main, which imports no torch)
    per part, run at the same time:
    each reads its part, sets up and says it is ready; once every process
    is ready, one line to each starts them together. Their result documents
    in order, and the drive's wall time, from the first process's start to
    the last one's finish on the host's monotonic clock, which every
    process reads alike."""
    from concurrent.futures import ThreadPoolExecutor

    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); "
        "import importlib; "
        "importlib.import_module('keto_tpu_torch.poolharness').client_main()"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(Path(__file__).resolve().parent)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for _ in parts
    ]
    try:
        for proc, part in zip(procs, parts):
            proc.stdin.write(json.dumps(part) + "\n")
            proc.stdin.flush()
        for proc in procs:
            line = proc.stdout.readline()
            require(line == "ready\n", f"client process not ready: {line!r}")
        for proc in procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        with ThreadPoolExecutor(len(procs)) as pool:
            runs = list(pool.map(lambda proc: proc.communicate(timeout=600), procs))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    docs = []
    for proc, (out, err) in zip(procs, runs):
        require(proc.returncode == 0, f"client process: rc {proc.returncode} {err[-2000:]}")
        docs.append(json.loads(out))
    return docs, max(d["end"] for d in docs) - min(d["start"] for d in docs)


def _merged(docs: list[dict], n: int) -> list:
    """Item j of a drive went to process j % len(docs): its results back in
    order."""
    results = [None] * n
    for i, doc in enumerate(docs):
        results[i::len(docs)] = doc["results"]
    return results


def http_clients(
    urls: list[str], clients: int, headers: list[dict] | None = None,
    procs: int = 1,
) -> tuple[list, float]:
    """GET every url from `clients` threads of `procs` separate processes,
    so the clients do not share the server's interpreter lock (nor, with
    procs > 1, one client interpreter's). Returns (status, seconds) per url,
    or with `headers` (one dict per url) (status, seconds, Retry-After or
    None), and the wall time of the run (first start to last finish)."""
    docs, wall = _run_clients([
        {"urls": urls[i::procs], "clients": max(1, clients // procs),
         "headers": None if headers is None else headers[i::procs]}
        for i in range(procs)
    ])
    return _merged(docs, len(urls)), wall


def frame_clients(read: str, frames: list[bytes], clients: int, procs: int):
    """POST every frame to /check/batch-encoded from `clients` threads of
    `procs` client processes. Returns (status, seconds, answer bits) per
    frame and the wall time of the run (first start to last finish)."""
    docs, wall = _run_clients([
        {"read": read, "frames": [f.hex() for f in frames[i::procs]],
         "clients": max(1, clients // procs)}
        for i in range(procs)
    ])
    return _merged(docs, len(frames)), wall


def fmt_walls(walls) -> str:
    return "/".join(f"{w:.3f}" for w in walls)


def pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values) * 1e3, q))


def serve_config(freshness: str, **engine) -> dict:
    return {
        "dsn": "columnar",
        "namespaces": [{"id": 1, "name": "rbac"}, {"id": 2, "name": "videos"}],
        "serve": {"read": {"host": "127.0.0.1", "port": 0, "max-depth": 5},
                  "write": {"host": "127.0.0.1", "port": 0}},
        "engine": {"freshness": freshness, **engine},
    }


def columnar_body(tuples) -> dict:
    """The columnar /check/batch body of `tuples`: parallel string arrays."""
    CheckColumns = port("relationtuple.columns", "CheckColumns")
    cols = CheckColumns.from_tuples(tuples)
    return {c: getattr(cols, c) for c in CheckColumns.__slots__}


def post_encoded(read: str, frame: bytes):
    """One /check/batch-encoded call: (status, answers or the error body)."""
    wirecodec = port("api", "wirecodec")
    post_frame = port("client.vocabcache", "post_frame")
    status, body = post_frame(read, frame, timeout=120.0)
    if status == 200:
        return status, wirecodec.decode_check_response(body)[0].tolist()
    return status, json.loads(body)


def chain_sample(rng, pools, edges, k: int):
    """k resource -> user checks: a quarter along real grant -> group ->
    member chains (allowed at depth 2 or more), the rest uniform pairs."""
    mem_s, mem_d = edges["membership"]
    member_of = {}
    for g_key, u_key in zip(mem_s[:100_000], mem_d[:100_000]):
        member_of.setdefault(g_key, u_key)
    g_src, g_dst = edges["grant"]
    chains = [
        to_tuple(r_key, member_of[d_key])
        for r_key, d_key in zip(g_src[: 4 * k], g_dst[: 4 * k])
        if d_key in member_of
    ][: k // 4]
    users, resources = pools["users"], pools["resources"]
    uniform = [
        to_tuple(r_key, u_key)
        for r_key, u_key in zip(
            resources[rng.integers(len(resources), size=k - len(chains))],
            users[rng.integers(len(users), size=k - len(chains))],
        )
    ]
    mixed = chains + uniform
    return [mixed[i] for i in rng.permutation(len(mixed))], member_of


def serve_telemetry(reg, eng, read, before, k, m_pad, sample, want, at) -> dict:
    """[serve]'s telemetry, right after the first 64-client GET /check drive
    (``before`` is the scrape just ahead of it): the /metrics deltas, builds
    and device gauges, /debug/attribution, then the same drive with the read
    API's check telemetry swapped for the no-op (as the reference's ReadAPI
    has when no registry wires one in), with the router's per-request log
    line off, once more live, and a live drive under /debug/pprof."""
    DEVSTATS = port("telemetry.devstats", "DEVSTATS")
    NOOP = port("telemetry.flight", "NOOP_CHECK_TELEMETRY")
    out = {}
    after = scrape(read)
    om = scrape(read, openmetrics=True)
    sent = {
        "check": counter_sum(after, "keto_check_requests_total", transport="rest")
        - counter_sum(before, "keto_check_requests_total", transport="rest"),
        "http": counter_sum(after, "keto_http_requests_total", route="/check",
                            method="GET")
        - counter_sum(before, "keto_http_requests_total", route="/check", method="GET"),
    }
    require(sent == {"check": k, "http": k},
            f"/metrics deltas over the drive {sent}, the drive sent {k}")
    builds = counter_sum(after, "keto_closure_builds_total", kind="full")
    require(builds == eng.n_full_builds == 1,
            f"keto_closure_builds_total full {builds}, the engine's {eng.n_full_builds}")
    in_use = after.value("keto_device_hbm_bytes_in_use", {"device": "cuda:0"})
    require(in_use is not None and in_use >= m_pad * m_pad,
            f"keto_device_hbm_bytes_in_use {in_use} under D's {m_pad * m_pad} bytes")
    peak_doc = scrape(read)
    peak = DEVSTATS.peak_bytes()
    scraped = peak_doc.value("keto_device_hbm_peak_bytes", {"device": "cuda:0"})
    require(scraped == float(peak), f"keto_device_hbm_peak_bytes {scraped}, "
            f"DEVSTATS.peak_bytes() {peak}")
    exemplars = [s.exemplar for s in om.samples_named("keto_check_duration_seconds_bucket")
                 if s.exemplar and "trace_id" in s.exemplar]
    require(exemplars, "no trace-id exemplar on keto_check_duration_seconds")
    status, attribution = http("GET", f"{read}/debug/attribution")
    require(status == 200 and attribution["attribution"]["stages"],
            f"/debug/attribution {status}")
    say(f"[serve {at()}] /metrics over the drive, as text and as OpenMetrics ({len(after.families)} "
        f"families, no format error): keto_check_requests_total{{transport=rest}} "
        f"+{sent['check']:.0f}, keto_http_requests_total{{route=/check}} "
        f"+{sent['http']:.0f} = the {k} sent; keto_closure_builds_total{{kind=full}} "
        f"{builds:.0f}; keto_device_hbm_bytes_in_use{{device=cuda:0}} {in_use:.0f} >= D "
        f"{m_pad * m_pad}; keto_device_hbm_peak_bytes {scraped:.0f} = "
        f"DEVSTATS.peak_bytes(); {len(exemplars)} trace-id exemplars")
    say(f"[serve {at()}] /debug/attribution: {attribution_shares(attribution)}")
    out["attribution"] = attribution["attribution"]
    router = reg.read_plane().router
    api = router._routes[("GET", "/check")].__self__
    live, logger = api.telemetry, router.logger
    urls = [f"{read}/check?{tuple_query(t)}" for t in sample]
    for name in ("noop", "nolog", "live"):
        api.telemetry = NOOP if name == "noop" else live
        router.logger = None if name == "nolog" else logger
        try:
            singles, wall = http_clients(urls, 64)
        finally:
            api.telemetry, router.logger = live, logger
        require([status == 200 for status, _ in singles] == want,
                f"GET /check answers ({name} telemetry) differ from the oracle")
        lat = [s for _, s in singles]
        out[name] = (k / wall, pct(lat, 50), pct(lat, 99))
    out["pprof"] = profile_drive(read, urls[: k // 2], at)
    return out


def profile_drive(read: str, urls: list, at) -> dict:
    """A live GET /check drive with /debug/pprof capturing the server while
    it runs: where the request threads' samples fall, by module."""
    import threading

    fetch = port("utils.urlfetch", "fetch")
    done = {}
    drive = threading.Thread(target=lambda: done.update(r=http_clients(urls, 64)))
    drive.start()
    time.sleep(1.5)  # the client process's start, before the capture
    status, folded, _ = fetch(f"{read}/debug/pprof?seconds=2.5&format=folded", timeout=60)
    drive.join()
    require(status == 200 and folded.strip(), f"/debug/pprof during a drive: {status}")
    idle = ("threading:wait", "socket:readinto", "selectors:select")
    groups = {"telemetry": 0, "log line": 0, "http": 0, "batcher and engine": 0, "other": 0}
    for line in folded.decode().splitlines():
        stack, n = line.rsplit(" ", 1)
        frames = stack.split(";")
        # the request threads and the serial dispatcher, while not waiting
        if not (frames[0].endswith("(process_request_thread)")
                or frames[0] == "check-batcher"):
            continue
        if any(frames[-1].startswith(i) for i in idle) or "api/debug:get_pprof" in stack:
            continue
        if any("telemetry/logging" in f for f in frames):
            groups["log line"] += int(n)
        elif any("keto_tpu_torch/telemetry/" in f for f in frames):
            groups["telemetry"] += int(n)
        elif any("keto_tpu_torch/engine/" in f for f in frames):
            groups["batcher and engine"] += int(n)
        elif any(f.startswith(("server:", "socketserver:", "client:", "socket:",
                               "keto_tpu_torch/api/")) for f in frames):
            groups["http"] += int(n)
        else:
            groups["other"] += int(n)
    total = sum(groups.values()) or 1
    shares = {g: n / total for g, n in groups.items()}
    say(f"[serve {at()}] /debug/pprof over 2.5 s of a {len(urls)}-check live drive: "
        f"{total} busy samples of the request threads and the dispatcher: "
        + ", ".join(f"{g} {s:.3f}" for g, s in shares.items()))
    return {"samples": total, "shares": shares}


def run_serve(args, dev, card, b1_ms: float) -> dict:
    """The serving seam at rbac1m: Registry -> REST planes -> CheckBatcher ->
    ClosureCheckEngine on the card, driven over HTTP. ``b1_ms`` is B1's
    per-launch time that [main:closure] measured: the boot build's
    ``closure.semiring`` span must cover the launches."""
    DEVSTATS = port("telemetry.devstats", "DEVSTATS")
    from concurrent.futures import ThreadPoolExecutor

    Config, Registry = port("driver", "Config", "Registry")
    CheckEngine, masked_spmv = port("engine", "CheckEngine", "masked_spmv")
    packed_ops = port("ops", "packed")
    RelationTuple = port("relationtuple", "RelationTuple")

    DEVSTATS.reset_peak()
    t_serve = time.perf_counter()

    def at() -> str:  # seconds into the phase, for the log
        return f"+{time.perf_counter() - t_serve:.1f}s"

    numbers = {}
    # the result cache off, so the single-check drive stays comparable with
    # the runs before the cache existed; the cache has its own server below
    # the scrubber's config is on, and its thread and live-check tap are off
    # until the [device] drill: the serve numbers stay comparable with the
    # runs before the scrubber existed
    reg = Registry(Config(values={**serve_config("auto", cache_size=0), "scrub": SCRUB}))
    t0 = time.perf_counter()
    store, pools, edges = gen_rbac(
        args.tuples, np.random.default_rng(args.seed + 1), store=reg.store()
    )
    say(f"[serve {at()}] store: {len(store)} tuples, load {time.perf_counter() - t0:.3f}s")
    masked_spmv.masked_step.launches = 0  # the serve path starts here
    packed_ops.packed_propagate.launches = 0
    t0 = time.perf_counter()
    read_port, write_port = reg.start_all()
    start_s = time.perf_counter() - t0
    eng, batcher = reg.check_engine(), reg.checker()
    reg.scrubber().stop()
    batcher.scrub_observer = None
    read = f"http://127.0.0.1:{read_port}"
    write = f"http://127.0.0.1:{write_port}"
    m_pad = eng._state.m_pad
    expected = (m_pad // 256) * (5 - 2)
    say(f"[serve {at()}] start_all (closure build + warmup) {start_s:.3f}s, m_pad "
        f"{m_pad}, phases {eng.last_build_phases}; read :{read_port}, write "
        f":{write_port}")
    rng = np.random.default_rng(args.seed + 2)
    try:
        # 0. the boot build's span: read before the drives push it out of
        # the tracer's ring; it closes after the card ran the last launch
        status, doc = http("GET", f"{read}/debug/traces?name=closure.semiring")
        spans = doc["spans"] if status == 200 else []
        floor_ms = 0.9 * expected * b1_ms
        require(spans and max(s["duration_ms"] for s in spans) >= floor_ms,
                f"closure.semiring spans {spans} under 0.9 x {expected} x {b1_ms:.4f} ms")
        numbers["semiring_span_ms"] = max(s["duration_ms"] for s in spans)
        say(f"[serve {at()}] /debug/traces: the boot build's closure.semiring span "
            f"{numbers['semiring_span_ms']:.3f} ms >= 0.9 x {expected} launches x "
            f"{b1_ms:.4f} ms = {floor_ms:.3f} ms (last_build_phases kernel "
            f"{eng.last_build_phases.get('kernel', 0) * 1e3:.3f} ms)")
        # 1. the cat-videos drive over REST, Expand included
        for path in sorted(
            (Path(__file__).resolve().parent
             / "contrib/cat-videos-example/relation-tuples").glob("*.json")
        ):
            doc = json.loads(path.read_text())
            doc.pop("$schema", None)
            status, _ = http("PUT", f"{write}/relation-tuples", doc)
            require(status == 201, f"PUT {path.name}: {status}")
        expect = {
            "videos:/cats#owner@cat lady": True,
            "videos:/cats/1.mp4#owner@cat lady": True,
            "videos:/cats/1.mp4#view@cat lady": True,
            "videos:/cats/1.mp4#view@*": True,
            "videos:/cats/2.mp4#view@*": False,
        }
        got = [rest_check(read, RelationTuple.from_string(q)) for q in expect]
        require(got == list(expect.values()), f"cat-videos over REST: {got}")
        status, doc = http("POST", f"{read}/check", RelationTuple.from_string(
            "videos:/cats/1.mp4#view@cat lady").to_dict())
        require(status == 200 and doc == {"allowed": True}, f"POST /check {status}")
        status, doc = http("GET", f"{read}/expand?namespace=videos"
                                  "&object=/cats/1.mp4&relation=view")
        require(status == 200 and cat_videos_expand_ok(doc),
                f"GET /expand cat-videos: {status} {doc}")
        say(f"[serve {at()}] cat-videos over REST: 5/5, POST /check 200, "
            f"GET /expand a union of the owner chain and the * leaf")
        serve_grpc(reg, read_port, expect, doc)

        # 2. 4096 sampled checks: POST /check/batch, then single GET /check
        # from 64 concurrent clients; every answer equals the host oracle
        k = args.checks
        sample, member_of = chain_sample(rng, pools, edges, k)
        t0 = time.perf_counter()
        so = SetGraphOracle(store)
        want = so.batch(sample)
        oracle_s = time.perf_counter() - t0
        base_oracle = CheckEngine(IndexedTuples(store), max_depth=5)
        n_ref = min(args.oracle, k) // 4
        require(base_oracle.batch_check(sample[:n_ref]) == want[:n_ref],
                "the set-graph oracle disagrees with CheckEngine")
        say(f"[serve {at()}] oracle: {k} checks {oracle_s:.1f}s, {sum(want)} allowed; "
            f"equal to CheckEngine on the first {n_ref}")
        body = [t.to_dict() for t in sample]
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            status, doc = http("POST", f"{read}/check/batch", body)
            lat.append(time.perf_counter() - t0)
            require(status == 200 and doc["allowed"] == want,
                    "/check/batch answers differ from the oracle")
            require(doc["snaptoken"] == str(store.version), f"snaptoken {doc}")
        numbers["batch_p50_ms"] = pct(lat[1:], 50)
        numbers["batch_rate"] = k * len(lat[1:]) / sum(lat[1:])
        batcher.n_batches = batcher.n_dispatched = 0

        with ThreadPoolExecutor(64) as pool:  # warm the server's threads
            warm = list(pool.map(lambda t: rest_check(read, t), sample[:256]))
        require(warm == want[:256], "GET /check answers differ from oracle")
        batcher.n_batches = batcher.n_dispatched = 0
        before = scrape(read)
        singles, wall = http_clients(
            [f"{read}/check?{tuple_query(t)}" for t in sample], 64
        )
        require([status == 200 for status, _ in singles] == want
                and all(status in (200, 403) for status, _ in singles),
                "GET /check answers differ from oracle")
        single_lat = [s for _, s in singles]
        numbers["single_p50_ms"] = pct(single_lat, 50)
        numbers["single_p99_ms"] = pct(single_lat, 99)
        numbers["single_rate"] = k / wall
        numbers["mean_batch"] = batcher.mean_batch_size()
        numbers["telemetry"] = serve_telemetry(
            reg, eng, read, before, k, m_pad, sample, want, at)
        # the same 64 clients split over 4 processes: the client setup of the
        # pool's drives, so the pool's rate is compared like for like
        singles, wall = http_clients(
            [f"{read}/check?{tuple_query(t)}" for t in sample], 64, procs=4
        )
        require([status == 200 for status, _ in singles] == want
                and all(status in (200, 403) for status, _ in singles),
                "GET /check answers (4 client processes) differ from oracle")
        single_lat = [s for _, s in singles]
        numbers["single4_p50_ms"] = pct(single_lat, 50)
        numbers["single4_p99_ms"] = pct(single_lat, 99)
        numbers["single4_rate"] = k / wall
        say(f"[serve {at()}] {k} checks as /check/batch x{len(lat)} and as {k} GET "
            f"/check from 64 client threads of a second process, then of 4 "
            f"processes: all equal the oracle")

        # 2b. the same sample as a columnar body, then as encoded frames
        numbers.update(serve_columnar_encoded(
            store, edges, sample, want, read, write, at))

        # 3. writes over REST, each class followed by a check that must
        # reflect it: the drain (overlay apply + D patch) is timed apart
        oracle = CheckEngine(IndexedTuples(store), max_depth=5)
        g_src, g_dst = edges["grant"]
        gr_s, gr_d = edges["group_role"]
        to_groups = [i for i in range(len(g_src)) if g_dst[i][1].startswith("g")]
        to_roles = [i for i in range(len(g_src)) if g_dst[i][1].startswith("role")]
        classes = {c: ([], []) for c in ("leaf insert", "leaf delete",
                                         "interior insert", "interior delete")}

        def timed(cls, method, tup, probe, expect_allowed, depth=0):
            url = f"{write}/relation-tuples"
            body = None
            if method == "PUT":
                body = tup.to_dict()
            else:
                url += "?" + tuple_query(tup)
            t0 = time.perf_counter()
            status, _ = http(method, url, body)
            require(status == (201 if method == "PUT" else 204), f"{method} {status}")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.served_version()  # drains the overlay: apply + D patch
            torch.cuda.synchronize()
            apply_s = time.perf_counter() - t1
            got = rest_check(read, probe, depth)
            visible_s = time.perf_counter() - t0
            require(got == expect_allowed == oracle.subject_is_allowed(probe, depth),
                    f"{cls}: {probe} answered {got}, expected {expect_allowed}")
            classes[cls][0].append(visible_s)
            classes[cls][1].append(apply_s)

        picked = 0
        for rep in range(3):
            gi = to_groups[rep * 7]
            leaf = to_tuple(g_dst[gi], (f"serve-user-{rep}",))
            probe = to_tuple(g_src[gi], (f"serve-user-{rep}",))
            timed("leaf insert", "PUT", leaf, probe, True)
            timed("leaf delete", "DELETE", leaf, probe, False)
        # interior: role_a -> role_b, probed as resource -> role_b set at
        # max-depth 2, which only the new edge can satisfy
        for ai in to_roles:
            if picked == 3:
                break
            res_a, role_a = g_src[ai], g_dst[ai]
            role_b = pools["roles"][(ai * 13) % len(pools["roles"])]
            probe = to_tuple(res_a, role_b)
            if role_a == role_b or so.check(probe, 2):
                continue  # the insert must flip this answer
            edge = to_tuple(role_a, role_b)
            timed("interior insert", "PUT", edge, probe, True, depth=2)
            timed("interior delete", "DELETE", edge, probe, False, depth=2)
            picked += 1
        require(picked == 3, "found no interior insert that flips a check")
        say(f"[serve {at()}] leaf and interior inserts and deletes over REST, "
            f"3 of each, each visible to the next check")
        numbers["classes"] = {
            c: (pct(v, 50), pct(a, 50)) for c, (v, a) in classes.items()
        }

        # 4. 1000 mixed random writes, then 256 oracle checks
        users, resources = pools["users"], pools["resources"]
        groups, roles = pools["groups"], pools["roles"]
        mem_s, mem_d = edges["membership"]
        inserted, touched = [], []
        t0 = time.perf_counter()
        for i in range(1000):
            roll = rng.random()
            if roll < 0.55:  # leaf insert: a user joins a group
                tup = to_tuple(groups[rng.integers(len(groups))],
                               users[rng.integers(len(users))])
                inserted.append(tup)
            elif roll < 0.75:  # leaf delete: a membership goes
                j = int(rng.integers(len(mem_s)))
                tup = (inserted.pop() if inserted and roll < 0.65
                       else to_tuple(mem_s[j], mem_d[j]))
            elif roll < 0.95:  # boundary insert: a resource grant
                tup = to_tuple(resources[rng.integers(len(resources))],
                               groups[rng.integers(len(groups))])
            elif roll < 0.98:  # interior insert: a role nests a group
                tup = to_tuple(roles[rng.integers(len(roles))],
                               groups[rng.integers(len(groups))])
            else:  # interior delete: a role loses a group
                j = int(rng.integers(len(gr_s)))
                tup = to_tuple(gr_s[j], gr_d[j])
            delete = 0.55 <= roll < 0.75 or roll >= 0.98
            if delete:
                status, _ = http("PATCH", f"{write}/relation-tuples",
                                 [{"action": "delete", "relation_tuple": tup.to_dict()}])
                require(status == 204, f"PATCH delete {status}")
            else:
                status, _ = http("PUT", f"{write}/relation-tuples", tup.to_dict())
                require(status == 201, f"PUT {status}")
            touched.append(tup)
        writes_s = time.perf_counter() - t0
        # checks through the written edges, from resources (a role as a
        # start has more than f0_max set successors and would take the
        # fallback oracle instead of the closure)
        granting = {}
        for r_key, d_key in zip(g_src, g_dst):
            granting.setdefault(d_key, r_key)
        after = []
        for t in touched[:128]:
            obj = (t.namespace, t.object, t.relation)
            user = (t.subject.id,) if hasattr(t.subject, "id") else (
                users[rng.integers(len(users))])
            start = obj if t.object.startswith("res") else granting.get(
                obj, resources[rng.integers(len(resources))])
            after.append(to_tuple(start, user))
        after += sample[:128]
        so_after = SetGraphOracle(store)
        status, doc = http("POST", f"{read}/check/batch",
                           [t.to_dict() for t in after])
        require(status == 200 and doc["allowed"] == so_after.batch(after),
                "answers after the mixed writes differ from the oracle")
        require(doc["snaptoken"] == str(store.version), f"snaptoken {doc['snaptoken']}")
        ov = eng._overlay
        launches = masked_spmv.masked_step.launches  # the serve path ends here
        say(f"[serve {at()}] 1000 mixed writes over REST in {writes_s:.2f}s; 256 "
            f"checks after them equal the oracle; overlay events {ov.n_events}, "
            f"interior edges {ov.n_interior_edges}, interior deletes "
            f"{ov.n_interior_deletes}, broken={ov.broken}")
        require(eng.n_full_builds == 1 and eng.n_incremental_builds == 0
                and not ov.broken,
                f"serve builds full={eng.n_full_builds} "
                f"incr={eng.n_incremental_builds} broken={ov.broken_reason!r}")
        require(launches == expected, f"serve path: {launches} B1 launches, "
                f"expected {expected}")
        require(packed_ops.packed_propagate.launches == 0, "B2 ran on the serve path")

        # 5. Expand and the list routes on the same server and store
        t0 = time.perf_counter()
        numbers["list"] = serve_expand_list(reg, store, pools, edges, rng, read,
                                            write, at, card)
        numbers["list"]["wall_s"] = time.perf_counter() - t0

        # 6. [device]: the planes idle through every step above, then drilled
        planes_idle(read, "serve")
        numbers["device"] = device_rbac(reg, store, sample, read, card, dev)
    finally:
        reg.stop_all()

    # 6. bounded freshness: a bulk load breaks the overlay; checks answer
    # from the previous closure with its snaptoken until the swap, and a
    # check carrying the new snaptoken waits for it
    reg = Registry(Config(values=serve_config("bounded")))
    store, pools, edges = gen_rbac(
        args.tuples, np.random.default_rng(args.seed + 1), store=reg.store()
    )
    read_port, _ = reg.start_all()
    read = f"http://127.0.0.1:{read_port}"
    eng = reg.check_engine()
    say(f"[serve {at()}] restarted with engine.freshness bounded")
    try:
        g_src, g_dst = edges["grant"]
        to_groups = [i for i in range(len(g_src)) if g_dst[i][1].startswith("g")][:8]
        bulk_src = [g_dst[i] for i in to_groups]
        bulk_dst = [(f"bulk-user-{j}",) for j in range(len(to_groups))]
        probes = [to_tuple(g_src[i], d) for i, d in zip(to_groups, bulk_dst)]
        probes += chain_sample(rng, pools, edges, 56)[0]
        body = [t.to_dict() for t in probes]
        v_old = store.version
        want_old = SetGraphOracle(store).batch(probes)
        ov = eng._overlay
        t_bulk = time.perf_counter()
        store.bulk_load_edges(bulk_src, bulk_dst)
        v_new = store.version
        status, stale = http("POST", f"{read}/check/batch", body)
        require(status == 200 and stale["snaptoken"] == str(v_old)
                and stale["allowed"] == want_old,
                f"before the swap: snaptoken {stale['snaptoken']} (old {v_old})")
        status, fresh = http("POST", f"{read}/check/batch?snaptoken={v_new}", body)
        swap_s = time.perf_counter() - t_bulk
        want_new = SetGraphOracle(store).batch(probes)
        require(status == 200 and fresh["snaptoken"] == str(v_new)
                and fresh["allowed"] == want_new,
                f"after the swap: snaptoken {fresh['snaptoken']} (new {v_new})")
        require(want_new[:8] == [True] * 8 and want_old[:8] == [False] * 8,
                "the bulk-loaded edges do not flip the probes")
        numbers["swap_s"] = swap_s
        say(f"[serve {at()}] bounded: overlay broke ({ov.broken_reason}); stale answers at "
            f"snaptoken {v_old} equal the oracle there; snaptoken {v_new} "
            f"waited {swap_s:.3f}s for the swap and equals the new oracle; "
            f"builds full={eng.n_full_builds} incr={eng.n_incremental_builds}")
        planes_idle(read, "serve:bounded")
    finally:
        reg.stop_all()

    # 7. the result cache at its default size, on a server of its own
    numbers["cache"] = serve_cache(args, at)
    peak_gib = DEVSTATS.peak_bytes(span=True) / 2**30
    classes = "; ".join(
        f"{c} {v:.3f} ms visible, {a:.3f} ms apply"
        for c, (v, a) in numbers["classes"].items()
    )
    say(f"[numbers] serve ({card}): GET /check at 64 clients (another process) p50 "
        f"{numbers['single_p50_ms']:.3f} ms, p99 {numbers['single_p99_ms']:.3f} "
        f"ms, {numbers['single_rate']:.0f} checks/s; mean batch formed "
        f"{numbers['mean_batch']:.2f}; the same 64 clients in 4 processes: p50 "
        f"{numbers['single4_p50_ms']:.3f} ms, p99 {numbers['single4_p99_ms']:.3f} "
        f"ms, {numbers['single4_rate']:.0f} checks/s")
    tel = numbers["telemetry"]
    say(f"[numbers] serve ({card}): GET /check at 64 clients (one client process), "
        f"checks/s and p50/p99 ms: check telemetry live {numbers['single_rate']:.0f}, "
        f"{numbers['single_p50_ms']:.3f}/{numbers['single_p99_ms']:.3f}; no-op "
        f"{tel['noop'][0]:.0f}, {tel['noop'][1]:.3f}/{tel['noop'][2]:.3f}; live without "
        f"the request log line {tel['nolog'][0]:.0f}, {tel['nolog'][1]:.3f}/"
        f"{tel['nolog'][2]:.3f}; live again {tel['live'][0]:.0f}, {tel['live'][1]:.3f}/"
        f"{tel['live'][2]:.3f}; live/no-op {numbers['single_rate'] / tel['noop'][0]:.3f} "
        f"and {tel['live'][0] / tel['noop'][0]:.3f}, no log line/live "
        f"{2 * tel['nolog'][0] / (numbers['single_rate'] + tel['live'][0]):.3f}; "
        f"closure.semiring span {numbers['semiring_span_ms']:.3f} ms")
    say(f"[numbers] serve ({card}): /check/batch of {k}: p50 "
        f"{numbers['batch_p50_ms']:.3f} ms, {numbers['batch_rate']:.0f} checks/s")
    say(f"[numbers] serve ({card}): write-to-visible and overlay apply "
        f"(drain + D patch), median of 3: {classes}")
    say(f"[numbers] serve ({card}): bounded freshness, bulk load to swap "
        f"{numbers['swap_s']:.3f} s; B1 launches on the serve path {launches}; "
        f"peak device memory {peak_gib:.3f} GiB")
    say(f"[numbers] serve ({card}): columnar /check/batch of {k}: p50 "
        f"{numbers['columnar_p50_ms']:.3f} ms, {numbers['columnar_rate']:.0f} "
        f"checks/s (the tuple body: p50 {numbers['batch_p50_ms']:.3f} ms)")
    say(f"[numbers] serve ({card}): encoded /check/batch-encoded of {k}: p50 "
        f"{numbers['encoded_p50_ms']:.3f} ms, {numbers['encoded_rate']:.0f} "
        f"checks/s; VocabCache bootstrap {numbers['bootstrap_s']:.3f} s "
        f"({numbers['vocab_keys']} keys), encode of {k} tuples "
        f"{numbers['encode_ms']:.3f} ms, sync after one write "
        f"{numbers['sync_ms']:.3f} ms")
    c = numbers["cache"]
    say(f"[numbers] serve ({card}): result cache (engine.cache_size 65536), "
        f"{k} GET /check at 64 clients: pass 1 hit share {c['hit1']:.4f}, p50 "
        f"{c['p50_1']:.3f} ms, {c['rate1']:.0f} checks/s; pass 2 hit share "
        f"{c['hit2']:.4f}, p50 {c['p50_2']:.3f} ms, {c['rate2']:.0f} checks/s; "
        f"mean batch {c['mean_batch1']:.2f} / {c['mean_batch2']:.2f}")
    return {"launches": launches, "list_launches": numbers["list"]["launches"],
            "cache_launches": c["launches"], "sample": sample, "want": want,
            "device": numbers["device"],
            "single_p50_ms": numbers["single_p50_ms"],
            "single_p99_ms": numbers["single_p99_ms"],
            "single_rate": numbers["single_rate"],
            "single4_p50_ms": numbers["single4_p50_ms"],
            "single4_p99_ms": numbers["single4_p99_ms"],
            "single4_rate": numbers["single4_rate"]}


# [serve:overload] settings. The plane sees only the batcher's queue delay
# and the engine's service time, not the HTTP handling around them (most of
# the ~100 ms p50 at 64 clients), so the CoDel target sits at 5 ms, under
# one batch period at 256 clients; a dwell of 200 ms between ladder steps up
# and a 2 s throttle window keep the quiet spell's first checks (whose
# limiter still remembers the storm) off the shedding rungs
OVERLOAD = {
    "enabled": True,
    "target_delay_ms": 5.0,
    "interval_ms": 100.0,
    "dwell_ms": 200.0,
    "hysteresis_ms": 1000.0,
    "throttle_window_s": 2.0,
}
OVERLOAD_CLIENTS = 256
CLASSES = ("critical", "default", "sheddable")


def serve_overload(args, serve: dict, card: str) -> dict:
    """[serve:overload]: a fourth rbac1m server with the result cache off
    and the overload plane on; the sample as GET /check from 256 clients,
    request i of class CLASSES[i % 3] in X-Request-Criticality. Every 200 or
    403 equals the oracle, every 429 carries Retry-After, critical gets no
    429, sheddable is shed at least as often as default, and the ladder
    reaches a shedding rung; after four quiet hysteresis windows it reads
    rung 0 and one client's checks get no 429."""
    Config, Registry = port("driver", "Config", "Registry")
    masked_spmv = port("engine", "masked_spmv")
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    values = serve_config("auto", cache_size=0)
    values["overload"] = OVERLOAD
    reg = Registry(Config(values=values))
    store, _, _ = gen_rbac(
        args.tuples, np.random.default_rng(args.seed + 1), store=reg.store()
    )
    masked_spmv.masked_step.launches = 0  # this server's path starts here
    read_port, _ = reg.start_all()
    read = f"http://127.0.0.1:{read_port}"
    eng, batcher, ov = reg.check_engine(), reg.checker(), reg.overload()
    require(ov is not None and batcher.overload is ov, "the overload plane is wired")
    # the fresh server holds the serve phase's initial store: its sample and
    # oracle answers apply unchanged
    sample, want = serve["sample"], serve["want"]
    require(len(store) > 0 and len(sample) == len(want), "the overload sample")
    out = {"settings": dict(OVERLOAD, clients=OVERLOAD_CLIENTS)}
    try:
        urls = [f"{read}/check?{tuple_query(t)}" for t in sample]
        headers = [{"X-Request-Criticality": CLASSES[i % 3]} for i in range(len(urls))]
        batcher.n_batches = batcher.n_dispatched = 0
        results, wall = http_clients(urls, OVERLOAD_CLIENTS, headers)
        shed = {c: 0 for c in CLASSES}
        sent = {c: 0 for c in CLASSES}
        lat = {c: [] for c in CLASSES}
        for i, (status, sec, retry) in enumerate(results):
            c = CLASSES[i % 3]
            sent[c] += 1
            if status == 429:
                require(retry is not None and int(retry) >= 1,
                        f"429 without Retry-After ({c}, request {i})")
                shed[c] += 1
            else:
                require(status in (200, 403) and (status == 200) == want[i],
                        f"GET /check {i} ({c}): {status}, oracle {want[i]}")
                lat[c].append(sec)
        snap, history = ov.snapshot(), ov.history()
        highest = max([e["state"] for e in history] + [snap["state"]])
        share = {c: shed[c] / sent[c] for c in CLASSES}
        require(shed["critical"] == 0, f"{shed['critical']} critical checks got a 429")
        require(share["sheddable"] >= share["default"],
                f"429 share sheddable {share['sheddable']} < default {share['default']}")
        require(highest >= 3, f"the ladder peaked at rung {highest}, not shedding; "
                f"{wall:.2f} s, snapshot {snap}")
        accepted = sum(len(v) for v in lat.values())
        out.update({
            "share": share,
            "p50": {c: pct(lat[c], 50) for c in CLASSES},
            "p99": {c: pct(lat[c], 99) for c in CLASSES},
            "p99_all": pct([x for v in lat.values() for x in v], 99),
            "p50_all": pct([x for v in lat.values() for x in v], 50),
            "accepted_rate": accepted / wall,
            "accepted": accepted,
            "highest": highest,
            "limit": snap["limiter"]["limit"],
            "culled": snap["culled"],
            "throttled": snap["throttle_rejects"],
            "mean_batch": batcher.mean_batch_size(),
        })
        say(f"[serve:overload {at()}] {len(urls)} GET /check from "
            f"{OVERLOAD_CLIENTS} clients: every 200/403 equals the oracle, "
            f"every 429 has Retry-After; 429s critical/default/sheddable "
            f"{shed['critical']}/{shed['default']}/{shed['sheddable']}; ladder "
            f"peaked at rung {highest}, {snap['brownout']['transitions_up']} steps "
            f"up")
        # the quiet spell: one rung down per hysteresis window
        time.sleep(4 * OVERLOAD["hysteresis_ms"] / 1e3 + 0.5)
        quiet = ov.snapshot()
        require(quiet["state"] == 0, f"after four quiet windows: rung {quiet['state']}")
        out["up"] = quiet["brownout"]["transitions_up"]
        out["down"] = quiet["brownout"]["transitions_down"]
        got = [rest_check(read, t) for t in sample[:64]]  # one client
        require(got == want[:64], "quiet-spell checks differ from the oracle")
        out["launches"] = masked_spmv.masked_step.launches  # ends here
        require(eng.n_full_builds == 1, f"overload server builds {eng.n_full_builds}")
        say(f"[serve:overload {at()}] after {4 * OVERLOAD['hysteresis_ms'] / 1e3:.1f} s "
            f"quiet the ladder reads rung 0; 64 checks from one client: no 429, "
            f"equal the oracle; {out['launches']} B1 launches")
        planes_idle(read, "serve:overload")
    finally:
        reg.stop_all()
    return out


# [serve:pool]: read replicas serving the rbac1m read port
POOL_WORKERS = 4


def _memory_mb(pid: int) -> dict:
    """RSS and PSS (shared pages split among their sharers) of a process in
    MB, from /proc/<pid>/smaps_rollup, else RSS alone from /proc/<pid>/status;
    empty where neither can be read."""
    for path, names in ((f"/proc/{pid}/smaps_rollup", ("Rss", "Pss")),
                        (f"/proc/{pid}/status", ("VmRSS",))):
        out = {}
        try:
            with open(path) as f:
                for line in f:
                    name, _, rest = line.partition(":")
                    if name in names:
                        out["rss" if name == "VmRSS" else name.lower()] = (
                            int(rest.split()[0]) / 1024)
        except OSError:
            continue
        if out:
            return out
    return {}


def pool_server_main(args) -> int:
    """The [serve:pool] server, run in a fresh interpreter (this script with
    --pool-server), so the fork starts from a process that holds only this
    server: a columnar rbac1m store from the serve phase's seed, the result
    cache off and serve.read.workers POOL_WORKERS (the closure engine in
    host query mode), brought up by start_all. It prints a POOL line with
    its ports, build phases and pool, then answers commands on stdin, one
    POOL line each: pool, plan, expect <json>, listref <user>, expandref
    <resource>, stop."""
    from collections import defaultdict

    Config, Registry = port("driver", "Config", "Registry")
    masked_spmv = port("engine", "masked_spmv")
    packed_ops = port("ops", "packed")
    ExpandEngine = port("engine.expand", "ExpandEngine")
    RelationTuple, SubjectSet = port("relationtuple", "RelationTuple", "SubjectSet")
    harness = port("", "poolharness")

    values = serve_config("auto", cache_size=0, query_mode=args.query_mode)
    values["serve"]["read"]["workers"] = args.pool_workers
    values["serve"]["read"]["wire_workers"] = args.wire_workers
    reg = Registry(Config(values=values))
    t0 = time.perf_counter()
    store, pools, edges = gen_rbac(
        args.tuples, np.random.default_rng(args.seed + 1), store=reg.store()
    )
    load_s = time.perf_counter() - t0
    masked_spmv.masked_step.launches = 0  # the pool server's path starts here
    packed_ops.packed_propagate.launches = 0
    t0 = time.perf_counter()
    read_port, write_port = reg.start_all()
    start_s = time.perf_counter() - t0
    eng, pool = reg.check_engine(), reg._replica_pool
    n_pool = max(args.pool_workers, args.wire_workers)
    require((pool is not None) == (n_pool > 1), "start_all forked no read replicas")
    phases = {n: round(v, 4) for n, v in eng.last_build_phases.items()}
    # the frames the parent's ring consumer answers for its wire workers
    ring = reg._wire_ring
    ring_frames = harness.count_ring_frames(reg._ring_server)

    def info(_arg: str = "") -> dict:
        kids = pool.child_pids() if pool is not None else []
        zygote = pool._zygote_pid if pool is not None else -1
        pids = [os.getpid(), zygote] + kids
        return {
            "read": read_port, "write": write_port, "load_s": load_s,
            "start_s": start_s, "phases": phases, "m": eng._state.ig.m,
            "workers": eng._build_workers(), "host": eng.host_queries(),
            "alive": pool.alive() if pool is not None else 1, "children": kids,
            "zygote": zygote, "respawns": pool.n_respawns if pool is not None else 0,
            "memory_mb": {str(p): _memory_mb(p) for p in harness.live_pids(pids)},
            "b1": masked_spmv.masked_step.launches,
            "b2": packed_ops.packed_propagate.launches,
            "cpus": os.cpu_count(),
            "endpoints": len(ring.endpoints) if ring is not None else 0,
            "shm": ring.shm.name if ring is not None else "",
            "ring_frames": ring_frames(),
        }

    def plan(_arg: str) -> dict:
        """A leaf insert whose probe it flips (a group granted alone to a
        resource gains a user) and a role -> role delete whose probe it
        flips (a resource granted only to role a, probed against role b's
        set at max-depth 2)."""
        grants = defaultdict(set)
        for r_key, d_key in zip(*edges["grant"]):
            grants[r_key].add(d_key)
        only = {}
        for r_key, targets in grants.items():
            if len(targets) == 1:
                only.setdefault(next(iter(targets)), r_key)
        g_key = next(d for d in only if d[1].startswith("g"))
        role_edge = next(
            (a, b) for a, b in zip(*edges["role_role"]) if a != b and a in only
        )
        return {
            "leaf": to_tuple(g_key, ("pool-user",)).to_dict(),
            "leaf_probe": to_tuple(only[g_key], ("pool-user",)).to_dict(),
            "edge": to_tuple(*role_edge).to_dict(),
            "edge_probe": to_tuple(only[role_edge[0]], role_edge[1]).to_dict(),
        }

    def expect(arg: str) -> dict:  # [[tuple dict, max-depth], ...] at the live version
        so = SetGraphOracle(store)
        return {"expect": [so.check(RelationTuple.from_dict(t), d)
                           for t, d in json.loads(arg)]}

    def listref(user: str) -> dict:  # list-objects by check_ids over every resource
        snap = eng.snapshots.snapshot()
        ids = snap.vocab.lookup_bulk(list(resources))
        ids = np.where(ids < 0, snap.dummy_node, ids)
        target = snap.vocab.lookup((user,))
        allowed = eng.check_ids(
            ids, np.full(len(ids), snap.dummy_node if target is None else target),
            np.ones(len(ids), dtype=bool),
        )
        return {"objects": sorted(resources[i][1] for i in np.nonzero(allowed)[0])}

    def expandref(res: str) -> dict:  # the host ExpandEngine over the live store
        tree = ExpandEngine(IndexedTuples(store), max_depth=5).build_tree(
            SubjectSet("rbac", res, "view"), 5
        )
        return {"tree": tree and tree.to_dict()}

    def stop() -> dict:
        pids = pool.child_pids() + [pool._zygote_pid] if pool is not None else []
        reg.stop_all()
        deadline = time.monotonic() + 30
        while harness.live_pids(pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        return {"stopped": True, "left": harness.live_pids(pids),
                "b1": masked_spmv.masked_step.launches,
                "b2": packed_ops.packed_propagate.launches}

    resources = pools["resources"]
    harness.emit(info())
    return harness.serve_commands(
        {"pool": info, "plan": plan, "expect": expect, "listref": listref,
         "expandref": expandref},
        stop,
    )


def converges(read: str, t, want: bool, depth: int = 0, tries: int = 24,
              timeout: float = 60.0) -> tuple[float, float]:
    """GET /check of `t` on a fresh connection each time until `tries`
    consecutive answers equal `want` (SO_REUSEPORT spreads the connections
    over the replicas). Returns the seconds from the call to the first
    answer of that streak and to its last."""
    extra = f"&max-depth={depth}" if depth else ""
    url = f"{read}/check?{tuple_query(t)}{extra}"
    t0 = time.perf_counter()
    streak, start = 0, 0.0
    while streak < tries:
        require(time.perf_counter() - t0 < timeout,
                f"{t} did not converge to {want} over the pool in {timeout}s")
        status, _ = http("GET", url)
        require(status in (200, 403), f"GET /check {t}: {status}")
        if (status == 200) == want:
            if streak == 0:
                start = time.perf_counter() - t0
            streak += 1
        else:
            streak = 0
            time.sleep(0.01)
    return start, time.perf_counter() - t0


def serve_pool(args, serve: dict, card: str) -> dict:
    """[serve:pool]: a server subprocess at rbac1m with serve.read.workers
    POOL_WORKERS, the result cache off and a columnar store. The serve
    phase's sample as GET /check from 64 clients (one client process, as
    the single-process drive, then four) and from 256 clients, every answer
    the oracle's; one list-objects and one Expand, each asked 8 times over
    fresh connections, equal to the server's check_ids over every resource
    and its host ExpandEngine; one replica SIGKILLed and respawned from the
    zygote, answers still the oracle's; a leaf insert and a role -> role
    delete on the write port, each followed by 24 consecutive
    fresh-connection checks that agree; stop_all leaves no child; no B1 or
    B2 launch in the server."""
    import signal
    from urllib.parse import urlencode

    RelationTuple = port("relationtuple", "RelationTuple")
    tag = "serve:pool"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    sample, want = serve["sample"], serve["want"]
    harness = port("", "poolharness")
    server = harness.PoolProcess(
        [sys.executable, str(Path(__file__).resolve()), "--pool-server",
         "--seed", str(args.seed), "--tuples", str(args.tuples)],
    )

    def server_log() -> list[str]:
        # its log lines: not its POOL documents, nor a request's http line
        return [line for line in server.lines
                if not line.startswith("POOL ") and not is_request_line(line)]

    out = {}
    try:
        info = server.next_doc(900)
        require(info["alive"] == POOL_WORKERS and info["host"] and info["b1"] == 0,
                f"pool server: {info}")
        read = f"http://127.0.0.1:{info['read']}"
        write = f"http://127.0.0.1:{info['write']}"
        out.update(start_s=info["start_s"], load_s=info["load_s"],
                   phases=info["phases"], cpus=info["cpus"], workers=info["workers"])
        say(f"[{tag} {at()}] server: store {info['load_s']:.3f}s, start_all "
            f"{info['start_s']:.3f}s (host build phases {info['phases']}, "
            f"m={info['m']}, {info['workers']} build threads), {info['alive']} "
            f"processes on read :{info['read']} (children {info['children']}, "
            f"zygote {info['zygote']}); host os.cpu_count() {info['cpus']}")

        urls = [f"{read}/check?{tuple_query(t)}" for t in sample]
        for name, clients, procs in (("64x1", 64, 1), ("64x4", 64, 4), ("256x4", 256, 4)):
            results, wall = http_clients(urls, clients, procs=procs)
            require([status == 200 for status, _ in results] == want
                    and all(status in (200, 403) for status, _ in results),
                    f"pool GET /check ({clients} clients, {procs} processes) "
                    f"differ from the oracle")
            lat = [sec for _, sec in results]
            out[name] = (pct(lat, 50), pct(lat, 99), len(urls) / wall)
        say(f"[{tag} {at()}] {len(urls)} GET /check from 64 clients (1 and 4 "
            f"client processes) and 256 clients (4): all equal the oracle")

        i = want.index(True)
        user, res = sample[i].subject.id, sample[i].object
        ref = server.ask(f"listref {user}")["objects"]
        tree = server.ask(f"expandref {res}")["tree"]
        q_list = urlencode({"namespace": "rbac", "relation": "view", "subject_id": user})
        q_tree = urlencode({"namespace": "rbac", "object": res, "relation": "view",
                            "max-depth": 5})
        for _ in range(8):
            status, doc = http("GET", f"{read}/relation-tuples/list-objects?{q_list}")
            require(status == 200 and doc["objects"] == ref,
                    f"pool list-objects {user}: {status}, {len(doc.get('objects', []))} "
                    f"objects, check_ids {len(ref)}")
            status, doc = http("GET", f"{read}/expand?{q_tree}")
            require(status == 200 and doc == tree, f"pool expand {res}: {status}")
        say(f"[{tag} {at()}] list-objects {user} ({len(ref)} objects) and GET "
            f"/expand {res} ({tree_nodes(tree) if tree else 0} nodes), 8 each over "
            f"fresh connections: equal check_ids over every resource and the "
            f"host ExpandEngine")

        victim = info["children"][0]
        t0 = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        while True:
            doc = server.ask("pool")
            kids = doc["children"]
            if (doc["alive"] == POOL_WORKERS and victim not in kids
                    and all(p > 0 for p in kids)):
                break
            require(time.perf_counter() - t0 < 60, f"no respawn after 60 s: {doc}")
            time.sleep(0.05)
        out["respawn_s"] = time.perf_counter() - t0
        results, _ = http_clients(urls[:1024], 64, procs=4)
        require([status == 200 for status, _ in results] == want[:1024],
                "answers after the respawn differ from the oracle")
        require(any("read replica died; respawning" in line for line in server_log()),
                "the supervisor logged no death")
        say(f"[{tag} {at()}] replica {victim} SIGKILLed: respawned from the zygote "
            f"in {out['respawn_s']:.3f}s (alive {doc['alive']}, children {kids}, "
            f"respawns {doc['respawns']}); "
            f"1024 checks after it equal the oracle")
        pool_doc = scrape(read)
        out["pool_metrics"] = {
            f"{s.name}{s.labels or ''}": s.value for s in pool_doc.samples_named(
                "keto_replica_respawns_total") + pool_doc.samples_named(
                "keto_replica_resyncs_total") + pool_doc.samples_named(
                "keto_replica_children")}
        say(f"[{tag} {at()}] one /metrics scrape over the pool after the kill (whichever "
            f"process the kernel picked): {out['pool_metrics']}")

        plan = server.ask("plan")
        leaf, leaf_probe = (RelationTuple.from_dict(plan[k])
                            for k in ("leaf", "leaf_probe"))
        edge, edge_probe = (RelationTuple.from_dict(plan[k])
                            for k in ("edge", "edge_probe"))
        require(server.ask("expect " + json.dumps(
            [[plan["leaf_probe"], 5], [plan["edge_probe"], 2]]))["expect"] == [False, True],
            "the write plan's probes do not start at (denied, allowed)")
        status, _ = http("PUT", f"{write}/relation-tuples", leaf.to_dict())
        require(status == 201, f"PUT {status}")
        out["leaf"] = converges(read, leaf_probe, True)
        status, _ = http("DELETE", f"{write}/relation-tuples?{tuple_query(edge)}")
        require(status == 204, f"DELETE {status}")
        out["delete"] = converges(read, edge_probe, False, depth=2)
        require(server.ask("expect " + json.dumps(
            [[plan["leaf_probe"], 5], [plan["edge_probe"], 2]]))["expect"] == [True, False],
            "the oracle disagrees with the converged answers")
        after = sample[:256]
        expect = server.ask("expect " + json.dumps([[t.to_dict(), 5] for t in after]))["expect"]
        results, _ = http_clients(urls[:256], 64, procs=4)
        require([status == 200 for status, _ in results] == expect,
                "256 checks after the writes differ from the oracle")
        doc = server.ask("pool")
        fell_back = [line.strip() for line in server_log() if "past its write overlay" in line]
        for line in server_log():  # the server's log: deaths, respawns, fallbacks
            say(f"[{tag}] server log: {line.rstrip()}")
        out["memory_mb"] = doc["memory_mb"]
        say(f"[{tag} {at()}] leaf insert {leaf}: the first of 24 agreeing "
            f"fresh-connection answers {out['leaf'][0]:.3f}s after the write "
            f"returned, the last {out['leaf'][1]:.3f}s; role -> role delete {edge}: "
            f"{out['delete'][0]:.3f}s and {out['delete'][1]:.3f}s; 256 checks after "
            f"both equal the oracle; "
            f"replicas answering from the live store: {fell_back or 'none'}")

        planes_idle(read, "serve:pool")
        pids = doc["children"] + [doc["zygote"]]
        doc = server.stop(120.0)
        left = harness.live_pids(pids)
        require(doc["stopped"] and doc["left"] == [] and left == [],
                f"processes left after stop_all: {doc['left']} {left}")
        require(doc["b1"] == 0 and doc["b2"] == 0,
                f"the pool server launched B1 {doc['b1']}, B2 {doc['b2']} times")
        require(server.proc.returncode == 0, f"pool server rc {server.proc.returncode}")
        say(f"[{tag} {at()}] stop_all: no child left; 0 B1 and 0 B2 launches in "
            f"the server; memory after the writes (MB, rss/pss by pid): "
            + ", ".join(f"{p} {m.get('rss', 'not measured')}/{m.get('pss', 'not measured')}"
                        for p, m in out["memory_mb"].items()))
    finally:
        server.kill_group()  # a failure's backstop: the group is empty after stop
    return out


# [serve:wire]: encoded frames from WIRE_WORKERS accept processes into the
# parent's one batcher over the shared-memory ring
WIRE_WORKERS = 4
WIRE_ROWS = 64  # rows per encoded frame
WIRE_REPEATS = 32  # posts of each of the sample's frames per drive
WIRE_DRIVES = 2  # timed drives of each server, the two in turns


def serve_wire(args, serve: dict, card: str) -> dict:
    """[serve:wire]: two rbac1m servers in fresh interpreters (this script
    with --pool-server), both in host query mode with the result cache off:
    serve.read.wire_workers WIRE_WORKERS (workers 1: the wire workers alone
    make the pool) and a single-process one. The serve phase's sample as
    encoded frames of WIRE_ROWS rows from a VocabCache, each posted
    WIRE_REPEATS times a drive by 64 clients in 4 client processes started
    together, WIRE_DRIVES drives of each server in turns; every answer the
    oracle's. Then, on the wire server: a leaf insert, a
    frame from before it answered 409 by every process until the client
    resyncs, and the resynced frame showing the insert; a SIGKILLed wire
    worker whose lane alone retires, respawned from the zygote, the frames
    after it answered right and the other lanes still reaching the parent;
    stop_all leaves no process. No B1 or B2 launch in either server."""
    import signal

    RelationTuple = port("relationtuple", "RelationTuple")
    VocabCache = port("client", "VocabCache")
    harness = port("", "poolharness")
    tag = "serve:wire"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    sample, want = serve["sample"], serve["want"]
    k = len(sample)
    argv = [sys.executable, str(Path(__file__).resolve()), "--pool-server",
            "--seed", str(args.seed), "--tuples", str(args.tuples),
            "--query-mode", "host", "--pool-workers", "1"]
    servers = {  # both boot at once
        "wire": harness.PoolProcess(argv + ["--wire-workers", str(WIRE_WORKERS)],
                                    name="wire server"),
        "single": harness.PoolProcess(argv + ["--wire-workers", "1"],
                                      name="single-process server"),
    }
    out = {}
    try:
        infos = {name: srv.next_doc(900) for name, srv in servers.items()}
        w, one = infos["wire"], infos["single"]
        require(w["alive"] == WIRE_WORKERS and w["endpoints"] == WIRE_WORKERS - 1
                and w["host"] and w["b1"] == 0, f"wire server: {w}")
        require(one["alive"] == 1 and one["endpoints"] == 0 and one["host"],
                f"single-process server: {one}")
        demoted = [line for srv in servers.values() for line in srv.lines
                   if "serving single-process" in line]
        require(not demoted, f"a server demoted to single-process: {demoted}")
        reads = {name: f"http://127.0.0.1:{info['read']}" for name, info in infos.items()}
        out["cpus"] = w["cpus"]
        say(f"[{tag} {at()}] servers: wire ({w['alive']} processes, {w['endpoints']} "
            f"ring endpoints, shm {w['shm']}, start_all {w['start_s']:.3f}s) and single "
            f"({one['alive']} process, start_all {one['start_s']:.3f}s), host query "
            f"mode, cache off; host os.cpu_count() {w['cpus']}")

        starts = range(0, k, WIRE_ROWS)
        expect = ["".join("1" if v else "0" for v in want[i:i + WIRE_ROWS]) for i in starts]
        frames, before = {}, {}
        for name in ("wire", "single"):
            cache = VocabCache(reads[name], timeout=120.0).bootstrap()
            frames[name] = [cache.frame(sample[i:i + WIRE_ROWS]) for i in starts]
            before[name] = servers[name].ask("pool")["ring_frames"]
            out[name] = {"walls": [], "lat": []}
        for _ in range(WIRE_DRIVES):  # the two servers in turns
            for name in ("wire", "single"):
                results, wall = frame_clients(
                    reads[name], frames[name] * WIRE_REPEATS, 64, 4)
                bad = [j for j, (status, _, bits) in enumerate(results)
                       if status != 200 or bits != expect[j % len(expect)]]
                require(not bad, f"{name}: {len(bad)} of {len(results)} frames wrong "
                        f"or refused, first {results[bad[0]][:1] if bad else None}")
                out[name]["walls"].append(wall)
                out[name]["lat"] += [sec for _, sec, _ in results]
        n_frames = len(expect) * WIRE_REPEATS  # per drive
        for name in ("wire", "single"):
            o = out[name]
            rates = sorted(n_frames / wall for wall in o["walls"])
            o.update(
                p50=pct(o["lat"], 50), p99=pct(o["lat"], 99),
                frames_s=rates[len(rates) // 2], frames_s_range=(rates[0], rates[-1]),
                checks_s=rates[len(rates) // 2] * k / len(expect),
                ring=servers[name].ask("pool")["ring_frames"] - before[name],
                frames=n_frames * WIRE_DRIVES,
            )
            del o["lat"]
        require(out["wire"]["ring"] > 0 and out["single"]["ring"] == 0,
                f"ring frames: wire {out['wire']['ring']}, single {out['single']['ring']}")
        say(f"[{tag} {at()}] {k} checks as {len(expect)} frames of {WIRE_ROWS} rows "
            f"x{WIRE_REPEATS} per drive, {WIRE_DRIVES} drives of each server in turns, "
            f"from 64 clients in 4 client processes started together: every answer "
            f"the oracle's; {out['wire']['ring']} of {out['wire']['frames']} "
            f"wire-server frames crossed the ring")

        # where a wire worker and the parent spend a frame: each process's
        # /debug/attribution, over fresh connections; a worker's ledger holds
        # the parent's stages shipped back over the ring and the transit as
        # "queue"
        seen = {}
        for _ in range(16):
            status, doc = http("GET", f"{reads['wire']}/debug/attribution")
            require(status == 200 and doc["attribution"]["stages"],
                    f"[{tag}] /debug/attribution with no stage: {status} {doc}")
            seen.setdefault(doc["attribution"]["requests"], doc)
        shipped = [d for d in seen.values() if "queue" in d["attribution"]["stages"]]
        require(shipped, f"[{tag}] no process's ledger holds ring-shipped stages: "
                f"{[d['attribution']['stages'] for d in seen.values()]}")
        out["attribution"] = [d["attribution"] for d in seen.values()]
        for d in seen.values():
            say(f"[{tag} {at()}] /debug/attribution of one process: {attribution_shares(d)}")

        srv, read = servers["wire"], reads["wire"]
        write = f"http://127.0.0.1:{w['write']}"
        plan = srv.ask("plan")
        leaf = RelationTuple.from_dict(plan["leaf"])
        probe = RelationTuple.from_dict(plan["leaf_probe"])
        probes = [probe] + sample[: WIRE_ROWS - 1]
        cache = VocabCache(read, timeout=120.0).bootstrap()
        stale = cache.frame(probes)
        status, _ = http("PUT", f"{write}/relation-tuples", leaf.to_dict())
        require(status == 201, f"PUT {status}")
        visible = converges(read, probe, True)
        for _ in range(12):  # fresh connections: every process gates
            status, doc = post_encoded(read, stale)
            require(status == 409 and doc["error"]["details"]["reason"]
                    == "vocab_epoch_mismatch", f"a stale frame: {status} {doc}")
        cache.sync()
        truth = srv.ask("expect " + json.dumps([[t.to_dict(), 5] for t in probes]))["expect"]
        require(truth[0], f"{probe} is not allowed after the leaf insert")
        for _ in range(12):
            status, got = post_encoded(read, cache.frame(probes))
            require(status == 200 and got == truth,
                    "resynced frames after the leaf insert differ from the oracle")
        say(f"[{tag} {at()}] leaf insert {leaf}: visible over the pool after "
            f"{visible[1]:.3f}s; 12 frames from before it 409 (vocab_epoch_mismatch); "
            f"after the resync 12 frames equal the oracle ({probe} allowed)")

        victim = w["children"][0]
        t0 = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        while True:
            doc = srv.ask("pool")
            kids = doc["children"]
            if (doc["alive"] == WIRE_WORKERS and victim not in kids
                    and all(p > 0 for p in kids)):
                break
            require(time.perf_counter() - t0 < 60, f"no respawn after 60 s: {doc}")
            time.sleep(0.05)
        out["respawn_s"] = time.perf_counter() - t0
        retired = [line.strip() for line in srv.lines if "retiring its ring lane" in line]
        require(len(retired) == 1 and "endpoint 0 " in retired[0],
                f"the ring retired {retired}")
        frames = [cache.frame(sample[i:i + WIRE_ROWS]) for i in starts]
        before = doc["ring_frames"]
        results, _ = frame_clients(read, frames * 2, 64, 4)
        bad = [j for j, (status, _, bits) in enumerate(results)
               if status != 200 or bits != expect[j % len(frames)]]
        require(not bad, f"{len(bad)} frames wrong or refused after the kill")
        after = srv.ask("pool")["ring_frames"] - before
        require(after > 0, "no frame reached the parent over the ring after the kill")
        say(f"[{tag} {at()}] wire worker {victim} SIGKILLed: its lane alone retired "
            f"({retired[0]}), respawned from the zygote in {out['respawn_s']:.3f}s "
            f"(answers encoded frames from its own engine); {len(results)} frames "
            f"after it equal the oracle, {after} of them over the ring")

        for name, server in servers.items():
            planes_idle(reads[name], f"serve:wire {name}")
            doc = server.ask("pool")
            pids = [p for p in doc["children"] if p > 0] + (
                [doc["zygote"]] if doc["zygote"] > 0 else [])
            doc = server.stop(120.0)
            left = harness.live_pids(pids)
            require(doc["stopped"] and doc["left"] == [] and left == [],
                    f"{name}: processes left after stop_all: {doc['left']} {left}")
            require(doc["b1"] == 0 and doc["b2"] == 0,
                    f"{name}: B1 {doc['b1']}, B2 {doc['b2']} launches")
            require(server.proc.returncode == 0, f"{name} server rc {server.proc.returncode}")
        say(f"[{tag} {at()}] stop_all: no process left in either server; 0 B1 and "
            f"0 B2 launches")
    finally:
        for server in servers.values():
            server.kill_group()  # a failure's backstop
    return out


# [device]: the device-aware planes — breaker, HBM admission, supervisor,
# scrubber and /debug — idle on every server, then drilled on the card

# the serve server's scrubber: a short interval for the drill; the replay
# kind stays off there (its oracle, CheckEngine over the columnar store,
# scans the columns per query) and is exercised by the CPU tests
SCRUB = {"enabled": True, "interval_s": 0.5, "sample_rows": 1024,
         "replay_per_cycle": 0}
DRILL_ROWS = 256  # rows of each packed drill batch


def planes_idle(read: str, tag: str, verify=True) -> dict:
    """/debug/device at the end of a phase without drills: the breaker
    closed with no failure and no oracle-answered batch, no quarantined
    shape, the card serving and no failover event."""
    status, doc = http("GET", f"{read}/debug/device", verify=verify)
    require(status == 200, f"[{tag}] GET /debug/device: {status}")
    br = doc.get("breaker") or {}
    require(br.get("open") is False and br.get("failures") == 0
            and br.get("real_failures") == 0
            and br.get("fallback_batches") == 0 and doc.get("quarantine") == []
            and doc.get("backend") == "cuda"
            and (doc.get("supervisor") or {}).get("timeline") == [],
            f"[{tag}] the device planes moved outside a drill: {doc}")
    say(f"[device] {tag}: breaker closed, 0 failures (0 real), 0 oracle-answered batches, "
        f"quarantine empty, backend cuda, no failover event")
    return doc


def _p50_pair(bare, wrapped, sample, want, reps: int = 10) -> tuple[float, float]:
    """p50 ms of `bare` and `wrapped` on the sample, in turns (bare, wrapped,
    wrapped, bare, ...), every answer held to `want`."""
    lat = {0: [], 1: []}
    for i in range(reps):
        order = (0, 1) if i % 2 == 0 else (1, 0)
        for k in order:
            fn = (bare, wrapped)[k]
            t0 = time.perf_counter()
            got = fn(sample)
            lat[k].append(time.perf_counter() - t0)
            require([bool(v) for v in got] == want, "breaker-cost answers differ")
    return pct(lat[0], 50), pct(lat[1], 50)


def _poisoned_row_sampled(seed: int, m: int, m_pad: int, n: int):
    """The row scrub.device_bitflip poisons with a scrubber rng of `seed`,
    if that rng's next sample holds it (the draws of scrub_residency), else
    None."""
    g = np.random.default_rng(seed)
    r = int(g.integers(m))
    g.integers(m_pad)
    rows = g.choice(m, size=min(n, m), replace=False)
    return r if r in rows else None


def _profile_kernels(read: str, urls: list[str], batcher) -> tuple[int, int, float]:
    """/debug/profile?seconds=1 while 64 clients drive GET /check (the
    capture starts once the batcher sees the drive): the archive's Chrome
    trace parsed; (CUDA kernel events, all events, the capture's seconds)."""
    import io
    import tarfile
    import threading

    fetch = port("utils.urlfetch", "fetch")
    drive = {}

    def run():
        drive["results"], drive["wall"] = http_clients(urls, 64)

    t = threading.Thread(target=run)
    t.start()
    try:
        start = batcher.n_dispatched
        deadline = time.monotonic() + 120
        while batcher.n_dispatched < start + 64 and time.monotonic() < deadline:
            time.sleep(0.01)  # the client process is up and driving
        t0 = time.perf_counter()
        status, body, headers = fetch(f"{read}/debug/profile?seconds=1")
        ctype = headers.get("Content-Type")
        secs = time.perf_counter() - t0
    finally:
        t.join()
    require(status == 200 and ctype == "application/gzip", f"/debug/profile {status} {ctype}")
    with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
        trace = json.loads(tar.extractfile("profile/trace.json").read())
    events = trace.get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    require(all(s in (200, 403) for s, _ in drive["results"]), "GET /check during the profile")
    if not kernels:  # what the capture did hold, for the failure's message
        from collections import Counter

        cats = Counter(e.get("cat") for e in events).most_common(8)
        names = Counter(e.get("name") for e in events).most_common(8)
        say(f"[device] the profile's events by category {cats}; by name {names}; "
            f"the drive's {len(drive['results'])} answers in {drive['wall']:.3f}s")
    return len(kernels), len(events), secs


def device_rbac(reg, store, sample, read, card, dev) -> dict:
    """[device] on the serve phase's server at rbac1m: the HBM budget; the
    breaker's own cost in device and in host query mode (the supervisor's
    CPU-failover mapping: host residency built, then home on the card); the
    scrub drill (a poisoned D cell detected, D rebuilt by B1, byte-equal to
    the plain build); /debug/scrub, /debug/overload, /debug/graph, and
    /debug/profile during a GET /check drive."""
    masked_spmv = port("engine", "masked_spmv")
    pack_adjacency = port("ops.closure", "pack_adjacency")
    FAULTS = port("faults", "FAULTS")
    eng, sup, breaker = reg.check_engine(), reg.device_supervisor(), reg._engine_breaker
    out = {}
    t_phase = time.perf_counter()
    status, doc = http("GET", f"{read}/debug/device")
    total = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    budget = doc["hbm"]["budget_bytes"]
    require(budget and budget > 0, f"no HBM budget on the card: {doc['hbm']}")
    out["budget_gib"] = budget / 2**30
    say(f"[device] HBM budget {out['budget_gib']:.3f} GiB (engine.memory.hbm_budget_frac "
        f"{doc['hbm']['budget_frac']} of the card's {torch.cuda.mem_get_info()[1] / 2**30:.3f} "
        f"GiB); nvidia-smi memory.total {total}; bytes per row {doc['hbm']['bytes_per_row']}")

    t0 = time.perf_counter()
    want = SetGraphOracle(store).batch(sample)
    oracle_s = time.perf_counter() - t0
    masked_spmv.masked_step.launches = 0  # the [device] rbac drills start here

    # the breaker's own cost: device query mode, then host query mode (the
    # supervisor's CPU failover: the residency rebuilt in host memory by the
    # numpy semiring builder, no launch), then home on the card
    out["device_ms"] = _p50_pair(eng.batch_check, breaker.batch_check, sample, want)
    t0 = time.perf_counter()
    require(sup._swap_to("cpu") and sup._reinit("cpu"), f"host failover: {sup.status()}")
    out["host_build_s"] = time.perf_counter() - t0
    require(eng.host_queries() and eng._state.d is None and eng._state.d_host is not None,
            "the host failover left D on the card")
    require(masked_spmv.masked_step.launches == 0, "the host residency launched B1")
    out["host_ms"] = _p50_pair(eng.batch_check, breaker.batch_check, sample, want)
    t0 = time.perf_counter()
    require(sup._reinit("cuda", homecoming=True), f"homecoming: {sup.status()}")
    out["home_s"] = time.perf_counter() - t0
    require(not eng.host_queries() and eng._state.d is not None, "not home on the card")
    home_launches = masked_spmv.masked_step.launches
    expected = (eng._state.m_pad // 256) * (5 - 2)
    require(home_launches == expected, f"homecoming: {home_launches} B1 launches")
    (db, dw), (hb, hw) = out["device_ms"], out["host_ms"]
    say(f"[device] breaker cost, batch_check of {len(sample)} p50 of 10 in turns: device "
        f"query mode bare {db:.3f} ms / breaker {dw:.3f} ms = {dw / db:.3f}x; host query "
        f"mode bare {hb:.3f} / {hw:.3f} ms = {hw / hb:.3f}x; every answer the oracle's "
        f"(set-graph oracle {oracle_s:.1f}s); host failover build {out['host_build_s']:.3f}s "
        f"(0 B1), home {out['home_s']:.3f}s ({home_launches} B1)")

    # the scrub drill: the scrubber's rng seeded so its first sample holds
    # the row the fault poisons (sampling 1024 of m rows finds one poisoned
    # row with probability 1024/m a cycle); the drill then times detection
    # and repair
    daemon = reg.scrubber()
    st = eng._state
    m, m_pad = st.ig.m, st.m_pad
    seed, row = next((s, r) for s in range(100_000)
                     if (r := _poisoned_row_sampled(s, m, m_pad, daemon.sample_rows)) is not None)
    daemon._rng = np.random.default_rng(seed)
    b1_before = masked_spmv.masked_step.launches
    FAULTS.arm("scrub.device_bitflip")
    t_arm, wall_arm = time.perf_counter(), time.time()
    daemon.start()
    deadline = t_arm + 60
    while daemon.repairs.get("reset_residency", 0) < 1 and time.perf_counter() < deadline:
        time.sleep(0.01)
    found_s = time.perf_counter() - t_arm
    require(daemon.repairs.get("reset_residency") == 1, f"no repair: {daemon.snapshot()}")
    cycles = daemon.cycles
    while daemon.cycles < cycles + 1 and time.perf_counter() < deadline:
        time.sleep(0.01)  # the next cycle, after the repair
    daemon.stop()
    repair_launches = masked_spmv.masked_step.launches - b1_before
    hist = daemon.history()
    dev_find = [f for f in hist[0]["findings"] if f.get("kind") == "device"]
    require(len(hist) == 1 and dev_find and dev_find[0]["bad_rows"] == [row],
            f"the scrub did not report exactly row {row}: {hist}")
    require(daemon.mismatches == {"device": 1} and daemon.cycles >= cycles + 1
            and daemon.last_clean_version == store.version,
            f"the cycle after the repair is not clean: {daemon.snapshot()}")
    ev = [e for e in sup.status()["timeline"] if e["event"] == "scrub_reset_residency"]
    require(len(ev) == 1 and ev[0]["ok"], f"supervisor timeline {sup.status()}")
    out["repair_s"] = ev[0]["seconds"]
    out["detect_s"] = ev[0]["t"] - ev[0]["seconds"] - wall_arm
    require(repair_launches == expected, f"scrub repair: {repair_launches} B1 launches")
    st = eng._state
    d_plain = masked_spmv.build_closure_semiring(
        pack_adjacency(st.ig.ii_src, st.ig.ii_dst, st.m_pad), st.ig.m, m_pad=st.m_pad,
        k_max=st.k_max, device=dev, step=masked_spmv.masked_step_plain,
    )
    require(torch.equal(st.d, d_plain), "the repaired D differs from the plain build")
    del d_plain
    require([bool(v) for v in eng.batch_check(sample)] == want,
            "answers after the repair differ from the oracle")
    say(f"[device] scrub drill: row {row} of m={m} poisoned on the card (rng seed {seed}); "
        f"detected {out['detect_s']:.3f}s after arming (interval {daemon.interval_s}s, "
        f"{daemon.sample_rows} rows a cycle), repaired by reset_residency in "
        f"{out['repair_s']:.3f}s ({repair_launches} B1 launches), D byte-equal to the "
        f"plain build, the next cycle clean, {len(sample)} answers the oracle's; "
        f"{found_s:.3f}s from arming to the repair's end")

    # /debug pages
    status, doc = http("GET", f"{read}/debug/scrub")
    require(status == 200 and doc["mismatches"] == {"device": 1}
            and doc["repairs"].get("reset_residency") == 1 and doc["history"],
            f"/debug/scrub {status} {doc}")
    status, ov = http("GET", f"{read}/debug/overload")
    require(status == 200 and ov == {"enabled": False}, f"/debug/overload {status} {ov}")
    status, graph = http("GET", f"{read}/debug/graph")
    devs = graph["devices"]
    require(status == 200 and devs and devs[0]["memory_stats"]["bytes_in_use"] > 0
            and graph["graph"]["tuples"] == len(store) and graph["transfer_bytes"],
            f"/debug/graph {status} {graph}")
    say(f"[device] /debug/scrub: {doc['cycles']} cycles, mismatches {doc['mismatches']}, "
        f"repairs {doc['repairs']}; /debug/overload {ov}; /debug/graph: "
        f"{devs[0]['device_kind']}, in use {devs[0]['memory_stats']['bytes_in_use'] / 2**30:.3f} "
        f"GiB, reserved {devs[0]['memory_stats']['bytes_reserved'] / 2**30:.3f} GiB, kernel "
        f"builds {graph['jit_compilations']} ({graph['jit_compile_seconds']}s)")

    kernels, events, secs = _profile_kernels(
        read, [f"{read}/check?{tuple_query(t)}" for t in sample], reg.checker())
    require(kernels > 0, f"the profile holds no CUDA kernel event ({events} events)")
    out["launches"] = masked_spmv.masked_step.launches  # the rbac drills end here
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"[device] /debug/profile?seconds=1 during {len(sample)} GET /check from 64 clients: "
        f"{kernels} CUDA kernel events of {events} in the archive ({secs:.3f}s)")
    return out


class _SetOracle:
    """SetGraphOracle as the breaker's host oracle (``batch_check`` and
    ``subject_is_allowed``) in the packed drills that time the breaker's
    paths. The registry's oracle is the host CheckEngine over the store,
    seconds a check at github10m; the bounded-oracle drill drives that one,
    under a deadline (bounded_oracle_drill)."""

    def __init__(self, store):
        self.so = SetGraphOracle(store)

    def batch_check(self, requests, max_depth=0):
        return self.so.batch(requests, max_depth or 5)

    def subject_is_allowed(self, requested, max_depth=0):
        return self.so.check(requested, max_depth or 5)


class _Readiness:
    def __init__(self):
        self.log = []

    def set_serving(self, serving):
        self.log.append(bool(serving))


def device_packed(eng, store, sample, want) -> dict:
    """[device] on the github10m packed engine, wrapped as the registry
    wraps it (the breaker over it, the supervisor on the breaker's hook, a
    pipelined CheckBatcher with HbmAdmission) but for the breaker's oracle,
    which is the set-graph oracle here (see _SetOracle): each drill's batch
    is DRILL_ROWS rows of the sample, held to `want`."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    DeviceFallbackEngine, classify = port(
        "engine.fallback", "DeviceFallbackEngine", "classify_device_error")
    HbmAdmission = port("engine.hbm", "HbmAdmission")
    DeviceSupervisor = port("driver.registry", "DeviceSupervisor")
    CheckBatcher = port("engine.batcher", "CheckBatcher")
    CheckColumns = port("relationtuple.columns", "CheckColumns")
    FAULTS = port("faults", "FAULTS")
    packed = port("ops", "packed")

    t_phase = time.perf_counter()
    oracle = _SetOracle(store)
    rows, rows_want = sample[:DRILL_ROWS], want[:DRILL_ROWS]
    require(oracle.batch_check(rows) == rows_want, "the set-graph oracle differs from the card")
    health = _Readiness()
    sup = DeviceSupervisor(eng, warm_batch=4096, probe_timeout_s=120.0)
    breaker = DeviceFallbackEngine(
        eng, fallback_factory=lambda: oracle, failure_threshold=3, cooldown_s=1.0,
        health=health, on_device_lost=sup.notify_device_lost,
    )
    sup.bind_breaker(breaker)
    hbm = HbmAdmission()
    batcher = CheckBatcher(breaker, pipeline_depth=2, encode_workers=2, hbm=hbm)
    cols = CheckColumns.from_tuples(rows)
    out = {"lines": []}

    def drill(name, check, detail):
        launches = packed.packed_propagate.launches
        t0 = time.perf_counter()
        got = check()
        secs = time.perf_counter() - t0
        b2 = packed.packed_propagate.launches - launches
        line = (f"[device] packed {name}: {detail(b2)}; {secs:.3f}s; breaker "
                f"{breaker.breaker_snapshot()}")
        say(line)
        out["lines"].append(line)
        return got, b2, secs

    def columnar():
        return batcher.check_batch_columnar(cols)

    packed.packed_propagate.launches = 0  # the [device] packed drills start here
    try:
        # device.oom: bisected, answered exactly, the breaker stays closed
        FAULTS.arm("device.oom")
        got, b2, _ = drill("device.oom", columnar, lambda b2: (
            f"{DRILL_ROWS} rows bisected ({breaker.n_bisections} bisections), {b2} B2 "
            f"launches"))
        require(got == rows_want and not breaker.circuit_open() and b2 > 0
                and breaker.n_bisections == 1 and breaker.n_fallback_batches == 0,
                "device.oom drill")

        # device.batch_nan x3: open, the oracle answers, the probe closes it
        FAULTS.arm("device.batch_nan", times=3)
        for i in range(3):
            got, b2, _ = drill(f"device.batch_nan {i + 1}/3", columnar,
                               lambda b2: f"garbage answered by the oracle, {b2} B2")
            require(got == rows_want, "batch_nan answers")
        require(breaker.circuit_open() and health.log == [False], "batch_nan: not open")
        time.sleep(1.0 * 1.25 + 0.05)  # the cooldown and its most jitter
        got, b2, _ = drill("half-open probe", columnar, lambda b2: f"{b2} B2 launches")
        require(got == rows_want and b2 > 0 and not breaker.circuit_open()
                and health.log == [False, True], f"the probe: {health.log}")

        # device.lost: the supervisor's child probe on the card,
        # reset_residency, warmup and force_probe; then backend.probe_hang:
        # one failed probe (no host residency to fail over to), then the same
        for name, hang, expect in (
            ("device.lost", False, ["device_lost", "probe", "recovered"]),
            ("backend.probe_hang", True,
             ["device_lost", "probe", "swap_failed", "probe", "recovered"]),
        ):
            n_fb = breaker.n_fallback_batches
            n_ev = len(sup.status()["timeline"])
            if hang:
                FAULTS.arm("backend.probe_hang")
            FAULTS.arm("device.lost")
            got, _, _ = drill(name, columnar, lambda b2: "the lost batch answered by the oracle")
            require(got == rows_want and breaker.circuit_open(), f"{name}: lost batch")
            t0 = time.perf_counter()
            st = sup.status()
            while st["recovering"] and time.perf_counter() - t0 < 300:
                time.sleep(0.05)
                st = sup.status()
            new = st["timeline"][n_ev:]
            events = [e["event"] for e in new]
            probes = [e for e in new if e["event"] == "probe"]
            require(st["backend"] == "cuda" and events == expect
                    and probes[-1]["ok"], f"{name}: {st}")
            got, b2, _ = drill(f"{name} recovered", columnar, lambda b2: (
                f"recovered in {st['last_recovery_s']:.3f}s, timeline {events}, probes "
                f"{[(p['ok'], p['detail']) for p in probes]}; {b2} B2 launches"))
            require(got == rows_want and b2 > 0 and not breaker.circuit_open()
                    and breaker.n_fallback_batches == n_fb + 1, f"{name}: after")
            out[name] = st["last_recovery_s"]
        require(health.log == [False, True] * 3, f"readiness {health.log}")

        # reconfigure under 512 closed-loop submitters: 2 -> 0 -> 2
        stop, errs, answered = [False], [], [0]
        lock = threading.Lock()

        def submit(i):
            j = i
            while not stop[0]:
                t = sample[j % len(sample)]
                try:
                    ok = batcher.check(t, timeout=120) == want[j % len(sample)]
                except Exception as e:
                    errs.append(repr(e))
                    return
                with lock:
                    answered[0] += 1
                if not ok:
                    errs.append(f"wrong answer for {t}")
                    return
                j += 512

        launches = packed.packed_propagate.launches
        t0 = time.perf_counter()
        with ThreadPoolExecutor(512) as pool:
            futs = [pool.submit(submit, i) for i in range(512)]
            shapes = []
            for depth in (0, 2):
                time.sleep(1.5)
                require(batcher.reconfigure(pipeline_depth=depth), "reconfigure no-op")
                shapes.append((batcher.pipeline_depth, batcher.pipelined))
            time.sleep(1.5)
            stop[0] = True
            for f in futs:
                f.result(timeout=300)
        secs = time.perf_counter() - t0
        b2 = packed.packed_propagate.launches - launches
        require(not errs and answered[0] >= 512, f"reconfigure drill: {errs[:3]}")
        line = (f"[device] packed reconfigure under 512 closed-loop submitters: depth 2 -> "
                f"{shapes[0]} -> {shapes[1]}, {answered[0]} checks answered, none lost or "
                f"wrong, {b2} B2 launches; {secs:.3f}s")
        say(line)

        # device.compile_fail, last: one shape quarantined (for the rest of this
        # snapshot) while another shape launches
        n_fb = breaker.n_fallback_batches
        FAULTS.arm("device.compile_fail")
        got, b2, _ = drill("device.compile_fail", columnar, lambda b2: (
            f"shape quarantined {breaker.quarantine_snapshot()}, {b2} B2 launches"))
        require(got == rows_want and b2 == 0 and len(breaker.quarantine_snapshot()) == 1
                and not breaker.circuit_open(), "device.compile_fail drill")
        # another bucket (8192) at the same snapshot, through the breaker
        # (the batcher never forms a batch past max_batch 4096)
        big = sample + rows
        got, b2, _ = drill("another shape", lambda: breaker.decode_launched(
            breaker.launch_encoded(eng.encode_batch(big))), lambda b2: (
            f"{len(big)} rows in bucket 8192 launch ({b2} B2 launches)"))
        require(got == want + rows_want and b2 > 0, "the other shape")
        require(breaker.n_fallback_batches == n_fb + 1, "compile_fail: oracle batches")

        # the bounded oracle: the registry's own oracle under a deadline
        out["bounded"] = bounded_oracle_drill(eng, store, sample, want, hbm)

        # a real out-of-memory on the card: more than the card holds (the
        # free memory alone is no bound: the caching allocator's reserve
        # is not counted free, and serves an allocation past it)
        size = torch.cuda.mem_get_info()[1] + (1 << 30)
        try:
            torch.empty(size, dtype=torch.uint8, device="cuda")
            require(False, "an allocation past the card's memory succeeded")
        except torch.cuda.OutOfMemoryError as e:
            kind = classify(e)
            require(kind == "oom", f"a real CUDA OOM classified {kind}")
            say(f"[device] real OOM: torch.empty of {size / 2**30:.3f} GiB "
                f"raised {type(e).__name__} ({str(e)[:80]!r}...), classified {kind}")
        torch.cuda.empty_cache()
        snap = hbm.snapshot()
        DEVSTATS = port("telemetry.devstats", "DEVSTATS")
        say(f"[device] packed HBM admission: budget {snap['budget_bytes'] / 2**30:.3f} GiB, "
            f"learned {snap['bytes_per_row']} bytes per row over {snap['modeled_shapes']} "
            f"shapes (per-batch peak windows), {hbm.n_splits} pre-splits, in flight "
            f"{snap['inflight_batches']}; the process high-water mark "
            f"{DEVSTATS.peak_bytes() / 2**30:.3f} GiB")
        require(snap["modeled_shapes"] >= 1, "HBM admission learned no shape")
        out["hbm"] = snap
    finally:
        batcher.close()
        sup.stop()
        FAULTS.reset()
    out["launches"] = packed.packed_propagate.launches  # the packed drills end here
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def serve_grpc(reg, read_port: int, expect: dict, expand_doc: dict) -> None:
    """[grpc]: the cat-videos Check and Expand over gRPC on the muxed read
    port, against the REST answers; where grpc or protobuf do not import,
    the line says that the plane is off and REST served alone."""
    if not reg.grpc_enabled:
        say(f"[grpc] the gRPC plane is off on this machine ({reg.grpc_off_reason}); "
            f"start_all served REST without it on the same ports")
        return
    services, convert = port("api", "services", "convert")
    check_pb2, expand_pb2 = port(
        "api.gen.ory.keto.acl.v1alpha1", "check_service_pb2", "expand_service_pb2"
    )
    RelationTuple, SubjectSet = port("relationtuple", "RelationTuple", "SubjectSet")
    channel = services.grpc.insecure_channel(f"127.0.0.1:{read_port}")
    try:
        stub = services.CheckServiceStub(channel)
        for q, allowed in expect.items():
            p = convert.tuple_to_proto(RelationTuple.from_string(q))
            resp = stub.Check(check_pb2.CheckRequest(
                namespace=p.namespace, object=p.object, relation=p.relation,
                subject=p.subject), timeout=60)
            require(resp.allowed == allowed, f"gRPC Check {q}: {resp.allowed}")
        root = convert.subject_to_proto(SubjectSet("videos", "/cats/1.mp4", "view"))
        resp = services.ExpandServiceStub(channel).Expand(
            expand_pb2.ExpandRequest(subject=root), timeout=60)
        require(convert.tree_from_proto(resp.tree).to_dict() == expand_doc,
                "gRPC Expand differs from GET /expand")
    finally:
        channel.close()
    say(f"[grpc] cat-videos over gRPC on the muxed read port :{read_port}: "
        f"{len(expect)}/{len(expect)} Check equal REST, Expand equal GET /expand "
        f"(grpcio {services.grpc.__version__}, protobuf "
        f"{sys.modules['google.protobuf'].__version__})")


def serve_columnar_encoded(store, edges, sample, want, read, write, at) -> dict:
    """The columnar and the encoded batch forms on the running server: the
    sample's answers equal the tuple body's and the oracle's; the encoded
    tier's 409 after a write that interns a key, then sync and resend."""
    VocabCache = port("client", "VocabCache")
    k = len(sample)
    out = {}
    body = columnar_body(sample)
    lat = []
    for _ in range(6):
        t0 = time.perf_counter()
        status, doc = http("POST", f"{read}/check/batch", body)
        lat.append(time.perf_counter() - t0)
        require(status == 200 and doc["allowed"] == want,
                "columnar /check/batch answers differ from the oracle")
    out["columnar_p50_ms"] = pct(lat[1:], 50)
    out["columnar_rate"] = k * len(lat[1:]) / sum(lat[1:])

    t0 = time.perf_counter()
    cache = VocabCache(read, timeout=120.0).bootstrap()
    out["bootstrap_s"] = time.perf_counter() - t0
    out["vocab_keys"] = len(cache)
    require(cache.epoch == len(store.vocab), f"epoch {cache.epoch}")
    t0 = time.perf_counter()
    frame = cache.frame(sample)
    out["encode_ms"] = (time.perf_counter() - t0) * 1e3
    lat = []
    for _ in range(6):
        t0 = time.perf_counter()
        status, got = post_encoded(read, frame)
        lat.append(time.perf_counter() - t0)
        require(status == 200 and got == want,
                f"/check/batch-encoded answers differ from the oracle: {status}")
    out["encoded_p50_ms"] = pct(lat[1:], 50)
    out["encoded_rate"] = k * len(lat[1:]) / sum(lat[1:])
    say(f"[serve {at()}] {k} checks as a columnar /check/batch x6 and as "
        f"encoded frames x6 (VocabCache of {len(cache)} keys over "
        f"/vocab/snapshot): all equal the oracle")

    # one write that interns a key moves the epoch: the next frame is a 409
    res, grp = next((r, d) for r, d in zip(*edges["grant"]) if d[1].startswith("g"))
    user = ("encoded-user",)
    status, _ = http("PUT", f"{write}/relation-tuples", to_tuple(grp, user).to_dict())
    require(status == 201, f"PUT {status}")
    probes = sample + [to_tuple(res, user)]
    status, doc = post_encoded(read, cache.frame(probes))
    details = doc.get("error", {}).get("details", {}) if status != 200 else {}
    require(status == 409 and details.get("reason") == "vocab_epoch_mismatch"
            and details.get("server_epoch") == cache.epoch + 1,
            f"a stale frame after the write: {status} {doc}")
    t0 = time.perf_counter()
    cache.sync()
    out["sync_ms"] = (time.perf_counter() - t0) * 1e3
    status, got = post_encoded(read, cache.frame(probes))
    require(status == 200 and got == SetGraphOracle(store).batch(probes)
            and got[-1], "answers after the write and sync differ from the oracle")
    # take the write back: the list phase holds list-subjects against the
    # users of the generated pool, which this user is not one of
    status, _ = http("DELETE", f"{write}/relation-tuples?"
                     + tuple_query(to_tuple(grp, user)))
    require(status == 204, f"DELETE {status}")
    say(f"[serve {at()}] after a write: the stale frame 409 "
        f"(vocab_epoch_mismatch), sync over /vocab/deltas to epoch "
        f"{cache.epoch}, the resend equals the oracle ({to_tuple(res, user)} "
        f"allowed); the write taken back")
    return out


def serve_cache(args, at) -> dict:
    """A server with the default engine.cache_size: the sample as GET /check
    from 64 clients twice (the hit share and p50 of each pass), then writes
    that flip a sampled answer and back, each seen by the next GET /check:
    the cache's stamp is the answering version."""
    Config, Registry = port("driver", "Config", "Registry")
    masked_spmv = port("engine", "masked_spmv")
    reg = Registry(Config(values=serve_config("auto")))
    store, pools, edges = gen_rbac(
        args.tuples, np.random.default_rng(args.seed + 1), store=reg.store()
    )
    masked_spmv.masked_step.launches = 0  # this server's path starts here
    read_port, write_port = reg.start_all()
    read = f"http://127.0.0.1:{read_port}"
    write = f"http://127.0.0.1:{write_port}"
    eng, batcher = reg.check_engine(), reg.checker()
    cache = batcher.cache
    require(cache is not None and cache.capacity == 65536, "the default cache")
    out = {}
    try:
        sample, _ = chain_sample(np.random.default_rng(args.seed + 3), pools,
                                 edges, args.checks)
        want = SetGraphOracle(store).batch(sample)
        urls = [f"{read}/check?{tuple_query(t)}" for t in sample]
        for rep in (1, 2):
            h0, m0 = cache.hits, cache.misses
            batcher.n_batches = batcher.n_dispatched = 0
            singles, wall = http_clients(urls, 64)
            require([status == 200 for status, _ in singles] == want
                    and all(status in (200, 403) for status, _ in singles),
                    f"GET /check pass {rep} answers differ from the oracle")
            hits, misses = cache.hits - h0, cache.misses - m0
            out[f"hit{rep}"] = hits / max(1, hits + misses)
            out[f"p50_{rep}"] = pct([sec for _, sec in singles], 50)
            out[f"rate{rep}"] = len(urls) / wall
            out[f"mean_batch{rep}"] = batcher.mean_batch_size()
        require(out["hit2"] > 0.99, f"pass 2 hit share {out['hit2']}")
        # a write that flips a sampled answer, then its delete: the next GET
        # /check shows each (a stale cached answer would not)
        i = want.index(False)
        flip = sample[i]
        for method, expect in (("PUT", True), ("DELETE", False)):
            url = f"{write}/relation-tuples"
            if method == "PUT":
                status, _ = http("PUT", url, flip.to_dict())
            else:
                status, _ = http("DELETE", url + "?" + tuple_query(flip))
            require(status in (201, 204), f"{method} {status}")
            require(rest_check(read, flip) == expect,
                    f"GET /check after the {method} of {flip} is not {expect}")
        require(eng.n_full_builds == 1 and not eng._overlay.broken,
                f"cache server builds full={eng.n_full_builds}")
        out["launches"] = masked_spmv.masked_step.launches  # ends here
        say(f"[serve {at()}] cache server: {len(urls)} GET /check x2 equal the "
            f"oracle, pass 2 hit share {out['hit2']:.4f}; {flip} flipped by a "
            f"write and back by its delete, each seen by the next GET /check; "
            f"{out['launches']} B1 launches")
        planes_idle(read, "serve:cache")
    finally:
        reg.stop_all()
    return out


def tree_nodes(doc: dict) -> int:
    """Nodes of an Expand tree's JSON form: the length of flat_subjects()."""
    n, stack = 0, [doc]
    while stack:
        node = stack.pop()
        n += 1
        stack.extend(node.get("children", ()))
    return n


def serve_expand_list(reg, store, pools, edges, rng, read, write, at, card) -> dict:
    """[serve:expand+list]: Expand and the list routes over REST on the
    running server, after the mixed writes. Returns the phase's numbers."""
    DEVSTATS = port("telemetry.devstats", "DEVSTATS")
    from urllib.parse import urlencode

    CheckEngine, masked_spmv = port("engine", "CheckEngine", "masked_spmv")
    ExpandEngine = port("engine.expand", "ExpandEngine")
    _rows_min = port("engine.listing", "_rows_min")
    Tree, apply_expand_patches = port("engine.tree", "Tree", "apply_expand_patches")
    SubjectID, SubjectSet = port("relationtuple", "SubjectID", "SubjectSet")

    tag = "serve:expand+list"
    eng, le, xe = reg.check_engine(), reg.list_engine(), reg.expand_engine()
    require(le is not None, "the registry built no list engine")
    users, resources = pools["users"], pools["resources"]
    q_users = [users[i][0] for i in rng.choice(len(users), 64, replace=False)]
    q_res = [resources[i][1] for i in rng.choice(len(resources), 64, replace=False)]

    def list_objects(user, **extra):
        q = {"namespace": "rbac", "relation": "view", "subject_id": user, **extra}
        return http("GET", f"{read}/relation-tuples/list-objects?{urlencode(q)}")

    def list_subjects(res, **extra):
        q = {"namespace": "rbac", "object": res, "relation": "view", **extra}
        return http("GET", f"{read}/relation-tuples/list-subjects?{urlencode(q)}")

    # 1. the first list query after the writes rebuilds the closure: the
    # overlay's absorbed writes are folded in (the reverse CSRs are
    # snapshot-time), then D^T and the reverse CSRs are built
    full0, n_rev0 = eng.n_full_builds, le.n_reverse
    masked_spmv.masked_step.launches = 0  # the list path's rebuild starts here
    t0 = time.perf_counter()
    status, doc = list_objects(q_users[0])
    first_s = time.perf_counter() - t0
    launches = masked_spmv.masked_step.launches
    require(status == 200, f"first list-objects: {status} {doc}")
    m_pad = eng._state.m_pad
    expected = (m_pad // 256) * (5 - 2)
    require(eng.n_full_builds == full0 + 1 and launches == expected,
            f"first list query: {eng.n_full_builds - full0} full builds, "
            f"{launches} B1 launches, expected one build of {expected}")
    view = eng.reverse_artifacts()
    require(view.d_rev.is_cuda and torch.equal(view.d_rev, view.d.t()),
            "D^T on the card is not the transpose of D")
    phases = {k: round(v, 4) for k, v in eng.last_build_phases.items()}
    say(f"[{tag} {at()}] first list-objects after the writes {first_s:.3f}s: "
        f"rebuild phases {phases}, D^T + reverse CSRs "
        f"{eng.last_reverse_build_s:.4f}s, {launches} B1 launches (one full "
        f"build at m_pad {m_pad}); D^T [{m_pad}, {m_pad}] on the card equals "
        f"D.t(), {view.d_rev.numel() / 1e6:.1f} MB")

    # 2. list-objects for 64 users; 8 against check_ids over every resource
    # (the forward-D check path on the card)
    vocab = view.snap.vocab
    dummy = view.snap.dummy_node

    def ids(keys):
        out = vocab.lookup_bulk(list(keys))
        return np.where(out < 0, dummy, out)

    res_ids = ids(resources)
    user_ids = ids(users)
    lat, n_items, answers = [], [], {}
    for u in q_users:
        t0 = time.perf_counter()
        status, doc = list_objects(u)
        lat.append(time.perf_counter() - t0)
        require(status == 200, f"list-objects {u}: {status} {doc}")
        answers[u] = doc["objects"]
        n_items.append(len(doc["objects"]))
    for u in q_users[:8]:
        target = vocab.lookup((u,))
        allowed = eng.check_ids(
            res_ids, np.full(len(res_ids), dummy if target is None else target),
            np.ones(len(res_ids), dtype=bool),
        )
        want = {resources[i][1] for i in np.nonzero(allowed)[0]}
        require(set(answers[u]) == want and len(answers[u]) == len(want),
                f"list-objects {u}: {len(answers[u])} objects, check_ids "
                f"allows {len(want)}")
    numbers = {"objects_p50_ms": pct(lat, 50), "objects_p99_ms": pct(lat, 99),
               "objects_mean": float(np.mean(n_items)), "first_s": first_s,
               "launches": launches, "reverse_s": eng.last_reverse_build_s,
               "phases": phases}
    # where a list query's time goes: the engine in process (no HTTP, no
    # JSON), and its one device op, the D^T row gather and min, alone
    u = next(u for u in q_users if answers[u])
    lat = []
    for _ in range(8):
        t0 = time.perf_counter()
        le.list_objects(SubjectID(u), "view", "rbac")
        lat.append(time.perf_counter() - t0)
    ig, uid = view.ig, vocab.lookup((u,))
    l_idx = ig.id_in_vals[ig.id_in_indptr[uid] : ig.id_in_indptr[uid + 1]]
    numbers.update(
        engine_p50_ms=pct(lat, 50),
        rows_min_ms=cuda_ms(lambda: _rows_min(view.d_rev, l_idx.astype(np.int64)), 20),
        transpose_ms=cuda_ms(lambda: view.d.t().contiguous(), 5),
    )
    say(f"[{tag} {at()}] 64 list-objects over REST, mean "
        f"{numbers['objects_mean']:.1f} objects; 8 equal the card's check_ids "
        f"over all {len(resources)} resources")

    # 3. list-subjects for 64 resources; 8 against check_ids over every user
    lat, n_items, subj_answers = [], [], {}
    for r in q_res:
        t0 = time.perf_counter()
        status, doc = list_subjects(r)
        lat.append(time.perf_counter() - t0)
        require(status == 200, f"list-subjects {r}: {status} {doc}")
        subj_answers[r] = doc["subject_ids"]
        n_items.append(len(doc["subject_ids"]))
    for r in q_res[:8]:
        start = vocab.lookup(("rbac", r, "view"))
        allowed = eng.check_ids(
            np.full(len(user_ids), dummy if start is None else start), user_ids,
            np.ones(len(user_ids), dtype=bool),
        )
        want = {users[i][0] for i in np.nonzero(allowed)[0]}
        require(set(subj_answers[r]) == want and len(subj_answers[r]) == len(want),
                f"list-subjects {r}: {len(subj_answers[r])} ids, check_ids "
                f"allows {len(want)}")
    numbers.update(subjects_p50_ms=pct(lat, 50), subjects_p99_ms=pct(lat, 99),
                   subjects_mean=float(np.mean(n_items)))
    say(f"[{tag} {at()}] 64 list-subjects over REST, mean "
        f"{numbers['subjects_mean']:.1f} ids; 8 equal the card's check_ids over "
        f"all {len(users)} users")

    # 4. two users and two resources against the host oracles on 256
    # candidates each: half from the answer, half drawn at random. The
    # set-graph oracle settles all 256; CheckEngine (a full BFS per check)
    # the first 16 of each
    so = SetGraphOracle(store)
    base = CheckEngine(IndexedTuples(store), max_depth=5)
    n_cand = 0
    for kind, key in [("objects", u) for u in q_users[:2]] + [
            ("subjects", r) for r in q_res[:2]]:
        got = answers[key] if kind == "objects" else subj_answers[key]
        pool_keys = ([r[1] for r in resources] if kind == "objects"
                     else [u[0] for u in users])
        picks = [got[i] for i in rng.choice(len(got), min(128, len(got)),
                                             replace=False)] if got else []
        picks += [pool_keys[i] for i in rng.integers(len(pool_keys),
                                                     size=256 - len(picks))]
        cands = [to_tuple(("rbac", c, "view"), (key,)) if kind == "objects"
                 else to_tuple(("rbac", key, "view"), (c,)) for c in picks]
        got_set = set(got)
        want = [c in got_set for c in picks]
        require(so.batch(cands) == want,
                f"list-{kind} {key}: the set-graph oracle disagrees")
        require(base.batch_check(cands[:16]) == want[:16],
                f"list-{kind} {key}: CheckEngine disagrees")
        n_cand += len(cands)
    say(f"[{tag} {at()}] 2 list-objects and 2 list-subjects answers hold on "
        f"{n_cand} candidates against the set-graph oracle, the first 16 "
        f"of each against CheckEngine")

    # 5. Expand of 64 resources at max-depth 5; 16 node for node against
    # the host ExpandEngine over the same store, 4 paged and stitched
    lat, sizes, trees = [], [], {}
    for r in q_res:
        q = urlencode({"namespace": "rbac", "object": r, "relation": "view",
                       "max-depth": 5})
        t0 = time.perf_counter()
        status, doc = http("GET", f"{read}/expand?{q}")
        lat.append(time.perf_counter() - t0)
        require(status == 200, f"expand {r}: {status}")
        trees[r] = doc
        sizes.append(0 if doc is None else tree_nodes(doc))
    numbers.update(expand_p50_ms=pct(lat, 50), expand_p99_ms=pct(lat, 99),
                   expand_mean=float(np.mean(sizes)), expand_max=max(sizes))
    host = ExpandEngine(IndexedTuples(store), max_depth=5)
    for r in q_res[:16]:
        want = host.build_tree(SubjectSet("rbac", r, "view"), 5)
        require((want and want.to_dict()) == trees[r],
                f"expand {r}: the snapshot engine's tree != the host engine's")
        require(want is None or len(want.flat_subjects()) == tree_nodes(trees[r]),
                f"expand {r}: node count")
    # paged over REST: the three smallest non-empty trees (a big tree's
    # tokens carry its visited set, ~10^4 node ids, past the 64 KiB request
    # line of http.server); the smallest big tree pages through the same
    # engine object in process
    small = sorted((s, r) for s, r in zip(sizes, q_res) if s)[:3]
    bigs = [(s, r) for s, r in zip(sizes, q_res) if s > 4096]
    require(len(small) == 3 and bigs, f"expand tree sizes {sorted(sizes)}")
    big = min(bigs)
    n_pages = []
    for size, r in small + [big]:
        subject = SubjectSet("rbac", r, "view")
        token, tree, pages = "", None, 0
        while True:
            if size <= 4096:
                q = {"namespace": "rbac", "object": r, "relation": "view",
                     "max-depth": 5, "page_size": 256}
                if token:
                    q["page_token"] = token
                status, page = http("GET", f"{read}/expand?{urlencode(q)}")
                require(status == 200, f"paged expand {r}: {status}")
            else:
                page = xe.build_tree_page(subject, 5, page_size=256,
                                          page_token=token).to_dict()
            if tree is None:
                tree = Tree.from_dict(page["tree"])
            else:
                apply_expand_patches(tree, [(p["path"], p["tree"])
                                            for p in page.get("patches", ())])
            pages += 1
            token = page.get("next_page_token", "")
            if not token:
                break
        require(tree.to_dict() == trees[r], f"paged expand {r}: stitched != unpaged")
        n_pages.append(pages)
    say(f"[{tag} {at()}] 64 GET /expand at max-depth 5 ({sum(s > 0 for s in sizes)} "
        f"non-empty, mean {numbers['expand_mean']:.1f} nodes, largest "
        f"{numbers['expand_max']}); 16 equal the host ExpandEngine node for "
        f"node; 4 paged at 256 ({n_pages} pages; the last, {big[0]} nodes, "
        f"in process) equal the unpaged trees")

    # 6. one paged list-objects at max-depth 3 (tens of pages; at depth 5
    # a user sees ~10^4 resources) equals the unpaged answer; a write
    # turns the next page's token into a 409
    u = next(u for u in q_users if answers[u])
    status, full = list_objects(u, **{"max-depth": 3})
    require(status == 200 and len(full["objects"]) > 200,
            f"paged list-objects {u}: {len(full.get('objects', []))} objects")
    items, token, pages = [], "", 0
    while True:
        extra = {"max-depth": 3, "page_size": 100}
        if token:
            extra["page_token"] = token
        status, page = list_objects(u, **extra)
        require(status == 200, f"page {pages} of {u}: {status} {page}")
        items += page["objects"]
        pages += 1
        token = page["next_page_token"]
        if not token or pages == 3:
            break
    stale = token
    while token:
        status, page = list_objects(u, **{"max-depth": 3, "page_size": 100,
                                          "page_token": token})
        items += page["objects"]
        pages += 1
        token = page["next_page_token"]
    require(items == full["objects"], f"paged list-objects {u} != unpaged")
    require(le.n_oracle == 0 and le.n_reverse == n_rev0 + 2 * 64 + 2 + 8 + pages,
            f"list answers: {le.n_reverse - n_rev0} reverse, {le.n_oracle} oracle"
            f" ({le.last_failure!r})")
    page = le.list_objects(SubjectID(u), "view", "rbac")
    require(page.source == "reverse", "an in-process list query took the oracle")
    g_src, g_dst = edges["grant"]
    status, _ = http("PUT", f"{write}/relation-tuples",
                     to_tuple(g_src[0], ("list-user",)).to_dict())
    require(status == 201, f"PUT {status}")
    status, doc = list_objects(u, **{"max-depth": 3, "page_size": 100,
                                     "page_token": stale})
    require(status == 409 and doc["error"]["status"] == "Conflict",
            f"a token from before the write: {status} {doc}")
    say(f"[{tag} {at()}] paged list-objects of {u} at max-depth 3: {pages} pages "
        f"of 100 equal the unpaged {len(items)} objects; every list answered by "
        f"the reverse path; after one write the fourth page's token is a 409")
    say(f"[numbers] {tag} ({card}): list-objects p50 "
        f"{numbers['objects_p50_ms']:.3f} ms, p99 {numbers['objects_p99_ms']:.3f} ms, "
        f"mean {numbers['objects_mean']:.1f} objects; list-subjects p50 "
        f"{numbers['subjects_p50_ms']:.3f} ms, p99 {numbers['subjects_p99_ms']:.3f} "
        f"ms, mean {numbers['subjects_mean']:.1f} ids; one list-objects in "
        f"process (no HTTP) p50 {numbers['engine_p50_ms']:.3f} ms, of which "
        f"_rows_min on the card {numbers['rows_min_ms']:.4f} ms ({len(l_idx)} "
        f"D^T rows); D.t().contiguous() {numbers['transpose_ms']:.4f} ms")
    say(f"[numbers] {tag} ({card}): GET /expand at max-depth 5 p50 "
        f"{numbers['expand_p50_ms']:.3f} ms, p99 {numbers['expand_p99_ms']:.3f} ms, "
        f"mean {numbers['expand_mean']:.1f} nodes (largest {numbers['expand_max']})")
    say(f"[numbers] {tag} ({card}): first list query after 1000 writes "
        f"{first_s:.3f} s (rebuild {phases}, D^T + reverse CSRs "
        f"{numbers['reverse_s']:.4f} s, {launches} B1 launches); peak device "
        f"memory so far in the phase {DEVSTATS.peak_bytes(span=True) / 2**30:.3f} GiB")
    return numbers


# -- [persist], [persist:spawn], [durable]: SQL stores, spawned workers, the WAL --

PERSIST_CHUNK = 50_000  # tuples per write call when loading the SQL store
PERSIST_WRITES = 100  # mixed writes over REST in [persist]
SPAWN_WORKERS = 4  # serve.read.workers on the SQL store in [persist:spawn]
DURABLE_WRITES = 1000  # acked REST writes before the SIGKILL in [durable]
BOUNDED_DEADLINE_S = 2.0  # the bounded-oracle drill's deadline


def smi_apps() -> dict:
    """Card memory per process, MiB, as nvidia-smi --query-compute-apps gives
    it (pid -> MiB); empty where nvidia-smi lists none."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        try:
            apps[int(pid)] = float(mib)
        except ValueError:
            continue
    return apps


def rbac_sample(args, store, pools, edges):
    """The serve phase's sample and its set-graph oracle answers: the same
    generator seed (args.seed + 1) and the same sample rng (args.seed + 2)
    as run_serve, so the answers are the serve phase's."""
    rng = np.random.default_rng(args.seed + 2)
    sample, _ = chain_sample(rng, pools, edges, args.checks)
    return sample, SetGraphOracle(store).batch(sample)


def persist_config(dsn: str, workers: int = 1) -> dict:
    """The serve phase's config on `dsn`. With workers > 1 the parent keeps
    device query placement (auto would turn to host query mode, which only
    the fork pool needs): it builds D with B1 while its spawned workers,
    pinned to host query mode, build theirs on the host."""
    values = serve_config("auto", cache_size=0)
    values["dsn"] = dsn
    values["serve"]["read"]["workers"] = workers
    if workers > 1:
        values["engine"]["query_mode"] = "device"
    return values


def persist_writes(pools, edges) -> list:
    """PERSIST_WRITES mixed writes, each with the probe it flips and the
    answer the probe must give after it: resource grants to fresh users
    (leaf inserts) and their deletes, fresh users joining a group (leaf
    inserts), then group -> group edges that make those users members of
    another group (interior inserts) and their deletes. Every probe involves
    a fresh user only, so its answer is known without an oracle."""
    resources, groups = pools["resources"], pools["groups"]
    out = []
    for i in range(40):  # leaf: a grant to a fresh user
        t = to_tuple(resources[i * 7919 % len(resources)], (f"persist-u{i}",))
        out.append(("PUT", t, t, True))
    for i in range(20):  # leaf delete
        t = to_tuple(resources[i * 7919 % len(resources)], (f"persist-u{i}",))
        out.append(("DELETE", t, t, False))
    for i in range(20):  # leaf: a fresh user joins group y
        y = groups[(2 * i + 1) % len(groups)]
        t = to_tuple(y, (f"persist-w{i}",))
        out.append(("PUT", t, t, True))
    for i in range(10):  # interior: group x contains group y
        x, y = groups[(2 * i) % len(groups)], groups[(2 * i + 1) % len(groups)]
        out.append(("PUT", to_tuple(x, y), to_tuple(x, (f"persist-w{i}",)), True))
    for i in range(10):  # interior delete
        x, y = groups[(2 * i) % len(groups)], groups[(2 * i + 1) % len(groups)]
        out.append(("DELETE", to_tuple(x, y), to_tuple(x, (f"persist-w{i}",)), False))
    require(len(out) == PERSIST_WRITES, "persist write plan")
    return out


def rest_write(write: str, method: str, t, verify=True) -> int:
    if method == "PUT":
        return http("PUT", f"{write}/relation-tuples", t.to_dict(), verify=verify)[0]
    return http("DELETE", f"{write}/relation-tuples?{tuple_query(t)}", verify=verify)[0]


def serve_persist(args, dev, card, serve: dict) -> dict:
    """[persist]: rbac1m on sqlite://<tmpdir>/keto.db, loaded through the
    port's SQL store, served by the closure engine on the card."""
    import tempfile

    Config, Registry = port("driver", "Config", "Registry")
    SQLiteTupleStore = port("persistence", "SQLiteTupleStore")
    CheckEngine, masked_spmv = port("engine", "CheckEngine", "masked_spmv")
    packed_ops = port("ops", "packed")
    MemoryNamespaceManager = port("namespace", "MemoryNamespaceManager")
    tag = "persist"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    out = {"dir": tempfile.mkdtemp(prefix="keto-persist-")}
    db = os.path.join(out["dir"], "keto.db")
    out["dsn"] = f"sqlite://{db}"
    cols, pools, edges = gen_rbac(args.tuples, np.random.default_rng(args.seed + 1))
    sample, want = rbac_sample(args, cols, pools, edges)
    require(want == serve["want"], "the regenerated sample's answers are not serve's")
    tuples = cols.all_tuples()
    del cols
    nsm = MemoryNamespaceManager()
    for ns in ("rbac", "videos"):
        nsm.add(ns)
    sql = SQLiteTupleStore(db, namespace_manager=nsm)
    t0 = time.perf_counter()
    for i in range(0, len(tuples), PERSIST_CHUNK):
        sql.write_relation_tuples(*tuples[i : i + PERSIST_CHUNK])
    out["load_s"] = time.perf_counter() - t0
    require(len(sql) == len(tuples) == args.tuples, f"{len(sql)} rows in sqlite")
    sql.close()
    out["db_mib"] = os.path.getsize(db) / 2**20
    say(f"[{tag} {at()}] {len(tuples)} tuples through SQLiteTupleStore in chunks of "
        f"{PERSIST_CHUNK}: {out['load_s']:.3f}s, keto.db {out['db_mib']:.1f} MiB ({card})")
    del tuples

    reg = Registry(Config(values=persist_config(out["dsn"])), device=dev)
    store = reg.store()
    require(type(store).__name__ == "SQLTupleStore", f"store {type(store).__name__}")
    read_s = []
    sql_snapshot = store.snapshot

    def timed_snapshot():  # the store's own read path, timed
        t = time.perf_counter()
        got = sql_snapshot()
        read_s.append(time.perf_counter() - t)
        return got

    store.snapshot = timed_snapshot
    masked_spmv.masked_step.launches = 0  # the persist path starts here
    packed_ops.packed_propagate.launches = 0
    t0 = time.perf_counter()
    reg.snapshots()  # the first snapshot: the SQL read and the encode
    snap_s = time.perf_counter() - t0
    read_port, write_port = reg.start_all()
    out["start_s"] = time.perf_counter() - t0
    eng, batcher = reg.check_engine(), reg.checker()
    ph = eng.last_build_phases
    out["read_s"] = read_s[0]
    out["encode_s"] = snap_s - read_s[0]
    out["phases"] = {k: round(v, 4) for k, v in ph.items()}
    out["start_launches"] = masked_spmv.masked_step.launches
    expected = (eng._state.m_pad // 256) * (5 - 2)
    require(not eng.host_queries() and out["start_launches"] == expected,
            f"persist start_all: {out['start_launches']} B1 launches, want {expected}")
    say(f"[{tag} {at()}] start_all on the card {out['start_s']:.3f}s: SQL read "
        f"(SQLTupleStore.snapshot, {len(read_s)} call) {out['read_s']:.3f}s, snapshot "
        f"encode {out['encode_s']:.3f}s, interior {ph.get('interior', 0):.3f}s, closure "
        f"build {ph.get('kernel', 0):.3f}s with {out['start_launches']} B1 launches, the "
        f"rest (warmup, CSR) {out['start_s'] - snap_s - ph.get('total', 0):.3f}s; phases "
        f"{out['phases']} ({card})")
    read = f"http://127.0.0.1:{read_port}"
    write = f"http://127.0.0.1:{write_port}"
    try:
        t0 = time.perf_counter()
        got = batcher.check_batch(sample)
        out["batch_s"] = time.perf_counter() - t0
        require(got == want, "persist: the sample's answers differ from [serve]'s oracle")
        n_sql = 32
        t0 = time.perf_counter()
        require(CheckEngine(store, max_depth=5).batch_check(sample[:n_sql]) == want[:n_sql],
                "persist: the host CheckEngine over SQL disagrees")
        sql_oracle_s = time.perf_counter() - t0
        status, doc = http("POST", f"{read}/check/batch", [t.to_dict() for t in sample])
        require(status == 200 and doc["allowed"] == want, f"persist /check/batch {status}")
        say(f"[{tag} {at()}] the sample: {len(sample)} checks equal to [serve]'s set-graph "
            f"oracle in process ({out['batch_s'] * 1e3:.3f} ms) and over POST /check/batch; "
            f"the first {n_sql} equal the host CheckEngine over the SQL store "
            f"({sql_oracle_s:.1f}s)")

        visible, written = [], []
        for method, t, probe, after in persist_writes(pools, edges):
            t0 = time.perf_counter()
            status = rest_write(write, method, t)
            require(status == (201 if method == "PUT" else 204),
                    f"persist {method} {t}: {status}")
            while True:
                if rest_check(read, probe) == after:
                    break
                require(time.perf_counter() - t0 < 60, f"persist: {probe} never {after}")
                time.sleep(0.005)
            visible.append(time.perf_counter() - t0)
            written.append((method, t))
        out["visible_p50"], out["visible_p99"] = pct(visible, 50), pct(visible, 99)
        out["launches"] = masked_spmv.masked_step.launches
        require(packed_ops.packed_propagate.launches == 0, "B2 ran on the persist path")
        say(f"[{tag} {at()}] {len(written)} mixed writes over REST (40 leaf inserts, 20 "
            f"leaf deletes, 20 group joins, 10 group -> group inserts and 10 deletes): "
            f"each visible to the next GET /check; write-to-visible p50 "
            f"{out['visible_p50']:.3f} ms, p99 {out['visible_p99']:.3f} ms ({card})")
        planes_idle(read, tag)
    finally:
        reg.stop_all()
        store.close()

    fresh = SQLiteTupleStore(db, namespace_manager=nsm)
    final = {}
    for method, t in written:
        final[str(t)] = (t, method == "PUT")
    missing = [
        k for k, (t, present) in final.items()
        if (fresh.get_relation_tuples(t.to_query())[0] == [t]) != present
    ]
    require(not missing, f"persist: after a reopen {len(missing)} acked writes differ: "
            f"{missing[:3]}")
    net = sum(1 for _, present in final.values() if present)
    require(len(fresh) == args.tuples + net, f"persist: {len(fresh)} rows after reopen")
    fresh.close()
    say(f"[{tag} {at()}] reopened in a fresh store: every acked write is there "
        f"({len(final)} tuples written, {net} present), {args.tuples + net} rows")
    out["sample"], out["want"] = sample, want
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def serve_persist_spawn(args, dev, card, persist: dict) -> dict:
    """[persist:spawn]: the [persist] database behind serve.read.workers
    SPAWN_WORKERS (spawned workers, host query mode), GET /check from 64
    clients in 4 client processes; then KETO_WORKER_ALLOW_ACCEL=1 and 2
    workers, where the spawned worker builds D with B1 on the card."""
    Config, Registry = port("driver", "Config", "Registry")
    masked_spmv = port("engine", "masked_spmv")
    tag = "persist:spawn"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    sample, want = persist["sample"], persist["want"]
    out = {}
    for name, workers, accel in (("host", SPAWN_WORKERS, False), ("accel", 2, True)):
        env_before = os.environ.get("KETO_WORKER_ALLOW_ACCEL")
        if accel:
            os.environ["KETO_WORKER_ALLOW_ACCEL"] = "1"
        reg = Registry(Config(values=persist_config(persist["dsn"], workers)), device=dev)
        masked_spmv.masked_step.launches = 0
        t0 = time.perf_counter()
        try:
            read_port, _ = reg.start_all()
            start_s = time.perf_counter() - t0
            pool = reg._replica_pool
            require(type(pool).__name__ == "SpawnWorkerPool"
                    and pool.wait_ready(600), f"[{tag}] workers not serving")
            ready_s = time.perf_counter() - t0
            docs = pool.ready_docs()
            require(len(docs) == workers - 1 and pool.alive() == workers,
                    f"[{tag}] {len(docs)} workers ready")
            read = f"http://127.0.0.1:{read_port}"
            apps = smi_apps()
            out.setdefault("smi", []).append(apps)
            pids = [os.getpid()] + pool.pids()
            mem = {p: _memory_mb(p).get("rss", 0.0) for p in pids}
            card_mib = {p: apps.get(p, 0.0) for p in pids}
            parent_host = reg.check_engine().host_queries()
            if not accel:
                urls = [f"{read}/check?{tuple_query(t)}" for t in sample]
                results, wall = http_clients(urls, 64, procs=4)
                require([s == 200 for s, _ in results] == want
                         and all(s in (200, 403) for s, _ in results),
                         f"[{tag}] GET /check answers differ from [persist]'s")
                lat = [sec for _, sec in results]
                out.update(p50=pct(lat, 50), p99=pct(lat, 99), rate=len(urls) / wall)
                for d in docs:
                    require(d["query_mode"] == "host" and d["b1_launches"] == 0,
                            f"[{tag}] worker {d}")
                out["launches"] = masked_spmv.masked_step.launches
                require(not parent_host and out["launches"] > 0,
                        f"[{tag}] the parent: host {parent_host}, "
                        f"{out['launches']} B1 launches")
                out["boot_s"] = [d["boot_s"] for d in docs]
                out["worker_cuda"] = [d["cuda_initialized"] for d in docs]
                out.update(start_s=start_s, ready_s=ready_s, rss=mem, card_mib=card_mib)
                say(f"[{tag} {at()}] {workers} processes (parent {os.getpid()} in device "
                    f"query mode, {out['launches']} B1 launches, + spawned "
                    f"{pool.pids()} in host query mode): start_all {start_s:.3f}s, all "
                    f"serving after {ready_s:.3f}s, worker boot s "
                    f"{[round(b, 3) for b in out['boot_s']]}; {len(urls)} GET /check from "
                    f"64 clients in 4 processes, every answer [persist]'s: "
                    f"{out['rate']:.0f} checks/s, p50 {out['p50']:.3f} ms, p99 "
                    f"{out['p99']:.3f} ms; RSS MB {{pid: MB}} "
                    f"{ {p: round(v) for p, v in mem.items()} }; card MiB by pid (nvidia-smi "
                    f"--query-compute-apps) {card_mib}, as listed {apps}; workers "
                    f"initialised CUDA: {out['worker_cuda']} ({card})")
            else:
                d = docs[0]
                require(d["query_mode"] == "device" and d["cuda_initialized"]
                        and d["b1_launches"] > 0, f"[{tag}] the opt-in worker: {d}")
                got = [rest_check(read, t) for t in sample[:256]]
                require(got == want[:256], f"[{tag}] opt-in answers differ")
                out["accel"] = {"doc": d, "card_mib": card_mib, "start_s": start_s,
                                "ready_s": ready_s}
                out["accel_launches"] = d["b1_launches"] + masked_spmv.masked_step.launches
                say(f"[{tag} {at()}] KETO_WORKER_ALLOW_ACCEL=1, {workers} processes: the "
                    f"spawned worker {d['pid']} built D on the card in its own context "
                    f"({d['query_mode']} query mode, {d['b1_launches']} B1 launches, boot "
                    f"{d['boot_s']:.3f}s, its allocator holding "
                    f"{d['cuda_reserved_mib']:.0f} MiB; nvidia-smi --query-compute-apps "
                    f"lists {apps}); the parent "
                    f"{masked_spmv.masked_step.launches} B1 launches; 256 GET /check over "
                    f"both equal [persist]'s ({card})")
        finally:
            reg.stop_all()
            if accel:
                if env_before is None:
                    os.environ.pop("KETO_WORKER_ALLOW_ACCEL", None)
                else:
                    os.environ["KETO_WORKER_ALLOW_ACCEL"] = env_before
            reg.store().close()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def durable_values(wal_dir: str) -> dict:
    values = serve_config("auto", cache_size=0)
    values["store"] = {"wal": {"dir": os.path.join(wal_dir, "wal")}}
    values["checkpoint"] = {"dir": os.path.join(wal_dir, "checkpoints")}
    return values


def durable_server_main(args) -> int:
    """The [durable] server, run in a fresh interpreter (this script with
    --durable-server DIR): a columnar store with store.wal.dir and
    checkpoint.dir under DIR at the reference defaults. On an empty DIR it
    bulk-loads rbac1m (the serve phase's seed; each bulk load cuts a
    synchronous checkpoint); on a non-empty one it recovers. It prints a
    POOL line with its ports, recovery report, timings and B1 launches,
    then answers commands on stdin: oracle <json tuples>, reingest, stop."""
    Config, Registry = port("driver", "Config", "Registry")
    masked_spmv = port("engine", "masked_spmv")
    ColumnarTupleStore = port("store", "ColumnarTupleStore")
    RelationTuple = port("relationtuple", "RelationTuple")
    harness = port("", "poolharness")

    t_boot = time.perf_counter()
    dev = torch.device(args.device)
    reg = Registry(Config(values=durable_values(args.durable_server)), device=dev)
    store = reg.store()
    store_s = time.perf_counter() - t_boot
    rep = store.recovery
    load_s = 0.0
    if store.version == 0:
        t0 = time.perf_counter()
        gen_rbac(args.tuples, np.random.default_rng(args.seed + 1), store=store)
        load_s = time.perf_counter() - t0
    masked_spmv.masked_step.launches = 0  # this server's path starts here
    t0 = time.perf_counter()
    read_port, write_port = reg.start_all()
    start_s = time.perf_counter() - t0
    eng = reg.check_engine()

    def info(_arg: str = "") -> dict:
        return {
            "read": read_port, "write": write_port, "pid": os.getpid(),
            "store_s": store_s, "load_s": load_s, "start_s": start_s,
            "boot_s": time.perf_counter() - t_boot if _arg == "boot" else None,
            "version": store.version, "tuples": len(store),
            "recovery": {
                "checkpoint_version": rep.checkpoint_version,
                "replayed": rep.replayed_deltas, "skipped": rep.skipped_records,
                "final_version": rep.final_version, "gap": rep.gap,
                "torn_tail_bytes": rep.torn_tail_bytes, "duration_s": rep.duration_s,
                "checkpoint_s": rep.checkpoint_s, "replay_s": rep.replay_s,
                "notes": rep.notes,
            },
            "csr_primed": reg.csr_primed, "host": eng.host_queries(),
            "phases": {k: round(v, 4) for k, v in eng.last_build_phases.items()},
            "b1": masked_spmv.masked_step.launches,
        }

    def oracle(arg: str) -> dict:
        so = SetGraphOracle(store.inner)
        return {"expect": so.batch([RelationTuple.from_dict(t) for t in json.loads(arg)])}

    def reingest(_arg: str) -> dict:
        src, dst, vocab, _ = store.inner.snapshot_ids()
        keys = vocab.keys()
        s_keys = [keys[i] for i in src.tolist()]
        d_keys = [keys[i] for i in dst.tolist()]
        t0 = time.perf_counter()
        cold = ColumnarTupleStore()
        cold.bulk_load_edges(s_keys, d_keys)
        secs = time.perf_counter() - t0
        require(len(cold) == len(store), "re-ingest row count")
        return {"reingest_s": secs, "tuples": len(cold)}

    def stop() -> dict:
        reg.stop_all()
        return {"stopped": True, "b1": masked_spmv.masked_step.launches,
                "checkpoints": sorted(os.listdir(store.checkpoint_dir))}

    harness.emit(info("boot"))
    return harness.serve_commands({"info": info, "oracle": oracle, "reingest": reingest},
                                  stop)


def serve_durable(args, dev, card, sample) -> dict:
    """[durable]: rbac1m on a columnar store with store.wal.dir and
    checkpoint.dir, in a subprocess server (durable_server_main); 1000 acked
    REST writes, SIGKILL, recovery, every acked write read back, the sample
    against the host oracle over the recovered store; a cold re-ingest's
    seconds beside it; a graceful stop whose final checkpoint carries the
    CSR, and a third boot that primes it."""
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    harness = port("", "poolharness")
    tag = "durable"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    root = tempfile.mkdtemp(prefix="keto-durable-")
    argv = [sys.executable, str(Path(__file__).resolve()), "--durable-server", root,
            "--seed", str(args.seed), "--tuples", str(args.tuples),
            "--device", str(dev)]
    out = {"launches": 0}

    def boot(name: str):
        t0 = time.perf_counter()
        server = harness.PoolProcess(argv, name=f"durable server ({name})")
        info = server.next_doc(900)
        read = f"http://127.0.0.1:{info['read']}"
        status, doc = http("POST", f"{read}/check/batch", [t.to_dict() for t in sample])
        first_s = time.perf_counter() - t0
        require(status == 200, f"[{tag}] first batch: {status}")
        return server, info, read, f"http://127.0.0.1:{info['write']}", doc, first_s

    server = None
    try:
        server, info, read, write, doc, first_s = boot("first")
        out["launches"] += info["b1"]
        require(info["recovery"]["checkpoint_version"] == 0 and info["b1"] > 0
                and not info["host"], f"[{tag}] first boot {info}")
        say(f"[{tag} {at()}] first boot: bulk load of {info['tuples']} tuples with its "
            f"synchronous checkpoints {info['load_s']:.3f}s, start_all {info['start_s']:.3f}s "
            f"({info['b1']} B1 launches), version {info['version']}")

        # 1000 acked writes: grants to fresh users, group joins, and role ->
        # role edges (interior), from 16 client threads
        roles, resources, groups = durable_pools(args)
        writes = []
        for i in range(DURABLE_WRITES):
            if i % 10 == 0:
                a, b = roles[i % len(roles)], roles[(i * 7 + 3) % len(roles)]
                if a == b:
                    b = roles[(i * 7 + 4) % len(roles)]
                writes.append(to_tuple(a, b))
            elif i % 10 < 6:
                writes.append(to_tuple(resources[i * 104_729 % len(resources)],
                                       (f"durable-u{i}",)))
            else:
                writes.append(to_tuple(groups[i % len(groups)], (f"durable-u{i}",)))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            statuses = list(pool.map(lambda t: rest_write(write, "PUT", t), writes))
        write_s = time.perf_counter() - t0
        acked = [t for t, s in zip(writes, statuses) if s == 201]
        require(len(acked) == len(writes), f"[{tag}] {len(writes) - len(acked)} writes "
                f"not acked: {sorted(set(statuses))}")
        pre = server.ask("info")
        say(f"[{tag} {at()}] {len(acked)} acked writes over REST (sync always, 16 "
            f"clients; {sum(1 for t in writes if not hasattr(t.subject, 'id'))} role -> "
            f"role) in {write_s:.3f}s, {len(acked) / write_s:.0f} writes/s; version "
            f"{pre['version']}")

        os.killpg(server.proc.pid, signal.SIGKILL)
        server.proc.wait(timeout=60)
        server = None
        server, info, read, write, doc, first_s = boot("after SIGKILL")
        out["launches"] += info["b1"]
        rec = info["recovery"]
        require(not rec["gap"] and rec["replayed"] == len(acked)
                and rec["final_version"] == pre["version"] and info["b1"] > 0,
                f"[{tag}] recovery {rec}")
        out.update(recovery=rec, restart_start_s=info["start_s"], first_batch_s=first_s,
                   csr_primed_kill=info["csr_primed"], store_s=info["store_s"])
        say(f"[{tag} {at()}] restart after SIGKILL: recovery from the checkpoint at "
            f"version {rec['checkpoint_version']} + {rec['replayed']} WAL records replayed "
            f"({rec['skipped']} inside the checkpoint), gap {rec['gap']}, torn tail "
            f"{rec['torn_tail_bytes']} bytes; checkpoint load {rec['checkpoint_s']:.3f}s, "
            f"replay {rec['replay_s']:.3f}s, recovery {rec['duration_s']:.3f}s; CSR primed "
            f"{info['csr_primed']}; start_all {info['start_s']:.3f}s ({info['b1']} B1 "
            f"launches); restart to the first {len(sample)}-check batch answered on the "
            f"card {first_s:.3f}s ({card})")

        def present(t) -> bool:
            status, body = http("GET", f"{read}/relation-tuples?{tuple_query(t)}")
            require(status == 200, f"GET /relation-tuples {status}")
            return [x for x in body["relation_tuples"]] == [t.to_dict()]

        with ThreadPoolExecutor(16) as pool:
            back = list(pool.map(present, acked))
        require(all(back), f"[{tag}] {back.count(False)} acked writes lost")
        expect = server.ask("oracle " + json.dumps([t.to_dict() for t in sample]), 600)
        require(doc["allowed"] == expect["expect"],
                f"[{tag}] the recovered sample differs from the host oracle")
        ri = server.ask("reingest", 600)
        out["reingest_s"] = ri["reingest_s"]
        say(f"[{tag} {at()}] every acked write read back over GET /relation-tuples "
            f"({len(acked)}); the {len(sample)} sample equals the set-graph oracle over "
            f"the recovered store; a cold re-ingest of the same {ri['tuples']} tuples "
            f"(bulk_load_edges into a fresh columnar store) {ri['reingest_s']:.3f}s "
            f"against recovery {rec['duration_s']:.3f}s ({card})")

        done = server.stop(300)
        server = None
        require(done["stopped"], f"[{tag}] graceful stop {done}")
        server, info, read, write, doc, first_s = boot("after a graceful stop")
        out["launches"] += info["b1"]
        rec3 = info["recovery"]
        require(info["csr_primed"] and rec3["replayed"] == 0 and not rec3["gap"]
                and doc["allowed"] == expect["expect"], f"[{tag}] third boot {info}")
        out.update(csr_primed=info["csr_primed"], primed_start_s=info["start_s"],
                   primed_first_s=first_s, primed_recovery_s=rec3["duration_s"],
                   root=root, tuples=info["tuples"], version=info["version"])
        say(f"[{tag} {at()}] graceful stop (final checkpoint {done['checkpoints'][-1]} "
            f"with the CSR), third boot: recovery {rec3['duration_s']:.3f}s from the "
            f"checkpoint alone, CSR primed {info['csr_primed']}, start_all "
            f"{info['start_s']:.3f}s ({info['b1']} B1 launches), first batch after "
            f"{first_s:.3f}s, the sample again the oracle's ({card})")
        planes_idle(read, tag)
        done = server.stop(300)
        server = None
    finally:
        if server is not None:
            server.kill_group()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def durable_pools(args):
    """The role, resource and group key pools of gen_rbac at args.tuples
    (the same sizes, no edges)."""
    n_groups = min(max(args.tuples // 100, 20), 20_000)
    n_roles = min(max(n_groups // 10, 5), 2_000)
    n_resources = max(args.tuples // 3, 50)
    roles = [("rbac", f"role{i}", "member") for i in range(n_roles)]
    resources = [("rbac", f"res{i}", "view") for i in range(n_resources)]
    groups = [("rbac", f"g{i}", "member") for i in range(n_groups)]
    return roles, resources, groups


class _TimedOracle:
    """The registry's oracle (the host CheckEngine over the store) with the
    seconds of each row it answered kept, and of each row it gave up at the
    deadline, for the bounded-oracle drill."""

    def __init__(self, engine):
        self.engine = engine
        self.row_s: list[float] = []
        self.cut_s: list[float] = []

    def batch_check(self, requests, max_depth=0, depths=None):
        t0 = time.perf_counter()
        got = self.engine.batch_check(requests, max_depth, depths)
        self.row_s.append((time.perf_counter() - t0) / max(1, len(requests)))
        return got

    def check_until(self, requested, max_depth, deadline):
        t0 = time.perf_counter()
        got = self.engine.check_until(requested, max_depth, deadline)
        (self.cut_s if got is None else self.row_s).append(time.perf_counter() - t0)
        return got

    def subject_is_allowed(self, requested, max_depth=0):
        return self.batch_check([requested], max_depth)[0]


def bounded_oracle_drill(eng, store, sample, want, hbm) -> dict:
    """The packed breaker's oracle, bounded: the registry's own oracle
    (CheckEngine over the github10m store) behind a fresh breaker over the
    packed engine; device.batch_nan x3 sends one len(sample)-row columnar
    batch there with a BOUNDED_DEADLINE_S deadline. The oracle reads the
    clock before every row and every page it asks the store for, so the
    batch returns by the deadline plus one page (held to one second), each
    answered row equal to the plain path's answer, the rest failed typed
    (DeadlineExceeded)."""
    CheckEngine = port("engine", "CheckEngine")
    DeviceFallbackEngine = port("engine.fallback", "DeviceFallbackEngine")
    CheckBatcher = port("engine.batcher", "CheckBatcher")
    CheckColumns = port("relationtuple.columns", "CheckColumns")
    DeadlineExceeded = port("utils.errors", "DeadlineExceeded")
    FAULTS = port("faults", "FAULTS")

    oracle = _TimedOracle(CheckEngine(store, max_depth=5))
    t0 = time.perf_counter()
    require(oracle.batch_check(sample[:1]) == want[:1], "the registry's oracle differs")
    warm_s = time.perf_counter() - t0
    oracle.row_s.clear()
    breaker = DeviceFallbackEngine(
        eng, fallback_factory=lambda: oracle, failure_threshold=3, cooldown_s=1.0,
        health=_Readiness(),
    )
    batcher = CheckBatcher(breaker, pipeline_depth=2, encode_workers=2, hbm=hbm)
    cols = CheckColumns.from_tuples(sample)
    FAULTS.arm("device.batch_nan", times=3)
    try:
        t0 = time.monotonic()
        try:
            answers = batcher.check_batch_columnar(cols, deadline=t0 + BOUNDED_DEADLINE_S)
            failed = False
        except DeadlineExceeded as e:
            answers, failed = e.answers, True
        wall = time.monotonic() - t0
    finally:
        batcher.close()
        FAULTS.disarm("device.batch_nan")
    answered = [i for i, v in enumerate(answers) if v is not None]
    max_row = max(oracle.row_s, default=0.0)
    cut = max(oracle.cut_s, default=0.0)
    require(len(answers) == len(sample) and breaker.n_fallback_batches == 1,
            f"bounded drill: {len(answers)} answers, {breaker.n_fallback_batches} "
            "oracle batches")
    require(all(answers[i] == want[i] for i in answered),
            "bounded drill: an answered row differs from the plain path")
    require(failed == (len(answered) < len(sample))
            and breaker.n_deadline_skips == len(sample) - len(answered),
            f"bounded drill: {breaker.n_deadline_skips} skips")
    require(wall <= BOUNDED_DEADLINE_S + 1.0,
            f"bounded drill: {wall:.3f}s, past the {BOUNDED_DEADLINE_S}s deadline plus "
            f"one second")
    line = (f"[device] packed bounded oracle: device.batch_nan sent one {len(sample)}-row "
            f"batch to the registry's oracle (CheckEngine over the store; warm-up row "
            f"{warm_s:.3f}s) under a {BOUNDED_DEADLINE_S}s deadline: returned after "
            f"{wall:.3f}s, {len(answered)} rows answered (each the plain path's; slowest "
            f"{max_row:.3f}s), {len(sample) - len(answered)} failed typed "
            f"(DeadlineExceeded; the row cut inside its search ran {cut:.3f}s)")
    say(line)
    return {"wall_s": wall, "answered": len(answered), "max_row_s": max_row,
            "cut_s": cut, "warm_s": warm_s, "line": line}


# -- [cli]: the CLI and the client SDK against an rbac1m server on sqlite --------

CLI_SERIAL = 256  # serial single checks per client, keep-alive
CLI_HEDGED = 64  # check_hedged calls
CLI_BATCH_REPS = 3  # timed batches of the sample per transport
CLI_ORACLE = 64  # the sample's prefix held to the host CheckEngine over SQL
CLI_NEW = 3  # tuples `relation-tuple create -` writes


def cli_tuples() -> list:
    RelationTuple = port("relationtuple", "RelationTuple")
    return [RelationTuple.from_string(f"rbac:cli-doc{i}#view@cli-user{i}")
            for i in range(CLI_NEW)]


def cli_plan(read_remote: str, write_remote: str, allowed, denied) -> dict:
    """The client verbs each run as a process and in process: name ->
    (argv, stdin)."""
    remotes = ["--read-remote", read_remote, "--write-remote", write_remote]

    def check_argv(t):
        return remotes + ["check", str(t.subject), t.relation, t.namespace, t.object]

    return {
        "status": (remotes + ["status", "--block", "--timeout", "60"], ""),
        "check allowed": (check_argv(allowed), ""),
        "check denied": (check_argv(denied), ""),
        "create": (remotes + ["relation-tuple", "create", "-"],
                   json.dumps([t.to_dict() for t in cli_tuples()])),
        "get": (remotes + ["relation-tuple", "get", "--namespace", "rbac", "--object",
                           "cli-doc0", "--format", "json"], ""),
        "version": (remotes + ["version"], ""),
    }


def cli_in_process(cli, argv, stdin: str = ""):
    """One cli.main(argv) in this interpreter: (rc, stdout, seconds)."""
    import contextlib
    import io

    buf, old = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO(stdin)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(a) for a in argv])
    finally:
        sys.stdin = old
    return rc, buf.getvalue(), time.perf_counter() - t0


def cli_server_main(cfg: str) -> int:
    """The [cli] and [config] servers, each in a fresh interpreter (this
    script with --cli-server or --config-server CFG): the port's own entry
    point, cli.main(["serve", "-c", CFG]), on the card. One POOL line when
    start_all returns (its ports and the B1 launches of the boot), and one
    when serve returns on SIGTERM (the process's B1 launches and the threads
    still alive)."""
    import threading

    cli = port("cli", "main")
    Registry = port("driver", "Registry")
    masked_spmv = port("engine", "masked_spmv")
    harness = port("", "poolharness")
    start_all = Registry.start_all
    t_boot = time.perf_counter()

    def reported(self):
        ports = start_all(self)
        harness.emit({"read": ports[0], "write": ports[1], "grpc": self.grpc_enabled,
                      "host": self.check_engine().host_queries(),
                      "b1": masked_spmv.masked_step.launches,
                      "start_s": time.perf_counter() - t_boot})
        return ports

    Registry.start_all = reported
    masked_spmv.masked_step.launches = 0  # this server's path starts here
    rc = cli.main(["serve", "-c", cfg])
    harness.emit({"rc": rc, "b1": masked_spmv.masked_step.launches,
                  "threads": sorted(t.name for t in threading.enumerate())})
    return rc


def cli_client_main(args) -> int:
    """The client verbs in process, in a fresh interpreter (this script with
    --cli-client PLAN): each cli.main(argv) timed after the CLI's modules
    are imported, then whether anything initialised CUDA."""
    cli = port("cli", "main")
    port("cli", "remote")  # the gRPC verbs' imports, before the clock starts
    port("", "client")
    harness = port("", "poolharness")
    out = {}
    for name, (argv, stdin) in json.loads(args.cli_client).items():
        rc, text, secs = cli_in_process(cli, argv, stdin)
        out[name] = {"rc": rc, "s": secs, "stdout": text}
    harness.emit({"verbs": out, "cuda_initialized": torch.cuda.is_initialized()})
    return 0


def run_cli_process(repo: Path, argv, stdin: str = "", timeout: float = 600):
    """One `python -m keto_tpu_torch.cli ...` process: (rc, stdout, seconds)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(repo), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "keto_tpu_torch.cli", *argv],
                          cwd=repo, env=env, input=stdin, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, time.perf_counter() - t0, proc.stderr


def serve_cli(args, card: str, persist: dict, durable: dict) -> dict:
    """[cli]: `migrate status` on the [persist] database, an rbac1m server
    over it started by the CLI's own `serve` in a subprocess on the card,
    the client verbs as `python -m keto_tpu_torch.cli` processes and in
    process, the 4096 sample through every SDK transport, serial and hedged
    single checks, `debug snapshot` against the server, and `doctor` over
    the [durable] directories (alongside the server's boot)."""
    import signal
    import tarfile
    from concurrent.futures import ThreadPoolExecutor

    harness = port("", "poolharness")
    cli = port("cli", "main")
    RestClient, Hedger, HedgePolicy = port("client", "RestClient", "Hedger", "HedgePolicy")
    GrpcClient = port("client.grpc_client", "GrpcClient")
    CheckEngine = port("engine", "CheckEngine")
    SQLiteTupleStore = port("persistence", "SQLiteTupleStore")
    MemoryNamespaceManager = port("namespace", "MemoryNamespaceManager")
    SubjectSet = port("relationtuple", "SubjectSet")
    repo = Path(__file__).resolve().parent
    tag = "cli"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    out = {"launches": 0}
    sample, want = persist["sample"], persist["want"]
    cfg = os.path.join(persist["dir"], "cli.json")
    with open(cfg, "w") as f:
        json.dump(persist_config(persist["dsn"]), f)

    # 1. migrations: nothing pending on the [persist] database
    rc, text, _ = cli_in_process(cli, ["migrate", "status", "-c", cfg])
    require(rc == 0 and text.strip() and "pending" not in text,
            f"[{tag}] migrate status: {rc} {text!r}")
    say(f"[{tag} {at()}] migrate status -c on {persist['dsn']}: "
        f"{len(text.strip().splitlines())} migrations, all applied")

    # 5. doctor over the [durable] directories, a process of its own that
    # runs alongside the server's boot (read after the server stops)
    root = durable["root"]
    doctor_pool = ThreadPoolExecutor(1)
    doctor = doctor_pool.submit(run_cli_process, repo, [
        "doctor", "--wal-dir", os.path.join(root, "wal"), "--checkpoint-dir",
        os.path.join(root, "checkpoints"), "--format", "json"])
    doctor_pool.shutdown(wait=False)

    # 2. the server, through the CLI's own serve, on the card
    argv = [sys.executable, str(Path(__file__).resolve()), "--cli-server", cfg]
    t0 = time.perf_counter()
    server = harness.PoolProcess(argv, name="cli server")
    try:
        info = server.next_doc(900)
        out["boot_s"] = time.perf_counter() - t0
        out["boot_launches"] = info["b1"]
        require(info["b1"] == 135 and not info["host"],
                f"[{tag}] serve booted with {info['b1']} B1 launches (host {info['host']})")
        require(info["grpc"], f"[{tag}] the gRPC plane is off on the serve process")
        rp, wp = info["read"], info["write"]
        read, write = f"http://127.0.0.1:{rp}", f"http://127.0.0.1:{wp}"
        say(f"[{tag} {at()}] `serve -c` in a fresh interpreter: serving after "
            f"{out['boot_s']:.3f}s (start_all returned at {info['start_s']:.3f}s of it), "
            f"{info['b1']} B1 launches at boot, REST + gRPC ({card})")

        # 3. the client verbs: processes, then in process in a fresh interpreter
        allowed = sample[want.index(True)]
        denied = sample[want.index(False)]
        plan = cli_plan(f"127.0.0.1:{rp}", f"127.0.0.1:{wp}", allowed, denied)
        expect_rc = {"check denied": 1}
        procs = {}
        for name, (vargv, stdin) in plan.items():
            rc, text, secs, err = run_cli_process(repo, vargv, stdin)
            require(rc == expect_rc.get(name, 0), f"[{tag}] `{name}` exited {rc}: {err[-2000:]}")
            procs[name] = (secs, text)
        require(procs["status"][1] == "SERVING\n", f"[{tag}] status {procs['status'][1]!r}")
        require(procs["check allowed"][1] == "Allowed\n"
                and procs["check denied"][1] == "Denied\n", f"[{tag}] check output")
        got = json.loads(procs["get"][1])["relation_tuples"]
        require(got == [cli_tuples()[0].to_dict()], f"[{tag}] get after create: {got}")
        client = harness.PoolProcess(
            [sys.executable, str(Path(__file__).resolve()), "--cli-client",
             json.dumps(plan)],
            name="cli client")
        doc = client.next_doc(600)
        client.proc.wait(timeout=60)
        require(not doc["cuda_initialized"], f"[{tag}] a client verb initialised CUDA")
        for name, v in doc["verbs"].items():
            require(v["rc"] == expect_rc.get(name, 0) and v["stdout"] == procs[name][1],
                    f"[{tag}] in-process `{name}`: {v}")
        out["verbs"] = {name: (procs[name][0], doc["verbs"][name]["s"]) for name in plan}
        say(f"[{tag} {at()}] the client verbs, process / in process s: "
            + ", ".join(f"{k} {p:.3f}/{i:.4f}" for k, (p, i) in out["verbs"].items())
            + "; exit codes 0, Allowed 0 / Denied 1; `get` shows the created "
            "tuple; torch.cuda.is_initialized() False after every in-process verb")

        # 4. the SDK: the sample through every transport
        rest = RestClient(read, write)
        grpc_client = GrpcClient(f"127.0.0.1:{rp}", f"127.0.0.1:{wp}")
        try:
            t0 = time.perf_counter()
            cache = rest.vocab_cache()
            cache.bootstrap()
            out["vocab_s"] = time.perf_counter() - t0
            transports = {
                "rest tuples": lambda: rest.batch_check(sample),
                "rest columns": lambda: rest.batch_check_columns(sample),
                "rest encoded": lambda: rest.batch_check_encoded(cache, sample),
                "grpc tuples": lambda: grpc_client.batch_check(sample),
                "grpc columns": lambda: grpc_client.batch_check_columns(sample),
            }
            batch_ms = {k: [] for k in transports}
            for _ in range(CLI_BATCH_REPS):
                for name, fn in transports.items():
                    t0 = time.perf_counter()
                    answers = fn()
                    batch_ms[name].append(time.perf_counter() - t0)
                    require(answers == want, f"[{tag}] {name}: the sample's answers differ")
            out["batch_p50"] = {k: pct(v, 50) for k, v in batch_ms.items()}
            out["answers"] = answers
            nsm = MemoryNamespaceManager()
            for ns in ("rbac", "videos"):
                nsm.add(ns)
            sql = SQLiteTupleStore(persist["dsn"][len("sqlite://"):], namespace_manager=nsm)
            t0 = time.perf_counter()
            out["oracle"] = CheckEngine(sql, max_depth=5).batch_check(sample[:CLI_ORACLE])
            require(out["oracle"] == want[:CLI_ORACLE],
                    f"[{tag}] the host CheckEngine over SQL disagrees")
            oracle_s = time.perf_counter() - t0
            sql.close()
            say(f"[{tag} {at()}] the {len(sample)} sample equal across REST tuples, REST "
                f"columns, REST encoded (vocab bootstrap {out['vocab_s']:.3f}s), gRPC tuples "
                f"and gRPC columns, x{CLI_BATCH_REPS}: p50 ms "
                + ", ".join(f"{k} {v:.3f}" for k, v in out["batch_p50"].items())
                + f"; the first {CLI_ORACLE} equal the host CheckEngine over the SQL store "
                f"({oracle_s:.1f}s) ({card})")

            serial = {"rest": [], "grpc": []}
            for name, c in (("rest", rest), ("grpc", grpc_client)):
                for t, w in zip(sample[:CLI_SERIAL], want[:CLI_SERIAL]):
                    t0 = time.perf_counter()
                    ok = c.check(t).allowed
                    serial[name].append(time.perf_counter() - t0)
                    require(ok == w, f"[{tag}] {name} single check {t}")
            out["serial"] = {k: (pct(v, 50), pct(v, 99)) for k, v in serial.items()}

            class Count:
                value = 0

                def inc(self, v=1):
                    self.value += v

            counts = tuple(Count() for _ in range(4))
            hedged = []
            with Hedger(HedgePolicy(), counters=counts) as h:
                for t, w in zip(sample[:CLI_HEDGED], want[:CLI_HEDGED]):
                    t0 = time.perf_counter()
                    call = rest.check_hedged(t, h)
                    hedged.append(time.perf_counter() - t0)
                    require(call.result.allowed == w, f"[{tag}] hedged check {t}")
            out["hedged"] = (pct(hedged, 50), pct(hedged, 99), [c.value for c in counts])
            say(f"[{tag} {at()}] {CLI_SERIAL} serial single checks on one keep-alive client, "
                f"p50/p99 ms: RestClient {out['serial']['rest'][0]:.3f}/"
                f"{out['serial']['rest'][1]:.3f}, GrpcClient {out['serial']['grpc'][0]:.3f}/"
                f"{out['serial']['grpc'][1]:.3f}; {CLI_HEDGED} check_hedged p50/p99 "
                f"{out['hedged'][0]:.3f}/{out['hedged'][1]:.3f} ms, hedges fired/won/"
                f"wasted/suppressed {out['hedged'][2]}; every answer the sample's ({card})")

            t = allowed
            ss = SubjectSet(t.namespace, t.object, t.relation)
            trees = [str(c.expand(ss)) for c in (rest, grpc_client)]
            lists = [c.list_objects(t.subject.id, t.relation, t.namespace).items
                     for c in (rest, grpc_client)]
            require(trees[0] == trees[1] and trees[0] != "None", f"[{tag}] expand differs")
            require(lists[0] == lists[1] and t.object in lists[0],
                    f"[{tag}] list_objects differs or misses {t.object}")
            say(f"[{tag} {at()}] expand {ss} ({trees[0].count(chr(10)) + 1} lines) and "
                f"list_objects of {t.subject} ({len(lists[0])} objects) equal through both "
                f"clients")
        finally:
            rest.close()
            grpc_client.close()

        # 6. debug snapshot against the server
        bundle = os.path.join(persist["dir"], "debug.tar.gz")
        rc, text, snap_s = cli_in_process(cli, ["--read-remote", f"127.0.0.1:{rp}",
                                                "debug", "snapshot", "-o", bundle])
        with tarfile.open(bundle) as tar:
            names = tar.getnames()
            flight = json.loads(tar.extractfile("flight.json").read())
            traces = json.loads(tar.extractfile("traces.json").read())
            prom = tar.extractfile("metrics.prom").read().decode()
        require(rc == 0 and names == ["stacks.txt", "config.json", "graph.json",
                                      "flight.json", "traces.json", "metrics.prom",
                                      "pipeline.json", "version.json"],
                f"[{tag}] debug snapshot: {rc} {names}")
        require(traces["spans"] and "checks" in flight
                and "keto_check_requests_total" in prom,
                f"[{tag}] debug snapshot: empty traces, flight or metrics")
        say(f"[{tag} {at()}] debug snapshot in {snap_s:.3f}s: {names}, no errors.txt; "
            f"{len(traces['spans'])} spans, {flight['checks']['checks']} checks in "
            f"flight.json, {len(prom.splitlines())} lines of metrics")
        planes_idle(read, tag)
    finally:
        if server.proc.poll() is None:
            os.kill(server.proc.pid, signal.SIGTERM)
        try:
            last = server.next_doc(120)
            server.proc.wait(timeout=60)
        except Exception:
            server.kill_group()
            raise
    require(last.get("rc") == 0, f"[{tag}] serve exited {last}")
    out["launches"] = last["b1"]
    require("shutting down gracefully...\n" in server.lines
            and any(line.startswith(f"read API serving on :{rp} (REST + gRPC)")
                    for line in server.lines), f"[{tag}] serve's output {server.lines[-5:]}")
    say(f"[{tag} {at()}] SIGTERM: serve returned 0 after 'shutting down gracefully...'; "
        f"{out['launches']} B1 launches in the serve process")

    rc, text, out["doctor_s"], err = doctor.result(timeout=600)
    report = json.loads(text)
    rec, digest = report["recovery"], report["digest"]
    require(rc == 0 and report["ok"] and not rec["gap"]
            and digest["count"] == durable["tuples"]
            and rec["final_version"] == durable["version"],
            f"[{tag}] doctor: rc {rc}, {json.dumps(rec)[:400]}, digest count "
            f"{digest and digest['count']} vs {durable['tuples']}: {err[-1000:]}")
    say(f"[{tag} {at()}] doctor over [durable]'s WAL ({len(report['wal']['segments'])} "
        f"segments) and checkpoints ({len(report['checkpoints']['files'])}): CLEAN, no gap, "
        f"version {rec['final_version']}, digest {digest['count']} tuples in "
        f"{len(digest['chunks'])} chunks, the count [durable] read back; "
        f"{out['doctor_s']:.3f}s as a process, alongside the server's boot ({card})")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


CONFIG_CLIENTS = 64  # HTTPS GET /check clients across the hot-knob reload
AUTOTUNE_INTERVAL_S = 0.5  # [config]'s autotune.interval_s
AUTOTUNE_WAIT_S = 20.0  # the longest [config] waits for the tuner's first move
CONFIG_ORIGIN = "https://app.example"  # the one origin CORS allows
CONFIG_KNOBS = {"engine.pipeline_depth": 1, "engine.encode_workers": 3,
                "serve.read.max_freshness_wait_s": 12.5}


def config_values(dsn: str, ns_dir: str, tls: dict) -> dict:
    """[config]'s file: [cli]'s rbac1m server on the [persist] database, its
    namespaces a watched directory, TLS on both planes, CORS for one origin
    on the read plane, and a read port the environment replaces."""
    values = persist_config(dsn)
    values["namespaces"] = "file://" + ns_dir
    values["serve"]["read"].update(
        port=4466, tls=tls,
        cors={"enabled": True, "allowed_origins": [CONFIG_ORIGIN]})
    values["serve"]["write"]["tls"] = tls
    return values


def write_config(path: str, values: dict) -> None:
    """Write the config file; the mtime moves at least a second, so the
    server's one-second poll never misses an edit."""
    prev = os.stat(path).st_mtime if os.path.exists(path) else 0.0
    with open(path, "w") as f:
        json.dump(values, f)
    t = max(time.time(), prev + 1.0)
    os.utime(path, (t, t))


class _Collector:
    """A loopback OTLP/HTTP collector on a thread: every POSTed body, by
    path."""

    def __init__(self):
        import http.server
        import threading

        received = self.received = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                received.append((self.path, body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def span_names(self) -> set:
        names = set()
        for path, body in list(self.received):
            if path != "/v1/traces":
                continue
            for rs in json.loads(body)["resourceSpans"]:
                for ss in rs["scopeSpans"]:
                    names.update(s["name"] for s in ss["spans"])
        return names

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def serve_config_plane(args, card: str, persist: dict, cn: dict) -> dict:
    """[config]: `serve -c` in a fresh interpreter over the [persist] rbac1m
    database, with KETO_SERVE_READ_PORT in its environment, namespaces from a
    watched directory, TLS on both planes and CORS, spans shipped over OTLP to
    a loopback collector and the sampling profiler on; the sample over HTTPS
    REST and TLS gRPC, the collector's check.request spans, CORS, a namespace
    added while serving, the hot knobs reloaded under 64 HTTPS clients, a
    reload of tracing to the log, /debug/pprof, a dsn edit and an invalid
    file refused, SIGTERM."""
    import signal
    import ssl
    import threading

    harness = port("", "poolharness")
    RestClient, RelationTuple = port("client", "RestClient"), port("relationtuple", "RelationTuple")
    resolve_free_ports = port("driver.replicas", "resolve_free_ports")
    repo = Path(__file__).resolve().parent
    cert = str(repo / "tests" / "fixtures" / "tls" / "tls.crt")
    tls = {"cert": {"path": cert}, "key": {"path": cert[:-3] + "key"}}
    tag = "config"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    out = {}
    sample, want = persist["sample"], persist["want"]
    root = os.path.join(persist["dir"], "config")
    ns_dir = os.path.join(root, "namespaces")
    os.makedirs(ns_dir, exist_ok=True)
    for nid, name in ((1, "rbac"), (2, "videos")):
        with open(os.path.join(ns_dir, f"{name}.json"), "w") as f:
            json.dump({"id": nid, "name": name}, f)
    cfg = os.path.join(root, "keto.json")
    values = config_values(persist["dsn"], ns_dir, tls)
    collector = _Collector()
    values["tracing"] = {"provider": "otlp", "otlp": {"endpoint": collector.url}}
    values["telemetry"] = {"profiler": {"enabled": True}}
    write_config(cfg, values)
    (env_port,) = resolve_free_ports([("127.0.0.1", 0)])
    env = dict(os.environ, KETO_SERVE_READ_PORT=str(env_port))

    # 1. boot: the env's port, 135 B1 launches, plaintext refused
    t0 = time.perf_counter()
    server = harness.PoolProcess(
        [sys.executable, str(Path(__file__).resolve()), "--config-server", cfg],
        name="config server", env=env)
    try:
        info = server.next_doc(900)
        out["boot_s"] = time.perf_counter() - t0
        out["boot_launches"] = info["b1"]
        require(info["b1"] == 135 and not info["host"] and info["grpc"],
                f"[{tag}] serve booted with {info['b1']} B1 launches (host "
                f"{info['host']}, gRPC {info['grpc']})")
        require(info["read"] == env_port,
                f"[{tag}] the read plane bound {info['read']}, not KETO_SERVE_READ_PORT "
                f"{env_port}")
        rp, wp = info["read"], info["write"]
        read, write = f"https://127.0.0.1:{rp}", f"https://127.0.0.1:{wp}"
        try:
            port("utils.urlfetch", "fetch")(f"http://127.0.0.1:{rp}/health/alive",
                                            timeout=10)
            plaintext = "answered"
        except OSError as e:
            plaintext = type(e).__name__
        require(plaintext != "answered", f"[{tag}] plaintext HTTP to the TLS port answered")
        say(f"[{tag} {at()}] `serve -c` with KETO_SERVE_READ_PORT={env_port}: serving on it "
            f"after {out['boot_s']:.3f}s, {info['b1']} B1 launches at boot, REST + gRPC "
            f"over TLS on both planes, plaintext HTTP refused ({plaintext}) ({card})")

        # 2. the sample over HTTPS REST and TLS gRPC
        grpc = importlib.import_module("grpc")
        pb = port("api.gen.ory.keto.acl.v1alpha1", "check_service_pb2")
        CheckServiceStub = port("api.services", "CheckServiceStub")
        subject_to_proto = port("api.convert", "subject_to_proto")
        options = port("api.grpc_servers", "grpc_message_options")(64 << 20)
        with open(cert, "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        channel = grpc.secure_channel(f"127.0.0.1:{rp}", creds, options=options)
        rest = RestClient(read, write, verify=cert)
        try:
            stub = CheckServiceStub(channel)

            def grpc_batch() -> list:
                # the request is built inside the clock, as GrpcClient's
                # batch_check builds it in [cli]'s plaintext timing
                request = pb.BatchCheckRequest(tuples=[
                    pb.CheckRequestTuple(namespace=t.namespace, object=t.object,
                                         relation=t.relation,
                                         subject=subject_to_proto(t.subject))
                    for t in sample])
                return list(stub.BatchCheck(request, timeout=120).allowed)

            ms = {"rest": [], "grpc": []}
            for _ in range(CLI_BATCH_REPS):
                for name, fn in (("rest", lambda: rest.batch_check(sample)),
                                 ("grpc", grpc_batch)):
                    t0 = time.perf_counter()
                    answers = fn()
                    ms[name].append(time.perf_counter() - t0)
                    require(answers == cn["answers"] == want,
                            f"[{tag}] TLS {name}: the sample's answers differ from [cli]'s")
                    require(answers[:CLI_ORACLE] == cn["oracle"],
                            f"[{tag}] TLS {name}: the {CLI_ORACLE}-prefix differs from the oracle")
            out["p50"] = {k: pct(v, 50) for k, v in ms.items()}
            say(f"[{tag} {at()}] the {len(sample)} sample over TLS equal to [cli]'s answers "
                f"and the first {CLI_ORACLE} to its host CheckEngine, x{CLI_BATCH_REPS}: p50 ms "
                f"HTTPS /check/batch {out['p50']['rest']:.3f} ([cli] plaintext "
                f"{cn['batch_p50']['rest tuples']:.3f}), TLS gRPC BatchCheck "
                f"{out['p50']['grpc']:.3f} ([cli] plaintext "
                f"{cn['batch_p50']['grpc tuples']:.3f}) ({card})")
        finally:
            channel.close()
        t0 = time.perf_counter()
        while ("check.request" not in collector.span_names()
               and time.perf_counter() - t0 < 15):
            time.sleep(0.1)
        names = collector.span_names()
        require("check.request" in names,
                f"[{tag}] the OTLP collector received no check.request span: {names}")
        say(f"[{tag} {at()}] OTLP: the loopback collector received "
            f"{len(collector.received)} POSTs to /v1/traces, spans {sorted(names)}")

        # 3. CORS
        ctx = ssl.create_default_context(cafile=cert)
        http_client = importlib.import_module("http.client")

        def https(method, path, headers):
            conn = http_client.HTTPSConnection("127.0.0.1", rp, timeout=60, context=ctx)
            try:
                conn.request(method, path, headers=headers)
                resp = conn.getresponse()
                resp.read()
                return resp.status, {k: resp.getheader(k) for k in (
                    "Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
                    "Access-Control-Allow-Headers")}
            finally:
                conn.close()

        pre = https("OPTIONS", "/check", {
            "Origin": CONFIG_ORIGIN, "Access-Control-Request-Method": "GET"})
        got = https("GET", "/health/alive", {"Origin": CONFIG_ORIGIN})
        other = https("GET", "/health/alive", {"Origin": "https://other.example"})
        require(pre[0] == 204 and pre[1]["Access-Control-Allow-Origin"] == CONFIG_ORIGIN
                and pre[1]["Access-Control-Allow-Methods"] and pre[1]["Access-Control-Allow-Headers"],
                f"[{tag}] preflight {pre}")
        require(got[0] == 200 and got[1]["Access-Control-Allow-Origin"] == CONFIG_ORIGIN,
                f"[{tag}] GET with the allowed origin {got}")
        require(other[0] == 200 and not any(other[1].values()),
                f"[{tag}] a disallowed origin got allow headers {other}")
        say(f"[{tag} {at()}] CORS: the preflight 204 with {pre[1]}; a GET with the origin "
            f"carries Access-Control-Allow-Origin; another origin gets no allow header")

        # 4. a namespace added while serving
        doc = RelationTuple.from_string("docs:d1#view@config-user")
        require(rest_write(write, "PUT", doc, verify=cert) == 404,
                f"[{tag}] a PUT to an unknown namespace did not answer 404")
        t0 = time.perf_counter()
        with open(os.path.join(ns_dir, "docs.json"), "w") as f:
            json.dump({"id": 3, "name": "docs"}, f)
        status = 404
        while status == 404 and time.perf_counter() - t0 < 30:
            time.sleep(0.05)
            status = rest_write(write, "PUT", doc, verify=cert)
        out["ns_visible_s"] = time.perf_counter() - t0
        require(status == 201, f"[{tag}] the added namespace: PUT answered {status}")
        require(rest.check(doc).allowed, f"[{tag}] the check in the added namespace")
        say(f"[{tag} {at()}] a namespace file written into the watched directory: the PUT "
            f"answered 201 after {out['ns_visible_s']:.3f}s (404 before it), its check allowed")

        # 5. the hot knobs, edited under 64 HTTPS clients
        class Clients:
            """CONFIG_CLIENTS HTTPS GET /check clients on the sample, each
            answer held against the sample's, until stopped."""

            def __init__(self):
                self.stop = threading.Event()
                self.lat, self.errors, self.served = [], [], [0]
                self.lock = threading.Lock()
                self.threads = [threading.Thread(target=self.client, args=(k,))
                                for k in range(CONFIG_CLIENTS)]
                self.t_load = time.perf_counter()
                for t in self.threads:
                    t.start()

            def client(self, k: int) -> None:
                mine = []
                i = k
                while not self.stop.is_set():
                    t, w = sample[i % len(sample)], want[i % len(sample)]
                    t0 = time.perf_counter()
                    try:
                        ok = rest.check(t).allowed
                    except Exception as e:
                        with self.lock:
                            self.errors.append(repr(e))
                        continue
                    mine.append(time.perf_counter() - t0)
                    if ok != w:
                        with self.lock:
                            self.errors.append(f"{t}: {ok} != {w}")
                    i += CONFIG_CLIENTS
                with self.lock:
                    self.lat.extend(mine)
                    self.served[0] += len(mine)

            def join(self) -> float:
                self.stop.set()
                for t in self.threads:
                    t.join(timeout=120)
                return time.perf_counter() - self.t_load

        drive = Clients()
        lat, errors, served = drive.lat, drive.errors, drive.served
        try:
            time.sleep(1.0)
            hot = json.loads(json.dumps(values))
            hot["engine"]["pipeline_depth"] = CONFIG_KNOBS["engine.pipeline_depth"]
            hot["engine"]["encode_workers"] = CONFIG_KNOBS["engine.encode_workers"]
            hot["serve"]["read"]["max_freshness_wait_s"] = CONFIG_KNOBS[
                "serve.read.max_freshness_wait_s"]
            t0 = time.perf_counter()
            write_config(cfg, hot)

            def reloaded() -> bool:
                text = "".join(server.lines)
                return all(f"hot knob reloaded key={k}" in text
                           for k in ("engine.pipeline_depth", "engine.encode_workers"))

            while not reloaded() and time.perf_counter() - t0 < 30:
                time.sleep(0.05)
            out["reload_s"] = time.perf_counter() - t0
            require(reloaded(), f"[{tag}] no 'hot knob reloaded' for each engine knob: "
                    + "".join(server.lines[-20:]))
            time.sleep(1.0)
        finally:
            load_s = drive.join()
        require(not errors and served[0] > 0,
                f"[{tag}] {len(errors)} failed or wrong answers across the reload: {errors[:5]}")
        out["load"] = (served[0], served[0] / load_s, pct(lat, 50), pct(lat, 99))
        status, dbg = http("GET", f"{read}/debug/config", verify=cert)
        live = dbg["config"] if status == 200 else {}
        seen = {}
        for key in CONFIG_KNOBS:
            node = live
            for part in key.split("."):
                node = node.get(part, {}) if isinstance(node, dict) else None
            seen[key] = node
        require(seen == CONFIG_KNOBS, f"[{tag}] /debug/config shows {seen}")
        say(f"[{tag} {at()}] {CONFIG_CLIENTS} HTTPS clients across the reload of "
            + ", ".join(f"{k} -> {v}" for k, v in CONFIG_KNOBS.items())
            + f": 'hot knob reloaded' logged for both engine knobs {out['reload_s']:.3f}s "
            f"after the edit, /debug/config shows the new values; {served[0]} checks in "
            f"{load_s:.1f}s ({out['load'][1]:.0f}/s), p50/p99 {out['load'][2]:.3f}/"
            f"{out['load'][3]:.3f} ms, none failed, every answer the sample's ({card})")

        # 5b. tracing reloaded to the log (at debug, where span lines go)
        traced = json.loads(json.dumps(hot))
        traced["tracing"] = {"provider": "log"}
        traced["log"] = {"level": "debug"}
        n_lines = len(server.lines)
        t0 = time.perf_counter()
        write_config(cfg, traced)
        while time.perf_counter() - t0 < 30 and not any(
                "config reloaded" in line and "tracing" in line
                for line in server.lines[n_lines:]):
            time.sleep(0.05)
        require(rest.check(sample[0]).allowed == want[0], f"[{tag}] a check after the reload")
        while time.perf_counter() - t0 < 30 and not any(
                " span span=check.request" in line for line in server.lines[n_lines:]):
            time.sleep(0.05)
        spans = [line.strip() for line in server.lines[n_lines:]
                 if " span span=check.request" in line]
        require(spans, f"[{tag}] no span line in the log after the reload to log: "
                + "".join(server.lines[-10:]))
        out["log_span_s"] = time.perf_counter() - t0
        say(f"[{tag} {at()}] tracing reloaded to log: a check's span in the log "
            f"{out['log_span_s']:.3f}s after the edit: {spans[0][:160]}")
        fetch = port("utils.urlfetch", "fetch")
        status, folded, _ = fetch(f"{read}/debug/pprof?format=folded", timeout=60,
                                  verify=cert)
        require(status == 200 and folded.strip(), f"[{tag}] /debug/pprof folded: {status}")
        status, pprof = http("GET", f"{read}/debug/pprof", verify=cert)
        require(status == 200 and pprof["profiler"]["running"], f"[{tag}] /debug/pprof {status}")
        out["pprof"] = pprof["profiler"]
        say(f"[{tag} {at()}] /debug/pprof: the profiler ran {out['pprof']['elapsed_s']}s, "
            f"{out['pprof']['samples']} samples, {out['pprof']['unique_stacks']} stacks, "
            f"self_overhead {out['pprof']['self_overhead']}; folded "
            f"{len(folded.splitlines())} lines, the heaviest "
            f"{folded.splitlines()[0].decode()[-160:]}")

        # 5c. the online autotuner, turned on by a reload under the 64
        # clients. The two knobs step 5 edited are pinned, so /debug/config
        # keeps their edited values for step 6; the SLO freeze is set out of
        # reach, because the drive's own tail can burn the 0.1% budget of the
        # 250 ms target in seconds, and a frozen tuner moves nothing
        tuned = json.loads(json.dumps(hot))
        tuned["autotune"] = {
            "enabled": True, "interval_s": AUTOTUNE_INTERVAL_S, "min_requests": 32,
            "freeze_burn_rate": 1e9,
            "knobs": {"pipeline_depth": {"enabled": False},
                      "encode_workers": {"enabled": False}},
        }
        drive = Clients()
        try:
            t0 = time.perf_counter()
            write_config(cfg, tuned)
            tuner = {}
            while time.perf_counter() - t0 < AUTOTUNE_WAIT_S:
                time.sleep(0.25)
                status, tuner = http("GET", f"{read}/debug/autotune", verify=cert)
                if status == 200 and tuner.get("moves_total", 0) >= 1:
                    break
            out["autotune_first_move_s"] = time.perf_counter() - t0
        finally:
            load_s = drive.join()
        # no traffic, so every later window is idle: the counts stop moving
        time.sleep(3 * AUTOTUNE_INTERVAL_S)
        require(not drive.errors and drive.served[0] > 0,
                f"[{tag}] {len(drive.errors)} failed or wrong answers under the autotuner: "
                f"{drive.errors[:5]}")
        status, tuner = http("GET", f"{read}/debug/autotune?n=20", verify=cert)
        moves = [e for e in tuner.get("history", []) if e.get("action") == "move"]
        metric_moves = counter_sum(scrape(read, verify=cert), "keto_autotune_moves_total")
        require(status == 200 and tuner["enabled"] and tuner["running"]
                and tuner["moves_total"] >= 1 and moves,
                f"[{tag}] the autotuner made no move: {status} {tuner}")
        require(metric_moves == tuner["moves_total"],
                f"[{tag}] keto_autotune_moves_total {metric_moves} != /debug/autotune "
                f"moves_total {tuner['moves_total']}")
        out["autotune"] = {k: tuner[k] for k in ("ticks", "moves_total", "reverts_total",
                                                 "frozen", "baseline_checks_per_s")}
        out["autotune"]["knobs"] = {k: v["value"] for k, v in tuner["knobs"].items()}
        say(f"[{tag} {at()}] autotune turned on by a reload (interval_s "
            f"{AUTOTUNE_INTERVAL_S}, pipeline_depth and encode_workers pinned): first move "
            f"{out['autotune_first_move_s']:.3f}s after the edit; {drive.served[0]} checks "
            f"from {CONFIG_CLIENTS} HTTPS clients in {load_s:.1f}s, none failed, every "
            f"answer the sample's; /debug/autotune {out['autotune']}; moves "
            + "; ".join(f"{e['knob']} {e['old']} -> {e['new']} (stage {e['stage']})"
                        for e in reversed(moves))
            + f"; keto_autotune_moves_total {metric_moves:.0f} = moves_total ({card})")

        # 6. edits that must not apply: the dsn, then an invalid file
        frozen = json.loads(json.dumps(traced))
        frozen["dsn"] = "sqlite://" + os.path.join(root, "other.db")
        n_lines = len(server.lines)
        write_config(cfg, frozen)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30 and not any(
                "immutable after boot" in line and "key=dsn" in line
                for line in server.lines[n_lines:]):
            time.sleep(0.05)
        require(any("immutable after boot" in line and "key=dsn" in line
                    for line in server.lines[n_lines:]), f"[{tag}] the dsn edit was not refused")
        n_lines = len(server.lines)
        with open(cfg, "w") as f:
            f.write('{"engine": {"pipeline_depth": -1}}')
        os.utime(cfg, (time.time() + 2, time.time() + 2))
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30 and not any(
                "config reload failed" in line for line in server.lines[n_lines:]):
            time.sleep(0.05)
        require(any("config reload failed" in line for line in server.lines[n_lines:]),
                f"[{tag}] the invalid file was not refused")
        status, dbg = http("GET", f"{read}/debug/config", verify=cert)
        require(status == 200 and dbg["config"]["dsn"] == persist["dsn"]
                and dbg["config"]["engine"]["pipeline_depth"] == 1,
                f"[{tag}] the config moved: {status}")
        require(rest.batch_check(sample) == want, f"[{tag}] the sample after the refused edits")
        say(f"[{tag} {at()}] the dsn edit logged as immutable and ignored; the invalid file "
            f"logged and refused; the server still answers the sample from {persist['dsn']}")
        planes_idle(read, tag, verify=cert)
        rest.close()
    finally:
        collector.close()
        if server.proc.poll() is None:
            os.kill(server.proc.pid, signal.SIGTERM)
        try:
            last = server.next_doc(120)
            server.proc.wait(timeout=60)
        except Exception:
            server.kill_group()
            raise

    # 7-8. SIGTERM: rc 0, the watcher threads gone; B1 over the server's life
    require(last.get("rc") == 0, f"[{tag}] serve exited {last}")
    left = [t for t in last["threads"] if t in ("namespace-watcher", "config-watcher")]
    require(not left, f"[{tag}] threads alive after stop_all: {left}")
    out["launches"] = last["b1"]
    say(f"[{tag} {at()}] SIGTERM: serve returned 0, no watcher thread left; B1 launches in "
        f"the serve process {out['launches']} (boot {out['boot_launches']}, "
        f"{out['launches'] - out['boot_launches']} after the namespace add and the reloads)")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def serve_phases(args, dev, card, walls: dict, b1_ms: float) -> dict:
    """Phases 6-9: the serving seam at rbac1m, the overload plane, the read
    replicas and the wire workers. Returns the serve phase's numbers, with
    the overload server's under "overload"."""
    # -- 6. the serving seam at rbac1m --------------------------------------------
    t0 = time.perf_counter()
    serve = run_serve(args, dev, card, b1_ms)
    walls["serve"] = time.perf_counter() - t0

    # -- 7. the overload plane at saturation ---------------------------------------
    t0 = time.perf_counter()
    ov = serve_overload(args, serve, card)
    walls["serve:overload"] = time.perf_counter() - t0
    shares = ", ".join(f"{c} {ov['share'][c]:.4f}" for c in CLASSES)
    lats = ", ".join(f"{c} {ov['p50'][c]:.3f}/{ov['p99'][c]:.3f}" for c in CLASSES)
    say(f"[numbers] serve:overload ({card}; {ov['settings']}): 429 share {shares}; "
        f"accepted p50/p99 ms {lats}; all accepted p50 {ov['p50_all']:.3f} p99 "
        f"{ov['p99_all']:.3f} ms (the cache-off drive at 64 clients: p50 "
        f"{serve['single_p50_ms']:.3f} p99 {serve['single_p99_ms']:.3f} ms); "
        f"{ov['accepted']} accepted, {ov['accepted_rate']:.0f} accepted checks/s; "
        f"transitions (drive and quiet spell) {ov['up']} up / {ov['down']} down, highest rung "
        f"{ov['highest']}; final limit {ov['limit']}; culled {ov['culled']}, "
        f"throttled {ov['throttled']}; mean batch {ov['mean_batch']:.2f}; "
        f"B1 launches {ov['launches']}")

    # -- 8. read replicas: the rbac1m read port from POOL_WORKERS processes ------
    t0 = time.perf_counter()
    pool_numbers = serve_pool(args, serve, card)
    walls["serve:pool"] = time.perf_counter() - t0
    pn = pool_numbers
    say(f"[numbers] serve:pool ({card}; host os.cpu_count() {pn['cpus']}, "
        f"{POOL_WORKERS} server processes, cache off): GET /check p50/p99 ms and "
        f"checks/s: 64 clients in 1 process {pn['64x1'][0]:.3f}/{pn['64x1'][1]:.3f}, "
        f"{pn['64x1'][2]:.0f}; 64 clients in 4 processes {pn['64x4'][0]:.3f}/"
        f"{pn['64x4'][1]:.3f}, {pn['64x4'][2]:.0f}; 256 clients in 4 processes "
        f"{pn['256x4'][0]:.3f}/{pn['256x4'][1]:.3f}, {pn['256x4'][2]:.0f} (the "
        f"single-process cache-off server, 64 clients in 1 process: "
        f"{serve['single_p50_ms']:.3f}/{serve['single_p99_ms']:.3f}, "
        f"{serve['single_rate']:.0f}; in 4 processes: "
        f"{serve['single4_p50_ms']:.3f}/{serve['single4_p99_ms']:.3f}, "
        f"{serve['single4_rate']:.0f}; pool/single at 64x1 "
        f"{pn['64x1'][2] / serve['single_rate']:.2f}, at 64x4 "
        f"{pn['64x4'][2] / serve['single4_rate']:.2f}); host build {pn['phases'].get('kernel', 0):.3f}s "
        f"({pn['workers']} threads), start_all {pn['start_s']:.3f}s; respawn "
        f"{pn['respawn_s']:.3f}s; write-to-visible over the pool (the first / last "
        f"of 24 agreeing answers after the write returned): leaf insert {pn['leaf'][0]:.3f}/{pn['leaf'][1]:.3f}s, "
        f"role -> role delete {pn['delete'][0]:.3f}/{pn['delete'][1]:.3f}s; "
        f"B1 0, B2 0")

    # -- 9. wire workers: encoded frames from 4 processes into one batcher -------
    t0 = time.perf_counter()
    wn = serve_wire(args, serve, card)
    walls["serve:wire"] = time.perf_counter() - t0
    ww, w1 = wn["wire"], wn["single"]
    say(f"[numbers] serve:wire ({card}; host os.cpu_count() {wn['cpus']}; host query "
        f"mode, cache off; {args.checks} checks as frames of {WIRE_ROWS} rows x"
        f"{WIRE_REPEATS} a drive, {WIRE_DRIVES} drives of each in turns, from 64 "
        f"clients in 4 processes started together; frames/s the median drive's "
        f"[slowest, fastest], p50/p99 over every drive): {WIRE_WORKERS} processes "
        f"(wire_workers {WIRE_WORKERS}) {ww['frames_s']:.1f} frames/s "
        f"[{ww['frames_s_range'][0]:.1f}, {ww['frames_s_range'][1]:.1f}], "
        f"{ww['checks_s']:.0f} checks/s, drives {fmt_walls(ww['walls'])} s, p50/p99 "
        f"{ww['p50']:.3f}/{ww['p99']:.3f} ms, {ww['ring']} of {ww['frames']} frames "
        f"over the ring; one process {w1['frames_s']:.1f} frames/s "
        f"[{w1['frames_s_range'][0]:.1f}, {w1['frames_s_range'][1]:.1f}], "
        f"{w1['checks_s']:.0f} checks/s, drives {fmt_walls(w1['walls'])} s, p50/p99 "
        f"{w1['p50']:.3f}/{w1['p99']:.3f} ms; wire/single (medians) "
        f"{ww['checks_s'] / w1['checks_s']:.3f}; respawn {wn['respawn_s']:.3f}s; "
        f"B1 0, B2 0")
    serve["overload"] = ov
    return serve


# -- [fleet]: a leader and two followers of rbac1m on one card -----------------

FLEET_WRITES = 1000  # acked REST writes, each read back on both followers
FLEET_CLIENTS = 64  # GET /check clients, over the followers and on the leader
FLEET_DRIVE = 2048  # GET /check requests per timed drive
FLEET_LEASE_TTL_S = 2.0  # cluster.election.lease_ttl_s of every node
FLEET_KILL_AFTER = 200  # acked writes of the failover drive before the SIGKILL
FLEET_BOOT_S = 300.0  # a node's boot, to its first POOL line


def fleet_values(durable_root: str, scratch: str, role: str, instance: str,
                 upstream: str = "") -> dict:
    """One node's config: the serve phase's engine settings, the cluster
    plane with lease election over [durable]'s WAL directory (the shared
    disk), and the role's replication block. The leader is [durable]'s
    WAL'd columnar store; a follower holds a plain columnar store seeded
    from the leader's checkpoint, with the scrubber on for its replica kind
    (the cycles are stepped by the smoke; the replay kind off, as on the
    serve phase's server; the bounce drill's 503s must not freeze it)."""
    values = durable_values(durable_root) if role == "leader" else serve_config(
        "auto", cache_size=0)
    values["cluster"] = {
        "enabled": True, "instance_id": instance,
        "heartbeat_interval_ms": 200, "scrape_interval_ms": 500,
        "election": {"enabled": True, "lease_ttl_s": FLEET_LEASE_TTL_S,
                     "heartbeat_interval_ms": 200,
                     "wal_dir": os.path.join(durable_root, "wal")},
    }
    if role == "leader":
        values["replication"] = {"role": "leader", "poll_interval_ms": 10}
    else:
        values["replication"] = {"role": "follower", "upstream": upstream,
                                 "dir": os.path.join(scratch, instance),
                                 "poll_interval_ms": 10}
        values["scrub"] = {"enabled": True, "interval_s": 3600, "replay_per_cycle": 0,
                           "freeze_burn_rate": 1e9}
    return values


def fleet_server_main(args) -> int:
    """A [fleet] node, in a fresh interpreter (this script with --fleet-server
    CFG, a JSON file of Registry values): start_all on the card (a leader
    recovers [durable]'s store, a follower bootstraps from the leader's
    checkpoint and builds D with B1), then its boot build's D held against a
    plain build of the same interior. One POOL line with its ports, boot
    seconds and B1 launches, then commands on stdin: info, oracle <json
    tuples>, present <json tuples>, scrub, arm <site>, stop."""
    Config, Registry = port("driver", "Config", "Registry")
    masked_spmv = port("engine", "masked_spmv")
    pack_adjacency = port("ops.closure", "pack_adjacency")
    RelationTuple = port("relationtuple", "RelationTuple")
    subject_node_key = port("graph.vocab", "subject_node_key")
    FAULTS = port("faults", "FAULTS")
    harness = port("", "poolharness")

    t_boot = time.perf_counter()
    # the node's stderr (its log) goes to CFG.log, so that the pipe of POOL
    # documents carries nothing else; the smoke prints its tail on a failure
    log_fd = os.open(args.fleet_server + ".log", os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(log_fd, 2)
    os.close(log_fd)
    with open(args.fleet_server) as f:
        values = json.load(f)
    upstream = values["replication"].get("upstream")
    if upstream:  # a follower boots beside its leader: wait for its feed
        fetch = port("utils.urlfetch", "fetch")
        deadline = time.monotonic() + FLEET_BOOT_S
        while True:
            try:
                if fetch(f"{upstream}/replication/status", timeout=5.0)[0] == 200:
                    break
            except OSError:
                pass
            require(time.monotonic() < deadline, f"no leader at {upstream}")
            time.sleep(0.1)
    dev = torch.device(args.device)
    reg = Registry(Config(values=values), device=dev)
    store = reg.store()
    inner = getattr(store, "inner", store)
    masked_spmv.masked_step.launches = 0  # this server's path starts here
    t0 = time.perf_counter()
    read_port, write_port = reg.start_all()
    start_s = time.perf_counter() - t0
    boot_launches = masked_spmv.masked_step.launches
    eng = reg.check_engine()
    st = eng._state
    t0 = time.perf_counter()
    d_plain = masked_spmv.build_closure_semiring(
        pack_adjacency(st.ig.ii_src, st.ig.ii_dst, st.m_pad), st.ig.m, m_pad=st.m_pad,
        k_max=st.k_max, device=dev, step=masked_spmv.masked_step_plain,
    )
    plain_equal = bool(torch.equal(st.d, d_plain))
    plain_s = time.perf_counter() - t0
    del d_plain

    def info(_arg: str = "") -> dict:
        em, rep = reg._election, reg._replicator
        return {
            "read": read_port, "write": write_port, "pid": os.getpid(),
            "version": store.version, "tuples": len(store),
            "role": em.role if em is not None else reg.replication_role(),
            "election": em.status() if em is not None else None,
            "start_s": start_s, "boot_s": time.perf_counter() - t_boot,
            "boot_b1": boot_launches, "b1": masked_spmv.masked_step.launches,
            "seed": dict(reg.follower_boot),
            "phases": {k: round(v, 4) for k, v in eng.last_build_phases.items()},
            "plain_equal": plain_equal, "plain_s": plain_s, "m": int(st.ig.m),
            "host": eng.host_queries(),
            "reseeds": rep.reseeds_total if rep is not None else 0,
            "promotion": dict(reg.last_promotion),
        }

    def oracle(arg: str) -> dict:
        so = SetGraphOracle(inner)
        return {"expect": so.batch([RelationTuple.from_dict(t) for t in json.loads(arg)])}

    def present(arg: str) -> dict:
        src, dst, vocab, _ = inner.snapshot_ids()
        n = len(vocab)
        have = np.unique(src.astype(np.int64) * n + dst.astype(np.int64))
        out = []
        for d in json.loads(arg):
            t = RelationTuple.from_dict(d)
            a = vocab.lookup((t.namespace, t.object, t.relation))
            b = vocab.lookup(subject_node_key(t.subject))
            if a is None or b is None:
                out.append(False)
                continue
            key = a * n + b
            i = int(np.searchsorted(have, key))
            out.append(i < len(have) and int(have[i]) == key)
        return {"present": out}

    def scrub(_arg: str = "") -> dict:
        t0 = time.perf_counter()
        event = reg.scrubber().step()
        findings = [f for f in event.get("findings", []) if f.get("kind") == "replica"]
        return {"replica": findings[0] if findings else None, "s": time.perf_counter() - t0,
                "repairs": dict(reg.scrubber().repairs),
                "reseeds": reg._replicator.reseeds_total,
                "b1": masked_spmv.masked_step.launches}

    def arm(site: str) -> dict:
        FAULTS.arm(site)
        return {"armed": FAULTS.armed(site)}

    def stop() -> dict:
        reg.stop_all()
        return {"stopped": True, "b1": masked_spmv.masked_step.launches,
                "fired": FAULTS.fired("replica.skip_delta")}

    harness.emit(info())
    return harness.serve_commands(
        {"info": info, "oracle": oracle, "present": present, "scrub": scrub, "arm": arm},
        stop)


def _status_token(write: str) -> str:
    """The token of the newest durable write: /replication/status's version
    and WAL position (a REST PUT answers the tuple, not a token)."""
    status, doc = http("GET", f"{write}/replication/status")
    require(status == 200, f"GET /replication/status: {status}")
    wal = doc.get("wal") or {}
    return f"z{doc['version']}.{wal.get('segment', 0)}.{wal.get('offset', 0)}"


def _fleet_writes(args, prefix: str, n: int, interior: bool = True) -> list:
    """`n` writes on rbac1m's pools, as [durable]'s: with `interior` a tenth
    are role -> role edges (the followers' overlays patch D rows on the
    card), the rest grants and group joins of fresh users (leaves, each a
    tuple no one wrote before)."""
    roles, resources, groups = durable_pools(args)
    out = []
    for i in range(n):
        if interior and i % 10 == 0:
            a, b = roles[(i * 13 + 1) % len(roles)], roles[(i * 17 + 5) % len(roles)]
            if a == b:
                b = roles[(i * 17 + 6) % len(roles)]
            out.append(to_tuple(a, b))
        elif i % 10 < 6:
            out.append(to_tuple(resources[i * 7_919 % len(resources)], (f"{prefix}-u{i}",)))
        else:
            out.append(to_tuple(groups[i % len(groups)], (f"{prefix}-u{i}",)))
    return out


def serve_fleet(args, card: str, persist: dict, durable: dict) -> dict:
    """[fleet]: a leader over [durable]'s directory and two followers, each a
    --fleet-server interpreter on the one card, with lease election over
    the shared WAL directory. Convergence of FLEET_WRITES acked writes on
    both followers at each write's token (the wait path), the bounce, the
    sample equal everywhere to the host oracle, a follower's read-only write
    plane, federation and a stitched hedged trace, the replica scrub (clean,
    then replica.skip_delta: divergence and reseed), GET /check from
    FLEET_CLIENTS clients over the followers beside the leader alone, and a
    SIGKILLed leader mid-drive: a follower wins the next term, no acked
    write lost, no phantom tuple, the other follower retargets."""
    import http.client as http_client
    import signal
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    harness = port("", "poolharness")
    fetch = port("utils.urlfetch", "fetch")
    ReplicatedRestClient = port("client", "ReplicatedRestClient")
    HedgePolicy, Hedger = port("client.hedge", "HedgePolicy", "Hedger")
    LeaseStore = port("cluster.election", "LeaseStore")
    tag = "fleet"
    t_phase = time.perf_counter()

    def at() -> str:
        return f"+{time.perf_counter() - t_phase:.1f}s"

    root = durable["root"]
    scratch = tempfile.mkdtemp(prefix="keto-fleet-")
    sample, out = persist["sample"], {"launches": 0}
    servers: dict = {}
    failed = True

    def boot(name: str, values: dict):
        cfg = os.path.join(scratch, f"{name}.json")
        with open(cfg, "w") as f:
            json.dump(values, f)
        return harness.PoolProcess(
            [sys.executable, str(Path(__file__).resolve()), "--fleet-server", cfg,
             "--device", str(args.device)], name=f"fleet {name}")

    def check_status(read: str, t, token: str = "", headers=None):
        q = tuple_query(t) + (f"&snaptoken={token}" if token else "")
        status, raw, hdrs = fetch(f"{read}/check?{q}", headers=headers or {})
        return status, (json.loads(raw) if raw else None), hdrs

    try:
        # -- boots, all three at once: the leader recovers [durable]'s store
        # on ports chosen here; the followers wait for its feed, then
        # bootstrap from its checkpoint
        t0 = time.perf_counter()
        ports = port("driver.replicas", "resolve_free_ports")([("127.0.0.1", 0)] * 2)
        lr, lw = (f"http://127.0.0.1:{p}" for p in ports)
        values = fleet_values(root, scratch, "leader", "leader-0")
        values["serve"]["read"]["port"], values["serve"]["write"]["port"] = ports
        servers["leader"] = boot("leader", values)
        for i in range(2):
            servers[f"f{i}"] = boot(f"follower-{i}", fleet_values(
                root, scratch, "follower", f"follower-{i}", upstream=lw))
        lead = servers["leader"].next_doc(FLEET_BOOT_S)
        leader_boot_s = time.perf_counter() - t0
        require(lead["role"] == "leader" and lead["plain_equal"] and not lead["host"]
                and [lead["read"], lead["write"]] == ports, f"[{tag}] leader boot {lead}")
        fol = [servers[f"f{i}"].next_doc(FLEET_BOOT_S) for i in range(2)]
        follower_boot_s = time.perf_counter() - t0
        fr = [f"http://127.0.0.1:{d['read']}" for d in fol]
        fw = [f"http://127.0.0.1:{d['write']}" for d in fol]
        for i, d in enumerate(fol):
            require(d["role"] == "follower" and d["boot_b1"] > 0 and d["plain_equal"]
                    and not d["host"] and d["seed"].get("bytes", 0) > 0
                    and d["version"] >= lead["version"],
                    f"[{tag}] follower-{i} boot {d}")
        out["boot"] = {"leader": lead, "followers": fol}
        say(f"[{tag} {at()}] leader-0 from [durable]'s directory: version {lead['version']}, "
            f"{lead['tuples']} tuples, serving {leader_boot_s:.3f}s after its start (start_all "
            f"{lead['start_s']:.3f}s, {lead['boot_b1']} B1 launches); the two followers, "
            f"started beside it, serving after {follower_boot_s:.3f}s: "
            + "; ".join(
                f"follower-{i} checkpoint {d['seed']['bytes']} bytes fetched in "
                f"{d['seed']['fetch_s']:.3f}s, restored in {d['seed']['restore_s']:.3f}s, "
                f"snapshot encode {d['phases'].get('snapshot_encode', 0):.3f}s, interior "
                f"{d['phases'].get('interior', 0):.3f}s, B1 build "
                f"{d['phases'].get('kernel', 0):.3f}s ({d['boot_b1']} launches, D "
                f"byte-equal to the plain build of m={d['m']})" for i, d in enumerate(fol))
            + f" ({card})")

        # -- convergence: each acked write's token read back on both followers
        writes = _fleet_writes(args, "fleet", FLEET_WRITES)
        visible = []

        def write_and_read(i_t):
            i, t = i_t
            require(rest_write(lw, "PUT", t) == 201, f"[{tag}] write {t} not acked")
            t_ack = time.perf_counter()
            token = _status_token(lw)
            first = i % 2
            for k in (first, 1 - first):
                status, doc, _ = check_status(fr[k], t, token)
                if k == first:
                    visible.append(time.perf_counter() - t_ack)
                require(status == 200 and doc == {"allowed": True},
                        f"[{tag}] follower-{k} at {token}: {status} {doc} for {t}")
            return token

        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            tokens = list(pool.map(write_and_read, enumerate(writes)))
        write_s = time.perf_counter() - t0
        token = _status_token(lw)
        out["visible_p50"], out["visible_p99"] = pct(visible, 50), pct(visible, 99)
        say(f"[{tag} {at()}] {len(writes)} acked REST writes to the leader (16 clients, a "
            f"tenth role -> role) in {write_s:.3f}s, each read back on both followers at "
            f"its token (e.g. {tokens[-1]}): all allowed; write-to-visible on a follower at "
            f"the write's token (ack -> /replication/status -> GET /check?snaptoken=) p50/p99 "
            f"{out['visible_p50']:.3f}/{out['visible_p99']:.3f} ms ({card})")

        # -- the bounce: a token far ahead, a zero wait
        far = f"z{int(token[1:].split('.')[0]) + 10 ** 9}.0.0"
        status, doc, hdrs = check_status(fr[0], writes[1], far, {"X-Request-Deadline-Ms": "0"})
        details = ((doc or {}).get("error") or {}).get("details") or {}
        require(status == 503 and hdrs.get("Retry-After") == "1"
                and details.get("lag_versions", 0) >= 10 ** 9,
                f"[{tag}] bounce: {status} {doc} {dict(hdrs)}")
        # a write to a follower: the read-only follower error, the leader hint
        status, doc = http("PUT", f"{fw[1]}/relation-tuples", writes[2].to_dict())
        hint = (((doc or {}).get("error") or {}).get("details") or {}).get("leader_hint") or {}
        require(status == 503 and "read-only follower" in doc["error"]["message"]
                and hint.get("write_url") == lw and hint.get("leader_id") == "leader-0",
                f"[{tag}] follower write: {status} {doc}")
        say(f"[{tag} {at()}] bounce: {far} with a zero wait -> 503, Retry-After "
            f"{hdrs.get('Retry-After')}, lag_versions {details['lag_versions']}; a write to "
            f"follower-1: 503 {doc['error']['message']!r} with leader_hint {hint}")

        # -- the sample everywhere, held to the host oracle
        expect = servers["leader"].ask("oracle " + json.dumps([t.to_dict() for t in sample]),
                                       600)["expect"]
        body = [t.to_dict() for t in sample]
        answers = {}
        for name, read in (("leader-0", lr), ("follower-0", fr[0]), ("follower-1", fr[1])):
            status, doc = http("POST", f"{read}/check/batch?snaptoken={token}", body)
            require(status == 200, f"[{tag}] {name} /check/batch: {status}")
            answers[name] = doc["allowed"]
        require(all(a == expect for a in answers.values()),
                f"[{tag}] the sample differs: "
                + ", ".join(f"{k} {sum(x != y for x, y in zip(v, expect))}"
                            for k, v in answers.items()))
        say(f"[{tag} {at()}] the {len(sample)}-check sample at {token} on the leader and both "
            f"followers equals the set-graph oracle over the leader's store "
            f"({sum(expect)} allowed)")

        # -- federation: three members alive, instance-labelled series, a
        # stitched hedged trace
        deadline = time.monotonic() + 30
        while True:
            status, cs = http("GET", f"{lr}/cluster/status")
            cl = (cs or {}).get("cluster") or {}
            if cl.get("alive", 0) >= 3 and cl.get("health") not in (None, "unknown"):
                break
            require(time.monotonic() < deadline, f"[{tag}] /cluster/status {cs}")
            time.sleep(0.2)
        ids = sorted(m["instance_id"] for m in cs["members"])
        require(ids == ["follower-0", "follower-1", "leader-0"], f"[{tag}] members {ids}")
        for om in (False, True):
            doc = scrape(lr, openmetrics=om)
            for i in range(2):
                require(doc.value("keto_cluster_replication_lag_versions",
                                  {"instance": f"follower-{i}"}) is not None
                        and doc.value("keto_cluster_member_up",
                                      {"instance": f"follower-{i}"}) == 1.0,
                        f"[{tag}] leader /metrics lacks follower-{i}'s series")
        hedger = Hedger(HedgePolicy(delay_s=0.0))  # always hedge
        stitched = None
        try:
            with ReplicatedRestClient(fr, write_url=lw, hedger=hedger) as rc:
                deadline = time.monotonic() + 30
                while stitched is None and time.monotonic() < deadline:
                    res = rc.check(sample[0], snaptoken=token)
                    require(res.allowed == expect[0], f"[{tag}] routed check")
                    tid = res.traceparent.split("-")[1]
                    for _ in range(20):
                        status, doc = http("GET", f"{lr}/debug/traces?trace_id={tid}")
                        insts = {s.get("instance") for s in (doc or {}).get("spans", [])}
                        if status == 200 and doc.get("stitched") and len(insts) >= 2:
                            stitched = doc
                            break
                        time.sleep(0.1)
                routed = rc.router.snapshot()
        finally:
            hedger.close()
        require(stitched is not None and stitched["hedge"]["winner"],
                f"[{tag}] no stitched hedged trace with spans from 2 processes")
        say(f"[{tag} {at()}] /cluster/status: {cl['alive']}/{cl['members']} alive, health "
            f"{cl['health']}, election term {cl['election']['observed_term']} leader "
            f"{cl['election']['leader_id']}; keto_cluster_* per instance in text and "
            f"OpenMetrics; a hedged check pair through ReplicatedRestClient is one stitched "
            f"trace on the leader ({sorted(stitched['instances'])}, winner "
            f"{stitched['hedge']['winner']['instance']}); the router's known versions "
            f"{[v['known_version'] for v in routed.values()]}")

        # -- GET /check from FLEET_CLIENTS clients: over both followers, then
        # on the leader alone
        picks = [sample[i % len(sample)] for i in range(FLEET_DRIVE)]
        want = [expect[i % len(sample)] for i in range(FLEET_DRIVE)]
        rates = {}
        for name, reads in (("followers", fr), ("leader", [lr])):
            urls = [f"{reads[i % len(reads)]}/check?{tuple_query(t)}"
                    for i, t in enumerate(picks)]
            results, wall = http_clients(urls, FLEET_CLIENTS, procs=4)
            require([s for s, _ in results] == [200 if w else 403 for w in want],
                    f"[{tag}] the {name} drive's answers differ from the oracle")
            secs = [sec for _, sec in results]
            rates[name] = (len(urls) / wall, pct(secs, 50), pct(secs, 99))
        out["rates"] = rates
        say(f"[{tag} {at()}] GET /check, {FLEET_CLIENTS} clients in 4 processes, "
            f"{FLEET_DRIVE} requests each: over both followers {rates['followers'][0]:.0f} "
            f"checks/s p50/p99 {rates['followers'][1]:.3f}/{rates['followers'][2]:.3f} ms; "
            f"the leader alone {rates['leader'][0]:.0f} checks/s p50/p99 "
            f"{rates['leader'][1]:.3f}/{rates['leader'][2]:.3f} ms; every answer the "
            f"oracle's ({card})")

        # -- anti-entropy: a clean replica cycle, then replica.skip_delta
        version = http("GET", f"{lw}/replication/status")[1]["version"]
        for i in range(2):
            deadline = time.monotonic() + 30
            while servers[f"f{i}"].ask("info")["version"] < version:
                require(time.monotonic() < deadline, f"[{tag}] follower-{i} lags")
                time.sleep(0.05)
        clean = servers["f0"].ask("scrub", 300)
        rf = clean["replica"]
        require(rf and rf.get("mismatches") == 0 and rf.get("version") == version,
                f"[{tag}] clean replica cycle {clean}")
        servers["f1"].ask("arm replica.skip_delta")
        skipped = _fleet_writes(args, "fleet-skip", 2)[1]  # a leaf grant
        require(rest_write(lw, "PUT", skipped) == 201, f"[{tag}] the skipped write")
        token = _status_token(lw)
        deadline = time.monotonic() + 30
        while servers["f1"].ask("info")["version"] < version + 1:
            require(time.monotonic() < deadline, f"[{tag}] follower-1 lags")
            time.sleep(0.05)
        require(check_status(fr[1], skipped)[0] == 403
                and check_status(fr[0], skipped, token)[0] == 200,
                f"[{tag}] replica.skip_delta did not diverge follower-1 alone")
        found = servers["f1"].ask("scrub", 300)
        rf2 = found["replica"]
        require(rf2 and rf2.get("mismatches", 0) >= 1 and found["reseeds"] == 1
                and found["repairs"].get("reseed") == 1,
                f"[{tag}] divergent replica cycle {found}")
        t0 = time.perf_counter()
        status, doc, _ = check_status(fr[1], skipped, token)
        healed_s = time.perf_counter() - t0
        require(status == 200, f"[{tag}] follower-1 after the reseed: {status} {doc}")
        out["scrub"] = {"clean_s": clean["s"], "repair_s": found["s"],
                        "b1": found["b1"] - fol[1]["boot_b1"]}
        say(f"[{tag} {at()}] replica scrub: follower-0's digest equals the leader's at "
            f"version {version} ({rf['chunks']} chunks, cycle {clean['s']:.3f}s); "
            f"replica.skip_delta on follower-1: lag 0, the write missing, the next cycle "
            f"finds {rf2['mismatches']} divergent chunk(s) at version {rf2['version']} and "
            f"reseeds (cycle with the reseed and the residency rebuild {found['s']:.3f}s, "
            f"{out['scrub']['b1']} B1 launches); the write then answers at its token after "
            f"{healed_s:.3f}s ({card})")
        planes_idle(fr[0], f"{tag} follower-0")
        planes_idle(lr, f"{tag} leader-0")

        # -- failover: SIGKILL the leader mid-drive, lease held
        pre = servers["leader"].ask("info")
        base = pre["tuples"]
        drive = _fleet_writes(args, "fleet-kill", 4000, interior=False)
        acked, attempted = [], []
        stop_drive = threading.Event()
        kill = {}

        def writer(k: int) -> None:
            for t in drive[k::4]:
                if stop_drive.is_set():
                    return
                attempted.append(t)
                try:
                    if rest_write(lw, "PUT", t) == 201:
                        acked.append(t)
                except (OSError, http_client.HTTPException):
                    return  # the leader is gone (an answer cut short is no ack)

        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(writer, k) for k in range(4)]
            deadline = time.monotonic() + 60
            while len(acked) < FLEET_KILL_AFTER:
                require(time.monotonic() < deadline, f"[{tag}] the failover drive stalled")
                time.sleep(0.01)
            kill["t"] = time.time()
            t_kill = time.perf_counter()
            os.killpg(servers["leader"].proc.pid, signal.SIGKILL)
            servers["leader"].proc.wait(timeout=60)
            servers["leader"].stopped = True
            stop_drive.set()
            for f in futs:
                f.result()
        winner = None
        deadline = time.monotonic() + 60
        while winner is None:
            require(time.monotonic() < deadline, f"[{tag}] no follower promoted")
            for i in range(2):
                d = servers[f"f{i}"].ask("info")
                if d["role"] == "leader":
                    winner, wdoc = i, d
            time.sleep(0.05)
        won_s = wdoc["election"]["last_transition"]["at"] - kill["t"]
        loser = 1 - winner
        first = _fleet_writes(args, "fleet-after", 3)[1]
        deadline = time.monotonic() + 60
        while rest_write(fw[winner], "PUT", first) != 201:
            require(time.monotonic() < deadline, f"[{tag}] the promoted leader refuses")
            time.sleep(0.02)
        first_s = time.perf_counter() - t_kill
        acked_set = {str(t) for t in acked}
        require(len(acked_set) == len(acked), f"[{tag}] duplicate writes in the drive")
        got = servers[f"f{winner}"].ask(
            "present " + json.dumps([t.to_dict() for t in acked]), 300)["present"]
        lost = got.count(False)
        tried = servers[f"f{winner}"].ask(
            "present " + json.dumps([t.to_dict() for t in attempted]), 300)["present"]
        after = servers[f"f{winner}"].ask("info")
        phantom = after["tuples"] - (base + sum(tried) + 1)
        lineage = LeaseStore(os.path.join(root, "wal")).lineage()
        terms = [r["term"] for r in lineage]
        out["lineage"] = [(r["term"], r["leader_id"], round(r["at"] - kill["t"], 3))
                          for r in lineage if r["at"] >= kill["t"]]
        out["promotions"] = {
            f"follower-{i}": (d["promotion"], d["election"]["transitions"],
                              d["election"]["last_transition"])
            for i, d in ((i, servers[f"f{i}"].ask("info")) for i in range(2))}
        require(lost == 0, f"[{tag}] {lost} acked writes lost across the failover")
        require(phantom == 0, f"[{tag}] {phantom} tuples nobody wrote on the new leader")
        require(len(terms) >= 2 and all(b > a for a, b in zip(terms, terms[1:]))
                and after["election"]["term"] == terms[-1],
                f"[{tag}] the term lineage {terms}")
        token = _status_token(fw[winner])
        status, doc, _ = check_status(fr[loser], first, token)
        require(status == 200, f"[{tag}] follower-{loser} after the failover: {status} {doc}")
        out["failover"] = {"won_s": won_s, "first_s": first_s, "lost": lost,
                           "acked": len(acked), "attempted": len(attempted),
                           "terms": terms}
        say(f"[{tag} {at()}] SIGKILL of leader-0 after {len(acked)} acked writes of a "
            f"4-client drive ({len(attempted)} attempted, {sum(tried) - len(acked)} durable "
            f"but unacked): follower-{winner} won term {terms[-1]} {won_s:.3f}s after the kill "
            f"(lease TTL {FLEET_LEASE_TTL_S}s), replayed the shared WAL and acked its first "
            f"write {first_s:.3f}s after it; acked writes lost {lost}, phantom tuples "
            f"{phantom}; term lineage {terms}, after the kill {out['lineage']} (term, "
            f"holder, s); promotions {out['promotions']}; follower-{loser} retargeted "
            f"and answers the new leader's write at {token} ({card})")
        for i in range(2):
            done = servers[f"f{i}"].stop(300)
            require(done["stopped"], f"[{tag}] follower-{i} stop {done}")
            out["launches"] += done["b1"]
        out["launches"] += pre["b1"]  # the leader's, read before the SIGKILL
        failed = False
    finally:
        for server in servers.values():
            if not server.stopped:
                server.kill_group()
        if failed:  # each node's log tail, for the failure's reader
            for name in ("leader", "follower-0", "follower-1"):
                path = os.path.join(scratch, f"{name}.json.log")
                if os.path.exists(path):
                    with open(path, errors="replace") as f:
                        tail = f.readlines()[-40:]
                    print(f"[{tag}] {name}'s log, last lines:\n" + "".join(tail),
                          file=sys.stderr, flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tuples", type=int, default=1_000_000)
    ap.add_argument("--gh-tuples", type=int, default=10_000_000)
    ap.add_argument("--checks", type=int, default=4096)
    # the host BFS oracle's share of the sample in [main:*]: the host
    # CheckEngine is slow at github10m, and 128 keeps the smoke in its budget
    ap.add_argument("--oracle", type=int, default=128)
    ap.add_argument("--pool-server", action="store_true",
                    help="run the [serve:pool] server (the smoke starts it)")
    ap.add_argument("--pool-workers", type=int, default=POOL_WORKERS,
                    help="the pool server's serve.read.workers")
    ap.add_argument("--wire-workers", type=int, default=1,
                    help="the pool server's serve.read.wire_workers")
    ap.add_argument("--query-mode", default="auto",
                    help="the pool server's engine.query_mode")
    ap.add_argument("--durable-server", default="",
                    help="run the [durable] server over this directory (the smoke "
                         "starts it)")
    ap.add_argument("--device", default="cuda", help="the [durable] server's device")
    ap.add_argument("--cli-server", default="",
                    help="run the [cli] server, `serve -c` of this config (the smoke "
                         "starts it)")
    ap.add_argument("--config-server", default="",
                    help="run the [config] server, `serve -c` of this config (the "
                         "smoke starts it)")
    ap.add_argument("--cli-client", default="",
                    help="run these client verbs in process (the smoke starts it)")
    ap.add_argument("--fleet-server", default="",
                    help="run a [fleet] node with the Registry values in this JSON "
                         "file (the smoke starts it)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    if args.pool_server:
        return pool_server_main(args)
    if args.durable_server:
        return durable_server_main(args)
    if args.cli_server or args.config_server:
        return cli_server_main(args.cli_server or args.config_server)
    if args.cli_client:
        return cli_client_main(args)
    if args.fleet_server:
        return fleet_server_main(args)
    masked_spmv = port("engine", "masked_spmv")
    _m_pad_for = port("engine.closure", "_m_pad_for")
    pack_adjacency = port("ops.closure", "pack_adjacency")
    kernels = port("utils", "kernels")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: full f32
    torch.backends.cudnn.allow_tf32 = False
    step = masked_spmv.masked_step
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t_all = time.perf_counter()
    walls = {}

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
    native = port("", "native")
    native.load()  # gcc, at first use, into keto_tpu_torch/_build/
    require(native.lib is not None and native.tuple_hash_ok,
            f"the native host tier did not load ({native.build_error or 'tuple hash'})")
    say(f"[build] native host tier: {native.so_path} ({native.build_s:.3f}s of gcc; "
        f"0.0 = already built), tuple-hash selftest passed")
    walls["build"] = time.perf_counter() - t0

    # -- 2. kernels vs plain ----------------------------------------------------
    t0 = time.perf_counter()
    max_err = 0.0
    b1_cases = [(256, m, p) for m in (256, 2048, 11520) for p in (0.002, 0.05)]
    b1_cases += [(128, 128, 0.05), (128, 384, 0.05), (256, 17152, 0.001)]
    for g, m, density in b1_cases:
        f, a, r = random_masks(gen, g, m, density, dev)
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
            f"kernel != plain at G={g} M={m} density={density} (err {err})",
        )
        require(kr[1, 5] == 1 and not kn[0].any(), f"edge rows at M={m}")
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
    say(f"[kernels] B1 bitwise equal at "
        + ", ".join(f"[{g}, {m}]" for g, m, _ in b1_cases)
        + "; D equal at "
        f"m={m_small} m_pad={m_pad_small}; max_abs_err={max_err}")
    del d_kernel, d_plain
    b2_err = check_b2_small(rng, gen, dev)
    say("[kernels] B2 bitwise equal at N_pad=4096 W=128, N_pad=16384 W=256, "
        "N_pad=2^20 W=128")
    walls["kernels"] = time.perf_counter() - t0

    # -- 3. examples ------------------------------------------------------------
    t0 = time.perf_counter()
    run_example(repo, dev)
    walls["example"] = time.perf_counter() - t0

    # -- 4. closure path at rbac1m ----------------------------------------------
    t0 = time.perf_counter()
    b1 = run_rbac(args, rng, dev, card)
    b1["max_abs_err"] = max_err
    walls["main:closure"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # -- 5. packed path at github10m --------------------------------------------
    t0 = time.perf_counter()
    b2 = run_github(args, rng, dev)
    b2["max_abs_err"] = b2_err
    walls["main:packed"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    serve = serve_phases(args, dev, card, walls, b1["ms"])

    # -- 10. persistence: rbac1m on sqlite, then spawned read workers ------------
    t0 = time.perf_counter()
    persist = serve_persist(args, dev, card, serve)
    walls["persist"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spawn = serve_persist_spawn(args, dev, card, persist)
    walls["persist:spawn"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # -- 11. durability: the WAL, a SIGKILL and boot recovery --------------------
    t0 = time.perf_counter()
    durable = serve_durable(args, dev, card, persist["sample"])
    walls["durable"] = time.perf_counter() - t0

    # -- 12. the CLI and the client SDK against rbac1m on sqlite ---------------
    t0 = time.perf_counter()
    cn = serve_cli(args, card, persist, durable)
    walls["cli"] = time.perf_counter() - t0

    # -- 13. config and the public port: env, watched namespaces, TLS, reload --
    t0 = time.perf_counter()
    cf = serve_config_plane(args, card, persist, cn)
    walls["config"] = time.perf_counter() - t0

    # -- 14. the fleet: a leader and two followers, failover -------------------
    t0 = time.perf_counter()
    fl = serve_fleet(args, card, persist, durable)
    walls["fleet"] = time.perf_counter() - t0

    walls["total"] = time.perf_counter() - t_all
    say(f"[numbers] card: {card}")
    say("[numbers] phase wall seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    pn, sp = persist, spawn
    say(f"[numbers] persist ({card}): sqlite load {pn['load_s']:.3f}s for "
        f"{args.tuples} tuples ({pn['db_mib']:.1f} MiB); start_all {pn['start_s']:.3f}s "
        f"= SQL read {pn['read_s']:.3f}s + snapshot encode {pn['encode_s']:.3f}s + "
        f"interior {pn['phases'].get('interior', 0):.3f}s + B1 build "
        f"{pn['phases'].get('kernel', 0):.3f}s ({pn['start_launches']} launches) + the "
        f"rest; sample batch {pn['batch_s'] * 1e3:.3f} ms; write-to-visible p50/p99 "
        f"{pn['visible_p50']:.3f}/{pn['visible_p99']:.3f} ms; spawn pool "
        f"({SPAWN_WORKERS} processes, host query mode): {sp['rate']:.0f} checks/s, "
        f"p50/p99 {sp['p50']:.3f}/{sp['p99']:.3f} ms at 64 clients in 4 processes, "
        f"worker boot s {[round(b, 3) for b in sp['boot_s']]}; B1 launches: the "
        f"parent {sp['launches']}, the opt-in pool {sp['accel_launches']}")
    dn = durable
    rec = dn["recovery"]
    say(f"[numbers] durable ({card}): recovery {rec['duration_s']:.3f}s (checkpoint "
        f"{rec['checkpoint_s']:.3f}s + replay of {rec['replayed']} records "
        f"{rec['replay_s']:.3f}s, gap {rec['gap']}); start_all after it "
        f"{dn['restart_start_s']:.3f}s; restart to the first batch "
        f"{dn['first_batch_s']:.3f}s; cold re-ingest {dn['reingest_s']:.3f}s; CSR "
        f"primed after the SIGKILL {dn['csr_primed_kill']}, after a graceful stop "
        f"{dn['csr_primed']} (start_all {dn['primed_start_s']:.3f}s); B1 launches "
        f"over three boots {dn['launches']}")
    say(f"[numbers] cli ({card}): the client verbs, process / in process s: "
        + ", ".join(f"{k} {p:.3f}/{i:.4f}" for k, (p, i) in cn["verbs"].items())
        + "; the 4096 sample, p50 ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in cn["batch_p50"].items())
        + f"; serial single checks p50/p99 ms: RestClient {cn['serial']['rest'][0]:.3f}/"
        f"{cn['serial']['rest'][1]:.3f}, GrpcClient {cn['serial']['grpc'][0]:.3f}/"
        f"{cn['serial']['grpc'][1]:.3f}; {CLI_HEDGED} check_hedged p50/p99 "
        f"{cn['hedged'][0]:.3f}/{cn['hedged'][1]:.3f} ms, fired/won/wasted/suppressed "
        f"{cn['hedged'][2]}; doctor {cn['doctor_s']:.3f}s over {durable['tuples']} "
        f"tuples; serve boot {cn['boot_s']:.3f}s with {cn['boot_launches']} B1 "
        f"launches, {cn['launches']} over its life")
    say(f"[numbers] config ({card}): serve boot {cf['boot_s']:.3f}s with "
        f"{cf['boot_launches']} B1 launches, {cf['launches']} over its life; the 4096 "
        f"sample p50 ms over TLS: HTTPS /check/batch {cf['p50']['rest']:.3f}, gRPC "
        f"BatchCheck {cf['p50']['grpc']:.3f} ([cli] plaintext: "
        f"{cn['batch_p50']['rest tuples']:.3f}, {cn['batch_p50']['grpc tuples']:.3f}); "
        f"namespace visible after {cf['ns_visible_s']:.3f}s; hot knobs reloaded "
        f"{cf['reload_s']:.3f}s after the edit; {CONFIG_CLIENTS} HTTPS clients: "
        f"{cf['load'][0]} checks, {cf['load'][1]:.0f}/s, p50/p99 {cf['load'][2]:.3f}/"
        f"{cf['load'][3]:.3f} ms, none failed")
    fb = fl["boot"]["followers"]
    fo = fl["failover"]
    say(f"[numbers] fleet ({card}): follower bootstrap s (checkpoint fetch / restore / "
        f"snapshot encode / interior / B1 build): "
        + "; ".join(f"follower-{i} {d['seed']['fetch_s']:.3f} / {d['seed']['restore_s']:.3f}"
                    f" / {d['phases'].get('snapshot_encode', 0):.3f} / "
                    f"{d['phases'].get('interior', 0):.3f} / {d['phases'].get('kernel', 0):.3f}"
                    f" (start_all {d['start_s']:.3f})" for i, d in enumerate(fb))
        + f"; checkpoint {fb[0]['seed']['bytes']} bytes; write-to-visible at the write's "
        f"token p50/p99 {fl['visible_p50']:.3f}/{fl['visible_p99']:.3f} ms; GET /check at "
        f"{FLEET_CLIENTS} clients: followers {fl['rates']['followers'][0]:.0f} checks/s "
        f"p50/p99 {fl['rates']['followers'][1]:.3f}/{fl['rates']['followers'][2]:.3f} ms, "
        f"leader alone {fl['rates']['leader'][0]:.0f} checks/s p50/p99 "
        f"{fl['rates']['leader'][1]:.3f}/{fl['rates']['leader'][2]:.3f} ms; failover "
        f"SIGKILL -> lease won {fo['won_s']:.3f}s -> first acked write {fo['first_s']:.3f}s; "
        f"acked writes lost {fo['lost']} of {fo['acked']}; B1 launches in the phase "
        f"{fl['launches']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    ov = serve["overload"]
    dv = serve["device"]
    say(f"[numbers] [device] ({card}): HBM budget {dv['budget_gib']:.3f} GiB; breaker "
        f"cost (batch_check of {args.checks}, p50 bare / breaker ms): device query mode "
        f"{dv['device_ms'][0]:.3f} / {dv['device_ms'][1]:.3f} = "
        f"{dv['device_ms'][1] / dv['device_ms'][0]:.3f}x, host query mode "
        f"{dv['host_ms'][0]:.3f} / {dv['host_ms'][1]:.3f} = "
        f"{dv['host_ms'][1] / dv['host_ms'][0]:.3f}x; scrub detect {dv['detect_s']:.3f}s, "
        f"repair {dv['repair_s']:.3f}s; host failover build {dv['host_build_s']:.3f}s, home "
        f"{dv['home_s']:.3f}s; rbac drills {dv['launches']} B1 launches in "
        f"{dv['wall_s']:.1f}s; packed drills {b2['drill_launches']} B2 launches in "
        f"{b2['drill_wall_s']:.1f}s")
    say(f"[numbers] B1 launches: main:closure {b1['launches']}, serve "
        f"{serve['launches']}, the list path's rebuild {serve['list_launches']}, "
        f"the cache server {serve['cache_launches']}, the overload server "
        f"{ov['launches']}, persist {persist['launches']}, the spawn pool's parent "
        f"{spawn['launches']}, the opt-in pool (parent and worker) "
        f"{spawn['accel_launches']}, durable's three boots {durable['launches']}, the "
        f"[cli] server {cn['launches']}, the [config] server {cf['launches']}, the "
        f"[fleet] nodes {fl['launches']}; B2 "
        f"launches: main:packed with its batcher drives {b2['launches']}")
    say(f"[numbers] [device] drill launches, not in the kernels line: B1 "
        f"{dv['launches']}, B2 {b2['drill_launches']}")
    # the kernels line counts each kernel's launches over every phase's
    # drive of the main path, each counted from 0 just before its run; the
    # [device] drills are not the main path's run
    b1["launches"] += (serve["launches"] + serve["list_launches"]
                       + serve["cache_launches"] + ov["launches"]
                       + persist["launches"] + spawn["launches"]
                       + spawn["accel_launches"] + durable["launches"]
                       + cn["launches"] + cf["launches"] + fl["launches"])
    say(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in (b1, b2)]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
