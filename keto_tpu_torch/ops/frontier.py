"""Batched frontier expansion over boolean frontiers (counterpart of
``keto_tpu/ops/frontier.py``).

A batch of B requests advances over the tuple graph in lockstep. State is a
boolean frontier ``F[B, padded_nodes]``; one expansion step computes the
successor set ``P`` of ``F`` along every edge and ORs it in. ``allowed[b]``
becomes true the first step the target node enters ``P`` within the
request's depth budget (a tuple of the queried object#relation matches at
depth 1; each subject-set indirection adds one).

Two propagation strategies:

- **dense**: the adjacency is materialized once per snapshot as a
  ``bf16[N, N]`` matrix and a step is ``F @ A`` (``torch.matmul`` in bf16;
  the JAX package leaves the same product to XLA's ``jnp.dot``). The inputs
  are 0/1 and every partial sum is a nonnegative integer, so ``> 0.5`` is an
  exact OR whatever the accumulation order or rounding of the result.
- **scatter**: edges stay as COO ``src/dst``; a step gathers ``F[:, src]``
  and ORs it into the ``dst`` columns, by an int32 ``index_add_`` of the
  gathered bits (a count of in-edges that fire, never above the edge count)
  and ``> 0``, over fixed-size edge chunks that bound the ``[B, chunk]``
  intermediate.

The JAX ``lax.while_loop`` is a host loop here: it runs while
``i < max_steps`` and not every request is done, reading ``done.all()``
once per step (the check loop's read is the ``frontier.done`` site of
``DEVSTATS.wait``, ``telemetry/devstats.py``). It evaluates the JAX loop's condition, so it stops where
that loop stops. The answers also equal those of a loop run to
``max_steps`` regardless (see ``_run_check`` and ``_run_distances``).
"""

from __future__ import annotations

import torch

from ..telemetry.devstats import DEVSTATS

# Unreachable sentinel for distance labels.
UNREACHED = 0x7FFFFFFF


def pick_edge_chunk(
    padded_edges: int, batch: int, budget_elems: int = 1 << 23
) -> int:
    """Edge-chunk length so the gathered [batch, chunk] intermediate stays
    under ~`budget_elems` elements; always divides padded_edges (both are
    powers of two)."""
    chunk = padded_edges
    while chunk > 1024 and batch * chunk > budget_elems:
        chunk //= 2
    return chunk


def build_dense_adjacency(src, dst, padded_nodes: int) -> torch.Tensor:
    """bf16[N, N] one-hot adjacency from COO edges (int tensors, on the
    device the adjacency should live on). The dummy node's padding
    self-edges are cleared so unknown subjects can never reach anything."""
    a = torch.zeros(
        (padded_nodes, padded_nodes), dtype=torch.bfloat16, device=src.device
    )
    a[src.long(), dst.long()] = 1
    a[padded_nodes - 1, padded_nodes - 1] = 0
    return a


def _one_hot_frontier(start, padded_nodes: int) -> torch.Tensor:
    nodes = torch.arange(padded_nodes, dtype=start.dtype, device=start.device)
    return nodes[None, :] == start[:, None]


def _make_scatter_propagate(src, dst, padded_nodes: int, edge_chunk: int):
    src = src.long()
    dst = dst.long()
    n_edges = src.shape[0]

    def propagate(f):
        counts = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
        for k in range(0, n_edges, edge_chunk):
            vals = f.index_select(1, src[k : k + edge_chunk]).to(torch.int32)
            counts.index_add_(1, dst[k : k + edge_chunk], vals)
        p = counts > 0
        # Padding edges are dummy->dummy; clearing the dummy column keeps the
        # dummy node (= every unknown subject) permanently unreachable.
        p[:, padded_nodes - 1] = False
        return p

    return propagate


def _make_dense_propagate(adj):
    def propagate(f):
        return torch.matmul(f.to(torch.bfloat16), adj) > 0.5

    return propagate


def batched_check_scatter(
    src, dst, start, target, depth, *, padded_nodes, edge_chunk, max_steps
) -> torch.Tensor:
    """allowed: bool[B] — COO gather/scatter propagation path."""
    propagate = _make_scatter_propagate(src, dst, padded_nodes, edge_chunk)
    return _run_check(propagate, start, target, depth, padded_nodes, max_steps)


def batched_check_dense(adj, start, target, depth, *, max_steps) -> torch.Tensor:
    """allowed: bool[B] — dense bf16 matmul propagation path (adj from
    build_dense_adjacency)."""
    propagate = _make_dense_propagate(adj)
    return _run_check(propagate, start, target, depth, adj.shape[0], max_steps)


def _run_check(propagate, start, target, depth, padded_nodes, max_steps):
    """Lockstep BFS check. Stopping early is exact: once a request is done
    its hit bit cannot change. A hit stays set. A frontier that stopped
    growing gives the same P next step, so `reached` repeats a value already
    tested at a smaller i (where `i < depth` held whenever it holds now).
    Past `i + 1 >= depth` the `i < depth` gate is closed for good."""
    batch = start.shape[0]
    f = _one_hot_frontier(start, padded_nodes)
    rows = torch.arange(batch, device=start.device)
    tgt = target.long()
    hit = torch.zeros(batch, dtype=torch.bool, device=start.device)
    done = torch.zeros(batch, dtype=torch.bool, device=start.device)
    i = 0
    while i < max_steps and not DEVSTATS.all_done(done, "frontier.done"):
        p = propagate(f)
        changed = (p & ~f).any(dim=1)
        reached = p[rows, tgt]
        hit |= reached & (i < depth)
        f |= p
        done |= hit | ~changed | ((i + 1) >= depth)
        i += 1
    return hit


def _run_distances(propagate, start, depth, padded_nodes, max_steps):
    """BFS levels. Stopping early is exact: a request whose active frontier
    stopped growing, or whose budget ran out (`active` false from then on),
    gets no new labels in any later step."""
    batch = start.shape[0]
    f = _one_hot_frontier(start, padded_nodes)
    dist = torch.where(
        f,
        torch.zeros((), dtype=torch.int32, device=start.device),
        torch.full((), UNREACHED, dtype=torch.int32, device=start.device),
    )
    done = torch.zeros(batch, dtype=torch.bool, device=start.device)
    i = 0
    while i < max_steps and not bool(done.all()):
        p = propagate(f)
        active = (i < depth)[:, None]
        fresh = p & ~f & active
        dist.masked_fill_(fresh, i + 1)
        f |= p & active
        done = ~fresh.any(dim=1) | ((i + 1) >= depth)
        i += 1
    return dist


def batched_distances_scatter(
    src, dst, start, depth, *, padded_nodes, edge_chunk, max_steps
) -> torch.Tensor:
    """BFS level per node per request: int32[B, padded_nodes], UNREACHED
    where not reachable within the depth budget."""
    propagate = _make_scatter_propagate(src, dst, padded_nodes, edge_chunk)
    return _run_distances(propagate, start, depth, padded_nodes, max_steps)


def batched_distances_dense(adj, start, depth, *, max_steps) -> torch.Tensor:
    propagate = _make_dense_propagate(adj)
    return _run_distances(propagate, start, depth, adj.shape[0], max_steps)
