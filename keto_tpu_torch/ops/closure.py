"""Bounded all-pairs-distance closure over the interior graph (counterpart of
``keto_tpu/ops/closure.py``).

The interior subgraph (``graph/interior.py``) is small enough to hold as a
dense adjacency, so depth-bounded all-pairs distances are computed once per
snapshot:

    reach_{<=k} = reach_{<=k-1}  OR  (reach_{<=k-1} @ A)
    D[i, j]     = first k at which j becomes reachable from i   (uint8)

After that a whole Check batch costs only gathers:

    allowed(b) = direct(b)  OR  min_{s in F0(b), s' in L(b)} D[s, s']
                 + 1 + extra(b)  <=  depth(b)

The adjacency ships bitpacked (``np.packbits`` rows, MSB first) and is
expanded on the device. ``build_closure_packed`` is the plain matmul ladder,
kept as the oracle for the masked-SpMV builder
(``engine/masked_spmv.py``), which is what the engine runs. D's padding
rows/columns stay at INF (255) so a padded index never allows anything.
"""

from __future__ import annotations

import numpy as np
import torch

INF_DIST = 255  # uint8 sentinel: not reachable within the depth bound

# np.packbits bit order: bit 7 of byte j is column 8j
_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def pack_adjacency(ii_src, ii_dst, m_pad: int) -> np.ndarray:
    """Host-side: COO interior edges -> bitpacked rows uint8[m_pad, m_pad/8].

    m_pad must be a multiple of 8 (the engine buckets to 256).
    """
    adj = np.zeros((m_pad, m_pad), dtype=np.uint8)
    if len(ii_src):
        adj[ii_src, ii_dst] = 1
    return np.packbits(adj, axis=1)


def unpack_adjacency(packed, m_pad: int, device) -> torch.Tensor:
    """Bitpacked rows -> dense 0/1 bf16 [m_pad, m_pad] on `device`."""
    p = torch.as_tensor(packed, device=device)
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=device)
    bits = (p.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(m_pad, m_pad).to(torch.bfloat16)


def set_diagonal_(d: torch.Tensor, m: int) -> torch.Tensor:
    """In place: live diagonal 0 (s == s' costs no interior steps), padding
    diagonal INF so the PAD index stays inert in queries."""
    diag = d.diagonal()
    diag.fill_(INF_DIST)
    diag[:m] = 0
    return d


def build_closure_packed(packed, m: int, *, m_pad: int, k_max: int, device):
    """D: uint8[m_pad, m_pad] bounded shortest-path matrix (plain version).

    packed: uint8[m_pad, m_pad/8] bitpacked adjacency rows (pack_adjacency);
    m: live interior count; k_max: longest path length to resolve (global
    max-depth - 1). The product runs in float32: inputs are 0/1 and counts
    up to m_pad are exact, so ``> 0.5`` is an exact boolean OR.
    """
    adj = unpack_adjacency(packed, m_pad, device).float()
    reach = adj > 0.5
    d = torch.where(
        reach,
        torch.tensor(1, dtype=torch.uint8, device=device),
        torch.tensor(INF_DIST, dtype=torch.uint8, device=device),
    )
    for k in range(2, k_max + 1):
        nxt = (reach.float() @ adj) > 0.5
        d.masked_fill_(nxt & ~reach, k)  # in place: D is the largest buffer
        reach |= nxt
    return set_diagonal_(d, m)


def closure_insert_edge(d: torch.Tensor, u: int, v: int, k_max: int):
    """Exact incremental update of a bounded closure for one inserted
    interior edge u -> v: D'[i,j] = min(D[i,j], D[i,u] + 1 + D[v,j]),
    exact because a shortest path uses the new edge at most once.
    Distances beyond k_max clamp to INF_DIST. The sum is taken in int32:
    uint8 would wrap (254 + 1 + 254). Returns a new tensor; `d` is not
    modified, so a previous snapshot's artifacts stay valid."""
    col = d[:, u].to(torch.int32)
    row = d[v, :].to(torch.int32)
    cand = col[:, None] + 1 + row[None, :]
    cand = torch.where(cand > k_max, INF_DIST, cand)
    return torch.minimum(d, cand.to(torch.uint8))


def closure_insert_edge_host(d: np.ndarray, u: int, v: int, k_max: int):
    """Numpy twin of closure_insert_edge for host query mode, in place.

    Restricted to the rows that reach u and the columns reachable from v:
    everything else gets a candidate above k_max and cannot improve, so the
    relax touches |reach(u)| x |reach(v)| entries, not M^2. Each store is a
    per-entry monotone uint8 write, so a concurrent reader sees every entry
    either before or after the edge."""
    du = d[:, u].astype(np.int16)
    dv = d[v, :].astype(np.int16)
    # du + 1 + dv <= k_max needs both legs <= k_max - 1
    rows = np.nonzero(du <= k_max - 1)[0]
    if rows.size == 0:
        return d
    cols = np.nonzero(dv <= k_max - 1)[0]
    if cols.size == 0:
        return d
    cand = du[rows][:, None] + np.int16(1) + dv[cols][None, :]
    cand = np.where(cand > k_max, np.int16(INF_DIST), cand).astype(np.uint8)
    ix = np.ix_(rows, cols)
    d[ix] = np.minimum(d[ix], cand)
    return d


def closure_query(d, f0, l, extra, depth, direct) -> torch.Tensor:
    """allowed: bool[B].

    d: uint8[m_pad, m_pad] closure; f0: int[B, F0] interior successor rows
    (PAD-filled); l: int[B, L] interior in-neighbor rows (PAD-filled);
    extra: int32[B] (1 for id targets); depth: int32[B]; direct: bool[B].
    All on d's device.
    """
    sub = d[f0[:, :, None].long(), l[:, None, :].long()]  # uint8[B, F0, L]
    best = sub.flatten(1).amin(dim=1).to(torch.int32)
    # INF must never satisfy a depth budget (valid distances are <= 254)
    best = torch.where(best >= INF_DIST, 1 << 30, best)
    total = 1 + best + extra
    return (direct & (depth >= 1)) | (total <= depth)
