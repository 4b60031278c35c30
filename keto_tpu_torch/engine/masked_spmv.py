"""Masked-SpMV frontier expansion: the closure builder's kernel and driver
(counterpart of ``keto_tpu/engine/pallas_spmv.py``).

The closure build is a batched multi-source BFS whose per-wave step is

    newly   = (frontier x A  under OR-AND)  AND NOT  reached
    reached = reached OR newly

Masks live as bf16 0/1: the tensor cores take bf16 tiles, and counts up to
the widest closure (17 152 columns) are exact in the f32 accumulator, so
``> 0.5`` is an exact boolean OR.

Kernel note. ``masked_step`` launches ``csrc/masked_spmv.cu``, the
hand-written Hopper replacement of the Pallas kernel
``keto_tpu/engine/pallas_spmv.py::_spmv_kernel`` (``_masked_step_pallas``).
At the engine's 256-row groups one wave reads the whole adjacency (M^2
bf16 bytes) for 2*256*M^2 operations, so it is bound by the adjacency
bytes, with the tensor cores close behind. One CTA owns all G rows of a
96-column stripe, so A crosses device memory once per wave; F is shared
across a cluster by TMA multicast; wgmma runs from a TMA ring under
mbarriers, and the threshold and reached-mask run from the accumulator
registers, so no [G, M] intermediate touches device memory.
``launch_geometry`` picks the rows per CTA and the grid here in Python,
where the CPU tests can check them. ``masked_step_plain`` is the
same function in float32 PyTorch: the wrapper uses it only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

``build_closure_semiring`` drives the waves: D is byte-identical to
``ops.closure.build_closure_packed`` (uint8 distances clamped at k_max,
INF elsewhere, live diagonal 0, padding rows INF).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops.closure import INF_DIST, set_diagonal_, unpack_adjacency
from ..utils import kernels

KERNEL = "masked_spmv"
TILE = 128  # G and M must be multiples of it
# the kernel's compile-time tile: csrc/masked_spmv.cu BN and CLUSTER
STRIPE = 96  # adjacency columns per CTA
CLUSTER = 4  # CTAs along N that share each F tile by TMA multicast


class Geometry(NamedTuple):
    """One launch of the kernel: CTAs of `rows` frontier rows by STRIPE
    adjacency columns, `grid_x` column stripes (a whole number of clusters
    of CLUSTER; stripes past M do nothing) by `grid_y` row blocks."""

    rows: int
    grid_x: int
    grid_y: int


def launch_geometry(g: int, m: int) -> Geometry:
    """The kernel's launch for a [g, m] frontier: each CTA covers all 256
    rows of the group (128 when g is not a multiple of 256), so every
    adjacency tile is read once per 256 rows; the column stripes are padded
    to whole clusters."""
    if g % TILE or m % TILE:
        raise ValueError(f"G={g} and M={m} must be multiples of {TILE}")
    rows = 256 if g % 256 == 0 else 128
    stripes = -(-m // STRIPE)
    grid_x = -(-stripes // CLUSTER) * CLUSTER
    return Geometry(rows, grid_x, g // rows)


def masked_step_plain(frontier, adj, reached):
    """One masked SpMV step in float32 PyTorch: (newly, reached')."""
    nxt = ((frontier.float() @ adj.float()) > 0.5).to(torch.bfloat16)
    newly = nxt * (1 - reached)
    return newly, torch.maximum(reached, nxt)


def _check_operands(frontier, adj, reached) -> None:
    for name, t in (("frontier", frontier), ("adj", adj), ("reached", reached)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if t.device != frontier.device:
            raise ValueError("operands must share one device")
    g, m = frontier.shape
    if tuple(adj.shape) != (m, m) or tuple(reached.shape) != (g, m):
        raise ValueError(
            f"shape mismatch: frontier {tuple(frontier.shape)}, adj "
            f"{tuple(adj.shape)}, reached {tuple(reached.shape)}"
        )


def masked_step(frontier, adj, reached):
    """One masked SpMV step: (newly, reached'), both bf16 [G, M].

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (G and M multiples of 128); anything the kernel does not take raises.
    """
    _check_operands(frontier, adj, reached)
    if frontier.device.type == "cpu":
        return masked_step_plain(frontier, adj, reached)
    if frontier.device.type != "cuda":
        raise ValueError(
            f"masked_step runs on CPU or CUDA tensors, not {frontier.device}"
        )
    g, m = frontier.shape
    geom = launch_geometry(g, m)
    for t in (frontier, adj, reached):
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")
    fn = _kernel_fn()
    newly = torch.empty_like(frontier)
    reached_out = torch.empty_like(reached)
    with torch.cuda.device(frontier.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            frontier.data_ptr(), adj.data_ptr(), reached.data_ptr(),
            newly.data_ptr(), reached_out.data_ptr(), g, m,
            geom.rows, geom.grid_x, stream,
        )
    if err != 0:
        raise kernels.launch_error("masked_spmv", err)
    masked_step.launches += 1
    return newly, reached_out


# kernel launches since the last reset: read by the smoke run to prove the
# main path went through the kernel
masked_step.launches = 0


def _kernel_fn():
    lib = kernels.load(KERNEL)
    fn = lib.masked_spmv_step
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def build_closure_semiring(
    packed, m: int, *, m_pad: int, k_max: int, group: int = 256,
    device, step=masked_step,
) -> torch.Tensor:
    """D: uint8[m_pad, m_pad] on `device`, built group by group.

    packed: uint8[m_pad, m_pad/8] bitpacked adjacency (ops.closure.
    pack_adjacency, np.packbits order); m: live interior count; k_max: the
    longest path to resolve. Each group of `group` source rows starts from
    its adjacency rows (distance 1) and runs waves k = 2..k_max (none when
    k_max < 2). `step` is the wave function: the kernel wrapper by default,
    ``masked_step_plain`` to hold the kernel against its plain version.
    D is filled in place, one group of rows at a time, so the build holds
    one [m_pad, m_pad] uint8 buffer plus the bf16 adjacency.
    """
    device = torch.device(device)
    grp = group
    while m_pad % grp:
        grp //= 2  # m_pad is a multiple of 256 upstream; be safe anyway
    adj = unpack_adjacency(packed, m_pad, device)
    d = torch.empty((m_pad, m_pad), dtype=torch.uint8, device=device)
    for g0 in range(0, m_pad, grp):
        f0 = adj[g0 : g0 + grp]  # distance-1 frontier: the sources' rows
        dg = d[g0 : g0 + grp]
        dg.fill_(INF_DIST)
        dg.masked_fill_(f0 > 0, 1)
        frontier, reached = f0, f0
        for k in range(2, k_max + 1):
            frontier, reached = step(frontier, adj, reached)
            dg.masked_fill_(frontier > 0, k)
    return set_diagonal_(d, m)
