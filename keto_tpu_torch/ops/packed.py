"""Bitpacked frontier propagation: the packed check path and its kernel
(counterpart of ``keto_tpu/ops/packed.py``).

- The frontier is bitpacked ``F[N_pad, W] int32`` with ``W = B/32``:
  request b's membership of node n is bit ``b%32`` of ``F[n, b//32]``.
- Edges are sorted by destination. One propagation pass gives
  ``out[d] = OR of F[src[e]]`` over the edges with ``dst[e] == d``, zeros
  for rows with no in-edge: a segmented OR over a CSR keyed by destination.
- In the Python loop, the per-request target test rides the same pass as
  B **probe edges** ``(target_b -> N_pad + b)`` appended after the real
  edges (their dst ids are larger than every real node, so sortedness is
  preserved). After the pass, probe row b holds ``F[target_b]``; bit b of
  it is "request b reached its target". The native loop reads that bit of
  ``F[target_b]`` in place instead (below), with no probe edges or rows.

Kernel note. ``packed_propagate`` launches ``csrc/packed_propagate.cu``, the
hand-written Hopper replacement of the Pallas kernel
``keto_tpu/ops/packed.py::_propagate_kernel``: one warp per output row walks
the row's in-edges and ORs 16-byte vector loads of the source rows in
registers. ``packed_propagate_plain`` is the same function in PyTorch: the
wrapper uses it only for CPU tensors; for CUDA tensors it launches the
kernel or raises.

The check loop gives the JAX loop's answers, including its one structural
twist: probe edges read the frontier BEFORE the pass's propagation, so the
probe lags one iteration, and the loop runs depth+1 probe iterations with
hit condition ``1 <= i <= depth[b]``. Unknown start/target nodes are
handled by the engine forcing depth 0 (the dummy row would otherwise let an
unknown start "reach" an unknown target).

Where the JAX loop keeps the accumulated set ``A_i = R_1 | ... | R_i``
(``R_i``: the nodes reached by walks of exactly i edges; it replaces the
frontier with the pass's output after iteration 0, then ORs each output
in), the port keeps the last pass's output, ``R_i``, so nothing touches
the frontier between passes. ``hit`` is still equal at every iteration:
the probe at iteration i reads ``R_i[target]`` for ``A_i[target]``, and any
``j <= i`` with ``target`` in ``R_j`` set ``hit`` at iteration j, inside
the same gate; so ``done``, the early stop and the passes are equal too.
The start bit is never in the frontier after iteration 0, so a
start==target request needs a real cycle in both.

Two loops give these answers, chosen by what the input shows, with no
knob. CUDA tensors with the default pass take the **native loop**: one
call into the kernel library (``packed_check_loop`` in
``csrc/packed_propagate.cu``, loaded through ctypes like B2, so the
interpreter is released for the whole loop and no Python runs between
passes). Per step it launches one probe kernel (the target test, ``hit``
and the count of rows not done, read in place from the frontier before
the pass), B2, and below ``max_steps`` one wait for the count. The whole
call is one sync site, ``packed.loop``. CPU tensors, or an explicit
``propagate=`` hook, take the **Python loop** below, which the CPU tests
hold against the JAX loop. ``DEVSTATS.record_packed_loop`` counts the
loops and passes of each (``keto_packed_loops_total{path}``,
``keto_packed_passes_total{path}``, path ``native`` or ``python``).

The Python loop's host<->device synchronisations each run inside
``DEVSTATS.wait`` (``telemetry/devstats.py``): the row-pointer tail's
upload when the engine passes its cached ``row_ptr`` (``packed.row_ptr``),
``_bits``'s upload in ``_build_f0`` and in every step's ``_probe_hits``
(``packed.bits``), and the ``done.all()`` read of every loop test that
gets that far (``packed.done``). A batch that runs ``k`` steps makes
``1 + (1 + k) + (k + 1)`` of them, one ``done`` read fewer when the loop
ends on ``max_steps``: 14 when max-depth 5 runs all 6 steps. The native
loop makes one, ``packed.loop``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..telemetry.devstats import DEVSTATS
from ..utils import kernels

KERNEL = "packed_propagate"
# the JAX kernel streams edges in 1024-id chunks: the edge list is padded to
# that multiple in both packages so they encode the same shapes
_CHUNK = 1024
# B multiple of 4096: W = B/32 int32 lanes fill 128-lane tiles
PACKED_BATCH_MULTIPLE = 4096


def _bits(device) -> torch.Tensor:
    """int32[32]: word value of each bit; bit 31 is -2^31 in int32."""
    bits = (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
    with DEVSTATS.wait("packed.bits"):
        return torch.from_numpy(bits).to(device)


def csr_row_ptr(dst_sorted: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int64[n_rows + 1]: row d's in-edges are [ptr[d], ptr[d+1]) of the
    dst-sorted edge list."""
    rows = torch.arange(n_rows + 1, dtype=dst_sorted.dtype, device=dst_sorted.device)
    return torch.searchsorted(dst_sorted, rows)


def packed_propagate_plain(
    f, src_sorted, dst_sorted, n_out: int, *, row_ptr=None
) -> torch.Tensor:
    """One propagation pass in PyTorch, in bounded memory.

    Pass k ORs the k-th in-edge of every row that has one into that row, so
    no row repeats within a pass; rows are visited in decreasing degree
    order, so the rows of pass k are a prefix. Temporaries are at most
    [rows with an in-edge, W]; nothing unpacks the bits.
    """
    if row_ptr is None:
        row_ptr = csr_row_ptr(dst_sorted, n_out)
    w = f.shape[1]
    out = torch.zeros((n_out, w), dtype=torch.int32, device=f.device)
    deg = row_ptr[1:] - row_ptr[:-1]
    order = torch.argsort(deg, descending=True, stable=True)
    first = row_ptr[:-1][order]
    # rows_with_more[k] = number of rows with more than k in-edges
    hist = torch.bincount(deg)
    rows_with_more = (n_out - torch.cumsum(hist, 0)).tolist()
    src = src_sorted.long()
    for k, n_k in enumerate(rows_with_more):
        if n_k == 0:
            break
        rows = order[:n_k]
        vals = f.index_select(0, src[first[:n_k] + k])
        out.index_copy_(0, rows, out.index_select(0, rows) | vals)
    return out


def _check_operands(f, src_sorted, dst_sorted, n_out: int, row_ptr) -> None:
    if f.dtype != torch.int32 or f.dim() != 2 or not f.is_contiguous():
        raise TypeError("f must be a contiguous int32 [N_pad, W] tensor")
    for name, t in (("src_sorted", src_sorted), ("dst_sorted", dst_sorted)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 vector")
        if t.device != f.device:
            raise ValueError("operands must share one device")
    if src_sorted.shape != dst_sorted.shape:
        raise ValueError("src_sorted and dst_sorted differ in length")
    if row_ptr is not None and (
        row_ptr.dtype != torch.int64
        or tuple(row_ptr.shape) != (n_out + 1,)
        or not row_ptr.is_contiguous()
        or row_ptr.device != f.device
    ):
        raise ValueError(f"row_ptr must be a contiguous int64[{n_out + 1}]")


def packed_propagate(
    f, src_sorted, dst_sorted, n_out: int, *, row_ptr=None
) -> torch.Tensor:
    """One expansion step over bitpacked frontiers: int32[n_out, W].

    f: int32[N_pad, W]; src/dst: int32[M] sorted by dst, every src in
    [0, N_pad) and every dst in [0, n_out). `row_ptr` (int64[n_out + 1],
    from ``csr_row_ptr``) is derived from `dst_sorted` when not given. CPU
    tensors take the plain version. CUDA tensors launch the kernel (W a
    multiple of 4); anything the kernel does not take raises.
    """
    _check_operands(f, src_sorted, dst_sorted, n_out, row_ptr)
    if f.device.type == "cpu":
        return packed_propagate_plain(
            f, src_sorted, dst_sorted, n_out, row_ptr=row_ptr
        )
    if f.device.type != "cuda":
        raise ValueError(
            f"packed_propagate runs on CPU or CUDA tensors, not {f.device}"
        )
    w = f.shape[1]
    if w % 4 or f.data_ptr() % 16:
        raise ValueError(f"W={w} must be a multiple of 4 and f 16-byte aligned")
    if row_ptr is None:
        row_ptr = csr_row_ptr(dst_sorted, n_out)
    fn = _kernel_fn()
    out = torch.empty((n_out, w), dtype=torch.int32, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            f.data_ptr(), src_sorted.data_ptr(), row_ptr.data_ptr(),
            out.data_ptr(), n_out, w, stream,
        )
    if err != 0:
        raise kernels.launch_error("packed_propagate", err)
    packed_propagate.launches += 1
    return out


# kernel launches since the last reset: read by the smoke run to prove the
# main path went through the kernel
packed_propagate.launches = 0


def _kernel_fn():
    lib = kernels.load(KERNEL)
    fn = lib.packed_propagate
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _loop_fn():
    lib = kernels.load(KERNEL)
    fn = lib.packed_check_loop
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [
            p, p, p, p, ctypes.c_int64, ctypes.c_int, p, p, p, p, p, p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _native_check(
    src_sorted, dst_sorted, start, target, depth, padded_nodes, max_steps, row_ptr
) -> torch.Tensor:
    """The packed check as one ``packed_check_loop`` call on CUDA tensors:
    the same ``hit`` and the same passes as the Python loop. Buffers come
    from the caching allocator, so HBM admission sees them: two frontier
    buffers [padded_nodes, W], ``hit``, a count a step and one pinned int."""
    bsz = start.shape[0]
    w = bsz // 32
    dev = start.device
    for name, t in (("start", start), ("target", target), ("depth", depth)):
        if t.dtype != torch.int32 or tuple(t.shape) != (bsz,) or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32[{bsz}]")
        if t.device != dev:
            raise ValueError("operands must share one device")
    if row_ptr is None:
        row_ptr = csr_row_ptr(dst_sorted, padded_nodes)
    fa = torch.empty((padded_nodes, w), dtype=torch.int32, device=dev)
    _check_operands(fa, src_sorted, dst_sorted, padded_nodes, row_ptr)
    fb = torch.empty_like(fa)
    hit = torch.empty(bsz, dtype=torch.bool, device=dev)
    open_rows = torch.empty(max_steps + 1, dtype=torch.int32, device=dev)
    host_open = torch.empty(1, dtype=torch.int32, pin_memory=True)
    passes = ctypes.c_int(0)
    fn = _loop_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        with DEVSTATS.wait("packed.loop"):
            err = fn(
                fa.data_ptr(), fb.data_ptr(), src_sorted.data_ptr(),
                row_ptr.data_ptr(), padded_nodes, w, start.data_ptr(),
                target.data_ptr(), depth.data_ptr(), hit.data_ptr(),
                open_rows.data_ptr(), host_open.data_ptr(), max_steps,
                ctypes.byref(passes), stream,
            )
    if err != 0:
        raise kernels.launch_error("packed_check_loop", err)
    packed_propagate.launches += passes.value
    DEVSTATS.record_packed_loop("native", passes.value)
    return hit


def _build_f0(start, padded_nodes: int, w: int) -> torch.Tensor:
    """Initial frontier: bit b set at row start[b], as one scatter.

    The JAX version broadcasts an iota of [N_pad, W, 32] that XLA fuses
    away; in eager torch that would be allocated. Each request owns a
    distinct (word, bit), so the accumulated sum of the bit values equals
    their OR: no two addends share a bit, so no carry ever occurs, and in
    two's complement adding bit 31 (-2^31) to lower bits cannot overflow.
    """
    bsz = start.shape[0]
    b = torch.arange(bsz, device=start.device)
    idx = start.long() * w + b // 32
    f = torch.zeros(padded_nodes * w, dtype=torch.int32, device=start.device)
    f.index_put_((idx,), _bits(start.device)[b % 32], accumulate=True)
    return f.view(padded_nodes, w)


def _probe_hits(probe, w: int) -> torch.Tensor:
    """probe: int32[B, W] (row b = frontier row of target_b). Returns
    bool[B] = bit b of probe[b, b//32]."""
    bsz = probe.shape[0]
    b = torch.arange(bsz, device=probe.device)
    word = probe[b, b // 32]
    return (word & _bits(probe.device)[b % 32]) != 0


def packed_batched_check(
    src_sorted,
    dst_sorted,
    start,
    target,
    depth,
    *,
    padded_nodes: int,
    max_steps: int,
    row_ptr: Optional[torch.Tensor] = None,
    propagate=None,
) -> torch.Tensor:
    """allowed: bool[B]. B must be a multiple of 4096. src/dst: real edges
    sorted by dst (int32, all dst < padded_nodes); start/target/depth:
    int32[B], every node in [0, padded_nodes). The Python loop appends the
    probe edges and padding edges (dummy -> n_out-1, up to the 1024-edge
    multiple) here. `row_ptr` (int64[padded_nodes + 1]) is the CSR of the
    real edges, cached per snapshot by the engine; it is derived when not
    given. `propagate` is the pass: None means the kernel, which on CUDA
    tensors runs the native loop (module docstring); a function given here
    (``packed_propagate`` or ``packed_propagate_plain``, to hold one loop
    or pass against another) runs in the Python loop.

    Memory: the frontier of pass i + 1 is pass i's output itself (a
    contiguous prefix view, walks of exactly i + 1 edges, not the
    accumulated set of the JAX loop's ``jnp.where(i == 0, p, f | p)``), so
    the loop holds the frontier, one pass's output and the pass's
    temporaries: two frontier-sized buffers, with no copy or OR between
    passes. f0 is built over the output's n_out rows, so every one of
    those buffers has one size and a freed one serves the next pass.
    """
    bsz = start.shape[0]
    if bsz % PACKED_BATCH_MULTIPLE:
        raise ValueError(f"B={bsz} must be a multiple of {PACKED_BATCH_MULTIPLE}")
    if propagate is None:
        if start.device.type == "cuda":
            return _native_check(
                src_sorted, dst_sorted, start, target, depth,
                padded_nodes, max_steps, row_ptr,
            )
        propagate = packed_propagate
    w = bsz // 32
    n_out = padded_nodes + bsz
    dev = start.device
    n_real = src_sorted.shape[0]

    probe_dst = padded_nodes + torch.arange(bsz, dtype=torch.int32, device=dev)
    pad = (-(n_real + bsz)) % _CHUNK
    src_all = torch.cat([
        src_sorted, target,
        torch.full((pad,), padded_nodes - 1, dtype=torch.int32, device=dev),
    ])
    dst_all = torch.cat([
        dst_sorted, probe_dst,
        torch.full((pad,), n_out - 1, dtype=torch.int32, device=dev),
    ])
    if row_ptr is None:
        rp = csr_row_ptr(dst_all, n_out)
    else:
        # probe row b holds edge n_real + b; the last probe row also holds
        # the padding edges
        probes = n_real + torch.arange(1, bsz, dtype=torch.int64, device=dev)
        with DEVSTATS.wait("packed.row_ptr"):
            tail = torch.tensor([n_real + bsz + pad], dtype=torch.int64, device=dev)
        rp = torch.cat([row_ptr, probes, tail])

    f = _build_f0(start, n_out, w)[:padded_nodes]
    hit = torch.zeros(bsz, dtype=torch.bool, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    # The JAX loop's condition, read once per step. Stopping early is exact:
    # a done request is either hit (hit stays set) or past its depth
    # (i >= depth[b], so the gate 1 <= i <= depth[b] is closed for good).
    i = 0
    while i <= max_steps and not DEVSTATS.all_done(done, "packed.done"):
        p_full = propagate(f, src_all, dst_all, n_out, row_ptr=rp)
        # probe row b = f[target_b] BEFORE this pass: at iteration i >= 1
        # that is "a walk of exactly i edges reaches target"
        reached = _probe_hits(p_full[padded_nodes:], w)
        hit |= reached & (i >= 1) & (i <= depth)
        # the next frontier is this pass's output (at i == 0 that drops the
        # start bit); rebinding f frees the previous one before the next
        # pass allocates
        f = p_full[:padded_nodes]
        del p_full
        done = hit | (i >= depth)
        i += 1
    DEVSTATS.record_packed_loop("python", i)
    return hit
