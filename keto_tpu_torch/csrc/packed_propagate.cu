// One OR-semiring propagation pass over bitpacked frontiers.
//
// Replaces the Pallas kernel keto_tpu/ops/packed.py::_propagate_kernel
// (launched by packed_propagate). The frontier F is int32 [N_pad, W]: bit
// b%32 of word b/32 of row n says whether request b has reached node n.
// For edges sorted by destination, given as a CSR over the n_out output
// rows (row d's in-edges are [row_ptr[d], row_ptr[d+1]) of src):
//
//     out[d] = OR of F[src[e]] over d's in-edges,   zeros for no in-edge
//
// The result is exact under any order: OR is associative and commutative.
//
// Bound: the pass must read every distinct source row once, write every
// output row once and read the edge ids, so
//     bytes = distinct_src * W * 4 + n_out * W * 4 + M * 8
// over 3.35 TB/s. It does about one OR per 4 bytes, so it is bound by
// bytes, not operations. At github10m (n_out = 2^23 + 4096, W = 128) the
// output write alone is 4.3 GB, about 1.3 ms.
// What this design does about it: a group of up to 32 lanes owns one output
// row (a full warp when W >= 128); lane l loads words 4l..4l+3 of each
// source row as one 16-byte vector load, so a warp moves a 512-byte row per
// instruction, neighbouring lanes on neighbouring words. The group walks
// the row's in-edges four at a time (four independent row loads in flight
// per lane), ORs in registers and stores the row once; rows with no
// in-edge store zeros, so there is no separate memset pass. Source rows
// shared by many destinations (a team read by each of its members) are
// served from L2. Skewed in-degree needs nothing special: a row's edges are
// walked by its own group, and no buffer is sized by the degree. Row
// offsets are 64-bit: row * W * 4 reaches 2^32 bytes at N_pad = 2^23,
// W = 128. TMA row gathers and L2-aware source ordering are left for later
// work. The caller passes each pass's output back as the next frontier, so
// there is no f | p update between passes to fuse.
//
// Contract (checked by the Python wrapper in ops/packed.py): W a multiple
// of 4, f 16-byte aligned and row-major contiguous, every src in [0, N_pad),
// row_ptr nondecreasing with row_ptr[n_out] = M. Launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// packed_check_loop runs the whole packed check of ops/packed.py
// (packed_batched_check on CUDA tensors) in one call, so the interpreter is
// released once for the loop and no Python runs between passes. It replaces
// no TPU kernel: the JAX loop is one jitted while_loop, and this is its
// counterpart. On the caller's stream it zeroes frontier buffer A, sets each
// request's start bit (packed_seed_kernel), then for i = 0 .. max_steps:
//
//   packed_probe_kernel on A: request b's target row, bit b of it, read
//     BEFORE the pass; hit[b] |= reached && 1 <= i <= depth[b]; the rows
//     not done (!hit[b] && i < depth[b]) are counted into not_done[i];
//   below max_steps, not_done[i] is copied to pinned host memory and an
//     event recorded;
//   B2 from A into B over the real edges' CSR (n_out = N_pad);
//   below max_steps, the host waits for the event (the probe, not the pass
//     just queued behind it, so the card stays busy) and stops once no row
//     is open;
//   A and B swap.
//
// Reading the target row in place stands in for the probe edges that the
// Python loop appends (target_b -> N_pad + b): probe row b after a pass is
// F_before[target_b], the word this kernel reads, so the answers and the
// passes are the Python loop's. The probe and the seed each touch one word
// per request, a few KB against B2's gigabytes. The pass count is written
// to *passes; the function returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // in-edges in flight per lane

__device__ __forceinline__ int4 or4(int4 a, int4 b) {
  return make_int4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// `lanes` lanes (a power of two dividing 32) per output row; each lane
// walks the row's 16-byte chunks lane, lane + lanes, ...
__global__ void __launch_bounds__(THREADS)
    packed_propagate_kernel(const int4* __restrict__ f,
                            const int32_t* __restrict__ src,
                            const int64_t* __restrict__ row_ptr,
                            int4* __restrict__ out, int64_t n_out,
                            int chunks, int lanes) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t row = tid / lanes;
  const int lane = static_cast<int>(tid % lanes);
  if (row >= n_out) return;
  const int64_t beg = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  int4* orow = out + row * chunks;
  for (int c = lane; c < chunks; c += lanes) {
    int4 acc = make_int4(0, 0, 0, 0);
    int64_t e = beg;
    for (; e + UNROLL <= end; e += UNROLL) {
      int32_t s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s[u] = __ldg(src + e + u);
      int4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = __ldg(f + static_cast<int64_t>(s[u]) * chunks + c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = or4(acc, v[u]);
    }
    for (; e < end; ++e) {
      const int32_t s = __ldg(src + e);
      acc = or4(acc, __ldg(f + static_cast<int64_t>(s) * chunks + c));
    }
    orow[c] = acc;
  }
}

// Sets bit b%32 of word b/32 of row start[b] in the zeroed frontier and
// clears hit[b]. Requests share rows and words, hence the atomic OR.
__global__ void __launch_bounds__(THREADS)
    packed_seed_kernel(uint32_t* __restrict__ f,
                       const int32_t* __restrict__ start,
                       uint8_t* __restrict__ hit, int64_t batch, int w) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= batch) return;
  atomicOr(f + static_cast<int64_t>(start[b]) * w + (b >> 5),
           1u << (b & 31));
  hit[b] = 0;
}

// Step `step` of the loop's target test and done test; counts the rows
// still open into *open_rows, one atomic per warp. Every lane reaches the
// ballot, so the block size is a multiple of 32 and nothing returns early.
__global__ void __launch_bounds__(THREADS)
    packed_probe_kernel(const uint32_t* __restrict__ f,
                        const int32_t* __restrict__ target,
                        const int32_t* __restrict__ depth,
                        uint8_t* __restrict__ hit, int* __restrict__ open_rows,
                        int64_t batch, int w, int step) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  bool open = false;
  if (b < batch) {
    const uint32_t word = f[static_cast<int64_t>(target[b]) * w + (b >> 5)];
    const int d = depth[b];
    bool h = hit[b] != 0;
    if (((word >> (b & 31)) & 1u) && step >= 1 && step <= d) {
      h = true;
      hit[b] = 1;
    }
    open = !h && step < d;
  }
  const unsigned votes = __ballot_sync(0xffffffffu, open);
  if ((threadIdx.x & 31) == 0 && votes != 0) atomicAdd(open_rows, __popc(votes));
}

int launch_propagate(const void* f, const void* src, const void* row_ptr,
                     void* out, int64_t n_out, int w, cudaStream_t stream) {
  if (n_out < 0 || w <= 0 || w % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  const int chunks = w / 4;  // 16-byte chunks per row
  int lanes = 32;
  while (lanes > chunks) lanes /= 2;
  const int64_t threads = n_out * lanes;
  const int64_t blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  packed_propagate_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                            stream>>>(
      static_cast<const int4*>(f), static_cast<const int32_t*>(src),
      static_cast<const int64_t*>(row_ptr), static_cast<int4*>(out), n_out,
      chunks, lanes);
  return static_cast<int>(cudaGetLastError());
}

#define RETURN_IF_ERROR(call)                               \
  do {                                                      \
    const cudaError_t err_ = (call);                        \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

int run_loop(int32_t* a, int32_t* b, const void* src, const void* row_ptr,
             int64_t n_rows, int w, const int32_t* start,
             const int32_t* target, const int32_t* depth, uint8_t* hit,
             int* open_rows, volatile int* host_open, int max_steps,
             int* passes, cudaStream_t stream, cudaEvent_t probed) {
  const int64_t batch = static_cast<int64_t>(w) * 32;
  const unsigned blocks = static_cast<unsigned>((batch + THREADS - 1) / THREADS);
  RETURN_IF_ERROR(cudaMemsetAsync(a, 0, n_rows * w * sizeof(int32_t), stream));
  RETURN_IF_ERROR(cudaMemsetAsync(
      open_rows, 0, (static_cast<size_t>(max_steps) + 1) * sizeof(int), stream));
  packed_seed_kernel<<<blocks, THREADS, 0, stream>>>(
      reinterpret_cast<uint32_t*>(a), start, hit, batch, w);
  RETURN_IF_ERROR(cudaGetLastError());
  for (int i = 0; i <= max_steps; ++i) {
    const bool test = i < max_steps;  // the loop ends on max_steps anyway
    packed_probe_kernel<<<blocks, THREADS, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(a), target, depth, hit,
        open_rows + i, batch, w, i);
    RETURN_IF_ERROR(cudaGetLastError());
    if (test) {
      RETURN_IF_ERROR(cudaMemcpyAsync(const_cast<int*>(host_open), open_rows + i,
                                      sizeof(int), cudaMemcpyDeviceToHost,
                                      stream));
      RETURN_IF_ERROR(cudaEventRecord(probed, stream));
    }
    const int err = launch_propagate(a, src, row_ptr, b, n_rows, w, stream);
    if (err != 0) return err;
    ++*passes;
    if (test) {
      RETURN_IF_ERROR(cudaEventSynchronize(probed));
      if (*host_open == 0) break;
    }
    int32_t* t = a;
    a = b;
    b = t;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" int packed_propagate(const void* f, const void* src,
                                const void* row_ptr, void* out, int64_t n_out,
                                int w, void* stream) {
  return launch_propagate(f, src, row_ptr, out, n_out, w,
                          static_cast<cudaStream_t>(stream));
}

// The packed check loop (see the header). fa, fb: int32 [n_rows, w]
// frontier buffers, 16-byte aligned; start, target, depth: int32 [32 w];
// hit: bool [32 w], written; open_rows: int32 [max_steps + 1] of scratch;
// host_open: one pinned int32. Every start and target in [0, n_rows).
extern "C" int packed_check_loop(void* fa, void* fb, const void* src,
                                 const void* row_ptr, int64_t n_rows, int w,
                                 const void* start, const void* target,
                                 const void* depth, void* hit, void* open_rows,
                                 void* host_open, int max_steps, int* passes,
                                 void* stream) {
  *passes = 0;
  if (n_rows <= 0 || w <= 0 || w % 4 != 0 || max_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaEvent_t probed;
  RETURN_IF_ERROR(cudaEventCreateWithFlags(&probed, cudaEventDisableTiming));
  const int err = run_loop(
      static_cast<int32_t*>(fa), static_cast<int32_t*>(fb), src, row_ptr,
      n_rows, w, static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(target), static_cast<const int32_t*>(depth),
      static_cast<uint8_t*>(hit), static_cast<int*>(open_rows),
      static_cast<volatile int*>(host_open), max_steps, passes,
      static_cast<cudaStream_t>(stream), probed);
  const cudaError_t destroyed = cudaEventDestroy(probed);
  return err != 0 ? err : static_cast<int>(destroyed);
}
