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

}  // namespace

extern "C" int packed_propagate(const void* f, const void* src,
                                const void* row_ptr, void* out, int64_t n_out,
                                int w, void* stream) {
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
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(f), static_cast<const int32_t*>(src),
      static_cast<const int64_t*>(row_ptr), static_cast<int4*>(out), n_out,
      chunks, lanes);
  return static_cast<int>(cudaGetLastError());
}
