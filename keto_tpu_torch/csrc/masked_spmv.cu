// One wave of the boolean-semiring BFS that builds the closure matrix D.
//
// Replaces the Pallas kernel keto_tpu/engine/pallas_spmv.py::_spmv_kernel
// (launched by _masked_step_pallas). For a frontier F [G, M], the interior
// adjacency A [M, M] and the reached mask R [G, M], all bf16 0/1:
//
//     nxt      = (F x A) > 0.5          (f32 accumulation)
//     newly    = nxt * (1 - R)
//     reached' = max(R, nxt)
//
// The result is exact under any summation order: the inputs are 0/1, and
// counts up to the 16896-row interior limit are exact in f32, so "> 0.5"
// is an exact boolean OR.
//
// Bound: at G = 256 each wave reads all of A (M^2 bf16 bytes: 265 MB at
// M = 11520) for 2*G*M^2 operations, about 256 operations per byte, just
// under the H100's bf16 ridge of ~295 operations per byte, so a wave is
// bound by the adjacency bytes (about 79 us at 3.35 TB/s at M = 11520).
// What this design does about it: a block owns a 128 x 128 output tile and
// walks K in 32-deep shared-memory tiles, double-buffered with cp.async,
// so each A tile is read from device memory once per 128 frontier rows
// (G / 128 = 2 reads of A per wave); the products run on the tensor cores
// through WMMA bf16 16x16x16 fragments with f32 accumulators, and the
// threshold and R-mask are fused into the epilogue, so neither nxt nor the
// f32 product ever reaches device memory. wgmma/TMA, a bitset popc
// redesign and all-rows-per-wave scheduling are left for later work.
//
// Contract (checked by the Python wrapper in engine/masked_spmv.py): G a
// multiple of 128, M a multiple of 128, every pointer 16-byte aligned and
// row-major contiguous. Launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // frontier rows per block
constexpr int BN = 128;       // adjacency columns per block
constexpr int BK = 32;        // K depth of one shared-memory tile
constexpr int LDA = BK + 8;   // padded row pitch (bf16) of the F tile
constexpr int LDB = BN + 8;   // padded row pitch (bf16) of the A tile
constexpr int THREADS = 256;  // 8 warps in a 2 x 4 grid
constexpr int WM = 64;        // rows per warp
constexpr int WN = 32;        // columns per warp
constexpr int FM = WM / 16;   // 16x16 fragments per warp, vertically
constexpr int FN = WN / 16;   // ... and horizontally

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
    masked_spmv_kernel(const __nv_bfloat16* __restrict__ F,
                       const __nv_bfloat16* __restrict__ A,
                       const __nv_bfloat16* __restrict__ R,
                       __nv_bfloat16* __restrict__ newly,
                       __nv_bfloat16* __restrict__ reached, int m) {
  __shared__ __align__(128) __nv_bfloat16 sA[2][BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 sB[2][BK * LDB];
  __shared__ __align__(128) float sC[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * BM;  // first frontier row of the tile
  const int col0 = blockIdx.x * BN;  // first adjacency column of the tile
  const int wr = (warp / 4) * WM;    // warp's row offset inside the tile
  const int wc = (warp % 4) * WN;    // warp's column offset inside the tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_tile = [&](int stage, int k0) {
    // F tile: BM rows x BK columns, 16-byte chunks of 8 bf16
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8);
      const int q = c % (BK / 8);
      cp_async16(&sA[stage][r * LDA + q * 8],
                 F + static_cast<size_t>(row0 + r) * m + k0 + q * 8);
    }
    // A tile: BK rows x BN columns
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8);
      const int q = c % (BN / 8);
      cp_async16(&sB[stage][r * LDB + q * 8],
                 A + static_cast<size_t>(k0 + r) * m + col0 + q * 8);
    }
    cp_async_commit();
  };

  const int nk = m / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      // the other stage was released by the barrier ending iteration kt-1
      load_tile(cur ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &sA[cur][(wr + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &sB[cur][kk * LDB + wc + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with stage `cur`
  }

  // Epilogue, one 16x16 fragment at a time through a per-warp scratch tile:
  // lane l owns row l/2, columns (l%2)*8 .. +8 of the fragment, so R, newly
  // and reached move as one 16-byte access each.
  float* scratch = sC[warp];
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const size_t off =
          static_cast<size_t>(row0 + wr + i * 16 + er) * m + col0 + wc +
          j * 16 + ec;
      const uint4 rv = *reinterpret_cast<const uint4*>(R + off);
      const __nv_bfloat16* rr = reinterpret_cast<const __nv_bfloat16*>(&rv);
      uint4 nv;
      uint4 sv;
      __nv_bfloat16* nn = reinterpret_cast<__nv_bfloat16*>(&nv);
      __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(&sv);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const bool nxt = scratch[er * 16 + ec + t] > 0.5f;
        const float r = __bfloat162float(rr[t]);
        nn[t] = __float2bfloat16(nxt ? 1.0f - r : 0.0f);
        ss[t] = __float2bfloat16(nxt ? fmaxf(r, 1.0f) : fmaxf(r, 0.0f));
      }
      *reinterpret_cast<uint4*>(newly + off) = nv;
      *reinterpret_cast<uint4*>(reached + off) = sv;
      __syncwarp();  // scratch is rewritten by the next fragment
    }
  }
}

}  // namespace

extern "C" int masked_spmv_step(const void* f, const void* a, const void* r,
                                void* newly, void* reached, int g, int m,
                                void* stream) {
  if (g <= 0 || m <= 0 || g % BM != 0 || m % BN != 0 || m % BK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(m / BN, g / BM);
  masked_spmv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(newly), static_cast<__nv_bfloat16*>(reached),
      m);
  return static_cast<int>(cudaGetLastError());
}
