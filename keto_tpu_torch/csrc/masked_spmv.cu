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
// counts up to the largest closure width, _m_pad_for(16384) = 17152, are
// exact in f32, so "> 0.5" is an exact boolean OR.
//
// Bound: at the engine's G = 256 a wave reads all of A (M^2 bf16 bytes:
// 265 MB at M = 11520) for 2*G*M^2 operations, about 256 operations per
// byte, just under the H100's bf16 ridge of ~295, so a wave is bound by the
// adjacency bytes (86 us at 3.35 TB/s at M = 11520), with the tensor cores
// close behind (69 us at 989 TFLOP/s).
//
// What the design does about it:
// - One CTA owns all G rows (256, or 128 when G is not a multiple of 256) of
//   a BN = 96 column stripe, so every A tile crosses HBM once per wave; at
//   M = 11520 that is 120 CTAs, one wave on 132 SMs.
// - F, the small operand every CTA needs, is shared along N: CTAs form
//   clusters of CLUSTER = 4 and each loads a quarter of an F tile by TMA
//   multicast into all four, cutting F's L2-to-SM traffic fourfold and
//   keeping the cluster's four stripes of A in step.
// - A producer warpgroup (one thread issuing TMA, registers given back with
//   setmaxnreg) keeps a ring of STAGES BK = 64 stages in flight under full
//   and empty mbarriers; the empty barriers take one arrival per consumer
//   warpgroup of every CTA in the cluster, since a peer's multicast writes
//   into this CTA's ring. Those arrivals use the default (CTA-scope release)
//   semantics: an explicit .release.cluster arrival stalls the consumer long
//   enough to drain the ring.
// - Two consumer warpgroups of 64*MT rows each run wgmma m64n96k16 (bf16 in,
//   f32 accumulators in registers): F is the K-major operand in 128-byte
//   swizzle (an F row of one stage is one 128-byte atom), A the MN-major
//   (transposed) operand in 64-byte swizzle, three 32-column atoms per stage.
//   One wgmma group stays in flight while the next stage is waited for.
// - The threshold and the R-mask run straight from the accumulator
//   registers (wgmma's fragment layout gives each thread fixed (row, col)
//   pairs); the f32 product never reaches device memory. Columns past M
//   (the ragged last stripe, and CTAs that pad the grid to whole clusters)
//   are loaded as zeros by TMA and never stored.
//
// Contract (checked again here; the geometry comes from the Python wrapper
// in engine/masked_spmv.py): G a multiple of `rows` (128 or 256), M a
// multiple of 128, `grid_x` a multiple of CLUSTER with grid_x * BN >= M;
// every pointer 16-byte aligned, row-major contiguous.
// Launches on the caller's stream, allocates nothing, and returns the launch
// error or cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BN = 96;       // adjacency columns per CTA
constexpr int BK = 64;       // K depth of a stage: one 128-byte F row
constexpr int ATOM_N = 32;   // columns of one 64-byte swizzle atom of A
constexpr int STAGES = 5;    // TMA ring depth
constexpr int CLUSTER = 4;   // CTAs along N that share each F tile
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int A_BOX_BYTES = BK * ATOM_N * 2;         // 4 KB
constexpr int A_STAGE_BYTES = (BN / ATOM_N) * A_BOX_BYTES;  // 12 KB
constexpr int ACC = BN / 2;  // f32 accumulators per thread per m64 tile

template <int MT>  // m64 tiles per consumer warpgroup
struct Tile {
  static constexpr int ROWS = 128 * MT;  // frontier rows per CTA
  static constexpr int F_STAGE_BYTES = ROWS * BK * 2;
  static constexpr int STAGE_BYTES = F_STAGE_BYTES + A_STAGE_BYTES;
  // 1 KB of slack to align the ring for the 128-byte swizzle
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
};

// d[64 x 96] += F[64 x 16] (K-major) x A[16 x 96] (MN-major)
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[ACC], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <int MT>
__device__ __forceinline__ void fence_acc(float (&acc)[MT][ACC]) {
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < ACC; ++i) fence_operand(acc[t][i]);
}

// a consumer warpgroup's release of one ring stage: one arrival on that
// stage's empty barrier in every CTA of the cluster
__device__ __forceinline__ void release_stage(uint32_t bar, int t) {
  if (t < CLUSTER) mbar_arrive_cluster(bar, t);
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
    masked_spmv_kernel(const __grid_constant__ CUtensorMap f_map,
                       const __grid_constant__ CUtensorMap a_map,
                       const __nv_bfloat16* __restrict__ R,
                       __nv_bfloat16* __restrict__ newly,
                       __nv_bfloat16* __restrict__ reached, int m) {
  using T = Tile<MT>;
  extern __shared__ uint8_t smem_raw[];
  // the ring: STAGES F tiles, STAGES A tiles, then full and empty barriers
  const uint32_t f_ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_ring = f_ring + STAGES * T::F_STAGE_BYTES;
  const uint32_t full_bar = a_ring + STAGES * A_STAGE_BYTES;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * T::ROWS;
  const int nk = m / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2 * CLUSTER);
    }
    fence_barrier_init();
  }
  // no peer may multicast into this CTA before its barriers exist
  cluster_sync();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA ring full ----------------------
    setmaxnreg_dec<40>();
    if (tid == 0) {
      prefetch_tensormap(&f_map);
      prefetch_tensormap(&a_map);
      constexpr int SLICE = T::ROWS / CLUSTER;  // F rows this CTA loads
      const uint32_t rank = cluster_ctarank();
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        // released by both consumer warpgroups of every CTA in the cluster
        mbar_wait(empty_bar + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * s;
        mbar_arrive_expect_tx(bar, T::STAGE_BYTES);
        const int k0 = kt * BK;
        const uint32_t f_dst =
            f_ring + s * T::F_STAGE_BYTES + rank * SLICE * BK * 2;
        tma_load_2d_multicast(f_dst, &f_map, bar, k0, row0 + rank * SLICE,
                              static_cast<uint16_t>((1 << CLUSTER) - 1));
#pragma unroll
        for (int i = 0; i < BN / ATOM_N; ++i) {
          tma_load_2d(a_ring + s * A_STAGE_BYTES + i * A_BOX_BYTES, &a_map,
                      bar, col0 + i * ATOM_N, k0);
        }
      }
      // stay until every consumer in the cluster has released every stage:
      // peers arrive on this CTA's empty barriers up to their last stage
      for (int kt = nk; kt < nk + STAGES; ++kt) {
        mbar_wait(empty_bar + 8 * (kt % STAGES), ((kt / STAGES) & 1) ^ 1);
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the fused epilogue -----------
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // consumer warpgroup 0 or 1
    const int t = tid % 128;
    float acc[MT][ACC];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[i][j] = 0.0f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);
      const uint32_t f_tile =
          f_ring + s * T::F_STAGE_BYTES + cw * MT * 64 * 128;
      const uint32_t a_tile = a_ring + s * A_STAGE_BYTES;
      fence_acc<MT>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 16 K-rows of 64 bytes per step; 8-row groups 512 B apart
        // (stride offset), 32-column atoms 4 KB apart (leading offset)
        const uint64_t db =
            smem_desc(a_tile + kk * 16 * 64, A_BOX_BYTES, 512, SWIZZLE_64B);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // F: 64 rows of 128 bytes, 8-row groups 1 KB apart; K steps by 32 B
          const uint64_t da = smem_desc(f_tile + mt * 64 * 128 + kk * 32, 16,
                                        1024, SWIZZLE_128B);
          wgmma_m64n96k16(acc[mt], da, db);
        }
      }
      wgmma_commit();
      fence_acc<MT>(acc);
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0) {
        release_stage(empty_bar + 8 * ((kt - 1) % STAGES), t);
      }
    }
    wgmma_wait<0>();
    fence_acc<MT>(acc);
    if (nk > 0) {
      release_stage(empty_bar + 8 * ((nk - 1) % STAGES), t);
    }

    // fragment layout of m64nNk16: thread t holds, for each 8-column block
    // j, rows t/32*16 + (t%32)/4 (+8) and columns 8j + 2*(t%4) (+1)
    const int warp = t / 32;
    const int lane = t % 32;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row =
            row0 + (cw * MT + mt) * 64 + warp * 16 + lane / 4 + 8 * h;
        const size_t row_off = static_cast<size_t>(row) * m;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = col0 + 8 * j + 2 * (lane % 4);
          if (col >= m) continue;  // m is even: col < m means col + 1 < m
          const size_t off = row_off + col;
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(R + off);
          const float r0 = __low2float(rv);
          const float r1 = __high2float(rv);
          const bool n0 = acc[mt][4 * j + 2 * h] > 0.5f;
          const bool n1 = acc[mt][4 * j + 2 * h + 1] > 0.5f;
          *reinterpret_cast<__nv_bfloat162*>(newly + off) =
              __floats2bfloat162_rn(n0 ? 1.0f - r0 : 0.0f,
                                    n1 ? 1.0f - r1 : 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(reached + off) =
              __floats2bfloat162_rn(n0 ? fmaxf(r0, 1.0f) : fmaxf(r0, 0.0f),
                                    n1 ? fmaxf(r1, 1.0f) : fmaxf(r1, 0.0f));
        }
      }
    }
  }
}

template <int MT>
int launch(const void* f, const void* a, const void* r, void* newly,
           void* reached, int g, int m, int grid_x, cudaStream_t stream) {
  using T = Tile<MT>;
  CUtensorMap f_map;
  CUtensorMap a_map;
  if (!encode_2d_bf16(&f_map, f, g, m, T::ROWS / CLUSTER, BK,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d_bf16(&a_map, a, m, m, BK, ATOM_N,
                      CU_TENSOR_MAP_SWIZZLE_64B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel =
      reinterpret_cast<const void*>(&masked_spmv_kernel<MT>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, g / T::ROWS, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&f_map, &a_map, &r, &newly, &reached, &m};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int masked_spmv_step(const void* f, const void* a, const void* r,
                                void* newly, void* reached, int g, int m,
                                int rows, int grid_x, void* stream) {
  if (g <= 0 || m <= 0 || m % 128 != 0 || (rows != 128 && rows != 256) ||
      g % rows != 0 || grid_x <= 0 || grid_x % CLUSTER ||
      static_cast<long long>(grid_x) * BN < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows == 256 ? launch<2>(f, a, r, newly, reached, g, m, grid_x, s)
                     : launch<1>(f, a, r, newly, reached, g, m, grid_x, s);
}
