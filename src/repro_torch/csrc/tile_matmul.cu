// Batched output-stationary tile GEMM with an optional carry-in accumulator:
//
//   O[p] = (C[p] +) A[p] @ B[p]     A [P,M,K], B [P,K,N], C/O [P,M,N]
//
// Replaces the Pallas kernel repro/kernels/systolic_matmul/kernel.py::matmul
// (bodies _matmul_kernel and _matmul_acc_kernel). One launch covers every PE
// of one ring hop: the PE axis is the grid's z dimension. The accumulator is
// fp32, seeded from C (the travelling reduce-scatter partial), and rounded
// once to the output type.
//
// What bounds it on an H100: the serving path's hops (P = 4 PEs, M = 512
// rows per PE, K and N of 512..1024, bf16) do ~240 operations per byte
// moved, near the card's balance point of ~295 for bf16 tensor cores, so
// the tensor-core rate and the bytes bound it together (~4 us at the FFN
// hop). Cannon's fp32 step at card scale ([256,512,512]^2) is bound by
// fp32 FMAs on the CUDA cores (67 TFLOP/s).
//
// Two bodies, chosen by the input type:
//
// * bf16 inputs: wgmma (sm_90a). Two warpgroups own 64 rows each of a
//   128 x BN output tile; BN (64, 96 or 128) is chosen per launch from
//   (P, M, N) so the grid fills about one wave of the 132 SMs, unless the
//   caller's block forces 64 or 128 (the autotuner's knob). K-tiles of
//   64 go through a ring of 5 shared-memory stages, three ahead of the
//   math, in the 128-byte swizzled layout the wgmma descriptors read (A
//   K-major, B N-major); one wgmma group stays in flight across each
//   step's barrier.
//   The loads are cp.async groups, not TMA: TMA would need a
//   cuTensorMapEncodeTiled per operand per launch on a path whose device
//   is mostly idle waiting for the host, and a link to libcuda; cp.async
//   needs nothing on the host. Out-of-range rows and columns are
//   zero-filled by the copy (src-size 0); K and N must be multiples of 8
//   and the operands 16-byte aligned (the wrapper pads or copies others).
// * fp32 inputs: exact fp32 FMAs (the twin's arithmetic; no TF32), a SIMT
//   SGEMM with 128 x 128 block tiles, an 8 x 8 register tile per thread
//   (64 x 64 and 4 x 4 when 128 x 128 tiles would not fill one wave, or
//   as the caller's block forces),
//   float4 shared-memory reads and double-buffered cp.async loads (A is
//   transposed by 4-byte copies, B arrives as 16-byte copies). N must be a
//   multiple of 4.
//
// Measured (chip_smoke.py phase 2, device time under torch.profiler; NVIDIA
// H100 80GB HBM3, 700.00 W): FFN AG hop [4,512,1024]@[4,1024,768] bf16
// 0.0126 ms against torch.bmm's 0.0073 and a 0.0041 ms bound; QKV q hop
// (N = 512) 0.0090 (bmm 0.0059); FFN RS hop with a bf16 carry 0.0142
// (baddbmm 0.0094); Cannon's fp32 step [256,512,512]^2 with carry 1.93 ms
// (baddbmm 1.65, bound 1.03). The first port, fp32 FMAs over 64 x 64 tiles
// for both types, took 0.188 and 3.53 ms. At the bf16 hops each SM pulls
// (128 + BN) x K x 2 bytes through L2, which is what keeps the kernel
// short of bmm; PERF.md has the rest.
//
// dtype codes: 0 = float32, 1 = bfloat16; c_dtype = -1 means no carry-in.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// two output values at (m, n), (m, n + 1); n is even and N a multiple of 8
template <typename T>
__device__ __forceinline__ void load2(const T* p, float& x, float& y);
template <>
__device__ __forceinline__ void load2<float>(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
}
template <>
__device__ __forceinline__ void load2<__nv_bfloat16>(const __nv_bfloat16* p, float& x, float& y) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  x = __low2float(v);
  y = __high2float(v);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BK = 64, WG_STAGES = 5, WG_THREADS = 256;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;    // 128 rows x 128 bytes
constexpr int WG_PANEL_BYTES = WG_BK * 128;      // 64 K-rows x 64 columns

template <int BN>
struct WgTile {
  static constexpr int PANELS = (BN + 63) / 64;
  static constexpr int STAGE_BYTES = WG_A_BYTES + PANELS * WG_PANEL_BYTES;
  static constexpr int SMEM = WG_STAGES * STAGE_BYTES + 1024;  // + alignment
};

// Shared-memory matrix descriptor, 128-byte swizzle. Every swizzle atom
// (8 rows of 128 bytes) starts on 1024 bytes; within an atom row r holds
// its 16-byte chunk c at chunk c ^ r.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D[64 x N] += A[64 x 16] (K-major) @ B[16 x N] (N-major), fp32 accumulator
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n96(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else if constexpr (BN == 96) wgmma_n96(d, da, db);
  else wgmma_n128(d, da, db);
}

template <int BN, typename TC, typename TOut, bool HAS_C>
__global__ void __launch_bounds__(WG_THREADS)
tile_matmul_kernel_wgmma(const __nv_bfloat16* __restrict__ A,
                         const __nv_bfloat16* __restrict__ B,
                         const TC* __restrict__ C, TOut* __restrict__ O,
                         int M, int N, int K) {
  using Tile = WgTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int p = blockIdx.z, m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  A += (size_t)p * M * K;
  B += (size_t)p * K * N;
  const size_t mn = (size_t)p * M * N;
  const int KT = (K + WG_BK - 1) / WG_BK;

  // one K-tile into its stage: A [128 x 64] K-major, B [64 x BN] as
  // 64-column panels of 64 K-rows, both 128-byte swizzled
  auto load_stage = [&](int kt) {
    const uint32_t sa = base + (kt % WG_STAGES) * Tile::STAGE_BYTES;
    const uint32_t sb = sa + WG_A_BYTES;
    const int k0 = kt * WG_BK;
#pragma unroll
    for (int i = 0; i < WG_BM * 8 / WG_THREADS; ++i) {
      const int idx = tid + i * WG_THREADS, r = idx >> 3, c = idx & 7;
      const int gm = m0 + r, gk = k0 + c * 8;
      const bool ok = gm < M && gk < K;
      cp_async16(sa + r * 128 + ((c ^ (r & 7)) << 4),
                 ok ? A + (size_t)gm * K + gk : A, ok);
    }
    constexpr int BCH = BN / 8;                // 16-byte chunks per K-row
#pragma unroll
    for (int i = 0; i < WG_BK * BCH / WG_THREADS; ++i) {
      const int idx = tid + i * WG_THREADS, kr = idx / BCH, cn = idx % BCH;
      const int gk = k0 + kr, gn = n0 + cn * 8, cc = cn & 7;
      const bool ok = gk < K && gn < N;
      cp_async16(sb + (cn >> 3) * WG_PANEL_BYTES + kr * 128 +
                     ((cc ^ (kr & 7)) << 4),
                 ok ? B + (size_t)gk * N + gn : B, ok);
    }
  };

  // accumulator fragment: value i sits at row row0 + 8*((i>>1)&1), column
  // n0 + (i>>2)*8 + (lane&3)*2 + (i&1); seeded from the carry
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = n0 + (i >> 2) * 8 + (lane & 3) * 2;
    acc[i] = 0.f;
    acc[i + 1] = 0.f;
    if (HAS_C && row < M && col < N)
      load2(C + mn + (size_t)row * N + col, acc[i], acc[i + 1]);
  }

  // Tiles run WG_STAGES - 2 ahead of the math, and one wgmma group stays in
  // flight across the barrier: at step kt every warpgroup has retired the
  // wgmmas of step kt-2, so that stage takes tile kt + WG_STAGES - 2.
#pragma unroll
  for (int s = 0; s < WG_STAGES - 2; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<WG_STAGES - 3>();            // this thread's tile kt landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                           // everyone's landed; step kt-2 retired
    if (kt + WG_STAGES - 2 < KT) load_stage(kt + WG_STAGES - 2);
    cp_async_commit();
    const uint32_t sa = base + (kt % WG_STAGES) * Tile::STAGE_BYTES;
    const uint32_t sb = sa + WG_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      const uint64_t da = sw128_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(sb + kk * 16 * 128, WG_PANEL_BYTES, 1024);
      wgmma_bn<BN>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();                           // step kt-1 retired
  }
  wgmma_wait<0>();

#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = n0 + (i >> 2) * 8 + (lane & 3) * 2;
    if (row < M && col < N)
      store2(O + mn + (size_t)row * N + col, acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32 body: SIMT SGEMM
// ---------------------------------------------------------------------------

constexpr int SG_BK = 8, SG_THREADS = 256, SG_PAD = 4;

// four values at (m, n..n+3); n is a multiple of 4 and N too
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* v);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float* v) {
  load2(p, v[0], v[1]);
  load2(p + 2, v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float* v) {
  store2(p, v[0], v[1]);
  store2(p + 2, v[2], v[3]);
}

// A 16 x 16 grid of threads, each holding a TM x TM register tile, covers
// a (16 TM)^2 block tile: 128 x 128 with TM = 8, 64 x 64 with TM = 4 for
// grids too small to fill the card. A thread's rows are
// m0 + ty*4 + (i&3) + (i>>2)*BT/2 and its columns likewise.
template <int TM, typename TC, typename TOut, bool HAS_C>
__global__ void __launch_bounds__(SG_THREADS, 2)
tile_matmul_kernel_sgemm(const float* __restrict__ A, const float* __restrict__ B,
                         const TC* __restrict__ C, TOut* __restrict__ O,
                         int M, int N, int K) {
  constexpr int BT = 16 * TM, HALF = BT / 2;
  __shared__ __align__(16) float As[2][SG_BK][BT + SG_PAD];  // k-major
  __shared__ __align__(16) float Bs[2][SG_BK][BT + SG_PAD];
  const int p = blockIdx.z, m0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  A += (size_t)p * M * K;
  B += (size_t)p * K * N;
  const size_t mn = (size_t)p * M * N;
  const int KT = (K + SG_BK - 1) / SG_BK;

  auto load_stage = [&](int kt) {
    const int s = kt & 1, k0 = kt * SG_BK;
#pragma unroll
    for (int i = 0; i < BT * SG_BK / SG_THREADS; ++i) {
      const int idx = tid + i * SG_THREADS, r = idx >> 3, c = idx & 7;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      cp_async4(smem_u32(&As[s][c][r]), ok ? A + (size_t)gm * K + gk : A, ok);
    }
    constexpr int BCH = BT / 4;                  // 16-byte chunks per K-row
    if (tid < SG_BK * BCH) {
      const int kr = tid / BCH, cn = (tid % BCH) * 4;
      const int gk = k0 + kr, gn = n0 + cn;
      const bool ok = gk < K && gn < N;
      cp_async16(smem_u32(&Bs[s][kr][cn]), ok ? B + (size_t)gk * N + gn : B, ok);
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * 4 + (i & 3) + (i >> 2) * HALF;
#pragma unroll
    for (int jh = 0; jh < TM / 4; ++jh) {
      const int col = n0 + tx * 4 + jh * HALF;
      float* v = &acc[i][jh * 4];
      v[0] = v[1] = v[2] = v[3] = 0.f;
      if (HAS_C && row < M && col < N) load4(C + mn + (size_t)row * N + col, v);
    }
  }

  load_stage(0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int k = 0; k < SG_BK; ++k) {
      float a[TM], b[TM];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 av = *reinterpret_cast<const float4*>(&As[s][k][h * HALF + ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[s][k][h * HALF + tx * 4]);
        a[4 * h] = av.x; a[4 * h + 1] = av.y; a[4 * h + 2] = av.z; a[4 * h + 3] = av.w;
        b[4 * h] = bv.x; b[4 * h + 1] = bv.y; b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * 4 + (i & 3) + (i >> 2) * HALF;
#pragma unroll
    for (int jh = 0; jh < TM / 4; ++jh) {
      const int col = n0 + tx * 4 + jh * HALF;
      if (row < M && col < N) store4(O + mn + (size_t)row * N + col, &acc[i][jh * 4]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *a, *b, *c;
  void* out;
  int P, M, N, K;
  int block;  // 0: the launcher's own tile; 64 | 128: the caller's
};

// the widest output tile whose grid takes the fewest 132-SM waves, weighed
// by the work of one block: 128x96 at the FFN AG hop (N = 768, 128 blocks),
// 128x64 at the QKV q hop (N = 512), 128x128 at the FFN RS hop (N = 1024)
int choose_bn(int P, int M, int N) {
  constexpr int kSMs = 132;
  const int bns[3] = {128, 96, 64};
  int best = 128;
  long long best_cost = -1;
  for (int bn : bns) {
    const long long blocks = (long long)P * ((M + WG_BM - 1) / WG_BM) * ((N + bn - 1) / bn);
    const long long cost = (blocks + kSMs - 1) / kSMs * bn;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = bn;
    }
  }
  return best;
}

template <int BN, typename TC, typename TOut, bool HAS_C>
cudaError_t launch_wgmma(const Args& a, cudaStream_t s) {
  auto kern = tile_matmul_kernel_wgmma<BN, TC, TOut, HAS_C>;
  constexpr int smem = WgTile<BN>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((a.N + BN - 1) / BN, (a.M + WG_BM - 1) / WG_BM, a.P);
  kern<<<grid, WG_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.a), static_cast<const __nv_bfloat16*>(a.b),
      static_cast<const TC*>(a.c), static_cast<TOut*>(a.out), a.M, a.N, a.K);
  return cudaSuccess;
}

// a block of 64 or 128 forces BN (WG_BM and WG_BK stay 128 and 64)
template <typename TC, typename TOut, bool HAS_C>
cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  switch (a.block ? a.block : choose_bn(a.P, a.M, a.N)) {
    case 64: return launch_wgmma<64, TC, TOut, HAS_C>(a, s);
    case 96: return launch_wgmma<96, TC, TOut, HAS_C>(a, s);
    default: return launch_wgmma<128, TC, TOut, HAS_C>(a, s);
  }
}

template <int TM, typename TC, typename TOut, bool HAS_C>
cudaError_t launch_sgemm(const Args& a, cudaStream_t s) {
  constexpr int BT = 16 * TM;
  dim3 grid((a.N + BT - 1) / BT, (a.M + BT - 1) / BT, a.P);
  tile_matmul_kernel_sgemm<TM, TC, TOut, HAS_C><<<grid, SG_THREADS, 0, s>>>(
      static_cast<const float*>(a.a), static_cast<const float*>(a.b),
      static_cast<const TC*>(a.c), static_cast<TOut*>(a.out), a.M, a.N, a.K);
  return cudaSuccess;
}

// 128 x 128 tiles when they fill a wave of the card, else 64 x 64 (the fp32
// ring hops of a short prompt: [4, 500, 1024] @ [4, 1024, 256] gives 32
// blocks of 128 x 128); a block of 64 or 128 forces the square tile
template <typename TC, typename TOut, bool HAS_C>
cudaError_t launch_fp32(const Args& a, cudaStream_t s) {
  const long long big = (long long)a.P * ((a.M + 127) / 128) * ((a.N + 127) / 128);
  const bool wide = a.block ? a.block == 128 : big >= 132;
  return wide ? launch_sgemm<8, TC, TOut, HAS_C>(a, s)
                    : launch_sgemm<4, TC, TOut, HAS_C>(a, s);
}

template <typename TOut>
cudaError_t dispatch_c(const Args& a, int in_dtype, int c_dtype, cudaStream_t s) {
  const bool bf = in_dtype == 1;
  switch (c_dtype) {
    case -1: return bf ? launch_bf16<float, TOut, false>(a, s) : launch_fp32<float, TOut, false>(a, s);
    case 0: return bf ? launch_bf16<float, TOut, true>(a, s) : launch_fp32<float, TOut, true>(a, s);
    case 1:
      return bf ? launch_bf16<__nv_bfloat16, TOut, true>(a, s)
                : launch_fp32<__nv_bfloat16, TOut, true>(a, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The wgmma body needs K and N multiples of 8, the SGEMM body N a multiple
// of 4; both need 16-byte aligned operands. The Python wrapper pads or
// copies whatever does not meet this; here it is an error. ``block`` is 0
// (the launcher picks the tile), 64 or 128.
extern "C" int tile_matmul(const void* a, const void* b, const void* c, void* out,
                           int P, int M, int N, int K, int in_dtype, int c_dtype,
                           int out_dtype, int block, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || K < 0 || (in_dtype != 0 && in_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block != 0 && block != 64 && block != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((in_dtype == 1 && (K % 8 || N % 8)) || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(a) || !aligned16(b) || !aligned16(out) || (c_dtype >= 0 && !aligned16(c)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args args{a, b, c, out, P, M, N, K, block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (out_dtype) {
    case 0: err = dispatch_c<float>(args, in_dtype, c_dtype, s); break;
    case 1: err = dispatch_c<__nv_bfloat16>(args, in_dtype, c_dtype, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
