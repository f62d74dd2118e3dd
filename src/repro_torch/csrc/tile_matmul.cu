// Batched output-stationary tile GEMM with an optional carry-in accumulator:
//
//   O[p] = (C[p] +) A[p] @ B[p]     A [P,M,K], B [P,K,N], C/O [P,M,N]
//
// Replaces the Pallas kernel repro/kernels/systolic_matmul/kernel.py::matmul
// (bodies _matmul_kernel and _matmul_acc_kernel). One launch covers every PE
// of one ring hop: the PE axis is the grid's z dimension.
//
// What bounds it on an H100: at the main path's shapes (M = 512 rows per PE,
// K and N of 256..1024, bf16) the product does ~100-300 operations per byte
// moved, near the card's balance point of ~295, so a fast version is bound
// by the tensor cores. This first version is deliberately simple: fp32 FMA
// on the CUDA cores (67 TFLOP/s peak) over 64x64 output tiles staged
// through shared memory, each thread holding a 4x4 block of the fp32
// accumulator in registers. The accumulator is seeded from C (the
// travelling reduce-scatter partial), so one hop's consume is one launch.
// Ragged M/N/K edges are masked here, so no shape needs another path.
// wgmma, TMA and a multi-stage pipeline are later work.
//
// dtype codes: 0 = float32, 1 = bfloat16; c_dtype = -1 means no carry-in.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;   // 16 x 16 threads
constexpr int THREADS = TX * TY;            // 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TIn, typename TC, typename TOut, bool HAS_C>
__global__ void __launch_bounds__(THREADS)
tile_matmul_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                   const TC* __restrict__ C, TOut* __restrict__ O,
                   int M, int N, int K) {
  __shared__ float As[BK][BM + 4];   // A tile, transposed (k-major)
  __shared__ float Bs[BK][BN + 4];
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  A += (size_t)p * M * K;
  B += (size_t)p * K * N;
  const size_t mn = (size_t)p * M * N;

  // this thread's outputs: rows m0 + ty + i*TY, cols n0 + tx + j*TX
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + i * TY, n = n0 + tx + j * TX;
      acc[i][j] = 0.f;
      if (HAS_C && m < M && n < N) acc[i][j] = to_f(C[mn + (size_t)m * N + n]);
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? to_f(A[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? to_f(B[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + i * TY, n = n0 + tx + j * TX;
      if (m < M && n < N) O[mn + (size_t)m * N + n] = from_f<TOut>(acc[i][j]);
    }
  }
}

template <typename TIn, typename TC, typename TOut, bool HAS_C>
void launch(const void* a, const void* b, const void* c, void* out, int P,
            int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, P);
  tile_matmul_kernel<TIn, TC, TOut, HAS_C><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<const TC*>(c), static_cast<TOut*>(out), M, N, K);
}

template <typename TIn, typename TOut>
bool dispatch_c(const void* a, const void* b, const void* c, void* out, int P,
                int M, int N, int K, int c_dtype, cudaStream_t s) {
  switch (c_dtype) {
    case -1: launch<TIn, float, TOut, false>(a, b, c, out, P, M, N, K, s); return true;
    case 0: launch<TIn, float, TOut, true>(a, b, c, out, P, M, N, K, s); return true;
    case 1: launch<TIn, __nv_bfloat16, TOut, true>(a, b, c, out, P, M, N, K, s); return true;
  }
  return false;
}

template <typename TIn>
bool dispatch_out(const void* a, const void* b, const void* c, void* out, int P,
                  int M, int N, int K, int c_dtype, int out_dtype, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return dispatch_c<TIn, float>(a, b, c, out, P, M, N, K, c_dtype, s);
    case 1: return dispatch_c<TIn, __nv_bfloat16>(a, b, c, out, P, M, N, K, c_dtype, s);
  }
  return false;
}

}  // namespace

extern "C" int tile_matmul(const void* a, const void* b, const void* c, void* out,
                           int P, int M, int N, int K, int in_dtype, int c_dtype,
                           int out_dtype, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (in_dtype) {
    case 0: ok = dispatch_out<float>(a, b, c, out, P, M, N, K, c_dtype, out_dtype, s); break;
    case 1: ok = dispatch_out<__nv_bfloat16>(a, b, c, out, P, M, N, K, c_dtype, out_dtype, s); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
