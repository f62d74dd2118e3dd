// Mamba2 SSD intra-chunk pass, one block per (batch*head, chunk):
//
//   dA = dt * a;  cum = cumsum(dA)                                  [L]
//   y[t, p]     = sum_{s <= t} (C[t].B[s]) * exp(cum[t] - cum[s]) * dt[s] * x[s, p]
//   state[p, n] = sum_s x[s, p] * (exp(cum[L-1] - cum[s]) * dt[s]) * B[s, n]
//   expcum[t]   = exp(cum[t])
//
//   x [BH,NC,L,P] (fp32 or bf16); dt [BH,NC,L] fp32; a [BH] fp32;
//   B, C [BG,NC,L,N] (x's type), shared by the heads of a group;
//   y [BH,NC,L,P], states [BH,NC,P,N], expcum [BH,NC,L], all fp32.
//
// Replaces the Pallas kernel repro/kernels/ssd/kernel.py::ssd_chunks (body
// _ssd_chunk_kernel). Head i of batch i / nheads reads the B/C rows of its
// group, batch * G + (i % nheads) / (nheads / G), exactly as the Pallas
// BlockSpec's bc_index does: B and C are never expanded to one copy per
// head.
//
// What bounds it on an H100: at mamba2-1.3b's shapes (L=256, P=64, N=128)
// a chunk does 2*L^2*N + 2*L^2*P + 2*L*P*N = 29 MFLOP on ~100 KB of input,
// so it is bound by operations. This first version runs fp32 FMAs on the
// CUDA cores (67 TFLOP/s), not the tensor cores. The design:
//
// * cum is summed in float64 by a block-wide scan and rounded once to fp32.
//   cum is differenced and then exponentiated, so the order of an fp32 sum
//   would show in the output; summed in float64 it does not depend on the
//   order, and the plain twin (torch.cumsum in float64) gets the same fp32
//   values.
// * The output rows are walked in 64-row tiles of t. For each, the 64-row
//   tiles of s at or below the diagonal are streamed through shared memory
//   (C and B transposed, n-major, so a thread's 4x4 micro tile reads
//   consecutive words); tiles above the diagonal are skipped, which is
//   exact. The decay is a select, never a product with a mask: above the
//   diagonal exp(cum[t] - cum[s]) overflows to inf at realistic dt, and
//   inf * 0 is NaN.
// * M = (C B^T) * decay * dt goes to shared memory (s-major) and y += M x
//   accumulates in registers, 4 t x 4 p per thread.
// * The boundary state is a second pass over the s tiles with B in its
//   natural layout: 4 p x 8 n per thread, the weights exp(cum[L-1] - cum)
//   * dt folded into x as it is loaded.
//
// Shapes taken: P <= 64, N <= 128 (every configuration of the repository:
// mamba2-1.3b P=64, N=128; zamba2-1.2b P=64, N=64); any L whose shared
// memory fits (3L floats beside ~100 KB of tiles).
//
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TILE = 64;          // rows of t (output) and of s (input) per tile
constexpr int THREADS = 256;      // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int WARPS = THREADS / 32;
constexpr int LDT = TILE + 1;     // padded row of the n-major C/B tiles and of M
constexpr int MAX_P = 64;         // y micro tile: p = tx + 16 j, j < 4
constexpr int MAX_N = 128;        // state micro tile: n = tx + 16 j, j < 8

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_bytes(int L, int P, int N) {
  const size_t floats = 3 * (size_t)L            // cum, dt, w
                        + 2 * (size_t)N * LDT    // C^T (or B), B^T
                        + (size_t)TILE * P       // x (or x * w)
                        + (size_t)TILE * LDT;    // M, s-major
  return WARPS * sizeof(double) + floats * sizeof(float);
}

// cum = fp32(inclusive prefix sums of fp32(dt * a), taken in float64)
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int L,
                             float* s_dt, float* s_cum, double* s_wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < L; base += THREADS) {
    const int i = base + tid;
    float d = 0.f;
    if (i < L) {
      d = dt[i];
      s_dt[i] = d;
    }
    double v = (i < L) ? (double)__fmul_rn(d, a) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) s_wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double t = lane < WARPS ? s_wsum[lane] : 0.0;
#pragma unroll
      for (int off = 1; off < WARPS; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += u;
      }
      if (lane < WARPS) s_wsum[lane] = t;
    }
    __syncthreads();
    v += carry + (warp > 0 ? s_wsum[warp - 1] : 0.0);
    if (i < L) s_cum[i] = __double2float_rn(v);
    carry += s_wsum[WARPS - 1];
    __syncthreads();
  }
}

// rows [r0, r0 + TILE) of src [L, N] into dst n-major: dst[n * LDT + r]
template <typename T>
__device__ __forceinline__ void load_nmajor(const T* __restrict__ src, int r0,
                                            int L, int N, float* dst) {
  for (int idx = threadIdx.x; idx < TILE * N; idx += THREADS) {
    const int r = idx / N, n = idx - r * N;
    dst[n * LDT + r] = (r0 + r < L) ? to_f(src[(size_t)(r0 + r) * N + n]) : 0.f;
  }
}

// rows [r0, r0 + TILE) of src [L, W] into dst [TILE, W], row r scaled by
// scale[r0 + r] when scale is given
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int L, int W, const float* scale,
                                          float* dst) {
  for (int idx = threadIdx.x; idx < TILE * W; idx += THREADS) {
    const int r = idx / W, c = idx - r * W;
    float v = 0.f;
    if (r0 + r < L) {
      v = to_f(src[(size_t)(r0 + r) * W + c]);
      if (scale) v = __fmul_rn(v, scale[r0 + r]);
    }
    dst[idx] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunks_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ c, float* __restrict__ y,
                  float* __restrict__ states, float* __restrict__ expcum,
                  int NC, int L, int P, int N, int nheads, int ngroups) {
  extern __shared__ double smem[];
  double* s_wsum = smem;
  float* s_cum = reinterpret_cast<float*>(smem + WARPS);
  float* s_dt = s_cum + L;
  float* s_w = s_dt + L;
  float* buf_c = s_w + L;                 // C^T tile, then B rows (state pass)
  float* buf_b = buf_c + N * LDT;         // B^T tile
  float* buf_x = buf_b + N * LDT;         // x tile, then x * w (state pass)
  float* buf_m = buf_x + TILE * P;        // M tile, s-major

  const int bh = blockIdx.x / NC, ch = blockIdx.x - bh * NC;
  const int row = (bh / nheads) * ngroups + (bh % nheads) / (nheads / ngroups);
  const size_t cell = (size_t)bh * NC + ch;
  const T* X = x + cell * L * P;
  const T* B = b + ((size_t)row * NC + ch) * L * N;
  const T* C = c + ((size_t)row * NC + ch) * L * N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  chunk_cumsum(dt + cell * L, a[bh], L, s_dt, s_cum, s_wsum);
  for (int i = tid; i < L; i += THREADS) {
    expcum[cell * L + i] = expf(s_cum[i]);
    s_w[i] = __fmul_rn(expf(s_cum[L - 1] - s_cum[i]), s_dt[i]);
  }

  // ---- intra-chunk output y, 64 rows of t at a time
  const int n_tiles = (L + TILE - 1) / TILE;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int t0 = tt * TILE;
    __syncthreads();
    load_nmajor(C, t0, L, N, buf_c);
    float acc[4][4] = {};
    for (int st = 0; st <= tt; ++st) {
      const int s0 = st * TILE;
      __syncthreads();
      load_nmajor(B, s0, L, N, buf_b);
      load_rows(X, s0, L, P, nullptr, buf_x);
      __syncthreads();
      float cb[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = buf_c[n * LDT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = buf_b[n * LDT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rt = ty + 16 * i, rs = tx + 16 * j;
          const int t = t0 + rt, s = s0 + rs;
          float m = 0.f;
          if (s <= t && t < L)
            m = __fmul_rn(__fmul_rn(cb[i][j], expf(s_cum[t] - s_cum[s])), s_dt[s]);
          buf_m[rs * LDT + rt] = m;
        }
      }
      __syncthreads();
      for (int r = 0; r < TILE; ++r) {
        float mv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = buf_m[r * LDT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          xv[j] = p < P ? buf_x[r * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (t < L && p < P) y[(cell * L + t) * P + p] = acc[i][j];
      }
    }
  }

  // ---- boundary state: (x * w)^T B over every s tile
  float sacc[4][8] = {};
  for (int st = 0; st < n_tiles; ++st) {
    const int s0 = st * TILE;
    __syncthreads();
    load_rows(B, s0, L, N, nullptr, buf_c);
    load_rows(X, s0, L, P, s_w, buf_x);
    __syncthreads();
    for (int r = 0; r < TILE; ++r) {
      float xv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        xv[i] = p < P ? buf_x[r * P + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        bv[j] = n < N ? buf_c[r * N + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (p < P && n < N) states[(cell * P + p) * N + n] = sacc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* states, void* expcum, int BH, int NC,
           int L, int P, int N, int nheads, int ngroups, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunks_kernel<T><<<(unsigned)((size_t)BH * NC), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(expcum), NC, L, P, N,
      nheads, ngroups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_chunks(const void* x, const void* dt, const void* a,
                          const void* b, const void* c, void* y, void* states,
                          void* expcum, int BH, int NC, int L, int P, int N,
                          int nheads, int ngroups, int dtype, void* stream) {
  if (BH <= 0 || NC <= 0 || L <= 0 || P <= 0 || P > MAX_P || N <= 0 ||
      N > MAX_N || nheads <= 0 || ngroups <= 0 || nheads % ngroups != 0 ||
      BH % nheads != 0 || (size_t)BH * NC > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, a, b, c, y, states, expcum, BH, NC, L, P, N,
                           nheads, ngroups, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, a, b, c, y, states, expcum, BH, NC,
                                   L, P, N, nheads, ngroups, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
