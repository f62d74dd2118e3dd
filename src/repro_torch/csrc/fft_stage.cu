// Radix-4 decimation-in-time FFT on the card, two entry points:
//
//   fft_stage: one stage per row block, each block at a stage of its own
//     out[p, b] = butterflies_s(x[p, b] * tw[s])      s = stage[p]
//     x, out [P,B,n] complex64 (interleaved float2); stage [P] int32;
//     tw [D,n] complex64, D = log4(n) stages; reverse: stage-0 rows load x
//     digit-reversed (base 4) first.
//   fft_full: the whole n-point transform of every row in one launch
//     out[r] = butterflies_{D-1}(... butterflies_0(digit_reverse(x[r]) * tw[0]) ...)
//     x, out [R,n] complex64; the same table; 4 <= n <= 4096.
//
// Replaces the Pallas kernel repro/kernels/fft/kernel.py::fft_stage (body
// _stage_kernel), which runs one stage over a batch on split real and
// imaginary planes (the TPU has no complex type). Here complex values stay
// interleaved. fft_stage gives every row block its own stage, so the
// emulated cfft pipeline (one stage per PE) is one launch per tick for all
// PEs. fft_full is the shared-memory fft256: one launch instead of D.
//
// What bounds it on an H100: a radix-4 butterfly does 34 floating-point
// operations on 4 points of 8 bytes, each read once and written once: about
// half an operation per byte, so it is bound by device memory (3.35 TB/s).
// At the paper's batch of 64 FFTs on 4 PEs a launch moves 1 MB, so launch
// latency, not the bound, sets its time.
//
// fft_stage gives one thread one butterfly: it loads the four points
// g*L + j*q + r (j = 0..3) of group g of L = 4^(s+1), q = L/4, applies the
// three non-trivial twiddles (leg 0's is 1) from the stage's row of the
// table, which stays in L1, and writes the four outputs back to the same
// indices. At the last stages the legs of neighbouring threads are
// adjacent, so the loads coalesce; at stage 0 a thread reads 32 contiguous
// bytes.
//
// fft_full keeps rows resident in shared memory for all D stages, so each
// point crosses device memory twice per transform instead of 2D times. A
// block holds max(1, 1024 / n) rows (four 256-point rows for 256 threads)
// and runs the D stages in place with the butterfly indices of fft_stage
// and __syncthreads() between stages (a thread takes n/1024 butterflies per
// stage when n > 1024). Stage 0 reads its four points straight from device
// memory: point 4k + j of the digit-reversed row is x[j n/4 +
// digit_reverse(k)] (each warp's reads cover half of every 32-byte sector
// it touches; the next warp reads the other half through L1). The last
// stage writes its outputs j n/4 + k straight to device memory,
// coalesced. Twiddles are read through the read-only path: the table
// (8 KB at n = 256) stays in L1. Shared-memory rows are padded with one
// point after every four (index i at i + i/4): unpadded, stage 0's stores
// and stage 1's accesses 32 bytes apart would be 4-way bank conflicts;
// padded, they are conflict-free and the middle stages at most 2-way.
//
// Both round every product and sum separately (__fmul_rn, __fadd_rn,
// __fsub_rn in cmul; the butterfly's plain sums cannot contract) in the
// reference's order, so fft_stage equals one call of the plain twin and
// fft_full equals D of them, bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int digit_reverse(int i, int digits) {
  int out = 0;
  for (int d = 0; d < digits; ++d) {
    out = (out << 2) | (i & 3);
    i >>= 2;
  }
  return out;
}

// x * tw as the reference writes it: (xr*twr - xi*twi, xr*twi + xi*twr)
__device__ __forceinline__ float2 cmul(float2 x, float2 t) {
  return make_float2(__fsub_rn(__fmul_rn(x.x, t.x), __fmul_rn(x.y, t.y)),
                     __fadd_rn(__fmul_rn(x.x, t.y), __fmul_rn(x.y, t.x)));
}

__global__ void __launch_bounds__(THREADS)
fft_stage_kernel(const float2* __restrict__ x, const int* __restrict__ stage,
                 const float2* __restrict__ tw, float2* __restrict__ out,
                 int B, int n, int digits, int reverse, long long total) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int quarter_n = n >> 2;
  const long long rb = t / quarter_n;          // row (p, b)
  const int k = (int)(t - rb * quarter_n);     // butterfly within the row
  const int s = stage[rb / B];
  const float2* src = x + rb * n;
  float2* dst = out + rb * n;
  int idx[4];
  if (s < 0 || s >= digits) {                  // no such stage: poison
    const float nan = __int_as_float(0x7fc00000);
    for (int j = 0; j < 4; ++j) dst[k * 4 + j] = make_float2(nan, nan);
    return;
  }
  const int q = 1 << (2 * s);                  // L / 4
  const int L = q << 2;
  const int g = k >> (2 * s), r = k & (q - 1);
  float2 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    idx[j] = g * L + j * q + r;
    const int from = (reverse && s == 0) ? digit_reverse(idx[j], digits) : idx[j];
    v[j] = src[from];
    if (j) v[j] = cmul(v[j], tw[(size_t)s * n + idx[j]]);
  }
  // radix-4 butterfly; t3 = (b - d) * (-1j)
  const float2 t0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 t1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 t2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 t3 = make_float2(v[1].y - v[3].y, -(v[1].x - v[3].x));
  dst[idx[0]] = make_float2(t0.x + t2.x, t0.y + t2.y);
  dst[idx[1]] = make_float2(t1.x + t3.x, t1.y + t3.y);
  dst[idx[2]] = make_float2(t0.x - t2.x, t0.y - t2.y);
  dst[idx[3]] = make_float2(t1.x - t3.x, t1.y - t3.y);
}

constexpr int FULL_POINTS = 1024;        // points per block: 4 per thread
constexpr int FULL_MAX_N = 4096;         // a row of 32 KB (40 KB padded)

__device__ __forceinline__ int padded(int i) { return i + (i >> 2); }

__global__ void __launch_bounds__(THREADS)
fft_full_kernel(const float2* __restrict__ x, const float2* __restrict__ tw,
                float2* __restrict__ out, long long rows, int n, int digits,
                int rows_per_block) {
  extern __shared__ float2 buf[];                // [rows_per_block][n + n/4]
  const int ld = padded(n), log_n = 2 * digits, quarter_n = n >> 2;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int nr = (int)min((long long)rows_per_block, rows - row0);
  const float2* src = x + row0 * n;
  float2* dst = out + row0 * n;
  for (int s = 0; s < digits; ++s) {
    const int q = 1 << (2 * s);                  // L / 4
    const int L = q << 2;
    const float2* tws = tw + (size_t)s * n;
    for (int b = threadIdx.x; b < nr * quarter_n; b += THREADS) {
      const int r = b >> (log_n - 2), k = b & (quarter_n - 1);
      const int g = k >> (2 * s), rr = k & (q - 1);
      float2* row = buf + r * ld;
      int idx[4];
      float2 v[4];
      if (s == 0) {
        // stage 0 loads its points from device memory: point 4k + j of
        // the digit-reversed row is x[j n/4 + digit_reverse(k)]
        const int from = digit_reverse(k, digits - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          idx[j] = 4 * k + j;
          v[j] = __ldg(src + (size_t)r * n + j * quarter_n + from);
          if (j) v[j] = cmul(v[j], __ldg(tws + idx[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          idx[j] = g * L + j * q + rr;
          v[j] = row[padded(idx[j])];
          if (j) v[j] = cmul(v[j], __ldg(tws + idx[j]));
        }
      }
      // radix-4 butterfly; t3 = (b - d) * (-1j)
      const float2 t0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
      const float2 t1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
      const float2 t2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
      const float2 t3 = make_float2(v[1].y - v[3].y, -(v[1].x - v[3].x));
      const float2 y[4] = {make_float2(t0.x + t2.x, t0.y + t2.y),
                           make_float2(t1.x + t3.x, t1.y + t3.y),
                           make_float2(t0.x - t2.x, t0.y - t2.y),
                           make_float2(t1.x - t3.x, t1.y - t3.y)};
      if (s == digits - 1) {
        // the last stage writes device memory: idx = j n/4 + k, coalesced
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[(size_t)r * n + idx[j]] = y[j];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) row[padded(idx[j])] = y[j];
      }
    }
    if (s < digits - 1) __syncthreads();
  }
}

}  // namespace

extern "C" int fft_stage(const void* x, const void* stage, const void* tw,
                         void* out, int P, int B, int n, int digits,
                         int reverse, void* stream) {
  if (P <= 0 || B <= 0 || n < 4 || n != (1 << (2 * digits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)P * B * (n / 4);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fft_stage_kernel<<<(unsigned)blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const int*>(stage),
      static_cast<const float2*>(tw), static_cast<float2*>(out), B, n, digits,
      reverse, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fft_full(const void* x, const void* tw, void* out,
                        long long rows, int n, int digits, void* stream) {
  if (rows <= 0 || n < 4 || n > FULL_MAX_N || n != (1 << (2 * digits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = n >= FULL_POINTS ? 1 : FULL_POINTS / n;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)per_block * (n + n / 4) * sizeof(float2);
  fft_full_kernel<<<(unsigned)blocks, THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(tw),
      static_cast<float2*>(out), rows, n, digits, per_block);
  return static_cast<int>(cudaGetLastError());
}
