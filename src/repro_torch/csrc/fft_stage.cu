// One radix-4 decimation-in-time FFT stage per row block, each block at a
// stage of its own:
//
//   out[p, b] = butterflies_s(x[p, b] * tw[s])      s = stage[p]
//
//   x, out [P,B,n] complex64 (interleaved float2); stage [P] int32;
//   tw [D,n] complex64, D = log4(n) stages; reverse: stage-0 rows load x
//   digit-reversed (base 4) first.
//
// Replaces the Pallas kernel repro/kernels/fft/kernel.py::fft_stage (body
// _stage_kernel), which runs one stage over a batch on split real and
// imaginary planes (the TPU has no complex type). Here complex values stay
// interleaved, and every row block carries its own stage, so the emulated
// cfft pipeline (one stage per PE) is one launch per tick for all PEs, and
// the shared-memory fft256 is four launches with the digit-reversed load
// folded into the first.
//
// What bounds it on an H100: a radix-4 butterfly does 34 floating-point
// operations on 4 points of 8 bytes, each read once and written once: about
// half an operation per byte, so it is bound by device memory (3.35 TB/s).
// At the paper's batch of 64 FFTs on 4 PEs a launch moves 1 MB, so launch
// latency, not the bound, sets its time. The design gives one thread one
// butterfly: it loads the four points g*L + j*q + r (j = 0..3) of group g
// of L = 4^(s+1), q = L/4, applies the three non-trivial twiddles (leg 0's
// is 1) from the stage's row of the table, which stays in L1, and writes
// the four outputs back to the same indices. At the last stages the legs of
// neighbouring threads are adjacent, so the loads coalesce; at stage 0 a
// thread reads 32 contiguous bytes. Products and sums are rounded
// separately (__fmul_rn, __fadd_rn) in the reference's order, so the result
// equals the plain twin's bit for bit.
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
