// Weight-stationary, zero-padded 3x3 convolution over the row blocks of P
// PEs, each block extended by one halo row above and one below:
//
//   out[p, i, c] = sum_{dr, dc} w[dr, dc] * ext[p, i + dr - 1, c + dc - 1]
//
//   x [P,R,W]; top, bot [P,1,W] (null = zero rows); w [3,3] fp32; out [P,R,W]
//
// ext[p, -1] is top[p], ext[p, R] is bot[p], and columns outside [0, W) are
// zero. Replaces the Pallas kernel repro/kernels/conv2d/kernel.py::conv2d_3x3
// (body _conv_kernel), whose grid steps read the previous and next row block
// for their halos; here the halo rows arrive as separate pointers (the rows
// the emulated ring's hops delivered), so no extended copy of the image is
// ever built. One launch covers every PE: the PE axis is the grid's z
// dimension. The whole-image contract conv2d(x [H,W], w) is P = 1 with null
// halos.
//
// What bounds it on an H100: 9 multiply-adds per output against 8 bytes
// moved per fp32 point (one read, one write): ~2 operations per byte, far
// below the card's balance point, so it is bound by device memory. The
// design reads each image row once per strip of RT output rows: every
// thread owns one column and slides a 3x3 window of registers down the
// strip, loading one new value per row; the column neighbours come from the
// adjacent lanes by warp shuffle (the edge lanes load their one extra
// value). The nine weights sit in registers for the whole block (the
// paper's stationary kernel). Products and sums are rounded separately
// (__fmul_rn, __fadd_rn) in the reference's order, dr outer and dc inner,
// so the result equals the plain twin's bit for bit. The accumulator is
// fp32; the output takes the input's type.
//
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BW = 256;   // columns per block, one per thread
constexpr int RT = 16;    // output rows per block, slid down in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row i of PE p's extended block: -1 is the top halo, R the bottom one.
// Null means a row of zeros.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* x, const T* top, const T* bot,
                                            int p, int i, int R, int W) {
  if (i < 0) return top ? top + (size_t)p * W : nullptr;
  if (i >= R) return bot ? bot + (size_t)p * W : nullptr;
  return x + ((size_t)p * R + i) * W;
}

// Columns c-1, c, c+1 of one row. Every lane of the warp must call this.
template <typename T>
__device__ __forceinline__ void load3(const T* row, int c, int W, int lane,
                                      float v[3]) {
  const float mid = (row && c < W) ? to_f(row[c]) : 0.f;
  float left = __shfl_up_sync(0xffffffffu, mid, 1);
  float right = __shfl_down_sync(0xffffffffu, mid, 1);
  if (lane == 0) left = (row && c >= 1 && c - 1 < W) ? to_f(row[c - 1]) : 0.f;
  if (lane == 31) right = (row && c + 1 < W) ? to_f(row[c + 1]) : 0.f;
  v[0] = left;
  v[1] = mid;
  v[2] = right;
}

template <typename T>
__global__ void __launch_bounds__(BW)
conv2d_3x3_kernel(const T* __restrict__ x, const T* __restrict__ top,
                  const T* __restrict__ bot, const float* __restrict__ wgt,
                  T* __restrict__ out, int R, int W) {
  const int p = blockIdx.z;
  const int c = blockIdx.x * BW + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * RT;
  const int r1 = min(r0 + RT, R);
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = wgt[i];

  float win[3][3];
  load3(row_ptr(x, top, bot, p, r0 - 1, R, W), c, W, lane, win[0]);
  load3(row_ptr(x, top, bot, p, r0, R, W), c, W, lane, win[1]);
  for (int i = r0; i < r1; ++i) {
    load3(row_ptr(x, top, bot, p, i + 1, R, W), c, W, lane, win[2]);
    float acc = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        acc = __fadd_rn(acc, __fmul_rn(k[dr * 3 + dc], win[dr][dc]));
    }
    if (c < W) out[((size_t)p * R + i) * W + c] = from_f<T>(acc);
#pragma unroll
    for (int dc = 0; dc < 3; ++dc) {
      win[0][dc] = win[1][dc];
      win[1][dc] = win[2][dc];
    }
  }
}

template <typename T>
void launch(const void* x, const void* top, const void* bot, const void* w,
            void* out, int P, int R, int W, cudaStream_t stream) {
  dim3 grid((W + BW - 1) / BW, (R + RT - 1) / RT, P);
  conv2d_3x3_kernel<T><<<grid, BW, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(top),
      static_cast<const T*>(bot), static_cast<const float*>(w),
      static_cast<T*>(out), R, W);
}

}  // namespace

extern "C" int conv2d_3x3(const void* x, const void* top, const void* bot,
                          const void* w, void* out, int P, int R, int W,
                          int dtype, void* stream) {
  if (P <= 0 || P > 65535 || R <= 0 || W <= 0 || (R + RT - 1) / RT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, top, bot, w, out, P, R, W, s); break;
    case 1: launch<__nv_bfloat16>(x, top, bot, w, out, P, R, W, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
