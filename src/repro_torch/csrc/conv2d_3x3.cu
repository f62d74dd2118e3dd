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
// ever built. One launch covers every PE. The whole-image contract
// conv2d(x [H,W], w) is P = 1 with null halos.
//
// What bounds it on an H100: 9 multiply-adds per output against 8 bytes
// moved per fp32 point (one read, one write): ~2 operations per byte, far
// below the card's balance point, so it is bound by device memory, and the
// design is about keeping enough bytes in flight to fill it. Two bodies:
//
// - conv2d_3x3_kernel_v16, for rows that start on 16-byte boundaries (W a
//   multiple of 4 in fp32 or 8 in bf16, every pointer 16-byte aligned):
//   each lane owns 16 bytes of consecutive columns and a warp owns a
//   column band of 512 bytes over a strip of rows (a whole PE block of up
//   to 64 rows, or 32-row strips of a taller one: the caller picks the
//   strip), so every row is read once plus two halo rows per strip. Each lane copies its 16
//   bytes of the next rows with cp.async into a ring of NS row slots in
//   shared memory, so NS - 3 rows stay in flight while a row is computed
//   and the copies hold no registers (which keeps occupancy, and with it
//   the bytes in flight per SM, high). The column neighbours come from the
//   adjacent lanes' vectors by shuffle; only the band's edge lanes (0 and
//   31) copy one more vector each, the neighbouring band's edge. The warps
//   of a block are stacked over strips, never side by side in columns, so
//   that edge is the block's tile edge.
// - conv2d_3x3_kernel, the generic body for every other width or
//   alignment: every thread owns one column and slides a 3x3 window of
//   registers down a strip of RT rows, one scalar load a row, column
//   neighbours by shuffle with the edge lanes loading their extra value.
//
// Both keep the nine weights in registers for the whole block (the paper's
// stationary kernel) and round products and sums separately (__fmul_rn,
// __fadd_rn) in the reference's order, dr outer and dc inner, so the result
// equals the plain twin's bit for bit. The accumulator is fp32; the output
// takes the input's type.
//
// dtype codes: 0 = float32, 1 = bfloat16. strip: 0 = the generic body, else
// the rows per strip of the 16-byte body.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// generic body: one column per thread, any width and alignment
// ---------------------------------------------------------------------------

constexpr int BW = 256;   // columns per block, one per thread
constexpr int RT = 16;    // output rows per block, slid down in registers

// Columns c-1, c, c+1 of one row. Every lane of the warp must call this.
template <typename T>
__device__ __forceinline__ void load3(const T* row, int c, int W, int lane,
                                      float v[3]) {
  const float mid = (row && c < W) ? to_f(row[c]) : 0.f;
  float left = __shfl_up_sync(FULL, mid, 1);
  float right = __shfl_down_sync(FULL, mid, 1);
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

// ---------------------------------------------------------------------------
// 16-byte body: 16 bytes of columns per lane, rows prefetched by cp.async
// ---------------------------------------------------------------------------

constexpr int VW = 4;     // warps per block, stacked over strips
constexpr int NS = 6;     // ring slots per warp (NS - 3 rows in flight
                          // while a row is computed)

// One extended row of a warp's band in shared memory: vector 0 holds the
// V columns left of the band, vectors 1..32 the lanes' own, vector 33 the
// V columns right of the band.
constexpr int SLOT = 34;

__device__ __forceinline__ void cp_async16(uint4* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T> __device__ __forceinline__ void unpack(uint4 r, float* v);
template <> __device__ __forceinline__ void unpack<float>(uint4 r, float* v) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
// bf16 -> fp32 is exact: the 16 bits become the high half of the float.
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 r, float* v) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* v);
template <> __device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Start copying one row's 16 bytes at column c0 into the lane's vector of
// the slot, and the band's neighbour vectors (lane 0 the left one, lane 31
// the right one; the band starts at column cb). A null row, or columns
// outside the image, fill with zeros (``safe`` is any valid address: a
// zero-byte copy reads nothing). Each lane reads back only what it copied
// itself, so the ring needs no barrier.
template <typename T>
__device__ __forceinline__ void issue(uint4* slot, const T* row, int c0, int cb,
                                      int W, int lane, const T* safe) {
  constexpr int V = 16 / sizeof(T);
  const bool own = row && c0 < W;
  cp_async16(slot + lane + 1, own ? row + c0 : safe, own);
  if (lane == 0) {
    const bool left = row && cb > 0;
    cp_async16(slot, left ? row + cb - V : safe, left);
  }
  if (lane == 31) {
    const bool right = row && cb + 32 * V < W;
    cp_async16(slot + SLOT - 1, right ? row + cb + 32 * V : safe, right);
  }
}

// A row's V columns with their left and right neighbours, from the slot:
// e[0] is column c0 - 1, e[V + 1] column c0 + V. The neighbours come from
// the adjacent lanes by shuffle, the band's edge columns from the
// neighbour vectors. Every lane of the warp must call this.
template <typename T>
__device__ __forceinline__ void expand(const uint4* slot, int lane, float* e) {
  constexpr int V = 16 / sizeof(T);
  unpack<T>(slot[lane + 1], e + 1);
  float left = __shfl_up_sync(FULL, e[V], 1);
  float right = __shfl_down_sync(FULL, e[1], 1);
  if (lane == 0) left = to_f(reinterpret_cast<const T*>(slot)[V - 1]);
  if (lane == 31) right = to_f(reinterpret_cast<const T*>(slot + SLOT - 1)[0]);
  e[0] = left;
  e[V + 1] = right;
}

template <typename T>
__global__ void __launch_bounds__(32 * VW)
conv2d_3x3_kernel_v16(const T* __restrict__ x, const T* __restrict__ top,
                      const T* __restrict__ bot, const float* __restrict__ wgt,
                      T* __restrict__ out, int P, int R, int W, int RS, int S) {
  constexpr int V = 16 / sizeof(T);
  __shared__ uint4 ring[VW][NS][SLOT];
  const int strip = blockIdx.y * VW + threadIdx.y;
  if (strip >= P * S) return;                 // whole warp: no shuffle waits
  const int lane = threadIdx.x;
  const int p = strip / S;
  const int r0 = (strip - p * S) * RS;
  const int n = min(RS, R - r0);              // output rows of this strip
  const int cb = blockIdx.x * 32 * V;
  const int c0 = cb + lane * V;
  uint4 (*slots)[SLOT] = ring[threadIdx.y];

  // extended row j of the strip is row r0 - 1 + j, j = 0 .. n + 1; it goes
  // to slot j % NS, and one commit group per row keeps the count uniform
  // (rows past the strip commit empty groups). A slot is refilled only
  // after the row it held was used in the sums, so no copy can overtake a
  // read of it.
  auto fill = [&](int j) {
    if (j <= n + 1)
      issue(slots[j % NS], row_ptr(x, top, bot, p, r0 - 1 + j, R, W), c0, cb,
            W, lane, x);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) fill(j);
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = wgt[i];

  float e0[V + 2], e1[V + 2], e2[V + 2];
  cp_async_wait<NS - 1>();
  expand<T>(slots[0], lane, e0);
  cp_async_wait<NS - 2>();
  expand<T>(slots[1], lane, e1);
  T* orow = out + ((size_t)p * R + r0) * W + c0;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NS - 3>();                  // row i + 2 has landed
    expand<T>(slots[(i + 2) % NS], lane, e2);
    float o[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) acc = __fadd_rn(acc, __fmul_rn(k[dc], e0[c + dc]));
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) acc = __fadd_rn(acc, __fmul_rn(k[3 + dc], e1[c + dc]));
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) acc = __fadd_rn(acc, __fmul_rn(k[6 + dc], e2[c + dc]));
      o[c] = acc;
    }
    fill(i + NS);                             // into row i's slot
    if (c0 < W) *reinterpret_cast<uint4*>(orow + (size_t)i * W) = pack<T>(o);
#pragma unroll
    for (int c = 0; c < V + 2; ++c) {
      e0[c] = e1[c];
      e1[c] = e2[c];
    }
  }
  cp_async_wait<0>();                         // no copy outlives the block
}

template <typename T>
void launch(const void* x, const void* top, const void* bot, const void* w,
            void* out, int P, int R, int W, int strip, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* tt = static_cast<const T*>(top);
  const T* bt = static_cast<const T*>(bot);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  if (strip == 0) {
    dim3 grid((W + BW - 1) / BW, (R + RT - 1) / RT, P);
    conv2d_3x3_kernel<T><<<grid, BW, 0, stream>>>(xt, tt, bt, wt, ot, R, W);
    return;
  }
  constexpr int V = 16 / sizeof(T);
  const int S = (R + strip - 1) / strip;
  dim3 grid((W + 32 * V - 1) / (32 * V), (P * S + VW - 1) / VW);
  conv2d_3x3_kernel_v16<T><<<grid, dim3(32, VW), 0, stream>>>(
      xt, tt, bt, wt, ot, P, R, W, strip, S);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" int conv2d_3x3(const void* x, const void* top, const void* bot,
                          const void* w, void* out, int P, int R, int W,
                          int dtype, int strip, void* stream) {
  if (P <= 0 || P > 65535 || R <= 0 || W <= 0 || strip < 0
      || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (strip == 0 && (R + RT - 1) / RT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (strip > 0) {
    // the 16-byte body reads and writes whole 16-byte vectors of every row
    const int vec = dtype == 0 ? 4 : 8;
    const long long blocks = ((long long)P * ((R + strip - 1) / strip) + VW - 1) / VW;
    if (W % vec || !aligned16(x) || !aligned16(out) || (top && !aligned16(top))
        || (bot && !aligned16(bot)) || blocks > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, top, bot, w, out, P, R, W, strip, s);
  else
    launch<__nv_bfloat16>(x, top, bot, w, out, P, R, W, strip, s);
  return static_cast<int>(cudaGetLastError());
}
