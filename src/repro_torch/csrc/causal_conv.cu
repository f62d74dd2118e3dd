// Depthwise causal conv1d of the Mamba2 layer, with its bias and SiLU:
//
//   out[b, t, c] = silu(sum_{i<K} w[i, c] * x[b, t - (K-1-i), c] + bias[c])
//
//   x [B,S,C] at batch stride sb and row stride ss (in elements, channels
//   contiguous); w [K,C]; bias [C]; out [B,S,C] contiguous. Rows before 0
//   are zeros.
//
// A new kernel: it replaces no Pallas kernel. The reference's _causal_conv
// (src/repro/models/ssm.py:61) is plain jnp, left to XLA to fuse; run
// eagerly, the same function is about twenty ops a layer (a pad, a strided
// slice, a multiply and an add per tap), each a pass over the activations.
// The layer's conv columns of the input projection arrive as one strided
// view of it (three adjacent column ranges: x, B and C), which this kernel
// reads in place, so no concatenated copy is made either.
//
// What bounds it on an H100: K multiply-adds, a bias and a SiLU per output
// element against one read and one write of it (4 bytes in bf16), far below
// the card's balance point, so it is bound by device memory bytes, and the
// design reads each input once and writes each output once. A thread owns
// 16 bytes of channels (8 bf16 or 4 fp32) of one batch row over a tile of
// rows, walks down time and keeps the previous K-1 inputs in registers, so
// each input is read once, plus K-1 halo rows a tile, which the
// neighbouring tile's thread read a moment before and L2 still holds (the
// caller picks the tile: row_tile in kernels/causal_conv/kernel.py; short
// tiles, for more threads, measured fastest). The loads of U rows are
// issued before any of them is used. Consecutive threads own consecutive
// 16-byte columns of a row, so a warp reads 512 contiguous bytes.
//
// Numerics are the reference's (and PyTorch's eager form of it): the K taps
// summed in order from zero, each product and each partial sum rounded to
// the activation type; then the bias, rounded; then SiLU in fp32,
// x / (1 + expf(-x)) as PyTorch's CUDA kernel computes it, rounded once.
// __fmul_rn / __fadd_rn / __fdiv_rn keep fp32 from contracting into FMAs;
// in bf16 the taps and the bias run on the packed bf16x2 instructions
// (Lanes below), which round as the eager form does at half the
// instructions and without a conversion a rounding. The output equals the
// eager form's run on the card bit for bit. Measured at about half its
// byte bound in bf16 (PERF.md §6): the SiLU's exponential and division
// (two special-function operations an element) are the work left.
//
// Two bodies behind one entry, one template: causal_conv_kernel<T, K, N>
// with N = 16 / sizeof(T) (the above) when the rows start on 16-byte
// boundaries (C, the strides and every pointer), and N = 1, one channel a
// thread with scalar loads, for any other width, stride or pointer.
//
// dtype: 0 = float32, 1 = bfloat16. vector: 1 = the 16-byte body.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;        // rows whose loads are issued together
constexpr int MAX_K = 4;

// SiLU as PyTorch's CUDA kernel computes it, in fp32.
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// The arithmetic of the taps on a thread's N channels, held in L lanes of
// type V: in fp32 a lane a channel (__fmul_rn / __fadd_rn: no FMA); in
// bf16 a lane a 32-bit word of two channels, multiplied and added by the
// bf16x2 instructions with round-to-nearest, which round each product and
// sum to bf16 once. That equals PyTorch's fp32 arithmetic rounded to bf16:
// the product of two bf16 values is exact in fp32, and the fp32 sum of two
// bf16 values is inexact only when their exponents lie 16 or more apart,
// where both give the larger one. N = 1 (the generic body) keeps its one
// bf16 channel in a word's low half.
template <typename T, int N> struct Lanes;

template <int N> struct Lanes<float, N> {
  static constexpr int L = N;
  using V = float;
  static __device__ __forceinline__ V zero() { return 0.f; }
  static __device__ __forceinline__ V mul(V a, V b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ V add(V a, V b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ V act(V pre) { return silu(pre); }
  static __device__ __forceinline__ void load(const float* p, V* v) {
    if constexpr (N == 1) {
      v[0] = *p;
    } else {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = __uint_as_float(r.x);
      v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z);
      v[3] = __uint_as_float(r.w);
    }
  }
  static __device__ __forceinline__ void store(float* p, const V* v) {
    if constexpr (N == 1)
      *p = v[0];
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(
          __float_as_uint(v[0]), __float_as_uint(v[1]),
          __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <int N> struct Lanes<__nv_bfloat16, N> {
  static constexpr int L = (N + 1) / 2;
  using V = uint32_t;
  static __device__ __forceinline__ V zero() { return 0u; }
  static __device__ __forceinline__ V mul(V a, V b) {
    V d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ V add(V a, V b) {
    V d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // SiLU of both halves in fp32 (bf16 -> fp32 is exact: the 16 bits become
  // the high half of the float), each rounded once to bf16
  static __device__ __forceinline__ V act(V pre) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        silu(__uint_as_float(pre << 16)),
        silu(__uint_as_float(pre & 0xffff0000u)));
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, V* v) {
    if constexpr (N == 1) {
      v[0] = *reinterpret_cast<const unsigned short*>(p);
    } else {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = r.x;
      v[1] = r.y;
      v[2] = r.z;
      v[3] = r.w;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const V* v) {
    if constexpr (N == 1)
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)(v[0] & 0xffffu);
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// One body for both: N = 16 / sizeof(T) channels a thread (the 16-byte
// body, rows on 16-byte boundaries) or N = 1 (the generic body: scalar
// loads, any width, stride or pointer). A thread owns N channels of one
// batch row over rows [r0, r0 + tile).
template <typename T, int K, int N>
__global__ void __launch_bounds__(THREADS)
causal_conv_kernel(const T* __restrict__ x, long long sb, long long ss,
                   const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int S, int C, int tile, int ntiles,
                   long long items) {
  using ln = Lanes<T, N>;
  using V = typename ln::V;
  constexpr int L = ln::L;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= items) return;
  const int nv = C / N;
  const int c0 = (int)(item % nv) * N;
  const long long rest = item / nv;
  const int r0 = (int)(rest % ntiles) * tile;
  const int b = (int)(rest / ntiles);
  const int r1 = min(r0 + tile, S);

  V wk[K][L], bs[L];
#pragma unroll
  for (int i = 0; i < K; ++i) ln::load(w + (size_t)i * C + c0, wk[i]);
  ln::load(bias + c0, bs);

  // win[0..K-2]: rows r-K+1 .. r-1; win[K-1]: row r
  const T* xb = x + (long long)b * sb + c0;
  V win[K][L];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int r = r0 - (K - 1) + j;
    if (r >= 0) {
      ln::load(xb + (long long)r * ss, win[j]);
    } else {
#pragma unroll
      for (int q = 0; q < L; ++q) win[j][q] = ln::zero();
    }
  }
  T* ob = out + (long long)b * S * C + c0;
  for (int r = r0; r < r1; r += U) {
    V buf[U][L];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u < r1) ln::load(xb + (long long)(r + u) * ss, buf[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u < r1) {
        V o[L];
#pragma unroll
        for (int q = 0; q < L; ++q) {
          win[K - 1][q] = buf[u][q];
          // the taps in order from zero, then the bias
          V acc = ln::zero();
#pragma unroll
          for (int i = 0; i < K; ++i)
            acc = ln::add(acc, ln::mul(win[i][q], wk[i][q]));
          o[q] = ln::act(ln::add(acc, bs[q]));
        }
        ln::store(ob + (long long)(r + u) * C, o);
#pragma unroll
        for (int j = 0; j < K - 1; ++j)
#pragma unroll
          for (int q = 0; q < L; ++q) win[j][q] = win[j + 1][q];
      }
    }
  }
}

template <typename T, int K>
const void* body(int vector) {
  return vector
      ? reinterpret_cast<const void*>(&causal_conv_kernel<T, K, 16 / sizeof(T)>)
      : reinterpret_cast<const void*>(&causal_conv_kernel<T, K, 1>);
}

template <typename T>
const void* body_of(int K, int vector) {
  switch (K) {
    case 1: return body<T, 1>(vector);
    case 2: return body<T, 2>(vector);
    case 3: return body<T, 3>(vector);
    default: return body<T, 4>(vector);
  }
}

template <typename T, int K>
void launch(const void* x, long long sb, long long ss, const void* w,
            const void* bias, void* out, int S, int C, int tile, int ntiles,
            long long items, int vector, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  const unsigned blocks = (unsigned)((items + THREADS - 1) / THREADS);
  if (vector)
    causal_conv_kernel<T, K, 16 / sizeof(T)><<<blocks, THREADS, 0, stream>>>(
        xt, sb, ss, wt, bt, ot, S, C, tile, ntiles, items);
  else
    causal_conv_kernel<T, K, 1><<<blocks, THREADS, 0, stream>>>(
        xt, sb, ss, wt, bt, ot, S, C, tile, ntiles, items);
}

template <typename T>
void launch_k(int K, const void* x, long long sb, long long ss, const void* w,
              const void* bias, void* out, int S, int C, int tile, int ntiles,
              long long items, int vector, cudaStream_t stream) {
  switch (K) {
    case 1: launch<T, 1>(x, sb, ss, w, bias, out, S, C, tile, ntiles, items, vector, stream); break;
    case 2: launch<T, 2>(x, sb, ss, w, bias, out, S, C, tile, ntiles, items, vector, stream); break;
    case 3: launch<T, 3>(x, sb, ss, w, bias, out, S, C, tile, ntiles, items, vector, stream); break;
    default: launch<T, 4>(x, sb, ss, w, bias, out, S, C, tile, ntiles, items, vector, stream); break;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" int causal_conv(const void* x, long long sb, long long ss,
                           const void* w, const void* bias, void* out, int B,
                           int S, int C, int K, int dtype, int tile, int vector,
                           void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || K < 1 || K > MAX_K || tile <= 0
      || (dtype != 0 && dtype != 1) || sb < 0 || ss < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long size = dtype == 0 ? 4 : 2;
  if (vector) {
    // the 16-byte body reads and writes whole 16-byte vectors of every row
    if ((C * size) % 16 || (B > 1 && (sb * size) % 16)
        || (S > 1 && (ss * size) % 16) || !aligned16(x) || !aligned16(w)
        || !aligned16(bias) || !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = (S + tile - 1) / tile;
  const long long per_row = vector ? C / (16 / size) : C;
  const long long items = (long long)B * ntiles * per_row;
  if ((items + THREADS - 1) / THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_k<float>(K, x, sb, ss, w, bias, out, S, C, tile, ntiles, items, vector, s);
  else
    launch_k<__nv_bfloat16>(K, x, sb, ss, w, bias, out, S, C, tile, ntiles, items, vector, s);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one body resident on the current card at once (blocks an SM
// times SMs, from the occupancy the runtime reports).
extern "C" int causal_conv_resident(int K, int dtype, int vector, int* out) {
  if (K < 1 || K > MAX_K || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fn = dtype == 0 ? body_of<float>(K, vector)
                              : body_of<__nv_bfloat16>(K, vector);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, THREADS, 0);
  *out = per * sms;
  return static_cast<int>(err);
}
