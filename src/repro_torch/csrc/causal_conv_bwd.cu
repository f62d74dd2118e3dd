// Backward of the Mamba2 layer's causal conv (csrc/causal_conv.cu):
//
//   pre[b, t, c] = sum_{i<K} w[i, c] * x[b, t - (K-1-i), c] + bias[c]
//   dp[b, t, c]  = g[b, t, c] * silu'(pre[b, t, c])
//   dx[b, t, c]  = sum_{i<K} dp[b, t + (K-1-i), c] * w[i, c]   (rows < S)
//   dw[i, c]     = sum_{b, t} dp[b, t, c] * x[b, t - (K-1-i), c]
//   dbias[c]     = sum_{b, t} dp[b, t, c]
//
//   x [B,S,C] at batch stride sb and row stride ss (the forward's strided
//   view, channels contiguous); w [K,C]; bias [C]; g, dx [B,S,C]
//   contiguous; part [B * ntiles, K + 1, C] fp32 scratch.
//
// A new kernel, as its forward: the reference trains through jnp autodiff
// of its plain _causal_conv (src/repro/models/ssm.py:61). It saves nothing
// of the forward but its inputs: the pre-activation is recomputed from x
// in the forward's rounding and instructions (each product and partial sum
// rounded to the activation type, then the bias; packed bf16x2 in bf16),
// SiLU' taken in fp32 as PyTorch's silu_backward takes it, dx summed over
// the K taps in fp32 within each batch row and rounded once to x's type.
//
// What bounds it on an H100: bytes. x and g read, dx written (plus K-1
// halo rows of x on each side of a tile and of g after it), against some
// 6K arithmetic operations an element. Two launches behind one entry:
//
// - causal_conv_bwd_kernel<T, K, N>: a thread owns N channels (4, in 8 or
//   16 bytes; or 1 for the generic body: any width, stride or pointer) of
//   one batch row over a tile of rows, walks down time keeping the last
//   K-1 inputs and the last K-1 dp in registers, emits dx of row t-(K-1)
//   once dp of row t is known, and keeps its tile's partial sums of dw and
//   dbias in fp32 registers, written once to part.
// - causal_conv_bwd_sum_kernel<T>: one thread a (tap or bias, channel)
//   sums the tiles' partials in tile order and rounds once to the
//   parameter type. No atomics: the result is the same bits every call.
//
// dtype: 0 = float32, 1 = bfloat16. vector: 1 = the 4-channel body (rows on
// 16-byte boundaries).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 4;        // rows whose loads are issued together
constexpr int MAX_K = 4;
constexpr int VB = 4;       // channels a thread in the vector body

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// g * silu'(x), as PyTorch's silu_backward computes it in fp32.
__device__ __forceinline__ float silu_grad(float g, float x) {
  const float s = 1.f / (1.f + expf(-x));
  return g * s * (1.f + x * (1.f - s));
}

// The forward's arithmetic of the taps on a thread's N channels, held in L
// lanes of type V (csrc/causal_conv.cu's Lanes): in fp32 a lane a channel;
// in bf16 a lane a 32-bit word of two channels, multiplied and added by
// the bf16x2 instructions with round-to-nearest (the forward's rounding);
// N = 1 keeps its one bf16 channel in a word's low half. ``floats`` gives
// the N channels in fp32 (exact), ``store`` rounds N fp32 values to T.
template <typename T, int N> struct Lanes;

template <int N> struct Lanes<float, N> {
  static constexpr int L = N;
  using V = float;
  static __device__ __forceinline__ V zero() { return 0.f; }
  static __device__ __forceinline__ V mul(V a, V b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ V add(V a, V b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ void floats(const V* v, float* f) {
#pragma unroll
    for (int c = 0; c < N; ++c) f[c] = v[c];
  }
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
  static __device__ __forceinline__ void store(float* p, const float* f) {
    if constexpr (N == 1)
      *p = f[0];
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(
          __float_as_uint(f[0]), __float_as_uint(f[1]),
          __float_as_uint(f[2]), __float_as_uint(f[3]));
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
  // bf16 -> fp32 is exact: the 16 bits become the high half of the float
  static __device__ __forceinline__ void floats(const V* v, float* f) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      f[c] = __uint_as_float(c % 2 ? v[c / 2] & 0xffff0000u : v[c / 2] << 16);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, V* v) {
    if constexpr (N == 1) {
      v[0] = *reinterpret_cast<const unsigned short*>(p);
    } else {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = r.x;
      v[1] = r.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    if constexpr (N == 1) {
      *p = __float2bfloat16_rn(f[0]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
      *reinterpret_cast<uint2*>(p) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&lo),
          *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
};

template <typename T, int K, int N>
__global__ void __launch_bounds__(THREADS)
causal_conv_bwd_kernel(const T* __restrict__ x, long long sb, long long ss,
                       const T* __restrict__ w, const T* __restrict__ bias,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ part, int S, int C, int tile,
                       int ntiles, long long items) {
  using ln = Lanes<T, N>;
  using V = typename ln::V;
  constexpr int L = ln::L;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= items) return;
  const int nv = C / N;
  const int c0 = (int)(item % nv) * N;
  const long long rest = item / nv;           // b * ntiles + tile index
  const int r0 = (int)(rest % ntiles) * tile;
  const int b = (int)(rest / ntiles);
  const int r1 = min(r0 + tile, S);
  // dp is needed up to row r1 + K - 2 (dx of the tile's last row); rows
  // from S on have none
  const int tend = min(r1 + K - 1, S);

  V wk[K][L], bs[L];
  float wf[K][N];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    ln::load(w + (size_t)i * C + c0, wk[i]);
    ln::floats(wk[i], wf[i]);
  }
  ln::load(bias + c0, bs);

  // rows r-K+1 .. r of x as lanes (xw, for the pre-activation) and in fp32
  // (xf, for dw); dp of rows r-K+1 .. r (dpw); the tile's dw and dbias
  const T* xb = x + (long long)b * sb + c0;
  const T* gb = g + (long long)b * S * C + c0;
  T* dxb = dx + (long long)b * S * C + c0;
  V xw[K][L];
  float xf[K][N], dpw[K][N], accw[K][N], accb[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    accb[c] = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) dpw[i][c] = accw[i][c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int r = r0 - (K - 1) + j;
    if (r >= 0) {
      ln::load(xb + (long long)r * ss, xw[j]);
    } else {
#pragma unroll
      for (int q = 0; q < L; ++q) xw[j][q] = ln::zero();
    }
    ln::floats(xw[j], xf[j]);
  }

  // dx of row r-(K-1), once dp of row r is in dpw[K-1], when it lies in the
  // tile: dp of rows r, r-1, .., r-K+1 times w[0], w[1], .., w[K-1], in fp32
  auto emit = [&](int r) {
    if (r - (K - 1) < r0) return;
    float o[N];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
        acc = __fadd_rn(acc, __fmul_rn(dpw[K - 1 - i][c], wf[i][c]));
      o[c] = acc;
    }
    ln::store(dxb + (long long)(r - (K - 1)) * C, o);
  };
  auto shift = [&]() {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
#pragma unroll
      for (int q = 0; q < L; ++q) xw[j][q] = xw[j + 1][q];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        xf[j][c] = xf[j + 1][c];
        dpw[j][c] = dpw[j + 1][c];
      }
    }
  };

  for (int r = r0; r < tend; r += U) {
    V xr[U][L], gr[U][L];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u < tend) {
        ln::load(xb + (long long)(r + u) * ss, xr[u]);
        ln::load(gb + (long long)(r + u) * C, gr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u < tend) {
        V pre[L];
#pragma unroll
        for (int q = 0; q < L; ++q) {
          xw[K - 1][q] = xr[u][q];
          V acc = ln::zero();
#pragma unroll
          for (int i = 0; i < K; ++i)
            acc = ln::add(acc, ln::mul(xw[i][q], wk[i][q]));
          pre[q] = ln::add(acc, bs[q]);
        }
        float pf[N], gf[N];
        ln::floats(xw[K - 1], xf[K - 1]);
        ln::floats(pre, pf);
        ln::floats(gr[u], gf);
        const bool own = r + u < r1;          // the tile's own row: dw, dbias
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float dp = silu_grad(gf[c], pf[c]);
          dpw[K - 1][c] = dp;
          if (own) {
#pragma unroll
            for (int i = 0; i < K; ++i)
              accw[i][c] = __fadd_rn(accw[i][c], __fmul_rn(dp, xf[i][c]));
            accb[c] = __fadd_rn(accb[c], dp);
          }
        }
        emit(r + u);
        shift();
      }
    }
  }
  // the tile's last rows whose later taps fall past S: those dp are zero
  for (int r = tend; r < r1 + K - 1; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) dpw[K - 1][c] = 0.f;
    emit(r);
    shift();
  }

  float* pb = part + (size_t)rest * (K + 1) * C + c0;
#pragma unroll
  for (int i = 0; i <= K; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c)
      pb[(size_t)i * C + c] = i < K ? accw[i][c] : accb[c];
}

// dw[j, c] (j < K) and dbias[c] (j = K): the P tiles' partials summed in
// tile order, rounded once.
template <typename T>
__global__ void __launch_bounds__(THREADS)
causal_conv_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dw,
                           T* __restrict__ dbias, int P, int K, int C) {
  const int j = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const float* p = part + (size_t)j * C + c;
  const size_t step = (size_t)(K + 1) * C;
  float acc = 0.f;
#pragma unroll 8
  for (int q = 0; q < P; ++q) acc = __fadd_rn(acc, p[(size_t)q * step]);
  (j < K ? dw + (size_t)j * C : dbias)[c] = from_f<T>(acc);
}

template <typename T, int K>
const void* body(int vector) {
  return vector ? reinterpret_cast<const void*>(&causal_conv_bwd_kernel<T, K, VB>)
                : reinterpret_cast<const void*>(&causal_conv_bwd_kernel<T, K, 1>);
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

struct Args {
  const void *x, *w, *bias, *g;
  void *dx, *dw, *db;
  float* part;
  long long sb, ss, items;
  int B, S, C, K, tile, ntiles, vector;
};

template <typename T, int K>
void launch(const Args& a, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.bias);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const unsigned blocks = (unsigned)((a.items + THREADS - 1) / THREADS);
  if (a.vector)
    causal_conv_bwd_kernel<T, K, VB><<<blocks, THREADS, 0, stream>>>(
        x, a.sb, a.ss, w, bias, g, dx, a.part, a.S, a.C, a.tile, a.ntiles,
        a.items);
  else
    causal_conv_bwd_kernel<T, K, 1><<<blocks, THREADS, 0, stream>>>(
        x, a.sb, a.ss, w, bias, g, dx, a.part, a.S, a.C, a.tile, a.ntiles,
        a.items);
  dim3 grid((a.C + THREADS - 1) / THREADS, K + 1);
  causal_conv_bwd_sum_kernel<T><<<grid, THREADS, 0, stream>>>(
      a.part, static_cast<T*>(a.dw), static_cast<T*>(a.db), a.B * a.ntiles,
      K, a.C);
}

template <typename T>
void launch_k(const Args& a, cudaStream_t stream) {
  switch (a.K) {
    case 1: launch<T, 1>(a, stream); break;
    case 2: launch<T, 2>(a, stream); break;
    case 3: launch<T, 3>(a, stream); break;
    default: launch<T, 4>(a, stream); break;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" int causal_conv_bwd(const void* x, long long sb, long long ss,
                               const void* w, const void* bias, const void* g,
                               void* dx, void* dw, void* db, void* part, int B,
                               int S, int C, int K, int dtype, int tile,
                               int vector, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || K < 1 || K > MAX_K || tile <= 0
      || (dtype != 0 && dtype != 1) || sb < 0 || ss < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long size = dtype == 0 ? 4 : 2;
  if (vector) {
    // the vector body reads and writes whole 4-channel vectors of every
    // row; it is chosen for rows on 16-byte boundaries
    if ((C * size) % 16 || (B > 1 && (sb * size) % 16)
        || (S > 1 && (ss * size) % 16) || !aligned16(x) || !aligned16(w)
        || !aligned16(bias) || !aligned16(g) || !aligned16(dx))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{x, w, bias, g, dx, dw, db, static_cast<float*>(part), sb, ss, 0,
         B, S, C, K, tile, (S + tile - 1) / tile, vector};
  a.items = (long long)B * a.ntiles * (vector ? C / VB : C);
  if ((a.items + THREADS - 1) / THREADS > 0x7fffffffLL
      || (long long)B * a.ntiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_k<float>(a, s);
  else
    launch_k<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the main pass's body resident on the current card at once
// (blocks an SM times SMs, from the occupancy the runtime reports).
extern "C" int causal_conv_bwd_resident(int K, int dtype, int vector, int* out) {
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
