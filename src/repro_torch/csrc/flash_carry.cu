// One online-softmax attention pass that folds a K/V block into carried
// fp32 state (m, l, acc): one systolic ring hop of prefill or decode
// attention is one launch.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_carry (body _flash_kernel).
//
// Layouts (element strides; the last dimension is contiguous):
//   q        [B', Sq, H, D]       strides q_sb, q_ss, q_sh       fp32 | bf16
//   k, v     [Bk, T, Kv, D]       strides kv_sb, kv_st, kv_sh    fp32 | bf16
//   kv_row   [B']  int32: which K/V row query row b' reads (lets the ring
//            decode read its resident cache shard in place)
//   q_off, k_off, klen [B'] int32: query i sits at q_off+i, key j at
//            k_off+j, and key j counts only if k_off+j < klen (per row,
//            since the emulated ring folds the PE axis into B')
//   m, l     [B', H, Sq] fp32 contiguous; acc [B', H, Sq, D] fp32 contiguous
// Query head h reads KV head h / (H / Kv) (native GQA, no repeat).
// Masked scores take the finite sentinel -1e30, exactly as the reference:
// a fully masked block then adds exp(0) per key to a row still at the
// sentinel, and the first real block's rescale exp(-1e30 - m) == 0 erases
// it. normalize=1 writes acc / max(l, 1e-30) in the output type instead of
// acc (m and l are written in both forms).
//
// What bounds it on an H100: a decode hop (Sq = 1, two query heads per KV
// head) does ~1 operation per K/V byte, far below the card's balance of
// ~295, so it is bound by the bytes of K and V; a prefill hop (64 queries
// per 64 keys) does ~64 per byte, still below the balance. The design
// therefore reads each K/V tile once for all query heads that share it
// (one block per (row b', KV head, tile of 16 flattened (group, position)
// query rows)), keeps the softmax state in registers and shared memory so
// it never leaves the SM between tiles, and skips a K/V tile outright when
// every key in it is masked for every row and every row already holds a
// real running max (only then is the skip exact), which keeps decode from
// reading cache slots past the rows' positions. Scores and P@V run as fp32
// FMAs on the CUDA cores; wgmma and TMA are later work.
//
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;        // flattened (group, position) query rows per block
constexpr int BKV = 32;       // keys per shared-memory tile (one per lane)
constexpr int DMAX = 128;     // head_dim limit: one thread per output column
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TQ, typename TKV, typename TO>
__global__ void __launch_bounds__(THREADS)
flash_carry_kernel(const TQ* __restrict__ q, long long q_sb, long long q_ss,
                   long long q_sh, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, long long kv_sb, long long kv_st,
                   long long kv_sh, const int* __restrict__ kv_row, int T,
                   const int* __restrict__ q_off, const int* __restrict__ k_off,
                   const int* __restrict__ klen, const float* __restrict__ m_in,
                   const float* __restrict__ l_in, const float* __restrict__ acc_in,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   TO* __restrict__ o_out, int H, int Kv, int Sq, int D,
                   int causal, int window, int normalize, float scale) {
  __shared__ float Qs[BQ][DMAX];
  __shared__ float Ks[BKV][DMAX + 1];   // +1: lanes read different rows
  __shared__ float Vs[BKV][DMAX];
  __shared__ float Ps[BQ][BKV];
  __shared__ float m_s[BQ], l_s[BQ], c_s[BQ];

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / Kv;
  const int rows = G * Sq;
  const int r0 = blockIdx.x * BQ;
  const int nr = min(BQ, rows - r0);    // valid rows in this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qo = q_off[b], ko = k_off[b], kl = klen[b];
  const long long kv_base = (long long)kv_row[b] * kv_sb + (long long)kvh * kv_sh;

  // query positions covered by this block (for the tile-skip test)
  int s_min = Sq, s_max = -1;
  for (int r = 0; r < nr; ++r) {
    const int s = (r0 + r) % Sq;
    s_min = min(s_min, s);
    s_max = max(s_max, s);
  }
  const int qpos_min = qo + s_min, qpos_max = qo + s_max;

  for (int idx = tid; idx < BQ * DMAX; idx += THREADS) {
    const int r = idx / DMAX, d = idx % DMAX;
    float val = 0.f;
    if (r < nr && d < D) {
      const int rr = r0 + r, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
      val = to_f(q[b * q_sb + s * q_ss + h * q_sh + d]);
    }
    Qs[r][d] = val;
  }
  if (tid < BQ) {
    float mv = NEG, lv = 0.f;
    if (tid < nr) {
      const int rr = r0 + tid, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
      const size_t si = ((size_t)b * H + h) * Sq + s;
      mv = m_in[si];
      lv = l_in[si];
    }
    m_s[tid] = mv;
    l_s[tid] = lv;
  }
  const int d = tid;                    // this thread's output column
  float acc[BQ];
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    acc[r] = 0.f;
    if (r < nr && d < D) {
      const int rr = r0 + r, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
      acc[r] = acc_in[(((size_t)b * H + h) * Sq + s) * D + d];
    }
  }
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += BKV) {
    const int nt = min(BKV, T - t0);
    const int kp_lo = ko + t0, kp_hi = ko + t0 + nt - 1;
    const bool dead = kp_lo >= kl || (causal && kp_lo > qpos_max) ||
                      (window > 0 && qpos_min - kp_hi >= window);
    if (dead) {
      bool fresh = false;               // a row still at the sentinel
      for (int r = 0; r < nr; ++r) fresh = fresh || !(m_s[r] > NEG);
      if (!fresh) continue;             // uniform across the block
    }

    {
      // 16-byte loads, all issued before any is stored, so one tile costs
      // one memory latency rather than one per element (the wrapper
      // guarantees 16-byte-aligned K/V rows)
      constexpr int VN = 16 / sizeof(TKV);
      constexpr int ITERS = BKV * DMAX / VN / THREADS;
      const int vpr = D / VN;               // vectors per key row
      uint4 kr[ITERS], vr[ITERS];
#pragma unroll
      for (int i = 0; i < ITERS; ++i) {
        const int idx = tid + i * THREADS, j = idx / vpr;
        if (j < nt) {
          const long long off = kv_base + (long long)(t0 + j) * kv_st +
                                (idx % vpr) * VN;
          kr[i] = *reinterpret_cast<const uint4*>(k + off);
          vr[i] = *reinterpret_cast<const uint4*>(v + off);
        }
      }
#pragma unroll
      for (int i = 0; i < ITERS; ++i) {
        const int idx = tid + i * THREADS, j = idx / vpr, c = (idx % vpr) * VN;
        if (j < nt) {
          const TKV* kp = reinterpret_cast<const TKV*>(&kr[i]);
          const TKV* vp = reinterpret_cast<const TKV*>(&vr[i]);
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            Ks[j][c + e] = to_f(kp[e]);
            Vs[j][c + e] = to_f(vp[e]);
          }
        }
      }
    }
    __syncthreads();

    // scores and the online-softmax update: warp w owns rows w, w+4, ...;
    // lane j owns key t0 + j
#pragma unroll
    for (int i = 0; i < BQ / WARPS; ++i) {
      const int r = warp + WARPS * i;
      if (r >= nr) break;                 // uniform across the warp
      float sc = -INFINITY;             // no key here: weight exactly 0
      if (lane < nt) {
        float dot = 0.f;
        for (int dd = 0; dd < D; ++dd) dot = fmaf(Qs[r][dd], Ks[lane][dd], dot);
        sc = dot * scale;
        const int qp = qo + (r0 + r) % Sq, kp = ko + t0 + lane;
        bool ok = kp < kl;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp < window);
        if (!ok) sc = NEG;
      }
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < nt ? expf(sc - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      Ps[r][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    if (d < D) {
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        if (r >= nr) break;
        float a = acc[r] * c_s[r];
        for (int j = 0; j < nt; ++j) a = fmaf(Ps[r][j], Vs[j][d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  if (tid < nr) {
    const int rr = r0 + tid, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
    const size_t si = ((size_t)b * H + h) * Sq + s;
    m_out[si] = m_s[tid];
    l_out[si] = l_s[tid];
  }
  if (d < D) {
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      if (r < nr) {
        const int rr = r0 + r, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
        const size_t si = ((size_t)b * H + h) * Sq + s;
        float val = acc[r];
        if (normalize) val = val / fmaxf(l_s[r], 1e-30f);
        o_out[si * D + d] = from_f<TO>(val);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  long long q_sb, q_ss, q_sh, kv_sb, kv_st, kv_sh;
  const int *kv_row, *q_off, *k_off, *klen;
  int T;
  const float *m_in, *l_in, *acc_in;
  float *m_out, *l_out;
  void* o_out;
  int Bp, H, Kv, Sq, D, causal, window, normalize;
  float scale;
};

template <typename TQ, typename TKV, typename TO>
void launch(const Args& a, cudaStream_t stream) {
  const int rows = (a.H / a.Kv) * a.Sq;
  dim3 grid((rows + BQ - 1) / BQ, a.Kv, a.Bp);
  flash_carry_kernel<TQ, TKV, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(a.q), a.q_sb, a.q_ss, a.q_sh,
      static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v), a.kv_sb,
      a.kv_st, a.kv_sh, a.kv_row, a.T, a.q_off, a.k_off, a.klen, a.m_in,
      a.l_in, a.acc_in, a.m_out, a.l_out, static_cast<TO*>(a.o_out), a.H,
      a.Kv, a.Sq, a.D, a.causal, a.window, a.normalize, a.scale);
}

template <typename TQ, typename TKV>
bool dispatch_out(const Args& a, int o_dtype, cudaStream_t s) {
  switch (o_dtype) {
    case 0: launch<TQ, TKV, float>(a, s); return true;
    case 1: launch<TQ, TKV, __nv_bfloat16>(a, s); return true;
  }
  return false;
}

template <typename TQ>
bool dispatch_kv(const Args& a, int kv_dtype, int o_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return dispatch_out<TQ, float>(a, o_dtype, s);
    case 1: return dispatch_out<TQ, __nv_bfloat16>(a, o_dtype, s);
  }
  return false;
}

}  // namespace

extern "C" int flash_carry(
    const void* q, long long q_sb, long long q_ss, long long q_sh, int q_dtype,
    const void* k, const void* v, long long kv_sb, long long kv_st,
    long long kv_sh, int kv_dtype, const int* kv_row, int T, const int* q_off,
    const int* k_off, const int* klen, const float* m_in, const float* l_in,
    const float* acc_in, float* m_out, float* l_out, void* o_out, int o_dtype,
    int Bp, int H, int Kv, int Sq, int D, int causal, int window, int normalize,
    float scale, void* stream) {
  if (Bp <= 0 || Sq <= 0 || T < 0 || Kv <= 0 || H % Kv != 0 || D <= 0 ||
      D > DMAX || (!normalize && o_dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // K/V rows are read as 16-byte vectors: they must start on 16 bytes
  const long long vn = kv_dtype == 0 ? 4 : 8;
  if (D % vn || kv_sb % vn || kv_st % vn || kv_sh % vn ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q, k, v, q_sb, q_ss, q_sh, kv_sb, kv_st, kv_sh, kv_row, q_off,
               k_off, klen, T, m_in, l_in, acc_in, m_out, l_out, o_out, Bp, H,
               Kv, Sq, D, causal, window, normalize, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (q_dtype) {
    case 0: ok = dispatch_kv<float>(a, kv_dtype, o_dtype, s); break;
    case 1: ok = dispatch_kv<__nv_bfloat16>(a, kv_dtype, o_dtype, s); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
