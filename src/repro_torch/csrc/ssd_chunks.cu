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
// What bounds it on an H100: a Mamba2 prefill of mamba2-1.3b (4 x 2048
// tokens, 64 heads, L=256, P=64, N=128) needs 17.5 GFLOP (the causal
// triangles, C B^T once per group) on 277 MB of inputs and outputs: 0.018
// ms at the bf16 tensor-core peak (989 TFLOP/s), 0.083 ms at 3.35 TB/s,
// 0.26 ms at the fp32 CUDA-core peak (67 TFLOP/s). So bf16 inputs, which
// can use the tensor cores, are bound by bytes, and fp32 inputs on the
// CUDA cores by operations. Two bodies, chosen by dtype:
//
// * bf16 (the main path: Mamba2 prefills in bf16): ssd_chunks_kernel_mma,
//   the flash-attention shape with Q = C, K = B, V = x and the softmax
//   replaced by the decay. One block of four warps per (batch*head,
//   chunk); each warp owns 16 rows of a 64-row t tile. For each t tile,
//   C is held in registers as mma A fragments (ldmatrix), and the 64-row
//   s tiles of B and x at or below the diagonal stream through shared
//   memory (cp.async double buffering; rows padded by 16 bytes so that
//   ldmatrix is conflict-free; zero-padded to multiples of 16 in L, P, N).
//   S = C B^T runs on mma.sync.m16n8k16 (bf16 operands, fp32 sums; the
//   products of bf16 values are exact). M = S * exp(cum[t] - cum[s]) *
//   dt[s] is formed on the C fragments in registers, selected to 0 where
//   s > t, then split into two bf16 halves, M = M_hi + M_lo, and
//   y += M_hi x + M_lo x reuses the fragments as A operands with x read by
//   ldmatrix.trans: one bf16 rounding of M would put ~2^-9 of each term
//   into y, beyond the reference's 1e-4 * |y|max bound; the split keeps it
//   near 2^-17. On the diagonal tile a warp skips the 16-column steps that
//   lie wholly above its rows. Below the diagonal tile the decay factors
//   through the s tile's last row e: exp(cum[t] - cum[e]) per row times a
//   column factor exp(cum[e] - cum[s]) * dt[s] computed once per block,
//   both at most 1, so a thread takes 2 exps per tile instead of 32 (a
//   few ulps from the twin's exp of the difference; the select stays on
//   the diagonal tile). The state is a second pass over the s
//   tiles: states = (x * w)^T B as an mma with (x * w)^T (ldmatrix.trans,
//   scaled in fp32 and split hi + lo) as A and B (ldmatrix.trans) as B.
//   The body is held to 128 registers (__launch_bounds__(128, 4), no
//   spills) so that four blocks share an SM: left to 166 registers, it
//   fits three and runs slower. Times: PERF.md (chip_smoke.py phase 2).
// * fp32: ssd_chunks_kernel, fp32 FMAs on the CUDA cores (67 TFLOP/s):
//   M = (C B^T) * decay * dt goes to shared memory (s-major) and y += M x
//   accumulates in registers, 4 t x 4 p per thread (C and B transposed,
//   n-major, so a thread's 4x4 micro tile reads consecutive words); the
//   boundary state is a second pass over the s tiles with B in its
//   natural layout, 4 p x 8 n per thread, the weights exp(cum[L-1] - cum)
//   * dt folded into x as it is loaded.
//
// Both:
//
// * cum is summed in float64 by a block-wide scan and rounded once to fp32.
//   cum is differenced and then exponentiated, so the order of an fp32 sum
//   would show in the output; summed in float64 it does not depend on the
//   order, and the plain twin (torch.cumsum in float64) gets the same fp32
//   values.
// * Tiles of s above the diagonal are skipped, which is exact. The decay
//   is a select, never a product with a mask: above the diagonal
//   exp(cum[t] - cum[s]) overflows to inf at realistic dt, and inf * 0 is
//   NaN.
//
// Shapes taken: P <= 64, N <= 128 (every configuration of the repository:
// mamba2-1.3b P=64, N=128; zamba2-1.2b P=64, N=64); any L whose shared
// memory fits (3L floats beside the tiles: ~100 KB fp32, ~53 KB bf16).
// The bf16 body loads rows with 16-byte cp.async when N and P are
// multiples of 8, element by element otherwise.
//
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// cum = fp32(inclusive prefix sums of fp32(dt * a), taken in float64), by
// a block of NT threads; s_wsum holds NT / 32 doubles
template <int NT>
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int L,
                             float* s_dt, float* s_cum, double* s_wsum) {
  constexpr int THREADS = NT, WARPS = NT / 32;
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

  chunk_cumsum<THREADS>(dt + cell * L, a[bh], L, s_dt, s_cum, s_wsum);
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

// ---------------------------------------------------------------------------
// bf16 body: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps, 16 rows of t (or of p) each
constexpr int TC_PAD = 8;         // bf16 elements of padding per smem row
constexpr int KN_MAX = MAX_N / 16, KP_MAX = MAX_P / 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x = hi + lo, both bf16 pairs: hi the rounded value, lo its remainder
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// rows [r0, r0 + TILE) of src [L, W] into dst [TILE][WP + TC_PAD], zero
// beyond L and W; WP = round16(W). vec: W is a multiple of 8, so every
// 16-byte chunk of a row lies wholly inside or outside it (cp.async, zero
// filled outside); otherwise element by element.
__device__ __forceinline__ void load_tile_bf16(const __nv_bfloat16* __restrict__ src,
                                               int r0, int L, int W, bool vec,
                                               __nv_bfloat16* dst) {
  const int WP = round16(W), ld = WP + TC_PAD;
  if (vec) {
    const int ch = WP / 8;
    for (int i = threadIdx.x; i < TILE * ch; i += TC_THREADS) {
      const int r = i / ch, c = (i - r * ch) * 8;
      const bool ok = r0 + r < L && c < W;
      cp_async16(smem_u32(dst + r * ld + c),
                 ok ? src + (size_t)(r0 + r) * W + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * WP; i += TC_THREADS) {
      const int r = i / WP, c = i - r * WP;
      dst[r * ld + c] = (r0 + r < L && c < W) ? src[(size_t)(r0 + r) * W + c]
                                              : __float2bfloat16(0.f);
    }
  }
}

// the scan's warp sums, then cum, dt and w; the tiles start 16-byte aligned
__host__ __device__ size_t head_bytes_mma(int L) {
  const size_t bytes = (TC_THREADS / 32) * sizeof(double) + 3 * (size_t)L * sizeof(float);
  return (bytes + 15) & ~(size_t)15;
}

size_t smem_bytes_mma(int L, int P, int N) {
  const size_t tiles = 2 * (size_t)TILE * (round16(N) + TC_PAD)    // B, 2 stages
                       + 2 * (size_t)TILE * (round16(P) + TC_PAD); // x, 2 stages
  return head_bytes_mma(L) + tiles * sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(TC_THREADS, 4)
ssd_chunks_kernel_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                      const __nv_bfloat16* __restrict__ c, float* __restrict__ y,
                      float* __restrict__ states, float* __restrict__ expcum,
                      int NC, int L, int P, int N, int nheads, int ngroups) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  double* s_wsum = reinterpret_cast<double*>(smem_raw);
  float* s_cum = reinterpret_cast<float*>(smem_raw + (TC_THREADS / 32) * sizeof(double));
  float* s_dt = s_cum + L;
  float* s_w = s_dt + L;
  const size_t head = head_bytes_mma(L);
  const int NP = round16(N), PP = round16(P), ldn = NP + TC_PAD, ldp = PP + TC_PAD;
  const int kn = NP / 16, kp = PP / 16;
  __nv_bfloat16* buf_b = reinterpret_cast<__nv_bfloat16*>(smem_raw + head);  // 2 stages
  __nv_bfloat16* buf_x = buf_b + 2 * TILE * ldn;                             // 2 stages
  __nv_bfloat16* buf_c = buf_b + TILE * ldn;       // C tile: B's stage 1, before the s loop

  const int bh = blockIdx.x / NC, ch = blockIdx.x - bh * NC;
  const int row = (bh / nheads) * ngroups + (bh % nheads) / (nheads / ngroups);
  const size_t cell = (size_t)bh * NC + ch;
  const __nv_bfloat16* X = x + cell * L * P;
  const __nv_bfloat16* B = b + ((size_t)row * NC + ch) * L * N;
  const __nv_bfloat16* C = c + ((size_t)row * NC + ch) * L * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool vec_n = N % 8 == 0 && ((reinterpret_cast<uintptr_t>(b) |
                                      reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  const bool vec_p = P % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  chunk_cumsum<TC_THREADS>(dt + cell * L, a[bh], L, s_dt, s_cum, s_wsum);
  // during the y pass s_w holds each column's factor to the last row of
  // its s tile, exp(cum[e] - cum[s]) * dt[s], e = min(s | 63, L - 1)
  float* s_cf = s_w;
  for (int i = tid; i < L; i += TC_THREADS) {
    expcum[cell * L + i] = expf(s_cum[i]);
    s_cf[i] = __fmul_rn(expf(s_cum[min(i | (TILE - 1), L - 1)] - s_cum[i]), s_dt[i]);
  }

  auto load_bx = [&](int s0, int st) {
    load_tile_bf16(B, s0, L, N, vec_n, buf_b + st * TILE * ldn);
    load_tile_bf16(X, s0, L, P, vec_p, buf_x + st * TILE * ldp);
  };

  // ---- intra-chunk output y, 64 rows of t at a time
  const int n_tiles = (L + TILE - 1) / TILE;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int t0 = tt * TILE;
    const int tr[2] = {t0 + warp * 16 + g, t0 + warp * 16 + g + 8};
    float cum_t[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) cum_t[e] = tr[e] < L ? s_cum[tr[e]] : 0.f;

    __syncthreads();                           // every buffer is free
    load_tile_bf16(C, t0, L, N, vec_n, buf_c);
    load_bx(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // C as mma A fragments: cf[kk] = rows warp*16.., columns kk*16..
    uint32_t cf[KN_MAX][4];
#pragma unroll
    for (int kk = 0; kk < KN_MAX; ++kk) {
      if (kk < kn)
        ldmatrix_x4(cf[kk], smem_u32(buf_c + (warp * 16 + (lane & 15)) * ldn +
                                     kk * 16 + (lane >> 4) * 8));
    }
    __syncthreads();                           // buf_c is B's stage 1 again

    float o[KP_MAX * 2][4];
#pragma unroll
    for (int j = 0; j < KP_MAX * 2; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    for (int st = 0; st <= tt; ++st) {
      const int s0 = st * TILE, stage = st & 1;
      if (st < tt) load_bx(s0 + TILE, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* bs = buf_b + stage * TILE * ldn;
      const __nv_bfloat16* xs = buf_x + stage * TILE * ldp;
      // 16-column steps of s that reach this warp's rows
      const int jmax = st == tt ? warp + 1 : TILE / 16;

      // S = C B^T for 16 rows x 64 columns of s: sc[j] holds columns j*8..
      float sc[TILE / 8][4];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN_MAX; ++kk) {
        if (kk >= kn) break;
#pragma unroll
        for (int jj = 0; jj < TILE / 16; ++jj) {
          if (jj >= jmax) break;
          uint32_t bk[4];
          const int sr = jj * 16 + (lane & 7) + (lane >> 4) * 8;
          const int nc = kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bk, smem_u32(bs + sr * ldn + nc));
          mma_bf16(sc[2 * jj], cf[kk], bk[0], bk[1]);
          mma_bf16(sc[2 * jj + 1], cf[kk], bk[2], bk[3]);
        }
      }

      // M = S * exp(cum[t] - cum[s]) * dt[s], selected to 0 where s > t.
      // Below the diagonal tile (t > e >= s, e the s tile's last row) the
      // decay factors exactly as exp(cum[t] - cum[e]) * exp(cum[e] -
      // cum[s]), both at most 1: a row factor per t and the column
      // factors of s_cf (a few ulps from the twin's exp of the difference)
      if (st < tt) {
        float rf[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rf[e] = tr[e] < L ? expf(cum_t[e] - s_cum[s0 + TILE - 1]) : 0.f;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sc[j][i] = __fmul_rn(__fmul_rn(sc[j][i], rf[i >> 1]), s_cf[s0 + j * 8 + c2 + (i & 1)]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i >> 1, t = tr[e], s = s0 + j * 8 + c2 + (i & 1);
            float m = 0.f;
            if (s <= t && t < L)
              m = __fmul_rn(__fmul_rn(sc[j][i], expf(cum_t[e] - s_cum[s])), s_dt[s]);
            sc[j][i] = m;
          }
        }
      }

      // y += (M_hi + M_lo) x, 16 columns of s per step
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (kk >= jmax) break;
        uint32_t mh[4], ml[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], mh[0], ml[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], mh[1], ml[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], mh[2], ml[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], mh[3], ml[3]);
#pragma unroll
        for (int jd = 0; jd < KP_MAX; ++jd) {
          if (jd >= kp) break;
          uint32_t bv[4];
          const int sr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int pc = jd * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bv, smem_u32(xs + sr * ldp + pc));
          mma_bf16(o[2 * jd], mh, bv[0], bv[1]);
          mma_bf16(o[2 * jd], ml, bv[0], bv[1]);
          mma_bf16(o[2 * jd + 1], mh, bv[2], bv[3]);
          mma_bf16(o[2 * jd + 1], ml, bv[2], bv[3]);
        }
      }
      __syncthreads();                         // stage is refilled next
    }

    // o[j] = {(row g, p), (row g, p+1), (row g+8, p), (row g+8, p+1)}, p = j*8 + c2
#pragma unroll
    for (int j = 0; j < KP_MAX * 2; ++j) {
      const int p = j * 8 + c2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (tr[e] >= L) continue;
        float* dst = y + (cell * L + tr[e]) * P + p;
        if (p + 1 < P && (P & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(o[j][2 * e], o[j][2 * e + 1]);
        } else {
          if (p < P) dst[0] = o[j][2 * e];
          if (p + 1 < P) dst[1] = o[j][2 * e + 1];
        }
      }
    }
  }

  // ---- boundary state: states[p, n] = sum_s (x[s, p] * w[s]) B[s, n];
  // warp w owns rows p = 16w.. (A = (x * w)^T), 16 columns of s per step
  const bool has_rows = warp * 16 < P;
  float sa[KN_MAX * 2][4];
#pragma unroll
  for (int j = 0; j < KN_MAX * 2; ++j) sa[j][0] = sa[j][1] = sa[j][2] = sa[j][3] = 0.f;
  __syncthreads();                             // every buffer is free
  for (int i = tid; i < L; i += TC_THREADS)
    s_w[i] = __fmul_rn(expf(s_cum[L - 1] - s_cum[i]), s_dt[i]);
  load_bx(0, 0);
  cp_async_commit();
  for (int st = 0; st < n_tiles; ++st) {
    const int s0 = st * TILE, stage = st & 1;
    if (st + 1 < n_tiles) load_bx(s0 + TILE, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* bs = buf_b + stage * TILE * ldn;
    const __nv_bfloat16* xs = buf_x + stage * TILE * ldp;
    if (has_rows) {
#pragma unroll
      for (int ks = 0; ks < TILE / 16; ++ks) {
        // A fragment: a[m] = (p = g + (m&1)*8, s = ks*16 + (m>>1)*8 + c2, +1)
        uint32_t xa[4], ah[4], al[4];
        const int sr = ks * 16 + (lane & 7) + (lane >> 4) * 8;
        const int pc = warp * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(xa, smem_u32(xs + sr * ldp + pc));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int s = s0 + ks * 16 + (m >> 1) * 8 + c2;
          const float2 xv = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xa[m]));
          const float w0 = s < L ? s_w[s] : 0.f, w1 = s + 1 < L ? s_w[s + 1] : 0.f;
          split_bf16(__fmul_rn(xv.x, w0), __fmul_rn(xv.y, w1), ah[m], al[m]);
        }
#pragma unroll
        for (int jn = 0; jn < KN_MAX; ++jn) {
          if (jn >= kn) break;
          uint32_t bv[4];
          const int br = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int nc = jn * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bv, smem_u32(bs + br * ldn + nc));
          mma_bf16(sa[2 * jn], ah, bv[0], bv[1]);
          mma_bf16(sa[2 * jn], al, bv[0], bv[1]);
          mma_bf16(sa[2 * jn + 1], ah, bv[2], bv[3]);
          mma_bf16(sa[2 * jn + 1], al, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                           // stage is refilled next
  }
  if (has_rows) {
#pragma unroll
    for (int j = 0; j < KN_MAX * 2; ++j) {
      const int n = j * 8 + c2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = warp * 16 + g + 8 * e;
        if (p >= P) continue;
        float* dst = states + (cell * P + p) * N + n;
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(sa[j][2 * e], sa[j][2 * e + 1]);
        } else {
          if (n < N) dst[0] = sa[j][2 * e];
          if (n + 1 < N) dst[1] = sa[j][2 * e + 1];
        }
      }
    }
  }
}

template <typename T>
using Body = void (*)(const T*, const float*, const float*, const T*, const T*,
                      float*, float*, float*, int, int, int, int, int, int);

template <typename T>
int launch(Body<T> kernel, int threads, size_t smem, const void* x,
           const void* dt, const void* a, const void* b, const void* c,
           void* y, void* states, void* expcum, int BH, int NC, int L, int P,
           int N, int nheads, int ngroups, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)((size_t)BH * NC), threads, smem, stream>>>(
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
      return launch<float>(ssd_chunks_kernel<float>, THREADS,
                           smem_bytes(L, P, N), x, dt, a, b, c, y, states,
                           expcum, BH, NC, L, P, N, nheads, ngroups, s);
    case 1:
      return launch<__nv_bfloat16>(ssd_chunks_kernel_mma, TC_THREADS,
                                   smem_bytes_mma(L, P, N), x, dt, a, b, c, y,
                                   states, expcum, BH, NC, L, P, N, nheads,
                                   ngroups, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
