// The backward of the Mamba2 SSD intra-chunk pass (ssd_chunks.cu): the
// gradients in x, dt, a, B and C of (y, states, expcum) = ssd_chunks(x, dt,
// a, B, C) for the cotangents (gy, gS, gE).
//
// Replaces no Pallas kernel. The reference's Pallas SSD kernel
// (repro/kernels/ssd/kernel.py) has no VJP, so the reference trains through
// jnp autodiff of repro/models/ssm.py::ssd_chunked (:81), which XLA fuses;
// this kernel computes that gradient, so that no Mamba2 training step on
// the card differentiates the plain twin (whose [BH, NC, L, L] fp32
// temporaries are 537 MB each at zamba2-1.2b's prefill shape).
//
// Per head row and chunk, with B and C the rows of the head's group, cum
// the forward's cum, D[t, s] = exp(cum[t] - cum[s]) for s <= t (a select,
// 0 above the diagonal, where the exp overflows at realistic dt), CB =
// C B^T, M = CB * D * dt[s] and w[s] = exp(cum[L-1] - cum[s]) dt[s]:
//
//   dM  = tril(gy x^T)          Q = dM * M          dCB = dM * D * dt[s]
//   u   = B gS^T                v[s] = sum_p x[s, p] u[s, p]
//   dx  = M^T gy + w * u        dC = dCB B          dB = dCB^T C + w * (x gS)
//   dcum[t] = rowsum_t(Q) - colsum_t(Q) - v[t] w[t] + [t = L-1] sum_s v w
//             + gE[t] exp(cum[t])
//   R[s] = sum_{t >= s} dcum[t]
//   ddt[s] = sum_t dM CB D [t, s] + v[s] exp(cum[L-1] - cum[s]) + a R[s]
//   da = sum_chunks sum_s dt[s] R[s]
//
// (the closed form and its derivation: kernels/ssd/kernel.py,
// ssd_chunks_backward_plain). dB and dC of a group row sum the heads of
// the group.
//
// Layouts as in ssd_chunks.cu: x, gy, dx [BH,NC,L,P]; dt, gE, ddt
// [BH,NC,L]; a, da [BH]; B, C, dB, dC [BG,NC,L,N]; gS [BH,NC,P,N]. gy, gS
// and gE are fp32; dx, dB and dC take x's type, ddt and da fp32.
//
// Two passes, no float atomics (the gradients are bit-identical run to
// run):
// * pass A, one block per (head row, chunk): a sweep over s tiles (rows of
//   B and x) with an inner loop over the t tiles at or below the diagonal
//   accumulates dx[s] and the head's dB[s] in registers, and the row and
//   column sums of Q from the same Q values (see below); a second sweep over
//   t tiles with the s tiles at or above them accumulates dC[t]. The head's
//   dB and dC go to fp32 scratch [BH,NC,L,N]; dx and ddt are written
//   directly, and the chunk's share of da to a float64 scratch [BH,NC].
// * pass B, one thread per element of dB and dC: the heads of the group
//   summed in a fixed order (and da over the chunks), rounded once.
//
// Precision. da is ill-conditioned: every R[s] sums the dcum of the rows
// after s, so an error in one dcum[t] reaches da times sum_{s<=t} dt[s]
// (up to ~L dt). Its true value, sum_{t>=s} Q[t,s] (T[t] - T[s]) + ..., T
// the prefix sums of dt, is small beside the row and column sums of Q it is
// taken from. So both sums come from the same Q values, accumulated in
// float64, and dcum, R (a float64 reverse scan, as the twin's autograd of
// its float64 cumsum) and the block's sums of v w and dt R stay in float64;
// an error in one Q[t, s] then reaches da only times T[t] - T[s], small
// where Q is large (near the diagonal). ddt and da are held to 1e-4 of
// their largest value against the twin.
//
// What bounds it on an H100: at zamba2-1.2b's training shape (x [256, 8,
// 256, 64] bf16, N = 64) the bytes are ~310 MB, most of them the fp32 gy
// and gS and the bf16 x and dx (0.09 ms at 3.35 TB/s); the products need
// ~43 GFLOP (0.04 ms on the tensor cores). The per-head fp32 scratch of
// dB and dC adds 2 x 134 MB written and read again. Two bodies, chosen by
// dtype as the forward's are:
// * bf16 (the training path): ssd_bwd_kernel_mma, four warps, each owning
//   16 rows of a 64-row tile, mma.sync.m16n8k16 (bf16 operands, fp32
//   sums) on tiles in padded shared memory read by ldmatrix (cp.async for
//   the bf16 inputs). S^T = B C^T and dM^T = x gy^T are recomputed in the
//   s sweep with the warp's s rows as the mma's M side, so the column sums
//   of Q (over t) are per-thread sums and the row sums (over s) a shuffle
//   over the warp's rows plus one float64 slot per warp and t. gy and gS are
//   split into bf16 halves, gy = hi + lo, wherever they feed dM (hence Q,
//   ddt and da) or u (hence v): one bf16 rounding there (~2^-9) would miss
//   the 1e-4 bound, the split keeps ~2^-17. M^T, dCB^T and dCB are rounded
//   once to bf16 as A operands of the dx, dB and dC products, and gy (hi)
//   and gS (hi) as their B operands, which keeps those gradients within
//   2^-7 of their largest value. The dC sweep recomputes dM from gy (hi).
// * fp32: ssd_bwd_kernel, fp32 FMAs on the CUDA cores, 256 threads each
//   owning a 4 x 4 (or 4 x 8) micro tile; the M^T, dCB^T and Q tiles go
//   through shared memory between the products.
//
// Shapes taken: the forward's (P <= 64, N <= 128), any L whose shared
// memory fits.
//
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // rows of t and of s per tile
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// cum = fp32(inclusive prefix sums of fp32(dt * a), taken in float64), as
// ssd_chunks.cu computes it; s_red holds NT / 32 doubles
template <int NT>
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int L,
                             float* s_dt, float* s_cum, double* s_red) {
  constexpr int WARPS = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < L; base += NT) {
    const int i = base + tid;
    float d = 0.f;
    if (i < L) {
      d = dt[i];
      s_dt[i] = d;
    }
    double v = (i < L) ? (double)__fmul_rn(d, a) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) s_red[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double t = lane < WARPS ? s_red[lane] : 0.0;
#pragma unroll
      for (int off = 1; off < WARPS; off <<= 1) {
        const double u = __shfl_up_sync(FULL, t, off);
        if (lane >= off) t += u;
      }
      if (lane < WARPS) s_red[lane] = t;
    }
    __syncthreads();
    v += carry + (warp > 0 ? s_red[warp - 1] : 0.0);
    if (i < L) s_cum[i] = __double2float_rn(v);
    carry += s_red[WARPS - 1];
    __syncthreads();
  }
}

// v[i] = sum_{j >= i} v[j], in place, in float64
template <int NT>
__device__ void reverse_scan(double* v, int L, double* s_red) {
  constexpr int WARPS = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < L; base += NT) {
    const int k = base + tid, i = L - 1 - k;
    double x = k < L ? v[i] : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += u;
    }
    if (lane == 31) s_red[warp] = x;
    __syncthreads();
    if (warp == 0) {
      double t = lane < WARPS ? s_red[lane] : 0.0;
#pragma unroll
      for (int off = 1; off < WARPS; off <<= 1) {
        const double u = __shfl_up_sync(FULL, t, off);
        if (lane >= off) t += u;
      }
      if (lane < WARPS) s_red[lane] = t;
    }
    __syncthreads();
    x += carry + (warp > 0 ? s_red[warp - 1] : 0.0);
    if (k < L) v[i] = x;
    carry += s_red[WARPS - 1];
    __syncthreads();
  }
}

// the sum over the block of each thread's v, in a fixed order
template <int NT>
__device__ double block_sum(double v, double* s_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) t += s_red[w];
  __syncthreads();
  return t;
}

// The per-row arrays of one (head row, chunk) in shared memory.
struct Rows {
  double* red;     // NT / 32 doubles for the block's scans and sums
  double* rowq;    // nparts x L: partial row sums of Q (summed in part order)
  double* colq;    // L: column sums of Q
  float* cum;
  float* dt;
  float* tail;     // exp(cum[L-1] - cum)
  float* w;        // tail * dt
  float* v;
  float* ddta;     // sum_t dM CB D
};

__host__ __device__ size_t rows_bytes(int L, int nt, int nparts) {
  return ((size_t)nt / 32 + (size_t)(nparts + 1) * L) * sizeof(double) +
         6 * (size_t)L * sizeof(float);
}

__device__ Rows carve_rows(uint8_t* base, int L, int nt, int nparts) {
  Rows r;
  r.red = reinterpret_cast<double*>(base);
  r.rowq = r.red + nt / 32;
  r.colq = r.rowq + (size_t)nparts * L;
  r.cum = reinterpret_cast<float*>(r.colq + L);
  r.dt = r.cum + L;
  r.tail = r.dt + L;
  r.w = r.tail + L;
  r.v = r.w + L;
  r.ddta = r.v + L;
  return r;
}

// cum, dt, tail, w; the Q sums zeroed
template <int NT>
__device__ void start_rows(const Rows& s, const float* __restrict__ dt, float a, int L,
                           int nparts) {
  chunk_cumsum<NT>(dt, a, L, s.dt, s.cum, s.red);
  for (int i = threadIdx.x; i < L; i += NT) {
    s.tail[i] = expf(s.cum[L - 1] - s.cum[i]);
    s.w[i] = __fmul_rn(s.tail[i], s.dt[i]);
    s.colq[i] = 0.0;
  }
  for (int i = threadIdx.x; i < nparts * L; i += NT) s.rowq[i] = 0.0;
  __syncthreads();
}

// dcum, R, ddt and the chunk's da from the per-row sums (every sum of the
// sweep written and synchronised)
template <int NT>
__device__ void finish_rows(const Rows& s, int L, int nparts, float a,
                            const float* __restrict__ ge, float* __restrict__ ddt,
                            double* __restrict__ da_out) {
  double part = 0.0;
  for (int i = threadIdx.x; i < L; i += NT) part += (double)s.v[i] * s.w[i];
  const double vw = block_sum<NT>(part, s.red);
  double* dcum = s.rowq;                       // part 0, in place
  for (int i = threadIdx.x; i < L; i += NT) {
    double r = 0.0;
    for (int k = 0; k < nparts; ++k) r += s.rowq[(size_t)k * L + i];
    double d = r - s.colq[i] - (double)s.v[i] * s.w[i] +
               (double)__fmul_rn(ge[i], expf(s.cum[i]));
    if (i == L - 1) d += vw;
    dcum[i] = d;
  }
  __syncthreads();
  reverse_scan<NT>(dcum, L, s.red);
  part = 0.0;
  for (int i = threadIdx.x; i < L; i += NT) {
    ddt[i] = s.ddta[i] + s.v[i] * s.tail[i] + a * (float)dcum[i];
    part += (double)s.dt[i] * dcum[i];
  }
  const double da = block_sum<NT>(part, s.red);
  if (threadIdx.x == 0) *da_out = da;
}

// ---------------------------------------------------------------------------
// fp32 body: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;      // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int LDT = TILE + 1;     // row of the [64][64] M^T, dCB^T and Q tiles

// rows [r0, r0 + TILE) of src [rows, W] into dst [TILE][ld], zero beyond
// rows (the pad columns W..ld-1 are never read)
__device__ __forceinline__ void load_pad(const float* __restrict__ src, int r0, int rows,
                                         int W, float* dst, int ld) {
  for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
    const int r = i / W, c = i - r * W;
    dst[r * ld + c] = r0 + r < rows ? src[(size_t)(r0 + r) * W + c] : 0.f;
  }
}

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) B(k, tx + 16 j), A(r, k) =
// a[r * ar + k * ak], B(k, c) = b[k * bk + c * bc]; columns c >= W read 0
template <int JN>
__device__ __forceinline__ void mm(float (&acc)[4][JN], const float* a, int ar, int ak,
                                   const float* b, int bk, int bc, int K, int W) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int c = tx + 16 * j;
      bv[j] = c < W ? b[k * bk + c * bc] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the sum over the 16 threads of a row (same ty)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}
__device__ __forceinline__ double row_sum16(double v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

size_t smem_bytes(int L, int P, int N) {
  const size_t ldn = N + 1, ldp = P + 1;
  const size_t tiles = 2 * (TILE * ldn + TILE * ldp)   // B_s, x_s; C_t, gy_t (or gS)
                       + 3 * (size_t)TILE * LDT;        // M^T, dCB^T, Q
  return align16(rows_bytes(L, THREADS, 1)) + tiles * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ c, const float* __restrict__ gy,
               const float* __restrict__ gs, const float* __restrict__ ge,
               float* __restrict__ dx, float* __restrict__ ddt,
               double* __restrict__ da_part, float* __restrict__ db_part,
               float* __restrict__ dc_part, int NC, int L, int P, int N, int nheads,
               int ngroups) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Rows s = carve_rows(smem_raw, L, THREADS, 1);
  const int ldn = N + 1, ldp = P + 1;
  float* sB = reinterpret_cast<float*>(smem_raw + align16(rows_bytes(L, THREADS, 1)));
  float* sX = sB + TILE * ldn;
  float* sC = sX + TILE * ldp;      // C_t, gy_t; gS over them before the t loop
  float* sG = sC + TILE * ldn;
  float* sGS = sC;
  float* sM = sG + TILE * ldp;
  float* sD = sM + TILE * LDT;
  float* sQ = sD + TILE * LDT;

  const int bh = blockIdx.x / NC, ch = blockIdx.x - bh * NC;
  const int row = (bh / nheads) * ngroups + (bh % nheads) / (nheads / ngroups);
  const size_t cell = (size_t)bh * NC + ch;
  const float* X = x + cell * L * P;
  const float* B = b + ((size_t)row * NC + ch) * L * N;
  const float* C = c + ((size_t)row * NC + ch) * L * N;
  const float* GY = gy + cell * L * P;
  const float* GS = gs + cell * P * N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  start_rows<THREADS>(s, dt + cell * L, a[bh], L, 1);
  const int n_tiles = (L + TILE - 1) / TILE;

  // ---- s sweep: dx, the head's dB, the sums of Q, ddt's first term, v
  for (int st = 0; st < n_tiles; ++st) {
    const int s0 = st * TILE;
    __syncthreads();
    load_pad(B, s0, L, N, sB, ldn);
    load_pad(X, s0, L, P, sX, ldp);
    load_pad(GS, 0, P, N, sGS, ldn);
    __syncthreads();
    float dxa[4][4] = {}, dba[4][8] = {};
    mm<4>(dxa, sB, ldn, 1, sGS, 1, ldn, N, P);            // u = B gS^T
    float wr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, sr = s0 + r;
      float vp = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < P) vp = fmaf(sX[r * ldp + p], dxa[i][j], vp);
      }
      vp = row_sum16(vp);
      if (tx == 0 && sr < L) s.v[sr] = vp;
      wr[i] = sr < L ? s.w[sr] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) dxa[i][j] *= wr[i];
    }
    mm<8>(dba, sX, ldp, 1, sGS, ldn, 1, P, N);            // x gS
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dba[i][j] *= wr[i];

    double colq[4] = {};
    float ddta[4] = {};
    for (int tt = st; tt < n_tiles; ++tt) {
      const int t0 = tt * TILE;
      __syncthreads();
      load_pad(C, t0, L, N, sC, ldn);
      load_pad(GY, t0, L, P, sG, ldp);
      __syncthreads();
      float sa[4][4] = {}, dm[4][4] = {};
      mm<4>(sa, sB, ldn, 1, sC, 1, ldn, N, TILE);         // S^T = B C^T
      mm<4>(dm, sX, ldp, 1, sG, 1, ldp, P, TILE);         // dM^T = x gy^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, sr = s0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j, t = t0 + cc;
          float m = 0.f, dcb = 0.f, q = 0.f;
          if (t >= sr && t < L) {
            const float dd = expf(s.cum[t] - s.cum[sr]), d_s = s.dt[sr];
            const float sd = sa[i][j] * dd;
            m = sd * d_s;
            dcb = dm[i][j] * d_s * dd;
            q = dm[i][j] * m;
            colq[i] += (double)q;
            ddta[i] = fmaf(dm[i][j], sd, ddta[i]);
          }
          sM[r * LDT + cc] = m;
          sD[r * LDT + cc] = dcb;
          sQ[r * LDT + cc] = q;
        }
      }
      __syncthreads();
      if (tid < TILE && t0 + tid < L) {               // row sums of Q over s
        double acc = 0.0;
        for (int r = 0; r < TILE; ++r) acc += (double)sQ[r * LDT + tid];
        s.rowq[t0 + tid] += acc;
      }
      mm<4>(dxa, sM, LDT, 1, sG, ldp, 1, TILE, P);        // += M^T gy
      mm<8>(dba, sD, LDT, 1, sC, ldn, 1, TILE, N);        // += dCB^T C
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sr = s0 + ty + 16 * i;
      const double cq = row_sum16(colq[i]);
      const float dd = row_sum16(ddta[i]);
      if (sr >= L) continue;
      if (tx == 0) {
        s.colq[sr] = cq;
        s.ddta[sr] = dd;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < P) dx[(cell * L + sr) * P + p] = dxa[i][j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) db_part[(cell * L + sr) * N + n] = dba[i][j];
      }
    }
  }

  // ---- t sweep: the head's dC = dCB B
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int t0 = tt * TILE;
    __syncthreads();
    load_pad(GY, t0, L, P, sG, ldp);
    float dca[4][8] = {};
    for (int st = 0; st <= tt; ++st) {
      const int s0 = st * TILE;
      __syncthreads();
      load_pad(B, s0, L, N, sB, ldn);
      load_pad(X, s0, L, P, sX, ldp);
      __syncthreads();
      float dm[4][4] = {};
      mm<4>(dm, sG, ldp, 1, sX, 1, ldp, P, TILE);         // dM = gy x^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j, sc = s0 + cc;
          float dcb = 0.f;
          if (sc <= t && t < L)
            dcb = dm[i][j] * s.dt[sc] * expf(s.cum[t] - s.cum[sc]);
          sD[r * LDT + cc] = dcb;
        }
      }
      __syncthreads();
      mm<8>(dca, sD, LDT, 1, sB, ldn, 1, TILE, N);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= L) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) dc_part[(cell * L + t) * N + n] = dca[i][j];
      }
    }
  }
  __syncthreads();
  finish_rows<THREADS>(s, L, 1, a[bh], ge + cell * L, ddt + cell * L, da_part + cell);
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps, 16 rows of a 64-row tile each
constexpr int TC_WARPS = TC_THREADS / 32;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// Fragment addresses in a [rows][ld] bf16 tile (ldmatrix.x4, lane's row):
// A operand, rows r0.. (M side) and 16 columns k0.. (K side)
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* t, int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(t + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B operand with the tile's rows on the N side (16 of them from n0) and
// its columns on the K side: regs {0, 1} for n0.., {2, 3} for n0 + 8..
__device__ __forceinline__ uint32_t bn_addr(const __nv_bfloat16* t, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}
// B operand with the tile's rows on the K side (16 from k0) and its
// columns on the N side (ldmatrix.trans): regs {0, 1} for n0.., {2, 3}
// for n0 + 8..
__device__ __forceinline__ uint32_t bk_addr(const __nv_bfloat16* t, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// C fragments of 16 columns (two n8 blocks) as one A fragment, rounded once
__device__ __forceinline__ void c_to_a(const float* lo, const float* hi, uint32_t* a) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows [r0, r0 + TILE) of bf16 src [L, W] into dst [TILE][round16(W) +
// TC_PAD], zero beyond L and W; cp.async when vec (W a multiple of 8 and
// src on 16 bytes), element by element otherwise
__device__ __forceinline__ void load_tile_bf16(const __nv_bfloat16* __restrict__ src,
                                               int r0, int L, int W, bool vec,
                                               __nv_bfloat16* dst) {
  const int WP = round16(W), ld = WP + TC_PAD;
  if (vec) {
    const int ch = WP / 8;
    for (int i = threadIdx.x; i < TILE * ch; i += TC_THREADS) {
      const int r = i / ch, c = (i - r * ch) * 8;
      const bool ok = r0 + r < L && c < W;
      cp_async16(smem_u32(dst + r * ld + c), ok ? src + (size_t)(r0 + r) * W + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * WP; i += TC_THREADS) {
      const int r = i / WP, c = i - r * WP;
      dst[r * ld + c] = (r0 + r < L && c < W) ? src[(size_t)(r0 + r) * W + c]
                                              : __float2bfloat16(0.f);
    }
  }
}

// rows [r0, r0 + TILE) of fp32 src [L, W] as bf16 hi (the rounded value)
// and, when lo is given, lo (its remainder), laid out as load_tile_bf16's
__device__ __forceinline__ void load_split(const float* __restrict__ src, int r0, int L,
                                           int W, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const int WP = round16(W), ld = WP + TC_PAD;
  for (int i = threadIdx.x; i < TILE * WP; i += TC_THREADS) {
    const int r = i / WP, c = i - r * WP;
    const float v = (r0 + r < L && c < W) ? src[(size_t)(r0 + r) * W + c] : 0.f;
    const __nv_bfloat16 h = __float2bfloat16(v);
    hi[r * ld + c] = h;
    if (lo) lo[r * ld + c] = __float2bfloat16(v - __bfloat162float(h));
  }
}

struct MmaLayout {
  size_t sb, sx, un, total;   // byte offsets of the tiles; total size
};

__host__ __device__ MmaLayout mma_layout(int L, int P, int N) {
  const size_t ldn = round16(N) + TC_PAD, ldp = round16(P) + TC_PAD, e = 2;
  MmaLayout m;
  m.sb = align16(rows_bytes(L, TC_THREADS, TC_WARPS));   // the per-row arrays first
  m.sx = m.sb + TILE * ldn * e;
  m.un = m.sx + TILE * ldp * e;
  // C_t + gy_t hi + gy_t lo, or gS hi + gS lo (before the t loop)
  const size_t ct = (TILE * ldn + 2 * TILE * ldp) * e, gs = 2 * TILE * ldn * e;
  m.total = m.un + (ct > gs ? ct : gs);
  return m;
}

__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_bwd_kernel_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                   const __nv_bfloat16* __restrict__ c, const float* __restrict__ gy,
                   const float* __restrict__ gs, const float* __restrict__ ge,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                   double* __restrict__ da_part, float* __restrict__ db_part,
                   float* __restrict__ dc_part, int NC, int L, int P, int N, int nheads,
                   int ngroups) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Rows s = carve_rows(smem_raw, L, TC_THREADS, TC_WARPS);
  const MmaLayout lay = mma_layout(L, P, N);
  const int NP = round16(N), PP = round16(P), ldn = NP + TC_PAD, ldp = PP + TC_PAD;
  const int kn = NP / 16, kp = PP / 16;
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.sb);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.sx);
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.un);
  __nv_bfloat16* sGh = sC + TILE * ldn;
  __nv_bfloat16* sGl = sGh + TILE * ldp;
  __nv_bfloat16* sSh = sC;                   // gS hi, lo: [P rows][N], before the t loop
  __nv_bfloat16* sSl = sC + TILE * ldn;

  const int bh = blockIdx.x / NC, ch = blockIdx.x - bh * NC;
  const int row = (bh / nheads) * ngroups + (bh % nheads) / (nheads / ngroups);
  const size_t cell = (size_t)bh * NC + ch;
  const __nv_bfloat16* X = x + cell * L * P;
  const __nv_bfloat16* B = b + ((size_t)row * NC + ch) * L * N;
  const __nv_bfloat16* C = c + ((size_t)row * NC + ch) * L * N;
  const float* GY = gy + cell * L * P;
  const float* GS = gs + cell * P * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool vec_n = N % 8 == 0 && ((reinterpret_cast<uintptr_t>(b) |
                                      reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  const bool vec_p = P % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  double* rowq = s.rowq + (size_t)warp * L;  // this warp's partial row sums

  start_rows<TC_THREADS>(s, dt + cell * L, a[bh], L, TC_WARPS);
  const int n_tiles = (L + TILE - 1) / TILE;

  // ---- s sweep: the warp's 16 rows s of each s tile
  for (int st = 0; st < n_tiles; ++st) {
    const int s0 = st * TILE;
    const int sr[2] = {s0 + warp * 16 + g, s0 + warp * 16 + g + 8};
    float cum_s[2], dt_s[2], w_s[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = sr[e] < L;
      cum_s[e] = ok ? s.cum[sr[e]] : 0.f;
      dt_s[e] = ok ? s.dt[sr[e]] : 0.f;
      w_s[e] = ok ? s.w[sr[e]] : 0.f;
    }
    __syncthreads();                             // every tile is free
    load_tile_bf16(B, s0, L, N, vec_n, sB);
    load_tile_bf16(X, s0, L, P, vec_p, sX);
    cp_async_commit();
    load_split(GS, 0, P, N, sSh, sSl);
    cp_async_wait_all();
    __syncthreads();

    // dx = w * u, u = B gS^T (gS hi + lo); dxa[j] holds p = j * 8 ..
    float dxa[KP_MAX * 2][4], dba[KN_MAX * 2][4];
#pragma unroll
    for (int j = 0; j < KP_MAX * 2; ++j) dxa[j][0] = dxa[j][1] = dxa[j][2] = dxa[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KN_MAX * 2; ++j) dba[j][0] = dba[j][1] = dba[j][2] = dba[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN_MAX; ++kk) {
      if (kk >= kn) break;
      uint32_t af[4];
      ldmatrix_x4(af, a_addr(sB, ldn, warp * 16, kk * 16));
#pragma unroll
      for (int jd = 0; jd < KP_MAX; ++jd) {
        if (jd >= kp) break;
        uint32_t bh4[4], bl4[4];
        ldmatrix_x4(bh4, bn_addr(sSh, ldn, jd * 16, kk * 16));
        ldmatrix_x4(bl4, bn_addr(sSl, ldn, jd * 16, kk * 16));
        mma_bf16(dxa[2 * jd], af, bh4[0], bh4[1]);
        mma_bf16(dxa[2 * jd], af, bl4[0], bl4[1]);
        mma_bf16(dxa[2 * jd + 1], af, bh4[2], bh4[3]);
        mma_bf16(dxa[2 * jd + 1], af, bl4[2], bl4[3]);
      }
    }
    // v = sum_p x u over the quad's columns
    {
      float vp[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KP_MAX * 2; ++j) {
        const int p = j * 8 + c2;
        if (p >= PP) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const __nv_bfloat16* xr = sX + (warp * 16 + g + 8 * e) * ldp + p;
          vp[e] = fmaf(__bfloat162float(xr[0]), dxa[j][2 * e], vp[e]);
          vp[e] = fmaf(__bfloat162float(xr[1]), dxa[j][2 * e + 1], vp[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        vp[e] += __shfl_xor_sync(FULL, vp[e], 1);
        vp[e] += __shfl_xor_sync(FULL, vp[e], 2);
        if ((lane & 3) == 0 && sr[e] < L) s.v[sr[e]] = vp[e];
      }
    }
#pragma unroll
    for (int j = 0; j < KP_MAX * 2; ++j) {
      dxa[j][0] *= w_s[0];
      dxa[j][1] *= w_s[0];
      dxa[j][2] *= w_s[1];
      dxa[j][3] *= w_s[1];
    }
    // dB = w * (x gS), gS hi
#pragma unroll
    for (int kk = 0; kk < KP_MAX; ++kk) {
      if (kk >= kp) break;
      uint32_t af[4];
      ldmatrix_x4(af, a_addr(sX, ldp, warp * 16, kk * 16));
#pragma unroll
      for (int jn = 0; jn < KN_MAX; ++jn) {
        if (jn >= kn) break;
        uint32_t b4[4];
        ldmatrix_x4_trans(b4, bk_addr(sSh, ldn, kk * 16, jn * 16));
        mma_bf16(dba[2 * jn], af, b4[0], b4[1]);
        mma_bf16(dba[2 * jn + 1], af, b4[2], b4[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < KN_MAX * 2; ++j) {
      dba[j][0] *= w_s[0];
      dba[j][1] *= w_s[0];
      dba[j][2] *= w_s[1];
      dba[j][3] *= w_s[1];
    }

    double colq[2] = {0.0, 0.0};
    float ddta[2] = {0.f, 0.f};
    for (int tt = st; tt < n_tiles; ++tt) {
      const int t0 = tt * TILE;
      // 16-column steps of t at or after this warp's rows
      const int jmin = tt == st ? warp : 0;
      __syncthreads();                           // gS / the last t tile is done
      load_tile_bf16(C, t0, L, N, vec_n, sC);
      cp_async_commit();
      load_split(GY, t0, L, P, sGh, sGl);
      cp_async_wait_all();
      __syncthreads();

      // S^T = B C^T and dM^T = x gy^T (gy hi + lo): rows s, columns t
      float sa[TILE / 8][4], dm[TILE / 8][4];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[j][i] = dm[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN_MAX; ++kk) {
        if (kk >= kn) break;
        uint32_t af[4];
        ldmatrix_x4(af, a_addr(sB, ldn, warp * 16, kk * 16));
#pragma unroll
        for (int jj = 0; jj < TILE / 16; ++jj) {
          if (jj < jmin) continue;
          uint32_t b4[4];
          ldmatrix_x4(b4, bn_addr(sC, ldn, jj * 16, kk * 16));
          mma_bf16(sa[2 * jj], af, b4[0], b4[1]);
          mma_bf16(sa[2 * jj + 1], af, b4[2], b4[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KP_MAX; ++kk) {
        if (kk >= kp) break;
        uint32_t af[4];
        ldmatrix_x4(af, a_addr(sX, ldp, warp * 16, kk * 16));
#pragma unroll
        for (int jj = 0; jj < TILE / 16; ++jj) {
          if (jj < jmin) continue;
          uint32_t bh4[4], bl4[4];
          ldmatrix_x4(bh4, bn_addr(sGh, ldp, jj * 16, kk * 16));
          ldmatrix_x4(bl4, bn_addr(sGl, ldp, jj * 16, kk * 16));
          mma_bf16(dm[2 * jj], af, bh4[0], bh4[1]);
          mma_bf16(dm[2 * jj], af, bl4[0], bl4[1]);
          mma_bf16(dm[2 * jj + 1], af, bh4[2], bh4[3]);
          mma_bf16(dm[2 * jj + 1], af, bl4[2], bl4[3]);
        }
      }

      // M^T and dCB^T in place of S^T and dM^T; Q's sums
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        if (j < 2 * jmin) continue;
        double qc[2] = {0.0, 0.0};               // this thread's two columns
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i >> 1, t = t0 + j * 8 + c2 + (i & 1);
          float m = 0.f, dcb = 0.f;
          if (t >= sr[e] && t < L) {
            const float dd = expf(s.cum[t] - cum_s[e]);
            const float sd = sa[j][i] * dd;
            m = sd * dt_s[e];
            dcb = dm[j][i] * dt_s[e] * dd;
            const double q = (double)(dm[j][i] * m);
            colq[e] += q;
            qc[i & 1] += q;
            ddta[e] = fmaf(dm[j][i], sd, ddta[e]);
          }
          sa[j][i] = m;
          dm[j][i] = dcb;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {            // over the warp's 16 rows
          double v = qc[k];
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          const int t = t0 + j * 8 + c2 + k;
          if (g == 0 && t < L) rowq[t] += v;
        }
      }

      // dx += M^T gy (gy hi), dB += dCB^T C: K = t
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (kk < jmin) continue;
        uint32_t am[4], ad[4];
        c_to_a(sa[2 * kk], sa[2 * kk + 1], am);
        c_to_a(dm[2 * kk], dm[2 * kk + 1], ad);
#pragma unroll
        for (int jd = 0; jd < KP_MAX; ++jd) {
          if (jd >= kp) break;
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, bk_addr(sGh, ldp, kk * 16, jd * 16));
          mma_bf16(dxa[2 * jd], am, b4[0], b4[1]);
          mma_bf16(dxa[2 * jd + 1], am, b4[2], b4[3]);
        }
#pragma unroll
        for (int jn = 0; jn < KN_MAX; ++jn) {
          if (jn >= kn) break;
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, bk_addr(sC, ldn, kk * 16, jn * 16));
          mma_bf16(dba[2 * jn], ad, b4[0], b4[1]);
          mma_bf16(dba[2 * jn + 1], ad, b4[2], b4[3]);
        }
      }
    }

    // the rows' sums over the quad; dx and the head's dB out
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      double cq = colq[e];
      cq += __shfl_xor_sync(FULL, cq, 1);
      cq += __shfl_xor_sync(FULL, cq, 2);
      float dd = ddta[e];
      dd += __shfl_xor_sync(FULL, dd, 1);
      dd += __shfl_xor_sync(FULL, dd, 2);
      if (sr[e] >= L) continue;
      if ((lane & 3) == 0) {
        s.colq[sr[e]] = cq;
        s.ddta[sr[e]] = dd;
      }
      __nv_bfloat16* dxr = dx + (cell * L + sr[e]) * P;
#pragma unroll
      for (int j = 0; j < KP_MAX * 2; ++j) {
        const int p = j * 8 + c2;
        if (p >= P) break;
        if (p + 1 < P) {
          *reinterpret_cast<__nv_bfloat162*>(dxr + p) =
              __floats2bfloat162_rn(dxa[j][2 * e], dxa[j][2 * e + 1]);
        } else {
          dxr[p] = __float2bfloat16(dxa[j][2 * e]);
        }
      }
      float* dbr = db_part + (cell * L + sr[e]) * N;
#pragma unroll
      for (int j = 0; j < KN_MAX * 2; ++j) {
        const int n = j * 8 + c2;
        if (n >= N) break;
        dbr[n] = dba[j][2 * e];
        if (n + 1 < N) dbr[n + 1] = dba[j][2 * e + 1];
      }
    }
  }

  // ---- t sweep: the warp's 16 rows t; dC = dCB B, dM = gy x^T (gy hi)
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int t0 = tt * TILE;
    const int tr[2] = {t0 + warp * 16 + g, t0 + warp * 16 + g + 8};
    float cum_t[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) cum_t[e] = tr[e] < L ? s.cum[tr[e]] : 0.f;
    float dca[KN_MAX * 2][4];
#pragma unroll
    for (int j = 0; j < KN_MAX * 2; ++j) dca[j][0] = dca[j][1] = dca[j][2] = dca[j][3] = 0.f;
    __syncthreads();
    load_split(GY, t0, L, P, sGh, nullptr);
    for (int st = 0; st <= tt; ++st) {
      const int s0 = st * TILE;
      // 16-column steps of s at or before this warp's rows
      const int jmax = st == tt ? warp + 1 : TILE / 16;
      __syncthreads();                           // sB / sX are free
      load_tile_bf16(B, s0, L, N, vec_n, sB);
      load_tile_bf16(X, s0, L, P, vec_p, sX);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      float dm[TILE / 8][4];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) dm[j][0] = dm[j][1] = dm[j][2] = dm[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP_MAX; ++kk) {
        if (kk >= kp) break;
        uint32_t af[4];
        ldmatrix_x4(af, a_addr(sGh, ldp, warp * 16, kk * 16));
#pragma unroll
        for (int jj = 0; jj < TILE / 16; ++jj) {
          if (jj >= jmax) break;
          uint32_t b4[4];
          ldmatrix_x4(b4, bn_addr(sX, ldp, jj * 16, kk * 16));
          mma_bf16(dm[2 * jj], af, b4[0], b4[1]);
          mma_bf16(dm[2 * jj + 1], af, b4[2], b4[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i >> 1, sc = s0 + j * 8 + c2 + (i & 1);
          float dcb = 0.f;
          if (sc <= tr[e] && tr[e] < L)
            dcb = dm[j][i] * s.dt[sc] * expf(cum_t[e] - s.cum[sc]);
          dm[j][i] = dcb;
        }
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (kk >= jmax) break;
        uint32_t ad[4];
        c_to_a(dm[2 * kk], dm[2 * kk + 1], ad);
#pragma unroll
        for (int jn = 0; jn < KN_MAX; ++jn) {
          if (jn >= kn) break;
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, bk_addr(sB, ldn, kk * 16, jn * 16));
          mma_bf16(dca[2 * jn], ad, b4[0], b4[1]);
          mma_bf16(dca[2 * jn + 1], ad, b4[2], b4[3]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (tr[e] >= L) continue;
      float* dcr = dc_part + (cell * L + tr[e]) * N;
#pragma unroll
      for (int j = 0; j < KN_MAX * 2; ++j) {
        const int n = j * 8 + c2;
        if (n >= N) break;
        dcr[n] = dca[j][2 * e];
        if (n + 1 < N) dcr[n + 1] = dca[j][2 * e + 1];
      }
    }
  }
  __syncthreads();
  finish_rows<TC_THREADS>(s, L, TC_WARPS, a[bh], ge + cell * L, ddt + cell * L,
                          da_part + cell);
}

// ---------------------------------------------------------------------------
// pass B: dB and dC summed over the heads of each group, da over the chunks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void ssd_bwd_reduce(const float* __restrict__ db_part,
                               const float* __restrict__ dc_part,
                               const double* __restrict__ da_part, T* __restrict__ db,
                               T* __restrict__ dc, float* __restrict__ da, long long BG,
                               int NC, int L, int N, int nheads, int ngroups, int BH) {
  const long long per = (long long)NC * L * N, total = BG * per;
  const int hpg = nheads / ngroups;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
    const long long gr = idx / per, rest = idx - gr * per;
    const long long h0 = (gr / ngroups) * nheads + (gr % ngroups) * hpg;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < hpg; ++j) {
      const size_t off = (size_t)(h0 + j) * per + rest;
      sb += db_part[off];
      sc += dc_part[off];
    }
    store(db + idx, sb);
    store(dc + idx, sc);
  }
  if (idx < BH) {
    double t = 0.0;
    for (int k = 0; k < NC; ++k) t += da_part[(size_t)idx * NC + k];
    da[idx] = static_cast<float>(t);
  }
}

template <typename T>
int reduce(const float* db_part, const float* dc_part, const double* da_part, void* db,
           void* dc, float* da, long long BG, int NC, int L, int N, int nheads,
           int ngroups, int BH, cudaStream_t stream) {
  const long long total = BG * NC * L * N;
  const long long n = total > BH ? total : BH;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_reduce<T><<<(unsigned)blocks, threads, 0, stream>>>(
      db_part, dc_part, da_part, static_cast<T*>(db), static_cast<T*>(dc), da, BG, NC, L,
      N, nheads, ngroups, BH);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" int ssd_chunks_bwd(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, const void* gy,
                              const void* gs, const void* ge, void* dx, void* ddt,
                              void* da, void* db, void* dc, void* db_part,
                              void* dc_part, void* da_part, int BH, int NC, int L,
                              int P, int N, int nheads, int ngroups, int dtype,
                              void* stream) {
  if (BH <= 0 || NC <= 0 || L <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      nheads <= 0 || ngroups <= 0 || nheads % ngroups != 0 || BH % nheads != 0 ||
      (size_t)BH * NC > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long BG = (long long)(BH / nheads) * ngroups;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a);
  const float* f_gy = static_cast<const float*>(gy);
  const float* f_gs = static_cast<const float*>(gs);
  const float* f_ge = static_cast<const float*>(ge);
  float* f_dbp = static_cast<float*>(db_part);
  float* f_dcp = static_cast<float*>(dc_part);
  double* f_dap = static_cast<double*>(da_part);
  const unsigned grid = (unsigned)((size_t)BH * NC);
  int err;
  switch (dtype) {
    case 0: {
      const size_t smem = smem_bytes(L, P, N);
      if ((err = prepare(ssd_bwd_kernel, smem)) != 0) return err;
      ssd_bwd_kernel<<<grid, THREADS, smem, st>>>(
          static_cast<const float*>(x), f_dt, f_a, static_cast<const float*>(b),
          static_cast<const float*>(c), f_gy, f_gs, f_ge, static_cast<float*>(dx),
          static_cast<float*>(ddt), f_dap, f_dbp, f_dcp, NC, L, P, N, nheads, ngroups);
      if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
      return reduce<float>(f_dbp, f_dcp, f_dap, db, dc, static_cast<float*>(da), BG, NC,
                           L, N, nheads, ngroups, BH, st);
    }
    case 1: {
      const size_t smem = mma_layout(L, P, N).total;
      if ((err = prepare(ssd_bwd_kernel_mma, smem)) != 0) return err;
      ssd_bwd_kernel_mma<<<grid, TC_THREADS, smem, st>>>(
          static_cast<const __nv_bfloat16*>(x), f_dt, f_a,
          static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c), f_gy,
          f_gs, f_ge, static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt), f_dap,
          f_dbp, f_dcp, NC, L, P, N, nheads, ngroups);
      if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
      return reduce<__nv_bfloat16>(f_dbp, f_dcp, f_dap, db, dc, static_cast<float*>(da),
                                   BG, NC, L, N, nheads, ngroups, BH, st);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
