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
// the group; since B and C are the group's, they are products of the sum:
// dC = (sum_h dCB_h) B and dB = (sum_h dCB_h)^T C + sum_h w_h * (x_h gS_h).
//
// Layouts as in ssd_chunks.cu: x, gy, dx [BH,NC,L,P]; dt, gE, ddt
// [BH,NC,L]; a, da [BH]; B, C, dB, dC [BG,NC,L,N]; gS [BH,NC,P,N]. gy, gS
// and gE are fp32; dx, dB and dC take x's type, ddt and da fp32.
//
// No float atomics, and every sum crossing threads or blocks runs in a
// fixed order: the gradients are bit-identical run to run. The wrapper
// plans the head slices (kernels/ssd/kernel.py, backward_plan: the fewest
// slices a group whose blocks fill two waves of the card's resident blocks
// of pass A) and passes them in; a slice is a contiguous run of a group's
// heads, in order.
//
// bf16 (the training path), four launches:
// * prep, one block per (head row, chunk): cum and w to scratch.
// * pass A, ssd_bwd_kernel_mma, one block per (s tile, group row, chunk,
//   head slice), s tiles slowest: S^T = B C^T of the block's s tile
//   against every t tile at or below the diagonal, once, kept in fp32 in
//   shared memory; then the slice's heads in order, each streaming its gS
//   and its gy tiles through two cp.async stages (the next tile loads
//   while this one's products run), each fp32 tile split once into bf16
//   hi + lo; per (head, t tile) dM^T = x gy^T formed once, M and dCB from
//   it and S, Q's row and column sums in float64 from the same Q values,
//   dx += M^T gy, and dCB added to the slice's fp32 sum in shared memory
//   in head order; at the end dB = (sum dCB)^T C + sum_h w (x gS) and the
//   tile's share of dC = (sum dCB) B, each one product on the sum. Eight
//   warps: 4 down the 64 rows s times 2 across the 64 columns t of a tile
//   pair (their dx, Q column sums and ddt terms added at the head's end).
//   The head's dx, v, colsum and ddt's first term go out at its end, its
//   row sums of Q per s tile.
// * rows, one block per (head row, chunk): dcum (the s tiles' row sums in
//   tile order), R, ddt and the chunk's da.
// * the sum: dB and dC over the slices (dC also over the s tiles at or
//   before each row), da over the chunks.
// The dB / dC partial sums are [BG, NC, slices, L, N] and [BG, NC, slices,
// ceil(L / 64), L, N] fp32: 31.5 MB at zamba2-1.2b's training shape (3
// slices), where the first form's per-head scratch was 268 MB.
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
// their largest value against the twin. gy and gS are split into bf16
// halves, gy = hi + lo, wherever they feed dM (hence Q, ddt and da) or u
// (hence v): one bf16 rounding there (~2^-9) would miss the 1e-4 bound, the
// split keeps ~2^-17. M^T and the dCB sum are rounded once to bf16 as A
// operands of the dx, dB and dC products, and gy (hi) and gS (hi) as their
// B operands, which keeps those gradients within 2^-7 of their largest
// value.
//
// What bounds it on an H100: at zamba2-1.2b's training shape (x [256, 8,
// 256, 64] bf16, N = 64) the bytes are ~310 MB, most of them the fp32 gy
// and gS and the bf16 x and dx (0.09 ms at 3.35 TB/s); the products need
// ~43 GFLOP (0.04 ms on the tensor cores). Pass A issues dM (hi + lo) and
// dx per (head, pair) and the rest once per block; its shared memory (S
// and the dCB sum of one s tile against the chunk: 128 KB at L = 256)
// holds one block an SM, so each tile pair's products, element-wise work
// and barriers run in lock step across the block's warps: measured by
// ablation (PERF.md §6), the element-wise work and the products each
// take about a third of pass A, and the loads alone (gy re-read once per
// s tile at or before it) about 0.3 ms. L is at most 256 at N = 128 for
// that shared memory.
//
// fp32 (parity checks only): ssd_bwd_kernel, one block per (group row,
// chunk, head slice) running the slice's heads in order, fp32 FMAs on the
// CUDA cores, 256 threads each owning a 4 x 4 (or 4 x 8) micro tile; the
// M^T, dCB^T and Q tiles go through shared memory between the products;
// then the sum (dC in one s part).
//
// Shapes taken: the forward's (P <= 64, N <= 128), and L whose pass A
// shared memory fits.
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

// A block's share of a group row and chunk: the head slice k of `slices`
// (heads [k hpg / slices, (k + 1) hpg / slices) of the group, contiguous,
// in order and as even as whole heads allow), from its index in (group
// row, chunk, slice) order (kernels/ssd/kernel.py, backward_grid).
struct Slice {
  int row, ch, k, head0, nh;   // head0: the slice's first head row
};

__device__ __forceinline__ Slice slice_of(int idx, int NC, int nheads, int ngroups,
                                          int slices) {
  Slice s;
  s.k = idx % slices;
  idx /= slices;
  s.ch = idx % NC;
  s.row = idx / NC;
  const int hpg = nheads / ngroups, h0 = s.k * hpg / slices;
  s.nh = (s.k + 1) * hpg / slices - h0;
  s.head0 = (s.row / ngroups) * nheads + (s.row % ngroups) * hpg + h0;
  return s;
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

// One block per (group row, chunk, head slice): the heads of the slice in
// order, each through an s sweep (dx, the head's dB, the sums of Q) and a t
// sweep (the head's dC), its dB and dC added to the slice's partial sums in
// head order (each thread adds to the elements it wrote), ddt and the
// chunk's share of da written at the head's end.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ c, const float* __restrict__ gy,
               const float* __restrict__ gs, const float* __restrict__ ge,
               float* __restrict__ dx, float* __restrict__ ddt,
               double* __restrict__ da_part, float* __restrict__ db_part,
               float* __restrict__ dc_part, int NC, int L, int P, int N, int nheads,
               int ngroups, int slices) {
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

  const Slice sl = slice_of(blockIdx.x, NC, nheads, ngroups, slices);
  const size_t grow = (size_t)sl.row * NC + sl.ch;
  const float* B = b + grow * L * N;
  const float* C = c + grow * L * N;
  float* DB = db_part + (grow * slices + sl.k) * L * N;
  float* DC = dc_part + (grow * slices + sl.k) * L * N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_tiles = (L + TILE - 1) / TILE;

  for (int hl = 0; hl < sl.nh; ++hl) {
    const int bh = sl.head0 + hl;
    const size_t cell = (size_t)bh * NC + sl.ch;
    const float* X = x + cell * L * P;
    const float* GY = gy + cell * L * P;
    const float* GS = gs + cell * P * N;
    __syncthreads();
    start_rows<THREADS>(s, dt + cell * L, a[bh], L, 1);

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
          if (n < N) {
            float* o = DB + (size_t)sr * N + n;
            *o = (hl == 0 ? 0.f : *o) + dba[i][j];
          }
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
          if (n < N) {
            float* o = DC + (size_t)t * N + n;
            *o = (hl == 0 ? 0.f : *o) + dca[i][j];
          }
        }
      }
    }
    __syncthreads();
    finish_rows<THREADS>(s, L, 1, a[bh], ge + cell * L, ddt + cell * L, da_part + cell);
  }
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int SW = 4;              // warps down a 64-row tile, 16 rows each
constexpr int TQ = 2;              // warps across it (pass A)
constexpr int TC_THREADS = 32 * SW * TQ;
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
    for (int i = threadIdx.x; i < TILE * (MAX_N / 8); i += TC_THREADS) {
      const int r = i / (MAX_N / 8), c = (i % (MAX_N / 8)) * 8;
      if (c >= WP) continue;
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

// 4-byte asynchronous copy (zero fill when !valid): row vectors and fp32
// tiles whose rows are not 16-byte multiples
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}
// wait until at most the newest commit group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

constexpr int LDS = TILE + TC_PAD;                 // row of a split stage's hi / lo tile
// one stage: an fp32 64 x 64 tile as it arrives, or a bf16 C tile
// [64][round16(N) + 8]
constexpr int STAGE = TILE * (MAX_N + TC_PAD) * 2;
// the split tile: an fp32 tile's bf16 hi and lo, [64][LDS] each
constexpr int SPLIT = 2 * TILE * LDS * 2;
constexpr int SMEM_MAX = 232448;                   // an H100 block's shared memory

// column of (s, t) in a [64][64] fp32 tile of S or of the dCB sum: 8-float
// groups swizzled by s, so that a quad's float2 of rows s and s + 1 .. 3
// fall in distinct banks
__device__ __forceinline__ int swz(int s, int t) { return t ^ ((s & 3) << 3); }

// rows [r0, r0 + TILE) and columns [c0, c0 + TILE) of fp32 src [rows, W]
// into dst [TILE][TILE], zero beyond; 16-byte copies when vec (W a
// multiple of 4 and src on 16 bytes), 4-byte copies otherwise
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ src, int r0, int rows,
                                              int W, int c0, bool vec, float* dst) {
  for (int i = threadIdx.x; i < TILE * (TILE / 4); i += TC_THREADS) {
    const int r = i >> 4, cc = (i & 15) * 4, gr = r0 + r, gc = c0 + cc;
    float* d = dst + r * TILE + cc;
    if (vec) {
      const bool ok = gr < rows && gc < W;
      cp_async16(smem_u32(d), ok ? src + (size_t)gr * W + gc : src, ok);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = gr < rows && gc + u < W;
        cp_async4(smem_u32(d + u), ok ? src + (size_t)gr * W + gc + u : src, ok);
      }
    }
  }
}

// n floats of src from i0 into dst, zero from src's row end L on
__device__ __forceinline__ void load_row(const float* __restrict__ src, int i0, int n, int L,
                                         float* dst) {
  for (int i = threadIdx.x; i < n; i += TC_THREADS) {
    const bool ok = i0 + i < L;
    cp_async4(smem_u32(dst + i), ok ? src + i0 + i : src, ok);
  }
}

// The fp32 tile of a stage split into bf16 hi (the rounded value) and lo
// (its remainder), [64][LDS] each: every value split once; the stage is
// free again on return
__device__ __forceinline__ void split_stage(const uint8_t* stage, uint8_t* split) {
  const float4* f = reinterpret_cast<const float4*>(stage);
  __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(split);
  __nv_bfloat16* lo = hi + TILE * LDS;
#pragma unroll
  for (int u = 0; u < TILE * TILE / 4 / TC_THREADS; ++u) {
    const float4 v = f[threadIdx.x + u * TC_THREADS];
    const int e = (threadIdx.x + u * TC_THREADS) * 4, r = e / TILE, cc = e % TILE;
    const float x4[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[2], l[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __nv_bfloat16 h0 = __float2bfloat16(x4[2 * k]), h1 = __float2bfloat16(x4[2 * k + 1]);
      __nv_bfloat162 hh(h0, h1);
      h[k] = *reinterpret_cast<uint32_t*>(&hh);
      l[k] = pack_bf16(x4[2 * k] - __bfloat162float(h0), x4[2 * k + 1] - __bfloat162float(h1));
    }
    *reinterpret_cast<uint2*>(hi + r * LDS + cc) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(lo + r * LDS + cc) = make_uint2(l[0], l[1]);
  }
  __syncthreads();
}

// Shared memory of the tensor-core pass A for (L, P, N): the S and dCB-sum
// tiles of one s tile against every t tile of the chunk, the B tile, two
// stages, the split tile, two head buffers (x, cum, w, dt) and the warps'
// row sums of Q.
struct TcLayout {
  int ns;
  size_t s, d, b, stage, split, head, head_bytes, h_cum, h_w, rowq, total;
};

__host__ __device__ __forceinline__ TcLayout tc_layout(int L, int P, int N) {
  TcLayout m;
  m.ns = (L + TILE - 1) / TILE;
  const size_t tile32 = (size_t)TILE * TILE * 4;
  m.s = 0;
  m.d = m.s + m.ns * tile32;
  m.b = m.d + m.ns * tile32;
  m.stage = m.b + align16((size_t)TILE * (round16(N) + TC_PAD) * 2);
  m.split = m.stage + 2 * (size_t)STAGE;
  m.head = m.split + SPLIT;
  m.h_cum = align16((size_t)TILE * (round16(P) + TC_PAD) * 2);
  m.h_w = m.h_cum + (size_t)m.ns * TILE * 4;
  m.head_bytes = m.h_w + 2 * TILE * 4;
  m.rowq = m.head + 2 * m.head_bytes;
  m.total = m.rowq + (size_t)SW * m.ns * TILE * 8;
  return m;
}

// An item of pass A: kind 0, C tile st + sub (for S); kind 1, half sub of head
// hl's gS; kind 2, head hl's gy tile st + sub; kind 3, C tile st + sub
// (for dB and dC)
struct Item {
  int kind, hl, sub;
};

// the item after `it` (items in order: C tiles, then each head's gS halves
// and gy tiles, then C tiles again; nh >= 1)
__device__ __forceinline__ Item next_item(const Item& it, int ntt, int nh, int ng) {
  switch (it.kind) {
    case 0: return it.sub + 1 < ntt ? Item{0, 0, it.sub + 1} : Item{1, 0, 0};
    case 1: return it.sub + 1 < ng ? Item{1, it.hl, it.sub + 1} : Item{2, it.hl, 0};
    case 2:
      return it.sub + 1 < ntt ? Item{2, it.hl, it.sub + 1}
             : it.hl + 1 < nh ? Item{1, it.hl + 1, 0} : Item{3, 0, 0};
    default: return Item{3, 0, it.sub + 1};
  }
}

// The warps of pass A: SW = 4 row groups of 16 rows s, times TQ column
// groups of TW columns t (and of 64 / TQ columns of each 64-column half
// of N for the dB and dC products)
constexpr int TW = TILE / TQ, JJ = TW / 16, J8 = TW / 8;

// Sum v[0..n) over the 8 lanes of a quad column (lanes g = 0..7 of the
// same lane & 3) by recursive halving: at each of the three steps a lane
// keeps half of its values, adds its partner's, and sends it the other
// half. On return v[0] holds the sum of the value index that lane g keeps,
// kept_index(g, n), or (n < 8) the same for 8 / n lanes.
template <int NV>
__device__ __forceinline__ void halve_sum(double (&v)[NV]) {
  const int g = (threadIdx.x & 31) >> 2;
  int count = NV;
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int mask = 4 << step;
    if (count > 1) {
      const bool up = (g >> step) & 1;
      const int half = count / 2;
#pragma unroll
      for (int k = 0; k < NV / 2; ++k) {
        if (k >= half) break;
        const double mine = up ? v[k + half] : v[k], other = up ? v[k] : v[k + half];
        v[k] = mine + __shfl_xor_sync(FULL, other, mask);
      }
      count = half;
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], mask);
    }
  }
}

// the value index lane g holds after halve_sum of NV values (the bits of g
// taken from the top of the index down); -1 where a lane only repeats
// another's sum
template <int NV>
__device__ __forceinline__ int kept_index(int g) {
  int idx = 0, count = NV, step = 0;
  for (; step < 3 && count > 1; ++step) {
    count /= 2;
    if ((g >> step) & 1) idx += count;
  }
  return (g >> step) == 0 ? idx : -1;
}

// dB (the warp's rows s and columns of gS half Q) += w * (x gS): K = p
template <int Q>
__device__ __forceinline__ void add_xgs(float (&dba)[KN_MAX * 2 / TQ][4],
                                        const __nv_bfloat16* sX, int ldp, int kp,
                                        const __nv_bfloat16* gh, int knh, const float* w_s) {
  const int warp = threadIdx.x >> 5, sw = warp % SW, tq = warp / SW;
  float t[JJ * 2][4];
#pragma unroll
  for (int j = 0; j < JJ * 2; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KP_MAX; ++kk) {
    if (kk >= kp) break;
    uint32_t af[4];
    ldmatrix_x4(af, a_addr(sX, ldp, sw * 16, kk * 16));
#pragma unroll
    for (int jl = 0; jl < JJ; ++jl) {
      const int jn = tq * JJ + jl;
      if (jn >= knh) break;
      uint32_t b4[4];
      ldmatrix_x4_trans(b4, bk_addr(gh, LDS, kk * 16, jn * 16));
      mma_bf16(t[2 * jl], af, b4[0], b4[1]);
      mma_bf16(t[2 * jl + 1], af, b4[2], b4[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < JJ * 2; ++j) {
    float* d = dba[Q * JJ * 2 + j];
    d[0] += w_s[0] * t[j][0];
    d[1] += w_s[0] * t[j][1];
    d[2] += w_s[1] * t[j][2];
    d[3] += w_s[1] * t[j][3];
  }
}

// Pass A, tensor cores: one block per (s tile, group row, chunk, head
// slice), s tiles slowest (the first have the most t tiles). SW x TQ
// warps: warp (sw, tq) owns rows s sw*16.. and columns t tq*TW.. of each
// tile pair. The block streams one 64 x 64 tile an item through two
// cp.async stages (the next item loads while this one runs): the C tiles
// at or below the diagonal, giving S^T = B C^T once; then per head in
// order its gS (in 64-column halves) and its gy tiles, each fp32 tile split
// once into bf16 hi / lo; then the C tiles again, for dB = dCB^T C +
// sum_h w * (x gS) and the tile's share of dC = dCB B, with dCB summed
// over the slice's heads in head order in shared memory.
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_bwd_kernel_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const __nv_bfloat16* __restrict__ b, const __nv_bfloat16* __restrict__ c,
                   const float* __restrict__ gy, const float* __restrict__ gs,
                   const float* __restrict__ cum, const float* __restrict__ wr,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ v_out,
                   float* __restrict__ ddta_out, double* __restrict__ colq_out,
                   double* __restrict__ qpart, float* __restrict__ db_part,
                   float* __restrict__ dc_part, int BG, int NC, int L, int P, int N,
                   int nheads, int ngroups, int slices) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const TcLayout lay = tc_layout(L, P, N);
  const int ns = lay.ns;
  const int NP = round16(N), PP = round16(P), ldn = NP + TC_PAD, ldp = PP + TC_PAD;
  const int kn = NP / 16, kp = PP / 16;
  float* sS = reinterpret_cast<float*>(smem_raw + lay.s);
  float* sD = reinterpret_cast<float*>(smem_raw + lay.d);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.b);
  double* rowq = reinterpret_cast<double*>(smem_raw + lay.rowq);

  const int cells = BG * NC * slices;
  const int st = blockIdx.x / cells;
  const Slice sl = slice_of(blockIdx.x - st * cells, NC, nheads, ngroups, slices);
  const int s0 = st * TILE, ntt = ns - st, ng = (N + TILE - 1) / TILE;
  const int n_items = 2 * ntt + sl.nh * (ng + ntt);
  const size_t grow = (size_t)sl.row * NC + sl.ch;
  const __nv_bfloat16* Bg = b + grow * L * N;
  const __nv_bfloat16* Cg = c + grow * L * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sw = warp % SW, tq = warp / SW;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int lr[2] = {sw * 16 + g, sw * 16 + g + 8};      // the thread's rows s - s0
  const int sr[2] = {s0 + lr[0], s0 + lr[1]};
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec_n = N % 8 == 0 && aligned(b) && aligned(c);
  const bool vec_p = P % 8 == 0 && aligned(x);
  const bool vec_gy = P % 4 == 0 && aligned(gy);
  const bool vec_gs = N % 4 == 0 && aligned(gs);

  const auto head_buf = [&](int hl) { return smem_raw + lay.head + (hl & 1) * lay.head_bytes; };
  // loads of item i into stage i % 2 (a head's first item also fills its
  // head buffer), one commit group an item (empty past the last)
  const auto issue = [&](int i, const Item& it) {
    if (i < n_items) {
      uint8_t* stg = smem_raw + lay.stage + (i & 1) * STAGE;
      if (it.kind == 0 || it.kind == 3) {
        load_tile_bf16(Cg, (st + it.sub) * TILE, L, N, vec_n,
                       reinterpret_cast<__nv_bfloat16*>(stg));
      } else {
        const size_t cell = (size_t)(sl.head0 + it.hl) * NC + sl.ch;
        if (it.kind == 1) {
          if (it.sub == 0) {
            uint8_t* hb = head_buf(it.hl);
            load_tile_bf16(x + cell * L * P, s0, L, P, vec_p,
                           reinterpret_cast<__nv_bfloat16*>(hb));
            float* hw = reinterpret_cast<float*>(hb + lay.h_w);
            load_row(cum + cell * L, s0, ntt * TILE, L, reinterpret_cast<float*>(hb + lay.h_cum));
            load_row(wr + cell * L, s0, TILE, L, hw);
            load_row(dt + cell * L, s0, TILE, L, hw + TILE);
          }
          load_tile_f32(gs + cell * P * N, 0, P, N, it.sub * TILE, vec_gs,
                        reinterpret_cast<float*>(stg));
        } else {
          load_tile_f32(gy + cell * L * P, (st + it.sub) * TILE, L, P, 0, vec_gy,
                        reinterpret_cast<float*>(stg));
        }
      }
    }
    cp_async_commit();
  };

  load_tile_bf16(Bg, s0, L, N, vec_n, sB);        // with item 0's group
  Item cur{0, 0, 0}, ahead = next_item(cur, ntt, sl.nh, ng);   // items i and i + 2
  issue(0, cur);
  issue(1, ahead);
  ahead = next_item(ahead, ntt, sl.nh, ng);

  // dxa: the warp's rows of dx over its columns t (all p); dba: its rows
  // and columns of dB
  float dxa[KP_MAX * 2][4], dba[KN_MAX * 2 / TQ][4];
#pragma unroll
  for (int j = 0; j < KN_MAX * 2 / TQ; ++j) dba[j][0] = dba[j][1] = dba[j][2] = dba[j][3] = 0.f;
  double colq[2];
  float ddta[2], cum_s[2], dt_s[2], w_s[2];

  uint8_t* spl = smem_raw + lay.split;
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait_1();
    __syncthreads();                               // item i is in its stage, item i - 1 done
    const Item it = cur;
    uint8_t* stg = smem_raw + lay.stage + (i & 1) * STAGE;
    const bool split = it.kind == 1 || it.kind == 2;
    if (split) {                                   // gS or gy: split, then the stage refills
      split_stage(stg, spl);
      issue(i + 2, ahead);
    }
    const int tt = st + it.sub;
    const int jmin = it.sub == 0 ? sw : 0;         // 16-column steps of t at or after the rows
    if (it.kind == 0) {
      // ---- S^T = B_s C_t^T (rows s, columns t), kept in fp32
      const __nv_bfloat16* sC = reinterpret_cast<const __nv_bfloat16*>(stg);
      float sa[J8][4];
#pragma unroll
      for (int j = 0; j < J8; ++j) sa[j][0] = sa[j][1] = sa[j][2] = sa[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN_MAX; ++kk) {
        if (kk >= kn) break;
        uint32_t af[4];
        ldmatrix_x4(af, a_addr(sB, ldn, sw * 16, kk * 16));
#pragma unroll
        for (int jl = 0; jl < JJ; ++jl) {
          const int jj = tq * JJ + jl;
          if (jj < jmin) continue;
          uint32_t b4[4];
          ldmatrix_x4(b4, bn_addr(sC, ldn, jj * 16, kk * 16));
          mma_bf16(sa[2 * jl], af, b4[0], b4[1]);
          mma_bf16(sa[2 * jl + 1], af, b4[2], b4[3]);
        }
      }
      float* T = sS + (size_t)it.sub * TILE * TILE;
#pragma unroll
      for (int j = 0; j < J8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(T + lr[e] * TILE + swz(lr[e], tq * TW + j * 8 + c2)) =
              make_float2(sa[j][2 * e], sa[j][2 * e + 1]);
    } else if (it.kind == 1) {
      // ---- head start: u = B gS^T (gS hi + lo; the warp's 16-column
      // steps p, every TQ-th), v, dx = w u; dB += w (x gS)
      const uint8_t* hb = head_buf(it.hl);
      const __nv_bfloat16* sX = reinterpret_cast<const __nv_bfloat16*>(hb);
      if (it.sub == 0) {
        const float* hw = reinterpret_cast<const float*>(hb + lay.h_w);
        const float* hc = reinterpret_cast<const float*>(hb + lay.h_cum);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = sr[e] < L;
          cum_s[e] = ok ? hc[lr[e]] : 0.f;
          w_s[e] = ok ? hw[lr[e]] : 0.f;
          dt_s[e] = ok ? hw[TILE + lr[e]] : 0.f;
          colq[e] = 0.0;
          ddta[e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < KP_MAX * 2; ++j) dxa[j][0] = dxa[j][1] = dxa[j][2] = dxa[j][3] = 0.f;
      }
      const __nv_bfloat16* gh = reinterpret_cast<const __nv_bfloat16*>(spl);
      const __nv_bfloat16* gl = gh + TILE * LDS;
      const int nw = min(TILE, N - it.sub * TILE), knh = round16(nw) / 16;
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (kk >= knh) break;
        uint32_t af[4];
        ldmatrix_x4(af, a_addr(sB, ldn, sw * 16, it.sub * TILE + kk * 16));
#pragma unroll
        for (int jd = 0; jd < KP_MAX; ++jd) {
          if (jd >= kp) break;
          if (jd % TQ != tq) continue;
          uint32_t bh4[4], bl4[4];
          ldmatrix_x4(bh4, bn_addr(gh, LDS, jd * 16, kk * 16));
          ldmatrix_x4(bl4, bn_addr(gl, LDS, jd * 16, kk * 16));
          mma_bf16(dxa[2 * jd], af, bh4[0], bh4[1]);
          mma_bf16(dxa[2 * jd + 1], af, bh4[2], bh4[3]);
          mma_bf16(dxa[2 * jd], af, bl4[0], bl4[1]);
          mma_bf16(dxa[2 * jd + 1], af, bl4[2], bl4[3]);
        }
      }
      if (it.sub == 0) add_xgs<0>(dba, sX, ldp, kp, gh, knh, w_s);
      else add_xgs<1>(dba, sX, ldp, kp, gh, knh, w_s);
      if (it.sub == ng - 1) {
        // v = sum_p x u: the quad's columns, then the TQ column groups in
        // order (through the stage's spare bytes); then dx = w u
        const size_t cell = (size_t)(sl.head0 + it.hl) * NC + sl.ch;
        float* vbuf = reinterpret_cast<float*>(rowq);   // free until this head's pairs
        float vp[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KP_MAX * 2; ++j) {
          const int p = j * 8 + c2;
          if (p >= PP) break;
          if ((j / 2) % TQ != tq) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const __nv_bfloat16* xr = sX + lr[e] * ldp + p;
            vp[e] = fmaf(__bfloat162float(xr[0]), dxa[j][2 * e], vp[e]);
            vp[e] = fmaf(__bfloat162float(xr[1]), dxa[j][2 * e + 1], vp[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          vp[e] += __shfl_xor_sync(FULL, vp[e], 1);
          vp[e] += __shfl_xor_sync(FULL, vp[e], 2);
          if ((lane & 3) == 0) vbuf[tq * TILE + lr[e]] = vp[e];
        }
        __syncthreads();
        if (tid < TILE && s0 + tid < L) {
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < TQ; ++q) v += vbuf[q * TILE + tid];
          v_out[cell * L + s0 + tid] = v;
        }
#pragma unroll
        for (int j = 0; j < KP_MAX * 2; ++j) {
          dxa[j][0] *= w_s[0];
          dxa[j][1] *= w_s[0];
          dxa[j][2] *= w_s[1];
          dxa[j][3] *= w_s[1];
        }
      }
    } else if (it.kind == 2) {
      // ---- the pair (s tile, t tile) of one head
      const uint8_t* hb = head_buf(it.hl);
      const __nv_bfloat16* sX = reinterpret_cast<const __nv_bfloat16*>(hb);
      const float* hc = reinterpret_cast<const float*>(hb + lay.h_cum);
      const __nv_bfloat16* gh = reinterpret_cast<const __nv_bfloat16*>(spl);
      const __nv_bfloat16* gl = gh + TILE * LDS;
      const int t0 = tt * TILE + tq * TW;          // the warp's first column t
      // dM^T = x gy^T (gy hi + lo): rows s, the warp's columns t
      float sa[J8][4], dm[J8][4];
#pragma unroll
      for (int j = 0; j < J8; ++j) dm[j][0] = dm[j][1] = dm[j][2] = dm[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP_MAX; ++kk) {
        if (kk >= kp) break;
        uint32_t af[4];
        ldmatrix_x4(af, a_addr(sX, ldp, sw * 16, kk * 16));
#pragma unroll
        for (int jl = 0; jl < JJ; ++jl) {
          const int jj = tq * JJ + jl;
          if (jj < jmin) continue;
          uint32_t bh4[4], bl4[4];
          ldmatrix_x4(bh4, bn_addr(gh, LDS, jj * 16, kk * 16));
          ldmatrix_x4(bl4, bn_addr(gl, LDS, jj * 16, kk * 16));
          mma_bf16(dm[2 * jl], af, bh4[0], bh4[1]);
          mma_bf16(dm[2 * jl + 1], af, bh4[2], bh4[3]);
          mma_bf16(dm[2 * jl], af, bl4[0], bl4[1]);
          mma_bf16(dm[2 * jl + 1], af, bl4[2], bl4[3]);
        }
      }
      const float* T = sS + (size_t)it.sub * TILE * TILE;
#pragma unroll
      for (int j = 0; j < J8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 v2 = *reinterpret_cast<const float2*>(
              T + lr[e] * TILE + swz(lr[e], tq * TW + j * 8 + c2));
          sa[j][2 * e] = v2.x;
          sa[j][2 * e + 1] = v2.y;
        }
      // M^T and dCB^T in place of S^T and dM^T; Q's sums (float64, from
      // the same Q values)
      double qc[J8 * 2];                             // this thread's columns
#pragma unroll
      for (int j = 0; j < J8; ++j) {
        qc[2 * j] = qc[2 * j + 1] = 0.0;
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          // branch-free, so that the elements' chains interleave: above the
          // diagonal (and past L) the decay is exp(-inf) = 0, which makes
          // m, dCB and Q exact zeros (S and dM are finite there)
          const int e = i4 >> 1, t = t0 + j * 8 + c2 + (i4 & 1);
          const float arg = t >= sr[e] && t < L ? hc[t - s0] - cum_s[e]
                                                      : __int_as_float(0xff800000);
          const float dd = expf(arg);
          const float sd = sa[j][i4] * dd;
          const float m = sd * dt_s[e];
          const double q = (double)(dm[j][i4] * m);
          colq[e] += q;
          qc[2 * j + (i4 & 1)] += q;
          ddta[e] = fmaf(dm[j][i4], sd, ddta[e]);
          sa[j][i4] = m;
          dm[j][i4] = dm[j][i4] * dt_s[e] * dd;
        }
      }
      // the warp's row sums of Q over its 16 rows, one column a lane
      halve_sum<J8 * 2>(qc);
      {
        const int k = kept_index<J8 * 2>(g);
        if (k >= 0) rowq[(size_t)sw * ns * TILE + t0 - s0 + (k >> 1) * 8 + c2 + (k & 1)] = qc[0];
      }
      // the slice's dCB sum, in head order
      float* Dt = sD + (size_t)it.sub * TILE * TILE;
#pragma unroll
      for (int j = 0; j < J8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float2* o = reinterpret_cast<float2*>(Dt + lr[e] * TILE +
                                                swz(lr[e], tq * TW + j * 8 + c2));
          const float2 prev = it.hl == 0 ? make_float2(0.f, 0.f) : *o;
          *o = make_float2(prev.x + dm[j][2 * e], prev.y + dm[j][2 * e + 1]);
        }
      // dx += M^T gy (gy hi): K = the warp's columns t
#pragma unroll
      for (int kl = 0; kl < JJ; ++kl) {
        if (tq * JJ + kl < jmin) continue;
        uint32_t am[4];
        c_to_a(sa[2 * kl], sa[2 * kl + 1], am);
#pragma unroll
        for (int jd = 0; jd < KP_MAX; ++jd) {
          if (jd >= kp) break;
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, bk_addr(gh, LDS, (tq * JJ + kl) * 16, jd * 16));
          mma_bf16(dxa[2 * jd], am, b4[0], b4[1]);
          mma_bf16(dxa[2 * jd + 1], am, b4[2], b4[3]);
        }
      }
      if (it.sub == ntt - 1) {
        // ---- head end: the column groups' dx, Q column sums and ddt
        // terms added in group order (through the split tile, free once
        // every warp's products are done); dx out; the rows' sums of Q
        const size_t cell = (size_t)(sl.head0 + it.hl) * NC + sl.ch;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          colq[e] += __shfl_xor_sync(FULL, colq[e], 1);
          colq[e] += __shfl_xor_sync(FULL, colq[e], 2);
          ddta[e] += __shfl_xor_sync(FULL, ddta[e], 1);
          ddta[e] += __shfl_xor_sync(FULL, ddta[e], 2);
        }
        float* xdx = reinterpret_cast<float*>(spl);              // [64][64], swizzled
        double* xcq = reinterpret_cast<double*>(spl + TILE * TILE * 4);
        float* xdd = reinterpret_cast<float*>(xcq + TILE);
#pragma unroll
        for (int q = 1; q < TQ; ++q) {
          __syncthreads();
          if (tq == q) {
#pragma unroll
            for (int j = 0; j < KP_MAX * 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                *reinterpret_cast<float2*>(xdx + lr[e] * TILE + swz(lr[e], j * 8 + c2)) =
                    make_float2(dxa[j][2 * e], dxa[j][2 * e + 1]);
            if ((lane & 3) == 0)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                xcq[lr[e]] = colq[e];
                xdd[lr[e]] = ddta[e];
              }
          }
          __syncthreads();
          if (tq == 0) {
#pragma unroll
            for (int j = 0; j < KP_MAX * 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float2 v2 = *reinterpret_cast<const float2*>(
                    xdx + lr[e] * TILE + swz(lr[e], j * 8 + c2));
                dxa[j][2 * e] += v2.x;
                dxa[j][2 * e + 1] += v2.y;
              }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              colq[e] += xcq[lr[e]];
              ddta[e] += xdd[lr[e]];
            }
          }
        }
        if (tq == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (sr[e] >= L) continue;
            if ((lane & 3) == 0) {
              colq_out[cell * L + sr[e]] = colq[e];
              ddta_out[cell * L + sr[e]] = ddta[e];
            }
            __nv_bfloat16* dxr = dx + (cell * L + sr[e]) * P;
#pragma unroll
            for (int j = 0; j < KP_MAX * 2; ++j) {
              const int p = j * 8 + c2;
              if (p >= P) break;
              if (p + 1 < P && P % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dxr + p) =
                    __floats2bfloat162_rn(dxa[j][2 * e], dxa[j][2 * e + 1]);
              } else {
                dxr[p] = __float2bfloat16(dxa[j][2 * e]);
                if (p + 1 < P) dxr[p + 1] = __float2bfloat16(dxa[j][2 * e + 1]);
              }
            }
          }
        }
        __syncthreads();                           // every warp's row sums
        double* qo = qpart + (cell * ns + st) * L;
        for (int u = tid; u < ntt * TILE; u += TC_THREADS) {
          const int t = s0 + u;
          if (t >= L) break;
          double q = 0.0;
#pragma unroll
          for (int w = 0; w < SW; ++w) q += rowq[(size_t)w * ns * TILE + u];
          qo[t] = q;
        }
      }
    } else {
      // ---- dB += dCB^T C_t (K = t) and dC_t = dCB B_s (K = s), dCB the
      // slice's sum, rounded once to bf16; the warp's columns n
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (kk < jmin) continue;
        const __nv_bfloat16* sC = reinterpret_cast<const __nv_bfloat16*>(stg);
        const float* Dt = sD + (size_t)it.sub * TILE * TILE;
        uint32_t ad[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 v2 = *reinterpret_cast<const float2*>(
                Dt + lr[e] * TILE + swz(lr[e], kk * 16 + 8 * h + c2));
            ad[2 * h + e] = pack_bf16(v2.x, v2.y);
          }
#pragma unroll
        for (int q = 0; q < KN_MAX / 4; ++q)
#pragma unroll
          for (int jl = 0; jl < JJ; ++jl) {
            const int jn = q * 4 + tq * JJ + jl;
            if (jn >= kn) continue;
            uint32_t b4[4];
            ldmatrix_x4_trans(b4, bk_addr(sC, ldn, kk * 16, jn * 16));
            mma_bf16(dba[(q * JJ + jl) * 2], ad, b4[0], b4[1]);
            mma_bf16(dba[(q * JJ + jl) * 2 + 1], ad, b4[2], b4[3]);
          }
      }
      float dca[KN_MAX * 2 / TQ][4];
#pragma unroll
      for (int j = 0; j < KN_MAX * 2 / TQ; ++j) dca[j][0] = dca[j][1] = dca[j][2] = dca[j][3] = 0.f;
      const int kmax = it.sub == 0 ? sw + 1 : TILE / 16;   // s steps at or before the rows t
      const float* Dt = sD + (size_t)it.sub * TILE * TILE;
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (kk >= kmax) break;
        uint32_t ad[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = kk * 16 + 8 * h + c2, t = lr[e];
            ad[2 * h + e] = pack_bf16(Dt[s * TILE + swz(s, t)], Dt[(s + 1) * TILE + swz(s + 1, t)]);
          }
#pragma unroll
        for (int q = 0; q < KN_MAX / 4; ++q)
#pragma unroll
          for (int jl = 0; jl < JJ; ++jl) {
            const int jn = q * 4 + tq * JJ + jl;
            if (jn >= kn) continue;
            uint32_t b4[4];
            ldmatrix_x4_trans(b4, bk_addr(sB, ldn, kk * 16, jn * 16));
            mma_bf16(dca[(q * JJ + jl) * 2], ad, b4[0], b4[1]);
            mma_bf16(dca[(q * JJ + jl) * 2 + 1], ad, b4[2], b4[3]);
          }
      }
      float* DC = dc_part + ((grow * slices + sl.k) * ns + st) * L * N;
      float* DB = db_part + (grow * slices + sl.k) * L * N;
      const bool last = it.sub == ntt - 1;
#pragma unroll
      for (int q = 0; q < KN_MAX / 4; ++q)
#pragma unroll
        for (int jb = 0; jb < JJ * 2; ++jb) {
          const int n = q * TILE + tq * TW + jb * 8 + c2, j = q * JJ * 2 + jb;
          if (n >= N) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = tt * TILE + lr[e];
            if (t < L) {
              DC[(size_t)t * N + n] = dca[j][2 * e];
              if (n + 1 < N) DC[(size_t)t * N + n + 1] = dca[j][2 * e + 1];
            }
            if (last && sr[e] < L) {
              DB[(size_t)sr[e] * N + n] = dba[j][2 * e];
              if (n + 1 < N) DB[(size_t)sr[e] * N + n + 1] = dba[j][2 * e + 1];
            }
          }
        }
    }
    if (!split) {                                  // a C tile: read until here
      __syncthreads();
      issue(i + 2, ahead);
    }
    cur = next_item(cur, ntt, sl.nh, ng);
    ahead = next_item(ahead, ntt, sl.nh, ng);
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// the tensor-core path's row passes: before pass A, cum and w; after it,
// dcum, R, ddt and the chunk's share of da
// ---------------------------------------------------------------------------

constexpr int ROW_THREADS = 128;

// one block per (head row, chunk): cum = fp32(the float64 prefix sums of
// fp32(dt a)) and w = exp(cum[L-1] - cum) dt, as start_rows forms them
__global__ void __launch_bounds__(ROW_THREADS)
ssd_bwd_prep_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                    float* __restrict__ cum, float* __restrict__ w, int NC, int L) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);
  float* s_cum = reinterpret_cast<float*>(red + ROW_THREADS / 32);
  float* s_dt = s_cum + L;
  const size_t cell = blockIdx.x;
  chunk_cumsum<ROW_THREADS>(dt + cell * L, a[cell / NC], L, s_dt, s_cum, red);
  for (int i = threadIdx.x; i < L; i += ROW_THREADS) {
    cum[cell * L + i] = s_cum[i];
    w[cell * L + i] = __fmul_rn(expf(s_cum[L - 1] - s_cum[i]), s_dt[i]);
  }
}

// one block per (head row, chunk): dcum[t] = (the s tiles' row sums of Q,
// in tile order) - colsum_t(Q) - v w + [t = L-1] sum v w + ge exp(cum),
// R its float64 reverse scan, ddt and the chunk's da as finish_rows
__global__ void __launch_bounds__(ROW_THREADS)
ssd_bwd_rows_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                    const float* __restrict__ ge, const float* __restrict__ cum,
                    const float* __restrict__ w, const float* __restrict__ v,
                    const float* __restrict__ ddta, const double* __restrict__ colq,
                    const double* __restrict__ qpart, float* __restrict__ ddt,
                    double* __restrict__ da_part, int NC, int L) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);
  double* dcum = red + ROW_THREADS / 32;
  const size_t cell = blockIdx.x, row0 = cell * L;
  const int ns = (L + TILE - 1) / TILE;
  double part = 0.0;
  for (int i = threadIdx.x; i < L; i += ROW_THREADS) part += (double)v[row0 + i] * w[row0 + i];
  const double vw = block_sum<ROW_THREADS>(part, red);
  const float* c = cum + row0;
  for (int i = threadIdx.x; i < L; i += ROW_THREADS) {
    double r = 0.0;
    for (int k = 0; k <= i / TILE; ++k) r += qpart[(cell * ns + k) * L + i];
    double d = r - colq[row0 + i] - (double)v[row0 + i] * w[row0 + i] +
               (double)__fmul_rn(ge[row0 + i], expf(c[i]));
    if (i == L - 1) d += vw;
    dcum[i] = d;
  }
  __syncthreads();
  reverse_scan<ROW_THREADS>(dcum, L, red);
  const float av = a[cell / NC];
  part = 0.0;
  for (int i = threadIdx.x; i < L; i += ROW_THREADS) {
    const float tail = expf(c[L - 1] - c[i]);
    ddt[row0 + i] = ddta[row0 + i] + v[row0 + i] * tail + av * (float)dcum[i];
    part += (double)dt[row0 + i] * dcum[i];
  }
  const double da = block_sum<ROW_THREADS>(part, red);
  if (threadIdx.x == 0) da_part[cell] = da;
}

// ---------------------------------------------------------------------------
// the sum: dB and dC over the slices' partial sums (and dC over the s
// tiles at or before each row), da over the chunks, in a fixed order
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ db_part,
                                      const float* __restrict__ dc_part,
                                      const double* __restrict__ da_part, T* __restrict__ db,
                                      T* __restrict__ dc, float* __restrict__ da, long long BG,
                                      int NC, int L, int N, int slices, int sparts, int BH) {
  const long long per = (long long)L * N, total = BG * NC * per;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
    const long long cell = idx / per, rest = idx - cell * per;
    const int t = static_cast<int>(rest / N);
    const int jmax = min(sparts, t / TILE + 1);
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < slices; ++k) {
      const long long part = cell * slices + k;
      sb += db_part[part * per + rest];
      for (int j = 0; j < jmax; ++j) sc += dc_part[(part * sparts + j) * per + rest];
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
           void* dc, float* da, long long BG, int NC, int L, int N, int slices, int sparts,
           int BH, cudaStream_t stream) {
  const long long total = BG * NC * L * N;
  const long long n = total > BH ? total : BH;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_reduce_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      db_part, dc_part, da_part, static_cast<T*>(db), static_cast<T*>(dc), da, BG, NC, L,
      N, slices, sparts, BH);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// blocks of pass A an SM holds at once times the SMs
template <typename K>
cudaError_t resident(K kernel, int threads, size_t smem, int* out) {
  cudaError_t e = prepare(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return e;
}

bool shape_ok(int L, int P, int N, int dtype) {
  if (L <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N) return false;
  if (dtype == 1) return tc_layout(L, P, N).total <= (size_t)SMEM_MAX;
  return dtype == 0 && smem_bytes(L, P, N) <= (size_t)SMEM_MAX;
}

}  // namespace

// How many blocks of pass A the current device holds at once (blocks an SM
// times SMs) for these shapes, into *out: the wrapper's plan reads it.
extern "C" int ssd_chunks_bwd_resident(int L, int P, int N, int dtype, int* out) {
  *out = 0;
  if (!shape_ok(L, P, N, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dtype == 1
      ? resident(ssd_bwd_kernel_mma, TC_THREADS, tc_layout(L, P, N).total, out)
      : resident(ssd_bwd_kernel, THREADS, smem_bytes(L, P, N), out));
}

// Whether pass A's shared memory holds these shapes (the wrapper raises
// before allocating otherwise).
extern "C" int ssd_chunks_bwd_takes(int L, int P, int N, int dtype) {
  return shape_ok(L, P, N, dtype);
}

// The gradients (dx, ddt, da, dB, dC) for the plan's `slices` head slices
// a group. Scratch from the wrapper (kernels/ssd/kernel.py,
// backward_scratch): db_part [BG, NC, slices, L, N] and dc_part [BG, NC,
// slices, sparts, L, N] fp32 (sparts = ceil(L / 64) for bf16, 1 for fp32);
// da_part [BH, NC] float64; for bf16 only, rows32 [4, BH, NC, L] fp32
// (cum, w, v, ddta) and rows64 float64 (colq [BH, NC, L], then the s
// tiles' row sums of Q [BH, NC, sparts, L]).
extern "C" int ssd_chunks_bwd(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, const void* gy,
                              const void* gs, const void* ge, void* dx, void* ddt,
                              void* da, void* db, void* dc, void* db_part,
                              void* dc_part, void* rows32, void* rows64, void* da_part,
                              int BH, int NC, int L, int P, int N, int nheads,
                              int ngroups, int slices, int dtype, void* stream) {
  if (BH <= 0 || NC <= 0 || nheads <= 0 || ngroups <= 0 || nheads % ngroups != 0 ||
      BH % nheads != 0 || slices <= 0 || slices > nheads / ngroups ||
      !shape_ok(L, P, N, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long BG = (long long)(BH / nheads) * ngroups;
  const int ns = (L + TILE - 1) / TILE;
  if (BG * NC * slices * ns > 0x7fffffffLL || (long long)BH * NC > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a);
  const float* f_gy = static_cast<const float*>(gy);
  const float* f_gs = static_cast<const float*>(gs);
  const float* f_ge = static_cast<const float*>(ge);
  float* f_dbp = static_cast<float*>(db_part);
  float* f_dcp = static_cast<float*>(dc_part);
  double* f_dap = static_cast<double*>(da_part);
  const int cells = BH * NC;
  int err;
  if (dtype == 0) {
    const size_t smem = smem_bytes(L, P, N);
    if ((err = static_cast<int>(prepare(ssd_bwd_kernel, smem))) != 0) return err;
    ssd_bwd_kernel<<<(unsigned)(BG * NC * slices), THREADS, smem, st>>>(
        static_cast<const float*>(x), f_dt, f_a, static_cast<const float*>(b),
        static_cast<const float*>(c), f_gy, f_gs, f_ge, static_cast<float*>(dx),
        static_cast<float*>(ddt), f_dap, f_dbp, f_dcp, NC, L, P, N, nheads, ngroups, slices);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    return reduce<float>(f_dbp, f_dcp, f_dap, db, dc, static_cast<float*>(da), BG, NC, L, N,
                         slices, 1, BH, st);
  }
  const size_t n_rows = (size_t)cells * L;
  float* r_cum = static_cast<float*>(rows32);
  float* r_w = r_cum + n_rows;
  float* r_v = r_w + n_rows;
  float* r_ddta = r_v + n_rows;
  double* r_colq = static_cast<double*>(rows64);
  double* r_q = r_colq + n_rows;
  const size_t prep_smem = (ROW_THREADS / 32) * sizeof(double) + 2 * (size_t)L * sizeof(float);
  const size_t rows_smem = (ROW_THREADS / 32 + (size_t)L) * sizeof(double);
  const size_t smem = tc_layout(L, P, N).total;
  if ((err = static_cast<int>(prepare(ssd_bwd_prep_kernel, prep_smem))) != 0) return err;
  if ((err = static_cast<int>(prepare(ssd_bwd_rows_kernel, rows_smem))) != 0) return err;
  if ((err = static_cast<int>(prepare(ssd_bwd_kernel_mma, smem))) != 0) return err;
  ssd_bwd_prep_kernel<<<(unsigned)cells, ROW_THREADS, prep_smem, st>>>(f_dt, f_a, r_cum, r_w,
                                                                      NC, L);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  ssd_bwd_kernel_mma<<<(unsigned)(BG * NC * slices * ns), TC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), f_dt, static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), f_gy, f_gs, r_cum, r_w,
      static_cast<__nv_bfloat16*>(dx), r_v, r_ddta, r_colq, r_q, f_dbp, f_dcp, (int)BG, NC, L,
      P, N, nheads, ngroups, slices);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  ssd_bwd_rows_kernel<<<(unsigned)cells, ROW_THREADS, rows_smem, st>>>(
      f_dt, f_a, f_ge, r_cum, r_w, r_v, r_ddta, r_colq, r_q, static_cast<float*>(ddt), f_dap,
      NC, L);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  return reduce<__nv_bfloat16>(f_dbp, f_dcp, f_dap, db, dc, static_cast<float*>(da), BG, NC, L,
                               N, slices, ns, BH, st);
}
