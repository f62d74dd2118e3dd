// The backward of one flash_carry hop: the gradients of (m_new, l_new,
// acc_new) = flash_carry(q, k, v, m, l, acc) in q, k, v and the carried
// state, for the cotangents (g_m, g_l, g_acc).
//
// Replaces no Pallas kernel. The reference differentiates its hop through
// a custom VJP whose backward is jax.vjp of the jnp oracle
// (repro/kernels/flash_attention/ops.py:129-131, _carry_reference at :85),
// which XLA compiles into fused code; this kernel computes that VJP, so
// that no training step on the card differentiates the plain twin.
//
// With s the masked, scaled scores (sentinel -1e30), p = exp(s - m_new),
// corr = exp(m - m_new) and r = g_m - g_l l_new - g_acc . acc_new:
//   dP_ij = g_l_i + g_acc_i . v_j         dV_j = sum_i p_ij g_acc_i
//   dS_ij = p_ij dP_ij + (max route)      (0 where key j is masked for i)
//   dQ_i  = scale sum_j dS_ij k_j         dK_j = scale sum_i dS_ij q_i
//   g_l_in = g_l corr, g_acc_in = g_acc corr,
//   g_m_in = corr (g_l l + g_acc . acc) + (max route)
// m_new = maximum(m, amax(s)) passes r on as torch and JAX do: all to m
// where m exceeds the block's max M, all to the live keys whose score ties
// M (split equally) where M exceeds m, half to each side where they are
// equal. M is the max over live keys (the sentinel where there is none:
// the masked keys tie there and pass nothing on).
//
// Layouts as in flash_carry.cu; the state, the saved outputs and the
// cotangents are fp32 contiguous. dq is [B', Sq, H, D] in q's type, dk and
// dv [Bk, T, Kv, D] in k's type, all contiguous.
//
// Two passes, no atomics (the gradients are bit-identical run to run):
// * pass A, one block per (query row b', KV head, 64 flattened query rows):
//   one sweep over the live key tiles accumulates dQ without the max route
//   and finds each row's M, its tie count and first tied key; then the
//   state gradients, r and the tie weight w are written (w and M to
//   scratch for pass B), and w times the tied keys is added to dQ: the one
//   tied key's row where there is one (the rule), a second sweep over the
//   ties where a row of the block has several. (The CUDA-core body sweeps
//   twice, the tally first.)
// * pass B, one block per (K/V row, KV head, key tile): a fixed-order loop
//   over the query rows that read the K/V row (grouped by the wrapper),
//   their group heads and query tiles accumulates dK and dV.
// Both passes recompute S and P from the saved m_new. A row whose m_new is
// still the sentinel has p = 1 on its (all masked) keys: those feed dV but
// not dQ/dK, so pass B skips a dead tile only when every row of the query
// tile holds a real max (pass A's per-tile flag); pass A skips every dead
// tile.
//
// What bounds it on an H100: at qwen3-0.6b's training hop (q
// [32,256,16,128], k/v [32,256,8,128] bf16) the bytes are ~0.41 GB, most
// of them the four fp32 acc-sized tensors (acc, acc_new, g_acc, g_acc_in),
// ~0.12 ms at 3.35 TB/s; the five products (12 D operations a pair as the
// reference's VJP counts them) are ~0.05 ms on the tensor cores. Two
// bodies, chosen as the forward's are:
// * bf16 q and K/V with Sq > 1 at D = 64 or 128 (every training hop):
//   mma.sync.m16n8k16 (bf16 operands, fp32 accumulation, as FlashAttention-2
//   takes them), cp.async double buffering into padded shared memory read
//   by ldmatrix. Pass A keeps a warp's 16 query rows of q and g_acc as A
//   fragments in registers, as the forward keeps q. Pass B computes S and
//   dP with the query rows as the mma's M side, exactly as pass A and the
//   forward do, so every score and every tie test is bit for bit the same
//   in both passes; P and dS are rounded to bf16 and transposed in
//   registers (movmatrix) into the A fragments of dV = P^T G and
//   dK = dS^T Q. g_acc is rounded to bf16 once, in pass A, into scratch.
//   A tile whose keys are live for every row of its block takes no mask,
//   and p is exp2 on the special-function unit (relative error ~2^-22
//   against the bf16 gradients' 2^-7 bound; the state gradients do not
//   depend on p). At D = 64 pass B keeps the warp's K and V fragments in
//   registers.
// * everything else (fp32 operands, other head dims up to 128, Sq = 1):
//   fp32 FMAs on the CUDA cores, pass A with the key range split across
//   warps (a lane per key) and pass B with the query rows split across
//   warps (a lane per query row); the warps' partials are summed in a
//   fixed order in shared memory. Both compute a score as the same
//   ascending chain of fmaf, so their tie tests agree.
//
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 128;     // head_dim limit
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool key_ok(int kp, int qp, int kl, int causal, int window) {
  bool ok = kp < kl;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp < window);
  return ok;
}

// Whether keys k_off + [t0, t0 + nt) are masked for every query position
// in [qpos_min, qpos_max].
__device__ __forceinline__ bool tile_dead(int t0, int nt, int ko, int kl, int qpos_min,
                                          int qpos_max, int causal, int window) {
  const int kp_lo = ko + t0, kp_hi = ko + t0 + nt - 1;
  return kp_lo >= kl || (causal && kp_lo > qpos_max) ||
         (window > 0 && qpos_min - kp_hi >= window);
}

// the position range of flattened rows [r0, r0 + nr) (row r is position
// r % Sq); rows that wrap into the next group cover every position
__device__ __forceinline__ void position_range(int r0, int nr, int Sq, int& s_min,
                                               int& s_max) {
  const int last = r0 + nr - 1;
  if (r0 / Sq == last / Sq) {
    s_min = r0 % Sq;
    s_max = last % Sq;
  } else {
    s_min = 0;
    s_max = Sq - 1;
  }
}

// (max, count) of two partial tie tallies
__device__ __forceinline__ void merge_tie(float& mx, int& cnt, float mx2, int cnt2) {
  if (mx2 > mx) {
    mx = mx2;
    cnt = cnt2;
  } else if (mx2 == mx) {
    cnt += cnt2;
  }
}

// The max route of r: the part that goes to m, and the weight w that each
// tied live score gets. M = -inf (no live key) stands for the sentinel the
// masked keys hold.
__device__ __forceinline__ void max_route(float m, float M, int cnt, float r, float& to_m,
                                          float& w, float& M_out) {
  M = cnt > 0 ? M : NEG;
  const float ts = M > m ? 1.f : (M == m ? 0.5f : 0.f);
  to_m = (1.f - ts) * r;
  w = cnt > 0 ? ts * r / (float)cnt : 0.f;
  M_out = M;
}

struct Args {
  const void *q, *k, *v;
  long long q_sb, q_ss, q_sh, kv_sb, kv_st, kv_sh;
  const int *kv_row, *order, *start, *q_off, *k_off, *klen;
  int T;
  const float *m, *l, *acc, *m_new, *l_new, *acc_new, *g_m, *g_l, *g_acc;
  void *dq, *dk, *dv;
  float *dm, *dl, *dacc;
  float *tie_max, *tie_w;     // [B', H, Sq]: pass A -> pass B
  __nv_bfloat16* g16;         // [B', H, Sq, D]: g_acc in bf16 (tensor-core body)
  int* resolved;              // [B', Kv, row tiles] (tensor-core body)
  int Bp, Bk, H, Kv, Sq, D, causal, window;
  float scale;
};

// ---------------------------------------------------------------------------
// tensor-core body: mma.sync on bf16
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 64, TC_KEYS = 64, TC_THREADS = 128;

template <int D>
struct TcTile {
  static constexpr int ROW = D + 8;                  // padded row, bf16 elements
  static constexpr int TILE = 64 * ROW;              // one 64-row tile
  static constexpr int SMEM_A = 2 * 2 * TILE * 2;    // 2 stages x (K, V), bytes
  // K, V of the block's keys; 2 stages x (Q, G) and the per-row scalars
  static constexpr int SCAL = 5 * TC_ROWS;           // mn, g_l, M, w (fp32), s (int)
  static constexpr int SMEM_B = 2 * TILE * 2 + 2 * 2 * TILE * 2 + 2 * SCAL * 4;
};

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

// the transpose of an 8x8 bf16 fragment (lane: row lane/4, columns
// 2(lane%4), +1), in the same layout
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether keys k_off + [t0, t0 + 64) all lie in the block and are live for
// every query position in [qpos_min, qpos_max]: the tile needs no mask.
__device__ __forceinline__ bool tile_live(int t0, int T, int ko, int kl, int qpos_min,
                                          int qpos_max, int causal, int window) {
  const long long lo = (long long)ko + t0, hi = lo + 64 - 1;
  return t0 + 64 <= T && hi < kl && (!causal || hi <= qpos_min) &&
         (window <= 0 || qpos_max - lo < window);
}

// Pass A: dQ and the state gradients of 64 flattened query rows. At D = 64
// three blocks share an SM (168 registers, a few spilled: faster than two
// blocks at 240 registers, with the same bits).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, D == 64 ? 3 : 2)
flash_carry_bwd_kernel_rows_mma(const Args a) {
  using Tile = TcTile<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = a.H / a.Kv, Sq = a.Sq, T = a.T, rows = G * Sq;
  const int r0 = blockIdx.x * TC_ROWS, nr = min(TC_ROWS, rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qo = a.q_off[b], ko = a.k_off[b], kl = a.klen[b];
  const long long kv_base = (long long)a.kv_row[b] * a.kv_sb + (long long)kvh * a.kv_sh;

  // this lane's rows: e = 0 (fragment rows 0-7) and e = 1 (rows 8-15)
  bool rv[2];
  int qp[2], hh[2], ss[2];
  size_t si[2];
  float mn[2], gl[2], corr[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rr = r0 + warp * 16 + (lane >> 2) + 8 * e;
    rv[e] = rr < rows;
    const int g = rv[e] ? rr / Sq : 0, s = rv[e] ? rr % Sq : 0;
    hh[e] = kvh * G + g;
    ss[e] = s;
    qp[e] = qo + s;
    si[e] = ((size_t)b * a.H + hh[e]) * Sq + s;
    mn[e] = rv[e] ? a.m_new[si[e]] : 0.f;
    gl[e] = rv[e] ? a.g_l[si[e]] : 0.f;
    corr[e] = rv[e] ? expf(a.m[si[e]] - mn[e]) : 0.f;
  }
  const bool res = (!rv[0] || mn[0] > NEG) && (!rv[1] || mn[1] > NEG);
  const bool all_resolved = __syncthreads_and(res);
  if (tid == 0)
    a.resolved[((size_t)b * a.Kv + kvh) * gridDim.x + blockIdx.x] = all_resolved;
  int s_min, s_max;
  position_range(r0, nr, Sq, s_min, s_max);
  const int qpos_min = qo + s_min, qpos_max = qo + s_max;

  // g_acc . acc and g_acc . acc_new; g_acc_in = g_acc corr; the bf16 copy
  // of g_acc. Lane (lane & 3) of a quad takes a quarter of both rows.
  float dot_a[2], dot_n[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float s1 = 0.f, s2 = 0.f;
    if (rv[e]) {
      const size_t base = si[e] * D;
      for (int c = (lane & 3) * (D / 4); c < ((lane & 3) + 1) * (D / 4); c += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(a.g_acc + base + c);
        const float4 a4 = *reinterpret_cast<const float4*>(a.acc + base + c);
        const float4 n4 = *reinterpret_cast<const float4*>(a.acc_new + base + c);
        s1 = fmaf(g4.x, a4.x, s1); s1 = fmaf(g4.y, a4.y, s1);
        s1 = fmaf(g4.z, a4.z, s1); s1 = fmaf(g4.w, a4.w, s1);
        s2 = fmaf(g4.x, n4.x, s2); s2 = fmaf(g4.y, n4.y, s2);
        s2 = fmaf(g4.z, n4.z, s2); s2 = fmaf(g4.w, n4.w, s2);
        *reinterpret_cast<float4*>(a.dacc + base + c) =
            make_float4(g4.x * corr[e], g4.y * corr[e], g4.z * corr[e], g4.w * corr[e]);
        uint2 u;
        u.x = pack_bf16(g4.x, g4.y);
        u.y = pack_bf16(g4.z, g4.w);
        *reinterpret_cast<uint2*>(a.g16 + base + c) = u;
      }
    }
    s1 += __shfl_xor_sync(FULL, s1, 1);
    s1 += __shfl_xor_sync(FULL, s1, 2);
    s2 += __shfl_xor_sync(FULL, s2, 1);
    s2 += __shfl_xor_sync(FULL, s2, 2);
    dot_a[e] = s1;
    dot_n[e] = s2;
  }

  // q and g_acc as mma A fragments: {(row0, c), (row8, c), (row0, c+8), (row8, c+8)}
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const __nv_bfloat16* qrow = q + b * a.q_sb + ss[e] * a.q_ss + hh[e] * a.q_sh;
      qf[kk][e] = rv[e] ? *reinterpret_cast<const uint32_t*>(qrow + c) : 0u;
      qf[kk][2 + e] = rv[e] ? *reinterpret_cast<const uint32_t*>(qrow + c + 8) : 0u;
      const float* grow = a.g_acc + si[e] * D;
      const float2 g0 = rv[e] ? *reinterpret_cast<const float2*>(grow + c) : make_float2(0.f, 0.f);
      const float2 g8 = rv[e] ? *reinterpret_cast<const float2*>(grow + c + 8) : make_float2(0.f, 0.f);
      gf[kk][e] = pack_bf16(g0.x, g0.y);
      gf[kk][2 + e] = pack_bf16(g8.x, g8.y);
    }
  }

  auto next_live = [&](int t0) {
    while (t0 < T && tile_dead(t0, min(TC_KEYS, T - t0), ko, kl, qpos_min, qpos_max,
                               a.causal, a.window))
      t0 += TC_KEYS;
    return t0;
  };
  auto load_tile = [&](int t0, int st, bool with_v) {
    __nv_bfloat16* ks = kv_s + (2 * st) * Tile::TILE;
    __nv_bfloat16* vs = ks + Tile::TILE;
    constexpr int CH = D / 8;                     // 16-byte chunks per key row
#pragma unroll
    for (int i = 0; i < TC_KEYS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, j = idx / CH, c = (idx % CH) * 8;
      const bool ok = t0 + j < T;
      const long long off = kv_base + (long long)(t0 + j) * a.kv_st + c;
      cp_async16(smem_u32(ks + j * Tile::ROW + c), ok ? k + off : k, ok);
      if (with_v) cp_async16(smem_u32(vs + j * Tile::ROW + c), ok ? v + off : v, ok);
    }
  };
  // One sweep over the live key tiles accumulates dQ from dS = p (dP +
  // g_l) and tallies each row's max over its live scores, the number of
  // keys that tie it and the first of them. The max route's part of dQ,
  // w times the tied keys, comes after: the one tied key's row read from
  // K where there is one, a second sweep over the ties alone (sweep 1)
  // where some row of the block has several.
  float bm[2] = {-INFINITY, -INFINITY}, w[2] = {0.f, 0.f};
  int bc[2] = {0, 0}, bj[2] = {0, 0};
  const float sl2 = a.scale * LOG2E, mb[2] = {mn[0] * LOG2E, mn[1] * LOG2E};
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  bool several = false;
  for (int sweep = 0; sweep < 1 + several; ++sweep) {
    const bool with_v = sweep == 0;
    int cur = next_live(0), st = 0;
    if (cur < T) load_tile(cur, 0, with_v);
    cp_async_commit();
    while (cur < T) {
      const int nxt = next_live(cur + TC_KEYS);
      if (nxt < T) load_tile(nxt, st ^ 1, with_v);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* ks = kv_s + (2 * st) * Tile::TILE;
      const __nv_bfloat16* vs = ks + Tile::TILE;
      // S = Q K^T for the warp's 16 rows x 64 keys: sc[j] is the C fragment
      // of keys j*8.. (the forward's order of products)
      float sc[TC_KEYS / 8][4];
#pragma unroll
      for (int j = 0; j < TC_KEYS / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < TC_KEYS / 16; ++jj) {
          uint32_t bk[4];
          const int key = jj * 16 + (lane & 7) + (lane >> 4) * 8;
          const int d = kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bk, smem_u32(ks + key * Tile::ROW + d));
          mma_bf16(sc[2 * jj], qf[kk], bk[0], bk[1]);
          mma_bf16(sc[2 * jj + 1], qf[kk], bk[2], bk[3]);
        }
      }
      // a tile live for every row of the block needs no mask (rows past the
      // block have q = g_acc = 0, so their dS is 0)
      const bool all_live = tile_live(cur, T, ko, kl, qpos_min, qpos_max, a.causal,
                                      a.window);
      if (sweep == 0) {
        // dS = p (dP + g_l), by 16 keys: dP = g_acc V^T
#pragma unroll
        for (int jj = 0; jj < TC_KEYS / 16; ++jj) {
          float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t bv[4];
            const int key = jj * 16 + (lane & 7) + (lane >> 4) * 8;
            const int d = kk * 16 + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(bv, smem_u32(vs + key * Tile::ROW + d));
            mma_bf16(dp[0], gf[kk], bv[0], bv[1]);
            mma_bf16(dp[1], gf[kk], bv[2], bv[3]);
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int j = 2 * jj + h2;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = i >> 1, key = cur + j * 8 + (lane & 3) * 2 + (i & 1);
              const bool live = all_live || (key < T && rv[e] &&
                                             key_ok(ko + key, qp[e], kl, a.causal, a.window));
              const float s = sc[j][i] * a.scale;
              if (live) {
                if (s > bm[e]) {
                  bm[e] = s;
                  bc[e] = 1;
                  bj[e] = key;
                } else if (s == bm[e]) {
                  ++bc[e];
                }
              }
              const float p = ex2(fmaf(sc[j][i], sl2, -mb[e]));
              sc[j][i] = live ? p * (dp[h2][i] + gl[e]) : 0.f;
            }
          }
        }
      } else {
        // the ties alone: dS = w where s equals the row's max
#pragma unroll
        for (int j = 0; j < TC_KEYS / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i >> 1, key = cur + j * 8 + (lane & 3) * 2 + (i & 1);
            const bool live = all_live || (key < T && rv[e] &&
                                           key_ok(ko + key, qp[e], kl, a.causal, a.window));
            sc[j][i] = live && bc[e] > 1 && sc[j][i] * a.scale == bm[e] ? w[e] : 0.f;
          }
        }
      }
      // dQ += dS K, 16 keys per step
#pragma unroll
      for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
        uint32_t af[4];
        af[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        af[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        af[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        af[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
          uint32_t bk[4];
          const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int d = jd * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bk, smem_u32(ks + key * Tile::ROW + d));
          mma_bf16(dq[2 * jd], af, bk[0], bk[1]);
          mma_bf16(dq[2 * jd + 1], af, bk[2], bk[3]);
        }
      }
      __syncthreads();                          // stage st is refilled next
      cur = nxt;
      st ^= 1;
    }
    if (sweep == 0) {
      bool more = false;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          const float m2 = __shfl_xor_sync(FULL, bm[e], x);
          const int c2 = __shfl_xor_sync(FULL, bc[e], x);
          const int j2 = __shfl_xor_sync(FULL, bj[e], x);
          if (m2 > bm[e] || (m2 == bm[e] && c2 > 0 && (bc[e] == 0 || j2 < bj[e]))) bj[e] = j2;
          merge_tie(bm[e], bc[e], m2, c2);
        }
        float to_m = 0.f, M = NEG;
        if (rv[e]) {
          const float r = a.g_m[si[e]] - gl[e] * a.l_new[si[e]] - dot_n[e];
          max_route(a.m[si[e]], bm[e], bc[e], r, to_m, w[e], M);
          if ((lane & 3) == 0) {
            a.dm[si[e]] = corr[e] * (gl[e] * a.l[si[e]] + dot_a[e]) + to_m;
            a.dl[si[e]] = gl[e] * corr[e];
            a.tie_max[si[e]] = M;
            a.tie_w[si[e]] = w[e];
          }
        }
        bm[e] = M;                // a live score ties iff it equals M
        if (rv[e] && w[e] != 0.f && bc[e] == 1) {
          // the one tied key: dQ += w k (fp32, before the final scale)
          const __nv_bfloat16* krow = k + kv_base + (long long)bj[e] * a.kv_st;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const float2 kv2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(krow + j * 8 + (lane & 3) * 2));
            dq[j][2 * e] = fmaf(w[e], kv2.x, dq[j][2 * e]);
            dq[j][2 * e + 1] = fmaf(w[e], kv2.y, dq[j][2 * e + 1]);
          }
        }
        more = more || (rv[e] && w[e] != 0.f && bc[e] > 1);
      }
      several = __syncthreads_or(more);
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!rv[e]) continue;
    __nv_bfloat16* row = out + (((size_t)b * Sq + ss[e]) * a.H + hh[e]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(row + j * 8 + (lane & 3) * 2, dq[j][2 * e] * a.scale, dq[j][2 * e + 1] * a.scale);
  }
}

// Pass B: dK and dV of 64 keys of one (K/V row, KV head); warp w owns keys
// 16w..16w+15.
template <int D, typename TO>
__global__ void __launch_bounds__(TC_THREADS)
flash_carry_bwd_kernel_keys_mma(const Args a) {
  using Tile = TcTile<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + Tile::TILE;
  __nv_bfloat16* qg_s = vs + Tile::TILE;                  // [stage][Q, G] tiles
  float* scal = reinterpret_cast<float*>(qg_s + 4 * Tile::TILE);   // [stage][5][64]
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const int kr = blockIdx.z, kvh = blockIdx.y, t0 = blockIdx.x * TC_KEYS;
  const int nt = min(TC_KEYS, a.T - t0);
  const int G = a.H / a.Kv, Sq = a.Sq, T = a.T, rows = G * Sq;
  const int ntile = (rows + TC_ROWS - 1) / TC_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int CH = D / 8;                       // 16-byte chunks per row

  {
    const long long kv_base = (long long)kr * a.kv_sb + (long long)kvh * a.kv_sh;
#pragma unroll
    for (int i = 0; i < TC_KEYS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, j = idx / CH, c = (idx % CH) * 8;
      const bool ok = j < nt;
      const long long off = kv_base + (long long)(t0 + j) * a.kv_st + c;
      cp_async16(smem_u32(ks + j * Tile::ROW + c), ok ? k + off : k, ok);
      cp_async16(smem_u32(vs + j * Tile::ROW + c), ok ? v + off : v, ok);
    }
    cp_async_commit();
  }

  const int i0 = a.start[kr], n_items = (a.start[kr + 1] - i0) * ntile;
  auto needed = [&](int n) {
    const int b = a.order[i0 + n / ntile], tile = n % ntile, r0 = tile * TC_ROWS;
    int s_min, s_max;
    position_range(r0, min(TC_ROWS, rows - r0), Sq, s_min, s_max);
    const int qo = a.q_off[b];
    return !(tile_dead(t0, nt, a.k_off[b], a.klen[b], qo + s_min, qo + s_max, a.causal,
                       a.window) &&
             a.resolved[((size_t)b * a.Kv + kvh) * ntile + tile]);
  };
  auto next_needed = [&](int n) {
    while (n < n_items && !needed(n)) ++n;
    return n;
  };
  auto load_item = [&](int n, int st) {
    const int b = a.order[i0 + n / ntile], r0 = (n % ntile) * TC_ROWS;
    __nv_bfloat16* qs = qg_s + (2 * st) * Tile::TILE;
    __nv_bfloat16* gs = qs + Tile::TILE;
#pragma unroll
    for (int i = 0; i < TC_ROWS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, j = idx / CH, c = (idx % CH) * 8;
      const int rr = r0 + j;
      const bool ok = rr < rows;
      const int g = ok ? rr / Sq : 0, s = ok ? rr % Sq : 0, h = kvh * G + g;
      const __nv_bfloat16* qsrc = q + b * a.q_sb + s * a.q_ss + h * a.q_sh + c;
      const __nv_bfloat16* gsrc = a.g16 + (((size_t)b * a.H + h) * Sq + s) * D + c;
      cp_async16(smem_u32(qs + j * Tile::ROW + c), ok ? qsrc : q, ok);
      cp_async16(smem_u32(gs + j * Tile::ROW + c), ok ? gsrc : a.g16, ok);
    }
    if (tid < TC_ROWS) {
      float* sc = scal + st * Tile::SCAL;
      const int rr = r0 + tid;
      const bool ok = rr < rows;
      const int g = ok ? rr / Sq : 0, s = ok ? rr % Sq : 0;
      const size_t si = ((size_t)b * a.H + kvh * G + g) * Sq + s;
      cp_async4(smem_u32(sc + tid), a.m_new + si, ok);
      cp_async4(smem_u32(sc + TC_ROWS + tid), a.g_l + si, ok);
      cp_async4(smem_u32(sc + 2 * TC_ROWS + tid), a.tie_max + si, ok);
      cp_async4(smem_u32(sc + 3 * TC_ROWS + tid), a.tie_w + si, ok);
      reinterpret_cast<int*>(sc)[4 * TC_ROWS + tid] = ok ? s : -1;
    }
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  // At D = 64 the warp's K and V B fragments (the same for every query
  // tile) stay in registers; at D = 128 they are read per use, for room
  constexpr bool KV_REGS = D == 64;
  uint32_t kb[KV_REGS ? D / 16 : 1][4], vb[KV_REGS ? D / 16 : 1][4];
  const int kv_key = warp * 16 + (lane & 7) + (lane >> 4) * 8;
  if constexpr (KV_REGS) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int d = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(kb[kk], smem_u32(ks + kv_key * Tile::ROW + d));
      ldmatrix_x4(vb[kk], smem_u32(vs + kv_key * Tile::ROW + d));
    }
  }
  int cur = next_needed(0), st = 0;
  if (cur < n_items) load_item(cur, 0);
  cp_async_commit();
  while (cur < n_items) {
    const int nxt = next_needed(cur + 1);
    if (nxt < n_items) load_item(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* qs = qg_s + (2 * st) * Tile::TILE;
    const __nv_bfloat16* gs = qs + Tile::TILE;
    const float* sc = scal + st * Tile::SCAL;
    const int* spos = reinterpret_cast<const int*>(sc) + 4 * TC_ROWS;
    const int b = a.order[i0 + cur / ntile];
    const int r0 = (cur % ntile) * TC_ROWS;
    const int qo = a.q_off[b], ko = a.k_off[b], kl = a.klen[b];
    int s_min, s_max;
    position_range(r0, min(TC_ROWS, rows - r0), Sq, s_min, s_max);
    // the block's keys live for every query of the tile: no mask
    const bool all_live = tile_live(t0, T, ko, kl, qo + s_min, qo + s_max, a.causal,
                                    a.window);
    for (int ch = 0; ch < TC_ROWS / 16 && r0 + ch * 16 < rows; ++ch) {
      // S and dP for 16 query rows (M side) x the warp's 16 keys, as pass A
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4], bk[4];
        const int row = ch * 16 + (lane & 15), ac = kk * 16 + (lane >> 4) * 8;
        const int d = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af, smem_u32(qs + row * Tile::ROW + ac));
        if constexpr (KV_REGS) {
          mma_bf16(s[0], af, kb[kk][0], kb[kk][1]);
          mma_bf16(s[1], af, kb[kk][2], kb[kk][3]);
        } else {
          ldmatrix_x4(bk, smem_u32(ks + kv_key * Tile::ROW + d));
          mma_bf16(s[0], af, bk[0], bk[1]);
          mma_bf16(s[1], af, bk[2], bk[3]);
        }
        ldmatrix_x4(af, smem_u32(gs + row * Tile::ROW + ac));
        if constexpr (KV_REGS) {
          mma_bf16(dp[0], af, vb[kk][0], vb[kk][1]);
          mma_bf16(dp[1], af, vb[kk][2], vb[kk][3]);
        } else {
          ldmatrix_x4(bk, smem_u32(vs + kv_key * Tile::ROW + d));
          mma_bf16(dp[0], af, bk[0], bk[1]);
          mma_bf16(dp[1], af, bk[2], bk[3]);
        }
      }
      // P and dS of the 16 x 16 pairs
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ch * 16 + (lane >> 2) + 8 * (i >> 1);
          const int key = t0 + warp * 16 + h2 * 8 + (lane & 3) * 2 + (i & 1);
          const int sp = spos[row];
          const bool in = key < T && sp >= 0;
          const bool live =
              in && (all_live || key_ok(ko + key, qo + sp, kl, a.causal, a.window));
          const float sv = live ? s[h2][i] * a.scale : NEG;
          const float p = in ? ex2((sv - sc[row]) * LOG2E) : 0.f;
          s[h2][i] = p;
          dp[h2][i] = live ? p * (dp[h2][i] + sc[TC_ROWS + row]) +
                                 (sv == sc[2 * TC_ROWS + row] ? sc[3 * TC_ROWS + row] : 0.f)
                           : 0.f;
        }
      }
      // P^T and dS^T as A fragments (keys x rows)
      uint32_t pt[4], dst[4];
      pt[0] = movtrans(pack_bf16(s[0][0], s[0][1]));
      pt[1] = movtrans(pack_bf16(s[1][0], s[1][1]));
      pt[2] = movtrans(pack_bf16(s[0][2], s[0][3]));
      pt[3] = movtrans(pack_bf16(s[1][2], s[1][3]));
      dst[0] = movtrans(pack_bf16(dp[0][0], dp[0][1]));
      dst[1] = movtrans(pack_bf16(dp[1][0], dp[1][1]));
      dst[2] = movtrans(pack_bf16(dp[0][2], dp[0][3]));
      dst[3] = movtrans(pack_bf16(dp[1][2], dp[1][3]));
      // dV += P^T G, dK += dS^T Q
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t bf[4];
        const int row = ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int d = jd * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf, smem_u32(gs + row * Tile::ROW + d));
        mma_bf16(dv[2 * jd], pt, bf[0], bf[1]);
        mma_bf16(dv[2 * jd + 1], pt, bf[2], bf[3]);
        ldmatrix_x4_trans(bf, smem_u32(qs + row * Tile::ROW + d));
        mma_bf16(dk[2 * jd], dst, bf[0], bf[1]);
        mma_bf16(dk[2 * jd + 1], dst, bf[2], bf[3]);
      }
    }
    __syncthreads();                            // stage st is refilled next
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

  TO* dk_out = static_cast<TO*>(a.dk);
  TO* dv_out = static_cast<TO*>(a.dv);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = t0 + warp * 16 + (lane >> 2) + 8 * e;
    if (key >= T) continue;
    const size_t base = (((size_t)kr * T + key) * a.Kv + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      store2(dk_out + base + c, dk[j][2 * e] * a.scale, dk[j][2 * e + 1] * a.scale);
      store2(dv_out + base + c, dv[j][2 * e], dv[j][2 * e + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core body: fp32 FMAs
// ---------------------------------------------------------------------------

constexpr int SC_RB = 8;      // pass A: flattened query rows per block
constexpr int SC_KB = 8;      // pass B: keys per block
constexpr int SC_WARPS = 4;
constexpr int SC_THREADS = SC_WARPS * 32;
constexpr int SC_KEYS = 32;   // pass A: keys per warp tile (one per lane)
constexpr int QROW = DMAX + 1;  // pass B: padded fp32 row (a lane per row)

template <typename TKV>
struct ScA {
  static constexpr int ROW = DMAX + 16 / sizeof(TKV);      // padded key row
  static constexpr int TILE = SC_KEYS * ROW;
  static constexpr int QG_BYTES = 2 * SC_RB * DMAX * 4;    // Qs, Gs (fp32)
  static constexpr int KV_BYTES = SC_WARPS * 2 * TILE * sizeof(TKV);
  static constexpr int MERGE_BYTES = SC_WARPS * SC_RB * (DMAX + 2) * 4;
  static constexpr int SMEM =
      QG_BYTES + (KV_BYTES > MERGE_BYTES ? KV_BYTES : MERGE_BYTES);
};
struct ScB {
  static constexpr int KV_BYTES = 2 * SC_KB * DMAX * 4;              // Ks, Vs (fp32)
  static constexpr int QG_BYTES = SC_WARPS * 2 * 32 * QROW * 4;      // per warp Q, G
  static constexpr int MERGE_BYTES = SC_WARPS * 2 * SC_KB * DMAX * 4;
  static constexpr int SMEM =
      KV_BYTES + (QG_BYTES > MERGE_BYTES ? QG_BYTES : MERGE_BYTES);
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Pass A: dQ and the state gradients of 8 flattened query rows; the key
// range is split across the warps, a lane per key of a 32-key tile.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(SC_THREADS)
flash_carry_bwd_kernel_rows_simt(const Args a) {
  using Cfg = ScA<TKV>;
  constexpr int W = SC_WARPS, VN = 16 / sizeof(TKV), DC = DMAX / 32;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);                  // [RB][DMAX]
  float* Gs = Qs + SC_RB * DMAX;                                   // [RB][DMAX]
  uint8_t* region = smem_raw + Cfg::QG_BYTES;                      // K/V, then merge
  __shared__ float r_m[SC_RB], r_mn[SC_RB], r_gl[SC_RB], r_w[SC_RB], r_M[SC_RB];
  __shared__ float w_bm[W][SC_RB];
  __shared__ int w_bc[W][SC_RB];
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const int b = blockIdx.z, kvh = blockIdx.y, D = a.D;
  const int G = a.H / a.Kv, Sq = a.Sq, T = a.T, rows = G * Sq;
  const int r0 = blockIdx.x * SC_RB, nr = min(SC_RB, rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qo = a.q_off[b], ko = a.k_off[b], kl = a.klen[b];
  const long long kv_base = (long long)a.kv_row[b] * a.kv_sb + (long long)kvh * a.kv_sh;
  auto row_index = [&](int r) {
    const int rr = r0 + r, g = rr / Sq, s = rr % Sq;
    return ((size_t)b * a.H + kvh * G + g) * Sq + s;
  };

  for (int idx = tid; idx < SC_RB * DMAX; idx += SC_THREADS) {
    const int r = idx / DMAX, d = idx % DMAX;
    float qv = 0.f, gv = 0.f;
    if (r < nr && d < D) {
      const int rr = r0 + r, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
      qv = to_f(q[b * a.q_sb + s * a.q_ss + h * a.q_sh + d]);
      gv = a.g_acc[row_index(r) * D + d];
    }
    Qs[idx] = qv;
    Gs[idx] = gv;
  }
  if (tid < SC_RB) {
    const bool ok = tid < nr;
    r_m[tid] = ok ? a.m[row_index(tid)] : 0.f;
    r_mn[tid] = ok ? a.m_new[row_index(tid)] : 0.f;
    r_gl[tid] = ok ? a.g_l[row_index(tid)] : 0.f;
  }
  __syncthreads();
  int s_min, s_max;
  position_range(r0, nr, Sq, s_min, s_max);
  const int qpos_min = qo + s_min, qpos_max = qo + s_max;

  // per row: g_acc_in, g_acc . acc and g_acc . acc_new (a warp per row)
  float* dots = reinterpret_cast<float*>(region);    // [RB][2], before K/V use
  for (int r = warp; r < nr; r += W) {
    const size_t base = row_index(r) * D;
    const float corr = expf(r_m[r] - r_mn[r]);
    float s1 = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float gv = Gs[r * DMAX + d];
      s1 = fmaf(gv, a.acc[base + d], s1);
      s2 = fmaf(gv, a.acc_new[base + d], s2);
      a.dacc[base + d] = gv * corr;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      dots[2 * r] = s1;
      dots[2 * r + 1] = s2;
    }
  }
  __syncthreads();
  if (tid < nr) {
    const size_t si = row_index(tid);
    const float corr = expf(r_m[tid] - r_mn[tid]);
    const float dot_a = dots[2 * tid], dot_n = dots[2 * tid + 1];
    // r, the max route and the state gradients wait for the tie tally
    r_w[tid] = a.g_m[si] - r_gl[tid] * a.l_new[si] - dot_n;
    r_M[tid] = corr * (r_gl[tid] * a.l[si] + dot_a);
  }
  __syncthreads();

  TKV* ks = reinterpret_cast<TKV*>(region) + warp * 2 * Cfg::TILE;
  TKV* vs = ks + Cfg::TILE;
  const int CH = D / VN;                                 // 16-byte chunks per row
  float bm[SC_RB], dq[SC_RB][DC];
  int bc[SC_RB];
#pragma unroll
  for (int r = 0; r < SC_RB; ++r) {
    bm[r] = -INFINITY;
    bc[r] = 0;
#pragma unroll
    for (int i = 0; i < DC; ++i) dq[r][i] = 0.f;
  }
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int t0 = warp * SC_KEYS; t0 < T; t0 += W * SC_KEYS) {
      const int nt = min(SC_KEYS, T - t0);
      if (tile_dead(t0, nt, ko, kl, qpos_min, qpos_max, a.causal, a.window))
        continue;                                         // uniform across the warp
      for (int idx = lane; idx < SC_KEYS * CH; idx += 32) {
        const int j = idx / CH, c = (idx % CH) * VN;
        const bool ok = j < nt;
        const long long off = kv_base + (long long)(t0 + j) * a.kv_st + c;
        cp_async16(smem_u32(ks + j * Cfg::ROW + c), ok ? k + off : k, ok);
        if (sweep) cp_async16(smem_u32(vs + j * Cfg::ROW + c), ok ? v + off : v, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();

      // lane j: key t0 + j against every row: q . k (ascending fmaf chain)
      // and, in the second sweep, g_acc . v
      float dot[SC_RB], dpv[SC_RB];
#pragma unroll
      for (int r = 0; r < SC_RB; ++r) dot[r] = dpv[r] = 0.f;
      const TKV* krow = ks + lane * Cfg::ROW;
      const TKV* vrow = vs + lane * Cfg::ROW;
      for (int c = 0; c < D; ++c) {
        const float kf = to_f(krow[c]);
        const float vf = sweep ? to_f(vrow[c]) : 0.f;
#pragma unroll
        for (int r = 0; r < SC_RB; ++r) {
          dot[r] = fmaf(Qs[r * DMAX + c], kf, dot[r]);
          if (sweep) dpv[r] = fmaf(Gs[r * DMAX + c], vf, dpv[r]);
        }
      }
      const int key = t0 + lane;
      if (sweep == 0) {
#pragma unroll
        for (int r = 0; r < SC_RB; ++r) {
          const int qp = qo + (r0 + r) % Sq;
          if (r < nr && lane < nt && key_ok(ko + key, qp, kl, a.causal, a.window))
            merge_tie(bm[r], bc[r], dot[r] * a.scale, 1);
        }
      } else {
        float ds[SC_RB];
#pragma unroll
        for (int r = 0; r < SC_RB; ++r) {
          const int qp = qo + (r0 + r) % Sq;
          const bool live =
              r < nr && lane < nt && key_ok(ko + key, qp, kl, a.causal, a.window);
          const float s = dot[r] * a.scale;
          const float p = expf(s - r_mn[r]);
          ds[r] = live ? p * (dpv[r] + r_gl[r]) + (s == r_M[r] ? r_w[r] : 0.f) : 0.f;
        }
        for (int j = 0; j < nt; ++j) {
          float kv_[DC];
#pragma unroll
          for (int i = 0; i < DC; ++i)
            kv_[i] = lane + 32 * i < D ? to_f(ks[j * Cfg::ROW + lane + 32 * i]) : 0.f;
#pragma unroll
          for (int r = 0; r < SC_RB; ++r) {
            const float dj = __shfl_sync(FULL, ds[r], j);
#pragma unroll
            for (int i = 0; i < DC; ++i) dq[r][i] = fmaf(dj, kv_[i], dq[r][i]);
          }
        }
      }
      __syncwarp();                                       // tile smem is reused
    }
    if (sweep == 0) {
      // the tie tally: lanes, then warps in order; then r's route
#pragma unroll
      for (int r = 0; r < SC_RB; ++r) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float m2 = __shfl_xor_sync(FULL, bm[r], o);
          const int c2 = __shfl_xor_sync(FULL, bc[r], o);
          merge_tie(bm[r], bc[r], m2, c2);
        }
        if (lane == 0) {
          w_bm[warp][r] = bm[r];
          w_bc[warp][r] = bc[r];
        }
      }
      __syncthreads();
      if (tid < nr) {
        float M = w_bm[0][tid];
        int cnt = w_bc[0][tid];
        for (int x = 1; x < W; ++x) merge_tie(M, cnt, w_bm[x][tid], w_bc[x][tid]);
        const size_t si = row_index(tid);
        const float r = r_w[tid], corr = expf(r_m[tid] - r_mn[tid]);
        float to_m, w, Mo;
        max_route(r_m[tid], M, cnt, r, to_m, w, Mo);
        a.dm[si] = r_M[tid] + to_m;
        a.dl[si] = r_gl[tid] * corr;
        a.tie_max[si] = Mo;
        a.tie_w[si] = w;
        r_M[tid] = Mo;
        r_w[tid] = w;
      }
      __syncthreads();
    }
  }

  // sum the warps' dQ partials in order
  __syncthreads();
  float* macc = reinterpret_cast<float*>(region);       // [W][RB][DMAX]
#pragma unroll
  for (int r = 0; r < SC_RB; ++r)
#pragma unroll
    for (int i = 0; i < DC; ++i) macc[(warp * SC_RB + r) * DMAX + lane + 32 * i] = dq[r][i];
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.dq);
  for (int idx = tid; idx < nr * D; idx += SC_THREADS) {
    const int r = idx / D, d = idx % D;
    const int rr = r0 + r, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < W; ++x) sum += macc[(x * SC_RB + r) * DMAX + d];
    store1(out + (((size_t)b * Sq + s) * a.H + h) * D + d, sum * a.scale);
  }
}

// Pass B: dK and dV of 8 keys of one (K/V row, KV head); the warps split
// the 32-row query tiles of the rows that read it, a lane per query row.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(SC_THREADS)
flash_carry_bwd_kernel_keys_simt(const Args a) {
  constexpr int W = SC_WARPS, DC = DMAX / 32;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);                  // [KB][DMAX]
  float* Vs = Ks + SC_KB * DMAX;
  float* region = Vs + SC_KB * DMAX;                               // Q, G; then merge
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const int kr = blockIdx.z, kvh = blockIdx.y, t0 = blockIdx.x * SC_KB, D = a.D;
  const int nk = min(SC_KB, a.T - t0);
  const int G = a.H / a.Kv, Sq = a.Sq, rows = G * Sq;
  const int ntile = (rows + 31) / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long kv_base = (long long)kr * a.kv_sb + (long long)kvh * a.kv_sh;

  for (int idx = tid; idx < SC_KB * DMAX; idx += SC_THREADS) {
    const int j = idx / DMAX, d = idx % DMAX;
    const bool ok = j < nk && d < D;
    const long long off = kv_base + (long long)(t0 + j) * a.kv_st + d;
    Ks[idx] = ok ? to_f(k[off]) : 0.f;
    Vs[idx] = ok ? to_f(v[off]) : 0.f;
  }
  __syncthreads();

  float* Qt = region + warp * 2 * 32 * QROW;
  float* Gt = Qt + 32 * QROW;
  float dk[SC_KB][DC], dv[SC_KB][DC];
#pragma unroll
  for (int j = 0; j < SC_KB; ++j)
#pragma unroll
    for (int i = 0; i < DC; ++i) dk[j][i] = dv[j][i] = 0.f;
  const int i0 = a.start[kr], n_items = (a.start[kr + 1] - i0) * ntile;
  for (int n = warp; n < n_items; n += W) {
    const int b = a.order[i0 + n / ntile], r0 = (n % ntile) * 32;
    const int nr = min(32, rows - r0);
    const int qo = a.q_off[b], ko = a.k_off[b], kl = a.klen[b];
    const int rr = r0 + lane;
    const bool valid = lane < nr;
    const int g = valid ? rr / Sq : 0, s = valid ? rr % Sq : 0, h = kvh * G + g;
    const size_t si = ((size_t)b * a.H + h) * Sq + s;
    const float mn = valid ? a.m_new[si] : 0.f;
    int s_min, s_max;
    position_range(r0, nr, Sq, s_min, s_max);
    if (tile_dead(t0, nk, ko, kl, qo + s_min, qo + s_max, a.causal, a.window) &&
        __all_sync(FULL, !valid || mn > NEG))
      continue;                                           // every p and dS is 0
    const float gl = valid ? a.g_l[si] : 0.f;
    const float tmax = valid ? a.tie_max[si] : 0.f, tw = valid ? a.tie_w[si] : 0.f;
    for (int j = 0; j < nr; ++j) {                        // row j of the tile
      const int rj = r0 + j, gj = rj / Sq, sj = rj % Sq, hj = kvh * G + gj;
      const TQ* qrow = q + b * a.q_sb + sj * a.q_ss + hj * a.q_sh;
      const float* grow = a.g_acc + (((size_t)b * a.H + hj) * Sq + sj) * D;
      for (int d = lane; d < D; d += 32) {
        Qt[j * QROW + d] = to_f(qrow[d]);
        Gt[j * QROW + d] = grow[d];
      }
    }
    __syncwarp();
    float p[SC_KB], ds[SC_KB];
#pragma unroll
    for (int j = 0; j < SC_KB; ++j) {
      float dot = 0.f, dpv = 0.f;
      if (valid && j < nk) {
        for (int d = 0; d < D; ++d) {
          dot = fmaf(Qt[lane * QROW + d], Ks[j * DMAX + d], dot);
          dpv = fmaf(Gt[lane * QROW + d], Vs[j * DMAX + d], dpv);
        }
      }
      const int key = t0 + j;
      const bool in = valid && j < nk;
      const bool live = in && key_ok(ko + key, qo + s, kl, a.causal, a.window);
      const float sv = live ? dot * a.scale : NEG;
      p[j] = in ? expf(sv - mn) : 0.f;
      ds[j] = live ? p[j] * (dpv + gl) + (sv == tmax ? tw : 0.f) : 0.f;
    }
    for (int j = 0; j < nr; ++j) {
      float qv[DC], gv[DC];
#pragma unroll
      for (int i = 0; i < DC; ++i) {
        const bool ok = lane + 32 * i < D;
        qv[i] = ok ? Qt[j * QROW + lane + 32 * i] : 0.f;
        gv[i] = ok ? Gt[j * QROW + lane + 32 * i] : 0.f;
      }
#pragma unroll
      for (int x = 0; x < SC_KB; ++x) {
        const float pj = __shfl_sync(FULL, p[x], j), dj = __shfl_sync(FULL, ds[x], j);
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          dv[x][i] = fmaf(pj, gv[i], dv[x][i]);
          dk[x][i] = fmaf(dj, qv[i], dk[x][i]);
        }
      }
    }
    __syncwarp();                                         // Qt, Gt are reused
  }

  // sum the warps' partials in order
  __syncthreads();
  float* mk = region;                                     // [W][KB][DMAX]
  float* mv = region + W * SC_KB * DMAX;
#pragma unroll
  for (int j = 0; j < SC_KB; ++j)
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      mk[(warp * SC_KB + j) * DMAX + lane + 32 * i] = dk[j][i];
      mv[(warp * SC_KB + j) * DMAX + lane + 32 * i] = dv[j][i];
    }
  __syncthreads();
  TKV* dk_out = static_cast<TKV*>(a.dk);
  TKV* dv_out = static_cast<TKV*>(a.dv);
  for (int idx = tid; idx < nk * D; idx += SC_THREADS) {
    const int j = idx / D, d = idx % D;
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int x = 0; x < W; ++x) {
      sk += mk[(x * SC_KB + j) * DMAX + d];
      sv += mv[(x * SC_KB + j) * DMAX + d];
    }
    const size_t o = (((size_t)kr * a.T + t0 + j) * a.Kv + kvh) * D + d;
    store1(dk_out + o, sk * a.scale);
    store1(dv_out + o, sv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  static bool attr_a = false, attr_b = false;
  auto ka = flash_carry_bwd_kernel_rows_mma<D>;
  auto kb = flash_carry_bwd_kernel_keys_mma<D, __nv_bfloat16>;
  cudaError_t e = allow_smem(ka, TcTile<D>::SMEM_A, attr_a);
  if (e != cudaSuccess) return e;
  e = allow_smem(kb, TcTile<D>::SMEM_B, attr_b);
  if (e != cudaSuccess) return e;
  const int rows = (a.H / a.Kv) * a.Sq;
  ka<<<dim3((rows + TC_ROWS - 1) / TC_ROWS, a.Kv, a.Bp), TC_THREADS, TcTile<D>::SMEM_A, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.T == 0) return e;
  kb<<<dim3((a.T + TC_KEYS - 1) / TC_KEYS, a.Kv, a.Bk), TC_THREADS, TcTile<D>::SMEM_B, s>>>(a);
  return cudaSuccess;
}

template <typename TQ, typename TKV>
cudaError_t launch_simt(const Args& a, cudaStream_t s) {
  static bool attr_a = false, attr_b = false;
  auto ka = flash_carry_bwd_kernel_rows_simt<TQ, TKV>;
  auto kb = flash_carry_bwd_kernel_keys_simt<TQ, TKV>;
  cudaError_t e = allow_smem(ka, ScA<TKV>::SMEM, attr_a);
  if (e != cudaSuccess) return e;
  e = allow_smem(kb, ScB::SMEM, attr_b);
  if (e != cudaSuccess) return e;
  const int rows = (a.H / a.Kv) * a.Sq;
  ka<<<dim3((rows + SC_RB - 1) / SC_RB, a.Kv, a.Bp), SC_THREADS, ScA<TKV>::SMEM, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.T == 0) return e;
  kb<<<dim3((a.T + SC_KB - 1) / SC_KB, a.Kv, a.Bk), SC_THREADS, ScB::SMEM, s>>>(a);
  return cudaSuccess;
}

template <typename TQ>
cudaError_t dispatch_simt(const Args& a, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return launch_simt<TQ, float>(a, s);
    case 1: return launch_simt<TQ, __nv_bfloat16>(a, s);
  }
  return cudaErrorInvalidValue;
}

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

}  // namespace

// Whether the tensor-core body takes these inputs (the wrapper sizes its
// scratch by it).
extern "C" int flash_carry_bwd_uses_mma(int q_dtype, int kv_dtype, int Sq, int D) {
  return q_dtype == 1 && kv_dtype == 1 && Sq > 1 && (D == 64 || D == 128);
}

extern "C" int flash_carry_bwd(
    const void* q, long long q_sb, long long q_ss, long long q_sh, int q_dtype,
    const void* k, const void* v, long long kv_sb, long long kv_st, long long kv_sh,
    int kv_dtype, const int* kv_row, const int* order, const int* start, int T,
    const int* q_off, const int* k_off, const int* klen, const float* m, const float* l,
    const float* acc, const float* m_new, const float* l_new, const float* acc_new,
    const float* g_m, const float* g_l, const float* g_acc, void* dq, void* dk, void* dv,
    float* dm, float* dl, float* dacc, float* tie_max, float* tie_w, void* g16,
    int* resolved, int Bp, int Bk, int H, int Kv, int Sq, int D, int causal, int window,
    float scale, void* stream) {
  if (Bp <= 0 || Bk <= 0 || Sq <= 0 || T < 0 || Kv <= 0 || H % Kv != 0 || D <= 0 ||
      D > DMAX || (q_dtype != 0 && q_dtype != 1) || (kv_dtype != 0 && kv_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // K/V rows are copied as 16-byte vectors: they must start on 16 bytes
  const long long vn = kv_dtype == 0 ? 4 : 8;
  if (D % vn || kv_sb % vn || kv_st % vn || kv_sh % vn || misaligned(k, 16) ||
      misaligned(v, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q, k, v, q_sb, q_ss, q_sh, kv_sb, kv_st, kv_sh, kv_row, order, start,
               q_off, k_off, klen, T, m, l, acc, m_new, l_new, acc_new, g_m, g_l, g_acc,
               dq, dk, dv, dm, dl, dacc, tie_max, tie_w,
               static_cast<__nv_bfloat16*>(g16), resolved, Bp, Bk, H, Kv, Sq, D,
               causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (flash_carry_bwd_uses_mma(q_dtype, kv_dtype, Sq, D)) {
    // q rows are copied as 16-byte vectors, acc-sized rows read as float4,
    // dq / dk / dv written as bf16 pairs
    if (q_sb % 8 || q_ss % 8 || q_sh % 8 || misaligned(q, 16) || misaligned(acc, 16) ||
        misaligned(acc_new, 16) || misaligned(g_acc, 16) || misaligned(dacc, 16) ||
        misaligned(g16, 16) || misaligned(dq, 4) || misaligned(dk, 4) || misaligned(dv, 4))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = D == 64 ? launch_mma<64>(a, s) : launch_mma<128>(a, s);
  } else {
    err = q_dtype == 0 ? dispatch_simt<float>(a, kv_dtype, s)
                       : dispatch_simt<__nv_bfloat16>(a, kv_dtype, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
