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
// Query head h reads KV head h / (H / Kv) (native GQA, no repeat); the
// query rows of one (b', KV head) are flattened as (group, position).
// Masked scores take the finite sentinel -1e30, exactly as the reference:
// a fully masked block then adds exp(0) per key to a row still at the
// sentinel, and the first real block's rescale exp(-1e30 - m) == 0 erases
// it. normalize=1 writes acc / max(l, 1e-30) in the output type instead of
// acc (m and l are written in both forms).
//
// Tile skip: a K/V tile whose keys are all masked for every query row of
// the block is skipped outright when every row is "resolved": it already
// holds a real running max, or some key of this block is live for it. Then
// the row's final max is real and every masked key adds exactly 0. This
// keeps decode from reading cache slots past the rows' positions.
//
// What bounds it on an H100: a prefill hop (qwen3-0.6b on a ring of 4:
// 64 queries x 2 query heads per KV head against 64 keys, D = 128) does
// ~64 operations per byte, far below the card's balance of ~295, and most
// of its bytes are the carried fp32 acc (16.8 MB in, 16.8 MB out): it is
// bound by bytes (~15 us). A decode hop (Sq = 1) does ~1 operation per K/V
// byte: bound by the bytes of the live cache slots (< 1 us), in practice by
// the latency of reading them. Two bodies, chosen by dtype, Sq and D:
//
// * bf16 q and K/V with Sq > 1 and D = 64, 128 or 224 (prefill and
//   training hops): tensor cores. One block of four warps per (row b', KV head, 64
//   flattened query rows), so each K/V tile is read once per 64 rows; each
//   warp owns 16 rows. Q K^T and P V run on
//   mma.sync.m16n8k16 (bf16 operands, fp32 accumulation); K/V tiles of 64
//   keys come through cp.async double buffering into padded shared memory
//   read by ldmatrix (.trans for V). The softmax state and acc stay in
//   registers; acc is read and written as 16-byte vectors (a lane-pair
//   shuffle turns the mma fragment into four consecutive columns), so each
//   warp access fills whole 32-byte sectors. P is split into two bf16
//   halves, P = P_hi + P_lo, and both go through the P V mma: the
//   reference sums P V in fp32, and one bf16 rounding of P alone would put
//   an error of ~2^-9 of |acc| into the carried state. The split costs a
//   third mma per pair: zamba2-1.2b's hop (q [16,512,32,64]) counts 34.4
//   GFLOP at every pair, 51.5 with the split, so at D = 64 the mma work,
//   not the hop's 0.0664 ms of bytes, sets what this body can reach.
//   At D = 64 the same tile carries half the mma work per score, so the
//   softmax's per-score instructions weigh twice as much: a tile whose
//   keys are live for every row of the block skips the mask (its max taken
//   on the raw products), exp runs as one FMA and ex2.approx
//   (2^(x*scale*log2 e - m*log2 e), relative error ~2^-22 against the
//   2e-4 bound), and acc is rescaled only when some row of the warp found
//   a new max (the factor is then exactly 1 everywhere else). These paths
//   are compiled out at D = 128, whose arithmetic is the first body's.
//   Two 16-row groups a warp (128 rows a block, each K/V fragment feeding
//   both) and a third cp.async stage were tried at D = 64: 255 registers
//   with spills, and no faster.
//   At D = 224 (Zamba2's shared attention) acc alone takes 112 registers a
//   lane, so q is not held as A fragments for the sweep: the block's 64
//   query rows wait in shared memory (padded rows, 29 KB beside the two
//   K/V stages' 116 KB) and each k step reads its fragment by ldmatrix.
// * everything else: Sq = 1, any fp32 operand, other D (decode, fp32
//   paths, small test models): fp32 FMAs on the CUDA cores, the key range
//   split across the block's warps so that all of a block's K/V loads are
//   in flight at once; each warp folds its 32-key
//   tiles into a private (m, l, acc) partial, and the partials are merged
//   with the carried state in shared memory at the end.
//
// Measured (chip_smoke.py phase 2, device time under torch.profiler; NVIDIA
// H100 80GB HBM3, 700.00 W), qwen3-0.6b on a ring of 4 at batch 8: prefill
// hop with carried state 0.0296 ms against a 0.0146 ms bound; the same hop
// normalized from zero state 0.0301 (SDPA 0.0160); decode hop (fp32 q,
// [32,256,8,128] bf16 cache view) 0.0148 against a 0.0006 bound: 64
// blocks on 132 SMs, each with three dependent rounds of memory reads (q,
// K/V, carried state) around its per-key work (not broken down further).
// The first port took 0.174, 0.178 and 0.032 ms. At D = 64 (the same card
// and power limit): zamba2-1.2b's prefill hop (q [16,512,32,64], causal
// hop 1) 0.2330 ms against a 0.0664 ms bound, internvl2-1b's GQA-7 hop (q
// [8,1024,14,64]) 0.1792 against 0.0231, whisper-tiny's decoder hop (q
// [32,224,6,64]) 0.0329 against 0.0101; normalized from zero state 2.73x,
// 2.91x and 2.08x SDPA. The CUDA-core body took 8.5361, 5.9633 and 0.6883.
//
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 224;     // head_dim limit (the CUDA-core body's instances: 128, 224)
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four consecutive values, 16 bytes (fp32) or 8 bytes (bf16)
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Whether query position qp has any live key among k_off + [0, T).
__device__ __forceinline__ bool has_live_key(int qp, int ko, int kl, int T,
                                             int causal, int window) {
  long long hi = min((long long)ko + T - 1, (long long)kl - 1);
  if (causal) hi = min(hi, (long long)qp);
  long long lo = ko;
  if (window > 0) lo = max(lo, (long long)qp - window + 1);
  return lo <= hi;
}

// Whether keys k_off + [t0, t0 + nt) are masked for every query position
// in [qpos_min, qpos_max].
__device__ __forceinline__ bool tile_dead(int t0, int nt, int ko, int kl,
                                          int qpos_min, int qpos_max,
                                          int causal, int window) {
  const int kp_lo = ko + t0, kp_hi = ko + t0 + nt - 1;
  return kp_lo >= kl || (causal && kp_lo > qpos_max) ||
         (window > 0 && qpos_min - kp_hi >= window);
}

__device__ __forceinline__ bool key_ok(int kp, int qp, int kl, int causal, int window) {
  bool ok = kp < kl;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp < window);
  return ok;
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

// ---------------------------------------------------------------------------
// prefill body: mma.sync on bf16
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 64, TC_KEYS = 64, TC_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcTile {
  static constexpr int ROW = D + 8;                  // padded row, bf16 elements
  static constexpr int TILE = TC_KEYS * ROW;         // one K or V tile
  static constexpr bool Q_SMEM = D > 128;            // q read from shared memory
  static constexpr int SMEM =                        // 2 stages x (K, V) (+ q), bytes
      2 * 2 * TILE * 2 + (Q_SMEM ? TC_ROWS * ROW * 2 : 0);
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

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether keys k_off + [t0, t0 + TC_KEYS) all lie in the block and are live
// for every query position in [qpos_min, qpos_max]: the tile needs no mask.
__device__ __forceinline__ bool tile_live(int t0, int T, int ko, int kl, int qpos_min,
                                          int qpos_max, int causal, int window) {
  const long long lo = (long long)ko + t0, hi = lo + TC_KEYS - 1;
  return t0 + TC_KEYS <= T && hi < kl && (!causal || hi <= qpos_min) &&
         (window <= 0 || qpos_max - lo < window);
}

template <int D, typename TO>
__global__ void __launch_bounds__(TC_THREADS)
flash_carry_kernel_mma(const Args a) {
  // the head_dim-64 softmax (see the header): unmasked live tiles, exp2,
  // acc rescaled only on a new max
  constexpr bool FAST = D == 64;
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
  int qp[2];
  size_t si[2];
  const __nv_bfloat16* qrow[2];
  float m_r[2], l_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rr = r0 + warp * 16 + (lane >> 2) + 8 * e;
    rv[e] = rr < rows;
    const int g = rv[e] ? rr / Sq : 0, s = rv[e] ? rr % Sq : 0, h = kvh * G + g;
    qp[e] = qo + s;
    si[e] = ((size_t)b * a.H + h) * Sq + s;
    qrow[e] = q + b * a.q_sb + s * a.q_ss + h * a.q_sh;
    m_r[e] = rv[e] ? a.m_in[si[e]] : NEG;
    l_r[e] = rv[e] ? a.l_in[si[e]] : 0.f;
  }
  const bool resolved = (!rv[0] || m_r[0] > NEG ||
                         has_live_key(qp[0], ko, kl, T, a.causal, a.window)) &&
                        (!rv[1] || m_r[1] > NEG ||
                         has_live_key(qp[1], ko, kl, T, a.causal, a.window));
  const bool all_resolved = __syncthreads_and(resolved);
  int s_min, s_max;
  position_range(r0, nr, Sq, s_min, s_max);
  const int qpos_min = qo + s_min, qpos_max = qo + s_max;

  // Q as mma A fragments: qf[kk] = {(row0, k), (row8, k), (row0, k+8), (row8, k+8)};
  // at D > 128 the block's rows as bf16 pairs in q_s (zeros past the block),
  // read by ldmatrix at each k step (visible after the first tile's barrier)
  __nv_bfloat16* q_s = kv_s + 4 * Tile::TILE;
  uint32_t qf[Tile::Q_SMEM ? 1 : D / 16][4];
  if constexpr (Tile::Q_SMEM) {
    constexpr int PAIRS = D / 2;
    for (int idx = tid; idx < TC_ROWS * PAIRS; idx += TC_THREADS) {
      const int r = idx / PAIRS, c = (idx % PAIRS) * 2, rr = r0 + r;
      uint32_t val = 0u;
      if (rr < rows) {
        const int g = rr / Sq, s = rr % Sq, h = kvh * G + g;
        val = *reinterpret_cast<const uint32_t*>(q + b * a.q_sb + s * a.q_ss + h * a.q_sh + c);
      }
      *reinterpret_cast<uint32_t*>(q_s + r * Tile::ROW + c) = val;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        qf[kk][e] = rv[e] ? *reinterpret_cast<const uint32_t*>(qrow[e] + c) : 0u;
        qf[kk][2 + e] = rv[e] ? *reinterpret_cast<const uint32_t*>(qrow[e] + c + 8) : 0u;
      }
    }
  }

  // acc as mma C fragments: o[j] = {(row0, c), (row0, c+1), (row8, c),
  // (row8, c+1)}, c = j*8 + (lane&3)*2. Even lanes read row0, odd lanes
  // row8, four columns from j*8 + (lane&2)*2, and swap halves with their
  // neighbour.
  const bool odd = lane & 1;
  const int col4 = (lane & 2) * 2;
  const bool my_rv = odd ? rv[1] : rv[0];
  const size_t my_si = odd ? si[1] : si[0];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (my_rv) w = *reinterpret_cast<const float4*>(a.acc_in + my_si * D + j * 8 + col4);
    const float sx = odd ? w.x : w.z, sy = odd ? w.y : w.w;
    const float rx = __shfl_xor_sync(FULL, sx, 1), ry = __shfl_xor_sync(FULL, sy, 1);
    o[j][0] = odd ? rx : w.x;
    o[j][1] = odd ? ry : w.y;
    o[j][2] = odd ? w.z : rx;
    o[j][3] = odd ? w.w : ry;
  }

  auto needed = [&](int t0) {
    return !(all_resolved && tile_dead(t0, min(TC_KEYS, T - t0), ko, kl, qpos_min,
                                       qpos_max, a.causal, a.window));
  };
  auto next_needed = [&](int t0) {
    while (t0 < T && !needed(t0)) t0 += TC_KEYS;
    return t0;
  };
  auto load_tile = [&](int t0, int st) {
    __nv_bfloat16* ks = kv_s + (2 * st) * Tile::TILE;
    __nv_bfloat16* vs = ks + Tile::TILE;
    constexpr int CH = D / 8;                     // 16-byte chunks per key row
#pragma unroll
    for (int i = 0; i < TC_KEYS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, j = idx / CH, c = (idx % CH) * 8;
      const bool ok = t0 + j < T;
      const long long off = kv_base + (long long)(t0 + j) * a.kv_st + c;
      cp_async16(smem_u32(ks + j * Tile::ROW + c), ok ? k + off : k, ok);
      cp_async16(smem_u32(vs + j * Tile::ROW + c), ok ? v + off : v, ok);
    }
  };

  int cur = next_needed(0), st = 0;
  if (cur < T) load_tile(cur, 0);
  cp_async_commit();
  while (cur < T) {
    const int nxt = next_needed(cur + TC_KEYS);
    if (nxt < T) load_tile(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + (2 * st) * Tile::TILE;
    const __nv_bfloat16* vs = ks + Tile::TILE;

    // S = Q K^T for 16 rows x 64 keys: sc[j] is the C fragment of keys j*8..
    float sc[TC_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < TC_KEYS / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (Tile::Q_SMEM) {
        ldmatrix_x4(qa, smem_u32(q_s + (warp * 16 + (lane & 15)) * Tile::ROW + kk * 16 +
                                 (lane >> 4) * 8));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      }
#pragma unroll
      for (int jj = 0; jj < TC_KEYS / 16; ++jj) {
        uint32_t bk[4];
        const int key = jj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int d = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bk, smem_u32(ks + key * Tile::ROW + d));
        mma_bf16(sc[2 * jj], qa, bk[0], bk[1]);
        mma_bf16(sc[2 * jj + 1], qa, bk[2], bk[3]);
      }
    }

    // mask, online softmax; the 4 lanes of a quad share a row. A tile live
    // for every row keeps the raw products here: max(round(x * scale)) ==
    // round(max(x) * scale) for scale > 0, so the max comes out the same.
    const bool live = FAST && tile_live(cur, T, ko, kl, qpos_min, qpos_max, a.causal,
                                        a.window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (live) {
#pragma unroll
      for (int j = 0; j < TC_KEYS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[j][i]);
    } else {
#pragma unroll
      for (int j = 0; j < TC_KEYS / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i >> 1, key = cur + j * 8 + (lane & 3) * 2 + (i & 1);
          float s = -INFINITY;                  // past the block: weight exactly 0
          if (key < T)
            s = key_ok(ko + key, qp[e], kl, a.causal, a.window) ? sc[j][i] * a.scale : NEG;
          sc[j][i] = s;
          mx[e] = fmaxf(mx[e], s);
        }
      }
    }
    float corr[2], sum[2] = {0.f, 0.f}, mb[2];
    bool grew = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 2));
      if (live) mx[e] *= a.scale;
      const float m_new = fmaxf(m_r[e], mx[e]);
      corr[e] = expf(m_r[e] - m_new);
      grew = grew || corr[e] != 1.f;
      m_r[e] = m_new;
      mb[e] = m_new * LOG2E;
    }
    if (FAST) {
      // exp(s - m) as 2^(x * scale * log2 e - m * log2 e) on a live tile (one
      // FMA), 2^((s - m) * log2 e) where the sentinel may meet itself
      const float sl2 = a.scale * LOG2E;
#pragma unroll
      for (int j = 0; j < TC_KEYS / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i >> 1;
          const float x = sc[j][i];
          sc[j][i] = live ? ex2(fmaf(x, sl2, -mb[e])) : ex2((x - m_r[e]) * LOG2E);
          sum[e] += sc[j][i];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TC_KEYS / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i >> 1;
          sc[j][i] = expf(sc[j][i] - m_r[e]);
          sum[e] += sc[j][i];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sum[e] += __shfl_xor_sync(FULL, sum[e], 1);
      sum[e] += __shfl_xor_sync(FULL, sum[e], 2);
      l_r[e] = l_r[e] * corr[e] + sum[e];
    }
    // acc *= corr; at D = 64 skipped (exactly: every factor is 1) when no row
    // of the warp found a new max
    if (!FAST || __any_sync(FULL, grew)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
    }

    // acc += (P_hi + P_lo) V, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t bv[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int d = jd * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bv, smem_u32(vs + key * Tile::ROW + d));
        mma_bf16(o[2 * jd], ph, bv[0], bv[1]);
        mma_bf16(o[2 * jd], pl, bv[0], bv[1]);
        mma_bf16(o[2 * jd + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * jd + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();                            // stage st is refilled next
    cur = nxt;
    st ^= 1;
  }

  if ((lane & 3) == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (rv[e]) {
        a.m_out[si[e]] = m_r[e];
        a.l_out[si[e]] = l_r[e];
      }
    }
  }
  const float inv = a.normalize ? 1.f / fmaxf(odd ? l_r[1] : l_r[0], 1e-30f) : 1.f;
  TO* out = static_cast<TO*>(a.o_out);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float sx = odd ? o[j][0] : o[j][2], sy = odd ? o[j][1] : o[j][3];
    const float rx = __shfl_xor_sync(FULL, sx, 1), ry = __shfl_xor_sync(FULL, sy, 1);
    float w[4] = {odd ? rx : o[j][0], odd ? ry : o[j][1], odd ? o[j][2] : rx,
                  odd ? o[j][3] : ry};
    if (a.normalize) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = w[i] * inv;
    }
    if (my_rv) store4(out + my_si * D + j * 8 + col4, w);
  }
}

// ---------------------------------------------------------------------------
// decode / fp32 body: key-split CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int SC_RB = 8;      // flattened query rows per block
constexpr int SC_KEYS = 32;   // keys per warp tile (one per lane)

// DM: the instance's head_dim limit, 128 or 224 (half the warps at 224, so
// that the K/V tiles fit in shared memory)
template <typename TKV, int DM>
struct ScCfg {
  static constexpr int WARPS = (sizeof(TKV) == 2 ? 8 : 4) / (DM > 128 ? 2 : 1);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROW = DM + 16 / sizeof(TKV);      // padded key row, elements
  static constexpr int TILE = SC_KEYS * ROW;              // one K or V tile
  static constexpr int KV_BYTES = WARPS * 2 * TILE * sizeof(TKV);
  static constexpr int MERGE_BYTES = WARPS * SC_RB * (DM + 2) * 4;
  static constexpr int Q_BYTES = SC_RB * DM * 4;
  static constexpr int SMEM =
      Q_BYTES + (KV_BYTES > MERGE_BYTES ? KV_BYTES : MERGE_BYTES);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename TQ, typename TKV, typename TO, int DM>
__global__ void __launch_bounds__(ScCfg<TKV, DM>::THREADS)
flash_carry_kernel_simt(const Args a) {
  using Cfg = ScCfg<TKV, DM>;
  constexpr int W = Cfg::WARPS, VN = 16 / sizeof(TKV), DC = DM / 32;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);                  // [RB][DM]
  uint8_t* region = smem_raw + Cfg::Q_BYTES;                       // K/V, then merge
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const int b = blockIdx.z, kvh = blockIdx.y, D = a.D;
  const int G = a.H / a.Kv, Sq = a.Sq, T = a.T, rows = G * Sq;
  const int r0 = blockIdx.x * SC_RB, nr = min(SC_RB, rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qo = a.q_off[b], ko = a.k_off[b], kl = a.klen[b];
  const long long kv_base = (long long)a.kv_row[b] * a.kv_sb + (long long)kvh * a.kv_sh;

  for (int idx = tid; idx < SC_RB * DM; idx += Cfg::THREADS) {
    const int r = idx / DM, d = idx % DM;
    float val = 0.f;
    if (r < nr && d < D) {
      const int rr = r0 + r, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
      val = to_f(q[b * a.q_sb + s * a.q_ss + h * a.q_sh + d]);
    }
    Qs[idx] = val;
  }
  bool res = true;
  if (tid < nr) {
    const int rr = r0 + tid, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
    res = a.m_in[((size_t)b * a.H + h) * Sq + s] > NEG ||
          has_live_key(qo + s, ko, kl, T, a.causal, a.window);
  }
  const bool all_resolved = __syncthreads_and(res);     // Qs is visible too
  int s_min, s_max;
  position_range(r0, nr, Sq, s_min, s_max);
  const int qpos_min = qo + s_min, qpos_max = qo + s_max;

  // this warp's partial over its tiles; lane owns columns lane + 32 i
  float m_w[SC_RB], l_w[SC_RB], acc_w[SC_RB][DC];
#pragma unroll
  for (int r = 0; r < SC_RB; ++r) {
    m_w[r] = -INFINITY;
    l_w[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DC; ++i) acc_w[r][i] = 0.f;
  }
  TKV* ks = reinterpret_cast<TKV*>(region) + warp * 2 * Cfg::TILE;
  TKV* vs = ks + Cfg::TILE;
  const int CH = D / VN;                               // 16-byte chunks per row
  for (int t0 = warp * SC_KEYS; t0 < T; t0 += W * SC_KEYS) {
    const int nt = min(SC_KEYS, T - t0);
    if (all_resolved && tile_dead(t0, nt, ko, kl, qpos_min, qpos_max, a.causal, a.window))
      continue;                                         // uniform across the warp
    for (int idx = lane; idx < SC_KEYS * CH; idx += 32) {
      const int j = idx / CH, c = (idx % CH) * VN;
      const bool ok = j < nt;
      const long long off = kv_base + (long long)(t0 + j) * a.kv_st + c;
      cp_async16(smem_u32(ks + j * Cfg::ROW + c), ok ? k + off : k, ok);
      cp_async16(smem_u32(vs + j * Cfg::ROW + c), ok ? v + off : v, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // scores: lane j holds key t0 + j against every row
    float dot[SC_RB];
#pragma unroll
    for (int r = 0; r < SC_RB; ++r) dot[r] = 0.f;
    const TKV* krow = ks + lane * Cfg::ROW;
    for (int c = 0; c < D; c += VN) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
      const TKV* kv = reinterpret_cast<const TKV*>(&raw);
      float kf[VN];
#pragma unroll
      for (int e = 0; e < VN; ++e) kf[e] = to_f(kv[e]);
#pragma unroll
      for (int r = 0; r < SC_RB; ++r) {
        if (r < nr) {
#pragma unroll
          for (int e = 0; e < VN; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * DM + c + e]);
            dot[r] = fmaf(qv.x, kf[e], dot[r]);
            dot[r] = fmaf(qv.y, kf[e + 1], dot[r]);
            dot[r] = fmaf(qv.z, kf[e + 2], dot[r]);
            dot[r] = fmaf(qv.w, kf[e + 3], dot[r]);
          }
        }
      }
    }
    float p[SC_RB];
#pragma unroll
    for (int r = 0; r < SC_RB; ++r) {
      p[r] = 0.f;
      if (r >= nr) continue;
      const int qp = qo + (r0 + r) % Sq;
      float s = -INFINITY;                              // past the block: weight 0
      if (lane < nt) s = key_ok(ko + t0 + lane, qp, kl, a.causal, a.window) ? dot[r] * a.scale : NEG;
      const float m_new = fmaxf(m_w[r], warp_max(s));
      const float corr = expf(m_w[r] - m_new);
      p[r] = expf(s - m_new);
      l_w[r] = l_w[r] * corr + warp_sum(p[r]);
      m_w[r] = m_new;
#pragma unroll
      for (int i = 0; i < DC; ++i) acc_w[r][i] *= corr;
    }
    for (int j = 0; j < nt; ++j) {
      float vv[DC];
#pragma unroll
      for (int i = 0; i < DC; ++i)
        vv[i] = lane + 32 * i < D ? to_f(vs[j * Cfg::ROW + lane + 32 * i]) : 0.f;
#pragma unroll
      for (int r = 0; r < SC_RB; ++r) {
        if (r < nr) {
          const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
          for (int i = 0; i < DC; ++i) acc_w[r][i] = fmaf(pj, vv[i], acc_w[r][i]);
        }
      }
    }
    __syncwarp();                                       // tile smem is reused
  }

  // merge the warps' partials with the carried state
  __syncthreads();
  float* macc = reinterpret_cast<float*>(region);      // [W][RB][DM]
  float* m_s = macc + W * SC_RB * DM;                  // [W][RB]
  float* l_s = m_s + W * SC_RB;
#pragma unroll
  for (int r = 0; r < SC_RB; ++r) {
#pragma unroll
    for (int i = 0; i < DC; ++i) macc[(warp * SC_RB + r) * DM + lane + 32 * i] = acc_w[r][i];
    if (lane == 0) {
      m_s[warp * SC_RB + r] = m_w[r];
      l_s[warp * SC_RB + r] = l_w[r];
    }
  }
  __syncthreads();
  TO* out = static_cast<TO*>(a.o_out);
  for (int idx = tid; idx < nr * D; idx += Cfg::THREADS) {
    const int r = idx / D, d = idx % D;
    const int rr = r0 + r, g = rr / Sq, s = rr % Sq, h = kvh * G + g;
    const size_t si = ((size_t)b * a.H + h) * Sq + s;
    const float m0 = a.m_in[si];
    float m_new = m0;
#pragma unroll
    for (int w = 0; w < W; ++w) m_new = fmaxf(m_new, m_s[w * SC_RB + r]);
    const float c0 = expf(m0 - m_new);
    float l = a.l_in[si] * c0, acc = a.acc_in[si * D + d] * c0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = m_s[w * SC_RB + r];
      if (mw == -INFINITY) continue;                  // the warp saw no key
      const float cw = expf(mw - m_new);
      l += l_s[w * SC_RB + r] * cw;
      acc += macc[(w * SC_RB + r) * DM + d] * cw;
    }
    if (d == 0) {
      a.m_out[si] = m_new;
      a.l_out[si] = l;
    }
    store1(out + si * D + d, a.normalize ? acc / fmaxf(l, 1e-30f) : acc);
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

template <int D, typename TO>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  auto kern = flash_carry_kernel_mma<D, TO>;
  static bool attr = false;
  const cudaError_t e = allow_smem(kern, TcTile<D>::SMEM, attr);
  if (e != cudaSuccess) return e;
  const int rows = (a.H / a.Kv) * a.Sq;
  dim3 grid((rows + TC_ROWS - 1) / TC_ROWS, a.Kv, a.Bp);
  kern<<<grid, TC_THREADS, TcTile<D>::SMEM, s>>>(a);
  return cudaSuccess;
}

template <typename TQ, typename TKV, typename TO, int DM>
cudaError_t launch_simt(const Args& a, cudaStream_t s) {
  using Cfg = ScCfg<TKV, DM>;
  auto kern = flash_carry_kernel_simt<TQ, TKV, TO, DM>;
  static bool attr = false;
  const cudaError_t e = allow_smem(kern, Cfg::SMEM, attr);
  if (e != cudaSuccess) return e;
  const int rows = (a.H / a.Kv) * a.Sq;
  dim3 grid((rows + SC_RB - 1) / SC_RB, a.Kv, a.Bp);
  kern<<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(a);
  return cudaSuccess;
}

template <typename TQ, typename TKV>
cudaError_t dispatch_simt(const Args& a, int o_dtype, cudaStream_t s) {
  const bool wide = a.D > 128;
  switch (o_dtype) {
    case 0: return wide ? launch_simt<TQ, TKV, float, 224>(a, s)
                        : launch_simt<TQ, TKV, float, 128>(a, s);
    case 1: return wide ? launch_simt<TQ, TKV, __nv_bfloat16, 224>(a, s)
                        : launch_simt<TQ, TKV, __nv_bfloat16, 128>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t dispatch_kv(const Args& a, int kv_dtype, int o_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return dispatch_simt<TQ, float>(a, o_dtype, s);
    case 1: return dispatch_simt<TQ, __nv_bfloat16>(a, o_dtype, s);
  }
  return cudaErrorInvalidValue;
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
      D > DMAX || (!normalize && o_dtype != 0) || (o_dtype != 0 && o_dtype != 1) ||
      (q_dtype != 0 && q_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // K/V rows are copied as 16-byte vectors: they must start on 16 bytes
  const long long vn = kv_dtype == 0 ? 4 : 8;
  if (D % vn || kv_sb % vn || kv_st % vn || kv_sh % vn ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q, k, v, q_sb, q_ss, q_sh, kv_sb, kv_st, kv_sh, kv_row, q_off,
               k_off, klen, T, m_in, l_in, acc_in, m_out, l_out, o_out, Bp, H,
               Kv, Sq, D, causal, window, normalize, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 1 && kv_dtype == 1 && Sq > 1 && (D == 64 || D == 128 || D == 224)) {
    // the tensor-core body reads q as bf16 pairs and acc / o as 4-vectors
    if (q_sb % 2 || q_ss % 2 || q_sh % 2 || reinterpret_cast<uintptr_t>(q) % 4 ||
        reinterpret_cast<uintptr_t>(acc_in) % 16 || reinterpret_cast<uintptr_t>(o_out) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (D == 64)
      err = o_dtype == 0 ? launch_mma<64, float>(a, s) : launch_mma<64, __nv_bfloat16>(a, s);
    else if (D == 128)
      err = o_dtype == 0 ? launch_mma<128, float>(a, s) : launch_mma<128, __nv_bfloat16>(a, s);
    else
      err = o_dtype == 0 ? launch_mma<224, float>(a, s) : launch_mma<224, __nv_bfloat16>(a, s);
  } else {
    err = q_dtype == 0 ? dispatch_kv<float>(a, kv_dtype, o_dtype, s)
                       : dispatch_kv<__nv_bfloat16>(a, kv_dtype, o_dtype, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
