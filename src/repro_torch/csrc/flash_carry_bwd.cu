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
// Two passes over the keys, no atomics on floating-point values and every
// sum in a fixed order (the gradients are bit-identical run to run):
// * pass A, one block per (query row b', KV head, 64 flattened query rows):
//   one sweep over the live key tiles accumulates dQ without the max route
//   and finds each row's M, its tie count and first tied key; then the
//   max route's part of dm and the tie weight w are written (w and M to
//   scratch for pass B), and w times the tied keys is added to dQ: the one
//   tied key's row where there is one (the rule), a second sweep over the
//   ties where a row of the block has several. (The CUDA-core body sweeps
//   twice, the tally first.)
// * pass B, one block per (K/V row, KV head, key tile, share): a
//   fixed-order loop over its share of the items (query row that reads the
//   K/V row, grouped by the wrapper; query tile) accumulates dK and dV.
// Both passes recompute S and P from the saved m_new. A row whose m_new is
// still the sentinel has p = 1 on its (all masked) keys: those feed dV but
// not dQ/dK, so pass B skips a dead tile only when every row of the query
// tile holds a real max (pass A's per-tile flag); pass A skips every dead
// tile.
//
// What bounds it on an H100: at qwen3-0.6b's training hop (q
// [32,256,16,128], k/v [32,256,8,128] bf16) the bytes are ~0.41 GB, most
// of them the four fp32 acc-sized tensors (acc, acc_new, g_acc, g_acc_in),
// ~0.12 ms at 3.35 TB/s; the products (12 D operations a pair as the
// reference's VJP counts them; the kernel does 14, S and dP in both
// passes) are ~0.05 ms on the tensor cores. Two bodies, chosen as the
// forward's are:
// * bf16 q and K/V with Sq > 1 at D = 64 or 128 (every training hop), four
//   launches, each shaped against what held the first form back:
//   - prep: the fp32 preamble (g_acc . acc, g_acc . acc_new, g_acc_in, the
//     bf16 copy of g_acc, dl, r) as a pass of its own at full occupancy,
//     D/4 lanes a row with a float4 each, so that neighbouring lanes read
//     and write neighbouring 16 bytes (it was pass A's prologue, a quarter
//     row a lane, 128 bytes apart at D = 128, under 2 blocks an SM).
//   - pass A: mma.sync.m16n8k16 (bf16 operands, fp32 accumulation, as
//     FlashAttention-2 takes them). The block's q and g_acc wait in shared
//     memory and are read by ldmatrix at each k step (they were A
//     fragments held for the whole sweep: 255 registers and spills at D =
//     128); K/V tiles stream through a cp.async ring of 3 stages at D = 64
//     (3 blocks an SM) and 2 at D = 128 (2 blocks an SM; a third would
//     leave one).
//   - pass B computes S and dP with mma.sync and the query rows as the M
//     side, exactly as pass A and the forward do, so every score and every
//     tie test is bit for bit the same in both passes; P and dS are rounded
//     to bf16 and transposed in registers (movmatrix) into the A operands
//     of dV = P^T G and dK = dS^T Q, which are wgmma (m64nDk16) over the
//     warpgroup's 64 keys: G and Q are read from shared memory (128-byte
//     swizzled) once for the four warps, where mma.sync had each warp read
//     them again for its 16 keys; each chunk's wgmma runs on while the next
//     chunk's S and dP are taken. At D = 64 K's B fragments stay in
//     registers.
//   - Where Bk x Kv x T/64 pass B blocks fall below two waves of the card
//     (GQA hops: 256 blocks at internvl2's and mixtral's), the wrapper
//     splits each key tile's items into nsplit contiguous shares; each
//     writes fp32 partials to scratch and the sum pass adds them in share
//     order into dK and dV.
//   A tile whose keys are live for every row of its block takes no mask,
//   and p is exp2 on the special-function unit (relative error ~2^-22
//   against the bf16 gradients' 2^-7 bound; the state gradients do not
//   depend on p). Pass A tallies a row's max a tile at a time (the tile's
//   max first; the keys that tie it only where it reaches the running max).
//   What holds this form back (chip_smoke.py phase 2 and ablations on an
//   NVIDIA H100 80GB HBM3, 700 W): the prep pass runs at ~2.9 TB/s, but
//   with every product and the elementwise work taken out, pass A and pass
//   B still take about 0.10 and 0.08 ms of their ~0.17 at qwen3's hop. The
//   blocks start in lock-step waves and wait for their first tiles; blocks
//   of 128 rows or keys (half the L2 traffic, half the blocks) were slower.
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
  float *tie_max, *tie_w;     // [B', H, Sq]: pass A -> pass B (tie_w: r before)
  __nv_bfloat16* g16;         // [B', H, Sq, D]: g_acc in bf16 (tensor-core body)
  int* resolved;              // [B', Kv, row tiles] (tensor-core body)
  int nsplit;                 // pass B's shares of a key tile's items (tensor-core body)
  const int* share;           // [Bk, nsplit + 1]: each share's first item, then the end
  float* part;                // [2, nsplit, Bk, T, Kv, D]: dK's, dV's partials (nsplit > 1)
  int Bp, Bk, H, Kv, Sq, D, causal, window;
  float scale;
};

// ---------------------------------------------------------------------------
// tensor-core body: mma.sync and wgmma on bf16
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 64, TC_KEYS = 64, TC_THREADS = 128, PREP_THREADS = 256,
              SUM_THREADS = 256;

// Pass A: q, g_acc (bf16) and a ring of K/V tiles, padded rows read by
// ldmatrix. Three stages at D = 64 (three blocks an SM), two at D = 128
// (two blocks an SM; a third stage would leave one). At D = 64, two stages
// and four blocks an SM spill (128 registers).
template <int D>
struct TcA {
  static constexpr int ROW = D + 8;                  // padded row, bf16 elements
  static constexpr int TILE = 64 * ROW;              // one 64-row tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;
  static constexpr int SMEM = (2 + 2 * STAGES) * TILE * 2;
};

// Pass B: the block's K and V (padded, ldmatrix), two stages of the item's
// Q and G tiles in the 128-byte swizzled layout wgmma reads them in (64-row
// panels of 64 columns; a row's 16-byte chunk c of a panel sits at chunk
// c ^ (row % 8)) and the items' per-row scalars; 1024 bytes to align the
// swizzle atoms. At D = 64 the warp's K fragments stay in registers (V's
// too would spill at three blocks an SM); at D = 128 neither does (K's
// took 255 registers and were no faster). Tried and slower: a third stage
// and four blocks an SM at D = 64, 128 keys (8 warps) a block.
template <int D>
struct TcB {
  static constexpr int ROW = D + 8;
  static constexpr int TILE = 64 * ROW;
  static constexpr int PANEL = 64 * 128;             // bytes: 64 rows x 64 columns
  static constexpr int QG = 64 * D * 2;              // bytes: one Q or G tile
  static constexpr int SCAL = 5 * TC_ROWS;           // mn, g_l, M, w (fp32), s (int)
  static constexpr int SMEM = 1024 + 2 * TILE * 2 + 2 * (2 * QG + SCAL * 4);
  static constexpr bool K_REGS = D == 64, V_REGS = false;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;
};

// the byte offset of row j's 16-byte chunk c in a swizzled Q or G tile
template <int D>
__device__ __forceinline__ uint32_t qg_off(int j, int c) {
  return (c >> 3) * TcB<D>::PANEL + j * 128 + (((c & 7) ^ (j & 7)) << 4);
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

// Shared-memory matrix descriptor, 128-byte swizzle (as tile_matmul.cu's):
// every swizzle atom (8 rows of 128 bytes) starts on 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async's writes, made visible to wgmma's reads of shared memory
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x N] += A[64 x 16] (registers, mma.sync's A fragment per warp) @
// B[16 x N] (shared memory, N-major), fp32 accumulator
__device__ __forceinline__ void wgmma_ra_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ra_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_ra(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (D == 64) wgmma_ra_n64(d, a, db);
  else wgmma_ra_n128(d, a, db);
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

// The fp32 preamble, a pass of its own at full occupancy: per (query row
// b', head, query) row, g_acc . acc and g_acc . acc_new, g_acc_in = g_acc
// corr and g_acc in bf16 (for the products). D/4 lanes take a row, a
// float4 each: neighbouring lanes read and write neighbouring 16 bytes.
// dl is final here; dm holds corr (g_l l + g_acc . acc) and tie_w holds r
// until pass A adds the max route.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
flash_carry_bwd_kernel_prep(const Args a) {
  constexpr int LPR = D / 4;                              // lanes a row
  const long long nrows = (long long)a.Bp * a.H * a.Sq;
  const long long row =
      (long long)blockIdx.x * (PREP_THREADS / LPR) + threadIdx.x / LPR;
  const int c = (threadIdx.x % LPR) * 4;
  const bool ok = row < nrows;
  float s1 = 0.f, s2 = 0.f, corr = 0.f;
  if (ok) {
    corr = expf(a.m[row] - a.m_new[row]);
    const size_t base = (size_t)row * D + c;
    const float4 g4 = *reinterpret_cast<const float4*>(a.g_acc + base);
    const float4 a4 = *reinterpret_cast<const float4*>(a.acc + base);
    const float4 n4 = *reinterpret_cast<const float4*>(a.acc_new + base);
    s1 = fmaf(g4.x, a4.x, s1); s1 = fmaf(g4.y, a4.y, s1);
    s1 = fmaf(g4.z, a4.z, s1); s1 = fmaf(g4.w, a4.w, s1);
    s2 = fmaf(g4.x, n4.x, s2); s2 = fmaf(g4.y, n4.y, s2);
    s2 = fmaf(g4.z, n4.z, s2); s2 = fmaf(g4.w, n4.w, s2);
    *reinterpret_cast<float4*>(a.dacc + base) =
        make_float4(g4.x * corr, g4.y * corr, g4.z * corr, g4.w * corr);
    uint2 u;
    u.x = pack_bf16(g4.x, g4.y);
    u.y = pack_bf16(g4.z, g4.w);
    *reinterpret_cast<uint2*>(a.g16 + base) = u;
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(FULL, s1, o);
    s2 += __shfl_xor_sync(FULL, s2, o);
  }
  if (ok && c == 0) {
    const float gl = a.g_l[row];
    a.dl[row] = gl * corr;
    a.dm[row] = corr * (gl * a.l[row] + s1);
    a.tie_w[row] = a.g_m[row] - gl * a.l_new[row] - s2;
  }
}

// Pass A: dQ and the max route of 64 flattened query rows (warp w owns
// rows 16w..16w+15). q and g_acc wait in shared memory and are read as A
// fragments by ldmatrix at each k step.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, TcA<D>::MIN_BLOCKS)
flash_carry_bwd_kernel_rows_mma(const Args a) {
  using Cfg = TcA<D>;
  constexpr int ROW = Cfg::ROW, STAGES = Cfg::STAGES, CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + Cfg::TILE;
  __nv_bfloat16* kv_s = gs + Cfg::TILE;                  // [stage][K, V]
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = a.H / a.Kv, Sq = a.Sq, T = a.T, rows = G * Sq;
  const int r0 = blockIdx.x * TC_ROWS, nr = min(TC_ROWS, rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qo = a.q_off[b], ko = a.k_off[b], kl = a.klen[b];
  const long long kv_base = (long long)a.kv_row[b] * a.kv_sb + (long long)kvh * a.kv_sh;

  // the block's rows of q and of g_acc in bf16 (the prep pass's copy),
  // zero past the last row; they land with the first K/V tile
#pragma unroll
  for (int i = 0; i < TC_ROWS * CH / TC_THREADS; ++i) {
    const int idx = tid + i * TC_THREADS, j = idx / CH, c = (idx % CH) * 8;
    const int rr = r0 + j;
    const bool ok = rr < rows;
    const int g = ok ? rr / Sq : 0, s = ok ? rr % Sq : 0, h = kvh * G + g;
    cp_async16(smem_u32(qs + j * ROW + c), ok ? q + b * a.q_sb + s * a.q_ss + h * a.q_sh + c : q,
               ok);
    cp_async16(smem_u32(gs + j * ROW + c),
               ok ? a.g16 + (((size_t)b * a.H + h) * Sq + s) * D + c : a.g16, ok);
  }

  // this lane's rows: e = 0 (fragment rows 0-7) and e = 1 (rows 8-15);
  // head, position and state index recomputed where needed, for registers
  auto head_pos = [&](int e, int& h, int& s) {
    const int rr = r0 + warp * 16 + (lane >> 2) + 8 * e;
    h = kvh * G + (rr < rows ? rr / Sq : 0);
    s = rr < rows ? rr % Sq : 0;
    return ((size_t)b * a.H + h) * Sq + s;
  };
  bool rv[2];
  int qp[2];
  float mn[2], gl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rv[e] = r0 + warp * 16 + (lane >> 2) + 8 * e < rows;
    int h, s;
    const size_t si = head_pos(e, h, s);
    qp[e] = qo + s;
    mn[e] = rv[e] ? a.m_new[si] : 0.f;
    gl[e] = rv[e] ? a.g_l[si] : 0.f;
  }
  const bool res = (!rv[0] || mn[0] > NEG) && (!rv[1] || mn[1] > NEG);
  const bool all_resolved = __syncthreads_and(res);
  if (tid == 0)
    a.resolved[((size_t)b * a.Kv + kvh) * gridDim.x + blockIdx.x] = all_resolved;
  int s_min, s_max;
  position_range(r0, nr, Sq, s_min, s_max);
  const int qpos_min = qo + s_min, qpos_max = qo + s_max;

  auto next_live = [&](int t0) {
    while (t0 < T && tile_dead(t0, min(TC_KEYS, T - t0), ko, kl, qpos_min, qpos_max,
                               a.causal, a.window))
      t0 += TC_KEYS;
    return t0;
  };
  auto load_tile = [&](int t0, int st, bool with_v) {
    __nv_bfloat16* ks = kv_s + (2 * st) * Cfg::TILE;
    __nv_bfloat16* vs = ks + Cfg::TILE;
#pragma unroll
    for (int i = 0; i < TC_KEYS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, j = idx / CH, c = (idx % CH) * 8;
      const bool ok = t0 + j < T;
      const long long off = kv_base + (long long)(t0 + j) * a.kv_st + c;
      cp_async16(smem_u32(ks + j * ROW + c), ok ? k + off : k, ok);
      if (with_v) cp_async16(smem_u32(vs + j * ROW + c), ok ? v + off : v, ok);
    }
  };
  // A fragments of the warp's 16 rows of a [64][ROW] tile at k step kk
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
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
    // a ring of STAGES tiles, STAGES - 1 in flight ahead of the math
    int ld = next_live(0);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (ld < T) {
        load_tile(ld, s, with_v);
        ld = next_live(ld + TC_KEYS);
      }
      cp_async_commit();
    }
    int cur = next_live(0), st = 0;
    while (cur < T) {
      cp_async_wait<STAGES - 2>();              // this thread's tile cur landed
      __syncthreads();                          // everyone's; the last stage is free
      if (ld < T) {
        load_tile(ld, (st + STAGES - 1) % STAGES, with_v);
        ld = next_live(ld + TC_KEYS);
      }
      cp_async_commit();
      const __nv_bfloat16* ks = kv_s + (2 * st) * Cfg::TILE;
      const __nv_bfloat16* vs = ks + Cfg::TILE;
      // a tile live for every row of the block needs no mask (rows past the
      // block have q = g_acc = 0, so their dS is 0)
      const bool all_live = tile_live(cur, T, ko, kl, qpos_min, qpos_max, a.causal,
                                      a.window);
      // the tile's 64 keys in two halves of 32, for registers
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k0 = hf * (TC_KEYS / 2);
        // S = Q K^T for the warp's 16 rows x 32 keys: sc[j] is the C
        // fragment of keys k0 + j*8.. (the forward's order of products)
        float sc[TC_KEYS / 16][4];
#pragma unroll
        for (int j = 0; j < TC_KEYS / 16; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, smem_u32(qs + a_row * ROW + kk * 16 + a_col));
#pragma unroll
          for (int jj = 0; jj < TC_KEYS / 32; ++jj) {
            uint32_t bk[4];
            const int key = k0 + jj * 16 + (lane & 7) + (lane >> 4) * 8;
            const int d = kk * 16 + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(bk, smem_u32(ks + key * ROW + d));
            mma_bf16(sc[2 * jj], af, bk[0], bk[1]);
            mma_bf16(sc[2 * jj + 1], af, bk[2], bk[3]);
          }
        }
        // bit 4j + i of live: whether sc[j][i] is (all, for a live tile)
        uint32_t live = FULL;
        if (!all_live) {
          live = 0u;
#pragma unroll
          for (int j = 0; j < TC_KEYS / 16; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = i >> 1, key = cur + k0 + j * 8 + (lane & 3) * 2 + (i & 1);
              if (key < T && rv[e] && key_ok(ko + key, qp[e], kl, a.causal, a.window))
                live |= 1u << (4 * j + i);
            }
        }
        if (sweep == 0) {
          // the tally of each row's max: the half's max first, and the keys
          // that tie it only where it reaches the running max (rounding is
          // monotone, so the half's max times scale is the max of the
          // scaled scores; the ties are counted among the scaled scores)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float tm = -INFINITY;
#pragma unroll
            for (int j = 0; j < TC_KEYS / 16; ++j)
#pragma unroll
              for (int i = 2 * e; i < 2 * e + 2; ++i)
                if (live >> (4 * j + i) & 1u) tm = fmaxf(tm, sc[j][i]);
            const float M = tm * a.scale;
            if (tm > -INFINITY && M >= bm[e]) {
              if (M > bm[e]) {
                bm[e] = M;
                bc[e] = 0;
              }
#pragma unroll
              for (int j = 0; j < TC_KEYS / 16; ++j)
#pragma unroll
                for (int i = 2 * e; i < 2 * e + 2; ++i)
                  if ((live >> (4 * j + i) & 1u) && sc[j][i] * a.scale == M) {
                    if (bc[e] == 0) bj[e] = cur + k0 + j * 8 + (lane & 3) * 2 + (i & 1);
                    ++bc[e];
                  }
            }
          }
          // dS = p (dP + g_l), by 16 keys: dP = g_acc V^T
#pragma unroll
          for (int jj = 0; jj < TC_KEYS / 32; ++jj) {
            float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              uint32_t gf[4], bv[4];
              const int key = k0 + jj * 16 + (lane & 7) + (lane >> 4) * 8;
              const int d = kk * 16 + ((lane >> 3) & 1) * 8;
              ldmatrix_x4(gf, smem_u32(gs + a_row * ROW + kk * 16 + a_col));
              ldmatrix_x4(bv, smem_u32(vs + key * ROW + d));
              mma_bf16(dp[0], gf, bv[0], bv[1]);
              mma_bf16(dp[1], gf, bv[2], bv[3]);
            }
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int j = 2 * jj + h2, e = i >> 1;
                const float p = ex2(fmaf(sc[j][i], sl2, -mb[e]));
                sc[j][i] = live >> (4 * j + i) & 1u ? p * (dp[h2][i] + gl[e]) : 0.f;
              }
          }
        } else {
          // the ties alone: dS = w where s equals the row's max
#pragma unroll
          for (int j = 0; j < TC_KEYS / 16; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = i >> 1;
              sc[j][i] =
                  (live >> (4 * j + i) & 1u) && bc[e] > 1 && sc[j][i] * a.scale == bm[e]
                      ? w[e]
                      : 0.f;
            }
        }
        // dQ += dS K, 16 keys per step
#pragma unroll
        for (int kk = 0; kk < TC_KEYS / 32; ++kk) {
          uint32_t af[4];
          af[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          af[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          af[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          af[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
          for (int jd = 0; jd < D / 16; ++jd) {
            uint32_t bk[4];
            const int key = k0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int d = jd * 16 + (lane >> 4) * 8;
            ldmatrix_x4_trans(bk, smem_u32(ks + key * ROW + d));
            mma_bf16(dq[2 * jd], af, bk[0], bk[1]);
            mma_bf16(dq[2 * jd + 1], af, bk[2], bk[3]);
          }
        }
      }
      cur = next_live(cur + TC_KEYS);
      st = (st + 1) % STAGES;
    }
    cp_async_wait<0>();
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
        int h, sp;
        const size_t si = head_pos(e, h, sp);
        if (rv[e]) {
          const float r = a.tie_w[si];              // the prep pass's r
          max_route(a.m[si], bm[e], bc[e], r, to_m, w[e], M);
        }
        // every lane of the quad has read r before its first lane writes w
        __syncwarp();
        if (rv[e] && (lane & 3) == 0) {
          a.dm[si] += to_m;
          a.tie_max[si] = M;
          a.tie_w[si] = w[e];
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
    int h, sp;
    head_pos(e, h, sp);
    __nv_bfloat16* row = out + (((size_t)b * Sq + sp) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(row + j * 8 + (lane & 3) * 2, dq[j][2 * e] * a.scale, dq[j][2 * e + 1] * a.scale);
  }
}

// Pass B: dK and dV of 64 keys of one (K/V row, KV head) over one share of
// the items (query row, query tile) that read them; warp w owns keys
// 16w..16w+15. S and dP are mma.sync with the query rows on the M side,
// as pass A takes them; dV += P^T G and dK += dS^T Q are wgmma over the
// warpgroup's 64 keys, P^T and dS^T from registers, G and Q read from
// shared memory once for all four warps. SPLIT: the share's fp32 partials
// go to scratch for the fixed-order sum; otherwise dK and dV themselves.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(TC_THREADS, TcB<D>::MIN_BLOCKS)
flash_carry_bwd_kernel_keys_mma(const Args a) {
  using Cfg = TcB<D>;
  constexpr int ROW = Cfg::ROW, CH = D / 8;       // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + Cfg::TILE;
  const uint32_t qg_s = smem_u32(vs + Cfg::TILE);        // [stage][Q, G], 1024-aligned
  float* scal = reinterpret_cast<float*>(smem + 2 * Cfg::TILE * 2 + 4 * Cfg::QG);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const int kv_tiles = (a.T + TC_KEYS - 1) / TC_KEYS;
  const int share = blockIdx.x / kv_tiles, t0 = (blockIdx.x % kv_tiles) * TC_KEYS;
  const int kr = blockIdx.z, kvh = blockIdx.y;
  const int nt = min(TC_KEYS, a.T - t0);
  const int G = a.H / a.Kv, Sq = a.Sq, T = a.T, rows = G * Sq;
  const int ntile = (rows + TC_ROWS - 1) / TC_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float sl2 = a.scale * LOG2E;

  {
    const long long kv_base = (long long)kr * a.kv_sb + (long long)kvh * a.kv_sh;
#pragma unroll
    for (int i = 0; i < TC_KEYS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, j = idx / CH, c = (idx % CH) * 8;
      const bool ok = j < nt;
      const long long off = kv_base + (long long)(t0 + j) * a.kv_st + c;
      cp_async16(smem_u32(ks + j * ROW + c), ok ? k + off : k, ok);
      cp_async16(smem_u32(vs + j * ROW + c), ok ? v + off : v, ok);
    }
    cp_async_commit();
  }

  // this share's items, in order: item n is query tile n % ntile of the
  // n / ntile-th query row that reads K/V row kr
  const int i0 = a.start[kr];
  const int* bounds = a.share + (size_t)kr * (a.nsplit + 1) + share;
  const int n_end = bounds[1];
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
    while (n < n_end && !needed(n)) ++n;
    return n;
  };
  auto load_item = [&](int n, int st) {
    const int b = a.order[i0 + n / ntile], r0 = (n % ntile) * TC_ROWS;
    const uint32_t qs = qg_s + (2 * st) * Cfg::QG, gs = qs + Cfg::QG;
    // (group, position) of row r0 + j: one division an item where the rows
    // wrap into the next group at most once
    const int g0 = r0 / Sq, s0 = r0 % Sq;
    auto group_pos = [&](int j, int& g, int& s) {
      if (Sq >= TC_ROWS) {
        s = s0 + j;
        g = g0 + (s >= Sq);
        s -= s >= Sq ? Sq : 0;
      } else {
        g = (r0 + j) / Sq;
        s = (r0 + j) % Sq;
      }
    };
#pragma unroll
    for (int i = 0; i < TC_ROWS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, j = idx / CH, c = idx % CH;
      const bool ok = r0 + j < rows;
      int g, s;
      group_pos(j, g, s);
      const int h = kvh * G + (ok ? g : 0);
      s = ok ? s : 0;
      const __nv_bfloat16* qsrc = q + b * a.q_sb + s * a.q_ss + h * a.q_sh + c * 8;
      const __nv_bfloat16* gsrc = a.g16 + (((size_t)b * a.H + h) * Sq + s) * D + c * 8;
      cp_async16(qs + qg_off<D>(j, c), ok ? qsrc : q, ok);
      cp_async16(gs + qg_off<D>(j, c), ok ? gsrc : a.g16, ok);
    }
    if (tid < TC_ROWS) {
      float* sc = scal + st * Cfg::SCAL;
      const bool ok = r0 + tid < rows;
      int g, s;
      group_pos(tid, g, s);
      g = ok ? g : 0;
      s = ok ? s : 0;
      const size_t si = ((size_t)b * a.H + kvh * G + g) * Sq + s;
      cp_async4(smem_u32(sc + tid), a.m_new + si, ok);
      cp_async4(smem_u32(sc + TC_ROWS + tid), a.g_l + si, ok);
      cp_async4(smem_u32(sc + 2 * TC_ROWS + tid), a.tie_max + si, ok);
      cp_async4(smem_u32(sc + 3 * TC_ROWS + tid), a.tie_w + si, ok);
      reinterpret_cast<int*>(sc)[4 * TC_ROWS + tid] = ok ? s : -1;
    }
  };

  // wgmma's accumulators: value 4j + i at key 16w + lane/4 + 8 (i >> 1),
  // column 8j + 2 (lane % 4) + (i & 1)
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
  // the warp's K and V B fragments (the same for every query tile), kept
  // in registers where room allows
  uint32_t kb[Cfg::K_REGS ? D / 16 : 1][4], vb[Cfg::V_REGS ? D / 16 : 1][4];
  const int kv_key = warp * 16 + (lane & 7) + (lane >> 4) * 8;
  if constexpr (Cfg::K_REGS || Cfg::V_REGS) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int d = kk * 16 + ((lane >> 3) & 1) * 8;
      if constexpr (Cfg::K_REGS) ldmatrix_x4(kb[kk], smem_u32(ks + kv_key * ROW + d));
      if constexpr (Cfg::V_REGS) ldmatrix_x4(vb[kk], smem_u32(vs + kv_key * ROW + d));
    }
  }
  int cur = next_needed(bounds[0]), st = 0;
  if (cur < n_end) load_item(cur, 0);
  cp_async_commit();
  while (cur < n_end) {
    const int nxt = next_needed(cur + 1);
    if (nxt < n_end) load_item(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const uint32_t qs = qg_s + (2 * st) * Cfg::QG, gs = qs + Cfg::QG;
    const float* sc = scal + st * Cfg::SCAL;
    const int* spos = reinterpret_cast<const int*>(sc) + 4 * TC_ROWS;
    const int b = a.order[i0 + cur / ntile];
    const int r0 = (cur % ntile) * TC_ROWS;
    const int qo = a.q_off[b], ko = a.k_off[b], kl = a.klen[b];
    int s_min, s_max;
    position_range(r0, min(TC_ROWS, rows - r0), Sq, s_min, s_max);
    // the block's keys live for every query of the tile: no mask; full:
    // and every key of the block lies below T
    const bool all_live = tile_live(t0, T, ko, kl, qo + s_min, qo + s_max, a.causal,
                                    a.window);
    const bool full = all_live && t0 + TC_KEYS <= T;
    for (int ch = 0; ch < TC_ROWS / 16 && r0 + ch * 16 < rows; ++ch) {
      // S and dP for 16 query rows (M side) x the warp's 16 keys, as pass A
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int arow = ch * 16 + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4], bk[4];
        const int d = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af, qs + qg_off<D>(arow, kk * 2 + (lane >> 4)));
        if constexpr (Cfg::K_REGS) {
          mma_bf16(s[0], af, kb[kk][0], kb[kk][1]);
          mma_bf16(s[1], af, kb[kk][2], kb[kk][3]);
        } else {
          ldmatrix_x4(bk, smem_u32(ks + kv_key * ROW + d));
          mma_bf16(s[0], af, bk[0], bk[1]);
          mma_bf16(s[1], af, bk[2], bk[3]);
        }
        ldmatrix_x4(af, gs + qg_off<D>(arow, kk * 2 + (lane >> 4)));
        if constexpr (Cfg::V_REGS) {
          mma_bf16(dp[0], af, vb[kk][0], vb[kk][1]);
          mma_bf16(dp[1], af, vb[kk][2], vb[kk][3]);
        } else {
          ldmatrix_x4(bk, smem_u32(vs + kv_key * ROW + d));
          mma_bf16(dp[0], af, bk[0], bk[1]);
          mma_bf16(dp[1], af, bk[2], bk[3]);
        }
      }
      // P and dS of the 16 x 16 pairs; the thread's two rows' scalars
      float mn[2], glr[2], tmx[2], twr[2];
      int spr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = ch * 16 + (lane >> 2) + 8 * e;
        mn[e] = sc[row];
        glr[e] = sc[TC_ROWS + row];
        tmx[e] = sc[2 * TC_ROWS + row];
        twr[e] = sc[3 * TC_ROWS + row];
        spr[e] = spos[row];
      }
      if (full && r0 + ch * 16 + 16 <= rows) {
        // every pair live: p as pass A takes it, the tie test on s scale
        const float mb[2] = {mn[0] * LOG2E, mn[1] * LOG2E};
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i >> 1;
            const float sv = s[h2][i] * a.scale;
            const float p = ex2(fmaf(s[h2][i], sl2, -mb[e]));
            s[h2][i] = p;
            dp[h2][i] = p * (dp[h2][i] + glr[e]) + (sv == tmx[e] ? twr[e] : 0.f);
          }
      } else {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i >> 1;
            const int key = t0 + warp * 16 + h2 * 8 + (lane & 3) * 2 + (i & 1);
            const bool in = key < T && spr[e] >= 0;
            const bool live =
                in && (all_live || key_ok(ko + key, qo + spr[e], kl, a.causal, a.window));
            const float sv = live ? s[h2][i] * a.scale : NEG;
            const float p = in ? ex2((sv - mn[e]) * LOG2E) : 0.f;
            s[h2][i] = p;
            dp[h2][i] =
                live ? p * (dp[h2][i] + glr[e]) + (sv == tmx[e] ? twr[e] : 0.f) : 0.f;
          }
      }
      // the previous chunk's products have read their A registers
      wgmma_wait0();
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
      // dV += P^T G, dK += dS^T Q over the block's 64 keys: rows ch*16.. of
      // the swizzled tiles, N-major; they run on while the next chunk's S
      // and dP are taken
      wgmma_fence();
      wgmma_ra<D>(dv, pt, sw128_desc(gs + ch * 16 * 128, Cfg::PANEL, 1024));
      wgmma_ra<D>(dk, dst, sw128_desc(qs + ch * 16 * 128, Cfg::PANEL, 1024));
      wgmma_commit();
    }
    wgmma_wait0();
    __syncthreads();                            // stage st is refilled next
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = t0 + warp * 16 + (lane >> 2) + 8 * e;
    if (key >= T) continue;
    const size_t base = (((size_t)kr * T + key) * a.Kv + kvh) * D;
    if constexpr (SPLIT) {
      // [2][nsplit][Bk, T, Kv, D]: dK's partials, then dV's
      const size_t n = (size_t)a.Bk * T * a.Kv * D;
      float* pk = a.part + share * n + base;
      float* pv = a.part + (a.nsplit + share) * n + base;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        store2(pk + c, dk[4 * j + 2 * e], dk[4 * j + 2 * e + 1]);
        store2(pv + c, dv[4 * j + 2 * e], dv[4 * j + 2 * e + 1]);
      }
    } else {
      __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(a.dk) + base;
      __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(a.dv) + base;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        store2(dk_out + c, dk[4 * j + 2 * e] * a.scale, dk[4 * j + 2 * e + 1] * a.scale);
        store2(dv_out + c, dv[4 * j + 2 * e], dv[4 * j + 2 * e + 1]);
      }
    }
  }
}

// dK and dV from pass B's partials: the shares summed in their order (0,
// 1, ...), whichever block finished first; 4 elements a thread.
__global__ void __launch_bounds__(SUM_THREADS) flash_carry_bwd_kernel_sum(const Args a) {
  const size_t n = (size_t)a.Bk * a.T * a.Kv * a.D;
  const size_t i = ((size_t)blockIdx.x * SUM_THREADS + threadIdx.x) * 4;
  if (i >= n) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < a.nsplit; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(a.part + s * n + i);
    const float4 y = *reinterpret_cast<const float4*>(a.part + (a.nsplit + s) * n + i);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  uint2 uk, uv;
  uk.x = pack_bf16(sk.x * a.scale, sk.y * a.scale);
  uk.y = pack_bf16(sk.z * a.scale, sk.w * a.scale);
  uv.x = pack_bf16(sv.x, sv.y);
  uv.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.dk) + i) = uk;
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.dv) + i) = uv;
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
  static bool attr_a = false, attr_b = false, attr_bs = false;
  auto ka = flash_carry_bwd_kernel_rows_mma<D>;
  const bool split = a.nsplit > 1;
  auto kb = split ? flash_carry_bwd_kernel_keys_mma<D, true>
                  : flash_carry_bwd_kernel_keys_mma<D, false>;
  cudaError_t e = allow_smem(ka, TcA<D>::SMEM, attr_a);
  if (e != cudaSuccess) return e;
  e = allow_smem(kb, TcB<D>::SMEM, split ? attr_bs : attr_b);
  if (e != cudaSuccess) return e;
  const long long nrows = (long long)a.Bp * a.H * a.Sq;
  constexpr int prep_rows = PREP_THREADS / (D / 4);
  flash_carry_bwd_kernel_prep<D>
      <<<(unsigned)((nrows + prep_rows - 1) / prep_rows), PREP_THREADS, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = (a.H / a.Kv) * a.Sq;
  ka<<<dim3((rows + TC_ROWS - 1) / TC_ROWS, a.Kv, a.Bp), TC_THREADS, TcA<D>::SMEM, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.T == 0) return e;
  const int kv_tiles = (a.T + TC_KEYS - 1) / TC_KEYS;
  kb<<<dim3(kv_tiles * a.nsplit, a.Kv, a.Bk), TC_THREADS, TcB<D>::SMEM, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  const long long n4 = (long long)a.Bk * a.T * a.Kv * D / 4;
  flash_carry_bwd_kernel_sum<<<(unsigned)((n4 + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS,
                               0, s>>>(a);
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

template <int D>
cudaError_t keys_resident(int* out) {
  static bool attr = false;
  auto kb = flash_carry_bwd_kernel_keys_mma<D, false>;
  cudaError_t e = allow_smem(kb, TcB<D>::SMEM, attr);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kb, TC_THREADS, TcB<D>::SMEM);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return e;
}

}  // namespace

// Whether the tensor-core body takes these inputs (the wrapper sizes its
// scratch by it).
extern "C" int flash_carry_bwd_uses_mma(int q_dtype, int kv_dtype, int Sq, int D) {
  return q_dtype == 1 && kv_dtype == 1 && Sq > 1 && (D == 64 || D == 128);
}

// How many blocks of the tensor-core pass B the current device holds at
// once (blocks an SM times SMs), into *out: the wrapper's split plan reads
// it.
extern "C" int flash_carry_bwd_keys_resident(int D, int* out) {
  *out = 0;
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(D == 64 ? keys_resident<64>(out) : keys_resident<128>(out));
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
    float scale, int nsplit, const int* share, float* part, void* stream) {
  if (Bp <= 0 || Bk <= 0 || Sq <= 0 || T < 0 || Kv <= 0 || H % Kv != 0 || D <= 0 ||
      D > DMAX || (q_dtype != 0 && q_dtype != 1) || (kv_dtype != 0 && kv_dtype != 1) ||
      nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // K/V rows are copied as 16-byte vectors: they must start on 16 bytes
  const long long vn = kv_dtype == 0 ? 4 : 8;
  if (D % vn || kv_sb % vn || kv_st % vn || kv_sh % vn || misaligned(k, 16) ||
      misaligned(v, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q, k, v, q_sb, q_ss, q_sh, kv_sb, kv_st, kv_sh, kv_row, order, start,
               q_off, k_off, klen, T, m, l, acc, m_new, l_new, acc_new, g_m, g_l, g_acc,
               dq, dk, dv, dm, dl, dacc, tie_max, tie_w,
               static_cast<__nv_bfloat16*>(g16), resolved, nsplit, share, part, Bp, Bk, H,
               Kv, Sq, D, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (flash_carry_bwd_uses_mma(q_dtype, kv_dtype, Sq, D)) {
    // q rows are copied as 16-byte vectors, acc-sized rows read as float4,
    // dq / dk / dv written as bf16 pairs (as 4-element groups by the sum)
    if (q_sb % 8 || q_ss % 8 || q_sh % 8 || misaligned(q, 16) || misaligned(acc, 16) ||
        misaligned(acc_new, 16) || misaligned(g_acc, 16) || misaligned(dacc, 16) ||
        misaligned(g16, 16) || misaligned(dq, 4) || misaligned(dk, 8) || misaligned(dv, 8) ||
        (nsplit > 1 && misaligned(part, 16)))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = D == 64 ? launch_mma<64>(a, s) : launch_mma<128>(a, s);
  } else {
    err = q_dtype == 0 ? dispatch_simt<float>(a, kv_dtype, s)
                       : dispatch_simt<__nv_bfloat16>(a, kv_dtype, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
