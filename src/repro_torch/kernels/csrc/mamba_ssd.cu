// Mamba-2 SSD per-chunk quadratic form, f32 accuracy, for Hopper (sm_90a),
// on the tensor cores.
// x (BC, Q, H, P), cum (BC, Q, H) of one type TX, B and C (BC, Q, N) of
// one type TB, contiguous -> y (BC, Q, H, P) and the chunk state S (BC, H,
// N, P), f32.  Three launch functions: all f32, all bf16, and "mixed"
// (x and cum f32, B and C bf16: what ops.ssd_chunks hands the kernel when
// the model computes in bf16, as the reference's ssd_forward hands its
// Pallas kernel B and C in the model's type).
//
// Replaces the Pallas kernel `_ssd_kernel` driven by `ssd_chunk_dual`
// (src/repro/kernels/mamba_ssd.py:48, body at :25).  For each chunk c and
// head h it computes
//   y[i, :]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x[j, h, :]
//   S[n, :]  = sum_j B[j, n] exp(cum_{Q-1} - cum_j) x[j, h, :]
// with n_groups = 1 (B and C shared by every head).  Above the diagonal
// (j > i) cum_i - cum_j is positive and its exp may overflow, so the
// kernel selects 0 there and never uses that exp.  The chunk state uses
// the chunk's last row, padded rows included, as the reference does: rows
// the caller padded carry dt = 0 and x = 0 and add nothing.
//
// What bounds it.  Per chunk the reference's work is C B^T once (Q^2 N / 2
// MACs, shared by every head) and, per head, W x and (d .* B)^T x (Q^2 P /
// 2 and Q N P MACs).  At the serve shapes (zamba2: Q 128, H 64, P 64, N
// 64; mamba2-370m: H 32, P 64, N 128) that is 68 M and 52 M MACs a chunk
// on 5.3 and 3.3 MB in f32: in 3xTF32 (495 / 3 TFLOP/s) the operations
// take 26 and 20 us a launch of 32 chunks, the bytes at 3.35 TB/s 51 and
// 31 us.
// The design keeps every product it issues one the reference counts.
// Measured, it is about 3x its bytes bound and bound by its instruction
// issue and barriers, not by either roofline: the variants benchmark
// (benchmarks/port_ssd_variants.py) times it without S's product, without
// y's and without the decay tables, each worth a fifth to a third of the
// time at zamba2's wave, the rest loads, stores, splits and barriers.
//
// Design.  One block per (chunk, group of heads), 16 warps, one block an
// SM (up to 216 KB of shared memory).  The block copies C and B once and
// computes C B^T once for all of its heads: the causal 16 x 16 tiles (36
// at Q = 128), handed out to the warps in turn, kept in shared memory in
// mma fragment order (36 KB).  f32 B and C take m16n8k8 3xTF32 products
// (tf32x3.cuh); bf16 B and C one m16n8k16 bf16 product a k16 step
// (bf16_tc.cuh: the products are exact), each step's sum taken in a
// zeroed fragment and added in f32 (the tensor core's accumulation rounds
// toward zero).  Then the block walks its units, a unit being one head and
// one tile of P: 64 columns (heads of P = 64, as both served models have,
// are one unit, so no warp computes over zero columns), or 128 for bf16 x
// at N <= 64 and P > 64 (the realization shape's bf16 heads of P = 128:
// a warp's 32 columns share each fragment it prepares over four n8 tiles;
// 64-column units there took 71.4 us a launch against 56.9).  The next
// unit's x tile is copied with cp.async into the second of two buffers
// (the first time into C's, which the scores have freed), and its decay
// tables are filled into the second of two table buffers, while the
// current unit is computed: one barrier a unit.  The tables of a unit,
// from its head's cum: the end decays d_j = exp(cum_{Q-1} - cum_j); the
// diagonal tiles' masked decays (exp(cum_i - cum_j) where j <= i, else 0);
// and, for a tile (I, J) below the diagonal, the factors exp(cum_i - m_J)
// and exp(m_J - cum_j) with m_J the least cum of tile J, so that W =
// scores .* decay is the score tile scaled by column factors before the
// product and by row factors after it.  Both factors stay finite wherever
// the reference's exp does (m_J is one of the tile's cum_j, all of them
// j < i), and the exps a unit takes fall from Q^2 / 2 to about 1.4 Q^2 / 8.
// Warp w = 4 p + q takes a quarter of the unit's columns and, over the J
// tiles in order, at each J: the x fragments of rows 16 J .. 16 J + 15
// once, shared by S's rows 16 p and 16 (p + 4) (N <= 128; 16 p at N <= 64)
// and by y's strips p and 7 - p (a heavy causal strip paired with a light
// one: 9 tiles each pair, so the warps' work is even).  W x and
// (d .* B)^T x keep 3xTF32 (two products where x is bf16, exact in TF32);
// each J tile's products go into a zeroed fragment added in f32.  The
// scores' C-fragment layout is used as the A fragment of W x with j
// permuted inside each k8 step the same way on both sides (a0..a3 = c0,
// c2, c1, c3; the x fragment reads rows 2t and 2t + 1), and S takes the
// same permutation.
//
// Heads a block: by grid fill on the card's SMs (ssd_chunk_dual_heads),
// as the bf16 GEMM picks its tile: the least waves x (units a block + one
// unit's worth for the scores and the copies of C and B).  zamba2's serve
// wave (BC 32, H 64) takes 16 heads a block (128 blocks), mamba2-370m's
// (BC 32, H 32) 8, the realization shape (H 16, P 128) 4.
//
// Tried and not kept: one head a block, each computing its own scores
// (the design of PRs 15-28, C B^T 64 times over at zamba2, and its
// 128-column P tile half idle at P = 64): forced to one head a block this
// kernel takes 230 us at zamba2's wave in the mixed type against 149 (the
// variants benchmark); f32 units of 128 columns (an f32 tile of 128
// columns leaves no room for the second table buffer, and the warps'
// fragments would spill); the decay tables through expf (no faster); the
// x tile split into its TF32 parts once and kept in shared memory (PR 15:
// slower, twice the shared reads).
// Rows are copied 16 bytes at a time where P and N are multiples of 16
// bytes of their types and x, B and C are 16-byte aligned, else one
// element at a time (cp.async of 4 bytes for f32, a plain load for bf16).
// Taken: 1 <= Q <= 128, 1 <= N <= 128, any P (tiled in the block),
// BC * ceil(H / heads) < 2^31.
//
// Two instances by the state width (NMAX): N <= 64, and N <= 128 (C and B
// tiles of Q x 132 floats; the block's shared memory is then 221,184
// bytes in f32 at Q = 128, C's buffer holding the second x tile and the
// second table buffer).

#include <cstdio>

#include <cuda_runtime.h>

#include "bf16_tc.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
using bf16 = __nv_bfloat16;

constexpr int STRIPS = 8;                 // 16-row strips of the chunk
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int QMAX = 16 * STRIPS;         // chunk length
constexpr int TILES = STRIPS * (STRIPS + 1) / 2;   // causal 16x16 tiles
constexpr int NMAX_S = 64, NMAX_L = 128;  // the instances' state widths
// one unit's decay tables, floats: the diagonal tiles' decays (fragment
// order), the row factors a[J][i], the column factors, the end decays
constexpr int TABLE_FLOATS = STRIPS * 256 + STRIPS * QMAX + 2 * QMAX;
// the fixed part: the scores (fragment order), the first unit-table
// buffer, cum of two units
constexpr int FIXED_FLOATS = TILES * 256 + TABLE_FLOATS + 2 * QMAX;

// Row strides in elements.  f32: 4 mod 32 words, so the fragment reads
// hit 32 different banks; bf16: 16 bytes of pad.  Rows stay 16-byte
// aligned either way.
template <class T, int NMAX>
__host__ __device__ constexpr int ldn() {
  return NMAX + int(16 / sizeof(T));
}
template <class T, int PT>
__host__ __device__ constexpr int ldx() {
  return PT + int(16 / sizeof(T));
}

// Where the second unit-table buffer goes: in the tail of C's buffer
// (which holds the second x tile once the scores are taken) where C's
// tile leaves room, else after the first x tile.
__host__ __device__ constexpr bool tables_in_c(size_t b_bytes,
                                               size_t x_bytes) {
  return b_bytes >= x_bytes + sizeof(float) * TABLE_FLOATS;
}

// Dynamic shared memory for QP (Q rounded up to 16) rows: the fixed
// part, B, C's tile (then the second x tile), the first x tile and, where
// C's tile has no room for it, the second table buffer.
template <class TX, class TB, int NMAX, int PT>
size_t smem_bytes(int QP) {
  const size_t bt = sizeof(TB) * size_t(QP) * ldn<TB, NMAX>();
  const size_t xt = sizeof(TX) * size_t(QP) * ldx<TX, PT>();
  return sizeof(float) * FIXED_FLOATS + bt + (bt > xt ? bt : xt) + xt +
         (tables_in_c(bt, xt) ? 0 : sizeof(float) * TABLE_FLOATS);
}

// Rows 0 .. QP - 1 of a (rows, cols) matrix with row stride `ld` into a
// (QP, LD) tile, columns 0 .. CMAX - 1, zero at r >= rows or c >= cols.
// Issues cp.async copies (or, for bf16 one element at a time, plain
// loads); no wait.
template <class T, int CMAX, int LD, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t ld,
                                          int rows, int cols, int QP) {
  constexpr int W = kCopyElems<T, VEC>; // elements a copy
  constexpr int CH = CMAX / W;          // copies a row
  for (int idx = threadIdx.x; idx < QP * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * W;
    const bool in = r < rows && c < cols;
    const T* from = in ? src + r * ld + c : src;
    copy_elems<T, VEC>(dst + r * LD + c, from, in);
  }
}

// s = C[i0 .. i0 + 15] . B[j0 .. j0 + 15]^T over the state width, 3xTF32:
// s[n] holds columns j0 + 8n .. j0 + 8n + 7.  Fragments of at most 8 k8
// steps, added to s with f32 adds.
template <int NMAX>
__device__ __forceinline__ void score_tile(float (&s)[2][4], const float* Cs,
                                           const float* Bs, int i0, int j0,
                                           int NK, int g, int t) {
  constexpr int LDN = ldn<float, NMAX>();
  float d[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = d[n][e] = 0.f;
#pragma unroll
  for (int k = 0; k < NMAX / 8; ++k) {
    if (k >= NK) break;
    const float* cr = Cs + (i0 + g) * LDN + 8 * k + t;
    uint32_t ahi[4], alo[4];
    split(cr[0], ahi[0], alo[0]);
    split(cr[8 * LDN], ahi[1], alo[1]);
    split(cr[4], ahi[2], alo[2]);
    split(cr[8 * LDN + 4], ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float* br = Bs + (j0 + 8 * n + g) * LDN + 8 * k + t;
      uint32_t bhi[2], blo[2];
      split(br[0], bhi[0], blo[0]);
      split(br[4], bhi[1], blo[1]);
      mma3(d[n], ahi, alo, bhi, blo);
    }
    if (k % 8 == 7) {
      drain(s[0], d[0]);
      drain(s[1], d[1]);
    }
  }
  drain(s[0], d[0]);
  drain(s[1], d[1]);
}

// The same from bf16 C and B: one m16n8k16 bf16 product a k16 step (the
// products are exact in f32), each step's sum in a zeroed fragment added
// to s in f32.
template <int NMAX>
__device__ __forceinline__ void score_tile(float (&s)[2][4], const bf16* Cs,
                                           const bf16* Bs, int i0, int j0,
                                           int NK, int g, int t) {
  constexpr int LDN = ldn<bf16, NMAX>();
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const int K16 = (NK + 1) / 2;         // k16 steps (NK counts k8 steps)
#pragma unroll
  for (int k = 0; k < NMAX / 16; ++k) {
    if (k >= K16) break;
    const bf16* cr = Cs + (i0 + g) * LDN + 16 * k + 2 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(cr);
    a[1] = *reinterpret_cast<const uint32_t*>(cr + 8 * LDN);
    a[2] = *reinterpret_cast<const uint32_t*>(cr + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(cr + 8 * LDN + 8);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const bf16* br = Bs + (j0 + 8 * n + g) * LDN + 16 * k + 2 * t;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      bf16tc::mma16816(d, a, *reinterpret_cast<const uint32_t*>(br),
                       *reinterpret_cast<const uint32_t*>(br + 8));
      drain(s[n], d);
    }
  }
}

// Columns col, col + 1 of an output row, those below pw: one 8-byte store
// where the row allows it and both are in, else one store each.
__device__ __forceinline__ void store2(float* row, int col, int pw, bool vec,
                                       float v0, float v1) {
  if (vec && col + 1 < pw) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
    return;
  }
  if (col < pw) row[col] = v0;
  if (col + 1 < pw) row[col + 1] = v1;
}

__device__ __forceinline__ void zero(float (&a)[2][4]) {
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[o][e] = 0.f;
}

// One unit's decay tables from its cum (QP entries, rows past Q holding
// row Q - 1's): the column factors exp(m_J - cum_j) and the row factors
// exp(cum_i - m_J) of the tiles below the diagonal (m_J the least cum of
// tile J: warp J), the end decays (0 past Q) and the diagonal tiles'
// masked decays in fragment order (all threads).
__device__ __forceinline__ void fill_tables(const float* __restrict__ cu,
                                            float* __restrict__ tb, int Q,
                                            int QP) {
  float* dg = tb;                       // [STRIPS][256]
  float* at = dg + STRIPS * 256;        // [STRIPS][QMAX]
  float* bt = at + STRIPS * QMAX;       // [QMAX]
  float* de = bt + QMAX;                // [QMAX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nS = QP / 16;
  if (warp < nS) {
    const int J = warp;
    const float v = cu[16 * J + (lane & 15)];
    float m = v;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane < 16) bt[16 * J + lane] = __expf(m - v);
    for (int i = 16 * (J + 1) + lane; i < QP; i += 32)
      at[J * QMAX + i] = __expf(cu[i] - m);
  }
  if (tid < QP) de[tid] = tid < Q ? expf(cu[Q - 1] - cu[tid]) : 0.f;
  for (int e = tid; e < nS * 256; e += THREADS) {
    const int I = e >> 8, l = (e >> 3) & 31, k = e & 7;
    const int i = 16 * I + (l >> 2) + 8 * ((k & 3) >> 1);
    const int j = 16 * I + 8 * (k >> 2) + 2 * (l & 3) + (k & 1);
    dg[e] = j <= i ? __expf(cu[i] - cu[j]) : 0.f;
  }
}

template <class TX, class TB, int NMAX, int PT, bool VEC>
__device__ __forceinline__ void ssd_body(
    const TX* __restrict__ x, const TX* __restrict__ cum,
    const TB* __restrict__ Bm, const TB* __restrict__ Cm,
    float* __restrict__ y, float* __restrict__ state, int H, int Q, int P,
    int N, int QP, int HB, int n_groups) {
  constexpr int LDN = ldn<TB, NMAX>();
  constexpr int LDX = ldx<TX, PT>();
  constexpr int NO = PT / 32;           // n8 tiles of a warp's columns
  constexpr bool EXX = kTf32Exact<TX>;  // x exact in TF32: two products
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sc = reinterpret_cast<float*>(smem_raw);   // [TILES][256]
  float* tb0 = sc + TILES * 256;        // unit tables, even units
  float* cs = tb0 + TABLE_FLOATS;       // [2][QMAX] cum of two units
  TB* Bs = reinterpret_cast<TB*>(cs + 2 * QMAX);    // [QP][LDN]
  const size_t b_elems = size_t(QP) * LDN;
  const size_t x_bytes = sizeof(TX) * size_t(QP) * LDX;
  const size_t b_bytes = sizeof(TB) * b_elems;
  unsigned char* r1 = reinterpret_cast<unsigned char*>(Bs + b_elems);
  TB* Cs = reinterpret_cast<TB*>(r1);   // C, then the second x tile
  unsigned char* r2 = r1 + (b_bytes > x_bytes ? b_bytes : x_bytes);
  TX* x0 = reinterpret_cast<TX*>(r2);
  TX* x1 = reinterpret_cast<TX*>(r1);
  float* tb1 = reinterpret_cast<float*>(
      tables_in_c(b_bytes, x_bytes) ? r1 + x_bytes : r2 + x_bytes);

  const int c = blockIdx.x / n_groups;
  const int h_lo = (blockIdx.x % n_groups) * HB;
  const int nh = min(HB, H - h_lo);
  const int npt = (P + PT - 1) / PT;    // PT-column tiles of P
  const int units = nh * npt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = size_t(c) * Q;    // the chunk's first row
  const size_t ldx_g = size_t(H) * P;   // row stride of x and y
  const int nS = QP / 16;               // strips
  const int NK = (N + 7) / 8;           // k8 steps over the state width

  auto issue_x = [&](int u, TX* dst) {
    const int h = h_lo + u / npt, p0 = (u % npt) * PT;
    load_tile<TX, PT, LDX, VEC>(dst, x + (row0 * H + h) * P + p0, ldx_g, Q,
                                min(PT, P - p0), QP);
  };
  // this thread's row of the unit's cum (rows past Q repeat row Q - 1)
  auto read_cum = [&](int u) -> float {
    if (tid >= QP || u >= units) return 0.f;
    const int h = h_lo + u / npt;
    return to_f32(cum[(row0 + min(tid, Q - 1)) * H + h]);
  };

  load_tile<TB, NMAX, LDN, VEC>(Cs, Cm + row0 * N, N, Q, N, QP);
  load_tile<TB, NMAX, LDN, VEC>(Bs, Bm + row0 * N, N, Q, N, QP);
  cp_async_commit();
  issue_x(0, x0);
  cp_async_commit();
  if (tid < QP) cs[tid] = read_cum(0);
  float cum_next = read_cum(1);         // one unit ahead of the tables
  cp_async_wait<1>();
  __syncthreads();                      // C, B and unit 0's cum are in

  // the scores, tile (I, J <= I) at I (I + 1) / 2 + J, warps in turn
  for (int I = 0, ti = 0; I < nS; ++I)
    for (int J = 0; J <= I; ++J, ++ti) {
      if (ti % WARPS != warp) continue;
      float s[2][4];
      score_tile<NMAX>(s, Cs, Bs, 16 * I, 16 * J, NK, g, t);
      float4* dst = reinterpret_cast<float4*>(sc + ti * 256 + lane * 8);
      dst[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
      dst[1] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
    }
  fill_tables(cs, tb0, Q, QP);

  // the warp's share of every unit: columns pc .. pc + PT / 4 - 1 of the
  // tile, y's strips sA = p and sB = nS - 1 - p, S's rows 16 mA, 16 mB
  const int p = warp >> 2;
  const int pc = (warp & 3) * (PT / 4);
  const int sA = p, sB = nS - 1 - p;
  const bool hasA = sA <= sB, hasB = sA < sB;
  const int mA = p, mB = p + 4;
  const bool hasSA = 16 * mA < N, hasSB = NMAX > 64 && 16 * mB < N;
  const bool vec2 = (P & 1) == 0;       // 8-byte aligned pairs of y and S

  for (int u = 0; u < units; ++u) {
    const int h = h_lo + u / npt, p0 = (u % npt) * PT;
    const int pw = min(PT, P - p0);
    const TX* xs = (u & 1) ? x1 : x0;
    const float* tb = (u & 1) ? tb1 : tb0;
    if (tid < QP) cs[((u + 1) & 1) * QMAX + tid] = cum_next;
    cp_async_wait<0>();
    // unit u's x and tables are in, unit u + 1's cum; unit u - 1 is done
    // with the buffers unit u + 1 takes
    __syncthreads();
    if (u + 1 < units) {      // the next unit: x in flight, its tables
      issue_x(u + 1, (u & 1) ? x0 : x1);
      cp_async_commit();
      cum_next = read_cum(u + 2);
      fill_tables(cs + ((u + 1) & 1) * QMAX, (u & 1) ? tb0 : tb1, Q, QP);
    }
    const float* dg = tb;
    const float* at = dg + STRIPS * 256;
    const float* bt = at + STRIPS * QMAX;
    const float* de = bt + QMAX;

    float ya[NO][4], yb[NO][4], sa[NO][4], sb[NO][4];
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ya[o][e] = yb[o][e] = sa[o][e] = sb[o][e] = 0.f;
    for (int J = 0; J < nS; ++J) {
      // the x fragments of rows 16 J + 8 n + 2 t and the row after it
      // (k8 step n, logical k = t and t + 4), columns pc + 8 o + g
      uint32_t xh[2][NO][2], xl[2][NO][2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const TX* xr =
              xs + (16 * J + 8 * n + 2 * t) * LDX + pc + 8 * o + g;
          split_t(xr[0], xh[n][o][0], xl[n][o][0]);
          split_t(xr[LDX], xh[n][o][1], xl[n][o][1]);
        }
      // S rows 16 m .. 16 m + 15 += (d .* B)^T x over the tile's rows
      auto s_tile = [&](float (&acc)[NO][4], int m) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int ja = 16 * J + 8 * n + 2 * t;
          const float da = de[ja], db = de[ja + 1];
          const TB* ba = Bs + ja * LDN + 16 * m + g;
          split(to_f32(ba[0]) * da, ahi[n][0], alo[n][0]);
          split(to_f32(ba[8]) * da, ahi[n][1], alo[n][1]);
          split(to_f32(ba[LDN]) * db, ahi[n][2], alo[n][2]);
          split(to_f32(ba[LDN + 8]) * db, ahi[n][3], alo[n][3]);
        }
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const uint32_t bh[2] = {xh[n][o][0], xh[n][o][1]};
            const uint32_t bl[2] = {xl[n][o][0], xl[n][o][1]};
            mmax<false, EXX>(d, ahi[n], alo[n], bh, bl);
          }
          drain(acc[o], d);
        }
      };
      // y strip s += W x over the tile's rows: W is the score tile times
      // the diagonal decays (J == s), or times the column factors, its
      // product then scaled by the row factors (J < s)
      auto y_tile = [&](float (&acc)[NO][4], int s) {
        const float4* src =
            reinterpret_cast<const float4*>(sc + (s * (s + 1) / 2 + J) * 256
                                            + lane * 8);
        const float4 u0 = src[0], u1 = src[1];
        float w[2][4] = {{u0.x, u0.y, u0.z, u0.w}, {u1.x, u1.y, u1.z, u1.w}};
        if (J == s) {
          const float4* e =
              reinterpret_cast<const float4*>(dg + s * 256 + lane * 8);
          const float4 e0 = e[0], e1 = e[1];
          w[0][0] *= e0.x; w[0][1] *= e0.y; w[0][2] *= e0.z; w[0][3] *= e0.w;
          w[1][0] *= e1.x; w[1][1] *= e1.y; w[1][2] *= e1.z; w[1][3] *= e1.w;
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float2 b =
                *reinterpret_cast<const float2*>(bt + 16 * J + 8 * n + 2 * t);
            w[n][0] *= b.x; w[n][1] *= b.y; w[n][2] *= b.x; w[n][3] *= b.y;
          }
        }
        // the A fragments, j permuted: a0..a3 = c0, c2, c1, c3
        uint32_t whi[2][4], wlo[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          split(w[n][0], whi[n][0], wlo[n][0]);
          split(w[n][2], whi[n][1], wlo[n][1]);
          split(w[n][1], whi[n][2], wlo[n][2]);
          split(w[n][3], whi[n][3], wlo[n][3]);
        }
        const int ia = 16 * s + g;
        const float ra = J == s ? 1.f : at[J * QMAX + ia];
        const float rb = J == s ? 1.f : at[J * QMAX + ia + 8];
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const uint32_t bh[2] = {xh[n][o][0], xh[n][o][1]};
            const uint32_t bl[2] = {xl[n][o][0], xl[n][o][1]};
            mmax<false, EXX>(d, whi[n], wlo[n], bh, bl);
          }
          acc[o][0] = fmaf(ra, d[0], acc[o][0]);
          acc[o][1] = fmaf(ra, d[1], acc[o][1]);
          acc[o][2] = fmaf(rb, d[2], acc[o][2]);
          acc[o][3] = fmaf(rb, d[3], acc[o][3]);
        }
      };
      if (hasSA) s_tile(sa, mA);
      if (hasSB) s_tile(sb, mB);
      if (hasA && J <= sA) y_tile(ya, sA);
      if (hasB && J <= sB) y_tile(yb, sB);
    }

    // the unit's outputs
    float* yo = y + (row0 * H + h) * P + p0;
    auto store_y = [&](const float (&acc)[NO][4], int s) {
      const int ia = 16 * s + g, ib = ia + 8;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const int col = pc + 8 * o + 2 * t;
        if (ia < Q)
          store2(yo + ia * ldx_g, col, pw, vec2, acc[o][0], acc[o][1]);
        if (ib < Q)
          store2(yo + ib * ldx_g, col, pw, vec2, acc[o][2], acc[o][3]);
      }
    };
    if (hasA) store_y(ya, sA);
    if (hasB) store_y(yb, sB);
    float* so = state + (size_t(c) * H + h) * N * P + p0;
    auto store_s = [&](const float (&acc)[NO][4], int m) {
      const int na = 16 * m + g, nb = na + 8;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const int col = pc + 8 * o + 2 * t;
        if (na < N)
          store2(so + size_t(na) * P, col, pw, vec2, acc[o][0], acc[o][1]);
        if (nb < N)
          store2(so + size_t(nb) * P, col, pw, vec2, acc[o][2], acc[o][3]);
      }
    };
    if (hasSA) store_s(sa, mA);
    if (hasSB) store_s(sb, mB);
  }
}

// The three kernels, one name each (the SASS gate tells them apart):
// f32, bf16, and mixed (x and cum f32, B and C bf16).
template <int NMAX, int PT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_f32(const float* x, const float* cum, const float* Bm,
              const float* Cm, float* y, float* state, int H, int Q, int P,
              int N, int QP, int HB, int n_groups) {
  ssd_body<float, float, NMAX, PT, VEC>(x, cum, Bm, Cm, y, state, H, Q, P,
                                        N, QP, HB, n_groups);
}

template <int NMAX, int PT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_bf16(const bf16* x, const bf16* cum, const bf16* Bm,
               const bf16* Cm, float* y, float* state, int H, int Q, int P,
               int N, int QP, int HB, int n_groups) {
  ssd_body<bf16, bf16, NMAX, PT, VEC>(x, cum, Bm, Cm, y, state, H, Q, P, N,
                                      QP, HB, n_groups);
}

template <int NMAX, int PT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_mixed(const float* x, const float* cum, const bf16* Bm,
                const bf16* Cm, float* y, float* state, int H, int Q, int P,
                int N, int QP, int HB, int n_groups) {
  ssd_body<float, bf16, NMAX, PT, VEC>(x, cum, Bm, Cm, y, state, H, Q, P,
                                       N, QP, HB, n_groups);
}

template <class TX, class TB, int NMAX, int PT, bool VEC>
struct Kernel;
template <int NMAX, int PT, bool VEC>
struct Kernel<float, float, NMAX, PT, VEC> {
  static constexpr auto fn = ssd_chunk_f32<NMAX, PT, VEC>;
};
template <int NMAX, int PT, bool VEC>
struct Kernel<bf16, bf16, NMAX, PT, VEC> {
  static constexpr auto fn = ssd_chunk_bf16<NMAX, PT, VEC>;
};
template <int NMAX, int PT, bool VEC>
struct Kernel<float, bf16, NMAX, PT, VEC> {
  static constexpr auto fn = ssd_chunk_mixed<NMAX, PT, VEC>;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte copies where P is a multiple of x's 16 bytes of elements and N
// of B's and C's, and x, B and C are 16-byte aligned.
bool vec_copies(int P, int N, int x_bytes, int bc_bytes, const void* x,
                const void* Bm, const void* Cm) {
  return P % (16 / x_bytes) == 0 && N % (16 / bc_bytes) == 0 &&
         aligned16(x) && aligned16(Bm) && aligned16(Cm);
}

int g_sms[64];                          // SMs of each card, once

int sm_count(int device) {
  if (device < 0 || device >= 64) return -1;
  if (g_sms[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess || n < 1)
      return -1;
    g_sms[device] = n;
  }
  return g_sms[device];
}

// Head-dim columns a unit: 128 for bf16 x at N <= 64 and P > 64 (its x
// tile is as large as an f32 one of 64 columns, and a warp's 32 columns
// share each score and state fragment it prepares over four n8 tiles), 64
// otherwise (an f32 tile of 128 columns leaves no room for the second
// table buffer, and 32 columns of f32 fragments a warp would spill).
int p_tile(int P, int N, int x_bytes) {
  return x_bytes == 2 && N <= NMAX_S && P > 64 ? 128 : 64;
}

// Heads a block: the least waves x (units a block + 1), the 1 standing for
// the block's scores and its copies of C and B; among equals the fewer
// blocks.  One block an SM.
int heads_per_block(int BC, int H, int P, int PT, int sms) {
  const long long npt = (P + PT - 1) / PT;
  int best = 1;
  long long best_cost = -1;
  for (int hb = 1; hb <= H; ++hb) {
    const long long groups = (H + hb - 1) / hb;
    if (hb > 1 && (H + hb - 2) / (hb - 1) == groups) continue;  // same grid
    const long long blocks = BC * groups;
    const long long waves = (blocks + sms - 1) / sms;
    const long long cost = waves * (hb * npt + 1);
    if (best_cost < 0 || cost < best_cost ||
        (cost == best_cost && blocks < BC * ((H + best - 1) / best))) {
      best = hb;
      best_cost = cost;
    }
  }
  return best;
}

template <class TX, class TB, int NMAX, int PT, bool VEC>
int launch(const void* x, const void* cum, const void* Bm, const void* Cm,
           float* y, float* state, int BC, int Q, int H, int P, int N,
           int HB, cudaStream_t stream) {
  const auto kernel = Kernel<TX, TB, NMAX, PT, VEC>::fn;
  // once per instantiation (the process drives one card)
  static const cudaError_t attr = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<TX, TB, NMAX, PT>(QMAX)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int QP = (Q + 15) / 16 * 16;
  const int groups = (H + HB - 1) / HB;
  const long long blocks = static_cast<long long>(BC) * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS,
           smem_bytes<TX, TB, NMAX, PT>(QP), stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(cum),
      static_cast<const TB*>(Bm), static_cast<const TB*>(Cm), y, state, H, Q,
      P, N, QP, HB, groups);
  return static_cast<int>(cudaGetLastError());
}

template <class TX, class TB, int NMAX, int PT>
int launch_v(bool vec, const void* x, const void* cum, const void* Bm,
             const void* Cm, float* y, float* state, int BC, int Q, int H,
             int P, int N, int HB, cudaStream_t st) {
  return vec ? launch<TX, TB, NMAX, PT, true>(x, cum, Bm, Cm, y, state, BC,
                                              Q, H, P, N, HB, st)
             : launch<TX, TB, NMAX, PT, false>(x, cum, Bm, Cm, y, state, BC,
                                               Q, H, P, N, HB, st);
}

template <class TX, class TB>
int launch_t(const void* x, const void* cum, const void* Bm, const void* Cm,
             float* y, float* state, int BC, int Q, int H, int P, int N,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BC < 1 || H < 1 || P < 1 || Q < 1 || Q > QMAX || N < 1 ||
      N > NMAX_L)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count(device);
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const int PT = p_tile(P, N, sizeof(TX));
  const int HB = heads_per_block(BC, H, P, PT, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_copies(P, N, sizeof(TX), sizeof(TB), x, Bm, Cm);
  if (N > NMAX_S)
    return launch_v<TX, TB, NMAX_L, 64>(vec, x, cum, Bm, Cm, y, state, BC,
                                        Q, H, P, N, HB, st);
  if constexpr (sizeof(TX) == 2) {
    if (PT == 128)
      return launch_v<TX, TB, NMAX_S, 128>(vec, x, cum, Bm, Cm, y, state,
                                           BC, Q, H, P, N, HB, st);
  }
  return launch_v<TX, TB, NMAX_S, 64>(vec, x, cum, Bm, Cm, y, state, BC, Q,
                                      H, P, N, HB, st);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller) and return the
// launch's cudaError_t: 0 when the kernel was accepted.  1 <= Q <= 128,
// 1 <= N <= 128, P >= 1, BC * ceil(H / heads) < 2^31 blocks; y and state
// f32, 8-byte aligned (fresh allocations).  x and cum f32 and B and C
// f32 (_f32) or bf16 (_mixed), or all four bf16 (_bf16).
int ssd_chunk_dual_f32(const void* x, const void* cum, const void* Bm,
                       const void* Cm, float* y, float* state, int BC, int Q,
                       int H, int P, int N, int device, void* stream) {
  return launch_t<float, float>(x, cum, Bm, Cm, y, state, BC, Q, H, P, N,
                                device, stream);
}

int ssd_chunk_dual_bf16(const void* x, const void* cum, const void* Bm,
                        const void* Cm, float* y, float* state, int BC,
                        int Q, int H, int P, int N, int device,
                        void* stream) {
  return launch_t<bf16, bf16>(x, cum, Bm, Cm, y, state, BC, Q, H, P, N,
                              device, stream);
}

int ssd_chunk_dual_mixed(const void* x, const void* cum, const void* Bm,
                         const void* Cm, float* y, float* state, int BC,
                         int Q, int H, int P, int N, int device,
                         void* stream) {
  return launch_t<float, bf16>(x, cum, Bm, Cm, y, state, BC, Q, H, P, N,
                               device, stream);
}

// The heads one block of a launch at these sizes takes on `device`, x's
// elements of `x_bytes` bytes (0 on a bad device).
int ssd_chunk_dual_heads(int BC, int H, int P, int N, int x_bytes,
                         int device) {
  const int sms = sm_count(device);
  if (sms < 1 || BC < 1 || H < 1 || P < 1) return 0;
  return heads_per_block(BC, H, P, p_tile(P, N, x_bytes), sms);
}

// The configuration a launch takes for these arguments, x's and B's
// elements of `x_bytes` and `bc_bytes` bytes: the instance ("N64" at
// N <= 64, "N128" above), the unit's columns ("P64", "P128") and the copy
// width ("cp.async16" for 16-byte copies; else one element: "cp.async4"
// f32, "ld2" bf16, "cp.async4+ld2" mixed), then " bf16" or " mixed" for
// those types, e.g. "N64 P128 cp.async16 bf16".
const char* ssd_chunk_dual_route(int P, int N, const void* x, const void* Bm,
                                 const void* Cm, int x_bytes, int bc_bytes) {
  static char names[2][2][2][3][40];   // [n64][p128][vec][type]
  const bool vec = vec_copies(P, N, x_bytes, bc_bytes, x, Bm, Cm);
  const bool n64 = N <= NMAX_S, p128 = p_tile(P, N, x_bytes) == 128;
  const int type = x_bytes == 2 ? 2 : bc_bytes == 2 ? 1 : 0;
  char* name = names[n64][p128][vec][type];
  static const char* copies[3] = {"cp.async4", "cp.async4+ld2", "ld2"};
  static const char* suffix[3] = {"", " mixed", " bf16"};
  snprintf(name, 40, "N%d P%d %s%s", n64 ? 64 : 128, p128 ? 128 : 64,
           vec ? "cp.async16" : copies[type], suffix[type]);
  return name;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
