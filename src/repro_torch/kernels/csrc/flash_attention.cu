// Flash attention forward for Hopper (sm_90a), on the tensor cores, f32
// operands (3xTF32) or bf16 operands (bf16 products), f32 arithmetic.
// q (B, H, Sq, D), k and v (B, H, Sk, D), contiguous -> o (B, H, Sq, D)
// of q's type and, on request, the online-softmax statistics m and l
// (B, H, Sq), f32.
//
// Replaces the Pallas kernel `_flash_kernel` driven by `flash_attention_mha`
// (src/repro/kernels/flash_attention.py:90) and follows its numerics
// exactly: scale 1/sqrt(D) on the q.k dot product; keys past Sk always
// masked; with `causal`, the mask q_offset + q_pos >= k_pos counted from 0
// for both (top-left aligned when q_offset = 0; q_offset = pos is the
// model's cache mode, `_flash_path` of src/repro/nn/attention.py:87);
// masked scores are the finite -1e30, not -inf; running max starts at
// -1e30, the denominator at 0; the output is acc / max(l, 1e-30).
//
// Statistics (m_out and l_out, both or neither; the `_stats` entry
// points, an instance of their own, STATS): the reference's flash
// path returns each row's max of the scaled scores m and its sum
// l = sum exp(s - m) (src/repro/nn/attention.py:87-128), which
// merge_attention weighs two partial attentions with.  The kernel keeps
// its max in log2 units (s * scale * log2 e), so it writes m = M / log2 e
// and l as it is (sum exp2(s2 - M) = sum exp(s - m)), after the f32
// kernel's merge of its kv groups.  Every row sees key 0 (Sk >= 1; causal positions are
// >= 0), so m is finite; Sk = 0, whose m is the reference's NEG_INF,
// launches nothing (flash_attention.py).
//
// f32 (flash_fwd).  What bounds it: at the realization path's shape
// (B, H, S, D) = (4, 4, 512, 128), causal, a launch does 1.08 GFLOP on
// 4.2 MB, about 250 FLOP per byte: it is bound by operations.  Both products (S = Q K^T and
// O = P V) run on the tensor cores in 3xTF32 (tf32x3.cuh): one TF32 product
// would be off by about 1e-3 against the 2e-5 tolerance, three are off by
// about 2e-6.  The ops bound is then 1.08 GFLOP over 165 TFLOP/s, 6.5 us.
// The kernel runs about 8x that (PERF.md): mma.sync reaches only part of
// the tensor-core rate (wgmma, the full-rate path, is later work), the
// TF32 splits and the softmax cost ALU instructions beside each product,
// and the causal mask leaves the heaviest query tiles 8x the work of the
// lightest.
//
// f32 design: one block per (32-query tile, batch * head),
// 8 warps: 2 row warps of 16 query rows, each in 4 kv groups that take
// their own 16 keys of every 64-key kv tile (so a warp's online softmax
// covers only its keys; the groups' (max, sum, output) are merged at the
// end through shared memory, in a fixed order).  The q tile is copied
// once and split into its TF32 parts in shared memory; k and v tiles are
// double-buffered with cp.async, the next tile's copy in flight while the
// current one is used (the Pallas kv grid axis becomes a loop inside the
// block).  Per kv tile a warp computes its 16 x 16 scores with m16n8k8
// 3xTF32 products (k rows of the tile as B fragments), runs the online
// softmax on the score fragments in registers (row max and sum over the 4
// threads of a row group with __shfl_xor_sync; exponentials as exp2 of
// log2-scaled scores), and multiplies the probabilities by v straight
// from the score registers: the score fragment holds columns (2t, 2t + 1)
// where the A fragment of the next product wants (t, t + 4), so inside
// each k8 step the kv index is permuted the same way on both sides
// (logical k = t is column 2t, k = t + 4 is 2t + 1): a0..a3 = c0, c2, c1,
// c3 and the B fragment reads v rows 2t and 2t + 1.  The sum over kv does
// not depend on that order.  The output (16 x DMAX per warp) stays in
// registers across the kv loop; the score matrix never reaches shared or
// device memory.  A masked score keeps the finite -1e30 in the running
// max and gets probability 0, so with `causal` the kv tiles that lie
// wholly past the block's last query are skipped, and so is a warp's part
// of a tile that is masked for all its 16 rows: its probabilities would
// all be 0 and its max would not move, so skipping changes no bit of the
// result.  32-query blocks (256 at the path
// shape) are scheduled heaviest first (the q-tile index runs backwards
// on the grid's slow axis), so the light ones fill in behind the heavy
// ones.  Head dims up to 256 are taken through four templates (32, 64,
// 128, 256; 256 with 32-row kv tiles to stay within 227 KB of shared
// memory); a head dim below the template's DMAX is zero-filled in shared
// memory, which leaves the dot products unchanged.  Rows are copied 16
// bytes at a time where D % 4 == 0 and every pointer is 16-byte aligned,
// else 4 bytes at a time (a second instantiation of the same kernel).
//
// bf16 (flash_fwd_bf16, bf16_tc.cuh): a kernel of its own, designed for
// the bf16 tensor cores.  What bounds it: at the main paths' shapes (head
// dim 64; 1024 to 4096 keys) a launch does about 256 (1024 keys, causal)
// to 1000 (4096) FLOP per byte, so apart from the shortest it is bound by
// the bf16 rate, 989 TFLOP/s dense, of which mma.sync reaches a part
// (wgmma, FA3's design, is later work); beside the products each score
// costs an exponential (MUFU, 16 a clock an SM) and a dozen ALU
// instructions.  Design (FA2's): one block per (query tile, batch * head)
// of 4 warps of 16 query rows (Bf16Cfg), each warp taking every key
// of each kv tile, so no (max, sum, output) is merged across warps.  q's
// A fragments are read once with ldmatrix and stay in registers (D <=
// 128); k and v tiles are double-buffered by 16-byte cp.async, k's B
// fragments read with ldmatrix, v's with ldmatrix.trans.  S = Q K^T runs
// on m16n8k16 bf16 products with f32 accumulation, exact as the
// reference's f32 products of the upcast blocks.  The online softmax runs
// on the score fragments in registers with the semantics above, in log2
// units; a tile with no masked score makes no compare.  P V: each
// probability is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi),
// about 16 significant bits together (P is never rounded to bf16 in one
// piece: the reference multiplies f32 probabilities), and taken as two
// m16n8k16 products, summed per kv tile in a fragment started at zero and
// added to the f32 output accumulator with an f32 add (the tensor core's
// own accumulation rounds toward zero: kept over the kv tiles it would
// drift, tf32x3.cuh); the C fragments of two adjacent score tiles are the
// A fragment of one k16 step, so the scores never leave registers.  Causal kv tiles past the block's last
// query, and a warp's tiles masked for all its rows, are skipped, which
// changes no bit; q tiles run heaviest first.  D % 8 != 0 or an unaligned
// pointer takes a second instance with one-element copies (plain loads,
// zeros past D).  Each output is one sum in a fixed order, so identical
// inputs give identical bits.  The output is rounded to bf16 once, at the
// store.

#include <cuda_runtime.h>

#include "bf16_tc.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int BQ = 32;                  // query rows a block
constexpr int ROW_WARPS = BQ / 16;      // 16 query rows each
constexpr int KV_GROUPS = 4;            // warps of a row, each taking its
                                        // own part of every kv tile
constexpr int THREADS = 32 * ROW_WARPS * KV_GROUPS;
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DMAX>
struct Cfg {
  static constexpr int BKV = DMAX > 128 ? 32 : 64;
  static constexpr int PART = BKV / KV_GROUPS;    // keys a warp takes
  // row stride of the q, k and v tiles in floats, 4 mod 32: the A and B
  // fragment reads of q, k (row g, column t) and v (row 2t, column g) hit
  // 32 different banks, and rows stay 16-byte aligned
  static constexpr int LD = DMAX + 4;
  static constexpr size_t bytes =
      sizeof(float) * (2 * size_t(BQ) + 4 * size_t(BKV)) * LD;
};

// Rows r0 .. r0 + ROWS - 1 of a (n_rows, D) matrix into a (ROWS, LD) tile
// of a block of NT threads, zero past n_rows and past D.  Issues cp.async
// copies (bf16 one element at a time: plain loads); no wait.
template <int DMAX, int LD, int ROWS, int NT, bool VEC, class T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int n_rows, int D) {
  constexpr int W = kCopyElems<T, VEC>; // elements a copy
  constexpr int CH = DMAX / W;          // copies a row
  constexpr int TOTAL = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (TOTAL % NT != 0 && idx >= TOTAL) break;
    const int r = idx / CH, c = (idx % CH) * W;
    const bool in = r0 + r < n_rows && c < D;
    const T* from = in ? src + size_t(r0 + r) * D + c : src;
    copy_elems<T, VEC>(dst + r * LD + c, from, in);
  }
}

// 2^x; exactly 0 for x <= -1e30.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DMAX, bool VEC, bool STATS>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
          int Sk, int D, int causal, int q_offset, float scale_log2) {
  using C = Cfg<DMAX>;
  constexpr int BKV = C::BKV;
  constexpr int LD = C::LD;
  constexpr int G = KV_GROUPS;
  constexpr int NS = C::PART / 8;       // n8 tiles of a warp's scores
  constexpr int NO = DMAX / 8;          // n8 tiles of a warp's output
  // k8 steps a score fragment sums in the tensor core (tf32x3.cuh)
  constexpr int KC = DMAX >= 64 ? 8 : 4;
  static_assert(DMAX % (8 * KC) == 0, "whole score chunks");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [BQ][LD], q then its hi parts
  float* Ql = Qs + BQ * LD;             // [BQ][LD], q's lo parts
  float* Ks = Ql + BQ * LD;             // [2][BKV][LD]
  float* Vs = Ks + 2 * BKV * LD;        // [2][BKV][LD]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heavy tiles first
  const size_t bh = blockIdx.x;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  float* ob = o + bh * Sq * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % ROW_WARPS;      // which 16 rows of the tile
  const int grp = warp / ROW_WARPS;     // which part of each kv tile
  const int wr = rw * 16;
  const int row0 = q0 + wr + g;         // query rows of c0/c1 and c2/c3
  const int row1 = row0 + 8;
  const int pos0 = q_offset + row0;     // their positions for the mask
  const int pos1 = pos0 + 8;

  const int kv_end = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  const int n_kv = (kv_end + BKV - 1) / BKV;

  load_rows<DMAX, LD, BQ, THREADS, VEC>(Qs, qb, q0, Sq, D);
  cp_async_commit();
  load_rows<DMAX, LD, BKV, THREADS, VEC>(Ks, kb, 0, Sk, D);
  load_rows<DMAX, LD, BKV, THREADS, VEC>(Vs, vb, 0, Sk, D);
  cp_async_commit();
  // the q tile is split into its TF32 parts once, not once per kv tile
  cp_async_wait<1>();
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    uint32_t hi, lo;
    split(Qs[r * LD + c], hi, lo);
    Qs[r * LD + c] = __uint_as_float(hi);
    Ql[r * LD + c] = __uint_as_float(lo);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // running max (log2 units) and denominator of rows row0 and row1
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * BKV;
    if (it + 1 < n_kv) {                // next tile into the other buffer
      const int nb = (it + 1) & 1;
      load_rows<DMAX, LD, BKV, THREADS, VEC>(Ks + nb * BKV * LD, kb,
                                             k0 + BKV, Sk, D);
      load_rows<DMAX, LD, BKV, THREADS, VEC>(Vs + nb * BKV * LD, vb,
                                             k0 + BKV, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // this tile (and the split q
                                        // tile) is in shared memory

    // the warp's keys kh .. kh + PART - 1; a part wholly masked for the
    // warp's 16 rows changes nothing (all its probabilities are 0) and is
    // skipped
    const int kh = k0 + grp * C::PART;
    if (kh < Sk && !(causal && kh > q_offset + q0 + wr + 15)) {
      const float* Kt = Ks + (it & 1) * BKV * LD + grp * C::PART * LD;
      const float* Vt = Vs + (it & 1) * BKV * LD + grp * C::PART * LD;

      // s = q k^T, 16 rows x PART keys, summed in fragments of KC k8 steps
      float s[NS][4], d[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = d[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += 8) {
        const int qa = (wr + g) * LD + kk + t;
        const uint32_t ahi[4] = {
            __float_as_uint(Qs[qa]), __float_as_uint(Qs[qa + 8 * LD]),
            __float_as_uint(Qs[qa + 4]), __float_as_uint(Qs[qa + 8 * LD + 4])};
        const uint32_t alo[4] = {
            __float_as_uint(Ql[qa]), __float_as_uint(Ql[qa + 8 * LD]),
            __float_as_uint(Ql[qa + 4]), __float_as_uint(Ql[qa + 8 * LD + 4])};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kr = Kt + (n * 8 + g) * LD + kk + t;
          uint32_t bhi[2], blo[2];
          split(kr[0], bhi[0], blo[0]);
          split(kr[4], bhi[1], blo[1]);
          mma3(d[n], ahi, alo, bhi, blo);
          if ((kk / 8) % KC == KC - 1) drain(s[n], d[n]);
        }
      }

      // online softmax on the fragments, in log2 units: rows row0
      // (s[n][0..1]) and row1 (s[n][2..3]), keys kh + 8n + 2t + {0, 1}
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kh + n * 8 + 2 * t + e;
          const bool in = kpos < Sk;
          s[n][e] = in && (!causal || pos0 >= kpos) ? s[n][e] * scale_log2
                                                    : NEG_INF;
          s[n][2 + e] = in && (!causal || pos1 >= kpos)
              ? s[n][2 + e] * scale_log2 : NEG_INF;
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2_approx(m0 - mn0);
      const float corr1 = exp2_approx(m1 - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] = s[n][e] > NEG_INF ? exp2_approx(s[n][e] - mn0) : 0.f;
          s[n][2 + e] =
              s[n][2 + e] > NEG_INF ? exp2_approx(s[n][2 + e] - mn1) : 0.f;
          ps0 += s[n][e];
          ps1 += s[n][2 + e];
        }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, sh);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, sh);
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
      m0 = mn0;
      m1 = mn1;

      // acc += p v with p taken from the score registers: k8 step n
      // covers keys kh + 8n .. kh + 8n + 7, logical k = t is key
      // kh + 8n + 2t and k = t + 4 is key kh + 8n + 2t + 1
      uint32_t phi[NS][4], plo[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        split(s[n][0], phi[n][0], plo[n][0]);
        split(s[n][2], phi[n][1], plo[n][1]);
        split(s[n][1], phi[n][2], plo[n][2]);
        split(s[n][3], phi[n][3], plo[n][3]);
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* vr = Vt + (n * 8 + 2 * t) * LD + j * 8 + g;
          uint32_t bhi[2], blo[2];
          split(vr[0], bhi[0], blo[0]);
          split(vr[LD], bhi[1], blo[1]);
          mma3(pv, phi[n], plo[n], bhi, blo);
        }
        acc[j][0] = acc[j][0] * corr0 + pv[0];
        acc[j][1] = acc[j][1] * corr0 + pv[1];
        acc[j][2] = acc[j][2] * corr1 + pv[2];
        acc[j][3] = acc[j][3] * corr1 + pv[3];
      }
    }
    __syncthreads();                    // the buffer may now be refilled
  }

  // The G parts of each row meet: groups 1 .. G - 1 leave their max, sum
  // and output in the (now free) q and kv buffers, group 0 merges and
  // writes.
  constexpr int XACC = ROW_WARPS * NO * 4 * 32;  // floats a group leaves
  constexpr int XML = ROW_WARPS * 4 * 32;
  static_assert((G - 1) * (XACC + XML) * sizeof(float) <= C::bytes,
                "the exchange fits in the q and kv buffers");
  float* xacc = smem;                   // [G - 1][ROW_WARPS][NO][4][32]
  float* xml = smem + (G - 1) * XACC;   // [G - 1][ROW_WARPS][4][32]
  if (grp > 0) {
    float* xa = xacc + (grp - 1) * XACC + rw * NO * 4 * 32 + lane;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[(j * 4 + e) * 32] = acc[j][e];
    float* xm = xml + (grp - 1) * XML + rw * 4 * 32 + lane;
    xm[0] = m0;
    xm[32] = m1;
    xm[64] = l0;
    xm[96] = l1;
  }
  __syncthreads();
  if (grp > 0) return;
  // group 0 holds key 0, so m0 and m1 are finite: a weight is exactly 0
  // where another part saw only masked keys
  float M0 = m0, M1 = m1;
#pragma unroll
  for (int p = 0; p < G - 1; ++p) {
    const float* xm = xml + p * XML + rw * 4 * 32 + lane;
    M0 = fmaxf(M0, xm[0]);
    M1 = fmaxf(M1, xm[32]);
  }
  float w0[G], w1[G];
  w0[0] = exp2_approx(m0 - M0);
  w1[0] = exp2_approx(m1 - M1);
  float L0 = l0 * w0[0], L1 = l1 * w1[0];
#pragma unroll
  for (int p = 0; p < G - 1; ++p) {
    const float* xm = xml + p * XML + rw * 4 * 32 + lane;
    w0[p + 1] = exp2_approx(xm[0] - M0);
    w1[p + 1] = exp2_approx(xm[32] - M1);
    L0 += xm[64] * w0[p + 1];
    L1 += xm[96] * w1[p + 1];
  }
  if (STATS && t == 0) {                // one thread of each row pair
    const size_t r0 = bh * Sq + row0, r1 = r0 + 8;
    if (row0 < Sq) {
      m_out[r0] = M0 / LOG2E;
      l_out[r0] = L0;
    }
    if (row1 < Sq) {
      m_out[r1] = M1 / LOG2E;
      l_out[r1] = L1;
    }
  }
  const float d0 = fmaxf(L0, 1e-30f), d1 = fmaxf(L1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = acc[j][e] * (e < 2 ? w0[0] : w1[0]);
#pragma unroll
    for (int p = 0; p < G - 1; ++p) {
      const float* xa = xacc + p * XACC + (rw * NO + j) * 4 * 32 + lane;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e] += xa[e * 32] * (e < 2 ? w0[p + 1] : w1[p + 1]);
    }
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= D) continue;
      if (row0 < Sq) ob[size_t(row0) * D + col + e] = r[e] / d0;
      if (row1 < Sq) ob[size_t(row1) * D + col + e] = r[2 + e] / d1;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the FA2 shape on mma.sync.m16n8k16.bf16
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// bf16: the FA2 shape on mma.sync.m16n8k16.bf16
// ---------------------------------------------------------------------------

// 4 warps of 16 query rows (64 a block), 64-key tiles (32 at D = 256, to
// stay within shared memory and registers); up to D = 64 three blocks an
// SM (at most 168 registers a thread: at 128 the D = 64 instance spills;
// benchmarks/port_bf16_variants.py times the alternatives).  q's
// fragments stay in registers up to D = 128; at 256 they are read from
// shared memory at each tile (in registers they would take 64 of a
// thread's 255 beside the 128 of its output).  Tiles of bf16 with a row
// stride of DMAX + 8 elements: 16 bytes of pad, so the 8 rows an ldmatrix
// reads start 4 banks apart and every row stays 16-byte aligned.
template <int DMAX>
struct Bf16Cfg {
  static constexpr int WARPS = 4;
  static constexpr int BQ = 16 * WARPS;
  static constexpr int BKV = DMAX > 128 ? 32 : 64;
  static constexpr bool QREG = DMAX <= 128;
  static constexpr int MIN_BLOCKS = DMAX <= 64 ? 3 : 1;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LDS = DMAX + 8;
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (size_t(BQ) + 4 * size_t(BKV)) * LDS;
};

// One kv tile for a warp's 16 query rows: s = q k^T, the online softmax,
// acc += p v.  MASK: some key of the tile is past Sk or, with `causal`,
// past one of the rows' positions (pos0, pos1: the thread's rows g and
// g + 8); without it no score is masked and no compare is made.
template <int DMAX, bool MASK>
__device__ __forceinline__ void flash_bf16_tile(
    const uint32_t (&qf)[Bf16Cfg<DMAX>::QREG ? DMAX / 16 : 1][4],
    const __nv_bfloat16* Qw, const __nv_bfloat16* Kt,
    const __nv_bfloat16* Vt, float (&acc)[DMAX / 8][4], float& m0,
    float& m1, float& l0, float& l1, int k0, int Sk, int causal, int pos0,
    int pos1, float scale_log2) {
  using C = Bf16Cfg<DMAX>;
  constexpr int NS = C::BKV / 8;        // n8 tiles of scores
  constexpr int LDS = C::LDS;
  const int lane = threadIdx.x & 31, t = lane & 3;

  // s = q k^T: per k16 step of D, two n8 score tiles per ldmatrix of k
  // (keys 16 np + (lane % 8) + 8 (lane / 16), d 8 ((lane / 8) % 2)); the
  // bf16 products are exact, summed in f32
  float s[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DMAX / 16; ++kd) {
    uint32_t a[4];
    if constexpr (C::QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
    } else {
      bf16tc::ldmatrix_x4(a, Qw + (lane % 16) * LDS + kd * 16 +
                                 8 * (lane / 16));
    }
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t b[4];
      bf16tc::ldmatrix_x4(b, Kt + (np * 16 + lane % 8 + 8 * (lane / 16)) * LDS
                                 + kd * 16 + 8 * ((lane / 8) % 2));
      bf16tc::mma16816(s[2 * np], a, b[0], b[1]);
      bf16tc::mma16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // online softmax on the fragments, in log2 units: rows g (s[n][0..1])
  // and g + 8 (s[n][2..3]), keys k0 + 8n + 2t + {0, 1}
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (MASK) {
        const int kpos = k0 + n * 8 + 2 * t + e;
        const bool in = kpos < Sk;
        s[n][e] = in && (!causal || pos0 >= kpos) ? s[n][e] * scale_log2
                                                  : NEG_INF;
        s[n][2 + e] = in && (!causal || pos1 >= kpos)
            ? s[n][2 + e] * scale_log2 : NEG_INF;
      } else {
        s[n][e] *= scale_log2;
        s[n][2 + e] *= scale_log2;
      }
      mx0 = fmaxf(mx0, s[n][e]);
      mx1 = fmaxf(mx1, s[n][2 + e]);
    }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float corr0 = exp2_approx(m0 - mn0);
  const float corr1 = exp2_approx(m1 - mn1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (MASK) {
        s[n][e] = s[n][e] > NEG_INF ? exp2_approx(s[n][e] - mn0) : 0.f;
        s[n][2 + e] =
            s[n][2 + e] > NEG_INF ? exp2_approx(s[n][2 + e] - mn1) : 0.f;
      } else {
        s[n][e] = exp2_approx(s[n][e] - mn0);
        s[n][2 + e] = exp2_approx(s[n][2 + e] - mn1);
      }
      ps0 += s[n][e];
      ps1 += s[n][2 + e];
    }
  // each thread keeps its part of the row sums; the 4 threads of a row
  // add theirs at the end
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
  m0 = mn0;
  m1 = mn1;

  // pv = p v: score tiles 2ks and 2ks + 1 are the A fragment of k16 step
  // ks, each probability split into bf16 hi and lo parts, two products;
  // v's fragments by ldmatrix.trans (keys 16 ks + lane % 16, d 16 jp + 8
  // (lane / 16)), two n8 output tiles each.  The tile's products are
  // summed in fragments started at zero and added to acc in f32, which
  // rounds to nearest: the tensor core's own accumulation rounds toward
  // zero and, kept over the kv tiles, would drift (tf32x3.cuh)
  float pv[DMAX / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < NS / 2; ++ks) {
    uint32_t phi[4], plo[4];
    bf16tc::split_bf16x2(s[2 * ks][0], s[2 * ks][1], phi[0], plo[0]);
    bf16tc::split_bf16x2(s[2 * ks][2], s[2 * ks][3], phi[1], plo[1]);
    bf16tc::split_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1], phi[2], plo[2]);
    bf16tc::split_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3], phi[3], plo[3]);
#pragma unroll
    for (int jp = 0; jp < DMAX / 16; ++jp) {
      uint32_t b[4];
      bf16tc::ldmatrix_x4_trans(b, Vt + (ks * 16 + lane % 16) * LDS + jp * 16
                                       + 8 * (lane / 16));
      bf16tc::mma16816(pv[2 * jp], plo, b[0], b[1]);
      bf16tc::mma16816(pv[2 * jp], phi, b[0], b[1]);
      bf16tc::mma16816(pv[2 * jp + 1], plo, b[2], b[3]);
      bf16tc::mma16816(pv[2 * jp + 1], phi, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    acc[j][0] = acc[j][0] * corr0 + pv[j][0];
    acc[j][1] = acc[j][1] * corr0 + pv[j][1];
    acc[j][2] = acc[j][2] * corr1 + pv[j][2];
    acc[j][3] = acc[j][3] * corr1 + pv[j][3];
  }
}

template <int DMAX, bool VEC, bool STATS>
__global__ void __launch_bounds__(Bf16Cfg<DMAX>::THREADS,
                                  Bf16Cfg<DMAX>::MIN_BLOCKS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
               float* __restrict__ l_out, int Sq, int Sk, int D, int causal,
               int q_offset, float scale_log2) {
  using C = Bf16Cfg<DMAX>;
  using T = __nv_bfloat16;
  constexpr int BQ = C::BQ, BKV = C::BKV, LDS = C::LDS, NT = C::THREADS;
  constexpr int NO = DMAX / 8;          // n8 tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);       // [BQ][LDS]
  T* Ks = Qs + BQ * LDS;                        // [2][BKV][LDS]
  T* Vs = Ks + 2 * BKV * LDS;                   // [2][BKV][LDS]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heavy tiles first
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  T* ob = o + bh * Sq * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;             // the warp's 16 rows of the tile
  const int row0 = q0 + wr + g;         // query rows of c0/c1 and c2/c3
  const int row1 = row0 + 8;
  const int pos0 = q_offset + row0;     // their positions for the mask
  const int pos1 = pos0 + 8;
  const int wpos = q_offset + q0 + wr;  // the warp's first position

  const int kv_end = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  const int n_kv = (kv_end + BKV - 1) / BKV;

  load_rows<DMAX, LDS, BQ, NT, VEC>(Qs, qb, q0, Sq, D);
  cp_async_commit();
  load_rows<DMAX, LDS, BKV, NT, VEC>(Ks, kb, 0, Sk, D);
  load_rows<DMAX, LDS, BKV, NT, VEC>(Vs, vb, 0, Sk, D);
  cp_async_commit();
  // q's A fragments, loaded once (ldmatrix: rows lane % 16, d 8 (lane /
  // 16) of each k16 step)
  uint32_t qf[C::QREG ? DMAX / 16 : 1][4];
  if constexpr (C::QREG) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
      bf16tc::ldmatrix_x4(qf[kd], Qs + (wr + lane % 16) * LDS + kd * 16 +
                                      8 * (lane / 16));
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // running max (log2 units) and this thread's part of the denominator of
  // rows row0 and row1
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * BKV;
    if (it + 1 < n_kv) {                // next tile into the other buffer
      const int nb = (it + 1) & 1;
      load_rows<DMAX, LDS, BKV, NT, VEC>(Ks + nb * BKV * LDS, kb, k0 + BKV,
                                         Sk, D);
      load_rows<DMAX, LDS, BKV, NT, VEC>(Vs + nb * BKV * LDS, vb, k0 + BKV,
                                         Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // this tile is in shared memory

    // a tile wholly masked for the warp's 16 rows changes nothing (all its
    // probabilities are 0, its max does not move) and is skipped
    if (!(causal && k0 > wpos + 15)) {
      const T* Kt = Ks + (it & 1) * BKV * LDS;
      const T* Vt = Vs + (it & 1) * BKV * LDS;
      const T* Qw = Qs + wr * LDS;
      if (k0 + BKV <= Sk && !(causal && k0 + BKV - 1 > wpos))
        flash_bf16_tile<DMAX, false>(qf, Qw, Kt, Vt, acc, m0, m1, l0, l1, k0,
                                     Sk, causal, pos0, pos1, scale_log2);
      else
        flash_bf16_tile<DMAX, true>(qf, Qw, Kt, Vt, acc, m0, m1, l0, l1, k0,
                                    Sk, causal, pos0, pos1, scale_log2);
    }
    __syncthreads();                    // the buffer may now be refilled
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  // every row sees key 0, so m0 and m1 are finite
  if (STATS && t == 0) {                // one thread of each row pair
    const size_t r0 = bh * Sq + row0, r1 = r0 + 8;
    if (row0 < Sq) {
      m_out[r0] = m0 / LOG2E;
      l_out[r0] = l0;
    }
    if (row1 < Sq) {
      m_out[r1] = m1 / LOG2E;
      l_out[r1] = l1;
    }
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t;
    if constexpr (VEC) {                // D % 8 == 0: col + 1 < D too
      if (col >= D) continue;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + size_t(row0) * D + col) =
            __floats2bfloat162_rn(acc[j][0] / d0, acc[j][1] / d0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + size_t(row1) * D + col) =
            __floats2bfloat162_rn(acc[j][2] / d1, acc[j][3] / d1);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= D) continue;
        if (row0 < Sq)
          ob[size_t(row0) * D + col + e] = __float2bfloat16_rn(acc[j][e] / d0);
        if (row1 < Sq)
          ob[size_t(row1) * D + col + e] =
              __float2bfloat16_rn(acc[j][2 + e] / d1);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte copies where D is a multiple of the copy's elements (4 f32,
// 8 bf16) and every pointer is 16-byte aligned.
bool vec_copies(int D, int elem_bytes, const void* q, const void* k,
                const void* v, const void* o) {
  return D % (16 / elem_bytes) == 0 && aligned16(q) && aligned16(k) &&
         aligned16(v) && aligned16(o);
}

int head_dim_template(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 0;
}

// Launch one instance: f32 (the 3xTF32 kernel, flash_fwd) or bf16
// (flash_fwd_bf16).
template <int DMAX, bool BF16, bool VEC, bool STATS>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, int BH, int Sq, int Sk, int D, int causal, int q_offset,
           cudaStream_t stream) {
  using T = std::conditional_t<BF16, __nv_bfloat16, float>;
  const auto kernel = [] {
    if constexpr (BF16) return flash_fwd_bf16<DMAX, VEC, STATS>;
    else return flash_fwd<DMAX, VEC, STATS>;
  }();
  constexpr size_t bytes = BF16 ? Bf16Cfg<DMAX>::bytes : Cfg<DMAX>::bytes;
  constexpr int threads = BF16 ? Bf16Cfg<DMAX>::THREADS : THREADS;
  constexpr int bq = BF16 ? Bf16Cfg<DMAX>::BQ : BQ;
  // once per instantiation (the process drives one card)
  static const cudaError_t attr = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(BH, (Sq + bq - 1) / bq);
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, l, Sq, Sk, D, causal,
      q_offset, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the copy width and whether the statistics are written
// (a separate instance, so that a launch without them runs the code it ran
// before they existed).
template <int DMAX, bool BF16>
int launch_d(bool vec, const void* q, const void* k, const void* v, void* o,
             float* m, float* l, int BH, int Sq, int Sk, int D, int causal,
             int q_offset, cudaStream_t stream) {
  if (m != nullptr)
    return vec ? launch<DMAX, BF16, true, true>(q, k, v, o, m, l, BH, Sq, Sk,
                                                D, causal, q_offset, stream)
               : launch<DMAX, BF16, false, true>(q, k, v, o, m, l, BH, Sq,
                                                 Sk, D, causal, q_offset,
                                                 stream);
  return vec ? launch<DMAX, BF16, true, false>(q, k, v, o, m, l, BH, Sq, Sk,
                                               D, causal, q_offset, stream)
             : launch<DMAX, BF16, false, false>(q, k, v, o, m, l, BH, Sq, Sk,
                                                D, causal, q_offset, stream);
}

template <bool BF16>
int launch_t(const void* q, const void* k, const void* v, void* o, void* m,
             void* l, int B, int H, int Sq, int Sk, int D, int causal,
             int q_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((m == nullptr) != (l == nullptr) || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  const bool vec = vec_copies(D, BF16 ? 2 : 4, q, k, v, o);
  switch (head_dim_template(D)) {
    case 32:
      return launch_d<32, BF16>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                                causal, q_offset, st);
    case 64:
      return launch_d<64, BF16>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                                causal, q_offset, st);
    case 128:
      return launch_d<128, BF16>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                                 causal, q_offset, st);
    case 256:
      return launch_d<256, BF16>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                                 causal, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller) and return the
// launch's cudaError_t: 0 when the kernel was accepted.  1 <= D <= 256,
// 1 <= Sk, B * H <= 2^31 - 1, ceil(Sq / 32) <= 65535, 0 <= q_offset (the
// position of query row 0 for the causal mask).  q, k, v and o all f32
// (the 3xTF32 kernel), or all bf16 (the bf16 kernel; f32 arithmetic
// either way).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Sk, int D, int causal,
                        int q_offset, int device, void* stream) {
  return launch_t<false>(q, k, v, o, nullptr, nullptr, B, H, Sq, Sk, D,
                         causal, q_offset, device, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Sq, int Sk, int D,
                         int causal, int q_offset, int device, void* stream) {
  return launch_t<true>(q, k, v, o, nullptr, nullptr, B, H, Sq, Sk, D,
                        causal, q_offset, device, stream);
}

// The same launch that also writes each row's statistics m and l into
// (B, H, Sq) f32 buffers (see the header).
int flash_attention_stats_f32(const void* q, const void* k, const void* v,
                              void* o, void* m, void* l, int B, int H,
                              int Sq, int Sk, int D, int causal,
                              int q_offset, int device, void* stream) {
  return launch_t<false>(q, k, v, o, m, l, B, H, Sq, Sk, D, causal, q_offset,
                         device, stream);
}

int flash_attention_stats_bf16(const void* q, const void* k, const void* v,
                               void* o, void* m, void* l, int B, int H,
                               int Sq, int Sk, int D, int causal,
                               int q_offset, int device, void* stream) {
  return launch_t<true>(q, k, v, o, m, l, B, H, Sq, Sk, D, causal, q_offset,
                        device, stream);
}

// The configuration a launch takes for these arguments of `elem_bytes`
// bytes an element (o taken as 16-byte aligned), e.g. "D128 kv64
// cp.async16"; bf16 routes name the query rows a block and the bf16
// product, e.g. "D64 q64 kv64 m16n8k16 cp.async16 bf16", and their
// one-element copies are plain loads ("ld2"); "" when D is out of range.
const char* flash_attention_route(int D, const void* q, const void* k,
                                  const void* v, int elem_bytes) {
  const bool vec = vec_copies(D, elem_bytes, q, k, v, nullptr);
  if (elem_bytes == 2) {
    static_assert(Bf16Cfg<64>::BQ == 64 && Bf16Cfg<64>::BKV == 64 &&
                      Bf16Cfg<256>::BQ == 64 && Bf16Cfg<256>::BKV == 32,
                  "the route names name the configurations");
    switch (head_dim_template(D)) {
      case 32:
        return vec ? "D32 q64 kv64 m16n8k16 cp.async16 bf16"
                   : "D32 q64 kv64 m16n8k16 ld2 bf16";
      case 64:
        return vec ? "D64 q64 kv64 m16n8k16 cp.async16 bf16"
                   : "D64 q64 kv64 m16n8k16 ld2 bf16";
      case 128:
        return vec ? "D128 q64 kv64 m16n8k16 cp.async16 bf16"
                   : "D128 q64 kv64 m16n8k16 ld2 bf16";
      case 256:
        return vec ? "D256 q64 kv32 m16n8k16 cp.async16 bf16"
                   : "D256 q64 kv32 m16n8k16 ld2 bf16";
      default: return "";
    }
  }
  switch (head_dim_template(D)) {
    case 32: return vec ? "D32 kv64 cp.async16" : "D32 kv64 cp.async4";
    case 64: return vec ? "D64 kv64 cp.async16" : "D64 kv64 cp.async4";
    case 128: return vec ? "D128 kv64 cp.async16" : "D128 kv64 cp.async4";
    case 256: return vec ? "D256 kv32 cp.async16" : "D256 kv32 cp.async4";
    default: return "";
  }
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
