// Flash attention forward for Hopper (sm_90a), on the tensor cores, f32
// or bf16 operands, f32 arithmetic.
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
// and l as it is (sum exp2(s2 - M) = sum exp(s - m)), after the kv
// groups' merge.  Every row sees key 0 (Sk >= 1; causal positions are
// >= 0), so m is finite; Sk = 0, whose m is the reference's NEG_INF,
// launches nothing (flash_attention.py).
//
// What bounds it: at the realization path's shape (B, H, S, D) =
// (4, 4, 512, 128), causal, a launch does 1.08 GFLOP on 4.2 MB, about 250
// FLOP per byte: it is bound by operations.  Both products (S = Q K^T and
// O = P V) run on the tensor cores in 3xTF32 (tf32x3.cuh): one TF32 product
// would be off by about 1e-3 against the 2e-5 tolerance, three are off by
// about 2e-6.  The ops bound is then 1.08 GFLOP over 165 TFLOP/s, 6.5 us.
// The kernel runs about 8x that (PERF.md): mma.sync reaches only part of
// the tensor-core rate (wgmma, the full-rate path, is later work), the
// TF32 splits and the softmax cost ALU instructions beside each product,
// and the causal mask leaves the heaviest query tiles 8x the work of the
// lightest.
//
// Design (the FA2 shape): one block per (32-query tile, batch * head),
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
// bf16 (tf32x3.cuh): the same kernel with T = __nv_bfloat16, as the
// reference casts each block to f32.  The k and v tiles hold bf16 (row
// stride DMAX + 8), copied 8 elements at a time where D % 8 == 0 and the
// pointers are 16-byte aligned, else one element a plain load; q is
// staged as bf16 in the space of its lo parts and widened once into the
// f32 q tile.  q and k are exact in TF32, so S = Q K^T takes one product
// per k8 step; P is computed in f32 and keeps its split, so P V takes two
// (v's lo part is zero).  P is never rounded to bf16.  The output is
// rounded to bf16 once, at the store.

#include <cuda_runtime.h>

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

template <int DMAX, class T>
struct Cfg {
  static constexpr int BKV = DMAX > 128 ? 32 : 64;
  static constexpr int PART = BKV / KV_GROUPS;    // keys a warp takes
  // row stride of the f32 q tiles in floats, 4 mod 32: the A and B
  // fragment reads of q, k (row g, column t) and v (row 2t, column g) hit
  // 32 different banks, and rows stay 16-byte aligned
  static constexpr int LD = DMAX + 4;
  // row stride of the k and v tiles (and the staged bf16 q) in elements
  // of T: LD for f32; 16 bytes of pad for bf16, rows 16-byte aligned
  static constexpr int LDT = DMAX + int(16 / sizeof(T));
  static constexpr size_t q_bytes = sizeof(float) * 2 * size_t(BQ) * LD;
  static constexpr size_t bytes =
      q_bytes + sizeof(T) * 4 * size_t(BKV) * LDT;
};

// Rows r0 .. r0 + ROWS - 1 of a (n_rows, D) matrix into a (ROWS, LDT)
// tile, zero past n_rows and past D.  Issues cp.async copies (or, for
// bf16 one element at a time, plain loads); no wait.
template <int DMAX, class T, int ROWS, bool VEC>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int n_rows, int D) {
  constexpr int LD = Cfg<DMAX, T>::LDT;
  constexpr int W = kCopyElems<T, VEC>; // elements a copy
  constexpr int CH = DMAX / W;          // copies a row
  constexpr int TOTAL = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (TOTAL + THREADS - 1) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (TOTAL % THREADS != 0 && idx >= TOTAL) break;
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

template <int DMAX, class T, bool VEC, bool STATS>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
          int Sk, int D, int causal, int q_offset, float scale_log2) {
  using C = Cfg<DMAX, T>;
  constexpr bool EX = kTf32Exact<T>;
  constexpr int BKV = C::BKV;
  constexpr int LD = C::LD;
  constexpr int LDT = C::LDT;
  constexpr int G = KV_GROUPS;
  constexpr int NS = C::PART / 8;       // n8 tiles of a warp's scores
  constexpr int NO = DMAX / 8;          // n8 tiles of a warp's output
  // k8 steps a score fragment sums in the tensor core (tf32x3.cuh)
  constexpr int KC = DMAX >= 64 ? 8 : 4;
  static_assert(DMAX % (8 * KC) == 0, "whole score chunks");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [BQ][LD], q then its hi parts
  float* Ql = Qs + BQ * LD;             // [BQ][LD], q's lo parts (bf16:
                                        // q staged as [BQ][LDT] of T)
  T* Ks = reinterpret_cast<T*>(Ql + BQ * LD);   // [2][BKV][LDT]
  T* Vs = Ks + 2 * BKV * LDT;                   // [2][BKV][LDT]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heavy tiles first
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  T* ob = o + bh * Sq * D;

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

  T* Qt = reinterpret_cast<T*>(EX ? Ql : Qs);   // where q lands
  load_rows<DMAX, T, BQ, VEC>(Qt, qb, q0, Sq, D);
  cp_async_commit();
  load_rows<DMAX, T, BKV, VEC>(Ks, kb, 0, Sk, D);
  load_rows<DMAX, T, BKV, VEC>(Vs, vb, 0, Sk, D);
  cp_async_commit();
  // the q tile is split into its TF32 parts once, not once per kv tile
  // (bf16: widened into Qs; its lo parts are zero and never read)
  cp_async_wait<1>();
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    if constexpr (EX) {
      Qs[r * LD + c] = to_f32(Qt[r * LDT + c]);
    } else {
      uint32_t hi, lo;
      split(Qs[r * LD + c], hi, lo);
      Qs[r * LD + c] = __uint_as_float(hi);
      Ql[r * LD + c] = __uint_as_float(lo);
    }
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
      load_rows<DMAX, T, BKV, VEC>(Ks + nb * BKV * LDT, kb, k0 + BKV, Sk, D);
      load_rows<DMAX, T, BKV, VEC>(Vs + nb * BKV * LDT, vb, k0 + BKV, Sk, D);
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
      const T* Kt = Ks + (it & 1) * BKV * LDT + grp * C::PART * LDT;
      const T* Vt = Vs + (it & 1) * BKV * LDT + grp * C::PART * LDT;

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
        uint32_t alo[4] = {0u, 0u, 0u, 0u};
        if constexpr (!EX) {
          alo[0] = __float_as_uint(Ql[qa]);
          alo[1] = __float_as_uint(Ql[qa + 8 * LD]);
          alo[2] = __float_as_uint(Ql[qa + 4]);
          alo[3] = __float_as_uint(Ql[qa + 8 * LD + 4]);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* kr = Kt + (n * 8 + g) * LDT + kk + t;
          uint32_t bhi[2], blo[2];
          split_t(kr[0], bhi[0], blo[0]);
          split_t(kr[4], bhi[1], blo[1]);
          mmax<EX, EX>(d[n], ahi, alo, bhi, blo);
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
          const T* vr = Vt + (n * 8 + 2 * t) * LDT + j * 8 + g;
          uint32_t bhi[2], blo[2];
          split_t(vr[0], bhi[0], blo[0]);
          split_t(vr[LDT], bhi[1], blo[1]);
          mmax<false, EX>(pv, phi[n], plo[n], bhi, blo);
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
      if (row0 < Sq) ob[size_t(row0) * D + col + e] = from_f32<T>(r[e] / d0);
      if (row1 < Sq)
        ob[size_t(row1) * D + col + e] = from_f32<T>(r[2 + e] / d1);
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

template <int DMAX, class T, bool VEC, bool STATS>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, int BH, int Sq, int Sk, int D, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr size_t bytes = Cfg<DMAX, T>::bytes;
  // once per instantiation (the process drives one card)
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<DMAX, T, VEC, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_fwd<DMAX, T, VEC, STATS>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  flash_fwd<DMAX, T, VEC, STATS><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, l, Sq, Sk, D, causal,
      q_offset, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the copy width and whether the statistics are written
// (a separate instance, so that a launch without them runs the code it ran
// before they existed).
template <int DMAX, class T>
int launch_d(bool vec, const void* q, const void* k, const void* v, void* o,
             float* m, float* l, int BH, int Sq, int Sk, int D, int causal,
             int q_offset, cudaStream_t stream) {
  if (m != nullptr)
    return vec ? launch<DMAX, T, true, true>(q, k, v, o, m, l, BH, Sq, Sk, D,
                                             causal, q_offset, stream)
               : launch<DMAX, T, false, true>(q, k, v, o, m, l, BH, Sq, Sk,
                                              D, causal, q_offset, stream);
  return vec ? launch<DMAX, T, true, false>(q, k, v, o, m, l, BH, Sq, Sk, D,
                                            causal, q_offset, stream)
             : launch<DMAX, T, false, false>(q, k, v, o, m, l, BH, Sq, Sk, D,
                                             causal, q_offset, stream);
}

template <class T>
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
  const bool vec = vec_copies(D, sizeof(T), q, k, v, o);
  switch (head_dim_template(D)) {
    case 32:
      return launch_d<32, T>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                             causal, q_offset, st);
    case 64:
      return launch_d<64, T>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                             causal, q_offset, st);
    case 128:
      return launch_d<128, T>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                              causal, q_offset, st);
    case 256:
      return launch_d<256, T>(vec, q, k, v, o, mf, lf, BH, Sq, Sk, D,
                              causal, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller) and return the
// launch's cudaError_t: 0 when the kernel was accepted.  1 <= D <= 256,
// 1 <= Sk, B * H <= 2^31 - 1, ceil(Sq / 32) <= 65535, 0 <= q_offset (the
// position of query row 0 for the causal mask).  q, k, v and o all f32,
// or all bf16 (f32 arithmetic either way).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Sk, int D, int causal,
                        int q_offset, int device, void* stream) {
  return launch_t<float>(q, k, v, o, nullptr, nullptr, B, H, Sq, Sk, D,
                         causal, q_offset, device, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Sq, int Sk, int D,
                         int causal, int q_offset, int device, void* stream) {
  return launch_t<__nv_bfloat16>(q, k, v, o, nullptr, nullptr, B, H, Sq, Sk,
                                 D, causal, q_offset, device, stream);
}

// The same launch that also writes each row's statistics m and l into
// (B, H, Sq) f32 buffers (see the header).
int flash_attention_stats_f32(const void* q, const void* k, const void* v,
                              void* o, void* m, void* l, int B, int H,
                              int Sq, int Sk, int D, int causal,
                              int q_offset, int device, void* stream) {
  return launch_t<float>(q, k, v, o, m, l, B, H, Sq, Sk, D, causal, q_offset,
                         device, stream);
}

int flash_attention_stats_bf16(const void* q, const void* k, const void* v,
                               void* o, void* m, void* l, int B, int H,
                               int Sq, int Sk, int D, int causal,
                               int q_offset, int device, void* stream) {
  return launch_t<__nv_bfloat16>(q, k, v, o, m, l, B, H, Sq, Sk, D, causal,
                                 q_offset, device, stream);
}

// The configuration a launch takes for these arguments of `elem_bytes`
// bytes an element (o taken as 16-byte aligned), e.g. "D128 kv64
// cp.async16"; bf16 routes end in " bf16", and their one-element copies
// are plain loads ("ld2"); "" when D is out of range.
const char* flash_attention_route(int D, const void* q, const void* k,
                                  const void* v, int elem_bytes) {
  const bool vec = vec_copies(D, elem_bytes, q, k, v, nullptr);
  if (elem_bytes == 2) {
    switch (head_dim_template(D)) {
      case 32: return vec ? "D32 kv64 cp.async16 bf16" : "D32 kv64 ld2 bf16";
      case 64: return vec ? "D64 kv64 cp.async16 bf16" : "D64 kv64 ld2 bf16";
      case 128:
        return vec ? "D128 kv64 cp.async16 bf16" : "D128 kv64 ld2 bf16";
      case 256:
        return vec ? "D256 kv32 cp.async16 bf16" : "D256 kv32 ld2 bf16";
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
