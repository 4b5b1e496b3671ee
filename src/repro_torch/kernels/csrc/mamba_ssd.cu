// Mamba-2 SSD per-chunk quadratic form, f32 accuracy, for Hopper (sm_90a),
// on the tensor cores, f32 or bf16 inputs.
// x (BC, Q, H, P), cum (BC, Q, H), B and C (BC, Q, N), contiguous, all of
// one type -> y (BC, Q, H, P) and the chunk state S (BC, H, N, P), f32.
//
// Replaces the Pallas kernel `_ssd_kernel` driven by `ssd_chunk_dual`
// (src/repro/kernels/mamba_ssd.py:48, body at :25).  For each chunk c and
// head h it computes
//   y[i, :]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x[j, h, :]
//   S[n, :]  = sum_j B[j, n] exp(cum_{Q-1} - cum_j) x[j, h, :]
// with n_groups = 1 (B and C shared by every head).  Above the diagonal
// (j > i) cum_i - cum_j is positive and its exp may overflow, so the
// kernel selects 0 there and never uses that exp (the Pallas body computes
// exp everywhere and selects afterwards; both give the same values where
// the mask keeps them).  The chunk state uses the chunk's last row,
// padded rows included, as the reference does: rows the caller padded carry
// dt = 0 and x = 0 and add nothing.
//
// What bounds it: at the realization path's shape (BC, Q, H, P, N) =
// (32, 128, 16, 128, 64) one launch does 2.2 GFLOP (C B^T counted once a
// chunk) on 84 MB.  In 3xTF32 (495 / 3 = 165 TFLOP/s) that is 13 us of
// operations against 25 us of bytes at 3.35 TB/s: it is bound by bytes.
// All three products run on the tensor cores in 3xTF32 (tf32x3.cuh): one
// TF32 product would be off by about 7e-2 (y) against the 1e-4 tolerance,
// three are off by about 4e-5 (tests/test_torch_kernels.py emulates both).
//
// Design (flash attention with a decay mask in place of the softmax: C
// plays q, B plays k, x plays v).  One block per (chunk, head) and
// 128-column tile of P (one tile at the path's P = 128), 16 warps: the
// chunk's rows fall in 8 strips of 16 (Q padded to a multiple of 16), and
// each strip has two warps, one per 64-column half of the tile.  C, B
// (Q x 64 each) and the x tile (Q x 128) are copied to shared memory with
// cp.async, C and B in a first group and x in a second, so that the first
// score tiles are computed while x is still in flight.  Per 16-wide j tile
// up to its diagonal (strip w has w + 1 of them) the scores C B^T are
// computed once for both warps of the strip: in round r the strip's two
// warps take tiles 2r and 2r + 1, each computes its 16 x 16 scores with
// m16n8k8 3xTF32 products over the state width (C rows as A, B rows as B
// fragments; one fragment started at zero, N <= 64 is at most 8 k8
// steps; two at N <= 128), multiplies them in registers by
// exp(cum_i - cum_j) where j <= i and selects 0 elsewhere, and leaves the
// masked tile W (1 KB) in a double-buffered exchange slot; after a
// barrier of the two warps
// (bar.sync, one id a strip) each multiplies both tiles by its half of x.
// The score fragment holds columns (2t, 2t + 1) where the A fragment of
// the second product wants (t, t + 4), so inside each k8 step the j index
// is permuted the same way on both sides (a0..a3 = c0, c2, c1, c3; the B
// fragment reads x rows 2t and 2t + 1).  The output strip (16 x 64 a warp)
// stays in registers until the store.  The state S = (d .* B)^T x,
// d_j = exp(cum_{Q-1} - cum_j), is one more 3xTF32 product over all QP
// rows (padded rows carry d = 0 and x = 0), with the same j permutation
// (it keeps the shared reads free of bank conflicts); its 16-row tiles go
// to the warps of strips 0 .. 3 at N <= 64, whose causal strips are the
// lightest (of strips 0 .. 7 at N <= 128), each warp its half of the
// columns.  Each product sums at most a few k8 steps in a fragment and
// adds it to an f32 accumulator (the tensor core's accumulation rounds
// toward zero; tf32x3.cuh).
//
// Shared memory is 167 KB at Q = 128 (C, B, x, the W exchange; the
// N <= 64 instance), so one block (16 warps) runs on an SM, at 128
// registers a thread, no spill.
// What bounds it in practice is shared-memory traffic: with the x tile
// split into its TF32 parts once and both parts kept in shared memory (so
// every x fragment is two reads and no split), the kernel is slower, not
// faster (benchmarks/port_kernel_variants.py, "x split once"; PERF.md).
// Tried in development and not kept, none of them faster: one block of 8
// warps per (chunk, head, 64-column half), two blocks an SM, each
// computing its own scores; a block looping over several heads of a
// chunk, C and B copied once and the next head's x copied while the
// current one is computed; S handed out piece by piece to whichever warp
// is free.
// Rows are copied 16 bytes at a time where N % 4 == 0, P % 4 == 0 and x,
// B and C are 16-byte aligned, else 4 bytes at a time (a second
// instantiation).
// Taken: 1 <= Q <= 128, 1 <= N <= 128, any P (tiled over the grid),
// BC * H < 2^31.
//
// Two instances by the state width, each with its P tile (the template
// arguments NMAX and PT; the route names them):
//   N <= 64:  NMAX 64, PT 128 ("P128"): the layout above, 167 KB of
//             shared memory at Q = 128 in f32;
//   N <= 128: NMAX 128, PT 64 ("P64 N128"): C and B of Q x 132 floats
//             each, the x tile of Q x 68, cum, the decays and the 32 KB
//             W exchange: 203,776 bytes at Q = 128 in f32 (with a
//             128-wide tile it would be about 235 KB, past the 227 KB a
//             block may take); bf16 121,856 bytes.  Both models with
//             N = 128 or 64 have heads of P = 64 (mamba2-370m, zamba2),
//             so no column of the 64-wide tile is idle.  The scores sum
//             16 k8 steps, two fragments of 8 drained into f32 adds (the
//             tensor core's accumulation rounds toward zero), and S's
//             128 rows take the warps of all 8 strips, each strip its 16
//             rows, each warp its 32 columns.
//
// bf16 (tf32x3.cuh): the same kernel with T = __nv_bfloat16, as the
// reference casts each block to f32 and returns f32.  C, B and x tiles
// hold bf16 (row strides NMAX + 8 and PT + 8), copied 8 elements at a
// time where N % 8 == 0, P % 8 == 0 and the pointers are 16-byte
// aligned, else one element a plain load; cum is widened as it is read.
// C and B are exact in TF32, so C B^T takes one product per k8 step; W
// and B scaled by the decays are computed in f32 and keep their split,
// x's lo part is zero, so W x and (d .* B)^T x take two.  W is never
// rounded to bf16.  y and S are f32, as in the reference.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int STRIPS = 8;               // 16-row strips of the chunk
constexpr int WARPS = 2 * STRIPS;       // two warps a strip
constexpr int THREADS = 32 * WARPS;
constexpr int QMAX = 16 * STRIPS;       // chunk length
// the instances: (state width NMAX, head-dim columns a block PT)
constexpr int NMAX_S = 64, PT_S = 128;  // N <= 64
constexpr int NMAX_L = 128, PT_L = 64;  // N <= 128
// the W exchange: per strip two rounds (double buffer) of two 16 x 16
// tiles, each as 32 lanes x 8 floats in fragment order
constexpr int EXF = STRIPS * 2 * 2 * 256;

// Row strides in elements of T.  f32: 4 mod 32 words, so the fragment
// reads (row g, column t of C and B; rows 2t and 2t + 1, column g of B and
// x) hit 32 different banks; bf16: 16 bytes of pad.  Rows stay 16-byte
// aligned either way.  Ld<T> is the N <= 64 instance's.
template <class T, int NMAX = NMAX_S, int PT = PT_S>
struct Ld {
  static constexpr int N = NMAX + int(16 / sizeof(T));
  static constexpr int X = PT + int(16 / sizeof(T));
};

// Dynamic shared memory for QP (Q rounded up to 16) rows: C, B, the x
// tile (of T), cum, the end-of-chunk decays and the W exchange (f32).
template <class T, int NMAX, int PT>
size_t smem_bytes(int QP) {
  using L = Ld<T, NMAX, PT>;
  return sizeof(T) * size_t(QP) * (2 * L::N + L::X) +
         sizeof(float) * (2 * size_t(QP) + EXF);
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

// s = C[i0 .. i0 + 15] . B[j0 .. j0 + 15]^T over the state width, 3xTF32
// (one product for bf16): s[n] holds columns j0 + 8n .. j0 + 8n + 7.
// NMAX 64 sums its NK <= 8 k8 steps in one fragment started at zero; NMAX
// 128 sums fragments of 8 k8 steps and adds them to s with f32 adds.
template <class T, int NMAX, int PT>
__device__ __forceinline__ void score_tile(float (&s)[2][4], const T* Cs,
                                           const T* Bs, int i0, int j0,
                                           int NK, int g, int t) {
  constexpr int LDN = Ld<T, NMAX, PT>::N;
  constexpr bool EX = kTf32Exact<T>;
  constexpr bool CHUNKED = NMAX > 64;
  float d[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = d[n][e] = 0.f;
#pragma unroll
  for (int k = 0; k < NMAX / 8; ++k) {
    if (k >= NK) break;
    const T* cr = Cs + (i0 + g) * LDN + 8 * k + t;
    uint32_t ahi[4], alo[4];
    split_t(cr[0], ahi[0], alo[0]);
    split_t(cr[8 * LDN], ahi[1], alo[1]);
    split_t(cr[4], ahi[2], alo[2]);
    split_t(cr[8 * LDN + 4], ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const T* br = Bs + (j0 + 8 * n + g) * LDN + 8 * k + t;
      uint32_t bhi[2], blo[2];
      split_t(br[0], bhi[0], blo[0]);
      split_t(br[4], bhi[1], blo[1]);
      if constexpr (CHUNKED) {
        mmax<EX, EX>(d[n], ahi, alo, bhi, blo);
      } else {
        mmax<EX, EX>(s[n], ahi, alo, bhi, blo);
      }
    }
    if constexpr (CHUNKED) {
      if (k % 8 == 7) {
        drain(s[0], d[0]);
        drain(s[1], d[1]);
      }
    }
  }
  if constexpr (CHUNKED) {
    drain(s[0], d[0]);
    drain(s[1], d[1]);
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

template <class T, int NMAX, int PT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk(const T* __restrict__ x, const T* __restrict__ cum,
          const T* __restrict__ Bm, const T* __restrict__ Cm,
          float* __restrict__ y, float* __restrict__ state, int H, int Q,
          int P, int N, int QP) {
  constexpr int LDN = Ld<T, NMAX, PT>::N;
  constexpr int LDX = Ld<T, NMAX, PT>::X;
  constexpr int PH = PT / 2;            // head-dim columns a warp
  constexpr int NO = PH / 8;            // n8 tiles of a warp's output
  constexpr bool EX = kTf32Exact<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);   // [QP][LDN], zero past Q, N
  T* Bs = Cs + QP * LDN;                // [QP][LDN]
  T* Xs = Bs + QP * LDN;                // [QP][LDX], x[c, j, h, p0 + p]
  // [QP], cum[c, j, h], 0 past Q (QP % 16 == 0: 16-byte aligned)
  float* cs = reinterpret_cast<float*>(Xs + QP * LDX);
  float* ds = cs + QP;                  // [QP], exp(cum[Q-1] - cum[j])
  float* ex = ds + QP;                  // [STRIPS][2 rounds][2][256]

  const int c = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int p0 = blockIdx.y * PT;
  const int pw = min(PT, P - p0);       // valid columns of this tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = warp >> 1, half = warp & 1;
  const int pc = half * PH;             // the warp's columns of the tile
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = size_t(c) * Q;    // the chunk's first row
  const size_t ldx = size_t(H) * P;     // row stride of x and y

  load_tile<T, NMAX, LDN, VEC>(Cs, Cm + row0 * N, N, Q, N, QP);
  load_tile<T, NMAX, LDN, VEC>(Bs, Bm + row0 * N, N, Q, N, QP);
  cp_async_commit();
  load_tile<T, PT, LDX, VEC>(Xs, x + (row0 * H + h) * P + p0, ldx, Q, pw,
                             QP);
  cp_async_commit();
  for (int r = threadIdx.x; r < QP; r += THREADS)
    cs[r] = r < Q ? to_f32(cum[(row0 + r) * H + h]) : 0.f;
  cp_async_wait<1>();
  __syncthreads();                      // C, B and cum are in
  {
    const float last = cs[Q - 1];
    for (int r = threadIdx.x; r < QP; r += THREADS)
      ds[r] = r < Q ? expf(last - cs[r]) : 0.f;
  }

  const int NK = (N + 7) / 8;           // k8 steps over the state width
  const int i0 = strip * 16;            // the warp's rows
  const bool has_rows = i0 < Q;
  const bool vec2 = (P & 1) == 0;       // 8-byte aligned pairs of y and S
  float s[2][4];
  if (has_rows && half <= strip)       // the first round's tile, while
    score_tile<T, NMAX, PT>(s, Cs, Bs, i0, 16 * half, NK, g,
                             t);   // x is in flight
  cp_async_wait<0>();
  __syncthreads();                      // x and the decays are in

  if (has_rows) {
    const int ia = i0 + g, ib = ia + 8;   // rows of c0/c1 and c2/c3
    const float ca = cs[ia], cb = cs[ib];
    float acc[NO][4];
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
    for (int r = 0; 2 * r <= strip; ++r) {
      const int km = 2 * r + half;      // the j tile this warp scores
      // the slot of round r; its last reader passed this round's barrier
      // before the round r + 2 write
      float* buf = ex + strip * 1024 + (r & 1) * 512;
      if (km <= strip) {
        if (r > 0)
          score_tile<T, NMAX, PT>(s, Cs, Bs, i0, 16 * km, NK, g, t);
        // W = s .* exp(cum_i - cum_j) where j <= i, else 0: that exp is
        // selected away, never multiplied.  __expf (ex2.approx, relative
        // error about 2^-21 here) is faster than expf
        // (benchmarks/port_kernel_variants.py, "expf mask").
        float w[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int j = 16 * km + 8 * n + 2 * t;
          const float cj0 = cs[j], cj1 = cs[j + 1];
          w[n][0] = j <= ia ? s[n][0] * __expf(ca - cj0) : 0.f;
          w[n][1] = j + 1 <= ia ? s[n][1] * __expf(ca - cj1) : 0.f;
          w[n][2] = j <= ib ? s[n][2] * __expf(cb - cj0) : 0.f;
          w[n][3] = j + 1 <= ib ? s[n][3] * __expf(cb - cj1) : 0.f;
        }
        float4* dst =
            reinterpret_cast<float4*>(buf + half * 256 + lane * 8);
        dst[0] = make_float4(w[0][0], w[0][1], w[0][2], w[0][3]);
        dst[1] = make_float4(w[1][0], w[1][1], w[1][2], w[1][3]);
      }
      // both of the strip's warps (barrier 0 is __syncthreads)
      asm volatile("bar.sync %0, 64;\n" :: "r"(1 + strip) : "memory");
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = 2 * r + hh;
        if (k > strip) break;
        const float4* src =
            reinterpret_cast<const float4*>(buf + hh * 256 + lane * 8);
        const float4 u0 = src[0], u1 = src[1];
        // the A fragments of y += W x, j permuted: a0..a3 = c0, c2, c1, c3
        uint32_t whi[2][4], wlo[2][4];
        split(u0.x, whi[0][0], wlo[0][0]);
        split(u0.z, whi[0][1], wlo[0][1]);
        split(u0.y, whi[0][2], wlo[0][2]);
        split(u0.w, whi[0][3], wlo[0][3]);
        split(u1.x, whi[1][0], wlo[1][0]);
        split(u1.z, whi[1][1], wlo[1][1]);
        split(u1.y, whi[1][2], wlo[1][2]);
        split(u1.w, whi[1][3], wlo[1][3]);
        // k8 step n covers j = 16k + 8n .. 16k + 8n + 7: logical k = t is
        // row 16k + 8n + 2t of x, k = t + 4 the row after it
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const T* xr =
                Xs + (16 * k + 8 * n + 2 * t) * LDX + pc + 8 * o + g;
            uint32_t bhi[2], blo[2];
            split_t(xr[0], bhi[0], blo[0]);
            split_t(xr[LDX], bhi[1], blo[1]);
            mmax<false, EX>(d, whi[n], wlo[n], bhi, blo);
          }
          drain(acc[o], d);
        }
      }
    }
    float* yb = y + (row0 * H + h) * P + p0;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int col = pc + 8 * o + 2 * t;
      if (ia < Q) store2(yb + ia * ldx, col, pw, vec2, acc[o][0], acc[o][1]);
      if (ib < Q) store2(yb + ib * ldx, col, pw, vec2, acc[o][2], acc[o][3]);
    }
  }

  // S[n][p] = sum_j (ds[j] B[j][n]) x[j][p]: the warps of strip w take
  // rows 16w .. 16w + 15 of S (N <= 64: strips 0 .. 3; N <= 128: all
  // eight), each its half of
  // the columns, over all QP rows j.  k8 step kk: logical k = t is row
  // kk + 2t, k = t + 4 the row after it.
  const int n0 = strip * 16;
  if (n0 < N) {
    float sacc[NO][4];
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[o][e] = 0.f;
    for (int kk = 0; kk < QP; kk += 8) {
      const int ja = kk + 2 * t;
      const float da = ds[ja], db = ds[ja + 1];
      const T* ba = Bs + ja * LDN + n0 + g;
      uint32_t ahi[4], alo[4];
      split(to_f32(ba[0]) * da, ahi[0], alo[0]);
      split(to_f32(ba[8]) * da, ahi[1], alo[1]);
      split(to_f32(ba[LDN]) * db, ahi[2], alo[2]);
      split(to_f32(ba[LDN + 8]) * db, ahi[3], alo[3]);
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const T* xr = Xs + ja * LDX + pc + 8 * o + g;
        uint32_t bhi[2], blo[2];
        split_t(xr[0], bhi[0], blo[0]);
        split_t(xr[LDX], bhi[1], blo[1]);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mmax<false, EX>(d, ahi, alo, bhi, blo);
        drain(sacc[o], d);
      }
    }
    const int na = n0 + g, nb = na + 8;
    float* sb = state + (size_t(c) * H + h) * N * P + p0;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int col = pc + 8 * o + 2 * t;
      if (na < N)
        store2(sb + size_t(na) * P, col, pw, vec2, sacc[o][0], sacc[o][1]);
      if (nb < N)
        store2(sb + size_t(nb) * P, col, pw, vec2, sacc[o][2], sacc[o][3]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte copies where P and N are multiples of the copy's elements (4
// f32, 8 bf16) and x, B and C are 16-byte aligned.
bool vec_copies(int P, int N, int elem_bytes, const void* x, const void* Bm,
                const void* Cm) {
  const int w = 16 / elem_bytes;
  return P % w == 0 && N % w == 0 && aligned16(x) && aligned16(Bm) &&
         aligned16(Cm);
}

template <class T, int NMAX, int PT, bool VEC>
int launch(const void* x, const void* cum, const void* Bm, const void* Cm,
           float* y, float* state, int BC, int Q, int H, int P, int N,
           cudaStream_t stream) {
  // once per instantiation (the process drives one card)
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk<T, NMAX, PT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T, NMAX, PT>(QMAX)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_chunk<T, NMAX, PT, VEC>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int QP = (Q + 15) / 16 * 16;
  const dim3 grid(BC * H, (P + PT - 1) / PT);
  ssd_chunk<T, NMAX, PT, VEC>
      <<<grid, THREADS, smem_bytes<T, NMAX, PT>(QP), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cum),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), y, state, H, Q,
      P, N, QP);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int NMAX, int PT>
int launch_v(bool vec, const void* x, const void* cum, const void* Bm,
             const void* Cm, float* y, float* state, int BC, int Q, int H,
             int P, int N, cudaStream_t st) {
  if ((P + PT - 1) / PT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return vec ? launch<T, NMAX, PT, true>(x, cum, Bm, Cm, y, state, BC, Q, H,
                                         P, N, st)
             : launch<T, NMAX, PT, false>(x, cum, Bm, Cm, y, state, BC, Q,
                                          H, P, N, st);
}

template <class T>
int launch_t(const void* x, const void* cum, const void* Bm, const void* Cm,
             float* y, float* state, int BC, int Q, int H, int P, int N,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BC < 1 || H < 1 || P < 1 || Q < 1 || Q > QMAX || N < 1 ||
      N > NMAX_L || static_cast<long long>(BC) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_copies(P, N, sizeof(T), x, Bm, Cm);
  return N <= NMAX_S
      ? launch_v<T, NMAX_S, PT_S>(vec, x, cum, Bm, Cm, y, state, BC, Q, H,
                                  P, N, st)
      : launch_v<T, NMAX_L, PT_L>(vec, x, cum, Bm, Cm, y, state, BC, Q, H,
                                  P, N, st);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller) and return the
// launch's cudaError_t: 0 when the kernel was accepted.  1 <= Q <= 128,
// 1 <= N <= 128, 1 <= P <= PT * 65535 (PT 128 at N <= 64, else 64),
// 1 <= BC * H < 2^31; y and state
// f32, 8-byte aligned (fresh allocations).  x, cum, B and C all f32, or
// all bf16.
int ssd_chunk_dual_f32(const void* x, const void* cum, const void* Bm,
                       const void* Cm, float* y, float* state, int BC, int Q,
                       int H, int P, int N, int device, void* stream) {
  return launch_t<float>(x, cum, Bm, Cm, y, state, BC, Q, H, P, N, device,
                         stream);
}

int ssd_chunk_dual_bf16(const void* x, const void* cum, const void* Bm,
                        const void* Cm, float* y, float* state, int BC,
                        int Q, int H, int P, int N, int device,
                        void* stream) {
  return launch_t<__nv_bfloat16>(x, cum, Bm, Cm, y, state, BC, Q, H, P, N,
                                 device, stream);
}

// The configuration a launch takes for these arguments of `elem_bytes`
// bytes an element: the instance ("P128" at N <= 64, "P64 N128" above)
// and the copy width, e.g. "P128 cp.async16" or "P64 N128 cp.async4";
// bf16 routes end in " bf16", and their one-element copies are plain
// loads ("ld2").
const char* ssd_chunk_dual_route(int P, int N, const void* x, const void* Bm,
                                 const void* Cm, int elem_bytes) {
  const bool vec = vec_copies(P, N, elem_bytes, x, Bm, Cm);
  if (N <= NMAX_S) {
    if (elem_bytes == 2)
      return vec ? "P128 cp.async16 bf16" : "P128 ld2 bf16";
    return vec ? "P128 cp.async16" : "P128 cp.async4";
  }
  if (elem_bytes == 2)
    return vec ? "P64 N128 cp.async16 bf16" : "P64 N128 ld2 bf16";
  return vec ? "P64 N128 cp.async16" : "P64 N128 cp.async4";
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
