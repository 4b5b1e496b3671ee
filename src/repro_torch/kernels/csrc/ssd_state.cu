// The chunked SSD's inter-chunk pass for Hopper (sm_90a), f32.
//
// Replaces the part of the jitted `ssd_forward` (src/repro/kernels/ops.py:
// 51-99) that runs after the Pallas `ssd_chunk_dual`: the `lax.scan` of the
// chunk states h <- h * exp(tot_c) + S_c and the inter-chunk output
// y_inter = exp(cum) * (C . h_before); and the same half of the model's
// `ssd_chunked` (src/repro/nn/mamba2.py:73-89), which adds G groups, an
// initial state and the final state.  On the TPU XLA compiles it into the
// one program around the chunk kernel; eagerly it is a loop of about a
// hundred small launches.
//
// Inputs, contiguous f32: y_intra (B, nc, Q, H, P), S (B, nc, H, N, P),
// cum (B, nc, Q, H), C (B, nc, Q, G, N), an optional init_state
// (B, H, N, P).  Head h reads group g = h / (H / G), the order of
// `jnp.repeat(C, H // G, axis=3)`.  For each chunk c in order:
//   y[c] = y_intra[c] + exp(cum[c]) * (C_g[c] . h),   h = state before c
//   h    = h * exp(cum[c, Q - 1]) + S[c]
// Outputs: y (B, nc, Q, H, P) and the final state (B, H, N, P).
//
// What bounds it: each input is read once and y written once, about 2 Q N
// FLOPs per element of y; at the zamba2-1.2b prefill (B 4, 1024 tokens,
// chunk 128, H 64, N 64, P 64) that is 145 MB against 2.1 GFLOP, so it is
// bound by bytes (43 us at 3.35 TB/s; 32 us of f32 FMA at 67 TFLOP/s, 13
// us in 3xTF32 at 165).  At the mamba2-370m serve wave (N 128) f32 FMAs
// would bound it by operations; on the tensor cores it is bound by bytes.
//
// The product.  y_inter of a chunk, head and 64-column P tile is a
// (Q x N) . (N x 64) product: C rows are the A operand (row-major, K = N
// zero-padded to a multiple of 8), the state tile the B operand.  It runs
// on the tensor cores in 3xTF32 (tf32x3.cuh: mma.sync.m16n8k8, each
// operand split into a TF32 high and low part, three products a k8 step,
// a fragment summed over at most 8 k8 steps and drained into f32 adds),
// so the f32 tolerance of 1e-4 holds as for ssd_chunk_dual; one TF32
// product would miss it (tests/test_torch_kernels.py emulates both).  Each
// of the block's 8 warps takes 32 rows x 32 columns of the tile (two
// 16-row strips, four 8-column n-tiles), so a B fragment serves two
// strips.  The state tile is held in shared memory already split, as its
// hi and lo parts (rows of 72 floats: the fragment reads, rows k = t and
// t + 4 at column g, fall in 32 different banks; a 64-float row would put
// the 4 lanes of a group in one bank), written once per tile: the B
// operand is never split again where it is read.  hi + lo is the f32
// value exactly (lo = x - hi is exact, and stored whole; the tensor core
// cuts it to TF32 itself), so the walk keeps no other copy of its state.
// C rows (row stride N8 + 4 floats, 4 mod 8 words: the A fragment reads
// hit 32 banks) are split where a warp reads them, once a product: each
// warp reads only its own rows.  Each lane's share of y_intra (32 floats)
// is loaded into registers before the product, so the epilogue does not
// wait on device memory.  The epilogue pairs neighbouring lanes with one
// shuffle so that each lane holds 4 neighbouring columns of one row, and
// y is read and written 16 bytes at a time where P % 4 == 0 and y_intra
// and y are 16-byte aligned, else 4 bytes at a time; y is stored
// streaming (evict first).  Where N rounds up to the instance's width
// (N8 == NMAX, 64 or 128: both models) the k loop has a fixed trip count.
//
// What bounds them in practice is device memory more than the product:
// with the product taken out, the walk at the zamba2 prefill is 7 %
// faster and the outputs 8-25 % (benchmarks/port_kernel_variants.py,
// "no product"; PERF.md; NVIDIA H100 80GB HBM3, 700 W).
//
// Two routes; ssd_state.py picks one by the launch's block count.
//
// The walk (`ssd_state_walk`): one block of 256 threads per (P tile of 64
// columns, head, batch) walks the chunks in order, the way the scan does;
// the walk is the sequential grid axis of a TPU kernel turned into a
// loop.  The chunk's C rows and cum are copied with cp.async into one of
// two buffers, the next chunk's copy in flight while the current chunk is
// computed; each thread's entries of the chunk's S are loaded into
// registers before the product and used after it, and the next chunk's
// y_intra and S tiles are prefetched into L2 (cp.async.bulk.prefetch):
// the blocks of a wave walk in step, so without it device memory idles
// while they multiply.  After a barrier each thread updates its entries of
// the state, h = hi + lo; h = h * decay + S (an f32 FMA), and writes them
// back split.  Shared memory: the split state (two N8 x 72 tiles), two C
// buffers and two cum buffers, 107,520 bytes at Q = 128, N = 64 (two
// blocks share an SM: the 256 blocks of a zamba2 prefill wave run in one
// wave) and 209,920 at N = 128 (one an SM).  A batch of few heads leaves
// SMs idle, since each block is a sequential walk over the chunks: at the
// mamba2-370m realization shape (B 1, H 16, P 128) that is 32 blocks on
// 132 SMs.
//
// The split (`ssd_state_scan`, then `ssd_state_out`) takes the walk
// apart where it would leave SMs idle:
//   scan: one thread per state entry (b, h, n, p) scans the chunks,
//         h_before[b, c] = h; h = h * exp(cum[b, c, Q - 1]) + S[b, c],
//         and writes every chunk's h_before (B, nc, H, N, P) and the
//         final state.  It reads S once and writes h_before once (plus
//         the initial and final states); each thread keeps eight chunks'
//         loads in flight, so the B H N P threads (131,072 at the
//         realization shape) hide the memory latency of the sequence.
//         It does no product and stays on the CUDA cores.
//   out:  one block per (batch and chunk, `heads` heads of one group, P
//         tile of 64 columns), no walk.  The chunk's C rows and the
//         heads' cum are copied to shared memory once (cp.async); the
//         first head's h_before tile is loaded into registers, split and
//         stored, then per head: the head's y_intra and the next head's
//         h_before tile are loaded into registers, the product and the
//         epilogue run, and after a barrier the next head's tile is
//         split into shared memory.  ssd_state.py::out_heads picks
//         `heads` (4, 2 or 1) so that the grid keeps about two blocks an
//         SM.  Shared memory: C, the split tile and cum, 73,728 bytes at
//         Q = 128, N = 64, 4 heads (two blocks an SM) and 143,360 at
//         N = 128 (one).
// It moves h_before twice more than the walk (written, read back): at the
// realization shape 119 MB in place of 86 MB, a 0.036 ms bound at 3.35
// TB/s against 0.026, with 256 output blocks in place of 32 walks.
//
// Each kernel has two instances by the state width, NMAX 64 (N <= 64) and
// 128 (N <= 128), which size the registers that hold a thread's share of
// a state tile (NMAX / 4 floats); the NMAX 64 instances are bound to 128
// registers a thread so that two blocks share an SM.
//
// Tried in development and not kept, none of them faster: 16 warps a
// block at N = 128 (32 x 16 warp tiles within 128 registers); the next
// chunk's or head's y_intra held in registers a step ahead at N = 128
// (254 registers); the L2 prefetch in the outputs kernel; streaming
// loads of y_intra and S.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 256;
constexpr int kPT = 64;                    // P columns a block
constexpr int kNT = 4;                     // 8-column n-tiles a warp
constexpr int kLDH = kPT + 8;              // row stride of the split state
constexpr int kMaxSmem = 232448;           // 227 KB, the opt-in limit
constexpr int kMaxHeads = 4;               // heads a block of the outputs

// Blocks an SM of the walk and the outputs by their state width NMAX: at
// 64 two (so at most 128 registers a thread); at 128 a block takes more
// than half an SM's shared memory and runs alone.
template <int NMAX>
constexpr int kMinBlocks = NMAX == 64 ? 2 : 1;

__host__ __device__ inline int round8(int n) { return (n + 7) / 8 * 8; }

// C rows: N zero-padded to N8 (a multiple of 8), 4 floats more a row
__host__ __device__ inline int ldc(int N) { return round8(N) + 4; }

// Floats of the split state: hi and lo, N8 rows of kLDH each.
__host__ __device__ inline long long state_floats(int N) {
  return 2LL * round8(N) * kLDH;
}

// Bytes of dynamic shared memory: the walk (split state, two C and two
// cum buffers) and the outputs (split state, C, the heads' cum).
__host__ __device__ inline long long walk_smem(int Q, int N) {
  return 4LL * (state_floats(N) + 2LL * Q * ldc(N) + 2LL * Q);
}
__host__ __device__ inline long long out_smem(int Q, int N, int heads) {
  return 4LL * (state_floats(N) + 1LL * Q * ldc(N) + 1LL * heads * Q);
}

// Rows of C (group g) of chunk bc into Cs (Q x ldc(N), columns N .. N8
// zero) with cp.async.
template <bool VEC>
__device__ __forceinline__ void load_c(float* Cs, const float* C, size_t bc,
                                       int Q, int N, int G, int g) {
  constexpr int W = VEC ? 4 : 1;
  const int L = ldc(N), per_row = round8(N) / W;
  for (int i = threadIdx.x; i < Q * per_row; i += kThreads) {
    const int q = i / per_row, n = (i % per_row) * W;
    const bool in = n < N;
    const float* src = in ? C + ((bc * Q + q) * G + g) * N + n : C;
    if constexpr (VEC) {
      cp_async16(Cs + q * L + n, src, in);
    } else {
      cp_async4(Cs + q * L + n, src, in);
    }
  }
}

// Ask the L2 cache to fetch `bytes` (a multiple of 16) from the 16-byte
// aligned `p`, ahead of the loads that read them.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(p), "r"(bytes) : "memory");
}

// Prefetch into L2 `rows` rows of `cols` floats (one P tile) from the
// 16-byte aligned `src`, `stride` floats apart: the walk's next chunk,
// fetched from device memory while this one is computed.
__device__ __forceinline__ void prefetch_rows(const float* src, int rows,
                                              size_t stride, int cols) {
  for (int r = threadIdx.x; r < rows; r += kThreads)
    prefetch_l2(src + r * stride, 4 * cols);
}

// cum of `heads` heads from hd of chunk bc: cs[i * Q + q].
__device__ __forceinline__ void load_cum(float* cs, const float* cum,
                                         size_t bc, int Q, int H, int hd,
                                         int heads) {
  for (int i = threadIdx.x; i < heads * Q; i += kThreads) {
    const int h = i / Q, q = i % Q;
    cp_async4(cs + i, cum + (bc * Q + q) * H + hd + h, true);
  }
}

// A thread's share of a state tile: rows threadIdx.x / 16 + 16 r (r <
// NMAX / 16), columns (threadIdx.x % 16) * 4 + 0 .. 3 of the tile.
template <int NMAX>
using Share = float[NMAX / 4];

// The thread's share of the (N, P) rows at `src`, columns p0 .. p0 + 63:
// float4 loads with VEC (P % 4 == 0, src 16-byte aligned), else one
// float at a time; zeros past N and P, or everywhere when src is null.
template <bool VEC, int NMAX>
__device__ __forceinline__ void load_share(Share<NMAX>& v, const float* src,
                                           int N, int P, int p0) {
  const int c = p0 + (threadIdx.x % 16) * 4;
#pragma unroll
  for (int r = 0; r < NMAX / 16; ++r) {
    const int n = threadIdx.x / 16 + 16 * r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src != nullptr && n < N) {
      const float* p = src + size_t(n) * P + c;
      if constexpr (VEC) {
        if (c < P) x = *reinterpret_cast<const float4*>(p);
      } else {
        if (c < P) x.x = p[0];
        if (c + 1 < P) x.y = p[1];
        if (c + 2 < P) x.z = p[2];
        if (c + 3 < P) x.w = p[3];
      }
    }
    v[4 * r] = x.x;
    v[4 * r + 1] = x.y;
    v[4 * r + 2] = x.z;
    v[4 * r + 3] = x.w;
  }
}

// The thread's share, split, into the state tiles hi and lo (rows < N8).
template <int NMAX>
__device__ __forceinline__ void store_split(const Share<NMAX>& v, float* hi,
                                            float* lo, int N8) {
  const int c = (threadIdx.x % 16) * 4;
#pragma unroll
  for (int r = 0; r < NMAX / 16; ++r) {
    const int n = threadIdx.x / 16 + 16 * r;
    if (n >= N8) break;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[4 * r + e], h[e], l[e]);
    *reinterpret_cast<uint4*>(hi + n * kLDH + c) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + n * kLDH + c) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The thread's share of the state, hi + lo (exact), from the tiles; zeros
// past N8.
template <int NMAX>
__device__ __forceinline__ void read_state(Share<NMAX>& v, const float* hi,
                                           const float* lo, int N8) {
  const int c = (threadIdx.x % 16) * 4;
#pragma unroll
  for (int r = 0; r < NMAX / 16; ++r) {
    const int n = threadIdx.x / 16 + 16 * r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (n < N8) {
      a = *reinterpret_cast<const float4*>(hi + n * kLDH + c);
      b = *reinterpret_cast<const float4*>(lo + n * kLDH + c);
    }
    v[4 * r] = a.x + b.x;
    v[4 * r + 1] = a.y + b.y;
    v[4 * r + 2] = a.z + b.z;
    v[4 * r + 3] = a.w + b.w;
  }
}

// A warp's output tile: rows r0 .. r0 + 31 (two 16-row strips) and the
// 32 columns from c0 of the block's P tile (four 8-column n-tiles).  After
// the shuffle in store_y, lane 4 g + t holds row r0 + 16 s + g + 8 (t & 1)
// and columns c0 + 8 j + 2 (t & ~1) .. + 3 of strip s and n-tile j.
struct Tile {
  int r0, c0;
  __device__ int row(int s) const {
    const int lane = threadIdx.x % 32;
    return r0 + 16 * s + lane / 4 + 8 * (lane & 1);
  }
  __device__ int col(int j) const {
    const int t = threadIdx.x % 4;
    return c0 + 8 * j + 2 * (t & ~1);
  }
};

// The warp's tile in the first round: warps 2 w and 2 w + 1 take rows
// 32 w .. 32 w + 31, each 32 of the 64 columns; rounds 128 rows apart.
__device__ __forceinline__ Tile first_tile() {
  const int warp = threadIdx.x / 32;
  return {(warp / 2) * 32, (warp % 2) * 8 * kNT};
}

// The lane's y_intra of its tile (rows < Q, columns < P; p0 the tile's
// first column in P), issued before the product: 16-byte loads with VEC_Y.
__device__ __forceinline__ void load_y(float4 (&yi)[2][kNT],
                                       const float* __restrict__ y_intra,
                                       size_t base, size_t stride,
                                       const Tile& T, int Q, int P, int p0,
                                       bool vec_y) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = T.row(s);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int p = p0 + T.col(j);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < Q) {
        const float* src = y_intra + base + q * stride + p;
        if (vec_y) {
          if (p < P) v = *reinterpret_cast<const float4*>(src);
        } else {
          if (p < P) v.x = src[0];
          if (p + 1 < P) v.y = src[1];
          if (p + 2 < P) v.z = src[2];
          if (p + 3 < P) v.w = src[3];
        }
      }
      yi[s][j] = v;
    }
  }
}

// acc = C rows of the tile (rows past Q read row Q - 1; their outputs are
// never stored) . the tile's state columns, in 3xTF32: per k8 step the A
// fragments of both strips are split once and each B fragment (hi and lo
// from the split tiles) serves both; a fragment sums at most 8 k8 steps
// (started at zero) and is then added to acc in f32.
// With FULL (N8 == NMAX, both models' widths) the k loop has a fixed trip
// count, so the next step's fragment reads can be issued early.
template <int NMAX, bool FULL>
__device__ __forceinline__ void product(float (&acc)[2][kNT][4],
                                        const float* Cs, const float* hi,
                                        const float* lo, const Tile& T,
                                        int Q, int N) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int L = ldc(N), N8 = FULL ? NMAX : round8(N);
  const float* crow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    crow[i] = Cs + min(T.r0 + 8 * i + g, Q - 1) * L + t;
#pragma unroll
  for (int kb = 0; kb < NMAX; kb += 64) {
    if (!FULL && kb >= N8) break;
    float d[2][kNT][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[s][j][e] = 0.f;
#pragma unroll
    for (int k = kb; k < kb + 64; k += 8) {
      if (!FULL && k >= N8) break;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        split(crow[2 * s][k], ahi[s][0], alo[s][0]);
        split(crow[2 * s + 1][k], ahi[s][1], alo[s][1]);
        split(crow[2 * s][k + 4], ahi[s][2], alo[s][2]);
        split(crow[2 * s + 1][k + 4], ahi[s][3], alo[s][3]);
      }
      const int b0 = (k + t) * kLDH + T.c0 + g, b1 = b0 + 4 * kLDH;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t bhi[2] = {__float_as_uint(hi[b0 + 8 * j]),
                                 __float_as_uint(hi[b1 + 8 * j])};
        const uint32_t blo[2] = {__float_as_uint(lo[b0 + 8 * j]),
                                 __float_as_uint(lo[b1 + 8 * j])};
#pragma unroll
        for (int s = 0; s < 2; ++s)
          mma3(d[s][j], ahi[s], alo[s], bhi, blo);
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (kb == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][j][e] = d[s][j][e];
        } else {
          drain(acc[s][j], d[s][j]);
        }
      }
  }
}

// y = y_intra + exp(cum) * acc for the tile, cs the head's cum (Q).  The
// fragment holds rows g and g + 8, columns 2t and 2t + 1 of each n-tile;
// lanes t and t ^ 1 swap half so that each holds 4 neighbouring columns
// of one row (Tile::row, Tile::col), stored 16 bytes at a time with VEC_Y.
// The stores are streaming (st.global.cs, evict first): nothing reads y
// back, and with plain stores the walk takes 1.5 times as long
// (benchmarks/port_kernel_variants.py, "plain stores").
__device__ __forceinline__ void store_y(const float (&acc)[2][kNT][4],
                                        const float4 (&yi)[2][kNT],
                                        const float* cs,
                                        float* __restrict__ y, size_t base,
                                        size_t stride, const Tile& T, int Q,
                                        int P, int p0, bool vec_y) {
  const int lane = threadIdx.x % 32, g = lane / 4;
  const bool odd = lane & 1;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int qa = T.r0 + 16 * s + g, qb = qa + 8;
    const float ea = qa < Q ? expf(cs[qa]) : 0.f;
    const float eb = qb < Q ? expf(cs[qb]) : 0.f;
    const int q = T.row(s);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float a0 = acc[s][j][0] * ea, a1 = acc[s][j][1] * ea;
      const float a2 = acc[s][j][2] * eb, a3 = acc[s][j][3] * eb;
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a2, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : a3, 1);
      float4 o = odd ? make_float4(r0, r1, a2, a3)
                     : make_float4(a0, a1, r0, r1);
      const int p = p0 + T.col(j);
      if (q >= Q || p >= P) continue;
      o.x += yi[s][j].x;
      o.y += yi[s][j].y;
      o.z += yi[s][j].z;
      o.w += yi[s][j].w;
      float* dst = y + base + q * stride + p;
      if (vec_y) {
        __stcs(reinterpret_cast<float4*>(dst), o);
      } else {
        __stcs(dst, o.x);
        if (p + 1 < P) __stcs(dst + 1, o.y);
        if (p + 2 < P) __stcs(dst + 2, o.z);
        if (p + 3 < P) __stcs(dst + 3, o.w);
      }
    }
  }
}

// The outputs of chunk bc, head hd and the P tile from p0 with the state
// split in hi and lo, C rows in Cs and the head's cum in cs: each warp
// takes its 32 x 32 tiles (rows past 128 in further rounds).
template <int NMAX>
__device__ __forceinline__ void chunk_output(
    const float* Cs, const float* cs, const float* hi, const float* lo,
    const float* __restrict__ y_intra, float* __restrict__ y, size_t bc,
    int Q, int H, int P, int N, int hd, int p0, bool vec_y) {
  const size_t stride = size_t(H) * P;
  const size_t base = (bc * Q * H + hd) * size_t(P);
  for (Tile T = first_tile(); T.r0 < Q; T.r0 += 128) {
    float4 yi[2][kNT];
    load_y(yi, y_intra, base, stride, T, Q, P, p0, vec_y);
    float acc[2][kNT][4];
    if (round8(N) == NMAX) {
      product<NMAX, true>(acc, Cs, hi, lo, T, Q, N);
    } else {
      product<NMAX, false>(acc, Cs, hi, lo, T, Q, N);
    }
    store_y(acc, yi, cs, y, base, stride, T, Q, P, p0, vec_y);
  }
}

template <bool VEC, int NMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NMAX>)
ssd_state_walk(const float* __restrict__ y_intra, const float* __restrict__ S,
               const float* __restrict__ cum, const float* __restrict__ C,
               const float* __restrict__ init, float* __restrict__ y,
               float* __restrict__ h_out, int nc, int Q, int H, int P, int N,
               int G, bool vec_y) {
  extern __shared__ __align__(16) float smem[];
  const int N8 = round8(N), L = ldc(N);
  float* hi = smem;                   // [N8][kLDH] the state, split
  float* lo = hi + N8 * kLDH;
  float* Cb = lo + N8 * kLDH;         // [2][Q][L] C rows
  float* cb = Cb + 2 * Q * L;         // [2][Q] cum

  const int p0 = blockIdx.x * kPT;
  const int hd = blockIdx.y;
  const size_t b = blockIdx.z;
  const int g = hd / (H / G);
  const size_t tile = size_t(N) * P;  // floats of one (N, P) state

  load_c<VEC>(Cb, C, b * nc, Q, N, G, g);
  load_cum(cb, cum, b * nc, Q, H, hd, 1);
  cp_async_commit();
  Share<NMAX> s;                      // the initial state, then S
  load_share<false, NMAX>(s, init == nullptr ? nullptr
                                             : init + (b * H + hd) * tile,
                          N, P, p0);
  store_split<NMAX>(s, hi, lo, N8);

  for (int c = 0; c < nc; ++c) {
    const size_t bc = b * nc + c;
    const int buf = c & 1;
    if (c + 1 < nc) {                 // the next chunk's C and cum
      load_c<VEC>(Cb + (buf ^ 1) * Q * L, C, bc + 1, Q, N, G, g);
      load_cum(cb + (buf ^ 1) * Q, cum, bc + 1, Q, H, hd, 1);
    }
    cp_async_commit();
    cp_async_wait<1>();               // this chunk's C and cum are in
    __syncthreads();                  // for every thread; the state too

    // the chunk's S, in flight while y is computed; the next chunk's
    // y_intra and S tiles on their way to L2
    load_share<VEC, NMAX>(s, S + (bc * H + hd) * tile, N, P, p0);
    if (VEC && vec_y && c + 1 < nc) {
      const int cols = min(kPT, P - p0);
      prefetch_rows(y_intra + ((bc + 1) * Q * H + hd) * size_t(P) + p0, Q,
                    size_t(H) * P, cols);
      prefetch_rows(S + ((bc + 1) * H + hd) * tile + p0, N, P, cols);
    }
    const float* cs = cb + buf * Q;
    chunk_output<NMAX>(Cb + buf * Q * L, cs, hi, lo, y_intra, y, bc, Q, H,
                       P, N, hd, p0, vec_y);
    const float decay = expf(cs[Q - 1]);   // the chunk's total decay
    __syncthreads();                  // every read of the state done

    Share<NMAX> h;
    read_state<NMAX>(h, hi, lo, N8);
#pragma unroll
    for (int e = 0; e < NMAX / 4; ++e) h[e] = fmaf(h[e], decay, s[e]);
    store_split<NMAX>(h, hi, lo, N8);
    // the next chunk's barrier orders these writes before the state is
    // read again
  }
  // the thread's own entries, as it wrote them
  Share<NMAX> h;
  read_state<NMAX>(h, hi, lo, N8);
  const int c0 = p0 + (threadIdx.x % 16) * 4;
#pragma unroll
  for (int r = 0; r < NMAX / 16; ++r) {
    const int n = threadIdx.x / 16 + 16 * r;
    if (n >= N) break;
    float* dst = h_out + (b * H + hd) * tile + size_t(n) * P + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < P) dst[e] = h[4 * r + e];
  }
}

// The split's states: thread e of batch b holds state entry e of (H, N,
// P) and scans the chunks, writing the state before each one into
// h_before and the last into h_out.  kUnroll chunks' loads are issued
// before their updates.
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
ssd_state_scan(const float* __restrict__ S, const float* __restrict__ cum,
               const float* __restrict__ init, float* __restrict__ h_before,
               float* __restrict__ h_out, int B, int nc, int Q, int H,
               int NP) {
  const size_t HNP = size_t(H) * NP;
  const size_t idx = size_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= size_t(B) * HNP) return;
  const size_t b = idx / HNP, e = idx % HNP;
  const int hd = static_cast<int>(e / NP);
  float h = init != nullptr ? init[idx] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kUnroll) {
    float s[kUnroll], tot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t bc = b * nc + c0 + u;
      if (c0 + u < nc) {
        s[u] = S[bc * HNP + e];
        tot[u] = cum[(bc * Q + Q - 1) * H + hd];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < nc) {
        h_before[(b * nc + c0 + u) * HNP + e] = h;
        h = h * expf(tot[u]) + s[u];
      }
    }
  }
  h_out[idx] = h;
}

// The split's outputs: one block per (chunk bc, `heads` heads of one
// group from blockIdx.y * heads, P tile).  C rows and the heads' cum are
// copied once; each head's h_before tile is loaded into registers during
// the previous head's product and split into shared memory after it.
template <bool VEC, int NMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NMAX>)
ssd_state_out(const float* __restrict__ y_intra,
              const float* __restrict__ h_before,
              const float* __restrict__ cum, const float* __restrict__ C,
              float* __restrict__ y, int Q, int H, int P, int N, int G,
              int heads, bool vec_y) {
  extern __shared__ __align__(16) float smem[];
  const int N8 = round8(N), L = ldc(N);
  float* hi = smem;                   // [N8][kLDH] the state, split
  float* lo = hi + N8 * kLDH;
  float* Cs = lo + N8 * kLDH;         // [Q][L] C rows
  float* cs = Cs + Q * L;             // [heads][Q] cum
  const size_t bc = blockIdx.x;
  const int hd0 = blockIdx.y * heads;
  const int p0 = blockIdx.z * kPT;
  const size_t tile = size_t(N) * P;
  load_c<VEC>(Cs, C, bc, Q, N, G, hd0 / (H / G));
  load_cum(cs, cum, bc, Q, H, hd0, heads);
  cp_async_commit();
  Share<NMAX> hb;
  load_share<VEC, NMAX>(hb, h_before + (bc * H + hd0) * tile, N, P, p0);
  store_split<NMAX>(hb, hi, lo, N8);
  cp_async_wait<0>();
  __syncthreads();
  for (int i = 0; i < heads; ++i) {
    const bool next = i + 1 < heads;
    if (next)                         // in flight during this product
      load_share<VEC, NMAX>(hb, h_before + (bc * H + hd0 + i + 1) * tile,
                            N, P, p0);
    chunk_output<NMAX>(Cs, cs + i * Q, hi, lo, y_intra, y, bc, Q, H, P, N,
                       hd0 + i, p0, vec_y);
    if (next) {
      __syncthreads();                // every read of this head's tile done
      store_split<NMAX>(hb, hi, lo, N8);
      __syncthreads();
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte copies where N and P are multiples of 4 and C and the state
// rows read (S for the walk, h_before for the outputs) are 16-byte
// aligned
bool vec_copies(int N, int P, const void* C, const void* S) {
  return N % 4 == 0 && P % 4 == 0 && aligned16(C) && aligned16(S);
}

// 16-byte reads of y_intra and writes of y where P % 4 == 0 and both are
// 16-byte aligned
bool vec_y(int P, const void* y_intra, const void* y) {
  return P % 4 == 0 && aligned16(y_intra) && aligned16(y);
}

// Set each instantiation's shared-memory limit once (the process drives
// one card).
cudaError_t set_smem_limits() {
  static const cudaError_t attr = [] {
    constexpr auto kAttr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const void* fns[] = {
        reinterpret_cast<const void*>(ssd_state_walk<true, 64>),
        reinterpret_cast<const void*>(ssd_state_walk<false, 64>),
        reinterpret_cast<const void*>(ssd_state_walk<true, 128>),
        reinterpret_cast<const void*>(ssd_state_walk<false, 128>),
        reinterpret_cast<const void*>(ssd_state_out<true, 64>),
        reinterpret_cast<const void*>(ssd_state_out<false, 64>),
        reinterpret_cast<const void*>(ssd_state_out<true, 128>),
        reinterpret_cast<const void*>(ssd_state_out<false, 128>)};
    for (const void* fn : fns) {
      const cudaError_t e = cudaFuncSetAttribute(fn, kAttr, kMaxSmem);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return attr;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a walk takes (ssd_state.py::smem_bytes;
// a block of the split's outputs takes less).
long long ssd_state_pass_smem(int Q, int N) { return walk_smem(Q, N); }

// Each launch function runs on `stream` (a cudaStream_t from the caller)
// and returns the launch's cudaError_t: 0 when the kernel was accepted.
// `init` may be null (a zero initial state).  H % G == 0; 1 <= N <= 128;
// ssd_state_pass_smem(Q, N) at most 227 KB.  C and S (h_before for the
// outputs) rows are copied 16 bytes at a time where N and P are multiples
// of 4 and both are 16-byte aligned, else 4 bytes at a time; y_intra and
// y the same where P % 4 == 0 and both are 16-byte aligned.
//
// The walk: y and the final state.  ceil(P / 64), H and B at most 65535.
int ssd_state_walk_f32(const void* y_intra, const void* S, const void* cum,
                       const void* C, const void* init, void* y, void* h_out,
                       int B, int nc, int Q, int H, int P, int N, int G,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = walk_smem(Q, N);
  if (N < 1 || N > 128 || bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  const bool vec = vec_copies(N, P, C, S);
  auto kernel = N <= 64 ? (vec ? ssd_state_walk<true, 64>
                               : ssd_state_walk<false, 64>)
                        : (vec ? ssd_state_walk<true, 128>
                               : ssd_state_walk<false, 128>);
  kernel<<<grid, kThreads, static_cast<size_t>(bytes),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(S),
      static_cast<const float*>(cum), static_cast<const float*>(C),
      static_cast<const float*>(init), static_cast<float*>(y),
      static_cast<float*>(h_out), nc, Q, H, P, N, G, vec_y(P, y_intra, y));
  return static_cast<int>(cudaGetLastError());
}

// The split's states: every chunk's h_before (B, nc, H, N, P) and the
// final state.  B * H * N * P < 2^31 * 256.
int ssd_state_scan_f32(const void* S, const void* cum, const void* init,
                       void* h_before, void* h_out, int B, int nc, int Q,
                       int H, int P, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * H * N * P;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_state_scan<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(cum),
      static_cast<const float*>(init), static_cast<float*>(h_before),
      static_cast<float*>(h_out), B, nc, Q, H, N * P);
  return static_cast<int>(cudaGetLastError());
}

// The split's outputs: y from y_intra, h_before, cum and C, `heads` heads
// of one group a block (1 to 4, dividing H / G; ssd_state.py::out_heads).
// B * nc below 2^31; H / heads and ceil(P / 64) at most 65535.
int ssd_state_out_f32(const void* y_intra, const void* h_before,
                      const void* cum, const void* C, void* y, int B, int nc,
                      int Q, int H, int P, int N, int G, int heads,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N < 1 || N > 128 || walk_smem(Q, N) > kMaxSmem || heads < 1 ||
      heads > kMaxHeads || (H / G) % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * nc, H / heads, (P + kPT - 1) / kPT);
  const bool vec = vec_copies(N, P, C, h_before);
  auto kernel = N <= 64 ? (vec ? ssd_state_out<true, 64>
                               : ssd_state_out<false, 64>)
                        : (vec ? ssd_state_out<true, 128>
                               : ssd_state_out<false, 128>);
  kernel<<<grid, kThreads, static_cast<size_t>(out_smem(Q, N, heads)),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(h_before),
      static_cast<const float*>(cum), static_cast<const float*>(C),
      static_cast<float*>(y), Q, H, P, N, G, heads, vec_y(P, y_intra, y));
  return static_cast<int>(cudaGetLastError());
}

// "cp.async16" or "cp.async4": the copy width a launch reading C and the
// state rows `rows` takes (S for the walk, h_before for the outputs).
const char* ssd_state_pass_route(int N, int P, const void* C,
                                 const void* rows) {
  return vec_copies(N, P, C, rows) ? "cp.async16" : "cp.async4";
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
