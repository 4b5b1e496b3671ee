// Tiled GEMM for Hopper (sm_90a) on the tensor cores, f32 or bf16
// operands, f32 arithmetic:
// C (M, N) = A (M, K) @ B (K, N), all row-major and contiguous, C of the
// operands' type.
//
// Replaces the Pallas kernel `_mm_kernel` driven by `tiled_matmul`
// (src/repro/kernels/tiled_matmul.py:51): an output tile per grid cell, the
// contraction axis walked in steps with an f32 accumulator that lives
// across the steps, operands zero-padded at the ragged edges.
//
// What bounds it: at the realization paths' shapes (M of 2048 or 4096, K
// and N of 512 to 4384) a GEMM does 256 to 1100 FLOP per byte it must
// move: it is bound by operations.  The products run on the tensor cores
// in 3xTF32 (tf32x3.cuh): one TF32 product would miss the f32 reference's
// atol 1e-3 / rtol 1e-4 by 30-60x at K = 512..2048, three meet it.  The
// ops bound is then 2 M N K over 165 TFLOP/s (495 / 3), against 67 TFLOP/s
// for the f32 FMAs the kernel used before.  The kernel reaches about a
// third of it (PERF.md): mma.sync is not the full-rate path (one TF32
// product instead of three runs at most 1.9x as fast, so the products
// themselves hold it), and each element's split and each fragment's f32
// adds cost instructions beside them.  wgmma, the full-rate path, takes
// TF32 operands only K-major from shared memory, and B is N-major here.
//
// Design: a BM x BN output tile per block, BK = 32 deep steps, STAGES
// shared-memory stages filled by cp.async so that the copies of the next
// two steps are in flight while one step is multiplied (the Pallas
// kernel's VMEM double buffering, one stage deeper).  Each warp owns a
// (BM / WM) x (BN / WN) slice of the tile as m16n8 accumulators held in
// registers over the whole K loop; per k8 step it reads its A and B
// fragments from shared memory, splits each into TF32 hi and lo parts in
// registers, and issues three m16n8k8 products per (m16, n8) pair into a
// fragment started at zero, which it adds to the accumulator in f32 (the
// tensor core's own accumulation would drift, tf32x3.cuh).  A's
// shared row stride is BK + 4 floats and B's BN + 8, so the fragment reads
// (A at row g, column t; B at row t, column g) hit 32 different banks and
// every row stays 16-byte aligned for the copies.  Two configurations:
// 128 x 128 tiles with 8 warps of 64 x 32 (3 stages, 105 KB: two blocks an
// SM) where they give at least one block per SM, else 64 x 64 tiles with 4
// warps of 32 x 32, so that small grids still fill the card.  Operands are
// copied 16 bytes at a time where K % 4 == 0, N % 4 == 0 and the pointers
// are 16-byte aligned, else 4 bytes at a time (a second instantiation of
// the same kernel); either way the copies write zeros past M, N and K, so
// no shape needs to be a tile multiple.  No split-K and no atomics: each
// output is one accumulator summed in a fixed order, so the result is
// deterministic.
//
// bf16, aligned operands (K % 8 == 0, N % 8 == 0, a, b and c 16-byte aligned:
// every realization shape): gemm_wgmma_bf16, bf16 products on the tensor cores
// (bf16_tc.cuh).  What bounds it: at those shapes a bf16 GEMM does 39 (N = 40)
// to 778 FLOP per byte it must move; above the H100's 295, at 9 of the 17
// shapes, it is bound by the bf16 rate (989 TFLOP/s dense), which only wgmma
// reaches.  Design: TMA (cp.async.bulk.tensor) fills a ring of STAGES
// shared-memory stages of BK = 64, each completing on an mbarrier ("full"); one
// producer warp issues the loads, one or two consumer warpgroups of 64 rows
// each issue wgmma.m64nBNk16 on the stage that has landed and release it on a
// second mbarrier ("empty") once the products that read it are done (one wgmma
// group kept in flight), so the copies run STAGES - 1 steps ahead and no thread
// spends instructions on addresses.  A (M, K) is K-major and B (K, N) row-major
// is N-major: bf16 wgmma reads an MN-major B through its transpose flag, so
// neither is copied transposed; both are loaded in 128-byte swizzle (A as BM
// rows of 64 k, B as 64-column panels of 64 k rows), which the descriptors
// name.  TMA writes zeros past M, N and K, so no shape needs to be a tile
// multiple.  The epilogue rounds the f32 accumulator to bf16 once, as the
// reference's `acc.astype(o_ref.dtype)`, stages the tile in shared memory and
// stores it 16 bytes a thread, masking M and N (straight from the fragments a
// store is 4 bytes a thread spread over 8 rows).  Tile by grid fill
// (wgmma_tile): 128 x 256, 128 x 128 or 128 x 64 with two consumer warpgroups,
// or 64 x 64 with one, all with 4 stages.  No split-K and no atomics: each
// output is one accumulator summed in a fixed order.  The tensor maps are
// encoded on the host at each launch (cuTensorMapEncodeTiled, fetched from the
// driver through the runtime) and passed as __grid_constant__ parameters.
//
// bf16, ragged operands (odd K or N, K % 8 != 0, unaligned pointers): the
// 3xTF32 kernel above with T = __nv_bfloat16 (tf32x3.cuh), tiles of bf16
// (row strides BK + 8 and BN + 8), one element copied at a time by a plain
// load; each element is widened to f32 at the fragment read, and since
// both operands are then exact in TF32 each (m16, n8) pair takes one TF32
// product.  It is on no path.

#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16_tc.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

template <class T_, int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Tile {
  using T = T_;
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int BK = 32;
  static constexpr int THREADS = 32 * WM * WN;
  // f32: 4 mod 32 words; bf16: 16 bytes of pad, rows 16-byte aligned
  static constexpr int LDA = BK + int(16 / sizeof(T));
  static constexpr int LDB = BN + 8;    // f32: 8 mod 32 words
  static constexpr int MT = BM / WM / 16;   // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;    // n8 tiles a warp
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr size_t bytes =
      sizeof(T) * STAGES * size_t(A_ELEMS + B_ELEMS);
};

template <class T>
using Big = Tile<T, 128, 128, 2, 4, 3>;
template <class T>
using Small = Tile<T, 64, 64, 2, 2, 3>;

// One BK step of A (rows m0.., columns k0..) and B (rows k0.., columns
// n0..) into a stage, zeros past the edges.  Issues cp.async (bf16 one
// element at a time: plain loads); no wait.
template <class Tl, bool VEC>
__device__ __forceinline__ void load_stage(typename Tl::T* As,
                                           typename Tl::T* Bs,
                                           const typename Tl::T* A,
                                           const typename Tl::T* B, int M,
                                           int N, int K, int m0, int n0,
                                           int k0) {
  using T = typename Tl::T;
  constexpr int W = kCopyElems<T, VEC>; // elements a copy
  constexpr int ACH = Tl::BK / W;       // copies an A row
  constexpr int BCH = Tl::BN / W;       // copies a B row
  static_assert(Tl::BM * ACH % Tl::THREADS == 0, "A copies split evenly");
  static_assert(Tl::BK * BCH % Tl::THREADS == 0, "B copies split evenly");
#pragma unroll
  for (int i = 0; i < Tl::BM * ACH / Tl::THREADS; ++i) {
    const int idx = threadIdx.x + i * Tl::THREADS;
    const int r = idx / ACH, c = (idx % ACH) * W;
    const bool in = m0 + r < M && k0 + c < K;
    const T* from = in ? A + size_t(m0 + r) * K + k0 + c : A;
    copy_elems<T, VEC>(As + r * Tl::LDA + c, from, in);
  }
#pragma unroll
  for (int i = 0; i < Tl::BK * BCH / Tl::THREADS; ++i) {
    const int idx = threadIdx.x + i * Tl::THREADS;
    const int r = idx / BCH, c = (idx % BCH) * W;
    const bool in = k0 + r < K && n0 + c < N;
    const T* from = in ? B + size_t(k0 + r) * N + n0 + c : B;
    copy_elems<T, VEC>(Bs + r * Tl::LDB + c, from, in);
  }
}

// Columns col and col + 1 of an output row: one paired store (VEC: N is a
// multiple of the copy width, so both are in when col is; only f32 takes
// this kernel with 16-byte copies, aligned bf16 taking gemm_wgmma_bf16).
template <class T, bool VEC>
__device__ __forceinline__ void store_pair(T* out, int col, int N, float v0,
                                           float v1) {
  if constexpr (VEC) {
    static_assert(sizeof(T) == 4, "aligned bf16 takes the wgmma kernel");
    if (col >= N) return;
    *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
  } else {
    if (col < N) out[0] = from_f32<T>(v0);
    if (col + 1 < N) out[1] = from_f32<T>(v1);
  }
}

template <class Tl, bool VEC>
__global__ void __launch_bounds__(Tl::THREADS, Tl::BM == 128 ? 2 : 1)
gemm_3xtf32(const typename Tl::T* __restrict__ A,
            const typename Tl::T* __restrict__ B,
            typename Tl::T* __restrict__ C, int M, int N, int K) {
  using T = typename Tl::T;
  constexpr bool EX = kTf32Exact<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);            // [STAGES][BM][LDA]
  T* Bs = As + Tl::STAGES * Tl::A_ELEMS;             // [STAGES][BK][LDB]

  const int m0 = blockIdx.y * Tl::BM;
  const int n0 = blockIdx.x * Tl::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / Tl::WN) * (Tl::BM / Tl::WM);   // warp's first row
  const int wn = (warp % Tl::WN) * (Tl::BN / Tl::WN);   // and column

  float acc[Tl::MT][Tl::NT][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + Tl::BK - 1) / Tl::BK;
#pragma unroll
  for (int s = 0; s < Tl::STAGES - 1; ++s) {
    if (s < KT)
      load_stage<Tl, VEC>(As + s * Tl::A_ELEMS, Bs + s * Tl::B_ELEMS, A, B,
                          M, N, K, m0, n0, s * Tl::BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<Tl::STAGES - 2>();    // step kt has landed
    __syncthreads();                    // ... for every thread, and step
                                        // kt - 1's stage is free
    const int nk = kt + Tl::STAGES - 1;
    if (nk < KT) {
      const int ns = nk % Tl::STAGES;
      load_stage<Tl, VEC>(As + ns * Tl::A_ELEMS, Bs + ns * Tl::B_ELEMS, A, B,
                          M, N, K, m0, n0, nk * Tl::BK);
    }
    cp_async_commit();

    const T* as = As + (kt % Tl::STAGES) * Tl::A_ELEMS;
    const T* bs = Bs + (kt % Tl::STAGES) * Tl::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < Tl::BK; kk += 8) {
      uint32_t bhi[Tl::NT][2], blo[Tl::NT][2];
#pragma unroll
      for (int j = 0; j < Tl::NT; ++j) {
        const T* bp = bs + (kk + t) * Tl::LDB + wn + j * 8 + g;
        split_t(bp[0], bhi[j][0], blo[j][0]);
        split_t(bp[4 * Tl::LDB], bhi[j][1], blo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < Tl::MT; ++i) {
        const T* ap = as + (wm + i * 16 + g) * Tl::LDA + kk + t;
        uint32_t ahi[4], alo[4];
        split_t(ap[0], ahi[0], alo[0]);
        split_t(ap[8 * Tl::LDA], ahi[1], alo[1]);
        split_t(ap[4], ahi[2], alo[2]);
        split_t(ap[8 * Tl::LDA + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < Tl::NT; ++j) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mmax<EX, EX>(d, ahi, alo, bhi[j], blo[j]);
          drain(acc[i][j], d);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        store_pair<T, VEC>(C + size_t(row) * N + col, col, N,
                           acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// bf16, aligned: wgmma fed by TMA
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int STAGES_>
struct Wg {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int BK = 64;               // 128 bytes: one swizzle row
  static constexpr int CONSUMERS = BM / 64;   // warpgroups of 64 rows
  static constexpr int THREADS = 128 * CONSUMERS + 32;   // + the producer
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int PANEL_BYTES = BK * 128;  // 64 columns of B, BK rows
  static constexpr int B_BYTES = BN / 64 * PANEL_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the stages, 1024-byte aligned (the swizzle atom), then the barriers
  static constexpr size_t bytes =
      1024 + size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
};
using WgWide = Wg<128, 256, 4>;   // 193 KB: one block an SM
using WgBig = Wg<128, 128, 4>;    // 129 KB: one
using WgMid = Wg<128, 64, 4>;     // 97 KB: two
using WgSmall = Wg<64, 64, 4>;    // 65 KB: three

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (BN == 256) {
    bf16tc::wgmma_m64n256k16(d, a, b);
  } else if constexpr (BN == 128) {
    bf16tc::wgmma_m64n128k16(d, a, b);
  } else {
    bf16tc::wgmma_m64n64k16(d, a, b);
  }
}

// C (M, N) = A (M, K) @ B (K, N), bf16, through the tensor maps ta (A: K
// innermost, boxes of 64 x BM) and tb (B: N innermost, boxes of 64 x 64).
template <class W>
__global__ void __launch_bounds__(W::THREADS)
gemm_wgmma_bf16(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  using namespace bf16tc;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t tiles = raw + pad;   // stage s: A, then B's panels
  uint64_t* full = reinterpret_cast<uint64_t*>(
      wg_smem + pad + W::STAGES * W::STAGE_BYTES);
  uint64_t* empty = full + W::STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * W::BM, n0 = blockIdx.x * W::BN;
  const int KT = (K + W::BK - 1) / W::BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * W::CONSUMERS);   // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * W::CONSUMERS) {     // the producer warp
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % W::STAGES;
        if (kt >= W::STAGES)          // the stage's previous step is done
          mbar_wait(&empty[s], (kt / W::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        const uint32_t a_s = tiles + s * W::STAGE_BYTES;
        tma_load_2d(a_s, &ta, &full[s], kt * W::BK, m0);
#pragma unroll
        for (int p = 0; p < W::BN / 64; ++p)
          tma_load_2d(a_s + W::A_BYTES + p * W::PANEL_BYTES, &tb, &full[s],
                      n0 + 64 * p, kt * W::BK);
      }
    }
    return;
  }

  const int wg = warp / 4;            // this warpgroup's 64 rows
  float acc[W::BN / 2];
#pragma unroll
  for (int i = 0; i < W::BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % W::STAGES;
    mbar_wait(&full[s], (kt / W::STAGES) & 1);
    const uint32_t a_s = tiles + s * W::STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_s = tiles + s * W::STAGE_BYTES + W::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W::BK / 16; ++kk)   // k16 steps: A 32 bytes on
      wgmma_tile<W::BN>(acc,                 // in its rows, B 16 rows down
                        wgmma_desc(a_s + 32 * kk, 16, 1024),
                        wgmma_desc(b_s + 2048 * kk, W::PANEL_BYTES, 1024));
    wgmma_commit();
    wgmma_wait<1>();                  // step kt - 1's products are done
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % W::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // The output tile leaves through shared memory, so that each store is
  // 16 bytes and a row's stores are contiguous: once every consumer
  // warpgroup's products are done (no load is in flight: every stage was
  // waited for), each warpgroup writes its 64 x BN rows as bf16 into the
  // stages' space, rows LDC apart (BN + 8: the fragment writes of a warp
  // hit 32 banks), then copies them out, masking M and N.
  constexpr int LDC = W::BN + 8;
  static_assert(W::CONSUMERS * 64 * LDC * 2 <= W::STAGES * W::STAGE_BYTES,
                "the output tile fits in the stages");
  named_barrier_sync(1, 128 * W::CONSUMERS);
  __nv_bfloat16* Cs =
      reinterpret_cast<__nv_bfloat16*>(wg_smem + pad) + wg * 64 * LDC;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp % 4) * 16 + g;
#pragma unroll
  for (int j = 0; j < W::BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(Cs + (wrow + 8 * h) * LDC + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  named_barrier_sync(2 + wg, 128);
  constexpr int CHUNKS = W::BN / 8;     // 16-byte chunks a row
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 64 * CHUNKS / 128; ++i) {
    const int idx = tid + 128 * i;
    const int r = idx / CHUNKS, c = 8 * (idx % CHUNKS);
    const int row = m0 + wg * 64 + r, col = n0 + c;
    if (row < M && col < N)             // N % 8 == 0: the chunk is whole
      *reinterpret_cast<uint4*>(C + size_t(row) * N + col) =
          *reinterpret_cast<const uint4*>(Cs + r * LDC + c);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int sm_count(int device) {
  static int sms[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 132;
  return sms[device];
}

// The big tile where its grid gives every SM a block, else the small one.
bool big_tiles(int M, int N, int device) {
  const long blocks = long((M + 127) / 128) * ((N + 127) / 128);
  return blocks >= sm_count(device);
}

// 16-byte copies where K and N are multiples of the copy's elements
// (4 f32, 8 bf16) and every pointer is 16-byte aligned.
bool vec_copies(int N, int K, int elem_bytes, const void* a, const void* b,
                const void* c) {
  const int w = 16 / elem_bytes;
  return K % w == 0 && N % w == 0 && aligned16(a) && aligned16(b) &&
         aligned16(c);
}

template <class Tl, bool VEC>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  using T = typename Tl::T;
  // once per instantiation (the process drives one card)
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_3xtf32<Tl, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tl::bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(gemm_3xtf32<Tl, VEC>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (M + Tl::BM - 1) / Tl::BM);
  gemm_3xtf32<Tl, VEC><<<grid, Tl::THREADS, Tl::bytes, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, a driver-API function, fetched once through the
// runtime (no -lcuda on the link line).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) bf16 matrix at `base` as boxes of (box_rows,
// 64) elements in 128-byte swizzle, zeros out of bounds.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class W>
int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K,
                 cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_wgmma_bf16<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W::bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, M, K, W::BM) || !tensor_map(&tb, b, K, N, W::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + W::BN - 1) / W::BN, (M + W::BM - 1) / W::BM);
  gemm_wgmma_bf16<W><<<grid, W::THREADS, W::bytes, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

enum class WgTile { Wide, Big, Mid, Small };

// The wgmma tile: the largest (128 x 256, 128 x 128, then 128 x 64) whose
// grid gives at least 31/32 of the SMs a block, else 64 x 64
// (benchmarks/port_bf16_variants.py times the rule against each tile).
WgTile wgmma_tile(int M, int N, int device) {
  const long fill = sm_count(device) * 31L / 32;
  auto blocks = [&](int bm, int bn) {
    return long((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  };
  if (blocks(128, 256) >= fill) return WgTile::Wide;
  if (blocks(128, 128) >= fill) return WgTile::Big;
  if (blocks(128, 64) >= fill) return WgTile::Mid;
  return WgTile::Small;
}

template <class T>
int launch_t(const void* a, const void* b, void* c, int M, int N, int K,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_copies(N, K, sizeof(T), a, b, c);
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      switch (wgmma_tile(M, N, device)) {
        case WgTile::Wide: return launch_wgmma<WgWide>(a, b, c, M, N, K, st);
        case WgTile::Big: return launch_wgmma<WgBig>(a, b, c, M, N, K, st);
        case WgTile::Mid: return launch_wgmma<WgMid>(a, b, c, M, N, K, st);
        default: return launch_wgmma<WgSmall>(a, b, c, M, N, K, st);
      }
    }
    return big_tiles(M, N, device)
               ? launch<Big<T>, false>(a, b, c, M, N, K, st)
               : launch<Small<T>, false>(a, b, c, M, N, K, st);
  } else {
    const bool big = big_tiles(M, N, device);
    if (vec)
      return big ? launch<Big<T>, true>(a, b, c, M, N, K, st)
                 : launch<Small<T>, true>(a, b, c, M, N, K, st);
    return big ? launch<Big<T>, false>(a, b, c, M, N, K, st)
               : launch<Small<T>, false>(a, b, c, M, N, K, st);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller) and return the
// launch's cudaError_t: 0 when the kernel was accepted.  f32 operands and
// output, or bf16 operands and output (f32 arithmetic either way).
int tiled_matmul_f32(const void* a, const void* b, void* c, int M, int N,
                     int K, int device, void* stream) {
  return launch_t<float>(a, b, c, M, N, K, device, stream);
}

int tiled_matmul_bf16(const void* a, const void* b, void* c, int M, int N,
                      int K, int device, void* stream) {
  return launch_t<__nv_bfloat16>(a, b, c, M, N, K, device, stream);
}

// The configuration a launch takes for these operands of `elem_bytes`
// bytes an element (the output taken as 16-byte aligned), e.g.
// "128x128 cp.async16"; bf16 routes end in " bf16": the wgmma kernel's
// tile for aligned operands ("128x64 wgmma tma bf16"), else the 3xTF32
// kernel's with one-element copies by plain loads ("64x64 ld2 bf16").
const char* tiled_matmul_route(int M, int N, int K, const void* a,
                               const void* b, int device, int elem_bytes) {
  const bool big = big_tiles(M, N, device);
  const bool vec = vec_copies(N, K, elem_bytes, a, b, nullptr);
  if (elem_bytes == 2) {
    if (vec) {
      switch (wgmma_tile(M, N, device)) {
        case WgTile::Wide: return "128x256 wgmma tma bf16";
        case WgTile::Big: return "128x128 wgmma tma bf16";
        case WgTile::Mid: return "128x64 wgmma tma bf16";
        default: return "64x64 wgmma tma bf16";
      }
    }
    return big ? "128x128 ld2 bf16" : "64x64 ld2 bf16";
  }
  if (vec) return big ? "128x128 cp.async16" : "64x64 cp.async16";
  return big ? "128x128 cp.async4" : "64x64 cp.async4";
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
