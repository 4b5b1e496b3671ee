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
// bf16 (tf32x3.cuh): the same kernel with T = __nv_bfloat16.  Tiles hold
// bf16 (row strides BK + 8 and BN + 8, so rows stay 16-byte aligned), a
// 16-byte copy moves 8 elements (K % 8 == 0, N % 8 == 0, aligned), else
// one element a plain load; each element is widened to f32 at the
// fragment read, and since both operands are then exact in TF32 each
// (m16, n8) pair takes one product, not three.  The f32 accumulator is
// rounded to bf16 once, at the store, as the reference's
// `acc.astype(o_ref.dtype)`.

#include <cuda_runtime.h>

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
// multiple of the copy width, so both are in when col is).
template <class T, bool VEC>
__device__ __forceinline__ void store_pair(T* out, int col, int N, float v0,
                                           float v1) {
  if constexpr (VEC) {
    if (col >= N) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
    }
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

template <class T>
int launch_t(const void* a, const void* b, void* c, int M, int N, int K,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool big = big_tiles(M, N, device);
  if (vec_copies(N, K, sizeof(T), a, b, c))
    return big ? launch<Big<T>, true>(a, b, c, M, N, K, st)
               : launch<Small<T>, true>(a, b, c, M, N, K, st);
  return big ? launch<Big<T>, false>(a, b, c, M, N, K, st)
             : launch<Small<T>, false>(a, b, c, M, N, K, st);
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
// "128x128 cp.async16"; bf16 routes end in " bf16", and their one-element
// copies are plain loads ("ld2").
const char* tiled_matmul_route(int M, int N, int K, const void* a,
                               const void* b, int device, int elem_bytes) {
  const bool big = big_tiles(M, N, device);
  const bool vec = vec_copies(N, K, elem_bytes, a, b, nullptr);
  if (elem_bytes == 2) {
    if (vec) return big ? "128x128 cp.async16 bf16" : "64x64 cp.async16 bf16";
    return big ? "128x128 ld2 bf16" : "64x64 ld2 bf16";
  }
  if (vec) return big ? "128x128 cp.async16" : "64x64 cp.async16";
  return big ? "128x128 cp.async4" : "64x64 cp.async4";
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
