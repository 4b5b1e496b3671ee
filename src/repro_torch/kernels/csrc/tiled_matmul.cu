// Tiled f32 GEMM for Hopper (sm_90a) on the tensor cores:
// C (M, N) = A (M, K) @ B (K, N), all row-major and contiguous.
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

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int BK = 32;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int LDA = BK + 4;    // 4 mod 32
  static constexpr int LDB = BN + 8;    // 8 mod 32
  static constexpr int MT = BM / WM / 16;   // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;    // n8 tiles a warp
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int B_FLOATS = BK * LDB;
  static constexpr size_t bytes =
      sizeof(float) * STAGES * size_t(A_FLOATS + B_FLOATS);
};

using Big = Tile<128, 128, 2, 4, 3>;
using Small = Tile<64, 64, 2, 2, 3>;

// One BK step of A (rows m0.., columns k0..) and B (rows k0.., columns
// n0..) into a stage, zeros past the edges.  Issues cp.async; no wait.
template <class T, bool VEC>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const float* A, const float* B,
                                           int M, int N, int K, int m0,
                                           int n0, int k0) {
  constexpr int W = VEC ? 4 : 1;        // floats a copy
  constexpr int ACH = T::BK / W;        // copies an A row
  constexpr int BCH = T::BN / W;        // copies a B row
  static_assert(T::BM * ACH % T::THREADS == 0, "A copies split evenly");
  static_assert(T::BK * BCH % T::THREADS == 0, "B copies split evenly");
#pragma unroll
  for (int i = 0; i < T::BM * ACH / T::THREADS; ++i) {
    const int idx = threadIdx.x + i * T::THREADS;
    const int r = idx / ACH, c = (idx % ACH) * W;
    const bool in = m0 + r < M && k0 + c < K;
    const float* from = in ? A + size_t(m0 + r) * K + k0 + c : A;
    if constexpr (VEC) {
      cp_async16(As + r * T::LDA + c, from, in);
    } else {
      cp_async4(As + r * T::LDA + c, from, in);
    }
  }
#pragma unroll
  for (int i = 0; i < T::BK * BCH / T::THREADS; ++i) {
    const int idx = threadIdx.x + i * T::THREADS;
    const int r = idx / BCH, c = (idx % BCH) * W;
    const bool in = k0 + r < K && n0 + c < N;
    const float* from = in ? B + size_t(k0 + r) * N + n0 + c : B;
    if constexpr (VEC) {
      cp_async16(Bs + r * T::LDB + c, from, in);
    } else {
      cp_async4(Bs + r * T::LDB + c, from, in);
    }
  }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS, T::BM == 128 ? 2 : 1)
gemm_3xtf32(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                  // [STAGES][BM][LDA]
  float* Bs = smem + T::STAGES * T::A_FLOATS;        // [STAGES][BK][LDB]

  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * T::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / T::WN) * (T::BM / T::WM);   // warp's first row
  const int wn = (warp % T::WN) * (T::BN / T::WN);   // and column

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < KT)
      load_stage<T, VEC>(As + s * T::A_FLOATS, Bs + s * T::B_FLOATS, A, B,
                         M, N, K, m0, n0, s * T::BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<T::STAGES - 2>();     // step kt has landed
    __syncthreads();                    // ... for every thread, and step
                                        // kt - 1's stage is free
    const int nk = kt + T::STAGES - 1;
    if (nk < KT) {
      const int ns = nk % T::STAGES;
      load_stage<T, VEC>(As + ns * T::A_FLOATS, Bs + ns * T::B_FLOATS, A, B,
                         M, N, K, m0, n0, nk * T::BK);
    }
    cp_async_commit();

    const float* as = As + (kt % T::STAGES) * T::A_FLOATS;
    const float* bs = Bs + (kt % T::STAGES) * T::B_FLOATS;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 8) {
      uint32_t bhi[T::NT][2], blo[T::NT][2];
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const float* bp = bs + (kk + t) * T::LDB + wn + j * 8 + g;
        split(bp[0], bhi[j][0], blo[j][0]);
        split(bp[4 * T::LDB], bhi[j][1], blo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const float* ap = as + (wm + i * 16 + g) * T::LDA + kk + t;
        uint32_t ahi[4], alo[4];
        split(ap[0], ahi[0], alo[0]);
        split(ap[8 * T::LDA], ahi[1], alo[1]);
        split(ap[4], ahi[2], alo[2]);
        split(ap[8 * T::LDA + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(d, ahi, alo, bhi[j], blo[j]);
          drain(acc[i][j], d);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float* out = C + size_t(row) * N + col;
        if constexpr (VEC) {            // N % 4 == 0: col + 1 < N too
          if (col < N)
            *reinterpret_cast<float2*>(out) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (col < N) out[0] = acc[i][j][2 * h];
          if (col + 1 < N) out[1] = acc[i][j][2 * h + 1];
        }
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
  const long blocks = long((M + Big::BM - 1) / Big::BM) *
                      ((N + Big::BN - 1) / Big::BN);
  return blocks >= sm_count(device);
}

bool vec_copies(int N, int K, const void* a, const void* b, const void* c) {
  return K % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(b) &&
         aligned16(c);
}

template <class T, bool VEC>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           cudaStream_t stream) {
  // once per instantiation (the process drives one card)
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_3xtf32<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(gemm_3xtf32<T, VEC>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  gemm_3xtf32<T, VEC><<<grid, T::THREADS, T::bytes, stream>>>(a, b, c, M, N,
                                                               K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t from the caller) and returns the
// launch's cudaError_t: 0 when the kernel was accepted.
int tiled_matmul_f32(const float* a, const float* b, float* c, int M, int N,
                     int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool big = big_tiles(M, N, device);
  if (vec_copies(N, K, a, b, c))
    return big ? launch<Big, true>(a, b, c, M, N, K, st)
               : launch<Small, true>(a, b, c, M, N, K, st);
  return big ? launch<Big, false>(a, b, c, M, N, K, st)
             : launch<Small, false>(a, b, c, M, N, K, st);
}

// The configuration tiled_matmul_f32 launches for these operands (the
// output taken as 16-byte aligned), e.g. "128x128 cp.async16".
const char* tiled_matmul_route(int M, int N, int K, const void* a,
                               const void* b, int device) {
  const bool big = big_tiles(M, N, device);
  if (vec_copies(N, K, a, b, nullptr))
    return big ? "128x128 cp.async16" : "64x64 cp.async16";
  return big ? "128x128 cp.async4" : "64x64 cp.async4";
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
