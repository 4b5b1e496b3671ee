// Tiled f32 GEMM for Hopper (sm_90a): C (M, N) = A (M, K) @ B (K, N).
//
// Replaces the Pallas kernel `_mm_kernel` driven by `tiled_matmul`
// (src/repro/kernels/tiled_matmul.py:51): an output tile per grid cell, the
// contraction axis walked in steps with an f32 accumulator that lives
// across the steps, operands zero-padded at the ragged edges.
//
// What bounds it: at the realization path's shapes (M = 2048, K and N of
// 512 or 2048) a GEMM does 256 to 1024 FMAs per byte it must move, far
// above the card's f32 balance point (67 TFLOP/s over 3.35 TB/s, about 20
// FLOP per byte), so it is bound by f32 operations.  TF32 tensor cores are
// off limits: the kernel must agree with the f32 reference to 1e-4
// relative, and TF32 keeps about three decimal digits.
//
// Design: a 64 x 64 output tile per 256-thread block, 4 x 4 outputs per
// thread held in registers over the whole K loop (the Pallas kernel's VMEM
// accumulator).  Each K step of 16 stages an A tile (stored transposed) and
// a B tile in shared memory with bounds-checked loads that write zeros
// past the edges, so M, N and K need not be tile multiples.  The inner
// loop reads four A and four B values with two 16-byte shared loads and
// issues 16 FMAs, which keeps the FMA pipes busier than the shared-memory
// port.  Plain FMAs in K order: no TF32, no split-K, deterministic.  Faster
// forms (wgmma in TF32 is excluded; a larger register tile, double-buffered
// cp.async staging) are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int PAD = 4;                           // keeps rows 16-byte aligned

__global__ void __launch_bounds__(THREADS)
sgemm_tiled(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + PAD];   // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN + PAD];   // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t from the caller) and returns the
// launch's cudaError_t: 0 when the kernel was accepted.
int tiled_matmul_f32(const float* a, const float* b, float* c, int M, int N,
                     int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  sgemm_tiled<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
