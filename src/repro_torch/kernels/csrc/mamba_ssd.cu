// Mamba-2 SSD per-chunk quadratic form, f32, for Hopper (sm_90a).
// x (BC, Q, H, P), cum (BC, Q, H), B and C (BC, Q, N), contiguous ->
// y (BC, Q, H, P) and the chunk state S (BC, H, N, P).
//
// Replaces the Pallas kernel `_ssd_kernel` driven by `ssd_chunk_dual`
// (src/repro/kernels/mamba_ssd.py:48, body at :25).  For each chunk c and
// head h it computes
//   y[i, :]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x[j, h, :]
//   S[n, :]  = sum_j B[j, n] exp(cum_{Q-1} - cum_j) x[j, h, :]
// with n_groups = 1 (B and C shared by every head).  Above the diagonal
// (j > i) cum_i - cum_j is positive and its exp may overflow, so the
// kernel selects 0 there and never forms that exp (the Pallas body computes
// exp everywhere and selects afterwards; both give the same values where
// the mask keeps them).  The chunk state uses the chunk's last row,
// padded rows included, as the reference does: rows the caller padded carry
// dt = 0 and x = 0 and add nothing.
//
// What bounds it: at the realization path's shape (BC, Q, H, P, N) =
// (32, 128, 16, 128, 64) one launch does about 2.2 GFLOP on 86 MB, about
// 25 FLOP per byte, above the card's f32 balance point (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP per byte): it is bound by f32 operations, and by
// shared-memory bandwidth feeding them.  Tensor cores are not used: the
// 1e-4 parity with the f32 reference rules out TF32.
//
// Design: one block per (chunk, head, 128-column tile of P), 256 threads.
// The chunk's C and B rows (Q x N), the head's x tile (Q x 128) and its
// cum column are staged in shared memory once.  The masked weight matrix
// W = (C B^T) .* L is computed in registers (8 x 8 per thread, 16-byte
// shared loads) and kept in shared memory, transposed, so that y = W x is a
// second register-tiled product reading W and x with 16-byte loads; its
// loop stops at the thread's last row (W is zero past the diagonal).  The
// state is a third register-tiled product over the chunk's rows.  The
// Q x Q decay matrix never reaches device memory.  At Q = 128 the block
// takes 201 KB of dynamic shared memory (opted in above the 48 KB
// default), so one block runs per SM.  Taken: 1 <= Q <= 128, 1 <= N <= 64,
// any P (tiled by 128 over the grid), BC * H < 2^31.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 128;               // chunk length
constexpr int NMAX = 64;                // state width
constexpr int PT = 128;                 // head-dim columns per block
constexpr int LDN = NMAX + 4;           // C / B row stride (floats)
constexpr int LDX = PT + 4;             // x tile row stride

// Floats of dynamic shared memory for QP (Q rounded up to 16) rows:
// C, B, W^T, the x tile, cum and the end-of-chunk decays.
size_t smem_floats(int QP) {
  return size_t(QP) * (2 * LDN + (QP + 4) + LDX + 2);
}

// Columns p .. p + 3 of an output row, those below pw: one 16-byte store
// where the row is aligned and all four are in, else one store each.
__device__ __forceinline__ void store4(float* row, int p, int pw, bool vec,
                                       float v0, float v1, float v2,
                                       float v3) {
  if (vec && p + 3 < pw) {
    *reinterpret_cast<float4*>(row + p) = make_float4(v0, v1, v2, v3);
    return;
  }
  if (p < pw) row[p] = v0;
  if (p + 1 < pw) row[p + 1] = v1;
  if (p + 2 < pw) row[p + 2] = v2;
  if (p + 3 < pw) row[p + 3] = v3;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk(const float* __restrict__ x, const float* __restrict__ cum,
          const float* __restrict__ Bm, const float* __restrict__ Cm,
          float* __restrict__ y, float* __restrict__ state, int H, int Q,
          int P, int N, int QP) {
  extern __shared__ __align__(16) float smem[];
  const int LDW = QP + 4;
  float* Cs = smem;                     // [QP][LDN], zero past Q and N
  float* Bs = Cs + QP * LDN;            // [QP][LDN]
  float* Wt = Bs + QP * LDN;            // [QP][LDW], Wt[j][i] = W[i][j]
  float* Xs = Wt + QP * LDW;            // [QP][LDX], x[c, j, h, p0 + p]
  float* cs = Xs + QP * LDX;            // [QP], cum[c, j, h]
  float* ds = cs + QP;                  // [QP], exp(cum[Q-1] - cum[j])

  const int c = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int p0 = blockIdx.y * PT;
  const int pw = min(PT, P - p0);       // valid columns of this tile
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;
  const bool vec = (P & 3) == 0;        // 16-byte aligned rows of y and S

  for (int idx = t; idx < QP * NMAX; idx += THREADS) {
    const int r = idx / NMAX, n = idx % NMAX;
    const bool in = r < Q && n < N;
    const size_t g = (size_t(c) * Q + r) * N + n;
    Cs[r * LDN + n] = in ? Cm[g] : 0.f;
    Bs[r * LDN + n] = in ? Bm[g] : 0.f;
  }
  for (int idx = t; idx < QP * PT; idx += THREADS) {
    const int r = idx / PT, p = idx % PT;
    Xs[r * LDX + p] = (r < Q && p < pw)
        ? x[((size_t(c) * Q + r) * H + h) * P + p0 + p] : 0.f;
  }
  for (int r = t; r < QP; r += THREADS)
    cs[r] = r < Q ? cum[(size_t(c) * Q + r) * H + h] : 0.f;
  __syncthreads();
  const float last = cs[Q - 1];
  for (int r = t; r < QP; r += THREADS)
    ds[r] = r < Q ? expf(last - cs[r]) : 0.f;

  // W[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i < Q, else 0.
  // Thread rows i0 .. i0 + 7, columns tx + 16 b: neighbouring threads read
  // neighbouring B rows, whose 16-byte words fall in distinct banks.
  const int NP = (N + 3) & ~3;
  {
    const int i0 = ty * 8;
    if (i0 < QP) {
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int n = 0; n < NP; n += 4) {
        float4 cv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          cv[a] = *reinterpret_cast<const float4*>(&Cs[(i0 + a) * LDN + n]);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int j = tx + 16 * b;
          if (j >= QP) continue;
          const float4 bv = *reinterpret_cast<const float4*>(&Bs[j * LDN + n]);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            acc[a][b] = fmaf(cv[a].x, bv.x, acc[a][b]);
            acc[a][b] = fmaf(cv[a].y, bv.y, acc[a][b]);
            acc[a][b] = fmaf(cv[a].z, bv.z, acc[a][b]);
            acc[a][b] = fmaf(cv[a].w, bv.w, acc[a][b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int j = tx + 16 * b;
        if (j >= QP) continue;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = i0 + a;
          Wt[j * LDW + i] =
              (j <= i && i < Q) ? acc[a][b] * expf(cs[i] - cs[j]) : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // y[i][p] = sum_j W[i][j] x[j][p]: rows i0 .. i0 + 7, columns
  // tx * 4 + {0, 64} + 0..3.
  {
    const int i0 = ty * 8;
    if (i0 < Q) {
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[a][k] = 0.f;
      const int jend = min(Q, i0 + 8);
      for (int j = 0; j < jend; ++j) {
        const float4 w0 = *reinterpret_cast<const float4*>(&Wt[j * LDW + i0]);
        const float4 w1 =
            *reinterpret_cast<const float4*>(&Wt[j * LDW + i0 + 4]);
        const float4 x0 =
            *reinterpret_cast<const float4*>(&Xs[j * LDX + tx * 4]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&Xs[j * LDX + 64 + tx * 4]);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[a][k] = fmaf(w[a], xv[k], acc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = i0 + a;
        if (i >= Q) continue;
        float* yr = y + ((size_t(c) * Q + i) * H + h) * P + p0;
#pragma unroll
        for (int b = 0; b < 2; ++b)
          store4(yr, tx * 4 + 64 * b, pw, vec, acc[a][4 * b],
                 acc[a][4 * b + 1], acc[a][4 * b + 2], acc[a][4 * b + 3]);
      }
    }
  }

  // S[n][p] = sum_j B[j][n] ds[j] x[j][p]: rows n0 .. n0 + 3, the same
  // columns as y.
  {
    const int n0 = ty * 4;
    if (n0 < N) {
      float acc[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[a][k] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[j * LDN + n0]);
        const float d = ds[j];
        const float4 x0 =
            *reinterpret_cast<const float4*>(&Xs[j * LDX + tx * 4]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&Xs[j * LDX + 64 + tx * 4]);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float xv[8] = {x0.x * d, x0.y * d, x0.z * d, x0.w * d,
                             x1.x * d, x1.y * d, x1.z * d, x1.w * d};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[a][k] = fmaf(bb[a], xv[k], acc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int n = n0 + a;
        if (n >= N) continue;
        float* sr = state + ((size_t(c) * H + h) * N + n) * P + p0;
#pragma unroll
        for (int b = 0; b < 2; ++b)
          store4(sr, tx * 4 + 64 * b, pw, vec, acc[a][4 * b],
                 acc[a][4 * b + 1], acc[a][4 * b + 2], acc[a][4 * b + 3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t from the caller) and returns the
// launch's cudaError_t: 0 when the kernel was accepted.  1 <= Q <= 128,
// 1 <= N <= 64, P >= 1, 1 <= BC * H < 2^31.
int ssd_chunk_dual_f32(const float* x, const float* cum, const float* Bm,
                       const float* Cm, float* y, float* state, int BC, int Q,
                       int H, int P, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BC < 1 || H < 1 || P < 1 || Q < 1 || Q > QMAX || N < 1 || N > NMAX ||
      static_cast<long long>(BC) * H > 0x7fffffffLL ||
      (P + PT - 1) / PT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int QP = (Q + 15) / 16 * 16;
  const size_t bytes = smem_floats(QP) * sizeof(float);
  err = cudaFuncSetAttribute(ssd_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BC * H, (P + PT - 1) / PT);
  ssd_chunk<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, cum, Bm, Cm, y, state, H, Q, P, N, QP);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
