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
// bound by bytes (43 us at 3.35 TB/s; 32 us of f32 FMA at 67 TFLOP/s).
//
// Two routes; ssd_state.py picks one by the launch's block count.
//
// The walk (`ssd_state_walk`, the first design, simple first): one block
// of 256 threads per (P tile of 64 columns, head, batch) walks the chunks
// in order, the way the scan does; the walk is the sequential grid axis
// of a TPU kernel turned into a loop.
// The N x 64 state stays in shared memory for the whole walk.  The chunk's
// C rows (Q x N) and cum are copied with cp.async into one of two buffers,
// the next chunk's copy in flight while the current chunk is computed; S
// of the chunk is copied the same way while y is computed.  y_inter is a
// (Q x N) . (N x 64) product in f32 FMAs: each thread sums an 8-row x
// 4-column tile, reading four C columns and four state columns as float4s
// per step (12 shared loads for 128 FMAs; C rows padded by 4 floats, so
// the two rows a warp reads lie in different banks).  A barrier, then
// each thread updates its entries of the state with the chunk's total
// decay and S.  A batch of few heads leaves SMs idle, since each block is
// a sequential walk over the chunks: at the mamba2-370m realization shape
// (B 1, H 16, P 128) that is 32 blocks on 132 SMs, and the walk took
// 0.318 ms against its 0.026 ms bound (PERF.md, NVIDIA H100 80GB HBM3,
// 700 W).
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
//   out:  one block per (batch and chunk, head, P tile of 64 columns),
//         no walk: the chunk's C rows and cum and its h_before tile are
//         copied to shared memory (cp.async) and y = y_intra + exp(cum) *
//         (C_g . h_before) is the walk's product, the same 8 x 4 register
//         tile a thread (chunk_output below).
// It moves h_before twice more than the walk (written, read back): at the
// realization shape 119 MB in place of 86 MB, a 0.036 ms bound at 3.35
// TB/s against 0.026, with 1024 output blocks in place of 32.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kPT = 64;                    // P columns a block
constexpr int kColGroups = kPT / 4;        // threads across a row: 4 cols
constexpr int kRowGroups = kThreads / kColGroups;
constexpr int kRows = 8;                   // rows of a thread's tile
constexpr int kRowBlock = kRowGroups * kRows;   // rows the block sums at once
constexpr int kMaxSmem = 232448;           // 227 KB, the opt-in limit

struct Layout {
  int N4;     // N rounded up to 4 (the state's rows, zero-padded)
  int LDC;    // row stride of the C buffers: N4 + 4
  int Q;
  __host__ __device__ long long floats() const {
    // state, S tile, two C buffers, two cum buffers
    return 2LL * N4 * kPT + 2LL * Q * LDC + 2LL * Q;
  }
};

__host__ __device__ inline Layout layout(int Q, int N) {
  const int N4 = (N + 3) / 4 * 4;
  return {N4, N4 + 4, Q};
}

// Rows of C (group g) and cum (head hd) of chunk bc into one buffer.
template <bool VEC>
__device__ __forceinline__ void load_chunk(float* Cs, float* cs,
                                           const float* C, const float* cum,
                                           size_t bc, int Q, int H, int N,
                                           int G, int g, int hd,
                                           const Layout& L) {
  constexpr int W = VEC ? 4 : 1;
  const int per_row = L.N4 / W;
  for (int i = threadIdx.x; i < Q * per_row; i += kThreads) {
    const int q = i / per_row, n = (i % per_row) * W;
    const float* src = C + ((bc * Q + q) * G + g) * N + n;
    if constexpr (VEC) {
      cp_async16(Cs + q * L.LDC + n, src, true);
    } else {
      cp_async4(Cs + q * L.LDC + n, n < N ? src : C, n < N);
    }
  }
  for (int q = threadIdx.x; q < Q; q += kThreads)
    cp_async4(cs + q, cum + (bc * Q + q) * H + hd, true);
}

// y of chunk bc for head hd and the 64 columns from p0: y = y_intra +
// exp(cum) * (C_g . h) from the chunk's C rows Cs (Q x LDC), its cum cs
// and the state tile hs (N4 x 64, rows past N zero), all in shared
// memory.  Each thread sums an 8-row x 4-column tile a pass over
// kRowBlock rows.
__device__ __forceinline__ void chunk_output(
    const float* Cs, const float* cs, const float* hs, const Layout& L,
    const float* __restrict__ y_intra, float* __restrict__ y, size_t bc,
    int H, int P, int hd, int p0) {
  const int Q = L.Q;
  const int c0 = (threadIdx.x % kColGroups) * 4;   // the tile's columns
  const int r0 = threadIdx.x / kColGroups;         // and first row
  for (int qb = 0; qb < Q; qb += kRowBlock) {
    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < L.N4; n += 4) {
      float4 h4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h4[k] = *reinterpret_cast<const float4*>(hs + (n + k) * kPT + c0);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = min(qb + r0 + i * kRowGroups, Q - 1);
        const float4 cv =
            *reinterpret_cast<const float4*>(Cs + q * L.LDC + n);
        const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][0] = fmaf(cn[k], h4[k].x, acc[i][0]);
          acc[i][1] = fmaf(cn[k], h4[k].y, acc[i][1]);
          acc[i][2] = fmaf(cn[k], h4[k].z, acc[i][2]);
          acc[i][3] = fmaf(cn[k], h4[k].w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q = qb + r0 + i * kRowGroups;
      if (q >= Q) break;
      const float e = expf(cs[q]);
      const size_t row = ((bc * Q + q) * H + hd) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + c0 + j;
        if (p < P) y[row + p] = y_intra[row + p] + e * acc[i][j];
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ssd_state_walk(const float* __restrict__ y_intra, const float* __restrict__ S,
               const float* __restrict__ cum, const float* __restrict__ C,
               const float* __restrict__ init, float* __restrict__ y,
               float* __restrict__ h_out, int nc, int Q, int H, int P, int N,
               int G) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(Q, N);
  float* hs = smem;                   // [N4][kPT] the state's tile
  float* Ss = hs + L.N4 * kPT;        // [N4][kPT] the chunk's S tile
  float* Cb = Ss + L.N4 * kPT;        // [2][Q][LDC] C rows
  float* cb = Cb + 2 * Q * L.LDC;     // [2][Q] cum

  const int p0 = blockIdx.x * kPT;
  const int hd = blockIdx.y;
  const size_t b = blockIdx.z;
  const int g = hd / (H / G);

  load_chunk<VEC>(Cb, cb, C, cum, b * nc, Q, H, N, G, g, hd, L);
  cp_async_commit();
  for (int i = threadIdx.x; i < L.N4 * kPT; i += kThreads) {
    const int n = i / kPT, c = i % kPT;
    hs[i] = init != nullptr && n < N && p0 + c < P
                ? init[((b * H + hd) * N + n) * P + p0 + c]
                : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const size_t bc = b * nc + c;
    const int buf = c & 1;
    if (c + 1 < nc)                   // the next chunk's C and cum
      load_chunk<VEC>(Cb + (buf ^ 1) * Q * L.LDC, cb + (buf ^ 1) * Q, C,
                      cum, bc + 1, Q, H, N, G, g, hd, L);
    cp_async_commit();
    cp_async_wait<1>();               // this chunk's C and cum are in
    __syncthreads();                  // for every thread; the state too

    // the chunk's S tile, in flight while y is computed
    const float* Sc = S + (bc * H + hd) * size_t(N) * P;
    constexpr int W = VEC ? 4 : 1;
    for (int i = threadIdx.x; i < N * (kPT / W); i += kThreads) {
      const int n = i / (kPT / W), cc = (i % (kPT / W)) * W;
      const bool in = p0 + cc < P;
      const float* src = in ? Sc + size_t(n) * P + p0 + cc : S;
      if constexpr (VEC) {
        cp_async16(Ss + n * kPT + cc, src, in);
      } else {
        cp_async4(Ss + n * kPT + cc, src, in);
      }
    }
    cp_async_commit();

    const float* Cs = Cb + buf * Q * L.LDC;
    const float* cs = cb + buf * Q;
    chunk_output(Cs, cs, hs, L, y_intra, y, bc, H, P, hd, p0);
    const float decay = expf(cs[Q - 1]);   // the chunk's total decay
    cp_async_wait<0>();
    __syncthreads();                  // S is in; every read of the state done

    for (int i = threadIdx.x; i < N * kPT; i += kThreads)
      hs[i] = hs[i] * decay + Ss[i];
    // the next chunk's barrier orders these writes before the state is
    // read again, and before the S tile is refilled
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * kPT; i += kThreads) {
    const int n = i / kPT, cc = i % kPT;
    if (p0 + cc < P)
      h_out[((b * H + hd) * N + n) * P + p0 + cc] = hs[i];
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

// The split's outputs: one block per (chunk bc, head, P tile); the chunk's
// C rows and cum and its state tile from h_before, then chunk_output.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ssd_state_out(const float* __restrict__ y_intra,
              const float* __restrict__ h_before,
              const float* __restrict__ cum, const float* __restrict__ C,
              float* __restrict__ y, int Q, int H, int P, int N, int G) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(Q, N);
  float* hs = smem;                   // [N4][kPT] the state's tile
  float* Cs = hs + L.N4 * kPT;        // [Q][LDC] C rows
  float* cs = Cs + Q * L.LDC;         // [Q] cum
  const size_t bc = blockIdx.x;
  const int hd = blockIdx.y;
  const int p0 = blockIdx.z * kPT;
  load_chunk<VEC>(Cs, cs, C, cum, bc, Q, H, N, G, hd / (H / G), hd, L);
  const float* hb = h_before + (bc * H + hd) * size_t(N) * P;
  constexpr int W = VEC ? 4 : 1;
  for (int i = threadIdx.x; i < L.N4 * (kPT / W); i += kThreads) {
    const int n = i / (kPT / W), cc = (i % (kPT / W)) * W;
    const bool in = n < N && p0 + cc < P;
    const float* src = in ? hb + size_t(n) * P + p0 + cc : h_before;
    if constexpr (VEC) {
      cp_async16(hs + n * kPT + cc, src, in);
    } else {
      cp_async4(hs + n * kPT + cc, src, in);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_output(Cs, cs, hs, L, y_intra, y, bc, H, P, hd, p0);
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

long long out_smem(int Q, int N) {
  const Layout L = layout(Q, N);
  return 4LL * (L.N4 * kPT + Q * L.LDC + Q);
}

// Set each instantiation's shared-memory limit once (the process drives
// one card).
cudaError_t set_smem_limits() {
  static const cudaError_t attr = [] {
    constexpr auto kAttr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t e = cudaFuncSetAttribute(ssd_state_walk<true>, kAttr,
                                         kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_state_walk<false>, kAttr, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_state_out<true>, kAttr, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_state_out<false>, kAttr, kMaxSmem);
    return e;
  }();
  return attr;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a walk takes (ssd_state.py::smem_bytes;
// a block of the split's outputs takes less).
long long ssd_state_pass_smem(int Q, int N) {
  return 4LL * layout(Q, N).floats();
}

// Each launch function runs on `stream` (a cudaStream_t from the caller)
// and returns the launch's cudaError_t: 0 when the kernel was accepted.
// `init` may be null (a zero initial state).  H % G == 0;
// ssd_state_pass_smem(Q, N) at most 227 KB.  C and S (h_before for the
// outputs) rows are copied 16 bytes at a time where N and P are multiples
// of 4 and both are 16-byte aligned, else 4 bytes at a time.
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
  const long long bytes = ssd_state_pass_smem(Q, N);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  auto kernel = vec_copies(N, P, C, S) ? ssd_state_walk<true>
                                       : ssd_state_walk<false>;
  kernel<<<grid, kThreads, static_cast<size_t>(bytes),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(S),
      static_cast<const float*>(cum), static_cast<const float*>(C),
      static_cast<const float*>(init), static_cast<float*>(y),
      static_cast<float*>(h_out), nc, Q, H, P, N, G);
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

// The split's outputs: y from y_intra, h_before, cum and C.  B * nc below
// 2^31; H and ceil(P / 64) at most 65535.
int ssd_state_out_f32(const void* y_intra, const void* h_before,
                      const void* cum, const void* C, void* y, int B, int nc,
                      int Q, int H, int P, int N, int G, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ssd_state_pass_smem(Q, N) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * nc, H, (P + kPT - 1) / kPT);
  auto kernel = vec_copies(N, P, C, h_before) ? ssd_state_out<true>
                                              : ssd_state_out<false>;
  kernel<<<grid, kThreads, static_cast<size_t>(out_smem(Q, N)),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(h_before),
      static_cast<const float*>(cum), static_cast<const float*>(C),
      static_cast<float*>(y), Q, H, P, N, G);
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
