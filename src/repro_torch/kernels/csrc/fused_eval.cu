// The evaluator's fused pass and the analyzer's segment replay for Hopper
// (sm_90a).
//
// fused_eval replaces the jitted `fused` function that `_build_fused_fn`
// builds (src/repro/core/evaluator.py:97-179): one segment-sum replays the
// batch's float32 contribution stream into B rows of `buf_len` cells, then
// each row's resource times, stage time, first-max bottleneck, GLB-overflow
// penalty, delay and five-way energy come out of the row, in f32 and in the
// order evaluator.py:131-177 computes them.
//
// segment_replay replaces `_jax_replay` (src/repro/core/analyzer.py:60-92):
// segment_sum(vals, idx, n) of an int64 index stream and a float64 value
// stream.  It adds in float64, as the interface's types ask; the reference
// runs float32 under jax's default x32.
//
// What bounds them: every stream entry is read once and added once, and a
// row's cells are read once; there is no reuse to exploit, so both are
// bound by bytes (8 bytes an entry for fused_eval, 16 for segment_replay,
// over the card's HBM rate).  At the batch sizes the search gives (a few
// to a hundred rows of a few hundred cells, streams of 10^4-10^6 entries)
// launch latency is as large as that bound.
//
// Design: pass 1 zeroes the accumulator (cudaMemsetAsync) and scatters the
// stream into it with atomicAdd, a grid-stride loop over the entries; pad
// entries aim at the dump cell past the last row.  An index outside the
// accumulator is skipped (the analyzer never emits one; the CPU plain
// version raises on it).  Pass 2 (fused_eval only) runs one block of 256
// threads per row: each thread strides over the row's spans (core time,
// the edges with their amortized part split by the D2D mask into NoC and
// D2D, the DRAM ports with theirs, the GLB footprint against capacity,
// the MACs, the core inputs), keeps four maxima and six sums, and the
// block reduces them with warp shuffles and a shared-memory step; thread 0
// then finishes the row.  Ties between the four times go to the first
// maximum, as `jnp.argmax` does.  Atomic adds land in an order that changes
// from run to run, and the row sums are taken in another order than the
// reference's, so results agree with it within float32 rounding (the
// reference's parity envelope is 1e-4 relative), never bit for bit.
//
// The spans, the D2D mask and the constants (bandwidths, GLB capacity,
// unit energies) are fixed per evaluator: the caller uploads them once.

#include <cuda_runtime.h>

namespace {

// accumulation targets, in the analyzer's layout order (analyzer.py T_*)
enum {
  T_CORE_MACS, T_EDGE, T_EDGE_AM, T_DRAM, T_DRAM_AM, T_GLB, T_CORE_IN,
  T_CORE_OUT, T_CORE_TIME, T_GLB_RW, N_TARGETS
};
// slots of the constants array (fused_eval.py CONSTS)
enum {
  C_NOC_BW, C_D2D_BW, C_DRAM_PORT_BW, C_DRAM_BW, C_GLB_CAP, C_GLB_TOTAL,
  C_E_MAC, C_E_GLB, C_E_NOC, C_E_D2D, C_E_DRAM
};
// rows of the output (fused_eval.py OUT_ROWS)
enum {
  O_DELAY, O_ENERGY, O_STAGE, O_OVERFLOW, O_E_MAC, O_E_GLB, O_E_NOC,
  O_E_D2D, O_E_DRAM
};
// per-thread partials: four maxima, then six sums
enum {
  A_COMP, A_NOC, A_D2D, A_DRAM, S_NOC, S_D2D, S_DRAM, S_MACS, S_IN, S_OVER,
  N_ACC
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScatterThreads = 256;

__global__ void scatter_f32(const int* __restrict__ idx,
                            const float* __restrict__ vals, long long n,
                            float* __restrict__ buf, long long n_cells) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long c = idx[i];
    if (c >= 0 && c < n_cells) atomicAdd(buf + c, vals[i]);
  }
}

__global__ void scatter_f64(const long long* __restrict__ idx,
                            const double* __restrict__ vals, long long n,
                            double* __restrict__ out, long long n_cells) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long c = idx[i];
    if (c >= 0 && c < n_cells) atomicAdd(out + c, vals[i]);
  }
}

__device__ __forceinline__ bool is_max(int a) { return a < S_NOC; }

__global__ void __launch_bounds__(kThreads)
rows_f32(const float* __restrict__ buf, int buf_len,
         const int* __restrict__ spans, const float* __restrict__ d2d_mask,
         const float* __restrict__ consts, int has_d2d,
         const int* __restrict__ npass, const int* __restrict__ depth,
         const float* __restrict__ wts, int B, float* __restrict__ out,
         int* __restrict__ bottleneck) {
  __shared__ int sp[2 * N_TARGETS];
  __shared__ float part[kWarps][N_ACC];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 2 * N_TARGETS) sp[tid] = spans[tid];
  __syncthreads();
  const float* row = buf + static_cast<long long>(b) * buf_len;
  float acc[N_ACC];
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) acc[a] = 0.f;   // max with initial 0.0

  for (int i = sp[2 * T_CORE_TIME] + tid; i < sp[2 * T_CORE_TIME + 1];
       i += kThreads)
    acc[A_COMP] = fmaxf(acc[A_COMP], row[i]);
  const int e0 = sp[2 * T_EDGE], ea = sp[2 * T_EDGE_AM];
  const int ne = sp[2 * T_EDGE + 1] - e0;
  for (int j = tid; j < ne; j += kThreads) {
    const float tot = row[e0 + j] + row[ea + j];
    const bool d2d = d2d_mask[j] != 0.f;
    const float noc = d2d ? 0.f : tot;
    const float dd = d2d ? tot : 0.f;
    acc[A_NOC] = fmaxf(acc[A_NOC], noc);
    acc[A_D2D] = fmaxf(acc[A_D2D], dd);
    acc[S_NOC] += noc;
    acc[S_D2D] += dd;
  }
  const int d0 = sp[2 * T_DRAM], da = sp[2 * T_DRAM_AM];
  const int nd = sp[2 * T_DRAM + 1] - d0;
  for (int j = tid; j < nd; j += kThreads) {
    acc[A_DRAM] = fmaxf(acc[A_DRAM], row[d0 + j] + row[da + j]);
    acc[S_DRAM] += row[d0 + j];
  }
  const float glb_cap = consts[C_GLB_CAP];
  for (int i = sp[2 * T_GLB] + tid; i < sp[2 * T_GLB + 1]; i += kThreads)
    acc[S_OVER] += fmaxf(row[i] - glb_cap, 0.f);
  for (int i = sp[2 * T_CORE_MACS] + tid; i < sp[2 * T_CORE_MACS + 1];
       i += kThreads)
    acc[S_MACS] += row[i];
  for (int i = sp[2 * T_CORE_IN] + tid; i < sp[2 * T_CORE_IN + 1];
       i += kThreads)
    acc[S_IN] += row[i];

#pragma unroll
  for (int a = 0; a < N_ACC; ++a) {
    float v = acc[a];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max(a) ? fmaxf(v, w) : v + w;
    }
    if ((tid & 31) == 0) part[tid >> 5][a] = v;
  }
  __syncthreads();
  if (tid != 0) return;
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) {
    float v = part[0][a];
    for (int w = 1; w < kWarps; ++w)
      v = is_max(a) ? fmaxf(v, part[w][a]) : v + part[w][a];
    acc[a] = v;
  }

  // evaluator.py:143-177, in its order
  const float t_comp = acc[A_COMP];
  const float t_noc = acc[A_NOC] / consts[C_NOC_BW];
  const float t_d2d = has_d2d ? acc[A_D2D] / consts[C_D2D_BW] : 0.f;
  const float t_dram = acc[A_DRAM] / consts[C_DRAM_PORT_BW];
  const float times[4] = {t_comp, t_noc, t_d2d, t_dram};
  int bi = 0;
  float bv = times[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (times[k] > bv) {            // first maximum, as jnp.argmax
      bi = k;
      bv = times[k];
    }
  float stage = fmaxf(bv, 1e-12f);
  const float overflow = acc[S_OVER];
  const float spill = overflow * 2.f;
  stage = stage * (1.f + overflow / consts[C_GLB_TOTAL]);
  stage = stage + spill / consts[C_DRAM_BW];
  const float np_f = static_cast<float>(npass[b]);
  const float delay = stage * (np_f + static_cast<float>(depth[b]) - 1.f);

  const float noc_bytes = acc[S_NOC] * np_f;
  const float d2d_bytes = acc[S_D2D] * np_f;
  const float dram_b = acc[S_DRAM] * np_f + wts[b] + spill * np_f;
  const float macs = acc[S_MACS] * np_f;
  const int rw = sp[2 * T_GLB_RW];
  const float e_mac = macs * consts[C_E_MAC];
  const float e_glb =
      (row[rw] + row[rw + 1] + acc[S_IN]) * np_f * consts[C_E_GLB];
  const float e_noc = (noc_bytes + d2d_bytes) * consts[C_E_NOC];
  const float e_d2d = d2d_bytes * consts[C_E_D2D];
  const float e_dram = dram_b * consts[C_E_DRAM];
  const float energy = e_mac + e_glb + e_noc + e_d2d + e_dram;

  out[O_DELAY * B + b] = delay;
  out[O_ENERGY * B + b] = energy;
  out[O_STAGE * B + b] = stage;
  out[O_OVERFLOW * B + b] = overflow;
  out[O_E_MAC * B + b] = e_mac;
  out[O_E_GLB * B + b] = e_glb;
  out[O_E_NOC * B + b] = e_noc;
  out[O_E_D2D * B + b] = e_d2d;
  out[O_E_DRAM * B + b] = e_dram;
  bottleneck[b] = bi;
}

int scatter_blocks(long long n) {
  long long blocks = (n + kScatterThreads - 1) / kScatterThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond that
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller) and return the
// launch's cudaError_t: 0 when every step was accepted.  `buf` is scratch
// of B * buf_len + 1 floats (the last one the dump cell); `out` is
// (9, B) f32 in OUT_ROWS order and `bottleneck` (B,) int32.
int fused_eval_f32(const void* idx, const void* vals, long long n, int B,
                   int buf_len, void* buf, const void* npass,
                   const void* depth, const void* wts, const void* spans,
                   const void* d2d_mask, const void* consts, int has_d2d,
                   void* out, void* bottleneck, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_cells = static_cast<long long>(B) * buf_len + 1;
  err = cudaMemsetAsync(buf, 0, n_cells * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    scatter_f32<<<scatter_blocks(n), kScatterThreads, 0, st>>>(
        static_cast<const int*>(idx), static_cast<const float*>(vals), n,
        static_cast<float*>(buf), n_cells);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rows_f32<<<B, kThreads, 0, st>>>(
      static_cast<const float*>(buf), buf_len,
      static_cast<const int*>(spans), static_cast<const float*>(d2d_mask),
      static_cast<const float*>(consts), has_d2d,
      static_cast<const int*>(npass), static_cast<const int*>(depth),
      static_cast<const float*>(wts), B, static_cast<float*>(out),
      static_cast<int*>(bottleneck));
  return static_cast<int>(cudaGetLastError());
}

// out (n_cells,) float64 = segment_sum(vals, idx, n_cells).
int segment_replay_f64(const void* idx, const void* vals, long long n,
                       void* out, long long n_cells, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, n_cells * sizeof(double), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    scatter_f64<<<scatter_blocks(n), kScatterThreads, 0, st>>>(
        static_cast<const long long*>(idx), static_cast<const double*>(vals),
        n, static_cast<double*>(out), n_cells);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
