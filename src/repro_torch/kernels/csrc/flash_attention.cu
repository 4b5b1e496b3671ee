// Flash attention forward, f32, for Hopper (sm_90a).
// q (B, H, Sq, D), k and v (B, H, Sk, D), contiguous -> o (B, H, Sq, D).
//
// Replaces the Pallas kernel `_flash_kernel` driven by `flash_attention_mha`
// (src/repro/kernels/flash_attention.py:90) and follows its numerics
// exactly: scale 1/sqrt(D) on the q.k dot product; keys past Sk always
// masked; with `causal`, the mask q_pos >= k_pos counted from 0 for both
// (top-left aligned when Sq != Sk); masked scores are the finite -1e30, not
// -inf; running max starts at -1e30, the denominator at 0; the output is
// acc / max(l, 1e-30).
//
// What bounds it: at the realization path's shape (B, H, S, D) =
// (4, 4, 512, 128) each key/value row is used by every query row of the
// block, so the kernel does about 2 * S FLOP per byte of q, k, v and o,
// far above the card's f32 balance point (about 20 FLOP per byte): it is
// bound by f32 operations, and by shared-memory bandwidth feeding them.
// Tensor cores are not used: f32 parity with the reference at 2e-5 rules
// out TF32.
//
// Design: one block per (64-query tile, head, batch), 256 threads; four
// threads own one query row.  The q tile stays in shared memory; k and v
// tiles of 64 rows stream through shared memory in a loop inside the block
// (the Pallas kv grid axis).  Each thread computes 16 of its row's 64
// scores with 16-byte shared loads, the row max and row sum are combined
// across the row's four threads with warp shuffles, and the running max,
// denominator and the thread's quarter of the output row (DMAX / 4
// values) stay in registers across the kv loop.  The probabilities go
// through shared memory so each thread can apply the whole row to its
// columns of v.  The score matrix never reaches device memory.  With
// `causal`, kv tiles that lie wholly past the block's last query are
// skipped: every score in them is masked, and exp(-1e30 - m) is exactly 0
// in f32 once the first tile (which always holds k_pos = 0) has set a
// finite running max, so skipping changes no bit of the result.  Head dims
// up to 256 are taken; a head dim below the template's DMAX is zero-padded
// in shared memory, which leaves the dot products unchanged.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;            // four threads per query row
constexpr int SC = BKV / 4;             // scores per thread per kv tile
constexpr float NEG_INF = -1.0e30f;

template <int DMAX>
struct Smem {
  static constexpr int LD = DMAX + 4;   // q/k/v row stride (floats)
  static constexpr int LDP = BKV + 4;   // probability row stride
  static constexpr size_t bytes =
      sizeof(float) * (size_t(BQ) * LD + 2 * size_t(BKV) * LD +
                       size_t(BQ) * LDP);
};

// First output column of a thread's accumulator entries c..c+3 (c a
// multiple of 4): the row's four threads take 4-column chunks in turn, so
// their 16-byte reads of a v row fall in different shared-memory banks.
__device__ __forceinline__ int col4(int j, int c) { return 4 * j + 4 * c; }

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
          int D, int causal, float scale) {
  using S = Smem<DMAX>;
  constexpr int CW = DMAX / 4;          // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * S::LD;
  float* Vs = Ks + BKV * S::LD;
  float* Ps = Vs + BKV * S::LD;

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  float* ob = o + bh * Sq * D;

  const int t = threadIdx.x;
  const int r = t >> 2;                 // query row within the tile
  const int j = t & 3;                  // quarter of the row
  const int qpos = q0 + r;

  for (int idx = t; idx < BQ * DMAX; idx += THREADS) {
    const int rr = idx / DMAX, dd = idx % DMAX;
    Qs[rr * S::LD + dd] = (q0 + rr < Sq && dd < D)
        ? qb[(size_t)(q0 + rr) * D + dd] : 0.f;
  }

  float acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.f;
  float m_i = NEG_INF;
  float l_i = 0.f;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                    // previous tile fully consumed
    for (int idx = t; idx < BKV * DMAX; idx += THREADS) {
      const int rr = idx / DMAX, dd = idx % DMAX;
      const bool in = k0 + rr < Sk && dd < D;
      const size_t g = (size_t)(k0 + rr) * D + dd;
      Ks[rr * S::LD + dd] = in ? kb[g] : 0.f;
      Vs[rr * S::LD + dd] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    // scores of kv columns j, j + 4, ..., j + 60 for query row r
    float s[SC];
#pragma unroll
    for (int c = 0; c < SC; ++c) s[c] = 0.f;
    for (int d = 0; d < DMAX; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * S::LD + d]);
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[(j + 4 * c) * S::LD + d]);
        s[c] = fmaf(qv.x, kv.x, s[c]);
        s[c] = fmaf(qv.y, kv.y, s[c]);
        s[c] = fmaf(qv.z, kv.z, s[c]);
        s[c] = fmaf(qv.w, kv.w, s[c]);
      }
    }

    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int kpos = k0 + j + 4 * c;
      const bool keep = kpos < Sk && (!causal || qpos >= kpos);
      s[c] = keep ? s[c] * scale : NEG_INF;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const float p = expf(s[c] - m_new);
      psum += p;
      Ps[r * S::LDP + j + 4 * c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncthreads();                    // the row's probabilities are in Ps

#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] *= corr;
    for (int kk = 0; kk < BKV; kk += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[r * S::LDP + kk]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = &Vs[(kk + u) * S::LD];
#pragma unroll
        for (int c = 0; c < CW; c += 4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + col4(j, c));
          acc[c + 0] = fmaf(pv[u], vv.x, acc[c + 0]);
          acc[c + 1] = fmaf(pv[u], vv.y, acc[c + 1]);
          acc[c + 2] = fmaf(pv[u], vv.z, acc[c + 2]);
          acc[c + 3] = fmaf(pv[u], vv.w, acc[c + 3]);
        }
      }
    }
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int d = col4(j, c & ~3) + (c & 3);
      if (d < D) ob[(size_t)qpos * D + d] = acc[c] / denom;
    }
  }
}

template <int DMAX>
int launch(const float* q, const float* k, const float* v, float* o, int BH,
           int Sq, int Sk, int D, int causal, cudaStream_t stream) {
  const size_t bytes = Smem<DMAX>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd<DMAX><<<grid, THREADS, bytes, stream>>>(q, k, v, o, Sq, Sk, D,
                                                    causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t from the caller) and returns the
// launch's cudaError_t: 0 when the kernel was accepted.  1 <= D <= 256.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int B, int H, int Sq, int Sk, int D,
                        int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (D <= 32) return launch<32>(q, k, v, o, BH, Sq, Sk, D, causal, st);
  if (D <= 64) return launch<64>(q, k, v, o, BH, Sq, Sk, D, causal, st);
  if (D <= 128) return launch<128>(q, k, v, o, BH, Sq, Sk, D, causal, st);
  if (D <= 256) return launch<256>(q, k, v, o, BH, Sq, Sk, D, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
