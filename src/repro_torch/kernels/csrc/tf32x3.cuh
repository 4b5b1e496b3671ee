// 3xTF32 tensor-core products and cp.async staging for sm_80 and later
// (built for sm_90a), shared by the three kernels under csrc/.
//
// Why three products.  A TF32 operand keeps 10 of f32's 23 mantissa bits,
// so one TF32 product misses the f32 references' tolerances (GEMM atol
// 1e-3 / rtol 1e-4, attention 2e-5) by one to two orders of magnitude.
// Each f32 operand x is therefore split into a TF32 high part hi (x
// rounded to nearest, ties away from zero) and a low part lo = x - hi,
// exact in f32, of which the tensor core reads the top 19 bits, and a.b
// is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32 accumulation: a
// product of two TF32 values is exact in f32, lo is cut to TF32 at about
// 2^-21 of x, and the dropped lo_a.lo_b term is about 2^-22 of the
// product.  This is the split CUTLASS calls OpMultiplyAddFastF32, the one
// PyTorch's f32 memory-efficient attention uses.  It costs three
// tensor-core products (495 / 3 = 165 TFLOP/s dense on an H100 SXM,
// against 67 TFLOP/s for f32 FMAs) plus three integer and float
// instructions per operand element.  `tests/test_torch_kernels.py`
// emulates the rounding on the CPU and shows that the three products meet
// the tolerances and one does not.
//
// Fragment layouts of mma.m16n8k8 with .tf32 operands (PTX ISA), for lane
// = 4 g + t (g = lane / 4 the group, t = lane % 4 the thread in group):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, "col"):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C, D (16 x 8):         c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace tf32x3 {

// x = hi + lo exactly: hi is x rounded to TF32 (to nearest, ties away
// from zero: half a TF32 ulp added to the magnitude, the low 13 bits
// cleared), lo the rest, which the tensor core cuts to TF32 itself.  The
// same rounding as cvt.rna.tf32.f32, in full-rate integer instructions:
// with two such conversions per element both kernels ran 15-22 % slower
// (benchmarks/port_kernel_variants.py; NVIDIA H100 80GB HBM3, 700 W).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b, one m16n8k8 TF32 product with an f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 operands.  The reference kernels take bf16 and compute in f32
// (src/repro/kernels/*.py cast each block with .astype(float32)); so do
// these, templated on the element type T: shared-memory tiles hold T, and
// an element is widened to f32 where a fragment is read (to_f32).  A
// bf16 value has 8 significant bits, so widened it is exact in TF32:
// split() gives hi = x and lo = 0, and a product of two such operands is
// one TF32 product (mmax<true, true>), exact like the f32 path's three.
// An operand computed in f32 inside a kernel (softmax probabilities, the
// decay-masked scores, B scaled by the decays) keeps its split; its
// partner's lo product is dropped (two products).
template <class T>
constexpr bool kTf32Exact = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// hi and lo of an element of type T (lo = 0 where T is exact in TF32).
template <class T>
__device__ __forceinline__ void split_t(T x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kTf32Exact<T>) {
    hi = __float_as_uint(to_f32(x));
    lo = 0u;
  } else {
    split(x, hi, lo);
  }
}

// d += a . b in 3xTF32: the two small terms first, then hi . hi.
//
// The tensor core rounds its accumulation toward zero, so a long sum kept
// in one mma accumulator drifts toward zero: accumulated there over
// K = 2048, the GEMM kernel was off by up to 3.7e-3 (NVIDIA H100 80GB
// HBM3, 700 W) against its 1e-3 tolerance.  The kernels therefore keep a
// sum in the tensor core over a few k8 steps only (a fragment started at
// zero) and add those fragments to their accumulators with f32 adds,
// which round to nearest; `tests/test_torch_kernels.py` emulates both.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);
}

// d += a . b where a (A_EXACT) or b (B_EXACT) is exact in TF32: the
// products of a zero lo part are left out; with neither, mma3 (so the f32
// kernels issue exactly mma3's products).
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mmax(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  if constexpr (!A_EXACT && !B_EXACT) {
    mma3(d, ahi, alo, bhi, blo);
  } else {
    if constexpr (!A_EXACT) mma(d, alo, bhi);
    if constexpr (!B_EXACT) mma(d, ahi, blo);
    mma(d, ahi, bhi);
  }
}

// acc += d, f32 adds (round to nearest); d is zeroed for the next sum.
__device__ __forceinline__ void drain(float (&acc)[4], float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e] += d[e];
    d[e] = 0.f;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !in (src-size 0:
// nothing is read, `src` need only be a valid address).  Both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared through L1; zero when !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Elements of T one copy moves: 16 bytes with VEC, else one element.
template <class T, bool VEC>
constexpr int kCopyElems = VEC ? int(16 / sizeof(T)) : 1;

// One copy of kCopyElems<T, VEC> elements global -> shared, zeros when
// !in: 16 bytes by cp.async (both addresses 16-byte aligned), one f32 by
// a 4-byte cp.async, or one bf16 by a plain load and store (cp.async has
// no 2-byte size; the barrier that makes the asynchronous copies visible
// makes the store visible too).
template <class T, bool VEC>
__device__ __forceinline__ void copy_elems(T* dst, const T* src, bool in) {
  if constexpr (VEC) {
    cp_async16(dst, src, in);
  } else if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src, in);
  } else {
    *dst = in ? *src : from_f32<T>(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace tf32x3
