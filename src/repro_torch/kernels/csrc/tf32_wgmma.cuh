// TF32 wgmma building blocks for Hopper (sm_90a), shared by the f32 routes
// of tiled_matmul.cu (gemm_wgmma_tf32x3) and flash_attention.cu
// (flash_fwd_wgmma_tf32x3), beside the mbarrier, TMA and descriptor helpers
// of bf16_tc.cuh and the 3xTF32 split of tf32x3.cuh.
//
// wgmma.mma_async.m64nNk8 with .tf32 operands reads both operands K-major
// (the transpose flags exist for 16-bit types only): B from shared memory
// through a descriptor, A from shared memory too or from registers, where
// each warp of the warpgroup holds its 16 rows as the m16n8k8 A fragment
// (tf32x3.cuh): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
// The accumulator is bf16_tc.cuh's: d[4j + 2h + e] is row 16 (warp % 4) + g
// + 8h, column 8j + 2t + e.  An f32 tile of 32 columns is one 128-byte
// swizzle row, so a K-major operand sits in shared memory as panels of 32
// k (rows of 128 bytes, 8-row atoms of 1024 bytes), as TMA writes them with
// CU_TENSOR_MAP_SWIZZLE_128B; a k8 step is 32 bytes on within the panel.
//
// Accumulation: the tensor core rounds its sum toward zero (tf32x3.cuh), so
// each kernel keeps a sum in one wgmma accumulator over a bounded number of
// k8 steps, started with `accumulate` = 0, and adds it to an f32 register
// sum (tests/test_torch_kernels.py sizes the depths: the GEMM 4 k8 steps
// over K = 2048, flash's scores all of D = 128, its P V one kv tile).

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16_tc.cuh"

namespace tf32wg {

// Byte offset of element (r, c) (c < 32 floats) in a 128-byte-swizzled
// panel whose base is 1024-byte aligned, as TMA writes it: the 16-byte chunk
// index XORed with the row's position in its 8-row atom.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return uint32_t(r) * 128 + ((uint32_t(c >> 2) ^ uint32_t(r & 7)) << 4) +
         uint32_t(c & 3) * 4;
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma reads, TMA writes) of the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 3-d box of `map` at element coordinates (c0 innermost, c1, c2) into
// shared memory at `dst`, completing its bytes on `bar`; out-of-bounds
// elements are written as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(bf16tc::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (the warpgroup's 64 x 64 f32 accumulator fragment) = a . b, plus d
// unless `accumulate` is 0: one wgmma.m64n64k8 with TF32 operands, a from
// registers (the m16n8k8 A fragment of the warp's 16 rows), b K-major from
// shared memory through a 128-byte-swizzle descriptor.
__device__ __forceinline__ void wgmma_rs_m64n64k8(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (the warpgroup's 64 x 128 f32 accumulator fragment) = a . b, plus d
// unless `accumulate` is 0: one wgmma.m64n128k8 with TF32 operands, a from
// registers (the m16n8k8 A fragment of the warp's 16 rows), b K-major from
// shared memory through a 128-byte-swizzle descriptor.
__device__ __forceinline__ void wgmma_rs_m64n128k8(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (the warpgroup's 64 x 32 f32 accumulator fragment) = a . b, plus d
// unless `accumulate` is 0: one wgmma.m64n32k8 with TF32 operands, both
// K-major from shared memory through 128-byte-swizzle descriptors.
__device__ __forceinline__ void wgmma_ss_m64n32k8(float (&d)[16], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (the warpgroup's 64 x 64 f32 accumulator fragment) = a . b, plus d
// unless `accumulate` is 0: one wgmma.m64n64k8 with TF32 operands, both
// K-major from shared memory through 128-byte-swizzle descriptors.
__device__ __forceinline__ void wgmma_ss_m64n64k8(float (&d)[32], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

}  // namespace tf32wg

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

namespace tmap {

// cuTensorMapEncodeTiled, a function of libcuda, fetched once through the
// runtime (no -lcuda on the link line).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// A dense tensor of `rank` dims (dims[0] innermost, contiguous) of
// `elem_bytes`-byte elements at `base`, read as boxes of `box`, zeros out of
// bounds; the byte strides of dims 1.. follow from the dims.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                   const void* base, int rank, const cuuint64_t* dims,
                   const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t step = cuuint64_t(elem_bytes);
  for (int i = 0; i + 1 < rank; ++i) strides[i] = step *= dims[i];
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, type, cuuint32_t(rank), const_cast<void*>(base), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tmap
