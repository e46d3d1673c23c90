// Host-side TMA tensor maps of the wgmma bodies (flash_fwd.cu,
// flash_bwd_fused.cu, ragged_paged.cu): a bf16 operand of (batch, heads,
// rows, d) with the caller's element strides, read in 128-byte swizzled
// boxes, and an fp32 buffer that tiles are added into.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace tmap {

// cuTensorMapEncodeTiled, a libcuda function, reached through the CUDA
// runtime so that the library links without -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (d, rows, heads, batch) of a bf16 operand with the caller's
// element strides, read in 128-byte swizzled boxes of 64 columns by
// `box_rows` rows by `box_heads` heads (the box's rows in shared memory run
// rows fastest); rows past the end read as zeros.
inline bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d,
                   int rows, int heads, int batch, long long s_row,
                   long long s_head, long long s_batch, int box_rows,
                   int box_heads = 1) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2,
                                 (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {sm90::BOX, (cuuint32_t)box_rows,
                             (cuuint32_t)box_heads, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3-D map (d, rows, heads) of a contiguous fp32 (heads, rows, d)
// buffer, in 128-byte swizzled boxes of 32 columns by `box_rows` rows, for
// reductions into it; rows past the end are left alone.
inline bool encode_f32(EncodeTiled enc, CUtensorMap* map, float* ptr, int d,
                       int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)rows * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace tmap
