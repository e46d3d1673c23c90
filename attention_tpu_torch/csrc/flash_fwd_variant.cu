// The flash forward's instances of one max_mode variant, named by
// FLASH_VARIANT when this file is compiled (1 = bound, 2 = FLASH-D, 3 =
// AMLA; `ops._native.KERNELS` builds it once for each, beside
// flash_fwd.cu, which holds the online instances and the C entry point).
// Each build is its own nvcc process, so the variants compile in parallel.
// What each variant computes and what bounds it: flash_fwd.cu,
// attention_tile.cuh and flash_fwd_sm90.cuh.
#include "flash_fwd.cuh"

#ifndef FLASH_VARIANT
#error "FLASH_VARIANT names the variant this build instantiates"
#endif

static_assert(FLASH_VARIANT >= atk::BOUND && FLASH_VARIANT <= atk::AMLA,
              "a variant other than online");

template cudaError_t ffwd::run_fma<FLASH_VARIANT>(const ffwd::FlashArgs&,
                                                  int, int, cudaStream_t);
template cudaError_t ffwd::run_wgmma<FLASH_VARIANT>(
    const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
    const sm90::Args&, int, int, cudaStream_t);
