// The ragged kernel's instances of one max_mode variant, named by
// RAGGED_VARIANT when this file is compiled (2 = FLASH-D, 3 = AMLA;
// `ops._native.VARIANT_UNITS` builds it once for each, beside
// ragged_paged.cu, which holds the online instances, the finishing kernel
// and the C entry point), so that the variants compile in parallel.
// ragged_paged.cu says what the kernel computes and what bounds it.
#include "ragged_paged.cuh"

#ifndef RAGGED_VARIANT
#error "RAGGED_VARIANT names the variant this build instantiates"
#endif

static_assert(RAGGED_VARIANT == atk::FLASHD || RAGGED_VARIANT == atk::AMLA,
              "a ragged variant other than online");

template cudaError_t rpa::run_slots<RAGGED_VARIANT>(
    const rpa::RaggedArgs&, const atk::DecodeArgs&, const rpa::RaggedSource&,
    bool, int, int, int, int, int, int, int, cudaStream_t);
