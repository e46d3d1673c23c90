// The dense-cache decode's instances of one max_mode variant, named by
// DECODE_VARIANT when this file is compiled (2 = FLASH-D, 3 = AMLA;
// `ops._native.VARIANT_UNITS` builds it once for each, beside decode.cu,
// which holds the online instances and the C entry point), so that the
// variants compile in parallel.  decode.cu says what the kernel computes
// and what bounds it; attention_tile.cuh how each variant runs.
#include "decode.cuh"

#ifndef DECODE_VARIANT
#error "DECODE_VARIANT names the variant this build instantiates"
#endif

static_assert(DECODE_VARIANT == atk::FLASHD || DECODE_VARIANT == atk::AMLA,
              "a decode variant other than online");

template cudaError_t ddec::run<DECODE_VARIANT>(const atk::DecodeArgs&,
                                               const ddec::DenseSource&, int,
                                               int, bool, cudaStream_t);
