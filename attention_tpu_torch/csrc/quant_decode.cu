// Decode against an int8 or feature-dim int4 KV cache for Hopper (sm_90a):
// one token, or a chunk of S appended tokens (int8), per sequence.
//
// Replaces the TPU kernel `_decode_q_kernel` (attention_tpu/ops/quant.py:156,
// launched by `flash_decode_quantized` at :338,
// `flash_decode_quantized_chunk` at :440 and `flash_decode_int4` at :649,
// the int4 layout through its `unpack` hook).  The rows, band, key split
// and merge are those of decode_rows.cuh; the tile loop is quant_tiles.cuh's,
// which scales the score and probability columns by the per-token scales.
//
// What bounds it on the H100: the cache bytes it reads (2·group·S
// operations per cache byte at most, against ~295 where the tensor cores
// become the limit), d + 4 bytes per token and kv head for K and for V in
// int8, d/2 + 4 in int4 (0.52 and 0.27 of bf16 at d = 128).  So the design
// is the dense kernel's (decode_rows.cuh): each sequence's keys split across
// CTAs so that the grid covers the SMs, a merge kernel, four warps sharing
// one 16-row tile at one-token decode.  What differs is the tile loop
// (quant_tiles.cuh): a CTA stages only the raw bytes and scales it reads,
// about 57 KB at d = 128 in int8 and 33 KB in int4 (the bf16 kernel's tiles
// took 104 KB), so that several CTAs share an SM, and its warps dequantize
// in registers straight into the mma.sync fragments, with no second pass
// over shared memory.
#include "quant_tiles.cuh"

// Plain C entry points, loaded through ctypes; the arguments are those of
// atk::quant_decode_entry (quant_tiles.cuh).
#define QUANT_DECODE_FWD(name, storage)                                      \
  extern "C" int name(                                                       \
      const void* q, const void* k, const void* v, const void* ks,           \
      const void* vs, const void* lens, void* o, void* part, int q_f32,      \
      int B, int H, int Hkv, int S, int N, int d, long long sqb,             \
      long long sqh, long long sqs, long long skb, long long skh,            \
      long long skn, long long svb, long long svh, long long svn,            \
      long long sob, long long soh, long long sos, int window, int sinks,    \
      float qscale, float softcap, int splits, int chunk, int kg,            \
      void* stream) {                                                        \
    return atk::quant_decode_entry<storage>(                                 \
        q, k, v, ks, vs, lens, o, part, q_f32, B, H, Hkv, S, N, d, sqb, sqh, \
        sqs, skb, skh, skn, svb, svh, svn, sob, soh, sos, window, sinks,     \
        qscale, softcap, splits, chunk, kg, stream);                         \
  }

// The int8 and the int4 instances build in two translation units, so that
// they compile at once (`ops._native.VARIANT_UNITS`): this file alone
// gives the int8 entry, with -DQUANT_INT4=1 the int4 one.
#ifndef QUANT_INT4
QUANT_DECODE_FWD(quant_decode_int8_fwd, atk::Storage::INT8)

extern "C" int quant_decode_int4_resources(int d, int kg, int* out);

// Registers, shared bytes and CTAs an SM of the (d, kg) instance, as
// atk::quant_decode_resources; int4 picks the feature-dim layout.
extern "C" int quant_decode_resources(int int4, int d, int kg, int* out) {
  return int4 ? quant_decode_int4_resources(d, kg, out)
              : atk::quant_decode_resources<atk::Storage::INT8>(d, kg, out);
}
#else
QUANT_DECODE_FWD(quant_decode_int4_fwd, atk::Storage::INT4_FEATURE)

extern "C" int quant_decode_int4_resources(int d, int kg, int* out) {
  return atk::quant_decode_resources<atk::Storage::INT4_FEATURE>(d, kg,
                                                                 out);
}
#endif
