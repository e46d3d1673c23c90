// Decode against an int8 or feature-dim int4 KV cache for Hopper (sm_90a):
// one token, or a chunk of S appended tokens (int8), per sequence.
//
// Replaces the TPU kernel `_decode_q_kernel` (attention_tpu/ops/quant.py:156,
// launched by `flash_decode_quantized` at :338,
// `flash_decode_quantized_chunk` at :440 and `flash_decode_int4` at :649,
// the int4 layout through its `unpack` hook).  The rows, band and loop
// bounds are those of decode_rows.cuh, the tensor-core tile loop that of
// attention_tile.cuh; what is new is the loader (quant_tiles.cuh), which
// dequantizes the stored rows into the loop's bf16 tiles and scales the
// score and probability columns by the per-token scales.
//
// What bounds it on the H100: the cache bytes it reads, as for the bf16
// decode kernel (2·group·S operations per cache byte at most, against
// ~295 where the tensor cores become the limit), now d + 4 bytes per token
// and kv head for K and for V in int8, d/2 + 4 in int4 (0.52 and 0.27 of
// bf16 at d = 128).  The design reads each live row once per (sequence, kv
// head) for the whole GQA group and keeps the dequantized values out of
// device memory: they go from the staged bytes into the shared bf16 tiles
// the ldmatrix/mma loop reads.  What it does not yet do: it launches one
// split per sequence (32 CTAs at the serving geometry) where the dense and
// paged kernels split the keys across CTAs, and the dequantization is a
// second pass over shared memory between the copy and the products; the
// split launch and a dequantization into the mma fragments are later work.
#include "quant_tiles.cuh"

// Plain C entry points, loaded through ctypes; the arguments are those of
// atk::quant_decode_entry (quant_tiles.cuh).
extern "C" int quant_decode_int8_fwd(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lens, void* o, int B, int H, int Hkv, int S,
    int N, int d, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long skn, long long svb, long long svh, long long svn,
    long long sob, long long soh, long long sos, int window, int sinks,
    float softcap, void* stream) {
  return atk::quant_decode_entry<atk::Storage::INT8>(
      q, k, v, ks, vs, lens, o, B, H, Hkv, S, N, d, sqb, sqh, sqs, skb, skh,
      skn, svb, svh, svn, sob, soh, sos, window, sinks, softcap, stream);
}

extern "C" int quant_decode_int4_fwd(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lens, void* o, int B, int H, int Hkv, int S,
    int N, int d, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long skn, long long svb, long long svh, long long svn,
    long long sob, long long soh, long long sos, int window, int sinks,
    float softcap, void* stream) {
  return atk::quant_decode_entry<atk::Storage::INT4_FEATURE>(
      q, k, v, ks, vs, lens, o, B, H, Hkv, S, N, d, sqb, sqh, sqs, skb, skh,
      skn, svb, svh, svn, sob, soh, sos, window, sinks, softcap, stream);
}
