// One-token decode against a token-paired int4 KV cache for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_decode_tok4_kernel` (attention_tpu/ops/quant.py:
// 788, launched by `flash_decode_int4_tok` at :973).  The TPU kernel had to
// mirror `_decode_q_kernel` by hand, because unpacking a byte row into two
// token rows changed its score tile's lane order ([even | odd] tokens,
// :829-847).  Here the tile loop (quant_tiles.cuh, INT4_TOKENS) feeds the
// two nibbles of a packed row to two score n-tiles, the even tokens' and the
// odd ones', and names each score column's token, so the mask and scales
// see tokens as they are and the kernel is the int8 kernel's rows, band,
// key split, merge and loop (decode_rows.cuh, quant_tiles.cuh): no chunk
// mode (S = 1), as the TPU kernel had none.
//
// What bounds it on the H100: the bytes of the packed cache, d/2 + 4 per
// token and kv head for K and for V (0.27 of bf16 at d = 128), read once per
// (sequence, kv head, split).  A 64-token tile is 32 packed rows of d
// bytes: full-width 16-byte copies, about 29 KB of ring at d = 128 in three
// stages.  Odd lengths: the last pair's high nibble is loaded and masked.
#include "quant_tiles.cuh"

// Plain C entry point, loaded through ctypes; the arguments are those of
// atk::quant_decode_entry (quant_tiles.cuh), with S = 1, N (tokens) even
// and the packed rows (B, Hkv, N/2, d).
extern "C" int quant_decode_tok4_fwd(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lens, void* o, void* part, int q_f32, int B,
    int H, int Hkv, int S, int N, int d, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, long long sob,
    long long soh, long long sos, int window, int sinks, float qscale,
    float softcap, int splits, int chunk, int kg, void* stream) {
  return atk::quant_decode_entry<atk::Storage::INT4_TOKENS>(
      q, k, v, ks, vs, lens, o, part, q_f32, B, H, Hkv, S, N, d, sqb, sqh,
      sqs, skb, skh, skn, svb, svh, svn, sob, soh, sos, window, sinks,
      qscale, softcap, splits, chunk, kg, stream);
}

// Registers, shared bytes and CTAs an SM of the (d, kg) instance, as
// atk::quant_decode_resources.
extern "C" int quant_tok4_resources(int d, int kg, int* out) {
  return atk::quant_decode_resources<atk::Storage::INT4_TOKENS>(d, kg, out);
}
