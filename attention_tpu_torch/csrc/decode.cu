// Decode against a dense KV cache for Hopper (sm_90a): one token, or a
// chunk of S appended tokens, per sequence.
//
// Replaces the TPU kernel `_decode_kernel` (attention_tpu/ops/decode.py:90,
// launched by `flash_decode` at :355 and `flash_decode_chunk` at :489),
// its max modes online, FLASH-D and AMLA (the call's `variant`; the online
// instances here, the others' in builds of decode_variant.cu).  q (B, H, S, d) against caches k (B, Hkv, N, d) and
// v (B, Hkv, N, dv) with per-sequence lengths lens (B,) taken after the S
// rows were appended; row (g, s) of kv head h sits at position
// lens[b] - S + s, causal within the chunk, with the optional window band
// and pinned sinks, and softcap.  Rows, band and loop bounds are those of
// decode_rows.cuh.
//
// What bounds it on the H100: a step reads each sequence's live cache rows
// once per kv head (2·len·d values) and does 4·group·S·len·d operations on
// them, 2·group·S operations per byte in bf16: about 8 at group 8 and S = 1,
// far below the ~295 where the tensor cores become the limit.  So it is
// bound by the bytes of the cache it reads (3.35 TB/s), and what sets the
// rate is how many bytes are in flight across the SMs.  The design reads
// those rows once per (sequence, kv head, split) for the whole GQA group;
// the loop bounds skip every row past the length and below the band, so
// the bytes scale with the used prefix (or the window), not with the
// capacity.  The keys of each sequence are split across CTAs so that the
// grid covers the SMs about twice (decode_rows.cuh: at the serving
// geometry, B = 8 and Hkv = 4, 32 CTAs become 256), a second small kernel
// merging the splits; where the rows fit one 16-row tile (one-token decode
// at group 8 has 8), the four warps share it and split every key tile
// between them instead of three of them computing on padding, and three
// cp.async stages keep about 64 KB of key/value tiles in flight per CTA.
#include "decode.cuh"

// the other variants' instances, built from decode_variant.cu
extern template cudaError_t ddec::run<atk::FLASHD>(
    const atk::DecodeArgs&, const ddec::DenseSource&, int, int, bool,
    cudaStream_t);
extern template cudaError_t ddec::run<atk::AMLA>(
    const atk::DecodeArgs&, const ddec::DenseSource&, int, int, bool,
    cudaStream_t);

// Plain C entry point, loaded through ctypes.  dtype: 0 = fp32, 1 = bf16.
// q and o are (B, H, S, d) and the caches (B, Hkv, N, d), each with element
// strides (batch, head, row) and a contiguous last dim; lens is (B,) int32
// on the device.  window <= 0 means none (sinks then ignored); softcap <= 0
// means none.  A negative length reads as 0.  splits and chunk are the key
// split of `split_plan` (attention_tpu_torch/ops/decode.py); with splits >
// 1, part is contiguous fp32 scratch of B·H·S·splits·(dv + 2) values.
// variant: the max mode, 0 = online, 2 = FLASH-D, 3 = AMLA.
// Returns cudaGetLastError().
extern "C" int decode_fwd(const void* q, const void* k, const void* v,
                          const void* lens, void* o, void* part, int dtype,
                          int B, int H, int Hkv, int S, int N, int dk, int dv,
                          long long sqb, long long sqh, long long sqs,
                          long long skb, long long skh, long long skn,
                          long long svb, long long svh, long long svn,
                          long long sob, long long soh, long long sos,
                          int window, int sinks, float scale, float softcap,
                          int splits, int chunk, int variant,
                          void* stream) {
  atk::DecodeArgs a{};
  a.q = q;
  a.o = o;
  a.lens = static_cast<const int*>(lens);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.dk = dk;
  a.dv = dv;
  a.n_cap = N;
  a.window = window > 0 ? window : 0;
  a.sinks = window > 0 ? sinks : 0;
  a.sqb = sqb;
  a.sqh = sqh;
  a.sqs = sqs;
  a.sob = sob;
  a.soh = soh;
  a.sos = sos;
  a.qscale = scale * atk::LOG2E;
  a.cap2 = softcap > 0.f ? softcap * atk::LOG2E : 0.f;
  atk::set_splits(a, B, splits, chunk, part);
  const ddec::DenseSource src{k, v, skb, skh, skn, svb, svh, svn};
  const bool mma_ok = atk::rows_aligned(a) && skb % 8 == 0 &&
                      skh % 8 == 0 && skn % 8 == 0 && svb % 8 == 0 &&
                      svh % 8 == 0 && svn % 8 == 0 && atk::aligned16(k) &&
                      atk::aligned16(v);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case atk::ONLINE:
      return (int)ddec::run<atk::ONLINE>(a, src, B, dtype, mma_ok, st);
    case atk::FLASHD:
      return (int)ddec::run<atk::FLASHD>(a, src, B, dtype, mma_ok, st);
    case atk::AMLA:
      return (int)ddec::run<atk::AMLA>(a, src, B, dtype, mma_ok, st);
  }
  return (int)cudaErrorInvalidValue;
}
