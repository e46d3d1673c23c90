// Decode through a page table for Hopper (sm_90a): one token, or a chunk of
// S appended tokens, per sequence, reading the shared page pool in place.
//
// Replaces the TPU kernel `_paged_kernel` (attention_tpu/ops/paged.py:213,
// launched by `paged_flash_decode` at :409), online max mode.  q (B, H, S, d)
// against pools k (P, Hkv, page, d) and v (P, Hkv, page, dv): row c of
// sequence b lives in page table[b, c / page] at slot c % page.  Lengths
// lens (B,) are taken after the S rows were appended; rows, positions,
// window band, sinks and loop bounds are those of decode_rows.cuh, and the
// band is cut on logical positions before any page is translated.
//
// Page table rules, as on the TPU: a -1 entry is never followed (an entry
// below the length that holds -1 reads page 0, as the TPU kernel's clamp
// did; a length of 0 reads nothing); a negative length (a poisoned
// sequence) reads nothing and writes NaN rows; no row past the table's
// last page is read.  With partials asked for (acc set), the kernel writes
// the fp32 unnormalized output, each row's max in natural log (-inf for a
// row that saw nothing) and its sum, and a negative length reads as 0.
//
// What bounds it on the H100: as decode.cu, the bytes of the pages it reads
// (2·len·d values per sequence and kv head against 2·group·S operations per
// byte), at 3.35 TB/s.  Pages are read straight from the pool, never
// gathered into a dense copy; the loop bounds skip pages past the length
// and below the band.  The design is decode.cu's (decode_rows.cuh): the
// keys split across CTAs with a merge, the four warps sharing a 16-row
// tile at one-token decode, three cp.async stages; a 64-row key tile that
// lies inside one page is translated through the table once, not per row.
// The two-call engine's prefill chunk (S = 256, group 8) gives 32 row
// blocks per (sequence, kv head) and needs no split.
#include "decode_rows.cuh"

// Plain C entry point, loaded through ctypes.  dtype: 0 = fp32, 1 = bf16.
// q is (B, H, S, d) with element strides (batch, head, row) and a
// contiguous last dim; the pools are contiguous (P, Hkv, page, d); table
// (B, max_pages) and lens (B,) are contiguous int32 on the device.  Exactly
// one of o (normalized, q's dtype) and acc (fp32 partials, with m_out and
// l_out, contiguous (B, H, S)) is non-null; the output strides are those of
// whichever is given.  window <= 0 means none (sinks then ignored);
// softcap <= 0 means none.  splits, chunk and part as for decode_fwd
// (decode.cu).  Returns cudaGetLastError().
extern "C" int paged_decode_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lens, void* o, void* acc, void* m_out, void* l_out,
    void* part, int dtype, int B, int H, int Hkv, int S, int max_pages,
    int page, int dk, int dv, long long sqb, long long sqh, long long sqs,
    long long sob, long long soh, long long sos, int window, int sinks,
    float scale, float softcap, int splits, int chunk, void* stream) {
  if ((o == nullptr) == (acc == nullptr) ||
      (acc != nullptr && (m_out == nullptr || l_out == nullptr)) ||
      max_pages < 1 || page < 1)
    return (int)cudaErrorInvalidValue;
  atk::DecodeArgs a{};
  a.q = q;
  a.o = o;
  a.acc = static_cast<float*>(acc);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.lens = static_cast<const int*>(lens);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.dk = dk;
  a.dv = dv;
  a.n_cap = max_pages * page;
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
  a.poison = acc == nullptr;
  atk::set_splits(a, B, splits, chunk, part);
  const atk::PagedSource src{k_pool, v_pool, static_cast<const int*>(table),
                        max_pages, Hkv, page, dk, dv};
  // pool rows stay 16-byte aligned at head dims 64/128
  const bool mma_ok = atk::rows_aligned(a) && atk::aligned16(k_pool) &&
                      atk::aligned16(v_pool);
  return (int)atk::dispatch_decode(a, src, B, dtype, mma_ok,
                                   static_cast<cudaStream_t>(stream));
}
