// Forward flash attention for Hopper (sm_90a), normalized output or partials.
//
// Replaces the TPU kernel `_flash_kernel` (attention_tpu/ops/flash.py:310,
// launched by `_flash_call`), each of its max modes (the `variant` of the
// call: online, bound with its overshoot guard, FLASH-D, AMLA;
// attention_tile.cuh and flash_fwd_sm90.cuh say how each runs here),
// normalized output or, given an fp32 accumulator, the partials of
// `flash_attention_partials`: the unnormalized output, the value each
// row's scores were taken against (natural-log domain) and its sum of
// exponentials, which training saves for the backward.  Computes
// softmax(Q Kᵀ · scale) V for q (B, H, m, dk), k (B, Hkv, n, dk),
// v (B, Hkv, n, dv); q head h reads kv head h / (H / Hkv).  Only the first
// kv_valid key rows are attended (a cache filled up to there).  Causal
// masking uses global positions: query row i sits at q_offset + i, key row
// j at kv_offset + j, and row i sees the keys at or before it (cached
// prefill passes q_offset = the cache's length, kv_valid = its new length);
// softcap maps the scaled scores through cap·tanh(s/cap) before masking.
// A sliding window (causal only, the TPU kernel's window/sinks) keeps only
// the last `window` positions at or before a row's, plus the keys at
// positions below `sinks` (StreamingLLM's attention sinks).  Packed-
// sequence segment ids (the TPU kernel's q_seg/kv_seg, one int32 a query
// row and a key row, shared across heads) keep a pair only where they are
// equal, on top of every other mask.
//
// What bounds it on the H100: at the testcase and serving shapes it does
// 2·m·n·(dk + dv) operations on (m + n)·(dk + dv) values, far above the ~295
// operations per byte where a bf16 kernel stops being bound by memory, so it
// is bound by operations: the tensor cores' 989 TFLOP/s in bf16, the CUDA
// cores' 67 TFLOP/s in f32 (f32 must stay full f32, so no TF32).  Everything
// but the inputs and the output stays out of device memory: a CTA holds its
// query rows, walks the key/value rows a tile at a time (the loop that
// replaces the TPU grid's sequential third axis), keeps the running max and
// sum in registers and writes each output row once; under causal masking it
// stops at the block's last row, halving the work, and under a window it
// starts at the block's band after the sink tiles, so the work scales with
// the window (`atk::TileWalk` in the FMA body, `tile_plan` in the wgmma
// one).  Two bodies, named by
// the caller (`ops.flash.flash_body`) and refused here where they do not
// fit: "wgmma" for bf16 at head dims 64/128 with 16-byte aligned bases and
// strides (flash_fwd_sm90.cuh: wgmma products on TMA-fed 128-row tiles,
// masks only where a tile needs them, heaviest-first order on a persistent
// grid and a key split for thin grids; its note says what each does), and
// "fma" for everything else (`atk::attend`, fp32 FMA on the CUDA cores,
// 64-row CTAs).  The online instances live here, each other variant's in
// its own build of flash_fwd_variant.cu (flash_fwd.cuh).
#include "flash_fwd.cuh"

// the other variants' instances, built from flash_fwd_variant.cu
extern template cudaError_t ffwd::run_fma<atk::BOUND>(
    const ffwd::FlashArgs&, int, int, cudaStream_t);
extern template cudaError_t ffwd::run_fma<atk::FLASHD>(
    const ffwd::FlashArgs&, int, int, cudaStream_t);
extern template cudaError_t ffwd::run_fma<atk::AMLA>(
    const ffwd::FlashArgs&, int, int, cudaStream_t);
extern template cudaError_t ffwd::run_wgmma<atk::BOUND>(
    const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
    const sm90::Args&, int, int, cudaStream_t);
extern template cudaError_t ffwd::run_wgmma<atk::FLASHD>(
    const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
    const sm90::Args&, int, int, cudaStream_t);
extern template cudaError_t ffwd::run_wgmma<atk::AMLA>(
    const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
    const sm90::Args&, int, int, cudaStream_t);

namespace {

using ffwd::FlashArgs;

// the wgmma body's tiles come by TMA: bf16, head dims 64/128, 16-byte
// aligned bases, and (batch, head, row) strides that are positive
// multiples of 8 elements (16 bytes)
bool wgmma_ok(const FlashArgs& a) {
  const long long st[12] = {a.sqb, a.sqh, a.sqm, a.skb, a.skh, a.skn,
                            a.svb, a.svh, a.svn, a.sob, a.soh, a.som};
  for (long long x : st)
    if (x <= 0 || x % 8) return false;
  return (a.dk == 64 || a.dk == 128) && (a.dv == 64 || a.dv == 128) &&
         tmap::aligned16(a.q) && tmap::aligned16(a.k) &&
         tmap::aligned16(a.v) && (a.acc != nullptr || tmap::aligned16(a.o));
}

cudaError_t run_wgmma(int variant, const CUtensorMap& tq,
                      const CUtensorMap& tk, const CUtensorMap& tv,
                      const sm90::Args& s, int dk, int B, cudaStream_t st) {
  switch (variant) {
    case atk::ONLINE:
      return ffwd::run_wgmma<atk::ONLINE>(tq, tk, tv, s, dk, B, st);
    case atk::BOUND:
      return ffwd::run_wgmma<atk::BOUND>(tq, tk, tv, s, dk, B, st);
    case atk::FLASHD:
      return ffwd::run_wgmma<atk::FLASHD>(tq, tk, tv, s, dk, B, st);
    case atk::AMLA:
      return ffwd::run_wgmma<atk::AMLA>(tq, tk, tv, s, dk, B, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run_fma(int variant, const FlashArgs& a, int dtype, int B,
                    cudaStream_t s) {
  switch (variant) {
    case atk::ONLINE: return ffwd::run_fma<atk::ONLINE>(a, dtype, B, s);
    case atk::BOUND: return ffwd::run_fma<atk::BOUND>(a, dtype, B, s);
    case atk::FLASHD: return ffwd::run_fma<atk::FLASHD>(a, dtype, B, s);
    case atk::AMLA: return ffwd::run_fma<atk::AMLA>(a, dtype, B, s);
  }
  return cudaErrorInvalidValue;
}

// The wgmma body: the tensor maps of q, k and v, then the kernel of the
// variant over `splits` key splits of split_tiles tiles each (and the
// merge when splits > 1, its scratch in part).
cudaError_t launch_wgmma(const FlashArgs& a, int B, int splits,
                         int split_tiles, float* part, int variant,
                         cudaStream_t st) {
  const tmap::EncodeTiled enc = tmap::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tmap::encode(enc, &tq, a.q, a.dk, a.m, a.H, B, a.sqm, a.sqh, a.sqb,
                    sm90::BM) ||
      !tmap::encode(enc, &tk, a.k, a.dk, a.n, a.Hkv, B, a.skn, a.skh, a.skb,
                    sm90::BN) ||
      !tmap::encode(enc, &tv, a.v, a.dv, a.n, a.Hkv, B, a.svn, a.svh, a.svb,
                    sm90::BN))
    return cudaErrorInvalidValue;
  sm90::Args s;
  s.o = a.o;
  s.acc = a.acc;
  s.row_max = a.row_max;
  s.row_sum = a.row_sum;
  s.part = splits > 1 ? part : nullptr;
  s.B = B;
  s.H = a.H;
  s.Hkv = a.Hkv;
  s.m = a.m;
  s.dv = a.dv;
  s.sob = a.sob;
  s.soh = a.soh;
  s.som = a.som;
  s.qscale = a.qscale;
  s.cap2 = a.cap2;
  s.causal = a.causal;
  s.q_offset = a.q_offset;
  s.kv_offset = a.kv_offset;
  s.kv_valid = a.kv_valid < 0 ? 0 : a.kv_valid > a.n ? a.n : a.kv_valid;
  s.window = a.window;
  s.sinks = a.sinks;
  s.splits = splits;
  s.split_tiles = split_tiles;
  s.q_seg = a.q_seg;
  s.kv_seg = a.kv_seg;
  s.variant = variant;
  s.knmax = a.knmax;
  s.demote = a.demote;
  s.q = static_cast<const __nv_bfloat16*>(a.q);
  s.sqb = a.sqb;
  s.sqh = a.sqh;
  s.sqm = a.sqm;
  s.dk = a.dk;
  cudaError_t err = run_wgmma(variant, tq, tk, tv, s, a.dk, B, st);
  if (err != cudaSuccess || splits == 1) return err;
  const long long bhm = (long long)B * s.H * s.m;
  sm90::flash_merge<<<(unsigned)((bhm + sm90::MERGE_ROWS - 1) /
                                 sm90::MERGE_ROWS),
                      32 * sm90::MERGE_ROWS, 0, st>>>(s, bhm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded through ctypes.  dtype: 0 = fp32, 1 = bf16.
// Strides are in elements, (batch, head, row) for each of q, k, v, o; the
// last dim of every tensor is contiguous.  softcap <= 0 means none;
// kv_valid is cut to n.  With acc non-null the kernel writes partials
// instead of o: acc (fp32, o's strides), row_max and row_sum ((B, H, m)
// fp32, contiguous); a row that sees no key gets max -inf and sum 0.
// window > 0 (causal only) keeps, of the keys at or before a row's
// position p, those after p - window and those at positions below sinks
// (window 0: no band, sinks 0: none); the bodies walk only the tiles the
// band and the sinks hold.
// body: 0 = "fma", 1 = "wgmma" (the caller's `flash_body`); a body that
// cannot take the call is refused, never replaced.  The wgmma body cuts
// each row block's key tiles into splits of split_tiles tiles (splits 1:
// no cut) and merges them through part, splits·B·H·m·(dv + 2) floats.
// q_seg and kv_seg, both set or both null, are int32 segment ids of the
// query rows (m) and the key rows (n, padded with ids no row holds to a
// whole number of 128-key tiles, and 16-byte aligned, for the wgmma
// body's bulk copies); a pair is kept only where they are equal.
// variant: the max mode, 0 = online, 1 = bound (knmax: (B, Hkv) fp32
// largest key norms, demote: the guard's int32 verdict, both on the
// device; non-zero runs the online body), 2 = FLASH-D, 3 = AMLA; the
// wgmma body has the instances `ffwd::wgmma_instance` names and refuses
// the others.  A row that sees no key gets sum 0 (and max -inf, except
// under bound: its bound).
// Returns cudaGetLastError() after the launches (or the refusal).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int dtype, int B, int H, int Hkv, int m, int n,
                         int dk, int dv, long long sqb, long long sqh,
                         long long sqm, long long skb, long long skh,
                         long long skn, long long svb, long long svh,
                         long long svn, long long sob, long long soh,
                         long long som, float scale, float softcap,
                         int causal, int q_offset, int kv_offset,
                         int kv_valid, int window, int sinks, float* acc,
                         float* row_max,
                         float* row_sum, int body, int splits,
                         int split_tiles, float* part, const void* q_seg,
                         const void* kv_seg, int variant, const void* knmax,
                         const void* demote, void* stream) {
  if (dk < 1 || dv < 1 || dk > atk::MAX_HEAD_DIM || dv > atk::MAX_HEAD_DIM ||
      H % Hkv != 0 || m < 1 || n < 1 || splits < 1 || window < 0 ||
      sinks < 0 || (window > 0 && !causal) || (sinks > 0 && window == 0) ||
      (q_seg == nullptr) != (kv_seg == nullptr) || variant < atk::ONLINE ||
      variant > atk::AMLA ||
      (variant == atk::BOUND && (knmax == nullptr || demote == nullptr)))
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{q,   k,   v,   o,   acc, row_max, row_sum, H,
                    Hkv, m,   n,   dk,  dv,  sqb,     sqh,     sqm,
                    skb, skh, skn, svb, svh, svn,     sob,     soh,
                    som, scale * atk::LOG2E,
                    softcap > 0.f ? softcap * atk::LOG2E : 0.f, causal,
                    q_offset, kv_offset, kv_valid, window, sinks,
                    static_cast<const int*>(q_seg),
                    static_cast<const int*>(kv_seg),
                    static_cast<const float*>(knmax),
                    static_cast<const int*>(demote)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || !wgmma_ok(a) || split_tiles < 1 ||
        (splits > 1 && part == nullptr) ||
        (kv_seg != nullptr && !tmap::aligned16(kv_seg)) ||
        !ffwd::wgmma_instance(variant, dk, dv, q_seg != nullptr))
      return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(a, B, splits, split_tiles, part, variant, s);
  }
  if (body != 0 || splits != 1) return (int)cudaErrorInvalidValue;
  return (int)run_fma(variant, a, dtype, B, s);
}
