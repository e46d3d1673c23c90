// Ragged paged attention for Hopper (sm_90a): one wrapper call per serving
// step.
//
// Replaces the TPU kernel `_ragged_kernel`
// (attention_tpu/ops/ragged_paged.py:201), its max modes online, FLASH-D
// and AMLA (the call's `variant`: the online instances here, the others'
// in builds of ragged_paged_variant.cu over ragged_paged.cuh).  Every real
// token of a mixed decode/prefill step sits on one packed axis of q
// (1, Hq, T, d); slot s owns tokens [cu_q_lens[s], cu_q_lens[s+1]) and reads
// its kv_lens[s] (post-append) cache rows through page_table row s of the
// (P, Hkv, page, d) pools, in place.  Causal within the request: the token at
// span offset t sees positions <= kv_len - q_len + t, and under a sliding
// window only the last `window` of them plus the first `sinks` (the TPU
// kernel's per-row band, attention_tpu/ops/ragged_paged.py:255-259; here
// each body's walk starts at its rows' band, so the pages read scale with
// the window).  Slots at or beyond
// distribution[1], and slots with q_len == 0, write nothing, and every token
// no live slot owns (pad) comes out zero; a slot with kv_len < 0 (poisoned
// by the append) writes NaN on its rows.  A -1 table entry below the length
// reads page 0, as the TPU kernel's clamp did.
//
// What bounds it on the H100.  A decode slot (one token, or a few, per
// request) does 4·group·kv_len·d operations on 2·kv_len·d cache values,
// about 2 operations per byte at group 8: it is bound by the bytes of its
// pages (3.35 TB/s), and one CTA per (slot, kv head) walking its whole
// cache would keep 32 of 132 SMs busy at the serving geometry.  A prefill
// chunk of c tokens does c times as many operations per byte, far above
// the ~295 where bf16 stops being bound by memory: it is bound by the
// tensor cores.  The slots are told apart on the device, so that the host
// never reads a length (a read there would cost a sync per layer per
// step): a slot whose q_len·group rows fit one 16-row tile (`smax` tokens,
// DECODE_ROWS / group; the engine's decode slots) is a decode slot, any
// other live slot a prefill slot.  Three launches, on the same stream:
//
// 1. Decode slots split their keys across CTAs, on the decode kernels'
//    rows (decode_rows.cuh, through `RaggedSource`: the paged source with
//    each slot's span read from cu_q_lens): grid (1, slots·Hkv, splits),
//    the split sized on the host from the table's capacity
//    (`ops.decode.split_plan`), four warps on one 16-row tile (KG = 4) in
//    bf16 at head dims 64/128, fp32 partials into scratch the wrapper
//    allocates.  CTAs of prefill slots and dead slots exit at once.
// 2. Prefill slots run one of three bodies, named by the caller
//    (`ops.ragged_paged.ragged_body`) and refused here where they do not
//    fit:
//    - "wgmma" (bf16, head dims 64/128, a GQA group dividing 128, pages of
//      a multiple of 128 rows or of 8–64 rows): the flash forward's body
//      (flash_fwd_sm90.cuh) under `RaggedSched`.  A work item is 128 rows
//      of one (slot, kv head): 128 / group tokens times the group's query
//      heads, row = token·group + head, so one K/V tile feeds the whole
//      group and the pages are read once per kv head and row block.  Q
//      comes by TMA as one box of (64 columns, group heads, 128 / group
//      tokens); each 128-key tile of K and V as boxes of the 4-D pool map
//      (d, page row, kv head, page) at the page the table names, translated
//      on the device by the producer thread.  Tiles past the block's causal
//      end are never loaded, and only the tiles from the first one that can
//      hold a masked key test the mask; softcap takes a tanh of two MUFU
//      instructions (`RaggedSched::softcap`), half the time of `tanhf`
//      on a tile.  A persistent grid walks the items, each slot's last
//      (heaviest) block first.
//    - "mma" (bf16 at head dims 64/128 whose operands the TMA maps cannot
//      take) and "fma" (f32, other head dims): `ragged_paged_kernel`, 64
//      rows a CTA head-major (row = head·q_len + token), `atk::attend_mma`
//      or `atk::attend`, grid (⌈q_tile·group / 64⌉, slots·Hkv) striding
//      over a longer span.
// 3. `ragged_finish`, a warp a (token, head): zeros where no live slot
//    owns the token, the decode slots' partials merged in split order
//    where they split (NaN rows for a poisoned one), nothing elsewhere.
//    So the output needs no zero fill first, and no atomics are used: a
//    second call gives the same bits.
#include "ragged_paged.cuh"

// the other variants' instances, built from ragged_paged_variant.cu
extern template cudaError_t rpa::run_slots<atk::FLASHD>(
    const rpa::RaggedArgs&, const atk::DecodeArgs&, const rpa::RaggedSource&,
    bool, int, int, int, int, int, int, int, cudaStream_t);
extern template cudaError_t rpa::run_slots<atk::AMLA>(
    const rpa::RaggedArgs&, const atk::DecodeArgs&, const rpa::RaggedSource&,
    bool, int, int, int, int, int, int, int, cudaStream_t);

namespace {

using rpa::DECODE_ROWS;
using rpa::RaggedArgs;
using rpa::RaggedSource;
using rpa::mma_ok;
using rpa::wgmma_ok;

// ------------------------------------------------------------- the finish

struct FinishArgs {
  void* o;
  long long soh, sot;
  const int* cu;
  const int* dist;
  const int* lens;
  const float* part_acc;  // (slots, Hq, smax, splits, dv)
  const float* part_m;    // (slots, Hq, smax, splits), natural log
  const float* part_l;
  int Hq, slots, smax, splits, dv;
};

constexpr int FINISH_WARPS = 8;  // heads of a token a CTA finishes

// CTA (t, j) finishes heads 8j .. 8j + 7 of token t, a warp a head: zeros
// where no live slot owns the token; a decode slot's partials merged in
// split order, as `atk::merge_splits` merges them (a split that saw
// nothing weighs 0 and is skipped, a NaN sum stays NaN, nothing seen gives
// zeros), or NaN rows for a poisoned slot; nothing for a prefill slot's
// token or an unsplit decode slot's, which their kernels wrote.  A warp
// reads the live slots' span ends at once, a lane a slot; its split
// weights go through shared memory (splits floats a warp), and each lane
// sums its (up to 8) columns over the splits together.
template <typename T>
__global__ void __launch_bounds__(32 * FINISH_WARPS)
    ragged_finish(FinishArgs f) {
  extern __shared__ float wts[];
  const int t = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y * FINISH_WARPS + warp;
  if (h >= f.Hq) return;
  const int live = max(min(f.dist[1], f.slots), 0);
  // the owner of token t is the number of live slots that end at or
  // before it (cu_q_lens does not decrease), `live` for none
  int s = 0;
  for (int i0 = 0; i0 < live; i0 += 32) {
    const int i = i0 + lane;
    s += __popc(__ballot_sync(0xffffffffu, i < live && f.cu[i + 1] <= t));
  }
  T* o = static_cast<T*>(f.o) + (long long)t * f.sot + h * f.soh;
  if (s == live) {
    for (int c = lane; c < f.dv; c += 32) o[c] = atk::from_f<T>(0.f);
    return;
  }
  const int tok0 = f.cu[s];
  if (f.cu[s + 1] - tok0 > f.smax || f.splits == 1) return;
  if (f.lens[s] < 0) {
    for (int c = lane; c < f.dv; c += 32) o[c] = atk::from_f<T>(NAN);
    return;
  }
  const int n = f.splits;
  const long long row = ((long long)s * f.Hq + h) * f.smax + t - tok0;
  const float* pm = f.part_m + row * n;
  const float* pl = f.part_l + row * n;
  float* w = wts + warp * n;
  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, pm[i]);
#pragma unroll
  for (int x = 16; x > 0; x /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float wi = pm[i] == -INFINITY ? 0.f : expf(pm[i] - mx);
    w[i] = wi;
    sum += pl[i] * wi;
  }
#pragma unroll
  for (int x = 16; x > 0; x /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, x);
  __syncwarp();
  constexpr int CW = atk::MAX_HEAD_DIM / 32;  // columns of a lane
  float x[CW];
#pragma unroll
  for (int q = 0; q < CW; ++q) x[q] = 0.f;
  const float* acc = f.part_acc + row * n * f.dv;
  for (int i = 0; i < n; ++i) {
    const float wi = w[i];
    if (wi == 0.f) continue;
    const float* src = acc + (long long)i * f.dv;
#pragma unroll
    for (int q = 0; q < CW; ++q)
      if (lane + 32 * q < f.dv) x[q] += wi * src[lane + 32 * q];
  }
#pragma unroll
  for (int q = 0; q < CW; ++q)
    if (lane + 32 * q < f.dv)
      o[lane + 32 * q] = atk::from_f<T>(sum == 0.f ? 0.f : x[q] / sum);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  dtype: 0 = fp32, 1 = bf16.
// q and o are (1, Hq, T, d) with element strides (head, token) and a
// contiguous last dim; the pools are contiguous (pages, Hkv, page, d); the
// four index arrays are contiguous int32 on the device.  smax: the most
// tokens of a decode slot (DECODE_ROWS / group, 0 for none); splits and
// chunk cut the decode slots' keys (`ops.decode.split_plan`), their
// partials going through part, slots·Hq·smax·splits·(dv + 2) floats (null
// for one split).  body: the prefill slots' body, 0 = "fma", 1 = "mma",
// 2 = "wgmma" (the caller's `ragged_body`); a body that cannot take the
// call is refused, never replaced.  grid: the wgmma body's persistent
// grid; q_tile sizes the other bodies' grid (the longest span they cover
// in parallel).  softcap <= 0 means none.  window > 0 keeps, of the
// keys at or before a token's position p, those after p - window and the
// first `sinks` (window 0: no band, sinks 0: none); every body walks only
// the tiles the band and the sinks hold.  variant: the max mode, 0 =
// online, 2 = FLASH-D, 3 = AMLA, in the decode slots, the prefill slots
// and the finish's merge alike (the variants' mma and wgmma instances take
// dk == dv).  Returns cudaGetLastError() after the launches (or the
// refusal).
extern "C" int ragged_paged_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_lens, const void* cu_q_lens,
    const void* distribution, void* o, void* part, int dtype, int Hq,
    int Hkv, int slots, int T, int pages, int max_pages, int page, int dk,
    int dv, int q_tile, long long sqh, long long sqt, long long soh,
    long long sot, float scale, float softcap, int window, int sinks,
    int body, int smax, int splits, int chunk, int grid, int variant,
    void* stream) {
  if (dk < 1 || dv < 1 || dk > atk::MAX_HEAD_DIM || dv > atk::MAX_HEAD_DIM ||
      Hkv < 1 || Hq % Hkv != 0 || slots < 1 || T < 1 || pages < 1 ||
      max_pages < 1 || page < 1 || q_tile < 1 || smax < 0 ||
      smax * (Hq / Hkv) > DECODE_ROWS || (dtype != 0 && dtype != 1) ||
      (splits > 1 && part == nullptr) || window < 0 || sinks < 0 ||
      (sinks > 0 && window == 0) ||
      (variant != atk::ONLINE && variant != atk::FLASHD &&
       variant != atk::AMLA))
    return (int)cudaErrorInvalidValue;
  const RaggedArgs a{q, k_pool, v_pool,
                     static_cast<const int*>(page_table),
                     static_cast<const int*>(kv_lens),
                     static_cast<const int*>(cu_q_lens),
                     static_cast<const int*>(distribution),
                     o, Hq, Hkv, max_pages, page, dk, dv, sqh, sqt, soh, sot,
                     scale * atk::LOG2E,
                     softcap > 0.f ? softcap * atk::LOG2E : 0.f, smax,
                     window, sinks};
  const bool dims = variant == atk::ONLINE || dk == dv;
  const bool fits = body == 2   ? dtype == 1 && wgmma_ok(a) && grid >= 1 &&
                                    dims
                    : body == 1 ? dtype == 1 && mma_ok(a) && dims
                                : body == 0;
  if (!fits) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // 1. decode slots (d.S = 0: none) and 2. prefill slots
  atk::DecodeArgs d{};
  const RaggedSource src{{k_pool, v_pool, a.page_table, max_pages, Hkv,
                          page, dk, dv},
                         a.cu_q_lens, a.distribution, sqt, sot};
  bool rows_ok = false;
  if (smax > 0) {
    d.q = q;
    d.o = o;
    d.lens = a.kv_lens;
    d.H = Hq;
    d.Hkv = Hkv;
    d.S = smax;
    d.dk = dk;
    d.dv = dv;
    d.n_cap = max_pages * page;
    d.sqh = sqh;
    d.sqs = sqt;
    d.soh = soh;
    d.sos = sot;
    d.qscale = a.qscale;
    d.cap2 = a.cap2;
    d.window = window;
    d.sinks = sinks;
    d.poison = 1;
    d.no_merge = 1;
    atk::set_splits(d, slots, splits, chunk, part);
    rows_ok = atk::rows_aligned(d) && atk::aligned16(k_pool) &&
              atk::aligned16(v_pool);
  }
  cudaError_t err;
  switch (variant) {
    case atk::FLASHD:
      err = rpa::run_slots<atk::FLASHD>(a, d, src, rows_ok, body, dtype,
                                        slots, T, pages, q_tile, grid, st);
      break;
    case atk::AMLA:
      err = rpa::run_slots<atk::AMLA>(a, d, src, rows_ok, body, dtype, slots,
                                      T, pages, q_tile, grid, st);
      break;
    default:
      err = rpa::run_slots<atk::ONLINE>(a, d, src, rows_ok, body, dtype,
                                        slots, T, pages, q_tile, grid, st);
  }
  if (err != cudaSuccess) return (int)err;

  // 3. pad rows and the decode slots' merge
  const FinishArgs f{o, soh, sot, a.cu_q_lens, a.distribution, a.kv_lens,
                     d.part_acc, d.part_m, d.part_l, Hq, slots, smax,
                     smax > 0 ? splits : 1, dv};
  const dim3 grid_f(T, (Hq + FINISH_WARPS - 1) / FINISH_WARPS);
  const size_t smem_f = FINISH_WARPS * f.splits * sizeof(float);
  if (dtype == 0)
    ragged_finish<float><<<grid_f, 32 * FINISH_WARPS, smem_f, st>>>(f);
  else
    ragged_finish<__nv_bfloat16>
        <<<grid_f, 32 * FINISH_WARPS, smem_f, st>>>(f);
  return (int)cudaGetLastError();
}
