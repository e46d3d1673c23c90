// Ragged paged attention for Hopper (sm_90a): one wrapper call per serving
// step.
//
// Replaces the TPU kernel `_ragged_kernel`
// (attention_tpu/ops/ragged_paged.py:201), online max mode.  Every real
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
#include "decode_rows.cuh"
#include "flash_fwd_sm90.cuh"
#include "tensor_map.cuh"

namespace {

using atk::BM;
using atk::THREADS;

// rows of the tile a decode slot's CTA holds (the KG = 4 tile)
constexpr int DECODE_ROWS = 16;

// ------------------------------------------------- the mma.sync / FMA body

template <typename T>
struct RaggedProblem : atk::ProblemBase {
  const T* q;       // at (head kvh*group, token cu[s])
  T* o;             // same for the output
  long long sqh, sqt, soh, sot;
  const T* kp;      // pool base
  const T* vp;
  const int* table; // page-table row of this slot
  int kvh, Hkv, page, dk, dv;
  int r0, rows, q_len, kv_len, n_end, window, sinks;

  __device__ const T* q_row(int r) const {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int g = rr / q_len;
    return q + g * sqh + (rr - g * q_len) * sqt;
  }
  __device__ T* o_row(int r) const {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int g = rr / q_len;
    return o + g * soh + (rr - g * q_len) * sot;
  }
  __device__ long long cache_row(int c) const {
    const int phys = max(table[c / page], 0);
    return (((long long)phys * Hkv + kvh) * page + c % page);
  }
  __device__ const T* k_row(int c) const { return kp + cache_row(c) * dk; }
  __device__ const T* v_row(int c) const { return vp + cache_row(c) * dv; }
  __device__ bool keep(int r, int c) const {
    const int rr = r0 + r;
    if (rr >= rows) return false;
    const int pos = kv_len - q_len + rr % q_len;
    return c <= pos && (window == 0 || c > pos - window || c < sinks);
  }
};

struct RaggedArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;
  const int* kv_lens;
  const int* cu_q_lens;
  const int* distribution;
  void* o;
  int Hq, Hkv, max_pages, page, dk, dv;
  long long sqh, sqt, soh, sot;  // element strides (head, token) of q, o
  float qscale, cap2;
  int smax;  // a slot of at most smax tokens is a decode slot
  int window, sinks;  // the band (window 0: none)
};

// NJ > 0: the fp32 FMA tile loop; NJ == 0: the bf16 tensor-core loop at
// head dims (DK, DV).  Prefill slots only.
template <typename T, int NJ, int DK, int DV>
__global__ void __launch_bounds__(THREADS) ragged_paged_kernel(RaggedArgs a) {
  const int s = blockIdx.y / a.Hkv;
  const int kvh = blockIdx.y - s * a.Hkv;
  if (s >= a.distribution[1]) return;
  const int tok0 = a.cu_q_lens[s];
  const int q_len = a.cu_q_lens[s + 1] - tok0;
  if (q_len <= a.smax) return;  // a decode slot, or no tokens
  const int group = a.Hq / a.Hkv;
  const int rows = q_len * group;

  RaggedProblem<T> pb;
  pb.q = static_cast<const T*>(a.q) + (long long)kvh * group * a.sqh +
         tok0 * a.sqt;
  pb.o = static_cast<T*>(a.o) + (long long)kvh * group * a.soh + tok0 * a.sot;
  pb.sqh = a.sqh;
  pb.sqt = a.sqt;
  pb.soh = a.soh;
  pb.sot = a.sot;
  pb.rows = rows;
  pb.q_len = q_len;
  pb.kp = static_cast<const T*>(a.k_pool);
  pb.vp = static_cast<const T*>(a.v_pool);
  pb.table = a.page_table + (long long)s * a.max_pages;
  pb.kvh = kvh;
  pb.Hkv = a.Hkv;
  pb.page = a.page;
  pb.dk = a.dk;
  pb.dv = a.dv;
  pb.window = a.window;
  pb.sinks = a.sinks;
  const int raw_len = a.kv_lens[s];
  pb.kv_len = raw_len;
  const int n_cap = a.max_pages * a.page;

  // the grid is sized for q_tile tokens; a longer span is still covered
  // in full, by striding the row blocks
  for (int r0 = blockIdx.x * BM; r0 < rows; r0 += gridDim.x * BM) {
    pb.r0 = r0;
    if (raw_len < 0) {
      // poisoned slot (a bad append): NaN on every row it owns, loudly
      for (int idx = threadIdx.x; idx < BM * a.dv; idx += THREADS) {
        const int r = idx / a.dv;
        T* dst = pb.o_row(r);
        if (dst) dst[idx - r * a.dv] = atk::from_f<T>(NAN);
      }
      continue;
    }
    // causal end of this block: the latest span offset among its rows
    const int r_last = min(r0 + BM, rows) - 1;
    const int t_max =
        (r0 / q_len == r_last / q_len) ? r_last % q_len : q_len - 1;
    pb.n_end = min(min(raw_len, raw_len - q_len + t_max + 1), n_cap);
    if (a.window > 0) {
      // the walk starts at the band of the block's earliest token, after
      // the sink tiles
      const int t_min = (r0 / q_len == r_last / q_len) ? r0 % q_len : 0;
      pb.kv_begin = max(0, raw_len - q_len + t_min - a.window + 1);
      pb.sink_end = a.sinks;
    }
    if constexpr (NJ > 0)
      atk::attend<T, NJ>(pb, a.dk, a.dv, a.qscale, a.cap2);
    else
      atk::attend_mma<DK, DV>(pb, a.qscale, a.cap2);
    __syncthreads();  // the next block rewrites the shared tiles
  }
}

template <typename T, int NJ, int DK = 0, int DV = 0>
cudaError_t launch(const RaggedArgs& a, int slots, int q_tile,
                   cudaStream_t stream) {
  auto kernel = ragged_paged_kernel<T, NJ, DK, DV>;
  const size_t smem = NJ > 0 ? atk::smem_bytes(a.dk, a.dv)
                             : atk::smem_bytes_mma(a.dk, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int group = a.Hq / a.Hkv;
  const dim3 grid((q_tile * group + BM - 1) / BM, slots * a.Hkv);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const RaggedArgs& a, int slots, int q_tile,
                       cudaStream_t s) {
  if (a.dv <= 32) return launch<T, 4>(a, slots, q_tile, s);
  if (a.dv <= 64) return launch<T, 8>(a, slots, q_tile, s);
  if (a.dv <= 128) return launch<T, 16>(a, slots, q_tile, s);
  return launch<T, 32>(a, slots, q_tile, s);
}

cudaError_t launch_mma(const RaggedArgs& a, int slots, int q_tile,
                       cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (a.dk == 64 && a.dv == 64)
    return launch<bf16, 0, 64, 64>(a, slots, q_tile, s);
  if (a.dk == 64 && a.dv == 128)
    return launch<bf16, 0, 64, 128>(a, slots, q_tile, s);
  if (a.dk == 128 && a.dv == 64)
    return launch<bf16, 0, 128, 64>(a, slots, q_tile, s);
  return launch<bf16, 0, 128, 128>(a, slots, q_tile, s);
}

// the tensor-core loops read 16-byte row chunks: head dims 64/128 (the
// pools' rows then stay 16-byte aligned), 16-byte aligned q/o/pool bases
// and q/o strides that are multiples of 8 elements
bool mma_ok(const RaggedArgs& a) {
  return (a.dk == 64 || a.dk == 128) && (a.dv == 64 || a.dv == 128) &&
         a.sqh % 8 == 0 && a.sqt % 8 == 0 && a.soh % 8 == 0 &&
         a.sot % 8 == 0 && atk::aligned16(a.q) && atk::aligned16(a.o) &&
         atk::aligned16(a.k_pool) && atk::aligned16(a.v_pool);
}

// ------------------------------------------------------------ decode slots

// The paged source with each slot's span: slot b's tokens from
// cu_q_lens, live only for a decode slot (1 to a.S tokens, a.S = smax)
// below distribution[1].
struct RaggedSource : atk::PagedSource {
  using Spans = void;
  const int* cu;
  const int* dist;
  long long sqt, sot;

  __device__ atk::Span span(int b, const atk::DecodeArgs& a) const {
    const int tok0 = cu[b];
    const int n = cu[b + 1] - tok0;
    return {tok0 * sqt, tok0 * sot, n, b < dist[1] && n >= 1 && n <= a.S};
  }
};

// ------------------------------------------------------- the wgmma body

// The wgmma body's work: 128-row blocks of each (prefill slot, kv head),
// rows token-major (row = token·group + head of the group).
struct RaggedSched {
  __nv_bfloat16* o;
  long long soh, sot;
  const int* table;
  const int* lens;
  const int* cu;
  const int* dist;
  int slots, Hkv, group, max_pages, page, box_rows, dv, smax, n_cap;
  int window, sinks;
  float qs, c2;

  struct Work {
    int s, kvh, m0, tok0, q_len, len;
    sm90::TilePlan plan;
  };

  __device__ float qscale() const { return qs; }
  __device__ float cap2() const { return c2; }
  // cap2·tanh(x / cap2) as cap2·(1 - 2 / (e^(2|x| / cap2) + 1)) with the
  // sign of x: two MUFU instructions (ex2, rcp) and a few FMAs where tanhf
  // takes a branch and a longer sequence, which halves a softcapped
  // tile's time (PERF.md).  Within 1.2e-7 of tanh, so within 1e-5 on a
  // score after the cap (softcap 50); inference only, since no backward
  // recomputes these scores.
  __device__ static float softcap(float x, float cap2) {
    const float e = sm90::ex2(fabsf(x) * (2.f * atk::LOG2E / cap2));
    return copysignf(cap2 * (1.f - __fdividef(2.f, e + 1.f)), x);
  }
  // row blocks of slot s: none for a decode slot or an empty one
  __device__ int blocks(int s) const {
    const int q_len = cu[s + 1] - cu[s];
    return q_len > smax ? (q_len * group + sm90::BM - 1) / sm90::BM : 0;
  }
  __device__ int live_slots() const { return max(min(dist[1], slots), 0); }
  __device__ long long total() const {
    long long n = 0;
    const int live = live_slots();
    for (int s = 0; s < live; ++s) n += blocks(s);
    return n * Hkv;
  }

  // Work item w: the kv head varies fastest, then the slot's row blocks
  // from its last (the most keys) to its first, then the slot.
  __device__ Work item(long long w) const {
    using sm90::BN;
    Work k;
    k.kvh = (int)(w % Hkv);
    int u = (int)(w / Hkv);
    int s = 0;
    int nb = blocks(0);
    while (u >= nb) {
      u -= nb;
      nb = blocks(++s);
    }
    k.s = s;
    k.m0 = (nb - 1 - u) * sm90::BM;
    k.tok0 = cu[s];
    k.q_len = cu[s + 1] - k.tok0;
    k.len = lens[s];
    // tokens t_lo .. t_hi of the span, at positions p_lo .. p_hi: the last
    // one's causal end bounds the tiles, the first one's the tiles that
    // need no causal mask; with a band the first one's band start is where
    // the walk starts after the sink tiles, the last one's where the tiles
    // that need no band mask start
    const int len = min(k.len, n_cap);
    const int t_lo = k.m0 / group;
    const int t_hi = (min(k.m0 + sm90::BM, k.q_len * group) - 1) / group;
    const int p_lo = k.len - k.q_len + t_lo;
    const int p_hi = k.len - k.q_len + t_hi;
    const int n_end = k.len < 0 ? 0 : max(0, min(len, p_hi + 1));
    const int mask = max(0, min(len / BN, sm90::floor_div(p_lo + 1, BN)));
    const bool on = window > 0;
    k.plan = sm90::plan_tiles(n_end, mask, on ? max(0, p_lo - window + 1) : 0,
                              on ? max(0, p_hi - window + 1) : 0,
                              on ? sinks : 0, 0, 1 << 30);
    return k;
  }

  template <int DK>
  __device__ void load_q(uint32_t dst, const CUtensorMap* tq, uint32_t bar,
                         const Work& k) const {
    for (int c = 0; c < DK / sm90::BOX; ++c)
      sm90::tma_load(dst + c * sm90::BOX_BYTES, tq, bar, c * sm90::BOX, 0,
                     k.tok0 + k.m0 / group, k.kvh);
  }

  // key tile t: the boxes of box_rows rows that make up its 128 keys, each
  // from the page the slot's table names for it
  template <int D>
  __device__ void load_kv(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                          const Work& k, int t) const {
    const int* row = table + (long long)k.s * max_pages;
    for (int p = 0; p < sm90::BN / box_rows; ++p) {
      const int key = t * sm90::BN + p * box_rows;
      const int j = key / page;
      const int phys = j < max_pages ? max(row[j], 0) : 0;
      for (int c = 0; c < D / sm90::BOX; ++c)
        sm90::tma_load(dst + c * sm90::BOX_BYTES + p * box_rows * 128, map,
                       bar, c * sm90::BOX, key - j * page, k.kvh, phys);
    }
  }

  // row r (token r / group of the block) keeps the keys at or before its
  // position kv_len - q_len + token
  __device__ void limits(const Work& k, int rl, int (&lim)[2]) const {
    const int len = min(k.len, n_cap);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = min(len, k.len - k.q_len + (k.m0 + rl + 8 * i) / group + 1);
  }

  // and, with a band, the keys from its position - window + 1 on, and the
  // sinks
  __device__ sm90::Band band(const Work& k, int rl) const {
    sm90::Band b;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      b.lo[i] = window > 0 ? k.len - k.q_len + (k.m0 + rl + 8 * i) / group -
                                 window + 1
                           : sm90::NO_BAND;
    b.sink = window > 0 ? sinks : 0;
    return b;
  }

  __device__ __nv_bfloat16* out_row(const Work& k, int row) const {
    const int t = row / group;
    return o + (long long)(k.kvh * group + row - t * group) * soh +
           (long long)(k.tok0 + t) * sot;
  }

  // a block that sees no key: NaN rows for a poisoned slot, else zeros
  __device__ void store_empty(const Work& k, int first, int count) const {
    const int rows = k.q_len * group;
    const __nv_bfloat16 x = __float2bfloat16(k.len < 0 ? NAN : 0.f);
    for (int idx = threadIdx.x - first; idx < sm90::BM * dv; idx += count) {
      const int r = idx / dv;
      const int row = k.m0 + r;
      if (row < rows) out_row(k, row)[idx - r * dv] = x;
    }
  }

  template <int DV>
  __device__ void store(const Work& k, int rl, const float (&acc)[DV / 2],
                        const float (&mrow)[2], const float (&lrow)[2],
                        int lane) const {
    const int rows = k.q_len * group;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k.m0 + rl + 8 * r;
      if (row < rows)
        sm90::store_bf16_row<DV>(out_row(k, row), acc, r, lrow[r],
                                 2 * (lane & 3));
    }
  }
};

template <int DK, int DV, bool CAP>
cudaError_t launch_wgmma_t(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, const RaggedSched& sc,
                           int grid, cudaStream_t stream) {
  auto kernel = sm90::flash_fwd_wgmma<DK, DV, CAP, RaggedSched>;
  constexpr size_t smem = sm90::smem_bytes(DK, DV);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, sm90::THREADS, smem, stream>>>(tq, tk, tv, sc);
  return cudaGetLastError();
}

template <bool CAP>
cudaError_t launch_wgmma_cap(const CUtensorMap& tq, const CUtensorMap& tk,
                             const CUtensorMap& tv, const RaggedSched& sc,
                             int dk, int grid, cudaStream_t st) {
  if (dk == 64 && sc.dv == 64)
    return launch_wgmma_t<64, 64, CAP>(tq, tk, tv, sc, grid, st);
  if (dk == 64)
    return launch_wgmma_t<64, 128, CAP>(tq, tk, tv, sc, grid, st);
  if (sc.dv == 64)
    return launch_wgmma_t<128, 64, CAP>(tq, tk, tv, sc, grid, st);
  return launch_wgmma_t<128, 128, CAP>(tq, tk, tv, sc, grid, st);
}

// what the TMA maps take: bf16 at head dims 64/128, a group dividing 128
// (a Q box of whole tokens), pages of a multiple of 128 rows or of 8 to 64
// rows dividing 128 (whole boxes of 1024-byte aligned rows), 16-byte
// aligned bases and strides of positive multiples of 8 elements
bool wgmma_ok(const RaggedArgs& a) {
  const int group = a.Hq / a.Hkv;
  const long long st[4] = {a.sqh, a.sqt, a.soh, a.sot};
  for (long long x : st)
    if (x <= 0 || x % 8) return false;
  return mma_ok(a) && group <= sm90::BM && sm90::BM % group == 0 &&
         (a.page % sm90::BN == 0 ||
          (a.page >= 8 && sm90::BN % a.page == 0));
}

// The wgmma body over `pages` pool pages: the tensor maps of q and the
// pools, then the persistent kernel on `grid` CTAs.
cudaError_t launch_wgmma(const RaggedArgs& a, int slots, int T, int pages,
                         int grid, cudaStream_t st) {
  const tmap::EncodeTiled enc = tmap::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int group = a.Hq / a.Hkv;
  const int box_rows = a.page < sm90::BN ? a.page : sm90::BN;
  const long long plane = (long long)a.Hkv * a.page;  // rows of a page
  CUtensorMap tq, tk, tv;
  // q as (d, group, T, Hkv): a box is 128 / group tokens of the group's
  // heads, token-major; the pools as (d, page row, kv head, page)
  if (!tmap::encode(enc, &tq, a.q, a.dk, group, T, a.Hkv, a.sqh, a.sqt,
                    group * a.sqh, group, sm90::BM / group) ||
      !tmap::encode(enc, &tk, a.k_pool, a.dk, a.page, a.Hkv, pages, a.dk,
                    (long long)a.page * a.dk, plane * a.dk, box_rows) ||
      !tmap::encode(enc, &tv, a.v_pool, a.dv, a.page, a.Hkv, pages, a.dv,
                    (long long)a.page * a.dv, plane * a.dv, box_rows))
    return cudaErrorInvalidValue;
  RaggedSched sc;
  sc.o = static_cast<__nv_bfloat16*>(a.o);
  sc.soh = a.soh;
  sc.sot = a.sot;
  sc.table = a.page_table;
  sc.lens = a.kv_lens;
  sc.cu = a.cu_q_lens;
  sc.dist = a.distribution;
  sc.slots = slots;
  sc.Hkv = a.Hkv;
  sc.group = group;
  sc.max_pages = a.max_pages;
  sc.page = a.page;
  sc.box_rows = box_rows;
  sc.dv = a.dv;
  sc.smax = a.smax;
  sc.n_cap = a.max_pages * a.page;
  sc.window = a.window;
  sc.sinks = a.sinks;
  sc.qs = a.qscale;
  sc.c2 = a.cap2;
  return a.cap2 > 0.f
             ? launch_wgmma_cap<true>(tq, tk, tv, sc, a.dk, grid, st)
             : launch_wgmma_cap<false>(tq, tk, tv, sc, a.dk, grid, st);
}

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
// the tiles the band and the sinks hold.  Returns cudaGetLastError()
// after the launches (or the refusal).
extern "C" int ragged_paged_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_lens, const void* cu_q_lens,
    const void* distribution, void* o, void* part, int dtype, int Hq,
    int Hkv, int slots, int T, int pages, int max_pages, int page, int dk,
    int dv, int q_tile, long long sqh, long long sqt, long long soh,
    long long sot, float scale, float softcap, int window, int sinks,
    int body, int smax, int splits, int chunk, int grid, void* stream) {
  if (dk < 1 || dv < 1 || dk > atk::MAX_HEAD_DIM || dv > atk::MAX_HEAD_DIM ||
      Hkv < 1 || Hq % Hkv != 0 || slots < 1 || T < 1 || pages < 1 ||
      max_pages < 1 || page < 1 || q_tile < 1 || smax < 0 ||
      smax * (Hq / Hkv) > DECODE_ROWS || (dtype != 0 && dtype != 1) ||
      (splits > 1 && part == nullptr) || window < 0 || sinks < 0 ||
      (sinks > 0 && window == 0))
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
  const bool fits = body == 2   ? dtype == 1 && wgmma_ok(a) && grid >= 1
                    : body == 1 ? dtype == 1 && mma_ok(a)
                                : body == 0;
  if (!fits) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // 1. decode slots
  atk::DecodeArgs d{};
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
    const RaggedSource src{{k_pool, v_pool, a.page_table, max_pages, Hkv,
                            page, dk, dv},
                           a.cu_q_lens, a.distribution, sqt, sot};
    const bool rows_ok = atk::rows_aligned(d) && atk::aligned16(k_pool) &&
                         atk::aligned16(v_pool);
    cudaError_t err = atk::dispatch_decode(d, src, slots, dtype, rows_ok, st);
    if (err != cudaSuccess) return (int)err;
  }

  // 2. prefill slots
  cudaError_t err;
  if (body == 2)
    err = launch_wgmma(a, slots, T, pages, grid, st);
  else if (body == 1)
    err = launch_mma(a, slots, q_tile, st);
  else if (dtype == 0)
    err = launch_fma<float>(a, slots, q_tile, st);
  else
    err = launch_fma<__nv_bfloat16>(a, slots, q_tile, st);
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
