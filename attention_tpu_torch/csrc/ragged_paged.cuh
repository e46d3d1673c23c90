// The ragged kernel's arguments, its decode and prefill slots' bodies and
// their launches, shared by ragged_paged.cu (the C entry point, the online
// instances and the finishing kernel) and ragged_paged_variant.cu (each
// other max_mode variant's instances, a build of their own so that they
// compile in parallel).  ragged_paged.cu's note says what the kernel
// computes and what bounds it; attention_tile.cuh and flash_fwd_sm90.cuh
// how each variant runs.
#pragma once

#include "decode_rows.cuh"
#include "flash_fwd_sm90.cuh"
#include "tensor_map.cuh"

namespace rpa {

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
// head dims (DK, DV); VAR the rescaling math.  Prefill slots only.
template <typename T, int NJ, int DK, int DV, int VAR>
__device__ __forceinline__ void ragged_rows(const RaggedArgs& a) {
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
      atk::attend<T, NJ, VAR>(pb, a.dk, a.dv, a.qscale, a.cap2);
    else
      atk::attend_mma<DK, DV, 1, 2, VAR>(pb, a.qscale, a.cap2);
    __syncthreads();  // the next block rewrites the shared tiles
  }
}

template <typename T, int NJ, int DK, int DV>
__global__ void __launch_bounds__(THREADS) ragged_paged_kernel(RaggedArgs a) {
  ragged_rows<T, NJ, DK, DV, atk::ONLINE>(a);
}

// A variant's kernel (`atk::VARIANT_MIN_BLOCKS`).
template <typename T, int NJ, int DK, int DV, int VAR>
__global__ void __launch_bounds__(THREADS, atk::VARIANT_MIN_BLOCKS)
    ragged_paged_kernel_var(RaggedArgs a) {
  ragged_rows<T, NJ, DK, DV, VAR>(a);
}

// the kernel of variant VAR (only that one instantiated)
template <typename T, int NJ, int DK, int DV, int VAR>
constexpr auto ragged_entry() {
  if constexpr (VAR == atk::ONLINE)
    return ragged_paged_kernel<T, NJ, DK, DV>;
  else
    return ragged_paged_kernel_var<T, NJ, DK, DV, VAR>;
}

template <typename T, int VAR, int NJ, int DK = 0, int DV = 0>
cudaError_t launch(const RaggedArgs& a, int slots, int q_tile,
                   cudaStream_t stream) {
  auto kernel = ragged_entry<T, NJ, DK, DV, VAR>();
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

template <typename T, int VAR>
cudaError_t launch_fma(const RaggedArgs& a, int slots, int q_tile,
                       cudaStream_t s) {
  if (a.dv <= 32) return launch<T, VAR, 4>(a, slots, q_tile, s);
  if (a.dv <= 64) return launch<T, VAR, 8>(a, slots, q_tile, s);
  if (a.dv <= 128) return launch<T, VAR, 16>(a, slots, q_tile, s);
  return launch<T, VAR, 32>(a, slots, q_tile, s);
}

// VAR's instances: every pair of 64 and 128 for ONLINE, dk == dv for the
// others (the caller's `ragged_body` names "fma" elsewhere)
template <int VAR>
cudaError_t launch_mma(const RaggedArgs& a, int slots, int q_tile,
                       cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (a.dk == 64 && a.dv == 64)
    return launch<bf16, VAR, 0, 64, 64>(a, slots, q_tile, s);
  if (a.dk == 128 && a.dv == 128)
    return launch<bf16, VAR, 0, 128, 128>(a, slots, q_tile, s);
  if constexpr (VAR == atk::ONLINE) {
    if (a.dk == 64 && a.dv == 128)
      return launch<bf16, VAR, 0, 64, 128>(a, slots, q_tile, s);
    if (a.dk == 128 && a.dv == 64)
      return launch<bf16, VAR, 0, 128, 64>(a, slots, q_tile, s);
  }
  return cudaErrorInvalidValue;
}

// the tensor-core loops read 16-byte row chunks: head dims 64/128 (the
// pools' rows then stay 16-byte aligned), 16-byte aligned q/o/pool bases
// and q/o strides that are multiples of 8 elements
inline bool mma_ok(const RaggedArgs& a) {
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

template <int DK, int DV, bool CAP, int VAR>
cudaError_t launch_wgmma_t(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, const RaggedSched& sc,
                           int grid, cudaStream_t stream) {
  auto kernel = sm90::flash_fwd_wgmma<DK, DV, CAP, RaggedSched, false, VAR>;
  constexpr size_t smem = sm90::smem_bytes(DK, DV);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, sm90::THREADS, smem, stream>>>(tq, tk, tv, sc);
  return cudaGetLastError();
}

template <bool CAP, int VAR>
cudaError_t launch_wgmma_cap(const CUtensorMap& tq, const CUtensorMap& tk,
                             const CUtensorMap& tv, const RaggedSched& sc,
                             int dk, int grid, cudaStream_t st) {
  if (dk == 64 && sc.dv == 64)
    return launch_wgmma_t<64, 64, CAP, VAR>(tq, tk, tv, sc, grid, st);
  if (dk == 128 && sc.dv == 128)
    return launch_wgmma_t<128, 128, CAP, VAR>(tq, tk, tv, sc, grid, st);
  if constexpr (VAR == atk::ONLINE) {
    if (dk == 64)
      return launch_wgmma_t<64, 128, CAP, VAR>(tq, tk, tv, sc, grid, st);
    return launch_wgmma_t<128, 64, CAP, VAR>(tq, tk, tv, sc, grid, st);
  }
  return cudaErrorInvalidValue;
}

// what the TMA maps take: bf16 at head dims 64/128, a group dividing 128
// (a Q box of whole tokens), pages of a multiple of 128 rows or of 8 to 64
// rows dividing 128 (whole boxes of 1024-byte aligned rows), 16-byte
// aligned bases and strides of positive multiples of 8 elements
inline bool wgmma_ok(const RaggedArgs& a) {
  const int group = a.Hq / a.Hkv;
  const long long st[4] = {a.sqh, a.sqt, a.soh, a.sot};
  for (long long x : st)
    if (x <= 0 || x % 8) return false;
  return mma_ok(a) && group <= sm90::BM && sm90::BM % group == 0 &&
         (a.page % sm90::BN == 0 ||
          (a.page >= 8 && sm90::BN % a.page == 0));
}

// The wgmma body over `pages` pool pages: the tensor maps of q and the
// pools, then the persistent kernel of variant VAR on `grid` CTAs.
template <int VAR>
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
             ? launch_wgmma_cap<true, VAR>(tq, tk, tv, sc, a.dk, grid, st)
             : launch_wgmma_cap<false, VAR>(tq, tk, tv, sc, a.dk, grid, st);
}

// Steps 1 and 2 of a call (the C entry point's note) under variant VAR:
// the decode slots' split kernel (when d.S, the most tokens of a decode
// slot, is not 0) and the prefill slots' body.
template <int VAR>
cudaError_t run_slots(const RaggedArgs& a, const atk::DecodeArgs& d,
                      const RaggedSource& src, bool rows_ok, int body,
                      int dtype, int slots, int T, int pages, int q_tile,
                      int grid, cudaStream_t st) {
  if (d.S > 0) {
    const cudaError_t err = atk::dispatch_decode<RaggedSource, VAR>(
        d, src, slots, dtype, rows_ok, st);
    if (err != cudaSuccess) return err;
  }
  if (body == 2) return launch_wgmma<VAR>(a, slots, T, pages, grid, st);
  if (body == 1) return launch_mma<VAR>(a, slots, q_tile, st);
  if (dtype == 0) return launch_fma<float, VAR>(a, slots, q_tile, st);
  return launch_fma<__nv_bfloat16, VAR>(a, slots, q_tile, st);
}

}  // namespace rpa
