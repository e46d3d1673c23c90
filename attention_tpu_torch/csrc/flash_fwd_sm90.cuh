// The Hopper body of the flash forward (flash_fwd.cu): bf16 q, k, v at
// head dims 64 or 128, both products on `wgmma`, the tiles fed by TMA.
// The kernel walks the work items of a schedule (`FlashSched` here; the
// ragged kernel's prefill slots run it under `RaggedSched`, with their
// key tiles loaded page by page through the slot's table).
//
// It computes what the TPU kernel `_flash_kernel` (attention_tpu/ops/
// flash.py:310, online max mode) computes, and is bound by operations at
// the shapes the port runs (2·m·n·(dk + dv) products on (m + n)·(dk + dv)
// values, far above the H100's ~295 operations per byte in bf16): the
// tensor cores' 989 TFLOP/s.  What each part of the design does about it:
//
// - `wgmma` for both products.  S = Q·Kᵀ is m64n128k16 with Q and K read
//   from shared memory; O += P·V takes P from registers (the score
//   accumulators rounded to bf16, as the reference rounds
//   `p.astype(v.dtype)`; the row sum uses the unrounded P) and reads V
//   from shared memory as an MN-major operand (the descriptor's transpose
//   bit), since V's rows are keys with dv contiguous.  fp32 accumulation.
// - 128 query rows and 128-key tiles a CTA.  Two consumer warpgroups own 64
//   rows each and share every K and V tile; a producer warpgroup, trimmed
//   to 24 registers a thread by `setmaxnreg` so the consumers get 240,
//   keeps the ring of STAGES K and V tiles full.
// - The softmax beside the products.  Within a warpgroup, tile i's scores
//   are issued with tile i - 1's P·V and its softmax runs while that
//   product does; across the two, named barriers make them take turns to
//   issue, so one's softmax runs while the other's products hold the
//   tensor cores (FlashAttention-3's intra-warpgroup overlap and
//   ping-pong).  exp2 is the MUFU's `ex2.approx.ftz`, one instruction; the
//   row sums stay per thread until the end.
// - TMA loads with 128-byte swizzle, the layout the `wgmma` descriptors
//   read, into a ring guarded by `mbarrier`s (full: the copy's bytes
//   landed; empty: all 256 consumer threads are done with the stage).  The
//   tensor maps are encoded on the host for each call from the caller's
//   strides (4-D: d, rows, heads, batch), so the training layer's
//   (b, s, h, d) views load as they are.  A 128-byte box is 64 bf16 wide: a
//   128-wide head is two boxes a tile.  TMA fills rows past m and n with
//   zeros; keys in [kv_valid, n) are masked in the edge tile.
// - Masks only where a tile needs them.  Each CTA computes from (m0,
//   q_offset, kv_offset, kv_valid, causal, window, sinks) the tiles it
//   visits and the interval of them that every row keeps whole
//   (`tile_plan`, mirrored by `ops.flash.tile_plan`); only the tiles
//   outside it (the diagonal, the band's lower edge, a sink tile) run the
//   per-element test.  Softcap on and off are two instances, so no
//   per-element branch.
// - A band shrinks the walk, not only the mask.  Under a sliding window a
//   block visits its sink tiles and then the band's tiles only, as the TPU
//   kernel's banded grid does (attention_tpu/ops/flash.py:381-399, where a
//   full-width grid with skip guards made a 1024-key window slower than
//   full causal attention): the work scales with the window.
// - Heaviest first, on a persistent grid.  At most one CTA an SM walks the
//   work items (row block, head, split) a round at a time; under causal
//   masking the row blocks with the most tiles come first (a block's tile
//   count does not fall as its rows move down, with or without a band, up
//   to the last block's edge), and the rounds
//   are dealt in a snake order so that every CTA sums about the same work
//   and the tail is made of short blocks.  The producer loads the next
//   item's Q and tiles while the consumers finish the current one, so a
//   short block's start-up latency hides behind the last one's epilogue.
// - A key split for thin grids.  Where B·H·⌈m/128⌉ leaves SMs idle
//   (`ops.flash.flash_split_plan`), each block's visited tiles are cut
//   into splits of split_tiles tiles; each split writes fp32 partials (output,
//   row max in the log2 domain, row sum) into scratch the wrapper
//   allocates, and `flash_merge` merges them in split order, the two-phase
//   max then sum.  No atomics: a second call gives the same bits.
// - Softcap keeps `tanhf`: the backward recomputes P from this forward's
//   row stats with `tanhf`, and a faster tanh here alone would move them.
// - The rescaling math (the TPU kernel's max_mode) is the kernel's `VAR`
//   (attention_tile.cuh's list), one instance each, so the online instance
//   is the code it was.  BOUND takes each row's bound b = ||q|| · qscale ·
//   knmax (capped at cap2) from the Q tile in shared memory at the item's
//   start, and its tile drops the row max, its quad shuffles and the
//   rescale of O: one exp2 a score, the sum and P·V.  Its guard runs on
//   the device before the launch and leaves a verdict in global memory;
//   the kernel reads it at its start and, where it says the bound could
//   leave fp32's range, takes the online step on every tile instead (the
//   instance holds both steps around one pipeline): one launch, a branch
//   the same for every CTA, no host sync.  FLASHD reduces each
//   tile's row sum across the row's four threads (two shuffles more a row
//   and tile) for its one reciprocal a row, and scales P by it before the
//   bf16 rounding; AMLA ceils the max and rescales O and l by exponent
//   adds.  A split that saw no key is told by its sum (under BOUND its max
//   is b, not -inf), and an item with no key writes b as its max.
// - Packed-sequence segment ids (the TPU kernel's q_seg/kv_seg) in an
//   instance of their own, `SEG`, so that a call without ids runs the code
//   it ran before them.  Ids mask; they do not move the walk: a SEG call
//   visits the tiles of its plan and tests every element of each.  A row's
//   two ids sit in registers, loaded once an item; a key tile's 128 ids
//   ride with its K tile (one bulk copy into the stage, on the K barrier),
//   and the stage's K is released after the softmax has read them.
#pragma once

#include "attention_tile.cuh"
#include "sm90.cuh"

namespace sm90 {

constexpr int BM = 128;       // query rows per CTA
constexpr int BN = 128;       // keys per tile
constexpr int STAGES = 2;     // K and V tiles in flight
constexpr int THREADS = 384;  // the producer warpgroup and two consumers
constexpr int CONSUMERS = 256;
constexpr int MERGE_ROWS = 4;  // rows per CTA of flash_merge, a warp each
constexpr float LN2 = 0.6931471805599453f;

// What the kernel reads besides the tensor maps.
struct Args {
  void* o;         // normalized bf16 output, or null
  float* acc;      // partials: fp32 unnormalized output (o's strides)
  float* row_max;  // partials: (B, H, m) row max (natural log), row sum
  float* row_sum;
  // split scratch (splits > 1): output (splits, B·H, m, dv), then the row
  // max (log2 domain) and row sum (splits, B·H, m)
  float* part;
  int B, H, Hkv, m, dv;
  long long sob, soh, som;  // element strides (batch, head, row) of o/acc
  float qscale, cap2;       // scale·log2 e and softcap·log2 e (0: none)
  int causal, q_offset, kv_offset, kv_valid;  // kv_valid cut to n
  // the band (causal only): a row at position p keeps the keys at
  // positions p - window + 1 .. p and those below `sinks`; window 0: none
  int window, sinks;
  int splits, split_tiles;
  // segment ids (SEG instances): the rows' (m) and the keys' (n rounded
  // up to whole tiles, the tail an id no row holds)
  const int* q_seg;
  const int* kv_seg;
  int variant;  // the instance's VAR, for the split merge
  // BOUND: (B, Hkv) largest key norms, the guard's verdict (non-zero: run
  // the online body) and q (its bound for an item that sees no key)
  const float* knmax;
  const int* demote;
  const __nv_bfloat16* q;
  long long sqb, sqh, sqm;
  int dk;
};

// The key tiles a CTA of one row block visits, and where it masks.  The
// block visits the sink tiles [0, sink) first, then the band's tiles from
// `base` on: the i-th visited tile is `tile(i)`, and its split takes the
// visits [begin, end).  A tile holding both a sink and the band's start
// is visited once, as a sink tile.  Without a band, sink and base are 0
// and the i-th visit is tile i.  Tiles in [mask_lo, mask) are kept whole
// by every row of the block and skip the per-element test: below mask_lo
// a key may lie before some row's band (sink tiles the band does not
// cover included), from `mask` on past kv_valid or after some row.
struct TilePlan {
  int begin, end, mask, sink, base, mask_lo;
  __device__ int tile(int i) const { return i < sink ? i : base + i - sink; }
};

// The plan of a block from its key columns: every kept key lies below
// n_end, tiles below `mask` hold no key past a row's end, the block's band
// starts at column `band` (its first row's) and every row's band has
// started by column `full` (its last row's); columns below sink_end are
// the pinned sinks.  The visited tiles are exactly those holding a kept
// key: the union of the rows' bands is the one interval [band, n_end).
__device__ __forceinline__ TilePlan plan_tiles(int n_end, int mask, int band,
                                               int full, int sink_end,
                                               int split, int split_tiles) {
  const int end = (n_end + BN - 1) / BN;
  TilePlan p;
  p.sink = (min(sink_end, n_end) + BN - 1) / BN;
  p.base = band < n_end ? max(band / BN, p.sink) : end;
  const int count = p.sink + end - p.base;
  p.begin = min(split * split_tiles, count);
  p.end = min(p.begin + split_tiles, count);
  p.mask = mask;
  p.mask_lo = (full + BN - 1) / BN;
  return p;
}

// The plan of the flash forward's CTA of rows [m0, m0 + BM) in its split
// of split_tiles visits (mirrored by `ops.flash.tile_plan`).
__device__ __forceinline__ TilePlan tile_plan(int m0, int m, int kv_valid,
                                              bool causal, int q_offset,
                                              int kv_offset, int window,
                                              int sinks, int split,
                                              int split_tiles) {
  int n_end = kv_valid;
  int mask = kv_valid / BN;
  int band = 0, full = 0, sink_end = 0;
  if (causal) {
    const int d = q_offset - kv_offset;    // a row's key column, less its row
    const int last = min(m0 + BM, m) - 1;  // the block's last real row
    n_end = max(0, min(n_end, last + d + 1));
    mask = min(mask, max(0, floor_div(m0 + d + 1, BN)));
    if (window > 0) {
      band = max(0, m0 + d - window + 1);
      full = max(0, last + d - window + 1);
      sink_end = max(0, sinks - kv_offset);
    }
  }
  return plan_tiles(n_end, mask, band, full, sink_end, split, split_tiles);
}

// A row's band in key columns: it keeps the columns from lo on and those
// below `sink` (the rows' key limits, `limits`, still apply).  Without a
// band, lo is NO_BAND and sink 0.
constexpr int NO_BAND = -(1 << 30);
struct Band {
  int lo[2];
  int sink;
};

// Dynamic shared memory of one CTA: Q, STAGES K and V tiles, the barriers,
// with segment ids each stage's key ids, and room to align the tiles to
// 1024 bytes.
constexpr size_t smem_bytes(int dk, int dv, bool seg = false) {
  return 2 * (size_t)(BM * dk + STAGES * BN * (dk + dv)) +
         8 * (2 + 4 * STAGES) + (seg ? STAGES * BN * 4 : 0) + 1024;
}

// Row r (0 or 1) of a consumer thread's accumulator, normalized, as bf16
// at dst: a row that attended nothing has l == 0 and an all-zero
// accumulator, and stays zero.
template <int DV>
__device__ __forceinline__ void store_bf16_row(__nv_bfloat16* dst,
                                               const float (&o)[DV / 2],
                                               int r, float l, int c0) {
  const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + c0) =
        pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
}

// ---------------------------------------------------------------- schedules

constexpr uint32_t BOX_BYTES = BN * 128;  // one 64-wide box of a tile

// A schedule names a launch's work to the kernel below (`flash_fwd_wgmma`):
// how many work items it has (`total`), each item's key tiles
// (`item(w).plan`), how a score is capped (`softcap`), the TMA copies of
// an item's 128 query rows and of its key/value tile t (`load_q`,
// `load_kv`, issued by one thread, completing on the barrier given), each
// row's key limit (`limits`: keys at or past it are masked) and band
// (`band`), both tested in the tiles outside [plan.mask_lo, plan.mask),
// and where each row's result goes (`store`, and
// `store_empty` for an item that sees no key).  A row is named by its
// place in the item's 128-row block.  `FlashSched` is the flash
// forward's; ragged_paged.cu has another.

// The flash forward: (row block, head, split) work items over q, k, v of
// (B, H or Hkv, rows, d), normalized bf16 output or partials.
struct FlashSched {
  Args a;

  struct Work {
    int bh, b, h, hk, m0, split;
    TilePlan plan;
  };

  __device__ float qscale() const { return a.qscale; }
  __device__ float cap2() const { return a.cap2; }
  // softcap as the backward recomputes it (flash_bwd.cuh)
  __device__ static float softcap(float x, float cap2) {
    return cap2 * tanhf(x / cap2);
  }
  __device__ int nmb() const { return (a.m + BM - 1) / BM; }
  __device__ long long bhm() const { return (long long)a.B * a.H * a.m; }
  __device__ long long total() const {
    return (long long)a.B * a.H * nmb() * a.splits;
  }

  // Work item w: the split varies slowest, then the row block (under
  // causal masking from the last, which sees the most tiles: heaviest
  // first), then the head.
  __device__ Work item(long long w) const {
    const int bhs = a.B * a.H;
    const int n = nmb();
    Work k;
    k.split = (int)(w / ((long long)bhs * n));
    const long long r = w - (long long)k.split * bhs * n;
    const int mi = (int)(r / bhs);
    k.bh = (int)(r - (long long)mi * bhs);
    k.b = k.bh / a.H;
    k.h = k.bh - k.b * a.H;
    k.hk = k.h / (a.H / a.Hkv);
    k.m0 = (a.causal ? n - 1 - mi : mi) * BM;
    k.plan = tile_plan(k.m0, a.m, a.kv_valid, a.causal != 0, a.q_offset,
                       a.kv_offset, a.window, a.sinks, k.split,
                       a.split_tiles);
    return k;
  }

  template <int DK>
  __device__ void load_q(uint32_t dst, const CUtensorMap* tq, uint32_t bar,
                         const Work& k) const {
    for (int c = 0; c < DK / BOX; ++c)
      tma_load(dst + c * BOX_BYTES, tq, bar, c * BOX, k.m0, k.h, k.b);
  }

  template <int D>
  __device__ void load_kv(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                          const Work& k, int t) const {
    for (int c = 0; c < D / BOX; ++c)
      tma_load(dst + c * BOX_BYTES, map, bar, c * BOX, t * BN, k.hk, k.b);
  }

  // the key ids of tile t into shared memory at dst, one bulk copy
  // completing on bar (SEG instances)
  __device__ void load_ids(uint32_t dst, uint32_t bar, int t) const {
    bulk_load(dst, a.kv_seg + t * BN, BN * 4, bar);
  }

  // the segment ids of rows rl and rl + 8 (SEG instances; -1 past m)
  __device__ void row_ids(const Work& k, int rl, int (&id)[2]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k.m0 + rl + 8 * i;
      id[i] = row < a.m ? a.q_seg[row] : -1;
    }
  }

  // row r keeps the keys below lim: kv_valid, and under causal masking
  // the last key at or before r + q_offset
  __device__ void limits(const Work& k, int rl, int (&lim)[2]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = a.causal ? min(a.kv_valid, k.m0 + rl + 8 * i + a.q_offset -
                                              a.kv_offset + 1)
                        : a.kv_valid;
  }

  // the band of rows rl and rl + 8: a row's key column is its row plus
  // q_offset - kv_offset, the sinks the keys at positions below `sinks`
  __device__ Band band(const Work& k, int rl) const {
    const bool on = a.causal && a.window > 0;
    Band b;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      b.lo[i] = on ? k.m0 + rl + 8 * i + a.q_offset - a.kv_offset -
                         a.window + 1
                   : NO_BAND;
    b.sink = on ? a.sinks - a.kv_offset : 0;
    return b;
  }

  // BOUND: the item's kv head's largest key norm, and the guard's verdict
  __device__ float knmax(const Work& k) const {
    return a.knmax[k.b * a.Hkv + k.hk];
  }
  __device__ bool demoted() const { return *a.demote != 0; }

  // BOUND, an item that sees no key: its rows' bound as the row max (from
  // q in global memory, a thread a row), sum 0 and zero outputs, as the
  // plain version gives them.  `count` threads from thread `first` on.
  __device__ void store_empty_bound(const Work& k, int first,
                                    int count) const {
    const long long hm = bhm();
    for (int r = threadIdx.x - first; r < BM; r += count) {
      const int row = k.m0 + r;
      if (row >= a.m) continue;
      const __nv_bfloat16* qr = a.q + k.b * a.sqb + k.h * a.sqh + row * a.sqm;
      float ss = 0.f;
      for (int c = 0; c < a.dk; ++c) {
        const float x = __bfloat162float(qr[c]);
        ss = fmaf(x, x, ss);
      }
      float b = sqrtf(ss) * a.qscale * knmax(k);
      if (a.cap2 > 0.f) b = fminf(b, a.cap2);
      const long long stat = (long long)k.bh * a.m + row;
      const long long out = k.b * a.sob + k.h * a.soh + row * a.som;
      if (a.part != nullptr) {
        const long long pr = k.split * hm + stat;
        for (int c = 0; c < a.dv; ++c) a.part[pr * a.dv + c] = 0.f;
        a.part[a.splits * hm * a.dv + pr] = b;
        a.part[a.splits * hm * (a.dv + 1) + pr] = 0.f;
      } else if (a.acc != nullptr) {
        for (int c = 0; c < a.dv; ++c) a.acc[out + c] = 0.f;
        a.row_max[stat] = b * LN2;
        a.row_sum[stat] = 0.f;
      } else {
        for (int c = 0; c < a.dv; ++c)
          static_cast<__nv_bfloat16*>(a.o)[out + c] = __float2bfloat16(0.f);
      }
    }
  }

  // Rows that see no key in their split: zero output rows, or row max
  // -inf and sum 0 (a split's scratch output is left unwritten; the merge
  // skips it).  Written by `count` threads from thread `first` on.
  __device__ void store_empty(const Work& k, int first, int count) const {
    const long long hm = bhm();
    for (int idx = threadIdx.x - first; idx < BM * a.dv; idx += count) {
      const int r = idx / a.dv;
      const int c = idx - r * a.dv;
      const int row = k.m0 + r;
      if (row >= a.m) continue;
      const long long stat = (long long)k.bh * a.m + row;
      if (a.part != nullptr) {
        if (c == 0) {
          const long long pr = k.split * hm + stat;
          a.part[a.splits * hm * a.dv + pr] = -INFINITY;
          a.part[a.splits * hm * (a.dv + 1) + pr] = 0.f;
        }
        continue;
      }
      const long long out = k.b * a.sob + k.h * a.soh + row * a.som + c;
      if (a.acc != nullptr) {
        a.acc[out] = 0.f;
        if (c == 0) {
          a.row_max[stat] = -INFINITY;
          a.row_sum[stat] = 0.f;
        }
        continue;
      }
      static_cast<__nv_bfloat16*>(a.o)[out] = __float2bfloat16(0.f);
    }
  }

  // Rows rl and rl + 8 of a consumer thread: its accumulator element
  // 4j + 2r + e holds row rl + 8r, column 8j + 2·(lane % 4) + e.
  template <int DV>
  __device__ void store(const Work& k, int rl, const float (&o)[DV / 2],
                        const float (&mrow)[2], const float (&lrow)[2],
                        int lane) const {
    const int c0 = 2 * (lane & 3);
    const long long hm = bhm();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k.m0 + rl + 8 * r;
      if (row >= a.m) continue;
      const long long stat = (long long)k.bh * a.m + row;
      if (a.part != nullptr) {
        const long long pr = k.split * hm + stat;
        float* dst = a.part + pr * DV;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j + c0) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if ((lane & 3) == 0) {
          a.part[a.splits * hm * DV + pr] = mrow[r];
          a.part[a.splits * hm * (DV + 1) + pr] = lrow[r];
        }
        continue;
      }
      const long long out = k.b * a.sob + k.h * a.soh + row * a.som;
      if (a.acc != nullptr) {
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<float2*>(a.acc + out + 8 * j + c0) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if ((lane & 3) == 0) {
          a.row_max[stat] = mrow[r] * LN2;
          a.row_sum[stat] = lrow[r];
        }
        continue;
      }
      store_bf16_row<DV>(static_cast<__nv_bfloat16*>(a.o) + out, o, r,
                         lrow[r], c0);
    }
  }
};

// ------------------------------------------------------------------ kernel

// A persistent grid: each CTA takes one work item of the schedule a round
// (at most one CTA an SM, `snake_item`), so the producer loads the next
// item's Q and first tiles while the consumers finish the current one.
// Thread layout: warpgroup 0 is the producer, warpgroups 1 and 2 the
// consumers of rows 0 .. 63 and 64 .. 127 of the item's block.  A consumer
// thread's accumulator element 4j + e sits at row 16·warp + lane / 4 +
// 8·(e / 2) of its warpgroup's 64, column 8j + 2·(lane % 4) + e % 2: the S
// accumulator of key columns 16kk .. 16kk + 15 is, element for element,
// the A operand of the P·V step kk.  The K/V ring runs on across items:
// the g-th tile a CTA loads sits in stage g % STAGES.  A CTA whose
// schedule has no work exits before it sets anything up.  SEG: the call
// has segment ids (the schedule's `load_ids` and `row_ids`).
template <int DK, int DV, bool CAP, typename Sched, bool SEG, int VAR>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const Sched sc, const bool bnd) {
  constexpr uint32_t Q_BYTES = BM * DK * 2;
  constexpr uint32_t K_BYTES = BN * DK * 2;
  constexpr uint32_t V_BYTES = BN * DV * 2;
  static_assert(BM == BN, "Q and K boxes share a stride");
  const long long total = sc.total();
  if (total <= blockIdx.x) return;
  const float qscale = sc.qscale();
  const float cap2 = sc.cap2();

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + STAGES * K_BYTES;
  // barriers: Q full, Q empty, then per stage K full, V full, K empty,
  // V empty
  const uint32_t q_full = sv + STAGES * V_BYTES;
  const uint32_t q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + STAGES + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * STAGES + s); };
  // SEG: stage s's key ids, after the barriers
  const uint32_t sid = q_full + 8 * (2 + 4 * STAGES);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS);
      mbar_init(v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < THREADS - CONSUMERS) {
    // the producer: one thread issues every copy.  A stage is refilled
    // once all consumer threads released it (the first round passes at
    // once), the Q tile once they issued their last S of the item before
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int g = 0;   // tiles loaded
    int nq = 0;  // Q tiles loaded
    for (int r = 0; (long long)r * gridDim.x < total; ++r) {
      const long long w = snake_item(r, total);
      if (w < 0) continue;
      const typename Sched::Work k = sc.item(w);
      const int ntiles = k.plan.end - k.plan.begin;
      if (ntiles <= 0) continue;
      if (nq > 0) mbar_wait(q_empty, (nq - 1) & 1);
      ++nq;
      mbar_expect_tx(q_full, Q_BYTES);
      sc.template load_q<DK>(sq, &tq, q_full, k);
      for (int i = 0; i < ntiles; ++i, ++g) {
        const int s = g % STAGES;
        const uint32_t ph = (g / STAGES) & 1;
        const int t = k.plan.tile(k.plan.begin + i);
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), K_BYTES + (SEG ? BN * 4 : 0));
        sc.template load_kv<DK>(sk + s * K_BYTES, &tk, k_full(s), k, t);
        if constexpr (SEG) sc.load_ids(sid + s * BN * 4, k_full(s), t);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), V_BYTES);
        sc.template load_kv<DV>(sv + s * V_BYTES, &tv, v_full(s), k, t);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const uint32_t qa = sq + cw * 64 * 128;  // this warpgroup's Q rows
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2, warpgroup 0 first), so that one's softmax runs while the
  // other's products hold the tensor cores.
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw));
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw));
  };
  if (cw == 1) asm volatile("bar.arrive 1, 256;\n");
  int g = 0;   // tiles consumed
  int nq = 0;  // Q tiles consumed
  for (int r = 0; (long long)r * gridDim.x < total; ++r) {
    const long long w = snake_item(r, total);
    if (w < 0) continue;
    const typename Sched::Work k = sc.item(w);
    const TilePlan plan = k.plan;
    const int ntiles = plan.end - plan.begin;
    if (ntiles <= 0) {
      if constexpr (VAR == atk::BOUND) {
        if (bnd) {
          sc.store_empty_bound(k, THREADS - CONSUMERS, CONSUMERS);
          continue;
        }
      }
      sc.store_empty(k, THREADS - CONSUMERS, CONSUMERS);
      continue;
    }
    const int rl = 64 * cw + 16 * warp + lane / 4;  // rows rl, rl + 8
    int lim[2];
    sc.limits(k, rl, lim);
    const Band band = sc.band(k, rl);
    int qid[2];  // SEG: the rows' segment ids
    if constexpr (SEG) sc.row_ids(k, rl, qid);
    float o[DV / 2];
    float s[BN / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY};  // log2 domain
    float lrow[2] = {0.f, 0.f};

    // S = Q·Kᵀ of the tile in stage st: 16 columns of dk a step, four
    // steps to a box (issued, not waited for)
    auto issue_qk = [&](int st) {
      const uint32_t ka = sk + st * K_BYTES;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_n128(s, desc_sw128(qa + off, 16, 1024),
                      desc_sw128(ka + off, 16, 1024), kk > 0);
      }
    };
    // O += P·V of the tile in stage st: 16 keys a step, V read MN-major
    auto issue_pv = [&](int st) {
      const uint32_t va = sv + st * V_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = desc_sw128(va + kk * 16 * 128, BOX_BYTES, 1024);
        if constexpr (DV == 128)
          wgmma_rs_n128(o, p[kk], db);
        else
          wgmma_rs_n64(o, p[kk], db);
      }
    };
    // tile t's scores (its K, and its key ids, in stage st), in s: to the
    // log2 domain, capped, masked where the tile may hold a masked element
    // (every tile under SEG); then the variant's softmax step: the new row
    // max (ONLINE; mu under FLASHD, the ceiled max under AMLA, none under
    // BOUND), P = exp2(s - max) in place (unrounded, for the row sum;
    // under FLASHD scaled by 1/t) and corr, what rescales O so far (AMLA:
    // the exponent step).  Each thread keeps its own part of the row sums;
    // a row's four threads add them at the end (FLASHD: every tile).
    auto softmax = [&](int t, int st, float (&corr)[2]) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        float x = s[e] * qscale;
        if constexpr (CAP) x = Sched::softcap(x, cap2);
        s[e] = x;
      }
      // SEG tests every tile's limits too: a test of them on the tiles
      // outside [mask_lo, mask) alone, by a run-time flag inside this
      // unrolled loop, measured 2.3x slower on the H100
      if (SEG || t < plan.mask_lo || t >= plan.mask) {
        const int col = t * BN + c0;
        const int* kid = reinterpret_cast<const int*>(
            smem_raw + (sid + st * BN * 4 - raw)) + c0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          int2 id2 = make_int2(0, 0);
          if constexpr (SEG) id2 = *reinterpret_cast<const int2*>(kid + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = col + 8 * j + (e & 1);
            bool drop = c >= lim[e >> 1] ||
                        (c < band.lo[e >> 1] && c >= band.sink);
            if constexpr (SEG)
              drop = drop || (e & 1 ? id2.y : id2.x) != qid[e >> 1];
            if (drop) s[4 * j + e] = -INFINITY;
          }
        }
      }
      if constexpr (VAR == atk::BOUND) {
        if (bnd) {
          // b bounds every score of the row: no max, no rescale
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            s[e] = ex2(s[e] - mrow[(e >> 1) & 1]);
            lrow[(e >> 1) & 1] += s[e];
          }
          return;
        }
      }
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      // a row whose max is still -inf has seen nothing: subtracting 0
      // keeps every exp2 at exp2(-inf) == 0
      float msub[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if constexpr (VAR == atk::AMLA) mx[r] = ceilf(mx[r]);
        msub[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        corr[r] = VAR == atk::AMLA
                      ? (mrow[r] == -INFINITY ? 0.f : mrow[r] - mx[r])
                      : ex2(mrow[r] - msub[r]);
        mrow[r] = mx[r];
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        s[e] = ex2(s[e] - msub[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += s[e];
      }
      if constexpr (VAR == atk::FLASHD) {
        // t = exp2(mu - b) + the row's sum: the denominator over exp2(b),
        // taken out of P (before its rounding) and out of O
        float rt[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          const float t = corr[r] + sum[r];
          rt[r] = t == 0.f ? 0.f : 1.f / t;
          corr[r] *= rt[r];
          mrow[r] += log2f(t);
          lrow[r] = mrow[r] == -INFINITY ? 0.f : 1.f;
        }
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) s[e] *= rt[(e >> 1) & 1];
      } else if constexpr (VAR == atk::AMLA) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lrow[r] = atk::exp_add(lrow[r], (int)corr[r]) + sum[r];
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * corr[r] + sum[r];
      }
    };
    // P rounded to bf16 as the A operand: the S accumulator of key columns
    // 16kk .. 16kk + 15 is element for element the A fragment of step kk
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
    };
    auto rescale_o = [&](const float (&corr)[2]) {
      if constexpr (VAR == atk::AMLA) {
#pragma unroll
        for (int e = 0; e < DV / 2; ++e)
          o[e] = atk::exp_add(o[e], (int)corr[(e >> 1) & 1]);
      } else {
        if (VAR == atk::BOUND && bnd) return;
#pragma unroll
        for (int e = 0; e < DV / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      }
    };
    auto pin_pv = [&]() {
      pin(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pin(p[kk]);
    };

    mbar_wait(q_full, nq & 1);
    ++nq;
    if constexpr (VAR == atk::BOUND) {
      if (bnd) {
        // each row's bound from its Q line in shared memory: a 128-byte line
        // a box (the swizzle permutes its 16-byte chunks, which a sum of
        // squares does not see), a quarter of it a thread
        const float kn = sc.knmax(k) * qscale;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float ss = 0.f;
#pragma unroll
          for (int c = 0; c < DK / BOX; ++c) {
            const uint4* src = reinterpret_cast<const uint4*>(
                smem_raw + (sq - raw) + c * BOX_BYTES + (rl + 8 * r) * 128 +
                (lane & 3) * 32);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 w = src[h];
              const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const float lo = __uint_as_float(ws[x] << 16);
                const float hi = __uint_as_float(ws[x] & 0xffff0000u);
                ss = fmaf(lo, lo, fmaf(hi, hi, ss));
              }
            }
          }
          ss += __shfl_xor_sync(0xffffffffu, ss, 1);
          ss += __shfl_xor_sync(0xffffffffu, ss, 2);
          mrow[r] = sqrtf(ss) * kn;
          if constexpr (CAP) mrow[r] = fminf(mrow[r], cap2);
        }
      }
    }
    // Tile i's scores are computed while tile i - 1's P·V runs: S_i is
    // issued, then O += P_{i-1}·V_{i-1}; once S_i lands its softmax runs
    // beside the product, which must land before O is rescaled and P
    // rewritten.  Tile 0's scores come first, the last tile's P·V last.
    // The Q tile is released with the last S.
    float corr[2];
    mbar_wait(k_full(g % STAGES), (g / STAGES) & 1);
    turn_wait();
    pin(s);
    wgmma_fence();
    issue_qk(g % STAGES);
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    pin(s);
    if constexpr (!SEG) mbar_arrive(k_empty(g % STAGES));
    if (ntiles == 1) mbar_arrive(q_empty);
    softmax(plan.tile(plan.begin), g % STAGES, corr);
    if constexpr (SEG) mbar_arrive(k_empty(g % STAGES));  // ids read
    pack_p();
    for (int i = 1; i < ntiles; ++i) {
      const int st = (g + i) % STAGES;
      const int pst = (g + i - 1) % STAGES;
      mbar_wait(k_full(st), ((g + i) / STAGES) & 1);
      turn_wait();
      pin(s);
      pin_pv();
      wgmma_fence();
      issue_qk(st);
      wgmma_commit();
      mbar_wait(v_full(pst), ((g + i - 1) / STAGES) & 1);
      issue_pv(pst);
      wgmma_commit();
      turn_pass();
      wgmma_wait<1>();
      pin(s);
      if constexpr (!SEG) mbar_arrive(k_empty(st));
      if (i == ntiles - 1) mbar_arrive(q_empty);
      softmax(plan.tile(plan.begin + i), st, corr);
      if constexpr (SEG) mbar_arrive(k_empty(st));  // ids read
      wgmma_wait<0>();
      pin_pv();
      mbar_arrive(v_empty(pst));
      rescale_o(corr);
      pack_p();
    }
    const int last = (g + ntiles - 1) % STAGES;
    mbar_wait(v_full(last), ((g + ntiles - 1) / STAGES) & 1);
    turn_wait();
    pin_pv();
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    pin_pv();
    mbar_arrive(v_empty(last));
    g += ntiles;

    if constexpr (VAR != atk::FLASHD) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
      }
    }
    sc.template store<DV>(k, rl, o, mrow, lrow, lane);
  }
}

// The kernel of a schedule and variant.  BOUND reads the guard's verdict
// first; where it demotes the call, the kernel takes the online step on
// every tile (`bnd` false: a branch the same for every CTA).
template <int DK, int DV, bool CAP, typename Sched, bool SEG = false,
          int VAR = atk::ONLINE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Sched sc) {
  bool bnd = false;
  if constexpr (VAR == atk::BOUND) bnd = !sc.demoted();
  fwd_body<DK, DV, CAP, Sched, SEG, VAR>(tq, tk, tv, sc, bnd);
}

// The splits' partials of each row merged in split order: the largest of
// their maxima, each split weighed by exp2(max_i - max), then the sums; a
// split whose sum is 0 saw nothing and is skipped (its output may be
// unwritten; under BOUND its max is the row's bound, not -inf).  A warp a
// row (B·H·m of them), a lane every 32nd column; the normalized bf16
// output, or the partials of the whole row (FLASHD's as (lse, 1) over the
// normalized output).
static __global__ void __launch_bounds__(32 * MERGE_ROWS)
    flash_merge(const Args a, long long bhm) {
  const long long row = (long long)blockIdx.x * MERGE_ROWS + threadIdx.x / 32;
  if (row >= bhm) return;
  const int lane = threadIdx.x & 31;
  const int bh = row / a.m;
  const int r = row - (long long)bh * a.m;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const float* pm = a.part + a.splits * bhm * a.dv;
  const float* pl = pm + a.splits * bhm;
  float mx = -INFINITY;
  for (int i = 0; i < a.splits; ++i) mx = fmaxf(mx, pm[i * bhm + row]);
  float l = 0.f;
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < a.splits; ++i) {
    const float mi = pm[i * bhm + row];
    const float li = pl[i * bhm + row];
    // a split that saw nothing weighs 0, and its output may be unwritten
    if (li == 0.f) continue;
    const float w = exp2f(mi - mx);
    l += w * li;
    const float* src = a.part + (i * bhm + row) * a.dv;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < a.dv) x[q] += w * src[lane + 32 * q];
  }
  const long long out = b * a.sob + h * a.soh + r * a.som;
  if (a.acc != nullptr) {
    const bool fd = a.variant == atk::FLASHD;
    const float inv = fd ? (l == 0.f ? 0.f : 1.f / l) : 1.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < a.dv) a.acc[out + lane + 32 * q] = x[q] * inv;
    if (lane == 0) {
      a.row_max[row] = fd ? (l == 0.f ? -INFINITY : (mx + log2f(l)) * LN2)
                          : mx * LN2;
      a.row_sum[row] = fd ? (l == 0.f ? 0.f : 1.f) : l;
    }
    return;
  }
  const float inv = l == 0.f ? 1.f : 1.f / l;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + out;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (lane + 32 * q < a.dv) o[lane + 32 * q] = __float2bfloat16(x[q] * inv);
}

}  // namespace sm90
