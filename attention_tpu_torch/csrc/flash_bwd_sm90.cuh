// The Hopper key-major body of the flash backward: bf16 q, k, v, dO at
// head dims dk = dv = 64 or 128, the products on `wgmma`, the tiles fed by
// TMA.  Two instances: with dQ (`DQ`, the fused kernel flash_bwd_fused.cu)
// and without it (the dK/dV kernel flash_bwd_dkv.cu, whose dQ comes from
// flash_bwd_dq_sm90.cuh).
//
// It computes what the TPU kernels `_fused_bwd_kernel` (attention_tpu/ops/
// flash_bwd.py:304) and `_dkv_kernel` (:215) compute, with the numerics of
// flash_bwd.cuh: Qs =
// round(q·scale·log2 e), P = exp2(Qs·Kᵀ - lse2) (0 where masked or where
// the forward saw no key), dS = P∘(dP - delta) (∘(1 - tanh²) under
// softcap, `tanhf` as the forward recomputes it), P and dS rounded to bf16
// before each product, fp32 accumulation, dK·ln 2 and dQ·scale.  It is
// bound by operations: 10·d per visible (row, key) pair per q head (8·d
// without dQ) on 4·h·m·d + 2·hkv·n·d values, far above the H100's ~295
// operations per byte in bf16.  What each part of the design does about
// it:
//
// - A work item is one block of 128 keys of one kv head and one slice of
//   its GQA group.  Two consumer warpgroups own 64 keys each and keep
//   their dK and dV in fp32 registers; a producer warpgroup, trimmed to 24
//   registers a thread by `setmaxnreg` so the consumers get 240, loads K
//   and V once per item and streams the item's query tiles (64 rows of
//   Qs and dO by TMA, that tile's lse2 and delta by bulk copy) through a
//   ring of `mbarrier`-guarded stages (2 with dQ; without it 4, in the
//   80 KB that dSᵀ and the dQ buffers take at d 128).
// - All five products on `wgmma`.  Sᵀ = K·Qsᵀ and dPᵀ = V·dOᵀ are
//   m64n64k16 from shared memory, both operands K-major.  dV += Pᵀ·dO and
//   dK += dSᵀ·Qs take Pᵀ and dSᵀ from registers (the score accumulators
//   rounded to bf16: accumulator element for element the A fragment, as
//   the forward's P·V) and read dO and Qs MN-major by the transpose bit.
//   dQ = dS·K reads dSᵀ, stored by both warpgroups into a 128-byte
//   swizzled tile, as an MN-major A operand and K as an MN-major B
//   operand: at d 128 each warpgroup takes 64 of dQ's columns, at d 64 the
//   two take turns by tile.  Without softcap P is computed while dPᵀ's
//   product still runs.
// - dQ as tiles: each (item, query tile) writes its 64×d fp32 dQ tile,
//   scaled, into one of two shared buffers, 128-byte swizzled in boxes of
//   32 columns (conflict-free stores), and one thread adds it to the
//   caller's zeroed fp32 dQ with one TMA reduction a box
//   (`cp.reduce.async.bulk.tensor` .add; rows past m fall outside the
//   map).  Nothing orders the adds of different CTAs: dQ may differ run
//   to run in fp32 order.
// - The GQA sum in a fixed order: an item walks the group/slices q heads of
//   its slice in order, so dK and dV are the same bits on every call.  One
//   slice (`ops.flash_bwd.bwd_work_plan`): dK and dV in bf16 directly;
//   more: fp32 partials (B, Hkv, slices, n, d) that the wrapper sums.
// - Heaviest first, on a persistent grid.  At most one CTA an SM walks the
//   items a round at a time; under causal masking the low key blocks see
//   the most query tiles, so items go key block by key block from 0,
//   dealt in `snake_item`'s order.  The producer loads the next item's K,
//   V and first tiles while the consumers write the last one's dK, dV.
// - Masks only where a tile needs them: each item computes from (key0, m,
//   kv_valid, causal, offsets, window) its query tiles and the tiles that
//   can hold a masked pair (`tile_plan`, mirrored by
//   `ops.flash_bwd.bwd_tile_plan`): the diagonal's at the start and,
//   under a window, those of the band's lower edge at the end; the rest
//   skip the per-element test.
// - Under a sliding window an item walks only its block's band of query
//   tiles, from the diagonal to the last row within window - 1 positions
//   of its last key, as the TPU kernels' banded grid does, so the work
//   and the load the work plan balances grow with the window, not the
//   sequence.  The mask is the window's alone: the sink pairs outside the
//   band are the caller's (`ops.flash_bwd.sink_patch`), since folding them
//   in would give key block 0 every query tile of the call, the heaviest
//   item of the grid for a few keys.
//   Rows past m and rows the forward fully masked need no test: the
//   wrapper pads lse2 with +inf there, so P = exp2(s - inf) = 0.  Softcap
//   on and off are two instances.
// - Packed-sequence segment ids in an instance of their own, `SEG`, which
//   walks the plan of a call without ids (its band included) and tests
//   the ids of every pair of every tile, the causal and band limits (at
//   run time) in the tiles the plan masks.  A query tile's 64 ids ride in
//   its stage beside lse2 and delta (one more bulk copy), the item's 128
//   key ids beside K and V (one bulk copy on their barrier); a thread
//   keeps its two keys' ids in registers and reads the rows' from shared
//   memory in the test.
// - TMA maps are 4-D (d, rows, heads, batch) from the caller's strides, so
//   the training layer's (b, s, h, d) views load as they are; rows past m
//   and keys past n read as zeros, and keys in [kv_valid, n) are masked in
//   the edge block.
// - Registers: 240 a consumer thread (dK and dV take 128 at d 128, Sᵀ and
//   dPᵀ 64, the dQ share 32), no spills at either head dim.
// - Without dQ the two consumer warpgroups never meet inside a tile: a
//   stage is released once the warpgroup's dK and dV products read it.
//
// Measured on the H100 against two variants, each slower: warpgroups that
// own a tile's whole dQ by turns and meet only through `mbarrier`s on the
// dSᵀ buffers (the owner of the next tile then waits for the other's dQ:
// 2.2x slower, and it spills at d 128), and each warpgroup reducing its
// own dQ columns, which saves one barrier a tile (5% slower).  What bounds
// this body, by count: at 64 x 64 tiles with both operands in shared
// memory, Sᵀ, dPᵀ and dQ read 4 KB of operands a k-step per warpgroup,
// about the 128 bytes a cycle shared memory gives an SM at the tensor
// cores' rate, and the two warpgroups meet twice a tile, so neither's
// softmax overlaps the other's products.
#pragma once

#include "flash_bwd.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"

namespace bwd90 {

using namespace sm90;

constexpr int KB = 128;       // keys per work item, 64 per consumer
constexpr int QT = 64;        // query rows per tile
constexpr int THREADS = 384;  // the producer warpgroup and two consumers
constexpr int CONSUMERS = 256;
// one query tile's lse2 and delta, and with segment ids its rows' ids
__host__ __device__ constexpr uint32_t stat_bytes(bool seg) {
  return (seg ? 3 : 2) * QT * 4;
}
constexpr float LN2 = 0.6931471805599453f;

// Query tiles in flight: 2 with dQ, 4 without (on the H100 4 was as fast
// as 3 or faster at every case measured)
__host__ __device__ constexpr int stages(bool dq) { return dq ? 2 : 4; }

// What the kernel reads besides the tensor maps.
struct Args {
  const float* lse2;   // (B, H, m_pad): lse·log2 e; +inf: no key, past m
  const float* delta;  // (B, H, m_pad): rowsum(dO ∘ O); 0 past m
  void* dk;            // slices 1: (B, Hkv, n, d) bf16, else fp32
  void* dv;            //   partials (B, Hkv, slices, n, d)
  int B, H, Hkv, m, n, m_pad, slices;
  float scale, cap2;  // cap2 = softcap·log2 e (0: none)
  int causal, q_offset, kv_offset, kv_valid;  // kv_valid cut to n
  int window;  // causal only: the keys of a row's last `window`
               // positions; 0: none
  // segment ids (SEG instances): the rows' (m_pad, padded) and the keys'
  // (n rounded up to whole blocks of KB, padded)
  const int* q_seg;
  const int* kv_seg;
};

// The query tiles [begin, end) that the item of keys [key0, key0 + KB)
// visits for each of its heads, and where it masks: tiles in [mask_end,
// edge) see every key of the block and skip the per-element test; below
// mask_end a row may lie before a key (the diagonal) or a key past
// kv_valid, from edge on a row's band may have left the block's first
// keys.  An item past kv_valid has no tiles.
struct TilePlan {
  int begin, end, mask_end, edge;
};

__device__ __forceinline__ TilePlan tile_plan(int key0, int m, int kv_valid,
                                              bool causal, int q_offset,
                                              int kv_offset, int window) {
  TilePlan p;
  const int tiles = (m + QT - 1) / QT;
  if (key0 >= kv_valid) {
    p.begin = p.end = p.mask_end = p.edge = 0;
    return p;
  }
  // causal: the first row that sees key0 sits at key0 + kv_offset -
  // q_offset, the first that sees the block's last key KB - 1 rows later;
  // a window: the last that sees its last key below kv_valid window - 1
  // rows after that key's first
  const int first = key0 + kv_offset - q_offset;
  const int span = min(KB, kv_valid - key0);
  const bool band = causal && window > 0;
  p.begin = !causal ? 0 : first >= m ? tiles : max(0, floor_div(first, QT));
  p.end = band ? max(p.begin, min(tiles, floor_div(first + span + window - 2,
                                                   QT) + 1))
               : tiles;
  if (key0 + KB > kv_valid)
    p.mask_end = p.end;
  else if (causal)
    p.mask_end =
        min(p.end, max(p.begin, floor_div(first + KB - 1 + QT - 1, QT)));
  else
    p.mask_end = p.begin;
  // a window: row first + window is the first whose band has left key0
  p.edge = band ? min(p.end, max(p.mask_end, floor_div(first + window, QT)))
                : p.end;
  return p;
}

// One block of keys of one kv head and one slice of its group.
struct Work {
  int b, hk, slice, key0, h_first, per_head, ntiles;
  TilePlan plan;
};

// Work item w: the key block varies slowest, from block 0 (under causal
// masking the heaviest) up, then the batch, kv head and slice.
// Its tile plan takes `window` (0 in an instance without a band).
__device__ __forceinline__ Work work_item(const Args& a, long long w,
                                          int window) {
  const int group = a.H / a.Hkv;
  const long long per_kb = (long long)a.B * a.Hkv * a.slices;
  Work k;
  const int kb = (int)(w / per_kb);
  const int rest = (int)(w - kb * per_kb);
  k.slice = rest % a.slices;
  const int bhk = rest / a.slices;
  k.b = bhk / a.Hkv;
  k.hk = bhk - k.b * a.Hkv;
  k.key0 = kb * KB;
  k.h_first = k.hk * group + k.slice * (group / a.slices);
  k.plan = tile_plan(k.key0, a.m, a.kv_valid, a.causal != 0, a.q_offset,
                     a.kv_offset, window);
  k.per_head = k.plan.end - k.plan.begin;
  k.ntiles = (group / a.slices) * k.per_head;
  return k;
}

// Dynamic shared memory of one CTA: K and V, `stages` Qs and dO tiles,
// with dQ the dSᵀ tile and two dQ buffers, the tiles' lse2 and delta (and
// with segment ids their rows' ids), the barriers, with segment ids the
// item's key ids, and room to align the tiles to 1024 bytes.
constexpr size_t smem_bytes(int d, bool dq, bool seg = false) {
  return (size_t)2 * KB * d * 2 + (size_t)stages(dq) * 2 * QT * d * 2 +
         (dq ? (size_t)KB * QT * 2 + (size_t)2 * QT * d * 4 : 0) +
         (size_t)stages(dq) * stat_bytes(seg) + 8 * (2 + 2 * stages(dq)) +
         (seg ? KB * 4 : 0) + 1024;
}

// Thread layout: warpgroup 0 is the producer, warpgroups 1 and 2 the
// consumers of keys key0 .. key0 + 63 and key0 + 64 .. key0 + 127.  A
// consumer thread's element 4j + e of an m64nN accumulator sits at row
// 16·warp + lane / 4 + 8·(e / 2) of its warpgroup's 64, column 8j +
// 2·(lane % 4) + e % 2.  The stage ring runs on across items: the g-th
// query tile a CTA loads sits in stage g % ST, and its dQ in buffer
// g % 2.  Without dQ, `tdq` is not read.  BAND: the call has a window
// (an instance of its own, so that a call without one runs the code it
// ran before the band).  SEG: the call has segment ids (and its window,
// if any, is tested at run time; BAND is false).
template <int D, bool CAP, bool DQ, bool BAND, bool SEG = false>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdq, const Args a) {
  constexpr int ST = stages(DQ);
  constexpr uint32_t KV_BYTES = KB * D * 2;  // one of K, V
  constexpr uint32_t Q_BYTES = QT * D * 2;   // one of Qs, dO
  constexpr uint32_t DQ_BYTES = QT * D * 4;
  constexpr uint32_t K_BOX = KB * 128;  // one 64-wide box of a K or V tile
  constexpr uint32_t Q_BOX = QT * 128;  // of a Qs or dO tile, and of the
                                        // 32-wide fp32 boxes of a dQ tile
  constexpr uint32_t DS_BYTES = KB * QT * 2;
  constexpr uint32_t STAT = stat_bytes(SEG);
  // the walk's band: a SEG instance walks the band of its call too
  const int window = BAND || SEG ? a.window : 0;
  const int nkb = (a.n + KB - 1) / KB;
  const long long total = (long long)nkb * a.B * a.Hkv * a.slices;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + KV_BYTES;
  const uint32_t sq0 = sv + KV_BYTES;  // stage s: Qs, then dO
  auto sq = [&](int s) { return sq0 + s * 2 * Q_BYTES; };
  auto sdo = [&](int s) { return sq0 + s * 2 * Q_BYTES + Q_BYTES; };
  const uint32_t sds = sq0 + ST * 2 * Q_BYTES;  // with dQ only
  const uint32_t sdq = sds + DS_BYTES;          // buffer i at i·DQ_BYTES
  // stage s: lse2, delta (SEG: then the rows' ids)
  const uint32_t sst = DQ ? sdq + 2 * DQ_BYTES : sds;
  const uint32_t kv_full = sst + ST * STAT;
  const uint32_t kv_empty = kv_full + 8;
  auto full = [&](int s) { return kv_full + 8 * (2 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (2 + ST + s); };
  const uint32_t skid = kv_full + 8 * (2 + 2 * ST);  // SEG: the key ids
  auto ptr = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < THREADS - CONSUMERS) {
    // the producer: one thread issues every copy.  A stage is refilled
    // once all consumer threads released it (the first round passes at
    // once), K and V once they finished the item before
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int g = 0;    // query tiles loaded
    int nkv = 0;  // K/V blocks loaded
    for (int r = 0; (long long)r * gridDim.x < total; ++r) {
      const long long w = snake_item(r, total);
      if (w < 0) continue;
      const Work k = work_item(a, w, window);
      if (k.ntiles <= 0) continue;
      if (nkv > 0) mbar_wait(kv_empty, (nkv - 1) & 1);
      ++nkv;
      mbar_expect_tx(kv_full, 2 * KV_BYTES + (SEG ? KB * 4 : 0));
      for (int c = 0; c < D / BOX; ++c) {
        tma_load(sk + c * K_BOX, &tk, kv_full, c * BOX, k.key0, k.hk, k.b);
        tma_load(sv + c * K_BOX, &tv, kv_full, c * BOX, k.key0, k.hk, k.b);
      }
      if constexpr (SEG) bulk_load(skid, a.kv_seg + k.key0, KB * 4, kv_full);
      for (int i = 0; i < k.ntiles; ++i, ++g) {
        const int s = g % ST;
        const int h = k.h_first + i / k.per_head;
        const int q0 = (k.plan.begin + i % k.per_head) * QT;
        const long long row = ((long long)k.b * a.H + h) * a.m_pad + q0;
        mbar_wait(empty(s), ((g / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * Q_BYTES + STAT);
        for (int c = 0; c < D / BOX; ++c) {
          tma_load(sq(s) + c * Q_BOX, &tq, full(s), c * BOX, q0, h, k.b);
          tma_load(sdo(s) + c * Q_BOX, &tdo, full(s), c * BOX, q0, h, k.b);
        }
        bulk_load(sst + s * STAT, a.lse2 + row, QT * 4, full(s));
        bulk_load(sst + s * STAT + QT * 4, a.delta + row, QT * 4, full(s));
        if constexpr (SEG)
          bulk_load(sst + s * STAT + 2 * QT * 4, a.q_seg + q0, QT * 4,
                    full(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const int kr = 64 * cw + 16 * warp + lane / 4;  // key rows kr, kr + 8
  const bool issuer = threadIdx.x == THREADS - CONSUMERS;
  const uint32_t ka = sk + cw * 64 * 128;  // this warpgroup's K rows
  const uint32_t va = sv + cw * 64 * 128;  // and V rows
  int g = 0;    // query tiles consumed
  int nkv = 0;  // K/V blocks consumed
  for (int r = 0; (long long)r * gridDim.x < total; ++r) {
    const long long w = snake_item(r, total);
    if (w < 0) continue;
    const Work k = work_item(a, w, window);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
    if (k.ntiles > 0) {
      mbar_wait(kv_full, nkv & 1);
      ++nkv;
      int kid[2];  // SEG: the segment ids of keys kr and kr + 8
      if constexpr (SEG) {
        const int* ids = reinterpret_cast<const int*>(ptr(skid));
        kid[0] = ids[kr];
        kid[1] = ids[kr + 8];
      }
      for (int i = 0; i < k.ntiles; ++i, ++g) {
        const int st = g % ST;
        const int h = k.h_first + i / k.per_head;
        const int t = k.plan.begin + i % k.per_head;
        const int q0 = t * QT;
        mbar_wait(full(st), (g / ST) & 1);

        // Sᵀ = K·Qsᵀ and dPᵀ = V·dOᵀ: this warpgroup's 64 keys x 64
        // queries, 16 columns of d a step, four steps to a box
        float s[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
        pin(s);
        pin(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t kv = (kk / 4) * K_BOX + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * Q_BOX + (kk % 4) * 32;
          wgmma_ss_n64<0, 0>(s, desc_sw128(ka + kv, 16, 1024),
                             desc_sw128(sq(st) + qo, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t kv = (kk / 4) * K_BOX + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * Q_BOX + (kk % 4) * 32;
          wgmma_ss_n64<0, 0>(dp, desc_sw128(va + kv, 16, 1024),
                             desc_sw128(sdo(st) + qo, 16, 1024), kk > 0);
        }
        wgmma_commit();
        // without softcap P is computed while dPᵀ is still running; with it
        // P and dS come in one pass once both have landed (the `tanhf`
        // pass beside an unfinished dPᵀ measured slower)
        wgmma_wait<CAP ? 0 : 1>();
        pin(s);
        if constexpr (CAP) pin(dp);

        // P in place of Sᵀ (under softcap dS = P·(dP - delta)·(1 - tanh²)
        // in place of dPᵀ in the same pass), then P rounded to bf16 as the
        // A fragments of dV's product (step kk: queries 16kk .. 16kk + 15,
        // accumulator elements 8kk .. 8kk + 7).  The per-element test only
        // in the tiles that can hold a masked pair (and, under SEG, the
        // ids of every tile).
        const float* lse = reinterpret_cast<const float*>(
            ptr(sst + st * STAT));
        const float* dl = lse + QT;
        const int* qid = reinterpret_cast<const int*>(dl + QT) + c0;
        const bool masked =
            t < k.plan.mask_end || ((BAND || SEG) && t >= k.plan.edge);
        uint32_t pf[4][4], df[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + c0);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + c0);
          int2 q2 = make_int2(0, 0);
          if constexpr (SEG) q2 = *reinterpret_cast<const int2*>(qid + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            float dcap = 1.f;
            if constexpr (CAP) {
              const float th = tanhf(x / a.cap2);
              x = a.cap2 * th;
              dcap = 1.f - th * th;
            }
            float p = ex2(x - (e & 1 ? l2.y : l2.x));
            if (masked) {
              const int key = k.key0 + kr + 8 * (e >> 1);
              const int q = q0 + 8 * j + c0 + (e & 1);
              if constexpr (SEG) {
                // the lag as under BAND, the band at run time
                const int lag = q + a.q_offset - (key + a.kv_offset);
                if (key >= a.kv_valid ||
                    (a.causal && (lag < 0 || (window > 0 && lag >= window))))
                  p = 0.f;
              } else if constexpr (BAND) {
                // the key's lag behind the row (a band is causal): kept
                // in [0, window)
                const int lag = q + a.q_offset - (key + a.kv_offset);
                if (key >= a.kv_valid || lag < 0 || lag >= a.window)
                  p = 0.f;
              } else if (key >= a.kv_valid ||
                         (a.causal && key + a.kv_offset > q + a.q_offset)) {
                p = 0.f;
              }
            }
            if constexpr (SEG)
              if ((e & 1 ? q2.y : q2.x) != kid[e >> 1]) p = 0.f;
            if constexpr (CAP)
              dp[4 * j + e] =
                  p * (dp[4 * j + e] - (e & 1 ? d2.y : d2.x)) * dcap;
            s[4 * j + e] = p;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pf[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
        if constexpr (!CAP) {
          // dS = P·(dP - delta)
          wgmma_wait<0>();
          pin(dp);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 d2 =
                *reinterpret_cast<const float2*>(dl + 8 * j + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * j + e] =
                  s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? d2.y : d2.x));
          }
        }
        // dS rounded to bf16 as the A fragments of dK's product
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            df[kk][q] = pack_bf16(dp[8 * kk + 2 * q], dp[8 * kk + 2 * q + 1]);

        // dV += Pᵀ·dO and dK += dSᵀ·Qs, dO and Qs read MN-major: 16
        // query rows a step
        pin(dk);
        pin(dv);
        pin(pf);
        pin(df);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc_sw128(sdo(st) + kk * 16 * 128, Q_BOX, 1024);
          if constexpr (D == 128)
            wgmma_rs_n128(dv, pf[kk], db);
          else
            wgmma_rs_n64(dv, pf[kk], db);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc_sw128(sq(st) + kk * 16 * 128, Q_BOX, 1024);
          if constexpr (D == 128)
            wgmma_rs_n128(dk, df[kk], db);
          else
            wgmma_rs_n64(dk, df[kk], db);
        }
        wgmma_commit();
        if constexpr (!DQ) {
          wgmma_wait<0>();
          pin(dk);
          pin(dv);
          pin(pf);
          pin(df);
          mbar_arrive(empty(st));  // Qs, dO, lse2, delta read
          continue;
        }

        // dSᵀ into shared memory, key rows by query columns, 128-byte
        // swizzled as TMA would lay it: the 16-byte chunk c of row r at
        // chunk c ^ (r % 8)
        unsigned char* dst = ptr(sds);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = kr + 8 * (q & 1);
            const int col = 16 * kk + 8 * (q >> 1) + c0;
            *reinterpret_cast<uint32_t*>(
                dst + row * 128 + (((col >> 3) ^ (row & 7)) << 4) +
                ((col & 7) << 1)) = df[kk][q];
          }
        fence_async_shared();
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS));  // dSᵀ stored

        // dQ = dS·K over the block's 128 keys, dSᵀ and K read MN-major: at
        // d 128 this warpgroup's 64 columns, at d 64 all of them on every
        // other tile
        const bool mine = D == 128 || (g & 1) == cw;
        float dq[32];
        if (mine) {
          const uint32_t kb = sk + (D == 128 ? cw * K_BOX : 0);
#pragma unroll
          for (int e = 0; e < 32; ++e) dq[e] = 0.f;
          pin(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KB / 16; ++kk)
            wgmma_ss_n64<1, 1>(dq, desc_sw128(sds + kk * 16 * 128, Q_BOX, 1024),
                               desc_sw128(kb + kk * 16 * 128, K_BOX, 1024),
                               kk > 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
        pin(dk);
        pin(dv);
        pin(pf);
        pin(df);
        if (mine) pin(dq);
        mbar_arrive(empty(st));  // Qs, dO, lse2, delta read

        // the dQ tile in boxes of 32 columns by 64 rows, the 16-byte chunk c
        // of row r at chunk c ^ (r % 8), as the TMA reduction reads it
        const uint32_t buf = sdq + (g & 1) * DQ_BYTES;
        if (mine) {
          unsigned char* dqs = ptr(buf);
          const int col0 = D == 128 ? 64 * cw : 0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int row = 16 * warp + lane / 4 + 8 * rr;
              const int col = col0 + 8 * j + c0;
              *reinterpret_cast<float2*>(
                  dqs + (col >> 5) * Q_BOX + row * 128 +
                  ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2)) =
                  make_float2(dq[4 * j + 2 * rr] * a.scale,
                              dq[4 * j + 2 * rr + 1] * a.scale);
            }
        }
        fence_async_shared();
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS));  // dQ tile stored
        if (issuer) {
          // the tile added to dQ (its rows below m); the buffer is written
          // again two tiles on, after the reduction read it
#pragma unroll
          for (int c = 0; c < D / 32; ++c)
            tma_reduce_add(&tdq, buf + c * Q_BOX, 32 * c, q0, k.b * a.H + h);
          bulk_commit();
          bulk_wait_read<1>();
        }
      }
      mbar_arrive(kv_empty);  // K, V read
    }

    // dK (·ln 2) and dV of the block's keys below n: bf16, or the slice's
    // fp32 partials
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = k.key0 + kr + 8 * rr;
      if (key >= a.n) continue;
      const long long head = (long long)k.b * a.Hkv + k.hk;
      if (a.slices == 1) {
        const long long at = (head * a.n + key) * D + c0;
        __nv_bfloat16* dko = static_cast<__nv_bfloat16*>(a.dk) + at;
        __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(a.dv) + at;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dko + 8 * j) = pack_bf16(
              dk[4 * j + 2 * rr] * LN2, dk[4 * j + 2 * rr + 1] * LN2);
          *reinterpret_cast<uint32_t*>(dvo + 8 * j) =
              pack_bf16(dv[4 * j + 2 * rr], dv[4 * j + 2 * rr + 1]);
        }
      } else {
        const long long at =
            ((head * a.slices + k.slice) * a.n + key) * D + c0;
        float* dko = static_cast<float*>(a.dk) + at;
        float* dvo = static_cast<float*>(a.dv) + at;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<float2*>(dko + 8 * j) = make_float2(
              dk[4 * j + 2 * rr] * LN2, dk[4 * j + 2 * rr + 1] * LN2);
          *reinterpret_cast<float2*>(dvo + 8 * j) =
              make_float2(dv[4 * j + 2 * rr], dv[4 * j + 2 * rr + 1]);
        }
      }
    }
  }
  if (DQ && issuer) bulk_wait<0>();  // every dQ reduction done
}

// ------------------------------------------------------------------ launch

template <int D, bool CAP, bool DQ, bool BAND, bool SEG = false>
cudaError_t launch_t(const CUtensorMap (&maps)[5], const Args& s,
                     cudaStream_t stream) {
  auto kernel = flash_bwd_wgmma<D, CAP, DQ, BAND, SEG>;
  constexpr size_t smem = smem_bytes(D, DQ, SEG);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: at most one CTA an SM, over every work item
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items =
      (long long)((s.n + KB - 1) / KB) * s.B * s.Hkv * s.slices;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                          maps[4], s);
  return cudaGetLastError();
}

// The instance of a head dim: softcap on or off, segment ids (with or
// without a band), else a band or none.
template <int D, bool DQ>
cudaError_t launch_d(const CUtensorMap (&maps)[5], const Args& s,
                     cudaStream_t st) {
  if (s.q_seg != nullptr)
    return s.cap2 > 0.f ? launch_t<D, true, DQ, false, true>(maps, s, st)
                        : launch_t<D, false, DQ, false, true>(maps, s, st);
  if (s.window > 0)
    return s.cap2 > 0.f ? launch_t<D, true, DQ, true>(maps, s, st)
                        : launch_t<D, false, DQ, true>(maps, s, st);
  return s.cap2 > 0.f ? launch_t<D, true, DQ, false>(maps, s, st)
                      : launch_t<D, false, DQ, false>(maps, s, st);
}

// The key-major body on a call the caller checked
// (`atb::wgmma_operands_ok`, lse2 and delta padded to whole query tiles,
// the GQA group a multiple of `slices`): the tensor maps of Qs, dO, K, V
// and, with dQ, dq32, then the kernel.
template <bool DQ>
cudaError_t launch(const atb::BwdArgs& a, int B, void* dk, void* dv,
                   int slices, cudaStream_t st) {
  const tmap::EncodeTiled enc = tmap::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[5];
  if (!tmap::encode(enc, &maps[0], a.qs, a.d, a.m, a.H, B, a.sqm, a.sqh,
                    a.sqb, QT) ||
      !tmap::encode(enc, &maps[1], a.dout, a.d, a.m, a.H, B, a.som, a.soh,
                    a.sob, QT) ||
      !tmap::encode(enc, &maps[2], a.k, a.d, a.n, a.Hkv, B, a.skn, a.skh,
                    a.skb, KB) ||
      !tmap::encode(enc, &maps[3], a.v, a.d, a.n, a.Hkv, B, a.svn, a.svh,
                    a.svb, KB))
    return cudaErrorInvalidValue;
  if (!DQ)
    maps[4] = maps[0];  // not read
  else if (!tmap::encode_f32(enc, &maps[4], a.dq32, a.d, a.m, B * a.H, QT))
    return cudaErrorInvalidValue;
  Args s;
  s.lse2 = a.lse2;
  s.delta = a.delta;
  s.dk = dk;
  s.dv = dv;
  s.B = B;
  s.H = a.H;
  s.Hkv = a.Hkv;
  s.m = a.m;
  s.n = a.n;
  s.m_pad = a.ls;
  s.slices = slices;
  s.scale = a.scale;
  s.cap2 = a.cap2;
  s.causal = a.causal;
  s.q_offset = a.q_offset;
  s.kv_offset = a.kv_offset;
  s.kv_valid = a.kv_valid < 0 ? 0 : a.kv_valid > a.n ? a.n : a.kv_valid;
  s.window = a.causal ? a.window : 0;
  s.q_seg = a.q_seg;
  s.kv_seg = a.kv_seg;
  if (a.d == 64)
    return launch_d<64, DQ>(maps, s, st);
  return launch_d<128, DQ>(maps, s, st);
}

}  // namespace bwd90
