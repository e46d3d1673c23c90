// The Hopper body of the flash backward's dQ kernel (flash_bwd_dq.cu):
// bf16 q, k, v, dO at head dims dk = dv = 64 or 128, its three products
// on `wgmma`, the tiles fed by TMA.
//
// It computes what the TPU kernel `_dq_kernel` (attention_tpu/ops/
// flash_bwd.py:146) computes, with the numerics of flash_bwd.cuh: Qs =
// round(q·scale·log2 e), P = exp2(Qs·Kᵀ - lse2) (0 where masked or where
// the forward saw no key), dS = P∘(dO·Vᵀ - delta) (∘(1 - tanh²) under
// softcap, `tanhf` as the forward recomputes it), dS rounded to bf16
// before dQ = scale·dS·K, fp32 accumulation.  It is bound by operations:
// 6·d per visible (row, key) pair per q head on 2·h·m·d + 2·hkv·n·d
// values, far above the H100's ~295 operations per byte in bf16.  What
// each part of the design does about it:
//
// - A work item is 128 query rows of one (batch, q head): two consumer
//   warpgroups own 64 rows each and keep their dQ in fp32 registers; a
//   producer warpgroup, trimmed to 24 registers a thread by `setmaxnreg`
//   so the consumers get 240, loads the item's Qs and dO tiles by TMA and
//   its rows' lse2 and delta by bulk copy once, and streams its K and V
//   tiles of 128 keys through a ring of two `mbarrier`-guarded stages.
// - All three products on `wgmma`.  S = Qs·Kᵀ and dP = dO·Vᵀ are
//   m64n128k16 from shared memory, both operands K-major.  dQ += dS·K takes
//   dS from registers (the dP accumulators rounded to bf16: accumulator
//   element for element the A fragment, as the forward's P·V) and reads K
//   MN-major by the transpose bit.  P (under softcap P·(1 - tanh²)) is
//   computed while dP's product still runs.
// - No softmax state: the forward's row statistics are known, so P =
//   exp2(S - lse2) with lse2 held per row in registers, no running max and
//   no rescale.  dQ is written once, ·scale, in bf16: no atomics, so it is
//   the same bits on every call.
// - Heaviest first, on a persistent grid: the flash forward's schedule
//   (`FlashSched`, one split) deals the items (row block, head), under
//   causal masking the last row block first, in `snake_item`'s order.
// - Masks only where a tile needs them: the forward's `tile_plan` (its
//   key tiles are this body's) gives each item's key tiles and the range
//   [mask_lo, mask) every row keeps whole (mirrored by
//   `ops.flash.tile_plan`).  Under a sliding window the plan is the
//   window's band alone (sinks 0: the sink pairs outside the band are the
//   caller's `sink_patch`), the walk visits only its tiles, and a masked
//   tile tests each row's band start beside its key limit.  Rows past m
//   and rows the forward fully masked need no test: the wrapper pads lse2
//   with +inf there.  Softcap on and off are two instances.
// - Packed-sequence segment ids in an instance of their own, `SEG`: the
//   walk of a call without ids (its band included), a test of every pair
//   of every tile (the key limits, the band and the ids), the rows' two
//   ids in registers (`FlashSched::row_ids`) and each key tile's 128 ids
//   beside its K and V in the stage (one bulk copy on their barrier).
//   While the tile's products run, a loop that is not unrolled folds the
//   id test into one 32-bit mask a row (bit 2j + e of the thread's
//   columns 8j + 2·(lane % 4) + e), which the P pass reads: the 32 ids of
//   a thread's columns never sit in registers at once (unrolled, they
//   spilled at d 128 under softcap).  The key limits and the band are
//   tested, at run time, in the tiles the plan masks only.
// - TMA maps are 4-D (d, rows, heads, batch) from the caller's strides, so
//   the training layer's (b, s, h, d) views load as they are; rows past m
//   and keys past n read as zeros, keys in [kv_valid, n) are masked.
// - Registers at d 128: dQ 64 a thread, S and dP 64 each.  On the H100
//   128-key tiles were 4-7% faster than 64-key tiles (with a ring of 4)
//   at every case measured.
#pragma once

#include "flash_bwd.cuh"
#include "flash_fwd_sm90.cuh"
#include "tensor_map.cuh"

namespace dq90 {

using namespace sm90;

constexpr int ROWS = BM;  // query rows per work item, 64 per consumer
constexpr int KT = BN;    // keys per K/V tile, the forward's
constexpr int ST = 2;     // K/V tiles in flight

// What the kernel reads besides the tensor maps.
struct Args {
  FlashSched sc;       // the items, each row's key limit, softcap·log2 e
  const float* lse2;   // (B·H, m_pad): lse·log2 e; +inf: no key, past m
  const float* delta;  // (B·H, m_pad): rowsum(dO ∘ O); 0 past m
  __nv_bfloat16* dq;   // (B, H, m, D), contiguous
  int m_pad;
  float scale;
};

// Dynamic shared memory of one CTA: the item's Qs and dO, its rows' lse2
// and delta, the K and V tiles of each stage, the barriers, with segment
// ids each stage's key ids, and room to align the tiles to 1024 bytes.
template <int D, bool SEG = false>
constexpr size_t smem_bytes() {
  return (size_t)2 * ROWS * D * 2 + 2 * ROWS * 4 + (size_t)ST * 2 * KT * D * 2 +
         8 * (2 + 2 * ST) + (SEG ? ST * KT * 4 : 0) + 1024;
}

// the key tiles of an item, from the forward's plan: the window's band
// without sinks
__device__ __forceinline__ TilePlan item_plan(const sm90::Args& a,
                                              const FlashSched::Work& k) {
  return tile_plan(k.m0, a.m, a.kv_valid, a.causal != 0, a.q_offset,
                   a.kv_offset, a.window, 0, 0, 1 << 30);
}

// d += A·B, A (64 x 16) from registers, B (16 x N) MN-major in shared
// memory
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// Thread layout: warpgroup 0 is the producer, warpgroups 1 and 2 the
// consumers of rows 0 .. 63 and 64 .. 127 of the item.  A consumer
// thread's accumulator element 4j + e sits at row 16·warp + lane / 4 +
// 8·(e / 2) of its warpgroup's 64, column 8j + 2·(lane % 4) + e % 2.  The
// K/V ring runs on across items: the g-th tile a CTA loads sits in stage
// g % ST.  The Qs/dO buffer is refilled once both consumers finished the
// item before.  BAND: the call has a window (an instance of its own, so
// that a call without one runs the code it ran before the band).  SEG: the
// call has segment ids (its band, if any, walked and tested at run time;
// BAND is false).
template <int D, bool CAP, bool BAND, bool SEG = false>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr uint32_t Q_BYTES = ROWS * D * 2;  // one of Qs, dO
  constexpr uint32_t KV_BYTES = KT * D * 2;   // one of K, V
  constexpr uint32_t Q_BOX = ROWS * 128;      // one 64-wide box of Qs, dO
  constexpr uint32_t K_BOX = KT * 128;        // of a K or V tile
  const FlashSched& sc = a.sc;
  const long long total = sc.total();
  if (total <= blockIdx.x) return;
  const float cap2 = sc.cap2();

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sdo = sq + Q_BYTES;
  const uint32_t skv = sdo + Q_BYTES;  // stage s: K, then V
  auto sk = [&](int s) { return skv + s * 2 * KV_BYTES; };
  auto sv = [&](int s) { return skv + s * 2 * KV_BYTES + KV_BYTES; };
  const uint32_t sst = skv + ST * 2 * KV_BYTES;  // lse2, then delta
  const uint32_t q_full = sst + 2 * ROWS * 4;
  const uint32_t q_empty = q_full + 8;
  auto full = [&](int s) { return q_full + 8 * (2 + s); };
  auto empty = [&](int s) { return q_full + 8 * (2 + ST + s); };
  const uint32_t sid = q_full + 8 * (2 + 2 * ST);  // SEG: stage s's key ids
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
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
    // once), Qs and dO once they finished the item before
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int g = 0;   // K/V tiles loaded
    int nq = 0;  // items loaded
    for (int r = 0; (long long)r * gridDim.x < total; ++r) {
      const long long w = snake_item(r, total);
      if (w < 0) continue;
      const FlashSched::Work k = sc.item(w);
      const TilePlan p = item_plan(sc.a, k);
      if (p.end <= p.begin) continue;
      if (nq > 0) mbar_wait(q_empty, (nq - 1) & 1);
      ++nq;
      mbar_expect_tx(q_full, 2 * Q_BYTES + 2 * ROWS * 4);
      for (int c = 0; c < D / BOX; ++c) {
        tma_load(sq + c * Q_BOX, &tq, q_full, c * BOX, k.m0, k.h, k.b);
        tma_load(sdo + c * Q_BOX, &tdo, q_full, c * BOX, k.m0, k.h, k.b);
      }
      const long long row = (long long)k.bh * a.m_pad + k.m0;
      bulk_load(sst, a.lse2 + row, ROWS * 4, q_full);
      bulk_load(sst + ROWS * 4, a.delta + row, ROWS * 4, q_full);
      for (int i = p.begin; i < p.end; ++i, ++g) {
        const int s = g % ST;
        const int t = BAND || SEG ? p.tile(i) : i;
        mbar_wait(empty(s), ((g / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KV_BYTES + (SEG ? KT * 4 : 0));
        for (int c = 0; c < D / BOX; ++c) {
          tma_load(sk(s) + c * K_BOX, &tk, full(s), c * BOX, t * KT, k.hk,
                   k.b);
          tma_load(sv(s) + c * K_BOX, &tv, full(s), c * BOX, t * KT, k.hk,
                   k.b);
        }
        if constexpr (SEG) sc.load_ids(sid + s * KT * 4, full(s), t);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const int rl = 64 * cw + 16 * warp + lane / 4;  // rows rl, rl + 8
  const uint32_t qa = sq + cw * 64 * 128;   // this warpgroup's Qs rows
  const uint32_t oa = sdo + cw * 64 * 128;  // and dO rows
  const float* stats = reinterpret_cast<const float*>(smem_raw + (sst - raw));
  int g = 0;   // K/V tiles consumed
  int nq = 0;  // items consumed
  for (int r = 0; (long long)r * gridDim.x < total; ++r) {
    const long long w = snake_item(r, total);
    if (w < 0) continue;
    const FlashSched::Work k = sc.item(w);
    const TilePlan p = item_plan(sc.a, k);
    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
    if (p.end > p.begin) {
      int lim[2];
      sc.limits(k, rl, lim);
      const Band band = sc.band(k, rl);  // its sinks unused: none here
      int qid[2];  // SEG: the rows' segment ids
      if constexpr (SEG) sc.row_ids(k, rl, qid);
      mbar_wait(q_full, nq & 1);
      ++nq;
      const float l2[2] = {stats[rl], stats[rl + 8]};
      const float dl[2] = {stats[ROWS + rl], stats[ROWS + rl + 8]};
      for (int i = p.begin; i < p.end; ++i, ++g) {
        const int st = g % ST;
        const int t = BAND || SEG ? p.tile(i) : i;
        mbar_wait(full(st), (g / ST) & 1);

        // S = Qs·Kᵀ and dP = dO·Vᵀ: this warpgroup's 64 rows x KT keys, 16
        // columns of d a step, four steps to a box
        float s[KT / 2], dp[KT / 2];
#pragma unroll
        for (int e = 0; e < KT / 2; ++e) s[e] = dp[e] = 0.f;
        pin(s);
        pin(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk / 4) * Q_BOX + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * K_BOX + (kk % 4) * 32;
          wgmma_ss_n128(s, desc_sw128(qa + qo, 16, 1024),
                        desc_sw128(sk(st) + ko, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk / 4) * Q_BOX + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * K_BOX + (kk % 4) * 32;
          wgmma_ss_n128(dp, desc_sw128(oa + qo, 16, 1024),
                        desc_sw128(sv(st) + ko, 16, 1024), kk > 0);
        }
        wgmma_commit();
        // SEG: bit 2j + e of keep[r] is set where column t·KT + c0 + 8j + e
        // lies in the segment of row rl + 8r
        uint32_t keep[2] = {0u, 0u};
        if constexpr (SEG) {
          const int* kid = reinterpret_cast<const int*>(
                               smem_raw + (sid + st * KT * 4 - raw)) + c0;
#pragma unroll 1
          for (int j = 0; j < KT / 8; ++j) {
            const int2 id2 = *reinterpret_cast<const int2*>(kid + 8 * j);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((e & 1 ? id2.y : id2.x) == qid[e >> 1])
                keep[e >> 1] |= 1u << (2 * j + (e & 1));
          }
        }
        // P in place of S while dP's product still runs (under softcap
        // P·(1 - tanh²), the factor dS takes); the per-element test only in
        // the tiles that can hold a masked pair (and the ids of every tile
        // under SEG)
        wgmma_wait<1>();
        pin(s);
        const bool masked = ((BAND || SEG) && t < p.mask_lo) || t >= p.mask;
        const int col0 = t * KT + c0;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            float dcap = 1.f;
            if constexpr (CAP) {
              const float th = tanhf(x / cap2);
              x = cap2 * th;
              dcap = 1.f - th * th;
            }
            float pv = ex2(x - l2[e >> 1]);
            if constexpr (SEG) {
              if (!((keep[e >> 1] >> (2 * j + (e & 1))) & 1u)) pv = 0.f;
            } else if (!BAND && masked &&
                       col0 + 8 * j + (e & 1) >= lim[e >> 1]) {
              pv = 0.f;
            }
            s[4 * j + e] = CAP ? pv * dcap : pv;
          }
        // a band's masked tiles (its lower edge and the diagonal; under SEG
        // every masked tile, the band NO_BAND without a window) in a pass of
        // their own, which the tiles between them skip
        if ((BAND || SEG) && masked) {
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = col0 + 8 * j + (e & 1);
              if (col >= lim[e >> 1] || col < band.lo[e >> 1])
                s[4 * j + e] = 0.f;
            }
        }
        // dS = P·(dP - delta)
        wgmma_wait<0>();
        pin(dp);
#pragma unroll
        for (int e = 0; e < KT / 2; ++e)
          dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]);
        // dS rounded to bf16 as the A fragments of dQ's product (step kk:
        // keys 16kk .. 16kk + 15, accumulator elements 8kk .. 8kk + 7)
        uint32_t df[KT / 16][4];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            df[kk][q] = pack_bf16(dp[8 * kk + 2 * q], dp[8 * kk + 2 * q + 1]);

        // dQ += dS·K, K read MN-major: 16 keys a step
        pin(dq);
        pin(df);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          mma_rs<D>(dq, df[kk], desc_sw128(sk(st) + kk * 16 * 128, K_BOX, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
        pin(df);
        mbar_arrive(empty(st));  // K and V read
      }
      mbar_arrive(q_empty);  // Qs, dO, lse2, delta read
    }

    // dQ·scale of the rows below m, in bf16 (zero for an item that sees no
    // key)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = k.m0 + rl + 8 * rr;
      if (row >= sc.a.m) continue;
      __nv_bfloat16* out = a.dq + ((long long)k.bh * sc.a.m + row) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(
            dq[4 * j + 2 * rr] * a.scale, dq[4 * j + 2 * rr + 1] * a.scale);
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D, bool CAP, bool BAND, bool SEG = false>
cudaError_t launch_t(const CUtensorMap (&maps)[4], const Args& s,
                     cudaStream_t stream) {
  auto kernel = flash_bwd_dq_wgmma<D, CAP, BAND, SEG>;
  constexpr size_t smem = smem_bytes<D, SEG>();
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
      (long long)s.sc.a.B * s.sc.a.H * ((s.sc.a.m + ROWS - 1) / ROWS);
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                          s);
  return cudaGetLastError();
}

// The instance of a head dim: softcap on or off, segment ids (with or
// without a band), else a band or none.
template <int D>
cudaError_t launch_d(const CUtensorMap (&maps)[4], const Args& s,
                     cudaStream_t st) {
  if (s.sc.a.q_seg != nullptr)
    return s.sc.a.cap2 > 0.f ? launch_t<D, true, false, true>(maps, s, st)
                             : launch_t<D, false, false, true>(maps, s, st);
  if (s.sc.a.window > 0)
    return s.sc.a.cap2 > 0.f ? launch_t<D, true, true>(maps, s, st)
                             : launch_t<D, false, true>(maps, s, st);
  return s.sc.a.cap2 > 0.f ? launch_t<D, true, false>(maps, s, st)
                           : launch_t<D, false, false>(maps, s, st);
}

// The body on a call the caller checked (`atb::wgmma_operands_ok`, lse2
// and delta padded to whole items, dq 16-byte aligned): the tensor maps of
// Qs, dO (boxes of ROWS rows), K and V (boxes of KT rows), then the kernel.
inline cudaError_t launch(const atb::BwdArgs& a, int B, cudaStream_t st) {
  const tmap::EncodeTiled enc = tmap::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[4];
  if (!tmap::encode(enc, &maps[0], a.qs, a.d, a.m, a.H, B, a.sqm, a.sqh,
                    a.sqb, ROWS) ||
      !tmap::encode(enc, &maps[1], a.dout, a.d, a.m, a.H, B, a.som, a.soh,
                    a.sob, ROWS) ||
      !tmap::encode(enc, &maps[2], a.k, a.d, a.n, a.Hkv, B, a.skn, a.skh,
                    a.skb, KT) ||
      !tmap::encode(enc, &maps[3], a.v, a.d, a.n, a.Hkv, B, a.svn, a.svh,
                    a.svb, KT))
    return cudaErrorInvalidValue;
  Args s{};
  sm90::Args& f = s.sc.a;
  f.B = B;
  f.H = a.H;
  f.Hkv = a.Hkv;
  f.m = a.m;
  f.cap2 = a.cap2;
  f.causal = a.causal;
  f.q_offset = a.q_offset;
  f.kv_offset = a.kv_offset;
  f.kv_valid = a.kv_valid < 0 ? 0 : a.kv_valid > a.n ? a.n : a.kv_valid;
  f.window = a.causal ? a.window : 0;
  f.sinks = 0;
  f.splits = 1;
  f.split_tiles = 1 << 30;
  f.q_seg = a.q_seg;
  f.kv_seg = a.kv_seg;
  s.lse2 = a.lse2;
  s.delta = a.delta;
  s.dq = static_cast<__nv_bfloat16*>(a.dq);
  s.m_pad = a.ls;
  s.scale = a.scale;
  if (a.d == 64)
    return launch_d<64>(maps, s, st);
  return launch_d<128>(maps, s, st);
}

}  // namespace dq90
