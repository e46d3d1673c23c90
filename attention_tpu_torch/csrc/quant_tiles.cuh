// Decode against a quantized KV cache: the storage formats, the tile loop
// that reads their bytes and dequantizes them in registers, and the C entry
// shared by quant_decode.cu (int8 and feature-dim int4) and
// quant_tok4_decode.cu (token-paired int4).
//
// The three formats of attention_tpu/ops/quant.py, each with one fp32 scale
// per cached token, stored (B, Hkv, N) in token order:
//   INT8          row c of (B, Hkv, N, d) int8 holds token c;
//   INT4_FEATURE  row c of (B, Hkv, N, d/2) holds token c, byte f feature f
//                 in its low nibble and feature f + d/2 in its high nibble;
//   INT4_TOKENS   row r of (B, Hkv, N/2, d) holds tokens 2r (low nibbles)
//                 and 2r + 1 (high nibbles), byte f their feature f.
// Nibbles are two's complement: the low one re-signed (>= 8 -> -16), the
// high one an arithmetic shift of the signed byte.
//
// A per-token scale is a scalar on the token axis of both products, so it
// commutes out of them, as in the TPU kernel `_decode_q_kernel`
// (attention_tpu/ops/quant.py:156): scores = (q · K_q) ∘ s_K column by
// column, out = (P ∘ s_V) · V_q.  The loop loads q in its own dtype and
// rounds q · c to bf16, c the fp32 of scale·log2(e) (as the plain version
// and the TPU wrapper round it); the key scale multiplies the score before
// softcap and the mask, and the value scale multiplies P after the row sum
// and before P is rounded to bf16.  The output is bf16.
//
// The loop (`attend_quant`) stages only what it reads: a cp.async ring of
// STAGES buffers, each one 64-token tile's 64 key and 64 value scales (zero
// past n_end) and its stored K and V rows (rows padded by 16 bytes, so that
// the eight rows of a fragment fall on eight bank groups).  Each warp turns
// the bytes into mma.sync's bf16 fragments in registers, exactly: an int8
// pair by masks and one bf16x2 subtraction ((128 + (b & 127)) - 128, or
// - 256 for b < 0), an int4 pair as 128 + (n ^ 8) - 136.  Both operands
// take a fixed order of their reduced index that makes every load one
// 32-bit word:
//   scores  the k16 step's features 16j + 4tq + {0, 2} and {1, 3} of a
//           thread are its logical k 2tq, 2tq+1 and 2tq+8, 2tq+9, in q's
//           fragment (loaded so) as in K's: one word of a key row;
//   P·V     a thread of output n-tile 4a + i (n = g) takes feature 32a + 4g
//           + i (VW bytes a block in place of 4 where an int4 row is
//           shorter than 32 bytes), so one word of each of its four key
//           rows feeds four n-tiles; `__byte_perm` pairs the keys.
// In the token-paired layout a word of packed row r feeds two score n-tiles,
// the even tokens' and the odd ones', so the tile's columns run 16p + 2c +
// (n-tile & 1) and the mask and scales follow that order.
//
// With four key groups (KG = 4) the groups share each tile's row max, so P
// is rounded against the running max of whole tiles, as with one group.
//
// Head dims.  Instances are compiled for D = 32, 64, 128 and 256, two at
// each (`ANY`).  A call at d = D whose q, output and stored rows are 16-byte
// aligned runs the instance without ANY: vector loads and stores and 16-byte
// copies, the code the head dims 32, 64 and 128 ran before the others were
// taken (one instance for any d in its place took 7-59% longer at d = D on
// the H100: PERF.md).  Every other call, any head dim d <= D (int4: an even
// d, as the TPU wrapper requires), runs the ANY instance: its kernel
// features past d (in the feature-dim int4 layout, past d/2 in each nibble
// half) take zero q values and are never stored, q and the output move
// feature by feature, and the stored rows come in by 16-byte copies where
// every row is whole 16-byte units at 16-byte aligned addresses, else by
// 4-byte copies, else byte by byte (`gran`), the staged bytes past the row
// zero, so a cache of any row width runs as it is stored.  At D = 256 the q
// fragments (64 registers a thread) sit in shared memory, each thread's own,
// so that the output tile's 128 fp32 registers and the scores fit without a
// spill.
//
// A NaN scale (an overflowing append writes them) makes a NaN score, P and
// row sum where it is visible (`softmax_tile`), and a NaN P·s_V where it is
// not, as the plain version's P ∘ s_V over every column does; a row whose
// accumulator picked up a NaN writes a NaN sum, so that the key-group and
// split merges carry it.
#pragma once

#include "decode_rows.cuh"

namespace atk {

enum class Storage { INT8, INT4_FEATURE, INT4_TOKENS };

// bytes of one stored row at head dim D
template <Storage ST, int D>
__host__ __device__ constexpr int row_bytes() {
  return ST == Storage::INT4_FEATURE ? D / 2 : D;
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// the signed bytes 0 and 2 of w as bf16x2 (byte 0 low), exactly
__device__ __forceinline__ uint32_t i8_pair(uint32_t w) {
  return bf16x2_sub((w & 0x007F007Fu) | 0x43004300u,   // 128 + (b & 127)
                    (w & 0x00800080u) | 0x43004300u);  // 128, 256 if b < 0
}

// the signed low nibbles of bytes 0 and 2 of w as bf16x2, exactly
__device__ __forceinline__ uint32_t i4_pair(uint32_t w) {
  return bf16x2_sub((w & 0x000F000Fu) ^ 0x43084308u,  // 128 + (n ^ 8)
                    0x43084308u);                     // 136
}

// byte i of x into byte 0 and byte i of y into byte 2
__device__ __forceinline__ uint32_t pair_bytes(uint32_t x, uint32_t y,
                                               int i) {
  return __byte_perm(x, y, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
}

template <Storage ST, int D>
struct QuantLayout {
  static constexpr int TPR = ST == Storage::INT4_TOKENS ? 2 : 1;  // tokens
                                                                  // per row
  static constexpr int RB = row_bytes<ST, D>();
  static constexpr int RS = RB + 16;           // shared row stride
  static constexpr int SROWS = MMA_BN / TPR;   // stored rows per tile
  // stage: k scales [MMA_BN], v scales [MMA_BN], K rows, V rows
  static constexpr int SCALES = 2 * MMA_BN * (int)sizeof(float);
  static constexpr int STAGE = SCALES + 2 * SROWS * RS;
  // V bytes a thread reads per row and block of 8·VW bytes
  static constexpr int VW = RB >= 32 ? 4 : RB / 8;
  static_assert(RB % 16 == 0 && (VW == 4 || VW == 2), "row layout");
};

// the logical feature of kernel feature f of an instance at D for head
// dim d, or -1 where it lies past the row: the feature-dim int4 layout
// keeps features d/2 .. d - 1 in its high nibbles, whose kernel features
// start at D/2
template <Storage ST, int D>
__device__ __forceinline__ int logical_feature(int f, int d) {
  if constexpr (ST == Storage::INT4_FEATURE) {
    const int half = d / 2;
    if (f < D / 2) return f < half ? f : -1;
    return f - D / 2 < half ? f - D / 2 + half : -1;
  } else {
    return f < d ? f : -1;
  }
}

// stored rows holding tokens j0 .. j0 + MMA_BN - 1 of `src` (row stride
// `stride` bytes, rb bytes a row) into `dst` (row stride RS), in copies of
// `gran` bytes (16 and 4: cp.async; 1: through registers; without ANY
// 16, the rows whole at RB bytes), zeros past n_end and past rb; the
// narrower copies' loops stay rolled, to keep the tile loop's code small
template <Storage ST, int D, bool ANY>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const signed char* src,
                                           long long stride, int j0,
                                           int n_end, int rb, int gran) {
  using L = QuantLayout<ST, D>;
  auto from = [&](int r, int c) {
    return src + (long long)(j0 / L::TPR + r) * stride + c;
  };
  if (!ANY || gran == 16) {
    constexpr int CH = L::RB / 16;
    for (int idx = threadIdx.x; idx < L::SROWS * CH; idx += THREADS) {
      const int r = idx / CH;
      const int c = (idx - r * CH) * 16;
      unsigned char* to = dst + r * L::RS + c;
      if (j0 + L::TPR * r < n_end && (!ANY || c < rb))
        cp_async16(to, from(r, c));
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
    }
  } else if (gran == 4) {
    constexpr int CH = L::RB / 4;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < L::SROWS * CH; idx += THREADS) {
      const int r = idx / CH;
      const int c = (idx - r * CH) * 4;
      unsigned char* to = dst + r * L::RS + c;
      if (j0 + L::TPR * r < n_end && c < rb)
        cp_async4(to, from(r, c));
      else
        *reinterpret_cast<uint32_t*>(to) = 0u;
    }
  } else {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < L::SROWS * L::RB; idx += THREADS) {
      const int r = idx / L::RB;
      const int c = idx - r * L::RB;
      dst[r * L::RS + c] = j0 + L::TPR * r < n_end && c < rb
                               ? static_cast<unsigned char>(*from(r, c))
                               : 0;
    }
  }
}

// Where the q fragments of an instance at D > 128 start in shared memory:
// past the ring and the key groups' tile maxima.
template <Storage ST, int D, int KG, int STAGES>
__host__ __device__ constexpr int q_frag_offset() {
  return STAGES * QuantLayout<ST, D>::STAGE +
         (KG > 1 ? 4 * 16 * (int)sizeof(float) : 0);
}

// The key-tile loop of one CTA over a quantized cache, for decode_kernel
// (decode_rows.cuh): the Problem's rows (16 per warp), its TileWalk, its
// mask, and its output rows or partials, as `attend_mma` takes them, with
// KG key groups.  qscale is c above; pb.kv.q_f32 says q is fp32 (its row
// pointers then address fp32 rows); ANY as in the head dims' note above.
template <Storage ST, int D, bool ANY, int KG, int STAGES, typename Problem>
__device__ void attend_quant(const Problem& pb, float qscale, float cap2) {
  using L = QuantLayout<ST, D>;
  static_assert(KG == 1 || KG == 4, "key groups");
  static_assert(STAGES >= 2, "double buffering at least");
  constexpr bool TOK = ST == Storage::INT4_TOKENS;
  constexpr int KW = MMA_BN / KG;  // key columns per warp per tile
  constexpr int NT = KW / 8;       // score n-tiles per warp
  constexpr int KS = D / 16;       // k16 steps of the scores
  constexpr int OT = D / 8;        // output n-tiles
  constexpr int VW = L::VW;
  constexpr int VB = L::RB / (8 * VW);  // V blocks per stored row
  constexpr bool QS = D > 128;          // q fragments in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / KG * 16;  // this warp's first row
  const int ko = warp % KG * KW;  // its first column of each key tile
  const int g = lane >> 2;
  const int tq = lane & 3;
  const auto& kv = pb.kv;
  const TileWalk walk(pb.n_end, pb.kv_begin, pb.sink_end, MMA_BN);
  const int ntiles = walk.count;

  // stage tile t, if there is one, into buffer t % STAGES as one commit
  // group (an empty one past the last tile, so that the groups count tiles)
  auto prefetch = [&](int t) {
    if (t < ntiles) {
      unsigned char* st = smem_raw + (t % STAGES) * L::STAGE;
      const int j0 = walk.col(t, MMA_BN);
      const int i = threadIdx.x;
      const int c = i & (MMA_BN - 1);
      float* to = reinterpret_cast<float*>(st) + i;  // k: [0, 64), v: [64,
      if (j0 + c < pb.n_end)                         // 128)
        cp_async4(to, (i < MMA_BN ? kv.ks : kv.vs) + j0 + c);
      else
        *to = 0.f;
      unsigned char* rows = st + L::SCALES;
      stage_rows<ST, D, ANY>(rows, kv.k, kv.skn, j0, pb.n_end, kv.rb,
                             kv.gran);
      stage_rows<ST, D, ANY>(rows + L::SROWS * L::RS, kv.v, kv.svn, j0,
                             pb.n_end, kv.rb, kv.gran);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) prefetch(t);

  // q rows g and g + 8 of the warp's 16, scaled and rounded to bf16, in the
  // scores' feature order, zero past the row; in registers, or at D > 128
  // in this thread's own slots [KS][THREADS] of shared memory past the ring
  uint32_t qf[QS ? 1 : KS][4];
  uint4* qsm = reinterpret_cast<uint4*>(
                   smem_raw + q_frag_offset<ST, D, KG, STAGES>()) +
               threadIdx.x;
  const __nv_bfloat16* qrow[2] = {pb.q_row(wr + g), pb.q_row(wr + g + 8)};
  // q and the output rows whole at D and 16-byte aligned (not ANY):
  // vector loads and paired stores; else feature by feature
  constexpr bool whole = !ANY;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* row = qrow[i];
      if (row != nullptr && whole) {
        const int f = 16 * j + 4 * tq;
        if (kv.q_f32) {
          const float4 v = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(row) + f);
          x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(row + f);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = __bfloat162float(h[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __fmul_rn(x[e], qscale);
      } else if (row != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = logical_feature<ST, D>(16 * j + 4 * tq + e, kv.d);
          if (f < 0) continue;
          x[e] = __fmul_rn(kv.q_f32 ? reinterpret_cast<const float*>(row)[f]
                                    : __bfloat162float(row[f]),
                           qscale);
        }
      }
      w[i] = pack_bf16(x[0], x[2]);
      w[2 + i] = pack_bf16(x[1], x[3]);
    }
    if constexpr (QS) {
      qsm[j * THREADS] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[j][e] = w[e];
    }
  }
  // the fragment of k16 step j
  auto frag = [&](int j, uint32_t (&f)[4]) {
    if constexpr (QS) {
      const uint4 u = qsm[j * THREADS];
      f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = qf[QS ? 0 : j][e];
    }
  };

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};
  float lrow[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose buffer the next prefetch fills
    __syncthreads();
    prefetch(t + STAGES - 1);
    const int j0 = walk.col(t, MMA_BN);
    const unsigned char* st = smem_raw + (t % STAGES) * L::STAGE;
    const float* ksc = reinterpret_cast<const float*>(st);
    const float* vsc = ksc + MMA_BN;
    const unsigned char* Kr = st + L::SCALES;
    const unsigned char* Vr = Kr + L::SROWS * L::RS;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // k16 step by k16 step, each score n-tile taking its steps in order
    if constexpr (TOK) {
      // packed row (ko/2 + 8p + g): n-tile 2p its low nibbles (token 2·row),
      // n-tile 2p + 1 its high ones
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t f[4];
        frag(j, f);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              Kr + (ko / 2 + 8 * p + g) * L::RS + 4 * tq + 16 * j);
          mma_bf16(s[2 * p], f, i4_pair(w), i4_pair(w >> 8));
          mma_bf16(s[2 * p + 1], f, i4_pair(w >> 4), i4_pair(w >> 12));
        }
      }
    } else if constexpr (ST == Storage::INT8) {
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t f[4];
        frag(j, f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              Kr + (ko + 8 * n + g) * L::RS + 4 * tq + 16 * j);
          mma_bf16(s[n], f, i8_pair(w), i8_pair(w >> 8));
        }
      }
    } else {
      // low nibbles: features of the first half, high: of the second
#pragma unroll
      for (int j = 0; j < KS / 2; ++j) {
        uint32_t lo[4], hi[4];
        frag(j, lo);
        frag(j + KS / 2, hi);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              Kr + (ko + 8 * n + g) * L::RS + 4 * tq + 16 * j);
          mma_bf16(s[n], lo, i4_pair(w), i4_pair(w >> 8));
          mma_bf16(s[n], hi, i4_pair(w >> 4), i4_pair(w >> 12));
        }
      }
    }

    // the tile columns of element e of n-tile n, for the scales and mask
    auto col = [&](int n, int e) {
      return TOK ? ko + 16 * (n >> 1) + 4 * tq + 2 * (e & 1) + (n & 1)
                 : ko + 8 * n + 2 * tq + (e & 1);
    };
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col(n, e);
        float x = s[n][e] * ksc[c];
        // softcap acts on the scaled scores, before masking
        if (cap2 > 0.f) x = cap2 * tanhf(x / cap2);
        s[n][e] = pb.keep(wr + g + 8 * (e >> 1), j0 + c) ? x : -INFINITY;
      }
    float mx[2];
    tile_row_max(s, mx);
    if constexpr (KG > 1) {
      // the key groups share each tile's row max, so that P is rounded to
      // bf16 against the running max of whole 64-key tiles, as the plain
      // version and the TPU kernel round it, and not a group's own
      // (one slot: the last reads of it precede the next tile's barrier)
      float* xm = reinterpret_cast<float*>(smem_raw + STAGES * L::STAGE);
      if (tq == 0) {
        xm[warp * 16 + g] = mx[0];
        xm[warp * 16 + g + 8] = mx[1];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < KG; ++k)
          mx[i] = fmaxf(mx[i], xm[k * 16 + g + 8 * i]);
    }
    softmax_tile(s, mx, mrow, lrow, o);
    // the value scales fold into P's columns, after the row sum
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= vsc[col(n, e)];

    // P·V, 16 keys a step: P's logical k 2tq, 2tq+1 are the columns 2tq,
    // 2tq+1 of n-tile 2ks, k 2tq+8, 2tq+9 those of n-tile 2ks + 1
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const int kb = ko + 16 * ks;
      if constexpr (TOK) {
        // tokens kb + 4tq (+2) are the low nibbles of packed rows kb/2 +
        // 2tq (+1), tokens kb + 4tq + 1 (+3) their high nibbles
        const unsigned char* v0 = Vr + (kb / 2 + 2 * tq) * L::RS + 4 * g;
#pragma unroll
        for (int b = 0; b < VB; ++b) {
          const uint32_t w0 =
              *reinterpret_cast<const uint32_t*>(v0 + 32 * b);
          const uint32_t w1 =
              *reinterpret_cast<const uint32_t*>(v0 + L::RS + 32 * b);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t x = pair_bytes(w0, w1, i);
            mma_bf16(o[4 * b + i], a, i4_pair(x), i4_pair(x >> 4));
          }
        }
      } else {
        // keys kb + 2tq, +1 (b0) and kb + 2tq + 8, +9 (b1)
        const unsigned char* v0 = Vr + (kb + 2 * tq) * L::RS + VW * g;
#pragma unroll
        for (int b = 0; b < VB; ++b) {
          uint32_t w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const unsigned char* p =
                v0 + ((r & 1) + 8 * (r >> 1)) * L::RS + 8 * VW * b;
            w[r] = VW == 4 ? *reinterpret_cast<const uint32_t*>(p)
                           : *reinterpret_cast<const uint16_t*>(p);
          }
#pragma unroll
          for (int i = 0; i < VW; ++i) {
            const uint32_t x01 = pair_bytes(w[0], w[1], i);
            const uint32_t x23 = pair_bytes(w[2], w[3], i);
            if constexpr (ST == Storage::INT8) {
              mma_bf16(o[VW * b + i], a, i8_pair(x01), i8_pair(x23));
            } else {
              mma_bf16(o[VW * b + i], a, i4_pair(x01), i4_pair(x23));
              mma_bf16(o[OT / 2 + VW * b + i], a, i4_pair(x01 >> 4),
                       i4_pair(x23 >> 4));
            }
          }
        }
      }
    }
  }

  // a NaN anywhere in a row's accumulator makes its sum NaN (the four
  // threads of the row agree)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int bad = 0;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      bad |= (o[j][2 * i] != o[j][2 * i]) | (o[j][2 * i + 1] != o[j][2 * i + 1]);
    bad |= __shfl_xor_sync(0xffffffffu, bad, 1);
    bad |= __shfl_xor_sync(0xffffffffu, bad, 2);
    if (bad) lrow[i] = NAN;
  }

  if constexpr (KG > 1) {
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring the merge reuses
    if (!merge_key_groups<KG, D>(o, mrow, lrow,
                                 reinterpret_cast<float*>(smem_raw)))
      return;
  }

  // o[np][2i + h] is row g + 8i, kernel feature `feat(np, h)` (each
  // thread holds 2·VW consecutive kernel features of each block); where
  // the rows are not whole, its logical feature, -1 past the row
  auto feat = [&](int np, int h) {
    const int half = ST == Storage::INT4_FEATURE && np >= OT / 2;
    const int n = np - half * (OT / 2);
    const int f = half * (D / 2) + 8 * VW * (n / VW) + 2 * VW * tq +
                  VW * h + n % VW;
    if constexpr (whole)
      return f;
    else
      return logical_feature<ST, D>(f, kv.d);
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    float* acc = pb.acc_row(r);
    if (acc != nullptr) {
#pragma unroll
      for (int np = 0; np < OT; ++np)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = feat(np, h);
          if (f >= 0) acc[f] = o[np][2 * i + h];
        }
      if (tq == 0) pb.put_stats(r, mrow[i], lrow[i]);
      continue;
    }
    __nv_bfloat16* dst = pb.o_row(r);
    if (dst == nullptr) continue;
    // a row that attended nothing has l == 0 and an all-zero accumulator
    const float inv = lrow[i] == 0.f ? 1.f : 1.f / lrow[i];
    if constexpr (whole) {
      // features feat(np, h) and feat(np + 1, h) are neighbours for even
      // np within a block
#pragma unroll
      for (int np = 0; np < OT; np += 2)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(dst + feat(np, h)) = pack_bf16(
              o[np][2 * i + h] * inv, o[np + 1][2 * i + h] * inv);
      continue;
    }
#pragma unroll
    for (int np = 0; np < OT; ++np)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = feat(np, h);
        if (f >= 0) dst[f] = __float2bfloat16_rn(o[np][2 * i + h] * inv);
      }
  }
}

// The tile loop of a quantized cache's rows (decode_kernel's `Tiles`).
template <Storage ST, bool ANY>
struct QuantLoop {
  static constexpr bool OWN_LOOP = true;
  template <int D, int KG, int STAGES, typename Problem>
  __device__ static void attend(const Problem& pb, float qscale,
                                float cap2) {
    attend_quant<ST, D, ANY, KG, STAGES>(pb, qscale, cap2);
  }
  // the ring, the key groups' tile maxima and at D > 128 the q
  // fragments, or the key groups' merge where that is larger
  template <int D, int KG, int STAGES>
  static constexpr size_t smem_bytes() {
    const size_t ring = (size_t)q_frag_offset<ST, D, KG, STAGES>() +
                        (D > 128 ? (size_t)(D / 16) * THREADS * 16 : 0);
    const size_t merge = KG > 1 ? 4 * 16 * (D + 2) * sizeof(float) : 0;
    return ring > merge ? ring : merge;
  }
};

// A quantized (B, Hkv, ...) cache: stored rows with byte strides (batch,
// head, row) and a contiguous last dim, scales contiguous (B, Hkv, N);
// whether q is fp32 (else bf16); the head dim d, the bytes rb of a stored
// row and the copies `gran` (16, 4 or 1 bytes) that stage them (ANY).
template <Storage ST, bool ANY>
struct QuantSource {
  const signed char* k;
  const signed char* v;
  const float* ks;
  const float* vs;
  int Hkv, N, q_f32, d, rb, gran;
  long long skb, skh, skn, svb, svh, svn;

  template <typename T>
  struct Rows {
    using Tiles = QuantLoop<ST, ANY>;
    const signed char* k;
    const signed char* v;
    const float* ks;
    const float* vs;
    long long skn, svn;
    int q_f32, d, rb, gran;
  };

  template <typename T>
  __device__ Rows<T> rows(int b, int kvh) const {
    const long long sc = ((long long)b * Hkv + kvh) * N;
    return {k + b * skb + kvh * skh, v + b * svb + kvh * svh, ks + sc,
            vs + sc, skn, svn, q_f32, d, rb, gran};
  }
};

// fn(D, KG, ANY) for the instance that takes head dim d (1 to 256: D =
// 32, 64, 128 or 256, the least at or above d), key groups kg (1 or 4)
// and rows that are whole at D and aligned (any false) or not, as
// integral constants.
template <typename Fn>
int with_quant_kernel(int d, int kg, bool any, Fn fn) {
  auto pick = [&](auto dk) -> int {
    using yes = std::true_type;
    using no = std::false_type;
    if (kg == 4)
      return any ? fn(dk, std::integral_constant<int, 4>{}, yes{})
                 : fn(dk, std::integral_constant<int, 4>{}, no{});
    return any ? fn(dk, std::integral_constant<int, 1>{}, yes{})
               : fn(dk, std::integral_constant<int, 1>{}, no{});
  };
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (d <= 32) return pick(std::integral_constant<int, 32>{});
  if (d <= 64) return pick(std::integral_constant<int, 64>{});
  if (d <= 128) return pick(std::integral_constant<int, 128>{});
  return pick(std::integral_constant<int, 256>{});
}

// the D of the instances that take head dim d (1 to 256)
inline int instance_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// The C entries' body.  q is (B, H, S, d), fp32 (q_f32) or bf16, and o (B,
// H, S, d) bf16, both with element strides (batch, head, token) and a
// contiguous last dim; k/v and their byte strides as in QuantSource, any
// alignment; ks/vs (B, Hkv, N) fp32; lens (B,) int32 after the append (a
// negative length reads as 0).  Head dims 1 to 256, even for int4.
// qscale is the fp32 of scale·log2(e).
// window <= 0 means none (sinks then ignored), softcap <= 0 none.  splits
// and chunk are the key split of `split_plan`
// (attention_tpu_torch/ops/decode.py); with splits > 1, part is contiguous
// fp32 scratch of B·H·S·splits·(d + 2) values.  kg = 4 puts the four warps
// on one 16-row tile, which a kv head's rows (group·S) must fit, kg = 1
// takes 64-row blocks (`quant.launch_plan` picks).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
template <Storage ST>
int quant_decode_entry(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* lens,
                       void* o, void* part, int q_f32, int B, int H, int Hkv,
                       int S, int N, int d, long long sqb, long long sqh,
                       long long sqs, long long skb, long long skh,
                       long long skn, long long svb, long long svh,
                       long long svn, long long sob, long long soh,
                       long long sos, int window, int sinks, float qscale,
                       float softcap, int splits, int chunk, int kg,
                       void* stream) {
  DecodeArgs a{};
  a.q = q;
  a.o = o;
  a.lens = static_cast<const int*>(lens);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.dk = d;
  a.dv = d;
  a.n_cap = N;
  a.window = window > 0 ? window : 0;
  a.sinks = window > 0 ? sinks : 0;
  // decode_kernel steps q's rows as bf16: fp32 strides count 2-byte units
  const long long unit = q_f32 ? 2 : 1;
  a.sqb = sqb * unit;
  a.sqh = sqh * unit;
  a.sqs = sqs * unit;
  a.sob = sob;
  a.soh = soh;
  a.sos = sos;
  a.qscale = qscale;
  a.cap2 = softcap > 0.f ? softcap * LOG2E : 0.f;
  set_splits(a, B, splits, chunk, part);
  // the widest copies that every stored row's bytes fill at aligned
  // addresses
  const int rb = ST == Storage::INT4_FEATURE ? d / 2 : d;
  auto whole = [&](int g) {
    const long long st[6] = {skb, skh, skn, svb, svh, svn};
    for (long long x : st)
      if (x % g) return false;
    return rb % g == 0 && reinterpret_cast<uintptr_t>(k) % g == 0 &&
           reinterpret_cast<uintptr_t>(v) % g == 0;
  };
  const int gran = whole(16) ? 16 : whole(4) ? 4 : 1;
  const bool any = d != instance_dim(d) || gran != 16 || !rows_aligned(a);
  const bool layout = (ST == Storage::INT8 || d % 2 == 0) &&
                      (ST != Storage::INT4_TOKENS || (S == 1 && N % 2 == 0));
  const bool rows_fit = kg == 1 || (kg == 4 && H / Hkv * S <= 16);
  if (!decode_args_ok(a, B) || !layout || !rows_fit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_quant_kernel(d, kg, any, [&](auto dk, auto g, auto an) {
    const QuantSource<ST, decltype(an)::value> src{
        static_cast<const signed char*>(k), static_cast<const signed char*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs), Hkv, N,
        q_f32 ? 1 : 0, d, rb, gran, skb, skh, skn, svb, svh, svn};
    return (int)launch_decode<__nv_bfloat16, 0, decltype(dk)::value,
                              decltype(dk)::value, decltype(g)::value>(
        a, src, B, s);
  });
}

// What the instance a call at head dim d with whole, aligned rows runs
// costs an SM (the ANY instance where d is not its D): out[0] registers a
// thread, out[1] dynamic shared bytes a CTA, out[2] CTAs an SM can hold,
// out[3] local (spilled) bytes a thread, out[4] its D.  Returns a CUDA
// error code.
template <Storage ST>
int quant_decode_resources(int d, int kg, int* out) {
  const bool any = d != instance_dim(d);
  return with_quant_kernel(d, kg, any, [&](auto dk, auto g, auto an) {
    constexpr int D = decltype(dk)::value;
    constexpr int KG = decltype(g)::value;
    using Src = QuantSource<ST, decltype(an)::value>;
    auto kernel = decode_kernel<__nv_bfloat16, 0, D, D, KG, Src>;
    const size_t smem = decode_smem<__nv_bfloat16, 0, D, D, KG, Src>(D, D);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaFuncAttributes at;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kernel);
    int ctas = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                          THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = at.numRegs;
    out[1] = (int)smem;
    out[2] = ctas;
    out[3] = (int)at.localSizeBytes;
    out[4] = D;
    return 0;
  });
}

}  // namespace atk
