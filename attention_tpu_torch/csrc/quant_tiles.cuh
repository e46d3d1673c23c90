// Decode against a quantized KV cache: the storage formats, the loader that
// turns their rows into the bf16 tiles of `attend_mma`, and the C entry
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
// column, out = (P ∘ s_V) · V_q.  q arrives pre-scaled by scale·log2(e) and
// rounded to bf16 (the wrapper does it, as the TPU wrapper did), the key
// scale multiplies the score before softcap and the mask, and the value
// scale multiplies P after the row sum and before P is rounded to bf16.
// The output is bf16.
//
// The loader `QuantTiles` stages one 64-token tile per buffer with cp.async:
// its 64 key and 64 value scales (zero past n_end) and its stored rows (zero
// past n_end).  Once they have landed, every thread dequantizes 16-byte
// chunks into the bf16 K and V tiles that the tensor-core loop reads with
// ldmatrix, tokens in their natural order (the token-paired layout's two
// nibbles go to rows 2r and 2r + 1, so the mask needs no remapping).  A NaN
// scale (an overflowing append poisons its rows so) makes its score, its
// probability and the row sum NaN, so the row comes out NaN although the
// row maxima (fmaxf) pass over it.
#pragma once

#include "decode_rows.cuh"

namespace atk {

enum class Storage { INT8, INT4_FEATURE, INT4_TOKENS };

// bytes of one stored row at head dim D
template <Storage ST, int D>
__host__ __device__ constexpr int row_bytes() {
  return ST == Storage::INT4_FEATURE ? D / 2 : D;
}

__device__ __forceinline__ float lo_nibble(int b) {
  return (float)(((b & 0xF) ^ 8) - 8);
}
// b is the signed byte, widened: the shift is arithmetic
__device__ __forceinline__ float hi_nibble(int b) { return (float)(b >> 4); }

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 16 bf16 values (8 registers) to 32 bytes of shared memory
__device__ __forceinline__ void store16(__nv_bfloat16* to,
                                        const uint32_t (&w)[8]) {
  reinterpret_cast<uint4*>(to)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(to)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <Storage ST>
struct QuantTiles {
  static constexpr bool SCALED = true;
  static constexpr int TPR = ST == Storage::INT4_TOKENS ? 2 : 1;  // tokens
                                                                  // per row
  static constexpr int SROWS = MMA_BN / TPR;  // stored rows per tile
  static_assert(THREADS == 2 * MMA_BN, "one scale per thread");

  // stage: k scales [MMA_BN], v scales [MMA_BN], K rows, V rows
  template <int DK, int DV>
  __host__ __device__ static constexpr int stage_bytes() {
    return 2 * MMA_BN * (int)sizeof(float) +
           SROWS * (row_bytes<ST, DK>() + row_bytes<ST, DV>());
  }

  // stored rows holding tokens j0 .. j0 + MMA_BN - 1 of `src` (row stride
  // `stride` bytes) into `dst`, zeros for rows past n_end
  template <int RB>
  __device__ static void stage_rows(unsigned char* dst, const signed char* src,
                                    long long stride, int j0, int n_end) {
    static_assert(RB % 16 == 0, "16-byte chunks");
    constexpr int CH = RB / 16;
    for (int idx = threadIdx.x; idx < SROWS * CH; idx += THREADS) {
      const int r = idx / CH;
      const int c = (idx - r * CH) * 16;
      unsigned char* to = dst + r * RB + c;
      if (j0 + TPR * r < n_end)
        cp_async16(to, src + (long long)(j0 / TPR + r) * stride + c);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
    }
  }

  template <int DK, int DV, typename Problem>
  __device__ static void prefetch(const Problem& pb, __nv_bfloat16*,
                                  __nv_bfloat16*, unsigned char* st, int j0) {
    const auto& kv = pb.kv;
    const int i = threadIdx.x;
    const int c = i & (MMA_BN - 1);
    float* to = reinterpret_cast<float*>(st) + i;  // k: [0, 64), v: [64, 128)
    if (j0 + c < pb.n_end)
      cp_async4(to, (i < MMA_BN ? kv.ks : kv.vs) + j0 + c);
    else
      *to = 0.f;
    unsigned char* rows = st + 2 * MMA_BN * sizeof(float);
    stage_rows<row_bytes<ST, DK>()>(rows, kv.k, kv.skn, j0, pb.n_end);
    stage_rows<row_bytes<ST, DV>()>(rows + SROWS * row_bytes<ST, DK>(), kv.v,
                                    kv.svn, j0, pb.n_end);
  }

  // stored rows at `src` -> bf16 tile rows of D values (stride D + 8)
  template <int D>
  __device__ static void dequant(__nv_bfloat16* dst,
                                 const unsigned char* src) {
    constexpr int RB = row_bytes<ST, D>();
    constexpr int CH = RB / 16;
    for (int idx = threadIdx.x; idx < SROWS * CH; idx += THREADS) {
      const int r = idx / CH;
      const int c = (idx - r * CH) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * RB + c);
      const signed char* b = reinterpret_cast<const signed char*>(&raw);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b0 = b[2 * i], b1 = b[2 * i + 1];
        if constexpr (ST == Storage::INT8) {
          lo[i] = pack_bf16((float)b0, (float)b1);
        } else {
          lo[i] = pack_bf16(lo_nibble(b0), lo_nibble(b1));
          hi[i] = pack_bf16(hi_nibble(b0), hi_nibble(b1));
        }
      }
      if constexpr (ST == Storage::INT8) {
        store16(dst + r * (D + 8) + c, lo);
      } else if constexpr (ST == Storage::INT4_FEATURE) {
        store16(dst + r * (D + 8) + c, lo);
        store16(dst + r * (D + 8) + c + D / 2, hi);
      } else {
        store16(dst + 2 * r * (D + 8) + c, lo);
        store16(dst + (2 * r + 1) * (D + 8) + c, hi);
      }
    }
  }

  template <int DK, int DV>
  __device__ static void land(__nv_bfloat16* K, __nv_bfloat16* V,
                              const unsigned char* st) {
    const unsigned char* rows = st + 2 * MMA_BN * sizeof(float);
    dequant<DK>(K, rows);
    dequant<DV>(V, rows + SROWS * row_bytes<ST, DK>());
    __syncthreads();  // the tiles are complete for every warp
  }

  __device__ static float k_scale(const unsigned char* st, int c) {
    return reinterpret_cast<const float*>(st)[c];
  }
  __device__ static float v_scale(const unsigned char* st, int c) {
    return reinterpret_cast<const float*>(st)[MMA_BN + c];
  }
};

// A quantized (B, Hkv, ...) cache: stored rows with byte strides (batch,
// head, row) and a contiguous last dim, scales contiguous (B, Hkv, N).
template <Storage ST>
struct QuantSource {
  const signed char* k;
  const signed char* v;
  const float* ks;
  const float* vs;
  int Hkv, N;
  long long skb, skh, skn, svb, svh, svn;

  template <typename T>
  struct Rows {
    using Tiles = QuantTiles<ST>;
    const signed char* k;
    const signed char* v;
    const float* ks;
    const float* vs;
    long long skn, svn;
  };

  template <typename T>
  __device__ Rows<T> rows(int b, int kvh) const {
    const long long sc = ((long long)b * Hkv + kvh) * N;
    return {k + b * skb + kvh * skh, v + b * svb + kvh * svh, ks + sc,
            vs + sc, skn, svn};
  }
};

// The C entries' body.  q is (B, H, S, d) bf16, pre-scaled by
// scale·log2(e), and o (B, H, S, d) bf16, both with element strides (batch,
// head, token) and a contiguous last dim; k/v and their byte strides as in
// QuantSource; ks/vs (B, Hkv, N) fp32; lens (B,) int32 after the append (a
// negative length reads as 0).  Head dims 32, 64 and 128.  window <= 0
// means none (sinks then ignored), softcap <= 0 none.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
template <Storage ST>
int quant_decode_entry(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* lens,
                       void* o, int B, int H, int Hkv, int S, int N, int d,
                       long long sqb, long long sqh, long long sqs,
                       long long skb, long long skh, long long skn,
                       long long svb, long long svh, long long svn,
                       long long sob, long long soh, long long sos,
                       int window, int sinks, float softcap, void* stream) {
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
  a.sqb = sqb;
  a.sqh = sqh;
  a.sqs = sqs;
  a.sob = sob;
  a.soh = soh;
  a.sos = sos;
  a.qscale = 1.f;  // q arrives pre-scaled
  a.cap2 = softcap > 0.f ? softcap * LOG2E : 0.f;
  a.splits = 1;  // one CTA walks a sequence's keys: no split, no merge
  const QuantSource<ST> src{static_cast<const signed char*>(k),
                            static_cast<const signed char*>(v),
                            static_cast<const float*>(ks),
                            static_cast<const float*>(vs),
                            Hkv, N, skb, skh, skn, svb, svh, svn};
  const bool aligned = rows_aligned(a) && skb % 16 == 0 && skh % 16 == 0 &&
                       skn % 16 == 0 && svb % 16 == 0 && svh % 16 == 0 &&
                       svn % 16 == 0 && aligned16(k) && aligned16(v) &&
                       (ST != Storage::INT4_TOKENS || (S == 1 && N % 2 == 0));
  if (!decode_args_ok(a, B) || !aligned) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using Src = QuantSource<ST>;
  switch (d) {
    case 32:
      return (int)launch_decode<bf16, 0, 32, 32, 1, Src>(a, src, B, s);
    case 64:
      return (int)launch_decode<bf16, 0, 64, 64, 1, Src>(a, src, B, s);
    case 128:
      return (int)launch_decode<bf16, 0, 128, 128, 1, Src>(a, src, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace atk
