// The backward of flash attention for Hopper (sm_90a): the bodies of the
// three kernels of flash_bwd_fused.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu.
//
// Each recomputes the probabilities from the forward's saved log-sum-exp
// instead of storing them, as the TPU kernels of
// attention_tpu/ops/flash_bwd.py do (`_p_and_ds`, :123):
//
//   S2 = Qs·Kᵀ              Qs = Q·scale·log2 e, rounded to the input dtype
//   P  = exp2(S2 - lse2)    lse2 = lse·log2 e, P = 0 where masked or lse2 = -inf
//   dP = dO·Vᵀ              dS = P ∘ (dP - delta) ∘ (1 - tanh²) under softcap
//   dV = Pᵀ·dO   dK = ln2 · dSᵀ·Qs   dQ = scale · dS·K
//
// with delta = rowsum(dO ∘ O) computed by the caller, P and dS rounded to
// the input dtype before each product (fp32 accumulation), causal masking
// by global positions (query row i at q_offset + i, key row j at
// kv_offset + j), only the first kv_valid key rows attended, under a
// sliding window (causal only) only the keys of a row's band (j + kv_offset
// > i + q_offset - window: the sinks of a windowed forward are the
// caller's `sink_patch`, as they are the TPU kernels' caller's), softcap
// in the log2 domain (cap2 = softcap·log2 e), and packed-sequence segment
// ids (one int32 a query row and a key row, shared across heads: a pair is
// kept only where they are equal).
//
// with lse2 and delta read at row stride ls (the caller pads each head's
// rows, lse2 with +inf: exp2(s - inf) is the 0 of a row that saw no key).
//
// The bf16 bodies at dk = dv = 64 or 128 are Hopper's own: the key-major
// `flash_bwd_wgmma` (flash_bwd_sm90.cuh; with dQ for the fused kernel,
// without it for the dK/dV kernel) and the query-major
// `flash_bwd_dq_wgmma` (flash_bwd_dq_sm90.cuh).  This file holds what
// they share with the FMA bodies (`BwdArgs`, the checks of a call) and
// the FMA bodies themselves, which take fp32 and bf16 at the other head
// dims up to 128 or with unaligned operands: fp32 FMA on the CUDA cores,
// bf16 widened on its way into shared memory, thread (tr, tc) owning a
// 4 x 4 block of each score tile as in `atk::attend`, 128 threads a CTA.
//
// key-major (`kv_major_fma`): a CTA owns a block of KB key rows and walks
// the query tiles in a loop that takes the place of the TPU grid's
// sequential q axis, keeping dK and dV in fp32 registers.  The dK/dV kernel
// (replaces `_dkv_kernel`, flash_bwd.py:215) walks the query tiles of every
// Q head of its KV head's GQA group, so the group sum stays in the kernel;
// the fused kernel (replaces `_fused_bwd_kernel`, :304) owns one Q head and
// writes per-Q-head partials that the caller sums over the group, and adds
// each tile's dQ = scale·dS·K into an fp32 (B, H, m, dk) buffer with
// atomicAdd: CTAs run in no order, and the TPU kernel's resident dQ block
// has no counterpart on the GPU.  A causal CTA starts at the first query
// tile that sees its keys and, under a window, stops after the last.
//
// query-major (`q_major_fma`, replaces `_dq_kernel`, :146): a CTA owns QB
// query rows and walks the key tiles up to the causal diagonal (under a
// window from its first row's band on), keeping dQ in fp32 registers, and
// writes it once in the input dtype.
//
// What bounds them on the H100: the fused backward does 10·h·m·n·d
// operations (halved under causal) on 4·h·m·d + 2·hkv·n·d values plus
// fp32 gradients, far above the ~295 operations per byte where bf16 work
// stops being bound by memory, so it is bound by the tensor cores' 989
// TFLOP/s (the two-kernel pair recomputes S and dP: 14·h·m·n·d).  The
// design keeps P, dP and dS out of device memory; the fused FMA body's dQ
// atomics (h·m·d per key block) are its one extra traffic.
#pragma once

#include "attention_tile.cuh"

namespace atb {

using atk::THREADS;
using bf16 = __nv_bfloat16;

constexpr int KB = 64;   // key rows per CTA of the key-major kernels
constexpr int QB = 64;   // query rows per CTA of the query-major kernel
constexpr int QT = 32;   // query rows per tile of the key-major kernels
constexpr int FKT = 32;  // key rows per tile of query-major fma kernel
constexpr int MAX_HEAD_DIM = 128;

enum Mode { FUSED = 0, DQ = 1, DKV = 2 };

struct BwdArgs {
  const void* qs;      // (B, H, m, dk) Q·scale·log2 e in the input dtype
  const void* k;       // (B, Hkv, n, dk)
  const void* v;       // (B, Hkv, n, dv)
  const void* dout;    // (B, H, m, dv)
  const float* lse2;   // (B, H, ls) log2-domain log-sum-exp, contiguous
  const float* delta;  // (B, H, ls) rowsum(dO ∘ O), contiguous
  float* dq32;         // fused: (B, H, m, dk) fp32, zeroed by the caller
  void* dq;            // dQ kernel: (B, H, m, dk), input dtype, contiguous
  float* dk;           // (B, Hout, n, dk) fp32, contiguous; Hout = H
  float* dv;           // (B, Hout, n, dv)   (fused) or Hkv (dK/dV)
  int H, Hkv, m, n, d, dvd, ls;
  // element strides (batch, head, row) of qs, k, v, dout
  long long sqb, sqh, sqm, skb, skh, skn, svb, svh, svn, sob, soh, som;
  float scale, cap2;
  int causal, q_offset, kv_offset, kv_valid;
  int window;  // causal only: a row keeps the keys of its last `window`
               // positions; 0: no window
  // segment ids, or null: the rows' (ls, padded) and the keys' (n rounded
  // up to whole 128-key blocks), the paddings ids no real row holds
  const int* q_seg;
  const int* kv_seg;
};

// P and dS of the pair (query row q, key row key) from its log2-domain
// score s and dP = dO·v: on return s holds P and dp holds dS
__device__ __forceinline__ void p_and_ds(const BwdArgs& a, int q, int key,
                                         float lse2, float delta, float& s,
                                         float& dp) {
  float dcap = 1.f;
  if (a.cap2 > 0.f) {
    const float t = tanhf(s / a.cap2);
    s = a.cap2 * t;
    dcap = 1.f - t * t;
  }
  // a row the forward fully masked has lse2 == -inf: P = 0, not inf
  const int lag = q + a.q_offset - (key + a.kv_offset);  // causal: >= 0
  const bool keep = key < a.kv_valid && lse2 != -INFINITY &&
                    (!a.causal || (lag >= 0 && (a.window <= 0 ||
                                                lag < a.window))) &&
                    (a.q_seg == nullptr || a.q_seg[q] == a.kv_seg[key]);
  const float p = keep ? exp2f(s - lse2) : 0.f;
  s = p;
  dp = p * (dp - delta) * dcap;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return atk::to_f(atk::from_f<T>(x));
}

// the (batch, head) a CTA works on and its row stats
struct Heads {
  int b, h_first, heads, hk, out;  // out: the output head index (bh)
};

template <int MODE>
__device__ Heads kv_heads(const BwdArgs& a) {
  const int group = a.H / a.Hkv;
  const int hout = MODE == FUSED ? a.H : a.Hkv;
  Heads r;
  r.out = blockIdx.y;
  r.b = r.out / hout;
  const int hh = r.out - r.b * hout;
  r.hk = MODE == FUSED ? hh / group : hh;
  r.h_first = MODE == FUSED ? hh : hh * group;
  r.heads = MODE == FUSED ? 1 : group;
  return r;
}

// first query tile (of width W) whose rows can see key row k0
__device__ __forceinline__ int first_q_tile(const BwdArgs& a, int k0, int W) {
  if (!a.causal) return 0;
  const int x = k0 + a.kv_offset - a.q_offset;
  return x <= 0 ? 0 : x / W;
}

// the end of the query tiles (of width W) whose rows can see a key of the
// block [k0, k0 + rows): all of them, or under a window the tile past the
// last row that sees the block's last key below kv_valid, window - 1 rows
// after that key's first
__device__ __forceinline__ int q_tile_end(const BwdArgs& a, int k0, int rows,
                                          int W) {
  const int tiles = (a.m + W - 1) / W;
  if (!a.causal || a.window <= 0) return tiles;
  const int span = min(rows, min(a.kv_valid, a.n) - k0);  // keys below it
  const int last = k0 + span - 1 + a.kv_offset - a.q_offset + a.window - 1;
  return last < 0 ? 0 : min(tiles, last / W + 1);
}

// keys a query block [q0, q0 + rows) visits: none past kv_valid, none past
// the block's causal diagonal
__device__ __forceinline__ int key_end(const BwdArgs& a, int q0, int rows) {
  const int valid = min(a.kv_valid, a.n);
  return a.causal ? max(0, min(valid, q0 + rows + a.q_offset - a.kv_offset))
                  : valid;
}

// the first key (a multiple of W) a query block starting at row q0 visits:
// 0, or under a window the tile of its first row's band
__device__ __forceinline__ int key_begin(const BwdArgs& a, int q0, int W) {
  if (!a.causal || a.window <= 0) return 0;
  const int x = q0 + a.q_offset - a.kv_offset - a.window + 1;
  return x <= 0 ? 0 : x / W * W;
}

// --------------------------------------------------------------- fp32 FMA

constexpr int KTS = KB + 4;   // row stride of [col][key] tiles (transposed)
constexpr int QTS = QT + 4;   // row stride of [col][query] tiles (kv-major)
constexpr int QBS = QB + 4;   // row stride of [col][query] tiles (q-major)
constexpr int FKS = FKT + 4;  // row stride of [col][key] tiles (q-major)

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows x cols values of rows row(r) (nullptr: zeros) into shared memory,
// widened to fp32: transposed (t[c * ts + r]) and, when rm is set,
// row-major (rm[r * rs + c], columns up to rs zero-filled)
template <typename T, typename RowFn>
__device__ void stage(float* t, int ts, float* rm, int rs, int rows,
                      int cols, RowFn row) {
  const int width = rm ? rs : cols;
  for (int idx = threadIdx.x; idx < rows * width; idx += THREADS) {
    const int r = idx / width;
    const int c = idx - r * width;
    const T* src = c < cols ? row(r) : nullptr;
    const float x = src ? atk::to_f(src[c]) : 0.f;
    if (c < cols) t[c * ts + r] = x;
    if (rm) rm[r * rs + c] = x;
  }
}

// s[i][j] += Σ_c a[c][4·ra + i] · b[c][4·rb + j] over transposed tiles
__device__ __forceinline__ void outer4(float (&s)[4][4], const float* a,
                                       int as, const float* b, int bs,
                                       int depth) {
  for (int c = 0; c < depth; ++c) {
    const float4 x = atk::lds4(a + c * as);
    const float4 y = atk::lds4(b + c * bs);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

// acc[i][q][e] += Σ_c x[c][4·tr + i] · y[c][4·tc + 32·q + e], x a
// [depth][xs] tile, y row-major with row stride ys (columns past ys read 0)
template <int NQ>
__device__ __forceinline__ void accumulate(float (&acc)[4][NQ][4],
                                           const float* x, int xs,
                                           const float* y, int ys, int depth,
                                           int tr, int tc) {
  for (int c = 0; c < depth; ++c) {
    const float4 p4 = atk::lds4(x + c * xs + 4 * tr);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = 4 * tc + 32 * q;
      const float4 v4 = col < ys ? atk::lds4(y + c * ys + col) : zero4();
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] = fmaf(p[i], vv[e], acc[i][q][e]);
    }
  }
}

// Shared memory (bytes) of kv_major_fma: Kᵀ, Vᵀ (resident), Qsᵀ, dOᵀ and
// their row-major copies per tile, Pᵀ and dSᵀ as [query][key].
inline size_t smem_kv_fma(int d, int dv) {
  return sizeof(float) *
         ((size_t)(d + dv) * (KTS + QTS) +
          (size_t)QT * (atk::v_stride(d) + atk::v_stride(dv)) + 2 * QT * KTS);
}

template <typename T, int NJ, int MODE>
__global__ void __launch_bounds__(THREADS) kv_major_fma(BwdArgs a) {
  constexpr int NQ = NJ / 4;
  extern __shared__ float smem[];
  const int d = a.d, dvd = a.dvd;
  const int dps = atk::v_stride(d), dvs = atk::v_stride(dvd);
  float* Kt = smem;            // [d][KTS]
  float* Vt = Kt + d * KTS;    // [dv][KTS]
  float* Qt = Vt + dvd * KTS;  // [d][QTS]
  float* Ot = Qt + d * QTS;    // [dv][QTS]
  float* Qr = Ot + dvd * QTS;  // [QT][dps]
  float* Or = Qr + QT * dps;   // [QT][dvs]
  float* Pt = Or + QT * dvs;   // [QT][KTS]
  float* St = Pt + QT * KTS;   // [QT][KTS]
  const Heads hd = kv_heads<MODE>(a);
  const int k0 = blockIdx.x * KB;
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const T* kp = static_cast<const T*>(a.k) + hd.b * a.skb + hd.hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + hd.b * a.svb + hd.hk * a.svh;
  const int i0 = first_q_tile(a, k0, QT);
  const int per_head = k0 < min(a.kv_valid, a.n)
                           ? max(q_tile_end(a, k0, KB, QT) - i0, 0) : 0;
  const int ntiles = hd.heads * per_head;

  stage<T>(Kt, KTS, nullptr, 0, KB, d, [&](int r) {
    return k0 + r < a.n ? kp + (k0 + r) * a.skn : nullptr;
  });
  stage<T>(Vt, KTS, nullptr, 0, KB, dvd, [&](int r) {
    return k0 + r < a.n ? vp + (k0 + r) * a.svn : nullptr;
  });

  float dk[4][NQ][4], dv[4][NQ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][q][e] = dv[i][q][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int h = hd.h_first + t / per_head;
    const int q0 = (i0 + t % per_head) * QT;
    const T* qp = static_cast<const T*>(a.qs) + hd.b * a.sqb + h * a.sqh;
    const T* op = static_cast<const T*>(a.dout) + hd.b * a.sob + h * a.soh;
    __syncthreads();  // the previous tile's readers are done
    stage<T>(Qt, QTS, Qr, dps, QT, d, [&](int r) {
      return q0 + r < a.m ? qp + (q0 + r) * a.sqm : nullptr;
    });
    stage<T>(Ot, QTS, Or, dvs, QT, dvd, [&](int r) {
      return q0 + r < a.m ? op + (q0 + r) * a.som : nullptr;
    });
    __syncthreads();

    // Sᵀ and dPᵀ: key rows 4·tr + i, queries 4·tc + j
    float s[4][4] = {}, dp[4][4] = {};
    outer4(s, Kt + 4 * tr, KTS, Qt + 4 * tc, QTS, d);
    outer4(dp, Vt + 4 * tr, KTS, Ot + 4 * tc, QTS, dvd);
    const long long row0 = ((long long)hd.b * a.H + h) * a.m;
    const long long lrow = ((long long)hd.b * a.H + h) * a.ls;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + 4 * tc + j;
      const float l2 = q < a.m ? a.lse2[lrow + q] : -INFINITY;
      const float dl = q < a.m ? a.delta[lrow + q] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p_and_ds(a, q, k0 + 4 * tr + i, l2, dl, s[i][j], dp[i][j]);
        Pt[(4 * tc + j) * KTS + 4 * tr + i] = round_to<T>(s[i][j]);
        St[(4 * tc + j) * KTS + 4 * tr + i] = round_to<T>(dp[i][j]);
      }
    }
    __syncthreads();
    accumulate<NQ>(dv, Pt, KTS, Or, dvs, QT, tr, tc);  // dV += Pᵀ·dO
    accumulate<NQ>(dk, St, KTS, Qr, dps, QT, tr, tc);  // dK += dSᵀ·Qs

    if constexpr (MODE == FUSED) {
      // this tile's dQ = scale·dS·K: lane = query row, warps split columns
      float* dq = a.dq32 + row0 * d;
      for (int idx = tid; idx < QT * d; idx += THREADS) {
        const int c = idx / QT;
        const int ql = idx - c * QT;
        if (q0 + ql >= a.m) continue;
        float sum = 0.f;
        for (int r = 0; r < KB; r += 4) {
          const float4 x = atk::lds4(St + ql * KTS + r);
          const float4 y = atk::lds4(Kt + c * KTS + r);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
          sum = fmaf(x.z, y.z, sum);
          sum = fmaf(x.w, y.w, sum);
        }
        atomicAdd(dq + (long long)(q0 + ql) * d + c, sum * a.scale);
      }
    }
  }

  float* dko = a.dk + (long long)hd.out * a.n * d;
  float* dvo = a.dv + (long long)hd.out * a.n * dvd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    if (key >= a.n) continue;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tc + 32 * q + e;
        if (col < d) dko[(long long)key * d + col] = dk[i][q][e] * atk::LN2;
        if (col < dvd) dvo[(long long)key * dvd + col] = dv[i][q][e];
      }
  }
}

// Shared memory (bytes) of q_major_fma: Qsᵀ, dOᵀ (resident), Kᵀ, Vᵀ and
// K row-major per tile, dSᵀ as [key][query].
inline size_t smem_q_fma(int d, int dv) {
  return sizeof(float) * ((size_t)(d + dv) * (QBS + FKS) +
                          (size_t)FKT * atk::v_stride(d) + FKT * QBS);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) q_major_fma(BwdArgs a) {
  constexpr int NQ = NJ / 4;
  extern __shared__ float smem[];
  const int d = a.d, dvd = a.dvd;
  const int dps = atk::v_stride(d);
  float* Qt = smem;            // [d][QBS]
  float* Ot = Qt + d * QBS;    // [dv][QBS]
  float* Kt = Ot + dvd * QBS;  // [d][FKS]
  float* Vt = Kt + d * FKS;    // [dv][FKS]
  float* Kr = Vt + dvd * FKS;  // [FKT][dps]
  float* St = Kr + FKT * dps;  // [FKT][QBS]
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * QB;
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  const T* qp = static_cast<const T*>(a.qs) + b * a.sqb + h * a.sqh;
  const T* op = static_cast<const T*>(a.dout) + b * a.sob + h * a.soh;
  const int n_end = key_end(a, q0, QB);

  stage<T>(Qt, QBS, nullptr, 0, QB, d, [&](int r) {
    return q0 + r < a.m ? qp + (q0 + r) * a.sqm : nullptr;
  });
  stage<T>(Ot, QBS, nullptr, 0, QB, dvd, [&](int r) {
    return q0 + r < a.m ? op + (q0 + r) * a.som : nullptr;
  });
  const long long row0 = (long long)bh * a.m;
  const long long lrow = (long long)bh * a.ls;
  float l2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * tr + i;
    l2[i] = q < a.m ? a.lse2[lrow + q] : -INFINITY;
    dl[i] = q < a.m ? a.delta[lrow + q] : 0.f;
  }

  float dq[4][NQ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][q][e] = 0.f;

  for (int j0 = key_begin(a, q0, FKT); j0 < n_end; j0 += FKT) {
    __syncthreads();  // the previous tile's readers are done
    stage<T>(Kt, FKS, Kr, dps, FKT, d, [&](int r) {
      return j0 + r < n_end ? kp + (j0 + r) * a.skn : nullptr;
    });
    stage<T>(Vt, FKS, nullptr, 0, FKT, dvd, [&](int r) {
      return j0 + r < n_end ? vp + (j0 + r) * a.svn : nullptr;
    });
    __syncthreads();
    // S and dP: query rows 4·tr + i, keys 4·tc + j
    float s[4][4] = {}, dp[4][4] = {};
    outer4(s, Qt + 4 * tr, QBS, Kt + 4 * tc, FKS, d);
    outer4(dp, Ot + 4 * tr, QBS, Vt + 4 * tc, FKS, dvd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_and_ds(a, q0 + 4 * tr + i, j0 + 4 * tc + j, l2[i], dl[i], s[i][j],
                 dp[i][j]);
        St[(4 * tc + j) * QBS + 4 * tr + i] = round_to<T>(dp[i][j]);
      }
    __syncthreads();
    accumulate<NQ>(dq, St, QBS, Kr, dps, FKT, tr, tc);  // dQ += dS·K
  }

  T* dqo = static_cast<T*>(a.dq) + row0 * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * tr + i;
    if (q >= a.m) continue;
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tc + 32 * qq + e;
        if (col < d)
          dqo[(long long)q * d + col] = atk::from_f<T>(dq[i][qq][e] * a.scale);
      }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const BwdArgs& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The Hopper bodies (flash_bwd_sm90.cuh, flash_bwd_dq_sm90.cuh) read their
// tiles by TMA and lse2 and delta by bulk copy: bf16, dk = dv = 64 or 128,
// (batch, head, row) strides that are positive multiples of 8 elements, and
// 16-byte aligned inputs.  Each entry point checks its outputs and the
// padding of lse2 and delta on top.
inline bool wgmma_operands_ok(const BwdArgs& a) {
  const long long st[12] = {a.sqb, a.sqh, a.sqm, a.skb, a.skh, a.skn,
                            a.svb, a.svh, a.svn, a.sob, a.soh, a.som};
  for (long long x : st)
    if (x <= 0 || x % 8) return false;
  const void* ptrs[6] = {a.qs, a.k, a.v, a.dout, a.lse2, a.delta};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return a.d == a.dvd && (a.d == 64 || a.d == 128);
}

template <int MODE, typename T, int NJ>
cudaError_t launch_fma(const BwdArgs& a, int B, cudaStream_t s) {
  if constexpr (MODE == DQ)
    return launch(q_major_fma<T, NJ>, dim3((a.m + QB - 1) / QB, B * a.H),
                  smem_q_fma(a.d, a.dvd), a, s);
  else
    return launch(kv_major_fma<T, NJ, MODE>,
                  dim3((a.n + KB - 1) / KB, B * (MODE == FUSED ? a.H : a.Hkv)),
                  smem_kv_fma(a.d, a.dvd), a, s);
}

template <int MODE, typename T>
cudaError_t dispatch_fma(const BwdArgs& a, int B, cudaStream_t s) {
  const int widest = a.d > a.dvd ? a.d : a.dvd;
  if (widest <= 32) return launch_fma<MODE, T, 4>(a, B, s);
  if (widest <= 64) return launch_fma<MODE, T, 8>(a, B, s);
  return launch_fma<MODE, T, 16>(a, B, s);
}

// the arguments every backward kernel takes
inline bool args_ok(const BwdArgs& a, int B) {
  return a.d >= 1 && a.dvd >= 1 && a.d <= MAX_HEAD_DIM &&
         a.dvd <= MAX_HEAD_DIM && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         a.m >= 1 && a.n >= 1 && B >= 1 && a.ls >= a.m && a.window >= 0;
}

}  // namespace atb
