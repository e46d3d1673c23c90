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
// dims up to 256 or with unaligned operands: fp32 FMA on the CUDA cores,
// bf16 widened on its way into shared memory, thread (tr, tc) owning a
// 4 x 4 block of each score tile as in `atk::attend`, 128 threads a CTA.
// Above head dim 128 a CTA owns 32 rows instead of 64 and each thread a
// 4 x 2 block (`Split`): the fp32 tiles then fit a CTA's shared memory and
// the accumulators stay at 4 x 16 a thread, as at d = 128.
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
constexpr int MAX_HEAD_DIM = 256;

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

constexpr int QTS = QT + 4;   // row stride of [col][query] tiles (kv-major)
constexpr int FKS = FKT + 4;  // row stride of [col][key] tiles (q-major)
// rows a CTA of the FMA bodies owns above head dim 128: 32 key rows
// (key-major) or query rows (query-major), so that the fp32 tiles fit a
// CTA's 227 KB at d = dv = 256 (64 rows would take 297 KB and 255 KB)
// and each thread keeps 4 rows x 16 columns of each accumulator, as at
// d = 128
constexpr int WIDE_ROWS = 32;

// How the 128 threads of an FMA body split a tile of ROWS rows (the CTA's
// own keys or queries, 4 a thread) by 32 columns (the tile's queries or
// keys): TR thread rows by TC thread columns, each thread a 4 x J block of
// scores and columns 4·tc + 4·TC·q + e of each accumulator row.
template <int ROWS>
struct Split {
  static constexpr int TR = ROWS / 4;
  static constexpr int TC = THREADS / TR;
  static constexpr int J = 32 / TC;
  static constexpr int RS = ROWS + 4;  // row stride of [col][row] tiles
  static_assert(TR * TC == THREADS && J * TC == 32 && (J == 2 || J == 4),
                "thread split");
};

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

// s[i][j] += Σ_c a[c][4·ra + i] · b[c][J·rb + j] over transposed tiles
template <int J>
__device__ __forceinline__ void outer(float (&s)[4][J], const float* a,
                                      int as, const float* b, int bs,
                                      int depth) {
  for (int c = 0; c < depth; ++c) {
    const float4 x = atk::lds4(a + c * as);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    float yv[J];
    if constexpr (J == 4) {
      const float4 y = atk::lds4(b + c * bs);
      yv[0] = y.x, yv[1] = y.y, yv[2] = y.z, yv[3] = y.w;
    } else {
      const float2 y = *reinterpret_cast<const float2*>(b + c * bs);
      yv[0] = y.x, yv[1] = y.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

// acc[i][q][e] += Σ_c x[c][4·tr + i] · y[c][4·tc + 4·TC·q + e], x a
// [depth][xs] tile, y row-major with row stride ys (columns past ys read 0)
template <int NQ, int TC>
__device__ __forceinline__ void accumulate(float (&acc)[4][NQ][4],
                                           const float* x, int xs,
                                           const float* y, int ys, int depth,
                                           int tr, int tc) {
  for (int c = 0; c < depth; ++c) {
    const float4 p4 = atk::lds4(x + c * xs + 4 * tr);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = 4 * tc + 4 * TC * q;
      const float4 v4 = col < ys ? atk::lds4(y + c * ys + col) : zero4();
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][q][e] = fmaf(p[i], vv[e], acc[i][q][e]);
    }
  }
}

// Shared memory (bytes) of kv_major_fma with kb keys a CTA: Kᵀ, Vᵀ
// (resident), Qsᵀ, dOᵀ and their row-major copies per tile, Pᵀ and dSᵀ as
// [query][key].  222,208 at d = dv = 256 with kb = 32.
inline size_t smem_kv_fma(int d, int dv, int kb) {
  const int ks = kb + 4;
  return sizeof(float) *
         ((size_t)(d + dv) * (ks + QTS) +
          (size_t)QT * (atk::v_stride(d) + atk::v_stride(dv)) + 2 * QT * ks);
}

template <typename T, int NJ, int MODE, int KB_ = KB>
__global__ void __launch_bounds__(THREADS) kv_major_fma(BwdArgs a) {
  constexpr int NQ = NJ / 4;
  using SP = Split<KB_>;
  constexpr int TC = SP::TC, J = SP::J, KTS = SP::RS;
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
  const int k0 = blockIdx.x * KB_;
  const int tid = threadIdx.x;
  const int tr = tid / TC;
  const int tc = tid % TC;
  const T* kp = static_cast<const T*>(a.k) + hd.b * a.skb + hd.hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + hd.b * a.svb + hd.hk * a.svh;
  const int i0 = first_q_tile(a, k0, QT);
  const int per_head = k0 < min(a.kv_valid, a.n)
                           ? max(q_tile_end(a, k0, KB_, QT) - i0, 0) : 0;
  const int ntiles = hd.heads * per_head;

  stage<T>(Kt, KTS, nullptr, 0, KB_, d, [&](int r) {
    return k0 + r < a.n ? kp + (k0 + r) * a.skn : nullptr;
  });
  stage<T>(Vt, KTS, nullptr, 0, KB_, dvd, [&](int r) {
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

    // Sᵀ and dPᵀ: key rows 4·tr + i, queries J·tc + j
    float s[4][J] = {}, dp[4][J] = {};
    outer<J>(s, Kt + 4 * tr, KTS, Qt + J * tc, QTS, d);
    outer<J>(dp, Vt + 4 * tr, KTS, Ot + J * tc, QTS, dvd);
    const long long row0 = ((long long)hd.b * a.H + h) * a.m;
    const long long lrow = ((long long)hd.b * a.H + h) * a.ls;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int q = q0 + J * tc + j;
      const float l2 = q < a.m ? a.lse2[lrow + q] : -INFINITY;
      const float dl = q < a.m ? a.delta[lrow + q] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p_and_ds(a, q, k0 + 4 * tr + i, l2, dl, s[i][j], dp[i][j]);
        Pt[(J * tc + j) * KTS + 4 * tr + i] = round_to<T>(s[i][j]);
        St[(J * tc + j) * KTS + 4 * tr + i] = round_to<T>(dp[i][j]);
      }
    }
    __syncthreads();
    accumulate<NQ, TC>(dv, Pt, KTS, Or, dvs, QT, tr, tc);  // dV += Pᵀ·dO
    accumulate<NQ, TC>(dk, St, KTS, Qr, dps, QT, tr, tc);  // dK += dSᵀ·Qs

    if constexpr (MODE == FUSED) {
      // this tile's dQ = scale·dS·K: lane = query row, warps split columns
      float* dq = a.dq32 + row0 * d;
      for (int idx = tid; idx < QT * d; idx += THREADS) {
        const int c = idx / QT;
        const int ql = idx - c * QT;
        if (q0 + ql >= a.m) continue;
        float sum = 0.f;
        for (int r = 0; r < KB_; r += 4) {
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
        const int col = 4 * tc + 4 * TC * q + e;
        if (col < d) dko[(long long)key * d + col] = dk[i][q][e] * atk::LN2;
        if (col < dvd) dvo[(long long)key * dvd + col] = dv[i][q][e];
      }
  }
}

// Shared memory (bytes) of q_major_fma with qb queries a CTA: Qsᵀ, dOᵀ
// (resident), Kᵀ, Vᵀ and K row-major per tile, dSᵀ as [key][query].
// 184,832 at d = dv = 256 with qb = 32.
inline size_t smem_q_fma(int d, int dv, int qb) {
  const int qs = qb + 4;
  return sizeof(float) * ((size_t)(d + dv) * (qs + FKS) +
                          (size_t)FKT * atk::v_stride(d) + FKT * qs);
}

template <typename T, int NJ, int QB_ = QB>
__global__ void __launch_bounds__(THREADS) q_major_fma(BwdArgs a) {
  constexpr int NQ = NJ / 4;
  using SP = Split<QB_>;
  constexpr int TC = SP::TC, J = SP::J, QBS = SP::RS;
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
  const int q0 = blockIdx.x * QB_;
  const int tid = threadIdx.x;
  const int tr = tid / TC;
  const int tc = tid % TC;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  const T* qp = static_cast<const T*>(a.qs) + b * a.sqb + h * a.sqh;
  const T* op = static_cast<const T*>(a.dout) + b * a.sob + h * a.soh;
  const int n_end = key_end(a, q0, QB_);

  stage<T>(Qt, QBS, nullptr, 0, QB_, d, [&](int r) {
    return q0 + r < a.m ? qp + (q0 + r) * a.sqm : nullptr;
  });
  stage<T>(Ot, QBS, nullptr, 0, QB_, dvd, [&](int r) {
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
    // S and dP: query rows 4·tr + i, keys J·tc + j
    float s[4][J] = {}, dp[4][J] = {};
    outer<J>(s, Qt + 4 * tr, QBS, Kt + J * tc, FKS, d);
    outer<J>(dp, Ot + 4 * tr, QBS, Vt + J * tc, FKS, dvd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        p_and_ds(a, q0 + 4 * tr + i, j0 + J * tc + j, l2[i], dl[i], s[i][j],
                 dp[i][j]);
        St[(J * tc + j) * QBS + 4 * tr + i] = round_to<T>(dp[i][j]);
      }
    __syncthreads();
    accumulate<NQ, TC>(dq, St, QBS, Kr, dps, FKT, tr, tc);  // dQ += dS·K
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
        const int col = 4 * tc + 4 * TC * qq + e;
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

// The FMA body of a MODE at NJ columns a thread and ROWS key (key-major)
// or query (query-major) rows a CTA: its kernel, shared bytes and grid.
template <int MODE, typename T, int NJ, int ROWS>
struct FmaInstance {
  static constexpr int rows = ROWS;
  static auto kernel() {
    if constexpr (MODE == DQ)
      return q_major_fma<T, NJ, ROWS>;
    else
      return kv_major_fma<T, NJ, MODE, ROWS>;
  }
  static size_t smem(int d, int dv) {
    return MODE == DQ ? smem_q_fma(d, dv, ROWS) : smem_kv_fma(d, dv, ROWS);
  }
  static dim3 grid(const BwdArgs& a, int B) {
    if (MODE == DQ) return dim3((a.m + ROWS - 1) / ROWS, B * a.H);
    return dim3((a.n + ROWS - 1) / ROWS, B * (MODE == FUSED ? a.H : a.Hkv));
  }
};

// fn(the FmaInstance for head dims d, dv): 64 rows a CTA and 4, 8 or 16
// columns a thread up to head dim 128, 32 rows and 16 columns (of 16
// thread columns: 256) above it
template <int MODE, typename T, typename Fn>
cudaError_t with_fma(int d, int dv, Fn fn) {
  constexpr int ROWS = MODE == DQ ? QB : KB;
  const int widest = d > dv ? d : dv;
  if (widest <= 32) return fn(FmaInstance<MODE, T, 4, ROWS>{});
  if (widest <= 64) return fn(FmaInstance<MODE, T, 8, ROWS>{});
  if (widest <= 128) return fn(FmaInstance<MODE, T, 16, ROWS>{});
  return fn(FmaInstance<MODE, T, 16, WIDE_ROWS>{});
}

template <int MODE, typename T>
cudaError_t dispatch_fma(const BwdArgs& a, int B, cudaStream_t s) {
  return with_fma<MODE, T>(a.d, a.dvd, [&](auto inst) {
    using I = decltype(inst);
    return launch(I::kernel(), I::grid(a, B), I::smem(a.d, a.dvd), a, s);
  });
}

// What the FMA instance of MODE for dtype (0 fp32, 1 bf16) at head dims
// (d, dv) costs an SM: out[0] registers a thread, out[1] dynamic shared
// bytes a CTA, out[2] CTAs an SM can hold, out[3] local (spilled) bytes a
// thread, out[4] the key (key-major) or query (query-major) rows a CTA
// owns.  Returns a CUDA error code.
template <int MODE>
int fma_resources(int dtype, int d, int dv, int* out) {
  if (d < 1 || dv < 1 || d > MAX_HEAD_DIM || dv > MAX_HEAD_DIM ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto get = [&](auto inst) -> cudaError_t {
    using I = decltype(inst);
    auto kernel = I::kernel();
    const size_t smem = I::smem(d, dv);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaFuncAttributes at;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kernel);
    int ctas = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                          THREADS, smem);
    if (err != cudaSuccess) return err;
    out[0] = at.numRegs;
    out[1] = (int)smem;
    out[2] = ctas;
    out[3] = (int)at.localSizeBytes;
    out[4] = I::rows;
    return cudaSuccess;
  };
  return (int)(dtype == 0 ? with_fma<MODE, float>(d, dv, get)
                          : with_fma<MODE, bf16>(d, dv, get));
}

// the arguments every backward kernel takes
inline bool args_ok(const BwdArgs& a, int B) {
  return a.d >= 1 && a.dvd >= 1 && a.d <= MAX_HEAD_DIM &&
         a.dvd <= MAX_HEAD_DIM && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         a.m >= 1 && a.n >= 1 && B >= 1 && a.ls >= a.m && a.window >= 0;
}

}  // namespace atb
