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
// kv_offset + j), only the first kv_valid key rows attended, and softcap
// in the log2 domain (cap2 = softcap·log2 e).
//
// with lse2 and delta read at row stride ls (the caller pads each head's
// rows, lse2 with +inf: exp2(s - inf) is the 0 of a row that saw no key).
//
// Two shapes of CTA (128 threads each):
//
// key-major (`kv_major_*`): a CTA owns a block of KB key rows and walks
// the query tiles in a loop that takes the place of the TPU grid's
// sequential q axis, keeping dK and dV in fp32 registers.  The dK/dV kernel
// (replaces `_dkv_kernel`, flash_bwd.py:215) walks the query tiles of every
// Q head of its KV head's GQA group, so the group sum stays in the kernel;
// the fused kernel's FMA body (replaces `_fused_bwd_kernel`, :304, for fp32
// and the head dims its Hopper body, flash_bwd_sm90.cuh, does not take)
// owns one Q head and writes per-Q-head partials that the caller sums over
// the group, and adds each tile's dQ = scale·dS·K into an fp32 (B, H, m,
// dk) buffer with atomicAdd: CTAs run in no order, and the TPU kernel's
// resident dQ block has no counterpart on the GPU.  A causal CTA starts at
// the first query tile that sees its keys.
//
// query-major (`q_major_*`, replaces `_dq_kernel`, :146): a CTA owns QB query
// rows and walks the key tiles up to the causal diagonal, keeping dQ in
// fp32 registers, and writes it once in the input dtype.
//
// The dQ and dK/dV kernels come in two versions.  `*_mma` (bf16, dk = dv
// = 64 or 128): the
// products on the tensor cores with `mma.sync.m16n8k16` through
// attention_tile.cuh's ldmatrix/cp.async helpers; each warp owns 16 rows of
// the CTA's block, the score accumulators turn into the next product's A
// operand in registers (as in FlashAttention-2), and the transposed
// operands come from shared memory through `ldmatrix.trans`.  `*_fma` (fp32,
// and bf16 at other head dims up to 128): fp32 FMA on the CUDA cores, bf16
// widened on its way into shared memory, thread (tr, tc) owning a 4 x 4
// block of each score tile as in `atk::attend`.
//
// What bounds them on the H100: the fused backward does 10·h·m·n·d
// operations (halved under causal) on 4·h·m·d + 2·hkv·n·d values plus
// fp32 gradients, far above the ~295 operations per byte where bf16 work
// stops being bound by memory, so it is bound by the tensor cores' 989
// TFLOP/s (the two-kernel pair recomputes S and dP: 14·h·m·n·d).  The
// design keeps P, dP and dS out of device memory; the fused FMA body's dQ
// atomics (h·m·d per key block) are its one extra traffic.  The pair's
// wgmma/TMA pipelines are later work.
#pragma once

#include "attention_tile.cuh"

namespace atb {

using atk::THREADS;
using bf16 = __nv_bfloat16;

constexpr int KB = 64;   // key rows per CTA of the key-major kernels
constexpr int QB = 64;   // query rows per CTA of the query-major kernel
constexpr int QT = 32;   // query rows per tile of the key-major kernels
constexpr int KT = 64;   // key rows per tile of query-major mma kernel
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
  const bool keep = key < a.kv_valid && lse2 != -INFINITY &&
                    (!a.causal || key + a.kv_offset <= q + a.q_offset);
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

// keys a query block [q0, q0 + rows) visits: none past kv_valid, none past
// the block's causal diagonal
__device__ __forceinline__ int key_end(const BwdArgs& a, int q0, int rows) {
  const int valid = min(a.kv_valid, a.n);
  return a.causal ? max(0, min(valid, q0 + rows + a.q_offset - a.kv_offset))
                  : valid;
}

// ------------------------------------------------------------ tensor cores

template <int D>
__device__ __forceinline__ void zero(float (&x)[D][4]) {
#pragma unroll
  for (int j = 0; j < D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// acc (16 x 8·NT) += A (16 x 16·K16, this warp's rows at arow of a
// row-major tile with row stride AS) · Bᵀ, B (8·NT x 16·K16) row-major at
// b with row stride BS: both operands read as stored (ldmatrix)
template <int NT, int K16>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* arow,
                                        int as, const bf16* b, int bs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    uint32_t af[4];
    atk::ldsm_x4(af, arow + ((lane & 7) + ((lane >> 3) & 1) * 8) * as +
                         kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t bf[4];
      atk::ldsm_x4(bf, b + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * bs +
                           kk * 16 + ((lane >> 3) & 1) * 8);
      atk::mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
      atk::mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8·NT) += A · B, A (16 x 16·K16) in registers as accumulator
// tiles x (16 x 8 each, rounded to bf16 here), B (16·K16 x 8·NT) row-major
// at b with row stride bs (read transposed by ldmatrix.trans)
template <int NT, int K16>
__device__ __forceinline__ void mma_xb(float (&acc)[NT][4],
                                       const float (&x)[2 * K16][4],
                                       const bf16* b, int bs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < K16; ++ks) {
    const uint32_t af[4] = {atk::pack_bf16(x[2 * ks][0], x[2 * ks][1]),
                            atk::pack_bf16(x[2 * ks][2], x[2 * ks][3]),
                            atk::pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                            atk::pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      atk::ldsm_x4_trans(bf, b + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     bs +
                                 np * 16 + (lane >> 4) * 8);
      atk::mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      atk::mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// Shared memory of kv_major_mma<D>: K and V blocks, two buffers of the Qs
// and dO tiles.
inline size_t smem_kv_mma(int d) {
  return sizeof(bf16) * (2 * (size_t)KB * (d + 8) + 4 * (size_t)QT * (d + 8));
}

// the dK/dV kernel's tensor-core body
template <int D>
__global__ void __launch_bounds__(THREADS) kv_major_mma(BwdArgs a) {
  constexpr int DP = D + 8;  // row stride of every tile
  constexpr int QBUF = 2 * QT * DP;  // one buffer: Qs tile, then dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + KB * DP;
  bf16* Qb = Vs + KB * DP;
  const Heads hd = kv_heads<DKV>(a);
  const int k0 = blockIdx.x * KB;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int kr = w * 16;  // this warp's first key row
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bf16* kp = static_cast<const bf16*>(a.k) + hd.b * a.skb + hd.hk * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + hd.b * a.svb + hd.hk * a.svh;
  const int i0 = first_q_tile(a, k0, QT);
  const int per_head = k0 < min(a.kv_valid, a.n)
                           ? max((a.m + QT - 1) / QT - i0, 0) : 0;
  const int ntiles = hd.heads * per_head;

  atk::load_rows<D, true>(Ks, KB, [&](int r) {
    return k0 + r < a.n ? kp + (k0 + r) * a.skn : nullptr;
  });
  atk::load_rows<D, true>(Vs, KB, [&](int r) {
    return k0 + r < a.n ? vp + (k0 + r) * a.svn : nullptr;
  });
  atk::cp_async_commit();

  // tile t: query rows [q0, q0 + QT) of head h
  auto head_of = [&](int t) { return hd.h_first + t / per_head; };
  auto q0_of = [&](int t) { return (i0 + t % per_head) * QT; };
  auto prefetch = [&](int t) {
    const int h = head_of(t);
    const int q0 = q0_of(t);
    bf16* Q = Qb + (t & 1) * QBUF;
    const bf16* qp =
        static_cast<const bf16*>(a.qs) + hd.b * a.sqb + h * a.sqh;
    const bf16* op =
        static_cast<const bf16*>(a.dout) + hd.b * a.sob + h * a.soh;
    atk::load_rows<D, true>(Q, QT, [&](int r) {
      return q0 + r < a.m ? qp + (q0 + r) * a.sqm : nullptr;
    });
    atk::load_rows<D, true>(Q + QT * DP, QT, [&](int r) {
      return q0 + r < a.m ? op + (q0 + r) * a.som : nullptr;
    });
    atk::cp_async_commit();
  };

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  if (ntiles > 0) prefetch(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      prefetch(t + 1);
      atk::cp_async_wait<1>();
    } else {
      atk::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and K, V) landed for every thread
    const int h = head_of(t);
    const int q0 = q0_of(t);
    const bf16* Qs = Qb + (t & 1) * QBUF;
    const bf16* Os = Qs + QT * DP;

    // Sᵀ = K·Qsᵀ and dPᵀ = V·dOᵀ: this warp's 16 key rows x QT queries;
    // element e of tile j: key kr + g + 8·(e >> 1), query j·8 + 2·tq + (e & 1)
    float s[QT / 8][4], dp[QT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<QT / 8, D / 16>(s, Ks + kr * DP, DP, Qs, DP);
    mma_abt<QT / 8, D / 16>(dp, Vs + kr * DP, DP, Os, DP);
    const long long row0 = ((long long)hd.b * a.H + h) * a.ls;
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + j * 8 + 2 * tq + c;
        const float l2 = q < a.m ? a.lse2[row0 + q] : -INFINITY;
        const float dl = q < a.m ? a.delta[row0 + q] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          p_and_ds(a, q, k0 + kr + g + 8 * i, l2, dl, s[j][2 * i + c],
                   dp[j][2 * i + c]);
      }
    // dV += Pᵀ·dO, dK += dSᵀ·Qs (the ln 2 comes in the epilogue)
    mma_xb<D / 8, QT / 16>(dv, s, Os, DP);
    mma_xb<D / 8, QT / 16>(dk, dp, Qs, DP);

    __syncthreads();  // every warp is done with buffer t & 1
  }
  atk::cp_async_wait<0>();

  float* dko = a.dk + (long long)hd.out * a.n * D;
  float* dvo = a.dv + (long long)hd.out * a.n * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + g + 8 * i;
    if (key >= a.n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long at = (long long)key * D + j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(dko + at) =
          make_float2(dk[j][2 * i] * atk::LN2, dk[j][2 * i + 1] * atk::LN2);
      *reinterpret_cast<float2*>(dvo + at) =
          make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// Shared memory of q_major_mma<D>: the Qs and dO rows, two buffers of K
// and V tiles.
inline size_t smem_q_mma(int d) {
  return sizeof(bf16) * (2 * (size_t)QB * (d + 8) + 4 * (size_t)KT * (d + 8));
}

template <int D>
__global__ void __launch_bounds__(THREADS) q_major_mma(BwdArgs a) {
  constexpr int DP = D + 8;
  constexpr int KVBUF = 2 * KT * DP;  // one buffer: K tile, then V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + QB * DP;
  bf16* Kb = Os + QB * DP;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * QB;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + hk * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + hk * a.svh;
  const bf16* qp = static_cast<const bf16*>(a.qs) + b * a.sqb + h * a.sqh;
  const bf16* op = static_cast<const bf16*>(a.dout) + b * a.sob + h * a.soh;
  const int n_end = key_end(a, q0, QB);
  const int ntiles = (n_end + KT - 1) / KT;

  auto prefetch = [&](int t) {
    bf16* K = Kb + (t & 1) * KVBUF;
    const int j0 = t * KT;
    atk::load_rows<D, true>(K, KT, [&](int r) {
      return j0 + r < n_end ? kp + (j0 + r) * a.skn : nullptr;
    });
    atk::load_rows<D, true>(K + KT * DP, KT, [&](int r) {
      return j0 + r < n_end ? vp + (j0 + r) * a.svn : nullptr;
    });
    atk::cp_async_commit();
  };

  if (ntiles > 0) prefetch(0);
  atk::load_rows<D, false>(Qs, QB, [&](int r) {
    return q0 + r < a.m ? qp + (q0 + r) * a.sqm : nullptr;
  });
  atk::load_rows<D, false>(Os, QB, [&](int r) {
    return q0 + r < a.m ? op + (q0 + r) * a.som : nullptr;
  });
  const long long row0 = (long long)bh * a.m;
  const long long lrow = (long long)bh * a.ls;
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + wr + g + 8 * i;
    l2[i] = q < a.m ? a.lse2[lrow + q] : -INFINITY;
    dl[i] = q < a.m ? a.delta[lrow + q] : 0.f;
  }

  float dq[D / 8][4];
  zero(dq);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      prefetch(t + 1);
      atk::cp_async_wait<1>();
    } else {
      atk::cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed (and Qs, dO are stored)
    const int j0 = t * KT;
    const bf16* Ks = Kb + (t & 1) * KVBUF;
    const bf16* Vs = Ks + KT * DP;
    // S = Qs·Kᵀ, dP = dO·Vᵀ: this warp's 16 query rows x KT keys
    float s[KT / 8][4], dp[KT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<KT / 8, D / 16>(s, Qs + wr * DP, DP, Ks, DP);
    mma_abt<KT / 8, D / 16>(dp, Os + wr * DP, DP, Vs, DP);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_and_ds(a, q0 + wr + g + 8 * (e >> 1), j0 + j * 8 + 2 * tq + (e & 1),
                 l2[e >> 1], dl[e >> 1], s[j][e], dp[j][e]);
    mma_xb<D / 8, KT / 16>(dq, dp, Ks, DP);  // dQ += dS·K
    __syncthreads();  // every warp is done with buffer t & 1
  }

  bf16* dqo = static_cast<bf16*>(a.dq) + row0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + wr + g + 8 * i;
    if (q >= a.m) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqo + (long long)q * D + j * 8 + 2 * tq) =
          atk::pack_bf16(dq[j][2 * i] * a.scale, dq[j][2 * i + 1] * a.scale);
  }
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
                           ? max((a.m + QT - 1) / QT - i0, 0) : 0;
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

  for (int j0 = 0; j0 < n_end; j0 += FKT) {
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

// the tensor-core path reads 16-byte row chunks: bf16, dk = dv = 64 or
// 128, 16-byte aligned bases and strides that are multiples of 8
inline bool mma_ok(const BwdArgs& a) {
  const long long st[12] = {a.sqb, a.sqh, a.sqm, a.skb, a.skh, a.skn,
                            a.svb, a.svh, a.svn, a.sob, a.soh, a.som};
  for (long long x : st)
    if (x % 8) return false;
  return a.d == a.dvd && (a.d == 64 || a.d == 128) && aligned16(a.qs) &&
         aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
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

template <int MODE, int D>
cudaError_t launch_mma(const BwdArgs& a, int B, cudaStream_t s) {
  if constexpr (MODE == DQ)
    return launch(q_major_mma<D>, dim3((a.m + QB - 1) / QB, B * a.H),
                  smem_q_mma(D), a, s);
  else
    return launch(kv_major_mma<D>, dim3((a.n + KB - 1) / KB, B * a.Hkv),
                  smem_kv_mma(D), a, s);
}

// the arguments every backward kernel takes
inline bool args_ok(const BwdArgs& a, int B) {
  return a.d >= 1 && a.dvd >= 1 && a.d <= MAX_HEAD_DIM &&
         a.dvd <= MAX_HEAD_DIM && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         a.m >= 1 && a.n >= 1 && B >= 1 && a.ls >= a.m;
}

// The dQ or the dK/dV kernel: dtype 0 = fp32, 1 = bf16.  Returns the
// launch's cudaGetLastError() (or the refusal of bad arguments).
template <int MODE>
int run(const BwdArgs& a, int B, int dtype, cudaStream_t s) {
  static_assert(MODE != FUSED, "the fused kernel has its own entry point");
  if (!args_ok(a, B)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_fma<MODE, float>(a, B, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!mma_ok(a)) return (int)dispatch_fma<MODE, bf16>(a, B, s);
  if (a.d == 64) return (int)launch_mma<MODE, 64>(a, B, s);
  return (int)launch_mma<MODE, 128>(a, B, s);
}

}  // namespace atb

// The plain C entry point of the dQ or the dK/dV kernel, loaded through
// ctypes.  Pointers as in atb::BwdArgs (unused ones null); strides in
// elements, (batch, head, row) for each of qs, k, v, dout, whose last dims
// are contiguous; softcap2 = softcap·log2 e, <= 0 for none; kv_valid <= n;
// ls the row stride of lse2 and delta.
#define ATB_ENTRY(NAME, MODE)                                                 \
  extern "C" int NAME(                                                        \
      const void* qs, const void* k, const void* v, const void* dout,         \
      const float* lse2, const float* delta, float* dq32, void* dq,           \
      float* dk, float* dv, int dtype, int B, int H, int Hkv, int m, int n,   \
      int d, int dvd, int ls, long long sqb, long long sqh, long long sqm,    \
      long long skb, long long skh, long long skn, long long svb,             \
      long long svh, long long svn, long long sob, long long soh,             \
      long long som, float scale, float softcap2, int causal, int q_offset,   \
      int kv_offset, int kv_valid, void* stream) {                            \
    const atb::BwdArgs a{qs,  k,   v,   dout, lse2, delta, dq32, dq,          \
                         dk,  dv,  H,   Hkv,  m,    n,     d,    dvd,         \
                         ls,  sqb, sqh, sqm,  skb,  skh,   skn,  svb,         \
                         svh, svn, sob, soh,  som,  scale,                    \
                         softcap2 > 0.f ? softcap2 : 0.f, causal, q_offset,   \
                         kv_offset, kv_valid};                                \
    return atb::run<MODE>(a, B, dtype, static_cast<cudaStream_t>(stream));    \
  }
