// The blocked online-softmax tile loops shared by the port's attention
// kernels (flash_fwd.cu, ragged_paged.cu, and decode.cu and paged_decode.cu
// through decode_rows.cuh).
//
// One CTA of THREADS threads owns BM query rows and walks the key/value
// stream a tile at a time: S = Q·Kᵀ for the tile, the running row max / row
// sum update (the reference's `_online_softmax_update`,
// attention_tpu/ops/flash.py:624), O += P·V, and one division by the row sum
// at the end.  The loop inside the CTA takes the place of the TPU grid's
// sequential key/value axis.  Scores live in the log2 domain (scale·log2 e
// folded in), and softcap, when set, maps them through cap·tanh(s/cap)
// before masking.  Two versions of that loop:
//
// `attend` (fp32 and bf16, any head dim up to 256): plain fp32 FMA on the
// CUDA cores.  bf16 values are widened on their way into shared memory, so
// fp32 runs in full fp32 (no TF32) and bf16 accumulates in fp32.  Thread
// layout: tid = tr * 8 + tc; thread (tr, tc) owns a 4 x 4 block of each
// score tile and 4 x NJ outputs.  A row's 8 owners are 8 consecutive lanes
// of one warp, so row max and row sum reduce with three xor shuffles.  Q, K
// and P sit transposed in shared memory, so each thread reads its four rows
// or columns of one step with one 16-byte load.
//
// `attend_mma` (bf16, head dims 64 or 128): the two products on the tensor
// cores with `mma.sync.m16n8k16` (bf16 in, fp32 accumulate).  Each of the
// four warps owns 16 query rows (or, with KG key groups, shares them with
// KG - 1 others and takes its own columns of every key tile); Q fragments
// stay in registers, K and V tiles of MMA_BN rows sit in STAGES shared
// buffers (two by default) with rows padded by 16 bytes (conflict-free
// `ldmatrix`), the next tiles copying in with `cp.async` while the current
// one is computed; V is read transposed by `ldmatrix.trans`.  The
// score accumulators turn into the P·V A-operand in registers, as in
// FlashAttention-2.
//
// In both, P is rounded to bf16 before the P·V product for bf16 inputs, as
// the reference rounds `p.astype(v.dtype)`; the row sum uses the unrounded P.
//
// Both walk the key tiles a `TileWalk` names: every tile up to n_end, or,
// for a decode band, the sink tiles and then the band's tiles only, so the
// loop bounds skip what the TPU kernels skipped by clamping their DMAs.
//
// `attend_mma` takes its key/value tiles from a loader (`Bf16Rows` unless
// the Problem names another as `Tiles`).  The quantized caches' loop
// (quant_tiles.cuh) is its own, over the online-softmax step and the
// key-group merge below (`softmax_tile`, `merge_key_groups`).
//
// The rescaling math of the recurrence is a compile-time parameter `VAR`
// of the softmax step (the TPU kernels' max_mode, attention_tpu/ops/
// flash.py:654-762), ONLINE by default, so every existing instance is the
// code it was:
// - ONLINE: the running row max m and sum l; O and l rescaled by
//   exp2(m_old - m_new) each tile.
// - BOUND (`attend` only, the flash forward's FMA body): m is a row bound
//   b >= every score of the row, computed once from the row's query and
//   the Problem's `knmax` (Cauchy-Schwarz); a tile is one exp2 a score and
//   the sum, no max, no rescale.  Stats (b, sum of exp2(s - b)).
// - FLASHD (FLASH-D): m carries mu, the running log2-sum-exp, O stays
//   normalized: each tile takes t = exp2(mu - b) + sum exp2(s - b) over
//   b = max(mu, tile max), scales P by 1/t before it is rounded and O by
//   exp2(mu - b)/t, and mu becomes b + log2 t.  Stats (mu, 1), (-inf, 0)
//   for a row that saw nothing: the two-phase merges hold unchanged.
// - AMLA: m is the running max ceiled to an integer, so each rescale is a
//   power of two, applied by adding the (non-positive) integer to the fp32
//   exponent fields of O and l (`exp_add`).  Stats (m, l).
// Every variant keeps the NaN behaviour `softmax_tile` documents.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace atk {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 32;        // key/value rows per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int RPT = BM / (THREADS / 8);  // rows per thread (4)
constexpr int CPT = BN / 8;              // score columns per thread (4)
constexpr int MAX_HEAD_DIM = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row strides of the shared tiles, in floats, all multiples of 4 so every
// thread's four rows or columns are one 16-byte load.
constexpr int QT_STRIDE = BM + 4;  // Qt[c][r] and Pt[c][r]: transposed
constexpr int KT_STRIDE = BN + 4;  // Kt[c][col]: transposed
__host__ __device__ inline int v_stride(int dv) { return (dv + 3) & ~3; }

// Dynamic shared memory one CTA needs for head dims (dk, dv).
inline size_t smem_bytes(int dk, int dv) {
  return sizeof(float) * ((size_t)dk * (QT_STRIDE + KT_STRIDE) +
                          (size_t)BN * (v_stride(dv) + QT_STRIDE));
}

constexpr float LN2 = 0.6931471805599453f;

// the rescaling-math variants (the C entry points' max_mode codes)
constexpr int ONLINE = 0, BOUND = 1, FLASHD = 2, AMLA = 3;

// The least CTAs an SM the variants' CUDA-core and mma.sync kernels ask of
// ptxas (their second launch bound): left to its own choice, ptxas held
// some of them to 128 registers a thread and spilled 2-36 bytes.
constexpr int VARIANT_MIN_BLOCKS = 1;

// x · 2^e for an integer e <= 0 as an add on the fp32 exponent field (the
// TPU kernel's `_exponent_add`, attention_tpu/ops/flash.py:748): zero and
// a result below the normal range give 0, inf and NaN pass through.
__device__ __forceinline__ float exp_add(float x, int e) {
  const int bits = __float_as_int(x);
  const int ex = (bits >> 23) & 0xFF;
  if (ex == 0xFF) return x;
  e = max(e, -255);
  return ex + e <= 0 ? 0.f : __int_as_float(bits + (e << 23));
}

// The key tiles of width W that a CTA visits, in order: those covering the
// pinned columns [0, sink_end), then every tile from the one holding
// kv_begin up to the one holding column n_end - 1.  A tile holding both a
// sink column and kv_begin is visited once.  Without a band (kv_begin 0)
// this is every tile below n_end.
struct TileWalk {
  int sink_tiles, first, count;
  __device__ TileWalk(int n_end, int kv_begin, int sink_end, int W) {
    const int nt = (max(n_end, 0) + W - 1) / W;
    first = min(kv_begin / W, nt);
    sink_tiles = min((sink_end + W - 1) / W, first);
    count = sink_tiles + nt - first;
  }
  // first column of the t-th visited tile
  __device__ int col(int t, int W) const {
    return (t < sink_tiles ? t : first + t - sink_tiles) * W;
  }
};

// The optional parts of a Problem, off: no band (every tile below n_end is
// visited) and a normalized output.  A Problem that wants partials returns
// an fp32 row from acc_row, which then receives the unnormalized output,
// and takes each row's max (log2 domain) and sum through put_stats.
struct ProblemBase {
  int kv_begin = 0;
  int sink_end = 0;
  float knmax = 0.f;     // BOUND: the largest key norm of the kv head
  bool demoted = false;  // BOUND: the guard's verdict, take the online step
  __device__ float* acc_row(int) const { return nullptr; }
  __device__ void put_stats(int, float, float) const {}
};

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One row's softmax step of `attend`'s tile under a variant other than
// ONLINE: the row's scores in s become P (rounded to T), and its m, l and
// O are updated.  BOUND where its guard passed (`bnd`): m is the row
// bound, one exp2 a score and the sum, no max, no rescale; BOUND demoted
// takes the online step.  FLASHD scales P by 1/t before the rounding;
// AMLA ceils the max and rescales O and l by exponent adds.
template <typename T, int NQ, int VAR>
__device__ __forceinline__ void variant_row_step(float (&s)[CPT], float mx,
                                                 float& m, float& l,
                                                 float (&o)[NQ][4],
                                                 bool bnd) {
  if (VAR == BOUND && bnd) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = exp2f(s[j] - m);
      sum += p;
      s[j] = to_f(from_f<T>(p));
    }
    l += row_sum8(sum);
    return;
  }
  mx = row_max8(mx);
  float m_new = fmaxf(m, VAR == AMLA ? ceilf(mx) : mx);
  float corr = 1.f;
  float sum = 0.f;
  if (m_new != -INFINITY) {
    corr = exp2f(m - m_new);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = exp2f(s[j] - m_new);
      sum += p;
      s[j] = p;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
  }
  sum = row_sum8(sum);
  if constexpr (VAR == FLASHD) {
    // corr is exp2(mu - b); t the new denominator over exp2(b), taken out
    // of P before its rounding and out of the carried O
    const float t = corr + sum;
    const float rt = t == 0.f ? 0.f : 1.f / t;
    corr *= rt;
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] *= rt;
    m_new += log2f(t);
    l = m_new == -INFINITY ? 0.f : 1.f;
  } else if constexpr (VAR == AMLA) {
    const int e = m == -INFINITY ? 0 : (int)(m - m_new);
    l = exp_add(l, e) + sum;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[q][x] = exp_add(o[q][x], e);
  } else {
    l = l * corr + sum;
  }
  m = m_new;
#pragma unroll
  for (int j = 0; j < CPT; ++j) s[j] = to_f(from_f<T>(s[j]));
  if constexpr (VAR != AMLA) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[q][e] *= corr;
  }
}

// One CTA's attention over the rows and key/value stream a Problem
// describes.  A Problem derives from ProblemBase and provides:
//   n_end               columns below n_end are visited (masked beyond),
//                       the tiles `TileWalk` names from n_end, kv_begin
//                       and sink_end
//   q_row(r), o_row(r)  pointers to query / output row r of the CTA, or
//                       nullptr for a row the CTA does not own
//   k_row(c), v_row(c)  pointers to key / value row c, or nullptr (zeros)
//   keep(r, c)          whether row r may attend column c
// qscale is scale*log2(e); cap2 is softcap*log2(e), or 0 for no softcap.
// NJ output columns per thread: dv <= 8*NJ, NJ a multiple of 4.  Thread
// (tr, tc) owns rows 4*tr .. 4*tr+3, score columns 4*tc .. 4*tc+3 of each
// tile and output columns 4*tc + 32*q + e (q < NJ/4, e < 4).
template <typename T, int NJ, int VAR = ONLINE, typename Problem>
__device__ void attend(const Problem& pb, int dk, int dv, float qscale,
                       float cap2) {
  static_assert(RPT == 4 && CPT == 4 && NJ % 4 == 0, "float4 tiles");
  constexpr int NQ = NJ / 4;
  extern __shared__ float smem[];
  const int dvp = v_stride(dv);
  float* Qt = smem;                   // [dk][QT_STRIDE]
  float* Kt = Qt + dk * QT_STRIDE;    // [dk][KT_STRIDE]
  float* Vs = Kt + dk * KT_STRIDE;    // [BN][dvp]
  float* Pt = Vs + BN * dvp;          // [BN][QT_STRIDE]
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;

  for (int idx = tid; idx < BM * dk; idx += THREADS) {
    const int r = idx / dk;
    const int c = idx - r * dk;
    const T* src = pb.q_row(r);
    Qt[c * QT_STRIDE + r] = src ? to_f(src[c]) * qscale : 0.f;
  }

  float o[RPT][NQ][4];
  float mrow[RPT];
  float lrow[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][q][e] = 0.f;
  }
  // BOUND takes the online step on every tile where the guard demoted the
  // call (`bnd` false: the same for every CTA)
  bool bnd = false;
  if constexpr (VAR == BOUND) bnd = !pb.demoted;
  if (bnd) {
    // the row bound from the (scaled) query rows in Qt: a row's 8 threads
    // each sum every 8th column's squares
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float ss = 0.f;
      for (int c = tc; c < dk; c += 8) {
        const float x = Qt[c * QT_STRIDE + RPT * tr + i];
        ss = fmaf(x, x, ss);
      }
      const float b = sqrtf(row_sum8(ss)) * pb.knmax;
      mrow[i] = cap2 > 0.f ? fminf(b, cap2) : b;
    }
  }

  const TileWalk walk(pb.n_end, pb.kv_begin, pb.sink_end, BN);
  for (int t = 0; t < walk.count; ++t) {
    const int j0 = walk.col(t, BN);
    // the previous tile's readers are done with Kt/Vs/Pt (and, on the
    // first pass, Qt is complete)
    __syncthreads();
    for (int idx = tid; idx < BN * dk; idx += THREADS) {
      const int r = idx / dk;
      const int c = idx - r * dk;
      const int col = j0 + r;
      const T* src = col < pb.n_end ? pb.k_row(col) : nullptr;
      Kt[c * KT_STRIDE + r] = src ? to_f(src[c]) : 0.f;
    }
    for (int idx = tid; idx < BN * dvp; idx += THREADS) {
      const int r = idx / dvp;
      const int c = idx - r * dvp;
      const int col = j0 + r;
      const T* src = col < pb.n_end && c < dv ? pb.v_row(col) : nullptr;
      Vs[r * dvp + c] = src ? to_f(src[c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < dk; ++c) {
      const float4 a = lds4(Qt + c * QT_STRIDE + RPT * tr);
      const float4 b = lds4(Kt + c * KT_STRIDE + CPT * tc);
      const float av[RPT] = {a.x, a.y, a.z, a.w};
      const float bv[CPT] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = RPT * tr + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float x = s[i][j];
        // softcap acts on the scaled scores, before masking
        if (cap2 > 0.f) x = cap2 * tanhf(x / cap2);
        x = pb.keep(r, j0 + CPT * tc + j) ? x : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      if constexpr (VAR == ONLINE) {
        mx = row_max8(mx);
        const float m_new = fmaxf(mrow[i], mx);
        float corr = 1.f;
        float sum = 0.f;
        if (m_new != -INFINITY) {
          // exp2f(-inf) == 0: a row's first live tile zeroes nothing
          corr = exp2f(mrow[i] - m_new);
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float p = exp2f(s[i][j] - m_new);
            sum += p;
            s[i][j] = to_f(from_f<T>(p));
          }
        } else {
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
        }
        sum = row_sum8(sum);
        lrow[i] = lrow[i] * corr + sum;
        mrow[i] = m_new;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][q][e] *= corr;
      } else {
        variant_row_step<T, NQ, VAR>(s[i], mx, mrow[i], lrow[i], o[i], bnd);
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        Pt[(CPT * tc + j) * QT_STRIDE + r] = s[i][j];
    }
    __syncthreads();

    for (int c = 0; c < BN; ++c) {
      const float4 p4 = lds4(Pt + c * QT_STRIDE + RPT * tr);
      const float p[RPT] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = 4 * tc + 32 * q;
        // columns past dvp are never stored; those up to dvp hold zeros
        const float4 v4 = col < dvp ? lds4(Vs + c * dvp + col)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][q][e] = fmaf(p[i], vv[e], o[i][q][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = RPT * tr + i;
    float* acc = pb.acc_row(r);
    if (acc != nullptr) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 4 * tc + 32 * q + e;
          if (col < dv) acc[col] = o[i][q][e];
        }
      if (tc == 0) pb.put_stats(r, mrow[i], lrow[i]);
      continue;
    }
    T* dst = pb.o_row(r);
    if (dst == nullptr) continue;
    // a row that attended nothing has l == 0 and an all-zero accumulator
    const float l = lrow[i] == 0.f ? 1.f : lrow[i];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tc + 32 * q + e;
        if (col < dv) dst[col] = from_f<T>(o[i][q][e] / l);
      }
  }
}

// ---------------------------------------------------------------- tensor cores

constexpr int MMA_BN = 64;  // key/value rows per tile of attend_mma

// Dynamic shared memory attend_mma<DK, DV, KG, STAGES> needs: the Q tile of
// the CTA's BM / KG rows and STAGES buffers of K and V tiles.
inline size_t smem_bytes_mma(int dk, int dv, int kg = 1, int stages = 2) {
  return sizeof(__nv_bfloat16) * ((size_t)(BM / kg) * (dk + 8) +
                                  stages * (size_t)MMA_BN * (dk + dv + 16));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared without passing through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows rows of D bf16 values each into shared memory (row stride D + 8),
// 16 bytes per copy, asynchronously (ASYNC) or through registers; a row
// whose pointer is null reads as zeros
template <int D, bool ASYNC, typename RowFn>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int rows,
                                          RowFn row) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx - r * CHUNKS) * 8;
    const __nv_bfloat16* src = row(r);
    __nv_bfloat16* to = dst + r * (D + 8) + c;
    if (ASYNC && src)
      cp_async16(to, src + c);
    else
      *reinterpret_cast<uint4*>(to) =
          src ? *reinterpret_cast<const uint4*>(src + c)
              : make_uint4(0, 0, 0, 0);
  }
}

// The default loader of `attend_mma`: bf16 rows that the Problem points at
// (k_row, v_row), copied by cp.async straight into the tiles.  A loader
// provides `prefetch`, which starts the copies of the tile whose first
// column is j0 (the caller closes the commit group), and OWN_LOOP: a
// loader that sets it walks the keys with its own loop (`attend` and
// `smem_bytes`, quant_tiles.cuh) in place of attend_mma.
struct Bf16Rows {
  static constexpr bool OWN_LOOP = false;
  template <int DK, int DV, typename Problem>
  __device__ static void prefetch(const Problem& pb, __nv_bfloat16* K,
                                  __nv_bfloat16* V, int j0) {
    load_rows<DK, true>(K, MMA_BN, [&](int r) {
      return j0 + r < pb.n_end ? pb.k_row(j0 + r) : nullptr;
    });
    load_rows<DV, true>(V, MMA_BN, [&](int r) {
      return j0 + r < pb.n_end ? pb.v_row(j0 + r) : nullptr;
    });
  }
};

// P::Tiles where P names one, else Bf16Rows
template <typename P, typename = void>
struct tiles_of {
  using type = Bf16Rows;
};
template <typename P>
struct tiles_of<P, std::void_t<typename P::Tiles>> {
  using type = typename P::Tiles;
};

// The row maxima of a score tile in mma.sync's C layout (element e of
// n-tile j in row g + 8·(e >> 1) of the warp's 16), over the row's four
// threads.
template <int NT>
__device__ __forceinline__ void tile_row_max(const float (&s)[NT][4],
                                             float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
}

// The online-softmax step of one score tile, masked entries -inf, whose
// row maxima are mx: the rows' running max and sum move on, the output
// rows are rescaled, and s becomes P.  A row whose max is still -inf takes
// its exponents against 0, so a masked entry gives P = 0 and a NaN score
// (a NaN-scaled key) a NaN P and row sum, also when nothing finite is
// visible: the row comes out NaN, as the plain versions' amax makes it.
//
// VAR (ONLINE, FLASHD or AMLA; see the top of this file) is the rescaling
// math; mrow then holds the running max, mu, or the ceiled max.
template <int NT, int OT, int VAR = ONLINE>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4],
                                             const float (&mx)[2],
                                             float (&mrow)[2],
                                             float (&lrow)[2],
                                             float (&o)[OT][4]) {
  static_assert(VAR != BOUND, "bound mode has its own tile body");
  float corr[2];
  float base[2];
  float mold[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mnew = fmaxf(mrow[i], VAR == AMLA ? ceilf(mx[i]) : mx[i]);
    // exp2f(-inf) == 0: a row's first live tile zeroes nothing
    corr[i] = mnew == -INFINITY ? 1.f : exp2f(mrow[i] - mnew);
    if (VAR == FLASHD && mrow[i] == -INFINITY) corr[i] = 0.f;
    base[i] = mnew == -INFINITY ? 0.f : mnew;
    mold[i] = mrow[i];
    mrow[i] = mnew;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - base[e >> 1]);
      sum[e >> 1] += p;
      s[j][e] = p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    if constexpr (VAR == FLASHD) {
      // t: the denominator over exp2(b), taken out of P and of O
      const float t = corr[i] + sum[i];
      const float rt = t == 0.f ? 0.f : 1.f / t;
      corr[i] *= rt;
      sum[i] = rt;  // P's factor
      mrow[i] = mrow[i] + log2f(t);
      lrow[i] = mrow[i] == -INFINITY ? 0.f : 1.f;
    } else if constexpr (VAR == AMLA) {
      // the integer step of the ceiled max, as an exponent add
      corr[i] = mold[i] == -INFINITY ? 0.f : mold[i] - mrow[i];
      lrow[i] = exp_add(lrow[i], (int)corr[i]) + sum[i];
    } else {
      lrow[i] = lrow[i] * corr[i] + sum[i];
    }
  }
  if constexpr (VAR == FLASHD) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sum[e >> 1];
  }
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (VAR == AMLA)
        o[j][e] = exp_add(o[j][e], (int)corr[e >> 1]);
      else
        o[j][e] *= corr[e >> 1];
    }
}

// The key groups of each 16-row tile (warps w, w + 1, .. w + KG - 1 of a
// layout of 4 / KG row tiles times KG groups) merged into the tile's first
// warp, in a fixed order: each warp parks its rows' o, max and sum in
// `red`, 4 · 16 · (DV + 2) floats of shared memory that nothing else uses
// by then (the caller passed a barrier after its last read of it), and the
// first warp adds the others'.  A group that saw nothing (max -inf) weighs
// 0, but a NaN sum or output stays NaN.  Every thread must call it; it
// returns whether the calling warp holds the merged rows.
template <int KG, int DV>
__device__ __forceinline__ bool merge_key_groups(float (&o)[DV / 8][4],
                                                 float (&mrow)[2],
                                                 float (&lrow)[2],
                                                 float* red) {
  constexpr int OT = DV / 8;
  constexpr int RED = 16 * (DV + 2);  // floats per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  float* mine = red + warp * RED;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      mine[r * DV + j * 8 + 2 * tq] = o[j][2 * i];
      mine[r * DV + j * 8 + 2 * tq + 1] = o[j][2 * i + 1];
    }
    if (tq == 0) {
      mine[16 * DV + r] = mrow[i];
      mine[16 * DV + 16 + r] = lrow[i];
    }
  }
  __syncthreads();
  if (warp % KG != 0) return false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    float m = mrow[i];
#pragma unroll
    for (int k = 1; k < KG; ++k) m = fmaxf(m, mine[k * RED + 16 * DV + r]);
    // a group that saw nothing (max -inf) adds nothing
    const float c0 = mrow[i] == -INFINITY ? 0.f : exp2f(mrow[i] - m);
    float l = lrow[i] * c0;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][2 * i] *= c0;
      o[j][2 * i + 1] *= c0;
    }
#pragma unroll
    for (int k = 1; k < KG; ++k) {
      const float* other = mine + k * RED;
      const float mk = other[16 * DV + r];
      const float ck = mk == -INFINITY ? 0.f : exp2f(mk - m);
      l += other[16 * DV + 16 + r] * ck;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][2 * i] += other[r * DV + j * 8 + 2 * tq] * ck;
        o[j][2 * i + 1] += other[r * DV + j * 8 + 2 * tq + 1] * ck;
      }
    }
    mrow[i] = m;
    lrow[i] = l;
  }
  return true;
}

// The Problem interface of `attend`, for bf16 rows whose pointers and
// strides are 16-byte aligned (the launcher checks), or for the rows of
// the Problem's own loader (`Tiles`).  Dynamic shared memory:
// smem_bytes_mma(DK, DV, KG, STAGES).
//
// KG is the number of key groups: the four warps are 4 / KG row tiles of 16
// query rows times KG groups, and the warps of one row tile take each its
// own MMA_BN / KG columns of every key tile, with their own running max and
// sum.  KG = 1 is the layout of a 64-row block; KG = 4 puts all four warps
// on one 16-row tile, for a CTA whose live rows are few (one-token decode
// at GQA group 8 has 8).  The key groups' (m, l, o) merge through shared
// memory once the walk is done (`merge_key_groups`).  STAGES tiles are in
// flight at once (cp.async, one commit group per tile).
template <int DK, int DV, int KG = 1, int STAGES = 2, int VAR = ONLINE,
          typename Problem>
__device__ void attend_mma(const Problem& pb, float qscale, float cap2) {
  using Tiles = typename tiles_of<Problem>::type;
  static_assert(KG == 1 || KG == 4, "key groups");
  static_assert(STAGES >= 2, "double buffering at least");
  constexpr int ROWS = BM / KG;           // query rows of the CTA
  constexpr int KW = MMA_BN / KG;         // key columns per warp per tile
  constexpr int NT = KW / 8;              // score n-tiles per warp
  constexpr int OT = DV / 8;              // output n-tiles
  constexpr int DKP = DK + 8;
  constexpr int DVP = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // buffer b: K tile at Kb + b * KV_STRIDE, V tile right after it
  __nv_bfloat16* Kb = Qs + ROWS * DKP;
  constexpr int KV_STRIDE = MMA_BN * (DKP + DVP);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / KG * 16;    // this warp's first row
  const int ko = warp % KG * KW;    // its first column of each key tile
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int tq = lane & 3;          // fragment column pair
  const TileWalk walk(pb.n_end, pb.kv_begin, pb.sink_end, MMA_BN);
  const int ntiles = walk.count;

  // copy tile t, if there is one, into buffer t % STAGES, as one commit
  // group (an empty one past the last tile, so that the groups count tiles)
  auto prefetch = [&](int t) {
    if (t < ntiles) {
      __nv_bfloat16* K = Kb + (t % STAGES) * KV_STRIDE;
      Tiles::template prefetch<DK, DV>(pb, K, K + MMA_BN * DKP,
                                       walk.col(t, MMA_BN));
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) prefetch(t);
  load_rows<DK, false>(Qs, ROWS, [&](int r) { return pb.q_row(r); });
  __syncthreads();
  uint32_t qf[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
    ldsm_x4(qf[kk], Qs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * DKP +
                        kk * 16 + (lane >> 4) * 8);

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};
  float lrow[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    // tile t + STAGES - 1 copies while tiles t .. are computed; the barrier
    // at the end of the previous pass freed its buffer
    prefetch(t + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t has landed for every thread
    const int j0 = walk.col(t, MMA_BN);
    __nv_bfloat16* Ks = Kb + (t % STAGES) * KV_STRIDE;
    __nv_bfloat16* Vs = Ks + MMA_BN * DKP;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, Ks + (ko + jp * 16 + (lane & 7) + (lane >> 4) * 8) * DKP +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // element e of n-tile j: row wr + g + 8*(e >> 1), tile column
    // ko + j*8 + 2*tq + (e&1)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = ko + j * 8 + 2 * tq + (e & 1);
        float x = s[j][e] * qscale;
        // softcap acts on the scaled scores, before masking
        if (cap2 > 0.f) x = cap2 * tanhf(x / cap2);
        const bool keep = pb.keep(wr + g + 8 * (e >> 1), j0 + c);
        s[j][e] = keep ? x : -INFINITY;
      }
    float mx[2];
    tile_row_max(s, mx);
    softmax_tile<NT, OT, VAR>(s, mx, mrow, lrow, o);

    // P (two score n-tiles per k16 step) as the A operand, V transposed
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + (ko + ks * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * DVP +
                             np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer t % STAGES
  }

  if constexpr (KG > 1) {
    // the (now idle) tile buffers hold the key groups' merge
    static_assert(4 * 16 * (DV + 2) * sizeof(float) <=
                      STAGES * KV_STRIDE * sizeof(__nv_bfloat16),
                  "the merge fits the tile buffers");
    cp_async_wait<0>();
    if (!merge_key_groups<KG, DV>(o, mrow, lrow,
                                  reinterpret_cast<float*>(Kb)))
      return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    float* acc = pb.acc_row(r);
    if (acc != nullptr) {
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        acc[j * 8 + 2 * tq] = o[j][2 * i];
        acc[j * 8 + 2 * tq + 1] = o[j][2 * i + 1];
      }
      if (tq == 0) pb.put_stats(r, mrow[i], lrow[i]);
      continue;
    }
    __nv_bfloat16* dst = pb.o_row(r);
    if (dst == nullptr) continue;
    // a row that attended nothing has l == 0 and an all-zero accumulator
    const float inv = lrow[i] == 0.f ? 1.f : 1.f / lrow[i];
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * tq) =
          pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

}  // namespace atk
