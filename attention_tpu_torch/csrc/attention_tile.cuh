// The blocked online-softmax tile loops shared by the port's two attention
// kernels (flash_fwd.cu and ragged_paged.cu).
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
// four warps owns 16 query rows; Q fragments stay in registers, K and V
// tiles of MMA_BN rows sit in two shared buffers with rows padded by 16
// bytes (conflict-free `ldmatrix`), the next tile copying in with
// `cp.async` while the current one is computed; V is read transposed by
// `ldmatrix.trans`.  The
// score accumulators turn into the P·V A-operand in registers, as in
// FlashAttention-2.
//
// In both, P is rounded to bf16 before the P·V product for bf16 inputs, as
// the reference rounds `p.astype(v.dtype)`; the row sum uses the unrounded P.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// One CTA's attention over the rows and key/value stream a Problem
// describes.  A Problem provides:
//   n_end               columns [0, n_end) are visited (masked beyond)
//   q_row(r), o_row(r)  pointers to query / output row r of the CTA, or
//                       nullptr for a row the CTA does not own
//   k_row(c), v_row(c)  pointers to key / value row c, or nullptr (zeros)
//   keep(r, c)          whether row r may attend column c
// qscale is scale*log2(e); cap2 is softcap*log2(e), or 0 for no softcap.
// NJ output columns per thread: dv <= 8*NJ, NJ a multiple of 4.  Thread
// (tr, tc) owns rows 4*tr .. 4*tr+3, score columns 4*tc .. 4*tc+3 of each
// tile and output columns 4*tc + 32*q + e (q < NJ/4, e < 4).
template <typename T, int NJ, typename Problem>
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

  for (int j0 = 0; j0 < pb.n_end; j0 += BN) {
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
    T* dst = pb.o_row(RPT * tr + i);
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

// Dynamic shared memory attend_mma<DK, DV> needs: the Q tile and two
// buffers of K and V tiles.
inline size_t smem_bytes_mma(int dk, int dv) {
  return sizeof(__nv_bfloat16) *
         ((size_t)BM * (dk + 8) + 2 * (size_t)MMA_BN * (dk + dv + 16));
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

// The Problem interface of `attend`, for bf16 rows whose pointers and
// strides are 16-byte aligned (the launcher checks).
template <int DK, int DV, typename Problem>
__device__ void attend_mma(const Problem& pb, float qscale, float cap2) {
  constexpr int DKP = DK + 8;
  constexpr int DVP = DV + 8;
  constexpr int NT = MMA_BN / 8;  // score n-tiles per tile
  constexpr int OT = DV / 8;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // buffer b: K tile at Kb + b * KV_STRIDE, V tile right after it
  __nv_bfloat16* Kb = Qs + BM * DKP;
  constexpr int KV_STRIDE = MMA_BN * (DKP + DVP);
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // this warp's first row
  const int g = lane >> 2;                 // fragment row (and row + 8)
  const int tq = lane & 3;                 // fragment column pair
  const int ntiles = (pb.n_end + MMA_BN - 1) / MMA_BN;

  // copy tile t into buffer t & 1, as one commit group
  auto prefetch = [&](int t) {
    const int j0 = t * MMA_BN;
    __nv_bfloat16* K = Kb + (t & 1) * KV_STRIDE;
    load_rows<DK, true>(K, MMA_BN, [&](int r) {
      return j0 + r < pb.n_end ? pb.k_row(j0 + r) : nullptr;
    });
    load_rows<DV, true>(K + MMA_BN * DKP, MMA_BN, [&](int r) {
      return j0 + r < pb.n_end ? pb.v_row(j0 + r) : nullptr;
    });
    cp_async_commit();
  };

  if (ntiles > 0) prefetch(0);
  load_rows<DK, false>(Qs, BM, [&](int r) { return pb.q_row(r); });
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
    // tile t + 1 copies while tile t is computed; the barrier at the end
    // of the previous pass freed its buffer
    if (t + 1 < ntiles) {
      prefetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    const int j0 = t * MMA_BN;
    const __nv_bfloat16* Ks = Kb + (t & 1) * KV_STRIDE;
    const __nv_bfloat16* Vs = Ks + MMA_BN * DKP;

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
        ldsm_x4(b, Ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * DKP +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // element e of tile j: row wr + g + 8*(e >> 1), column j*8 + 2*tq + (e&1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * qscale;
        // softcap acts on the scaled scores, before masking
        if (cap2 > 0.f) x = cap2 * tanhf(x / cap2);
        const bool keep =
            pb.keep(wr + g + 8 * (e >> 1), j0 + j * 8 + 2 * tq + (e & 1));
        s[j][e] = keep ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
    float mnew[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mnew[i] = fmaxf(mrow[i], mx[i]);
      // exp2f(-inf) == 0: a row's first live tile zeroes nothing
      corr[i] = mnew[i] == -INFINITY ? 1.f : exp2f(mrow[i] - mnew[i]);
      mrow[i] = mnew[i];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = mnew[e >> 1];
        const float p = m == -INFINITY ? 0.f : exp2f(s[j][e] - m);
        sum[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      lrow[i] = lrow[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];

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
        ldsm_x4_trans(b, Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  DVP +
                             np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer t & 1
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* dst = pb.o_row(wr + g + 8 * i);
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
