// The flash forward's arguments, its two bodies' launches and their
// instances, shared by flash_fwd.cu (the C entry point, the online
// instances and the split merge) and flash_fwd_variant.cu, which holds the
// instances of one other max_mode variant (BOUND, FLASHD or AMLA, chosen
// when it is compiled) so that the variants' instances build in parallel.
// flash_fwd.cu's note says what the kernel computes and what bounds it.
#pragma once

#include "attention_tile.cuh"
#include "flash_fwd_sm90.cuh"
#include "tensor_map.cuh"

namespace ffwd {

using atk::BM;
using atk::THREADS;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // partials mode when acc is set: the fp32 unnormalized output (o's
  // strides) and the (B, H, m) row max and row sum, contiguous
  float* acc;
  float* row_max;
  float* row_sum;
  int H, Hkv, m, n, dk, dv;
  // element strides (batch, head, row) of q, k, v, o
  long long sqb, sqh, sqm, skb, skh, skn, svb, svh, svn, sob, soh, som;
  float qscale, cap2;
  int causal, q_offset, kv_offset, kv_valid;
  int window, sinks;  // the band, causal only (window 0: none)
  // segment ids (m) and (n rounded up to whole 128-key tiles), or null
  const int* q_seg;
  const int* kv_seg;
  // BOUND: (B, Hkv) largest key norms and the guard's verdict (non-zero:
  // run the online body), both on the device
  const float* knmax;
  const int* demote;
};

template <typename T>
struct FlashProblem : atk::ProblemBase {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* acc;
  float* mx;
  float* sm;
  long long sqm, skn, svn, som;
  int m0, m, n_end, kv_valid, q_offset, kv_offset, window, sinks;
  bool causal;
  const int* q_seg;  // segment ids, or null
  const int* kv_seg;

  __device__ const T* q_row(int r) const {
    const int row = m0 + r;
    return row < m ? q + row * sqm : nullptr;
  }
  __device__ T* o_row(int r) const {
    const int row = m0 + r;
    return row < m ? o + row * som : nullptr;
  }
  __device__ float* acc_row(int r) const {
    const int row = m0 + r;
    return acc != nullptr && row < m ? acc + row * som : nullptr;
  }
  // the tile loops keep the max in the log2 domain; JAX's stats are in
  // the natural-log domain (attention_tpu/ops/flash.py:498)
  __device__ void put_stats(int r, float mrow, float lrow) const {
    const int row = m0 + r;
    if (row < m) {
      mx[row] = mrow * atk::LN2;
      sm[row] = lrow;
    }
  }
  __device__ const T* k_row(int c) const { return k + c * skn; }
  __device__ const T* v_row(int c) const { return v + c * svn; }
  // exact per element: the band's keys are those at positions p - window
  // + 1 .. p of the row at position p, plus the positions below sinks;
  // with segment ids, only the keys of the row's segment
  __device__ bool keep(int r, int c) const {
    const int p = m0 + r + q_offset;
    const int kp = c + kv_offset;
    return c < kv_valid &&
           (!causal || (kp <= p && (window == 0 || kp > p - window ||
                                    kp < sinks))) &&
           (q_seg == nullptr || (m0 + r < m && q_seg[m0 + r] == kv_seg[c]));
  }
};

// the (batch*head, query block) of this CTA
template <typename T>
__device__ FlashProblem<T> flash_problem(const FlashArgs& a) {
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  FlashProblem<T> pb;
  pb.q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  pb.k = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  pb.v = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  pb.o = static_cast<T*>(a.o) + b * a.sob + h * a.soh;
  pb.acc = a.acc == nullptr ? nullptr : a.acc + b * a.sob + h * a.soh;
  pb.mx = a.row_max + (long long)bh * a.m;
  pb.sm = a.row_sum + (long long)bh * a.m;
  pb.sqm = a.sqm;
  pb.skn = a.skn;
  pb.svn = a.svn;
  pb.som = a.som;
  pb.m0 = blockIdx.x * BM;
  pb.m = a.m;
  pb.kv_valid = min(a.kv_valid, a.n);
  pb.q_offset = a.q_offset;
  pb.kv_offset = a.kv_offset;
  pb.causal = a.causal != 0;
  pb.window = pb.causal ? a.window : 0;
  pb.sinks = a.sinks;
  pb.q_seg = a.q_seg;
  pb.kv_seg = a.kv_seg;
  if (a.knmax != nullptr) {
    pb.knmax = a.knmax[b * a.Hkv + hk];
    pb.demoted = *a.demote != 0;
  }
  // causal: no key past the block's last row; with a band, the walk
  // starts at the block's first row's band after the sink tiles
  pb.n_end = pb.causal ? max(0, min(pb.kv_valid, pb.m0 + BM + a.q_offset -
                                                     a.kv_offset))
                       : pb.kv_valid;
  if (pb.window > 0) {
    pb.kv_begin = max(0, pb.m0 + a.q_offset - a.kv_offset - a.window + 1);
    pb.sink_end = max(0, a.sinks - a.kv_offset);
  }
  return pb;
}

// The FMA body, online and of another variant (`atk::VARIANT_MIN_BLOCKS`;
// BOUND takes the online step where the guard's verdict says so, every
// CTA alike: `attend`).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FlashArgs a) {
  atk::attend<T, NJ>(flash_problem<T>(a), a.dk, a.dv, a.qscale, a.cap2);
}

template <typename T, int NJ, int VAR>
__global__ void __launch_bounds__(THREADS, atk::VARIANT_MIN_BLOCKS)
    flash_fwd_kernel_var(FlashArgs a) {
  atk::attend<T, NJ, VAR>(flash_problem<T>(a), a.dk, a.dv, a.qscale,
                          a.cap2);
}

template <typename T, int NJ, int VAR>
constexpr auto fma_kernel() {
  if constexpr (VAR == atk::ONLINE)
    return flash_fwd_kernel<T, NJ>;
  else
    return flash_fwd_kernel_var<T, NJ, VAR>;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const FlashArgs& a, int B,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + BM - 1) / BM, B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int VAR>
cudaError_t launch_fma(const FlashArgs& a, int B, cudaStream_t s) {
  const size_t smem = atk::smem_bytes(a.dk, a.dv);
  if (a.dv <= 32) return launch(fma_kernel<T, 4, VAR>(), smem, a, B, s);
  if (a.dv <= 64) return launch(fma_kernel<T, 8, VAR>(), smem, a, B, s);
  if (a.dv <= 128) return launch(fma_kernel<T, 16, VAR>(), smem, a, B, s);
  return launch(fma_kernel<T, 32, VAR>(), smem, a, B, s);
}

// The FMA body of variant VAR: fp32 (dtype 0) or bf16 (1).
template <int VAR>
cudaError_t run_fma(const FlashArgs& a, int dtype, int B, cudaStream_t s) {
  if (dtype == 0) return launch_fma<float, VAR>(a, B, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  return launch_fma<__nv_bfloat16, VAR>(a, B, s);
}

// The wgmma body's kernel at one instance: a persistent grid, at most one
// CTA an SM, over every work item (the caller launches the split merge).
template <int DK, int DV, bool CAP, bool SEG, int VAR>
cudaError_t launch_wgmma_t(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, const sm90::Args& s, int B,
                           cudaStream_t stream) {
  auto kernel = sm90::flash_fwd_wgmma<DK, DV, CAP, sm90::FlashSched, SEG, VAR>;
  constexpr size_t smem = sm90::smem_bytes(DK, DV, SEG);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * s.H *
                          ((s.m + sm90::BM - 1) / sm90::BM) * s.splits;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, sm90::THREADS, smem, stream>>>(tq, tk, tv,
                                                 sm90::FlashSched{s});
  return cudaGetLastError();
}

// Whether variant VAR has a wgmma instance at these head dims, with or
// without segment ids: ONLINE at every pair of 64 and 128, BOUND where
// dk == dv, FLASHD and AMLA where dk == dv without ids (the caller's
// `ops.flash.flash_body` routes the rest to the FMA body).
inline bool wgmma_instance(int var, int dk, int dv, bool seg) {
  return var == atk::ONLINE ||
         (dk == dv && (var == atk::BOUND || !seg));
}

template <bool CAP, bool SEG, int VAR>
cudaError_t launch_wgmma_dims(const CUtensorMap& tq, const CUtensorMap& tk,
                              const CUtensorMap& tv, const sm90::Args& s,
                              int dk, int B, cudaStream_t st) {
  if constexpr (VAR == atk::ONLINE) {
    if (dk == 64 && s.dv == 128)
      return launch_wgmma_t<64, 128, CAP, SEG, VAR>(tq, tk, tv, s, B, st);
    if (dk == 128 && s.dv == 64)
      return launch_wgmma_t<128, 64, CAP, SEG, VAR>(tq, tk, tv, s, B, st);
  }
  if (dk == 64 && s.dv == 64)
    return launch_wgmma_t<64, 64, CAP, SEG, VAR>(tq, tk, tv, s, B, st);
  if (dk == 128 && s.dv == 128)
    return launch_wgmma_t<128, 128, CAP, SEG, VAR>(tq, tk, tv, s, B, st);
  return cudaErrorInvalidValue;
}

// The wgmma body of variant VAR: the instance of a call, softcap on or
// off, segment ids or none (where VAR has them).
template <int VAR>
cudaError_t run_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const sm90::Args& s, int dk,
                      int B, cudaStream_t st) {
  const bool cap = s.cap2 > 0.f;
  if constexpr (VAR == atk::ONLINE || VAR == atk::BOUND) {
    if (s.q_seg != nullptr)
      return cap ? launch_wgmma_dims<true, true, VAR>(tq, tk, tv, s, dk, B, st)
                 : launch_wgmma_dims<false, true, VAR>(tq, tk, tv, s, dk, B,
                                                       st);
  } else {
    if (s.q_seg != nullptr) return cudaErrorInvalidValue;
  }
  return cap ? launch_wgmma_dims<true, false, VAR>(tq, tk, tv, s, dk, B, st)
             : launch_wgmma_dims<false, false, VAR>(tq, tk, tv, s, dk, B, st);
}

}  // namespace ffwd
