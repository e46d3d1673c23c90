// The rows, band and launch of a decode or chunk-verify call, shared by
// decode.cu (dense caches) and paged_decode.cu (caches behind a page table).
//
// One CTA per (sequence b, kv head, 64-row block).  The rows of a (b, kv
// head) are its group of query heads times the S tokens just appended,
// laid out (g, s) with s minor, so the group's heads share every key/value
// row the CTA reads: the cache is read once per kv head (and once more per
// extra row block, which only chunk mode has).  Row (g, s) sits at position
// len - S + s, where len is the cache's length after the append, and sees
// the cache rows at or before it; with a window w it sees only the rows
// after pos - w, plus the pinned first `sinks` rows.  One-token decode is
// S = 1.
//
// The loop bounds are the band: n_end stops at the block's last row, and
// with a window the walk starts at the block's lowest band start, after the
// sink tiles (`atk::TileWalk`).  This is what the TPU kernels got from
// clamping their DMA index maps (`banded_block_clamp`,
// attention_tpu/ops/decode.py:195): the bytes read scale with the band, not
// with the cache's capacity.  Each row's own mask (`keep`) is exact.  A
// length of 0 reads nothing and writes a zero row (the l == 0 guard of
// attention_tpu/ops/decode.py:162-166).
#pragma once

#include "attention_tile.cuh"

namespace atk {

// What both decode kernels take besides where the cache rows live.
struct DecodeArgs {
  const void* q;
  void* o;          // normalized output, or nullptr when acc is set
  float* acc;       // unnormalized fp32 output (partials), or nullptr
  float* m_out;     // partials: row max, natural log, contiguous (B, H, S)
  float* l_out;     // partials: row sum, contiguous (B, H, S)
  const int* lens;  // (B,) cache lengths after the append
  int H, Hkv, S, dk, dv;
  int n_cap;        // cache rows addressable per sequence
  int window;       // 0: no band
  int sinks;
  long long sqb, sqh, sqs, sob, soh, sos;  // element strides (batch, head,
                                           // token) of q and of o / acc
  float qscale, cap2;
  int poison;       // a negative length writes NaN rows (else reads as 0)
};

template <typename T, typename Rows>
struct DecodeProblem : ProblemBase {
  using Tiles = typename tiles_of<Rows>::type;  // attend_mma's loader
  const T* q;  // each at (b, first head of the group, token 0)
  T* o;
  float* acc;
  float* m_out;
  float* l_out;
  long long sqh, sqs, soh, sos;
  int S, rows, r0, len, n_end, window, sinks;
  Rows kv;

  __device__ const T* q_row(int r) const {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int g = rr / S;
    return q + g * sqh + (rr - g * S) * sqs;
  }
  __device__ T* o_row(int r) const {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int g = rr / S;
    return o + g * soh + (rr - g * S) * sos;
  }
  __device__ float* acc_row(int r) const {
    const int rr = r0 + r;
    if (acc == nullptr || rr >= rows) return nullptr;
    const int g = rr / S;
    return acc + g * soh + (rr - g * S) * sos;
  }
  __device__ void put_stats(int r, float m2, float l) const {
    const int rr = r0 + r;  // (g, s) is row g*S + s of the group's stats
    m_out[rr] = m2 * LN2;
    l_out[rr] = l;
  }
  __device__ const T* k_row(int c) const { return kv.k_row(c); }
  __device__ const T* v_row(int c) const { return kv.v_row(c); }
  __device__ bool keep(int r, int c) const {
    const int rr = r0 + r;
    if (rr >= rows) return false;
    const int pos = len - S + rr % S;
    return c <= pos && (window == 0 || c > pos - window || c < sinks);
  }
};

// Source: where cache rows live; `rows<T>(b, kv head)` gives the accessor
// of one sequence's kv head.
template <typename T, int NJ, int DK, int DV, typename Source>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(DecodeArgs a, Source src) {
  const int b = blockIdx.y / a.Hkv;
  const int kvh = blockIdx.y - b * a.Hkv;
  const int group = a.H / a.Hkv;
  const long long h0 = (long long)kvh * group;
  DecodeProblem<T, typename Source::template Rows<T>> pb;
  pb.rows = group * a.S;
  pb.r0 = blockIdx.x * BM;
  pb.q = static_cast<const T*>(a.q) + b * a.sqb + h0 * a.sqh;
  pb.o = a.o ? static_cast<T*>(a.o) + b * a.sob + h0 * a.soh : nullptr;
  pb.acc = a.acc ? a.acc + b * a.sob + h0 * a.soh : nullptr;
  const long long st = ((long long)b * a.H + h0) * a.S;
  pb.m_out = a.m_out ? a.m_out + st : nullptr;
  pb.l_out = a.l_out ? a.l_out + st : nullptr;
  pb.sqh = a.sqh;
  pb.sqs = a.sqs;
  pb.soh = a.soh;
  pb.sos = a.sos;
  pb.S = a.S;
  pb.window = a.window;
  pb.sinks = a.sinks;
  pb.kv = src.template rows<T>(b, kvh);
  const int raw = a.lens[b];
  if (raw < 0 && a.poison) {
    // poisoned sequence (a bad append): NaN on every row, loudly
    for (int idx = threadIdx.x; idx < BM * a.dv; idx += THREADS) {
      const int r = idx / a.dv;
      T* dst = pb.o_row(r);
      if (dst) dst[idx - r * a.dv] = from_f<T>(NAN);
    }
    return;
  }
  pb.len = max(raw, 0);
  // the block's rows span tokens s_lo..s_hi (all of them once it holds
  // rows of two heads)
  const int r_last = min(pb.r0 + BM, pb.rows) - 1;
  const bool one_head = pb.r0 / a.S == r_last / a.S;
  const int s_lo = one_head ? pb.r0 % a.S : 0;
  const int s_hi = one_head ? r_last % a.S : a.S - 1;
  pb.n_end = min(pb.len - a.S + s_hi + 1, a.n_cap);
  if (a.window > 0) {
    pb.kv_begin = max(pb.len - a.S + s_lo - a.window + 1, 0);
    pb.sink_end = a.sinks;
  }
  if constexpr (NJ > 0)
    attend<T, NJ>(pb, a.dk, a.dv, a.qscale, a.cap2);
  else
    attend_mma<DK, DV>(pb, a.qscale, a.cap2);
}

template <typename T, int NJ, int DK, int DV, typename Source>
cudaError_t launch_decode(const DecodeArgs& a, const Source& src, int B,
                          cudaStream_t stream) {
  auto kernel = decode_kernel<T, NJ, DK, DV, Source>;
  using Tiles = typename tiles_of<typename Source::template Rows<T>>::type;
  const size_t smem =
      NJ > 0 ? smem_bytes(a.dk, a.dv)
             : smem_bytes_mma(a.dk, a.dv) +
                   2 * (size_t)Tiles::template stage_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.H / a.Hkv * a.S + BM - 1) / BM, B * a.Hkv);
  kernel<<<grid, THREADS, smem, stream>>>(a, src);
  return cudaGetLastError();
}

// What every decode kernel refuses.
inline bool decode_args_ok(const DecodeArgs& a, int B) {
  return a.dk >= 1 && a.dv >= 1 && a.dk <= MAX_HEAD_DIM &&
         a.dv <= MAX_HEAD_DIM && B >= 1 && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         a.S >= 1 && a.window >= 0 && a.sinks >= 0 && a.n_cap >= 0;
}

// Refuse what the kernels do not take, then pick the loop: fp32 FMA for
// f32 and for bf16 at other head dims, tensor cores for bf16 at head dims
// 64/128 when the caller found the rows 16-byte aligned (mma_ok).
template <typename Source>
cudaError_t dispatch_decode(const DecodeArgs& a, const Source& src, int B,
                            int dtype, bool mma_ok, cudaStream_t s) {
  if (!decode_args_ok(a, B)) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (dtype == 1 && mma_ok && (a.dk == 64 || a.dk == 128) &&
      (a.dv == 64 || a.dv == 128)) {
    if (a.dk == 64 && a.dv == 64)
      return launch_decode<bf16, 0, 64, 64>(a, src, B, s);
    if (a.dk == 64)
      return launch_decode<bf16, 0, 64, 128>(a, src, B, s);
    if (a.dv == 64)
      return launch_decode<bf16, 0, 128, 64>(a, src, B, s);
    return launch_decode<bf16, 0, 128, 128>(a, src, B, s);
  }
  if (dtype == 0) {
    if (a.dv <= 32) return launch_decode<float, 4, 0, 0>(a, src, B, s);
    if (a.dv <= 64) return launch_decode<float, 8, 0, 0>(a, src, B, s);
    if (a.dv <= 128) return launch_decode<float, 16, 0, 0>(a, src, B, s);
    return launch_decode<float, 32, 0, 0>(a, src, B, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (a.dv <= 32) return launch_decode<bf16, 4, 0, 0>(a, src, B, s);
  if (a.dv <= 64) return launch_decode<bf16, 8, 0, 0>(a, src, B, s);
  if (a.dv <= 128) return launch_decode<bf16, 16, 0, 0>(a, src, B, s);
  return launch_decode<bf16, 32, 0, 0>(a, src, B, s);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// q and o (or acc) 16-byte aligned with strides in multiples of 8 elements
inline bool rows_aligned(const DecodeArgs& a) {
  return a.sqb % 8 == 0 && a.sqh % 8 == 0 && a.sqs % 8 == 0 &&
         a.sob % 8 == 0 && a.soh % 8 == 0 && a.sos % 8 == 0 &&
         aligned16(a.q) && aligned16(a.o ? a.o : a.acc);
}

}  // namespace atk
