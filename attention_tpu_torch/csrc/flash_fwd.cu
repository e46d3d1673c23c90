// Forward flash attention for Hopper (sm_90a), normalized output or partials.
//
// Replaces the TPU kernel `_flash_kernel` (attention_tpu/ops/flash.py:310,
// launched by `_flash_call`), online max mode, normalized output or, given
// an fp32 accumulator, the partials of `flash_attention_partials`: the
// unnormalized output, each row's max (natural-log domain) and its sum of
// exponentials, which training saves for the backward.  Computes
// softmax(Q Kᵀ · scale) V for q (B, H, m, dk), k (B, Hkv, n, dk),
// v (B, Hkv, n, dv); q head h reads kv head h / (H / Hkv).  Only the first
// kv_valid key rows are attended (a cache filled up to there).  Causal
// masking uses global positions: query row i sits at q_offset + i, key row
// j at kv_offset + j, and row i sees the keys at or before it (cached
// prefill passes q_offset = the cache's length, kv_valid = its new length);
// softcap maps the scaled scores through cap·tanh(s/cap) before masking.
// A sliding window (causal only, the TPU kernel's window/sinks) keeps only
// the last `window` positions at or before a row's, plus the keys at
// positions below `sinks` (StreamingLLM's attention sinks).  Packed-
// sequence segment ids (the TPU kernel's q_seg/kv_seg, one int32 a query
// row and a key row, shared across heads) keep a pair only where they are
// equal, on top of every other mask.
//
// What bounds it on the H100: at the testcase and serving shapes it does
// 2·m·n·(dk + dv) operations on (m + n)·(dk + dv) values, far above the ~295
// operations per byte where a bf16 kernel stops being bound by memory, so it
// is bound by operations: the tensor cores' 989 TFLOP/s in bf16, the CUDA
// cores' 67 TFLOP/s in f32 (f32 must stay full f32, so no TF32).  Everything
// but the inputs and the output stays out of device memory: a CTA holds its
// query rows, walks the key/value rows a tile at a time (the loop that
// replaces the TPU grid's sequential third axis), keeps the running max and
// sum in registers and writes each output row once; under causal masking it
// stops at the block's last row, halving the work, and under a window it
// starts at the block's band after the sink tiles, so the work scales with
// the window (`atk::TileWalk` in the FMA body, `tile_plan` in the wgmma
// one).  Two bodies, named by
// the caller (`ops.flash.flash_body`) and refused here where they do not
// fit: "wgmma" for bf16 at head dims 64/128 with 16-byte aligned bases and
// strides (flash_fwd_sm90.cuh: wgmma products on TMA-fed 128-row tiles,
// masks only where a tile needs them, heaviest-first order on a persistent
// grid and a key split for thin grids; its note says what each does), and
// "fma" for everything else (`atk::attend`, fp32 FMA on the CUDA cores,
// 64-row CTAs).
#include "attention_tile.cuh"
#include "flash_fwd_sm90.cuh"
#include "tensor_map.cuh"

namespace {

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

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FlashArgs a) {
  atk::attend<T, NJ>(flash_problem<T>(a), a.dk, a.dv, a.qscale, a.cap2);
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

template <typename T>
cudaError_t launch_fma(const FlashArgs& a, int B, cudaStream_t s) {
  const size_t smem = atk::smem_bytes(a.dk, a.dv);
  if (a.dv <= 32) return launch(flash_fwd_kernel<T, 4>, smem, a, B, s);
  if (a.dv <= 64) return launch(flash_fwd_kernel<T, 8>, smem, a, B, s);
  if (a.dv <= 128) return launch(flash_fwd_kernel<T, 16>, smem, a, B, s);
  return launch(flash_fwd_kernel<T, 32>, smem, a, B, s);
}

// the wgmma body's tiles come by TMA: bf16, head dims 64/128, 16-byte
// aligned bases, and (batch, head, row) strides that are positive
// multiples of 8 elements (16 bytes)
bool wgmma_ok(const FlashArgs& a) {
  const long long st[12] = {a.sqb, a.sqh, a.sqm, a.skb, a.skh, a.skn,
                            a.svb, a.svh, a.svn, a.sob, a.soh, a.som};
  for (long long x : st)
    if (x <= 0 || x % 8) return false;
  return (a.dk == 64 || a.dk == 128) && (a.dv == 64 || a.dv == 128) &&
         tmap::aligned16(a.q) && tmap::aligned16(a.k) &&
         tmap::aligned16(a.v) && (a.acc != nullptr || tmap::aligned16(a.o));
}

template <int DK, int DV, bool CAP, bool SEG>
cudaError_t launch_wgmma_t(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, const sm90::Args& s, int B,
                           cudaStream_t stream) {
  auto kernel = sm90::flash_fwd_wgmma<DK, DV, CAP, sm90::FlashSched, SEG>;
  constexpr size_t smem = sm90::smem_bytes(DK, DV, SEG);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: at most one CTA an SM, over every work item
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
  err = cudaGetLastError();
  if (err != cudaSuccess || s.splits == 1) return err;
  const long long bhm = (long long)B * s.H * s.m;
  sm90::flash_merge<<<(unsigned)((bhm + sm90::MERGE_ROWS - 1) /
                                 sm90::MERGE_ROWS),
                      32 * sm90::MERGE_ROWS, 0, stream>>>(s, bhm);
  return cudaGetLastError();
}

template <bool CAP, bool SEG>
cudaError_t launch_wgmma_cap(const CUtensorMap& tq, const CUtensorMap& tk,
                             const CUtensorMap& tv, const sm90::Args& s,
                             int dk, int B, cudaStream_t st) {
  if (dk == 64 && s.dv == 64)
    return launch_wgmma_t<64, 64, CAP, SEG>(tq, tk, tv, s, B, st);
  if (dk == 64)
    return launch_wgmma_t<64, 128, CAP, SEG>(tq, tk, tv, s, B, st);
  if (s.dv == 64)
    return launch_wgmma_t<128, 64, CAP, SEG>(tq, tk, tv, s, B, st);
  return launch_wgmma_t<128, 128, CAP, SEG>(tq, tk, tv, s, B, st);
}

// The instance of a call: softcap on or off, segment ids or none.
template <bool CAP>
cudaError_t launch_wgmma_seg(const CUtensorMap& tq, const CUtensorMap& tk,
                             const CUtensorMap& tv, const sm90::Args& s,
                             int dk, int B, cudaStream_t st) {
  return s.q_seg != nullptr
             ? launch_wgmma_cap<CAP, true>(tq, tk, tv, s, dk, B, st)
             : launch_wgmma_cap<CAP, false>(tq, tk, tv, s, dk, B, st);
}

// The wgmma body: the tensor maps of q, k and v, then the kernel over
// `splits` key splits of split_tiles tiles each (and the merge when
// splits > 1, its scratch in part).
cudaError_t launch_wgmma(const FlashArgs& a, int B, int splits,
                         int split_tiles, float* part, cudaStream_t st) {
  const tmap::EncodeTiled enc = tmap::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tmap::encode(enc, &tq, a.q, a.dk, a.m, a.H, B, a.sqm, a.sqh, a.sqb,
                    sm90::BM) ||
      !tmap::encode(enc, &tk, a.k, a.dk, a.n, a.Hkv, B, a.skn, a.skh, a.skb,
                    sm90::BN) ||
      !tmap::encode(enc, &tv, a.v, a.dv, a.n, a.Hkv, B, a.svn, a.svh, a.svb,
                    sm90::BN))
    return cudaErrorInvalidValue;
  sm90::Args s;
  s.o = a.o;
  s.acc = a.acc;
  s.row_max = a.row_max;
  s.row_sum = a.row_sum;
  s.part = splits > 1 ? part : nullptr;
  s.B = B;
  s.H = a.H;
  s.Hkv = a.Hkv;
  s.m = a.m;
  s.dv = a.dv;
  s.sob = a.sob;
  s.soh = a.soh;
  s.som = a.som;
  s.qscale = a.qscale;
  s.cap2 = a.cap2;
  s.causal = a.causal;
  s.q_offset = a.q_offset;
  s.kv_offset = a.kv_offset;
  s.kv_valid = a.kv_valid < 0 ? 0 : a.kv_valid > a.n ? a.n : a.kv_valid;
  s.window = a.window;
  s.sinks = a.sinks;
  s.splits = splits;
  s.split_tiles = split_tiles;
  s.q_seg = a.q_seg;
  s.kv_seg = a.kv_seg;
  return a.cap2 > 0.f ? launch_wgmma_seg<true>(tq, tk, tv, s, a.dk, B, st)
                      : launch_wgmma_seg<false>(tq, tk, tv, s, a.dk, B, st);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  dtype: 0 = fp32, 1 = bf16.
// Strides are in elements, (batch, head, row) for each of q, k, v, o; the
// last dim of every tensor is contiguous.  softcap <= 0 means none;
// kv_valid is cut to n.  With acc non-null the kernel writes partials
// instead of o: acc (fp32, o's strides), row_max and row_sum ((B, H, m)
// fp32, contiguous); a row that sees no key gets max -inf and sum 0.
// window > 0 (causal only) keeps, of the keys at or before a row's
// position p, those after p - window and those at positions below sinks
// (window 0: no band, sinks 0: none); the bodies walk only the tiles the
// band and the sinks hold.
// body: 0 = "fma", 1 = "wgmma" (the caller's `flash_body`); a body that
// cannot take the call is refused, never replaced.  The wgmma body cuts
// each row block's key tiles into splits of split_tiles tiles (splits 1:
// no cut) and merges them through part, splits·B·H·m·(dv + 2) floats.
// q_seg and kv_seg, both set or both null, are int32 segment ids of the
// query rows (m) and the key rows (n, padded with ids no row holds to a
// whole number of 128-key tiles, and 16-byte aligned, for the wgmma
// body's bulk copies); a pair is kept only where they are equal.
// Returns cudaGetLastError() after the launches (or the refusal).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int dtype, int B, int H, int Hkv, int m, int n,
                         int dk, int dv, long long sqb, long long sqh,
                         long long sqm, long long skb, long long skh,
                         long long skn, long long svb, long long svh,
                         long long svn, long long sob, long long soh,
                         long long som, float scale, float softcap,
                         int causal, int q_offset, int kv_offset,
                         int kv_valid, int window, int sinks, float* acc,
                         float* row_max,
                         float* row_sum, int body, int splits,
                         int split_tiles, float* part, const void* q_seg,
                         const void* kv_seg, void* stream) {
  if (dk < 1 || dv < 1 || dk > atk::MAX_HEAD_DIM || dv > atk::MAX_HEAD_DIM ||
      H % Hkv != 0 || m < 1 || n < 1 || splits < 1 || window < 0 ||
      sinks < 0 || (window > 0 && !causal) || (sinks > 0 && window == 0) ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{q,   k,   v,   o,   acc, row_max, row_sum, H,
                    Hkv, m,   n,   dk,  dv,  sqb,     sqh,     sqm,
                    skb, skh, skn, svb, svh, svn,     sob,     soh,
                    som, scale * atk::LOG2E,
                    softcap > 0.f ? softcap * atk::LOG2E : 0.f, causal,
                    q_offset, kv_offset, kv_valid, window, sinks,
                    static_cast<const int*>(q_seg),
                    static_cast<const int*>(kv_seg)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || !wgmma_ok(a) || split_tiles < 1 ||
        (splits > 1 && part == nullptr) ||
        (kv_seg != nullptr && !tmap::aligned16(kv_seg)))
      return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(a, B, splits, split_tiles, part, s);
  }
  if (body != 0 || splits != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_fma<float>(a, B, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_fma<__nv_bfloat16>(a, B, s);
}
