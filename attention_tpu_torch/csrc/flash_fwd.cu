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
//
// What bounds it on the H100: at the testcase and serving shapes it does
// 2·m·n·(dk + dv) operations on (m + n)·(dk + dv) values, far above the ~295
// operations per byte where a bf16 kernel stops being bound by memory, so it
// is bound by operations: the tensor cores' 989 TFLOP/s in bf16, the CUDA
// cores' 67 TFLOP/s in f32 (f32 must stay full f32, so no TF32).  The design
// keeps everything but the inputs and the output out of device memory: one
// CTA per (batch*head, 64-row query block) holds its query rows, walks the
// key/value rows a tile at a time inside the CTA (the loop that replaces the
// TPU grid's sequential third axis), keeps the running max and sum in
// registers, and writes each output row once; under causal masking it stops
// at the block's last row, halving the work.  bf16 at head dims 64/128 runs
// the products on the tensor cores (`atk::attend_mma`, mma.sync); f32 and
// other head dims run fp32 FMA (`atk::attend`).  wgmma/TMA pipelines are
// later work.
#include "attention_tile.cuh"

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
  int m0, m, n_end, kv_valid, q_offset, kv_offset;
  bool causal;

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
  __device__ bool keep(int r, int c) const {
    return c < kv_valid &&
           (!causal || c + kv_offset <= m0 + r + q_offset);
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
  // causal: no key past the block's last row
  pb.n_end = pb.causal ? max(0, min(pb.kv_valid, pb.m0 + BM + a.q_offset -
                                                     a.kv_offset))
                       : pb.kv_valid;
  return pb;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FlashArgs a) {
  atk::attend<T, NJ>(flash_problem<T>(a), a.dk, a.dv, a.qscale, a.cap2);
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_mma_kernel(FlashArgs a) {
  atk::attend_mma<DK, DV>(flash_problem<__nv_bfloat16>(a), a.qscale, a.cap2);
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

cudaError_t launch_mma(const FlashArgs& a, int B, cudaStream_t s) {
  const size_t smem = atk::smem_bytes_mma(a.dk, a.dv);
  if (a.dk == 64 && a.dv == 64)
    return launch(flash_fwd_mma_kernel<64, 64>, smem, a, B, s);
  if (a.dk == 64 && a.dv == 128)
    return launch(flash_fwd_mma_kernel<64, 128>, smem, a, B, s);
  if (a.dk == 128 && a.dv == 64)
    return launch(flash_fwd_mma_kernel<128, 64>, smem, a, B, s);
  return launch(flash_fwd_mma_kernel<128, 128>, smem, a, B, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the tensor-core path reads 16-byte row chunks: bf16, head dims 64/128,
// 16-byte aligned bases and row/head/batch strides that are multiples of 8
bool mma_ok(const FlashArgs& a) {
  const long long st[12] = {a.sqb, a.sqh, a.sqm, a.skb, a.skh, a.skn,
                            a.svb, a.svh, a.svn, a.sob, a.soh, a.som};
  for (long long x : st)
    if (x % 8) return false;
  return (a.dk == 64 || a.dk == 128) && (a.dv == 64 || a.dv == 128) &&
         aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         (a.acc != nullptr || aligned16(a.o));
}

}  // namespace

// Plain C entry point, loaded through ctypes.  dtype: 0 = fp32, 1 = bf16.
// Strides are in elements, (batch, head, row) for each of q, k, v, o; the
// last dim of every tensor is contiguous.  softcap <= 0 means none;
// kv_valid is cut to n.  With acc non-null the kernel writes partials
// instead of o: acc (fp32, o's strides), row_max and row_sum ((B, H, m)
// fp32, contiguous); a row that sees no key gets max -inf and sum 0.
// Returns cudaGetLastError() after the launch (or the refusal).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int dtype, int B, int H, int Hkv, int m, int n,
                         int dk, int dv, long long sqb, long long sqh,
                         long long sqm, long long skb, long long skh,
                         long long skn, long long svb, long long svh,
                         long long svn, long long sob, long long soh,
                         long long som, float scale, float softcap,
                         int causal, int q_offset, int kv_offset,
                         int kv_valid, float* acc, float* row_max,
                         float* row_sum, void* stream) {
  if (dk < 1 || dv < 1 || dk > atk::MAX_HEAD_DIM || dv > atk::MAX_HEAD_DIM ||
      H % Hkv != 0 || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{q,   k,   v,   o,   acc, row_max, row_sum, H,
                    Hkv, m,   n,   dk,  dv,  sqb,     sqh,     sqm,
                    skb, skh, skn, svb, svh, svn,     sob,     soh,
                    som, scale * atk::LOG2E,
                    softcap > 0.f ? softcap * atk::LOG2E : 0.f, causal,
                    q_offset, kv_offset, kv_valid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fma<float>(a, B, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma_ok(a)) return (int)launch_mma(a, B, s);
  return (int)launch_fma<__nv_bfloat16>(a, B, s);
}
