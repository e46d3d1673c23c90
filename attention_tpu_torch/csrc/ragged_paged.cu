// Ragged paged attention for Hopper (sm_90a): one launch per serving step.
//
// Replaces the TPU kernel `_ragged_kernel`
// (attention_tpu/ops/ragged_paged.py:201), online max mode.  Every real
// token of a mixed decode/prefill step sits on one packed axis of q
// (1, Hq, T, d); slot s owns tokens [cu_q_lens[s], cu_q_lens[s+1]) and reads
// its kv_lens[s] (post-append) cache rows through page_table row s of the
// (P, Hkv, page, d) pools, in place.  Causal within the request: the token at
// span offset t sees positions <= kv_len - q_len + t.  Slots at or beyond
// distribution[1], and slots with q_len == 0, write nothing; a slot with
// kv_len < 0 (poisoned by the append) writes NaN on its rows.  Pad tokens
// stay zero because the wrapper zeroes the output first: slots own disjoint
// rows, so the TPU's grid-ordered read-modify-write is not needed.
//
// Work split: the grid is (ceil(q_tile * group / 64), slots * Hkv).  The
// CTAs of one (slot, kv head) share that slot's q_len x group rows in
// 64-row blocks (a span longer than q_tile is strided, never cut), laid
// out head-major (row = g * q_len + t), so the group's query heads share
// every page the CTA reads and a prefill block covers consecutive tokens
// of one head (its causal end is tight).  A decode slot is one CTA of
// `group` rows; CTAs with no rows exit at once.
//
// What bounds it on the H100: a decode slot does 4·group·kv_len·d operations
// on 2·kv_len·d cache values, about 2 operations per byte at group 8, so
// decode is bound by the bytes of the pages it reads (3.35 TB/s); a prefill
// chunk of c tokens does c times as many operations per byte and is bound by
// operations.  The design reads each page once per (slot, kv head, row
// block) straight from the pool, never gathers a dense copy of the cache,
// and skips pages past the block's causal end.  As in flash_fwd.cu, bf16 at
// head dims 64/128 runs the products on the tensor cores
// (`atk::attend_mma`), f32 and other head dims fp32 FMA (`atk::attend`).
#include "attention_tile.cuh"

namespace {

using atk::BM;
using atk::THREADS;

template <typename T>
struct RaggedProblem {
  const T* q;       // at (head kvh*group, token cu[s])
  T* o;             // same for the output
  long long sqh, sqt, soh, sot;
  const T* kp;      // pool base
  const T* vp;
  const int* table; // page-table row of this slot
  int kvh, Hkv, page, dk, dv;
  int r0, rows, q_len, kv_len, n_end;

  __device__ const T* q_row(int r) const {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int g = rr / q_len;
    return q + g * sqh + (rr - g * q_len) * sqt;
  }
  __device__ T* o_row(int r) const {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int g = rr / q_len;
    return o + g * soh + (rr - g * q_len) * sot;
  }
  __device__ long long cache_row(int c) const {
    const int phys = table[c / page];
    if (phys < 0) return -1;
    return (((long long)phys * Hkv + kvh) * page + c % page);
  }
  __device__ const T* k_row(int c) const {
    const long long row = cache_row(c);
    return row < 0 ? nullptr : kp + row * dk;
  }
  __device__ const T* v_row(int c) const {
    const long long row = cache_row(c);
    return row < 0 ? nullptr : vp + row * dv;
  }
  __device__ bool keep(int r, int c) const {
    const int rr = r0 + r;
    if (rr >= rows) return false;
    return c <= kv_len - q_len + rr % q_len;
  }
};

struct RaggedArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;
  const int* kv_lens;
  const int* cu_q_lens;
  const int* distribution;
  void* o;
  int Hq, Hkv, max_pages, page, dk, dv;
  long long sqh, sqt, soh, sot;  // element strides (head, token) of q, o
  float qscale, cap2;
};

// NJ > 0: the fp32 FMA tile loop; NJ == 0: the bf16 tensor-core loop at
// head dims (DK, DV)
template <typename T, int NJ, int DK, int DV>
__global__ void __launch_bounds__(THREADS) ragged_paged_kernel(RaggedArgs a) {
  const int s = blockIdx.y / a.Hkv;
  const int kvh = blockIdx.y - s * a.Hkv;
  if (s >= a.distribution[1]) return;
  const int tok0 = a.cu_q_lens[s];
  const int q_len = a.cu_q_lens[s + 1] - tok0;
  if (q_len <= 0) return;
  const int group = a.Hq / a.Hkv;
  const int rows = q_len * group;

  RaggedProblem<T> pb;
  pb.q = static_cast<const T*>(a.q) + (long long)kvh * group * a.sqh +
         tok0 * a.sqt;
  pb.o = static_cast<T*>(a.o) + (long long)kvh * group * a.soh + tok0 * a.sot;
  pb.sqh = a.sqh;
  pb.sqt = a.sqt;
  pb.soh = a.soh;
  pb.sot = a.sot;
  pb.rows = rows;
  pb.q_len = q_len;
  pb.kp = static_cast<const T*>(a.k_pool);
  pb.vp = static_cast<const T*>(a.v_pool);
  pb.table = a.page_table + (long long)s * a.max_pages;
  pb.kvh = kvh;
  pb.Hkv = a.Hkv;
  pb.page = a.page;
  pb.dk = a.dk;
  pb.dv = a.dv;
  const int raw_len = a.kv_lens[s];
  pb.kv_len = raw_len;

  // the grid is sized for q_tile tokens; a longer span is still covered
  // in full, by striding the row blocks
  for (int r0 = blockIdx.x * BM; r0 < rows; r0 += gridDim.x * BM) {
    pb.r0 = r0;
    if (raw_len < 0) {
      // poisoned slot (a bad append): NaN on every row it owns, loudly
      for (int idx = threadIdx.x; idx < BM * a.dv; idx += THREADS) {
        const int r = idx / a.dv;
        T* dst = pb.o_row(r);
        if (dst) dst[idx - r * a.dv] = atk::from_f<T>(NAN);
      }
      continue;
    }
    // causal end of this block: the latest span offset among its rows
    const int r_last = min(r0 + BM, rows) - 1;
    const int t_max =
        (r0 / q_len == r_last / q_len) ? r_last % q_len : q_len - 1;
    pb.n_end = min(raw_len, raw_len - q_len + t_max + 1);
    if constexpr (NJ > 0)
      atk::attend<T, NJ>(pb, a.dk, a.dv, a.qscale, a.cap2);
    else
      atk::attend_mma<DK, DV>(pb, a.qscale, a.cap2);
    __syncthreads();  // the next block rewrites the shared tiles
  }
}

template <typename T, int NJ, int DK = 0, int DV = 0>
cudaError_t launch(const RaggedArgs& a, int slots, int q_tile,
                   cudaStream_t stream) {
  auto kernel = ragged_paged_kernel<T, NJ, DK, DV>;
  const size_t smem = NJ > 0 ? atk::smem_bytes(a.dk, a.dv)
                             : atk::smem_bytes_mma(a.dk, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int group = a.Hq / a.Hkv;
  const dim3 grid((q_tile * group + BM - 1) / BM, slots * a.Hkv);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const RaggedArgs& a, int slots, int q_tile,
                       cudaStream_t s) {
  if (a.dv <= 32) return launch<T, 4>(a, slots, q_tile, s);
  if (a.dv <= 64) return launch<T, 8>(a, slots, q_tile, s);
  if (a.dv <= 128) return launch<T, 16>(a, slots, q_tile, s);
  return launch<T, 32>(a, slots, q_tile, s);
}

cudaError_t launch_mma(const RaggedArgs& a, int slots, int q_tile,
                       cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (a.dk == 64 && a.dv == 64)
    return launch<bf16, 0, 64, 64>(a, slots, q_tile, s);
  if (a.dk == 64 && a.dv == 128)
    return launch<bf16, 0, 64, 128>(a, slots, q_tile, s);
  if (a.dk == 128 && a.dv == 64)
    return launch<bf16, 0, 128, 64>(a, slots, q_tile, s);
  return launch<bf16, 0, 128, 128>(a, slots, q_tile, s);
}

// the tensor-core path reads 16-byte row chunks: head dims 64/128 (the
// pools' rows then stay 16-byte aligned), 16-byte aligned q/o/pool bases
// and q/o strides that are multiples of 8 elements
bool mma_ok(const RaggedArgs& a) {
  auto aligned16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return (a.dk == 64 || a.dk == 128) && (a.dv == 64 || a.dv == 128) &&
         a.sqh % 8 == 0 && a.sqt % 8 == 0 && a.soh % 8 == 0 &&
         a.sot % 8 == 0 && aligned16(a.q) && aligned16(a.o) &&
         aligned16(a.k_pool) && aligned16(a.v_pool);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  dtype: 0 = fp32, 1 = bf16.
// q and o are (1, Hq, T, d) with element strides (head, token) and a
// contiguous last dim; the pools are contiguous (P, Hkv, page, d); the four
// index arrays are contiguous int32 on the device.  q_tile sizes the grid
// (the longest span it covers in parallel).  softcap <= 0 means none.
// Returns cudaGetLastError().
extern "C" int ragged_paged_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_lens, const void* cu_q_lens,
    const void* distribution, void* o, int dtype, int Hq, int Hkv, int slots,
    int max_pages, int page, int dk, int dv, int q_tile, long long sqh,
    long long sqt, long long soh, long long sot, float scale, float softcap,
    void* stream) {
  if (dk < 1 || dv < 1 || dk > atk::MAX_HEAD_DIM || dv > atk::MAX_HEAD_DIM ||
      Hq % Hkv != 0 || slots < 1 || max_pages < 1 || page < 1 || q_tile < 1)
    return (int)cudaErrorInvalidValue;
  const RaggedArgs a{q, k_pool, v_pool,
                     static_cast<const int*>(page_table),
                     static_cast<const int*>(kv_lens),
                     static_cast<const int*>(cu_q_lens),
                     static_cast<const int*>(distribution),
                     o, Hq, Hkv, max_pages, page, dk, dv, sqh, sqt, soh, sot,
                     scale * atk::LOG2E,
                     softcap > 0.f ? softcap * atk::LOG2E : 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fma<float>(a, slots, q_tile, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma_ok(a)) return (int)launch_mma(a, slots, q_tile, s);
  return (int)launch_fma<__nv_bfloat16>(a, slots, q_tile, s);
}
