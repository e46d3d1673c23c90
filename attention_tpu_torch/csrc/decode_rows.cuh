// The rows, band, key split and launch of a decode or chunk-verify call,
// shared by decode.cu (dense caches), paged_decode.cu (caches behind a page
// table, `PagedSource`), the quantized caches' kernels (quant_tiles.cuh)
// and the decode slots of ragged_paged.cu.
//
// Rows.  The rows of a (sequence b, kv head) are its group of query heads
// times the S tokens just appended, laid out (g, s) with s minor, so the
// group's heads share every key/value row a CTA reads: the cache is read
// once per kv head and split (and once more per extra row block, which only
// chunk mode has).  Row (g, s) sits at position len - S + s, where len is
// the cache's length after the append, and sees the cache rows at or before
// it; with a window w it sees only the rows after pos - w, plus the pinned
// first `sinks` rows.  One-token decode is S = 1.  A source may give a
// sequence fewer tokens than S, or none (`span`: the ragged kernel's slots
// read theirs from cu_q_lens); the scratch keeps S tokens a head.
//
// Grid (row blocks, B·Hkv, splits).  A CTA owns one block of rows (64, or
// 16 where the bf16 loop splits every key tile across its four warps) and
// one split of its sequence's keys.  The host cuts the keys without reading
// the lengths (`split_plan`, attention_tpu_torch/ops/decode.py): `splits`
// splits of `chunk` columns, chunk a whole number of key tiles.  On the
// device, split i owns the columns [first + i·chunk, first + (i+1)·chunk),
// the last split everything after its start, where `first` is the lowest
// band start of the sequence's rows rounded down to a key tile (0 without a
// window); split 0 also owns every column below `first`, the pinned sinks
// among them.  `split_owner` in ops/decode.py is the same partition.
//
// The loop bounds are the band cut to the split: n_end stops at the block's
// last row (or the split's end), and the walk starts at the block's lowest
// band start or the split's start, whichever is later, after the sink tiles
// (split 0; `atk::TileWalk`).  This is what the TPU kernels got from
// clamping their DMA index maps (`banded_block_clamp`,
// attention_tpu/ops/decode.py:195): the bytes read scale with the band, not
// with the cache's capacity.  Each row's own mask (`keep`) is exact.  A
// split whose columns lie past the length or below the band writes an empty
// partial (max -inf, sum 0) and exits.
//
// With one split the CTA writes the normalized output itself (or the paged
// kernel's partials), and a length of 0 gives a zero row (the l == 0 guard
// of attention_tpu/ops/decode.py:162-166).  With more, each CTA writes its
// fp32 unnormalized output, row max (natural log) and row sum into scratch
// (B, H, S, splits, dv) and (B, H, S, splits) that the wrapper allocated,
// and `merge_splits`, launched next on the same stream, combines them: the
// two-phase max, rescale, sum of attention_tpu/parallel/kv_sharded.py:45-58
// in split order, with no atomics, so a second call gives the same bits.
// Nothing seen (sum 0) gives a zero row, a poisoned sequence NaN rows, and a
// split whose sum is NaN (it saw a NaN score, `softmax_tile`) NaN rows too,
// whatever its max.
//
// VAR is the rescaling math of the tile loops (attention_tile.cuh: ONLINE,
// FLASHD or AMLA; bound is forward-only, as in the TPU kernels).  Under
// FLASHD a split's partials are its normalized output with (mu, 1), and
// under AMLA its ceiled max with its sum: the merge weighs them as it
// weighs online's.  The variants' tensor-core instances exist at dk == dv
// only; elsewhere they take the FMA loop.
#pragma once

#include "attention_tile.cuh"

namespace atk {

// What every decode kernel takes besides where the cache rows live.
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
  int splits;       // key splits per sequence (1: no merge)
  int chunk;        // columns per split, a multiple of MMA_BN
  float* part_acc;  // splits > 1: contiguous (B, H, S, splits, dv) scratch
  float* part_m;    // and (B, H, S, splits) row max and row sum
  float* part_l;
  int no_merge;     // splits > 1: the caller merges the partials itself
};

// The query rows of sequence b: q's and the output's offsets (elements)
// and the tokens it appended, S of them unless its source says fewer
// (the ragged kernel's decode slots); a sequence that is not live writes
// nothing.  A source that declares `Spans` names them with `span(b, a)`.
struct Span {
  long long q_off, o_off;
  int S;
  bool live;
};

template <typename Source, typename = void>
struct has_span : std::false_type {};
template <typename Source>
struct has_span<Source, std::void_t<typename Source::Spans>>
    : std::true_type {};

template <typename Source>
__device__ __forceinline__ Span span_of(const Source& src, const DecodeArgs& a,
                                        int b) {
  if constexpr (has_span<Source>::value)
    return src.span(b, a);
  else
    return {b * a.sqb, b * a.sob, a.S, true};
}

template <typename T, typename Rows>
struct DecodeProblem : ProblemBase {
  using Tiles = typename tiles_of<Rows>::type;  // the tile loop's loader
  const T* q;  // each at (b, first head of the group, token 0)
  T* o;
  float* acc;
  float* m_out;
  float* l_out;
  long long sqh, sqs, soh, sos;
  int S, rows, r0, len, n_end, window, sinks;
  int Sl;       // tokens per head in the stats' layout (S or more)
  int sstride;  // elements between two rows' stats
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
    const int rr = r0 + r;  // (g, s) is row g*Sl + s of the group's stats
    const int g = rr / S;
    const int at = (g * Sl + rr - g * S) * sstride;
    m_out[at] = m2 * LN2;
    l_out[at] = l;
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

// Rows [0, n) of a key tile at base + r·stride: a source's `k_tile` and
// `v_tile` address a tile once, where `k_row` and `v_row` address a row.
template <typename T>
struct TileSpan {
  const T* base;
  long long stride;
  int n;
};

// The loader of the dense and paged sources: Bf16Rows, with the tile's
// rows addressed through its span, and rows past the span (a tile that
// crosses a page) one by one.
struct SpanTiles : Bf16Rows {
  template <int DK, int DV, typename Problem>
  __device__ static void prefetch(const Problem& pb, __nv_bfloat16* K,
                                  __nv_bfloat16* V, int j0) {
    const int live = pb.n_end - j0;
    const TileSpan<__nv_bfloat16> k = pb.kv.k_tile(j0);
    const TileSpan<__nv_bfloat16> v = pb.kv.v_tile(j0);
    load_rows<DK, true>(K, MMA_BN, [&](int r) {
      return r >= live ? nullptr
             : r < k.n ? k.base + r * k.stride
                       : pb.kv.k_row(j0 + r);
    });
    load_rows<DV, true>(V, MMA_BN, [&](int r) {
      return r >= live ? nullptr
             : r < v.n ? v.base + r * v.stride
                       : pb.kv.v_row(j0 + r);
    });
  }
};

// Cache rows behind a page table (paged_decode.cu, and the decode slots of
// ragged_paged.cu): row c of sequence b lives in page table[b, c / page]
// at slot c % page of the (P, Hkv, page, d) pools.  A -1 entry reads page
// 0, as the TPU kernels' clamp did.
struct PagedSource {
  const void* k_pool;
  const void* v_pool;
  const int* table;
  int max_pages, Hkv, page, dk, dv;

  template <typename T>
  struct Rows {
    using Tiles = SpanTiles;
    const T* kp;
    const T* vp;
    const int* table;  // this sequence's row
    int kvh, Hkv, page, dk, dv;
    __device__ long long row(int c) const {
      const int phys = max(table[c / page], 0);
      return ((long long)phys * Hkv + kvh) * page + c % page;
    }
    __device__ const T* k_row(int c) const { return kp + row(c) * dk; }
    __device__ const T* v_row(int c) const { return vp + row(c) * dv; }
    // the rows from c to the end of its page
    __device__ TileSpan<T> k_tile(int c) const {
      return {k_row(c), dk, page - c % page};
    }
    __device__ TileSpan<T> v_tile(int c) const {
      return {v_row(c), dv, page - c % page};
    }
  };

  template <typename T>
  __device__ Rows<T> rows(int b, int kvh) const {
    return {static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
            table + (long long)b * max_pages, kvh, Hkv, page, dk, dv};
  }
};

// cp.async stages of the bf16 loop: three where the CTA's 16 rows leave
// room for them (two such CTAs fit an SM), two for 64-row blocks
template <int KG>
constexpr int DECODE_STAGES = KG > 1 ? 3 : 2;

// Source: where cache rows live; `rows<T>(b, kv head)` gives the accessor
// of one sequence's kv head, whose loader (`Tiles`) may bring its own tile
// loop (OWN_LOOP: the quantized caches).  KG: the bf16 loop's key groups (1
// or 4); the fp32 loop (NJ > 0) takes 64-row blocks.
// VAR: the rescaling math; a variant's kernel asks ptxas for
// `VARIANT_MIN_BLOCKS` CTAs an SM, an online one for none (0), as it
// always has.
template <typename T, int NJ, int DK, int DV, int KG, typename Source,
          int VAR = ONLINE>
__global__ void __launch_bounds__(THREADS,
                                  VAR == ONLINE ? 0 : VARIANT_MIN_BLOCKS)
    decode_kernel(DecodeArgs a, Source src) {
  constexpr int ROWS = NJ > 0 ? BM : BM / KG;  // rows per CTA
  const int b = blockIdx.y / a.Hkv;
  const int kvh = blockIdx.y - b * a.Hkv;
  const int split = blockIdx.z;
  const int group = a.H / a.Hkv;
  const long long h0 = (long long)kvh * group;
  const long long st = ((long long)b * a.H + h0) * a.S;  // first stats row
  const Span sp = span_of(src, a, b);
  if (!sp.live) return;
  using Problem = DecodeProblem<T, typename Source::template Rows<T>>;
  Problem pb;
  pb.rows = group * sp.S;
  pb.r0 = blockIdx.x * ROWS;
  if (pb.r0 >= pb.rows) return;
  pb.q = static_cast<const T*>(a.q) + sp.q_off + h0 * a.sqh;
  if (a.splits > 1) {
    // this split's column of the (B, H, S, splits) scratch
    pb.o = nullptr;
    pb.acc = a.part_acc + (st * a.splits + split) * a.dv;
    pb.m_out = a.part_m + st * a.splits + split;
    pb.l_out = a.part_l + st * a.splits + split;
    pb.soh = (long long)a.S * a.splits * a.dv;
    pb.sos = (long long)a.splits * a.dv;
    pb.sstride = a.splits;
  } else {
    pb.o = a.o ? static_cast<T*>(a.o) + sp.o_off + h0 * a.soh : nullptr;
    pb.acc = a.acc ? a.acc + sp.o_off + h0 * a.soh : nullptr;
    pb.m_out = a.m_out ? a.m_out + st : nullptr;
    pb.l_out = a.l_out ? a.l_out + st : nullptr;
    pb.soh = a.soh;
    pb.sos = a.sos;
    pb.sstride = 1;
  }
  pb.sqh = a.sqh;
  pb.sqs = a.sqs;
  pb.S = sp.S;
  pb.Sl = a.S;
  pb.window = a.window;
  pb.sinks = a.sinks;
  pb.kv = src.template rows<T>(b, kvh);
  const int raw = a.lens[b];
  if (raw < 0 && a.poison) {
    // poisoned sequence (a bad append): NaN on every row, loudly; with
    // splits the merge writes them
    if (a.splits > 1) return;
    for (int idx = threadIdx.x; idx < ROWS * a.dv; idx += THREADS) {
      const int r = idx / a.dv;
      T* dst = pb.o_row(r);
      if (dst) dst[idx - r * a.dv] = from_f<T>(NAN);
    }
    return;
  }
  pb.len = max(raw, 0);
  // the block's rows span tokens s_lo..s_hi (all of them once it holds
  // rows of two heads)
  const int r_last = min(pb.r0 + ROWS, pb.rows) - 1;
  const int S = pb.S;
  const bool one_head = pb.r0 / S == r_last / S;
  const int s_lo = one_head ? pb.r0 % S : 0;
  const int s_hi = one_head ? r_last % S : S - 1;
  const int n_end = min(pb.len - S + s_hi + 1, a.n_cap);
  int band = 0;    // the block's lowest band start
  int first = 0;   // the sequence's, down to a key tile: split 0 starts there
  if (a.window > 0) {
    band = max(pb.len - S + s_lo - a.window + 1, 0);
    first = max(pb.len - S - a.window + 1, 0) / MMA_BN * MMA_BN;
  }
  const int lo = first + split * a.chunk;
  // a later split whose columns start among the sinks walks them all, as
  // split 0 walks the sink tiles below its start
  pb.kv_begin = split > 0 && lo < a.sinks ? lo : max(lo, band);
  pb.n_end = split == a.splits - 1 ? n_end : min(lo + a.chunk, n_end);
  pb.sink_end = split == 0 ? a.sinks : 0;
  if (split > 0 && pb.kv_begin >= pb.n_end) {
    // nothing of this split is visible: an empty partial
    for (int r = threadIdx.x; r < ROWS; r += THREADS)
      if (pb.r0 + r < pb.rows) pb.put_stats(r, -INFINITY, 0.f);
    return;
  }
  if constexpr (NJ > 0)
    attend<T, NJ, VAR>(pb, a.dk, a.dv, a.qscale, a.cap2);
  else if constexpr (Problem::Tiles::OWN_LOOP) {
    static_assert(VAR == ONLINE, "the quantized loops run online");
    Problem::Tiles::template attend<DK, KG, DECODE_STAGES<KG>>(pb, a.qscale,
                                                               a.cap2);
  } else
    attend_mma<DK, DV, KG, DECODE_STAGES<KG>, VAR>(pb, a.qscale, a.cap2);
}

constexpr int MERGE_THREADS = 128;

// One CTA per row (b, h, s): the splits' partials merged in split order
// into the normalized output in T (o set) or into the partials of the
// whole row (acc, m_out, l_out).  Each split's weight exp(m_i - max) and
// sum go through shared memory first (2·splits floats), so the sums over
// the splits issue their loads together.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS) merge_splits(DecodeArgs a) {
  extern __shared__ float wl[];  // weights [splits], weighted sums [splits]
  const long long row = blockIdx.x;  // (b·H + h)·S + s
  const int s = row % a.S;
  const long long bh = row / a.S;
  const int h = bh % a.H;
  const int b = bh / a.H;
  const long long out = b * a.sob + h * a.soh + s * a.sos;
  const int n = a.splits;
  T* o = a.o ? static_cast<T*>(a.o) + out : nullptr;
  if (o != nullptr && a.poison && a.lens[b] < 0) {
    for (int c = threadIdx.x; c < a.dv; c += MERGE_THREADS)
      o[c] = from_f<T>(NAN);
    return;
  }
  for (int i = threadIdx.x; i < n; i += MERGE_THREADS) {
    wl[i] = a.part_m[row * n + i];
    wl[n + i] = a.part_l[row * n + i];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, wl[i]);
  __syncthreads();  // every thread has read the maxima
  // a split that saw nothing (max -inf) weighs 0, and its scratch row may
  // never have been written, so it is skipped, not multiplied; its sum
  // still enters the total, where a NaN (a NaN score with no finite one
  // beside it) stays NaN (NaN · 0), so the row comes out NaN
  for (int i = threadIdx.x; i < n; i += MERGE_THREADS) {
    const float w = wl[i] == -INFINITY ? 0.f : expf(wl[i] - mx);
    wl[i] = w;
    wl[n + i] *= w;
  }
  __syncthreads();
  float sum = 0.f;
  for (int i = 0; i < n; ++i) sum += wl[n + i];
  const float* acc = a.part_acc + row * n * a.dv;
  for (int c = threadIdx.x; c < a.dv; c += MERGE_THREADS) {
    float x = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i)
      if (wl[i] != 0.f) x += wl[i] * acc[(long long)i * a.dv + c];
    if (o != nullptr)
      o[c] = from_f<T>(sum == 0.f ? 0.f : x / sum);
    else
      a.acc[out + c] = x;
  }
  if (o == nullptr && threadIdx.x == 0) {
    a.m_out[row] = mx;
    a.l_out[row] = sum;
  }
}

// Dynamic shared memory of decode_kernel<T, NJ, DK, DV, KG, Source> at head
// dims (dk, dv).
template <typename T, int NJ, int DK, int DV, int KG, typename Source>
size_t decode_smem(int dk, int dv) {
  using Tiles = typename tiles_of<typename Source::template Rows<T>>::type;
  if constexpr (NJ > 0)
    return smem_bytes(dk, dv);
  else if constexpr (Tiles::OWN_LOOP)
    return Tiles::template smem_bytes<DK, KG, DECODE_STAGES<KG>>();
  else
    return smem_bytes_mma(dk, dv, KG, DECODE_STAGES<KG>);
}

template <typename T, int NJ, int DK, int DV, int KG, typename Source,
          int VAR = ONLINE>
cudaError_t launch_decode(const DecodeArgs& a, const Source& src, int B,
                          cudaStream_t stream) {
  auto kernel = decode_kernel<T, NJ, DK, DV, KG, Source, VAR>;
  const size_t smem = decode_smem<T, NJ, DK, DV, KG, Source>(a.dk, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = NJ > 0 ? BM : BM / KG;
  const dim3 grid((a.H / a.Hkv * a.S + rows - 1) / rows, B * a.Hkv,
                  a.splits);
  kernel<<<grid, THREADS, smem, stream>>>(a, src);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1 || a.no_merge) return err;
  merge_splits<T><<<(unsigned)((long long)B * a.H * a.S), MERGE_THREADS,
                    2 * a.splits * sizeof(float), stream>>>(a);
  return cudaGetLastError();
}

// The key split of a launch, with its scratch carved out of `part`
// (B·H·S·splits·(dv + 2) floats: the partial outputs, the row maxima, the
// row sums); H, S and dv must be set.
inline void set_splits(DecodeArgs& a, int B, int splits, int chunk,
                       void* part) {
  a.splits = splits;
  a.chunk = chunk;
  if (splits <= 1 || part == nullptr) return;
  const long long rows = (long long)B * a.H * a.S * splits;
  a.part_acc = static_cast<float*>(part);
  a.part_m = a.part_acc + rows * a.dv;
  a.part_l = a.part_m + rows;
}

// What every decode kernel refuses.
inline bool decode_args_ok(const DecodeArgs& a, int B) {
  return a.dk >= 1 && a.dv >= 1 && a.dk <= MAX_HEAD_DIM &&
         a.dv <= MAX_HEAD_DIM && B >= 1 && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         a.S >= 1 && a.window >= 0 && a.sinks >= 0 && a.n_cap >= 0 &&
         a.splits >= 1 && a.splits <= 4096 &&  // the merge's weights fit
         (a.splits == 1 || (a.chunk >= MMA_BN && a.chunk % MMA_BN == 0 &&
                            a.part_acc && a.part_m && a.part_l));
}

// Refuse what the kernels do not take, then pick the loop: fp32 FMA for
// f32 and for bf16 at other head dims, tensor cores for bf16 at head dims
// 64/128 when the caller found the rows 16-byte aligned (mma_ok), with the
// keys split across the four warps where the rows fit one 16-row tile.
// VAR's tensor-core instances: every pair of 64 and 128 for ONLINE, dk ==
// dv for the others.
template <typename Source, int VAR = ONLINE>
cudaError_t dispatch_decode(const DecodeArgs& a, const Source& src, int B,
                            int dtype, bool mma_ok, cudaStream_t s) {
  if (!decode_args_ok(a, B)) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (dtype == 1 && mma_ok && (a.dk == 64 || a.dk == 128) &&
      (a.dv == 64 || a.dv == 128) && (VAR == ONLINE || a.dk == a.dv)) {
    const bool few = a.H / a.Hkv * a.S <= 16;
    if (a.dk == 64 && a.dv == 64)
      return few ? launch_decode<bf16, 0, 64, 64, 4, Source, VAR>(a, src, B, s)
                 : launch_decode<bf16, 0, 64, 64, 1, Source, VAR>(a, src, B,
                                                                  s);
    if constexpr (VAR == ONLINE) {
      if (a.dk == 64)
        return few ? launch_decode<bf16, 0, 64, 128, 4>(a, src, B, s)
                   : launch_decode<bf16, 0, 64, 128, 1>(a, src, B, s);
      if (a.dv == 64)
        return few ? launch_decode<bf16, 0, 128, 64, 4>(a, src, B, s)
                   : launch_decode<bf16, 0, 128, 64, 1>(a, src, B, s);
    }
    return few
               ? launch_decode<bf16, 0, 128, 128, 4, Source, VAR>(a, src, B, s)
               : launch_decode<bf16, 0, 128, 128, 1, Source, VAR>(a, src, B,
                                                                  s);
  }
  if (dtype == 0) {
    if (a.dv <= 32)
      return launch_decode<float, 4, 0, 0, 1, Source, VAR>(a, src, B, s);
    if (a.dv <= 64)
      return launch_decode<float, 8, 0, 0, 1, Source, VAR>(a, src, B, s);
    if (a.dv <= 128)
      return launch_decode<float, 16, 0, 0, 1, Source, VAR>(a, src, B, s);
    return launch_decode<float, 32, 0, 0, 1, Source, VAR>(a, src, B, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (a.dv <= 32)
    return launch_decode<bf16, 4, 0, 0, 1, Source, VAR>(a, src, B, s);
  if (a.dv <= 64)
    return launch_decode<bf16, 8, 0, 0, 1, Source, VAR>(a, src, B, s);
  if (a.dv <= 128)
    return launch_decode<bf16, 16, 0, 0, 1, Source, VAR>(a, src, B, s);
  return launch_decode<bf16, 32, 0, 0, 1, Source, VAR>(a, src, B, s);
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
