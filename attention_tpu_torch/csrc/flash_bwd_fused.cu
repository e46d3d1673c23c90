// Fused single-pass flash backward for Hopper (sm_90a): dQ, dK and dV from
// one sweep.
//
// Replaces the TPU kernel `_fused_bwd_kernel` (attention_tpu/ops/
// flash_bwd.py:304, launched by `_fused_backward`, :176).  S and dP are
// computed once per (query tile, key block): 10·h·m·n·d operations (halved
// under causal), bound by the tensor cores.  Two bodies, named by the
// caller (`ops.flash_bwd.flash_bwd_body`) and refused here where they do
// not fit: "wgmma" for bf16 at dk = dv = 64 or 128 with 16-byte aligned
// bases and strides (flash_bwd_sm90.cuh: all five products on wgmma over
// TMA-fed 128-key blocks, dQ added a tile at a time by TMA reduction, the
// GQA sum in a fixed order, a persistent heaviest-first grid; its note
// says what each does), and "fma" for everything else (flash_bwd.cuh's
// `kv_major_fma`: one Q head and 64 keys a CTA, fp32 FMA, per-Q-head
// partials of dK and dV that the caller sums over the group, dQ by
// atomicAdd).
#include "flash_bwd.cuh"
#include "flash_bwd_sm90.cuh"
#include "tensor_map.cuh"

namespace {

// the wgmma body's tiles come by TMA: bf16, dk = dv = 64 or 128, 16-byte
// aligned bases, (batch, head, row) strides that are positive multiples
// of 8 elements, and the fp32 buffers 16-byte aligned
bool wgmma_ok(const atb::BwdArgs& a, const void* dk, const void* dv) {
  const long long st[12] = {a.sqb, a.sqh, a.sqm, a.skb, a.skh, a.skn,
                            a.svb, a.svh, a.svn, a.sob, a.soh, a.som};
  for (long long x : st)
    if (x <= 0 || x % 8) return false;
  const void* ptrs[9] = {a.qs,    a.k,    a.v,  a.dout, a.lse2,
                         a.delta, a.dq32, dk,   dv};
  for (const void* p : ptrs)
    if (!tmap::aligned16(p)) return false;
  return a.d == a.dvd && (a.d == 64 || a.d == 128) && a.ls % bwd90::QT == 0;
}

template <int D, bool CAP>
cudaError_t launch_wgmma_t(const CUtensorMap (&maps)[5],
                           const bwd90::Args& s, cudaStream_t stream) {
  auto kernel = bwd90::flash_bwd_wgmma<D, CAP>;
  constexpr size_t smem = bwd90::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: at most one CTA an SM, over every work item
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((s.n + bwd90::KB - 1) / bwd90::KB) *
                          s.B * s.Hkv * s.slices;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, bwd90::THREADS, smem, stream>>>(maps[0], maps[1], maps[2],
                                                 maps[3], maps[4], s);
  return cudaGetLastError();
}

// The wgmma body: the tensor maps of Qs, dO, K, V and dq32, then the
// kernel.
cudaError_t launch_wgmma(const atb::BwdArgs& a, int B, void* dk, void* dv,
                         int slices, cudaStream_t st) {
  const tmap::EncodeTiled enc = tmap::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[5];
  if (!tmap::encode(enc, &maps[0], a.qs, a.d, a.m, a.H, B, a.sqm, a.sqh,
                    a.sqb, bwd90::QT) ||
      !tmap::encode(enc, &maps[1], a.dout, a.d, a.m, a.H, B, a.som, a.soh,
                    a.sob, bwd90::QT) ||
      !tmap::encode(enc, &maps[2], a.k, a.d, a.n, a.Hkv, B, a.skn, a.skh,
                    a.skb, bwd90::KB) ||
      !tmap::encode(enc, &maps[3], a.v, a.d, a.n, a.Hkv, B, a.svn, a.svh,
                    a.svb, bwd90::KB) ||
      !tmap::encode_f32(enc, &maps[4], a.dq32, a.d, a.m, B * a.H, bwd90::QT))
    return cudaErrorInvalidValue;
  bwd90::Args s;
  s.lse2 = a.lse2;
  s.delta = a.delta;
  s.dk = dk;
  s.dv = dv;
  s.B = B;
  s.H = a.H;
  s.Hkv = a.Hkv;
  s.m = a.m;
  s.n = a.n;
  s.m_pad = a.ls;
  s.slices = slices;
  s.scale = a.scale;
  s.cap2 = a.cap2;
  s.causal = a.causal;
  s.q_offset = a.q_offset;
  s.kv_offset = a.kv_offset;
  s.kv_valid = a.kv_valid < 0 ? 0 : a.kv_valid > a.n ? a.n : a.kv_valid;
  if (a.d == 64)
    return a.cap2 > 0.f ? launch_wgmma_t<64, true>(maps, s, st)
                        : launch_wgmma_t<64, false>(maps, s, st);
  return a.cap2 > 0.f ? launch_wgmma_t<128, true>(maps, s, st)
                      : launch_wgmma_t<128, false>(maps, s, st);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  Pointers and strides as in
// atb::BwdArgs (the dQ kernel's dq unused); dtype 0 = fp32, 1 = bf16;
// softcap2 = softcap·log2 e, <= 0 for none; kv_valid <= n; ls the row
// stride of lse2 and delta, lse2 +inf where the forward saw no key.  dq32
// is (B, H, m, d) fp32, zeroed by the caller.  body: 0 = "fma", 1 =
// "wgmma" (the caller's `flash_bwd_body`); a body that cannot take the
// call is refused, never replaced.  "fma" writes per-Q-head fp32 partials
// (B, H, n, d) of dK and dV; "wgmma" with `slices` slices of each GQA group
// writes dK and dV (B, Hkv, n, d) in bf16 for one slice, else fp32
// partials (B, Hkv, slices, n, d).  Returns cudaGetLastError() after the
// launch (or the refusal).
extern "C" int flash_bwd_fused(
    const void* qs, const void* k, const void* v, const void* dout,
    const float* lse2, const float* delta, float* dq32, void* dk, void* dv,
    int dtype, int B, int H, int Hkv, int m, int n, int d, int dvd, int ls,
    long long sqb, long long sqh, long long sqm, long long skb, long long skh,
    long long skn, long long svb, long long svh, long long svn, long long sob,
    long long soh, long long som, float scale, float softcap2, int causal,
    int q_offset, int kv_offset, int kv_valid, int body, int slices,
    void* stream) {
  const atb::BwdArgs a{qs,  k,   v,   dout, lse2, delta, dq32,
                       nullptr, static_cast<float*>(dk),
                       static_cast<float*>(dv), H, Hkv, m, n, d, dvd, ls,
                       sqb, sqh, sqm, skb, skh, skn, svb, svh, svn, sob,
                       soh, som, scale, softcap2 > 0.f ? softcap2 : 0.f,
                       causal, q_offset, kv_offset, kv_valid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!atb::args_ok(a, B) || slices < 1) return (int)cudaErrorInvalidValue;
  if (body == 1) {
    if (dtype != 1 || !wgmma_ok(a, dk, dv) || (H / Hkv) % slices != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(a, B, dk, dv, slices, s);
  }
  if (body != 0 || slices != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)atb::dispatch_fma<atb::FUSED, float>(a, B, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)atb::dispatch_fma<atb::FUSED, __nv_bfloat16>(a, B, s);
}
