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
// says what each does; the dK/dV kernel runs the same body without dQ),
// and "fma" for everything else (flash_bwd.cuh's
// `kv_major_fma`: one Q head and 64 keys a CTA, 32 above head dim 128,
// fp32 FMA, per-Q-head partials of dK and dV that the caller sums over the
// group, dQ by atomicAdd).
#include "flash_bwd_sm90.cuh"

// Plain C entry point, loaded through ctypes.  Pointers and strides as in
// atb::BwdArgs (the dQ kernel's dq unused); dtype 0 = fp32, 1 = bf16;
// softcap2 = softcap·log2 e, <= 0 for none; kv_valid <= n; window (causal
// only) the band of a row's last `window` key positions, 0 for none, the
// sinks of a windowed forward left to the caller; ls the row
// stride of lse2 and delta, lse2 +inf where the forward saw no key.  dq32
// is (B, H, m, d) fp32, zeroed by the caller.  body: 0 = "fma", 1 =
// "wgmma" (the caller's `flash_bwd_body`); a body that cannot take the
// call is refused, never replaced.  "fma" writes per-Q-head fp32 partials
// (B, H, n, d) of dK and dV; "wgmma" with `slices` slices of each GQA group
// writes dK and dV (B, Hkv, n, d) in bf16 for one slice, else fp32
// partials (B, Hkv, slices, n, d).
// q_seg and kv_seg, both set or both null, are int32 segment ids of the
// query rows (ls of them, the padding -1) and of the key rows (padded to
// whole 128-key blocks with -2), 16-byte aligned: a pair is kept only
// where they are equal.
// Returns cudaGetLastError() after the launch (or the refusal).
extern "C" int flash_bwd_fused(
    const void* qs, const void* k, const void* v, const void* dout,
    const float* lse2, const float* delta, float* dq32, void* dk, void* dv,
    int dtype, int B, int H, int Hkv, int m, int n, int d, int dvd, int ls,
    long long sqb, long long sqh, long long sqm, long long skb, long long skh,
    long long skn, long long svb, long long svh, long long svn, long long sob,
    long long soh, long long som, float scale, float softcap2, int causal,
    int q_offset, int kv_offset, int kv_valid, int window, int body,
    int slices, const void* q_seg, const void* kv_seg, void* stream) {
  const atb::BwdArgs a{qs,  k,   v,   dout, lse2, delta, dq32,
                       nullptr, static_cast<float*>(dk),
                       static_cast<float*>(dv), H, Hkv, m, n, d, dvd, ls,
                       sqb, sqh, sqm, skb, skh, skn, svb, svh, svn, sob,
                       soh, som, scale, softcap2 > 0.f ? softcap2 : 0.f,
                       causal, q_offset, kv_offset, kv_valid, window,
                       static_cast<const int*>(q_seg),
                       static_cast<const int*>(kv_seg)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!atb::args_ok(a, B) || slices < 1 ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (body == 1) {
    if (dtype != 1 || !atb::wgmma_operands_ok(a) || a.ls % bwd90::QT != 0 ||
        !atb::aligned16(dq32) || !atb::aligned16(dk) || !atb::aligned16(dv) ||
        (H / Hkv) % slices != 0 ||
        (q_seg != nullptr &&
         (!atb::aligned16(q_seg) || !atb::aligned16(kv_seg))))
      return (int)cudaErrorInvalidValue;
    return (int)bwd90::launch<true>(a, B, dk, dv, slices, s);
  }
  if (body != 0 || slices != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)atb::dispatch_fma<atb::FUSED, float>(a, B, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)atb::dispatch_fma<atb::FUSED, __nv_bfloat16>(a, B, s);
}

// Registers, shared bytes, CTAs an SM, spilled bytes and rows a CTA of
// the "fma" instance a call in dtype (0 fp32, 1 bf16) at head dims (d, dv) runs, as
// atb::fma_resources.
extern "C" int flash_bwd_fused_fma_resources(int dtype, int d, int dv,
                                             int* out) {
  return atb::fma_resources<atb::FUSED>(dtype, d, dv, out);
}
