// The dK/dV kernel of the two-kernel flash backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dkv_kernel` (attention_tpu/ops/flash_bwd.py:215,
// launched at :1105).  dK = ln2·dSᵀ·Qs and dV = Pᵀ·dO, summed over each
// GQA group in a fixed order, so they are the same bits every call: 8·h·m·n·d
// operations (halved under causal), bound by the tensor cores.  Two bodies,
// named by the caller (`ops.flash_bwd.flash_bwd_body`) and refused here
// where they do not fit: "wgmma" for bf16 at dk = dv = 64 or 128 with
// 16-byte aligned bases and strides (the fused kernel's body,
// flash_bwd_sm90.cuh, without its dQ: 128-key work items over a deeper ring
// of TMA-fed query tiles, the same work plan and persistent grid), and
// "fma" for everything else (flash_bwd.cuh's `kv_major_fma`: 64 keys a CTA,
// 32 above head dim 128, walking every Q head of its group, fp32 FMA).
#include "flash_bwd_sm90.cuh"

// Plain C entry point, loaded through ctypes.  Pointers and strides as in
// atb::BwdArgs; dtype 0 = fp32, 1 = bf16; softcap2 = softcap·log2 e, <= 0
// for none; kv_valid <= n; window (causal only) the band of a row's last
// `window` key positions, 0 for none, the sinks of a windowed forward left
// to the caller; ls the row stride of lse2 and delta, lse2 +inf
// where the forward saw no key.  body: 0 = "fma", 1 = "wgmma" (the
// caller's `flash_bwd_body`); a body that cannot take the call is refused,
// never replaced.  "fma" (slices 1) writes fp32 dK and dV (B, Hkv, n, d),
// through BwdArgs' float pointers; "wgmma" with `slices` slices of each
// GQA group writes them in bf16 for one slice, else fp32 partials (B, Hkv,
// slices, n, d), through the pointers as given.
// q_seg and kv_seg, both set or both null, are int32 segment ids of the
// query rows (ls of them, the padding -1) and of the key rows (padded to
// whole 128-key blocks with -2), 16-byte aligned: a pair is kept only
// where they are equal.
// Returns cudaGetLastError() after the launch (or the refusal).
extern "C" int flash_bwd_dkv(
    const void* qs, const void* k, const void* v, const void* dout,
    const float* lse2, const float* delta, void* dk, void* dv, int dtype,
    int B, int H, int Hkv, int m, int n, int d, int dvd, int ls,
    long long sqb, long long sqh, long long sqm, long long skb, long long skh,
    long long skn, long long svb, long long svh, long long svn, long long sob,
    long long soh, long long som, float scale, float softcap2, int causal,
    int q_offset, int kv_offset, int kv_valid, int window, int body,
    int slices, const void* q_seg, const void* kv_seg, void* stream) {
  const atb::BwdArgs a{qs,  k,   v,   dout, lse2, delta, nullptr,
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
        !atb::aligned16(dk) || !atb::aligned16(dv) ||
        (H / Hkv) % slices != 0 ||
        (q_seg != nullptr &&
         (!atb::aligned16(q_seg) || !atb::aligned16(kv_seg))))
      return (int)cudaErrorInvalidValue;
    return (int)bwd90::launch<false>(a, B, dk, dv, slices, s);
  }
  if (body != 0 || slices != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)atb::dispatch_fma<atb::DKV, float>(a, B, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)atb::dispatch_fma<atb::DKV, __nv_bfloat16>(a, B, s);
}

// Registers, shared bytes, CTAs an SM, spilled bytes and rows a CTA of
// the "fma" instance a call in dtype (0 fp32, 1 bf16) at head dims (d, dv) runs, as
// atb::fma_resources.
extern "C" int flash_bwd_dkv_fma_resources(int dtype, int d, int dv,
                                           int* out) {
  return atb::fma_resources<atb::DKV>(dtype, d, dv, out);
}
