// Fused single-pass flash backward for Hopper (sm_90a): dQ, and dK and dV
// per Q head, from one sweep.
//
// Replaces the TPU kernel `_fused_bwd_kernel` (attention_tpu/ops/
// flash_bwd.py:304, launched by `_fused_backward`, :176).  A CTA owns one
// (batch, q head, 64-row key block), walks the query tiles that can see its
// keys, keeps dK and dV in fp32 registers and writes them as per-Q-head
// partials (the caller sums them over the GQA group, as JAX does at
// flash_bwd.py:613-615); each tile's dQ is added with atomicAdd into an
// fp32 buffer the caller zeroed.  S and dP are computed once per tile:
// 10·h·m·n·d operations, bound by the tensor cores (flash_bwd.cuh has the
// design and the numerics).
#include "flash_bwd.cuh"

ATB_ENTRY(flash_bwd_fused, atb::FUSED)
