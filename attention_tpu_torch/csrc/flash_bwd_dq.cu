// The dQ kernel of the two-kernel flash backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dq_kernel` (attention_tpu/ops/flash_bwd.py:146,
// launched at :1044).  A CTA owns one (batch, q head, 64-row query block),
// walks the key tiles up to its causal diagonal (the loop that replaces the
// TPU grid's sequential kv axis, skipping the tiles :192-200 skip), keeps
// dQ = scale·dS·K in fp32 registers and writes it once in the input dtype.
// 6·h·m·n·d operations (halved under causal), bound by the tensor cores
// (flash_bwd.cuh has the design and the numerics).
#include "flash_bwd.cuh"

ATB_ENTRY(flash_bwd_dq, atb::DQ)
