// The dK/dV kernel of the two-kernel flash backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dkv_kernel` (attention_tpu/ops/flash_bwd.py:215,
// launched at :1105).  A CTA owns one (batch, kv head, 64-row key block) and
// walks the query tiles of every Q head of that KV head's GQA group (the TPU
// grid orders its q-head axis the same way), so dK = ln2·dSᵀ·Qs and
// dV = Pᵀ·dO are summed over the group in fp32 registers and written once.
// 8·h·m·n·d operations (halved under causal), bound by the tensor cores
// (flash_bwd.cuh has the design and the numerics).
#include "flash_bwd.cuh"

ATB_ENTRY(flash_bwd_dkv, atb::DKV)
