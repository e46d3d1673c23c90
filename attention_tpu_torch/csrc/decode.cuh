// The dense cache of decode.cu and the decode of one max_mode variant
// over it, shared by decode.cu (the C entry point and the online
// instances) and decode_variant.cu (each other variant's instances, a
// build of their own so that they compile in parallel).
#pragma once

#include "decode_rows.cuh"

namespace ddec {

// a dense (B, Hkv, N, d) cache, any element strides with a contiguous last
// dim
struct DenseSource {
  const void* k;
  const void* v;
  long long skb, skh, skn, svb, svh, svn;

  template <typename T>
  struct Rows {
    using Tiles = atk::SpanTiles;
    const T* k;
    const T* v;
    long long skn, svn;
    __device__ const T* k_row(int c) const { return k + c * skn; }
    __device__ const T* v_row(int c) const { return v + c * svn; }
    __device__ atk::TileSpan<T> k_tile(int c) const {
      return {k_row(c), skn, atk::MMA_BN};
    }
    __device__ atk::TileSpan<T> v_tile(int c) const {
      return {v_row(c), svn, atk::MMA_BN};
    }
  };

  template <typename T>
  __device__ Rows<T> rows(int b, int kvh) const {
    return {static_cast<const T*>(k) + b * skb + kvh * skh,
            static_cast<const T*>(v) + b * svb + kvh * svh, skn, svn};
  }
};

// The decode of variant VAR over a dense cache (`atk::dispatch_decode`).
template <int VAR>
cudaError_t run(const atk::DecodeArgs& a, const DenseSource& src, int B,
                int dtype, bool mma_ok, cudaStream_t s) {
  return atk::dispatch_decode<DenseSource, VAR>(a, src, B, dtype, mma_ok, s);
}

}  // namespace ddec
