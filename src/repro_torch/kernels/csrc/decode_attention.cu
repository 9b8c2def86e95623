// Split-KV decode attention (flash-decoding) over a contiguous cache.
//
// Replaces: src/repro/kernels/decode_attention.py,
// decode_attention_splitkv (body _decode_kernel, merge in the wrapper):
// one query token per sequence against a contiguous cache, each split of
// the cache reduced into f32 partials (o, m, l), then an LSE-weighted
// merge across splits.
//
// Bound on this card: bytes. Each valid cache row is read once for
// 4 * G * D flops against 4 * D bytes (bf16), i.e. G flops per byte,
// far below the ridge.
//
// Design: the row-parallel split body of splitkv.cuh (split_rows_kernel)
// for a float / bf16 cache: grid (B * Hkv, ceil(W / 128)), one block of
// 128 threads a split of 128 rows (1,152 blocks at B = 4, W = 1024,
// Hkv = 36), D / 8 lanes a bf16 row at G 1, each with one 16-byte load
// of K and of V, all of a thread's loads issued before the first is used
// (K, then V, staged at D 128). Masked rows are never read; a wholly
// masked sequence comes out 0 (splitkv.cuh says why). A second small
// kernel merges the per-split partials, as the reference wrapper does
// (decode_attention.py:88-96), and casts on write.
#include "splitkv.cuh"

extern "C" int rt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   void* o_part, void* m_part, void* l_part,
                                   void* out, int B, int W, int Hkv, int G,
                                   int D, int dtype, void* stream) {
  if (dtype == RT_BF16)
    return splitkv::launch_same<__nv_bfloat16, false>(
        q, k, v, nullptr, mask, o_part, m_part, l_part, out, B, W, Hkv, G,
        D, 0, 0, stream);
  if (dtype == RT_F32)
    return splitkv::launch_same<float, false>(
        q, k, v, nullptr, mask, o_part, m_part, l_part, out, B, W, Hkv, G,
        D, 0, 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
