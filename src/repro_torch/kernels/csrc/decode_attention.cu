// Split-KV decode attention (flash-decoding) over a contiguous cache.
//
// Replaces: src/repro/kernels/decode_attention.py,
// decode_attention_splitkv (body _decode_kernel, merge in the wrapper):
// one query token per sequence against a contiguous cache, each split of
// the cache reduced into f32 partials (o, m, l), then an LSE-weighted
// merge across splits. The kernels are the shared template of
// splitkv.cuh, instantiated for a contiguous float / bf16 cache.
//
// Bound on this card: bytes. Each valid cache row is read once for
// 4 * G * D flops against 4 * D bytes (bf16), i.e. G flops per byte,
// far below the ridge. Design: grid (B * Hkv, ceil(W / 128)), one
// thread per cache row in a split, so the whole cache is streamed by
// ~B * Hkv * W / 128 blocks in parallel (576 blocks at B = 4, W = 1024,
// Hkv = 36); rows are read with 16-byte vector loads, masked rows are
// not read in the score pass, and a V row is skipped when its weight is
// 0. A second small kernel merges the per-split partials, as the
// reference wrapper does (decode_attention.py:88-96), and casts on write.
#include "splitkv.cuh"

extern "C" int rt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   void* o_part, void* m_part, void* l_part,
                                   void* out, int B, int W, int Hkv, int G,
                                   int D, int dtype, void* stream) {
  if (dtype == RT_BF16)
    return splitkv::launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, nullptr, nullptr, nullptr, mask, o_part, m_part, l_part,
        out, B, W, Hkv, G, D, 0, 0, stream);
  if (dtype == RT_F32)
    return splitkv::launch<float, float, false>(
        q, k, v, nullptr, nullptr, nullptr, mask, o_part, m_part, l_part,
        out, B, W, Hkv, G, D, 0, 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
