// Split-KV decode attention over a contiguous int8 KV cache with per-row
// scales (body, design and bound in quant_splitkv.cuh).
//
// Replaces: src/repro/kernels/quant.py, quant_decode_attention_splitkv
// (body _quant_decode_kernel, merge in the wrapper).
#include "quant_splitkv.cuh"

// The f32 forms (quant_attention_f32.cu): each dtype's kernels build in
// an nvcc process of their own, in parallel.
int quant_attention_f32(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* mask,
                        void* o_part, void* m_part, void* l_part, void* out,
                        int B, int W, int Hkv, int G, int D, void* stream);
int quant_attention_f32_plan(int B, int W, int Hkv, int G, int D,
                             RtLaunch* out, int cap);

extern "C" int rt_quant_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* mask, void* o_part, void* m_part,
    void* l_part, void* out, int B, int W, int Hkv, int G, int D, int dtype,
    void* stream) {
  if (dtype == RT_BF16)
    return quant_splitkv::launch<__nv_bfloat16, false>(
        q, k, v, ks, vs, nullptr, mask, o_part, m_part, l_part, out, B, W,
        Hkv, G, D, 0, 0, stream);
  if (dtype == RT_F32)
    return quant_attention_f32(q, k, v, ks, vs, mask, o_part, m_part,
                               l_part, out, B, W, Hkv, G, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches of rt_quant_decode_attention (split, then merge): the
// count, at most cap of them written to out; a negative CUDA error code
// where the call would refuse.
extern "C" int rt_quant_decode_attention_plan(int B, int W, int Hkv, int G,
                                              int D, int dtype, RtLaunch* out,
                                              int cap) {
  if (dtype == RT_BF16)
    return quant_splitkv::plan<__nv_bfloat16, false>(B, W, Hkv, G, D, out,
                                                     cap);
  if (dtype == RT_F32)
    return quant_attention_f32_plan(B, W, Hkv, G, D, out, cap);
  return -static_cast<int>(cudaErrorInvalidValue);
}
