// The f32 forms of decode_attention.cu, in a source of their own so that
// nvcc builds them beside the bf16 forms.
#include "splitkv.cuh"

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* mask, void* o_part, void* m_part,
                         void* l_part, void* out, int B, int W, int Hkv,
                         int G, int D, void* stream) {
  return splitkv::launch_same<float, false>(q, k, v, nullptr, mask, o_part,
                                            m_part, l_part, out, B, W, Hkv,
                                            G, D, 0, 0, stream);
}

int decode_attention_f32_plan(int B, int W, int Hkv, int G, int D,
                              RtLaunch* out, int cap) {
  return splitkv::plan_same<float, false>(B, W, Hkv, G, D, out, cap);
}
