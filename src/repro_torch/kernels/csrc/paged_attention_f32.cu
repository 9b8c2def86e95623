// The f32 forms of paged_attention.cu, in a source of their own so that
// nvcc builds them beside the bf16 forms.
#include "splitkv.cuh"

int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* page_table,
                        const void* mask, void* o_part, void* m_part,
                        void* l_part, void* out, int B, int NP, int ps,
                        int Hkv, int G, int D, void* stream) {
  return splitkv::launch_same<float, true>(
      q, k_pages, v_pages, page_table, mask, o_part, m_part, l_part, out, B,
      NP * ps, Hkv, G, D, ps, NP, stream);
}

int paged_attention_f32_plan(int B, int NP, int ps, int Hkv, int G, int D,
                             RtLaunch* out, int cap) {
  return splitkv::plan_same<float, true>(B, NP * ps, Hkv, G, D, out, cap);
}
