// The f32 forms of quant_paged_attention.cu, in a source of their own so
// that nvcc builds them beside the bf16 forms.
#include "quant_splitkv.cuh"

int quant_paged_attention_f32(const void* q, const void* k_pages,
                              const void* v_pages, const void* ks,
                              const void* vs, const void* page_table,
                              const void* mask, void* o_part, void* m_part,
                              void* l_part, void* out, int B, int NP, int ps,
                              int Hkv, int G, int D, void* stream) {
  return quant_splitkv::launch<float, true>(
      q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part, l_part,
      out, B, NP * ps, Hkv, G, D, ps, NP, stream);
}

int quant_paged_attention_f32_plan(int B, int NP, int ps, int Hkv, int G,
                                   int D, RtLaunch* out, int cap) {
  return quant_splitkv::plan<float, true>(B, NP * ps, Hkv, G, D, out, cap);
}
