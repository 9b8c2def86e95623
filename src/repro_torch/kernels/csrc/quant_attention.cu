// Split-KV decode attention over an int8 KV cache with per-row scales,
// contiguous and paged.
//
// Replaces: src/repro/kernels/quant.py, quant_decode_attention_splitkv
// (body _quant_decode_kernel) and quant_paged_decode_attention_splitkv
// (body _quant_paged_decode_kernel), each with its merge in the wrapper.
// Payloads are int8 (rows, Hkv, D); one bf16 scale per (row, kv head) in
// ks/vs; a row dequantizes as float(q) * scale in f32, as the reference
// kernels do (quant.py:168-169, 261-264).
//
// Bound on this card: bytes. A valid row costs 2 * (D + 2) bytes of K/V
// payload and scales for 4 * G * D flops (about 1 flop per byte at G = 1,
// D = 64): roughly half the bytes of the bf16 kernels for the same work.
//
// Design: the template of splitkv.cuh with the int8 reader. K rows are
// read 8 payload bytes per load and scaled in registers; the scale is
// read once per row. The paged variant adds the page-table lookup of
// paged_attention.cu and dequantizes only the rows its table names: no
// pass over the pool, no dequantized copy in device memory. Both variants
// split the logical rows identically, so a paged and a contiguous int8
// cache holding the same rows give bit-identical outputs.
#include "splitkv.cuh"

extern "C" int rt_quant_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* mask, void* o_part, void* m_part,
    void* l_part, void* out, int B, int W, int Hkv, int G, int D, int dtype,
    void* stream) {
  if (dtype == RT_BF16)
    return splitkv::launch<__nv_bfloat16, int8_t, false>(
        q, k, v, ks, vs, nullptr, mask, o_part, m_part, l_part, out, B, W,
        Hkv, G, D, 0, 0, stream);
  if (dtype == RT_F32)
    return splitkv::launch<float, int8_t, false>(
        q, k, v, ks, vs, nullptr, mask, o_part, m_part, l_part, out, B, W,
        Hkv, G, D, 0, 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_quant_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* ks,
    const void* vs, const void* page_table, const void* mask, void* o_part,
    void* m_part, void* l_part, void* out, int B, int NP, int ps, int Hkv,
    int G, int D, int dtype, void* stream) {
  if (ps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return splitkv::launch<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
        l_part, out, B, NP * ps, Hkv, G, D, ps, NP, stream);
  if (dtype == RT_F32)
    return splitkv::launch<float, int8_t, true>(
        q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
        l_part, out, B, NP * ps, Hkv, G, D, ps, NP, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
