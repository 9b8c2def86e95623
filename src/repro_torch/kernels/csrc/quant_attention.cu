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
// Design: the row-parallel split body of splitkv.cuh (split_rows), for an
// int8 cache: C = 16 columns a lane at G 1 (one 16-byte load per row and
// tensor), 8 at G 2 and 4 at G > 2; the K and V payloads of every pass
// are in flight together; thread t applies row t's K scale to its score,
// then 1/sqrt(D), and keeps p * vs for the P.V pass, which sums
// (p * vs) * v. splitkv.cuh's merge_kernel combines the splits.
#include "splitkv.cuh"

namespace {
namespace quant_splitkv {

template <typename T, int D, int NG, bool PAGED>
__global__ void __launch_bounds__(splitkv::BK)
quant_split_kernel(const T* __restrict__ q,
                   const splitkv::Rows<int8_t, PAGED> cache,
                   const uint8_t* __restrict__ mask,
                   float* __restrict__ o_part, float* __restrict__ m_part,
                   float* __restrict__ l_part, int G, int GB,
                   float sm_scale) {
  splitkv::split_rows<T, int8_t, D, NG, PAGED>(q, cache, mask, o_part,
                                               m_part, l_part, G, GB,
                                               sm_scale);
}

// Split + merge for q/out of type T over an int8 cache. For a contiguous
// cache W is its length and ps, NP are unused; for a paged one W = NP * ps
// logical rows.
template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* mask, void* o_part,
           void* m_part, void* l_part, void* out, int B, int W, int Hkv,
           int G, int D, int ps, int NP, void* stream) {
  auto pick = [](auto d, auto g) {
    return &quant_split_kernel<T, decltype(d)::value, decltype(g)::value,
                               PAGED>;
  };
  return splitkv::launch<T, int8_t, PAGED>(
      pick, q, k, v, ks, vs, pt, mask, o_part, m_part, l_part, out, B, W,
      Hkv, G, D, ps, NP, stream);
}

}  // namespace quant_splitkv
}  // namespace

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
    return quant_splitkv::launch<float, false>(
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
    return quant_splitkv::launch<__nv_bfloat16, true>(
        q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
        l_part, out, B, NP * ps, Hkv, G, D, ps, NP, stream);
  if (dtype == RT_F32)
    return quant_splitkv::launch<float, true>(
        q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
        l_part, out, B, NP * ps, Hkv, G, D, ps, NP, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
