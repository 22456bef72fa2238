// The logsumexp the flash forward kernels write for the backward
// (flash_attn_bwd.cu), included by flash_attn_fwd_wgmma.cu and
// flash_attn_fwd_tf32.cu.
//
// Both kernels run the softmax in base 2, on x = scale * log2(e) * (q . k)
// with ex2.approx, so a row's running max m and sum l are those of x; the
// natural-log logsumexp of scale * (q . k), which the reference's backward
// takes (repro/models/layers.py::_attention_fwd_scan: m + log(max(l,
// 1e-30)) of the natural-log scan), is (m + log2(max(l, 1e-30))) * ln 2.
// lse is (B, H, S) f32, the reference's (B, Hk, G, S) with h = kh * G + g.

#pragma once

namespace flash_lse {

constexpr float kLn2 = 0.6931471805599453f;

// rows a and a + 8 of one (batch, head) whose rows start at lse + head0; the
// first thread of each quad writes them (every thread of the quad holds the
// same m and, after the quad's reduction, the same l); lse null: nothing
__device__ __forceinline__ void store_rows(float* __restrict__ lse,
                                           long long head0, int row_a,
                                           int s_len, int quad, float m_a,
                                           float l_a, float m_b, float l_b) {
  if (lse == nullptr || quad != 0) return;
  if (row_a < s_len)
    lse[head0 + row_a] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * kLn2;
  if (row_a + 8 < s_len)
    lse[head0 + row_a + 8] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * kLn2;
}

}  // namespace flash_lse
