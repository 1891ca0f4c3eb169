// K4: single-query cross-attention over packed int8 K|V, output f32.
//
// Replaces the TPU kernel whisperlive_tpu/ops/attention.py
// cross_attention_int8 (_cross_attn_int8_kernel): every decode step and the
// language-ID prefill (Tq = 1) attend q [B, H, 64] (per-channel K scales
// already folded in by the caller) over kvp [B, H, T, 128] int8, where each
// 128-byte row holds K in bytes [0, 64) and V in bytes [64, 128). Scores
// and softmax are f32; probabilities are cast to q's dtype (bf16) before
// the PV sum, as the TPU kernel does; the V scales are applied by the
// caller. Optional [B] lengths mask positions >= len[b] with f32-min, so a
// row whose every position is masked gives a uniform softmax, not NaN.
//
// What bounds it on the card: the int8 K|V bytes, read once per step
// (B*H*T*128 bytes: 15 MB per layer at large-v3, B=4); the arithmetic is
// ~1 FLOP per byte. The TPU kernel zero-padded q into the V lanes so one
// 128-lane dot covered K; here threads read the K half and the V half of
// each row directly. One CTA per (b, h): threads stride over T for the
// scores (kept in shared memory), block-wide max and sum, then 64 position
// lanes x 4 channel groups accumulate PV with 16-byte V loads and reduce
// with shuffles and shared memory.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kRow = 2 * kHd;  // bytes of one packed K|V row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
cross_attention_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kvp,
                            const int* __restrict__ lengths, float* __restrict__ out,
                            int H, int T, float scale) {
    extern __shared__ float probs[];  // [T]
    __shared__ float qf[kHd];
    __shared__ float buf[32];
    __shared__ float part[kWarps][kHd];
    const int tid = threadIdx.x;
    const long long bh = blockIdx.x;
    const int8_t* kv = kvp + bh * T * kRow;
    if (tid < kHd) qf[tid] = __bfloat162float(q[bh * kHd + tid]);
    const int len = lengths != nullptr ? lengths[blockIdx.x / H] : T;
    __syncthreads();

    // Scores over the K half of each row.
    float mx = -INFINITY;
    for (int t = tid; t < T; t += kThreads) {
        const uint4* row = reinterpret_cast<const uint4*>(kv + static_cast<long long>(t) * kRow);
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kHd / 16; ++i) {
            float kf[16];
            wl::unpack_i8x16(__ldg(row + i), kf);
#pragma unroll
            for (int c = 0; c < 16; ++c) dot = fmaf(qf[i * 16 + c], kf[c], dot);
        }
        const float sc = t < len ? dot * scale : wl::kNegInf;
        probs[t] = sc;
        mx = fmaxf(mx, sc);
    }
    mx = wl::block_max(mx, buf);
    float sum = 0.0f;
    for (int t = tid; t < T; t += kThreads) {
        const float e = expf(probs[t] - mx);
        probs[t] = e;
        sum += e;
    }
    const float total = wl::block_sum(sum, buf);
    for (int t = tid; t < T; t += kThreads)
        probs[t] = __bfloat162float(__float2bfloat16(probs[t] / total));
    __syncthreads();

    // PV over the V half: 64 position lanes x 4 groups of 16 channels.
    const int cg = tid & 3, tg = tid >> 2;
    float acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
    for (int t = tg; t < T; t += kThreads / 4) {
        float vf[16];
        wl::unpack_i8x16(__ldg(reinterpret_cast<const uint4*>(
                             kv + static_cast<long long>(t) * kRow + kHd) + cg),
                         vf);
        const float p = probs[t];
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[c] = fmaf(p, vf[c], acc[c]);
    }
    // lane = (tg % 8) * 4 + cg: reduce over the 8 position lanes of a warp
#pragma unroll
    for (int c = 0; c < 16; ++c) {
        float v = acc[c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[c] = v;
    }
    const int warp = tid >> 5, lane = tid & 31;
    if (lane < 4) {
#pragma unroll
        for (int c = 0; c < 16; ++c) part[warp][lane * 16 + c] = acc[c];
    }
    __syncthreads();
    if (tid < kHd) {
        float o = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) o += part[w][tid];
        out[bh * kHd + tid] = o;
    }
}

}  // namespace

extern "C" int wl_cross_attention_int8(const void* q, const void* kvp, const void* lengths,
                                       void* out, int B, int H, int T, float scale,
                                       void* stream) {
    const size_t smem = static_cast<size_t>(T) * sizeof(float);
    cross_attention_int8_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const int8_t*>(kvp),
        static_cast<const int*>(lengths), static_cast<float*>(out), H, T, scale);
    return static_cast<int>(cudaGetLastError());
}
