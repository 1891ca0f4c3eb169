// K5: single-query int8 cross-attention of the continuous decode step, with
// per-slot lengths and an active mask.
//
// Replaces the TPU kernel whisperlive_tpu/ops/attention.py
// _cross_attention_int8_skip (_cross_attn_int8_dma_kernel): the lockstep
// step of the continuous scheduler attends q [B, H, 64] (K scales folded
// in) over the slot pool's packed int8 K|V [B, H, T, 128] (K in bytes
// [0, 64), V in [64, 128)), where T is the content cap (640 at large-v3)
// and slot b holds len[b] valid positions (a window encoded at a reduced
// context leaves a stale tail). Rows whose active[b] is 0 (done lanes
// awaiting harvest, free slots) must read no K/V. Scores and softmax are
// f32, positions >= len[b] count as f32-min, probabilities are cast to
// bf16 before the PV sum and the output is f32 (V scales are applied by
// the caller), all as in K4 (cross_attention_int8.cu).
//
// What bounds it on the card: the K/V bytes of the active rows up to their
// lengths, sum over active b of H * len[b] * 128 bytes (13.1 MB for 8
// active slots of 20 heads at len 640). The design reads exactly those:
// one CTA per (b, h); a CTA whose row is inactive writes zeros and returns
// before touching K/V (the TPU kernel left such rows unwritten; zeros keep
// NaN out of the caller's later arithmetic at no cost); an active CTA's
// position loop stops at len[b], because masked positions have exactly
// zero probability, so the TPU's opt-in length-aware block DMA is simply
// how this kernel works. A row with len[b] = 0 masks every position, and
// the TPU kernel then gives a uniform softmax over all T positions: this
// kernel runs its loops over T for such a row and matches it.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kRow = 2 * kHd;  // bytes of one packed K|V row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
cross_attention_int8_skip_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kvp,
                                 const int* __restrict__ lengths,
                                 const uint8_t* __restrict__ active, float* __restrict__ out,
                                 int H, int T, float scale) {
    extern __shared__ float probs[];  // [T]
    __shared__ float qf[kHd];
    __shared__ float buf[32];
    __shared__ float part[kWarps][kHd];
    const int tid = threadIdx.x;
    const long long bh = blockIdx.x;
    const int b = blockIdx.x / H;
    if (!active[b]) {
        if (tid < kHd) out[bh * kHd + tid] = 0.0f;
        return;
    }
    const int8_t* kv = kvp + bh * T * kRow;
    if (tid < kHd) qf[tid] = __bfloat162float(q[bh * kHd + tid]);
    const int len = lengths[b];
    // positions >= len have probability exactly 0 unless every position is
    // masked (len <= 0): then all T share a uniform softmax
    const int n = len <= 0 ? T : min(len, T);
    __syncthreads();

    float mx = -INFINITY;
    for (int t = tid; t < n; t += kThreads) {
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
    for (int t = tid; t < n; t += kThreads) {
        const float e = expf(probs[t] - mx);
        probs[t] = e;
        sum += e;
    }
    const float total = wl::block_sum(sum, buf);
    for (int t = tid; t < n; t += kThreads)
        probs[t] = __bfloat162float(__float2bfloat16(probs[t] / total));
    __syncthreads();

    // PV over the V half: 64 position lanes x 4 groups of 16 channels.
    const int cg = tid & 3, tg = tid >> 2;
    float acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
    for (int t = tg; t < n; t += kThreads / 4) {
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

extern "C" int wl_cross_attention_int8_skip(const void* q, const void* kvp, const void* lengths,
                                            const void* active, void* out, int B, int H, int T,
                                            float scale, void* stream) {
    const size_t smem = static_cast<size_t>(T) * sizeof(float);
    cross_attention_int8_skip_kernel<<<B * H, kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const int8_t*>(kvp),
        static_cast<const int*>(lengths), static_cast<const uint8_t*>(active),
        static_cast<float*>(out), H, T, scale);
    return static_cast<int>(cudaGetLastError());
}
