// The cross-attention kernel of K7 and K8 (cross_attention_int4.cu): q
// [B, H, Tq, 64] (Tq <= 8, K scales folded in) attends one (b, h) row of
// quantised K and V, stored as a Codec describes:
//
//   kRowBytes               bytes from one position to the next in K and V
//   score<kTq>(krow, qf, dot)  dot[j] += q_j . k over the 64 channels
//   load_v(vrow, g, vf)     the 8 V channels of channel group g (0..7)
//   channel(g, c)           the output channel that vf[c] of group g is
//
// Numerics as in K4 (cross_attention_int8.cu): f32 scores and softmax,
// positions >= len[b] count as f32-min, probabilities cast to bf16 before
// the PV sum, f32 output (V scales applied by the caller). With `active`,
// rows whose active[b] is 0 read no K/V and get zeros.
//
// The design: one CTA per (b, h). The score pass reads each K row once and
// scores it against all Tq queries held in shared memory; the Tq score
// rows (Tq * T f32 in dynamic shared memory, 48,000 bytes at Tq = 8 and
// T = 1500, so the launcher raises the CTA's dynamic shared-memory limit)
// are normalised one warp per query; the PV pass reads each V row once and
// accumulates it into all Tq outputs. So each K/V byte is read once per
// window, not once per query. Positions past len[b] have exactly zero
// probability, so both loops stop there; a row with len[b] = 0 masks every
// position, and the reference then gives a uniform softmax over all T: the
// loops run over T for such a row and match it. The int8 windows (K6 and
// K5's window form) are instantiations of K4's source, which splits each
// (b, h) over T across a thread-block cluster; K7 and K8 are not split.
#pragma once

#include "common.cuh"

namespace wl {
namespace window {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <class Codec, int kTq>
__global__ void __launch_bounds__(kThreads)
kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
       const int* __restrict__ lengths, const uint8_t* __restrict__ active,
       float* __restrict__ out, int H, int T, float scale) {
    extern __shared__ float probs[];  // [kTq][T]
    __shared__ float qf[kTq][kHd];
    __shared__ float part[kWarps][kTq][kHd];
    const int tid = threadIdx.x;
    const long long bh = blockIdx.x;
    const int b = blockIdx.x / H;
    float* o = out + bh * kTq * kHd;
    if (active != nullptr && !active[b]) {
        for (int i = tid; i < kTq * kHd; i += kThreads) o[i] = 0.0f;
        return;
    }
    const int8_t* kb = k + bh * T * Codec::kRowBytes;
    const int8_t* vb = v + bh * T * Codec::kRowBytes;
    for (int i = tid; i < kTq * kHd; i += kThreads)
        qf[i / kHd][i % kHd] = __bfloat162float(q[bh * kTq * kHd + i]);
    const int len = lengths == nullptr ? T : lengths[b];
    // positions >= len have probability exactly 0 unless every position is
    // masked (len <= 0): then all T share a uniform softmax
    const int n = len <= 0 ? T : min(len, T);
    __syncthreads();

    // scores: each K row read once, against every query of the window
    for (int t = tid; t < n; t += kThreads) {
        float dot[kTq];
#pragma unroll
        for (int j = 0; j < kTq; ++j) dot[j] = 0.0f;
        if (t < len)
            Codec::template score<kTq>(kb + static_cast<long long>(t) * Codec::kRowBytes, qf, dot);
#pragma unroll
        for (int j = 0; j < kTq; ++j) probs[j * T + t] = t < len ? dot[j] * scale : kNegInf;
    }
    __syncthreads();

    // softmax: one warp per query row, probabilities rounded to bf16
    const int warp = tid >> 5, lane = tid & 31;
    for (int j = warp; j < kTq; j += kWarps) {
        float* row = probs + j * T;
        float mx = -INFINITY;
        for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
        mx = warp_max(mx);
        float sum = 0.0f;
        for (int t = lane; t < n; t += 32) {
            const float e = expf(row[t] - mx);
            row[t] = e;
            sum += e;
        }
        const float total = warp_sum(sum);
        for (int t = lane; t < n; t += 32) row[t] = __bfloat162float(__float2bfloat16(row[t] / total));
    }
    __syncthreads();

    // PV: 32 position lanes x 8 channel groups, each V row read once for
    // all queries
    const int cg = tid & 7, tg = tid >> 3;
    float acc[kTq][8];
#pragma unroll
    for (int j = 0; j < kTq; ++j) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
    }
    for (int t = tg; t < n; t += kThreads / 8) {
        float vf[8];
        Codec::load_v(vb + static_cast<long long>(t) * Codec::kRowBytes, cg, vf);
#pragma unroll
        for (int j = 0; j < kTq; ++j) {
            const float p = probs[j * T + t];
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(p, vf[c], acc[j][c]);
        }
    }
    // lane = (tg % 4) * 8 + cg: reduce over the 4 position lanes of a warp
#pragma unroll
    for (int j = 0; j < kTq; ++j) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            float x = acc[j][c];
            x += __shfl_xor_sync(0xffffffffu, x, 8);
            x += __shfl_xor_sync(0xffffffffu, x, 16);
            acc[j][c] = x;
        }
    }
    if (lane < 8) {
#pragma unroll
        for (int j = 0; j < kTq; ++j) {
#pragma unroll
            for (int c = 0; c < 8; ++c) part[warp][j][Codec::channel(lane, c)] = acc[j][c];
        }
    }
    __syncthreads();
    for (int i = tid; i < kTq * kHd; i += kThreads) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[w][i / kHd][i % kHd];
        o[i] = s;
    }
}

template <class Codec, int kTq>
int launch(const void* q, const void* k, const void* v, const void* lengths, const void* active,
           void* out, int B, int H, int T, float scale, void* stream) {
    const size_t smem = static_cast<size_t>(kTq) * T * sizeof(float);
    auto fn = kernel<Codec, kTq>;
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const int*>(lengths), static_cast<const uint8_t*>(active),
        static_cast<float*>(out), H, T, scale);
    return static_cast<int>(cudaGetLastError());
}

// k and v point at position 0 of row (0, 0); lengths and active may be null
template <class Codec>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             const void* active, void* out, int B, int H, int T, int Tq, float scale,
             void* stream) {
    switch (Tq) {
        case 1: return launch<Codec, 1>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        case 2: return launch<Codec, 2>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        case 3: return launch<Codec, 3>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        case 4: return launch<Codec, 4>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        case 5: return launch<Codec, 5>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        case 6: return launch<Codec, 6>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        case 7: return launch<Codec, 7>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        case 8: return launch<Codec, 8>(q, k, v, lengths, active, out, B, H, T, scale, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace window
}  // namespace wl
