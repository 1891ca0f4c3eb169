// K3: int8 GEMM on the [N, K] layout, out[M, N] = (x[M, K] @ w8[N, K]^T) * s[N],
// output f32.
//
// Replaces the TPU kernel whisperlive_tpu/ops/quant_matmul.py int8_matmul_t
// (_kernel_nk): the tied-embedding logits of every decode step and of the
// prefill's last and <|sot|> positions, x [B, 1280] against the int8 token
// embedding [51866, 1280] with per-row scales. N = 51866 has no
// multiple-of-128 divisor, which forced the TPU kernel to pad N; here the
// last row is simply bounds-checked.
//
// What bounds it on the card: the 66 MB of embedding bytes per call (2*M
// FLOP per byte at M = B). The design streams each vocab row once: one warp
// per row, 32 lanes x 16-byte loads coalesced along K, int8 widened to f32
// in registers, f32 dot products reduced with shuffles, the row's scale
// applied in f32. M is walked in tiles of 4 rows inside the warp, so any M
// is right (a row is re-read from L1/L2 once per extra tile).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 4;

__global__ void __launch_bounds__(kThreads)
int8_matmul_t_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w8,
                     const bf16* __restrict__ s, float* __restrict__ out,
                     int M, int K, int N) {
    const int lane = threadIdx.x & 31;
    const long long n = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
    if (n >= N) return;  // warp-uniform: the whole warp leaves together
    const int8_t* wr = w8 + n * K;
    const float sn = __bfloat162float(s[n]);
    for (int m0 = 0; m0 < M; m0 += kRows) {
        float acc[kRows];
#pragma unroll
        for (int m = 0; m < kRows; ++m) acc[m] = 0.0f;
        for (int k = lane * 16; k < K; k += 32 * 16) {
            float wf[16];
            wl::unpack_i8x16(__ldg(reinterpret_cast<const uint4*>(wr + k)), wf);
#pragma unroll
            for (int m = 0; m < kRows; ++m) {
                if (m0 + m < M) {
                    const uint4* xr = reinterpret_cast<const uint4*>(
                        x + static_cast<long long>(m0 + m) * K + k);
                    float xa[8], xb[8];
                    wl::unpack_bf16x8(__ldg(xr), xa);
                    wl::unpack_bf16x8(__ldg(xr + 1), xb);
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        acc[m] = fmaf(xa[j], wf[j], acc[m]);
                        acc[m] = fmaf(xb[j], wf[8 + j], acc[m]);
                    }
                }
            }
        }
#pragma unroll
        for (int m = 0; m < kRows; ++m) acc[m] = wl::warp_sum(acc[m]);
        if (lane == 0) {
#pragma unroll
            for (int m = 0; m < kRows; ++m)
                if (m0 + m < M) out[static_cast<long long>(m0 + m) * N + n] = acc[m] * sn;
        }
    }
}

}  // namespace

extern "C" int wl_int8_matmul_t(const void* x, const void* w8, const void* s, void* out,
                                int M, int K, int N, void* stream) {
    const int warps_per_cta = kThreads / 32;
    const dim3 grid((N + warps_per_cta - 1) / warps_per_cta);
    int8_matmul_t_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(w8),
        static_cast<const bf16*>(s), static_cast<float*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
}
