// K2: weight-only int8 GEMM, out[M, N] = (x[M, K] @ w8[K, N]) * s[N].
//
// Replaces the TPU kernel whisperlive_tpu/ops/quant_matmul.py int8_matmul
// (_kernel_kn): every decoder linear at M <= 512 (decode M = B, prefill
// M = B * prompt_pad, language ID M = B). Accumulation is f32, the
// per-output-channel scale is applied in f32, and the result is cast to
// x's dtype (bf16).
//
// What bounds it on the card: the weight bytes. At decode M = B the
// kernel does 2*M FLOP per weight byte, far below the ~295 FLOP/byte where
// the H100's bf16 tensor cores would become the limit, so the only thing
// that matters is streaming w8 once, as int8. The design: each thread owns
// 16 consecutive output columns (one 16-byte load of a w8 row) and a
// stride of K in chunks of 8; int8 widens to f32 in registers (never a
// bf16 copy of the weights in device memory); partial sums over K are
// reduced with warp shuffles and then across the CTA's 8 warps in shared
// memory. A CTA covers 32 columns so that even N = 1280 gives 40 CTAs per
// 4-row M tile; gridDim.y walks M in tiles of 4 rows, so any M in 1..512
// is right (large M re-reads w8 from L2 once per tile; a tensor-core tile
// loop for the prefill shapes is later work).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kColGroups = 2;                   // 16-column groups per CTA
constexpr int kKLanes = kThreads / kColGroups;  // threads striding over K
constexpr int kRows = 4;                        // rows of x per CTA
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w8,
                   const bf16* __restrict__ s, bf16* __restrict__ out,
                   int M, int K, int N) {
    __shared__ float red[kWarps][kRows][kColGroups * 16];
    const int tid = threadIdx.x;
    const int cg = tid % kColGroups, kg = tid / kColGroups;
    const int n0 = (blockIdx.x * kColGroups + cg) * 16;
    const int m0 = blockIdx.y * kRows;

    float acc[kRows][16];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[m][c] = 0.0f;

    if (n0 < N) {
        for (int k = kg * 8; k < K; k += kKLanes * 8) {
            float xv[kRows][8];
#pragma unroll
            for (int m = 0; m < kRows; ++m) {
                if (m0 + m < M) {
                    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                        x + static_cast<long long>(m0 + m) * K + k));
                    wl::unpack_bf16x8(raw, xv[m]);
                } else {
#pragma unroll
                    for (int j = 0; j < 8; ++j) xv[m][j] = 0.0f;
                }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                    w8 + static_cast<long long>(k + j) * N + n0));
                float wf[16];
                wl::unpack_i8x16(raw, wf);
#pragma unroll
                for (int m = 0; m < kRows; ++m)
#pragma unroll
                    for (int c = 0; c < 16; ++c) acc[m][c] = fmaf(xv[m][j], wf[c], acc[m][c]);
            }
        }
    }

    // Lanes of one warp hold 16 K-lanes of both column groups
    // (lane = (kg % 16) * kColGroups + cg): reduce over the K-lanes.
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
            float v = acc[m][c];
#pragma unroll
            for (int off = kColGroups; off < 32; off <<= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            acc[m][c] = v;
        }
    const int warp = tid >> 5, lane = tid & 31;
    if (lane < kColGroups) {
#pragma unroll
        for (int m = 0; m < kRows; ++m)
#pragma unroll
            for (int c = 0; c < 16; ++c) red[warp][m][lane * 16 + c] = acc[m][c];
    }
    __syncthreads();
    for (int i = tid; i < kRows * kColGroups * 16; i += kThreads) {
        const int m = i / (kColGroups * 16), col = i % (kColGroups * 16);
        const int n = blockIdx.x * kColGroups * 16 + col;
        if (m0 + m < M && n < N) {
            float sum = 0.0f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) sum += red[w][m][col];
            out[static_cast<long long>(m0 + m) * N + n] =
                __float2bfloat16(sum * __bfloat162float(s[n]));
        }
    }
}

}  // namespace

extern "C" int wl_int8_matmul(const void* x, const void* w8, const void* s, void* out,
                              int M, int K, int N, void* stream) {
    const dim3 grid((N + kColGroups * 16 - 1) / (kColGroups * 16), (M + kRows - 1) / kRows);
    int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(w8),
        static_cast<const bf16*>(s), static_cast<bf16*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
}
