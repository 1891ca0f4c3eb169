// K1: bidirectional encoder self-attention, flash style, hd = 64.
//
// Replaces the TPU kernel whisperlive_tpu/ops/attention.py fused_attention
// (_attn_kernel): out = softmax(q k^T * hd^-0.5) v over [B, T, H, 64] with
// f32 scores and softmax, probabilities cast to v's dtype (bf16) before the
// PV product, output in q's dtype.
//
// What bounds it on the card: the product, 4*B*H*T^2*64 FLOP (46 GFLOP per
// encoder layer at large-v3, B=4, T=1500), so it must run on the tensor
// cores. The TPU kernel kept K/V of one (batch, head) whole in VMEM and
// materialised a [512, T] score block; here shared memory is far smaller,
// so the design is the flash form instead: one CTA per (b*h, 64-query
// tile), K/V tiles of 64 positions staged through shared memory, bf16 WMMA
// (16x16x16, f32 accumulate) for QK^T and PV, and an online softmax in f32
// that never writes a score to device memory. q/k/v are read in place
// through their [B, T, H, hd] strides (no transposed copies), and the
// ragged last tile (1500 = 23*64 + 28) is masked here, not padded by the
// caller. A simple kernel that is right first: no TMA, no wgmma, no
// double buffering.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kBq = 64;           // queries per CTA
constexpr int kBk = 64;           // key/value positions per tile
constexpr int kWarps = kBq / 16;  // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kLdb = kHd + 8;     // bf16 smem row stride (elements): skews banks
constexpr int kLdf = kBk + 4;     // f32 smem row stride (elements)

struct Smem {
    bf16 q[kBq * kLdb];
    bf16 k[kBk * kLdb];
    bf16 v[kBk * kLdb];
    bf16 p[kBq * kLdb];   // unnormalised probabilities of the current tile
    float s[kBq * kLdf];  // raw scores of the current tile
    float o[kBq * kLdf];  // running output accumulator
};

// rows x 64 bf16 tile from global memory (row stride in elements) into
// shared memory; rows at or beyond `rows_valid` are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int rows_valid) {
    for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
        const int r = i >> 3, c = (i & 7) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows_valid)
            val = __ldg(reinterpret_cast<const uint4*>(src + r * row_stride + c));
        *reinterpret_cast<uint4*>(dst + r * kLdb + c) = val;
    }
}

__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int T, int H,
                       long long qsb, long long qst, long long qsh,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       float scale) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int q0 = blockIdx.y * kBq;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;

    load_tile(sm.q, qb + q0 * qst, qst, min(kBq, T - q0));
    for (int i = threadIdx.x; i < kBq * kLdf; i += kThreads) sm.o[i] = 0.0f;
    __syncthreads();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kHd / 16];
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
        wmma::load_matrix_sync(qa[kk], sm.q + warp * 16 * kLdb + kk * 16, kLdb);

    float* sw = sm.s + warp * 16 * kLdf;
    float* ow = sm.o + warp * 16 * kLdf;
    bf16* pw = sm.p + warp * 16 * kLdb;
    float m_r[16], l_r[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        m_r[r] = -INFINITY;
        l_r[r] = 0.0f;
    }

    for (int k0 = 0; k0 < T; k0 += kBk) {
        const int n_valid = min(kBk, T - k0);
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile(sm.k, kb + k0 * kst, kst, n_valid);
        load_tile(sm.v, vb + k0 * vst, vst, n_valid);
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 tile columns.
#pragma unroll
        for (int n = 0; n < kBk / 16; ++n) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.0f);
#pragma unroll
            for (int kk = 0; kk < kHd / 16; ++kk) {
                // K^T in column-major is K row-major: column j = key n*16+j.
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
                wmma::load_matrix_sync(kf, sm.k + n * 16 * kLdb + kk * 16, kLdb);
                wmma::mma_sync(acc, qa[kk], kf, acc);
            }
            wmma::store_matrix_sync(sw + n * 16, acc, kLdf, wmma::mem_row_major);
        }
        __syncwarp();

        // Online softmax, one row at a time across the warp (2 columns a lane).
        const bool ok0 = lane < n_valid, ok1 = lane + 32 < n_valid;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            const float s0 = ok0 ? sw[r * kLdf + lane] * scale : -INFINITY;
            const float s1 = ok1 ? sw[r * kLdf + lane + 32] * scale : -INFINITY;
            const float m_new = fmaxf(m_r[r], wl::warp_max(fmaxf(s0, s1)));
            const float alpha = expf(m_r[r] - m_new);  // 0 on the first tile
            const float p0 = ok0 ? expf(s0 - m_new) : 0.0f;
            const float p1 = ok1 ? expf(s1 - m_new) : 0.0f;
            pw[r * kLdb + lane] = __float2bfloat16(p0);
            pw[r * kLdb + lane + 32] = __float2bfloat16(p1);
            l_r[r] = l_r[r] * alpha + wl::warp_sum(p0 + p1);
            m_r[r] = m_new;
            ow[r * kLdf + lane] *= alpha;
            ow[r * kLdf + lane + 32] *= alpha;
        }
        __syncwarp();

        // O += P V (P 16 x 64 positions, V 64 positions x 64 channels).
#pragma unroll
        for (int n = 0; n < kHd / 16; ++n) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::load_matrix_sync(acc, ow + n * 16, kLdf, wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < kBk / 16; ++kk) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
                wmma::load_matrix_sync(pf, pw + kk * 16, kLdb);
                wmma::load_matrix_sync(vf, sm.v + kk * 16 * kLdb + n * 16, kLdb);
                wmma::mma_sync(acc, pf, vf, acc);
            }
            wmma::store_matrix_sync(ow + n * 16, acc, kLdf, wmma::mem_row_major);
        }
        __syncwarp();
    }

    // Normalise and write [B, T, H, 64] (contiguous output).
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const int t = q0 + warp * 16 + r;
        if (t < T) {
            const float inv = 1.0f / l_r[r];
            bf16* dst = out + ((static_cast<long long>(b) * T + t) * H + h) * kHd;
            dst[lane] = __float2bfloat16(ow[r * kLdf + lane] * inv);
            dst[lane + 32] = __float2bfloat16(ow[r * kLdf + lane + 32] * inv);
        }
    }
}

}  // namespace

extern "C" int wl_fused_attention(const void* q, const void* k, const void* v, void* out,
                                  int B, int T, int H,
                                  long long qsb, long long qst, long long qsh,
                                  long long ksb, long long kst, long long ksh,
                                  long long vsb, long long vst, long long vsh,
                                  float scale, void* stream) {
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            fused_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(sizeof(Smem)));
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_set = true;
    }
    const dim3 grid(B * H, (T + kBq - 1) / kBq);
    fused_attention_kernel<<<grid, kThreads, sizeof(Smem),
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), T, H,
        qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale);
    return static_cast<int>(cudaGetLastError());
}
