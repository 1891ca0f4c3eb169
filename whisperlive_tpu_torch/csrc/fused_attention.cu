// K1: bidirectional encoder self-attention, hd = 64.
//
// Replaces the TPU kernel whisperlive_tpu/ops/attention.py fused_attention
// (_attn_kernel): out = softmax(q k^T * hd^-0.5) v over [B, T, H, 64] with
// f32 scores and softmax, probabilities cast to bf16 before the PV
// product, output bf16. q/k/v are read in place through their strides;
// the output is a contiguous [B, T, H, 64].
//
// What bounds it on the card: operations at the window path's T = 1500
// (4*B*H*T^2*64 = 46.1 GFLOP at B=4: 46.6 us at 989 TFLOP/s bf16) and
// bytes at the continuous insert's T = 512 (q, k, v read and out written
// once, 41.9 MB at B=8: 12.5 us at 3.35 TB/s, against 10.9 us of
// operations). So the products must run on the tensor cores with nothing
// else in their way, and K/V should come from L2, not HBM, after the first
// CTA of a (b, h) has read them.
//
// The design is the FlashAttention-2 forward form:
// - One CTA per (128-query tile, b*h), with the query tiles of one (b, h)
//   adjacent in launch order (blockIdx.x), so that their K/V stay in L2.
// - 4 warps, each owning 32 query rows as two m16 tiles: every K or V
//   fragment that ldmatrix brings from shared memory feeds two mma.sync
//   instead of one, which halves the shared-memory reads per product
//   against 8 warps of 16 rows. Measured (k1_variants.py, H100 SXM at
//   700 W): 8 warps of 16 rows take 1.34x as long at T = 1500, 64 queries
//   a CTA 1.06x (but 0.93x at T = 512), 128 keys a tile (which spills)
//   1.06x, and capping the registers for 3 CTAs an SM (which spills) 1.20x.
// - Q is copied once by cp.async and held in registers as mma.sync A
//   fragments (ldmatrix.x4) for the whole key loop.
// - K/V tiles of 64 keys arrive through a ring of kStages stages by
//   cp.async.cg (16 bytes a thread, commit/wait groups); the copy of tile
//   j + kStages - 1 is in flight while tile j is multiplied. Rows are 128
//   bytes with chunk c of row r stored at chunk c ^ (r % 8), so the eight
//   rows that an ldmatrix reads hit all 32 banks once. A third stage
//   measured no faster.
// - S = Q K^T by mma.sync.m16n8k16 (bf16 in, f32 accumulate) with K from
//   ldmatrix; the scores stay in the accumulator registers. Columns past T
//   in the ragged last tile (1500 = 23*64 + 28) are -inf before the row
//   max; their K/V rows were zero-filled by the copy (src-size 0).
// - Online softmax in registers: the row max is taken across the quad of
//   lanes that share a row, 2^x with hd^-0.5 * log2(e) folded into one
//   FMA, the running output rescaled in registers, and each thread's row
//   sums reduced across the quad only once, at the end. 2^x is the SFU's
//   ex2.approx.ftz (wl::exp2_approx): exp2f's own range handling around the
//   same instruction cost 5% at T = 1500.
// - O += P V: two adjacent n8 score tiles packed to bf16x2 are the A
//   fragment of one k16 step (P never touches shared memory); V comes by
//   ldmatrix.trans.
// - Epilogue: divide by the row sum, convert to bf16, stage each warp's
//   rows in the (by then free) Q tile and store 16 bytes a thread; rows
//   at or past T are not stored.
//
// Shared memory: 16 KB of Q + kStages * 16 KB of K/V = 48 KB at two
// stages. nvcc -Xptxas -v (sm_90a, CUDA 12.8): 244 registers, 0 bytes of
// spill, 1 barrier; so registers, not shared memory, hold an SM to 2 CTAs
// (8 warps).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kBq = 128;                // queries per CTA
constexpr int kBk = 64;                 // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBq / kWarps;
constexpr int kMt = kRowsPerWarp / 16;  // m16 tiles per warp
constexpr int kNt = kBk / 8;            // n8 score tiles per K/V tile
constexpr int kDt = kHd / 8;            // n8 output tiles (head dims)
constexpr int kStages = 2;              // depth of the K/V ring
constexpr int kChunks = kHd / 8;        // 16-byte chunks in a 128-byte row
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
    bf16 q[kBq * kHd];  // the output tile in the epilogue
    bf16 k[kStages][kBk * kHd];
    bf16 v[kStages][kBk * kHd];
};

// Element offset of 16-byte chunk c of row r in a swizzled [rows, 64] tile.
__device__ __forceinline__ int swz(int r, int c) {
    return r * kHd + ((c ^ (r & 7)) << 3);
}

// Rows [row0, row0 + kRows) of one (b, h) into a swizzled tile by cp.async;
// rows at or past T are zero-filled and not read.
template <int kRows>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int T) {
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / kChunks, c = idx % kChunks;
        const bool ok = row0 + r < T;
        wl::cp_async_16(dst + swz(r, c), src + (ok ? row0 + r : 0) * row_stride + c * 8, ok);
    }
}

__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int T, int H,
                       long long qsb, long long qst, long long qsh,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       float scale_log2) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int q0 = blockIdx.x * kBq;
    const long long b = blockIdx.y / H;
    const int h = blockIdx.y % H;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_tiles = (T + kBk - 1) / kBk;

    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;

    // Q joins the first K/V tile's copy group; one group per tile after.
    copy_tile<kBq>(sm.q, q + b * qsb + h * qsh, qst, q0, T);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_tiles) {
            copy_tile<kBk>(sm.k[s], kb, kst, s * kBk, T);
            copy_tile<kBk>(sm.v[s], vb, vst, s * kBk, T);
        }
        wl::cp_async_commit();
    }

    uint32_t qf[kMt][kHd / 16][4];    // Q as A fragments [m tile][k16 step]
    float o[kMt][kDt][4] = {};        // output accumulator [m tile][n8 tile]
    float m_run[kMt][2];              // [m tile][row g, g + 8]: running max
    float l_run[kMt][2] = {};         // and this thread's share of the row sum
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) m_run[mt][0] = m_run[mt][1] = -INFINITY;

    for (int j = 0; j < n_tiles; ++j) {
        const int pre = j + kStages - 1;  // refills the stage tile j - 1 used
        if (pre < n_tiles) {
            copy_tile<kBk>(sm.k[pre % kStages], kb, kst, pre * kBk, T);
            copy_tile<kBk>(sm.v[pre % kStages], vb, vst, pre * kBk, T);
        }
        wl::cp_async_commit();
        wl::cp_async_wait<kStages - 1>();  // tile j (and Q) landed
        __syncthreads();

        if (j == 0) {
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
                for (int kk = 0; kk < kHd / 16; ++kk)
                    wl::ldmatrix_x4(qf[mt][kk],
                                    sm.q + swz(warp * kRowsPerWarp + mt * 16 + (lane & 15),
                                               kk * 2 + (lane >> 4)));
        }
        const bf16* ks = sm.k[j % kStages];
        const bf16* vs = sm.v[j % kStages];

        // S = Q K^T. One ldmatrix.x4 gives the B fragments of keys
        // 16np..16np+7 and 16np+8..16np+15 for one k16 step of head dims.
        float s[kMt][kNt][4] = {};
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
#pragma unroll
            for (int kk = 0; kk < kHd / 16; ++kk) {
                uint32_t kf[4];
                wl::ldmatrix_x4(kf, ks + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                             kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
                for (int mt = 0; mt < kMt; ++mt) {
                    wl::mma_bf16_16816(s[mt][2 * np], qf[mt][kk], kf[0], kf[1]);
                    wl::mma_bf16_16816(s[mt][2 * np + 1], qf[mt][kk], kf[2], kf[3]);
                }
            }
        }

        if ((j + 1) * kBk > T) {  // the ragged last tile
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (j * kBk + nt * 8 + 2 * (lane & 3) + (e & 1) >= T) {
#pragma unroll
                        for (int mt = 0; mt < kMt; ++mt) s[mt][nt][e] = -INFINITY;
                    }
                }
            }
        }

        // Online softmax; the scores become unnormalised probabilities in place.
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                float mx = m_run[mt][hr];
#pragma unroll
                for (int nt = 0; nt < kNt; ++nt)
                    mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hr], s[mt][nt][2 * hr + 1]));
                mx = wl::quad_max(mx);  // finite: every tile has a key below T
                // 0 on the first tile, where m_run is -inf
                const float alpha = wl::exp2_approx((m_run[mt][hr] - mx) * scale_log2);
                const float mc = mx * scale_log2;
                float sum = 0.0f;
#pragma unroll
                for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
                    for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
                        s[mt][nt][e] = wl::exp2_approx(fmaf(s[mt][nt][e], scale_log2, -mc));
                        sum += s[mt][nt][e];
                    }
                }
                l_run[mt][hr] = l_run[mt][hr] * alpha + sum;
                m_run[mt][hr] = mx;
#pragma unroll
                for (int dt = 0; dt < kDt; ++dt) {
                    o[mt][dt][2 * hr] *= alpha;
                    o[mt][dt][2 * hr + 1] *= alpha;
                }
            }
        }

        // O += P V. The accumulators of n8 tiles 2kk and 2kk + 1, packed to
        // bf16x2, are the A fragment of k16 step kk; one ldmatrix.x4.trans
        // gives the B fragments of head dims 16dp..16dp+7 and 16dp+8..16dp+15.
#pragma unroll
        for (int kk = 0; kk < kNt / 2; ++kk) {
            uint32_t pf[kMt][4];
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) {
                pf[mt][0] = wl::pack_bf16x2(s[mt][2 * kk][0], s[mt][2 * kk][1]);
                pf[mt][1] = wl::pack_bf16x2(s[mt][2 * kk][2], s[mt][2 * kk][3]);
                pf[mt][2] = wl::pack_bf16x2(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
                pf[mt][3] = wl::pack_bf16x2(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
            }
#pragma unroll
            for (int dp = 0; dp < kDt / 2; ++dp) {
                uint32_t vf[4];
                wl::ldmatrix_x4_trans(vf, vs + swz(kk * 16 + (lane & 15), dp * 2 + (lane >> 4)));
#pragma unroll
                for (int mt = 0; mt < kMt; ++mt) {
                    wl::mma_bf16_16816(o[mt][2 * dp], pf[mt], vf[0], vf[1]);
                    wl::mma_bf16_16816(o[mt][2 * dp + 1], pf[mt], vf[2], vf[3]);
                }
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // Epilogue: each warp stages its own kRowsPerWarp rows of sm.q (read into
    // registers before the first barrier of the loop) as bf16, then
    // stores them 16 bytes a thread.
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const float inv = 1.0f / wl::quad_sum(l_run[mt][hr]);
            const int r = warp * kRowsPerWarp + mt * 16 + hr * 8 + (lane >> 2);
#pragma unroll
            for (int dt = 0; dt < kDt; ++dt)
                *reinterpret_cast<uint32_t*>(sm.q + swz(r, dt) + 2 * (lane & 3)) =
                    wl::pack_bf16x2(o[mt][dt][2 * hr] * inv, o[mt][dt][2 * hr + 1] * inv);
        }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp * kChunks / 32; ++i) {
        const int r = warp * kRowsPerWarp + i * 4 + (lane >> 3), c = lane & 7;
        const int t = q0 + r;
        if (t < T)
            *reinterpret_cast<uint4*>(out + ((b * T + t) * H + h) * kHd + c * 8) =
                *reinterpret_cast<const uint4*>(sm.q + swz(r, c));
    }
}

}  // namespace

extern "C" int wl_fused_attention(const void* q, const void* k, const void* v, void* out,
                                  int B, int T, int H,
                                  long long qsb, long long qst, long long qsh,
                                  long long ksb, long long kst, long long ksh,
                                  long long vsb, long long vst, long long vsh,
                                  float scale, void* stream) {
    if constexpr (sizeof(Smem) > 48 * 1024) {
        static const cudaError_t attr = cudaFuncSetAttribute(
            fused_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(sizeof(Smem)));
        if (attr != cudaSuccess) return static_cast<int>(attr);
    }
    const dim3 grid((T + kBq - 1) / kBq, B * H);
    fused_attention_kernel<<<grid, kThreads, sizeof(Smem),
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), T, H,
        qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
}
