// K2: weight-only int8 GEMM, out[M, N] = (x[M, K] @ w8[K, N]) * s[N].
//
// Replaces the TPU kernel whisperlive_tpu/ops/quant_matmul.py int8_matmul
// (_kernel_kn, an MXU product of bf16 x with w8 cast to bf16, f32
// accumulation): every decoder linear at M <= 512 (decode M = B or the
// continuous pool's slots, the verify window M = slots * (k + 1), prefill
// M = B * prompt_pad). x is bf16, w8 int8 in the reference's [K, N] layout,
// s a bf16 [N]; the sums are f32, the scale is applied in f32 and the
// result is cast to bf16.
//
// What bounds it on the card. At decode (M <= 16) the weight bytes: the
// product does 2M FLOP per weight byte, far below the ~295 FLOP/byte where
// the bf16 tensor cores become the limit, and the card must keep enough
// weight loads in flight to stream K*N bytes at 3.35 TB/s. At prefill
// (M = 64-512) the operations come closer, and a CUDA-core FMA per byte per
// row of x cannot keep up. The design:
//
// - Products on the tensor cores: mma.sync.m16n8k16, bf16 in, f32
//   accumulate (int8 values are exact in bf16, so the products are the TPU
//   kernel's). The operands are swapped: the weights are A (16 output
//   channels x 16 k) and x is B (16 k x 8 rows of x), so M <= 8 fills one
//   n8 tile. A CTA holds 64 rows of x as NT = 1, 2, 4 or 8 n8 tiles (the
//   template picks the fewest that cover M), so w8 is streamed once for
//   M <= 64; a larger M tiles the grid in 64-row tiles that re-read w8.
// - int8 -> bf16 in registers: a CTA's weight tile lands in shared memory
//   as int8 in its [K, N] layout. ldmatrix.x4.trans on the tile viewed as
//   b16 pairs of adjacent columns gives each thread two k rows of two
//   adjacent columns; A's row g is column 2g and row g + 8 column 2g + 1,
//   so one register holds both of a thread's A rows, and the epilogue's
//   thread holds two adjacent output columns. The conversion avoids the
//   I2F pipe (16 a clock per SM, near the byte rate): bias to u8, place
//   each byte in the mantissa of the f32 2^23 with one prmt, subtract
//   2^23 + 128, and keep the upper halves with one more prmt (exact: an
//   integer of |w| <= 128 has zero low bits).
// - Bytes in flight on every SM: 64 columns x 64 k of int8 (4 KB) and the
//   matching 64 k of x per stage, copied with cp.async.cg into a ring of 8
//   stages (NT <= 2), 6 (NT = 4) or 4 (NT = 8), 48 KB at most, rows
//   XOR-swizzled so that ldmatrix has no bank conflicts. Where the M and
//   column tiles give fewer than 264 CTAs (2 per SM of the H100's 132), K
//   is split across the CTAs of a thread-block cluster of up to 4: each
//   CTA leaves its partial sums in its shared memory, and after a cluster
//   barrier each CTA sums its share of the tile over the cluster's CTAs in
//   rank order through distributed shared memory, so two calls give the
//   same bits. No workspace, no float atomics, no host synchronisation.
// - Epilogue: scale in f32, round to bf16, store rows < M only.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 16 * kWarps;           // output columns per CTA, 16 per warp
constexpr int kPieces = kBN / 16;          // 16-byte pieces of a weight row
constexpr int kRowsPerLine = 8 / kPieces;  // weight rows per 128 bytes
constexpr int kBK = 64;                    // k rows per stage
constexpr int kMTile = 64;                 // rows of x per CTA
constexpr int kTargetCtas = 264;           // split K below this many CTAs ...
constexpr int kMaxSplits = 4;              // ... over a cluster of at most 4
constexpr int kPartStride = kBN + 4;       // f32 row of a partial tile in shared memory

template <int NT>
struct Smem {
    static constexpr int kW = kBK * kBN;         // int8 [kBK][kBN]
    static constexpr int kX = NT * 8 * kBK * 2;  // bf16 [NT * 8][kBK]
    static constexpr int kStage = kW + kX;
    static constexpr int kStages = NT <= 2 ? 8 : NT == 4 ? 6 : 4;
    static constexpr int kBytes = kStages * kStage;
    static_assert(NT * 8 * kPartStride * 4 <= kBytes, "the partial tile reuses the ring");
};

// Four int8 values as ldmatrix .trans gives them from an int8 [K, N] tile
// read as b16 column pairs: bytes (k, n), (k, n + 1), (k + 1, n), (k + 1,
// n + 1). Returns the bf16x2 (k, k + 1) pairs of column n and column n + 1.
__device__ __forceinline__ void i8x4_to_bf16_kpairs(uint32_t r, uint32_t& col0,
                                                    uint32_t& col1) {
    constexpr uint32_t kTwo23 = 0x4B000000u;  // f32 2^23; a u8 in its mantissa
    constexpr float kBias = 8388736.0f;       // 2^23 + 128
    const uint32_t u = r ^ 0x80808080u;       // int8 + 128 as u8
    const float f0 = __uint_as_float(__byte_perm(u, kTwo23, 0x7650)) - kBias;
    const float f1 = __uint_as_float(__byte_perm(u, kTwo23, 0x7651)) - kBias;
    const float f2 = __uint_as_float(__byte_perm(u, kTwo23, 0x7652)) - kBias;
    const float f3 = __uint_as_float(__byte_perm(u, kTwo23, 0x7653)) - kBias;
    col0 = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
    col1 = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// Grid (N / kBN, M tiles, splits), clusters of (1, 1, splits): a cluster is
// one output tile's slices of K.
template <int NT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w8,
                   const bf16* __restrict__ s, bf16* __restrict__ out, int M, int K, int N,
                   int splits) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = Smem<NT>;
    constexpr int kStages = L::kStages;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kMTile;
    const int chunks = K / kBK, per = (chunks + splits - 1) / splits;
    const int c0 = min(chunks, static_cast<int>(blockIdx.z) * per);
    const int n_chunks = min(chunks, c0 + per) - c0;

    // Stage layout: weight row r (k) holds kPieces pieces of 16 bytes,
    // piece c at c ^ (r / kRowsPerLine % kPieces), so the 8 rows an
    // ldmatrix reads at one piece fall in 8 different bank groups; x row r
    // (a row of x) holds 8 pieces of 8 k, piece c at c ^ (r & 7). Rows of
    // x past M are zero-filled.
    auto load = [&](int chunk, int stage) {
        unsigned char* wt = smem + stage * L::kStage;
        unsigned char* xt = wt + L::kW;
        const int k0 = (c0 + chunk) * kBK;
#pragma unroll
        for (int q = 0; q < kBK * kPieces / kThreads; ++q) {
            const int i = tid + q * kThreads, r = i / kPieces, c = i % kPieces;
            wl::cp_async_16(wt + r * kBN + ((c ^ (r / kRowsPerLine % kPieces)) << 4),
                            w8 + static_cast<long long>(k0 + r) * N + n0 + c * 16, true);
        }
#pragma unroll
        for (int q = 0; q < (NT * 64 + kThreads - 1) / kThreads; ++q) {
            const int i = tid + q * kThreads, r = i >> 3, c = i & 7;
            const bool valid = m0 + r < M;
            if (i < NT * 64)
                wl::cp_async_16(xt + r * (kBK * 2) + ((c ^ (r & 7)) << 4),
                                valid ? x + static_cast<long long>(m0 + r) * K + k0 + c * 8 : x,
                                valid);
        }
    };

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < n_chunks) load(st, st);
        wl::cp_async_commit();
    }
    for (int i = 0; i < n_chunks; ++i) {
        wl::cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk i landed for every thread; stage i - 1 is free
        if (i + kStages - 1 < n_chunks) load(i + kStages - 1, (i + kStages - 1) % kStages);
        wl::cp_async_commit();
        const unsigned char* wt = smem + (i % kStages) * L::kStage;
        const unsigned char* xt = wt + L::kW;
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // k rows 32p .. 32p + 31: two k16 steps
            // matrix q of the x4 is k rows 32p + 8q .. + 7 of this warp's 16
            // columns; lane l addresses k row 32p + l
            const int r = 32 * p + lane;
            uint32_t wr[4], a[2][4];
            wl::ldmatrix_x4_trans(wr, wt + r * kBN + ((warp ^ (r / kRowsPerLine % kPieces)) << 4));
            i8x4_to_bf16_kpairs(wr[0], a[0][0], a[0][1]);
            i8x4_to_bf16_kpairs(wr[1], a[0][2], a[0][3]);
            i8x4_to_bf16_kpairs(wr[2], a[1][0], a[1][1]);
            i8x4_to_bf16_kpairs(wr[3], a[1][2], a[1][3]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                // matrix q: rows 8j .. 8j + 7 of x, k 32p + 8q .. + 7
                const int xr = 8 * j + (lane & 7), xc = 4 * p + (lane >> 3);
                uint32_t b[4];
                wl::ldmatrix_x4(b, xt + xr * (kBK * 2) + ((xc ^ (xr & 7)) << 4));
                wl::mma_bf16_16816(acc[j], a[0], b[0], b[1]);
                wl::mma_bf16_16816(acc[j], a[1], b[2], b[3]);
            }
        }
    }

    // acc[j]: {e = 0, 1} tile column col, tile rows row0 + 8j + e; {2, 3}
    // column col + 1
    const int col = 16 * warp + 2 * (lane >> 2);
    const int row0 = 2 * (lane & 3);
    if (splits == 1) {
        const float s0 = __bfloat162float(s[n0 + col]), s1 = __bfloat162float(s[n0 + col + 1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int row = m0 + row0 + 8 * j + e;
                if (row < M)
                    *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N + n0 + col) =
                        wl::pack_bf16x2(acc[j][e] * s0, acc[j][2 + e] * s1);
            }
        return;
    }

    // Split over K: this slice's partial sums to its shared memory ...
    __syncthreads();  // every warp is done with the ring
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(part + (row0 + 8 * j + e) * kPartStride + col) =
                make_float2(acc[j][e], acc[j][2 + e]);
    wl::cluster_sync();
    // ... and each CTA sums its share of the tile's rows < M, 4 columns a
    // thread, over the cluster's CTAs in rank order
    const int quads = min(kMTile, M - m0) * (kBN / 4);
    const int rank = static_cast<int>(wl::cluster_rank());
    const int last = (rank + 1) * quads / splits;
    for (int i = rank * quads / splits + tid; i < last; i += kThreads) {
        const int r = i / (kBN / 4), c = i % (kBN / 4) * 4;
        const float* p = part + r * kPartStride + c;
        float4 v[kMaxSplits];  // every CTA's read in flight at once
#pragma unroll
        for (int z = 0; z < kMaxSplits; ++z)
            if (z < splits) v[z] = wl::ld_shared_cluster_f4(p, z);
        float4 sum = v[0];
#pragma unroll
        for (int z = 1; z < kMaxSplits; ++z)
            if (z < splits) {
                sum.x += v[z].x;
                sum.y += v[z].y;
                sum.z += v[z].z;
                sum.w += v[z].w;
            }
        const int n = n0 + c;
        *reinterpret_cast<uint2*>(out + static_cast<long long>(m0 + r) * N + n) = make_uint2(
            wl::pack_bf16x2(sum.x * __bfloat162float(s[n]), sum.y * __bfloat162float(s[n + 1])),
            wl::pack_bf16x2(sum.z * __bfloat162float(s[n + 2]),
                            sum.w * __bfloat162float(s[n + 3])));
    }
    wl::cluster_sync();  // no CTA leaves while another still reads its partials
}

// K2's split over K: whole 64-k chunks a slice, enough slices (at most
// kMaxSplits) that the (column tile, M tile, slice) grid reaches
// kTargetCtas, and none empty.
int splits_for(int M, int K, int N) {
    const int tiles = N / kBN * ((M + kMTile - 1) / kMTile), chunks = K / kBK;
    const int want = max(1, min(min(chunks, kMaxSplits), (kTargetCtas + tiles - 1) / tiles));
    const int per = (chunks + want - 1) / want;
    return (chunks + per - 1) / per;
}

template <int NT>
int launch_nt(const void* x, const void* w8, const void* s, void* out, int M, int K, int N,
              int splits, cudaStream_t stream) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(N / kBN, (M + kMTile - 1) / kMTile, splits);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = Smem<NT>::kBytes;
    config.stream = stream;
    cudaLaunchAttribute cluster = {};
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = splits;
    config.attrs = &cluster;
    config.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &config, int8_matmul_kernel<NT>, static_cast<const bf16*>(x),
        static_cast<const int8_t*>(w8), static_cast<const bf16*>(s), static_cast<bf16*>(out), M,
        K, N, splits));
}

// The launch with an explicit split over K (1 <= splits <= kMaxSplits).
int launch(const void* x, const void* w8, const void* s, void* out, int M, int K, int N,
           int splits, cudaStream_t stream) {
    if (M < 1 || K < kBK || K % kBK || N < kBN || N % kBN || splits < 1 || splits > kMaxSplits)
        return static_cast<int>(cudaErrorInvalidValue);
    if (M <= 8) return launch_nt<1>(x, w8, s, out, M, K, N, splits, stream);
    if (M <= 16) return launch_nt<2>(x, w8, s, out, M, K, N, splits, stream);
    if (M <= 32) return launch_nt<4>(x, w8, s, out, M, K, N, splits, stream);
    return launch_nt<8>(x, w8, s, out, M, K, N, splits, stream);
}

}  // namespace

// K and N must be multiples of 64.
extern "C" int wl_int8_matmul(const void* x, const void* w8, const void* s, void* out, int M,
                              int K, int N, void* stream) {
    return launch(x, w8, s, out, M, K, N, splits_for(M, K, N), static_cast<cudaStream_t>(stream));
}
