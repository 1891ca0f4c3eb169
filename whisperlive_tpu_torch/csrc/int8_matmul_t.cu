// K3: int8 GEMM on the [N, K] layout, out[M, N] = (x[M, K] @ w8[N, K]^T) * s[N],
// output f32.
//
// Replaces the TPU kernel whisperlive_tpu/ops/quant_matmul.py int8_matmul_t
// (_kernel_nk, an MXU product of bf16 x with w8 cast to bf16, f32
// accumulation): the tied-embedding logits of every decode step, of the
// prefill's last and <|sot|> positions and of the speculative verify
// window, x [M, d_model] against the int8 token embedding [vocab, d_model]
// (51866 x 1280 at large-v3) with per-row scales. The vocab (51864, 51865
// or 51866) has no multiple-of-128 divisor, which forced the TPU kernel to
// pad N; here the last tile is masked.
//
// What bounds it on the card: the embedding's bytes, 66 MB at large-v3 for
// 2M FLOP a byte at M rows of x (M <= 40 on every path), so the card must
// stream K*N bytes once at 3.35 TB/s whatever M is, and the products, the
// int8 -> bf16 conversion and the sum across warps must keep pace beside
// the stream. The design:
//
// - Products on the tensor cores: mma.sync.m16n8k16, bf16 in, f32
//   accumulate (int8 values are exact in bf16, so every product is the TPU
//   kernel's). The weights are A (16 vocab rows x 16 k) and x is B (16 k x
//   8 rows of x): x's rows are NT = 1, 2, 4 or 5 n8 tiles (the template
//   picks the fewest that cover M), so w8 is streamed once for any M <= 40,
//   the verify window of the 8-slot pool; a larger M is taken 40 rows a
//   launch.
// - A fragments from the [N, K] layout: a plain ldmatrix.x4 of the int8
//   tile viewed as b16 gives each thread bytes 4t .. 4t + 3 of vocab row g
//   (t = lane % 4, g = lane / 4). The mma sums over k, so any order of a
//   step's 16 k, the same in A and B, gives the same products: bytes 4t,
//   4t + 1 are taken as the logical k pair (2t, 2t + 1) and bytes 4t + 2,
//   4t + 3 as (2t + 8, 2t + 9). int8 -> bf16 in registers without the I2F
//   pipe: bias to u8, place each byte in the mantissa of the f32 2^23 with
//   one prmt, subtract 2^23 + 128, keep the upper halves with one more prmt
//   (exact: an integer of |w| <= 128 has zero low bits).
// - x in registers: eight warps share each tile, warp w taking the k16 step
//   pairs w, w + 8, ... (5 at K = 1280), the same in every tile. So a warp
//   loads its B fragments of x once (x row g at k 4t .. 4t + 3 of each of
//   its steps, 20 registers at NT = 1, 100 at NT = 5) and shared memory
//   holds weights and partial sums only: read from shared memory a tile at
//   a time, x would cost M / 8 times the weights' shared-memory traffic.
// - Contiguous reads by the copy engine: a tile is 16 vocab rows, 16 K
//   contiguous bytes of w8 (20 KB at K = 1280), copied into one ring stage
//   by 16 bulk copies (cp.async.bulk, one a row, one a lane of the copying
//   warp) counted in bytes on the stage's mbarrier. Stage rows are K + 16
//   bytes apart, so the 8 rows an ldmatrix reads fall in 8 bank groups.
// - Warp roles: one warp copies, eight multiply, three sum. The copying
//   warp refills a stage once the eight have released it (an "empty"
//   mbarrier); each multiplying warp leaves its [rows][16] partial tile in
//   one of 4 buffers and arrives on its "full" mbarrier; the summing warps
//   add each output's eight partials in warp order (the same bits every
//   call; no workspace, no atomics, no split across CTAs), scale in f32,
//   store, and release the buffer. No CTA-wide barrier waits in the loop,
//   so the copies, the products and the sums of different tiles overlap.
// - Every SM streams the whole call: a persistent grid of one or two CTAs
//   an SM (as the shape's registers and shared memory allow), CTA b walking
//   the tiles b, b + G, b + 2G, ..., with a ring of 2 to 8 tiles running
//   across tile boundaries: the shallowest that keeps kTilesPerSm tiles an
//   SM in flight (deeper rings streamed slower in kernel_variants.py k3).
//   Small tiles keep the tail short: the CTAs that walk one tile more than
//   the others wait on 20 KB.
// - Ragged N: the last tile's rows >= N are not copied; what a stage row
//   holds from before reaches only that row's outputs, which are never
//   stored. A summing thread stores four consecutive floats of one row of
//   out: one 16-byte store where they are 16-byte aligned, else four 4-byte
//   stores. A row of out starts 16-byte aligned only where m N is a multiple
//   of 4: every row at N = 51864, the even rows at 51866, one row in four at
//   51865. Rows >= M are not stored. The scales of every row a CTA walks are
//   read once, at its start, so no global load waits in the loop.
// - The launch plan (grid and ring depth, from the occupancy API) depends
//   only on the card and the shape, so it is made once a process for each
//   and read from a table after that.
#include <array>
#include <map>
#include <mutex>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxK = 1280;               // x's fragments in registers: d_model <= 1280
constexpr int kWarps = 8;                 // warps that multiply ...
constexpr int kCopyWarp = kWarps;         // ... one that copies ...
constexpr int kReduceWarps = 3;           // ... and three that sum the partials
constexpr int kThreads = (kWarps + 1 + kReduceWarps) * 32;
constexpr int kReduceThreads = kReduceWarps * 32;
constexpr int kReduceBarrier = 1;         // named barrier of the summing warps
constexpr int kPairs = (kMaxK / 32 + kWarps - 1) / kWarps;  // k16 step pairs a warp multiplies
constexpr int kRows = 16;                 // vocab rows a tile: one mma A tile
constexpr int kMTile = 40;                // rows of x a launch
constexpr int kRedStride = kRows + 4;     // f32 row (one row of x) of a warp's partial tile
constexpr int kParts = 4;                 // tiles of partial sums in flight
constexpr int kRowPad = 16;               // a stage row is K + 16 bytes: 8 rows, 8 bank groups
constexpr int kMinStages = 2, kMaxStages = 8;
constexpr int kTilesPerSm = 3;            // tiles in flight an SM the plan asks for
constexpr int kBarBytes = 256;            // the mbarriers, 8 bytes each
constexpr int kMaxSmem = 232448;          // the H100's 227 KB a CTA
constexpr int kMaxCtasPerSm = 2;

// Shared memory of a launch over `m` rows of x with a ring of `stages`
// tiles, on a grid whose CTAs walk at most `walk` tiles: the mbarriers, the
// ring, the multiplying warps' partial tiles of kParts tiles (rows of x
// rounded up to whole n8 tiles) and the scales of the walk's rows in f32.
int smem_bytes(int m, int K, int stages, int walk) {
    const int rows = (m + 7) / 8 * 8;
    return kBarBytes + stages * kRows * (K + kRowPad) + kParts * kWarps * rows * kRedStride * 4 +
           walk * kRows * 4;
}

// Four int8 values as a plain ldmatrix gives them from an int8 [N, K] tile
// read as b16: bytes k, k + 1, k + 2, k + 3 of one row. Returns the bf16x2
// pairs (k, k + 1) and (k + 2, k + 3).
__device__ __forceinline__ void i8x4_to_bf16_pairs(uint32_t r, uint32_t& lo, uint32_t& hi) {
    constexpr uint32_t kTwo23 = 0x4B000000u;  // f32 2^23; a u8 in its mantissa
    constexpr float kBias = 8388736.0f;       // 2^23 + 128
    const uint32_t u = r ^ 0x80808080u;       // int8 + 128 as u8
    const float f0 = __uint_as_float(__byte_perm(u, kTwo23, 0x7650)) - kBias;
    const float f1 = __uint_as_float(__byte_perm(u, kTwo23, 0x7651)) - kBias;
    const float f2 = __uint_as_float(__byte_perm(u, kTwo23, 0x7652)) - kBias;
    const float f3 = __uint_as_float(__byte_perm(u, kTwo23, 0x7653)) - kBias;
    lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// A persistent grid of G CTAs (G <= tiles) over M <= kMTile rows of x, with
// a ring of `stages` tiles. Three roles walk the CTA's tiles in step,
// handing over through mbarriers: the copying warp fills the ring, the
// multiplying warps take each tile's products into partial sums, and the
// summing warps add the partials, scale and store.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? kMaxCtasPerSm : 1)
int8_matmul_t_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w8,
                     const bf16* __restrict__ s, float* __restrict__ out, int M, int K, int N,
                     int stages) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nt = (M + 7) / 8, rows = 8 * nt;  // n8 tiles of x in use (<= NT), their rows
    const int cta = blockIdx.x, grid = gridDim.x;
    const int n_tiles = ((N + kRows - 1) / kRows - cta + grid - 1) / grid;  // this CTA's
    const int row_bytes = K + kRowPad, tile_bytes = kRows * row_bytes, pairs = K / 32;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // stage st's tile has landed
    uint64_t* empty = full + kMaxStages;                  // the multiplying warps are done with it
    uint64_t* part_full = empty + kMaxStages;             // partial buffer b is written
    uint64_t* part_empty = part_full + kParts;            // ... and read out
    unsigned char* ring = smem + kBarBytes;
    float* red = reinterpret_cast<float*>(ring + stages * tile_bytes);  // kParts tiles' partials
    float* scales = red + kParts * kWarps * rows * kRedStride;  // [n_tiles][16]
    const int part = kWarps * rows * kRedStride;  // floats of one tile's partials
    if (tid == 0) {
        for (int st = 0; st < stages; ++st) {
            wl::mbar_init(&full[st], 1);
            wl::mbar_init(&empty[st], kWarps);
        }
        for (int b = 0; b < kParts; ++b) {
            wl::mbar_init(&part_full[b], kWarps);
            wl::mbar_init(&part_empty[b], kReduceWarps);
        }
        wl::fence_mbar_init();
    }
    __syncthreads();  // the mbarriers are initialised
    // Tile i of this CTA's walk: vocab rows n0 .. n0 + 15, contiguous in w8.
    // Stage row r holds vocab row n0 + r; rows >= N are neither read nor
    // stored (the products of what a stage row holds from before reach only
    // outputs of that row).
    auto tile_n0 = [&](int i) { return (cta + i * grid) * kRows; };

    if (warp == kCopyWarp) {
        // Tile i into stage i % stages, a row a lane, once the multiplying
        // warps are done with the tile the stage held before.
        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % stages, n0 = tile_n0(i), valid = min(kRows, N - n0);
            if (i >= stages) wl::mbar_wait(&empty[st], (i / stages - 1) & 1);
            if (lane == 0) wl::mbar_arrive_expect_tx(&full[st], valid * K);
            __syncwarp();
            if (lane < valid)
                wl::bulk_copy_g2s(ring + st * tile_bytes + lane * row_bytes,
                                  w8 + static_cast<long long>(n0 + lane) * K, K, &full[st]);
        }
        return;
    }

    if (warp > kCopyWarp) {
        // Tile i's partials are in buffer i % kParts: warp w's [rows][16] tile at
        // w * rows * kRedStride. Each output sums its eight partials in warp
        // order (the same bits every call), scales and stores. The scales of
        // every row the CTA walks are loaded first, so no global load waits
        // in the loop (rows >= N: 0).
        const int rt = tid - (kCopyWarp + 1) * 32;
        for (int q = rt; q < n_tiles * kRows; q += kReduceThreads) {
            const int n = (cta + q / kRows * grid) * kRows + q % kRows;
            scales[q] = n < N ? __bfloat162float(s[n]) : 0.0f;
        }
        wl::named_barrier_sync(kReduceBarrier, kReduceThreads);
        for (int i = 0; i < n_tiles; ++i) {
            const int b = i % kParts, n0 = tile_n0(i);
            wl::mbar_wait(&part_full[b], (i / kParts) & 1);
            const float* p0 = red + b * part;
            // four outputs of one row of x a thread: 16-byte loads
            for (int q = rt; q < M * (kRows / 4); q += kReduceThreads) {
                const int m = q / (kRows / 4), r = q % (kRows / 4) * 4;
                const float* p = p0 + m * kRedStride + r;
                float4 sum = *reinterpret_cast<const float4*>(p);
#pragma unroll
                for (int w = 1; w < kWarps; ++w) {
                    const float4 v = *reinterpret_cast<const float4*>(p + w * rows * kRedStride);
                    sum.x += v.x;
                    sum.y += v.y;
                    sum.z += v.z;
                    sum.w += v.w;
                }
                const float4 sc = *reinterpret_cast<const float4*>(scales + i * kRows + r);
                const float4 v = make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z,
                                             sum.w * sc.w);
                float* o = out + static_cast<long long>(m) * N + n0 + r;
                const int cols = N - n0 - r;
                if (cols >= 4 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
                    wl::st_global_f4(o, v);
                } else {  // a row of out may start only 4-byte aligned
                    if (cols > 0) o[0] = v.x;
                    if (cols > 1) o[1] = v.y;
                    if (cols > 2) o[2] = v.z;
                    if (cols > 3) o[3] = v.w;
                }
            }
            __syncwarp();
            if (lane == 0) wl::mbar_arrive(&part_empty[b]);
        }
        return;
    }

    // A multiplying warp's B fragments, kept for the whole call: pair q is
    // k16 steps 2pr and 2pr + 1 (pr = warp + 8q); xb[q][e][j] is x row 8j + g
    // at k 16 (2pr + e) + 4t .. + 3 (logical k 2t, 2t + 1 and 2t + 8, 2t + 9).
    // Rows >= M are zero.
    uint2 xb[kPairs][2][NT];
#pragma unroll
    for (int q = 0; q < kPairs; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int pr = warp + kWarps * q, xr = 8 * j + g;
                xb[q][e][j] = pr < pairs && xr < M
                                  ? *reinterpret_cast<const uint2*>(
                                        x + static_cast<long long>(xr) * K + 16 * (2 * pr + e) + 4 * t)
                                  : make_uint2(0u, 0u);
            }
    // the tile row this lane addresses in ldmatrix: row l % 8 of matrix
    // l / 8, which covers rows 8 (l / 8 % 2) .. + 7 at piece 2pr + l / 16
    const int lr = (lane & 7) + 8 * (lane >> 3 & 1);
    for (int i = 0; i < n_tiles; ++i) {
        const int st = i % stages, b = i % kParts;
        wl::mbar_wait(&full[st], (i / stages) & 1);  // the stage's (i / stages)-th tile
        const unsigned char* tile = ring + st * tile_bytes;
        float acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
            const int pr = warp + kWarps * q;  // pieces 2pr, 2pr + 1: two k16 steps
            if (pr < pairs) {
                // wr[2e], wr[2e + 1]: rows g and g + 8 at piece 2pr + e
                uint32_t wr[4];
                wl::ldmatrix_x4(wr, tile + lr * row_bytes + ((2 * pr + (lane >> 4)) << 4));
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    uint32_t a[4];  // rows g and g + 8, logical k (2t, 2t + 1) and (2t + 8, 2t + 9)
                    i8x4_to_bf16_pairs(wr[2 * e], a[0], a[2]);
                    i8x4_to_bf16_pairs(wr[2 * e + 1], a[1], a[3]);
#pragma unroll
                    for (int j = 0; j < NT; ++j)
                        wl::mma_bf16_16816(acc[j], a, xb[q][e][j].x, xb[q][e][j].y);
                }
            }
        }
        __syncwarp();
        if (lane == 0) wl::mbar_arrive(&empty[st]);  // this warp is done with the stage
        // acc[j][c]: tile row g + 8 (c / 2) against x row 8j + 2t + c % 2, to
        // this warp's partial tile once the buffer's tile i - kParts is read out
        if (i >= kParts) wl::mbar_wait(&part_empty[b], (i / kParts - 1) & 1);
        float* red_w = red + b * part + warp * rows * kRedStride;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if (j < nt) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    float* o = red_w + (8 * j + 2 * t + c) * kRedStride + g;
                    o[0] = acc[j][c];
                    o[8] = acc[j][2 + c];
                }
            }
        }
        __syncwarp();
        if (lane == 0) wl::mbar_arrive(&part_full[b]);
    }
}

// A launch's grid (persistent CTAs), ring depth and the most tiles a CTA
// walks.
struct Plan {
    int grid, stages, walk;
};

// The plan of a launch over M <= kMTile rows of x, on `ctas` persistent
// CTAs with a ring of `stages` tiles. Where either is 0, the plan's own: the
// most CTAs an SM (at most kMaxCtasPerSm, as registers and shared memory
// allow) on each of the card's SMs, with the shallowest ring that keeps
// kTilesPerSm tiles an SM in flight, or the deepest that keeps that many
// CTAs.
template <int NT>
int make_plan(int M, int K, int N, int ctas, int stages, int dev, Plan& plan) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (N + kRows - 1) / kRows;
    // the most tiles a CTA walks: on a grid of `ctas`, or of one CTA an SM
    // at least
    const int least_grid = ctas ? ctas : sms;
    const int walk = (tiles + least_grid - 1) / least_grid;
    int depth = 0, per_sm = 0;
    for (int r = stages ? stages : kMinStages; r <= (stages ? stages : kMaxStages); ++r) {
        int occupancy = 0;
        if (smem_bytes(M, K, r, walk) > kMaxSmem) break;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occupancy, int8_matmul_t_kernel<NT>, kThreads, smem_bytes(M, K, r, walk));
        if (err != cudaSuccess) return static_cast<int>(err);
        occupancy = min(occupancy, kMaxCtasPerSm);
        if (occupancy > per_sm || (occupancy == per_sm && per_sm * depth < kTilesPerSm))
            depth = r, per_sm = occupancy;
    }
    if (depth == 0) return static_cast<int>(cudaErrorInvalidValue);
    plan = {min(ctas ? ctas : sms * per_sm, tiles), depth, walk};
    return 0;
}

// make_plan's own plan (ctas and stages 0), made once for each device and
// shape and then read from a table. ctypes calls run without the GIL, so
// the table is locked.
template <int NT>
int cached_plan(int M, int K, int N, int dev, Plan& plan) {
    static std::mutex mutex;
    static std::map<std::array<int, 4>, Plan> plans;
    const std::array<int, 4> key = {dev, M, K, N};
    const std::lock_guard<std::mutex> lock(mutex);
    const auto it = plans.find(key);
    if (it != plans.end()) {
        plan = it->second;
        return 0;
    }
    const int rc = make_plan<NT>(M, K, N, 0, 0, dev, plan);
    if (rc == 0) plans.emplace(key, plan);
    return rc;
}

// One launch over M <= kMTile rows of x; `ctas` and `stages` as make_plan's.
template <int NT>
int launch_nt(const bf16* x, const void* w8, const void* s, float* out, int M, int K, int N,
              int ctas, int stages, int dev, cudaStream_t stream) {
    // above 48 KB of dynamic shared memory only by opting in, once a process
    static const cudaError_t raised = cudaFuncSetAttribute(
        int8_matmul_t_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (raised != cudaSuccess) return static_cast<int>(raised);
    Plan plan;
    const int rc = ctas || stages ? make_plan<NT>(M, K, N, ctas, stages, dev, plan)
                                  : cached_plan<NT>(M, K, N, dev, plan);
    if (rc != 0) return rc;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(plan.grid);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem_bytes(M, K, plan.stages, plan.walk);
    config.stream = stream;
    config.numAttrs = 0;
    return static_cast<int>(cudaLaunchKernelEx(&config, int8_matmul_t_kernel<NT>, x,
                                               static_cast<const int8_t*>(w8),
                                               static_cast<const bf16*>(s), out, M, K, N,
                                               plan.stages));
}

// Any M, kMTile rows of x a launch; `ctas` and `stages` as make_plan's.
int launch(const void* x, const void* w8, const void* s, void* out, int M, int K, int N,
           int ctas, int stages, cudaStream_t stream) {
    if (M < 1 || N < 1 || K < 64 || K % 64 || K > kMaxK || ctas < 0 ||
        (stages && (stages < kMinStages || stages > kMaxStages)))
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int m0 = 0; m0 < M; m0 += kMTile) {
        const int m = min(kMTile, M - m0);
        const bf16* xm = static_cast<const bf16*>(x) + static_cast<long long>(m0) * K;
        float* om = static_cast<float*>(out) + static_cast<long long>(m0) * N;
        const int rc =
            m <= 8    ? launch_nt<1>(xm, w8, s, om, m, K, N, ctas, stages, dev, stream)
            : m <= 16 ? launch_nt<2>(xm, w8, s, om, m, K, N, ctas, stages, dev, stream)
            : m <= 32 ? launch_nt<4>(xm, w8, s, om, m, K, N, ctas, stages, dev, stream)
                      : launch_nt<5>(xm, w8, s, om, m, K, N, ctas, stages, dev, stream);
        if (rc != 0) return rc;
    }
    return 0;
}

}  // namespace

// K must be a multiple of 64 (every d_model of Whisper is).
extern "C" int wl_int8_matmul_t(const void* x, const void* w8, const void* s, void* out,
                                int M, int K, int N, void* stream) {
    return launch(x, w8, s, out, M, K, N, 0, 0, static_cast<cudaStream_t>(stream));
}
