// K4 and K5: single-query cross-attention over packed int8 K|V, output f32,
// each (b, h) split over T across a thread-block cluster.
//
// Replaces two TPU kernels of whisperlive_tpu/ops/attention.py:
// - _cross_attn_int8_kernel (:158), behind cross_attention_int8 (:354):
//   every decode step of the window path and the language-ID prefill
//   (Tq = 1), with optional lengths. Entry: wl_cross_attention_int8.
// - _cross_attn_int8_dma_kernel (:212), behind _cross_attention_int8_skip
//   (:314): the continuous scheduler's lockstep step, with per-slot lengths
//   and an active mask. Entry: wl_cross_attention_int8_skip.
// Both attend q [B, H, 64] (per-channel K scales folded in by the caller)
// over kvp [B, H, T, 128] int8, each 128-byte row holding K in bytes
// [0, 64) and V in [64, 128). Scores and softmax are f32; positions >=
// len[b] count as f32-min, so a row whose every position is masked (len <=
// 0) gives a uniform softmax over all T; the normalised probabilities are
// cast to bf16 (q's dtype) before the PV sum, where the reference rounds
// them; the output is f32 and the V scales are applied by the caller. Rows
// whose active[b] is 0 (done lanes, free slots) read no K/V and are written
// as zeros (the TPU kernel left them unwritten; zeros keep NaN out of the
// caller's later arithmetic).
//
// What bounds it on the card: the K|V bytes of the rows it must read, n x
// 128 bytes a (b, h), where n = min(len[b], T), or T without lengths or
// where len[b] <= 0 (positions >= len have probability exactly 0
// otherwise), at about one FLOP a byte: 15.4 MB per layer at large-v3,
// B = 4, T = 1500, or 4.6 us at 3.35 TB/s. The card needs ~3 MB of loads in
// flight to stream at that rate, while a (b, h) row is 80-192 KB: one CTA a
// row (80 CTAs at B = 4, 20 at B = 1) can neither fill the card nor hide
// the latency of HBM. The design:
//
// - A thread-block cluster of S CTAs per (b, h), S in {1, 2, 4, 8} from B*H
//   and T (splits_for): enough that B*H*S reaches 2 CTAs per SM of the
//   H100's 132 while a chunk keeps >= 64 rows (S = 8 at B = 1, 4 at B = 4,
//   T = 1500; 2 for 8 slots at T = 640). S comes from B*H, inactive rows
//   included: the host cannot read `active` without a sync. Rank r takes
//   rows [r*c, min(n, (r+1)*c)) with c = ceil(n / S), so a short row still
//   spreads over the cluster.
// - One copy wave: each CTA issues every 16-byte cp.async of its chunk, K
//   and V halves together, into shared memory (the 8 pieces of a row
//   XOR-swizzled by the row's index mod 8), then commits once and waits
//   once: one pass over HBM with all of it in flight.
// - Scores: one thread a row, over the whole K half in four independent FMA
//   chains, q as f32 in shared memory (every lane reads the same address);
//   int8 becomes f32 without the I2F pipe (a prmt into the mantissa of
//   2^23, then a subtraction, both exact). A thread keeps its scores (at
//   most kRowsPerThread) in registers; the CTA forms its max m_r, then its
//   sum l_r = sum exp(s - m_r) (an empty chunk: m_r = -inf, l_r = 0).
// - Exchange 1: each CTA stores (m_r, l_r) into every rank's shared memory
//   (distributed shared memory); after a cluster barrier each forms m = max
//   m_r and total = sum l_r exp(m_r - m) in rank order. An empty chunk adds
//   exactly 0 (m is finite, since n >= 1 and masked scores are f32-min).
//   Each thread then writes p_t = bf16(exp(s_t - m) / total) over its
//   scores in shared memory.
// - PV from shared memory, 32 position lanes x 8 groups of 8 channels (the
//   two position lanes of a half-warp on rows 4 apart, so that the swizzle
//   keeps their reads on distinct banks), shuffles and a block sum into a
//   64-float partial. Exchange 2: each CTA stores its partial's channels
//   [64r/S, 64(r+1)/S) into rank r's shared memory; after a second cluster
//   barrier rank r sums them in rank order and writes them. Every remote
//   store precedes a barrier that its target passes before it reads or
//   exits, and a cluster barrier arrived at the start (and waited on before
//   the first remote store) ensures every target has started. No
//   workspace, no atomics, no host synchronisation: two calls give the same
//   bits.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kRow = 2 * kHd;           // bytes of one packed K|V row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPvLanes = kThreads / 8;  // PV position lanes, 8 channels a thread
constexpr int kMaxSplits = 8;           // the portable cluster size
constexpr int kTargetCtas = 264;        // 2 per SM of the H100's 132
constexpr int kMinChunk = 64;           // rows a further split must leave a CTA
constexpr int kMaxChunk = 1536;         // rows a CTA can hold (~200 KB)
constexpr int kRowsPerThread = kMaxChunk / kThreads;  // score rows a thread at most
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory after the chunk's rows and scores.
struct Tail {
    float qf[kHd];                   // q in f32
    float2 stats[kMaxSplits];        // (m_r, l_r) of every rank, stored by each
    float parts[kMaxSplits][kHd];    // PV sums of every rank (this rank's share)
    float warp_part[kWarps][kHd];    // PV sums of each warp
    float red_max[kWarps], red_sum[kWarps];
};

__host__ __device__ inline size_t smem_bytes(int cap) {
    return static_cast<size_t>(cap) * kRow + (static_cast<size_t>(cap) * 4 + 15) / 16 * 16 +
           sizeof(Tail);
}

// Byte offset in shared memory of 16-byte piece p of row r: the pieces of
// a row are XOR-swizzled by r % 8, so that 8 lanes reading the same piece
// of 8 consecutive rows, or any piece of two rows 4 apart, hit distinct
// banks.
__device__ __forceinline__ int piece_at(int r, int p) { return r * kRow + ((p ^ (r & 7)) << 4); }

// Four int8 values (one 32-bit word, byte i the i-th) -> four floats, exact:
// each byte biased to u8 sits in the mantissa of the f32 2^23.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
    constexpr uint32_t kTwo23 = 0x4B000000u;
    constexpr float kBias = 8388736.0f;  // 2^23 + 128
    const uint32_t u = w ^ 0x80808080u;  // int8 + 128 as u8
    f[0] = __uint_as_float(__byte_perm(u, kTwo23, 0x7650)) - kBias;
    f[1] = __uint_as_float(__byte_perm(u, kTwo23, 0x7651)) - kBias;
    f[2] = __uint_as_float(__byte_perm(u, kTwo23, 0x7652)) - kBias;
    f[3] = __uint_as_float(__byte_perm(u, kTwo23, 0x7653)) - kBias;
}

// exp(x - m) for x >= -FLT_MAX and finite m >= x (0 for x = -inf).
__device__ __forceinline__ float exp_minus(float x, float m) {
    return wl::exp2_approx((x - m) * kLog2e);
}

// Max and sum over the CTA, in warp order; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
    v = wl::warp_max(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    return m;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
    v = wl::warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w];
    return s;
}

// Grid (S * B * H), clusters of S CTAs: cluster bh is row (bh / H, bh % H).
__global__ void __launch_bounds__(kThreads)
cross_attention_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kvp,
                            const int* __restrict__ lengths, const uint8_t* __restrict__ active,
                            float* __restrict__ out, int H, int T, int S, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rank = static_cast<int>(wl::cluster_rank());
    const long long bh = blockIdx.x / S;
    const int b = static_cast<int>(bh / H);
    const int share = kHd / S;  // output channels this rank writes
    float* o = out + bh * kHd + rank * share;
    if (active != nullptr && !active[b]) {
        // a cluster is one (b, h): every rank returns here, before any barrier
        if (tid < share) o[tid] = 0.0f;
        return;
    }
    wl::cluster_arrive_relaxed();  // this CTA has started; waited on before any remote store
    const int len = lengths != nullptr ? lengths[b] : T;
    const int n = len <= 0 ? T : min(len, T);
    const int cap = (T + S - 1) / S;  // rows the shared memory holds
    const int c = (n + S - 1) / S;
    const int r0 = min(n, rank * c);
    const int rows = min(n, r0 + c) - r0;  // this CTA's chunk; empty when rank * c >= n
    unsigned char* kv = smem;  // [cap][kRow], pieces swizzled (piece_at)
    float* score = reinterpret_cast<float*>(smem + cap * kRow);
    Tail& tl = *reinterpret_cast<Tail*>(smem + smem_bytes(cap) - sizeof(Tail));

    // The copy wave: one commit, one wait.
    const int8_t* src = kvp + (bh * T + r0) * kRow;
    for (int i = tid; i < rows * 8; i += kThreads)
        wl::cp_async_16(kv + piece_at(i >> 3, i & 7), src + i * 16, true);
    wl::cp_async_commit();
    if (tid < kHd) tl.qf[tid] = __bfloat162float(q[bh * kHd + tid]);
    wl::cp_async_wait<0>();
    __syncthreads();  // the chunk and q landed for every thread

    // Scores: thread t takes rows t, t + kThreads, ..., the whole K half of
    // each, in four independent sums; q is read from shared memory (every
    // lane the same address).
    auto score_of = [&](int j) {
        float d[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const uint4 w = *reinterpret_cast<const uint4*>(kv + piece_at(j, p));
            float kf[16];
            i8x4_to_f32(w.x, kf);
            i8x4_to_f32(w.y, kf + 4);
            i8x4_to_f32(w.z, kf + 8);
            i8x4_to_f32(w.w, kf + 12);
            d[p] = 0.0f;
#pragma unroll
            for (int i = 0; i < 16; i += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(&tl.qf[16 * p + i]);
                d[p] = fmaf(qv.x, kf[i], d[p]);
                d[p] = fmaf(qv.y, kf[i + 1], d[p]);
                d[p] = fmaf(qv.z, kf[i + 2], d[p]);
                d[p] = fmaf(qv.w, kf[i + 3], d[p]);
            }
        }
        const float dot = (d[0] + d[1]) + (d[2] + d[3]);
        return r0 + j < len ? dot * scale : wl::kNegInf;
    };
    float sc[kRowsPerThread];
    float m_t = -INFINITY;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int j = tid + k * kThreads;
        sc[k] = j < rows ? score_of(j) : -INFINITY;
        m_t = fmaxf(m_t, sc[k]);
    }
    const float m_r = block_max(m_t, tl.red_max);
    float l_t = 0.0f;
    if (m_r != -INFINITY) {  // an empty chunk has no score and sums to 0
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) l_t += exp_minus(sc[k], m_r);
    }
    const float l_r = block_sum(l_t, tl.red_sum);

    // Exchange 1: (m_r, l_r) into every rank's slot `rank`; then m = max m_r
    // and total = sum l_r exp(m_r - m) in rank order (an empty chunk's
    // exp(-inf - m) is 0, m being finite).
    wl::cluster_wait();  // every CTA of the cluster has started
    if (tid < S) wl::st_shared_cluster_f2(&tl.stats[rank], tid, float2{m_r, l_r});
    wl::cluster_sync();
    float m = -INFINITY, total = 0.0f;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
        if (z < S) m = fmaxf(m, tl.stats[z].x);
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
        if (z < S) total += tl.stats[z].y * exp_minus(tl.stats[z].x, m);
    const float inv = 1.0f / total;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int j = tid + k * kThreads;
        if (j < rows) score[j] = __bfloat162float(__float2bfloat16(exp_minus(sc[k], m) * inv));
    }
    __syncthreads();

    // PV over the V halves: 32 position lanes x 8 groups of 8 channels. Lane
    // P takes rows 32i + (P & 24) + 4 (P & 1) + (P >> 1 & 3): the two
    // position lanes of a half-warp read rows 4 apart.
    const int cg = tid & 7, pl = tid >> 3;
    const int pr = (pl & 24) | ((pl & 1) << 2) | ((pl >> 1) & 3);
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll 2
    for (int j = pr; j < rows; j += kPvLanes) {
        const float p = score[j];
        const uint2 w = *reinterpret_cast<const uint2*>(kv + piece_at(j, 4 + (cg >> 1)) +
                                                        ((cg & 1) << 3));
        float vf[8];
        i8x4_to_f32(w.x, vf);
        i8x4_to_f32(w.y, vf + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
    // lane = (P % 4) * 8 + cg: sum over the warp's 4 position lanes
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    }
    if (lane < 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) tl.warp_part[warp][lane * 8 + i] = acc[i];
    }
    __syncthreads();

    // Exchange 2: channel ch of this CTA's partial into the slot `rank` of
    // rank ch / share, which sums its share over the ranks in rank order.
    if (tid < kHd) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += tl.warp_part[w][tid];
        wl::st_shared_cluster_f32(&tl.parts[rank][tid], tid / share, s);
    }
    wl::cluster_sync();
    if (tid < share) {
        float s = 0.0f;
#pragma unroll
        for (int z = 0; z < kMaxSplits; ++z)
            if (z < S) s += tl.parts[z][rank * share + tid];
        o[tid] = s;
    }
}

// The split over T: the fewest CTAs a (b, h), doubling while B*H*S is short
// of kTargetCtas and a chunk of T keeps >= kMinChunk rows, then as many as
// a chunk of T needs to fit in shared memory.
int splits_for(int bh, int T) {
    int s = 1;
    while (s < kMaxSplits && bh * s < kTargetCtas && (T + 2 * s - 1) / (2 * s) >= kMinChunk)
        s *= 2;
    while (s < kMaxSplits && (T + s - 1) / s > kMaxChunk) s *= 2;
    return s;
}

// The launch with an explicit split S in {1, 2, 4, 8}; `lengths` and
// `active` may be null.
int launch(const void* q, const void* kvp, const void* lengths, const void* active, void* out,
           int B, int H, int T, float scale, int S, cudaStream_t stream) {
    const int cap = (T + S - 1) / S;
    if (B < 1 || H < 1 || T < 1 || (S != 1 && S != 2 && S != 4 && S != 8) || cap > kMaxChunk)
        return static_cast<int>(cudaErrorInvalidValue);
    // above 48 KB of dynamic shared memory only by opting in, once a process
    static const cudaError_t raised = cudaFuncSetAttribute(
        cross_attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxChunk)));
    if (raised != cudaSuccess) return static_cast<int>(raised);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(S * B * H);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem_bytes(cap);
    config.stream = stream;
    cudaLaunchAttribute cluster = {};
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = S;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    config.attrs = &cluster;
    config.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &config, cross_attention_int8_kernel, static_cast<const bf16*>(q),
        static_cast<const int8_t*>(kvp), static_cast<const int*>(lengths),
        static_cast<const uint8_t*>(active), static_cast<float*>(out), H, T, S, scale));
}

}  // namespace

// K4: `lengths` may be null (every row reads all T positions).
extern "C" int wl_cross_attention_int8(const void* q, const void* kvp, const void* lengths,
                                       void* out, int B, int H, int T, float scale,
                                       void* stream) {
    return launch(q, kvp, lengths, nullptr, out, B, H, T, scale, splits_for(B * H, T),
                  static_cast<cudaStream_t>(stream));
}

// K5: rows whose active[b] is 0 read no K/V and are written as zeros.
extern "C" int wl_cross_attention_int8_skip(const void* q, const void* kvp, const void* lengths,
                                            const void* active, void* out, int B, int H, int T,
                                            float scale, void* stream) {
    return launch(q, kvp, lengths, active, out, B, H, T, scale, splits_for(B * H, T),
                  static_cast<cudaStream_t>(stream));
}
