// K4-K8: cross-attention of Tq <= 8 queries over int8 or int4 K and V,
// output f32, each (b, h) split over T across a thread-block cluster.
//
// Replaces six TPU kernels of whisperlive_tpu/ops/attention.py:
// - _cross_attn_int8_kernel (:158), behind cross_attention_int8 (:354):
//   every decode step of the window path and the language-ID prefill
//   (Tq = 1), with optional lengths. Entry: wl_cross_attention_int8 (K4).
// - _cross_attn_int8_dma_kernel (:212), behind _cross_attention_int8_skip
//   (:314): the continuous scheduler's lockstep step, with per-slot lengths
//   and an active mask. Entry: wl_cross_attention_int8_skip (K5).
// - _cross_attn_int8_window_kernel (:409), behind
//   cross_attention_int8_window (:443): the window route's speculative
//   verify, a window of Tq <= 8 queries with optional lengths. Entry:
//   wl_cross_attention_int8_window (K6).
// - the window form of _cross_attention_int8_skip (a 4-D q, :294-311): the
//   continuous pool's verify, with lengths and an active mask. Entry:
//   wl_cross_attention_int8_skip_window (K5's window form).
// - _cross_attn_int4_kernel (:53), behind cross_attention_int4 (:110):
//   every decode step of an int4 cross-KV engine (Tq = 1), with optional
//   lengths. Entry: wl_cross_attention_int4 (K7).
// - _cross_attn_int4_window_kernel (:490), behind
//   cross_attention_int4_window (:540): K7 for a window of Tq <= 8 queries,
//   the int4 speculative verify. Entry: wl_cross_attention_int4_window (K8).
// All attend q [B, H, Tq, 64] ([B, H, 64] at Tq = 1; per-channel K scales
// folded in by the caller) over one of two row layouts, each a codec below:
// Int8Packed, kvp [B, H, T, 128] int8, each 128-byte row holding K in bytes
// [0, 64) and V in [64, 128); Int4Halves, k4 and v4 [B, H, T, 32] int8 of
// two signed nibbles each, byte c holding channel c in its low nibble and
// channel 32 + c in its high nibble, each nibble n worth (n ^ 8) - 8 (the
// TPU kernel's floor-divide form). Scores and softmax are f32; positions
// >= len[b] count as f32-min, so a row whose every position is masked
// (len <= 0) gives every query a uniform softmax over all T; the
// normalised probabilities are cast to bf16 (q's dtype) before the PV sum,
// where the reference rounds them; the output is f32 and the V scales are
// applied by the caller. Rows whose active[b] is 0 (done lanes, free
// slots; K5 and its window form only) read no K/V and are written as zeros
// (the TPU kernels left them unwritten; zeros keep NaN out of the caller's
// later arithmetic). The int4 entries take no active mask and compute
// every row, as the reference does.
//
// What bounds it on the card: the K and V bytes of the rows it must read,
// n x 128 bytes a (b, h) at int8 and n x 64 at int4, where n = min(len[b],
// T), or T without lengths or where len[b] <= 0 (positions >= len have
// probability exactly 0 otherwise), read once a window and not once a
// query, which is the point of the TPU's window kernels; about Tq FLOP a
// byte (2 Tq at int4) beside them. 15.4 MB per layer at large-v3, B = 4,
// T = 1500 (K4), or 4.6 us at 3.35 TB/s; 7.7 MB at int4 (K7), 2.3 us;
// 3.84 MB for the window route's one request of 20 heads (K6), 1.15 us.
// The card needs ~3 MB of loads in flight to stream at that rate, while a
// (b, h) row is 40-192 KB: one CTA a row (80 CTAs at B = 4, 20 at B = 1)
// can neither fill the card nor hide the latency of HBM. The design, one
// instantiation of the kernel for each codec and Tq (kTq = 1 serves K4, K5
// and K7):
//
// - A thread-block cluster of S CTAs per (b, h), S in {1, 2, 4, 8} from B*H
//   and T (splits_for): enough that B*H*S reaches 2 CTAs per SM of the
//   H100's 132 while a chunk keeps >= 64 rows (S = 8 at B = 1, 4 at B = 4,
//   T = 1500; 2 for 8 slots at T = 640). S comes from B*H, inactive rows
//   included: the host cannot read `active` without a sync. Rank r takes
//   rows [r*c, min(n, (r+1)*c)) with c = ceil(n / S), so a short row still
//   spreads over the cluster.
// - One copy wave: each CTA issues every 16-byte cp.async of its chunk, K
//   and V together (from kvp, or from k4 and v4), into shared memory (the
//   pieces of a row XOR-swizzled by the row's index, piece_at), then
//   commits once and waits once: one pass over HBM with all of it in
//   flight.
// - Scores: one thread a row, the row's K read once from HBM (from shared
//   memory twice at Tq = 7 and 8, half the queries each time, to stay
//   within the registers) and scored against every query of the window,
//   in four independent FMA chains a query at Tq = 1 (two at Tq = 2, one
//   above), q as f32 in shared memory (every lane reads the same address);
//   int8 and int4 become f32 without the I2F pipe (each code, biased to
//   unsigned, goes by a prmt into the mantissa of 2^23, then a
//   subtraction, both exact). At Tq = 1 a thread keeps its scores (at most
//   kRowsPerThread) in registers and the CTA forms the max m_r, then the
//   sum l_r = sum exp(s - m_r); a window writes its Tq score rows to shared
//   memory and warp t forms query t's (m_r, l_r) over row t, so that no
//   thread holds Tq x rows scores or computes another query's exponentials
//   (an empty chunk: m_r = -inf, l_r = 0 for every query).
// - Exchange 1: each CTA stores its kTq pairs (m_r, l_r) into every rank's
//   shared memory (distributed shared memory); after a cluster barrier,
//   m = max m_r and total = sum l_r exp(m_r - m) over the ranks, in rank
//   order at Tq = 1 (every thread) and by warp t's lanes in a fixed
//   butterfly for query t of a window. An empty chunk adds exactly 0 (m is
//   finite, since n >= 1 and masked scores are f32-min). Then p_t =
//   bf16(exp(s_t - m) / total) goes into the query's score row in shared
//   memory.
// - PV from shared memory, 32 position lanes x 8 groups of 8 channels (the
//   two position lanes of a half-warp on rows 4 apart, so that the swizzle
//   keeps their reads on distinct banks), each V row read once for up to 5
//   queries (a window of 6-8 in two passes: at most 5 x 8 sums a thread),
//   shuffles and a block sum into a kTq x 64-float partial. Exchange 2:
//   each CTA stores output i of its partial (i = query x 64 + channel) into
//   the shared memory of rank i / (kTq*64/S); after a second cluster
//   barrier rank r sums its share in rank order and writes it. Every remote
//   store precedes a barrier that its target passes before it reads or
//   exits, and a cluster barrier arrived at the start (and waited on before
//   the first remote store) ensures every target has started. No
//   workspace, no atomics, no host synchronisation: two calls give the same
//   bits.
// - The rows a CTA can hold shrink as Tq grows (its Tq score rows and the
//   tail share the 227 KB): at int8 1536 up to Tq = 3, 1280 up to 7, 1024
//   at 8; at int4 (64-byte rows) 1536 at every Tq. So T <= 8192 fits at S =
//   8 for every Tq. A window's instantiation keeps to 80 registers a
//   thread, so that three CTAs share an SM: the 8-slot pool's verify (320
//   CTAs of 320 rows) then runs in one wave of the 396 places.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPvLanes = kThreads / 8;  // PV position lanes, 8 channels a thread
constexpr int kMaxSplits = 8;           // the portable cluster size
constexpr int kMaxTq = 8;               // queries a window at most
constexpr int kTargetCtas = 264;        // 2 per SM of the H100's 132
constexpr int kMinChunk = 64;           // rows a further split must leave a CTA
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory a CTA may have
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kTwo23 = 0x4B000000u;  // the f32 2^23

// Four int8 values (one 32-bit word, byte i the i-th) -> four floats, exact:
// each byte biased to u8 sits in the mantissa of the f32 2^23.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
    constexpr float kBias = 8388736.0f;  // 2^23 + 128
    const uint32_t u = w ^ 0x80808080u;  // int8 + 128 as u8
    f[0] = __uint_as_float(__byte_perm(u, kTwo23, 0x7650)) - kBias;
    f[1] = __uint_as_float(__byte_perm(u, kTwo23, 0x7651)) - kBias;
    f[2] = __uint_as_float(__byte_perm(u, kTwo23, 0x7652)) - kBias;
    f[3] = __uint_as_float(__byte_perm(u, kTwo23, 0x7653)) - kBias;
}

// Eight signed nibbles (one 32-bit word, byte i holding value i's low and
// high nibble) -> the four low nibbles' values to lo[i] and the four high
// nibbles' to hi[i], exact: each nibble n biased to n ^ 8 (its value + 8)
// sits in the mantissa of the f32 2^23.
__device__ __forceinline__ void i4x8_to_f32(uint32_t w, float* lo, float* hi) {
    constexpr float kBias = 8388616.0f;  // 2^23 + 8
    const uint32_t u = w ^ 0x88888888u;
    const uint32_t l = u & 0x0f0f0f0fu, h = (u >> 4) & 0x0f0f0f0fu;
    lo[0] = __uint_as_float(__byte_perm(l, kTwo23, 0x7650)) - kBias;
    lo[1] = __uint_as_float(__byte_perm(l, kTwo23, 0x7651)) - kBias;
    lo[2] = __uint_as_float(__byte_perm(l, kTwo23, 0x7652)) - kBias;
    lo[3] = __uint_as_float(__byte_perm(l, kTwo23, 0x7653)) - kBias;
    hi[0] = __uint_as_float(__byte_perm(h, kTwo23, 0x7650)) - kBias;
    hi[1] = __uint_as_float(__byte_perm(h, kTwo23, 0x7651)) - kBias;
    hi[2] = __uint_as_float(__byte_perm(h, kTwo23, 0x7652)) - kBias;
    hi[3] = __uint_as_float(__byte_perm(h, kTwo23, 0x7653)) - kBias;
}

// A row codec: how one position's K and V are copied into shared memory
// and decoded there.
//   kRow                  bytes of a position in shared memory (kPieces of 16)
//   copy_piece(kv, k, v, row0, i)  the cp.async of piece i of the chunk
//                         whose first position is row0 (from row (0, 0))
//   piece_at(r, p)        byte offset of piece p of row r in shared memory
//   k_unit(kv, r, u, kf)  the kKVals K values of unit u (of kKUnits) of row r
//   k_channel(u, i)       the channel of kf[i] (i, i+1, i+2, i+3 consecutive)
//   v_group(kv, r, g, vf) the 8 V values of channel group g (0..7) of row r
//   v_channel(g, i)       the channel of vf[i]

// kvp [B, H, T, 128]: K in bytes [0, 64), V in [64, 128) of a row; k is
// kvp, v is unused.
struct Int8Packed {
    static constexpr int kRow = 2 * kHd;
    static constexpr int kPieces = kRow / 16;
    static constexpr int kKUnits = 4, kKVals = 16;  // a unit is a piece of K

    // The pieces of a row XOR-swizzled by r % 8, so that 8 lanes reading
    // the same piece of 8 consecutive rows, or any piece of two rows 4
    // apart, hit distinct banks.
    __device__ static int piece_at(int r, int p) { return r * kRow + ((p ^ (r & 7)) << 4); }

    __device__ static void copy_piece(unsigned char* kv, const int8_t* k, const int8_t*,
                                      long long row0, int i) {
        wl::cp_async_16(kv + piece_at(i >> 3, i & 7), k + row0 * kRow + i * 16, true);
    }

    __device__ static void k_unit(const unsigned char* kv, int r, int u, float (&kf)[kKVals]) {
        const uint4 w = *reinterpret_cast<const uint4*>(kv + piece_at(r, u));
        i8x4_to_f32(w.x, kf);
        i8x4_to_f32(w.y, kf + 4);
        i8x4_to_f32(w.z, kf + 8);
        i8x4_to_f32(w.w, kf + 12);
    }

    __host__ __device__ static constexpr int k_channel(int u, int i) { return 16 * u + i; }

    __device__ static void v_group(const unsigned char* kv, int r, int g, float (&vf)[8]) {
        const uint2 w = *reinterpret_cast<const uint2*>(kv + piece_at(r, 4 + (g >> 1)) +
                                                        ((g & 1) << 3));
        i8x4_to_f32(w.x, vf);
        i8x4_to_f32(w.y, vf + 4);
    }

    __device__ static int v_channel(int g, int i) { return g * 8 + i; }
};

// k4 and v4 [B, H, T, 32], byte c of a row holding channel c (low nibble)
// and 32 + c (high nibble): a row in shared memory is K's 32 bytes (pieces
// 0 and 1) then V's (pieces 2 and 3).
struct Int4Halves {
    static constexpr int kHalf = kHd / 2;  // bytes of K (and of V) a position
    static constexpr int kRow = 2 * kHalf;
    static constexpr int kPieces = kRow / 16;
    static constexpr int kKUnits = 2, kKVals = 32;  // a unit is a piece of K

    // The pieces of a row XOR-swizzled by (r / 2) % 4, so that 8 lanes
    // reading the same piece of 8 consecutive rows hit 8 distinct 16-byte
    // bank groups, and the PV lanes (a warp on rows r, r + 4, r + 1, r + 5,
    // each row's 8 words of V) 32 distinct banks.
    __device__ static int piece_at(int r, int p) { return r * kRow + ((p ^ ((r >> 1) & 3)) << 4); }

    __device__ static void copy_piece(unsigned char* kv, const int8_t* k, const int8_t* v,
                                      long long row0, int i) {
        const int r = i >> 2, p = i & 3;
        wl::cp_async_16(kv + piece_at(r, p), (p < 2 ? k : v) + (row0 + r) * kHalf + (p & 1) * 16,
                        true);
    }

    // kf[0..15]: the low nibbles of K's bytes 16u..16u+15 (channels 16u +
    // i); kf[16..31]: their high nibbles (channels 32 + 16u + i - 16)
    __device__ static void k_unit(const unsigned char* kv, int r, int u, float (&kf)[kKVals]) {
        const uint4 w = *reinterpret_cast<const uint4*>(kv + piece_at(r, u));
        i4x8_to_f32(w.x, kf, kf + 16);
        i4x8_to_f32(w.y, kf + 4, kf + 20);
        i4x8_to_f32(w.z, kf + 8, kf + 24);
        i4x8_to_f32(w.w, kf + 12, kf + 28);
    }

    __host__ __device__ static constexpr int k_channel(int u, int i) {
        return i < 16 ? 16 * u + i : 16 * u + i + 16;
    }

    // group g reads V's word g: channels 4g..4g+3 (low nibbles) to
    // vf[0..3], 32+4g..32+4g+3 (high nibbles) to vf[4..7]
    __device__ static void v_group(const unsigned char* kv, int r, int g, float (&vf)[8]) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(kv + piece_at(r, 2 + (g >> 2)) +
                                                              ((g & 3) << 2));
        i4x8_to_f32(w, vf, vf + 4);
    }

    __device__ static int v_channel(int g, int i) {
        return i < 4 ? 4 * g + i : kHalf + 4 * g + i - 4;
    }
};

// Shared memory after the chunk's rows, score rows and the PV sums of every
// rank (S x kTq x 64 floats: this rank's share of each).
template <int kTq>
struct Tail {
    float qf[kTq][kHd];                     // q in f32
    float2 stats[kMaxSplits][kTq];          // (m_r, l_r) of every rank, stored by each
    float warp_part[kWarps][kTq * kHd];     // PV sums of each warp
    float red_max[kWarps], red_sum[kWarps];  // the CTA's reductions at Tq = 1
};

template <class Codec, int kTq>
__host__ __device__ inline size_t parts_at(int cap) {
    return static_cast<size_t>(cap) * Codec::kRow +
           (static_cast<size_t>(cap) * 4 * kTq + 15) / 16 * 16;
}

template <class Codec, int kTq>
__host__ __device__ inline size_t smem_bytes(int cap, int S) {
    return parts_at<Codec, kTq>(cap) + static_cast<size_t>(S) * kTq * kHd * 4 +
           sizeof(Tail<kTq>);
}

// Rows a CTA can hold at kTq queries: whole passes of kThreads rows whose
// K and V, score rows, partial sums (at S = kMaxSplits) and tail fit in
// kSmemLimit, at most 1536 (~200 KB at int8, Tq = 1).
template <class Codec, int kTq>
constexpr int max_chunk() {
    const int fit = static_cast<int>((kSmemLimit - sizeof(Tail<kTq>) - kMaxSplits * kTq * kHd * 4 -
                                      15) / (Codec::kRow + 4 * kTq));
    return fit / kThreads * kThreads < 1536 ? fit / kThreads * kThreads : 1536;
}
template <class Codec, int kTq>
constexpr int kMaxChunk = max_chunk<Codec, kTq>();
template <class Codec>
constexpr int kMaxChunkOf[kMaxTq + 1] = {
    0, kMaxChunk<Codec, 1>, kMaxChunk<Codec, 2>, kMaxChunk<Codec, 3>, kMaxChunk<Codec, 4>,
    kMaxChunk<Codec, 5>, kMaxChunk<Codec, 6>, kMaxChunk<Codec, 7>, kMaxChunk<Codec, 8>};

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
// A window keeps to 80 registers (three CTAs an SM).
// k and v are the codec's arrays (Int8Packed: kvp and null).
template <class Codec, int kTq>
__global__ void __launch_bounds__(kThreads, kTq == 1 ? 1 : 3)
cross_attention_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v, const int* __restrict__ lengths,
                       const uint8_t* __restrict__ active, float* __restrict__ out, int H, int T,
                       int S, float scale) {
    constexpr int kRowsPerThread = kMaxChunk<Codec, kTq> / kThreads;  // score rows a thread at most
    constexpr int kOut = kTq * kHd;                                   // outputs of a (b, h)
    constexpr int kPvTq = kTq <= 5 ? kTq : (kTq + 1) / 2;             // queries a PV pass
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rank = static_cast<int>(wl::cluster_rank());
    const long long bh = blockIdx.x / S;
    const int b = static_cast<int>(bh / H);
    const int share = kOut / S;  // outputs this rank writes
    float* o = out + bh * kOut + rank * share;
    if (active != nullptr && !active[b]) {
        // a cluster is one (b, h): every rank returns here, before any barrier
        for (int i = tid; i < share; i += kThreads) o[i] = 0.0f;
        return;
    }
    wl::cluster_arrive_relaxed();  // this CTA has started; waited on before any remote store
    const int len = lengths != nullptr ? lengths[b] : T;
    const int n = len <= 0 ? T : min(len, T);
    const int cap = (T + S - 1) / S;  // rows the shared memory holds
    const int c = (n + S - 1) / S;
    const int r0 = min(n, rank * c);
    const int rows = min(n, r0 + c) - r0;  // this CTA's chunk; empty when rank * c >= n
    unsigned char* kv = smem;  // [cap][Codec::kRow], pieces swizzled (Codec::piece_at)
    float* score = reinterpret_cast<float*>(smem + cap * Codec::kRow);      // [kTq][cap]
    float* parts = reinterpret_cast<float*>(smem + parts_at<Codec, kTq>(cap));  // [S][kOut]
    Tail<kTq>& tl = *reinterpret_cast<Tail<kTq>*>(smem + smem_bytes<Codec, kTq>(cap, S) -
                                                  sizeof(Tail<kTq>));

    // The copy wave: one commit, one wait.
    for (int i = tid; i < rows * Codec::kPieces; i += kThreads)
        Codec::copy_piece(kv, k, v, bh * T + r0, i);
    wl::cp_async_commit();
    for (int i = tid; i < kOut; i += kThreads)
        tl.qf[i / kHd][i % kHd] = __bfloat162float(q[bh * kOut + i]);
    wl::cp_async_wait<0>();
    __syncthreads();  // the chunk and q landed for every thread

    // Scores: thread t takes rows t, t + kThreads, ..., the whole K of each
    // against kScoreTq queries a pass, in four independent sums
    // (kChains) a query at Tq = 1, two at Tq = 2 and one above, where the
    // queries' sums are independent; q is read from shared memory (every
    // lane the same address).
    constexpr int kChains = kTq == 1 ? 4 : kTq == 2 ? 2 : 1;
    constexpr int kScoreTq = kTq <= 6 ? kTq : (kTq + 1) / 2;
    auto score_of = [&](int j, float (&dot)[kTq]) {
#pragma unroll
        for (int t0 = 0; t0 < kTq; t0 += kScoreTq) {
            float d[kScoreTq][kChains];
#pragma unroll
            for (int t = 0; t < kScoreTq; ++t) {
#pragma unroll
                for (int h = 0; h < kChains; ++h) d[t][h] = 0.0f;
            }
#pragma unroll
            for (int u = 0; u < Codec::kKUnits; ++u) {
                float kf[Codec::kKVals];
                Codec::k_unit(kv, j, u, kf);
#pragma unroll
                for (int t = 0; t < kScoreTq; ++t) {
                    if (t0 + t >= kTq) continue;
#pragma unroll
                    for (int i = 0; i < Codec::kKVals; i += 4) {
                        float& acc = d[t][(u * Codec::kKVals + i) / 16 % kChains];
                        const float4 qv = *reinterpret_cast<const float4*>(
                            &tl.qf[t0 + t][Codec::k_channel(u, i)]);
                        acc = fmaf(qv.x, kf[i], acc);
                        acc = fmaf(qv.y, kf[i + 1], acc);
                        acc = fmaf(qv.z, kf[i + 2], acc);
                        acc = fmaf(qv.w, kf[i + 3], acc);
                    }
                }
            }
#pragma unroll
            for (int t = 0; t < kScoreTq; ++t) {
                if (t0 + t >= kTq) continue;
                float dot_t = d[t][0];
                if constexpr (kChains == 4) dot_t = (d[t][0] + d[t][1]) + (d[t][2] + d[t][3]);
                if constexpr (kChains == 2) dot_t = d[t][0] + d[t][1];
                dot[t0 + t] = r0 + j < len ? dot_t * scale : wl::kNegInf;
            }
        }
    };
    if constexpr (kTq == 1) {
        // A thread keeps its scores; the CTA forms (m_r, l_r).
        float sc[kRowsPerThread];
        float m_t = -INFINITY;
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
            const int j = tid + k * kThreads;
            float dot[1] = {-INFINITY};
            if (j < rows) score_of(j, dot);
            sc[k] = dot[0];
            m_t = fmaxf(m_t, sc[k]);
        }
        const float m_r = block_max(m_t, tl.red_max);
        float l_t = 0.0f;
        if (m_r != -INFINITY) {  // an empty chunk has no score and sums to 0
#pragma unroll
            for (int k = 0; k < kRowsPerThread; ++k) l_t += exp_minus(sc[k], m_r);
        }
        const float l_r = block_sum(l_t, tl.red_sum);

        // Exchange 1: (m_r, l_r) into every rank's slot `rank`; then m = max
        // m_r and total = sum l_r exp(m_r - m) in rank order (an empty
        // chunk's exp(-inf - m) is 0, m being finite).
        wl::cluster_wait();  // every CTA of the cluster has started
        if (tid < S) wl::st_shared_cluster_f2(&tl.stats[rank][0], tid, float2{m_r, l_r});
        wl::cluster_sync();
        float m = -INFINITY, total = 0.0f;
#pragma unroll
        for (int z = 0; z < kMaxSplits; ++z)
            if (z < S) m = fmaxf(m, tl.stats[z][0].x);
#pragma unroll
        for (int z = 0; z < kMaxSplits; ++z)
            if (z < S) total += tl.stats[z][0].y * exp_minus(tl.stats[z][0].x, m);
        const float inv = 1.0f / total;
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
            const int j = tid + k * kThreads;
            if (j < rows) score[j] = __bfloat162float(__float2bfloat16(exp_minus(sc[k], m) * inv));
        }
    } else {
        // The Tq score rows into shared memory; warp t forms query t's
        // (m_r, l_r) over row t.
        for (int j = tid; j < rows; j += kThreads) {
            float dot[kTq];
            score_of(j, dot);
#pragma unroll
            for (int t = 0; t < kTq; ++t) score[t * cap + j] = dot[t];
        }
        __syncthreads();
        const float* row = score + warp * cap;
        float m_r = -INFINITY, l_r = 0.0f;
        if (warp < kTq) {
            for (int j = lane; j < rows; j += 32) m_r = fmaxf(m_r, row[j]);
            m_r = wl::warp_max(m_r);
            if (m_r != -INFINITY) {  // an empty chunk has no score and sums to 0
                for (int j = lane; j < rows; j += 32) l_r += exp_minus(row[j], m_r);
            }
            l_r = wl::warp_sum(l_r);
        }

        // Exchange 1: lane z of warp t stores query t's (m_r, l_r) into rank
        // z's slot `rank`; then lane z holds rank z's pair, and the warp
        // forms m = max m_r and total = sum l_r exp(m_r - m) (an empty
        // chunk's exp(-inf - m) is 0, m being finite) in a butterfly whose
        // order is fixed.
        wl::cluster_wait();  // every CTA of the cluster has started
        if (warp < kTq && lane < S)
            wl::st_shared_cluster_f2(&tl.stats[rank][warp], lane, float2{m_r, l_r});
        wl::cluster_sync();
        if (warp < kTq) {
            const float2 st = lane < S ? tl.stats[lane][warp] : float2{-INFINITY, 0.0f};
            const float m = wl::warp_max(st.x);
            const float total = wl::warp_sum(lane < S ? st.y * exp_minus(st.x, m) : 0.0f);
            const float inv = 1.0f / total;
            float* prow = score + warp * cap;
            for (int j = lane; j < rows; j += 32)
                prow[j] = __bfloat162float(__float2bfloat16(exp_minus(prow[j], m) * inv));
        }
    }
    __syncthreads();

    // PV over the V halves: 32 position lanes x 8 groups of 8 channels, each
    // V row once for kPvTq queries a pass. Lane P takes rows 32i + (P & 24)
    // + 4 (P & 1) + (P >> 1 & 3): the two position lanes of a half-warp
    // read rows 4 apart. Lane = (P % 4) * 8 + cg: a warp's sums over its 4
    // position lanes go to warp_part.
    const int cg = tid & 7, pl = tid >> 3;
    const int pr = (pl & 24) | ((pl & 1) << 2) | ((pl >> 1) & 3);
#pragma unroll
    for (int t0 = 0; t0 < kTq; t0 += kPvTq) {
        float acc[kPvTq][8];
#pragma unroll
        for (int t = 0; t < kPvTq; ++t) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[t][i] = 0.0f;
        }
#pragma unroll 2
        for (int j = pr; j < rows; j += kPvLanes) {
            float vf[8];
            Codec::v_group(kv, j, cg, vf);
#pragma unroll
            for (int t = 0; t < kPvTq; ++t) {
                if (t0 + t < kTq) {
                    const float p = score[(t0 + t) * cap + j];
#pragma unroll
                    for (int i = 0; i < 8; ++i) acc[t][i] = fmaf(p, vf[i], acc[t][i]);
                }
            }
        }
#pragma unroll
        for (int t = 0; t < kPvTq; ++t) {
            if (t0 + t < kTq) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    acc[t][i] += __shfl_xor_sync(0xffffffffu, acc[t][i], 8);
                    acc[t][i] += __shfl_xor_sync(0xffffffffu, acc[t][i], 16);
                }
                if (lane < 8) {
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        tl.warp_part[warp][(t0 + t) * kHd + Codec::v_channel(lane, i)] = acc[t][i];
                }
            }
        }
    }
    __syncthreads();

    // Exchange 2: output i of this CTA's partial into the slot `rank` of
    // rank i / share, which sums its share over the ranks in rank order.
    for (int i = tid; i < kOut; i += kThreads) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += tl.warp_part[w][i];
        wl::st_shared_cluster_f32(&parts[rank * kOut + i], i / share, s);
    }
    wl::cluster_sync();
    for (int i = tid; i < share; i += kThreads) {
        float s = 0.0f;
#pragma unroll
        for (int z = 0; z < kMaxSplits; ++z)
            if (z < S) s += parts[z * kOut + rank * share + i];
        o[i] = s;
    }
}

// The split over T for Tq queries (1..kMaxTq): the fewest CTAs a (b, h),
// doubling while B*H*S is short of kTargetCtas and a chunk of T keeps >=
// kMinChunk rows, then as many as a chunk of T needs to fit in shared
// memory.
template <class Codec>
int splits_for(int bh, int T, int tq) {
    int s = 1;
    while (s < kMaxSplits && bh * s < kTargetCtas && (T + 2 * s - 1) / (2 * s) >= kMinChunk)
        s *= 2;
    while (s < kMaxSplits && (T + s - 1) / s > kMaxChunkOf<Codec>[tq]) s *= 2;
    return s;
}

template <class Codec, int kTq>
int launch_tq(const void* q, const void* k, const void* v, const void* lengths,
              const void* active, void* out, int B, int H, int T, float scale, int S,
              cudaStream_t stream) {
    const int cap = (T + S - 1) / S;
    if (B < 1 || H < 1 || T < 1 || (S != 1 && S != 2 && S != 4 && S != 8) ||
        cap > kMaxChunk<Codec, kTq>)
        return static_cast<int>(cudaErrorInvalidValue);
    // above 48 KB of dynamic shared memory only by opting in, once a process
    // for each codec and Tq
    static const cudaError_t raised = cudaFuncSetAttribute(
        cross_attention_kernel<Codec, kTq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<Codec, kTq>(kMaxChunk<Codec, kTq>, kMaxSplits)));
    if (raised != cudaSuccess) return static_cast<int>(raised);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(S * B * H);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem_bytes<Codec, kTq>(cap, S);
    config.stream = stream;
    cudaLaunchAttribute cluster = {};
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = S;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    config.attrs = &cluster;
    config.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &config, cross_attention_kernel<Codec, kTq>, static_cast<const bf16*>(q),
        static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const int*>(lengths), static_cast<const uint8_t*>(active),
        static_cast<float*>(out), H, T, S, scale));
}

// The launch of a window of Tq queries (1..kMaxTq) over the codec's k and v
// with the split S in {1, 2, 4, 8}, or splits_for's where S is 0; `lengths`
// and `active` may be null.
template <class Codec>
int launch(const void* q, const void* k, const void* v, const void* lengths, const void* active,
           void* out, int B, int H, int T, int Tq, float scale, int S, cudaStream_t stream) {
    if (Tq < 1 || Tq > kMaxTq) return static_cast<int>(cudaErrorInvalidValue);
    if (S == 0) S = splits_for<Codec>(B * H, T, Tq);
    constexpr decltype(&launch_tq<Codec, 1>) kByTq[kMaxTq + 1] = {
        nullptr, launch_tq<Codec, 1>, launch_tq<Codec, 2>, launch_tq<Codec, 3>, launch_tq<Codec, 4>,
        launch_tq<Codec, 5>, launch_tq<Codec, 6>, launch_tq<Codec, 7>, launch_tq<Codec, 8>};
    return kByTq[Tq](q, k, v, lengths, active, out, B, H, T, scale, S, stream);
}

}  // namespace

// K4: `lengths` may be null (every row reads all T positions).
extern "C" int wl_cross_attention_int8(const void* q, const void* kvp, const void* lengths,
                                       void* out, int B, int H, int T, float scale,
                                       void* stream) {
    return launch<Int8Packed>(q, kvp, nullptr, lengths, nullptr, out, B, H, T, 1, scale, 0,
                              static_cast<cudaStream_t>(stream));
}

// K5: rows whose active[b] is 0 read no K/V and are written as zeros.
extern "C" int wl_cross_attention_int8_skip(const void* q, const void* kvp, const void* lengths,
                                            const void* active, void* out, int B, int H, int T,
                                            float scale, void* stream) {
    return launch<Int8Packed>(q, kvp, nullptr, lengths, active, out, B, H, T, 1, scale, 0,
                              static_cast<cudaStream_t>(stream));
}

// K6: a window of Tq <= 8 queries a row; `lengths` may be null.
extern "C" int wl_cross_attention_int8_window(const void* q, const void* kvp, const void* lengths,
                                              void* out, int B, int H, int T, int Tq, float scale,
                                              void* stream) {
    return launch<Int8Packed>(q, kvp, nullptr, lengths, nullptr, out, B, H, T, Tq, scale, 0,
                              static_cast<cudaStream_t>(stream));
}

// K5's window form: K6 with lengths and an active mask; rows whose active[b]
// is 0 read no K/V and are written as zeros.
extern "C" int wl_cross_attention_int8_skip_window(const void* q, const void* kvp,
                                                   const void* lengths, const void* active,
                                                   void* out, int B, int H, int T, int Tq,
                                                   float scale, void* stream) {
    return launch<Int8Packed>(q, kvp, nullptr, lengths, active, out, B, H, T, Tq, scale, 0,
                              static_cast<cudaStream_t>(stream));
}

// K7: one query a row over int4 K and V; `lengths` may be null.
extern "C" int wl_cross_attention_int4(const void* q, const void* k4, const void* v4,
                                       const void* lengths, void* out, int B, int H, int T,
                                       float scale, void* stream) {
    return launch<Int4Halves>(q, k4, v4, lengths, nullptr, out, B, H, T, 1, scale, 0,
                              static_cast<cudaStream_t>(stream));
}

// K8: a window of Tq <= 8 queries a row over int4 K and V; `lengths` may be
// null.
extern "C" int wl_cross_attention_int4_window(const void* q, const void* k4, const void* v4,
                                              const void* lengths, void* out, int B, int H,
                                              int T, int Tq, float scale, void* stream) {
    return launch<Int4Halves>(q, k4, v4, lengths, nullptr, out, B, H, T, Tq, scale, 0,
                              static_cast<cudaStream_t>(stream));
}
