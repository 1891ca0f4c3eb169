// A CPU stand-in for csrc/common.cuh and the CUDA headers, so that a kernel
// source of csrc/ compiles with g++ (C++17) and runs on the CPU. Clusters
// of CTAs (one CTA each, unless the launch asks for more) run one after
// another, in launch order (x fastest) or, with emu::reverse_ctas, in the
// reverse order; the threads of a cluster's CTAs are coroutines (ucontext)
// on one OS thread, scheduled in turn, so runs are deterministic.
// __syncthreads is a barrier of the CTA's threads, cluster_sync one of the
// cluster's, and the warp collectives (shuffles, ldmatrix, mma.sync)
// exchange values through per-warp slots between two barriers of the warp.
// A barrier that can never complete aborts as a deadlock. Each CTA has its
// own shared memory, filled with NaN at the cluster's start and again when
// the CTA exits; a read of (or a write to) another CTA's through the
// cluster helpers lands in the same offset of its memory, and a write to a
// CTA that has exited aborts. cp.async copies are held per thread and land
// at the wait_group that retires their group (or at once, with
// emu::eager_copies), so a read that misses its wait sees that NaN. Every ldmatrix counts its bank
// conflicts; a copy's source must lie in a range registered with
// emu::add_global. Bulk copies are held on their mbarrier and land when a
// thread waits on it (or at once, with emu::eager_copies); mbarrier waits
// and named barriers block until woken. Only what the kernels here use is
// defined. A launch `k<<<grid, block, smem, stream>>>(args)` must be rewritten to
// `emu_launch(k, grid, block, smem, stream, args)` first; cudaLaunchKernelEx
// runs as it is.
#pragma once
#include <ucontext.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <map>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __restrict__
#define __align__(n) alignas(n)

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3e { unsigned x, y, z; };
inline uint3e blockDim, gridDim;

struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
using std::max;
using std::min;

typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
constexpr int cudaLaunchAttributeClusterDimension = 4;
struct cudaLaunchAttributeValue {
    struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute { int id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
inline cudaError_t cudaGetLastError() { return 0; }
// The device queries of a persistent launch: the H100's 132 SMs, and as many
// CTAs an SM as its 228 KB of shared memory holds (1 KB reserved a CTA).
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t smem) {
    *n = static_cast<int>(233472 / (smem + 1024));
    return 0;
}

struct __nv_bfloat16 { uint16_t u; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline uint16_t f2bf(float f) {
    uint32_t u; std::memcpy(&u, &f, 4);
    if (std::isnan(f)) return 0x7fc0;
    u += 0x7fff + ((u >> 16) & 1);
    return static_cast<uint16_t>(u >> 16);
}
inline float bf2f(uint16_t h) {
    const uint32_t u = uint32_t(h) << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) { return {f2bf(f)}; }
inline float __bfloat162float(__nv_bfloat16 h) { return bf2f(h.u); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {{f2bf(a)}, {f2bf(b)}}; }

// Integer and bit intrinsics. __byte_perm(x, y, s): byte i of the result is
// byte (s >> 4i) & 7 of the eight bytes y:x (x holds bytes 0-3).
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
    const uint64_t v = (uint64_t(y) << 32) | x;
    uint32_t r = 0;
    for (int i = 0; i < 4; ++i) r |= uint32_t((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
    return r;
}
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }

// ---- emulator state ----
namespace emu {
constexpr int kMaxCtas = 8;                  // CTAs in a cluster
constexpr int kMaxWarps = 32 * kMaxCtas;     // warps in a cluster
constexpr size_t kSmemPerCta = 232448;     // the H100's 227 KB a CTA
constexpr size_t kStack = 256 * 1024;
struct Copy { void* dst; const void* src; bool valid; };
struct Thread {
    ucontext_t ctx;
    std::unique_ptr<char[]> stack;
    uint3e idx{}, block{};
    int cta = 0;  // rank of its CTA in the cluster
    bool done = false, waiting = false;
    int named = -1;           // the named barrier it waits at
    bool on_cluster = false;  // waiting at the cluster barrier ...
    int cluster_target = 0;   // ... for its phase to reach this
    std::vector<std::vector<Copy>> groups;
    std::vector<Copy> open_group;
};
inline std::vector<Thread> threads;  // a cluster's, CTA by CTA
inline Thread* cur = nullptr;
inline ucontext_t scheduler;
inline std::function<void()> body;
inline int warp_arrived[kMaxWarps], cta_arrived[kMaxCtas], cluster_arrived;
inline int named_arrived[kMaxCtas][16];
inline int cluster_phase;  // completed phases of the cluster barrier
inline const void* x_ptr[kMaxWarps][32];
inline uint32_t x_u[kMaxWarps][32][6];
inline float x_f[kMaxWarps][32];
alignas(128) inline unsigned char smem_buf[kMaxCtas][kSmemPerCta];
inline size_t smem_size;
inline long bank_conflicts = 0, ldmatrix_calls = 0;
inline bool eager_copies = false;
inline bool reverse_ctas = false;
inline std::vector<std::pair<const unsigned char*, size_t>> globals;
inline void add_global(const void* p, size_t n) {
    globals.emplace_back(static_cast<const unsigned char*>(p), n);
}
inline void check_global(const void* p, size_t n) {
    auto c = static_cast<const unsigned char*>(p);
    for (auto& [base, size] : globals)
        if (c >= base && c + n <= base + size) return;
    fprintf(stderr, "global read out of bounds\n");
    abort();
}
inline unsigned char* cta_smem() { return smem_buf[cur->cta]; }
// mbarriers, by address (a CTA's barriers are initialised before use)
struct Bulk { void* dst; const void* src; uint32_t bytes; };
struct MBar {
    int count = 0, pending = 0;
    long tx = 0;
    unsigned completed = 0;  // phases completed
    std::vector<Bulk> copies;  // issued, not landed
    std::vector<std::pair<Thread*, unsigned>> waiters;  // blocked, with the parity they wait for
};
inline std::map<const void*, MBar> mbars;
inline MBar& mbar(const void* bar) {
    auto it = mbars.find(bar);
    if (it == mbars.end()) { fprintf(stderr, "mbarrier used before init\n"); abort(); }
    return it->second;
}
inline void mbar_advance(MBar& b) {
    if (b.pending != 0 || b.tx != 0) return;
    ++b.completed, b.pending = b.count;
    std::vector<std::pair<Thread*, unsigned>> still;
    for (auto& [th, parity] : b.waiters)
        if ((b.completed & 1u) != parity) th->waiting = false; else still.emplace_back(th, parity);
    b.waiters.swap(still);
}
inline void mbar_land(MBar& b) {
    for (auto& c : b.copies) std::memcpy(c.dst, c.src, c.bytes), b.tx -= c.bytes;
    b.copies.clear();
    mbar_advance(b);
}
// warp of the current thread among the cluster's warps
inline int warp() { return (cur->cta * static_cast<int>(blockDim.x) + cur->idx.x) >> 5; }
inline int lane() { return cur->idx.x & 31; }
// Arrive at a barrier of threads [first, first + n) and wait for the rest.
inline void barrier(int& arrived, int first, int n) {
    cur->waiting = true;
    if (++arrived == n) {
        arrived = 0;
        for (int i = first; i < first + n; ++i) threads[i].waiting = false;
    }
    while (cur->waiting) swapcontext(&cur->ctx, &scheduler);
}
inline void wsync() { barrier(warp_arrived[warp()], warp() * 32, 32); }
inline void check_smem(const void* p, size_t n) {
    auto c = static_cast<const unsigned char*>(p);
    if (c < cta_smem() || c + n > cta_smem() + smem_size) {
        fprintf(stderr, "smem OOB\n");
        abort();
    }
}
inline void do_copy(const Copy& c) {
    if (c.valid) std::memcpy(c.dst, c.src, 16); else std::memset(c.dst, 0, 16);
}
// How a cluster's threads take turns: kRoundRobin resumes each in turn, so
// the warps keep in step; kFirstWarpAhead always resumes the
// lowest-numbered thread that can run, and kLastWarpAhead the highest, so
// one warp runs as far ahead of the others as the barriers allow (a missing
// barrier then lets it overwrite, or read, shared memory that another warp
// still needs).
enum Schedule { kRoundRobin, kFirstWarpAhead, kLastWarpAhead };
inline Schedule schedule = kRoundRobin;

inline void resume(Thread& th) {
    cur = &th;
    swapcontext(&scheduler, &th.ctx);
}

inline void run_cluster() {
    const int n = static_cast<int>(threads.size());
    for (;;) {
        int left = 0, ran = 0;
        if (schedule == kRoundRobin) {
            for (auto& th : threads) {
                left += !th.done;
                if (!th.done && !th.waiting) resume(th), ++ran;
            }
        } else {
            for (int k = 0; k < n; ++k) {
                Thread& th = threads[schedule == kFirstWarpAhead ? k : n - 1 - k];
                left += !th.done;
                if (!th.done && !th.waiting) {
                    resume(th), ++ran;
                    break;
                }
            }
            if (ran) continue;
        }
        if (!left) return;
        if (!ran) { fprintf(stderr, "deadlock: a barrier never completes\n"); abort(); }
    }
}

inline void trampoline() {
    body();
    cur->done = true;
    // a CTA that has exited leaves NaN behind for the cluster's late readers
    const int n = static_cast<int>(blockDim.x), first = cur->cta * n;
    bool cta_done = true;
    for (int i = first; i < first + n; ++i) cta_done = cta_done && threads[i].done;
    if (cta_done) std::memset(smem_buf[cur->cta], 0xff, smem_size);
    swapcontext(&cur->ctx, &scheduler);
}
}  // namespace emu

#define threadIdx (emu::cur->idx)
#define blockIdx (emu::cur->block)
// the dynamic shared memory of the current thread's CTA
#define emu_smem (emu::cta_smem())

inline void __syncthreads() {
    const int n = static_cast<int>(blockDim.x);
    emu::barrier(emu::cta_arrived[emu::cur->cta], emu::cur->cta * n, n);
}
inline void __syncwarp() { emu::wsync(); }
namespace wl {
// bar.sync id, count: the CTA's threads waiting at barrier `id` go on once
// `count` of them have arrived.
inline void named_barrier_sync(int id, int count) {
    const int n = static_cast<int>(blockDim.x), first = emu::cur->cta * n;
    int& arrived = emu::named_arrived[emu::cur->cta][id];
    emu::cur->named = id;
    emu::cur->waiting = true;
    if (++arrived == count) {
        arrived = 0;
        for (int i = first; i < first + n; ++i)
            if (emu::threads[i].named == id) emu::threads[i].named = -1, emu::threads[i].waiting = false;
    }
    while (emu::cur->waiting) swapcontext(&emu::cur->ctx, &emu::scheduler);
}
}  // namespace wl
inline float __shfl_xor_sync(unsigned, float v, int m) {
    const int w = emu::warp(), l = emu::lane();
    emu::x_f[w][l] = v;
    emu::wsync();
    const float r = emu::x_f[w][l ^ m];
    emu::wsync();
    return r;
}

namespace wl {
constexpr float kNegInf = -FLT_MAX;
inline float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
inline float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
inline float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}
inline float warp_max(float v) {
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}
inline void cp_async_16(void* dst, const void* src, bool valid) {
    emu::check_smem(dst, 16);
    if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) {
        fprintf(stderr, "cp.async misaligned\n"); abort();
    }
    if (valid) emu::check_global(src, 16);
    emu::Copy c{dst, src, valid};
    if (emu::eager_copies) emu::do_copy(c);
    else emu::cur->open_group.push_back(c);
}
inline void cp_async_commit() {
    emu::cur->groups.push_back(std::move(emu::cur->open_group));
    emu::cur->open_group.clear();
}
template <int N> inline void cp_async_wait() {
    auto& groups = emu::cur->groups;
    while (groups.size() > static_cast<size_t>(N)) {
        for (auto& c : groups.front()) emu::do_copy(c);
        groups.erase(groups.begin());
    }
}
inline void ldm(uint32_t r[4], const void* p, bool trans) {
    const int w = emu::warp(), l = emu::lane();
    emu::check_smem(p, 16);
    if (reinterpret_cast<uintptr_t>(p) % 16) { fprintf(stderr, "ldmatrix misaligned\n"); abort(); }
    emu::x_ptr[w][l] = p;
    emu::wsync();
    for (int i = 0; i < 4; ++i) {
        uint16_t lo, hi;
        if (!trans) {
            auto row = static_cast<const uint16_t*>(emu::x_ptr[w][8 * i + (l >> 2)]);
            lo = row[2 * (l & 3)]; hi = row[2 * (l & 3) + 1];
        } else {
            auto r0 = static_cast<const uint16_t*>(emu::x_ptr[w][8 * i + 2 * (l & 3)]);
            auto r1 = static_cast<const uint16_t*>(emu::x_ptr[w][8 * i + 2 * (l & 3) + 1]);
            lo = r0[l >> 2]; hi = r1[l >> 2];
        }
        r[i] = lo | (uint32_t(hi) << 16);
    }
    if (l == 0) {  // bank check: each matrix's 8 rows must cover 32 distinct banks
        emu::ldmatrix_calls++;
        for (int i = 0; i < 4; ++i) {
            bool used[32] = {};
            for (int rr = 0; rr < 8; ++rr) {
                const uintptr_t a = reinterpret_cast<uintptr_t>(emu::x_ptr[w][8 * i + rr]);
                for (int q = 0; q < 4; ++q) {
                    const int bank = ((a >> 2) + q) & 31;
                    if (used[bank]) emu::bank_conflicts++;
                    used[bank] = true;
                }
            }
        }
    }
    emu::wsync();
}
inline void ldmatrix_x4(uint32_t r[4], const void* p) { ldm(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t r[4], const void* p) { ldm(r, p, true); }
inline void mma_bf16_16816(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    const int w = emu::warp(), l = emu::lane();
    for (int i = 0; i < 4; ++i) emu::x_u[w][l][i] = a[i];
    emu::x_u[w][l][4] = b0; emu::x_u[w][l][5] = b1;
    emu::wsync();
    float A[16][16], Bm[16][8];
    for (int ln = 0; ln < 32; ++ln) {
        const int g = ln >> 2, t = ln & 3;
        auto lo = [](uint32_t x) { return bf2f(x & 0xffff); };
        auto hi = [](uint32_t x) { return bf2f(x >> 16); };
        const uint32_t* u = emu::x_u[w][ln];
        A[g][2 * t] = lo(u[0]); A[g][2 * t + 1] = hi(u[0]);
        A[g + 8][2 * t] = lo(u[1]); A[g + 8][2 * t + 1] = hi(u[1]);
        A[g][2 * t + 8] = lo(u[2]); A[g][2 * t + 9] = hi(u[2]);
        A[g + 8][2 * t + 8] = lo(u[3]); A[g + 8][2 * t + 9] = hi(u[3]);
        Bm[2 * t][g] = lo(u[4]); Bm[2 * t + 1][g] = hi(u[4]);
        Bm[2 * t + 8][g] = lo(u[5]); Bm[2 * t + 9][g] = hi(u[5]);
    }
    emu::wsync();
    const int g = l >> 2, t = l & 3;
    for (int e = 0; e < 4; ++e) {
        const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
        float acc = d[e];
        for (int kk = 0; kk < 16; ++kk) acc += A[row][kk] * Bm[kk][col];
        d[e] = acc;
    }
}
// A 16-byte global store: a misaligned address aborts, as the card faults.
inline void st_global_f4(float* p, const float4& v) {
    if (reinterpret_cast<uintptr_t>(p) % 16) { fprintf(stderr, "st.global.v4 misaligned\n"); abort(); }
    std::memcpy(p, &v, 16);
}
inline uint32_t cluster_rank() { return static_cast<uint32_t>(emu::cur->cta); }
// The cluster barrier in halves: a thread's wait returns once every thread
// of the cluster has arrived for the phase of its own last arrive.
inline void cluster_arrive_relaxed() {
    emu::cur->cluster_target = emu::cluster_phase + 1;
    if (++emu::cluster_arrived == static_cast<int>(emu::threads.size())) {
        emu::cluster_arrived = 0;
        ++emu::cluster_phase;
        for (auto& th : emu::threads)
            if (th.on_cluster && th.cluster_target <= emu::cluster_phase)
                th.on_cluster = th.waiting = false;
    }
}
inline void cluster_wait() {
    if (emu::cluster_phase >= emu::cur->cluster_target) return;
    emu::cur->on_cluster = emu::cur->waiting = true;
    while (emu::cur->waiting) swapcontext(&emu::cur->ctx, &emu::scheduler);
}
inline void cluster_sync() {
    cluster_arrive_relaxed();
    cluster_wait();
}
inline float4 ld_shared_cluster_f4(const void* p, uint32_t rank) {
    emu::check_smem(p, 16);
    const size_t off = static_cast<const unsigned char*>(p) - emu::cta_smem();
    if (rank * blockDim.x >= emu::threads.size() || off % 16) {
        fprintf(stderr, "bad distributed shared memory read\n");
        abort();
    }
    float4 v;
    std::memcpy(&v, emu::smem_buf[rank] + off, 16);
    return v;
}
// Distributed shared memory stores: the same offset in CTA `rank`'s memory.
inline unsigned char* remote_smem(void* p, uint32_t rank, size_t n) {
    emu::check_smem(p, n);
    const size_t off = static_cast<unsigned char*>(p) - emu::cta_smem();
    if (rank * blockDim.x >= emu::threads.size() || off % n) {
        fprintf(stderr, "bad distributed shared memory write\n");
        abort();
    }
    bool exited = true;  // a CTA's shared memory ends with its last thread
    for (unsigned t = 0; t < blockDim.x; ++t) exited = exited && emu::threads[rank * blockDim.x + t].done;
    if (exited) {
        fprintf(stderr, "distributed shared memory write to an exited CTA\n");
        abort();
    }
    return emu::smem_buf[rank] + off;
}
inline void st_shared_cluster_f32(void* p, uint32_t rank, float v) {
    std::memcpy(remote_smem(p, rank, 4), &v, 4);
}
inline void st_shared_cluster_f2(void* p, uint32_t rank, float2 v) {
    std::memcpy(remote_smem(p, rank, 8), &v, 8);
}
// mbarriers and bulk copies: a copy is held on its barrier and lands when a
// thread waits on that barrier (or at once, with emu::eager_copies); a phase
// completes when its arrivals are in and its expected bytes have landed, and
// wakes the threads blocked on it. A wait that can never complete aborts as a
// deadlock.
inline void mbar_init(uint64_t* bar, uint32_t count) {
    emu::check_smem(bar, 8);
    emu::MBar& b = emu::mbars[bar];
    b = emu::MBar{};
    b.count = b.pending = static_cast<int>(count);
}
inline void fence_mbar_init() {}
inline void mbar_arrive(uint64_t* bar) {
    emu::MBar& b = emu::mbar(bar);
    if (--b.pending < 0) { fprintf(stderr, "mbarrier: too many arrivals\n"); abort(); }
    emu::mbar_advance(b);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    emu::MBar& b = emu::mbar(bar);
    b.tx += bytes;
    if (--b.pending < 0) { fprintf(stderr, "mbarrier: too many arrivals\n"); abort(); }
    emu::mbar_advance(b);
}
inline void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    emu::check_smem(dst, bytes);
    if (bytes % 16 || reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) {
        fprintf(stderr, "bulk copy misaligned\n"); abort();
    }
    emu::check_global(src, bytes);
    emu::MBar& b = emu::mbar(bar);
    b.copies.push_back({dst, src, bytes});
    if (emu::eager_copies || !b.waiters.empty()) emu::mbar_land(b);  // a waiter would land it
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
    emu::MBar& b = emu::mbar(bar);
    emu::mbar_land(b);
    if ((b.completed & 1u) != parity) return;
    emu::cur->waiting = true;  // until a completed phase wakes it
    b.waiters.emplace_back(emu::cur, parity);
    while (emu::cur->waiting) swapcontext(&emu::cur->ctx, &emu::scheduler);
}
inline float exp2_approx(float x) { return exp2f(x); }
inline uint32_t pack_bf16x2(float lo, float hi) {
    return f2bf(lo) | (uint32_t(f2bf(hi)) << 16);
}
}  // namespace wl

// A launch of clusters of `cluster` CTAs; kernel<<<grid, block, smem,
// stream>>>(args...) is rewritten to emu_launch, a launch of one-CTA
// clusters.
template <class K, class... A>
void emu_launch_clusters(K kernel, dim3 grid, dim3 block, size_t smem, dim3 cluster, A... args) {
    const unsigned per_cluster = cluster.x * cluster.y * cluster.z;
    if (smem > emu::kSmemPerCta || block.x % 32 || block.x * per_cluster > 32 * emu::kMaxWarps ||
        per_cluster > emu::kMaxCtas || grid.x % cluster.x || grid.y % cluster.y ||
        grid.z % cluster.z) {
        fprintf(stderr, "launch refused\n");
        abort();
    }
    emu::smem_size = smem;
    blockDim = {block.x, 1, 1};
    gridDim = {grid.x, grid.y, grid.z};
    emu::body = [&] { kernel(args...); };
    const unsigned gx = grid.x / cluster.x, gy = grid.y / cluster.y;
    const unsigned n_clusters = gx * gy * (grid.z / cluster.z);
    for (unsigned i = 0; i < n_clusters; ++i) {
        const unsigned c = emu::reverse_ctas ? n_clusters - 1 - i : i;
        const uint3e origin{c % gx * cluster.x, c / gx % gy * cluster.y, c / (gx * gy) * cluster.z};
        emu::threads.clear();
        emu::threads.resize(per_cluster * block.x);
        emu::cluster_arrived = emu::cluster_phase = 0;
        std::memset(emu::named_arrived, 0, sizeof emu::named_arrived);
        for (unsigned r = 0; r < per_cluster; ++r) {
            std::memset(emu::smem_buf[r], 0xff, smem);  // bf16 NaN everywhere
            const uint3e b{origin.x + r % cluster.x, origin.y + r / cluster.x % cluster.y,
                           origin.z + r / (cluster.x * cluster.y)};
            for (unsigned t = 0; t < block.x; ++t) {
                emu::Thread& th = emu::threads[r * block.x + t];
                th.idx = {t, 0, 0};
                th.block = b;
                th.cta = static_cast<int>(r);
                th.stack.reset(new char[emu::kStack]);
                getcontext(&th.ctx);
                th.ctx.uc_stack.ss_sp = th.stack.get();
                th.ctx.uc_stack.ss_size = emu::kStack;
                th.ctx.uc_link = nullptr;
                makecontext(&th.ctx, emu::trampoline, 0);
            }
        }
        emu::run_cluster();
        for (auto& [bar, b] : emu::mbars)
            if (!b.copies.empty()) { fprintf(stderr, "bulk copies pending at exit\n"); abort(); }
        emu::mbars.clear();
        for (auto& th : emu::threads) {
            for (auto& g : th.groups)
                if (!g.empty()) { fprintf(stderr, "copies pending at exit\n"); abort(); }
            if (!th.open_group.empty()) { fprintf(stderr, "uncommitted copies\n"); abort(); }
        }
    }
}

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
    emu_launch_clusters(kernel, grid, block, smem, dim3(1, 1, 1), args...);
}

template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config, void (*kernel)(P...),
                               A... args) {
    dim3 cluster(1, 1, 1);
    for (unsigned i = 0; i < config->numAttrs; ++i)
        if (config->attrs[i].id == cudaLaunchAttributeClusterDimension) {
            const auto& d = config->attrs[i].val.clusterDim;
            cluster = dim3(d.x, d.y, d.z);
        }
    emu_launch_clusters(kernel, config->gridDim, config->blockDim, config->dynamicSmemBytes,
                        cluster, static_cast<P>(args)...);
    return cudaSuccess;
}
