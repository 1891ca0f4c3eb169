// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel file exposes one extern "C" launcher that takes raw device
// pointers, sizes and the caller's CUDA stream, launches without
// synchronising, and returns cudaGetLastError() so the Python wrapper
// (whisperlive_tpu_torch/ops/_kernels.py) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace wl {

// The TPU kernels mask with float32's most negative finite value, not -inf
// (whisperlive_tpu/ops/attention.py NEG_INF): a row whose every position
// is masked then gives a uniform softmax instead of NaN.
constexpr float kNegInf = -FLT_MAX;

// 16 signed int8 values packed in one 16-byte load -> 16 floats.
__device__ __forceinline__ void unpack_i8x16(const uint4& w, float f[16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            f[i * 4 + j] = static_cast<float>(
                static_cast<int8_t>((words[i] >> (8 * j)) & 0xffu));
        }
    }
}

// 8 bf16 values packed in one 16-byte load -> 8 floats.
__device__ __forceinline__ void unpack_bf16x8(const uint4& a, float f[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(h[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// Reductions over the quad of lanes (lane ^ 1, lane ^ 2) that share a row
// of an mma.sync accumulator.
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- Tensor-core and asynchronous-copy primitives (PTX, sm_80 and up) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1. With `valid` false the
// source is not read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] of lane l holds row l/4, columns
// 2(l%4) and 2(l%4)+1 of matrix i (with .trans: column l/4, rows 2(l%4)
// and 2(l%4)+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate. With g = lane / 4
// and t = lane % 4: a holds rows g, g + 8 x columns 2t, 2t + 1 (a[0],
// a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); b0, b1 hold rows 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g; d[0], d[1] are row g and d[2], d[3] row g + 8,
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16-byte store to global memory; `p` must be 16-byte aligned.
__device__ __forceinline__ void st_global_f4(float* p, const float4& v) {
    *reinterpret_cast<float4*>(p) = v;
}

// ---- Bulk copies and transaction barriers (sm_90) ----

// An mbarrier in shared memory whose phase completes after `count` arrivals
// and every transaction byte expected in it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// Makes initialised mbarriers visible to the copy engine; a __syncthreads
// after it makes them visible to the other threads.
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` more transaction bytes this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` (the barrier's uses counted from
// 0, modulo 2) has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "wait:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra wait;\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the copy engine, counted on `bar` as transaction bytes.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) of the first `count` threads to
// arrive at it, a multiple of 32: a barrier of some of a CTA's warps.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---- Thread-block clusters (sm_90) ----

// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// Barrier of every thread of every CTA in the cluster: shared-memory
// writes before it are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of a cluster barrier with nothing ordered by it: arrive
// early and wait late, so that the barrier's latency hides behind the work
// between. Arrive and wait alternate in every thread. Its use: every CTA
// of the cluster has started, so its shared memory may be written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Store to the address `p` has in this CTA's shared memory, in the shared
// memory of the cluster's CTA `rank`; visible there after a cluster_sync.
__device__ __forceinline__ void st_shared_cluster_f32(void* p, uint32_t rank, float v) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(remote), "f"(v) : "memory");
}

__device__ __forceinline__ void st_shared_cluster_f2(void* p, uint32_t rank, float2 v) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
                 :: "r"(remote), "f"(v.x), "f"(v.y) : "memory");
}

// 16 bytes at the address `p` has in this CTA's shared memory, read from
// the shared memory of the cluster's CTA `rank` (distributed shared memory).
__device__ __forceinline__ float4 ld_shared_cluster_f4(const void* p, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote) : "memory");
    return v;
}

// 2^x on the special-function unit with subnormal results flushed to zero
// (ex2.approx.ftz.f32, what exp2f becomes under --use_fast_math; exp2f
// itself adds a range check and two multiplies around it). 2 ulp.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Two floats -> one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace wl
