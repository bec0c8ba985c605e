// Device code shared by the cluster-per-ion moments kernels
// (csrc/moments.cu and csrc/fused_moments.cu), hand-written for Hopper
// (sm_90a).
//
// One ion is one thread-block cluster of S CTAs (S in 1, 2, 4, 8, 16).  CTA
// `rank` of the cluster takes the contiguous pixel slice [rank * slice,
// min((rank + 1) * slice, P)) of all K rows; the slices tile [0, P) exactly
// once.  In the resident regime the CTA keeps its slice in its shared memory,
// so the cluster holds the ion's whole block; in the streaming regime the
// block is too large for that and the CTA reads its slice from global memory
// on each pass.  After each pass the CTAs combine their partials over DSMEM
// (distributed shared memory), in rank order 0..S-1:
//  - sums, max and counts: each CTA writes its partials into slot `rank` of
//    every peer's shared memory, one cluster barrier, and every CTA totals
//    its slots in rank order, so every CTA computes the same f64 totals and
//    the same f32 means;
//  - centered norms and dots: each CTA writes its partials into slot `rank`
//    of rank 0 and arrives on the cluster barrier; only rank 0 waits, totals
//    them in rank order and writes the ion's row.
// Partials are pushed, never pulled: after the first barrier no CTA reads
// another's shared memory, so the other ranks may exit as soon as they have
// arrived (a cluster barrier waits for the threads that have not exited),
// and one barrier wait per ion is all a CTA other than rank 0 pays.  The
// first push waits on the barrier phase every CTA arrived at when it
// started, so no CTA writes into a peer that is not running yet.
//
// The plan (S, slice length, regime, dynamic shared bytes) is computed on the
// host by ops/moments.py::moments_plan; `mc_smem_bytes` below is the layout
// that plan mirrors.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

#define MC_THREADS 256
#define MC_WARPS (MC_THREADS / 32)
#define MC_K_MAX 8
#define MC_CLUSTER_MAX 16
// the resident slice is copied in this many stages, one mbarrier each
#define MC_STAGES 8
#define MC_BARRIER_BYTES (MC_STAGES * 8)
// returned by the C entry points when the occupancy API reports that no
// cluster of the planned shape fits on the device
#define MC_CLUSTER_UNSCHEDULABLE (-1)

// Floats of one row of the resident slice: padded to 16 bytes, so every row
// of the shared-memory slice starts 16-byte aligned.
__host__ __device__ inline int mc_row_floats(int slice) { return (slice + 3) & ~3; }

// Dynamic shared memory of one CTA: the stage barriers, then the K rows of
// the slice (resident); nothing (streaming).
__host__ __device__ inline long long mc_smem_bytes(int k, int slice, int resident) {
    return resident ? MC_BARRIER_BYTES + 4LL * k * mc_row_floats(slice) : 0;
}

// Static shared memory of a CTA: reduction scratch, its block totals, the
// slots its peers push their partials into (by rank), the cluster's totals.
struct McScratch {
    double wsum[MC_K_MAX][MC_WARPS];
    float wmax[MC_K_MAX][MC_WARPS];
    int wcnt[MC_K_MAX][MC_WARPS];
    double s[MC_K_MAX], ns[MC_K_MAX], dt[MC_K_MAX];
    float vmax[MC_K_MAX];
    int nn[MC_K_MAX];
    double ps[MC_CLUSTER_MAX][MC_K_MAX], pns[MC_CLUSTER_MAX][MC_K_MAX],
        pdt[MC_CLUSTER_MAX][MC_K_MAX];
    float pmax[MC_CLUSTER_MAX][MC_K_MAX];
    int pcnt[MC_CLUSTER_MAX][MC_K_MAX];
    double tot_s[MC_K_MAX];
    float mean[MC_K_MAX], tot_max[MC_K_MAX];
    int tot_cnt[MC_K_MAX];
};

// The cluster barrier split into its halves (PTX barrier.cluster): every
// thread of every CTA arrives; a wait returns once every thread of the
// cluster that has not exited has arrived.
__device__ __forceinline__ void mc_cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mc_cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mc_cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// First thing a cluster kernel does: arrive (relaxed) on the barrier phase
// that mc_cluster_totals waits on before it writes into the peers.
__device__ __forceinline__ void mc_cluster_start() { mc_cluster_arrive_relaxed(); }

// ---------------------------------------------------------------- reductions
__device__ __forceinline__ double mc_warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float mc_warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int mc_warp_isum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Block sums of v[0..K) into dst[0..K) (shared); thread r adds the warps'
// partials of row r in warp order.  Ends with a barrier.
template <int K>
__device__ __forceinline__ void mc_block_sum(const double (&v)[K], double* dst, McScratch& sc) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < K; ++r) {
        const double t = mc_warp_sum(v[r]);
        if (lane == 0) sc.wsum[r][warp] = t;
    }
    __syncthreads();
    if (threadIdx.x < K) {
        double t = 0.0;
#pragma unroll
        for (int w = 0; w < MC_WARPS; ++w) t = __dadd_rn(t, sc.wsum[threadIdx.x][w]);
        dst[threadIdx.x] = t;
    }
    __syncthreads();
}

// Block max and positive count of the first M rows into sc.vmax / sc.nn.
// Ends with a barrier.
template <int M>
__device__ __forceinline__ void mc_block_maxcnt(const float (&m)[M], const int (&c)[M], McScratch& sc) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < M; ++r) {
        const float wm = mc_warp_max(m[r]);
        const int wc = mc_warp_isum(c[r]);
        if (lane == 0) { sc.wmax[r][warp] = wm; sc.wcnt[r][warp] = wc; }
    }
    __syncthreads();
    if (threadIdx.x < M) {
        float t = -INFINITY;
        int n = 0;
#pragma unroll
        for (int w = 0; w < MC_WARPS; ++w) {
            t = fmaxf(t, sc.wmax[threadIdx.x][w]);
            n += sc.wcnt[threadIdx.x][w];
        }
        sc.vmax[threadIdx.x] = t;
        sc.nn[threadIdx.x] = n;
    }
    __syncthreads();
}

// First cluster reduction.  Waits until every CTA of the cluster runs, then
// thread q < S writes this CTA's block sums (K rows) and max/count (first M
// rows) into slot `rank` of peer q; after one cluster barrier, every CTA
// totals its slots in rank order: sc.tot_s, sc.tot_max, sc.tot_cnt, and
// sc.mean = f32(total) / fn, one IEEE division, the same bits in every CTA.
template <int K, int M>
__device__ __forceinline__ void mc_cluster_totals(cg::cluster_group& cluster, McScratch& sc, float fn) {
    const int n_cta = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    mc_cluster_wait();                     // the start phase: every peer runs
    if ((int)threadIdx.x < n_cta) {
        McScratch* peer = cluster.map_shared_rank(&sc, threadIdx.x);
#pragma unroll
        for (int r = 0; r < K; ++r) peer->ps[rank][r] = sc.s[r];
#pragma unroll
        for (int r = 0; r < M; ++r) { peer->pmax[rank][r] = sc.vmax[r]; peer->pcnt[rank][r] = sc.nn[r]; }
    }
    cluster.sync();                        // every peer's partials have landed here
    if (threadIdx.x < K) {
        const int r = threadIdx.x;
        double t = 0.0;
        float m = -INFINITY;
        int c = 0;
        for (int q = 0; q < n_cta; ++q) {
            t = __dadd_rn(t, sc.ps[q][r]);
            if (r < M) { m = fmaxf(m, sc.pmax[q][r]); c += sc.pcnt[q][r]; }
        }
        sc.tot_s[r] = t;
        sc.mean[r] = __fdiv_rn(__double2float_rn(t), fn);
        if (r < M) { sc.tot_max[r] = m; sc.tot_cnt[r] = c; }
    }
    __syncthreads();
}

// Second cluster reduction: thread r < K writes this CTA's centered norm and
// dot of row r (sc.ns, sc.dt) into slot `rank` of rank 0, and every thread
// arrives on the cluster barrier.  Returns false on every CTA but rank 0,
// which may then exit; rank 0 waits until every push has landed and returns
// true: thread r < K then totals row r's slots (sc.pns, sc.pdt) in rank
// order with mc_rank_total.
template <int K>
__device__ __forceinline__ bool mc_cluster_push_centered(cg::cluster_group& cluster, McScratch& sc) {
    const int rank = (int)cluster.block_rank();
    if (threadIdx.x < K) {
        McScratch* root = cluster.map_shared_rank(&sc, 0u);
        root->pns[rank][threadIdx.x] = sc.ns[threadIdx.x];
        root->pdt[rank][threadIdx.x] = sc.dt[threadIdx.x];
    }
    mc_cluster_arrive();
    if (rank != 0) return false;
    mc_cluster_wait();
    return true;
}

__device__ __forceinline__ double mc_rank_total(const double (*g)[MC_K_MAX], int n_cta, int r) {
    double t = 0.0;
    for (int q = 0; q < n_cta; ++q) t = __dadd_rn(t, g[q][r]);
    return t;
}

// ------------------------------------------- bulk copies (1-D TMA), mbarriers
__device__ __forceinline__ uint32_t mc_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mc_mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mc_smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mc_fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mc_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mc_smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to this CTA's shared memory; completes on `bar`.
__device__ __forceinline__ void mc_bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            mc_smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(mc_smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void mc_mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = mc_smem_addr(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}

// ---------------------------------------------------------------- host side
__host__ inline bool mc_valid_cluster(int s) {
    return s == 1 || s == 2 || s == 4 || s == 8 || s == 16;
}

// The plan's slices tile [0, p) exactly once with no empty slice.
__host__ inline bool mc_valid_slices(int p, int cluster, int slice) {
    return slice > 0 && (long long)cluster * slice >= p && (long long)(cluster - 1) * slice < p;
}

// The launch set-up of one kernel on one device, made once: its dynamic
// shared-memory limit raised to all the device allows a block beside the
// kernel's static shared memory, and, the first time a plan needs a cluster of
// more than 8 CTAs, non-portable cluster sizes allowed.  The attributes are
// the function's, shared by every host thread, so they are never set per
// launch: two threads launching one kernel with plans of different shared
// memory would otherwise set the limit under each other's launch.  Each launch
// passes its own dynamicSmemBytes instead.  One mutex guards the table;
// entries never move.  `limit` gets the kernel's dynamic shared-memory limit.
#define MC_SETUP_SLOTS 256

struct McSetup {
    const void* fn;
    int dev;
    int limit;
    bool nonportable;
};

__host__ inline cudaError_t mc_setup(const void* fn, int cluster, int* limit) {
    static std::mutex mu;
    static McSetup table[MC_SETUP_SLOTS];
    static int used = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    McSetup* e = nullptr;
    for (int i = 0; i < used && e == nullptr; ++i)
        if (table[i].fn == fn && table[i].dev == dev) e = &table[i];
    if (e == nullptr) {
        if (used == MC_SETUP_SLOTS) return cudaErrorInvalidValue;
        int optin = 0;
        cudaFuncAttributes fa = {};
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
        const int lim = optin - (int)fa.sharedSizeBytes;
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
        if (err != cudaSuccess) return err;
        e = &table[used++];
        *e = {fn, dev, lim, false};
    }
    if (cluster > 8 && !e->nonportable) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        e->nonportable = true;
    }
    *limit = e->limit;
    return cudaSuccess;
}

// The launch set-up (mc_setup) of one kernel instance on the current device,
// with no launch (what a library's set-up entry point makes ahead of
// traffic).
template <typename... Params>
__host__ inline cudaError_t mc_setup_kernel(void (*kernel)(Params...)) {
    int limit = 0;
    return mc_setup((const void*)kernel, 1, &limit);
}

// Make the kernel's launch set-up (once per device, mc_setup) and fill `cfg`
// for a launch over n_ions clusters of `cluster` CTAs with `smem` bytes of
// dynamic shared memory each.
__host__ inline cudaError_t mc_config(const void* fn, int n_ions, int cluster, int smem,
                                      cudaStream_t stream, cudaLaunchConfig_t& cfg,
                                      cudaLaunchAttribute* attr) {
    int limit = 0;
    cudaError_t err = mc_setup(fn, cluster, &limit);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    if (smem < 0 || smem > limit) return cudaErrorInvalidValue;
    cfg = {};
    cfg.gridDim = dim3((unsigned)n_ions * (unsigned)cluster, 1, 1);
    cfg.blockDim = dim3(MC_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
}

// Clusters of this shape the device holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
template <typename... Params>
__host__ int mc_active_clusters(void (*kernel)(Params...), int cluster, int smem) {
    const void* fn = (const void*)kernel;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = mc_config(fn, 1, cluster, smem, 0, cfg, attr);
    int active = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return -(int)err;
    }
    return active;
}

// Launch `kernel` over n_ions clusters of `cluster` CTAs.  Returns
// MC_CLUSTER_UNSCHEDULABLE when the occupancy API says no such cluster fits,
// else cudaGetLastError() after the launch (0 on success).
template <typename... Params, typename... Args>
__host__ int mc_launch(void (*kernel)(Params...), int n_ions, int cluster, int smem,
                       cudaStream_t stream, Args... args) {
    const int active = mc_active_clusters(kernel, cluster, smem);
    if (active < 0) return -active;
    if (active < 1) return MC_CLUSTER_UNSCHEDULABLE;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = mc_config((const void*)kernel, n_ions, cluster, smem, stream, cfg, attr);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
