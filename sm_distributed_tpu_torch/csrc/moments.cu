// Per-ion image moments for the MSM metrics, hand-written for Hopper (sm_90a).
//
// Replaces: sm_distributed_tpu/ops/moments_pallas.py::_moments_kernel_masked
// (batch_moments_pallas_masked, masked=1) and ::_moments_kernel
// (batch_moments_pallas, masked=0) — one kernel, the mask is a flag.
//
// Computes, for each ion i of an (N, K, P) f32 image block:
//   out[i, r, 0] = sum_p x[r, p]                         (pixel sum)
//   out[i, r, 1] = sum_p c[r, p]^2                       (centered norm^2)
//   out[i, r, 2] = sum_p c[0, p] * c[r, p]               (centered dot vs row 0)
//   out[i, r, 3] = max_p x[0, p]                         (row-0 max, every r)
//   out[i, r, 4] = #{p : x[0, p] > 0}                    (row-0 positives)
// with mean[r] = sum[r] / n (n = n_real when masked, else P; one IEEE
// division) and c[r, p] = x[r, p] - mean[r] for p < n, 0 past it.
//
// Bound on the H100: bytes.  The arithmetic is ~6 flops per element against
// 4 bytes read, far below what the card needs before compute limits it, so
// the floor is one read of N*K*P*4 bytes at 3.35 TB/s (0.64 ms at (2048, 4,
// 65536)).
//
// Design: one thread-block cluster per ion (csrc/moments_cluster.cuh).  The
// exact two-pass centered formula needs the ion's mean before any centered
// term, so a kernel that streams the block twice moves it through HBM twice;
// the TPU kernel avoids that by holding the ion's block in VMEM.  One SM's
// shared memory (232,448 B a block) cannot hold an ion's block (1 MiB on the
// main path), but a cluster can: S CTAs on neighbouring SMs, each holding a
// contiguous pixel slice of all K rows.
//
// - Resident regime (K * slice * 4 B fits a CTA; the main path's S = 16
//   slices of 4096 pixels are 64 KiB, three CTAs to an SM).  Pass 1 copies
//   the slice into shared memory with cp.async.bulk (1-D TMA) in
//   MC_STAGES stages, each completing on its own mbarrier, all issued at
//   once by one thread; the CTA reduces each stage's sums, row-0 max and
//   positive count as it lands.  Where the bulk copy's 16-byte rules do not
//   hold (P % 4 != 0, a misaligned base: `vec` = 0), threads copy with
//   4-byte loads and stores instead.  The cluster combines the sums over
//   DSMEM, pass 2 runs from shared memory, a second DSMEM reduction gives
//   the norms and dots, and rank 0 writes the (K, 5) row.  The partials are
//   pushed into the peers' shared memory, so a CTA other than rank 0 waits
//   on one cluster barrier and exits after its second push: per-ion
//   barrier latency, hidden only by the other clusters resident on the
//   SMs, is what this regime spends besides the copy.  The block crosses
//   HBM once.
// - Streaming regime (the whole-slide block: 16 MiB an ion, more than 16
//   CTAs' shared memory can hold, 3.6 MB).  The same cluster split with
//   S = 16 (4096 CTAs for 256 ions, the whole card busy); each CTA reads
//   its slice from global memory on both passes, pass 2 walking it
//   backwards so that its first loads find what pass 1 read last in L2.
//   This regime reads the block twice: the means need the whole ion's sum
//   before any centered term, a cluster has at most 16 CTAs, and keeping
//   one read would take either a grid-wide barrier per ion or the one-pass
//   raw-moment identity sum(x^2) - n*mean^2, which cancels catastrophically
//   on integer-grid values up to 2^24 and is not used.
//
// Numerics: the mean is
// __fdiv_rn(f32(total), n); the centered values and their products are f32
// and round once each (__fsub_rn / __fmul_rn keep nvcc from contracting
// them into FMAs); all sums accumulate in f64 (per thread, then warps, then
// the cluster's CTAs in rank order) and round to f32 once.  The mask tests
// the global pixel index slice_start + j against n.  Row-0 max and positive
// count are reduced over the cluster too.

#include "moments_cluster.cuh"

template <int K, bool RESIDENT>
__global__ void __launch_bounds__(MC_THREADS, 3)
moments_cluster_kernel(const float* img, float* out, int p, int n, int slice, int vec) {
    __shared__ McScratch sc;
    extern __shared__ __align__(16) unsigned char dyn[];
    cg::cluster_group cluster = cg::this_cluster();
    mc_cluster_start();
    const int n_cta = (int)cluster.num_blocks();
    const int ion = blockIdx.x / n_cta;
    const int a = (int)cluster.block_rank() * slice;        // the slice's first pixel
    const int len = max(0, min(slice, p - a));
    const float* base = img + (size_t)ion * K * p + a;      // row r at base + r * p
    const int row = mc_row_floats(slice);
    uint64_t* bar = reinterpret_cast<uint64_t*>(dyn);
    float* data = reinterpret_cast<float*>(dyn + MC_BARRIER_BYTES);   // row r at data + r * row

    // ---- pass 1: sums, row-0 max and positive count --------------------
    double s[K];
#pragma unroll
    for (int r = 0; r < K; ++r) s[r] = 0.0;
    float vmax[1] = {-INFINITY};
    int nn[1] = {0};
    auto take4 = [&](int r, const float4 v) {
        s[r] = __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(s[r], v.x), v.y), v.z), v.w);
        if (r == 0) {
            vmax[0] = fmaxf(vmax[0], fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
            nn[0] += (v.x > 0.0f) + (v.y > 0.0f) + (v.z > 0.0f) + (v.w > 0.0f);
        }
    };
    auto take1 = [&](int r, const float v) {
        s[r] = __dadd_rn(s[r], v);
        if (r == 0) { vmax[0] = fmaxf(vmax[0], v); nn[0] += (v > 0.0f); }
    };
    if (RESIDENT && vec) {
        // stage pixels: a multiple of 4, at least one float4 a thread
        const int ch = max(mc_row_floats((slice + MC_STAGES - 1) / MC_STAGES), 4 * MC_THREADS);
        const int n_st = (len + ch - 1) / ch;
        if (threadIdx.x == 0) {
            for (int st = 0; st < n_st; ++st) mc_mbar_init(&bar[st], 1);
            mc_fence_mbar_init();
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int st = 0; st < n_st; ++st) {
                const int c0 = st * ch, cl = min(ch, len - c0);
                mc_mbar_expect_tx(&bar[st], (uint32_t)(K * cl * 4));
#pragma unroll
                for (int r = 0; r < K; ++r)
                    mc_bulk_g2s(data + r * row + c0, base + (size_t)r * p + c0, (uint32_t)(cl * 4),
                                &bar[st]);
            }
        }
        for (int st = 0; st < n_st; ++st) {
            const int c0 = st * ch, cl = min(ch, len - c0);
            mc_mbar_wait(&bar[st], 0);
            for (int j = (c0 >> 2) + threadIdx.x; j < ((c0 + cl) >> 2); j += MC_THREADS) {
#pragma unroll
                for (int r = 0; r < K; ++r)
                    take4(r, reinterpret_cast<const float4*>(data + r * row)[j]);
            }
        }
    } else if (vec) {
        const int len4 = len >> 2;
#pragma unroll 2
        for (int j = threadIdx.x; j < len4; j += MC_THREADS) {
            float4 v[K];
#pragma unroll
            for (int r = 0; r < K; ++r) v[r] = __ldg(reinterpret_cast<const float4*>(base + (size_t)r * p) + j);
#pragma unroll
            for (int r = 0; r < K; ++r) take4(r, v[r]);
        }
    } else {
        for (int j = threadIdx.x; j < len; j += MC_THREADS) {
#pragma unroll
            for (int r = 0; r < K; ++r) {
                const float v = __ldg(base + (size_t)r * p + j);
                if (RESIDENT) data[r * row + j] = v;
                take1(r, v);
            }
        }
    }
    mc_block_sum<K>(s, sc.s, sc);
    mc_block_maxcnt<1>(vmax, nn, sc);
    mc_cluster_totals<K, 1>(cluster, sc, (float)n);

    float mean[K];
#pragma unroll
    for (int r = 0; r < K; ++r) mean[r] = sc.mean[r];

    // ---- pass 2: centered norms and dots vs row 0 ----------------------
    double ns[K], dt[K];
#pragma unroll
    for (int r = 0; r < K; ++r) { ns[r] = 0.0; dt[r] = 0.0; }
    const int lim = n - a;                 // slice-local bound of the real pixels
    if (vec) {
        const int len4 = len >> 2;
        // resident: from shared memory; streaming: from global, backwards
        const int j0 = RESIDENT ? (int)threadIdx.x : len4 - 1 - (int)threadIdx.x;
        const int dj = RESIDENT ? MC_THREADS : -MC_THREADS;
        for (int j = j0; RESIDENT ? j < len4 : j >= 0; j += dj) {
            float c[K][4];
#pragma unroll
            for (int r = 0; r < K; ++r) {
                const float4 v = RESIDENT
                    ? reinterpret_cast<const float4*>(data + r * row)[j]
                    : __ldg(reinterpret_cast<const float4*>(base + (size_t)r * p) + j);
                const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    c[r][t] = (4 * j + t < lim) ? __fsub_rn(xs[t], mean[r]) : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < K; ++r) {
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    ns[r] = __dadd_rn(ns[r], (double)__fmul_rn(c[r][t], c[r][t]));
                    dt[r] = __dadd_rn(dt[r], (double)__fmul_rn(c[0][t], c[r][t]));
                }
            }
        }
    } else {
        const int j0 = RESIDENT ? (int)threadIdx.x : len - 1 - (int)threadIdx.x;
        const int dj = RESIDENT ? MC_THREADS : -MC_THREADS;
        for (int j = j0; RESIDENT ? j < len : j >= 0; j += dj) {
            const bool in = j < lim;
            float c[K];
#pragma unroll
            for (int r = 0; r < K; ++r) {
                const float v = RESIDENT ? data[r * row + j] : __ldg(base + (size_t)r * p + j);
                c[r] = in ? __fsub_rn(v, mean[r]) : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < K; ++r) {
                ns[r] = __dadd_rn(ns[r], (double)__fmul_rn(c[r], c[r]));
                dt[r] = __dadd_rn(dt[r], (double)__fmul_rn(c[0], c[r]));
            }
        }
    }
    mc_block_sum<K>(ns, sc.ns, sc);
    mc_block_sum<K>(dt, sc.dt, sc);

    if (mc_cluster_push_centered<K>(cluster, sc) && threadIdx.x < K) {
        const int r = threadIdx.x;
        float* o = out + ((size_t)ion * K + r) * 5;
        o[0] = __double2float_rn(sc.tot_s[r]);
        o[1] = __double2float_rn(mc_rank_total(sc.pns, n_cta, r));
        o[2] = __double2float_rn(mc_rank_total(sc.pdt, n_cta, r));
        o[3] = sc.tot_max[0];
        o[4] = (float)sc.tot_cnt[0];
    }
}

template <bool RESIDENT>
static int active_clusters(int k, int cluster, int smem) {
    switch (k) {
#define ACTIVE_CASE(KK) \
    case KK: return mc_active_clusters(moments_cluster_kernel<KK, RESIDENT>, cluster, smem);
        ACTIVE_CASE(1) ACTIVE_CASE(2) ACTIVE_CASE(3) ACTIVE_CASE(4)
        ACTIVE_CASE(5) ACTIVE_CASE(6) ACTIVE_CASE(7) ACTIVE_CASE(8)
#undef ACTIVE_CASE
    }
    return -(int)cudaErrorInvalidValue;
}

template <bool RESIDENT>
static int launch(int k, const float* img, float* out, int n, int p, int n_mean, int cluster,
                  int slice, int smem, int vec, cudaStream_t stream) {
    switch (k) {
#define MOMENTS_CASE(KK)                                                                  \
    case KK:                                                                              \
        return mc_launch(moments_cluster_kernel<KK, RESIDENT>, n, cluster, smem, stream,  \
                         img, out, p, n_mean, slice, vec);
        MOMENTS_CASE(1) MOMENTS_CASE(2) MOMENTS_CASE(3) MOMENTS_CASE(4)
        MOMENTS_CASE(5) MOMENTS_CASE(6) MOMENTS_CASE(7) MOMENTS_CASE(8)
#undef MOMENTS_CASE
    }
    return (int)cudaErrorInvalidValue;
}

// C entry point (bound with ctypes).  The plan (cluster, slice, resident,
// smem_bytes) comes from ops/moments.py::moments_plan; `vec` says the block
// may be read in 16-byte units (P and slice multiples of 4, base 16-byte
// aligned).  Returns cudaGetLastError() after the launch, 0 on success;
// cudaErrorInvalidValue for an argument or plan the kernel does not take;
// MC_CLUSTER_UNSCHEDULABLE when the occupancy API reports that no cluster
// of the plan's shape fits on the device.
extern "C" int sm_moments(const float* img, float* out, int n, int k, int p, int n_real,
                          int masked, int vec, int cluster, int slice, int resident,
                          int smem_bytes, void* stream) {
    if (n <= 0) return 0;
    if (k <= 0 || k > MC_K_MAX || p <= 0 || !mc_valid_cluster(cluster) ||
        !mc_valid_slices(p, cluster, slice) || (masked && (n_real <= 0 || n_real > p)) ||
        (long long)smem_bytes != mc_smem_bytes(k, slice, resident) ||
        (vec && ((p & 3) || (cluster > 1 && (slice & 3)) || ((uintptr_t)img & 15))))
        return (int)cudaErrorInvalidValue;
    const int n_mean = masked ? n_real : p;
    return resident
        ? launch<true>(k, img, out, n, p, n_mean, cluster, slice, smem_bytes, vec, (cudaStream_t)stream)
        : launch<false>(k, img, out, n, p, n_mean, cluster, slice, smem_bytes, vec, (cudaStream_t)stream);
}

extern "C" int sm_moments_k_max(void) { return MC_K_MAX; }

// The dynamic shared bytes of a CTA for a plan: the layout
// ops/moments.py::moments_smem_bytes mirrors.
extern "C" long long sm_moments_smem_bytes(int k, int slice, int resident) {
    return mc_smem_bytes(k, slice, resident);
}

// Clusters of a plan's shape the device holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error: what
// chip_smoke.py reports beside the kernel's time.
extern "C" int sm_moments_active_clusters(int k, int cluster, int slice, int resident) {
    const int smem = (int)mc_smem_bytes(k, slice, resident);
    return resident ? active_clusters<true>(k, cluster, smem) : active_clusters<false>(k, cluster, smem);
}
