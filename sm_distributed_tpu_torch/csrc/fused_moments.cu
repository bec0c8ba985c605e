// Fused window extraction + per-ion moments, hand-written for Hopper (sm_90a).
//
// Replaces: sm_distributed_tpu/ops/score_pallas.py::_fused_kernel
// (fused_window_moments).
//
// Input: the bins-major histogram scratch of one batch, `whp` (cols, P) f32
// with rows `ld` floats apart, and the ion-major chunk plan: chunk offsets
// `starts` (C,) and local window rank bounds `rlo`/`rhi` (C, Wc), Wc = ipc*k
// (ipc ions of k windows per chunk).  The image value of window w of chunk c
// at pixel p is the sum of the histogram rows start_eff + g, g in
// (rlo + shift, rhi + shift] and in [0, gc_width + 1], of column p, where
// start_eff = min(start, cols - (gc_width + 2)) and shift = start -
// start_eff: exactly the rows the plain chain's banded membership matmul
// reads (ops/imager.py::banded_images).  The values are integer-grid sums
// below 2^24, exact in f32 in any order, so the kernel adds the rows
// directly (in row order, __fadd_rn): no membership matrix, no matmul.
// Output, per window row (columns as the TPU kernel's):
//   partials[c, w] = (sum_p v, sum_p cen^2, sum_p cen0 * cen, max_p v,
//                     #{p : v > 0}),
// cen = v - sum/n_real for p < n_real, 0 past it (cen0: the ion's window 0),
// and the principal rows principal[c, i, p] = v of window 0 of ion i.
//
// Bound on the H100: bytes.  Each band row the windows cover is read once
// (2.1 GB for 2048 ions of 4 windows at 65536 pixels), each principal row
// written once (0.54 GB): ~0.8 ms at 3.35 TB/s; a few f32 and f64 operations
// per (window, pixel) are far below the compute rates.  The (B, K, P) image
// block is never written: that is the point of the fusion.
//
// Design: csrc/moments.cu's cluster per ion (csrc/moments_cluster.cuh) with
// another producer of pixel values.  Pass 0 derives the windows' values for
// the CTA's pixel slice one window at a time, summing that window's band
// rows with 16-byte loads where `ld`, P and the pointer allow (`vec`; each
// thread takes FUSED_U groups of four pixels at once, so that many loads are
// in flight: the values come from loads, not from a bulk copy), and
// writes them to shared memory (resident regime), window 0's also to
// `principal`; it reduces sums, max and positive count per window as the
// values are made.  The cluster combines the sums over DSMEM, pass 1 runs
// the centered terms from shared memory, and a second DSMEM reduction gives
// rank 0 the norms and dots.  The band rows are read once per ion.  Where
// the ion's windows do not fit the cluster's shared memory (streaming
// regime, S = 16), pass 1 derives the values again from the band rows.
// The grid keeps the plan's ion order (cluster index c * ipc + i), so the
// ions of one chunk, which share band rows, run side by side and find those
// rows in L2.  Numerics as csrc/moments.cu: centered values and their
// products are f32 and round once each; all sums accumulate in f64 (threads,
// warps, then the cluster's CTAs in rank order) and round to f32 once, so
// sums are the exact totals correctly rounded and the centered terms sit
// within an ulp or two of an f64 reference.

#include "moments_cluster.cuh"

// Float4 groups a thread derives together in pass 0, so that U * nrow
// independent 16-byte loads are in flight per band-row step.
#define FUSED_U 4

__device__ __forceinline__ void add4(float4& v, const float4 q) {
    v.x = __fadd_rn(v.x, q.x);
    v.y = __fadd_rn(v.y, q.y);
    v.z = __fadd_rn(v.z, q.z);
    v.w = __fadd_rn(v.w, q.w);
}

// Four pixels of one window: its nrow band rows summed in row order.
__device__ __forceinline__ float4 window4(const float* src, int nrow, long long ld, int j) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int t = 0; t < nrow; ++t)
        add4(v, __ldg(reinterpret_cast<const float4*>(src + (size_t)t * ld) + j));
    return v;
}

// FUSED_U groups of four pixels of one window, j0 + u * MC_THREADS (those
// below len4), each its band rows summed in row order.
__device__ __forceinline__ void window4x(const float* src, int nrow, long long ld, int j0,
                                         int len4, float4 (&v)[FUSED_U]) {
#pragma unroll
    for (int u = 0; u < FUSED_U; ++u) v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
    for (int t = 0; t < nrow; ++t) {
        const float4* rowp = reinterpret_cast<const float4*>(src + (size_t)t * ld);
#pragma unroll
        for (int u = 0; u < FUSED_U; ++u)
            if (j0 + u * MC_THREADS < len4) add4(v[u], __ldg(rowp + j0 + u * MC_THREADS));
    }
}

// One pixel of one window.
__device__ __forceinline__ float window1(const float* src, int nrow, long long ld, int j) {
    float v = 0.0f;
#pragma unroll 4
    for (int t = 0; t < nrow; ++t) v = __fadd_rn(v, __ldg(src + (size_t)t * ld + j));
    return v;
}

template <int K, bool RESIDENT>
__global__ void __launch_bounds__(MC_THREADS, 3)
fused_cluster_kernel(const float* whp, long long ld, int cols, const int* starts,
                     const int* rlo, const int* rhi, float* partials, float* principal, int wc,
                     int p, int n_real, int gc_width, int slice, int vec) {
    __shared__ McScratch sc;
    __shared__ long long win_off[K];       // each window's first band row, in floats
    __shared__ int win_rows[K];            // and its band row count
    extern __shared__ __align__(16) unsigned char dyn[];
    cg::cluster_group cluster = cg::this_cluster();
    mc_cluster_start();
    const int n_cta = (int)cluster.num_blocks();
    const int ion = blockIdx.x / n_cta;   // c * ipc + i: the plan's ion order
    const int ipc = wc / K;
    const int c = ion / ipc;
    const int w0 = (ion % ipc) * K;        // the ion's first window in its chunk
    const int a = (int)cluster.block_rank() * slice;
    const int len = max(0, min(slice, p - a));
    const int row = mc_row_floats(slice);
    float* data = reinterpret_cast<float*>(dyn + MC_BARRIER_BYTES);   // window r at data + r * row

    if (threadIdx.x < K) {
        const int r = threadIdx.x;
        const int start = starts[c];
        const int start_eff = min(start, cols - (gc_width + 2));
        const int shift = start - start_eff;
        const int w = c * wc + w0 + r;
        const int g0 = max(rlo[w] + shift + 1, 0);
        const int g1 = min(rhi[w] + shift, gc_width + 1);
        win_off[r] = g1 >= g0 ? (long long)(start_eff + g0) * ld : 0;
        win_rows[r] = g1 >= g0 ? g1 - g0 + 1 : 0;
    }
    __syncthreads();

    // ---- pass 0: values, principal row, sums, max and positive count ---
    double s[K];
    float vmax[K];
    int nn[K];
    float* prow = principal + (size_t)ion * p + a;
#pragma unroll
    for (int r = 0; r < K; ++r) {
        const float* src = whp + win_off[r] + a;
        const int nrow = win_rows[r];
        double sr = 0.0;
        float mr = -INFINITY;
        int cr = 0;
        if (vec) {
            const int len4 = len >> 2;
            for (int j0 = threadIdx.x; j0 < len4; j0 += FUSED_U * MC_THREADS) {
                float4 vs[FUSED_U];
                window4x(src, nrow, ld, j0, len4, vs);
#pragma unroll
                for (int u = 0; u < FUSED_U; ++u) {
                    const int j = j0 + u * MC_THREADS;
                    if (j < len4) {
                        const float4 v = vs[u];
                        if (RESIDENT) reinterpret_cast<float4*>(data + r * row)[j] = v;
                        if (r == 0) reinterpret_cast<float4*>(prow)[j] = v;
                        sr = __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(sr, v.x), v.y), v.z), v.w);
                        mr = fmaxf(mr, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
                        cr += (v.x > 0.0f) + (v.y > 0.0f) + (v.z > 0.0f) + (v.w > 0.0f);
                    }
                }
            }
        } else {
            for (int j = threadIdx.x; j < len; j += MC_THREADS) {
                const float v = window1(src, nrow, ld, j);
                if (RESIDENT) data[r * row + j] = v;
                if (r == 0) prow[j] = v;
                sr = __dadd_rn(sr, v);
                mr = fmaxf(mr, v);
                cr += (v > 0.0f);
            }
        }
        s[r] = sr;
        vmax[r] = mr;
        nn[r] = cr;
    }
    mc_block_sum<K>(s, sc.s, sc);
    mc_block_maxcnt<K>(vmax, nn, sc);
    mc_cluster_totals<K, K>(cluster, sc, (float)n_real);

    float mean[K];
#pragma unroll
    for (int r = 0; r < K; ++r) mean[r] = sc.mean[r];

    // ---- pass 1: centered norms and dots vs window 0 --------------------
    double ns[K], dt[K];
#pragma unroll
    for (int r = 0; r < K; ++r) { ns[r] = 0.0; dt[r] = 0.0; }
    const int lim = n_real - a;            // slice-local bound of the real pixels
    if (vec) {
        const int len4 = len >> 2;
        for (int j = threadIdx.x; j < len4; j += MC_THREADS) {
            float cen[K][4];
#pragma unroll
            for (int r = 0; r < K; ++r) {
                const float4 v = RESIDENT ? reinterpret_cast<const float4*>(data + r * row)[j]
                                          : window4(whp + win_off[r] + a, win_rows[r], ld, j);
                const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    cen[r][t] = (4 * j + t < lim) ? __fsub_rn(xs[t], mean[r]) : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < K; ++r) {
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    ns[r] = __dadd_rn(ns[r], (double)__fmul_rn(cen[r][t], cen[r][t]));
                    dt[r] = __dadd_rn(dt[r], (double)__fmul_rn(cen[0][t], cen[r][t]));
                }
            }
        }
    } else {
        for (int j = threadIdx.x; j < len; j += MC_THREADS) {
            const bool in = j < lim;
            float cen[K];
#pragma unroll
            for (int r = 0; r < K; ++r) {
                const float v = RESIDENT ? data[r * row + j]
                                         : window1(whp + win_off[r] + a, win_rows[r], ld, j);
                cen[r] = in ? __fsub_rn(v, mean[r]) : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < K; ++r) {
                ns[r] = __dadd_rn(ns[r], (double)__fmul_rn(cen[r], cen[r]));
                dt[r] = __dadd_rn(dt[r], (double)__fmul_rn(cen[0], cen[r]));
            }
        }
    }
    mc_block_sum<K>(ns, sc.ns, sc);
    mc_block_sum<K>(dt, sc.dt, sc);

    if (mc_cluster_push_centered<K>(cluster, sc) && threadIdx.x < K) {
        const int r = threadIdx.x;
        float* o = partials + ((size_t)c * wc + w0 + r) * 5;
        o[0] = __double2float_rn(sc.tot_s[r]);
        o[1] = __double2float_rn(mc_rank_total(sc.pns, n_cta, r));
        o[2] = __double2float_rn(mc_rank_total(sc.pdt, n_cta, r));
        o[3] = sc.tot_max[r];
        o[4] = (float)sc.tot_cnt[r];
    }
}

template <bool RESIDENT>
static int launch(int k, int n_ions, int cluster, int smem, cudaStream_t stream, const float* whp,
                  long long ld, int cols, const int* starts, const int* rlo, const int* rhi,
                  float* partials, float* principal, int wc, int p, int n_real, int gc_width,
                  int slice, int vec) {
    switch (k) {
#define FUSED_CASE(KK)                                                                        \
    case KK:                                                                                  \
        return mc_launch(fused_cluster_kernel<KK, RESIDENT>, n_ions, cluster, smem, stream,  \
                         whp, ld, cols, starts, rlo, rhi, partials, principal, wc, p, n_real, \
                         gc_width, slice, vec);
        FUSED_CASE(1) FUSED_CASE(2) FUSED_CASE(3) FUSED_CASE(4)
        FUSED_CASE(5) FUSED_CASE(6) FUSED_CASE(7) FUSED_CASE(8)
#undef FUSED_CASE
    }
    return (int)cudaErrorInvalidValue;
}

// C entry point (bound with ctypes).  `partials` is (C, wc, 5) f32 and
// `principal` (C * wc / k, p) f32; one cluster per ion, planned by
// ops/moments.py::moments_plan (cluster, slice, resident, smem_bytes).
// `vec` says the histogram rows and the principal rows may be read and
// written in 16-byte units (ld, P and slice multiples of 4, both bases
// 16-byte aligned).  Returns cudaGetLastError() after the launch, 0 on
// success; cudaErrorInvalidValue for an argument or plan the kernel does not
// take; MC_CLUSTER_UNSCHEDULABLE when no cluster of the plan's shape fits.
extern "C" int sm_fused_moments(const float* whp, long long ld, int cols, const int* starts,
                                const int* rlo, const int* rhi, float* partials,
                                float* principal, int n_chunks, int wc, int k, int p,
                                int n_real, int gc_width, int cluster, int slice, int resident,
                                int smem_bytes, int vec, void* stream) {
    if (n_chunks <= 0) return 0;
    if (k <= 0 || k > MC_K_MAX || wc % k != 0 || p <= 0 || n_real <= 0 || n_real > p ||
        cols < gc_width + 2 || !mc_valid_cluster(cluster) || !mc_valid_slices(p, cluster, slice) ||
        (long long)smem_bytes != mc_smem_bytes(k, slice, resident) ||
        (vec && ((p & 3) || (ld & 3) || (cluster > 1 && (slice & 3)) || ((uintptr_t)whp & 15) ||
                 ((uintptr_t)principal & 15))))
        return (int)cudaErrorInvalidValue;
    const int n_ions = n_chunks * (wc / k);
    cudaStream_t st = (cudaStream_t)stream;
    return resident
        ? launch<true>(k, n_ions, cluster, smem_bytes, st, whp, ld, cols, starts, rlo, rhi, partials,
                       principal, wc, p, n_real, gc_width, slice, vec)
        : launch<false>(k, n_ions, cluster, smem_bytes, st, whp, ld, cols, starts, rlo, rhi,
                        partials, principal, wc, p, n_real, gc_width, slice, vec);
}

extern "C" int sm_fused_moments_k_max(void) { return MC_K_MAX; }
