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
// directly: no membership matrix, no matmul.
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
// Design: one CTA of 256 threads per ion, as csrc/moments.cu, both passes
// in the block, so pass 1's mean needs no second launch or grid barrier.
// Pass 0 derives every window's value per pixel (coalesced loads of the
// ion's band rows), writes the principal row and reduces sums, max and
// positive count; pass 1 re-derives the values (the ion's band rows, ~1 MB
// at 65536 pixels, mostly still in L2) and reduces the centered norms and
// the dots against window 0.  Numerics as csrc/moments.cu: centered values
// and their products are f32 and round once each (__fsub_rn/__fmul_rn keep
// nvcc from contracting them into FMAs); all sums accumulate in f64 and
// round to f32 once, so sums are the exact totals correctly rounded and the
// centered terms sit within an ulp or two of an f64 reference.

#include <cuda_runtime.h>
#include <math.h>

#define FUSED_THREADS 256
#define FUSED_WARPS (FUSED_THREADS / 32)
#define K_MAX 8

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Block sums of the first k entries of `v`; results land in red[r][0].
// Ends with a barrier, so red may be read right after.
__device__ __forceinline__ void block_sum(const double* v, int k,
                                          double (*red)[FUSED_WARPS]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < K_MAX; ++r) {
        if (r < k) {
            const double s = warp_sum(v[r]);
            if (lane == 0) red[r][warp] = s;
        }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int r = 0; r < K_MAX; ++r) {
            if (r < k) {
                double s = lane < FUSED_WARPS ? red[r][lane] : 0.0;
                s = warp_sum(s);
                if (lane == 0) red[r][0] = s;
            }
        }
    }
    __syncthreads();
}

// The image value of one window at pixel p: its band rows summed in f32.
__device__ __forceinline__ float window_value(const float* row0, int nrow,
                                              long long ld, int p) {
    float v = 0.0f;
    for (int t = 0; t < nrow; ++t) v = __fadd_rn(v, row0[(size_t)t * ld + p]);
    return v;
}

__global__ void __launch_bounds__(FUSED_THREADS)
fused_kernel(const float* __restrict__ whp, long long ld, int cols,
             const int* __restrict__ starts, const int* __restrict__ rlo,
             const int* __restrict__ rhi, float* __restrict__ partials,
             float* __restrict__ principal, int wc, int k, int p, int n_real,
             int gc_width) {
    __shared__ double red_s[K_MAX][FUSED_WARPS];
    __shared__ double red_n[K_MAX][FUSED_WARPS];
    __shared__ double red_d[K_MAX][FUSED_WARPS];
    __shared__ float red_max[K_MAX][FUSED_WARPS];
    __shared__ int red_nn[K_MAX][FUSED_WARPS];

    const int ipc = wc / k;
    const int ion = blockIdx.x;          // c * ipc + i: the plan's ion order
    const int c = ion / ipc;
    const int w0 = (ion % ipc) * k;      // the ion's first window in its chunk
    const int start = starts[c];
    const int start_eff = min(start, cols - (gc_width + 2));
    const int shift = start - start_eff;

    const float* row0[K_MAX];
    int nrow[K_MAX];
#pragma unroll
    for (int r = 0; r < K_MAX; ++r) {
        row0[r] = whp;
        nrow[r] = 0;
        if (r < k) {
            const int w = c * wc + w0 + r;
            const int g0 = max(rlo[w] + shift + 1, 0);
            const int g1 = min(rhi[w] + shift, gc_width + 1);
            if (g1 >= g0) {
                row0[r] = whp + (size_t)(start_eff + g0) * (size_t)ld;
                nrow[r] = g1 - g0 + 1;
            }
        }
    }

    // ---- pass 0: principal row, sums, max and positive count -----------
    double s[K_MAX];
    float vmax[K_MAX];
    int nn[K_MAX];
#pragma unroll
    for (int r = 0; r < K_MAX; ++r) { s[r] = 0.0; vmax[r] = -INFINITY; nn[r] = 0; }
    float* prow = principal + (size_t)ion * (size_t)p;
    for (int j = threadIdx.x; j < p; j += FUSED_THREADS) {
#pragma unroll
        for (int r = 0; r < K_MAX; ++r) {
            if (r < k) {
                const float v = window_value(row0[r], nrow[r], ld, j);
                s[r] = __dadd_rn(s[r], (double)v);
                vmax[r] = fmaxf(vmax[r], v);
                nn[r] += (v > 0.0f);
                if (r == 0) prow[j] = v;
            }
        }
    }
    block_sum(s, k, red_s);
    {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
        for (int r = 0; r < K_MAX; ++r) {
            if (r < k) {
                const float m = warp_max(vmax[r]);
                const int cnt = warp_isum(nn[r]);
                if (lane == 0) { red_max[r][warp] = m; red_nn[r][warp] = cnt; }
            }
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
            for (int r = 0; r < K_MAX; ++r) {
                if (r < k) {
                    float m = lane < FUSED_WARPS ? red_max[r][lane] : -INFINITY;
                    int cnt = lane < FUSED_WARPS ? red_nn[r][lane] : 0;
                    m = warp_max(m);
                    cnt = warp_isum(cnt);
                    if (lane == 0) { red_max[r][0] = m; red_nn[r][0] = cnt; }
                }
            }
        }
        __syncthreads();
    }

    float mean[K_MAX];
    const float fn = (float)n_real;
#pragma unroll
    for (int r = 0; r < K_MAX; ++r)
        mean[r] = r < k ? __fdiv_rn(__double2float_rn(red_s[r][0]), fn) : 0.0f;

    // ---- pass 1: centered norms and dots vs window 0 --------------------
    double ns[K_MAX], dt[K_MAX];
#pragma unroll
    for (int r = 0; r < K_MAX; ++r) { ns[r] = 0.0; dt[r] = 0.0; }
    for (int j = threadIdx.x; j < p; j += FUSED_THREADS) {
        const bool in = j < n_real;
        float c0 = 0.0f;
#pragma unroll
        for (int r = 0; r < K_MAX; ++r) {
            if (r < k) {
                const float cen = in ? __fsub_rn(window_value(row0[r], nrow[r], ld, j), mean[r])
                                     : 0.0f;
                if (r == 0) c0 = cen;
                ns[r] = __dadd_rn(ns[r], (double)__fmul_rn(cen, cen));
                dt[r] = __dadd_rn(dt[r], (double)__fmul_rn(c0, cen));
            }
        }
    }
    block_sum(ns, k, red_n);
    block_sum(dt, k, red_d);

    if (threadIdx.x < k) {
        const int r = threadIdx.x;
        float* o = partials + ((size_t)c * wc + w0 + r) * 5;
        o[0] = __double2float_rn(red_s[r][0]);
        o[1] = __double2float_rn(red_n[r][0]);
        o[2] = __double2float_rn(red_d[r][0]);
        o[3] = red_max[r][0];
        o[4] = (float)red_nn[r][0];
    }
}

// C entry point (bound with ctypes).  `partials` is (C, wc, 5) f32 and
// `principal` (C * wc / k, p) f32; one CTA per ion.  Returns
// cudaGetLastError() after the launch; 0 is success.
extern "C" int sm_fused_moments(const float* whp, long long ld, int cols,
                                const int* starts, const int* rlo,
                                const int* rhi, float* partials,
                                float* principal, int n_chunks, int wc, int k,
                                int p, int n_real, int gc_width, void* stream) {
    if (n_chunks <= 0) return 0;
    if (k <= 0 || k > K_MAX || wc % k != 0 || p <= 0 || n_real <= 0
        || n_real > p || cols < gc_width + 2)
        return (int)cudaErrorInvalidValue;
    const int n_ions = n_chunks * (wc / k);
    fused_kernel<<<n_ions, FUSED_THREADS, 0, (cudaStream_t)stream>>>(
        whp, ld, cols, starts, rlo, rhi, partials, principal, wc, k, p,
        n_real, gc_width);
    return (int)cudaGetLastError();
}

extern "C" int sm_fused_moments_k_max(void) { return K_MAX; }
