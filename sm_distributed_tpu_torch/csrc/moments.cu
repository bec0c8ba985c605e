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
// 4 bytes read, far below the ~20 flop/byte the card needs before f32 compute
// limits it, so the floor is one read of N*K*P*4 bytes at 3.35 TB/s
// (0.64 ms at (2048, 4, 65536)).
//
// Design: one CTA of 256 threads per ion streams the ion's K rows with
// 16-byte loads, all K rows at the same pixel offset together so each warp
// reads K coalesced segments.  Pass 1 takes the sums, row-0 max and positive
// count; pass 2 re-reads the block (from L2 where it still sits) for the
// exact two-pass centered terms — the one-pass raw-moment identity
// sum(x^2) - n*mean^2 cancels catastrophically on integer-grid values up to
// 2^24 and is not used.  Per-thread partials reduce by warp shuffles, then
// across the block's warps in shared memory.  The centered values and their
// products are f32 and round once each, as in the plain version
// (__fsub_rn/__fmul_rn keep nvcc from contracting them into FMAs); the sums
// of those f32 terms accumulate in f64 and round to f32 once at the end.
// An f32 sum over 65536 terms drifts from the exact sum by ulps that depend
// on its order, and the spatial correlation carries that drift into its
// result; the f64 adds cost nothing against the memory traffic (~3 adds
// per 4 bytes read).

#include <cuda_runtime.h>
#include <math.h>

#define MOM_THREADS 256
#define MOM_WARPS (MOM_THREADS / 32)
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

// Sum each of the first `k` entries of `v` over the block; results land in
// red[r][0].  Ends with a barrier, so red may be read right after.
__device__ __forceinline__ void block_sum(double* v, int k, double (*red)[MOM_WARPS]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < K_MAX; ++r) {
        if (r < k) {
            double s = warp_sum(v[r]);
            if (lane == 0) red[r][warp] = s;
        }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int r = 0; r < K_MAX; ++r) {
            if (r < k) {
                double s = lane < MOM_WARPS ? red[r][lane] : 0.0;
                s = warp_sum(s);
                if (lane == 0) red[r][0] = s;
            }
        }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(MOM_THREADS)
moments_kernel(const float* __restrict__ img, float* __restrict__ out,
               int k, int p, int n_real, int masked, int vec) {
    __shared__ double red_s[K_MAX][MOM_WARPS];
    __shared__ double red_n[K_MAX][MOM_WARPS];
    __shared__ double red_d[K_MAX][MOM_WARPS];
    __shared__ float red_max[MOM_WARPS];
    __shared__ int red_nn[MOM_WARPS];

    const float* base = img + (size_t)blockIdx.x * (size_t)k * (size_t)p;
    const int n = masked ? n_real : p;

    // ---- pass 1: sums, row-0 max and positive count --------------------
    double s[K_MAX];
#pragma unroll
    for (int r = 0; r < K_MAX; ++r) s[r] = 0.0;
    float vmax = -INFINITY;
    int nn = 0;
    if (vec) {
        const int p4 = p >> 2;
        for (int j = threadIdx.x; j < p4; j += MOM_THREADS) {
#pragma unroll
            for (int r = 0; r < K_MAX; ++r) {
                if (r < k) {
                    const float4 v = reinterpret_cast<const float4*>(base + (size_t)r * p)[j];
                    s[r] = __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(s[r], v.x), v.y), v.z), v.w);
                    if (r == 0) {
                        vmax = fmaxf(vmax, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
                        nn += (v.x > 0.0f) + (v.y > 0.0f) + (v.z > 0.0f) + (v.w > 0.0f);
                    }
                }
            }
        }
    } else {
        for (int j = threadIdx.x; j < p; j += MOM_THREADS) {
#pragma unroll
            for (int r = 0; r < K_MAX; ++r) {
                if (r < k) {
                    const float v = base[(size_t)r * p + j];
                    s[r] = __dadd_rn(s[r], v);
                    if (r == 0) {
                        vmax = fmaxf(vmax, v);
                        nn += (v > 0.0f);
                    }
                }
            }
        }
    }
    block_sum(s, k, red_s);
    {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        float m = warp_max(vmax);
        int c = warp_isum(nn);
        if (lane == 0) { red_max[warp] = m; red_nn[warp] = c; }
        __syncthreads();
        if (warp == 0) {
            m = lane < MOM_WARPS ? red_max[lane] : -INFINITY;
            c = lane < MOM_WARPS ? red_nn[lane] : 0;
            m = warp_max(m);
            c = warp_isum(c);
            if (lane == 0) { red_max[0] = m; red_nn[0] = c; }
        }
        __syncthreads();
    }

    float mean[K_MAX];
    const float fn = (float)n;
#pragma unroll
    for (int r = 0; r < K_MAX; ++r)
        mean[r] = r < k ? __fdiv_rn(__double2float_rn(red_s[r][0]), fn) : 0.0f;

    // ---- pass 2: centered norms and dots vs row 0 ----------------------
    double ns[K_MAX], dt[K_MAX];
#pragma unroll
    for (int r = 0; r < K_MAX; ++r) { ns[r] = 0.0; dt[r] = 0.0; }
    if (vec) {
        const int p4 = p >> 2;
        for (int j = threadIdx.x; j < p4; j += MOM_THREADS) {
            float c[K_MAX][4];
#pragma unroll
            for (int r = 0; r < K_MAX; ++r) {
                if (r < k) {
                    const float4 v = reinterpret_cast<const float4*>(base + (size_t)r * p)[j];
                    const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int t = 0; t < 4; ++t)
                        c[r][t] = (4 * j + t < n) ? __fsub_rn(xs[t], mean[r]) : 0.0f;
                }
            }
#pragma unroll
            for (int r = 0; r < K_MAX; ++r) {
                if (r < k) {
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        ns[r] = __dadd_rn(ns[r], __fmul_rn(c[r][t], c[r][t]));
                        dt[r] = __dadd_rn(dt[r], __fmul_rn(c[0][t], c[r][t]));
                    }
                }
            }
        }
    } else {
        for (int j = threadIdx.x; j < p; j += MOM_THREADS) {
            const bool in = j < n;
            const float c0 = in ? __fsub_rn(base[j], mean[0]) : 0.0f;
#pragma unroll
            for (int r = 0; r < K_MAX; ++r) {
                if (r < k) {
                    const float c = in ? __fsub_rn(base[(size_t)r * p + j], mean[r]) : 0.0f;
                    ns[r] = __dadd_rn(ns[r], __fmul_rn(c, c));
                    dt[r] = __dadd_rn(dt[r], __fmul_rn(c0, c));
                }
            }
        }
    }
    block_sum(ns, k, red_n);
    block_sum(dt, k, red_d);

    if (threadIdx.x < k) {
        const int r = threadIdx.x;
        float* o = out + ((size_t)blockIdx.x * k + r) * 5;
        o[0] = __double2float_rn(red_s[r][0]);
        o[1] = __double2float_rn(red_n[r][0]);
        o[2] = __double2float_rn(red_d[r][0]);
        o[3] = red_max[0];
        o[4] = (float)red_nn[0];
    }
}

// C entry point (bound with ctypes).  Returns cudaGetLastError() after the
// launch; 0 is success.
extern "C" int sm_moments(const float* img, float* out, int n, int k, int p,
                          int n_real, int masked, int vec, void* stream) {
    if (n <= 0) return 0;
    if (k <= 0 || k > K_MAX || p <= 0) return (int)cudaErrorInvalidValue;
    moments_kernel<<<n, MOM_THREADS, 0, (cudaStream_t)stream>>>(
        img, out, k, p, n_real, masked, vec);
    return (int)cudaGetLastError();
}

extern "C" int sm_moments_k_max(void) { return K_MAX; }
