// Measure-of-chaos component counts, hand-written for Hopper (sm_90a).
//
// Replaces: sm_distributed_tpu/ops/chaos_pallas.py::_chaos_kernel
// (chaos_count_sums, the "packed" route).
//
// Computes, for each image i (nrows x ncols, row-major, rows `stride`
// floats apart), the SUM over levels l = 0..nlevels-1 of the number of
// 4-connected components of {p : max(x[p], 0) > thr[i, l]}.  The thresholds
// arrive precomputed (vmax * l / nlevels in f32, by the caller), so the
// kernel does no float arithmetic beyond comparisons: the counts are exact
// integers, bit-equal to scipy.ndimage.label.
//
// Bound on the H100: not bytes.  One read of N*P*4 bytes is the floor the
// records state (0.16 ms for 2048 images of 256x256), but the time goes into
// the union-find's dependent loads and atomics, which are latency- and
// iteration-bound.
//
// Design: exact union-find (Playne-Hawick style: find without locks, link by
// atomicMin of the larger root onto the smaller) run level by level, highest
// threshold first, with no re-initialisation between levels:
// - Pass A gives each pixel its level count m[p] = #{l : x[p] > thr[l]};
//   thresholds rise with l, so p is in the mask of level l iff l < m[p].
//   It sets parent[p] = p and adds sum_p m[p] (= the masked pixels over all
//   levels) to the count.
// - Masks only grow as the threshold drops, so components only merge: level
//   l adds exactly the edges (p, q) with min(m[p], m[q]) == l + 1 to the
//   forest of the levels above it.  Every successful link of two roots
//   removes one component at level l and at every level below it, so it
//   subtracts (l + 1) from the sum.  A barrier between levels keeps each
//   link on its own level.  sum over levels of components
//   = sum_p m[p] - sum over links of (level + 1).
// - A root changes only by one successful atomicMin, so links are counted
//   exactly once whatever the interleaving; labels only decrease along a
//   parent chain, so find terminates.
// Where the labels live: the parent labels are int32 in global memory, one
// plane of P ints per CTA (the wrapper allocates grid * P ints; a 256x256
// plane is 256 KB, past the 227 KB of shared memory a block may use).  The
// level counts are one byte a pixel, in shared memory when P bytes fit
// (256x256: 64 KB) and in a global plane otherwise (512x512).  CTAs are
// persistent: a grid of a few per SM walks the images, so the label planes
// stay few and mostly L2-resident.

#include <cuda_runtime.h>

#define CHAOS_THREADS 512
#define CHAOS_WARPS (CHAOS_THREADS / 32)
#define MAX_LEVELS 255

__device__ __forceinline__ int uf_find(int* par, int i) {
    const int start = i;
    int p = __ldcg(par + i);
    while (p != i) {
        i = p;
        p = __ldcg(par + i);
    }
    // compress the start node onto its root; atomicMin never raises a
    // label, and start is not a root, so the forest's roots are unchanged
    if (start != i) atomicMin(par + start, i);
    return i;
}

// Link the trees of a and b.  Returns 1 when two distinct roots were joined
// (one component fewer), 0 when they already shared a root.
__device__ __forceinline__ int uf_union(int* par, int a, int b) {
    while (true) {
        a = uf_find(par, a);
        b = uf_find(par, b);
        if (a == b) return 0;
        if (a > b) { const int t = a; a = b; b = t; }
        const int old = atomicMin(par + b, a);
        if (old == b) return 1;  // b was a root and now hangs under a
        b = old;                  // b was linked meanwhile: retry from there
    }
}

__global__ void __launch_bounds__(CHAOS_THREADS)
chaos_kernel(const float* __restrict__ img, long long stride,
             const float* __restrict__ thr, float* __restrict__ out,
             int* __restrict__ par_scratch, unsigned char* __restrict__ lev_scratch,
             int n, int nrows, int ncols, int nlevels, int lev_in_smem) {
    extern __shared__ unsigned char smem_lev[];
    __shared__ float thr_s[MAX_LEVELS];
    __shared__ int red[CHAOS_WARPS];
    __shared__ int top_s;

    const int P = nrows * ncols;
    int* par = par_scratch + (size_t)blockIdx.x * P;
    unsigned char* lev = lev_in_smem ? smem_lev : lev_scratch + (size_t)blockIdx.x * P;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    for (int im = blockIdx.x; im < n; im += gridDim.x) {
        const float* x = img + (size_t)im * (size_t)stride;
        for (int l = threadIdx.x; l < nlevels; l += CHAOS_THREADS)
            thr_s[l] = thr[(size_t)im * nlevels + l];
        if (threadIdx.x == 0) top_s = 0;
        __syncthreads();

        // pass A: level counts, singleton forest, sum of m
        int acc = 0, top = 0;
        for (int i = threadIdx.x; i < P; i += CHAOS_THREADS) {
            const float v = fmaxf(x[i], 0.0f);
            int m = 0;
            for (int l = 0; l < nlevels; ++l) m += (v > thr_s[l]);
            lev[i] = (unsigned char)m;
            par[i] = i;
            acc += m;
            top = max(top, m);
        }
        if (top) atomicMax(&top_s, top);
        __syncthreads();
        const int levels = top_s;

        // levels top-1 .. 0: add the edges that appear at each level
        for (int l = levels - 1; l >= 0; --l) {
            const int e = l + 1;
            for (int i = threadIdx.x; i < P; i += CHAOS_THREADS) {
                const int mi = lev[i];
                if (mi <= l) continue;
                const int col = i % ncols;
                if (col + 1 < ncols && min(mi, (int)lev[i + 1]) == e)
                    acc -= e * uf_union(par, i, i + 1);
                if (i + ncols < P && min(mi, (int)lev[i + ncols]) == e)
                    acc -= e * uf_union(par, i, i + ncols);
            }
            __syncthreads();
        }

        // block reduction of the count sum
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) red[warp] = acc;
        __syncthreads();
        if (warp == 0) {
            int s = lane < CHAOS_WARPS ? red[lane] : 0;
            for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
            if (lane == 0) out[im] = (float)s;
        }
        __syncthreads();  // scratch, thr_s and red are reused by the next image
    }
}

// C entry point (bound with ctypes).  Returns cudaGetLastError() after the
// launch; 0 is success.  `smem_bytes` is the dynamic shared memory for the
// level plane (P when lev_in_smem, else 0).
extern "C" int sm_chaos(const float* img, long long stride, const float* thr,
                        float* out, int* par_scratch, unsigned char* lev_scratch,
                        int n, int nrows, int ncols, int nlevels, int grid,
                        int lev_in_smem, int smem_bytes, void* stream) {
    if (n <= 0) return 0;
    if (nlevels <= 0 || nlevels > MAX_LEVELS || grid <= 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        chaos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    chaos_kernel<<<grid, CHAOS_THREADS, smem_bytes, (cudaStream_t)stream>>>(
        img, stride, thr, out, par_scratch, lev_scratch, n, nrows, ncols,
        nlevels, lev_in_smem);
    return (int)cudaGetLastError();
}

extern "C" int sm_chaos_max_levels(void) { return MAX_LEVELS; }
