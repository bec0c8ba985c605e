// Measure-of-chaos component counts for whole-slide images, hand-written for
// Hopper (sm_90a).
//
// Replaces: sm_distributed_tpu/ops/chaos_pallas.py::_chaos_strip_kernel
// (chaos_count_sums_strips, the "strips" route: images past the packed
// kernel's lean budget of 288k cells, e.g. 1024x1024).
//
// Computes what csrc/chaos.cu computes, for any image size: for each image i
// (nrows x ncols, row-major, rows `stride` floats apart), the SUM over levels
// l = 0..nlevels-1 of the number of 4-connected components of
// {p : max(x[p], 0) > thr[i, l]}.  The thresholds arrive precomputed, so the
// counts are exact integers, bit-equal to scipy.ndimage.label.
//
// Bound on the H100: not bytes.  One read of N*P*4 bytes is the floor (0.32
// ms for 256 images of 1024x1024), but the time goes into the union-find's
// dependent loads and atomics and into one pass over the level plane per
// level.
//
// Design: the exact union-find of csrc/chaos.cu (lock-free find, link by
// atomicMin of the larger root onto the smaller, level by level from the
// highest threshold, no re-initialisation), with one image split over many
// CTAs.  A 1024x1024 label plane is 4 MB and its level plane 1 MB; one
// persistent CTA per image would keep a few hundred such planes live, far
// past the 50 MB L2, and each CTA would walk a million pixels alone.  Here
// each CTA owns one strip of STRIP_PIX consecutive pixels (4 rows at 1024
// columns), and the grid is (strips, images):
// - `strips_init` gives each pixel its level count m[p] = #{l : x[p] >
//   thr[l]} (p is in the mask of level l iff l < m[p]), sets parent[p] = p,
//   adds sum_p m[p] to the image's total and records each strip's max m.
// - `strips_link`, launched once per level from the top level down, adds
//   the edges (p, q) with min(m[p], m[q]) == l + 1 (right and down
//   neighbours of p, across strip boundaries too: the parent plane is the
//   image's, in global memory).  Every link of two roots removes one
//   component at level l and at every level below it, so it credits l + 1.
//   The launch boundary is the barrier between levels that keeps each link
//   on its own level (Kruskal order across CTAs):
//   sum over levels of components = sum_p m[p] - sum over links of (l + 1).
//   A strip whose max m is <= l has no edge at level l and returns at once.
// - `strips_finish` writes total - credits as f32.
// Blocks run in blockIdx order, strips fastest, so the CTAs resident at one
// time cover a few consecutive images: their label and level planes (5 MB
// an image at 1024x1024) stay in L2 while the union-find walks them.
// Finds read parents with __ldcg (L2, never a stale L1 line): other SMs
// link and compress the same plane concurrently.

#include <cuda_runtime.h>

#define STRIP_THREADS 256
#define STRIP_WARPS (STRIP_THREADS / 32)
#define STRIP_PIX 4096
#define MAX_LEVELS 255

__device__ __forceinline__ int sf_find(int* par, int i) {
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
__device__ __forceinline__ int sf_union(int* par, int a, int b) {
    while (true) {
        a = sf_find(par, a);
        b = sf_find(par, b);
        if (a == b) return 0;
        if (a > b) { const int t = a; a = b; b = t; }
        const int old = atomicMin(par + b, a);
        if (old == b) return 1;  // b was a root and now hangs under a
        b = old;                  // b was linked meanwhile: retry from there
    }
}

// Sum of v over the block, valid in thread 0.  Ends with a barrier.
__device__ __forceinline__ long long block_sum_ll(long long v, long long* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    long long s = 0;
    if (threadIdx.x == 0)
        for (int w = 0; w < STRIP_WARPS; ++w) s += red[w];
    __syncthreads();
    return s;
}

__global__ void __launch_bounds__(STRIP_THREADS)
strips_init(const float* __restrict__ img, long long stride,
            const float* __restrict__ thr, int* __restrict__ par,
            unsigned char* __restrict__ lev,
            unsigned long long* __restrict__ total,
            int* __restrict__ strip_top, int p, int nlevels) {
    __shared__ float thr_s[MAX_LEVELS];
    __shared__ long long red[STRIP_WARPS];
    __shared__ int top_s;
    const int im = blockIdx.y, s = blockIdx.x;
    const float* x = img + (size_t)im * (size_t)stride;
    int* pl = par + (size_t)im * p;
    unsigned char* lv = lev + (size_t)im * p;
    for (int l = threadIdx.x; l < nlevels; l += STRIP_THREADS)
        thr_s[l] = thr[(size_t)im * nlevels + l];
    if (threadIdx.x == 0) top_s = 0;
    __syncthreads();

    const int beg = s * STRIP_PIX;
    const int end = min(p, beg + STRIP_PIX);
    long long acc = 0;
    int top = 0;
    for (int i = beg + threadIdx.x; i < end; i += STRIP_THREADS) {
        const float v = fmaxf(x[i], 0.0f);
        int m = 0;
        for (int l = 0; l < nlevels; ++l) m += (v > thr_s[l]);
        lv[i] = (unsigned char)m;
        pl[i] = i;
        acc += m;
        top = max(top, m);
    }
    if (top) atomicMax(&top_s, top);
    const long long sum = block_sum_ll(acc, red);  // barrier: top_s is final
    if (threadIdx.x == 0) {
        strip_top[(size_t)im * gridDim.x + s] = top_s;
        if (sum) atomicAdd(total + im, (unsigned long long)sum);
    }
}

__global__ void __launch_bounds__(STRIP_THREADS)
strips_link(int* __restrict__ par, const unsigned char* __restrict__ lev,
            unsigned long long* __restrict__ credit,
            const int* __restrict__ strip_top, int p, int ncols, int l) {
    __shared__ long long red[STRIP_WARPS];
    const int im = blockIdx.y, s = blockIdx.x;
    // block-uniform: no pixel of this strip is in the mask of level l
    if (strip_top[(size_t)im * gridDim.x + s] <= l) return;
    int* pl = par + (size_t)im * p;
    const unsigned char* lv = lev + (size_t)im * p;
    const int e = l + 1;
    const int beg = s * STRIP_PIX;
    const int end = min(p, beg + STRIP_PIX);
    long long acc = 0;
    for (int i = beg + threadIdx.x; i < end; i += STRIP_THREADS) {
        const int mi = lv[i];
        if (mi <= l) continue;
        if ((i % ncols) + 1 < ncols && min(mi, (int)lv[i + 1]) == e)
            acc += e * sf_union(pl, i, i + 1);
        if (i + ncols < p && min(mi, (int)lv[i + ncols]) == e)
            acc += e * sf_union(pl, i, i + ncols);
    }
    const long long sum = block_sum_ll(acc, red);
    if (threadIdx.x == 0 && sum) atomicAdd(credit + im, (unsigned long long)sum);
}

__global__ void strips_finish(const unsigned long long* __restrict__ total,
                              const unsigned long long* __restrict__ credit,
                              float* __restrict__ out, int n) {
    const int im = blockIdx.x * blockDim.x + threadIdx.x;
    if (im < n) out[im] = (float)(long long)(total[im] - credit[im]);
}

// C entry point (bound with ctypes).  Runs init, one link launch per level
// from nlevels-1 down to 0, and finish, all on `stream`.  `total` and
// `credit` are (n,) zeroed u64; `par` is (n*p,) i32, `lev` (n*p,) u8 and
// `strip_top` (n*strips) i32 scratch.  Returns cudaGetLastError() after the
// last launch (a refused launch stays reported until then); 0 is success.
extern "C" int sm_chaos_strips(const float* img, long long stride,
                               const float* thr, float* out, int* par,
                               unsigned char* lev, unsigned long long* total,
                               unsigned long long* credit, int* strip_top,
                               int n, int nrows, int ncols, int nlevels,
                               void* stream) {
    if (n <= 0) return 0;
    if (nlevels <= 0 || nlevels > MAX_LEVELS || nrows <= 0 || ncols <= 0)
        return (int)cudaErrorInvalidValue;
    const long long p64 = (long long)nrows * ncols;
    if (p64 > 0x7fffffffLL - STRIP_PIX || n > 65535) return (int)cudaErrorInvalidValue;
    const int p = (int)p64;
    const dim3 grid((p + STRIP_PIX - 1) / STRIP_PIX, n);
    cudaStream_t st = (cudaStream_t)stream;
    strips_init<<<grid, STRIP_THREADS, 0, st>>>(img, stride, thr, par, lev,
                                                total, strip_top, p, nlevels);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int l = nlevels - 1; l >= 0; --l) {
        strips_link<<<grid, STRIP_THREADS, 0, st>>>(par, lev, credit, strip_top,
                                                    p, ncols, l);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    strips_finish<<<(n + 255) / 256, 256, 0, st>>>(total, credit, out, n);
    return (int)cudaGetLastError();
}

extern "C" int sm_chaos_strips_max_levels(void) { return MAX_LEVELS; }
extern "C" int sm_chaos_strips_strip_pixels(void) { return STRIP_PIX; }
