// Measure-of-chaos component counts for images of at most 65,536 pixels,
// hand-written for Hopper (sm_90a).
//
// Replaces: sm_distributed_tpu/ops/chaos_pallas.py::_chaos_kernel
// (chaos_count_sums, the "packed" route) for images of at most 65,536
// pixels (256x256, the main path's grid).  Larger packed images (512x512)
// take the row-tile kernel of csrc/chaos_strips.cu.
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
// iteration-bound.  With a union-find in global memory every find,
// compression and link is a dependent load or atomic that goes to L2 or
// HBM; here one CTA holds one image's whole union-find in shared memory, so
// those accesses take shared-memory latency, and the image's only HBM
// traffic is one read of its pixels.
//
// Design: exact union-find (find without locks, link by a compare-and-swap
// of the larger root onto a smaller label) run level by level, highest
// threshold first, with no re-initialisation between levels; uint16 labels
// and uint8 level counts in shared memory.  The algorithm, its shared-memory
// layout and its proof of exactness are in csrc/chaos_smem.cuh, which the
// row-tile kernel shares.  A persistent grid of one 1024-thread CTA per SM
// walks the images.  256x256 at 255 levels takes 144 + 1,024 + 131,072 +
// 66,564 = 198,804 bytes of the 232,448 a block may use.

#include "chaos_smem.cuh"

__global__ void __launch_bounds__(SMEM_THREADS, 1)
chaos_smem_kernel(const float* __restrict__ img, long long stride,
                  const float* __restrict__ thr, float* __restrict__ out,
                  int n, int nrows, int ncols, int nlevels, int vec4) {
    extern __shared__ __align__(16) unsigned char smem[];
    for (int im = blockIdx.x; im < n; im += gridDim.x) {
        const int acc = chaos_block_count<false>(
            img + (size_t)im * (size_t)stride, thr + (size_t)im * nlevels, nrows,
            ncols, nlevels, vec4, smem, nullptr, nullptr);
        const int s = chaos_block_sum(acc, (int*)smem);
        if (threadIdx.x == 0) out[im] = (float)s;
    }
}

extern "C" int sm_chaos_max_levels(void) { return MAX_LEVELS; }

extern "C" int sm_chaos_smem_bytes(int nrows, int ncols, int nlevels) {
    return chaos_block_smem_bytes(nrows, ncols, nlevels);
}

// C entry point (bound with ctypes).  Returns cudaGetLastError() after the
// launch, 0 on success; cudaErrorInvalidValue for a shape past the kernel
// (more than 65,536 pixels, or more shared memory than the device's opt-in
// limit per block).  The SM count and the opt-in limit are queried, and the
// kernel's dynamic shared-memory attribute set to that limit, once per
// device under a mutex (smem_setup).
extern "C" int sm_chaos_smem(const float* img, long long stride, const float* thr,
                             float* out, int n, int nrows, int ncols, int nlevels,
                             void* stream) {
    static SmemSetup setup;
    if (n <= 0) return 0;
    if (nlevels <= 0 || nlevels > MAX_LEVELS || nrows <= 0 || ncols <= 0 ||
        (long long)nrows * ncols > SMEM_MAX_PIXELS)
        return (int)cudaErrorInvalidValue;
    static const void* const fns[] = {(const void*)chaos_smem_kernel};
    int sms = 0, optin = 0;
    const cudaError_t err = smem_setup(setup, fns, 1, &sms, &optin);
    if (err != cudaSuccess) return (int)err;
    const int bytes = chaos_block_smem_bytes(nrows, ncols, nlevels);
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    const int vec4 = ((uintptr_t)img % 16 == 0) && stride % 4 == 0 && ncols % 4 == 0;
    const int grid = n < sms ? n : sms;
    chaos_smem_kernel<<<grid, SMEM_THREADS, bytes, (cudaStream_t)stream>>>(
        img, stride, thr, out, n, nrows, ncols, nlevels, vec4);
    return (int)cudaGetLastError();
}
