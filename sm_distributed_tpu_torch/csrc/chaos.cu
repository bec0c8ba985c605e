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
// Two kernels share that algorithm; the wrapper (ops/chaos.py) picks one by
// the image's pixel count:
// - chaos_smem_kernel, for images of at most 65,536 pixels (256x256, the
//   main path's grid): the whole union-find of an image in one CTA's shared
//   memory, uint16 labels and uint8 level counts (below);
// - chaos_kernel, for larger images (512x512): int32 parent labels in global
//   memory, one plane of P ints per CTA (the wrapper allocates grid * P
//   ints).  The level counts are one byte a pixel, in shared memory when P
//   bytes fit and in a global plane otherwise.  CTAs are persistent: a grid
//   of a few per SM walks the images, so the label planes stay few and
//   mostly L2-resident.

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Shared-memory variant: images of at most 65,536 pixels.
//
// Bound: with the global-plane kernel above, every find, compression and link
// is a dependent load or atomic that goes to L2 or HBM (264 planes of 256 KB
// at 256x256 exceed the 50 MB L2).  Here one CTA holds one image's whole
// union-find in shared memory, so those accesses take shared-memory latency,
// and the image's only HBM traffic is one read of its pixels.
//
// Shared memory of one CTA (all dynamic, each part 16-byte aligned;
// sm_chaos_smem_bytes, mirrored by ops/chaos.py::chaos_smem_bytes):
//   red    33 ints: per-warp partial sums, then the image's top level count
//   thr    nlevels floats: the image's thresholds
//   par    P uint16 parent labels: indices 0..65535 are exactly the pixels
//   lev    nrows rows of S = round_up(ncols + 1, 4) bytes, level counts,
//          plus one zero word past the last row
// 256x256 at 255 levels: 144 + 1,024 + 131,072 + 66,564 = 198,804 bytes of
// the 232,448 a block may use.  The padding bytes of each row hold level 0,
// so the right edge of a row's last pixel and every edge of a padding byte
// have level min(m, 0) = 0 and are never linked, without a column test.
//
// Work: a persistent grid of one 1024-thread CTA per SM walks the images.
// Threads own 4-pixel words of the lev plane (word w: row w / (S/4)), the
// words tid + k * 1024, in every pass:
// - pass A reads the word's pixels once (16-byte loads when aligned), finds
//   m = #{l : x > thr[l]} by binary search (thresholds rise with l), writes
//   the lev word and par[p] = p for m > 0, and sums m and its maximum, top;
// - the right and down edge levels of a word are the byte-wise minima of
//   its lev word with the word shifted one byte (right) and the word a row
//   below (down), four bytes at a time (__vminu4); a thread keeps, in
//   registers, a mask of the edge levels each of its first 17 words holds,
//   so a level visits only the words with an edge at that level (all words
//   of a 256x256 image; larger shapes scan their other words every level);
// - levels e = top .. 1, with a barrier between levels: a visited word's
//   edges at level e (__vcmpeq4) each link two pixels, subtracting e on a
//   join.  Measured on the card, the joins cost more than the scans, and
//   most edges of dense images lie inside a component already: the union
//   climbs both paths together and stops where they meet.
// Pixels with m = 0 are never a link's end nor on a chain, so their labels
// are never set nor read.

#define SMEM_THREADS 1024
#define SMEM_WARPS (SMEM_THREADS / 32)
#define SMEM_MAX_PIXELS 65536
#define SMEM_MAX_DEVICES 64
// lev words a thread keeps level masks for, in registers: 17 * 1024 covers
// the 16,640 words of a 256x256 image
#define SMEM_SLOTS 17

__host__ __device__ __forceinline__ int round16(int b) { return (b + 15) & ~15; }
// bytes of one padded lev row: at least one zero byte after the last pixel
__host__ __device__ __forceinline__ int lev_row_bytes(int ncols) { return (ncols + 4) & ~3; }
__host__ __device__ __forceinline__ int smem_off_thr(void) { return round16(4 * (SMEM_WARPS + 1)); }
__host__ __device__ __forceinline__ int smem_off_par(int nlevels) {
    return smem_off_thr() + round16(4 * nlevels);
}
__host__ __device__ __forceinline__ int smem_off_lev(int P, int nlevels) {
    return smem_off_par(nlevels) + round16(2 * P);
}

// par[i] = val if par[i] == expect, atomically.  A 16-bit compare-and-swap,
// emulated with a 32-bit atomicCAS on the word that holds the label: its
// semantics and its lowering are explicit, and it builds with any toolkit.
// The other half of the word is written back as read; if a halving store
// changed it meanwhile, the CAS fails and is retried against the new word.
__device__ __forceinline__ bool smem_cas_label(unsigned int* par32, int i,
                                               unsigned int expect,
                                               unsigned int val) {
    unsigned int* word = par32 + (i >> 1);
    const int shift = (i & 1) << 4;
    const unsigned int mask = 0xffffu << shift;
    unsigned int old = *(volatile unsigned int*)word;
    while (((old & mask) >> shift) == expect) {
        const unsigned int prev = atomicCAS(word, old, (old & ~mask) | (val << shift));
        if (prev == old) return true;
        old = prev;
    }
    return false;
}

// Link the trees of a and b: 1 when two trees were joined, 0 when a and b
// already shared a tree.  The two paths are climbed together (Rem's
// interleaved find, without splicing), the one whose parent is larger
// first, so an edge inside a component stops where the paths meet instead
// of at the root.  Labels fall along every chain, so a root is the smallest
// label of its tree: when the climbing side a is a root and the other
// side's parent pb is smaller, pb lies in another tree, and the
// compare-and-swap hangs a under pb.  A root is replaced at most once (no
// ABA: a linked root never reads as a root again), so every join is counted
// exactly once.
//
// Climbing halves the path: a plain store points a at its grandparent g.
// The store may be stale: another thread may have linked or compressed
// meanwhile.  Either way g was on a's root path at some moment, so it is in
// a's tree (trees only merge) and below a (labels fall along every chain):
// par[x] < x for every non-root x still holds, so climbs end, and the
// partition is unchanged.  a is no root (par[a] != a), and a node that is
// no root never becomes one, so a store never overwrites a root that a
// compare-and-swap expects.
__device__ __forceinline__ int smem_union(volatile unsigned short* par,
                                          unsigned int* par32, int a, int b) {
    while (true) {
        int pa = par[a], pb = par[b];
        if (pa == pb) return 0;  // a common parent: one tree
        if (pa < pb) {
            int t = a; a = b; b = t;
            t = pa; pa = pb; pb = t;
        }
        if (pa == a) {  // a is a root, pb < a
            if (smem_cas_label(par32, a, (unsigned int)a, (unsigned int)pb)) return 1;
            continue;  // a was linked meanwhile: read again
        }
        const int g = par[pa];
        if (g != pa) par[a] = (unsigned short)g;
        a = g;
    }
}

// Link the edges of lev word w (row `row`) whose level is e (ee: e in each
// byte): the right and down edges whose byte-wise level minimum is e.
// Returns the number of joins.
__device__ __forceinline__ int smem_link_word(volatile unsigned short* par,
                                              unsigned int* par32,
                                              const unsigned int* lev32, int w,
                                              int row, int nrows, int ncols,
                                              int WR, unsigned int ee) {
    const unsigned int cur = lev32[w];
    if (!cur) return 0;
    const unsigned int right = __funnelshift_r(cur, lev32[w + 1], 8);
    const unsigned int down = row + 1 < nrows ? lev32[w + WR] : 0u;
    // bit 8j: right edge of byte j at level e; bit 8j+1: its down edge
    unsigned int hit = (__vcmpeq4(__vminu4(cur, right), ee) & 0x01010101u) |
                       (__vcmpeq4(__vminu4(cur, down), ee) & 0x02020202u);
    const int p = row * ncols + ((w - row * WR) << 2);
    int links = 0;
    while (hit) {
        const int k = __ffs(hit) - 1;
        hit &= hit - 1;
        const int a = p + (k >> 3);
        links += smem_union(par, par32, a, (k & 1) ? a + ncols : a + 1);
    }
    return links;
}

__global__ void __launch_bounds__(SMEM_THREADS, 1)
chaos_smem_kernel(const float* __restrict__ img, long long stride,
                  const float* __restrict__ thr, float* __restrict__ out,
                  int n, int nrows, int ncols, int nlevels, int vec4) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int P = nrows * ncols;
    const int WR = lev_row_bytes(ncols) >> 2;  // lev words a row
    const int words = nrows * WR;
    int* red = (int*)smem;
    int* top_s = red + SMEM_WARPS;
    float* thr_s = (float*)(smem + smem_off_thr());
    unsigned short* par16 = (unsigned short*)(smem + smem_off_par(nlevels));
    volatile unsigned short* par = par16;
    unsigned int* par32 = (unsigned int*)par16;
    unsigned int* lev32 = (unsigned int*)(smem + smem_off_lev(P, nlevels));

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // the thread's first word as (row, word in row), and the step between
    // its words (SMEM_THREADS words), so no pass divides
    const int row0 = tid / WR, cw0 = tid % WR;
    const int drow = SMEM_THREADS / WR, dcw = SMEM_THREADS % WR;
    if (tid == 0) lev32[words] = 0u;  // right neighbours of the last word

    for (int im = blockIdx.x; im < n; im += gridDim.x) {
        const float* x = img + (size_t)im * (size_t)stride;
        for (int l = tid; l < nlevels; l += SMEM_THREADS)
            thr_s[l] = thr[(size_t)im * nlevels + l];
        if (tid == 0) *top_s = 0;
        __syncthreads();

        // pass A: level counts, the singletons of the forest, sum and top
        int acc = 0, top = 0;
        {
            int row = row0, cw = cw0;
            for (int w = tid; w < words; w += SMEM_THREADS) {
                const int col = cw << 2;
                const int p = row * ncols + col;
                float v[4];
                if (vec4) {
                    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (col < ncols) f = __ldcs((const float4*)(x + p));
                    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j) v[j] = col + j < ncols ? x[p + j] : 0.f;
                }
                unsigned int word = 0u;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (col + j >= ncols) continue;  // padding: level 0
                    const float vj = fmaxf(v[j], 0.0f);
                    int lo = 0, hi = nlevels;  // #{l : thr[l] < vj}
                    while (lo < hi) {
                        const int mid = (lo + hi) >> 1;
                        if (thr_s[mid] < vj) lo = mid + 1; else hi = mid;
                    }
                    word |= (unsigned int)lo << (8 * j);
                    acc += lo;
                    top = max(top, lo);
                    if (lo) par[p + j] = (unsigned short)(p + j);
                }
                lev32[w] = word;
                cw += dcw; row += drow;
                if (cw >= WR) { cw -= WR; ++row; }
            }
        }
        top = __reduce_max_sync(0xffffffffu, top);
        if (lane == 0 && top) atomicMax(top_s, top);
        __syncthreads();
        const int levels = *top_s;

        // the edge levels each of the thread's first SMEM_SLOTS words holds:
        // bit e-1 for level e <= 31, bit 31 for every level >= 32
        unsigned int mask[SMEM_SLOTS];
#pragma unroll
        for (int k = 0; k < SMEM_SLOTS; ++k) {
            mask[k] = 0u;
            const int w = tid + k * SMEM_THREADS;
            if (levels && w < words) {
                const unsigned int cur = lev32[w];
                if (cur) {
                    const int row = w / WR;
                    const unsigned int right = __funnelshift_r(cur, lev32[w + 1], 8);
                    const unsigned int down = row + 1 < nrows ? lev32[w + WR] : 0u;
                    const unsigned int er = __vminu4(cur, right), ed = __vminu4(cur, down);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const unsigned int a = (er >> (8 * j)) & 0xffu;
                        const unsigned int b = (ed >> (8 * j)) & 0xffu;
                        if (a) mask[k] |= 1u << (min(a, 32u) - 1);
                        if (b) mask[k] |= 1u << (min(b, 32u) - 1);
                    }
                }
            }
        }

        // levels top .. 1: link the edges that appear at each level
        for (int e = levels; e >= 1; --e) {
            const unsigned int ee = 0x01010101u * (unsigned int)e;
            const int bit = min(e, 32) - 1;
            unsigned int visit = 0u;
#pragma unroll
            for (int k = 0; k < SMEM_SLOTS; ++k) visit |= ((mask[k] >> bit) & 1u) << k;
            int links = 0;
            while (visit) {
                const int w = tid + (__ffs(visit) - 1) * SMEM_THREADS;
                visit &= visit - 1;
                links += smem_link_word(par, par32, lev32, w, w / WR, nrows, ncols, WR, ee);
            }
            // words past the slots (more than SMEM_SLOTS words a thread):
            // scanned at every level
            for (int w = tid + SMEM_SLOTS * SMEM_THREADS; w < words; w += SMEM_THREADS)
                links += smem_link_word(par, par32, lev32, w, w / WR, nrows, ncols, WR, ee);
            acc -= e * links;
            __syncthreads();  // Kruskal order: each link on its own level
        }

        // block sum of the count
        acc = __reduce_add_sync(0xffffffffu, acc);
        if (lane == 0) red[warp] = acc;
        __syncthreads();
        if (warp == 0) {
            const int s = __reduce_add_sync(0xffffffffu, red[lane]);
            if (lane == 0) out[im] = (float)s;
        }
        __syncthreads();  // red, top_s, thr_s, par and lev are reused
    }
}

extern "C" int sm_chaos_smem_bytes(int nrows, int ncols, int nlevels) {
    return smem_off_lev(nrows * ncols, nlevels) + nrows * lev_row_bytes(ncols) + 4;
}

// C entry point of the shared-memory variant.  Returns cudaGetLastError()
// after the launch, 0 on success; cudaErrorInvalidValue for a shape past the
// kernel (more than 65,536 pixels, or more shared memory than the device's
// opt-in limit per block).  The SM count and the opt-in limit are queried,
// and the kernel's dynamic shared-memory attribute set to that limit, once
// per device.
extern "C" int sm_chaos_smem(const float* img, long long stride, const float* thr,
                             float* out, int n, int nrows, int ncols, int nlevels,
                             void* stream) {
    static int sms[SMEM_MAX_DEVICES], optin[SMEM_MAX_DEVICES];
    if (n <= 0) return 0;
    if (nlevels <= 0 || nlevels > MAX_LEVELS || nrows <= 0 || ncols <= 0 ||
        (long long)nrows * ncols > SMEM_MAX_PIXELS)
        return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= SMEM_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (optin[dev] == 0) {
        int s = 0, o = 0;
        err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(chaos_smem_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, o);
        if (err != cudaSuccess) return (int)err;
        sms[dev] = s;
        optin[dev] = o;
    }
    const int bytes = sm_chaos_smem_bytes(nrows, ncols, nlevels);
    if (bytes > optin[dev]) return (int)cudaErrorInvalidValue;
    const int vec4 = ((uintptr_t)img % 16 == 0) && stride % 4 == 0 && ncols % 4 == 0;
    const int grid = n < sms[dev] ? n : sms[dev];
    chaos_smem_kernel<<<grid, SMEM_THREADS, bytes, (cudaStream_t)stream>>>(
        img, stride, thr, out, n, nrows, ncols, nlevels, vec4);
    return (int)cudaGetLastError();
}
