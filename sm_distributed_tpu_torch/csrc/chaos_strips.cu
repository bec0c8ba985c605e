// Measure-of-chaos component counts for images of more than 65,536 pixels,
// hand-written for Hopper (sm_90a): row tiles whose union-find lives in
// shared memory, and a seam merge.
//
// Replaces: sm_distributed_tpu/ops/chaos_pallas.py::_chaos_strip_kernel
// (chaos_count_sums_strips, the "strips" route: images past the packed
// kernel's lean budget of 288k cells, e.g. 1024x1024 whole-slide images),
// and ::_chaos_kernel (chaos_count_sums, the "packed" route) for packed
// images of more than 65,536 pixels (512x512, 8x36864).
//
// Computes what csrc/chaos.cu computes, for any image size: for each image i
// (nrows x ncols, row-major, rows `stride` floats apart), the SUM over levels
// l = 0..nlevels-1 of the number of 4-connected components of
// {p : max(x[p], 0) > thr[i, l]}.  The thresholds arrive precomputed, so the
// counts are exact integers, bit-equal to scipy.ndimage.label.
//
// Bound on the H100: not bytes.  One read of N*P*4 bytes is the floor (0.32
// ms for 256 images of 1024x1024), but the time goes into the union-find's
// dependent shared-memory accesses and atomics.  A union-find over the whole
// image in global memory makes every find, compression and link a dependent
// load or atomic on L2 or HBM (a 1024x1024 image's int32 labels are 4 MB);
// here every tile's union-find is in shared memory and each image crosses
// HBM once.
//
// Design: two kernels, launched one after the other on the caller's stream.
// - chaos_tile_kernel: an image is cut into tiles of `rows_t` whole rows
//   (rows_t * ncols <= 65,536, so a tile's labels fit uint16; the last tile
//   may be shorter), and a persistent grid of one 1024-thread CTA per SM
//   walks the (image, tile) pairs.  Each tile runs the whole-image algorithm
//   of csrc/chaos_smem.cuh with the image's thresholds: the tile's last row
//   has no down edges, so the tile's count C_t(l) is that of its own pixels.
//   Its labels are rotated one row, so the tile's seam pixels (its top and
//   bottom rows) carry the smallest labels, and it records each join of two
//   trees that hold seam pixels: rec[a] = pb | e << 16 for the seam root a
//   hung under pb at level e, at most one record a seam label.  It writes
//   its local sum sum_l C_t(l), its seam pixels' level counts (seam_m) and
//   the records, per (image, tile).
// - the seam merge: one CTA per image (persistent) runs a union-find over
//   the image's seam nodes (slot `label` of each tile: ss = 2*ncols slots a
//   tile, ncols for one-row tiles; 32,768 nodes at 1024x1024), levels from
//   the top seam level down with a barrier between levels.  At level e it
//   replays the tiles' records of level e and adds the cross edges at level
//   e (bottom row of tile t, top row of tile t+1, level min(m_a, m_b)).
//   The nodes' union-find is uint16 in shared memory when its bytes fit the
//   block (seam_in_smem: seam_merge_smem_kernel), else int32 in a global
//   plane over the seam nodes of the CTA's image (seam_merge_plane_kernel):
//   a shape rule the wrapper picks and counts.
//
// Why the sum is exact.  At level l, contract each tile's components: the
// image's components are sum_t C_t(l) minus the merges the cross edges make
// among the contracted components that hold seam pixels.  There are T(l) =
// N(l) - R(l) of those (N(l): seam pixels in the mask, R(l): records of
// levels > l; each record joins two such components of one tile, and a join
// with a component without seam pixels leaves their number alone).  The
// merge's union-find, after the records and cross edges of levels > l, has
// U(l) = N(l) - J(l) components (J(l): its joins so far), and its partition
// of the seam nodes is that of the contracted graph.  So the image has
// sum_t C_t(l) - (T(l) - U(l)) = sum_t C_t(l) - (J(l) - R(l)) components, and
// over all levels a join at level e counts e times:
//   sum = sum_t localsum_t - sum over cross joins of e
//                          + sum over records that joined nothing of e.
// Within a level the number of joins does not depend on their order.

#include "chaos_smem.cuh"

// seam-node words a thread of the shared-memory merge keeps level masks for:
// 16 * 4 * 1024 = 65,536 nodes, the most uint16 labels address
#define MERGE_SLOTS 16

// the merge's shared memory: 32 long long partial sums and the top level,
// then (seam_in_smem) per seam node its uint16 label and record partner and
// its uint8 level count and record level, each array 16-byte aligned: the
// level loop reads no global memory
__host__ __device__ __forceinline__ int seam_off_par(void) {
    return round16(8 * SMEM_WARPS + 4);
}
__host__ __device__ __forceinline__ int seam_smem_bytes(int nodes) {
    return seam_off_par() + 2 * round16(2 * nodes) + 2 * round16(nodes);
}

__global__ void __launch_bounds__(SMEM_THREADS, 1)
chaos_tile_kernel(const float* __restrict__ img, long long stride,
                  const float* __restrict__ thr, unsigned char* __restrict__ seam_m,
                  unsigned int* __restrict__ rec, int* __restrict__ tile_sum,
                  int n, int nrows, int ncols, int nlevels, int rows_t, int tiles,
                  int ss, int vec4) {
    extern __shared__ __align__(16) unsigned char smem[];
    for (int pair = blockIdx.x; pair < n * tiles; pair += gridDim.x) {
        const int im = pair / tiles, t = pair - im * tiles;
        const int r0 = t * rows_t;
        const int tr = min(rows_t, nrows - r0);
        unsigned char* sm = seam_m + (size_t)pair * ss;
        unsigned int* rc = rec + (size_t)pair * ss;
        // a one-row last tile of a plan with taller tiles uses only the
        // bottom slots: its top row is its bottom row
        const int used = tr > 1 ? 2 * ncols : ncols;
        for (int i = used + threadIdx.x; i < ss; i += SMEM_THREADS) {
            sm[i] = 0;
            rc[i] = 0u;
        }
        const int acc = chaos_block_count<true>(
            img + (size_t)im * (size_t)stride + (size_t)r0 * ncols,
            thr + (size_t)im * nlevels, tr, ncols, nlevels, vec4, smem, sm, rc);
        const int s = chaos_block_sum(acc, (int*)smem);
        if (threadIdx.x == 0) tile_sum[pair] = s;
    }
}

// The int32 union of the global seam plane: smem_union's algorithm (Rem's
// interleaved climb with path halving, a compare-and-swap that hangs the
// larger root under a smaller label) on labels in global memory, read and
// written at L2 (__ldcg, __stcg) since only this CTA uses the plane.
__device__ __forceinline__ int global_union(int* par, int a, int b) {
    while (true) {
        int pa = __ldcg(par + a), pb = __ldcg(par + b);
        if (pa == pb) return 0;
        if (pa < pb) {
            int t = a; a = b; b = t;
            t = pa; pa = pb; pb = t;
        }
        if (pa == a) {
            if (atomicCAS(par + a, a, pb) == a) return 1;
            continue;
        }
        const int g = __ldcg(par + pa);
        if (g != pa) __stcg(par + a, g);
        a = g;
    }
}

// The seam node that the cross edge below bottom-row node v (tile t, slot
// lab < ncols) reaches: the top row of tile t + 1, slots ncols.. unless that
// tile has one row (then its bottom slots).
__device__ __forceinline__ int seam_below(int t, int lab, int ncols, int rows_t,
                                          int tiles, int last_rows, int ss) {
    const int below = t + 1 == tiles - 1 ? last_rows : rows_t;
    return (t + 1) * ss + (below > 1 ? ncols + lab : lab);
}

// The merge with its union-find in shared memory (seam_in_smem).  Threads
// own words of 4 consecutive seam nodes, the words tid + k * SMEM_THREADS.
// A node acts at no more than two levels: its record's (rl) and, for a
// bottom-row node with a tile below, its cross edge's (cl = min of the two
// level counts).  The prologue stores both as byte planes and keeps, in
// registers, a mask of the levels each of the thread's words acts at (bit
// e-1 for e <= 31, bit 31 for every e >= 32), so a level visits only the
// words with work at that level and compares four nodes at once
// (__vcmpeq4).
__global__ void __launch_bounds__(SMEM_THREADS, 1)
seam_merge_smem_kernel(const unsigned char* __restrict__ seam_m,
                       const unsigned int* __restrict__ rec,
                       const int* __restrict__ tile_sum, float* __restrict__ out,
                       int n, int nrows, int ncols, int rows_t, int tiles, int ss) {
    extern __shared__ __align__(16) unsigned char smem[];
    long long* red = (long long*)smem;
    int* top_s = (int*)(red + SMEM_WARPS);
    const int nodes = tiles * ss;
    const int words = (nodes + 3) >> 2;
    unsigned short* par16 = (unsigned short*)(smem + seam_off_par());
    volatile unsigned short* par = par16;
    unsigned int* par32 = (unsigned int*)par16;
    unsigned short* pb_s = (unsigned short*)(smem + seam_off_par() + round16(2 * nodes));
    // level counts, then (after the prologue) cross-edge levels
    unsigned char* cl_s = smem + seam_off_par() + 2 * round16(2 * nodes);
    unsigned char* rl_s = cl_s + round16(nodes);
    const unsigned int* cl32 = (const unsigned int*)cl_s;
    const unsigned int* rl32 = (const unsigned int*)rl_s;
    const int tid = threadIdx.x, lane = tid & 31;
    const int last_rows = nrows - (tiles - 1) * rows_t;

    for (int im = blockIdx.x; im < n; im += gridDim.x) {
        const unsigned char* mi = seam_m + (size_t)im * nodes;
        const unsigned int* ri = rec + (size_t)im * nodes;
        long long acc = 0;
        for (int t = tid; t < tiles; t += SMEM_THREADS) acc += tile_sum[(size_t)im * tiles + t];
        if (tid == 0) *top_s = 0;
        // the nodes (the padding of the last word: level 0, no record)
        for (int v = tid; v < 4 * words; v += SMEM_THREADS) {
            unsigned int r = 0u, mm = 0u;
            if (v < nodes) {
                r = ri[v];
                mm = mi[v];
                par[v] = (unsigned short)v;
                pb_s[v] = (unsigned short)r;
            }
            cl_s[v] = (unsigned char)mm;
            rl_s[v] = (unsigned char)(r >> 16);
        }
        __syncthreads();
        // the cross-edge levels of the thread's words, packed 4 a word
        unsigned int slot[MERGE_SLOTS];
#pragma unroll
        for (int k = 0; k < MERGE_SLOTS; ++k) {
            slot[k] = 0u;
            const int w = tid + k * SMEM_THREADS;
            if (w >= words) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int v = 4 * w + j;
                const int t = v / ss, lab = v - t * ss;
                if (v < nodes && lab < ncols && t + 1 < tiles) {
                    const int q = seam_below(t, lab, ncols, rows_t, tiles, last_rows, ss);
                    slot[k] |= (unsigned int)min(cl_s[v], cl_s[q]) << (8 * j);
                }
            }
        }
        __syncthreads();  // every level count read: overwrite them
        int top = 0;
#pragma unroll
        for (int k = 0; k < MERGE_SLOTS; ++k) {
            const int w = tid + k * SMEM_THREADS;
            if (w >= words) continue;
            ((unsigned int*)cl_s)[w] = slot[k];
            const unsigned int both[2] = {slot[k], rl32[w]};
            slot[k] = 0u;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int lv = (both[i] >> (8 * j)) & 0xffu;
                    if (lv) slot[k] |= 1u << (min(lv, 32) - 1);
                    top = max(top, lv);
                }
        }
        top = __reduce_max_sync(0xffffffffu, top);
        if (lane == 0 && top) atomicMax(top_s, top);
        __syncthreads();
        const int levels = *top_s;

        for (int e = levels; e >= 1; --e) {
            const unsigned int ee = 0x01010101u * (unsigned int)e;
            const int bit = min(e, 32) - 1;
            unsigned int visit = 0u;
#pragma unroll
            for (int k = 0; k < MERGE_SLOTS; ++k) visit |= ((slot[k] >> bit) & 1u) << k;
            while (visit) {
                const int w = tid + (__ffs(visit) - 1) * SMEM_THREADS;
                visit &= visit - 1;
                // bit 8j: node j's record at level e; bit 8j+1: its cross edge
                unsigned int hit = (__vcmpeq4(rl32[w], ee) & 0x01010101u) |
                                   (__vcmpeq4(cl32[w], ee) & 0x02020202u);
                while (hit) {
                    const int b = __ffs(hit) - 1;
                    hit &= hit - 1;
                    const int v = 4 * w + (b >> 3);
                    const int t = v / ss;
                    if (b & 1) {  // the cross edge down
                        const int q = seam_below(t, v - t * ss, ncols, rows_t, tiles,
                                                 last_rows, ss);
                        acc -= e * smem_union<false>(par, par32, v, q, nullptr, 0, 0u);
                    } else {  // replay the tile's join; count it if it joins nothing
                        const int q = t * ss + pb_s[v];
                        if (!smem_union<false>(par, par32, v, q, nullptr, 0, 0u)) acc += e;
                    }
                }
            }
            __syncthreads();  // Kruskal order: each link on its own level
        }
        const long long s = chaos_block_sum(acc, red);
        if (tid == 0) out[im] = (float)s;
    }
}

// The merge with its union-find in a global int32 plane over the image's
// seam nodes (gpar: one plane of `nodes` ints a CTA), for seam sets past
// the shared memory (2048x2048, one-row tiles of 36,864 columns): every
// level scans the CTA's nodes, reading their level counts and records from
// the tile kernel's output.
__global__ void __launch_bounds__(SMEM_THREADS, 1)
seam_merge_plane_kernel(const unsigned char* __restrict__ seam_m,
                        const unsigned int* __restrict__ rec,
                        const int* __restrict__ tile_sum, int* __restrict__ gpar,
                        float* __restrict__ out, int n, int nrows, int ncols,
                        int rows_t, int tiles, int ss) {
    extern __shared__ __align__(16) unsigned char smem[];
    long long* red = (long long*)smem;
    int* top_s = (int*)(red + SMEM_WARPS);
    const int nodes = tiles * ss;
    int* gp = gpar + (size_t)blockIdx.x * nodes;
    const int tid = threadIdx.x, lane = tid & 31;
    const int last_rows = nrows - (tiles - 1) * rows_t;

    for (int im = blockIdx.x; im < n; im += gridDim.x) {
        const unsigned char* mi = seam_m + (size_t)im * nodes;
        const unsigned int* ri = rec + (size_t)im * nodes;
        long long acc = 0;
        for (int t = tid; t < tiles; t += SMEM_THREADS) acc += tile_sum[(size_t)im * tiles + t];
        if (tid == 0) *top_s = 0;
        __syncthreads();
        int top = 0;
        for (int v = tid; v < nodes; v += SMEM_THREADS) {
            __stcg(gp + v, v);
            top = max(top, (int)mi[v]);
        }
        top = __reduce_max_sync(0xffffffffu, top);
        if (lane == 0 && top) atomicMax(top_s, top);
        __syncthreads();
        const int levels = *top_s;

        for (int e = levels; e >= 1; --e) {
            for (int v = tid; v < nodes; v += SMEM_THREADS) {
                const int mm = mi[v];
                if (mm < e) continue;
                const int t = v / ss, lab = v - t * ss;
                const unsigned int r = ri[v];
                if ((int)(r >> 16) == e) {  // replay; count it if it joins nothing
                    if (!global_union(gp, v, t * ss + (int)(r & 0xffffu))) acc += e;
                }
                if (lab < ncols && t + 1 < tiles) {  // the cross edge down
                    const int q = seam_below(t, lab, ncols, rows_t, tiles, last_rows, ss);
                    if (min(mm, (int)mi[q]) == e) acc -= e * global_union(gp, v, q);
                }
            }
            __syncthreads();  // Kruskal order: each link on its own level
        }
        const long long s = chaos_block_sum(acc, red);
        if (tid == 0) out[im] = (float)s;
    }
}

extern "C" int sm_chaos_tiles_max_levels(void) { return MAX_LEVELS; }

extern "C" int sm_chaos_tile_smem_bytes(int rows, int ncols, int nlevels) {
    return chaos_block_smem_bytes(rows, ncols, nlevels);
}

extern "C" int sm_chaos_seam_smem_bytes(int nodes) { return seam_smem_bytes(nodes); }

// C entry point (bound with ctypes).  Launches the tile kernel and the seam
// merge on `stream`.  The plan comes from ops/chaos.py::tile_plan and is
// re-checked here: rows_t * ncols <= 65,536, the tile's shared memory and,
// with seam_in_smem, the merge's within the device's opt-in limit per block
// and at most 65,536 seam nodes.  Scratch, allocated by the caller: seam_m
// (n * nodes) u8, rec (n * nodes) u32, tile_sum (n * tiles) i32, and
// without seam_in_smem gpar (merge_grid * nodes) i32; nodes = tiles * ss.
// Returns cudaGetLastError() after each launch, 0 on success, and
// cudaErrorInvalidValue for a plan or shape the kernels do not take.
extern "C" int sm_chaos_tiles(const float* img, long long stride, const float* thr,
                              float* out, unsigned char* seam_m, unsigned int* rec,
                              int* tile_sum, int* gpar, int n, int nrows, int ncols,
                              int nlevels, int rows_t, int seam_in_smem,
                              int merge_grid, void* stream) {
    static int sms[SMEM_MAX_DEVICES], optin[SMEM_MAX_DEVICES];
    if (n <= 0) return 0;
    if (nlevels <= 0 || nlevels > MAX_LEVELS || nrows <= 0 || ncols <= 0 ||
        rows_t <= 0 || rows_t > nrows || (long long)rows_t * ncols > SMEM_MAX_PIXELS ||
        merge_grid <= 0 || merge_grid > n)
        return (int)cudaErrorInvalidValue;
    const int tiles = (nrows + rows_t - 1) / rows_t;
    const int ss = rows_t > 1 ? 2 * ncols : ncols;
    const long long nodes = (long long)tiles * ss;
    if ((long long)n * tiles > 0x7fffffffLL || nodes > 0x3fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (seam_in_smem ? nodes > SMEM_MAX_PIXELS : gpar == nullptr)
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
            err = cudaFuncSetAttribute(chaos_tile_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, o);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(seam_merge_smem_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, o);
        if (err != cudaSuccess) return (int)err;
        sms[dev] = s;
        optin[dev] = o;
    }
    const int tile_bytes = chaos_block_smem_bytes(rows_t, ncols, nlevels);
    const int merge_bytes = seam_in_smem ? seam_smem_bytes((int)nodes) : seam_off_par();
    if (tile_bytes > optin[dev] || merge_bytes > optin[dev])
        return (int)cudaErrorInvalidValue;
    const int vec4 = ((uintptr_t)img % 16 == 0) && stride % 4 == 0 && ncols % 4 == 0;
    const int pairs = n * tiles;
    const int grid = pairs < sms[dev] ? pairs : sms[dev];
    cudaStream_t st = (cudaStream_t)stream;
    chaos_tile_kernel<<<grid, SMEM_THREADS, tile_bytes, st>>>(
        img, stride, thr, seam_m, rec, tile_sum, n, nrows, ncols, nlevels, rows_t,
        tiles, ss, vec4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (seam_in_smem)
        seam_merge_smem_kernel<<<merge_grid, SMEM_THREADS, merge_bytes, st>>>(
            seam_m, rec, tile_sum, out, n, nrows, ncols, rows_t, tiles, ss);
    else
        seam_merge_plane_kernel<<<merge_grid, SMEM_THREADS, merge_bytes, st>>>(
            seam_m, rec, tile_sum, gpar, out, n, nrows, ncols, rows_t, tiles, ss);
    return (int)cudaGetLastError();
}
