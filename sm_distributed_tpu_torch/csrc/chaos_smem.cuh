// Device code shared by the chaos kernels that keep a union-find in shared
// memory (csrc/chaos.cu's whole-image kernel and csrc/chaos_strips.cu's row
// tiles), hand-written for Hopper (sm_90a).
//
// One CTA of SMEM_THREADS threads counts the components of one block of at
// most 65,536 pixels: a whole image, or a tile of whole rows of a larger
// image.  For each pixel its level count m[p] = #{l : max(x[p], 0) > thr[l]}
// (thresholds rise with l, so p is in the mask of level l iff l < m[p]); the
// function returns, summed over the block's threads,
//   sum over levels of components = sum_p m[p] - sum over joins of e,
// where level e = top .. 1 adds the edges (p, q) with min(m[p], m[q]) == e
// to the forest of the levels above it (masks only grow as the threshold
// drops), and every join of two trees at level e removes one component at
// the e levels 0 .. e-1.  A barrier between levels keeps each link on its
// own level (Kruskal order).
//
// Shared memory of the CTA (all dynamic, each part 16-byte aligned;
// chaos_block_smem_bytes, mirrored by ops/chaos.py::chaos_smem_bytes):
//   red    33 ints: per-warp partial sums, then the block's top level count
//   thr    nlevels floats: the image's thresholds
//   par    P uint16 parent labels: labels 0..65535 are exactly the pixels
//   lev    nrows rows of round_up(ncols + 1, 4) bytes, level counts, plus one
//          zero word past the last row
// The padding bytes of each row hold level 0, so the right edge of a row's
// last pixel and every edge of a padding byte have level min(m, 0) = 0 and
// are never linked, without a column test.
//
// Work: threads own 4-pixel words of the lev plane (word w: row w / (S/4)),
// the words tid + k * SMEM_THREADS, in every pass:
// - pass A reads the word's pixels once (16-byte loads when aligned), finds m
//   by binary search over the thresholds, writes the lev word and the
//   singleton par[label(p)] = label(p) for m > 0, and sums m and its maximum;
// - the right and down edge levels of a word are the byte-wise minima of its
//   lev word with the word shifted one byte (right) and the word a row below
//   (down), four bytes at a time (__vminu4); a thread keeps, in registers, a
//   mask of the edge levels each of its first SMEM_SLOTS words holds, so a
//   level visits only the words with an edge at that level (words past the
//   slots are scanned at every level);
// - levels e = top .. 1, with a barrier between levels: a visited word's
//   edges at level e (__vcmpeq4) each link two pixels.
// Pixels with m = 0 are never a link's end nor on a chain, so their labels
// are never set nor read.
//
// Labels.  The whole-image kernel labels pixel p with p.  A row tile
// (TILE = true) labels pixel p with (p + ncols) mod P: its bottom row takes
// labels 0 .. ncols-1 and its top row ncols .. 2*ncols-1, so the seam pixels
// (the rows a tile shares an edge with its neighbours through) carry the S
// smallest labels (S = 2*ncols, or ncols for a one-row tile, whose one row
// is both).  Labels fall along every chain, so a root is the smallest label
// of its tree, and every tree that holds a seam pixel has a seam pixel as
// its root.  A join that hangs root a under pb with a < S therefore joins
// two trees that both hold seam pixels (pb < a is one too), and the tile
// records it as rec[a] = pb | e << 16: a root is replaced at most once, so
// each a is written at most once, and the records are exactly the joins
// that change how the tile connects its seam pixels.  The seam merge
// (csrc/chaos_strips.cu) replays them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SMEM_THREADS 1024
#define SMEM_WARPS (SMEM_THREADS / 32)
#define SMEM_MAX_PIXELS 65536
#define SMEM_MAX_DEVICES 64
#define MAX_LEVELS 255
// lev words a thread keeps level masks for, in registers: 17 * 1024 covers
// the 16,640 words of a 256x256 image, 16,448 of a 64x1024 tile and 16,392
// of an 8x8192 tile
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
__host__ __device__ __forceinline__ int chaos_block_smem_bytes(int nrows, int ncols,
                                                               int nlevels) {
    return smem_off_lev(nrows * ncols, nlevels) + nrows * lev_row_bytes(ncols) + 4;
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
//
// With TILE, a join that hangs a root a < S records rec[a] = pb | tag (tag:
// the level e << 16), as the header comment says.
template <bool TILE>
__device__ __forceinline__ int smem_union(volatile unsigned short* par,
                                          unsigned int* par32, int a, int b,
                                          unsigned int* rec, int S,
                                          unsigned int tag) {
    while (true) {
        int pa = par[a], pb = par[b];
        if (pa == pb) return 0;  // a common parent: one tree
        if (pa < pb) {
            int t = a; a = b; b = t;
            t = pa; pa = pb; pb = t;
        }
        if (pa == a) {  // a is a root, pb < a
            if (smem_cas_label(par32, a, (unsigned int)a, (unsigned int)pb)) {
                if (TILE && a < S) rec[a] = (unsigned int)pb | tag;
                return 1;
            }
            continue;  // a was linked meanwhile: read again
        }
        const int g = par[pa];
        if (g != pa) par[a] = (unsigned short)g;
        a = g;
    }
}

// The label of pixel p of a block of P pixels (see the header comment).
template <bool TILE>
__device__ __forceinline__ int block_label(int p, int ncols, int P) {
    if (!TILE) return p;
    const int l = p + ncols;
    return l >= P ? l - P : l;
}

// Link the edges of lev word w (row `row`) whose level is e (ee: e in each
// byte): the right and down edges whose byte-wise level minimum is e.
// Returns the number of joins.
template <bool TILE>
__device__ __forceinline__ int smem_link_word(volatile unsigned short* par,
                                              unsigned int* par32,
                                              const unsigned int* lev32, int w,
                                              int row, int nrows, int ncols,
                                              int WR, unsigned int ee,
                                              unsigned int* rec, int S) {
    const unsigned int cur = lev32[w];
    if (!cur) return 0;
    const unsigned int right = __funnelshift_r(cur, lev32[w + 1], 8);
    const unsigned int down = row + 1 < nrows ? lev32[w + WR] : 0u;
    // bit 8j: right edge of byte j at level e; bit 8j+1: its down edge
    unsigned int hit = (__vcmpeq4(__vminu4(cur, right), ee) & 0x01010101u) |
                       (__vcmpeq4(__vminu4(cur, down), ee) & 0x02020202u);
    const int P = nrows * ncols;
    const int p = row * ncols + ((w - row * WR) << 2);
    const unsigned int tag = (ee & 0xffu) << 16;
    int links = 0;
    while (hit) {
        const int k = __ffs(hit) - 1;
        hit &= hit - 1;
        const int a = p + (k >> 3);
        const int b = (k & 1) ? a + ncols : a + 1;
        links += smem_union<TILE>(par, par32, block_label<TILE>(a, ncols, P),
                                  block_label<TILE>(b, ncols, P), rec, S, tag);
    }
    return links;
}

// The count of one block (whole image or row tile) of nrows x ncols pixels
// at x (rows contiguous), with the image's thresholds thr: returns this
// thread's share of sum_p m[p] - sum over joins of e.  With TILE, also
// writes the level count of each seam pixel to seam_m[label], clears
// rec[label] in pass A and records the seam joins in rec.  Starts by
// writing shared memory that the previous block may still read: the caller
// puts a barrier between two calls (chaos_block_sum ends with one).
template <bool TILE>
__device__ __forceinline__ int chaos_block_count(const float* __restrict__ x,
                                                 const float* __restrict__ thr,
                                                 int nrows, int ncols, int nlevels,
                                                 int vec4, unsigned char* smem,
                                                 unsigned char* seam_m,
                                                 unsigned int* rec) {
    const int P = nrows * ncols;
    const int S = TILE ? (nrows > 1 ? 2 * ncols : ncols) : 0;
    const int WR = lev_row_bytes(ncols) >> 2;  // lev words a row
    const int words = nrows * WR;
    int* top_s = (int*)smem + SMEM_WARPS;
    float* thr_s = (float*)(smem + smem_off_thr());
    unsigned short* par16 = (unsigned short*)(smem + smem_off_par(nlevels));
    volatile unsigned short* par = par16;
    unsigned int* par32 = (unsigned int*)par16;
    unsigned int* lev32 = (unsigned int*)(smem + smem_off_lev(P, nlevels));

    const int tid = threadIdx.x, lane = tid & 31;
    // the thread's first word as (row, word in row), and the step between
    // its words (SMEM_THREADS words), so no pass divides
    const int row0 = tid / WR, cw0 = tid % WR;
    const int drow = SMEM_THREADS / WR, dcw = SMEM_THREADS % WR;
    for (int l = tid; l < nlevels; l += SMEM_THREADS) thr_s[l] = thr[l];
    if (tid == 0) {
        *top_s = 0;
        lev32[words] = 0u;  // right neighbours of the last word
    }
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
                const int lab = block_label<TILE>(p + j, ncols, P);
                if (lo) par[lab] = (unsigned short)lab;
                if (TILE && lab < S) {
                    seam_m[lab] = (unsigned char)lo;
                    rec[lab] = 0u;
                }
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
            links += smem_link_word<TILE>(par, par32, lev32, w, w / WR, nrows, ncols,
                                          WR, ee, rec, S);
        }
        // words past the slots (more than SMEM_SLOTS words a thread):
        // scanned at every level
        for (int w = tid + SMEM_SLOTS * SMEM_THREADS; w < words; w += SMEM_THREADS)
            links += smem_link_word<TILE>(par, par32, lev32, w, w / WR, nrows, ncols,
                                          WR, ee, rec, S);
        acc -= e * links;
        __syncthreads();  // Kruskal order: each link on its own level
    }
    return acc;
}

// Sum of v over the block, valid in thread 0; `red` holds SMEM_WARPS ints.
// Ends with a barrier, so shared memory may be rewritten after it.
template <typename T>
__device__ __forceinline__ T chaos_block_sum(T v, T* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    T s = 0;
    if (threadIdx.x == 0)
        for (int w = 0; w < SMEM_WARPS; ++w) s += red[w];
    __syncthreads();
    return s;
}
