// jax.lax.associative_scan with the reference's segmented combine, run by
// a thread-block cluster: each CTA scans one aligned tile of the scan
// order in its own level storage, and only the tiles' top elements cross
// CTAs, through distributed shared memory between cluster barriers. Used
// by the victim analysis (victims.cu); seg_scan.cuh's one-block SegScan
// stays as it is for the round kernels.
//
// Why the result is the one-block tree's, bit for bit: element i of level
// l of jax's odd/even tree combines the aligned rows [i 2^l, (i+1) 2^l),
// so a tile of S = 2^k rows at an aligned offset holds its own elements of
// levels 0..k, and the up-sweep of those levels is the whole tree's. Level
// k has one element per full tile; the levels above it are the tree of
// those elements, which every CTA computes alike from the C tops it reads
// through DSMEM. On the way down, the first element of a tile's level l
// combines the last element of the previous tile's level l+1, and that is,
// down an unbroken chain of odd indices, the previous tile's level-k
// result: one carry per tile. A tail tile shorter than S (V not a multiple
// of S, as V_pad 20,480 is) has no level-k element; its level counts are
// floor(cnt0 / 2^l) exactly as the whole tree's are, and its highest
// element takes the carry. Float additions are the combine's own, in the
// tree's order; only which thread performs them changes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kb {

// a tile's top element as the other CTAs read it
struct ScanTop {
    float v[3];
    uint32_t f;
};

// most tiles (cluster CTAs) the top tree takes
constexpr int kMaxTiles = 16;

__device__ __forceinline__ void seg_comb3(const float* av, uint8_t af,
                                          const float* bv, uint8_t bf,
                                          float* ov, uint8_t* of) {
    float o0 = bf ? bv[0] : av[0] + bv[0];
    float o1 = bf ? bv[1] : av[1] + bv[1];
    float o2 = bf ? bv[2] : av[2] + bv[2];
    ov[0] = o0;
    ov[1] = o1;
    ov[2] = o2;
    *of = af | bf;
}

// One CTA's part of a cluster scan of (float[3], flag) elements. Level l of
// the tile lives at element offset 2S - 2S/2^l of v (3 floats an element)
// and f (one byte); the caller fills level 0 (cnt0 elements) and finds the
// inclusive result there after run(). The storage may be shared or global
// memory (generic pointers): it is this CTA's alone.
struct ClusterSegScan3 {
    float* v;
    uint8_t* f;
    int k;       // log2 of the tile size S
    int tile;    // this CTA's tile (its cluster rank)
    int cnt0;    // the tile's rows: S, fewer in the tail tile, or 0
    int full;    // tiles with a level-k element: V >> k

    static __host__ __device__ size_t elems(int k) {
        return (size_t)2 << k;
    }
    __device__ int off(int l) const {
        return (2 << k) - ((2 << k) >> l);
    }

    // Every thread of every CTA of the cluster calls run(); ``top`` is the
    // same __shared__ slot in every CTA, free for this scan (the caller
    // gives consecutive scans different slots, and a later cluster barrier
    // frees a slot again). A cluster of one CTA synchronises as a block.
    __device__ void run(cooperative_groups::cluster_group& cl,
                        ScanTop* top) const {
        __shared__ float s_carry[3];
        __shared__ uint8_t s_carry_f;
        const int tid = threadIdx.x, nt = blockDim.x;
        __syncthreads();
        for (int l = 0; l < k; ++l) {
            const int h = cnt0 >> (l + 1);
            const int lo = off(l), hi = off(l + 1);
            for (int j = tid; j < h; j += nt)
                seg_comb3(v + 3 * (size_t)(lo + 2 * j), f[lo + 2 * j],
                          v + 3 * (size_t)(lo + 2 * j + 1),
                          f[lo + 2 * j + 1], v + 3 * (size_t)(hi + j),
                          f + hi + j);
            __syncthreads();
        }
        const int kt = off(k);
        if (tid == 0 && tile < full) {
            for (int r = 0; r < 3; ++r) top->v[r] = v[3 * (size_t)kt + r];
            top->f = f[kt];
        }
        if (cl.num_blocks() > 1)
            cl.sync();
        else
            __syncthreads();
        if (tid < 32 && full > 0 && tile <= full && cnt0 > 0)
            top_tree(cl, top, s_carry, &s_carry_f);
        __syncthreads();
        for (int l = k - 1; l >= 0; --l) {
            const int n = cnt0 >> l;
            const int lo = off(l), hi = off(l + 1);
            for (int j = tid; j < n; j += nt) {
                float* o = v + 3 * (size_t)(lo + j);
                if (j & 1) {
                    const float* s = v + 3 * (size_t)(hi + j / 2);
                    o[0] = s[0];
                    o[1] = s[1];
                    o[2] = s[2];
                    f[lo + j] = f[hi + j / 2];
                } else if (j > 0) {
                    seg_comb3(v + 3 * (size_t)(hi + j / 2 - 1),
                              f[hi + j / 2 - 1], o, f[lo + j], o,
                              f + lo + j);
                } else if (tile > 0) {
                    seg_comb3(s_carry, s_carry_f, o, f[lo], o, f + lo);
                }
            }
            __syncthreads();
        }
    }

    // The tree of the ``full`` level-k elements (jax's algorithm on them)
    // by warp 0: its lanes read the tops through DSMEM at once, then take
    // one element each at every level (a warp barrier between levels);
    // stores this tile's result into its level-k element and the previous
    // tile's result into carry.
    __device__ void top_tree(cooperative_groups::cluster_group& cl,
                             ScanTop* top, float* carry,
                             uint8_t* carry_f) const {
        constexpr int kLevels = 5;    // log2(kMaxTiles) + 1
        __shared__ float ev[2 * kMaxTiles][3], rv[2 * kMaxTiles][3];
        __shared__ uint8_t ef[2 * kMaxTiles], rf[2 * kMaxTiles];
        const int lane = threadIdx.x;
        if (lane < full) {
            const ScanTop* p = cl.map_shared_rank(top, lane);
            ev[lane][0] = p->v[0];
            ev[lane][1] = p->v[1];
            ev[lane][2] = p->v[2];
            ef[lane] = (uint8_t)p->f;
        }
        int ns[kLevels], offs[kLevels];
        int L = 0;
        ns[0] = full;
        offs[0] = 0;
#pragma unroll
        for (int l = 0; l + 1 < kLevels; ++l) {
            if (l == L && ns[l] >= 2) {
                offs[l + 1] = offs[l] + ns[l];
                ns[l + 1] = ns[l] / 2;
                ++L;
            }
        }
        __syncwarp();
#pragma unroll
        for (int l = 0; l + 1 < kLevels; ++l) {
            if (l < L && lane < ns[l + 1]) {
                const int a = offs[l] + 2 * lane, o = offs[l + 1] + lane;
                seg_comb3(ev[a], ef[a], ev[a + 1], ef[a + 1], ev[o], ef + o);
            }
            __syncwarp();
        }
#pragma unroll
        for (int l = 0; l < kLevels; ++l) {
            if (l == L && lane < ns[l]) {
                const int s = offs[l] + lane;
                rv[s][0] = ev[s][0];
                rv[s][1] = ev[s][1];
                rv[s][2] = ev[s][2];
                rf[s] = ef[s];
            }
        }
        __syncwarp();
#pragma unroll
        for (int l = kLevels - 2; l >= 0; --l) {
            if (l < L && lane < ns[l]) {
                const int o = offs[l] + lane;
                if (lane & 1) {
                    const int s = offs[l + 1] + lane / 2;
                    rv[o][0] = rv[s][0];
                    rv[o][1] = rv[s][1];
                    rv[o][2] = rv[s][2];
                    rf[o] = rf[s];
                } else if (lane == 0) {
                    rv[o][0] = ev[o][0];
                    rv[o][1] = ev[o][1];
                    rv[o][2] = ev[o][2];
                    rf[o] = ef[o];
                } else {
                    const int s = offs[l + 1] + lane / 2 - 1;
                    seg_comb3(rv[s], rf[s], ev[o], ef[o], rv[o], rf + o);
                }
            }
            __syncwarp();
        }
        if (lane != 0) return;
        const int kt = off(k);
        if (tile < full) {
            for (int d = 0; d < 3; ++d) v[3 * (size_t)kt + d] = rv[tile][d];
            f[kt] = rf[tile];
        }
        if (tile > 0) {
            for (int d = 0; d < 3; ++d) carry[d] = rv[tile - 1][d];
            *carry_f = rf[tile - 1];
        }
    }
};

}  // namespace kb
