// The two-level solve's coarse pass (kubebatch_tpu/kernels/hier.py:160
// _coarse_pass, :208 hier_allocate's winner), shared by the one-card
// kernel (hier_allocate.cu, over the whole node axis) and the node-sharded
// one (sharded_round.cu, over a rank's block, whose bits and pool scores
// the ranks combine by OR and max before the winner is chosen).
//
// The nodes are those of the Params' node arrays, [0, nn), which are the
// global nodes g0 .. g0 + nn of the pooled axis: pool b is the global
// nodes [b * pool, (b + 1) * pool), and a pass over a block sees the
// part of each pool the block holds (possibly none).
#pragma once

#include "batched_round.cuh"

namespace {

// [start, end) of pool b's part of the nodes [0, nn) (global g0 + n)
__device__ __forceinline__ void pool_part(int b, int pool, int g0, int nn,
                                          int* start, int* end) {
    *start = min(max(b * pool - g0, 0), nn);
    *end = min(max((b + 1) * pool - g0, 0), nn);
}

// grid, one warp per row r < rows that ``row(r, &sig, init)`` accepts: per
// pool b, whether any node of the pool's part passes c.cell, the warp
// stopping at the first eligible node of each part; one bit per pool
// into bits + r * BW. Returns this thread's (rows tested, cells needed:
// per row and part, the nodes up to and including the first eligible
// one, or the whole part) for the caller's counters.
template <class Cy, class Row>
__device__ void coarse_bits(const Cy& c, int rows, int B, int BW,
                            int pool, int g0, int nn, uint32_t* bits,
                            Row row, unsigned long long* tested,
                            unsigned long long* cells) {
    for (int r = c.gwarp; r < rows; r += c.nwarps) {
        float init[3];
        int sig;
        if (!row(r, &sig, init)) continue;
        uint32_t* out = bits + (size_t)r * BW;
        uint32_t word = 0;
        for (int b = 0; b < B; ++b) {
            int start, end;
            pool_part(b, pool, g0, nn, &start, &end);
            bool any = false;
            for (int n0 = start; n0 < end && !any; n0 += 32) {
                const int n = n0 + c.lane;
                const uint32_t m = __ballot_sync(
                    FULL, n < end && c.cell(sig, init, n));
                any = m != 0;
                *cells += any ? __ffs(m) : min(32, end - n0);
            }
            if (any) word |= 1u << (b & 31);
            if ((b & 31) == 31 || b == B - 1) {
                if (c.lane == 0) out[b >> 5] = word;
                word = 0;
            }
        }
        ++*tested;
    }
}

// coarse_bits with one warp per (row, pool) instead of per row, so a row's
// pools are walked side by side: the same bits (OR-ed into words the
// caller zeroed before its last barrier, by integer atomics), rows and
// cells (a row counted by its pool-0 warp)
template <class Cy, class Row>
__device__ void coarse_bits_split(const Cy& c, int rows, int B, int BW,
                                  int pool, int g0, int nn, uint32_t* bits,
                                  Row row, unsigned long long* tested,
                                  unsigned long long* cells) {
    for (int q = c.gwarp; q < rows * B; q += c.nwarps) {
        const int r = q / B, b = q - r * B;
        float init[3];
        int sig;
        if (!row(r, &sig, init)) continue;
        int start, end;
        pool_part(b, pool, g0, nn, &start, &end);
        bool any = false;
        for (int n0 = start; n0 < end && !any; n0 += 32) {
            const int n = n0 + c.lane;
            const uint32_t m = __ballot_sync(
                FULL, n < end && c.cell(sig, init, n));
            any = m != 0;
            *cells += any ? __ffs(m) : min(32, end - n0);
        }
        if (any && c.lane == 0)
            atomicOr(bits + (size_t)r * BW + (b >> 5), 1u << (b & 31));
        if (b == 0) ++*tested;
    }
}

// every block: the demand-majority pair, argmax of dem[0..P) (lowest
// index on ties)
template <class Cy>
__device__ int coarse_majority(const Cy& c, const int32_t* dem, int P) {
    __shared__ int s_v[NT / 32], s_i[NT / 32];
    int bv = -1, bi = 0;
    for (int q = threadIdx.x; q < P; q += blockDim.x) {
        const int v = dem[q];
        if (v > bv) { bv = v; bi = q; }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const int ov = __shfl_xor_sync(FULL, bv, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    if (c.lane == 0) {
        s_v[threadIdx.x >> 5] = bv;
        s_i[threadIdx.x >> 5] = bi;
    }
    __syncthreads();
    int maj = s_i[0];
    for (int i = 1, v = s_v[0]; i < NT / 32; ++i)
        if (s_v[i] > v || (s_v[i] == v && s_i[i] < maj)) {
            v = s_v[i];
            maj = s_i[i];
        }
    __syncthreads();
    return maj;
}

// node n's score for pair maj in the coarse pass: the pair's sig row
// plus the dynamic term, the two-level graphs' one FMA
// (kernels/xla_order.py WEIGHTED_SUM_FMA); -3e38 where its predicate row
// or the room rule it out
__device__ __forceinline__ float coarse_score(const Params& p, const Work& w,
                                              int msig, int maj, float w0,
                                              float w1, int n) {
    float v = p.sig_scores[(size_t)msig * p.NS + n];
    if (p.dyn)
        v = v + kb::scan_node_score(
            p.nz[n * 2], p.nz[n * 2 + 1], p.pair_nz[maj * 2],
            p.pair_nz[maj * 2 + 1], p.cap[n * 2], p.cap[n * 2 + 1], w0, w1);
    const bool ok = p.sig_pred[(size_t)msig * p.NS + n] && w.basep[n];
    return ok ? v : -3.0e38f;
}

// grid, one warp a pool: the best score of pair maj over the pool's part
// of [0, nn) (coarse_score; an empty part -inf). max is exact in any
// order.
template <class Cy>
__device__ void coarse_best(const Cy& c, const Params& p, const Work& w,
                            int maj, int B, int pool, int g0, int nn,
                            float* best) {
    const int msig = p.pair_sig[maj];
    const float w0 = p.dynw[0], w1 = p.dynw[1];
    for (int b = c.gwarp; b < B; b += c.nwarps) {
        int start, end;
        pool_part(b, pool, g0, nn, &start, &end);
        float m = -INFINITY;
        for (int n = start + c.lane; n < end; n += 32)
            m = fmaxf(m, coarse_score(p, w, msig, maj, w0, w1, n));
        for (int o = 16; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        if (c.lane == 0) best[b] = m;
    }
}

// coarse_best with each pool's part cut into S segments of whole 32-node
// chunks, one warp a (pool, segment): segment s of pool b's maximum into
// part[b * S + s] (an empty segment -inf); coarse_best_fold then takes
// each pool's maximum over its segments
template <class Cy>
__device__ void coarse_best_split(const Cy& c, const Params& p,
                                  const Work& w, int maj, int B, int pool,
                                  int g0, int nn, int S, float* part) {
    const int msig = p.pair_sig[maj];
    const float w0 = p.dynw[0], w1 = p.dynw[1];
    for (int q = c.gwarp; q < B * S; q += c.nwarps) {
        const int b = q / S, s = q - b * S;
        int start, end;
        pool_part(b, pool, g0, nn, &start, &end);
        const int width = (end - start + 32 * S - 1) / (32 * S) * 32;
        const int lo = min(end, start + s * width);
        const int hi = min(end, lo + width);
        float m = -INFINITY;
        for (int n = lo + c.lane; n < hi; n += 32)
            m = fmaxf(m, coarse_score(p, w, msig, maj, w0, w1, n));
        for (int o = 16; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        if (c.lane == 0) part[q] = m;
    }
}

// block, one warp a pool: best[b] = max over part[b * S .. b * S + S)
__device__ void coarse_best_fold(const float* part, int B, int S,
                                 float* best) {
    const int lane = threadIdx.x & 31;
    for (int b = threadIdx.x >> 5; b < B; b += blockDim.x >> 5) {
        float m = -INFINITY;
        for (int s = lane; s < S; s += 32) m = fmaxf(m, part[b * S + s]);
        for (int o = 16; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        if (lane == 0) best[b] = m;
    }
    __syncthreads();
}

// grid: cand[b] += the pending tasks t < T whose pool bits (bits_of(t),
// BW words) have b
template <class Cy, class Bits>
__device__ void coarse_candidates(const Cy& c, int T,
                                  const uint8_t* pending, int BW,
                                  Bits bits_of, int32_t* cand) {
    for (int t = c.gtid; t < T; t += c.gsize) {
        if (!pending[t]) continue;
        const uint32_t* tb = bits_of(t);
        for (int wi = 0; wi < BW; ++wi) {
            uint32_t m = tb[wi];
            while (m) {
                const int i = __ffs(m) - 1;
                m &= m - 1;
                atomicAdd(&cand[wi * 32 + i], 1);
            }
        }
    }
}

// one thread: the winner, the best-scoring pool with candidates that is
// not quarantined (lowest index on ties); writes has-work, the winner,
// the pools with candidates and the winner's candidates into hs[0..4)
__device__ void coarse_winner(const int32_t* cand, const uint8_t* blocked,
                              const float* best, int B, int32_t* hs) {
    float kv = -INFINITY;
    int win = 0, occ = 0;
    bool work = false;
    for (int b = 0; b < B; ++b) {
        occ += cand[b] > 0;
        const float key = (cand[b] > 0 && !blocked[b]) ? best[b]
                                                       : -INFINITY;
        work = work || key > -INFINITY;
        if (key > kv) { kv = key; win = b; }
    }
    hs[0] = work;
    hs[1] = win;
    hs[2] = occ;
    hs[3] = cand[win];
}

}  // namespace
