// The unschedulability explainer's per-task failure counts, one launch.
//
// Replaces kubebatch_tpu/obs/explain.py:57 _explain_kernel (the jitted
// [T, N] reduction behind failure_counts_device). For every task row t
// it counts, over the candidate nodes (node_ok), the nodes that fail
// each reason, and the nodes that pass all of them:
//   col 0  predicate      sig_pred[task_sig[t], n] is false
//   col 1  resources      some d in 0..2 has !(resreq[t, d] <= idle[n, d])
//                         (the plain float compare: no epsilon, no
//                         arithmetic, so no rounding question)
//   col 2  task-slots     !(n_tasks[n] < max_task_num[n])
//   col 3  port-conflict  a port the task requires is claimed on n
//                         (has_ports only; else the column is 0)
//   col 4  eligible       the node fails none of the four
//   col 5  n_cand         the candidate count, on every row
// Columns 0-4 are 0 on a padded task row (task_valid false). All counts
// are integers, so the result equals the plain version bit for bit.
//
// Bound: operations. The inputs are a few MB at the largest shipped
// shape (T_pad 16,384 x N_pad 8,192: sig_pred is [S_pad, N_pad] bytes
// with a handful of signature rows), while the work is a dozen integer
// and compare instructions per (task, candidate node) cell: ~5e7 real
// cells at cfg5. The design keeps node data out of device memory's way
// and every count in registers:
//   - a block of 256 threads owns 32 task rows (4 per warp) and walks the
//     nodes in tiles of 256: the tile's node data (idle, the candidate
//     and slot bits, the port word) is staged in shared memory once and
//     read by all 32 rows; a tile with no candidate node is skipped;
//   - a lane takes every 32nd node of the tile, so the warp's reads of a
//     task's sig_pred row are contiguous bytes;
//   - each task's required ports become one 64-bit word (two
//     __ballot_sync over its PT <= 64 bools), each node's claimed ports
//     another (built in the tile load), and a conflict is one AND;
//   - per lane five int counters a row; at the end each is summed over
//     the warp with __reduce_add_sync (no atomics) and lane 0 writes the
//     row. The candidate count is the sum of __syncthreads_count over the
//     tiles, the same in every block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTile = 256;

__global__ void __launch_bounds__(kThreads)
explain_counts_kernel(const float* __restrict__ idle,          // [N, 3]
                      const uint8_t* __restrict__ node_ok,     // [N]
                      const int32_t* __restrict__ n_tasks,     // [N]
                      const int32_t* __restrict__ max_task_num,// [N]
                      const uint8_t* __restrict__ sig_pred,    // [S, N]
                      const int32_t* __restrict__ task_sig,    // [T]
                      const uint8_t* __restrict__ task_valid,  // [T]
                      const float* __restrict__ resreq,        // [T, 3]
                      const uint8_t* __restrict__ task_ports,  // [T, PT]
                      const uint8_t* __restrict__ port_base,   // [N, PT]
                      int t_pad, int n_pad, int pt, int has_ports,
                      int32_t* __restrict__ out) {             // [T, 6]
    __shared__ float s_idle[3][kTile];
    __shared__ uint8_t s_cand[kTile];
    __shared__ uint8_t s_slot[kTile];
    __shared__ unsigned long long s_port[kTile];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

    // this warp's task rows: request, signature row, port word, validity
    float rr[kRowsPerWarp][3];
    const uint8_t* pred_row[kRowsPerWarp];
    unsigned long long tport[kRowsPerWarp];
    bool live[kRowsPerWarp];
    int cnt[kRowsPerWarp][5];
    bool any_live = false;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        const int t = row0 + r;
        live[r] = t < t_pad && task_valid[t] != 0;
        any_live |= live[r];
        const int tt = t < t_pad ? t : 0;
        rr[r][0] = resreq[tt * 3 + 0];
        rr[r][1] = resreq[tt * 3 + 1];
        rr[r][2] = resreq[tt * 3 + 2];
        pred_row[r] = sig_pred + (long long)task_sig[tt] * n_pad;
        unsigned lo = 0u, hi = 0u;
        if (has_ports) {
            const uint8_t* tp = task_ports + (long long)tt * pt;
            lo = __ballot_sync(0xffffffffu, lane < pt && tp[lane] != 0);
            hi = __ballot_sync(0xffffffffu,
                               lane + 32 < pt && tp[lane + 32] != 0);
        }
        tport[r] = ((unsigned long long)hi << 32) | lo;
#pragma unroll
        for (int c = 0; c < 5; ++c) cnt[r][c] = 0;
    }

    int n_cand = 0;
    for (int base = 0; base < n_pad; base += kTile) {
        const int i = threadIdx.x;
        const int n = base + i;
        int cand = 0;
        if (n < n_pad) {
            cand = node_ok[n] != 0;
            s_idle[0][i] = idle[n * 3 + 0];
            s_idle[1][i] = idle[n * 3 + 1];
            s_idle[2][i] = idle[n * 3 + 2];
            s_slot[i] = n_tasks[n] < max_task_num[n];
            unsigned long long w = 0ull;
            if (has_ports) {
                const uint8_t* pb = port_base + (long long)n * pt;
                for (int k = 0; k < pt; ++k)
                    w |= (unsigned long long)(pb[k] != 0) << k;
            }
            s_port[i] = w;
        }
        s_cand[i] = (uint8_t)cand;
        const int tile_cand = __syncthreads_count(cand);
        n_cand += tile_cand;
        if (tile_cand > 0 && any_live) {
            const int width = min(kTile, n_pad - base);
            for (int j = lane; j < width; j += 32) {
                if (!s_cand[j]) continue;
                const float i0 = s_idle[0][j], i1 = s_idle[1][j],
                            i2 = s_idle[2][j];
                const bool slot_ok = s_slot[j] != 0;
                const unsigned long long pw = s_port[j];
#pragma unroll
                for (int r = 0; r < kRowsPerWarp; ++r) {
                    if (!live[r]) continue;
                    const bool p_ok = pred_row[r][base + j] != 0;
                    const bool r_ok = (rr[r][0] <= i0) & (rr[r][1] <= i1)
                                      & (rr[r][2] <= i2);
                    const bool o_ok = (tport[r] & pw) == 0ull;
                    cnt[r][0] += !p_ok;
                    cnt[r][1] += !r_ok;
                    cnt[r][2] += !slot_ok;
                    cnt[r][3] += !o_ok;
                    cnt[r][4] += p_ok & r_ok & slot_ok & o_ok;
                }
            }
        }
        __syncthreads();            // the tile is reused by the next load
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        const int t = row0 + r;
        int sum[5];
#pragma unroll
        for (int c = 0; c < 5; ++c)
            sum[c] = __reduce_add_sync(0xffffffffu, cnt[r][c]);
        if (lane == 0 && t < t_pad) {
            int32_t* o = out + (long long)t * 6;
#pragma unroll
            for (int c = 0; c < 5; ++c) o[c] = live[r] ? sum[c] : 0;
            o[5] = n_cand;
        }
    }
}

}  // namespace

extern "C" int kb_explain_counts(const void* idle, const void* node_ok,
                                 const void* n_tasks,
                                 const void* max_task_num,
                                 const void* sig_pred, const void* task_sig,
                                 const void* task_valid, const void* resreq,
                                 const void* task_ports,
                                 const void* port_base, int t_pad,
                                 int n_pad, int pt, int has_ports, void* out,
                                 void* stream) {
    if (t_pad <= 0) return 0;
    const int blocks = (t_pad + kRowsPerBlock - 1) / kRowsPerBlock;
    explain_counts_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)idle, (const uint8_t*)node_ok,
        (const int32_t*)n_tasks, (const int32_t*)max_task_num,
        (const uint8_t*)sig_pred, (const int32_t*)task_sig,
        (const uint8_t*)task_valid, (const float*)resreq,
        (const uint8_t*)task_ports, (const uint8_t*)port_base, t_pad, n_pad,
        pt, has_ports, (int32_t*)out);
    return (int)cudaGetLastError();
}
