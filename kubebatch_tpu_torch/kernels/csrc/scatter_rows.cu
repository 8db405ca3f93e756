// Dirty-row refresh of the DeviceSession's node arrays: k packed source
// rows scattered into the eight node arrays in place, in one launch.
//
// Replaces kubebatch_tpu/kernels/solver.py:231 _scatter_rows (the jitted
// eight-way `.at[jidx].set` with donated buffers behind
// DeviceSession.update_rows).
//
// Source block: int32 [k, 17], one row per dirty node, float words as
// their bit patterns (kernels/solver.py pack_scatter_rows):
//   word 0       destination node row
//   words 1-3    idle        float32 [N_pad, 3]
//   words 4-6    releasing   float32 [N_pad, 3]
//   words 7-9    backfilled  float32 [N_pad, 3]
//   words 10-11  allocatable_cm float32 [N_pad, 2]
//   words 12-13  nz_req      float32 [N_pad, 2]
//   word 14      n_tasks     int32 [N_pad]
//   word 15      max_task_num int32 [N_pad]
//   word 16      node_ok     bool [N_pad] (0 or 1)
// The block reaches the card as one host-to-device copy.
//
// Bound: bytes. Per row the function reads 65 bytes (61 of values and a
// 4-byte index) and writes 61; at a steady cfg5 cycle's few hundred dirty
// rows that is tens of KB, so a launch is latency-bound. The design is
// one thread per (row, word): 16 threads a row, each moving one 32-bit
// word (a byte for node_ok) as a bit copy, so the values land exactly as
// packed. Duplicate destination rows are safe when they carry identical
// values (every writer stores the same bits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 17;
constexpr int kValueWords = 16;

__global__ void scatter_rows_kernel(const int32_t* __restrict__ src, int k,
                                    int n_pad, int32_t* __restrict__ idle,
                                    int32_t* __restrict__ releasing,
                                    int32_t* __restrict__ backfilled,
                                    int32_t* __restrict__ alloc_cm,
                                    int32_t* __restrict__ nz_req,
                                    int32_t* __restrict__ n_tasks,
                                    int32_t* __restrict__ max_task_num,
                                    uint8_t* __restrict__ node_ok) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)k * kValueWords) return;
    const int row = (int)(t / kValueWords);
    const int w = (int)(t % kValueWords);
    const int32_t* r = src + (long long)row * kWords;
    const int dst = r[0];
    // the wrapper's packer rejects out-of-range rows; never write past
    // the arrays whatever the block holds
    if (dst < 0 || dst >= n_pad) return;
    const int32_t v = r[1 + w];
    if (w < 3) {
        idle[dst * 3 + w] = v;
    } else if (w < 6) {
        releasing[dst * 3 + (w - 3)] = v;
    } else if (w < 9) {
        backfilled[dst * 3 + (w - 6)] = v;
    } else if (w < 11) {
        alloc_cm[dst * 2 + (w - 9)] = v;
    } else if (w < 13) {
        nz_req[dst * 2 + (w - 11)] = v;
    } else if (w == 13) {
        n_tasks[dst] = v;
    } else if (w == 14) {
        max_task_num[dst] = v;
    } else {
        node_ok[dst] = (uint8_t)(v != 0);
    }
}

}  // namespace

extern "C" int kb_scatter_rows(const void* src, int k, int n_pad,
                               void* idle, void* releasing, void* backfilled,
                               void* alloc_cm, void* nz_req, void* n_tasks,
                               void* max_task_num, void* node_ok,
                               void* stream) {
    if (k <= 0) return 0;
    const int threads = 256;
    const long long total = (long long)k * kValueWords;
    const int blocks = (int)((total + threads - 1) / threads);
    scatter_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src, k, n_pad, (int32_t*)idle, (int32_t*)releasing,
        (int32_t*)backfilled, (int32_t*)alloc_cm, (int32_t*)nz_req,
        (int32_t*)n_tasks, (int32_t*)max_task_num, (uint8_t*)node_ok);
    return (int)cudaGetLastError();
}
