// The whole allocate action as one persistent thread block.
//
// Replaces kubebatch_tpu/kernels/fused.py:112 fused_allocate (a
// lax.while_loop placing one task per iteration), with
// kubebatch_tpu/kernels/solver.py:67 dynamic_node_score inside it
// (node_score.cuh) and kubebatch_tpu/kernels/telemetry.py:95
// decision_frame as the epilogue. The plain PyTorch version is
// kubebatch_tpu_torch/kernels/fused.py fused_allocate_plain; every float
// operation here is that version's, in the same order, so the host block
// and the node carries agree bit for bit (built with -fmad=false).
//
// What bounds it on an H100: neither bytes nor operations. The inputs are
// ~2 MB at cfg5 (0.6 us at 3.35 TB/s) and each iteration does ~80 float
// operations per node, but the iterations form a dependence chain: the
// next placement reads the node state the previous one wrote. The floor
// is iterations x (one pass over the N nodes + ~10 block-wide barriers
// and reductions). Design:
//  - one block of 1024 threads runs the loop, so every placement stays on
//    the SM (no host round trip, no launch per placement); the queue and
//    job scalars live in shared memory, the state arrays in global memory
//    that stays in L1/L2;
//  - a prologue buckets the task indices by job (a CSR built with atomics),
//    so the task pick scans the visited job's tasks with one warp instead
//    of all T tasks; the pick is still the lexicographic minimum over the
//    job's tasks by (rank, index), so the order inside a bucket is free;
//  - the node pass evaluates predicate, fit and score for 8 nodes per
//    thread and reduces (score, lowest index) across the block; thread 0
//    then re-evaluates the winning node with the same code and applies the
//    updates;
//  - the epilogue writes the telemetry frame into the same int32 host
//    block as the decisions, so the host reads one buffer per cycle.
// Using more than one SM (a cluster sharing the node pass) is later work.
#include "fused_body.cuh"

namespace {

__global__ void __launch_bounds__(NT, 1) fused_allocate_kernel(const Params p) {
    fused_body(p);
}

}  // namespace

// Plain C entry point for ctypes. Pointer arguments are device pointers;
// ws_i32 holds Q + 4J + 1 + T int32 and ws_f32 3Q + 3J float32 of
// scratch. Returns cudaGetLastError() after the launch.
extern "C" int kb_fused_allocate(
        void* idle, void* rel, void* n_tasks, void* nz,
        const void* backfilled, const void* alloc_cm,
        const void* max_task_num, const void* node_ok,
        const void* resreq, const void* init_resreq, const void* task_nz,
        const void* task_job, const void* task_rank, const void* task_sig,
        const void* task_valid, const void* sig_scores, const void* sig_pred,
        const void* min_available, const void* order_min_available,
        const void* init_allocated, const void* job_queue,
        const void* job_priority, const void* job_create_rank,
        const void* job_valid, const void* q_entries,
        const void* q_create_rank, const void* q_deserved,
        const void* q_alloc0, const void* j_alloc0,
        const void* cluster_total, const void* dyn_weights,
        const void* eps, void* ws_i32, void* ws_f32, void* host_block,
        int n_nodes, int n_tasks_total, int n_jobs, int n_queues,
        int job_key0, int job_key1, int job_key2, int n_job_keys,
        int use_prop_share, int gang_enabled, int prop_overused,
        int dyn_enabled, int max_iters, int narrow, int narrow_gate,
        void* stream) {
    if (n_job_keys < 0 || n_job_keys > 3) return (int)cudaErrorInvalidValue;
    const Params p = make_params(
        idle, rel, n_tasks, nz, backfilled, alloc_cm, max_task_num, node_ok,
        resreq, init_resreq, task_nz, task_job, task_rank, task_sig,
        task_valid, sig_scores, sig_pred, min_available, order_min_available,
        init_allocated, job_queue, job_priority, job_create_rank, job_valid,
        q_entries, q_create_rank, q_deserved, q_alloc0, j_alloc0,
        cluster_total, dyn_weights, eps, ws_i32, ws_f32, host_block, n_nodes,
        n_tasks_total, n_jobs, n_queues, job_key0, job_key1, job_key2,
        n_job_keys, use_prop_share, gang_enabled, prop_overused, dyn_enabled,
        max_iters, narrow, narrow_gate);
    fused_allocate_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
