// The whole allocate action as one thread-block cluster.
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
// The loop, what bounds it and its design are fused_body.cuh's: one
// cluster of C CTAs (C from the node count, or given), the node state in
// the CTAs' shared memory, the selection replicated in every CTA, one
// cluster barrier a node solve, job-less pops consumed a run at a time.
#include "fused_body.cuh"

namespace {

__global__ void __launch_bounds__(NT, 1) fused_allocate_kernel(
        const Params p, const Layout L, const int) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int c = (int)cg::this_cluster().block_rank();
    fused_body(p, L, smem, p.ws + (size_t)c * L.ws_cta, c,
               p.phase_ns != nullptr);
}

}  // namespace

// The launch shape of one problem (launch_shape's info[11]); cluster 0
// lets the node count choose C.
extern "C" int kb_fused_shape(int n, int t, int j, int q, int cluster,
                              int* info) {
    Layout L;
    return (int)launch_shape(fused_allocate_kernel, n, t, j, q, 1, cluster,
                             true, &L, info);
}

// Plain C entry point for ctypes. Pointer arguments are device pointers;
// ws holds the shape's info[8] bytes of scratch, phase_ns N_PHASES +
// N_COUNTS uint64 (or null). cluster: CTAs (0: chosen by the node count).
// Returns the cudaError_t of the launch; a refused launch is returned,
// never retried another way.
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
        const void* eps, void* ws, void* phase_ns, void* host_block,
        int n_nodes, int n_tasks_total, int n_jobs, int n_queues,
        int job_key0, int job_key1, int job_key2, int n_job_keys,
        int use_prop_share, int gang_enabled, int prop_overused,
        int dyn_enabled, int max_iters, int narrow, int narrow_gate,
        int cluster, void* stream) {
    if (n_job_keys < 0 || n_job_keys > 3) return (int)cudaErrorInvalidValue;
    Layout L;
    int info[11];
    cudaError_t err = launch_shape(fused_allocate_kernel, n_nodes,
                                   n_tasks_total, n_jobs, n_queues, 1,
                                   cluster, false, &L, info);
    if (err != cudaSuccess) return (int)err;
    const Params p = make_params(
        idle, rel, n_tasks, nz, backfilled, alloc_cm, max_task_num, node_ok,
        resreq, init_resreq, task_nz, task_job, task_rank, task_sig,
        task_valid, sig_scores, sig_pred, min_available, order_min_available,
        init_allocated, job_queue, job_priority, job_create_rank, job_valid,
        q_entries, q_create_rank, q_deserved, q_alloc0, j_alloc0,
        cluster_total, dyn_weights, eps, ws, phase_ns, host_block, n_nodes,
        n_tasks_total, n_jobs, n_queues, job_key0, job_key1, job_key2,
        n_job_keys, use_prop_share, gang_enabled, prop_overused, dyn_enabled,
        max_iters, narrow, narrow_gate);
    return (int)launch_clusters(fused_allocate_kernel, p, L, 1, 1,
                                (cudaStream_t)stream);
}
