// Many tenants' fused allocate solves in one launch: one thread-block
// cluster per lane.
//
// Replaces kubebatch_tpu/tenantsvc/megasolve.py:56 _mega_fused, which is
// jax.vmap of kubebatch_tpu/kernels/fused.py:112 fused_allocate over the
// lanes of a coalesced group (requests of one shape and one static
// configuration). Each lane is an independent problem, so cluster b runs
// the fused loop (fused_body.cuh, the code fused_allocate.cu launches on
// one cluster) on lane b's slice of the stacked [B, ...] inputs, with its
// own node carries, replicas and host block. A lane's result is bitwise
// the result of a single fused_allocate launch on that lane's inputs, and
// the plain version is kubebatch_tpu_torch/kernels/mega.py
// mega_fused_plain (the plain fused loop per lane).
//
// What bounds it on an H100: each lane is the fused loop's dependence
// chain on its own cluster, so the lanes run side by side and the launch
// takes about the slowest lane's time while every cluster is resident.
// C is chosen from the lane count: the largest power of two up to the
// single launch's whose B clusters the card keeps resident at once
// (cudaOccupancyMaxActiveClusters); past that, clusters run in waves.
// The reference pads B up to 2, 4 or 8 by copying lane 0 because the lane
// count is a compile shape for XLA; this kernel takes B at run time and
// launches the real lanes only.
#include "fused_body.cuh"

namespace {

__global__ void __launch_bounds__(NT, 1) mega_fused_kernel(
        const Params p0, const Layout L, const int n_sigs) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int c = (int)cg::this_cluster().block_rank();
    const int b = (int)blockIdx.x / L.C;
    // the lane's parameter block lives in shared memory, read there like
    // the single kernel's in the parameter bank (not in local memory)
    Ctl& S = *reinterpret_cast<Ctl*>(smem);
    if (threadIdx.x == 0) S.lane = lane_params(p0, b, n_sigs);
    __syncthreads();
    fused_body(S.lane, L, smem, p0.ws + ((size_t)b * L.C + c) * L.ws_cta, c,
               b == 0 && p0.phase_ns != nullptr);
}

}  // namespace

// The launch shape of n_lanes problems (launch_shape's info[11]);
// cluster 0 lets the lane and node counts choose C.
extern "C" int kb_mega_shape(int n, int t, int j, int q, int n_lanes,
                             int cluster, int* info) {
    Layout L;
    return (int)launch_shape(mega_fused_kernel, n, t, j, q, n_lanes, cluster,
                             true, &L, info);
}

// Plain C entry point for ctypes: kb_fused_allocate's arguments for lane 0
// of stacked [n_lanes, ...] device arrays (the host block stacked the same
// way; ws n_lanes times the shape's info[8] bytes; lane 0's phases), then
// the lane count and each lane's sig rows. Returns the cudaError_t of the
// launch.
extern "C" int kb_mega_fused(
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
        int cluster, int n_lanes, int n_sigs, void* stream) {
    if (n_job_keys < 0 || n_job_keys > 3) return (int)cudaErrorInvalidValue;
    if (n_lanes < 1 || n_sigs < 1) return (int)cudaErrorInvalidValue;
    Layout L;
    int info[11];
    cudaError_t err = launch_shape(mega_fused_kernel, n_nodes, n_tasks_total,
                                   n_jobs, n_queues, n_lanes, cluster, false,
                                   &L, info);
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
    return (int)launch_clusters(mega_fused_kernel, p, L, n_lanes, n_sigs,
                                (cudaStream_t)stream);
}
