// The batched allocate cycle — every round, the compact continuation and
// the stranded-gang epilogue — as one cooperative grid.
//
// Replaces kubebatch_tpu/kernels/batched.py:1184 _batched_packed, with
// :436 _round, :885 _stranded_jobs, :916 _rollback_stranded and :1009
// batched_allocate inside it, their inter-pod affinity / host-port branch
// (:200-432 _aff_gather, _aff_eligibility, _aff_serialize, _aff_involved,
// _aff_delta, _aff_commit, _aff_rollback, _ip_score; see "Affinity"
// below), kubebatch_tpu/kernels/solver.py:67 dynamic_node_score for the [P,N]
// pair scores (node_score.cuh) and kubebatch_tpu/kernels/telemetry.py:95
// decision_frame as the epilogue. The plain PyTorch version is
// kubebatch_tpu_torch/kernels/batched.py batched_allocate_plain; every
// float operation here is that version's, in the same order, so the
// packed result and the node carry agree bit for bit (built with
// -fmad=false and IEEE division):
//  - cumulative sums in jnp.cumsum's 16-wide tiled order, the column sum
//    in XLA's 32-window tree order, the segmented prefixes in
//    jax.lax.associative_scan's odd/even tree (kernels/xla_order.py);
//  - segment sums in task-index order: tasks are sorted by (segment,
//    index) and one thread adds a segment's values one after another;
//    where the reference adds onto a carry (``x + segment_sum``, which XLA
//    folds into the scatter) the thread starts from the carry, where it
//    subtracts it sums from 0 first. No float atomics anywhere.
//
// What bounds it on an H100: per round, two passes over [T_part, N] task
// x node cells (eligibility, fit and the masked score argmax), ~20 float
// operations a cell, and the [P,N] pair scores (~60 operations a cell);
// at cfg5's round 0 that is ~2e9 operations (~0.06 ms at 33.5e12/s) and
// the node state, [S,N] predicates and [P,N] scores it reads (~70 MB,
// ~0.02 ms at 3.35 TB/s). Between those passes the round is a chain of
// dependent steps over T (sorts, scans, segment sums) that each need every
// earlier result: their latency (grid barriers, L2 round trips), not bytes
// or operations, bounds it.
// Design:
//  - one cooperative launch (grid.sync() between phases, the grid no
//    larger than what is co-resident) runs the whole cycle, so no round
//    returns to the host; the host reads the packed result once;
//  - the [T,N] passes spread over the grid: one warp per task row walks
//    the nodes, keeping eligibility, any-eligible and the (score, lowest
//    index) argmax in registers; nothing of size [T,N] is stored. The
//    waterfall slot's eligibility is one cell per task;
//  - the grid chain (batched_round.cuh): on a task view past
//    GRID_CHAIN_MIN the ordering steps run across the whole grid (the
//    waterfall's node order past GRID_CHAIN_MIN nodes, the job order past
//    GRID_JOBS_MIN jobs, each sorting counting passes over its keys'
//    order-preserving bits). Their
//    sorts are stable LSD counting sorts (at most 8 bits a pass: each
//    block counts the digits of a contiguous chunk, a grid barrier, each
//    block finds its digit bases and scatters its chunk with ranks from
//    __match_any_sync), each sized to the key's range (nodes, jobs,
//    queues, task ranks), the secondary key free from the iteration
//    order; per-segment sums take one thread a segment across the grid
//    (bounds by binary search of the sorted keys); the segmented scan's
//    and the tiled cumsum's long levels run across the grid, the short
//    ones in block 0. Every key ends in an index, so any correct sort
//    gives the permutation the bitonic sort gave, and no addition
//    changes its operands or order. On smaller views block 0 runs the
//    same steps with the bitonic sort in shared memory. The epilogue's
//    stranded-job pass and the compaction stay in block 0;
//  - scalars shared across the grid sit in a small global array that
//    every thread reads after the barrier.
//
// Affinity (when the cycle carries kernels/affinity.py's vocabulary; A
// affinity pairs <= 128, PT ports <= 64, D domain slots):
//  - a task's rows of task_grp / task_req_aff / task_req_anti /
//    task_self_ok (and which task_pref_w / task_carry_w entries are
//    nonzero) are packed once, in setup, into two 64-bit words each, its
//    task_ports row and each node's port_base row into one;
//  - the carry is kept as int32 ([A,D] members, anti carriers, preferred
//    weights; [A] totals) and a [N] port-claim word: its values are
//    integer-valued floats far below 2**24 (counts and k8s's integer
//    weights; prepare_batched checks the inputs), so integer atomics
//    commit and roll back exactly and in any order, and the float carry
//    the host reads back is the reference's bit for bit;
//  - each round starts with a grid phase that turns the carry into
//    per-node words: present (pairs whose group has a member in the
//    node's domain), sym (pairs with an anti carrier there) and the used
//    ports, plus [A]-wide flags (bootstrapping, satisfied somewhere,
//    has a carrier, pending members). The reference's three boolean
//    [T,A] x [A,N] products and the port product count ones and compare
//    with 0.5: "any bit of need & ~present, anti & present, grp & sym,
//    ports & used" is the same predicate, tested per cell in the row pass;
//  - the interpod score (tasks that can score: a nonzero preferred term,
//    or membership of a pair with carried preferred weight) is a second
//    pass over the row's nodes: own + sym counts (integer-valued, exact in
//    any order), their min / max over the real nodes, then the
//    reference's floor(10 * (c - cmin) / span) * weight in its float
//    order; such tasks leave the shared waterfall;
//  - phase-1 serialization is integer work across the grid (a team step
//    of the chain): atomicMin of ranks into an [A, D+1] workspace per
//    (pair, domain) and into [N+1] per node for port claimants, the
//    bootstrap domain by atomicMax, a grid barrier, then each accepted
//    task keeps or drops. Integer atomics are exact and order-free;
//    float atomics stay out.
#include "batched_round.cuh"

namespace {

__global__ void __launch_bounds__(NT, 1)
batched_allocate_kernel(const __grid_constant__ Params p,
                        const __grid_constant__ Work w) {
    extern __shared__ uint64_t skeys[];
    Cycle c(p, w, skeys);
    c.run();
}

}  // namespace

// Workspace bytes for these sizes (ints as kb_batched_allocate takes
// them). Returns a cudaError_t (0).
extern "C" int kb_batched_workspace(const int* ints, int n_ints,
                                    long long* bytes) {
    if (n_ints != N_INTS) return (int)cudaErrorInvalidValue;
    uint64_t ptrs[N_PTRS] = {0};
    const Params p = make_params(ptrs, ints);
    *bytes = (long long)layout(p, nullptr, nullptr);
    return 0;
}

// Launch the cycle. ptrs: N_PTRS device addresses in the P_* order (the
// last the workspace; P_PHASE N_PHASES zeroed uint64 for the phase
// times; the affinity slots null without the vocabulary); ints: N_INTS
// sizes and options; info (host, 3 ints): grid,
// threads and dynamic shared bytes of the launch. Returns the
// cudaError_t of the setup and the launch.
extern "C" int kb_batched_allocate(const unsigned long long* ptrs,
                                   int n_ptrs, const int* ints, int n_ints,
                                   int* info, void* stream) {
    if (n_ptrs != N_PTRS || n_ints != N_INTS)
        return (int)cudaErrorInvalidValue;
    const Params p = make_params((const uint64_t*)ptrs, ints);
    if (p.T >= (1 << 20) || p.J >= (1 << 24) || p.njk > 3)
        return (int)cudaErrorInvalidValue;
    if (p.aff && (p.A < 1 || p.A > 128 || p.D < 1 || p.PT < 0 || p.PT > 64))
        return (int)cudaErrorInvalidValue;
    Work w;
    layout(p, (char*)ptrs[P_WS], &w);
    const size_t smem = smem_bytes(p);
    cudaError_t err = cudaFuncSetAttribute(
        batched_allocate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
        return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, batched_allocate_kernel, NT, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    const int grid = sms * per_sm;
    if (grid > MAX_GRID) return (int)cudaErrorInvalidConfiguration;
    info[0] = grid;
    info[1] = NT;
    info[2] = (int)smem;
    Params pc = p;
    Work wc = w;
    void* args[] = {&pc, &wc};
    err = cudaLaunchCooperativeKernel((const void*)batched_allocate_kernel,
                                      dim3(grid), dim3(NT), args, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
