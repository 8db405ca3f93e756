// jax.lax.associative_scan with the reference's segmented combine, shared
// by the batched round kernel (batched_allocate.cu) and the victim
// analysis (victims.cu).
//
// Replaces the tree of kubebatch_tpu's segmented scans
// (kernels/batched.py _segmented_prefix, kernels/victims.py
// _seg_excl_cumsum): the plain versions run the same tree through
// kubebatch_tpu_torch/kernels/xla_order.py associative_scan, so every
// float addition happens in the same order. All threads of the block
// call run(); it synchronises the block between levels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kb {

// jax.lax.associative_scan of (values[NV], count, flag) elements with the
// reference's segmented combine (b.flag ? b : a + b; flags or-ed), in the
// same tree: pairs (0,1), (2,3).. combine, the halves scan recursively,
// each even output combines the odd output before it with its element.
// Level 0 (n elements) is filled by the caller at sv/scnt/sflag; the
// inclusive result lands at rv/rcnt/rflag[0..n).
template <int NV>
struct SegScan {
    float* sv; int32_t* sc; uint8_t* sf;
    float* rv; int32_t* rc; uint8_t* rf;

    __device__ void comb(const float* av, int ac, uint8_t af, const float* bv,
                         int bc, uint8_t bf, float* ov, int32_t* oc,
                         uint8_t* of) const {
#pragma unroll
        for (int v = 0; v < NV; ++v) ov[v] = bf ? bv[v] : av[v] + bv[v];
        *oc = bf ? bc : ac + bc;
        *of = af | bf;
    }

    __device__ void run(int n) const {
        int ns[32], off[32];
        int L = 0;
        ns[0] = n;
        off[0] = 0;
        while (ns[L] >= 2) {
            const int h = ns[L] / 2;
            off[L + 1] = off[L] + ns[L];
            ns[L + 1] = h;
            for (int i = threadIdx.x; i < h; i += blockDim.x) {
                const int a = off[L] + 2 * i, b = a + 1, o = off[L + 1] + i;
                comb(sv + (size_t)a * NV, sc[a], sf[a], sv + (size_t)b * NV,
                     sc[b], sf[b], sv + (size_t)o * NV, sc + o, sf + o);
            }
            __syncthreads();
            ++L;
        }
        // top level: its scan is itself
        for (int i = threadIdx.x; i < ns[L]; i += blockDim.x) {
            const int s = off[L] + i;
            for (int v = 0; v < NV; ++v) rv[(size_t)s * NV + v] =
                sv[(size_t)s * NV + v];
            rc[s] = sc[s];
            rf[s] = sf[s];
        }
        __syncthreads();
        for (int l = L - 1; l >= 0; --l) {
            for (int i = threadIdx.x; i < ns[l]; i += blockDim.x) {
                const int o = off[l] + i;
                if (i & 1) {
                    const int s = off[l + 1] + i / 2;
                    for (int v = 0; v < NV; ++v) rv[(size_t)o * NV + v] =
                        rv[(size_t)s * NV + v];
                    rc[o] = rc[s];
                    rf[o] = rf[s];
                } else if (i == 0) {
                    for (int v = 0; v < NV; ++v) rv[(size_t)o * NV + v] =
                        sv[(size_t)o * NV + v];
                    rc[o] = sc[o];
                    rf[o] = sf[o];
                } else {
                    const int s = off[l + 1] + i / 2 - 1;
                    comb(rv + (size_t)s * NV, rc[s], rf[s],
                         sv + (size_t)o * NV, sc[o], sf[o],
                         rv + (size_t)o * NV, rc + o, rf + o);
                }
            }
            __syncthreads();
        }
    }
};

}  // namespace kb
