// K2 and K3: the fused insertion table + vote, and the insertion table.
//
// K2 (s2c_insertion_vote) replaces
//   sam2consensus_tpu/ops/pallas_insertion.py::_vote_kernel
//   (grid call _table_vote_call);
// K3 (s2c_insertion_table) replaces
//   sam2consensus_tpu/ops/pallas_insertion.py::_kernel (grid call _table_call).
//
// K2 takes the tail's events unsorted, (key, col, code) int32 [E] each.  The
// TPU kernel needs them sorted by key with a CSR offset per key because a
// TPU block owns one key block in VMEM.  Here the whole count table
// (int32 [kp, cp, 6]; 96 KiB at amplicon_deep's 512 x 8) lives in a scratch
// buffer that stays in the 50 MB L2, and K2 is one cooperative launch (at
// most one block per SM, all resident, so the grid can synchronise) in
// three steps, with no plan and no host synchronisation:
//   1. the grid zeroes the table;
//   2. one thread per event adds it with a warp-aggregated atomicAdd
//      (__match_any_sync groups the lanes that hit one cell; the lowest lane
//      adds the group's size), so a hot key costs one L2 atomic per distinct
//      cell of a warp, not one per event.  An event outside
//      [0, kp) x [0, cp) x [0, 6) is dropped (the JAX scatter drops it too);
//   3. one thread per (key, column) pair votes, all pairs busy: gap lane =
//      site coverage minus the column sum (may go negative, quirk 4),
//      strictly-greater sums, the exact cutoff ceil(fl64(t) * cov) per
//      threshold in float64 clamped to [0, 2^31 - 1] (the same value as
//      ops/cutoff.exact_cutoff), the 6-bit call mask through the IUPAC LUT,
//      and FILL (0) for a '-' call or a column past the site's n_cols.
// A grid-wide barrier separates the steps.  The thresholds and the LUT
// travel by value in the launch's parameters (no host-to-device copy), up
// to K2_MAX_T thresholds a launch; one launch replaces the three (memset,
// count, vote) that each cost the host a launch.
//
// K3 takes events sorted by site key with a CSR offset per
// key (key_ptr[k] .. key_ptr[k+1]), each event col * 6 + code; one block per
// (key, chunk of columns) scans the key's range into an int32 [chunk, 6]
// shared table with shared-memory atomics and writes it to [kp, cp, 6].
//
// Bound: bytes for both.  K2 reads the events once and writes the
// [T, kp, cp] uint8 calls once (the table is scratch in L2); the vote is a
// few dozen integer operations and one float64 multiply per threshold.
#include <cooperative_groups.h>
#include <math.h>

#include "kernels.h"

namespace cg = cooperative_groups;

#define NSYM 6
#define THREADS 256
#define K2_MAX_T 16

namespace {

struct VoteParams {
    double thr[K2_MAX_T];
    uint8_t lut[64];
    int n_thr;
};

__device__ __forceinline__ void accumulate_chunk(
    const int32_t* __restrict__ key_ptr, const int32_t* __restrict__ cc,
    int key, int c0, int width, int32_t* tab)
{
    for (int i = threadIdx.x; i < width * NSYM; i += blockDim.x) tab[i] = 0;
    __syncthreads();
    const int lo = c0 * NSYM;
    const int hi = (c0 + width) * NSYM;
    const int e1 = key_ptr[key + 1];
    for (int e = key_ptr[key] + threadIdx.x; e < e1; e += blockDim.x) {
        const int v = cc[e];
        if (v >= lo && v < hi) atomicAdd(&tab[v - lo], 1);
    }
    __syncthreads();
}

__global__ void insertion_table_kernel(
    const int32_t* __restrict__ key_ptr, const int32_t* __restrict__ cc,
    int cp, int chunk, int32_t* __restrict__ out)      // [kp, cp, 6]
{
    extern __shared__ int32_t tab[];
    const int key = blockIdx.x;
    const int c0 = blockIdx.y * chunk;
    const int width = min(chunk, cp - c0);
    accumulate_chunk(key_ptr, cc, key, c0, width, tab);
    int32_t* row = out + ((long long)key * cp + c0) * NSYM;
    for (int i = threadIdx.x; i < width * NSYM; i += blockDim.x) row[i] = tab[i];
}

__global__ void __launch_bounds__(THREADS) insertion_vote_kernel(
    const int32_t* __restrict__ key, const int32_t* __restrict__ col,
    const int32_t* __restrict__ code, int n_events,
    const int32_t* __restrict__ site_cov,   // [kp]
    const int32_t* __restrict__ n_cols,     // [kp]
    const __grid_constant__ VoteParams prm, int t0, int kp, int cp,
    int32_t* __restrict__ table,            // [kp, cp, 6] scratch
    uint8_t* __restrict__ out)              // [n_thr_total, kp, cp]
{
    cg::grid_group grid = cg::this_grid();
    __shared__ double thr[K2_MAX_T];
    __shared__ uint8_t lut[64];
    if (threadIdx.x < K2_MAX_T) thr[threadIdx.x] = prm.thr[threadIdx.x];
    if (threadIdx.x < 64) lut[threadIdx.x] = prm.lut[threadIdx.x];

    const long long pairs = (long long)kp * cp;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int2* table2 = reinterpret_cast<int2*>(table);
    for (long long i = tid; i < pairs * 3; i += stride)
        table2[i] = make_int2(0, 0);
    grid.sync();

    const int lane = threadIdx.x & 31;
    // b is block-uniform, so whole warps run every iteration together
    for (long long b = (long long)blockIdx.x * blockDim.x; b < n_events;
         b += stride) {
        const long long e = b + threadIdx.x;
        long long cell = -1;
        if (e < n_events) {
            const int k = key[e], c = col[e], s = code[e];
            if (k >= 0 && k < kp && c >= 0 && c < cp && s >= 0 && s < NSYM)
                cell = ((long long)k * cp + c) * NSYM + s;
        }
        const unsigned same = __match_any_sync(0xFFFFFFFFu,
                                               (unsigned long long)cell);
        if (cell >= 0 && lane == __ffs(same) - 1)
            atomicAdd(table + cell, __popc(same));
    }
    grid.sync();

    for (long long idx = tid; idx < pairs; idx += stride) {
        const int k = (int)(idx / cp);
        const int c = (int)(idx - (long long)k * cp);
        int p[NSYM];
        int colsum = 0;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int2 v = __ldcg(table2 + idx * 3 + j);
            p[2 * j] = v.x;
            p[2 * j + 1] = v.y;
            colsum += v.x + v.y;
        }
        const int cov = site_cov[k];
        p[0] = cov - colsum;                 // gap completion; may be < 0
        int sgs[NSYM];
#pragma unroll
        for (int i = 0; i < NSYM; ++i) {
            int s = 0;
#pragma unroll
            for (int j = 0; j < NSYM; ++j) s += (p[j] > p[i]) ? p[j] : 0;
            sgs[i] = s;
        }
        const bool past = c >= n_cols[k];
        for (int t = 0; t < prm.n_thr; ++t) {
            double cut = ceil(__dmul_rn(thr[t], (double)cov));
            cut = fmin(fmax(cut, 0.0), 2147483647.0);
            const int cutoff = (int)cut;
            int mask = 0;
#pragma unroll
            for (int i = 0; i < NSYM; ++i)
                if (p[i] != 0 && sgs[i] < cutoff) mask |= 1 << i;
            const uint8_t sym = lut[mask];
            out[(long long)(t0 + t) * pairs + idx] =
                (sym == (uint8_t)'-' || past) ? 0 : sym;
        }
    }
}

int grid_for(long long items)
{
    const long long blocks = (items + THREADS - 1) / THREADS;
    return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

}  // namespace

cudaError_t s2c_insertion_table(
    const int32_t* key_ptr, const int32_t* cc, int kp, int cp, int chunk,
    int32_t* out, cudaStream_t stream)
{
    const dim3 grid(kp, (cp + chunk - 1) / chunk);
    const size_t smem = (size_t)chunk * NSYM * sizeof(int32_t);
    insertion_table_kernel<<<grid, THREADS, smem, stream>>>(
        key_ptr, cc, cp, chunk, out);
    return cudaGetLastError();
}

cudaError_t s2c_insertion_vote(
    const int32_t* key, const int32_t* col, const int32_t* code,
    int n_events, const int32_t* site_cov, const int32_t* n_cols,
    const double* thresholds, int n_thr, const uint8_t* lut, int kp, int cp,
    int32_t* table, uint8_t* out, cudaStream_t stream, int* launches)
{
    // at most one block per SM: a cooperative launch may always ask for
    // that many (one block of THREADS fits on an SM)
    *launches = 0;
    const int cap = s2c_sm_count();
    if (cap <= 0) return cudaErrorInvalidConfiguration;
    const long long items = (long long)kp * cp > n_events
        ? (long long)kp * cp : n_events;
    const int grid = grid_for(items) < cap ? grid_for(items) : cap;
    VoteParams prm = {};
    for (int i = 0; i < 64; ++i) prm.lut[i] = lut[i];
    for (int t0 = 0; t0 < n_thr; t0 += K2_MAX_T) {
        prm.n_thr = n_thr - t0 < K2_MAX_T ? n_thr - t0 : K2_MAX_T;
        for (int t = 0; t < prm.n_thr; ++t) prm.thr[t] = thresholds[t0 + t];
        void* args[] = {&key, &col, &code, &n_events, &site_cov, &n_cols,
                        &prm, &t0, &kp, &cp, &table, &out};
        cudaError_t err = cudaLaunchCooperativeKernel(
            (const void*)insertion_vote_kernel, dim3(grid), dim3(THREADS),
            args, 0, stream);
        if (err != cudaSuccess) return err;
        ++*launches;
    }
    return cudaSuccess;
}
