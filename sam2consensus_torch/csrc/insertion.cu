// K2 and K3: the insertion table, and the fused insertion table + vote.
//
// K3 (s2c_insertion_table) replaces
//   sam2consensus_tpu/ops/pallas_insertion.py::_kernel (grid call _table_call);
// K2 (s2c_insertion_vote) replaces
//   sam2consensus_tpu/ops/pallas_insertion.py::_vote_kernel
//   (grid call _table_vote_call).
//
// Events arrive sorted by site key with a CSR offset per key
// (key_ptr[k] .. key_ptr[k+1]); each event is col * 6 + code.  The TPU
// kernels accumulate 128 keys x all columns per block as an f32 one-hot
// matmul; that block (up to 1.5 MB at 512 columns) does not fit in shared
// memory, so here a CUDA block takes one key and one chunk of columns,
// scans the key's event range once and adds the events of its chunk into an
// int32 [chunk, 6] shared table with shared-memory atomics (a hot key costs
// contention, not correctness).  K3 writes the table to [K, C, 6].  K2 votes
// in the same block, one thread per column: gap lane = site coverage minus
// the column sum (may go negative, quirk 4), strictly-greater sums, the
// exact cutoff ceil(fl64(t) * cov) per threshold in float64 (the same
// value as ops/cutoff.exact_cutoff), the 6-bit call mask through the IUPAC
// LUT, and FILL (0) for a '-' call or a column past the site's n_cols.
//
// Bound: bytes.  The events are read once and the table (K3) or the
// [T, K, C] uint8 calls (K2) written once; the per-column vote is a few
// dozen integer operations and one float64 multiply per threshold.
#include <math.h>

#include "kernels.h"

#define NSYM 6
#define THREADS 256

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

__global__ void insertion_vote_kernel(
    const int32_t* __restrict__ key_ptr, const int32_t* __restrict__ cc,
    const int32_t* __restrict__ site_cov,   // [kp]
    const int32_t* __restrict__ n_cols,     // [kp]
    const double* __restrict__ thr,         // [n_thr]
    const uint8_t* __restrict__ lut,        // [64] IUPAC mask -> ASCII
    int n_thr, int kp, int cp, int chunk,
    uint8_t* __restrict__ out)              // [n_thr, kp, cp]
{
    extern __shared__ int32_t tab[];
    const int key = blockIdx.x;
    const int c0 = blockIdx.y * chunk;
    const int width = min(chunk, cp - c0);
    accumulate_chunk(key_ptr, cc, key, c0, width, tab);

    const int cov = site_cov[key];
    const int valid_cols = n_cols[key];
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
        int p[NSYM];
        int colsum = 0;
#pragma unroll
        for (int j = 0; j < NSYM; ++j) {
            p[j] = tab[c * NSYM + j];
            colsum += p[j];
        }
        p[0] = cov - colsum;                 // gap completion; may be < 0
        int sgs[NSYM];
#pragma unroll
        for (int i = 0; i < NSYM; ++i) {
            int s = 0;
#pragma unroll
            for (int j = 0; j < NSYM; ++j) s += (p[j] > p[i]) ? p[j] : 0;
            sgs[i] = s;
        }
        const int col = c0 + c;
        for (int t = 0; t < n_thr; ++t) {
            double cut = ceil(__dmul_rn(thr[t], (double)cov));
            cut = fmin(fmax(cut, 0.0), 2147483647.0);
            const int cutoff = (int)cut;
            int mask = 0;
#pragma unroll
            for (int i = 0; i < NSYM; ++i)
                if (p[i] != 0 && sgs[i] < cutoff) mask |= 1 << i;
            const uint8_t sym = lut[mask];
            const bool skip = sym == (uint8_t)'-' || col >= valid_cols;
            out[((long long)t * kp + key) * cp + col] = skip ? 0 : sym;
        }
    }
}

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
    const int32_t* key_ptr, const int32_t* cc, const int32_t* site_cov,
    const int32_t* n_cols, const double* thr, const uint8_t* lut, int n_thr,
    int kp, int cp, int chunk, uint8_t* out, cudaStream_t stream)
{
    const dim3 grid(kp, (cp + chunk - 1) / chunk);
    const size_t smem = (size_t)chunk * NSYM * sizeof(int32_t);
    insertion_vote_kernel<<<grid, THREADS, smem, stream>>>(
        key_ptr, cc, site_cov, n_cols, thr, lut, n_thr, kp, cp, chunk, out);
    return cudaGetLastError();
}
