// The host entry points of the CUDA kernels: the one statement of their
// parameters, included by the kernels' sources (pileup.cu, insertion.cu)
// and by binding.cpp, so the compiler checks every call against it.
// Each launches on `stream`, does not synchronise, allocates nothing, and
// returns the launch's cudaError_t.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// K1 (pileup.cu): counts[start_r + j, code_r[j]] += 1 over nibble-packed
// rows [n, wb].  `starts` ascending, sorted row r is packed row order[r].
// The kernel's geometry (window, stage, rows a block, grid) is its own:
// the grid follows from n, wb and the SM count.  One launch.
cudaError_t s2c_pileup_rows(
    const int32_t* starts, const int64_t* order, const uint8_t* packed,
    int n, int wb, long long n_pos, int32_t* counts, cudaStream_t stream);

// K3 (insertion.cu): the int32 [kp, cp, 6] insertion table from key-sorted
// events (cc = col * 6 + code) with a CSR offset per key.  One launch.
cudaError_t s2c_insertion_table(
    const int32_t* key_ptr, const int32_t* cc, int kp, int cp, int chunk,
    int32_t* out, cudaStream_t stream);

// K2 (insertion.cu): the insertion table of unsorted events, accumulated
// into `table` (int32 [kp, cp, 6] scratch, zeroed here), then voted;
// uint8 [n_thr, kp, cp].  `thresholds` [n_thr] and `lut` [64] are host
// memory: they travel in the launches' parameters, a bounded number of
// thresholds a launch.  `*launches` receives the number of launches made.
cudaError_t s2c_insertion_vote(
    const int32_t* key, const int32_t* col, const int32_t* code,
    int n_events, const int32_t* site_cov, const int32_t* n_cols,
    const double* thresholds, int n_thr, const uint8_t* lut, int kp, int cp,
    int32_t* table, uint8_t* out, cudaStream_t stream, int* launches);

// The current device's SM count, cached per device; 0 if it cannot be read.
// K1 sizes its grid from it, K2 caps its cooperative grid at it.
inline int s2c_sm_count()
{
    static int cached[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (cached[dev] == 0
        && cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                                  dev) != cudaSuccess)
        return 0;
    return cached[dev];
}
