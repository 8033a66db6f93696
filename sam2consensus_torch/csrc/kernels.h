// The host entry points of the CUDA kernels: the one statement of their
// parameters, included by the kernels' sources (pileup.cu, insertion.cu)
// and by binding.cpp, so the compiler checks every call against it.
// Each launches on `stream`, does not synchronise, allocates nothing, and
// returns the launch's cudaError_t.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// K1 (pileup.cu): counts[start_r + j, code_r[j]] += 1 over tile-sorted,
// nibble-packed rows; one block per work item [item_lo, item_hi) of a tile.
cudaError_t s2c_pileup_tiles(
    const int32_t* starts, const uint8_t* packed, const int32_t* item_tile,
    const int32_t* item_lo, const int32_t* item_hi, int n_items, int wb,
    int tile, long long n_pos, int32_t* counts, cudaStream_t stream);

// K3 (insertion.cu): the int32 [kp, cp, 6] insertion table from key-sorted
// events (cc = col * 6 + code) with a CSR offset per key.
cudaError_t s2c_insertion_table(
    const int32_t* key_ptr, const int32_t* cc, int kp, int cp, int chunk,
    int32_t* out, cudaStream_t stream);

// K2 (insertion.cu): the same table voted in-block; uint8 [n_thr, kp, cp].
cudaError_t s2c_insertion_vote(
    const int32_t* key_ptr, const int32_t* cc, const int32_t* site_cov,
    const int32_t* n_cols, const double* thr, const uint8_t* lut, int n_thr,
    int kp, int cp, int chunk, uint8_t* out, cudaStream_t stream);
