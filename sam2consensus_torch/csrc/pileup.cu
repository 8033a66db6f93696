// K1: the pileup histogram, counts[start_r + j, code_r[j]] += 1.
//
// Replaces sam2consensus_tpu/ops/pallas_pileup.py::_kernel (grid call
// _pileup_call), the TPU tile-CSR VMEM histogram.
//
// Inputs are segment rows sorted by position tile (tile = start / TILE),
// 4-bit packed: two codes per byte, the even column in the low nibble,
// codes 0..5 count and 15 (PAD) adds nothing.  Each CUDA block takes one
// work item, a run of rows of one tile (the host plan caps a run's bytes so
// a deep tile spreads over many blocks), and keeps an int32 [TILE, 6]
// histogram of that tile in shared memory: duplicate positions meet in
// shared-memory atomics instead of device memory.  A cell past the tile
// (a row overhanging the tile edge, or a row wider than the tile) goes
// straight to device memory with atomicAdd: unlike the TPU grid, CUDA
// blocks run in no order, so there is no carried overhang.  At the end the
// block adds its non-zero histogram cells into counts with atomicAdd,
// because counts accumulates across slabs and other blocks share the tile.
// Integer atomics make the result independent of order.
//
// Bound: bytes.  The kernel must read the packed rows and starts once and
// read-modify-write the [L, 6] int32 counts; the integer work per cell is
// a few operations.  The shared histogram turns the per-cell traffic into
// on-chip atomics, so device memory sees one atomic per non-zero
// (position, symbol) of each work item.
#include "kernels.h"

#define NSYM 6
#define THREADS 512

__global__ void pileup_tiles_kernel(
    const int32_t* __restrict__ starts,      // [N] tile-sorted
    const uint8_t* __restrict__ packed,      // [N, wb] tile-sorted
    const int32_t* __restrict__ item_tile,   // [n_items]
    const int32_t* __restrict__ item_lo,     // [n_items] first row
    const int32_t* __restrict__ item_hi,     // [n_items] end row
    int wb, int tile, long long n_pos,
    int32_t* __restrict__ counts)            // [n_pos, 6]
{
    extern __shared__ int32_t hist[];        // [tile * 6]
    const int item = blockIdx.x;
    const long long base = (long long)item_tile[item] * tile;
    const int lo = item_lo[item];
    const int hi = item_hi[item];
    const int cells = tile * NSYM;

    for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
    __syncthreads();

    const long long nbytes = (long long)(hi - lo) * wb;
    const uint8_t* rows = packed + (long long)lo * wb;
    for (long long i = threadIdx.x; i < nbytes; i += blockDim.x) {
        const int r = (int)(i / wb);
        const int b = (int)(i - (long long)r * wb);
        const int byte = rows[i];
        const long long p0 = (long long)starts[lo + r] + 2 * b;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int code = h ? (byte >> 4) : (byte & 0xF);
            if (code >= NSYM) continue;
            const long long pos = p0 + h;
            const long long local = pos - base;
            if (local >= 0 && local < tile) {
                atomicAdd(&hist[local * NSYM + code], 1);
            } else if (pos >= 0 && pos < n_pos) {
                atomicAdd(&counts[pos * NSYM + code], 1);
            }
        }
    }
    __syncthreads();

    const long long limit = (n_pos - base) * NSYM;
    for (int i = threadIdx.x; i < cells && i < limit; i += blockDim.x) {
        const int v = hist[i];
        if (v != 0) atomicAdd(&counts[base * NSYM + i], v);
    }
}

cudaError_t s2c_pileup_tiles(
    const int32_t* starts, const uint8_t* packed, const int32_t* item_tile,
    const int32_t* item_lo, const int32_t* item_hi, int n_items, int wb,
    int tile, long long n_pos, int32_t* counts, cudaStream_t stream)
{
    const size_t smem = (size_t)tile * NSYM * sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        pileup_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    pileup_tiles_kernel<<<n_items, THREADS, smem, stream>>>(
        starts, packed, item_tile, item_lo, item_hi, wb, tile, n_pos, counts);
    return cudaGetLastError();
}
