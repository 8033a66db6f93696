// K1: the pileup histogram, counts[start_r + j, code_r[j]] += 1.
//
// Replaces sam2consensus_tpu/ops/pallas_pileup.py::_kernel (grid call
// _pileup_call), the TPU tile-CSR VMEM histogram.
//
// Inputs: segment rows 4-bit packed (two codes per byte, the even column in
// the low nibble; codes 0..5 count, 15 = PAD adds nothing), their starts
// sorted ascending (one device sort in the wrapper) and the sort's
// permutation: sorted row r is packed row order[r].  No host-side plan: the
// host entry point sizes the grid from N, the row width and the SM count.
//
// Each block takes a fixed run of `rows_per_block` sorted rows and walks it
// with a sliding window of K1_WINDOW positions held in shared memory:
//   * the window's base is the start of its first row; the rows that fit
//     whole inside it (start + W <= base + K1_WINDOW; a prefix, since starts
//     are sorted, counted by the block in one pass) are staged into shared
//     memory, with 16-byte vector loads where the row width allows, and
//     counted with shared-memory atomics, one nibble per thread,
//     neighbouring threads on neighbouring positions;
//   * the first row that does not fit flushes the window and rebases it at
//     that row's start.  A row wider than the window is counted alone at the
//     window's base; its cells past the window go straight to device memory
//     with atomicAdd (phase 3's W = 16384, long-read segments);
//   * the counters are uint16 pairs: word k of a position holds symbols 2k
//     (low half) and 2k+1 (high half), laid out symbol-pair major
//     (hist[k * K1_WINDOW + local]) so the 32 lanes of a warp hit 32 banks.
//     A position gets at most one count per row, and a block holds at most
//     K1_MAX_ROWS = 65535 rows, so a half never carries into its neighbour;
//   * zero and flush cost is the window's extent (the positions its rows
//     span), not a fixed tile: the shared words are zeroed once per block
//     and re-zeroed by the flush that reads them;
//   * a flush adds into counts with a plain 8-byte read-modify-write (L2
//     only, __ldcg/__stcg) where no other block can touch the position in
//     this launch: [start of the previous block's last row + W, start of the
//     next block's first row).  Elsewhere (at most W positions at each end
//     of the block's span) it uses atomicAdd per non-zero cell.  Launches on
//     one stream run in order, so counts accumulate across slabs.
//
// Bound: bytes.  The rows and starts are read once and counts is read and
// written once where the rows cover it; the integer work is a few dozen
// operations per cell, and the shared counters turn the ~3 cells a position
// gets at E. coli coverage into one read-modify-write of its 24 bytes.
// What keeps it above the bound: a block's steps (stage, count, flush) run
// one after another, the flush waits on memory latency, and the blocks of
// an SM overlap each other's steps only in part.
//
// The geometry constants below can be overridden with -D, which is how
// perf/k1_explore.py builds and times the alternatives on the card; its
// logs (perf/k1_explore_*.log) show each chosen value against its
// neighbours at ecoli_scale, and atomicAdd for every flushed cell
// (K1_PLAIN_FLUSH 0) against the plain read-modify-write.
#include <limits.h>

#include "kernels.h"

#define NSYM 6
#define THREADS 256
// positions of a block's shared window: 12 KiB of uint16 counter pairs
#ifndef K1_WINDOW
#define K1_WINDOW 1024
#endif
// packed bytes a block stages per step
#ifndef K1_STAGE
#define K1_STAGE 8192
#endif
// resident blocks an SM should hold: the launch bounds hold a thread to
// 65536 / (256 * 5) = 51 registers for it (48 in practice, no spills; at 6
// blocks, 40 registers spill), and the grid fills that many blocks per SM
#ifndef K1_BLOCKS_PER_SM
#define K1_BLOCKS_PER_SM 5
#endif
// flush positions a thread has in flight
#ifndef K1_FLUSH_UNROLL
#define K1_FLUSH_UNROLL 2
#endif
// 1: plain read-modify-write where no other block reaches; 0: atomicAdd
// for every flushed cell
#ifndef K1_PLAIN_FLUSH
#define K1_PLAIN_FLUSH 1
#endif
// rows a block may hold: the 16-bit counters allow 65535 counts a position
#define K1_MAX_ROWS 65535
// rows a stage may hold; this caps only rows narrower than 16 bytes (32
// columns, the narrowest bucket width)
#define K1_MAX_STAGED (K1_STAGE / 16)

static_assert(K1_WINDOW % 32 == 0, "K1_WINDOW must be a multiple of 32");
static_assert(K1_STAGE % 16 == 0, "K1_STAGE must be a multiple of 16");

namespace {

// Add the window's first `extent` positions into counts and zero them.
// A thread issues all the loads of its K1_FLUSH_UNROLL positions before it
// adds: the read-modify-write is latency-bound otherwise.
__device__ void flush(uint32_t* hist, long long base, int extent,
                      long long ex_lo, long long ex_hi,
                      int32_t* __restrict__ counts)
{
    for (int l0 = threadIdx.x; l0 < extent;
         l0 += K1_FLUSH_UNROLL * blockDim.x) {
        uint32_t h[K1_FLUSH_UNROLL][3];
        int2 v[K1_FLUSH_UNROLL][3];
        bool rmw[K1_FLUSH_UNROLL];
#pragma unroll
        for (int u = 0; u < K1_FLUSH_UNROLL; ++u) {
            const int l = l0 + u * blockDim.x;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                h[u][k] = l < extent ? hist[k * K1_WINDOW + l] : 0;
            const long long pos = base + l;
            rmw[u] = (h[u][0] | h[u][1] | h[u][2]) != 0 && pos >= ex_lo
                && pos < ex_hi;
            if (rmw[u]) {
                const int2* p =
                    reinterpret_cast<const int2*>(counts + pos * NSYM);
#pragma unroll
                for (int k = 0; k < 3; ++k) v[u][k] = __ldcg(p + k);
            }
        }
#pragma unroll
        for (int u = 0; u < K1_FLUSH_UNROLL; ++u) {
            if ((h[u][0] | h[u][1] | h[u][2]) == 0) continue;
            const int l = l0 + u * blockDim.x;
#pragma unroll
            for (int k = 0; k < 3; ++k) hist[k * K1_WINDOW + l] = 0;
            int32_t* cell = counts + (base + l) * NSYM;
            if (rmw[u]) {
                int2* p = reinterpret_cast<int2*>(cell);
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    int2 x = v[u][k];
                    x.x += (int)(h[u][k] & 0xFFFF);
                    x.y += (int)(h[u][k] >> 16);
                    __stcg(p + k, x);
                }
            } else {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const int lo = (int)(h[u][k] & 0xFFFF);
                    const int hi = (int)(h[u][k] >> 16);
                    if (lo) atomicAdd(cell + 2 * k, lo);
                    if (hi) atomicAdd(cell + 2 * k + 1, hi);
                }
            }
        }
    }
    __syncthreads();
}

// VEC = 16: rows of a multiple of 16 bytes at a 16-byte aligned base (the
// main path's: every bucket width is a power of two of at least 32
// columns); VEC = 1 for any other width.
template <int VEC>
struct Chunk;
template <> struct Chunk<16> { typedef int4 T; };
template <> struct Chunk<1> { typedef uint8_t T; };

template <int VEC>
__global__ void __launch_bounds__(THREADS, K1_BLOCKS_PER_SM)
pileup_rows_kernel(
    const int32_t* __restrict__ starts,     // [n] ascending
    const int64_t* __restrict__ order,      // [n] packed row of sorted row r
    const uint8_t* __restrict__ packed,     // [n, wb], input order
    int n, int wb, int rows_per_block, int cap,
    long long n_pos, int32_t* __restrict__ counts)   // [n_pos, 6]
{
    typedef typename Chunk<VEC>::T vec_t;
    __shared__ __align__(16) uint32_t hist[3 * K1_WINDOW];
    __shared__ __align__(16) uint8_t bytes[K1_STAGE];
    __shared__ int32_t row_start[K1_MAX_STAGED];

    const int row_lo = blockIdx.x * rows_per_block;
    const int row_hi = min(n, row_lo + rows_per_block);
    const long long w = 2LL * wb;                              // cells a row
    const long long ex_lo = !K1_PLAIN_FLUSH ? LLONG_MAX
        : blockIdx.x == 0 ? LLONG_MIN : (long long)starts[row_lo - 1] + w;
    const long long ex_hi = row_hi == n
        ? LLONG_MAX : (long long)starts[row_hi];

    for (int i = threadIdx.x; i < 3 * K1_WINDOW / 4; i += blockDim.x)
        reinterpret_cast<uint4*>(hist)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();

    const int pw = min(wb, K1_STAGE);       // staged bytes of a row
    long long base = starts[row_lo];
    long long end = base;                   // end of the window's extent
    int i = row_lo;
    while (i < row_hi) {
        const long long s_i = starts[i];
        int j;
        if (s_i + w <= base + K1_WINDOW) {
            // the rows after i that fit: a prefix, counted in parallel
            const int top = min(row_hi, i + cap);
            const long long lim = base + K1_WINDOW - w;
            j = i + 1;
            for (int r0 = i + 1; r0 < top; r0 += blockDim.x) {
                const int r = r0 + threadIdx.x;
                j += __syncthreads_count(r < top && starts[r] <= lim);
            }
        } else if (s_i == base) {
            j = i + 1;                      // wider than the window
        } else {
            flush(hist, base, (int)max(0LL, end - base), ex_lo, ex_hi,
                  counts);
            base = end = s_i;
            continue;
        }
        const int rows = j - i;
        for (int b0 = 0; b0 < wb; b0 += pw) {
            const int bw = min(pw, wb - b0);
            const int vpr = bw / VEC;
            for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
                const int r = v / vpr;
                const int cv = v - r * vpr;
                const vec_t* src = reinterpret_cast<const vec_t*>(
                    packed + order[i + r] * wb + b0) + cv;
                reinterpret_cast<vec_t*>(bytes + r * bw)[cv] = __ldg(src);
            }
            for (int r = threadIdx.x; r < rows; r += blockDim.x)
                row_start[r] = starts[i + r];
            __syncthreads();

            // one nibble a thread; (r, c) advance by blockDim.x nibbles
            // without a division in the loop
            const int nw = 2 * bw;
            const int dr = blockDim.x / nw;
            const int dc = blockDim.x - dr * nw;
            int r = threadIdx.x / nw;
            int c = threadIdx.x - r * nw;
            for (int k = threadIdx.x; k < rows * nw; k += blockDim.x) {
                const int code = (bytes[r * bw + (c >> 1)] >> ((c & 1) * 4))
                    & 0xF;
                const long long pos = (long long)row_start[r] + 2LL * b0 + c;
                if (code < NSYM && pos >= 0 && pos < n_pos) {
                    const long long local = pos - base;
                    if (local < K1_WINDOW)
                        atomicAdd(&hist[(code >> 1) * K1_WINDOW + (int)local],
                                  (code & 1) ? 0x10000u : 1u);
                    else
                        atomicAdd(&counts[pos * NSYM + code], 1);
                }
                r += dr;
                c += dc;
                if (c >= nw) { c -= nw; ++r; }
            }
            __syncthreads();
        }
        end = max(end, min(base + K1_WINDOW,
                           min(n_pos, (long long)starts[j - 1] + w)));
        i = j;
    }
    flush(hist, base, (int)max(0LL, end - base), ex_lo, ex_hi, counts);
}

}  // namespace

cudaError_t s2c_pileup_rows(
    const int32_t* starts, const int64_t* order, const uint8_t* packed,
    int n, int wb, long long n_pos, int32_t* counts, cudaStream_t stream)
{
    if (n <= 0 || wb <= 0) return cudaErrorInvalidValue;
    const int sms = s2c_sm_count();
    if (sms <= 0) return cudaErrorInvalidConfiguration;
    // rows a stage holds; a block gets at least that many, else spreads the
    // rows over the resident blocks, and never more than its counters allow
    const int pw = wb < K1_STAGE ? wb : K1_STAGE;
    const int cap = K1_STAGE / pw < K1_MAX_STAGED ? K1_STAGE / pw
                                                  : K1_MAX_STAGED;
    const long long slots = (long long)sms * K1_BLOCKS_PER_SM;
    long long rb = (n + slots - 1) / slots;
    rb = rb > cap ? rb : cap;
    rb = rb < K1_MAX_ROWS ? rb : K1_MAX_ROWS;
    const int grid = (int)((n + rb - 1) / rb);
    // the widest load that every staged piece's source and target allow
    // (pieces start at multiples of K1_STAGE, itself a multiple of 16)
    if (wb % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0)
        pileup_rows_kernel<16><<<grid, THREADS, 0, stream>>>(
            starts, order, packed, n, wb, (int)rb, cap, n_pos, counts);
    else
        pileup_rows_kernel<1><<<grid, THREADS, 0, stream>>>(
            starts, order, packed, n, wb, (int)rb, cap, n_pos, counts);
    return cudaGetLastError();
}
