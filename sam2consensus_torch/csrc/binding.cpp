// PyTorch binding of the CUDA kernels: one typed tensor entry point each.
//
// The only source that includes PyTorch's headers (compiled by the host
// compiler; the .cu files are not).  Each entry point checks device, type,
// shape and contiguity, takes its sizes from the tensors, launches on
// PyTorch's current stream of the output's device, and raises on empty
// work or a refused launch (so a return means one launch).  It allocates nothing: the Python wrappers (ops/pileup_kernel.py,
// ops/insertion_kernel.py) pass the outputs in.
#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include "kernels.h"

namespace {

void check(const at::Tensor& t, at::ScalarType dtype, const at::Device& dev,
           const char* name) {
    TORCH_CHECK(t.is_cuda() && t.device() == dev, name, ": must be on ", dev,
                ", is on ", t.device());
    TORCH_CHECK(t.scalar_type() == dtype, name, ": must be ", dtype,
                ", is ", t.scalar_type());
    TORCH_CHECK(t.is_contiguous(), name, ": must be contiguous");
}

void launched(cudaError_t err, const char* kernel) {
    TORCH_CHECK(err == cudaSuccess, "CUDA kernel ", kernel,
                " failed to launch: ", cudaGetErrorString(err));
}

int as_int(int64_t v, const char* name) {
    TORCH_CHECK(v >= 0 && v <= INT32_MAX, name, " = ", v, " is out of range");
    return (int)v;
}

}  // namespace

// K1: counts [P, 6] += the histogram of tile-sorted packed rows [N, wb].
void pileup_tiles(const at::Tensor& starts, const at::Tensor& packed,
                  const at::Tensor& item_tile, const at::Tensor& item_lo,
                  const at::Tensor& item_hi, int64_t tile,
                  const at::Tensor& counts) {
    const at::Device dev = counts.device();
    check(counts, at::kInt, dev, "counts");
    check(starts, at::kInt, dev, "starts");
    check(packed, at::kByte, dev, "packed");
    check(item_tile, at::kInt, dev, "item_tile");
    check(item_lo, at::kInt, dev, "item_lo");
    check(item_hi, at::kInt, dev, "item_hi");
    TORCH_CHECK(counts.dim() == 2 && counts.size(1) == 6,
                "counts: must be [P, 6]");
    TORCH_CHECK(packed.dim() == 2 && starts.dim() == 1
                && starts.size(0) == packed.size(0),
                "starts [N] and packed [N, W/2] must agree");
    const int64_t n_items = item_tile.numel();
    TORCH_CHECK(item_lo.numel() == n_items && item_hi.numel() == n_items,
                "item_tile, item_lo and item_hi must have one length");
    TORCH_CHECK(tile > 0 && tile * 6 * 4 <= 227 * 1024,
                "tile = ", tile, " does not fit in shared memory");
    TORCH_CHECK(n_items > 0, "pileup_tiles: no work item to launch");
    const c10::cuda::CUDAGuard guard(dev);
    launched(s2c_pileup_tiles(
        starts.data_ptr<int32_t>(), packed.data_ptr<uint8_t>(),
        item_tile.data_ptr<int32_t>(), item_lo.data_ptr<int32_t>(),
        item_hi.data_ptr<int32_t>(), as_int(n_items, "work items"),
        as_int(packed.size(1), "packed width"), (int)tile, counts.size(0),
        counts.data_ptr<int32_t>(), c10::cuda::getCurrentCUDAStream()),
        "pileup_tiles");
}

// K3: out [kp, cp, 6] = the insertion table of key-sorted events.
void insertion_table(const at::Tensor& key_ptr, const at::Tensor& cc,
                     int64_t chunk, const at::Tensor& out) {
    const at::Device dev = out.device();
    check(out, at::kInt, dev, "out");
    check(key_ptr, at::kInt, dev, "key_ptr");
    check(cc, at::kInt, dev, "cc");
    TORCH_CHECK(out.dim() == 3 && out.size(2) == 6, "out: must be [K, C, 6]");
    TORCH_CHECK(key_ptr.numel() == out.size(0) + 1, "key_ptr: must be [K+1]");
    TORCH_CHECK(chunk > 0 && chunk <= 4096, "chunk = ", chunk);
    TORCH_CHECK(out.numel() > 0, "insertion_table: empty table");
    const c10::cuda::CUDAGuard guard(dev);
    launched(s2c_insertion_table(
        key_ptr.data_ptr<int32_t>(), cc.data_ptr<int32_t>(),
        as_int(out.size(0), "keys"), as_int(out.size(1), "columns"),
        (int)chunk, out.data_ptr<int32_t>(),
        c10::cuda::getCurrentCUDAStream()),
        "insertion_table");
}

// K2: out [T, kp, cp] = the insertion vote (IUPAC ASCII, 0 = FILL).
void insertion_vote(const at::Tensor& key_ptr, const at::Tensor& cc,
                    const at::Tensor& site_cov, const at::Tensor& n_cols,
                    const at::Tensor& thr, const at::Tensor& lut,
                    int64_t chunk, const at::Tensor& out) {
    const at::Device dev = out.device();
    check(out, at::kByte, dev, "out");
    check(key_ptr, at::kInt, dev, "key_ptr");
    check(cc, at::kInt, dev, "cc");
    check(site_cov, at::kInt, dev, "site_cov");
    check(n_cols, at::kInt, dev, "n_cols");
    check(thr, at::kDouble, dev, "thr");
    check(lut, at::kByte, dev, "lut");
    TORCH_CHECK(out.dim() == 3, "out: must be [T, K, C]");
    const int64_t kp = out.size(1);
    TORCH_CHECK(thr.numel() == out.size(0), "thr: must be [T]");
    TORCH_CHECK(key_ptr.numel() == kp + 1, "key_ptr: must be [K+1]");
    TORCH_CHECK(site_cov.numel() == kp && n_cols.numel() == kp,
                "site_cov and n_cols: must be [K]");
    TORCH_CHECK(lut.numel() == 64, "lut: must be [64]");
    TORCH_CHECK(chunk > 0 && chunk <= 4096, "chunk = ", chunk);
    TORCH_CHECK(out.numel() > 0, "insertion_vote: empty output");
    const c10::cuda::CUDAGuard guard(dev);
    launched(s2c_insertion_vote(
        key_ptr.data_ptr<int32_t>(), cc.data_ptr<int32_t>(),
        site_cov.data_ptr<int32_t>(), n_cols.data_ptr<int32_t>(),
        thr.data_ptr<double>(), lut.data_ptr<uint8_t>(),
        as_int(out.size(0), "thresholds"), as_int(kp, "keys"),
        as_int(out.size(2), "columns"), (int)chunk, out.data_ptr<uint8_t>(),
        c10::cuda::getCurrentCUDAStream()),
        "insertion_vote");
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
    m.def("pileup_tiles", &pileup_tiles, "K1: pileup histogram");
    m.def("insertion_table", &insertion_table, "K3: insertion table");
    m.def("insertion_vote", &insertion_vote, "K2: insertion table + vote");
}
