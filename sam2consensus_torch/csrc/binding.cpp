// PyTorch binding of the CUDA kernels: one typed tensor entry point each.
//
// The only source that includes PyTorch's headers (compiled by the host
// compiler; the .cu files are not).  Each entry point checks device, type,
// shape and contiguity, takes its sizes from the tensors, launches on
// PyTorch's current stream of the output's device, raises on empty work or
// a refused launch, and returns the number of kernel launches it made (the
// Python side's launch counter adds it).  It allocates nothing: the Python
// wrappers (ops/pileup_kernel.py, ops/insertion_kernel.py) pass the outputs
// and scratch in.
#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <pybind11/stl.h>

#include <string>
#include <vector>

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

// K1: counts [P, 6] += the histogram of packed rows [N, wb], given their
// starts sorted ascending and the sort's permutation.
int64_t pileup_rows(const at::Tensor& starts, const at::Tensor& order,
                    const at::Tensor& packed, const at::Tensor& counts) {
    const at::Device dev = counts.device();
    check(counts, at::kInt, dev, "counts");
    check(starts, at::kInt, dev, "starts");
    check(order, at::kLong, dev, "order");
    check(packed, at::kByte, dev, "packed");
    TORCH_CHECK(counts.dim() == 2 && counts.size(1) == 6,
                "counts: must be [P, 6]");
    TORCH_CHECK(reinterpret_cast<uintptr_t>(counts.data_ptr()) % 8 == 0,
                "counts: must be 8-byte aligned");
    TORCH_CHECK(packed.dim() == 2 && starts.dim() == 1 && order.dim() == 1
                && starts.size(0) == packed.size(0)
                && order.size(0) == packed.size(0),
                "starts [N], order [N] and packed [N, W/2] must agree");
    TORCH_CHECK(packed.size(0) > 0 && packed.size(1) > 0,
                "pileup_rows: no row to count");
    const c10::cuda::CUDAGuard guard(dev);
    launched(s2c_pileup_rows(
        starts.data_ptr<int32_t>(), order.data_ptr<int64_t>(),
        packed.data_ptr<uint8_t>(), as_int(packed.size(0), "rows"),
        as_int(packed.size(1), "packed width"), counts.size(0),
        counts.data_ptr<int32_t>(), c10::cuda::getCurrentCUDAStream()),
        "pileup_rows");
    return 1;
}

// K3: out [kp, cp, 6] = the insertion table of key-sorted events.
int64_t insertion_table(const at::Tensor& key_ptr, const at::Tensor& cc,
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
    return 1;
}

// K2: out [T, kp, cp] = the insertion vote (IUPAC ASCII, 0 = FILL) of
// unsorted events; `table` is int32 [kp, cp, 6] scratch.
int64_t insertion_vote(const at::Tensor& key, const at::Tensor& col,
                       const at::Tensor& code, const at::Tensor& site_cov,
                       const at::Tensor& n_cols,
                       const std::vector<double>& thresholds,
                       const std::string& lut, const at::Tensor& table,
                       const at::Tensor& out) {
    const at::Device dev = out.device();
    check(out, at::kByte, dev, "out");
    check(table, at::kInt, dev, "table");
    check(key, at::kInt, dev, "key");
    check(col, at::kInt, dev, "col");
    check(code, at::kInt, dev, "code");
    check(site_cov, at::kInt, dev, "site_cov");
    check(n_cols, at::kInt, dev, "n_cols");
    TORCH_CHECK(out.dim() == 3, "out: must be [T, K, C]");
    const int64_t kp = out.size(1), cp = out.size(2);
    TORCH_CHECK(table.dim() == 3 && table.size(0) == kp
                && table.size(1) == cp && table.size(2) == 6,
                "table: must be [K, C, 6]");
    TORCH_CHECK(reinterpret_cast<uintptr_t>(table.data_ptr()) % 8 == 0,
                "table: must be 8-byte aligned");
    TORCH_CHECK((int64_t)thresholds.size() == out.size(0),
                "thresholds: must be [T]");
    TORCH_CHECK(key.dim() == 1 && col.sizes() == key.sizes()
                && code.sizes() == key.sizes(), "key, col, code: must be [E]");
    TORCH_CHECK(site_cov.numel() == kp && n_cols.numel() == kp,
                "site_cov and n_cols: must be [K]");
    TORCH_CHECK(lut.size() == 64, "lut: must be 64 bytes");
    TORCH_CHECK(out.numel() > 0, "insertion_vote: empty output");
    const c10::cuda::CUDAGuard guard(dev);
    int launches = 0;
    launched(s2c_insertion_vote(
        key.data_ptr<int32_t>(), col.data_ptr<int32_t>(),
        code.data_ptr<int32_t>(), as_int(key.numel(), "events"),
        site_cov.data_ptr<int32_t>(), n_cols.data_ptr<int32_t>(),
        thresholds.data(), as_int(out.size(0), "thresholds"),
        reinterpret_cast<const uint8_t*>(lut.data()),
        as_int(kp, "keys"), as_int(cp, "columns"), table.data_ptr<int32_t>(),
        out.data_ptr<uint8_t>(), c10::cuda::getCurrentCUDAStream(),
        &launches),
        "insertion_vote");
    return launches;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
    m.def("pileup_rows", &pileup_rows, "K1: pileup histogram");
    m.def("insertion_table", &insertion_table, "K3: insertion table");
    m.def("insertion_vote", &insertion_vote, "K2: insertion table + vote");
}
