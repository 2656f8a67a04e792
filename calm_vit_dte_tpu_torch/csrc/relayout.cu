// The head-split relayout, written for Hopper (sm_90a) in plain CUDA C++:
//   y[b, h, s, :] = x[b, s, h, :]
// for a contiguous x (B, S, H, D) and a contiguous y (B, H, S, D): the
// (s, h, d) -> (h, s, d) swap that turns the projection's natural layout
// into the attention kernels' (B, H, S, D).
//
// Replaces the Pallas TPU kernel of the toolchain canary,
// scripts/canary_probes.py::probe_swap (pallas_call at :62), and the same
// kernel at module level in scripts/mosaic_swap_probe.py (:29): there one
// grid step per batch element loads the (S, H, D) block into VMEM and
// stores its swapaxes(0, 1). Dropped from the TPU kernel: the VMEM block
// and its 110 MB limit (a TPU tiling device); each row is copied straight
// from device memory to device memory here.
//
// What bounds it on the H100: it is a copy, zero operations, so bytes:
// each element read once and written once, 2 * B*S*H*D * itemsize (77.1 MB
// at B=128, S=224, H=12, D=56 in bf16: 23.0 us at 3.35 TB/s).
//
// Design: the kernel is a row gather. Output row (b, h, s) is the
// contiguous input row (b, s, h) of D * itemsize bytes, so the element type
// does not matter: rows are copied as raw bytes, in vectors of the widest
// width (16, 8, 4 or 2 bytes) that divides the row's byte length and both
// base addresses. In bf16, D = 56 gives 112-byte rows (16-byte vectors);
// D = 44 (88 B) and D = 20 (40 B) rows start on 8-byte boundaries only, so
// they take 8-byte vectors; in fp32 every flagship D is a multiple of 16
// bytes. One block row of the grid per (b, h): thread j writes vector j of
// the contiguous output slab y[b, h] (S rows), so a warp's stores are one
// contiguous run and its loads are runs of one row each, H rows apart.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Grid (ceil(S * vecs_per_row / kThreads), H, B): block (., h, b) writes
// the contiguous output slab y[b, h] of S rows.
template <typename V>
__global__ void __launch_bounds__(kThreads) swap_seq_heads_kernel(
    const V* __restrict__ x, V* __restrict__ y, int S, int vecs_per_row) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int slab = S * vecs_per_row;
  if (j >= slab) return;
  const int H = gridDim.y;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int s = j / vecs_per_row;
  const int v = j - s * vecs_per_row;
  const size_t src_row = (b * S + s) * H + h;
  y[(b * H + h) * slab + j] = x[src_row * vecs_per_row + v];
}

template <typename V>
cudaError_t launch(const void* x, void* y, int B, int S, int H,
                   int row_bytes, cudaStream_t stream) {
  const int vecs_per_row = row_bytes / (int)sizeof(V);
  const dim3 grid((S * vecs_per_row + kThreads - 1) / kThreads, H, B);
  swap_seq_heads_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(y), S, vecs_per_row);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, H, D) -> y (B, H, S, D), both contiguous, rows of row_bytes =
// D * itemsize bytes. Returns the CUDA error of the launch (0 on success).
extern "C" int swap_seq_heads(const void* x, void* y, int B, int S, int H,
                              int row_bytes, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || S < 1 || row_bytes < 2 ||
      row_bytes % 2 != 0 || (long long)S * row_bytes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)y | (uintptr_t)row_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) return (int)launch<uint4>(x, y, B, S, H, row_bytes, st);
  if (align % 8 == 0) return (int)launch<uint2>(x, y, B, S, H, row_bytes, st);
  if (align % 4 == 0) return (int)launch<uint32_t>(x, y, B, S, H, row_bytes, st);
  return (int)launch<uint16_t>(x, y, B, S, H, row_bytes, st);
}
