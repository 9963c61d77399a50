// Fused DeltaLayer for Hopper: (B, T, D) f32 -> (B, T, 3D) f32 = [x, delta, accel].
//
// Replaces the TPU kernel ip_avsr_tpu/ops/pallas/delta_kernel.py::_delta_kernel
// (launched by _append_delta_pallas_impl).  Same math: over a sequence
// edge-padded by W frames on each side,
//     d[t] = sum_{theta=1..W} (x[t+theta] - x[t-theta]) / (2*theta)
// and the acceleration is the same FIR over d, edge-padded again.
//
// Bound: bytes.  x is read once and [x, d, a] written once (16 bytes of
// traffic per input element against ~6W flops), so the card's memory rate
// bounds it.  Design: one block per (batch row, tile of 32 features); the
// block stages x[b, :, tile] with its W edge rows in shared memory, computes
// d into a second edge-padded shared buffer, then a, and writes all three
// sections straight into the (B, T, 3D) output (no concat pass).  Each warp
// covers the 32 features of one time row, so global reads and writes are
// 128-byte coalesced.  window <= 0 gives zero deltas: the tap loop is empty.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // features per block: one warp across a time row
constexpr int kRows = 8;   // warps per block, striding over time
constexpr int kStage = 8;  // padded rows each thread loads per round

__device__ __forceinline__ float fir(const float* buf, int window, int t, int f) {
  float acc = 0.f;
  for (int th = 1; th <= window; ++th) {
    acc += (1.0f / (2.0f * th)) *
           (buf[(window + t + th) * kTile + f] - buf[(window + t - th) * kTile + f]);
  }
  return acc;
}

__global__ void delta_kernel(const float* __restrict__ x, float* __restrict__ out,
                             int T, int D, int window) {
  extern __shared__ float smem[];
  const int P = T + 2 * window;
  float* xs = smem;              // (P, kTile) edge-padded x
  float* ds = smem + P * kTile;  // (P, kTile) edge-padded delta
  const int f = threadIdx.x;
  const int d = blockIdx.y * kTile + f;
  const bool live = d < D;
  const float* xb = x + static_cast<size_t>(blockIdx.x) * T * D;
  float* ob = out + static_cast<size_t>(blockIdx.x) * T * 3 * D;

  // Stage x through registers in whole rounds: a store to shared memory
  // between two loads would serialise their round trips to device memory.
  for (int p0 = threadIdx.y; p0 < P; p0 += kStage * kRows) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int p = p0 + u * kRows;
      const int t = min(max(p - window, 0), T - 1);
      v[u] = (live && p < P) ? __ldg(xb + static_cast<size_t>(t) * D + d) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int p = p0 + u * kRows;
      if (p < P) xs[p * kTile + f] = v[u];
      const int t = p - window;
      if (live && t >= 0 && t < T) ob[static_cast<size_t>(t) * 3 * D + d] = v[u];
    }
  }
  __syncthreads();

  for (int t = threadIdx.y; t < T; t += kRows) {
    const float v = fir(xs, window, t, f);
    ds[(window + t) * kTile + f] = v;
    if (live) ob[static_cast<size_t>(t) * 3 * D + D + d] = v;
  }
  __syncthreads();

  for (int p = threadIdx.y; p < window; p += kRows) {
    ds[p * kTile + f] = ds[window * kTile + f];
    ds[(window + T + p) * kTile + f] = ds[(window + T - 1) * kTile + f];
  }
  __syncthreads();

  for (int t = threadIdx.y; t < T; t += kRows) {
    const float v = fir(ds, window, t, f);
    if (live) ob[static_cast<size_t>(t) * 3 * D + 2 * D + d] = v;
  }
}

}  // namespace

extern "C" size_t delta_smem_bytes(int T, int window) {
  const int w = window > 0 ? window : 0;
  return 2 * static_cast<size_t>(T + 2 * w) * kTile * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int delta_forward(const void* x, void* out, int B, int T, int D,
                             int window, void* stream) {
  const int w = window > 0 ? window : 0;
  const size_t smem = delta_smem_bytes(T, w);
  cudaError_t err = cudaFuncSetAttribute(
      delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (D + kTile - 1) / kTile);
  const dim3 block(kTile, kRows);
  delta_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), T, D, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
