// Grouped DeltaLayer for Hopper: for each stream i of a group that shares B, T
// and the window, (B, T, D_i) f32 -> (B, T, 3 D_i) f32 = [x, delta, accel],
// all streams in one launch.
//
// Replaces the TPU kernel ip_avsr_tpu/ops/pallas/delta_kernel.py::_delta_kernel
// (:56, launched by _append_delta_pallas_impl).  Same function: over a
// sequence edge-padded by W frames on each side,
//     d[t] = sum_{theta=1..W} (x[t+theta] - x[t-theta]) / (2*theta)
// and the acceleration is the same FIR over d, edge-padded again.  Both are
// linear in x on the time axis, so [x, d, a] = S x, where S is the (3T, T)
// matrix whose row 3t + k is row t of I, F and F F (F the edge-clamped FIR
// matrix, F F formed in float64).  The wrapper builds S once per (T, W,
// device) (ops/delta.py::delta_matrix) and passes it in.
//
// What bounds it on the H100: latency and launches, not bytes.  At the
// models' shapes (T = 29, W = 9, D = 39..90, B <= 10) one stream moves
// 46-140 KB, a few hundredths of a microsecond at 3.35 TB/s, while a launch
// costs microseconds.  The earlier one-stream design paid, per stream, a
// launch, a load round trip and three block-wide barriers between four
// serial phases (stage x, first order, edge fill of d, second order).
//
// What the design does about it:
// - One launch per group.  The kernel takes a table of streams (input and
//   output pointers, D_i, first block) and each block finds its stream, batch
//   row, time chunk and feature tile from blockIdx.x alone; the entry point
//   lays out the blocks, stream after stream.  A model's forward launches it
//   once over every delta stream.
// - No barrier and no shared memory.  A thread owns one (t, feature) and
//   computes d and a from the composed rows of S across the band
//   [t - 2W, t + 2W] where they can be nonzero: both orders in one pass,
//   with no exchange between threads beyond its warp.  So there is no
//   cudaFuncSetAttribute and no shared-memory size to compute per call.
// - One memory round trip per 32 taps.  Every lane of a warp has the same t,
//   so lane j loads tap j of both rows of S (one coalesced load each) and
//   __shfl_sync hands it to the others, while each lane issues its 32 loads
//   of the x column before it uses the first.  At T = 29 the whole band is
//   one round.  A first version that read S and x tap by tap, four taps in
//   flight, took about twice as long on the H100, and longer than one
//   cuBLAS product of the same S (PERF.md, row 2).  The other way, each
//   warp recomputing the 2W + 1 values of d that its a needs, reads the x
//   column (2W + 1) 2W times per output instead of at most 4W + 1 times
//   (342 against 37 at W = 9).
// - Small blocks over many SMs.  A block is 4 warps x 32 lanes: 4 time rows
//   of one 32-feature tile.  The flagship's forward at B = 8 (two streams,
//   D = 50) is 256 blocks, the 4-stream model's at B = 10 720.
// - Coalescing: the 32 lanes of a warp cover consecutive features of one
//   time row, for the x reads and for each of the three output sections.
//
// Numerics: the composed rows round once per tap where the plain version
// rounds d to float32 before its second FIR; on normal inputs of std 3 the
// two differ by at most a few float32 ulps of the output.  window <= 0 gives
// zero deltas (S's rows 3t + 1 and 3t + 2 are zero).  The x section is a copy.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // features per block, and taps per round: a warp's lanes
constexpr int kRows = 4;         // time rows per block: its warps
constexpr int kMaxStreams = 16;  // streams one launch takes

struct Stream {
  const float* x;  // (B, T, D)
  float* out;      // (B, T, 3D)
  int D;
  int first;  // the stream's first block
};

struct Group {
  Stream s[kMaxStreams];
  int n;
};

__global__ void __launch_bounds__(kTile * kRows)
    delta_group_kernel(const Group group, const float* __restrict__ S, int B, int T, int window) {
  // the stream: the last whose first block is at or below this one (uniform
  // across the block)
  int i = 0;
  while (i + 1 < group.n && group.s[i + 1].first <= static_cast<int>(blockIdx.x)) ++i;
  const Stream st = group.s[i];
  const int D = st.D;
  const int tiles = (D + kTile - 1) / kTile;
  const int chunks = (T + kRows - 1) / kRows;
  const int local = blockIdx.x - st.first;
  const int tile = local % tiles;
  const int chunk = (local / tiles) % chunks;
  const int b = local / (tiles * chunks);
  const int t = chunk * kRows + threadIdx.y;
  const int f = tile * kTile + threadIdx.x;
  // [uniform] a whole warp leaves or stays: lanes past D stay for the
  // shuffles and load and store nothing
  if (b >= B || t >= T) return;
  const bool live = f < D;

  const float* xc = st.x + static_cast<size_t>(b) * T * D + f;  // x[b, :, f]
  const float* sd = S + static_cast<size_t>(3 * t + 1) * T;     // row of F
  const float* sa = sd + T;                                     // row of F F
  const float xt = live ? __ldg(xc + static_cast<size_t>(t) * D) : 0.f;
  const int lo = max(t - 2 * window, 0);
  const int hi = min(t + 2 * window, T - 1);
  float d = 0.f, a = 0.f;
  // [converge] rounds of kTile taps: the trip count and every shuffle are
  // the same for all lanes of the warp (lo and hi depend on t alone)
  for (int s0 = lo; s0 <= hi; s0 += kTile) {
    // lane j brings tap s0 + j of both rows of S: one coalesced load each
    const int sj = s0 + static_cast<int>(threadIdx.x);
    const float cd = sj <= hi ? __ldg(sd + sj) : 0.f;
    const float ca = sj <= hi ? __ldg(sa + sj) : 0.f;
    // all of the round's x loads are in flight before the first is used
    float v[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      v[j] = (live && s0 + j <= hi) ? __ldg(xc + static_cast<size_t>(s0 + j) * D) : 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      d = fmaf(__shfl_sync(0xffffffffu, cd, j), v[j], d);
      a = fmaf(__shfl_sync(0xffffffffu, ca, j), v[j], a);
    }
  }
  if (!live) return;
  float* o = st.out + (static_cast<size_t>(b) * T + t) * 3 * D + f;
  o[0] = xt;
  o[D] = d;
  o[2 * D] = a;
}

}  // namespace

// Launches one grid over the n <= 16 streams on `stream`: stream i reads
// xs[i] (B, T, widths[i]) and writes outs[i] (B, T, 3 widths[i]), and takes
// B * ceil(T / kRows) * ceil(widths[i] / kTile) blocks after those of the
// streams before it; S is the (3T, T) composed matrix for (T, window).
// Returns the grid's block count on success, else minus a CUDA error code
// (cudaErrorInvalidValue for a table the kernel cannot take, or
// cudaGetLastError() after the launch).
extern "C" int delta_group_forward(const void* const* xs, void* const* outs, const int* widths,
                                   int n, const void* S, int B, int T, int window,
                                   void* stream) {
  if (n < 1 || n > kMaxStreams || B < 1 || T < 1) return -static_cast<int>(cudaErrorInvalidValue);
  Group group{};
  group.n = n;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (widths[i] < 1) return -static_cast<int>(cudaErrorInvalidValue);
    group.s[i] = Stream{static_cast<const float*>(xs[i]), static_cast<float*>(outs[i]),
                        widths[i], blocks};
    blocks += B * ((T + kRows - 1) / kRows) * ((widths[i] + kTile - 1) / kTile);
  }
  delta_group_kernel<<<blocks, dim3(kTile, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      group, static_cast<const float*>(S), B, T, window > 0 ? window : 0);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

extern "C" const char* delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
