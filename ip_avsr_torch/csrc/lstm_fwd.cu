// Masked LSTM recurrence for Hopper, f32, with or without peepholes.
//
// Replaces the TPU kernels of ip_avsr_tpu/ops/pallas/lstm_kernel.py in all
// four of their launches: _lstm_fwd_kernel as lstm_pallas (inference) and
// lstm_pallas_train (the training forward, which also writes the post-mask
// cells and the pre-activation gates for the backward chain in lstm_bwd.cu),
// and _lstm_peep_fwd_kernel as lstm_pallas_peep and lstm_pallas_peep_train.
// As on the TPU, one body serves them all (template parameters EmitResiduals
// and Peephole), so inference and training share one set of numerics; the
// inference instantiations make no residual stores and the non-peephole ones
// no peephole loads.  Per step t:
//     gates = x_proj[:, t] + h_{t-1} @ W_hid          (gate order i, f, c, o)
//     c'    = sigmoid(f + w_cf * c_{t-1}) * c_{t-1} + sigmoid(i + w_ci * c_{t-1}) * tanh(c)
//     h'    = sigmoid(o + w_co * c') * tanh(c')
//     (c_t, h_t) = m * (c', h') + (1 - m) * (c_{t-1}, h_{t-1})   (mask carry)
// where the three (H,) peephole terms are zero without peepholes.  The
// stored gates are those before the peephole terms, as on the TPU.
// The hoisted input projection x @ W_in + b stays a cuBLAS product outside
// (as XLA computed it outside the Pallas kernel); h @ W_hid is computed here.
//
// Bound: the serial chain of T steps, each of which must read all of W_hid
// (H x 4H f32, 4 MB at H = 500) and exchange h across the whole card.  The TPU
// kept W_hid resident in one core's VMEM; on Hopper it does not fit one SM's
// shared memory, so this design partitions by hidden unit instead: a block
// owns kUnits hidden units j, hence gate columns {j, H+j, 2H+j, 3H+j}, so the
// gate math and the cell state stay local to the block.  W_hid is read from
// global memory every step and stays in the 50 MB L2 across steps.  Only h
// crosses blocks, through global memory between launches: the C entry point
// issues one launch per time step on the caller's stream (T launches per
// call), so the launch boundary is the step barrier.  A persistent kernel
// with a grid or cluster barrier, bf16 W_hid and wgmma are later work.  The
// peepholes are local to a unit (three loads and three multiply-adds per
// (row, step, unit)), so they change none of this; the peephole models' H =
// 250 gives 63 blocks per 8 rows, the last with 2 live units.
//
// Layouts are batch-major, the port's public layout, so no transpose is
// needed: x_proj (B, T, 4H), mask (B, T), out (B, T, H), and the residuals
// cells (B, T, H) and gates (B, T, 4H).  Step t reads h_{t-1} from
// out[:, t-1] (or hid0 at t = 0) and writes out[:, t]; the cell state (B, H)
// is updated in place, each element by exactly one thread.
#include <cuda_runtime.h>

namespace {

// 4 units per block gives H / 4 = 125 blocks at H = 500, about one per SM of
// the 132; 8 units (63 blocks) measured slower.
constexpr int kUnits = 4;   // hidden units per block -> 4 * kUnits gate columns
constexpr int kSplit = 16;  // slices of the length-H dot product per column
constexpr int kRowsB = 8;   // batch rows per block
constexpr int kCols = 4 * kUnits;
constexpr int kThreads = kCols * kSplit;  // 256
constexpr int kStage = 2;   // h elements per row and thread staged per round

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// A step is a short chain of memory round trips (h_{t-1}, then W_hid, then
// the gate inputs), so the kernel keeps as many loads in flight as it can:
// the gate inputs are fetched first, h_{t-1} is staged through registers in
// whole rounds (a store to shared memory between two loads would serialise
// them), and the dot-product loop is unrolled by 8 (16 measured the same,
// 32 slower).  With EmitResiduals the gate-stage threads also store the
// post-mask cell to cells[:, t] and the four pre-activation gates to
// gates[:, t]; otherwise those pointers are unused.  With Peephole the
// gate-stage thread of unit j also loads w_ci[j], w_cf[j] and w_co[j]
// (H-vectors; the j < H guard of gate_live covers a last block with fewer
// than kUnits live units); otherwise those pointers are unused.
template <bool EmitResiduals, bool Peephole>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hid,
                 const float* __restrict__ mask, const float* h_prev,
                 long long h_stride, float* __restrict__ cell, float* out,
                 float* __restrict__ cells, float* __restrict__ gates,
                 const float* __restrict__ w_ci, const float* __restrict__ w_cf,
                 const float* __restrict__ w_co, int B, int T, int H, int t) {
  extern __shared__ float smem[];
  float* hs = smem;                   // (kRowsB, H): h_{t-1} of this block's rows
  float* part = smem + kRowsB * H;    // (kSplit, kRowsB, kCols): partial dots
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRowsB;
  const int nb = min(kRowsB, B - b0);
  const int tid = threadIdx.x;

  // gate-stage thread (gr, gu): batch row b0 + gr, hidden unit j0 + gu
  const int gr = tid / kUnits;
  const int gu = tid % kUnits;
  const bool gate_live = tid < kRowsB * kUnits && gr < nb && j0 + gu < H;
  const size_t gb = b0 + gr;
  const size_t gj = j0 + gu;
  float xin[4] = {0.f, 0.f, 0.f, 0.f};
  float c_prev = 0.f, m = 0.f;
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;  // peephole weights of unit gj
  if (gate_live) {
    const float* xp = x_proj + (gb * T + t) * 4 * static_cast<size_t>(H) + gj;
#pragma unroll
    for (int q = 0; q < 4; ++q) xin[q] = __ldg(xp + static_cast<size_t>(q) * H);
    m = __ldg(mask + gb * T + t);
    c_prev = cell[gb * H + gj];
    if constexpr (Peephole) {
      p_i = __ldg(w_ci + gj);
      p_f = __ldg(w_cf + gj);
      p_o = __ldg(w_co + gj);
    }
  }

  for (int k0 = 0; k0 < H; k0 += kStage * kThreads) {
    float v[kRowsB][kStage];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int k = k0 + u * kThreads + tid;
        v[r][u] = (r < nb && k < H)
                      ? __ldg(h_prev + static_cast<size_t>(b0 + r) * h_stride + k) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int k = k0 + u * kThreads + tid;
        if (k < H) hs[r * H + k] = v[r][u];
      }
    }
  }
  __syncthreads();

  // Thread (col, ks): column col = g * kUnits + u of gate g for unit j0 + u,
  // summing k = ks, ks + kSplit, ...  A warp is two ks across all 16
  // columns, so each hs[r * H + k] read is a broadcast.
  const int col = tid % kCols;
  const int ks = tid / kCols;
  const int g = col / kUnits;
  const int j = j0 + col % kUnits;
  float acc[kRowsB];
#pragma unroll
  for (int r = 0; r < kRowsB; ++r) acc[r] = 0.f;
  if (j < H) {
    const float* wcol = w_hid + static_cast<size_t>(g) * H + j;
    const size_t ld = static_cast<size_t>(4) * H;
#pragma unroll 8
    for (int k = ks; k < H; k += kSplit) {
      const float w = __ldg(wcol + k * ld);
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsB; ++r) part[(ks * kRowsB + r) * kCols + col] = acc[r];
  __syncthreads();

  if (gate_live) {
    float gate[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) s += part[(p * kRowsB + gr) * kCols + q * kUnits + gu];
      gate[q] = xin[q] + s;
    }
    const float h_prev_v = hs[gr * H + gj];
    float z_i = gate[0], z_f = gate[1], z_o = gate[3];
    if constexpr (Peephole) {
      z_i += c_prev * p_i;
      z_f += c_prev * p_f;
    }
    const float c_new = sigm(z_f) * c_prev + sigm(z_i) * tanhf(gate[2]);
    if constexpr (Peephole) z_o += c_new * p_o;
    const float h_new = sigm(z_o) * tanhf(c_new);
    const float c_out = m * c_new + (1.0f - m) * c_prev;
    cell[gb * H + gj] = c_out;
    out[(gb * T + t) * H + gj] = m * h_new + (1.0f - m) * h_prev_v;
    if constexpr (EmitResiduals) {
      cells[(gb * T + t) * H + gj] = c_out;
      float* gp = gates + (gb * T + t) * 4 * static_cast<size_t>(H) + gj;
#pragma unroll
      for (int q = 0; q < 4; ++q) gp[static_cast<size_t>(q) * H] = gate[q];
    }
  }
}

// Runs all T steps of one instantiation on `stream`; see the entry points.
// `peep` holds w_ci, w_cf, w_co (each (H,)) or is null without peepholes.
template <bool EmitResiduals, bool Peephole>
int run_steps(const void* x_proj, const void* w_hid, const void* mask, const void* hid0,
              void* cell, void* out, void* cells, void* gates, const void* const* peep,
              int B, int T, int H, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_step_kernel<EmitResiduals, Peephole>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRowsB - 1) / kRowsB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x_proj);
  const float* w = static_cast<const float*>(w_hid);
  const float* m = static_cast<const float*>(mask);
  float* c = static_cast<float*>(cell);
  float* o = static_cast<float*>(out);
  const float* wci = Peephole ? static_cast<const float*>(peep[0]) : nullptr;
  const float* wcf = Peephole ? static_cast<const float*>(peep[1]) : nullptr;
  const float* wco = Peephole ? static_cast<const float*>(peep[2]) : nullptr;
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? static_cast<const float*>(hid0) : o + static_cast<size_t>(t - 1) * H;
    const long long stride = t == 0 ? H : static_cast<long long>(T) * H;
    lstm_step_kernel<EmitResiduals, Peephole><<<grid, kThreads, smem, s>>>(
        xp, w, m, h, stride, c, o, static_cast<float*>(cells), static_cast<float*>(gates),
        wci, wcf, wco, B, T, H, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" size_t lstm_fwd_smem_bytes(int H) {
  return (static_cast<size_t>(kRowsB) * H + kSplit * kRowsB * kCols) * sizeof(float);
}

// Runs all T steps on `stream`.  `cell` (B, H) holds cell0 on entry and the
// final cell state on return; `hid0` (B, H) is read at t = 0.  Returns the
// first CUDA error (0 on success).
extern "C" int lstm_fwd_forward(const void* x_proj, const void* w_hid, const void* mask,
                                const void* hid0, void* cell, void* out,
                                int B, int T, int H, void* stream) {
  return run_steps<false, false>(x_proj, w_hid, mask, hid0, cell, out, nullptr, nullptr,
                                 nullptr, B, T, H, lstm_fwd_smem_bytes(H), stream);
}

// The training forward: as lstm_fwd_forward, and also writes the residuals
// cells (B, T, H) and gates (B, T, 4H).
extern "C" int lstm_fwd_train_forward(const void* x_proj, const void* w_hid, const void* mask,
                                      const void* hid0, void* cell, void* out, void* cells,
                                      void* gates, int B, int T, int H, void* stream) {
  return run_steps<true, false>(x_proj, w_hid, mask, hid0, cell, out, cells, gates, nullptr,
                                B, T, H, lstm_fwd_smem_bytes(H), stream);
}

// The peephole recurrence: as lstm_fwd_forward, with the (H,) peephole
// vectors w_ci, w_cf and w_co.
extern "C" int lstm_fwd_peep_forward(const void* x_proj, const void* w_hid, const void* mask,
                                     const void* hid0, void* cell, void* out, const void* w_ci,
                                     const void* w_cf, const void* w_co, int B, int T, int H,
                                     void* stream) {
  const void* peep[3] = {w_ci, w_cf, w_co};
  return run_steps<false, true>(x_proj, w_hid, mask, hid0, cell, out, nullptr, nullptr, peep,
                                B, T, H, lstm_fwd_smem_bytes(H), stream);
}

// The peephole training forward: as lstm_fwd_train_forward, with the
// peephole vectors; the gates stored are those before the peephole terms.
extern "C" int lstm_fwd_peep_train_forward(const void* x_proj, const void* w_hid,
                                           const void* mask, const void* hid0, void* cell,
                                           void* out, void* cells, void* gates,
                                           const void* w_ci, const void* w_cf,
                                           const void* w_co, int B, int T, int H,
                                           void* stream) {
  const void* peep[3] = {w_ci, w_cf, w_co};
  return run_steps<true, true>(x_proj, w_hid, mask, hid0, cell, out, cells, gates, peep,
                               B, T, H, lstm_fwd_smem_bytes(H), stream);
}

extern "C" const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
