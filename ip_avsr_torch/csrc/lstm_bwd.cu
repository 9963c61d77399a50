// Reverse-time backward chain of the masked LSTM for Hopper, f32, with or
// without peepholes.
//
// Replaces the TPU kernels ip_avsr_tpu/ops/pallas/lstm_kernel.py::
// _lstm_bwd_kernel as launched by lstm_pallas_bwd_chain and
// _lstm_peep_bwd_kernel as launched by lstm_pallas_peep_bwd_chain (the same
// math as back_step in ip_avsr_tpu/ops/lstm.py::_lstm_core_bwd and
// ::_lstm_core_peep_bwd); one body serves both (template parameter
// Peephole).  Per step t, from T-1 down to 0, with the carries (dc, dh) of
// the step after it (zero at T-1):
//     dh_total = g_out[t] + dh,   dh_c = m * dh_total,   dc_c = m * dc
//     i = sigmoid(gates_pre[t].i + w_ci * c_prev), f = sigmoid(.f + w_cf * c_prev),
//     g = tanh(.c), o = sigmoid(.o + w_co * cells[t]);  tc = tanh(cells[t])
//     do = dh_c * tc * o(1-o)
//     dc_c += dh_c * o * (1 - tc^2) + do * w_co
//     di = dc_c*g*i(1-i),  df = dc_c*c_prev*f(1-f),  dg = dc_c*i(1-g^2)
//     dw_ci += di * c_prev,  dw_cf += df * c_prev,  dw_co += do * cells[t]
//     dgates[t] = clip([di, df, dg, do], +-clip)          (no clip when clip == 0)
//     dh <- dgates[t] @ W_hid^T + (1 - m) * dh_total
//     dc <- dc_c * f + di * w_ci + df * w_cf + (1 - m) * dc
// where the peephole terms are zero without peepholes.  The peephole routes
// (dc's di/df terms and the three dw sums) take the cotangents before the
// clip, as the JAX package does; only the dgates that leave the step are
// clipped.  Returns dgates (B, T, 4H), dcell0 = dc and dhid0 = dh after step
// 0 and, with peepholes, the per-row partial sums dw_c* (B, H), which the
// caller reduces over B (as lstm_pallas_peep_bwd_chain does outside its
// kernel).  dW_hid, dW_in, dx and db stay batched cuBLAS products outside the
// kernel, as the JAX package leaves them to XLA outside the Pallas kernel.
//
// Bound: like the forward, the serial chain of T steps, each of which reads
// all of W_hid (H x 4H f32, 4 MB at H = 500) and exchanges dh across the card.
// The design mirrors lstm_fwd.cu: a block owns kUnits hidden units j for
// kRowsB batch rows, so the gate backward for columns {j, H+j, 2H+j, 3H+j},
// the (dc, dh) carries and the peephole partials stay local to it.  The only
// cross-block term, the
// product dgates_{t+1} @ W_hid^T for unit j, reads row j of W_hid, which is
// contiguous, so no transposed copy is needed; it is computed at the start of
// step t's launch from the dgates_{t+1} that the previous launch wrote, so the
// launch boundary is the step barrier (one launch per step, plus one last
// launch that only finishes dhid0).  The local part (1 - m) * dh_total of the
// carry waits between launches in dh_pass.  W_hid stays in the 50 MB L2.
// Each (row, unit) element of a carry or a peephole partial is read and
// written by one thread only, so the sums need no atomics and are
// deterministic.  Shared memory is static and small (the block reduction), so
// no opt-in is needed.  A persistent kernel, wgmma and bf16 are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kUnits = 4;    // hidden units per block
constexpr int kRowsB = 8;    // batch rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = kRowsB * kUnits;  // (row, unit) pairs of a block: 32

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// One reverse step t (0 <= t < T), or with t == -1 the last launch, which only
// writes dhid0.  All sequence tensors are batch-major (B, T, .).  dcell and
// dh_pass (B, H) are the carries, zero before the first launch; each element
// is read and written by exactly one thread.  With Peephole, w_c* are the
// (H,) peephole vectors and dw_c* (B, H) the partial sums, zero before the
// first launch, owned per element like the carries; otherwise all six
// pointers are unused.
template <bool Peephole>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step_kernel(const float* __restrict__ g_out, const float* __restrict__ gates_pre,
                     const float* __restrict__ cells, const float* __restrict__ cells_prev,
                     const float* __restrict__ mask, const float* __restrict__ w_hid,
                     float* dgates, float* __restrict__ dcell, float* __restrict__ dh_pass,
                     float* __restrict__ dhid0, const float* __restrict__ w_ci,
                     const float* __restrict__ w_cf, const float* __restrict__ w_co,
                     float* __restrict__ dw_ci, float* __restrict__ dw_cf,
                     float* __restrict__ dw_co, float clip, int B, int T, int H, int t) {
  __shared__ float red[kWarps][kOut];
  __shared__ float dh_next[kOut];
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRowsB;
  const int nb = min(kRowsB, B - b0);
  const int nu = min(kUnits, H - j0);
  const int tid = threadIdx.x;
  const size_t H4 = static_cast<size_t>(4) * H;

  // gate-stage thread (gr, gu): batch row b0 + gr, hidden unit j0 + gu; its
  // inputs are fetched first so the loads overlap the product below
  const int gr = tid / kUnits;
  const int gu = tid % kUnits;
  const bool gate_live = tid < kOut && gr < nb && gu < nu;
  const size_t gb = b0 + gr;
  const size_t gj = j0 + gu;
  float gz[4] = {0.f, 0.f, 0.f, 0.f};
  float go = 0.f, c_t = 0.f, c_p = 0.f, m = 0.f, dc = 0.f, pass = 0.f;
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;  // peephole weights of unit gj
  if (gate_live) {
    pass = dh_pass[gb * H + gj];
    if (t >= 0) {
      const size_t bt = gb * T + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) gz[q] = __ldg(gates_pre + bt * H4 + static_cast<size_t>(q) * H + gj);
      go = __ldg(g_out + bt * H + gj);
      c_t = __ldg(cells + bt * H + gj);
      c_p = __ldg(cells_prev + bt * H + gj);
      m = __ldg(mask + bt);
      dc = dcell[gb * H + gj];
      if constexpr (Peephole) {
        p_i = __ldg(w_ci + gj);
        p_f = __ldg(w_cf + gj);
        p_o = __ldg(w_co + gj);
      }
    }
  }

  // dh_next[r * kUnits + u] = sum_col dgates_{t+1}[b0 + r, col] * W_hid[j0 + u, col]:
  // each thread sums a strided slice of the 4H columns (coalesced across the
  // warp for both operands), then the block reduces the 32 sums
  const bool has_next = t + 1 < T;
  if (has_next) {
    float acc[kRowsB][kUnits];
#pragma unroll
    for (int r = 0; r < kRowsB; ++r)
#pragma unroll
      for (int u = 0; u < kUnits; ++u) acc[r][u] = 0.f;
    const float* dg = dgates + static_cast<size_t>(t + 1) * H4;
    const size_t row_stride = static_cast<size_t>(T) * H4;
#pragma unroll 2
    for (size_t col = tid; col < H4; col += kThreads) {
      float w[kUnits];
#pragma unroll
      for (int u = 0; u < kUnits; ++u) w[u] = u < nu ? __ldg(w_hid + (j0 + u) * H4 + col) : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        const float d = r < nb ? dg[(b0 + r) * row_stride + col] : 0.f;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) acc[r][u] = fmaf(d, w[u], acc[r][u]);
      }
    }
    const int lane = tid % 32;
    const int warp = tid / 32;
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        float v = acc[r][u];
#pragma unroll
        for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][r * kUnits + u] = v;
      }
    }
    __syncthreads();
    if (tid < kOut) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][tid];
      dh_next[tid] = s;
    }
    __syncthreads();
  }

  if (!gate_live) return;
  const float dh = (has_next ? dh_next[tid] : 0.f) + pass;
  if (t < 0) {
    dhid0[gb * H + gj] = dh;
    return;
  }
  const float dh_total = go + dh;
  const float dh_c = m * dh_total;
  float dc_c = m * dc;
  float z_i = gz[0], z_f = gz[1], z_o = gz[3];
  if constexpr (Peephole) {
    // o from the post-mask cell, as the JAX backward recomputes it
    z_i += c_p * p_i;
    z_f += c_p * p_f;
    z_o += c_t * p_o;
  }
  const float i = sigm(z_i);
  const float f = sigm(z_f);
  const float g = tanhf(gz[2]);
  const float o = sigm(z_o);
  const float tc = tanhf(c_t);
  const float d_o = dh_c * tc;
  const float do_pre = d_o * o * (1.0f - o);
  dc_c = dc_c + dh_c * o * (1.0f - tc * tc);
  if constexpr (Peephole) dc_c += do_pre * p_o;
  float dgate[4] = {dc_c * g * i * (1.0f - i), dc_c * c_p * f * (1.0f - f),
                    dc_c * i * (1.0f - g * g), do_pre};
  float dc_prev = dc_c * f + (1.0f - m) * dc;
  if constexpr (Peephole) {
    // the peephole routes take the cotangents before the clip
    dc_prev += dgate[0] * p_i + dgate[1] * p_f;
    const size_t e = gb * H + gj;
    dw_ci[e] += dgate[0] * c_p;
    dw_cf[e] += dgate[1] * c_p;
    dw_co[e] += do_pre * c_t;
  }
  if (clip != 0.f) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dgate[q] = fminf(fmaxf(dgate[q], -clip), clip);
  }
  float* dp = dgates + (gb * T + t) * H4 + gj;
#pragma unroll
  for (int q = 0; q < 4; ++q) dp[static_cast<size_t>(q) * H] = dgate[q];
  dcell[gb * H + gj] = dc_prev;
  dh_pass[gb * H + gj] = (1.0f - m) * dh_total;
}

// Runs the whole chain of one instantiation on `stream`; see the entry
// points.  `peep` holds w_ci, w_cf, w_co, dw_ci, dw_cf, dw_co or is null.
template <bool Peephole>
int run_chain(const void* g_out, const void* gates_pre, const void* cells,
              const void* cells_prev, const void* mask, const void* w_hid, void* dgates,
              void* dcell, void* dh_pass, void* dhid0, void* const* peep, float clip,
              int B, int T, int H, void* stream) {
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRowsB - 1) / kRowsB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pv[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if constexpr (Peephole) {
    for (int k = 0; k < 6; ++k) pv[k] = static_cast<float*>(peep[k]);
  }
  for (int t = T - 1; t >= -1; --t) {
    lstm_bwd_step_kernel<Peephole><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g_out), static_cast<const float*>(gates_pre),
        static_cast<const float*>(cells), static_cast<const float*>(cells_prev),
        static_cast<const float*>(mask), static_cast<const float*>(w_hid),
        static_cast<float*>(dgates), static_cast<float*>(dcell), static_cast<float*>(dh_pass),
        static_cast<float*>(dhid0), pv[0], pv[1], pv[2], pv[3], pv[4], pv[5], clip, B, T, H,
        t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Runs the whole chain on `stream`: T reverse steps and the last launch.
// dcell and dh_pass (B, H) must be zero on entry; dcell holds dcell0 on
// return.  Writes dgates (B, T, 4H) and dhid0 (B, H).  Returns the first
// CUDA error (0 on success).
extern "C" int lstm_bwd_chain(const void* g_out, const void* gates_pre, const void* cells,
                              const void* cells_prev, const void* mask, const void* w_hid,
                              void* dgates, void* dcell, void* dh_pass, void* dhid0,
                              float clip, int B, int T, int H, void* stream) {
  return run_chain<false>(g_out, gates_pre, cells, cells_prev, mask, w_hid, dgates, dcell,
                          dh_pass, dhid0, nullptr, clip, B, T, H, stream);
}

// The peephole chain: as lstm_bwd_chain, with the (H,) peephole vectors
// w_ci, w_cf, w_co, and the (B, H) partial sums dw_ci, dw_cf, dw_co of their
// gradients, which must be zero on entry.
extern "C" int lstm_bwd_peep_chain(const void* g_out, const void* gates_pre, const void* cells,
                                   const void* cells_prev, const void* mask,
                                   const void* w_hid, const void* w_ci, const void* w_cf,
                                   const void* w_co, void* dgates, void* dcell, void* dh_pass,
                                   void* dhid0, void* dw_ci, void* dw_cf, void* dw_co,
                                   float clip, int B, int T, int H, void* stream) {
  void* peep[6] = {const_cast<void*>(w_ci), const_cast<void*>(w_cf), const_cast<void*>(w_co),
                   dw_ci, dw_cf, dw_co};
  return run_chain<true>(g_out, gates_pre, cells, cells_prev, mask, w_hid, dgates, dcell,
                         dh_pass, dhid0, peep, clip, B, T, H, stream);
}

extern "C" const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
