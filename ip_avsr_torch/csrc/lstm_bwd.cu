// Reverse-time backward chain of the masked LSTM for Hopper, with or without
// peepholes, with W_hid in float32 or bf16: one persistent cooperative launch
// per call.
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
// 0 and, with peepholes, the three (H,) gradients dw_c*, reduced over B in
// the kernel.  dW_hid, dW_in, dx and db stay batched cuBLAS products outside
// the kernel, as the JAX package leaves them to XLA outside the Pallas kernel.
//
// Bound: the serial chain of T steps.  The arithmetic of a whole call is a
// few microseconds of the card's f32 rate; what a step costs is the
// exchange: every hidden unit's dh needs all 4H columns of dgates_{t+1} of
// every row, so each step ends in a grid-wide barrier and the next one
// starts with an L2 read of B x 4H floats (80 KB at B = 10, H = 500) by
// every block.  The design keeps everything else on-chip for the whole
// chain:
// - One launch per call.  lstm_bwd_chain_kernel loops over t itself and is
//   launched with cudaLaunchCooperativeKernel, so its grid.sync() is the step
//   barrier (T barriers: one after each step's dgates store).  The
//   cooperative launch refuses a grid that cannot be co-resident
//   (cudaErrorCooperativeLaunchTooLarge) rather than hang in the barrier.
// - A block owns U hidden units j0..j0+U-1 for all B rows, for the whole
//   chain: gate columns {j, H+j, 2H+j, 3H+j}.  The grid is ceil(H / U) blocks,
//   U the smallest of 1, 2, 4, 8 whose grid fits the card's SMs (the Python
//   launch plan, ops/kernels/lstm.py::bwd_launch_plan, picks it).
// - W_hid resident in shared memory.  The block loads its U rows W_hid[j0 :
//   j0 + U, :] (U x 4H f32: 32,000 B at H = 500, U = 4) once, and the
//   product dh_next[b, j] = sum_col dgates[b, t+1, col] * W_hid[j, col] reads
//   only dgates from global memory.
// - The carries dc and (1 - m) * dh_total and, with peepholes, the three
//   per-(row, unit) partial sums live in shared memory for the whole chain;
//   each element is read and written by one thread only (pair q = b * U + u
//   belongs to thread q mod kThreads), so the sums need no atomics.  At the
//   end each block writes dcell0, dhid0 and its units' three dw, each summed
//   over b = 0 .. B-1 in that order: deterministic, and no launch outside.
//   The plain version sums the rows with torch's sum, in another order: the
//   card holds the two within 1e-5 of each output's max abs.
// Shared memory (dynamic): W_hid rows U x 4H, then dh_next, dc, pass and
// the three dw partials, B x U each, then the block reduction kWarps x
// kPairs; 16UH + 24BU + 1024 bytes in all for f32, so one launch holds up to
// 2077 rows at H = 500 (bf16: below, 1022).  Rows are independent: a
// larger batch runs as several launches over near-equal row chunks, each a
// pointer offset into the batch-major tensors, and the chunks' (3, H)
// peephole gradients are added in chunk order (ops/kernels/lstm.py).
//
// bf16 W_hid (matmul_dtype="bfloat16"): every instantiation also exists with
// W of storage type __nv_bfloat16 (template parameter WT), as
// _lstm_bwd_kernel is generic over W_hid's dtype: dh <- bf16(dgates[t]) @
// W_hid^T with f32 accumulation, as jnp.dot(dgates.astype(bf16), w_hid_t,
// preferred_element_type=f32) computes it (lstm_kernel.py:227-230).  The
// product runs on Hopper's tensor cores (product_mma below): warp-level
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 through inline PTX,
// dh_next (B x U) = bf16(dgates_{t+1}) (B x 4H) . W_blk (4H x U), the rows on
// M in tiles of 16, the U units on N (one n8 tile; the lanes of units past U
// pass zeros), K = 4H in KQ = ceil(4H / 16) steps (125 at H = 500; the last
// one zero-padded at H = 250 and 130).  A block's product costs the same at
// 2 to 8 units, so the launch plan gives a bf16 W 8 units per block, which
// fill the tile, and half or a quarter of the f32 plan's blocks
// (ops/kernels/lstm.py::bwd_launch_plan; 63 blocks at H = 500).  Only the product differs from the
// f32 instantiations, whose code is untouched (if constexpr (sizeof(WT) ==
// 2) below):
// - The k of a step in a permuted order, the same for both operands: the
//   fragment's k 2 (lane % 4) + 8 r + {0, 1} is column c = 16 s + 4 (lane
//   % 4) + 2 r + {0, 1} of dgates, so that a lane's four A values of a row
//   are neighbours in memory (as in lstm_fwd.cu).
// - W in shared memory as bf16 in fragment order, once per call: 32-bit word
//   (s * 4U + lane) * 2 + r holds W_hid[j0 + lane / 4, c] and W_hid[j0 +
//   lane / 4, c + 1] (low half first), c = 16 s + 4 (lane % 4) + 2 r, the B
//   fragment register r of lane `lane` (< 4U) at k step s: one 8-byte read
//   per lane and k step, neighbouring lanes on neighbouring words, no bank
//   conflict.  32 U bytes per k step: 32,000 B at H = 500, U = 8.
// - The operand, rounded once: the gate stage also writes each clipped
//   dgate rounded to nearest even (__float2bfloat16_rn, as the plain version
//   rounds it) into dg16 (2, B, 4H) bf16 in global memory, slot t % 2 at
//   step t (the wrapper's scratch), and the next step's product reads that
//   slot: every value is rounded once, by the block that owns it, not once
//   by each of the blocks that read it (125 at H = 500), and the reads are
//   half the bytes.  Two slots, because step t reads slot (t + 1) % 2 while it
//   writes slot t % 2, and the grid.sync() between steps orders both
//   ([stale]: dg16 is written and read in the launch, read with __ldcg).
//   The stored dgates, the carries, the gate math and every output stay
//   f32.  All-zero dgates (a pass-through step, ops/lstm.py::_chain_inputs)
//   round to zeros and give exactly 0.
// - The A fragment: rows b0 + lane / 4 and + 8, columns 16 s + 4 (lane %
//   4) .. + 3 of dg16's slot, one 8-byte __ldcg per row (four bf16 values,
//   two fragment registers; a row of 4H values is 8-byte aligned); each
//   product exact, each k step's products summed into a zero accumulator
//   and added in f32 (mma_bf16, as in lstm_fwd.cu), a batch's products in
//   one straight run without a branch between them.
// - Tiles of 16 rows in rounds of up to kWarps; the warps split the round's
//   tiles and the KQ k steps (warp -> tile warp % G, k steps ks, ks + ns,
//   ...: 15-16 each at B <= 16, H = 500), store their 16 x U partial tiles
//   in shared memory, and the tile's partials are added in warp order
//   (unrolled), as product adds its warps' sums: the result does not depend
//   on the schedule.  The operands of kMmaBatch k steps, all of a warp's at
//   B <= 16 and H = 500, are requested before any of their products.
//   Shared memory: 32 U KQ bytes of W, the carries, then the partial tiles
//   8 x 16 x U floats; one launch holds up to 1022 rows at H = 500, U = 8.
// [bf16 uniform] mma.sync is warp-wide: every lane of a warp runs the same k
//   steps (warp-uniform trip counts, masked operands are zeros), and every
//   thread reaches the round's two __syncthreads.
//
// Where trouble is likely, and what the code does about it (marked below):
// [stale] dgates is written and read inside this launch, so it is never read
//   through the read-only path (__ldg or a const __restrict__ pointer, which
//   may return stale lines) nor through L1, which is not coherent across
//   SMs: the product reads it with __ldcg (L2 only).  g_out, gates_pre,
//   cells, cells_prev, mask, W_hid and the peephole vectors are read-only
//   for the whole launch, so __ldg is right for them.
// [order] grid.sync() fences before it arrives, so every block's dgates[:, t]
//   stores are visible to every block after it.
// [ragged] H need not be a multiple of U (H = 250 with U = 4, H = 130): the
//   last block's dead units get zero W_hid rows and are skipped by the gate
//   stage, the stores and the peephole loads and sums.
// [uniform] every thread of every block reaches each grid.sync() the same
//   number of times (T): no thread leaves early.
// [converge] the warp shuffles of the product's reduction follow a column
//   loop whose trip count is the same for every lane.
//
// Large B, float32 W_hid (tiled_chain, the kernel's explicit specializations
// at U = kTiledUnits = 16; the wrapper takes it at the batches and widths
// ops/kernels/lstm.py::bwd_plan names).  In the small-B body every block
// reads all B rows of dgates_{t+1} each step: B x 4H f32, 2.05 MB at B = 256,
// H = 500, by each of 125 blocks, about 256 MB of L2 reads a step.  The
// large-B body does the same f32 FMAs on the CUDA cores (no TF32: the
// configurations state f32) in a layout that reads a quarter of that:
// - Blocks split by rows as well as units: ceil(H / 16) unit groups on x by
//   row groups of 64 rows on y (gridDim.y, passed by the wrapper; a launch
//   takes as many as fit beside the unit groups on the card's SMs, a larger
//   batch runs in row chunks: ops/kernels/lstm.py::bwd_tiled_plan).  A block
//   owns all four gate columns of its 16 units, so the gate math and the
//   carries stay local, and reads only its row group's rows of dgates_{t+1}:
//   64 MB of L2 a step at B = 256, H = 500.  Still one grid.sync() a step.
// - W resident, k-major: the block's 16 rows of W_hid as 4H (padded to
//   whole chunks, zero rows) k rows of 16 floats, 128 KB at H = 500, loaded
//   once per call.
// - dgates_{t+1} staged through shared memory: the row group's rows in
//   chunks of kTiledK = 128 values of k, each row padded to 132 floats, two
//   buffers, chunk c + 1's loads issued before chunk c is multiplied.
//   [stale] the loads are float4 __ldcg into registers (L2 only; a row of 4H
//   floats is 16-byte aligned), then stored to shared memory.  Each unit
//   group starts at its own chunk (blockIdx.x modulo the chunks) and takes
//   the others in turn, so that the blocks of a row group do not all read
//   the same lines at once.  (Measured slower on an H100: a three-stage
//   cp.async.cg pipeline, 4%, and 1-D bulk copies (TMA), one a row, 2.1x.)
// - A register-tiled product: thread (kq, tu, tr) holds an 8 x 8 tile of
//   sums, rows tr + 8 i by units 8 tu .. + 7, over slice kq of every chunk
//   (16 slices of 8 k).  Per 4 k it reads 8 float4 of dgates (a quarter warp:
//   8 neighbouring rows, 528 bytes apart, in 8 distinct bank groups) and 8
//   float4 of W (a quarter warp: one address) for 256 FMAs, one byte of
//   shared memory a FMA, which is the SM's rate for both (4 x 4 and 8 x 4
//   tiles, 0.5 and 0.375 a FMA, measured 11% and 6% slower).  The slices'
//   partial sums meet in shared memory, over the chunk buffers, and are
//   added in slice order; within a slice k runs in the block's fixed chunk
//   order, so two calls give the same bits.
// - The gate stage: thread tid owns rows tid / 16 + 16 i (i < 4) of unit
//   tid % 16, its carries (dc, the pass-through and the three dw sums) in
//   registers for the whole call, with the small-B body's math.  The
//   peephole dw: at step 0 each block sums its rows' partials in row order
//   into a (row groups, 3, H) buffer (the wrapper's scratch), and after the
//   last grid.sync() the blocks of row group 0 add the row groups' sums in
//   row-group order into dw: no atomics, the same bits every call.
// Bound of a step: a block's 64 x 16 sums over K = 4H are 2.05 M FMAs at
// H = 500, 16k clocks of an SM's 128 FMAs a clock (and as many of shared
// memory), at B = 256 on 128 of the card's 132 SMs; and 512 KB of L2 reads
// a block.  Shared memory (dynamic): W ceil(4H / 128) * 128 rows of 16
// floats, two chunks of 64 rows x 132 floats: 198,656 B at H = 500, 133,120
// at H = 250 (ops/kernels/lstm.py::bwd_tiled_smem_bytes); H up to 640.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// (row, unit) pairs of one product tile: 32 / U rows by U units, one
// accumulator each per thread, reduced across a warp in 31 shuffles
constexpr int kPairs = 32;

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// The bf16 product on the tensor cores (header): kTile rows of an m16n8k16
// tile, k steps of 16 over the 4H columns, and the floats of the warps'
// partial tiles (16 x U each).
constexpr int kTile = 16;
__host__ __device__ constexpr int mma_ksteps(int H) { return (4 * H + kTile - 1) / kTile; }
__host__ __device__ constexpr int mma_red_floats(int U) { return kWarps * kTile * U; }
// k steps whose operands a warp loads before their products: all of a warp's
// at B <= 16 for the widths the launch plan gives U (H <= 528 at U = 4:
// 16; H <= 264 at U = 2: 8)
__host__ __device__ constexpr int mma_batch(int U) { return U >= 4 ? 16 : 8; }

// acc += a b for one k step on the tensor cores: a 16 x 16 bf16 A
// (row-major fragment a), a 16 x 8 bf16 B (column-major fragment b0, b1),
// f32 sums (PTX ISA, mma.sync m16n8k16 fragment layouts).  The tensor core
// sums the step's 16 exact products into a zero accumulator, and the step's
// sum is added to acc in f32, rounded to nearest, so the k steps are not
// summed inside the tensor core and their products need not wait on each
// other.
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const unsigned int (&a)[4],
                                         unsigned int b0, unsigned int b1) {
  float d[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

// One level of the warp's transposing reduction: of the 2 * O values a lane
// holds, it keeps the half its lane bit O selects and adds its partner's copy
// of the same half.  After levels 16, 8, 4, 2 and 1, v[0] of lane L is the
// warp's sum of value L.
template <int O>
__device__ __forceinline__ void transpose_level(float (&v)[kPairs], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? v[k] : v[k + O];
    const float keep = upper ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// dh_next[b * U + u] = sum_col dg[b * row_stride + col] * w_s[u * 4H + col] for
// every row b < B and unit u < U, from the dgates of one step (dg points at
// dgates[0, t + 1, 0]) and the block's W_hid rows in shared memory.  Rows go
// in tiles of R = 32 / U, columns as float4 in passes of kRounds * kThreads;
// a thread sums the columns tid + k * kThreads of a pass for the R rows, a
// warp reduces its 32 sums in 31 shuffles, and kWarps partial sums per pair
// meet in shared memory.  A step is a chain of L2 round trips, so the loads
// are batched: every load of a (tile, pass) chunk is issued before any of
// its products (16 float4 per thread at U >= 2), and the next chunk's loads
// go out before this tile's reduction, so they overlap it.  Ends with a
// __syncthreads, so dh_next is visible to the whole block.  f32 W only
// (product_mma is the bf16 product).
template <int U>
__device__ void product(const float* dg, size_t row_stride, const float* w_s, float* dh_next,
                        float* red, int B, int H) {
  constexpr int R = kPairs / U;
  constexpr int kRounds = U >= 2 ? U / 2 : 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // [converge] the chunk loop's trip count is the same for every thread and
  // the ragged edges are masked inside: a loop whose trip count differed
  // between the lanes of a warp, followed by the shuffles below, gave wrong
  // and run-to-run varying sums on the card whenever H % 256 split a warp
  const int passes = (H + kRounds * kThreads - 1) / (kRounds * kThreads);
  const int chunks = (B + R - 1) / R * passes;
  float4 d[kRounds][R];
  const auto load = [&](int i) {
    const int b0 = i / passes * R;
    const int cb = i % passes * kRounds * kThreads;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int c = cb + k * kThreads + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // [stale] dgates of this launch: L2 only, never __ldg or L1
        d[k][r] = c < H && b0 + r < B
                      ? __ldcg(reinterpret_cast<const float4*>(dg + (b0 + r) * row_stride) + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  float acc[kPairs];
  load(0);
  for (int i = 0; i < chunks; ++i) {
    const int pass = i % passes;
    if (pass == 0) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int c = pass * kRounds * kThreads + k * kThreads + tid;
      float4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        w[u] = c < H ? reinterpret_cast<const float4*>(w_s + static_cast<size_t>(u) * 4 * H)[c]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float a = acc[r * U + u];
          a = fmaf(d[k][r].x, w[u].x, a);
          a = fmaf(d[k][r].y, w[u].y, a);
          a = fmaf(d[k][r].z, w[u].z, a);
          acc[r * U + u] = fmaf(d[k][r].w, w[u].w, a);
        }
      }
    }
    if (i + 1 < chunks) load(i + 1);
    if (pass < passes - 1) continue;
    const int b0 = i / passes * R;
    transpose_level<16>(acc, lane);
    transpose_level<8>(acc, lane);
    transpose_level<4>(acc, lane);
    transpose_level<2>(acc, lane);
    transpose_level<1>(acc, lane);
    red[warp * kPairs + lane] = acc[0];
    __syncthreads();
    if (tid < kPairs && b0 + tid / U < B) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kPairs + tid];
      dh_next[b0 * U + tid] = s;
    }
    __syncthreads();
  }
}

// product's bf16 twin on the tensor cores (header): the same dh_next from
// the clipped dgates of one step already rounded to bf16 (dg16, rows of 4H
// bf16 values) and the block's W_hid rows in fragment order (w_w).  Ends
// with a __syncthreads, so dh_next is visible to the whole block.
template <int U>
__device__ void product_mma(const unsigned short* dg16, const unsigned int* w_w, float* dh_next,
                            float* red, int B, int H) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int H4 = 4 * H;
  const int KQ = mma_ksteps(H);
  const int n_tiles = (B + kTile - 1) / kTile;
  for (int tile0 = 0; tile0 < n_tiles; tile0 += kWarps) {
    // warp -> tile g of the round and k steps ks, ks + ns, ...
    const int G = min(kWarps, n_tiles - tile0);
    const int g = warp % G;
    const int ks = warp / G;
    const int ns = (kWarps - 1 - g) / G + 1;
    const int ra = (tile0 + g) * kTile + lane / 4;
    const bool la = ra < B;
    const bool lb = ra + 8 < B;
    const unsigned short* da = dg16 + static_cast<size_t>(la ? ra : 0) * H4;
    const unsigned short* db = dg16 + static_cast<size_t>(lb ? ra + 8 : 0) * H4;
    // [bf16 uniform] the same k steps for every lane of the warp
    const int steps = (KQ - ks + ns - 1) / ns;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    constexpr int kMmaBatch = mma_batch(U);
    for (int s0 = 0; s0 < steps; s0 += kMmaBatch) {
      // every operand of the batch is requested before any product: the
      // lane's c = 16 s + 4 (lane % 4) .. + 3 of rows ra and ra + 8, four
      // bf16 values (two fragment registers) each, one 8-byte read (a row is
      // 4H values, 8-byte aligned; 4H is a multiple of 4, so a quad never
      // crosses a row's end)
      uint2 d[kMmaBatch][2];
#pragma unroll
      for (int i = 0; i < kMmaBatch; ++i) {
        const int c = (ks + (s0 + i) * ns) * kTile + (lane % 4) * 4;
        const bool live = s0 + i < steps && c < H4;
        const uint2 zero = make_uint2(0u, 0u);
        // [stale] written in this launch: L2 only, never __ldg or L1
        d[i][0] = live && la ? __ldcg(reinterpret_cast<const uint2*>(da + c)) : zero;
        d[i][1] = live && lb ? __ldcg(reinterpret_cast<const uint2*>(db + c)) : zero;
      }
      // the batch's products in one straight run: a slot past the warp's
      // steps has zero operands (its loads are masked) and a live W word, so
      // it adds exactly 0, where a branch per slot kept each step's shared
      // memory read, product and sums from overlapping the next step's
#pragma unroll
      for (int i = 0; i < kMmaBatch; ++i) {
        const int s = min(ks + (s0 + i) * ns, KQ - 1);
        // the A fragment: registers 0 and 2 of row ra, 1 and 3 of row ra + 8
        const unsigned int a[4] = {d[i][0].x, d[i][1].x, d[i][0].y, d[i][1].y};
        const uint2 b = lane < 4 * U
                            ? reinterpret_cast<const uint2*>(w_w)[static_cast<size_t>(s) * 4 * U +
                                                                  lane]
                            : make_uint2(0u, 0u);
        mma_bf16(acc, a, b.x, b.y);
      }
    }
    // the accumulator fragment: rows lane / 4 and lane / 4 + 8, units
    // 2 (lane % 4) + {0, 1}; units past U are not stored
    float* rw = red + warp * kTile * U + (lane / 4) * U;
    const int u = (lane % 4) * 2;
    if (u < U) {
      rw[u] = acc[0];
      rw[8 * U + u] = acc[2];
    }
    if (u + 1 < U) {
      rw[u + 1] = acc[1];
      rw[8 * U + u + 1] = acc[3];
    }
    __syncthreads();
    // pair q of the round: tile gt, row (q % 16U) / U of it, unit q % U;
    // the partial tiles of the warps on tile gt added in warp order
    for (int q = tid; q < G * kTile * U; q += kThreads) {
      const int gt = q / (kTile * U);
      const int pr = q % (kTile * U);
      if ((tile0 + gt) * kTile + pr / U >= B) continue;
      const int nsg = (kWarps - 1 - gt) / G + 1;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < kWarps; ++p) {
        if (p < nsg) sum += red[(p * G + gt) * kTile * U + pr];
      }
      dh_next[(tile0 + gt) * kTile * U + pr] = sum;
    }
    __syncthreads();
  }
}

// dh_next from the dgates of step t: product (f32 W, the f32 dgates dg of
// step t, row stride row_stride) or product_mma (bf16 W, their bf16 copy in
// slot t % 2 of dg16), W at the start of shared memory (smem).
template <int U, typename WT>
__device__ __forceinline__ void run_product(const float* dg, size_t row_stride,
                                            const unsigned short* dg16, int t,
                                            const float4* smem, float* dh_next, float* red,
                                            int B, int H) {
  if constexpr (sizeof(WT) == 2) {
    product_mma<U>(dg16 + static_cast<size_t>(t % 2) * B * 4 * H,
                   reinterpret_cast<const unsigned int*>(smem), dh_next, red, B, H);
  } else {
    product<U>(dg, row_stride, reinterpret_cast<const float*>(smem), dh_next, red, B, H);
  }
}

// The gate stage's read-only inputs of pair q = b * U + u at step t.
struct GateIn {
  float z[4] = {0.f, 0.f, 0.f, 0.f};
  float go = 0.f, c_t = 0.f, c_p = 0.f, m = 0.f;
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;  // peephole weights of unit j
};

template <bool Peephole>
__device__ __forceinline__ GateIn load_gate(const float* __restrict__ g_out,
                                            const float* __restrict__ gates_pre,
                                            const float* __restrict__ cells,
                                            const float* __restrict__ cells_prev,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ w_ci,
                                            const float* __restrict__ w_cf,
                                            const float* __restrict__ w_co, int b, int j,
                                            int T, int H, int t) {
  GateIn in;
  const size_t bt = static_cast<size_t>(b) * T + t;
  const size_t H4 = static_cast<size_t>(4) * H;
#pragma unroll
  for (int q = 0; q < 4; ++q) in.z[q] = __ldg(gates_pre + bt * H4 + static_cast<size_t>(q) * H + j);
  in.go = __ldg(g_out + bt * H + j);
  in.c_t = __ldg(cells + bt * H + j);
  in.c_p = __ldg(cells_prev + bt * H + j);
  in.m = __ldg(mask + bt);
  if constexpr (Peephole) {
    in.p_i = __ldg(w_ci + j);
    in.p_f = __ldg(w_cf + j);
    in.p_o = __ldg(w_co + j);
  }
  return in;
}

// The whole chain.  All sequence tensors are batch-major (B, T, .).  dw is
// (3, H) (dw_ci, dw_cf, dw_co) with Peephole; without it the peephole
// pointers and dw are unused.  Shared memory as in the header.  w_hid holds
// WT values (float or __nv_bfloat16).  With a bf16 W, dg16 (2, B, 4H) bf16
// holds the product's operand, the clipped dgates of step t in slot t % 2
// (header); unused in f32.
template <bool Peephole, int U, typename WT>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_chain_kernel(const float* __restrict__ g_out, const float* __restrict__ gates_pre,
                      const float* __restrict__ cells, const float* __restrict__ cells_prev,
                      const float* __restrict__ mask, const WT* __restrict__ w_hid,
                      const float* __restrict__ w_ci, const float* __restrict__ w_cf,
                      const float* __restrict__ w_co,
                      float* dgates,  // [stale] written and read here: not const, not restrict
                      float* __restrict__ dcell0, float* __restrict__ dhid0,
                      float* __restrict__ dw, float clip, int B, int T, int H,
                      unsigned short* dg16) {  // [stale] as dgates
  constexpr bool kMma = sizeof(WT) == 2;  // bf16: the product on the tensor cores
  extern __shared__ float4 smem4[];
  const size_t H4 = static_cast<size_t>(4) * H;
  const int BU = B * U;
  // W: f32 (U, 4H); bf16 in fragment order, KQ k steps of 4U word pairs
  float* dh_next;  // (B * U) each, from here on
  if constexpr (kMma) {
    dh_next = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                       static_cast<size_t>(32) * U * mma_ksteps(H));
  } else {
    dh_next = reinterpret_cast<float*>(smem4) + U * H4;
  }
  float* dc_s = dh_next + BU;
  float* pass_s = dc_s + BU;
  float* dw_s = pass_s + BU;                     // (3, B * U)
  float* red = dw_s + 3 * BU;                    // f32 (kWarps, kPairs); bf16 (kWarps, kTile, U)
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  const size_t row_stride = static_cast<size_t>(T) * H4;

  if constexpr (kMma) {
    // word (s * 4U + l) * 2 + r = W_hid[j0 + l / 4, c .. c + 1] for c = 16 s
    // + 4 (l % 4) + 2 r, once per call: one 4-byte read of two bf16 values
    // (c is even, and so is 4H).  [ragged] dead units and c past 4H are 0.
    unsigned int* w_w = reinterpret_cast<unsigned int*>(smem4);
    const int n_words = mma_ksteps(H) * 8 * U;
    for (int i = tid; i < n_words; i += kThreads) {
      const int l = i / 2 % (4 * U);
      const int c = i / (8 * U) * kTile + (l % 4) * 4 + (i % 2) * 2;
      w_w[i] = l / 4 < nu && c < static_cast<int>(H4)
                   ? __ldg(reinterpret_cast<const unsigned int*>(w_hid + (j0 + l / 4) * H4 + c))
                   : 0u;
    }
  } else {
    // W_hid[j0 : j0 + U, :] is contiguous: one coalesced pass, once per call.
    // [ragged] dead units' rows are zero.
    float* w_s = reinterpret_cast<float*>(smem4);  // (U, 4H)
    for (size_t i = tid; i < U * H4; i += kThreads) {
      const bool live = static_cast<int>(i / H4) < nu;
      w_s[i] = live ? __ldg(w_hid + j0 * H4 + i) : 0.f;
    }
  }
  for (int i = tid; i < 5 * BU; i += kThreads) dc_s[i] = 0.f;  // dc, pass, dw
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    const bool has_next = t + 1 < T;
    // the gate inputs of the thread's first pair are fetched before the
    // product, so their loads overlap it
    GateIn first;
    if (tid < BU && tid % U < nu)
      first = load_gate<Peephole>(g_out, gates_pre, cells, cells_prev, mask, w_ci, w_cf, w_co,
                                  tid / U, j0 + tid % U, T, H, t);
    if (has_next) {
      run_product<U, WT>(dgates + (t + 1) * H4, row_stride, dg16, t + 1, smem4, dh_next, red,
                         B, H);
    }

    for (int q = tid; q < BU; q += kThreads) {
      const int b = q / U;
      const int u = q % U;
      if (u >= nu) continue;  // [ragged]
      const int j = j0 + u;
      const GateIn in = q == tid ? first
                                 : load_gate<Peephole>(g_out, gates_pre, cells, cells_prev,
                                                       mask, w_ci, w_cf, w_co, b, j, T, H, t);
      const float dh = (has_next ? dh_next[q] : 0.f) + pass_s[q];
      const float dc = dc_s[q];
      const float m = in.m;
      const float dh_total = in.go + dh;
      const float dh_c = m * dh_total;
      float dc_c = m * dc;
      float z_i = in.z[0], z_f = in.z[1], z_o = in.z[3];
      if constexpr (Peephole) {
        // o from the post-mask cell, as the JAX backward recomputes it
        z_i += in.c_p * in.p_i;
        z_f += in.c_p * in.p_f;
        z_o += in.c_t * in.p_o;
      }
      const float i = sigm(z_i);
      const float f = sigm(z_f);
      const float g = tanhf(in.z[2]);
      const float o = sigm(z_o);
      const float tc = tanhf(in.c_t);
      const float do_pre = dh_c * tc * o * (1.0f - o);
      dc_c = dc_c + dh_c * o * (1.0f - tc * tc);
      if constexpr (Peephole) dc_c += do_pre * in.p_o;
      float dgate[4] = {dc_c * g * i * (1.0f - i), dc_c * in.c_p * f * (1.0f - f),
                        dc_c * i * (1.0f - g * g), do_pre};
      float dc_prev = dc_c * f + (1.0f - m) * dc;
      if constexpr (Peephole) {
        // the peephole routes take the cotangents before the clip
        dc_prev += dgate[0] * in.p_i + dgate[1] * in.p_f;
        dw_s[q] += dgate[0] * in.c_p;
        dw_s[BU + q] += dgate[1] * in.c_p;
        dw_s[2 * BU + q] += do_pre * in.c_t;
      }
      if (clip != 0.f) {
#pragma unroll
        for (int k = 0; k < 4; ++k) dgate[k] = fminf(fmaxf(dgate[k], -clip), clip);
      }
      float* dp = dgates + (static_cast<size_t>(b) * T + t) * H4 + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) dp[static_cast<size_t>(k) * H] = dgate[k];
      if constexpr (kMma) {
        // the product's operand, rounded to nearest even once here rather
        // than by each of the blocks that read it
        __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(dg16) +
                            (static_cast<size_t>(t % 2) * B + b) * H4 + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) op[static_cast<size_t>(k) * H] = __float2bfloat16_rn(dgate[k]);
      }
      dc_s[q] = dc_prev;
      pass_s[q] = (1.0f - m) * dh_total;
    }
    // [order] [uniform] every block's dgates[:, t] before any block's product
    grid.sync();
  }

  // dh after step 0: one more product, then the block's outputs
  run_product<U, WT>(dgates, row_stride, dg16, 0, smem4, dh_next, red, B, H);
  for (int q = tid; q < BU; q += kThreads) {
    const int u = q % U;
    if (u >= nu) continue;
    const size_t e = static_cast<size_t>(q / U) * H + j0 + u;
    dhid0[e] = dh_next[q] + pass_s[q];
    dcell0[e] = dc_s[q];
  }
  if constexpr (Peephole) {
    // dw[k, j] = sum over b = 0 .. B-1 in order (product's __syncthreads
    // made every thread's partial sums visible)
    for (int i = tid; i < 3 * U; i += kThreads) {
      const int k = i / U;
      const int u = i % U;
      if (u >= nu) continue;
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += dw_s[k * BU + b * U + u];
      dw[static_cast<size_t>(k) * H + j0 + u] = s;
    }
  }
}

// The large-B body (header): float32 W_hid, kTiledUnits units by kTiledRows
// rows a block.  For the product, thread (kq, tu, tr) sums rows tr +
// kTiledRT i (i < kTiledTR) by units kTiledTU tu .. + kTiledTU - 1 over
// slice kq of every staged chunk of kTiledK values of k (kTiledSplit
// slices); for the gate stage, thread tid owns rows tid / 16 + 16 i (i <
// kTiledPairs) of unit tid % 16.
constexpr int kTiledUnits = 16;
constexpr int kTiledRows = 64;
constexpr int kTiledK = 128;
constexpr int kTiledKPad = kTiledK + 4;
constexpr int kTiledTR = 8;
constexpr int kTiledTU = 8;
constexpr int kTiledRT = kTiledRows / kTiledTR;   // row tiles
constexpr int kTiledUT = kTiledUnits / kTiledTU;  // unit tiles
constexpr int kTiledSplit = kThreads / (kTiledRT * kTiledUT);
constexpr int kTiledSlice = kTiledK / kTiledSplit;  // k of a chunk in one slice
constexpr int kTiledPairs = kTiledRows * kTiledUnits / kThreads;
// float4 of a chunk each thread stages: rows tid / (kTiledK / 4) +
// kStageRowStep * l (l < kTiledStage) at float4 column tid % (kTiledK / 4)
constexpr int kTiledStage = kTiledRows * kTiledK / 4 / kThreads;
constexpr int kStageRowStep = kThreads / (kTiledK / 4);
static_assert(kTiledSplit * kTiledRT * kTiledUT == kThreads && kTiledSlice * kTiledSplit == kTiledK,
              "one product thread per k slice and tile");
static_assert(kTiledRT % 8 == 0 && kTiledTU % 4 == 0 && kTiledSlice % 4 == 0,
              "a quarter warp on 8 neighbouring rows, units and k in groups of 4");
static_assert(kThreads / kTiledUnits * kTiledPairs == kTiledRows,
              "the gate stage's pairs: 16 rows apart");
static_assert(kThreads % (kTiledK / 4) == 0, "a chunk is staged in whole rows");
static_assert(kTiledSplit * kTiledRows * kTiledUnits <= 2 * kTiledRows * kTiledKPad &&
                  3 * kTiledRows * kTiledUnits <= 2 * kTiledRows * kTiledKPad,
              "the slices' partial sums and the peephole sums fit the chunk buffers");
// k rows of the block's W share: 4H padded to whole chunks (zero rows)
__host__ __device__ constexpr int tiled_k_rows(int H) {
  return (4 * H + kTiledK - 1) / kTiledK * kTiledK;
}
// W share and two staged chunks of dgates_{t+1}, whose space the k slices'
// partial sums take once the last chunk is multiplied
__host__ __device__ constexpr size_t tiled_smem_bytes(int H) {
  return (static_cast<size_t>(tiled_k_rows(H)) * kTiledUnits +
          static_cast<size_t>(2) * kTiledRows * kTiledKPad) *
         sizeof(float);
}

__device__ __forceinline__ void fma4(float* acc, float a, const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// The step's product in the large-B body: red[kq, r, u] = sum over slice kq
// of every chunk of k of dg[r, k] * W_hid[j0 + u, k], for the block's rows r
// and units u.  dg points at the row group's first row of dgates_{t+1},
// rows row_stride apart, rows_live of them below B; w_t (k-major, 16 floats
// a k) and the two chunk buffers dg_s are the block's shared memory, and
// red is dg_s itself, written once the last chunk is multiplied.  Ends with
// a __syncthreads, so red is visible to the whole block.
__device__ __forceinline__ void tiled_product(const float* dg, size_t row_stride, int rows_live,
                                              int H4, const float* w_t, float* dg_s) {
  const int tid = threadIdx.x;
  // a quarter warp (one phase of a 16-byte shared-memory read) holds 8
  // neighbouring tr of one tu and kq: its dgates reads fall in 8 distinct
  // bank groups (rows 528 bytes apart), its W reads are one address
  const int tr = tid % kTiledRT;
  const int tu = tid / kTiledRT % kTiledUT;
  const int kq = tid / (kTiledRT * kTiledUT);
  const int sc = tid % (kTiledK / 4);
  const int sr = tid / (kTiledK / 4);
  const int n_chunks = (H4 + kTiledK - 1) / kTiledK;
  float4 sv[kTiledStage];
  // the thread's float4 of chunk c into registers; rows past B and k past
  // 4H (a float4 lies wholly inside or outside, 4H being a multiple of 4)
  // are 0.  [stale] dgates is written in this launch: L2 only.
  const auto load = [&](int c) {
    const int k = c * kTiledK + 4 * sc;
#pragma unroll
    for (int l = 0; l < kTiledStage; ++l) {
      const int r = sr + kStageRowStep * l;
      sv[l] = r < rows_live && k < H4
                  ? __ldcg(reinterpret_cast<const float4*>(dg + r * row_stride + k))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const auto store = [&](float* buf) {
#pragma unroll
    for (int l = 0; l < kTiledStage; ++l) {
      *reinterpret_cast<float4*>(buf + (sr + kStageRowStep * l) * kTiledKPad + 4 * sc) = sv[l];
    }
  };
  // each unit group starts at its own chunk and takes the others in turn, so
  // that the blocks of a row group do not all read the same lines at once;
  // the order is fixed by the block, so two calls sum alike
  const int c0 = blockIdx.x % n_chunks;
  load(c0);
  store(dg_s);
  __syncthreads();
  float acc[kTiledTR][kTiledTU];
#pragma unroll
  for (int i = 0; i < kTiledTR; ++i) {
#pragma unroll
    for (int v = 0; v < kTiledTU; ++v) acc[i][v] = 0.f;
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    // chunk cc is multiplied while the next one is in flight
    const int cc = (c0 + ch) % n_chunks;
    const bool more = ch + 1 < n_chunks;
    if (more) load((c0 + ch + 1) % n_chunks);
    const float* a = dg_s + (ch % 2) * kTiledRows * kTiledKPad + tr * kTiledKPad + kq * kTiledSlice;
    const float* w = w_t + static_cast<size_t>(cc * kTiledK + kq * kTiledSlice) * kTiledUnits +
                     kTiledTU * tu;
#pragma unroll
    for (int g = 0; g < kTiledSlice / 4; ++g) {
      float4 av[kTiledTR];
#pragma unroll
      for (int i = 0; i < kTiledTR; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a + kTiledRT * i * kTiledKPad + 4 * g);
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float4 wv[kTiledTU / 4];
#pragma unroll
        for (int h = 0; h < kTiledTU / 4; ++h) {
          wv[h] = *reinterpret_cast<const float4*>(w + (4 * g + d) * kTiledUnits + 4 * h);
        }
#pragma unroll
        for (int i = 0; i < kTiledTR; ++i) {
          const float x = d == 0 ? av[i].x : d == 1 ? av[i].y : d == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int h = 0; h < kTiledTU / 4; ++h) fma4(acc[i] + 4 * h, x, wv[h]);
        }
      }
    }
    // the other buffer was last read before the previous __syncthreads
    if (more) store(dg_s + ((ch + 1) % 2) * kTiledRows * kTiledKPad);
    __syncthreads();
  }
  // the slices' partial sums, red[kq, row, unit], over the chunk buffers
  // (their last reads ended at the loop's last __syncthreads)
  float* red = dg_s;
#pragma unroll
  for (int i = 0; i < kTiledTR; ++i) {
#pragma unroll
    for (int h = 0; h < kTiledTU / 4; ++h) {
      *reinterpret_cast<float4*>(
          red + (static_cast<size_t>(kq) * kTiledRows + tr + kTiledRT * i) * kTiledUnits +
          kTiledTU * tu + 4 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
  __syncthreads();
}

// dh_next of the gate-stage thread's pair (row r, unit u): the slices'
// partial sums in slice order, whatever the schedule.
__device__ __forceinline__ float tiled_sum(const float* red, int r, int u) {
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < kTiledSplit; ++p) s += red[(p * kTiledRows + r) * kTiledUnits + u];
  return s;
}

// The whole chain in the large-B body; arguments as the kernel's (without
// Peephole the w_c*, dw and dw_part are unused).  Block (blockIdx.x,
// blockIdx.y) owns units j0 = 16 blockIdx.x .. + 15 and rows rb0 = 64
// blockIdx.y .. + 63.  With Peephole, dw_part (gridDim.y, 3, H) receives
// each row group's dw, summed over its rows in order; after the last
// grid.sync() the row groups' sums are added in row-group order into dw.
template <bool Peephole>
__device__ __forceinline__ void tiled_chain(
    const float* __restrict__ g_out, const float* __restrict__ gates_pre,
    const float* __restrict__ cells, const float* __restrict__ cells_prev,
    const float* __restrict__ mask, const float* __restrict__ w_hid,
    const float* __restrict__ w_ci, const float* __restrict__ w_cf,
    const float* __restrict__ w_co, float* dgates, float* __restrict__ dcell0,
    float* __restrict__ dhid0, float* __restrict__ dw, float clip, int B, int T, int H,
    float* dw_part) {  // [stale] written and read in the launch
  constexpr int U = kTiledUnits;
  constexpr int P = kTiledPairs;
  extern __shared__ float4 smem4[];
  const int KW = tiled_k_rows(H);
  const int H4 = 4 * H;
  float* w_t = reinterpret_cast<float*>(smem4);     // (KW, 16): w_t[k, u] = W_hid[j0 + u, k]
  float* dg_s = w_t + static_cast<size_t>(KW) * U;  // (2, kTiledRows, kTiledKPad)
  const float* red = dg_s;  // (kTiledSplit, kTiledRows, 16) after a product
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * U;
  const int rb0 = blockIdx.y * kTiledRows;
  const size_t row_stride = static_cast<size_t>(T) * H4;
  const int rows_live = B - rb0;
  // gate-stage thread: unit gu, rows gr + 16 i of the row group
  const int gu = tid % U;
  const int gr = tid / U;
  const int j = j0 + gu;

  // w_t, once per call: item i is unit (i / 8) % 16 at k = i % 8 + 8 (i /
  // 128), so that 8 neighbouring threads read 32 contiguous bytes of one W
  // row.  [ragged] dead units and k past 4H are 0.
  constexpr int kLoadW = 16;
  const int n_w = KW * U;
  for (int i0 = 0; i0 < n_w; i0 += kLoadW * kThreads) {
    float v[kLoadW];
#pragma unroll
    for (int l = 0; l < kLoadW; ++l) {
      const int i = i0 + l * kThreads + tid;
      const int u = i / 8 % U;
      const int k = i % 8 + 8 * (i / (8 * U));
      v[l] = i < n_w && k < H4 && j0 + u < H
                 ? __ldg(w_hid + static_cast<size_t>(j0 + u) * H4 + k)
                 : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kLoadW; ++l) {
      const int i = i0 + l * kThreads + tid;
      if (i < n_w) w_t[(i % 8 + 8 * (i / (8 * U))) * U + i / 8 % U] = v[l];
    }
  }
  // the carries of the thread's pairs, in registers for the whole call;
  // [ragged] [uniform] dead pairs are masked, no thread returns
  bool live[P];
  float dc[P], pass[P], dws[P][3];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    live[i] = gr + 16 * i < rows_live && j < H;
    dc[i] = pass[i] = 0.f;
    dws[i][0] = dws[i][1] = dws[i][2] = 0.f;
  }
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if constexpr (Peephole) {
    if (j < H) {
      p_i = __ldg(w_ci + j);
      p_f = __ldg(w_cf + j);
      p_o = __ldg(w_co + j);
    }
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    const bool has_next = t + 1 < T;
    // the step's read-only inputs first, so that they overlap the product
    float z[P][4], go[P], c_t[P], c_p[P], m[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const size_t bt = static_cast<size_t>(rb0 + gr + 16 * i) * T + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        z[i][q] = live[i] ? __ldg(gates_pre + bt * H4 + static_cast<size_t>(q) * H + j) : 0.f;
      }
      go[i] = live[i] ? __ldg(g_out + bt * H + j) : 0.f;
      c_t[i] = live[i] ? __ldg(cells + bt * H + j) : 0.f;
      c_p[i] = live[i] ? __ldg(cells_prev + bt * H + j) : 0.f;
      m[i] = live[i] ? __ldg(mask + bt) : 0.f;
    }
    if (has_next) {
      tiled_product(dgates + static_cast<size_t>(rb0) * row_stride + (t + 1) * H4, row_stride,
                    rows_live, H4, w_t, dg_s);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (!live[i]) continue;
      const int r = gr + 16 * i;
      // the small-B body's gate math (header), written out again: one
      // function shared by both bodies changed the small-B code (SASS)
      const float dh = (has_next ? tiled_sum(red, r, gu) : 0.f) + pass[i];
      const float dh_total = go[i] + dh;
      const float dh_c = m[i] * dh_total;
      float dc_c = m[i] * dc[i];
      float z_i = z[i][0], z_f = z[i][1], z_o = z[i][3];
      if constexpr (Peephole) {
        // o from the post-mask cell, as the JAX backward recomputes it
        z_i += c_p[i] * p_i;
        z_f += c_p[i] * p_f;
        z_o += c_t[i] * p_o;
      }
      const float ig = sigm(z_i);
      const float f = sigm(z_f);
      const float g = tanhf(z[i][2]);
      const float o = sigm(z_o);
      const float tc = tanhf(c_t[i]);
      const float do_pre = dh_c * tc * o * (1.0f - o);
      dc_c = dc_c + dh_c * o * (1.0f - tc * tc);
      if constexpr (Peephole) dc_c += do_pre * p_o;
      float dgate[4] = {dc_c * g * ig * (1.0f - ig), dc_c * c_p[i] * f * (1.0f - f),
                        dc_c * ig * (1.0f - g * g), do_pre};
      float dc_prev = dc_c * f + (1.0f - m[i]) * dc[i];
      if constexpr (Peephole) {
        // the peephole routes take the cotangents before the clip
        dc_prev += dgate[0] * p_i + dgate[1] * p_f;
        dws[i][0] += dgate[0] * c_p[i];
        dws[i][1] += dgate[1] * c_p[i];
        dws[i][2] += do_pre * c_t[i];
      }
      if (clip != 0.f) {
#pragma unroll
        for (int k = 0; k < 4; ++k) dgate[k] = fminf(fmaxf(dgate[k], -clip), clip);
      }
      float* dp = dgates + (static_cast<size_t>(rb0 + r) * T + t) * H4 + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) dp[static_cast<size_t>(k) * H] = dgate[k];
      dc[i] = dc_prev;
      pass[i] = (1.0f - m[i]) * dh_total;
    }
    if constexpr (Peephole) {
      if (t == 0) {
        // the row group's dw, summed over its rows in order, over dg_s once
        // every thread has read its dh_next there
        __syncthreads();
        float* part = dg_s;  // (3, kTiledRows, 16)
#pragma unroll
        for (int i = 0; i < P; ++i) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            part[(k * kTiledRows + gr + 16 * i) * U + gu] = live[i] ? dws[i][k] : 0.f;
          }
        }
        __syncthreads();
        if (tid < 3 * U && j0 + tid % U < H) {
          const int k = tid / U;
          float s = 0.f;
          for (int r = 0; r < kTiledRows; ++r) s += part[(k * kTiledRows + r) * U + tid % U];
          dw_part[(static_cast<size_t>(blockIdx.y) * 3 + k) * H + j0 + tid % U] = s;
        }
      }
    }
    // [order] [uniform] every block's dgates[:, t] (and at t = 0 its dw
    // sums) before any block's next product; it also orders this step's
    // reads of red and dg_s before the next step's writes
    grid.sync();
  }

  // dh after step 0: one more product, then the block's outputs
  tiled_product(dgates + static_cast<size_t>(rb0) * row_stride, row_stride, rows_live, H4, w_t,
                dg_s);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (!live[i]) continue;
    const int r = gr + 16 * i;
    const size_t e = static_cast<size_t>(rb0 + r) * H + j;
    dhid0[e] = tiled_sum(red, r, gu) + pass[i];
    dcell0[e] = dc[i];
  }
  if constexpr (Peephole) {
    // dw[k, j]: the row groups' sums in row-group order
    if (blockIdx.y == 0 && tid < 3 * U && j0 + tid % U < H) {
      const int k = tid / U;
      float s = 0.f;
      for (int y = 0; y < static_cast<int>(gridDim.y); ++y) {
        s += __ldcg(dw_part + (static_cast<size_t>(y) * 3 + k) * H + j0 + tid % U);
      }
      dw[static_cast<size_t>(k) * H + j0 + tid % U] = s;
    }
  }
}

// The large-B body's two instantiations: explicit specializations of the
// kernel at kTiledUnits units and a float32 W, so that a trace names them
// as it names every other (lstm_bwd_chain_kernel<Peephole, 16, float>),
// while the body above, the small-B one, is never instantiated at that
// width.  The last argument, unused in f32 by the small-B body, carries the
// peephole rows' per-row-group dw sums (float, gridDim.y x 3 x H).
#define LSTM_BWD_TILED(P)                                                                       \
  template <>                                                                                  \
  __global__ void __launch_bounds__(kThreads) lstm_bwd_chain_kernel<P, kTiledUnits, float>(    \
      const float* __restrict__ g_out, const float* __restrict__ gates_pre,                    \
      const float* __restrict__ cells, const float* __restrict__ cells_prev,                   \
      const float* __restrict__ mask, const float* __restrict__ w_hid,                         \
      const float* __restrict__ w_ci, const float* __restrict__ w_cf,                          \
      const float* __restrict__ w_co, float* dgates, float* __restrict__ dcell0,               \
      float* __restrict__ dhid0, float* __restrict__ dw, float clip, int B, int T, int H,      \
      unsigned short* dg16) {                                                                  \
    tiled_chain<P>(g_out, gates_pre, cells, cells_prev, mask, w_hid, w_ci, w_cf, w_co, dgates, \
                   dcell0, dhid0, dw, clip, B, T, H, reinterpret_cast<float*>(dg16));         \
  }
LSTM_BWD_TILED(false)
LSTM_BWD_TILED(true)
#undef LSTM_BWD_TILED

template <typename WT>
size_t smem_bytes(int B, int H, int U) {
  if constexpr (sizeof(WT) == 2) {
    return static_cast<size_t>(32) * U * mma_ksteps(H) +
           (static_cast<size_t>(6) * B * U + mma_red_floats(U)) * sizeof(float);
  }
  if (U == kTiledUnits) return tiled_smem_bytes(H);
  return static_cast<size_t>(4) * U * H * sizeof(float) +
         (static_cast<size_t>(6) * B * U + kWarps * kPairs) * sizeof(float);
}

template <bool Peephole, int U, typename WT>
cudaError_t launch(const float* g_out, const float* gates_pre, const float* cells,
                   const float* cells_prev, const float* mask, const WT* w_hid,
                   const float* w_ci, const float* w_cf, const float* w_co, float* dgates,
                   float* dcell0, float* dhid0, float* dw, float clip, int B, int T, int H,
                   int row_groups, unsigned short* dg16, size_t smem, cudaStream_t stream) {
  const auto kernel = lstm_bwd_chain_kernel<Peephole, U, WT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&g_out, &gates_pre, &cells, &cells_prev, &mask, &w_hid, &w_ci, &w_cf, &w_co,
                  &dgates, &dcell0, &dhid0, &dw, &clip, &B, &T, &H, &dg16};
  // the large-B body's row groups on y (1 for the small-B body)
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3((H + U - 1) / U, row_groups), dim3(kThreads), args,
                                     smem, stream);
}

// Runs the whole chain of one instantiation on `stream`; see the entry
// points.  `peep` holds w_ci, w_cf, w_co, dw or is null.
template <bool Peephole, typename WT>
int run_chain_w(const void* g_out, const void* gates_pre, const void* cells,
                const void* cells_prev, const void* mask, const void* w_hid, void* dgates,
                void* dcell0, void* dhid0, void* const* peep, void* scratch, float clip, int B,
                int T, int H, int units, int row_groups, size_t smem, void* stream) {
  if (smem < smem_bytes<WT>(B, H, units)) return static_cast<int>(cudaErrorInvalidValue);
  // the large-B body: float32 W, row groups that cover B, float4 reads of
  // dgates (its rows are 16H bytes apart) and, with peepholes, its dw sums
  const bool tiled = units == kTiledUnits;
  if (tiled ? sizeof(WT) != 4 || row_groups < 1 || row_groups * kTiledRows < B ||
                  (Peephole && scratch == nullptr)
            : row_groups != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiled && (reinterpret_cast<size_t>(dgates) % 16 != 0 ||
                reinterpret_cast<size_t>(scratch) % 4 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the bf16 layout reads W_hid two values at a time and needs its operand
  // buffer, read 8 bytes at a time
  if (sizeof(WT) == 2 && (reinterpret_cast<size_t>(w_hid) % 4 != 0 ||
                          reinterpret_cast<size_t>(scratch) % 8 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (sizeof(WT) == 2 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[3] = {nullptr, nullptr, nullptr};
  float* dw = nullptr;
  if constexpr (Peephole) {
    for (int k = 0; k < 3; ++k) p[k] = static_cast<const float*>(peep[k]);
    dw = static_cast<float*>(peep[3]);
  }
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto go = [&](auto launcher) {
    return launcher(f(g_out), f(gates_pre), f(cells), f(cells_prev), f(mask),
                    static_cast<const WT*>(w_hid), p[0],
                    p[1], p[2], static_cast<float*>(dgates), static_cast<float*>(dcell0),
                    static_cast<float*>(dhid0), dw, clip, B, T, H, row_groups,
                    static_cast<unsigned short*>(scratch), smem,
                    static_cast<cudaStream_t>(stream));
  };
  cudaError_t err;
  switch (units) {
    case 1: err = go(launch<Peephole, 1, WT>); break;
    case 2: err = go(launch<Peephole, 2, WT>); break;
    case 4: err = go(launch<Peephole, 4, WT>); break;
    case 8: err = go(launch<Peephole, 8, WT>); break;
    case kTiledUnits:
      // the large-B body: float32 W only (checked above)
      if constexpr (sizeof(WT) == 4) {
        err = go(launch<Peephole, kTiledUnits, WT>);
      } else {
        err = cudaErrorInvalidValue;
      }
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// run_chain_w with W of type __nv_bfloat16 when w_bf16, else float.
template <bool Peephole>
int run_chain(const void* g_out, const void* gates_pre, const void* cells,
              const void* cells_prev, const void* mask, const void* w_hid, void* dgates,
              void* dcell0, void* dhid0, void* const* peep, void* scratch, float clip,
              int w_bf16, int B, int T, int H, int units, int row_groups, size_t smem,
              void* stream) {
  return w_bf16 ? run_chain_w<Peephole, __nv_bfloat16>(g_out, gates_pre, cells, cells_prev,
                                                        mask, w_hid, dgates, dcell0, dhid0,
                                                        peep, scratch, clip, B, T, H, units,
                                                        row_groups, smem, stream)
                : run_chain_w<Peephole, float>(g_out, gates_pre, cells, cells_prev, mask, w_hid,
                                               dgates, dcell0, dhid0, peep, scratch, clip, B, T,
                                               H, units, row_groups, smem, stream);
}

}  // namespace

// Runs the whole chain on `stream` in one cooperative launch of ceil(H /
// units) blocks, units in {1, 2, 4, 8} (row_groups 1), or with an f32 w_hid
// 16 (the large-B body, ceil(H / 16) x row_groups blocks, row_groups at
// least ceil(B / 64)), with `smem` bytes of dynamic shared memory (at least
// smem_bytes<W>(B, H, units): f32 16 units H + 24 B units + 1024, at 16
// units tiled_smem_bytes(H); bf16 32 units ceil(4H / 16) + 24 B units + 512
// units).  w_hid is (H, 4H) bf16 when w_bf16 is not 0, else f32; every other
// tensor is f32.  Writes dgates (B, T, 4H), dcell0 and dhid0 (B, H).  With
// a bf16 w_hid, scratch is 2 B 4H bf16 values of device memory, 8-byte
// aligned, for the product's operand (the header's dg16; its contents need
// no setting); with an f32 w_hid it is unused (may be null) but for the
// peephole chain's large-B body, which takes row_groups x 3 x H floats
// there.  Returns the first CUDA error (0 on success;
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident).
extern "C" int lstm_bwd_chain(const void* g_out, const void* gates_pre, const void* cells,
                              const void* cells_prev, const void* mask, const void* w_hid,
                              void* dgates, void* dcell0, void* dhid0, void* scratch, float clip,
                              int w_bf16, int B, int T, int H, int units, int row_groups,
                              size_t smem, void* stream) {
  return run_chain<false>(g_out, gates_pre, cells, cells_prev, mask, w_hid, dgates, dcell0,
                          dhid0, nullptr, scratch, clip, w_bf16, B, T, H, units, row_groups,
                          smem, stream);
}

// The peephole chain: as lstm_bwd_chain, with the (H,) peephole vectors
// w_ci, w_cf, w_co, and dw (3, H), which receives their gradients (scratch
// as there).
extern "C" int lstm_bwd_peep_chain(const void* g_out, const void* gates_pre, const void* cells,
                                   const void* cells_prev, const void* mask,
                                   const void* w_hid, const void* w_ci, const void* w_cf,
                                   const void* w_co, void* dgates, void* dcell0, void* dhid0,
                                   void* dw, void* scratch, float clip, int w_bf16, int B, int T,
                                   int H, int units, int row_groups, size_t smem, void* stream) {
  void* peep[4] = {const_cast<void*>(w_ci), const_cast<void*>(w_cf), const_cast<void*>(w_co),
                   dw};
  return run_chain<true>(g_out, gates_pre, cells, cells_prev, mask, w_hid, dgates, dcell0,
                         dhid0, peep, scratch, clip, w_bf16, B, T, H, units, row_groups, smem,
                         stream);
}

extern "C" const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
