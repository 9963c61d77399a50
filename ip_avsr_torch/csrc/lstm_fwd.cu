// Masked LSTM recurrence for Hopper, with or without peepholes, with W_hid in
// float32 or bf16.
//
// Replaces the TPU kernels of ip_avsr_tpu/ops/pallas/lstm_kernel.py in all
// four of their launches: _lstm_fwd_kernel as lstm_pallas (inference) and
// lstm_pallas_train (the training forward, which also writes the post-mask
// cells and the pre-activation gates for the backward chain in lstm_bwd.cu),
// and _lstm_peep_fwd_kernel as lstm_pallas_peep and lstm_pallas_peep_train.
// As on the TPU, inference and training share one body per peephole setting
// (template parameter EmitResiduals), so they share one set of numerics; the
// inference instantiations make no residual stores.  Per step t:
//     gates = x_proj[:, t] + h_{t-1} @ W_hid          (gate order i, f, c, o)
//     c'    = sigmoid(f + w_cf * c_{t-1}) * c_{t-1} + sigmoid(i + w_ci * c_{t-1}) * tanh(c)
//     h'    = sigmoid(o + w_co * c') * tanh(c')
//     (c_t, h_t) = m * (c', h') + (1 - m) * (c_{t-1}, h_{t-1})   (mask carry)
// where the three (H,) peephole terms are zero without peepholes
// (cell_update below holds this math).  The stored gates are those before
// the peephole terms, as on the TPU.  The hoisted input projection x @ W_in
// + b stays a cuBLAS product outside (as XLA computed it outside the Pallas
// kernel); h @ W_hid is computed here.
//
// Bound: the serial chain of T steps, each of which needs all of W_hid (H x
// 4H f32, 4 MB at H = 500) and an exchange of h across the whole card.  The
// TPU kept W_hid resident in one core's VMEM; on Hopper it does not fit one
// SM's shared memory, so the kernel partitions by hidden unit: a block owns
// U hidden units j, hence gate columns {j, H+j, 2H+j, 3H+j}, so the gate math
// and the cell state stay local to the block and only h crosses blocks.  The
// arithmetic of a whole call is a few microseconds of the card's f32 rate;
// what a step costs is the exchange.
//
// Two bodies serve all four rows, one persistent cooperative launch per call
// (per row chunk, see below) of lstm_fwd_chain_kernel<EmitResiduals,
// Peephole, U, WT>, which loops over t itself: the small-B body described
// first, and for a float32 W_hid at B >= 128 (256 below H = 250) the large-B
// body (U = 16; "Large B" below).  The wrapper picks one from W_hid's dtype,
// B and H (ops/kernels/lstm.py::fwd_plan).
// - The grid is ceil(H / U) blocks, U the smallest of 1, 2, 4, 8 whose grid
//   fits the card's SMs (ops/kernels/lstm.py::fwd_launch_plan), so every
//   block is resident and grid.sync() is the step barrier (one per step,
//   after the step's h stores).  The cooperative launch refuses a grid that
//   cannot be co-resident (cudaErrorCooperativeLaunchTooLarge) rather than
//   hang in the barrier.
// - W_hid resident in shared memory.  The block's 4U columns are loaded once
//   per call as H rows of 4U floats, row k holding W_hid[k, col] for col =
//   gate * U + unit, each row padded to 4U + 4 floats (U >= 2) so that
//   neighbouring k's float4 reads fall in distinct banks: 40,000 B at H =
//   500, U = 4.  The product gates[b, col] = sum_k h_{t-1}[b, k] * W[k, col]
//   then reads only h from global memory, and a lane's weights for one k are
//   4U / 4 float4 reads from one address.  (A (4U, H) layout, one row per
//   column, took 16 strided addresses per k and measured slower: the address
//   arithmetic, not the loads, bound a k step.)
// - The cell state and the block's own units of h_{t-1} (for the mask carry)
//   live in shared memory for the whole call, each (row, unit) read and
//   written by one thread only.  With peepholes, each gate-stage thread holds
//   its unit's three peephole weights in registers for the whole call: its
//   unit tid % U is the same in every round and step.
// - h crosses blocks through out[:, t] in global memory and L2 behind the
//   barrier.  The product reads h_{t-1} in row tiles of R = 32 / 4U rows
//   straight from L2; shared memory does not grow with B x H.  A warp owns
//   one tile and a slice of k (lanes on neighbouring k, so its loads are
//   coalesced and its weight reads free of bank conflicts), sums the tile's
//   32 (row, column) pairs over its slice, and reduces them across its lanes
//   in 31 shuffles; the gate stage adds the partial sums of the warps that
//   shared the tile, in a fixed order.  A round is up to 8 tiles, one per
//   warp or several warps per tile, so B <= 8 R rows (16 at U = 4) take one
//   round and one __syncthreads per step.
// Shared memory (dynamic) of the small-B body: W H x (4U + 4) f32 (H x 4 at U
// = 1; bf16: see below), then the cell and h carries B x U each, then the
// warps' partial sums 8 x 32; 4 (4U + 4) H + 8BU + 1024 bytes for f32
// (ops/kernels/lstm.py::fwd_launch_plan; the large-B body's below).  Rows are
// independent, so a batch whose carries do not fit beside W_hid runs as
// several launches over near-equal row chunks, each a pointer offset into
// the batch-major tensors (the plan's `chunks`; the wrapper launches them in
// order on one stream).
//
// bf16 W_hid (matmul_dtype="bfloat16" and a bf16-weight artifact): every
// instantiation also exists with W of storage type __nv_bfloat16 (template
// parameter WT), as each Pallas body is generic over W_hid's dtype.  There
// gates = x_proj[:, t] + bf16(h_{t-1}) @ W_hid with f32 accumulation, as
// jnp.dot(hid_prev.astype(bf16), w_hid_bf16, preferred_element_type=f32)
// computes it (lstm_kernel.py:67-70), and the product runs on Hopper's
// tensor cores: warp-level mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.
// f32 (inline PTX, mma_bf16 below), rows of h on M, the block's 4U gate
// columns on N (n8 tiles: 2 at U = 4; one at U = 1 and 2, half of it zero
// at U = 1), K = H padded with zeros to KS = ceil(H / 16) steps of 16.  (The
// other orientation, the 4U columns on M and the rows on N, issues the same
// number of products at B = 9-16 and half of them at B <= 8; it was not
// built: a step of the chain costs the exchange, not these few products.)
// Only the product differs from the f32 instantiations, whose code is
// untouched (if constexpr (sizeof(WT) == 2) below):
// - The k of a step in a permuted order, the same for both operands (a sum
//   does not depend on it): the fragment's k 2 (lane % 4) + 8 r + {0, 1}
//   is h's column 16 s + 4 (lane % 4) + 2 r + {0, 1}, so that a lane's four
//   A values of a row are neighbours in memory, one 8-byte read.
// - W in shared memory as bf16 in fragment order, laid out once per call:
//   32-bit word ((s * LW + lane) * NT + j) * 2 + r holds W_hid[k, col] and
//   W_hid[k + 1, col] (low half first) for k = 16 s + 4 (lane % 4) + 2 r and
//   col = 8 j + lane / 4, which is the B fragment register r of n-tile j
//   that lane `lane` passes to the k step s.  A lane reads its fragments of
//   a k step as one 8- or 16-byte word (two at U = 8), neighbouring lanes on
//   neighbouring words: no bank conflict.  LW = 32 lanes hold live columns
//   (16 at U = 1, whose other lanes pass zeros).  8 U bytes per padded k:
//   16,384 B at H = 500, U = 4 (f32: 40,000).
// - The operand, rounded once: the gate stage also writes each h_t rounded
//   to nearest even (__float2bfloat16_rn, as the f32-emulating plain
//   version rounds it) into h16 (2, B, KS * 16) bf16 in global memory, slot
//   (t + 1) % 2, and step t's product reads slot t % 2: every value is
//   rounded once, by the block that owns it, not once by each of the
//   blocks that read it, the reads are half the bytes, and the rows,
//   padded to KS * 16 values (zeros past H), need no ragged or misaligned
//   reads at H = 250 or 130.  Slot 0 starts as bf16(hid0), each block
//   writing its units, the last block zeroing the padding of both slots,
//   and one more grid.sync() orders that before the first product.  Two
//   slots, because step t reads one while it writes the other, and the
//   grid.sync() between steps orders both ([stale]: h16 is written and
//   read in the launch, read with __ldcg).  The mask carry's h_{t-1}, out
//   and every other output stay f32.
// - The A fragment: a lane's rows are b0 + lane / 4 and b0 + lane / 4 + 8,
//   its columns 16 s + 4 (lane % 4) .. + 3 of h16's slot, one 8-byte
//   __ldcg per row (four bf16 values, two fragment registers); each bf16 x
//   bf16 product is exact.  A ragged operand is zero: rows past B (masked),
//   k past H (the padding).
// - Each k step's products go to a zero accumulator and the step's sums are
//   added in f32 (mma_bf16), so that the k steps are summed with f32
//   rounding to nearest, not inside the tensor core, and the steps'
//   products need not wait on each other.
// - A round is up to 16 / U tiles of 16 rows (at most 8): 64 rows at U =
//   4, one tile for the flagship's B = 8-10.  The warps split the round's
//   tiles and the KS k steps as the f32 design splits its tiles: warp ->
//   tile warp % G and k steps ks, ks + ns, ..., so at B <= 16 every warp
//   takes every 8th k step (4 at H = 500).  Each warp stores its 16 x 4U
//   partial tile to shared memory and the gate stage adds the tiles of the
//   warps that shared its tile in warp order (unrolled, its up to 32 loads
//   in flight together), as in f32: the result does not depend on the
//   schedule.  Within a k step the tensor core's own order sums the 16
//   products; that, and the order of the k steps, is all that differs from
//   a chain of fmaf.
// - The carries, the mask carry's h_{t-1}, the gate math, x_proj, the
//   peepholes and every output stay f32, and the persistent cooperative
//   launch, the grid.sync() per step and the row chunks are the f32
//   design's.  Shared memory: 8 U KS * 16 bytes of W, the carries, then the
//   warps' partial tiles 8 x 16 x 4U floats (8,192 B at U = 4); the operand
//   buffer is the wrapper's scratch in global memory.
// [bf16 uniform] mma.sync is warp-wide: every lane of a warp runs the same
//   k steps (warp-uniform trip counts; masked lanes pass zeros), and the
//   round's __syncthreads and the grid.sync()s (T + 1 with a bf16 W) are
//   reached by every thread.
//
// Layouts are batch-major, the port's public layout, so no transpose is
// needed: x_proj (B, T, 4H), mask (B, T), out (B, T, H), and the residuals
// cells (B, T, H) and gates (B, T, 4H).  Step t reads h_{t-1} from
// out[:, t-1] (or hid0 at t = 0, row stride H) and writes out[:, t].  The
// inference entry points can also write the final cell carry (B, H) after
// the t loop, for a streaming caller that resumes from (cell_T, out[:, T-1]);
// the training ones pass null and write none.
//
// Where trouble is likely, and what the code does about it (marked below):
// [stale] out is written and read inside one launch, so h_{t-1} is never
//   read through the read-only path (__ldg or a const __restrict__ pointer,
//   which may return stale lines) nor through L1, which is not coherent
//   across SMs: the product reads it with __ldcg (L2 only), and out is
//   neither const nor __restrict__.  x_proj, mask, W_hid, cell0, hid0 and the
//   peephole vectors are read-only for the whole launch, so __ldg is right
//   for them.
// [order] grid.sync() fences before it arrives, so every block's out[:, t]
//   stores are visible to every block after it.
// [carry] a padded step still stores h_{t-1} into out[:, t], for every row
//   (a fully padded one too): the next step reads all of out[:, t].
// [ragged] H need not be a multiple of U (H = 250 with U = 4, H = 130): the
//   last block's dead units get zero weight columns, no peephole weights and
//   no gate stage.
// [uniform] every thread of every block reaches each __syncthreads and each
//   grid.sync() the same number of times: the gate-stage and peephole-load
//   guards mask work and no thread leaves early.
// [converge] the warp shuffles of the product's reduction follow k loops
//   whose trip counts are the same for every lane of the warp.
//
// Large B, float32 W_hid (tiled_chain, the kernel's explicit specializations
// at U = kTiledUnits = 16).  In the small-B body every block reads all B
// rows of h_{t-1} each step, in rounds of 8 R rows (16 at U = 4), each an
// unhidden L2 round trip, a shuffle transpose and a __syncthreads: 16 rounds,
// 55 us a step at B = 256, H = 500.  The large-B body does the same f32 FMAs
// on the CUDA cores (no TF32: the configurations state f32) in one of two
// forms, which share the grid, the gate stage and the barrier:
// - Blocks split by rows as well as units: ceil(H / 16) unit groups on x by
//   row groups of 64 rows on y (gridDim.y; a launch takes as many as fit
//   beside the unit groups on the card's SMs, a larger batch runs in row
//   chunks: ops/kernels/lstm.py::fwd_tiled_plan).  A block owns all four
//   gates of its 16 units, so the gate math and the carries stay local, and
//   reads only its row group's rows of h_{t-1}: 16 MB of L2 a step at B =
//   256, H = 500.  One grid.sync() a step.
// - The gate stage: thread tid owns rows tid / 16 + 16 i (i < 4) of unit
//   tid % 16.
// Resident (resident_chain, at the widths tiled_resident takes: H a multiple
// of 4 from 388 to 512), W_hid in registers for the whole call, the
// persistent-RNN layout:
// - Warp w holds the k slice w KW .. w KW + KW - 1 (KW = 4 ceil(H / 32), 64
//   at H = 500), its quarter q = lane / 8 the groups of 4 k 4 i + q (i < 4)
//   of the slice, and lane l the gate columns of units 2 (l % 8) and + 1
//   (columns unit-major, 4 u + gate): 4 x 4 x 8 = 128 weights a thread, an
//   array that only compile-time indices touch.  Shared memory serves only
//   h_{t-1}, as broadcasts: a float4 read has one address a quarter warp
//   and feeds a lane 4 k x 8 columns, 32 FMAs.  (With 2 columns a lane and
//   no k split, 8 FMAs a read, the product measured bound by shared memory:
//   a broadcast float4 read costs one wavefront a quarter warp.)
// - The quarters' sums of a column meet in two shuffle levels, (q0 + q2) +
//   (q1 + q3) in every lane that holds it (a + b = b + a), transposed so
//   that a lane keeps 2 columns; the warps' partial sums go to shared memory
//   and the gate stage adds the 8 of each (row, column) in warp order; each
//   quarter takes its k in order, so two calls give the same bits.
// - h_{t-1} staged per warp: each warp copies its own k slice of its row
//   group's rows into its own 64 rows of shared memory, in float4 pieces
//   (H a multiple of 4 and the entry points check the alignment of hid0 and
//   out), kTiledChunkRows rows at a time, chunk c + 1's loads in flight
//   while chunk c is multiplied; a row of h is overwritten by the warp's
//   partial sums of that row once every lane has read it, so the warps meet
//   only at the step's __syncthreads.  [stale] h is written in this launch:
//   __ldcg into registers (L2 only), then shared stores.  Each unit group
//   starts at its own chunk and takes the others in turn, so that the
//   blocks of a row group do not all read the same lines at once; a row's
//   sums do not depend on the chunk order.  Chunks wholly past B are
//   skipped.
// - The gate stage's x_proj and mask of step t + 1 are copied to shared
//   memory by cp.async.ca (read-only for the whole launch) during step t,
//   and its carries live in shared memory, so that neither holds registers
//   across the product.
// Bound of a step: a block's 64 x 64 sums over K = 8 KW are 2.1 M FMAs at H
// = 500, 16.4 k clocks of an SM's 128 FMAs a clock; a warp issues 32 FMAs a
// shared-memory read and 2 x 4 shuffles a row of 128 FMAs, so the product
// is bound by FMA issue.  At B = 256 every block does them (128 of the
// card's 132 SMs).  Registers: 128 of W, 255 in all, no spill.  Shared
// memory (dynamic), whatever H: the warps' rows of h and partial sums 8 x 64
// x 64 floats, the gate inputs of two steps and the carries 256 threads x 48
// floats: 180,224 B (ops/kernels/lstm.py::fwd_tiled_smem_bytes).
// Staged (staged_chain, every other width up to 512; at H = 250, 130 and 64
// it measured faster than the resident layout, whose fixed cost a step does
// not shrink with H):
// - h_{t-1} staged through shared memory: the row group's rows in chunks of
//   kStagedK = 64 values of k, two buffers, chunk c + 1's loads issued
//   before chunk c is multiplied.  [stale] h is written in this launch, so
//   the loads are __ldcg into registers (L2 only), then stored to shared
//   memory: cp.async.cg copies only 16 bytes and the rows of h are 8-byte
//   aligned at H = 250 or 130, cp.async.ca goes through L1, and TMA needs
//   16-byte row strides; the register route needs no proxy fence either, as
//   its shared stores are generic.  Each unit group starts at its own chunk
//   (blockIdx.x modulo the chunks) and takes the others in turn.
// - A register-tiled product: thread (kq, tr, tc) holds an 8 x 8 tile of
//   sums, rows tr + 8 i by the four gates of units tc and tc + 8 (W's columns
//   unit-major, 4 u + gate), over slice kq of every chunk (4 slices of 16 k).
//   Per k it reads 8 values of h and 8 of W from shared memory as float4 (a
//   quarter warp reads one h address and 128 contiguous bytes of W: no bank
//   conflict).  The slices' partial sums meet in shared memory and are added
//   in slice order; within a slice k runs in the block's fixed chunk order,
//   so two calls give the same bits.  The carries stay in registers.
// - Shared memory (dynamic): W ceil(H / 64) * 64 rows of 64 floats (zero past
//   H), two chunks of 64 rows x 68 floats, the slices' partial sums 4 x 64 x
//   64 floats: 165,888 B at H = 250, 231,424 at H = 512.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// The gate math of one (row, unit): the pre-activations gate[4] (i, f, c, o,
// before any peephole term), the carries c_prev and h_prev and the mask m ->
// the post-mask cell and hidden state.  Without Peephole the p_* are unused.
template <bool Peephole>
__device__ __forceinline__ void cell_update(const float (&gate)[4], float c_prev, float h_prev,
                                            float m, float p_i, float p_f, float p_o,
                                            float& c_out, float& h_out) {
  float z_i = gate[0], z_f = gate[1], z_o = gate[3];
  if constexpr (Peephole) {
    z_i += c_prev * p_i;
    z_f += c_prev * p_f;
  }
  const float c_new = sigm(z_f) * c_prev + sigm(z_i) * tanhf(gate[2]);
  if constexpr (Peephole) z_o += c_new * p_o;
  const float h_new = sigm(z_o) * tanhf(c_new);
  c_out = m * c_new + (1.0f - m) * c_prev;
  h_out = m * h_new + (1.0f - m) * h_prev;
}

constexpr int kChainThreads = 256;
constexpr int kWarps = kChainThreads / 32;
// (row, column) pairs of one warp tile: 32 / 4U rows by 4U gate columns, one
// accumulator each per lane, reduced across the warp in 31 shuffles
constexpr int kPairs = 32;

// f32 values per k row of the block's W_hid columns in shared memory: 4U,
// padded so that the 8 lanes of each phase of a float4 read (neighbouring
// k) hit distinct banks, that is so that a row is an odd number of 16-byte
// words: 20 floats at U = 4 (U = 1 needs no padding).
__host__ __device__ constexpr int padded_columns(int U) { return U == 1 ? 4 : 4 * U + 4; }

// The C weights of one k row of w_s as floats: C / 4 float4 reads.
template <int C>
__device__ __forceinline__ void load_row(const float* row, float (&w)[C]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c4 = 0; c4 < C / 4; ++c4) {
    const float4 q = r4[c4];
    w[4 * c4] = q.x;
    w[4 * c4 + 1] = q.y;
    w[4 * c4 + 2] = q.z;
    w[4 * c4 + 3] = q.w;
  }
}

// The bf16 product on the tensor cores (header).  kTile rows of an m16n8k16
// tile; the n8 tiles and the lanes holding live columns of the block's 4U
// gate columns; the tiles of a round (16 / U, at most kWarps, so that a
// round's rows x U units are at most kChainThreads gate-stage threads).
constexpr int kTile = 16;
__host__ __device__ constexpr int mma_ntiles(int U) { return (4 * U + 7) / 8; }
__host__ __device__ constexpr int mma_lanes(int U) { return U == 1 ? 16 : 32; }
__host__ __device__ constexpr int mma_round_tiles(int U) {
  return 16 / U < kWarps ? 16 / U : kWarps;
}
// k steps of 16 at width H, and the bytes of W (fragment order) and of the
// warps' partial tiles in shared memory
__host__ __device__ constexpr int mma_ksteps(int H) { return (H + kTile - 1) / kTile; }
__host__ __device__ constexpr size_t mma_w_bytes(int H, int U) {
  return static_cast<size_t>(mma_ksteps(H)) * mma_lanes(U) * mma_ntiles(U) * 8;
}
__host__ __device__ constexpr int mma_red_floats(int U) { return kWarps * kTile * 4 * U; }
// k steps whose operands a warp loads before their products: all of a warp's
// at B <= 16 for the widths the launch plan gives U (H <= 528 at U = 4: 4;
// H <= 264 at U = 2: 2)
__host__ __device__ constexpr int mma_batch(int U) { return U >= 4 ? 4 : 2; }

// Two f32 as a bf16 pair, each rounded to nearest even, x in the low half
// (the lower k of an mma fragment register).
__device__ __forceinline__ unsigned int pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned int*>(&v);
}

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

// The bf16 product of one round (header): this warp's 16 x 4U partial tile
// of rows b0 .. b0 + 15 over k steps ks, ks + ns, ... into red_w (16 rows of
// 4U floats), from h_{t-1} already rounded to bf16 (h16: rows of KS * 16
// values, zero past H) and W in fragment order.
template <int U>
__device__ __forceinline__ void mma_tile(const unsigned short* h16, const unsigned int* w_w,
                                         float* red_w, int b0, int ks, int ns, int B, int H,
                                         int lane) {
  constexpr int C = 4 * U;
  constexpr int NT = mma_ntiles(U);
  constexpr int LW = mma_lanes(U);
  const int KS = mma_ksteps(H);
  const size_t stride = static_cast<size_t>(KS) * kTile;
  const int ra = b0 + lane / 4;
  const bool la = ra < B;
  const bool lb = ra + 8 < B;
  const unsigned short* ha = h16 + (la ? ra : 0) * stride;
  const unsigned short* hb = h16 + (lb ? ra + 8 : 0) * stride;
  // [bf16 uniform] the same k steps for every lane of the warp
  const int steps = (KS - ks + ns - 1) / ns;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  }
  constexpr int kMmaBatch = mma_batch(U);
  for (int s0 = 0; s0 < steps; s0 += kMmaBatch) {
    // every operand of the batch is requested before any product: the
    // lane's k = 16 s + 4 (lane % 4) .. + 3 of rows ra and ra + 8, four bf16
    // values (two fragment registers) in one 8-byte read each
    uint2 hv[kMmaBatch][2];
#pragma unroll
    for (int i = 0; i < kMmaBatch; ++i) {
      const bool live = s0 + i < steps;
      const int k = (ks + (s0 + i) * ns) * kTile + (lane % 4) * 4;
      const uint2 zero = make_uint2(0u, 0u);
      // [stale] written in this launch: L2 only, never __ldg or L1
      hv[i][0] = live && la ? __ldcg(reinterpret_cast<const uint2*>(ha + k)) : zero;
      hv[i][1] = live && lb ? __ldcg(reinterpret_cast<const uint2*>(hb + k)) : zero;
    }
    // the batch's products in one straight run: a slot past the warp's
    // steps has zero operands (its loads are masked) and a live W word, so
    // it adds exactly 0 (as in lstm_bwd.cu)
#pragma unroll
    for (int i = 0; i < kMmaBatch; ++i) {
      const int s = min(ks + (s0 + i) * ns, KS - 1);
      // the A fragment: registers 0 and 2 of row ra, 1 and 3 of row ra + 8
      const unsigned int a[4] = {hv[i][0].x, hv[i][1].x, hv[i][0].y, hv[i][1].y};
      unsigned int b[NT][2];
      const unsigned int* wp = w_w + (static_cast<size_t>(s) * LW + lane) * NT * 2;
      if constexpr (NT == 1) {
        const uint2 q = lane < LW ? *reinterpret_cast<const uint2*>(wp) : make_uint2(0u, 0u);
        b[0][0] = q.x;
        b[0][1] = q.y;
      } else {
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          const uint4 q = reinterpret_cast<const uint4*>(wp)[j2];
          b[2 * j2][0] = q.x;
          b[2 * j2][1] = q.y;
          b[2 * j2 + 1][0] = q.z;
          b[2 * j2 + 1][1] = q.w;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
    }
  }
  // the accumulator fragment: rows lane / 4 and lane / 4 + 8, columns
  // 8 j + 2 (lane % 4) + {0, 1}; columns past 4U (U = 1) are zero
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    if (col < C) {
      float* r0 = red_w + (lane / 4) * C + col;
      r0[0] = acc[j][0];
      r0[1] = acc[j][1];
      r0[8 * C] = acc[j][2];
      r0[8 * C + 1] = acc[j][3];
    }
  }
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

// The large-B body (header): float32 W_hid, kTiledUnits units by kTiledRows
// rows a block; for the gate stage, thread tid owns rows tid / 16 + 16 i (i
// < kTiledGateRows) of unit tid % 16.  In the resident body's product, warp
// w holds W_hid's k slice w KW .. + KW - 1 (KW <= kTiledSliceK), quarter q =
// lane / 8 of it the groups of 4 k 4 i + q (i < kTiledGroups) and lane l the
// kTiledLaneCols gate columns of group l % 8, over the row group's rows in
// chunks of kTiledChunkRows, kTiledPassRows rows at a time.
constexpr int kTiledUnits = 16;
constexpr int kTiledRows = 64;
constexpr int kTiledCols = 4 * kTiledUnits;
constexpr int kTiledMaxH = 512;
constexpr int kTiledSliceK = kTiledMaxH / kWarps;
constexpr int kTiledLaneCols = kTiledCols / 8;
constexpr int kTiledGroups = kTiledSliceK / 16;
constexpr int kTiledPassRows = 4;
constexpr int kTiledChunkRows = 8;
constexpr int kTiledGateRows = kTiledRows * kTiledUnits / kChainThreads;
// a gate-stage thread's values in shared memory: x_proj's 4 gates and the
// mask of each of its rows, for two steps, and its cell and hidden carries
constexpr int kTiledStepIn = 5 * kTiledGateRows;
constexpr int kTiledGateIn = 2 * kTiledStepIn + 2 * kTiledGateRows;
static_assert(kTiledLaneCols == 8 && kTiledGroups * 16 == kTiledSliceK &&
                  32 % (kTiledSliceK / 4) == 0,
              "a lane holds two units' gate columns; the quarters take whole groups of 4 k; "
              "a warp's float4 pieces cover whole rows");
// k of a warp's slice at width H: the slices cover H in whole groups of 4
__host__ __device__ constexpr int tiled_slice_k(int H) {
  return (H + 4 * kWarps - 1) / (4 * kWarps) * 4;
}
// the widths the resident body takes: those whose k slices fill every
// quarter warp's kTiledGroups groups of 4 k (H above 384), in whole float4
// pieces of h
__host__ __device__ constexpr bool tiled_resident(int H) {
  return H > kTiledMaxH * 3 / 4 && H <= kTiledMaxH && H % 4 == 0;
}
// the warps' rows of h_{t-1} and then partial sums, the gate inputs and
// carries
__host__ __device__ constexpr size_t resident_smem_bytes() {
  return (static_cast<size_t>(kWarps) * kTiledRows * kTiledCols +
          static_cast<size_t>(kTiledGateIn) * kChainThreads) *
         sizeof(float);
}

// One float of read-only global memory into shared memory, asynchronously
// (cp.async.ca, 4 bytes); cp.async.wait_group makes it visible to the thread.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The warp's k slice of one chunk of kTiledChunkRows rows (row0 ..) moves
// to shared memory through registers in float4 pieces: piece m of the
// lane, v[4 m .. 4 m + 3], is q = lane + 32 m of the chunk's rows of
// kTiledSliceK / 4 pieces, so that neighbouring lanes read neighbouring
// pieces.  h's rows are 16-byte aligned (H a multiple of 4, checked by the
// entry points).
constexpr int kTiledStage = kTiledChunkRows * kTiledSliceK / 32;  // floats a lane
constexpr int kTiledPieces = kTiledSliceK / 4;                     // of a row

// Loads the pieces: zero at a row at or past B, at slice k at or past KW, or
// at k at or past H (a piece is wholly one or the other: KW and H are
// multiples of 4).  [stale] h is written in this launch: L2 only.
__device__ __forceinline__ void tiled_stage_load(const float* h, size_t h_stride, int row0,
                                                 int B, int k0, int KW, int H, int lane,
                                                 float (&v)[kTiledStage]) {
#pragma unroll
  for (int m = 0; m < kTiledStage / 4; ++m) {
    const int q = lane + 32 * m;
    const int r = q / kTiledPieces;
    const int kk = q % kTiledPieces * 4;
    const float* src = h + (row0 + r) * h_stride + k0 + kk;
    const float4 x = row0 + r < B && kk < KW && k0 + kk < H
                         ? __ldcg(reinterpret_cast<const float4*>(src))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    v[4 * m] = x.x;
    v[4 * m + 1] = x.y;
    v[4 * m + 2] = x.z;
    v[4 * m + 3] = x.w;
  }
}

// Stores the pieces into the chunk's rows of buf (rows of kTiledSliceK).
__device__ __forceinline__ void tiled_stage_store(float* buf, int lane,
                                                  const float (&v)[kTiledStage]) {
#pragma unroll
  for (int m = 0; m < kTiledStage / 4; ++m) {
    const int q = lane + 32 * m;
    *reinterpret_cast<float4*>(buf + q / kTiledPieces * kTiledSliceK + q % kTiledPieces * 4) =
        make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
  }
}

// The whole recurrence in the resident large-B body (tiled_resident(H));
// arguments as the kernel's (cell_last may be null; without Peephole the w_c*
// are unused; without EmitResiduals cells and gates are).  Block (blockIdx.x,
// blockIdx.y) owns units j0 = kTiledUnits blockIdx.x .. + kTiledUnits - 1 and
// rows rb0 = kTiledRows blockIdx.y .. + kTiledRows - 1.
template <bool EmitResiduals, bool Peephole>
__device__ __forceinline__ void resident_chain(
    const float* __restrict__ x_proj, const float* __restrict__ w_hid,
    const float* __restrict__ mask, const float* __restrict__ cell0,
    const float* __restrict__ hid0, float* out, float* __restrict__ cells,
    float* __restrict__ gates, float* __restrict__ cell_last, const float* __restrict__ w_ci,
    const float* __restrict__ w_cf, const float* __restrict__ w_co, int B, int T, int H) {
  constexpr int U = kTiledUnits;
  constexpr int C = kTiledCols;
  constexpr int G = kTiledGroups;
  constexpr int CR = kTiledChunkRows;
  constexpr int SK = kTiledSliceK;
  constexpr int GR = kTiledGateRows;
  extern __shared__ float4 smem4[];
  // (kWarps, kTiledRows, C): warp w's rows of h_{t-1} (its k slice), each
  // overwritten by the warp's partial sums (column 4 u + gate) once read
  float* red = reinterpret_cast<float*>(smem4);
  float* gin = red + kWarps * kTiledRows * C;  // (kTiledGateIn, kChainThreads)
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = blockIdx.x * U;
  const int rb0 = blockIdx.y * kTiledRows;
  const size_t H4 = static_cast<size_t>(4) * H;
  // product thread: k slice k0 .. k0 + KW - 1 of the warp, its groups of 4
  // k 4 i + wq of the quarter, the 8 gate columns of units 2 wc, 2 wc + 1
  const int KW = tiled_slice_k(H);
  const int k0 = warp * KW;
  const int wq = lane / 8;
  const int wc = lane % 8;
  // gate-stage thread: unit gu, rows gr + 16 i
  const int gu = tid % U;
  const int gr = tid / U;
  const int j = j0 + gu;

  // the thread's W_hid share, once per call: w[i][d][c] = W_hid[k, gate * H
  // + unit] for k = k0 + 4 (4 i + wq) + d, column 8 wc + c = 4 (unit - j0) +
  // gate; [ragged] dead units, k past the slice and k past H are 0
  float w[G][4][kTiledLaneCols];
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int kk = 4 * (4 * i + wq) + d;
      const bool k_live = kk < KW && k0 + kk < H;
#pragma unroll
      for (int c = 0; c < kTiledLaneCols; ++c) {
        const int u = j0 + 2 * wc + c / 4;
        w[i][d][c] = k_live && u < H
                         ? __ldg(w_hid + (k0 + kk) * H4 + static_cast<size_t>(c % 4) * H + u)
                         : 0.f;
      }
    }
  }
  // the carries of the gate-stage thread's (row, unit) pairs, in shared
  // memory for the whole call (carry[i] the cell, carry[GR + i] the hidden
  // state), each read and written by this thread only; [ragged] [uniform]
  // dead pairs are masked, no thread returns
  float* carry = gin + 2 * kTiledStepIn * kChainThreads + tid;
  bool live[GR];
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    const int b = rb0 + gr + kChainThreads / U * i;
    live[i] = b < B && j < H;
    const size_t e = static_cast<size_t>(b) * H + j;
    carry[i * kChainThreads] = live[i] ? __ldg(cell0 + e) : 0.f;
    carry[(GR + i) * kChainThreads] = live[i] ? __ldg(hid0 + e) : 0.f;
  }
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if constexpr (Peephole) {
    if (j < H) {
      p_i = __ldg(w_ci + j);
      p_f = __ldg(w_cf + j);
      p_o = __ldg(w_co + j);
    }
  }

  cg::grid_group grid = cg::this_grid();
  // the row group's chunks that hold a row below B; each unit group starts
  // at its own
  const int n_rc = min(kTiledRows / CR, (B - rb0 + CR - 1) / CR);
  const int c_first = blockIdx.x % n_rc;
  float* wrows = red + warp * kTiledRows * SK;
  static_assert(kTiledSliceK == kTiledCols, "a row of h's slice and of partial sums alike");
  // a step's gate inputs: x_proj's gates of the thread's rows at
  // gin[(t % 2) kTiledStepIn + 4 i + q], the mask at + 4 GR + i, copied
  // one step ahead, one cp.async group a step
  const auto fetch_inputs = [&](int s) {
    if (s < T) {
      float* dst = gin + (s % 2) * kTiledStepIn * kChainThreads + tid;
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        const int b = rb0 + gr + kChainThreads / U * i;
        if (b < B && j < H) {  // live[i]
          const size_t bt = static_cast<size_t>(b) * T + s;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cp_async_f32(dst + (4 * i + q) * kChainThreads,
                         x_proj + bt * H4 + static_cast<size_t>(q) * H + j);
          }
          cp_async_f32(dst + (4 * GR + i) * kChainThreads, mask + bt);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch_inputs(0);
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? hid0 : out + static_cast<size_t>(t - 1) * H;
    const size_t h_stride = t == 0 ? static_cast<size_t>(H) : static_cast<size_t>(T) * H;
    float v[kTiledStage];
    tiled_stage_load(h, h_stride, rb0 + c_first * CR, B, k0, KW, H, lane, v);
    // the next step's inputs queue behind this step's first loads of h; the
    // buffer they fill was last read before the previous grid.sync()
    fetch_inputs(t + 1);
    // into rows whose partial sums the previous step's gate stage read
    tiled_stage_store(wrows + c_first * CR * SK, lane, v);
    __syncwarp();
    for (int ch = 0; ch < n_rc; ++ch) {
      // chunk cc is multiplied while the next one, cn, is in flight
      const int cc = (c_first + ch) % n_rc;
      const int cn = (c_first + ch + 1) % n_rc;
      const bool more = ch + 1 < n_rc;
      if (more) tiled_stage_load(h, h_stride, rb0 + cn * CR, B, k0, KW, H, lane, v);
      const float* buf = wrows + cc * CR * SK;
#pragma unroll
      for (int r0 = 0; r0 < CR; r0 += kTiledPassRows) {
        float acc[kTiledPassRows][kTiledLaneCols];
#pragma unroll
        for (int r = 0; r < kTiledPassRows; ++r) {
#pragma unroll
          for (int c = 0; c < kTiledLaneCols; ++c) acc[r][c] = 0.f;
        }
        // the quarter's groups of 4 k, in order; past KW and H both
        // operands are 0
#pragma unroll
        for (int i = 0; i < G; ++i) {
          float4 hv[kTiledPassRows];
#pragma unroll
          for (int r = 0; r < kTiledPassRows; ++r) {
            // one address a quarter warp: a broadcast
            hv[r] = *reinterpret_cast<const float4*>(buf + (r0 + r) * SK + 4 * (4 * i + wq));
          }
#pragma unroll
          for (int d = 0; d < 4; ++d) {
#pragma unroll
            for (int r = 0; r < kTiledPassRows; ++r) {
              const float hk = d == 0 ? hv[r].x : d == 1 ? hv[r].y : d == 2 ? hv[r].z : hv[r].w;
#pragma unroll
              for (int c = 0; c < kTiledLaneCols; ++c) {
                acc[r][c] = fmaf(hk, w[i][d][c], acc[r][c]);
              }
            }
          }
        }
        // the four quarters' sums of each column, (q0 + q2) + (q1 + q3) in
        // every lane (a + b = b + a), transposed so that lane l keeps
        // columns 8 wc + 2 wq and + 1; then the warp's partial sums,
        // red[warp, row, column]
#pragma unroll
        for (int r = 0; r < kTiledPassRows; ++r) {
          const bool hi16 = lane & 16;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float send = hi16 ? acc[r][c] : acc[r][c + 4];
            const float keep = hi16 ? acc[r][c + 4] : acc[r][c];
            acc[r][c] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
          const bool hi8 = lane & 8;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float send = hi8 ? acc[r][c] : acc[r][c + 2];
            const float keep = hi8 ? acc[r][c + 2] : acc[r][c];
            acc[r][c] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
          }
          // over the row's h, which every lane has read: its shuffles came
          // after its reads
          *reinterpret_cast<float2*>(wrows + (cc * CR + r0 + r) * C + kTiledLaneCols * wc +
                                     2 * wq) = make_float2(acc[r][0], acc[r][1]);
        }
      }
      // into rows whose partial sums the previous step's gate stage read
      if (more) tiled_stage_store(wrows + cn * CR * SK, lane, v);
      __syncwarp();
    }
    // this step's inputs arrived; the next step's may be in flight
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const float* xin = gin + (t % 2) * kTiledStepIn * kChainThreads + tid;
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      if (live[i]) {
        const int r = gr + kChainThreads / U * i;
        // the warps' slices in order, whatever the schedule
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < kWarps; ++p) {
          const float4 pv =
              *reinterpret_cast<const float4*>(red + (p * kTiledRows + r) * C + 4 * gu);
          s[0] += pv.x;
          s[1] += pv.y;
          s[2] += pv.z;
          s[3] += pv.w;
        }
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[q] = xin[(4 * i + q) * kChainThreads] + s[q];
        float& c = carry[i * kChainThreads];
        float& hp = carry[(GR + i) * kChainThreads];
        float c_out, h_out;
        cell_update<Peephole>(gate, c, hp, xin[(4 * GR + i) * kChainThreads], p_i, p_f, p_o,
                              c_out, h_out);
        c = c_out;
        hp = h_out;
        const size_t e = (static_cast<size_t>(rb0 + r) * T + t) * H + j;
        out[e] = h_out;  // [carry] every row, padded or not
        if constexpr (EmitResiduals) {
          // gate[] holds the pre-activations before any peephole term
          cells[e] = c_out;
          float* gp = gates + (static_cast<size_t>(rb0 + r) * T + t) * H4 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) gp[static_cast<size_t>(q) * H] = gate[q];
        }
      }
    }
    // [order] [uniform] every block's out[:, t] before any block's next
    // product; it also orders this step's reads of the partial sums and
    // the gate inputs before the next step's writes
    grid.sync();
  }
  if (cell_last != nullptr) {
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      if (live[i]) {
        cell_last[static_cast<size_t>(rb0 + gr + kChainThreads / U * i) * H + j] =
            carry[i * kChainThreads];
      }
    }
  }
}

// The staged large-B body (header): float32 W_hid, kTiledUnits units by
// kTiledRows rows a block.  For the product, thread (kq, tr, tc) sums rows
// tr + 8 i (i < kStagedTileRows) by the gate columns of units tc and tc + 8
// over slice kq of every staged chunk of kStagedK values of k (kStagedSplit
// slices); for the gate stage, thread tid owns rows tid / 16 + 16 i (i <
// kTiledGateRows) of unit tid % 16.
constexpr int kStagedSplit = 4;
constexpr int kStagedTileRows = 8;
constexpr int kStagedK = 64;
constexpr int kStagedKPad = kStagedK + 4;
// values of a chunk each thread stages: rows r0 + kStagedRowStep * l (l <
// kStagedStage) at the thread's column tid % kStagedK
constexpr int kStagedStage = kTiledRows * kStagedK / kChainThreads;
constexpr int kStagedRowStep = kChainThreads / kStagedK;
static_assert(kStagedSplit * (kTiledRows / kStagedTileRows) * (kTiledCols / 8) == kChainThreads,
              "one product thread per k slice and 8 x 8 tile");
static_assert(kChainThreads % kStagedK == 0 && kStagedK % (4 * kStagedSplit) == 0,
              "a chunk is staged in whole rows and cut into slices of whole groups of 4 k");
// k rows of the block's W share: H padded to whole chunks (zero rows)
__host__ __device__ constexpr int staged_k_rows(int H) {
  return (H + kStagedK - 1) / kStagedK * kStagedK;
}
// W share, two staged chunks of h_{t-1}, the k slices' partial sums; H up
// to 512
__host__ __device__ constexpr size_t staged_smem_bytes(int H) {
  return (static_cast<size_t>(staged_k_rows(H)) * kTiledCols +
          static_cast<size_t>(2) * kTiledRows * kStagedKPad +
          static_cast<size_t>(kStagedSplit) * kTiledRows * kTiledCols) *
         sizeof(float);
}
// shared memory of the large-B body at width H
__host__ __device__ constexpr size_t tiled_smem_bytes(int H) {
  return tiled_resident(H) ? resident_smem_bytes() : staged_smem_bytes(H);
}

__device__ __forceinline__ void fma4(float* acc, float h, const float4& w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

// The thread's values of the chunk that starts at column k into registers:
// hr points at the thread's column of its first row, rows row_step apart,
// rows_live of them below B, and a column at or past h_live is past H; zero
// there.  [stale] h is written in this launch: L2 only.
__device__ __forceinline__ void staged_load(const float* hr, size_t row_step, int rows_live,
                                                 int k, int h_live, float (&v)[kStagedStage]) {
  const bool k_live = k < h_live;
#pragma unroll
  for (int l = 0; l < kStagedStage; ++l) {
    v[l] = l < rows_live && k_live ? __ldcg(hr + l * row_step + k) : 0.f;
  }
}

// The thread's staged values into a chunk buffer (kTiledRows, kStagedKPad):
// neighbouring threads on neighbouring columns.
__device__ __forceinline__ void staged_store(float* buf, const float (&v)[kStagedStage]) {
  const int tid = threadIdx.x;
  float* p = buf + tid / kStagedK * kStagedKPad + tid % kStagedK;
#pragma unroll
  for (int l = 0; l < kStagedStage; ++l) p[l * kStagedRowStep * kStagedKPad] = v[l];
}

// The whole recurrence in the large-B body; arguments as the kernel's
// (cell_last may be null; without Peephole the w_c* are unused; without
// EmitResiduals cells and gates are).  Block (blockIdx.x, blockIdx.y) owns
// units j0 = kTiledUnits blockIdx.x .. + kTiledUnits - 1 and rows rb0 =
// kTiledRows blockIdx.y .. + kTiledRows - 1.
template <bool EmitResiduals, bool Peephole>
__device__ __forceinline__ void staged_chain(
    const float* __restrict__ x_proj, const float* __restrict__ w_hid,
    const float* __restrict__ mask, const float* __restrict__ cell0,
    const float* __restrict__ hid0, float* out, float* __restrict__ cells,
    float* __restrict__ gates, float* __restrict__ cell_last, const float* __restrict__ w_ci,
    const float* __restrict__ w_cf, const float* __restrict__ w_co, int B, int T, int H) {
  constexpr int U = kTiledUnits;
  constexpr int C = kTiledCols;
  constexpr int TR = kStagedTileRows;
  constexpr int GR = kTiledGateRows;
  constexpr int KS = kStagedK / kStagedSplit;  // k of a chunk in one slice
  extern __shared__ float4 smem4[];
  const int KH = staged_k_rows(H);
  float* w_s = reinterpret_cast<float*>(smem4);  // (KH, C), row k: unit u's gates at 4 u
  float* h_s = w_s + static_cast<size_t>(KH) * C;  // (2, kTiledRows, kStagedKPad)
  float* red = h_s + 2 * kTiledRows * kStagedKPad;  // (kStagedSplit, kTiledRows, C)
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = blockIdx.x * U;
  const int rb0 = blockIdx.y * kTiledRows;
  const size_t H4 = static_cast<size_t>(4) * H;
  // product thread: a quarter warp (8 lanes, one phase of a 16-byte
  // shared-memory read) holds one tr and tc = 0 .. 7, so its h reads are
  // one address (a broadcast) and its W reads 128 contiguous bytes
  const int tc = lane % 8;
  const int tr = lane / 8 + 4 * (warp % 2);
  const int kq = warp / 2;
  // gate-stage thread: unit gu, rows gr + 16 i
  const int gu = tid % U;
  const int gr = tid / U;
  const int j = j0 + gu;

  // w_s[k, 4 u + q] = W_hid[k, q H + j0 + u], once per call; neighbouring
  // threads read neighbouring units of one gate.  [ragged] dead units and k
  // past H are 0.
  constexpr int kLoadW = 16;
  const int n_w = KH * C;
  for (int i0 = 0; i0 < n_w; i0 += kLoadW * kChainThreads) {
    float v[kLoadW];
#pragma unroll
    for (int l = 0; l < kLoadW; ++l) {
      const int i = i0 + l * kChainThreads + tid;
      const int k = i / C;
      const int u = i % U;
      v[l] = i < n_w && k < H && j0 + u < H
                 ? __ldg(w_hid + k * H4 + static_cast<size_t>(i / U % 4) * H + j0 + u)
                 : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kLoadW; ++l) {
      const int i = i0 + l * kChainThreads + tid;
      if (i < n_w) w_s[i / C * C + i % U * 4 + i / U % 4] = v[l];
    }
  }
  // the carries of the gate-stage thread's (row, unit) pairs, in registers
  // for the whole call; [ragged] [uniform] dead pairs are masked, no thread
  // returns
  bool live[GR];
  float c[GR], hp[GR];
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    const int b = rb0 + gr + kChainThreads / U * i;
    live[i] = b < B && j < H;
    const size_t e = static_cast<size_t>(b) * H + j;
    c[i] = live[i] ? __ldg(cell0 + e) : 0.f;
    hp[i] = live[i] ? __ldg(hid0 + e) : 0.f;
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
  const int n_chunks = (H + kStagedK - 1) / kStagedK;
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? hid0 : out + static_cast<size_t>(t - 1) * H;
    const size_t h_stride = t == 0 ? static_cast<size_t>(H) : static_cast<size_t>(T) * H;
    // the step's read-only inputs first, so that they overlap the product
    float xin[GR][4];
    float m[GR];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const size_t bt = static_cast<size_t>(rb0 + gr + kChainThreads / U * i) * T + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xin[i][q] = live[i] ? __ldg(x_proj + bt * H4 + static_cast<size_t>(q) * H + j) : 0.f;
      }
      m[i] = live[i] ? __ldg(mask + bt) : 0.f;
    }
    // the thread's staged rows rb0 + tid / kStagedK + kStagedRowStep * l, at
    // column tid % kStagedK of each chunk
    const int r0 = rb0 + tid / kStagedK;
    const float* hr = h + r0 * h_stride + tid % kStagedK;
    const size_t row_step = kStagedRowStep * h_stride;
    const int rows_live = (B - r0 + kStagedRowStep - 1) / kStagedRowStep;
    const int h_live = H - tid % kStagedK;
    // each unit group starts at its own chunk and takes the others in turn,
    // so that the blocks of a row group do not all read the same lines of h
    // at once; the order is fixed by the block, so two calls sum alike
    const int c0 = blockIdx.x % n_chunks;
    float sv[kStagedStage];
    staged_load(hr, row_step, rows_live, c0 * kStagedK, h_live, sv);
    staged_store(h_s, sv);
    __syncthreads();
    // acc[i][0..3]: row tr + 8 i, unit tc; acc[i][4..7]: unit tc + 8
    float acc[TR][8];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      // chunk cc is multiplied while the next one, cn, is in flight
      const int cc = (c0 + ch) % n_chunks;
      const int cn = (c0 + ch + 1) % n_chunks;
      const bool more = ch + 1 < n_chunks;
      if (more) staged_load(hr, row_step, rows_live, cn * kStagedK, h_live, sv);
      // the slice's groups of 4 k, each group's h fragments read while the
      // previous group is multiplied; past H both operands are zero
      const float* hrow = h_s + (ch % 2) * kTiledRows * kStagedKPad + tr * kStagedKPad + kq * KS;
      const float* wrow = w_s + static_cast<size_t>(cc * kStagedK + kq * KS) * C + 4 * tc;
      float4 hv[2][TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        hv[0][i] = *reinterpret_cast<const float4*>(hrow + 8 * i * kStagedKPad);
      }
#pragma unroll
      for (int g = 0; g < KS / 4; ++g) {
        if (g + 1 < KS / 4) {
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            hv[(g + 1) % 2][i] =
                *reinterpret_cast<const float4*>(hrow + 8 * i * kStagedKPad + 4 * (g + 1));
          }
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float* wr = wrow + (4 * g + d) * C;
          const float4 wa = *reinterpret_cast<const float4*>(wr);
          const float4 wb = *reinterpret_cast<const float4*>(wr + C / 2);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float4& hq = hv[g % 2][i];
            const float hk = d == 0 ? hq.x : d == 1 ? hq.y : d == 2 ? hq.z : hq.w;
            fma4(acc[i], hk, wa);
            fma4(acc[i] + 4, hk, wb);
          }
        }
      }
      // the other buffer was last read before the previous __syncthreads
      if (more) staged_store(h_s + ((ch + 1) % 2) * kTiledRows * kStagedKPad, sv);
      __syncthreads();
    }
    // the slices' partial sums, red[kq, row, col]
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float* rp = red + (static_cast<size_t>(kq) * kTiledRows + tr + 8 * i) * C + 4 * tc;
      *reinterpret_cast<float4*>(rp) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(rp + C / 2) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < GR; ++i) {
      if (live[i]) {
        const int r = gr + kChainThreads / U * i;
        // the slices in order, whatever the schedule
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < kStagedSplit; ++p) {
          const float4 v = *reinterpret_cast<const float4*>(
              red + (static_cast<size_t>(p) * kTiledRows + r) * C + 4 * gu);
          s[0] += v.x;
          s[1] += v.y;
          s[2] += v.z;
          s[3] += v.w;
        }
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[q] = xin[i][q] + s[q];
        float c_out, h_out;
        cell_update<Peephole>(gate, c[i], hp[i], m[i], p_i, p_f, p_o, c_out, h_out);
        c[i] = c_out;
        hp[i] = h_out;
        const size_t e = (static_cast<size_t>(rb0 + r) * T + t) * H + j;
        out[e] = h_out;  // [carry] every row, padded or not
        if constexpr (EmitResiduals) {
          // gate[] holds the pre-activations before any peephole term
          cells[e] = c_out;
          float* gp = gates + (static_cast<size_t>(rb0 + r) * T + t) * H4 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) gp[static_cast<size_t>(q) * H] = gate[q];
        }
      }
    }
    // [order] [uniform] every block's out[:, t] before any block's next
    // product; it also orders this step's reads of red before the next
    // step's writes
    grid.sync();
  }
  if (cell_last != nullptr) {
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      if (live[i]) {
        cell_last[static_cast<size_t>(rb0 + gr + kChainThreads / U * i) * H + j] = c[i];
      }
    }
  }
}

// The large-B body: the resident one where W_hid's share fills the registers
// (tiled_resident(H)), else the staged one.  [uniform] the same choice in
// every block.
template <bool EmitResiduals, bool Peephole>
__device__ __forceinline__ void tiled_chain(
    const float* __restrict__ x_proj, const float* __restrict__ w_hid,
    const float* __restrict__ mask, const float* __restrict__ cell0,
    const float* __restrict__ hid0, float* out, float* __restrict__ cells,
    float* __restrict__ gates, float* __restrict__ cell_last, const float* __restrict__ w_ci,
    const float* __restrict__ w_cf, const float* __restrict__ w_co, int B, int T, int H) {
  if (tiled_resident(H)) {
    resident_chain<EmitResiduals, Peephole>(x_proj, w_hid, mask, cell0, hid0, out, cells, gates,
                                            cell_last, w_ci, w_cf, w_co, B, T, H);
  } else {
    staged_chain<EmitResiduals, Peephole>(x_proj, w_hid, mask, cell0, hid0, out, cells, gates,
                                          cell_last, w_ci, w_cf, w_co, B, T, H);
  }
}

// The whole recurrence.  Shared memory as in the header.  cell0 and hid0 are
// (B, H); with EmitResiduals cells (B, T, H) and gates (B, T, 4H) receive the
// residuals, otherwise those pointers are unused; with Peephole w_ci, w_cf
// and w_co are the (H,) peephole vectors, otherwise unused.  cell_last (B, H),
// when not null, receives the cell carry after step T - 1 (the carried hidden
// state is out[:, T - 1]), so a caller can resume the recurrence from it.
// w_hid holds WT values (float or __nv_bfloat16).  With a bf16 W, h16 (2, B,
// KS * 16) bf16 holds the product's operand, h_{t-1} in slot t % 2 (header);
// unused in f32.
template <bool EmitResiduals, bool Peephole, int U, typename WT>
__global__ void __launch_bounds__(kChainThreads)
lstm_fwd_chain_kernel(const float* __restrict__ x_proj, const WT* __restrict__ w_hid,
                      const float* __restrict__ mask, const float* __restrict__ cell0,
                      const float* __restrict__ hid0,
                      float* out,  // [stale] written and read here: not const, not restrict
                      float* __restrict__ cells, float* __restrict__ gates,
                      float* __restrict__ cell_last, const float* __restrict__ w_ci,
                      const float* __restrict__ w_cf, const float* __restrict__ w_co, int B,
                      int T, int H,
                      unsigned short* h16) {  // [stale] as out
  constexpr bool kMma = sizeof(WT) == 2;  // bf16: the product on the tensor cores
  constexpr int C = 4 * U;       // the block's gate columns, col = gate * U + unit
  constexpr int CP = padded_columns(U);
  // rows of a warp tile, and tiles of a round
  constexpr int R = kMma ? kTile : kPairs / C;
  constexpr int RT = kMma ? mma_round_tiles(U) : kWarps;
  constexpr int KI = kMma ? 1 : kPairs / R;  // f32: k steps per batch of loads, R * KI = 32
  extern __shared__ float4 smem4[];
  const int BU = B * U;
  // W: f32 (H, CP), row k holding the C weights; bf16 in fragment order
  float* c_s;
  if constexpr (kMma) {
    c_s = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + mma_w_bytes(H, U));
  } else {
    c_s = reinterpret_cast<float*>(smem4) + CP * H;
  }
  float* h_s = c_s + BU;  // (B * U) each
  float* red = h_s + BU;  // f32 (kWarps, kPairs); bf16 (kWarps, kTile, C)
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  const size_t H4 = static_cast<size_t>(4) * H;

  constexpr int kLoadW = 16;
  if constexpr (kMma) {
    // word ((s * LW + l) * NT + j) * 2 + r = (W[k, col], W[k + 1, col]) for
    // k = 16 s + 4 (l % 4) + 2 r, col = 8 j + l / 4 = gate * U + unit, once
    // per call: item i is the pair k = 2 (i / C), column i % C, so that
    // neighbouring threads read neighbouring units of one gate; kLoadW items
    // in flight per thread.  [ragged] dead units and k past H are 0.
    constexpr int NT = mma_ntiles(U);
    constexpr int LW = mma_lanes(U);
    unsigned int* w_w = reinterpret_cast<unsigned int*>(smem4);
    const int n_items = mma_ksteps(H) * (kTile / 2) * C;
    for (int i0 = 0; i0 < n_items; i0 += kLoadW * kChainThreads) {
      float v[kLoadW][2];
#pragma unroll
      for (int l = 0; l < kLoadW; ++l) {
        const int i = i0 + l * kChainThreads + tid;
        const int k = i / C * 2;
        const int col = i % C;
        const int u = col % U;
        const bool live = i < n_items && u < nu;
        const WT* src = w_hid + k * H4 + static_cast<size_t>(col / U) * H + j0 + u;
        v[l][0] = live && k < H ? __bfloat162float(__ldg(src)) : 0.f;
        v[l][1] = live && k + 1 < H ? __bfloat162float(__ldg(src + H4)) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < kLoadW; ++l) {
        const int i = i0 + l * kChainThreads + tid;
        if (i < n_items) {
          // k = 16 s + 4 (lane % 4) + 2 r, col = 8 j + lane / 4
          const int k = i / C * 2;
          const int col = i % C;
          const int wl = col % 8 * 4 + k % kTile / 4;
          const int w = ((k / kTile * LW + wl) * NT + col / 8) * 2 + k % 4 / 2;
          w_w[w] = pack_bf16(v[l][0], v[l][1]);  // exact: bf16 values
        }
      }
    }
  } else {
    // w_s[k, col] = W_hid[k, gate * H + j0 + unit], once per call, kLoadW loads
    // in flight per thread; neighbouring threads read neighbouring units of
    // one gate.  [ragged] dead units are 0.
    float* w_s = reinterpret_cast<float*>(smem4);
    for (int i0 = 0; i0 < C * H; i0 += kLoadW * kChainThreads) {
      float v[kLoadW];
#pragma unroll
      for (int l = 0; l < kLoadW; ++l) {
        const int i = i0 + l * kChainThreads + tid;
        const int k = i / C;
        const int col = i % C;
        const int u = col % U;
        v[l] = i < C * H && u < nu
                   ? __ldg(w_hid + k * H4 + static_cast<size_t>(col / U) * H + j0 + u)
                   : 0.f;
      }
#pragma unroll
      for (int l = 0; l < kLoadW; ++l) {
        const int i = i0 + l * kChainThreads + tid;
        if (i < C * H) w_s[i / C * CP + i % C] = v[l];
      }
    }
  }
  for (int q = tid; q < BU; q += kChainThreads) {
    const int u = q % U;
    const size_t e = static_cast<size_t>(q / U) * H + j0 + u;
    c_s[q] = u < nu ? __ldg(cell0 + e) : 0.f;
    h_s[q] = u < nu ? __ldg(hid0 + e) : 0.f;
  }
  // the peephole weights of the gate-stage thread's unit, tid % U in every
  // round and step; [ragged] [uniform] a guard, not a return
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if constexpr (Peephole) {
    if (tid % U < nu) {
      p_i = __ldg(w_ci + j0 + tid % U);
      p_f = __ldg(w_cf + j0 + tid % U);
      p_o = __ldg(w_co + j0 + tid % U);
    }
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  if constexpr (kMma) {
    // slot 0 of the operand buffer: bf16(hid0) of the block's units, every
    // row; the last block zeroes the padding columns H .. KS * 16 - 1 of
    // both slots, which no step writes.  [order] [uniform] before any
    // block's first product.
    const int Kp = mma_ksteps(H) * kTile;
    __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(h16);
    for (int q = tid; q < BU; q += kChainThreads) {
      if (q % U < nu) {
        hb[static_cast<size_t>(q / U) * Kp + j0 + q % U] = __float2bfloat16_rn(h_s[q]);
      }
    }
    if (blockIdx.x == gridDim.x - 1) {
      for (int q = tid; q < 2 * B * (Kp - H); q += kChainThreads) {
        hb[static_cast<size_t>(q / (Kp - H)) * Kp + H + q % (Kp - H)] = __float2bfloat16_rn(0.f);
      }
    }
    grid.sync();
  }
  const int n_tiles = (B + R - 1) / R;
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? hid0 : out + static_cast<size_t>(t - 1) * H;
    const size_t h_stride = t == 0 ? static_cast<size_t>(H) : static_cast<size_t>(T) * H;
    for (int tile0 = 0; tile0 < n_tiles; tile0 += RT) {
      const int G = min(RT, n_tiles - tile0);  // tiles of this round
      const int rb0 = tile0 * R;
      // gate-stage thread: row rb0 + tid / U, unit tid % U of this round;
      // its read-only inputs are fetched first, so they overlap the product
      const int gr = tid / U;
      const int gu = tid % U;
      const int gb = rb0 + gr;
      const bool gate_live = gr < G * R && gb < B && gu < nu;  // [uniform] masks, no return
      float xin[4] = {0.f, 0.f, 0.f, 0.f};
      float m = 0.f;
      if (gate_live) {
        const float* xp = x_proj + (static_cast<size_t>(gb) * T + t) * H4 + j0 + gu;
#pragma unroll
        for (int q = 0; q < 4; ++q) xin[q] = __ldg(xp + static_cast<size_t>(q) * H);
        m = __ldg(mask + static_cast<size_t>(gb) * T + t);
      }

      // product: warp -> tile g of the round and slice ks of the ns warps on it
      const int g = warp % G;
      const int ks = warp / G;
      const int ns = (kWarps - 1 - g) / G + 1;
      const int b0 = rb0 + g * R;
      if constexpr (kMma) {
        mma_tile<U>(h16 + static_cast<size_t>(t % 2) * B * mma_ksteps(H) * kTile,
                    reinterpret_cast<const unsigned int*>(smem4), red + warp * R * C, b0, ks,
                    ns, B, H, lane);
      } else {
        const float* w_s = reinterpret_cast<const float*>(smem4);
        const int stride = 32 * ns;
        // [converge] warp-uniform trip counts; k >= H is masked inside
        const int steps = (H + stride - 1) / stride;
        float acc[kPairs];
#pragma unroll
        for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
        for (int s0 = 0; s0 < steps; s0 += KI) {
          float hv[KI][R];
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            const int k = (s0 + i) * stride + ks * 32 + lane;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              // [stale] h of this launch: L2 only, never __ldg or L1
              hv[i][r] = s0 + i < steps && k < H && b0 + r < B
                             ? __ldcg(h + (b0 + r) * h_stride + k) : 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            if (s0 + i >= steps) break;  // warp-uniform
            const int k = (s0 + i) * stride + ks * 32 + lane;
            // one address per k; past H, hv is 0 and row H - 1 stands in
            float w[C];
            load_row<C>(w_s + min(k, H - 1) * CP, w);
#pragma unroll
            for (int r = 0; r < R; ++r) {
#pragma unroll
              for (int c = 0; c < C; ++c) acc[r * C + c] = fmaf(hv[i][r], w[c], acc[r * C + c]);
            }
          }
        }
        transpose_level<16>(acc, lane);
        transpose_level<8>(acc, lane);
        transpose_level<4>(acc, lane);
        transpose_level<2>(acc, lane);
        transpose_level<1>(acc, lane);
        red[warp * kPairs + lane] = acc[0];
      }
      __syncthreads();

      if (gate_live) {
        // the partial sums of the warps on tile gt, in warp order
        const int gt = gr / R;
        const int pair = (gr % R) * C + gu;
        const int nsg = (kWarps - 1 - gt) / G + 1;
        float gate[4];
        if constexpr (kMma) {
          // unrolled, so that the up to 8 x 4 loads are in flight together
          float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int p = 0; p < kWarps; ++p) {
            if (p < nsg) {
#pragma unroll
              for (int q = 0; q < 4; ++q) s[q] += red[(p * G + gt) * (R * C) + pair + q * U];
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) gate[q] = xin[q] + s[q];
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float s = 0.f;
            for (int p = 0; p < nsg; ++p) s += red[(p * G + gt) * (R * C) + pair + q * U];
            gate[q] = xin[q] + s;
          }
        }
        const int q = gb * U + gu;
        float c_out, h_out;
        cell_update<Peephole>(gate, c_s[q], h_s[q], m, p_i, p_f, p_o, c_out, h_out);
        c_s[q] = c_out;
        h_s[q] = h_out;
        const size_t e = (static_cast<size_t>(gb) * T + t) * H + j0 + gu;
        out[e] = h_out;  // [carry] every row, padded or not
        if constexpr (kMma) {
          // the next step's operand, rounded to nearest even once here
          // rather than by each of the blocks that read it
          reinterpret_cast<__nv_bfloat16*>(h16)[(static_cast<size_t>((t + 1) % 2) * B + gb) *
                                                    mma_ksteps(H) * kTile + j0 + gu] =
              __float2bfloat16_rn(h_out);
        }
        if constexpr (EmitResiduals) {
          // gate[] holds the pre-activations before any peephole term
          cells[e] = c_out;
          float* gp = gates + (static_cast<size_t>(gb) * T + t) * H4 + j0 + gu;
#pragma unroll
          for (int k = 0; k < 4; ++k) gp[static_cast<size_t>(k) * H] = gate[k];
        }
      }
      // red is refilled by the next round; the last round's barrier is grid.sync
      if (tile0 + RT < n_tiles) __syncthreads();
    }
    // [order] [uniform] every block's out[:, t] before any block's next product
    grid.sync();
  }
  // the final cell carry of the block's units; the last grid.sync() ordered
  // every gate-stage write of c_s before these reads by other threads
  if (cell_last != nullptr) {
    for (int q = tid; q < BU; q += kChainThreads) {
      const int u = q % U;
      if (u < nu) cell_last[static_cast<size_t>(q / U) * H + j0 + u] = c_s[q];
    }
  }
}

// The large-B body's four instantiations: explicit specializations of the
// kernel at kTiledUnits units and a float32 W, so that a trace names them
// as it names every other (lstm_fwd_chain_kernel<EmitResiduals, Peephole,
// 16, float>), while the body above, the small-B one, is never instantiated
// at that width.
#define LSTM_FWD_TILED(E, P)                                                                    \
  template <>                                                                                  \
  __global__ void __launch_bounds__(kChainThreads) lstm_fwd_chain_kernel<E, P, kTiledUnits,    \
                                                                         float>(              \
      const float* __restrict__ x_proj, const float* __restrict__ w_hid,                       \
      const float* __restrict__ mask, const float* __restrict__ cell0,                         \
      const float* __restrict__ hid0, float* out, float* __restrict__ cells,                   \
      float* __restrict__ gates, float* __restrict__ cell_last, const float* __restrict__ w_ci, \
      const float* __restrict__ w_cf, const float* __restrict__ w_co, int B, int T, int H,     \
      unsigned short*) {                                                                       \
    tiled_chain<E, P>(x_proj, w_hid, mask, cell0, hid0, out, cells, gates, cell_last, w_ci,    \
                      w_cf, w_co, B, T, H);                                                    \
  }
LSTM_FWD_TILED(false, false)
LSTM_FWD_TILED(true, false)
LSTM_FWD_TILED(false, true)
LSTM_FWD_TILED(true, true)
#undef LSTM_FWD_TILED

template <typename WT>
size_t chain_smem_bytes(int B, int H, int U) {
  if constexpr (sizeof(WT) == 2) {
    return mma_w_bytes(H, U) + (static_cast<size_t>(2) * B * U + mma_red_floats(U)) * sizeof(float);
  }
  if (U == kTiledUnits) return tiled_smem_bytes(H);
  return static_cast<size_t>(padded_columns(U)) * H * sizeof(float) +
         (static_cast<size_t>(2) * B * U + kWarps * kPairs) * sizeof(float);
}

template <bool EmitResiduals, bool Peephole, int U, typename WT>
cudaError_t launch_chain(const float* x_proj, const WT* w_hid, const float* mask,
                         const float* cell0, const float* hid0, float* out, float* cells,
                         float* gates, float* cell_last, const float* w_ci, const float* w_cf,
                         const float* w_co, int B, int T, int H, unsigned short* h16,
                         size_t smem, cudaStream_t stream) {
  const auto kernel = lstm_fwd_chain_kernel<EmitResiduals, Peephole, U, WT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&x_proj, &w_hid, &mask, &cell0, &hid0, &out, &cells,
                  &gates, &cell_last, &w_ci, &w_cf, &w_co, &B, &T, &H, &h16};
  // the large-B body's row groups on y
  const dim3 grid((H + U - 1) / U, U == kTiledUnits ? (B + kTiledRows - 1) / kTiledRows : 1);
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                     dim3(kChainThreads), args, smem, stream);
}

// Runs the whole recurrence of one instantiation on `stream`; see the entry
// points.  cells and gates are null without EmitResiduals, `peep` (w_ci,
// w_cf, w_co) is null without Peephole, cell_last may be null, scratch is
// null for an f32 W.
template <bool EmitResiduals, bool Peephole, typename WT>
int run_chain_w(const void* x_proj, const void* w_hid, const void* mask, const void* cell0,
                const void* hid0, void* out, void* cells, void* gates, void* cell_last,
                const void* const* peep, void* scratch, int B, int T, int H, int units,
                size_t smem, void* stream) {
  if (smem < chain_smem_bytes<WT>(B, H, units)) return static_cast<int>(cudaErrorInvalidValue);
  // the resident large-B body reads h_{t-1} (hid0, then out) in float4 pieces
  if (sizeof(WT) == 4 && units == kTiledUnits && tiled_resident(H) &&
      (reinterpret_cast<size_t>(hid0) | reinterpret_cast<size_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the bf16 product reads its operand buffer 8 bytes at a time
  if (sizeof(WT) == 2 && (scratch == nullptr || reinterpret_cast<size_t>(scratch) % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const void* p[3] = {nullptr, nullptr, nullptr};
  if constexpr (Peephole) {
    for (int k = 0; k < 3; ++k) p[k] = peep[k];
  }
  const auto go = [&](auto launcher) {
    return launcher(f(x_proj), static_cast<const WT*>(w_hid), f(mask), f(cell0), f(hid0),
                    static_cast<float*>(out),
                    static_cast<float*>(cells), static_cast<float*>(gates),
                    static_cast<float*>(cell_last), f(p[0]), f(p[1]), f(p[2]), B, T, H,
                    static_cast<unsigned short*>(scratch), smem,
                    static_cast<cudaStream_t>(stream));
  };
  cudaError_t err;
  switch (units) {
    case 1: err = go(launch_chain<EmitResiduals, Peephole, 1, WT>); break;
    case 2: err = go(launch_chain<EmitResiduals, Peephole, 2, WT>); break;
    case 4: err = go(launch_chain<EmitResiduals, Peephole, 4, WT>); break;
    case 8: err = go(launch_chain<EmitResiduals, Peephole, 8, WT>); break;
    case kTiledUnits:
      // the large-B body: float32 W only
      if constexpr (sizeof(WT) == 4) {
        err = go(launch_chain<EmitResiduals, Peephole, kTiledUnits, WT>);
      } else {
        err = cudaErrorInvalidValue;
      }
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// run_chain_w with W of type __nv_bfloat16 when w_bf16, else float.
template <bool EmitResiduals, bool Peephole>
int run_chain(const void* x_proj, const void* w_hid, const void* mask, const void* cell0,
              const void* hid0, void* out, void* cells, void* gates, void* cell_last,
              const void* const* peep, void* scratch, int w_bf16, int B, int T, int H,
              int units, size_t smem, void* stream) {
  return w_bf16 ? run_chain_w<EmitResiduals, Peephole, __nv_bfloat16>(
                      x_proj, w_hid, mask, cell0, hid0, out, cells, gates, cell_last, peep,
                      scratch, B, T, H, units, smem, stream)
                : run_chain_w<EmitResiduals, Peephole, float>(
                      x_proj, w_hid, mask, cell0, hid0, out, cells, gates, cell_last, peep,
                      nullptr, B, T, H, units, smem, stream);
}

}  // namespace

// Runs all T steps on `stream` in one cooperative launch of ceil(H / units)
// blocks, units in {1, 2, 4, 8}, or with an f32 w_hid 16 (the large-B body,
// ceil(H / 16) x ceil(B / 64) blocks), with `smem` bytes of dynamic shared
// memory (at least chain_smem_bytes<W>(B, H, units): f32 4
// padded_columns(units) H + 8 B units + 1024, at 16 units tiled_smem_bytes(H);
// bf16 128 units ceil(H / 16) + 8 B units + 2048 units).  w_hid is (H, 4H)
// bf16 when w_bf16 is not 0, else f32; every other tensor is f32.  cell0 and
// hid0 (B, H) are the initial state; writes out (B, T, H) and, when
// cell_last is not null, the final cell (B, H).  With a bf16 w_hid, scratch
// is 2 B 16 ceil(H / 16) bf16 values of device memory, 8-byte aligned, for
// the product's operand (the header's h16; its contents need no setting);
// ignored (may be null) with an f32 w_hid.  Returns the first CUDA error (0
// on success; cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident; cudaErrorMisalignedAddress when the resident large-B body,
// tiled_resident(H) at 16 units, gets a hid0 or out off 16 bytes).
extern "C" int lstm_fwd_forward(const void* x_proj, const void* w_hid, const void* mask,
                                const void* cell0, const void* hid0, void* out, void* cell_last,
                                void* scratch, int w_bf16, int B, int T, int H, int units,
                                size_t smem, void* stream) {
  return run_chain<false, false>(x_proj, w_hid, mask, cell0, hid0, out, nullptr, nullptr,
                                 cell_last, nullptr, scratch, w_bf16, B, T, H, units, smem,
                                 stream);
}

// The training forward: as lstm_fwd_forward, and also writes the residuals
// cells (B, T, H) and gates (B, T, 4H).
extern "C" int lstm_fwd_train_forward(const void* x_proj, const void* w_hid, const void* mask,
                                      const void* cell0, const void* hid0, void* out,
                                      void* cells, void* gates, void* scratch, int w_bf16, int B,
                                      int T, int H, int units, size_t smem, void* stream) {
  return run_chain<true, false>(x_proj, w_hid, mask, cell0, hid0, out, cells, gates, nullptr,
                                nullptr, scratch, w_bf16, B, T, H, units, smem, stream);
}

// The peephole recurrence: as lstm_fwd_forward (cell_last included), with
// the (H,) peephole vectors w_ci, w_cf and w_co.
extern "C" int lstm_fwd_peep_forward(const void* x_proj, const void* w_hid, const void* mask,
                                     const void* cell0, const void* hid0, void* out,
                                     void* cell_last, const void* w_ci, const void* w_cf,
                                     const void* w_co, void* scratch, int w_bf16, int B, int T,
                                     int H, int units, size_t smem, void* stream) {
  const void* peep[3] = {w_ci, w_cf, w_co};
  return run_chain<false, true>(x_proj, w_hid, mask, cell0, hid0, out, nullptr, nullptr,
                                cell_last, peep, scratch, w_bf16, B, T, H, units, smem, stream);
}

// The peephole training forward: as lstm_fwd_peep_forward, and also writes
// the residuals cells (B, T, H) and gates (B, T, 4H), the gates before the
// peephole terms.
extern "C" int lstm_fwd_peep_train_forward(const void* x_proj, const void* w_hid,
                                           const void* mask, const void* cell0,
                                           const void* hid0, void* out, void* cells,
                                           void* gates, const void* w_ci, const void* w_cf,
                                           const void* w_co, void* scratch, int w_bf16, int B,
                                           int T, int H, int units, size_t smem, void* stream) {
  const void* peep[3] = {w_ci, w_cf, w_co};
  return run_chain<true, true>(x_proj, w_hid, mask, cell0, hid0, out, cells, gates, nullptr,
                               peep, scratch, w_bf16, B, T, H, units, smem, stream);
}

extern "C" const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
