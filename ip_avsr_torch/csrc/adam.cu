// Multi-tensor Adam for Hopper: one launch updates every f32 leaf of a
// parameter tree, out of place,
//     m' = b1 m + (1 - b1) g
//     v' = b2 v + ((1 - b2) g) g
//     p' = p - (s m') / (sqrt(v') + eps)
// with s the leaf's step size: its factor times a 0-d device scalar (Adam's
// a_t with factor 1, or adam_vlr's correction times the leaf's rate).
//
// Replaces no TPU kernel.  The JAX package's Adam
// (ip_avsr_tpu/train/optimizers.py::adam) is three tree_maps of jnp
// operations that XLA fuses; PyTorch runs the same tree_maps eagerly, 12
// kernels a leaf (3 for m, 4 for v, 5 for p), each reading and writing whole
// leaves: 524 launches a step over the flagship's 43 leaves, 848 over the
// 4-stream model's 70, hundreds of them on leaves of 1 to 500 values.
//
// What bounds it on the H100: bytes.  Each value reads p, g, m and v and
// writes p', m' and v', 7 x 4 bytes and 9 float32 operations (one a
// division, one a square root): 488 MB and 0.146 ms at 3.35 TB/s for the
// flagship's 17.4M values, 345 MB and 0.103 ms for the 4-stream model's.
//
// What the design does about it:
// - One launch for the whole tree.  The leaf table (seven pointers, the
//   value count, a start in one flat index space over all leaves, the step
//   factor, 80 bytes a leaf) goes by value in the launch's parameters, a
//   __grid_constant__ that the blocks read in place: no upload a step.  The
//   table holds 384 leaves, 30.7 KB, within the 32,764 bytes of kernel
//   parameters that CUDA 12.1+ takes (toolkit and driver; the build refuses
//   an older toolkit and the wrapper an older driver).  The table's size
//   costs nothing measurable (on the H100 the flagship's 43 leaves took
//   0.1667 ms in a 3.9 KB table and 0.1666 ms in this one).  The wrapper
//   splits a larger tree into launches of a table each.
// - Equal chunks across leaves.  The leaves lie back to back in the flat
//   index space, each starting at a multiple of 4; block b updates the
//   values [b chunk, (b + 1) chunk) of it, whichever leaves they belong to
//   (a binary search over the table finds the first).  A 1-value leaf shares
//   a block with its neighbours; a 9M-value leaf is spread over thousands.
//   A block walks its leaves one after another, a memory round trip each,
//   so many tiny leaves in a row lengthen the last block to finish (86
//   one-value leaves at the flagship tree's end added 0.07 ms): the trees
//   here hold at most 4 in a row.
//   With the wrapper's 1,024 values a block, the flagship's tree is 17,025
//   blocks of 256 threads, the 4-stream model's 12,048: short blocks, so
//   the last wave leaves few SMs idle (4,096 values a block took 3-5%
//   longer on the H100, 16,384 8-11%).
// - 16-byte loads and stores where a leaf's seven pointers are all 16-byte
//   aligned (a chunk starts at a multiple of 4 in every leaf), scalar ones
//   elsewhere and for a leaf's last 1-3 values.  A thread's float4 of each
//   of p, g, m and v are in flight together, 64 bytes, and an SM holds 2,048
//   threads: 128 KB in flight an SM, enough to stream at the card's rate.
//
// Numerics: bit for bit PyTorch's eager ops (the plain version,
// ip_avsr_torch/ops/kernels/adam.plain), which round each operation
// to float32 and never contract into an FMA.  So every operation is written
// with its round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), which the compiler never merges, whatever the
// flags; the constants are the wrapper's float32 roundings of the doubles
// (b1, 1 - b1, b2, 1 - b2, eps), as PyTorch rounds a Python scalar.
#include <cuda_runtime.h>

#include <cstring>

static_assert(CUDART_VERSION >= 12010,
              "adam.cu passes a 30.7 KB table of kernel parameters: CUDA 12.1 or later");

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kLeaves = 384;   // leaves of a table: 30.7 KB, under the 32,764 bytes of CUDA 12.1+

struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  long long start;  // first value in the launch's flat index space, a multiple of 4
  long long n;      // values, at least 1
  float factor;     // s = factor * step
  int vector;       // 1: all seven pointers 16-byte aligned
};
static_assert(sizeof(Leaf) == 80, "the wrapper packs 10 words a leaf");

struct Table {
  Leaf leaf[kLeaves];
};

struct Consts {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_value(float p, float g, float m, float v, float s,
                                           const Consts& c, float& p_out, float& m_out,
                                           float& v_out) {
  m_out = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v_out = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  p_out = __fsub_rn(p, __fdiv_rn(__fmul_rn(s, m_out), __fadd_rn(__fsqrt_rn(v_out), c.eps)));
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const __grid_constant__ Table table, const int n_leaves,
                      const long long chunk, const float* __restrict__ step, const Consts c) {
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = lo + chunk;
  // the first leaf that ends after lo (uniform across the block)
  int k = 0;
  for (int top = n_leaves - 1; k < top;) {
    const int mid = (k + top) / 2;
    if (table.leaf[mid].start + table.leaf[mid].n <= lo) {
      k = mid + 1;
    } else {
      top = mid;
    }
  }
  const float st = *step;
  for (; k < n_leaves && table.leaf[k].start < hi; ++k) {
    const Leaf& L = table.leaf[k];
    const long long first = (lo > L.start ? lo : L.start) - L.start;
    const long long end = (hi < L.start + L.n ? hi : L.start + L.n) - L.start;
    const float s = __fmul_rn(L.factor, st);
    long long rest = first;
    if (L.vector) {
      const long long quads = (end - first) / 4;
      for (long long q = threadIdx.x; q < quads; q += kThreads) {
        const long long i = first + 4 * q;
        const float4 p = *reinterpret_cast<const float4*>(L.p + i);
        const float4 g = *reinterpret_cast<const float4*>(L.g + i);
        const float4 m = *reinterpret_cast<const float4*>(L.m + i);
        const float4 v = *reinterpret_cast<const float4*>(L.v + i);
        float4 po, mo, vo;
        adam_value(p.x, g.x, m.x, v.x, s, c, po.x, mo.x, vo.x);
        adam_value(p.y, g.y, m.y, v.y, s, c, po.y, mo.y, vo.y);
        adam_value(p.z, g.z, m.z, v.z, s, c, po.z, mo.z, vo.z);
        adam_value(p.w, g.w, m.w, v.w, s, c, po.w, mo.w, vo.w);
        *reinterpret_cast<float4*>(L.p_out + i) = po;
        *reinterpret_cast<float4*>(L.m_out + i) = mo;
        *reinterpret_cast<float4*>(L.v_out + i) = vo;
      }
      rest = first + 4 * quads;
    }
    for (long long i = rest + threadIdx.x; i < end; i += kThreads) {
      adam_value(L.p[i], L.g[i], L.m[i], L.v[i], s, c, L.p_out[i], L.m_out[i], L.v_out[i]);
    }
  }
}

}  // namespace

// The CUDA driver's version (12010 for 12.1), 0 where it cannot be read: the
// wrapper refuses a driver older than 12.1, which would refuse the table.
extern "C" int adam_driver_version() {
  int version = 0;
  return cudaDriverGetVersion(&version) == cudaSuccess ? version : 0;
}

// One launch over the n leaves of `leaves` (the wrapper's table, 80 bytes a
// leaf, in order of start), `blocks` blocks of `chunk` values each.  Returns
// the blocks launched, or minus a CUDA error code (a refused table, or
// cudaGetLastError() after the launch).
extern "C" int adam_multi_update(const void* leaves, int n, long long chunk, int blocks,
                                 const void* step, float b1, float omb1, float b2, float omb2,
                                 float eps, void* stream) {
  const Leaf* in = static_cast<const Leaf*>(leaves);
  if (n < 1 || n > kLeaves || chunk < 4 || chunk % 4 != 0 || blocks < 1 ||
      static_cast<long long>(blocks) * chunk < in[n - 1].start + in[n - 1].n) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < n; ++k) {
    const Leaf& L = in[k];
    if (L.n < 1 || L.start % 4 != 0 || (k > 0 && L.start < in[k - 1].start + in[k - 1].n)) {
      return -static_cast<int>(cudaErrorInvalidValue);
    }
    if (L.vector) {
      const void* ptrs[7] = {L.p, L.g, L.m, L.v, L.p_out, L.m_out, L.v_out};
      for (const void* ptr : ptrs) {
        if (reinterpret_cast<unsigned long long>(ptr) % 16 != 0) {
          return -static_cast<int>(cudaErrorMisalignedAddress);
        }
      }
    }
  }
  const Consts c{b1, omb1, b2, omb2, eps};
  Table table{};
  std::memcpy(table.leaf, in, sizeof(Leaf) * n);
  adam_multi_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n, chunk, static_cast<const float*>(step), c);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

extern "C" const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
