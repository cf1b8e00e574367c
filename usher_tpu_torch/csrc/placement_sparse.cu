// Sparse placement scoring kernels for Hopper (sm_90a), bound through ctypes
// by usher_tpu_torch/ops/placement_sparse.py.
//
// Both kernels score every node n of the flat MAT against every sample b of a
// batch from the sample's K entry slots only (the decomposition derived in
// usher_tpu/ops/placement_pallas.py):
//
//   score[n,b] = base[n]    + sum_k corr(n, b, k)
//   nc[n,b]    = nc_base[n] + sum_k corr_nc(n, b, k)
//
// where base/nc_base are per-node row reductions the caller computes, and the
// corrections read st/stp of node n at column pos[b,k] only.
//
// B1 usher_score_entries_T replaces usher_tpu/ops/placement_pallas.py::_kernel
//    (reached through _score_entries_T): it writes the node-major [N, B]
//    score and num_common matrices.
// B1-spr is B1 with spr = 1: the SPR semantics of the `sub` term
//    (usher_tpu/ops/placement_pallas.py::_corr_tiles with spr=True), run
//    over a batch's column subset.  It replaces
//    usher_tpu/ops/placement_pallas.py::score_cols_T, which reaches the
//    Pallas kernel through _score_entries_T(spr=...); the BigMAT column
//    path (usher_tpu_torch/core/bigmat.py::_score_chunk) calls it with the
//    pointer-doubled [N, C] column states as st/stp.  What bounds it is the
//    same as for B1: reading the N x C packed bytes of st and stp once.
// B1-3d usher_score_entries_3d replaces
//    usher_tpu/ops/placement_pallas.py::_score_entries_3d: B1 (or B1-spr)
//    with the two outputs left in sample-tile-major tiles [bt, n_pad, tb],
//    score3[b / tb][n][b % tb], so that a consumer walking one sample tile
//    reads a contiguous [n_pad, tb] slab.  It is the same kernel with the
//    kTiled output addressing; its bound is B1's, as it moves the same bytes
//    and does the same integer work.
// mesh B1 (usher_tpu/parallel/mesh.py::sharded_sparse_score_fn, B1 under a
//    shard_map) is B1 launched once per (data, model) shard on the shard's
//    own device and stream, by usher_tpu_torch/parallel/mesh.py.  Every
//    launcher therefore takes the device ordinal, makes it current for the
//    launch (the shared-memory attribute holds per device, and a stream
//    belongs to one device) and restores the caller's device.
// B2 usher_placement_partials replaces
//    usher_tpu/ops/placement_pallas.py::_kernel_reduce (reached through
//    placement_step_sparse): it adds placement validity and a per-node-block
//    partial tie-break, writing only [n_blocks, B] partials that the caller
//    merges exactly.
//
// What bounds them on an H100.  Each block stages `rows` node rows of st and
// stp once, packed to one byte per column (st | stp << 4), in shared memory
// with 16-byte coalesced loads; every (node, sample, slot) triple then costs
// one shared-memory byte lookup, one cached 4-byte slot-word load and ~20
// integer operations.  At a wide position axis (tens of thousands of columns)
// and a small batch the kernels are bound by reading st and stp from device
// memory (2 bytes per node and column, once per call); at a narrow axis and a
// large batch they are bound by the integer work of the N*B*K triples.  The
// TPU kernel's one-hot bf16 matmul gather and block-diagonal segment-sum
// matmul are not carried over: Hopper loads st[n, pos] directly and sums the
// K slots in registers.
//
// Slot word (built by placement_sparse.py::_slot_words), one per (k, b),
// stored k-major so that neighbouring threads (neighbouring b) read
// neighbouring words:
//   bits  0..21  position (0 when the slot is padding)
//   bits 22..25  sample allele mask gval
//   bit  26      kmiss (entry is missing, N)
//   bit  27      kvalid (slot holds an entry; padding slots are skipped)
//   bits 28..31  reference nibble at the position
//
// st and stp hold nibbles (values 0..15), which the byte packing relies on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 1 << 30;

// Stage rows [n0, n0 + rows) of st/stp into sm as packed bytes st | stp << 4,
// one row every `pitch` bytes.  Rows past N are zero-filled.
__device__ void stage_rows(uint8_t* __restrict__ sm,
                           const uint8_t* __restrict__ st,
                           const uint8_t* __restrict__ stp,
                           long long n0, int rows, long long N, int P,
                           int pitch, bool vec) {
  if (vec) {
    // P % 16 == 0 and both bases 16-byte aligned: whole uint4 per thread.
    const int per_row = P >> 4;
    const int total = rows * per_row;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      const long long n = n0 + r;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) {
        const size_t off = (size_t)n * P + ((size_t)c << 4);
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(st + off));
        const uint4 p = __ldg(reinterpret_cast<const uint4*>(stp + off));
        // every byte is <= 0x0F, so a word-wide shift moves each byte's
        // nibble into its own high nibble without carrying across bytes
        out.x = a.x | (p.x << 4);
        out.y = a.y | (p.y << 4);
        out.z = a.z | (p.z << 4);
        out.w = a.w | (p.w << 4);
      }
      *reinterpret_cast<uint4*>(sm + (size_t)r * pitch + ((size_t)c << 4)) = out;
    }
  } else {
    const int total = rows * P;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / P;
      const int c = i - r * P;
      const long long n = n0 + r;
      uint8_t v = 0;
      if (n < N) {
        const size_t off = (size_t)n * P + c;
        v = (uint8_t)(st[off] | (stp[off] << 4));
      }
      sm[(size_t)r * pitch + c] = v;
    }
  }
}

// Sum of the K slot corrections of sample b against one packed node row
// (the correction terms of placement_pallas.py::_corr_tiles; kSpr selects
// the SPR base semantics of the `sub` term).
template <bool kSpr>
__device__ __forceinline__ void entry_sums(const uint8_t* __restrict__ row,
                                           const uint32_t* __restrict__ slots,
                                           int b, int B, int K,
                                           int& cs, int& ns) {
  int c = 0, n = 0;
  for (int k = 0; k < K; ++k) {
    const uint32_t w = __ldg(slots + (size_t)k * B + b);
    if (!((w >> 27) & 1u)) continue;
    const uint32_t v = row[w & 0x3FFFFFu];
    const uint32_t s = v & 0xFu;
    const uint32_t sp = v >> 4;
    const uint32_t gv = (w >> 22) & 0xFu;
    const uint32_t km = (w >> 26) & 1u;
    const uint32_t rk = w >> 28;
    const bool bm = s != sp;
    const bool matched = (gv & s) != 0u;
    const bool matched_r = (rk & s) != 0u;
    const uint32_t a = (bm && !matched) ? sp : s;
    const int term1 = (!km && (gv & a) == 0u) ? 1 : 0;
    // what this column contributed to base[n] (the g == ref term): the
    // placement no-entry term A_r != ref, or in SPR mode the
    // E=1-everywhere term (ref & A_r) == 0
    const uint32_t a_r = (bm && !matched_r) ? sp : s;
    const int sub = kSpr ? (int)((rk & a_r) == 0u) : (int)(a_r != rk);
    c += term1 - sub;
    n += (int)(bm && matched) - (int)(bm && matched_r);
  }
  cs = c;
  ns = n;
}

// B1 (kSpr false) and B1-spr (kSpr true): one block per `rows` node rows;
// work items (row, b) with b fastest so that slot-word loads and output
// stores coalesce over b.  kTiled (B1-3d) writes element (n, b) of the
// outputs at [b / tb][n][b % tb] of [bt, n_pad, tb] buffers instead of
// [n][b] of [N, B]; rows >= N and samples >= B of a tile are not written.
template <bool kSpr, bool kTiled>
__global__ void __launch_bounds__(kThreads)
score_entries_kernel(const uint8_t* __restrict__ st,
                     const uint8_t* __restrict__ stp,
                     const int32_t* __restrict__ base,
                     const int32_t* __restrict__ nc_base,
                     const uint32_t* __restrict__ slots,
                     long long N, int P, int pitch, int B, int K, int rows,
                     bool vec, int tb, long long n_pad,
                     int32_t* __restrict__ score_t,
                     int32_t* __restrict__ nc_t) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem_raw);
  const long long n0 = (long long)blockIdx.x * rows;
  stage_rows(sm, st, stp, n0, rows, N, P, pitch, vec);
  __syncthreads();
  const int nrows = (int)min((long long)rows, N - n0);
  const long long items = (long long)nrows * B;
  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const int r = (int)(i / B);
    const int b = (int)(i - (long long)r * B);
    int cs, ns;
    entry_sums<kSpr>(sm + (size_t)r * pitch, slots, b, B, K, cs, ns);
    const long long n = n0 + r;
    size_t o;
    if constexpr (kTiled) {
      o = ((size_t)(b / tb) * (size_t)n_pad + (size_t)n) * tb + b % tb;
    } else {
      o = (size_t)n * B + b;
    }
    score_t[o] = base[n] + cs;
    nc_t[o] = nc_base[n] + ns;
  }
}

// B2: one block per `rows` node rows; each thread owns samples b and walks
// the block's rows in order, folding every valid (node, b) into the partial
// (best, cnt, p1, p2) of placement_pallas.py::_kernel_reduce:
//   best  min valid score            cnt  rows at best
//   p1    max leaves among best      p2   max (rank*2 | has_unique) among
//                                         best rows with leaves == p1
// nodemeta is [N, 4] int32: num_leaves, bfs_rank, node_num_mut,
// flags = active | is_leaf << 1 | is_root << 2.
__global__ void __launch_bounds__(kThreads)
placement_partials_kernel(const uint8_t* __restrict__ st,
                          const uint8_t* __restrict__ stp,
                          const int32_t* __restrict__ base,
                          const int32_t* __restrict__ nc_base,
                          const int4* __restrict__ nodemeta,
                          const uint32_t* __restrict__ slots,
                          long long N, int P, int pitch, int B, int K,
                          int rows, bool vec, int32_t* __restrict__ pbest,
                          int32_t* __restrict__ pcnt, int32_t* __restrict__ p1,
                          int32_t* __restrict__ p2) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem_raw);
  const long long n0 = (long long)blockIdx.x * rows;
  stage_rows(sm, st, stp, n0, rows, N, P, pitch, vec);
  __syncthreads();
  const int nrows = (int)min((long long)rows, N - n0);
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int best = kBig, cnt = 0, q1 = -1, q2 = -1;
    for (int r = 0; r < nrows; ++r) {
      const long long n = n0 + r;
      const int4 m = __ldg(nodemeta + n);
      const int flags = m.w;
      if (!(flags & 1)) continue;  // inactive rows are never valid
      int cs, ns;
      entry_sums<false>(sm + (size_t)r * pitch, slots, b, B, K, cs, ns);
      const int score = base[n] + cs;
      const int nc = nc_base[n] + ns;
      const bool leaf = (flags >> 1) & 1;
      const bool root = (flags >> 2) & 1;
      const bool hu = nc < m.z;
      const bool nc_pos = nc > 0;
      const bool valid = root || (leaf && nc_pos) || (!leaf && hu && nc_pos) ||
                         (!leaf && !hu);
      if (!valid) continue;
      const int rank2 = m.y * 2 + (hu ? 1 : 0);
      if (score < best) {
        best = score;
        cnt = 1;
        q1 = m.x;
        q2 = rank2;
      } else if (score == best) {
        ++cnt;
        if (m.x > q1) {
          q1 = m.x;
          q2 = rank2;
        } else if (m.x == q1 && rank2 > q2) {
          q2 = rank2;
        }
      }
    }
    const size_t o = (size_t)blockIdx.x * B + b;
    pbest[o] = best;
    pcnt[o] = cnt;
    p1[o] = q1;
    p2[o] = q2;
  }
}

bool use_vec(const void* st, const void* stp, int P) {
  return (P % 16) == 0 && (reinterpret_cast<uintptr_t>(st) & 15u) == 0 &&
         (reinterpret_cast<uintptr_t>(stp) & 15u) == 0;
}

int pitch_of(int P) { return (P + 15) & ~15; }

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Makes `device` the current CUDA device for the lifetime of the guard and
// restores the previous one: cudaFuncSetAttribute applies to the current
// device, and a launch must go to the device that owns its stream.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

template <bool kSpr, bool kTiled>
cudaError_t launch_score_entries(const void* st, const void* stp,
                                 const void* base, const void* nc_base,
                                 const void* slots, long long N, int P, int B,
                                 int K, int rows, int tb, long long n_pad,
                                 void* score_t, void* nc_t, int device,
                                 cudaStream_t stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const int pitch = pitch_of(P);
  const size_t smem = (size_t)rows * pitch;
  cudaError_t err = set_smem(score_entries_kernel<kSpr, kTiled>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (N + rows - 1) / rows;
  score_entries_kernel<kSpr, kTiled>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          (const uint8_t*)st, (const uint8_t*)stp, (const int32_t*)base,
          (const int32_t*)nc_base, (const uint32_t*)slots, N, P, pitch, B, K,
          rows, use_vec(st, stp, P), tb, n_pad, (int32_t*)score_t,
          (int32_t*)nc_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 on success) and never
// synchronises.  `device` is the ordinal of the device that holds the tensors
// and owns `stream`; spr != 0 selects B1-spr (the SPR `sub` term).
int usher_score_entries_T(const void* st, const void* stp, const void* base,
                          const void* nc_base, const void* slots, long long N,
                          int P, int B, int K, int rows, int spr,
                          void* score_t, void* nc_t, int device,
                          void* stream) {
  if (N <= 0 || B <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(spr ? launch_score_entries<true, false>(
                         st, stp, base, nc_base, slots, N, P, B, K, rows, 0, 0,
                         score_t, nc_t, device, s)
                   : launch_score_entries<false, false>(
                         st, stp, base, nc_base, slots, N, P, B, K, rows, 0, 0,
                         score_t, nc_t, device, s));
}

// B1-3d: score3/nc3 are [ceil(B / tb), n_pad, tb] int32 with n_pad >= N.
int usher_score_entries_3d(const void* st, const void* stp, const void* base,
                           const void* nc_base, const void* slots, long long N,
                           int P, int B, int K, int rows, int spr, int tb,
                           long long n_pad, void* score3, void* nc3,
                           int device, void* stream) {
  if (N <= 0 || B <= 0) return (int)cudaSuccess;
  if (tb <= 0 || n_pad < N) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(spr ? launch_score_entries<true, true>(
                         st, stp, base, nc_base, slots, N, P, B, K, rows, tb,
                         n_pad, score3, nc3, device, s)
                   : launch_score_entries<false, true>(
                         st, stp, base, nc_base, slots, N, P, B, K, rows, tb,
                         n_pad, score3, nc3, device, s));
}

int usher_placement_partials(const void* st, const void* stp, const void* base,
                             const void* nc_base, const void* nodemeta,
                             const void* slots, long long N, int P, int B,
                             int K, int rows, void* pbest, void* pcnt, void* p1,
                             void* p2, int device, void* stream) {
  if (N <= 0 || B <= 0) return (int)cudaSuccess;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const int pitch = pitch_of(P);
  const size_t smem = (size_t)rows * pitch;
  cudaError_t err = set_smem(placement_partials_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + rows - 1) / rows;
  placement_partials_kernel<<<(unsigned)blocks, kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)st, (const uint8_t*)stp, (const int32_t*)base,
      (const int32_t*)nc_base, (const int4*)nodemeta, (const uint32_t*)slots, N,
      P, pitch, B, K, rows, use_vec(st, stp, P), (int32_t*)pbest,
      (int32_t*)pcnt, (int32_t*)p1, (int32_t*)p2);
  return (int)cudaGetLastError();
}

const char* usher_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
