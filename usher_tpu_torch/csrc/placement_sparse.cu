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
// where base/nc_base are per-node sums over the whole row (the score and
// num_common of a sample without entries) and the corrections read st/stp of
// node n at column pos[b,k] only.
//
// Entry points and the TPU kernels they replace
//
// B1 usher_score_entries_T replaces usher_tpu/ops/placement_pallas.py::_kernel
//    (reached through _score_entries_T): it writes the node-major [N, B]
//    score and num_common matrices.  With `ref` given it is the fused form:
//    base, nc_base and node_num_mut are summed in the kernel from the rows it
//    stages (the JAX package computes them in XLA outside its Pallas kernel)
//    and written out as a [3, N] array; with ref null the caller gives
//    base/nc_base.
// B1-spr is B1 with spr = 1: the SPR semantics of the `sub` term
//    (usher_tpu/ops/placement_pallas.py::_corr_tiles with spr=True), run
//    over a batch's column subset.  It replaces
//    usher_tpu/ops/placement_pallas.py::score_cols_T; the BigMAT column
//    path (usher_tpu_torch/core/bigmat.py::_score_chunk) calls it with the
//    pointer-doubled [N, C] column states as st/stp and its full-genome
//    base/nc_base (never fused: they are not sums over the columns shown).
// B1-3d usher_score_entries_3d replaces
//    usher_tpu/ops/placement_pallas.py::_score_entries_3d: B1 (or B1-spr)
//    with the two outputs left in sample-tile-major tiles [bt, n_pad, tb],
//    score3[b / tb][n][b % tb].  The same kernel with the kTiled output
//    addressing.
// mesh B1 (usher_tpu/parallel/mesh.py::sharded_sparse_score_fn, B1 under a
//    shard_map) is the fused B1 launched once per (data, model) shard on the
//    shard's own device and stream, by usher_tpu_torch/parallel/mesh.py.
//    Every launcher therefore takes the device ordinal, makes it current for
//    the launch and restores the caller's device.
// B2 usher_placement_partials replaces
//    usher_tpu/ops/placement_pallas.py::_kernel_reduce (reached through
//    placement_step_sparse): B1's sums, placement validity and the exact
//    tie-break, folded in registers over all the rows a block walks; it
//    writes one partial per block and sample, [grid, B] x 4, which the caller
//    merges exactly.  The [N, B] matrices are never written.  Fused like B1
//    when `ref` is given.
//
// What bounds them on an H100, and what the design does about it
//
// At a wide position axis (tens of thousands of columns) and a small batch
// the kernels are bound by reading st and stp from device memory (2 bytes per
// node and column, once per call); at a narrow axis or a large batch by the
// integer work of the N * B * K (node, sample, entry) triples.
//
// * Persistent blocks and an asynchronous row ring.  One block of kThreads
//   threads per SM (the launcher is given grid = SMs of the device) walks
//   the row groups blockIdx.x, blockIdx.x + gridDim.x, ...  A group is `rows`
//   node rows; its st rows and its stp rows are each one contiguous run of
//   device memory, fetched by thread 0 with one non-tensor bulk copy each
//   (cp.async.bulk, completion counted in bytes on the stage's `full`
//   mbarrier) into a ring of `stages` slots of dynamic shared memory.  A
//   warp arrives on the slot's `empty` mbarrier when it has scored the slot;
//   thread 0 waits for it before it refills the slot, so groups i+1 .. i+
//   stages-1 load while group i is scored, with no block-wide wait on a
//   load.  (A stage is at most ~227 KB, below the 2^20 - 1 bytes one mbarrier
//   phase can count.)  Bulk copies need 16-byte alignment: for P % 16 != 0
//   or unaligned bases (vec = 0) the threads copy the rows themselves into
//   slot 0, one group at a time.
// * The folded sweep.  When a slot has landed, every warp sweeps 512-column
//   segments of its rows: 16 columns per lane as uint4, four cells per
//   32-bit word with byte-parallel compares against the reference row held
//   in shared memory (every byte is <= 0x0F, so x + 0x7F7F7F7F raises bit 7
//   of exactly the non-zero bytes without a carry between bytes; the four
//   words of a uint4 use bits 7, 6, 5 and 4, so one __popc counts 16 cells).
//   It packs st | stp << 4 in place over the st plane, so that a triple costs
//   one shared-memory byte lookup, and in the fused form counts the three
//   row sums, reduces them over the warp with shuffles and adds them into
//   the slot's [rows, 3] accumulators.  The sums thus cost no byte of
//   device-memory traffic beyond the rows the scoring needs anyway.  A
//   16-cell word whose st, stp and ref agree (nearly all of a tree's cells)
//   counts nothing and takes 8 xor/or and a vote beside the pack; one that
//   differs takes 4 x 20 for the four masks, 3 popc and 3 adds, or, where a
//   warp's 32 words hold at most three such (a tree's states), is counted
//   afterwards with a cell per lane so that the other lanes do not walk
//   through the masks with it.  The function itself needs 16 integer
//   operations for a 16-cell word that agrees (8 xor, 7 or, a test) and 90
//   more for one that differs (21 per 32-bit word for the three masks, 3 popc,
//   3 adds), which is what the yardstick charges
//   (chip_smoke.py::OPS_PER_EQUAL_WORD, OPS_PER_DIFFER_WORD).  The compiled
//   loop (cuobjdump -sass, CUDA 12.8) spends about 58 on a word that agrees,
//   with its addressing, the vote and the pack, and 58 more on one that
//   takes the masks (chip_smoke.py reports them as sweep_executed_ms).
// * Work item (row chunk, sample, K-slice), four triples at a time.  The
//   slot table stores a sample's slots in quads of four.  `lanes` (1, 2, ...
//   32, chosen by the caller from B and K) neighbouring lanes of a warp split
//   one sample's quads q = lane, lane + lanes, ... below the sample's last
//   quad that holds an entry (qend[b]; padding beyond it costs neither a
//   load nor a lookup) and fold their two sums with __shfl_xor_sync,
//   Hopper's form of the TPU kernel's block-diagonal segment-sum matmul.  A
//   batch of 64 thus fills the block as well as one of 1,024.  A lane
//   gathers the node's packed bytes at the quad's four columns into one
//   word and evaluates the four corrections byte-parallel (add_quad), as the
//   sweep does.  A quad is loaded once for the kRC (4, or 1 when a stage
//   holds fewer than 4 rows) rows of a chunk, the next quad is requested
//   before the current one is looked up, and a thread group's first quad
//   stays in registers from one row group to the next.  In the compiled
//   loops a quad costs 61 integer operations at kRC 1 beside its 7 LDG
//   and 4 LDS.U8 (15.25 a triple: 18 IMAD, 15 LOP3, 12 adds, 4 SHF, 4 POPC,
//   3 PRMT and the loop's compares), and 162 for the 16 triples of a quad at
//   kRC 4 (10.1 a triple), where four rows share the quad's loads and
//   addressing.  The yardstick charges the lower figure
//   (chip_smoke.py::OPS_PER_TRIPLE), so that its bound is a lower limit at
//   every shape; at the wide shapes, where a stage holds one row, the
//   kernel executes half as many again.
// * B2 keeps (best, cnt, q1, q2) of its sample in registers across every row
//   group of the block and writes [gridDim.x, B] once.  A block without row
//   groups writes the identity (1 << 30, 0, -1, -1).  More samples than
//   thread groups (B > kThreads / lanes) are taken in tiles, the block
//   walking its rows once per tile.  No atomics between blocks: the result
//   is the same in every run.
//
// ptxas (sm_90a, CUDA 12.8, -O3, __launch_bounds__(1024, 1), which caps a
// thread at 64 registers; from the build log beside the library): every
// score_entries_kernel<kSpr, kTiled, kRC> uses 62 registers at kRC 1 and 64
// at kRC 4, without spills; placement_partials_kernel<1> 64 registers with
// 12 bytes of spill stores and 28 of loads, placement_partials_kernel<4> 64
// with 36 bytes of spill stores and 92 of loads (its partial, its sample's first
// quad and four rows' sums are live together).
//
// Slot table (built by placement_sparse.py::_slot_words): int32 [Q, 7, B]
// for B samples of K slots, Q = ceil(K / 4) quads, b fastest so that
// neighbouring threads (neighbouring b) read neighbouring words.  Words 0..3
// of a quad are the columns of its four slots (0 when the slot is padding);
// words 4..6 hold one byte per slot, slot i in bits 8i .. 8i + 7:
//   word 4  the sample's allele mask gval (low nibble)
//   word 5  the reference nibble at the column
//   word 6  flags: bit 7 kmiss (entry is missing, N), bit 6 the slot holds
//           an entry
// A padding slot has all three bytes zero.
//
// st and stp hold nibbles (values 0..15), which the byte packing and the
// byte-parallel compares rely on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One block per SM: 1,024 threads scored the operation-bound shapes faster
// than 512 did (a thread then has 64 registers).
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 30;
constexpr int kMaxStages = 4;
constexpr int kMaxRows = 32;
// shared-memory header: 2 * kMaxStages mbarriers, then the [stages, rows, 3]
// int32 row-sum accumulators
constexpr int kRedOffset = 64;
constexpr int kHeader = 2048;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;
static_assert(kRedOffset + kMaxStages * kMaxRows * 3 * 4 <= kHeader, "header");
static_assert(kThreads % 32 == 0 && kThreads >= kMaxRows * 3, "block size");

// Built with -DUSHER_PROFILE (tools/kernel_profile.py), B1 reads clock64()
// between the phases of its row-group loop (waiting for the stage, the sweep,
// the block barrier, scoring and stores, releasing the stage) and thread
// kProfThread of block b leaves its five sums in usher_prof[b * 8 ...].
#ifdef USHER_PROFILE
constexpr int kProfBlocks = 256;
constexpr int kProfThread = 97;
__device__ long long usher_prof[kProfBlocks * 8];
#define USHER_PROF_BEGIN \
  long long prof[5] = {0, 0, 0, 0, 0}; \
  long long prof_t0 = clock64();
#define USHER_PROF_TICK(i)             \
  {                                    \
    const long long t1 = clock64();    \
    prof[i] += t1 - prof_t0;           \
    prof_t0 = t1;                      \
  }
#define USHER_PROF_END                                              \
  if (threadIdx.x == kProfThread && blockIdx.x < kProfBlocks)       \
    for (int i = 0; i < 5; ++i) usher_prof[blockIdx.x * 8 + i] = prof[i];
#else
#define USHER_PROF_BEGIN
#define USHER_PROF_TICK(i)
#define USHER_PROF_END
#endif

// How a launch cuts st/stp [N, P] into row groups and ring stages.
struct Ring {
  long long N;
  long long groups;  // ceil(N / rows)
  int P;
  int pitch;   // bytes between rows of a plane in shared memory, P up to 16
  int rows;    // node rows of a group
  int stages;  // ring slots
  int vec;     // 1: bulk copies fill the ring; 0: the threads copy into slot 0
};

// --- mbarrier and bulk-copy primitives ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --- the row ring --------------------------------------------------------------

// The shared memory of a block, and the block's walk over its row groups.
struct Block {
  uint64_t* full;
  uint64_t* empty;
  int* red;        // [stages, rows, 3] row sums of the slots
  uint8_t* refs;   // reference row (fused form only), zero beyond P
  uint8_t* ring;   // [stages] x (st plane [rows, pitch], stp plane)
  long long my_groups;

  __device__ Block(uint8_t* sm, const Ring& g, bool fused) {
    full = reinterpret_cast<uint64_t*>(sm);
    empty = full + kMaxStages;
    red = reinterpret_cast<int*>(sm + kRedOffset);
    refs = sm + kHeader;
    ring = refs + (fused ? g.pitch : 0);
    my_groups = (long long)blockIdx.x < g.groups
                    ? (g.groups - blockIdx.x + gridDim.x - 1) / gridDim.x
                    : 0;
  }

  __device__ __forceinline__ uint8_t* slot(const Ring& g, int s) const {
    return ring + (size_t)s * g.rows * 2 * g.pitch;
  }
};

__device__ __forceinline__ long long group_of(long long unit,
                                              long long my_groups) {
  return (long long)blockIdx.x + (unit % my_groups) * (long long)gridDim.x;
}

// Thread 0: zero the slot's row sums and start the two bulk copies of a row
// group into it.
__device__ void fill_slot(const Block& blk, const Ring& g,
                          const uint8_t* __restrict__ st,
                          const uint8_t* __restrict__ stp, long long group,
                          int s) {
  const long long n0 = group * g.rows;
  const int nrows = (int)min((long long)g.rows, g.N - n0);
  const uint32_t bytes = (uint32_t)nrows * (uint32_t)g.P;  // pitch == P
  int* red = blk.red + s * g.rows * 3;
  for (int i = 0; i < g.rows * 3; ++i) red[i] = 0;
  uint8_t* dst = blk.slot(g, s);
  mbar_arrive_expect_tx(&blk.full[s], 2u * bytes);
  bulk_copy(dst, st + (size_t)n0 * g.P, bytes, &blk.full[s]);
  bulk_copy(dst + (size_t)g.rows * g.pitch, stp + (size_t)n0 * g.P, bytes,
            &blk.full[s]);
}

// Set up the block: barriers, the reference row, and the first `stages`
// groups in flight.
__device__ void ring_begin(const Block& blk, const Ring& g,
                           const uint8_t* __restrict__ st,
                           const uint8_t* __restrict__ stp,
                           const uint8_t* __restrict__ ref, long long units) {
  if (threadIdx.x == 0 && g.vec) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&blk.full[s], 1);
      mbar_init(&blk.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (ref != nullptr) {
    for (int c = threadIdx.x; c < g.pitch; c += kThreads)
      blk.refs[c] = c < g.P ? ref[c] : (uint8_t)0;
  }
  __syncthreads();
  if (threadIdx.x == 0 && g.vec) {
    for (int s = 0; s < g.stages && s < units; ++s)
      fill_slot(blk, g, st, stp, group_of(s, blk.my_groups), s);
  }
}

// Wait until unit u's rows are in shared memory; returns its slot.  In the
// ring, thread 0 first refills the slot that unit u - 1 used.
__device__ int ring_acquire(const Block& blk, const Ring& g,
                            const uint8_t* __restrict__ st,
                            const uint8_t* __restrict__ stp, long long u,
                            long long units, long long n0, int nrows) {
  if (g.vec) {
    if (threadIdx.x == 0 && u >= 1 && u - 1 + g.stages < units) {
      const int s = (int)((u - 1) % g.stages);
      mbar_wait(&blk.empty[s], (uint32_t)(((u - 1) / g.stages) & 1));
      fill_slot(blk, g, st, stp, group_of(u - 1 + g.stages, blk.my_groups), s);
    }
    const int s = (int)(u % g.stages);
    // one lane of a warp polls; the warp's other lanes take its word for it
    if ((threadIdx.x & 31) == 0)
      mbar_wait(&blk.full[s], (uint32_t)((u / g.stages) & 1));
    __syncwarp();
    return s;
  }
  // the threads copy the rows themselves: columns P .. pitch are zero, which
  // the sweep counts as nothing
  __syncthreads();  // everyone has scored the previous group
  if (threadIdx.x < g.rows * 3) blk.red[threadIdx.x] = 0;
  uint8_t* dst = blk.slot(g, 0);
  const int total = nrows * g.pitch;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / g.pitch;
    const int c = i - r * g.pitch;
    const size_t off = (size_t)(n0 + r) * g.P + c;
    dst[i] = c < g.P ? st[off] : (uint8_t)0;
    dst[(size_t)g.rows * g.pitch + i] = c < g.P ? stp[off] : (uint8_t)0;
  }
  __syncthreads();
  return 0;
}

// This warp has scored the slot: let thread 0 refill it.
__device__ __forceinline__ void ring_release(const Block& blk, const Ring& g,
                                             int s) {
  if (!g.vec) return;
  // the sweep wrote the slot through the generic proxy; the refill writes it
  // through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&blk.empty[s]);
}

// --- the sweep: pack in place, and the three row sums ---------------------------

// bit kBit (4..7) of every non-zero byte of x (bytes <= 0x0F, so the add
// never carries into the next byte)
template <int kBit>
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  constexpr uint32_t kOne = 0x01010101u << kBit;
  return (x + (kOne - 0x01010101u)) & kOne;
}

// Four cells of st (a), stp (p) and ref (r): ORs into the three masks, at
// bit kBit of each byte, whether the cell counts into base (the no-entry
// score: A_r != ref with A_r = stp where the branch mutated away from ref,
// else st), nc_base (branch mutations that ref matches) and node_num_mut
// (branch mutations), as placement_sparse.py::row_reductions defines them.
// The four words of a uint4 take four bit positions, so one __popc per mask
// counts 16 cells.
template <int kBit>
__device__ __forceinline__ void sweep_word(uint32_t a, uint32_t p, uint32_t r,
                                           uint32_t& m_base, uint32_t& m_nc,
                                           uint32_t& m_mut) {
  const uint32_t bm = nonzero_bytes<kBit>(a ^ p);
  const uint32_t m0 = nonzero_bytes<kBit>(r & a);
  const uint32_t ds = nonzero_bytes<kBit>(a ^ r);
  const uint32_t dp = nonzero_bytes<kBit>(p ^ r);
  const uint32_t sel = bm & ~m0;
  m_base |= ds ^ (sel & (ds ^ dp));
  m_nc |= bm & m0;
  m_mut |= bm;
}

__device__ __forceinline__ void flush_sums(int* red_row, int s_base, int s_nc,
                                           int s_mut) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s_base += __shfl_xor_sync(kAllLanes, s_base, off);
    s_nc += __shfl_xor_sync(kAllLanes, s_nc, off);
    s_mut += __shfl_xor_sync(kAllLanes, s_mut, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(red_row + 0, s_base);
    atomicAdd(red_row + 1, s_nc);
    atomicAdd(red_row + 2, s_mut);
  }
}

// Words of a 32-word unit that the sweep counts one at a time (a cell a
// lane) before it turns to the byte-parallel masks for the whole unit.
constexpr int kFixupWords = 3;

// Sweep the nrows rows of a slot: warp w takes the (row, 512-column segment)
// units w, w + kWarps, ...; packs st | stp << 4 over the st plane and, when
// kSums, adds the rows' three sums into red [rows, 3].  A 16-cell word whose
// st, stp and ref agree counts nothing.  On a tree's states few words of a
// unit do otherwise: up to kFixupWords of them are counted after the pack,
// one at a time with a cell per lane, so that the other lanes do not walk
// through the mask arithmetic with them; with more, every lane whose word
// differs takes the byte-parallel masks.
template <bool kSums>
__device__ void sweep_slot(uint8_t* slot, const uint8_t* refs, int* red,
                           const Ring& g, int nrows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpr = g.pitch >> 4;        // uint4 words of a row
  const int segs = (wpr + 31) >> 5;
  const int units = nrows * segs;
  uint4* plane_a = reinterpret_cast<uint4*>(slot);
  const uint4* plane_p =
      reinterpret_cast<const uint4*>(slot + (size_t)g.rows * g.pitch);
  const uint4* ref4 = reinterpret_cast<const uint4*>(refs);
  int cur = -1, s_base = 0, s_nc = 0, s_mut = 0;
  int r = warp / segs;           // unit u is segment seg of row r
  int seg = warp - r * segs;
  for (int u = warp; u < units; u += kWarps, seg += kWarps) {
    while (seg >= segs) {
      seg -= segs;
      ++r;
    }
    const int c0 = seg << 5;  // the unit's first word of the row
    const int c = c0 + lane;
    if (kSums && r != cur) {
      if (cur >= 0) flush_sums(red + cur * 3, s_base, s_nc, s_mut);
      cur = r;
      s_base = s_nc = s_mut = 0;
    }
    const int i = r * wpr + c;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), p = a, rf = a;
    bool differs = false;
    if (c < wpr) {
      a = plane_a[i];
      p = plane_p[i];
      if (kSums) {
        rf = ref4[c];
        differs = ((a.x ^ p.x) | (a.y ^ p.y) | (a.z ^ p.z) | (a.w ^ p.w) |
                   (a.x ^ rf.x) | (a.y ^ rf.y) | (a.z ^ rf.z) |
                   (a.w ^ rf.w)) != 0u;
      }
    }
    unsigned todo = 0;
    if (kSums) {
      todo = __ballot_sync(kAllLanes, differs);
      if (__popc(todo) > kFixupWords) {
        if (differs) {
          uint32_t m_base = 0, m_nc = 0, m_mut = 0;
          sweep_word<7>(a.x, p.x, rf.x, m_base, m_nc, m_mut);
          sweep_word<6>(a.y, p.y, rf.y, m_base, m_nc, m_mut);
          sweep_word<5>(a.z, p.z, rf.z, m_base, m_nc, m_mut);
          sweep_word<4>(a.w, p.w, rf.w, m_base, m_nc, m_mut);
          s_base += __popc(m_base);
          s_nc += __popc(m_nc);
          s_mut += __popc(m_mut);
        }
        todo = 0;
      }
    }
    if (c < wpr) {
      a.x |= p.x << 4;
      a.y |= p.y << 4;
      a.z |= p.z << 4;
      a.w |= p.w << 4;
      plane_a[i] = a;
    }
    if (kSums && todo) {
      __syncwarp();  // the unit's packed words are written
      while (todo) {
        const int w = c0 + __ffs(todo) - 1;  // a word that differs
        todo &= todo - 1;
        uint32_t v = 0, rk = 0;
        if (lane < 16) {
          v = slot[((size_t)r * wpr + w) * 16 + lane];
          rk = refs[w * 16 + lane];
        }
        const uint32_t sv = v & 0xFu;
        const uint32_t sp = v >> 4;
        const bool bm = sv != sp;
        const bool matched0 = (rk & sv) != 0u;
        const bool in_base = (bm && !matched0) ? sp != rk : sv != rk;
        const int n_base = __popc(__ballot_sync(kAllLanes, in_base));
        const int n_nc = __popc(__ballot_sync(kAllLanes, bm && matched0));
        const int n_mut = __popc(__ballot_sync(kAllLanes, bm));
        if (lane == 0) {
          s_base += n_base;
          s_nc += n_nc;
          s_mut += n_mut;
        }
      }
    }
  }
  if (kSums && cur >= 0) flush_sums(red + cur * 3, s_base, s_nc, s_mut);
}

// --- the corrections --------------------------------------------------------------

// Four slots of a sample (a quad), as the slot table stores them.
struct Quad {
  uint32_t pos[4];  // column of each slot (0 for padding)
  uint32_t g;       // one byte a slot: the sample's allele mask
  uint32_t r;       // one byte a slot: the reference nibble
  uint32_t fl;      // one byte a slot: bit 7 missing, bit 6 holds an entry
};

// Quad q of sample b from the table [Q, 7, B]; the empty quad at or beyond
// qend, which adds nothing.
__device__ __forceinline__ Quad load_quad(const uint32_t* __restrict__ table,
                                          int q, int b, int B, int qend) {
  Quad x;
  if (q < qend) {
    const uint32_t* p = table + (size_t)q * 7 * B + b;
#pragma unroll
    for (int i = 0; i < 4; ++i) x.pos[i] = __ldg(p + (size_t)i * B);
    x.g = __ldg(p + (size_t)4 * B);
    x.r = __ldg(p + (size_t)5 * B);
    x.fl = __ldg(p + (size_t)6 * B);
  } else {
    x.pos[0] = x.pos[1] = x.pos[2] = x.pos[3] = 0u;
    x.g = x.r = x.fl = 0u;
  }
  return x;
}

// The corrections of the four (node, sample, slot) triples of a quad at
// once, one per byte: v holds the node's packed bytes st | stp << 4 (s, sp)
// at the quad's four columns.  The terms of
// placement_pallas.py::_corr_tiles, kSpr selecting the SPR base semantics of
// the `sub` term.  With bm = s != sp, matched = gv & s, matched_r = rk & s,
// A = (bm && !matched) ? sp : s and A_r = (bm && !matched_r) ? sp : s:
//   term1 = !km && (gv & A) == 0    is  !km && (gv & (s | sp)) == 0,
//     since A = s whenever gv meets s, and where bm is false s == sp;
//   sub   = A_r != rk (placement: what the column put into base[n]), with
//     A_r = matched_r ? s : sp;  in SPR mode (rk & A_r) == 0, which is
//     (rk & (s | sp)) == 0 by the same argument.
// Every term is a bit 7 per byte; a slot without an entry has gv = rk = 0
// and a clear `holds` bit, so its byte counts nothing.
template <bool kSpr>
__device__ __forceinline__ void add_quad(uint32_t v, const Quad& x, int& c,
                                         int& n) {
  const uint32_t s = v & 0x0F0F0F0Fu;
  const uint32_t sp = (v >> 4) & 0x0F0F0F0Fu;
  const uint32_t holds = (x.fl << 1) & 0x80808080u;
  const uint32_t bm = nonzero_bytes<7>(s ^ sp);
  const uint32_t matched = nonzero_bytes<7>(s & x.g);
  const uint32_t matched_r = nonzero_bytes<7>(s & x.r);
  const uint32_t term1 = ~(nonzero_bytes<7>((s | sp) & x.g) | x.fl) & holds;
  uint32_t sub;
  if (kSpr) {
    sub = ~nonzero_bytes<7>((s | sp) & x.r) & holds;
  } else {
    const uint32_t pick_s = (matched_r >> 7) * 0xFFu;  // 0xFF where matched_r
    const uint32_t a_r = (s & pick_s) | (sp & ~pick_s);
    sub = nonzero_bytes<7>(a_r ^ x.r) & holds;
  }
  c += __popc(term1) - __popc(sub);
  n += __popc(bm & matched) - __popc(bm & matched_r);
}

// A lane's view of one sample: its qend and its first quad (q = sub), which
// a lane that keeps its sample from one row group to the next loads once
// per launch.
struct SampleSlots {
  int b, qend;
  Quad first;
};

__device__ __forceinline__ SampleSlots load_sample(
    const uint32_t* __restrict__ table, const int32_t* __restrict__ qends,
    int b, int B, bool act, int sub) {
  SampleSlots ss;
  ss.b = act ? b : 0;
  ss.qend = act ? __ldg(qends + b) : 0;
  ss.first = load_quad(table, sub, ss.b, B, ss.qend);
  return ss;
}

// The two slot sums of a sample against the kRC packed rows at `rows`
// (pitch bytes apart), over this lane's share q = sub, sub + lanes, ... of
// the sample's quads, then folded over the `lanes` lanes of the group: every
// lane of the group returns the whole sums.  All 32 lanes of a warp call
// this together; lanes without a sample pass qend = 0.  The next quad is
// requested before the current one is looked up.
template <bool kSpr, int kRC>
__device__ __forceinline__ void entry_sums(
    const uint8_t* __restrict__ rows, int pitch,
    const uint32_t* __restrict__ table, int B, const SampleSlots& ss, int sub,
    int lanes, int (&cs)[kRC], int (&ns)[kRC]) {
#pragma unroll
  for (int j = 0; j < kRC; ++j) cs[j] = ns[j] = 0;
  Quad x = ss.first;
  for (int q = sub; q < ss.qend; q += lanes) {
    const Quad next = load_quad(table, q + lanes, ss.b, B, ss.qend);
    uint32_t v[kRC];
#pragma unroll
    for (int j = 0; j < kRC; ++j) {
      const uint8_t* row = rows + (size_t)j * pitch;
      v[j] = (uint32_t)row[x.pos[0]] | ((uint32_t)row[x.pos[1]] << 8) |
             ((uint32_t)row[x.pos[2]] << 16) | ((uint32_t)row[x.pos[3]] << 24);
    }
#pragma unroll
    for (int j = 0; j < kRC; ++j) add_quad<kSpr>(v[j], x, cs[j], ns[j]);
    x = next;
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kRC; ++j) {
      cs[j] += __shfl_xor_sync(kAllLanes, cs[j], off);
      ns[j] += __shfl_xor_sync(kAllLanes, ns[j], off);
    }
  }
}

// --- B1 --------------------------------------------------------------------------

// B1 (kSpr false) and B1-spr (kSpr true).  Work items (row chunk, b) with b
// fastest, one per group of `lanes` lanes, so that slot-word loads and output
// stores run over neighbouring b; a group's first item is the same in every
// row group, so its sample's first slot words stay in registers.  kTiled
// (B1-3d) writes element (n, b) of the outputs at [b / tb][n][b % tb] of
// [bt, n_pad, tb] buffers instead of [n][b] of [N, B]; rows >= N and samples
// >= B of a tile are not written.  ref != nullptr selects the fused form:
// base/nc_base come from the sweep and the three row sums are written to
// sums_out [3, N].
template <bool kSpr, bool kTiled, int kRC>
__global__ void __launch_bounds__(kThreads, 1)
score_entries_kernel(const uint8_t* __restrict__ st,
                     const uint8_t* __restrict__ stp,
                     const uint8_t* __restrict__ ref,
                     const int32_t* __restrict__ base,
                     const int32_t* __restrict__ nc_base,
                     const uint32_t* __restrict__ slots,
                     const int32_t* __restrict__ qends, Ring g, int B,
                     int lanes, int tb, long long n_pad,
                     int32_t* __restrict__ score_t, int32_t* __restrict__ nc_t,
                     int32_t* __restrict__ sums_out) {
  extern __shared__ uint4 smem_raw[];
  const bool fused = ref != nullptr;
  const Block blk(reinterpret_cast<uint8_t*>(smem_raw), g, fused);
  const long long units = blk.my_groups;
  ring_begin(blk, g, st, stp, ref, units);
  const int n_groups = kThreads / lanes;  // thread groups of the block
  const int grp = threadIdx.x / lanes;
  const int sub = threadIdx.x % lanes;
  // the group's item of the first pass over a stage: row chunk ch0, sample b0
  // (a fused launch without samples, B == 0, has no item and only writes
  // the row sums)
  const int ch0 = B > 0 ? grp / B : 0;
  const int b0 = grp - ch0 * B;
  const SampleSlots first =
      load_sample(slots, qends, b0, B, B > 0 && ch0 * kRC < g.rows, sub);
  USHER_PROF_BEGIN
  for (long long u = 0; u < units; ++u) {
    const long long n0 = group_of(u, blk.my_groups) * g.rows;
    const int nrows = (int)min((long long)g.rows, g.N - n0);
    const int s = ring_acquire(blk, g, st, stp, u, units, n0, nrows);
    USHER_PROF_TICK(0)
    uint8_t* slot = blk.slot(g, s);
    int* red = blk.red + s * g.rows * 3;
    if (fused) {
      sweep_slot<true>(slot, blk.refs, red, g, nrows);
    } else {
      sweep_slot<false>(slot, blk.refs, red, g, nrows);
    }
    USHER_PROF_TICK(1)
    __syncthreads();  // the slot is packed and its row sums are whole
    USHER_PROF_TICK(2)
    if (fused && threadIdx.x < nrows * 3) {
      const int r = threadIdx.x / 3;
      const int which = threadIdx.x - r * 3;
      sums_out[(size_t)which * g.N + n0 + r] = red[threadIdx.x];
    }
    const int items = ((nrows + kRC - 1) / kRC) * B;
    for (int it0 = 0; it0 < items; it0 += n_groups) {
      const int it = it0 + grp;
      const bool act = it < items;
      int ch = ch0;
      SampleSlots ss = first;
      if (it0 != 0) {
        ch = act ? it / B : 0;
        ss = load_sample(slots, qends, it - ch * B, B, act, sub);
      }
      if (!act) ss.qend = 0;
      const int r0 = ch * kRC;
      int cs[kRC], ns[kRC];
      entry_sums<kSpr, kRC>(slot + (size_t)r0 * g.pitch, g.pitch, slots, B, ss,
                            sub, lanes, cs, ns);
      if (act && sub == 0) {
        const int b = ss.b;
#pragma unroll
        for (int j = 0; j < kRC; ++j) {
          const int r = r0 + j;
          if (r < nrows) {
            const long long n = n0 + r;
            size_t o;
            if constexpr (kTiled) {
              o = ((size_t)(b / tb) * (size_t)n_pad + (size_t)n) * tb + b % tb;
            } else {
              o = (size_t)n * B + b;
            }
            score_t[o] = (fused ? red[r * 3] : base[n]) + cs[j];
            nc_t[o] = (fused ? red[r * 3 + 1] : nc_base[n]) + ns[j];
          }
        }
      }
    }
    USHER_PROF_TICK(3)
    ring_release(blk, g, s);
    USHER_PROF_TICK(4)
  }
  USHER_PROF_END
}

// --- B2 --------------------------------------------------------------------------

// One partial of the tie-break of placement_pallas.py::_kernel_reduce:
//   best  min valid score            cnt  rows at best
//   q1    max leaves among best      q2   max (rank*2 | has_unique) among
//                                         best rows with leaves == q1
struct Partial {
  int best, cnt, q1, q2;

  __device__ __forceinline__ void reset() {
    best = kBig;
    cnt = 0;
    q1 = -1;
    q2 = -1;
  }

  __device__ __forceinline__ void fold(int score, int leaves, int rank2) {
    if (score < best) {
      best = score;
      cnt = 1;
      q1 = leaves;
      q2 = rank2;
    } else if (score == best) {
      ++cnt;
      if (leaves > q1) {
        q1 = leaves;
        q2 = rank2;
      } else if (leaves == q1 && rank2 > q2) {
        q2 = rank2;
      }
    }
  }
};

// B2.  Thread group t of `lanes` lanes owns sample tile * n_groups + t and
// folds every valid (node, sample) of the block's row groups into its
// partial; parts are [4, gridDim.x, B] (best, cnt, q1, q2).  nodemeta is
// [N, 4] int32: num_leaves, bfs_rank, node_num_mut (unused in the fused
// form, which counts it in the sweep), flags = active | is_leaf << 1 |
// is_root << 2.  Inactive rows are never valid and are not scored.
template <int kRC>
__global__ void __launch_bounds__(kThreads, 1)
placement_partials_kernel(const uint8_t* __restrict__ st,
                          const uint8_t* __restrict__ stp,
                          const uint8_t* __restrict__ ref,
                          const int32_t* __restrict__ base,
                          const int32_t* __restrict__ nc_base,
                          const int4* __restrict__ nodemeta,
                          const uint32_t* __restrict__ slots,
                          const int32_t* __restrict__ qends, Ring g, int B,
                          int lanes, int32_t* __restrict__ parts) {
  extern __shared__ uint4 smem_raw[];
  const bool fused = ref != nullptr;
  const Block blk(reinterpret_cast<uint8_t*>(smem_raw), g, fused);
  const int n_groups = kThreads / lanes;
  const int grp = threadIdx.x / lanes;
  const int sub = threadIdx.x % lanes;
  const size_t plane = (size_t)gridDim.x * B;  // one of the four parts
  int32_t* out = parts + (size_t)blockIdx.x * B;
  if (blk.my_groups == 0) {
    // a block without rows: the identity of the merge
    for (int b = threadIdx.x; b < B; b += kThreads) {
      out[b] = kBig;
      out[plane + b] = 0;
      out[2 * plane + b] = -1;
      out[3 * plane + b] = -1;
    }
    return;
  }
  const long long tiles = (B + n_groups - 1) / n_groups;
  const long long units = tiles * blk.my_groups;
  ring_begin(blk, g, st, stp, ref, units);
  Partial part;
  part.reset();
  SampleSlots ss;
  for (long long u = 0; u < units; ++u) {
    const long long gi = u % blk.my_groups;
    const long long n0 = group_of(u, blk.my_groups) * g.rows;
    const int nrows = (int)min((long long)g.rows, g.N - n0);
    const int b = (int)(u / blk.my_groups) * n_groups + grp;
    const bool act = b < B;
    // a new tile: the group's sample changes
    if (gi == 0) ss = load_sample(slots, qends, b, B, act, sub);
    const int s = ring_acquire(blk, g, st, stp, u, units, n0, nrows);
    uint8_t* slot = blk.slot(g, s);
    int* red = blk.red + s * g.rows * 3;
    if (fused) {
      sweep_slot<true>(slot, blk.refs, red, g, nrows);
    } else {
      sweep_slot<false>(slot, blk.refs, red, g, nrows);
    }
    __syncthreads();  // the slot is packed and its row sums are whole
    for (int r0 = 0; r0 < nrows; r0 += kRC) {
      // bit j: row r0 + j is active
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        if (r0 + j < nrows && (__ldg(&nodemeta[n0 + r0 + j].w) & 1))
          live |= 1u << j;
      }
      if (!live) continue;  // the same for the whole block
      int cs[kRC], ns[kRC];
      entry_sums<false, kRC>(slot + (size_t)r0 * g.pitch, g.pitch, slots, B,
                             ss, sub, lanes, cs, ns);
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        if (!((live >> j) & 1u)) continue;
        const int r = r0 + j;
        const long long n = n0 + r;
        const int score = (fused ? red[r * 3] : base[n]) + cs[j];
        const int nc = (fused ? red[r * 3 + 1] : nc_base[n]) + ns[j];
        const int4 meta = __ldg(nodemeta + n);
        const int flags = meta.w;
        const int num_mut = fused ? red[r * 3 + 2] : meta.z;
        const bool leaf = (flags >> 1) & 1;
        const bool root = (flags >> 2) & 1;
        const bool hu = nc < num_mut;
        const bool nc_pos = nc > 0;
        const bool valid = root || (leaf && nc_pos) ||
                           (!leaf && hu && nc_pos) || (!leaf && !hu);
        if (valid) part.fold(score, meta.x, meta.y * 2 + (hu ? 1 : 0));
      }
    }
    ring_release(blk, g, s);
    if (gi == blk.my_groups - 1) {
      // the tile's last row group: every lane of the group holds the partial
      if (act && sub == 0) {
        out[b] = part.best;
        out[plane + b] = part.cnt;
        out[2 * plane + b] = part.q1;
        out[3 * plane + b] = part.q2;
      }
      part.reset();
    }
  }
}

// --- launchers ---------------------------------------------------------------------

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

// What the caller chose for a launch (placement_sparse.py::launch_plan).
struct Plan {
  int rows, stages, vec, lanes, grid;
};

// The Ring of a plan and its dynamic shared memory; cudaErrorInvalidValue
// for a plan the kernels do not take.
cudaError_t make_ring(const void* st, const void* stp, long long N, int P,
                      const Plan& plan, bool fused, Ring* ring, size_t* smem) {
  const int pitch = (P + 15) & ~15;
  const bool aligned = (P % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(st) & 15u) == 0 &&
                       (reinterpret_cast<uintptr_t>(stp) & 15u) == 0;
  const int lanes = plan.lanes;
  if (plan.rows < 1 || plan.rows > kMaxRows || plan.stages < 1 ||
      plan.stages > kMaxStages || plan.grid < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || (plan.vec && !aligned) ||
      (!plan.vec && plan.stages != 1))
    return cudaErrorInvalidValue;
  *ring = Ring{N, (N + plan.rows - 1) / plan.rows, P, pitch, plan.rows,
               plan.stages, plan.vec};
  *smem = (size_t)kHeader + (fused ? pitch : 0) +
          (size_t)plan.stages * plan.rows * 2 * pitch;
  // one mbarrier phase counts at most 2^20 - 1 bytes
  if ((size_t)plan.rows * 2 * pitch >= (1u << 20)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool kSpr, bool kTiled, int kRC>
cudaError_t launch_score_entries(const void* st, const void* stp,
                                 const void* ref, const void* base,
                                 const void* nc_base, const void* slots,
                                 const void* qends, const Ring& ring,
                                 size_t smem, int B, const Plan& plan, int tb,
                                 long long n_pad, void* score_t, void* nc_t,
                                 void* sums_out, cudaStream_t stream) {
  cudaError_t err = set_smem(score_entries_kernel<kSpr, kTiled, kRC>, smem);
  if (err != cudaSuccess) return err;
  score_entries_kernel<kSpr, kTiled, kRC>
      <<<(unsigned)plan.grid, kThreads, smem, stream>>>(
          (const uint8_t*)st, (const uint8_t*)stp, (const uint8_t*)ref,
          (const int32_t*)base, (const int32_t*)nc_base,
          (const uint32_t*)slots, (const int32_t*)qends, ring, B, plan.lanes,
          tb, n_pad, (int32_t*)score_t, (int32_t*)nc_t, (int32_t*)sums_out);
  return cudaGetLastError();
}

template <bool kTiled>
cudaError_t score_entries(const void* st, const void* stp, const void* ref,
                          const void* base, const void* nc_base,
                          const void* slots, const void* qends, long long N,
                          int P, int B, const Plan& plan, int spr, int tb,
                          long long n_pad, void* score_t, void* nc_t,
                          void* sums_out, int device, cudaStream_t stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const bool fused = ref != nullptr;
  if (fused ? sums_out == nullptr : (base == nullptr || nc_base == nullptr))
    return cudaErrorInvalidValue;
  Ring ring;
  size_t smem;
  cudaError_t err = make_ring(st, stp, N, P, plan, fused, &ring, &smem);
  if (err != cudaSuccess) return err;
  const bool chunked = plan.rows % 4 == 0;
#define USHER_LAUNCH(SPR, RC)                                                 \
  launch_score_entries<SPR, kTiled, RC>(st, stp, ref, base, nc_base, slots,   \
                                        qends, ring, smem, B, plan, tb,       \
                                        n_pad, score_t, nc_t, sums_out,       \
                                        stream)
  if (spr) return chunked ? USHER_LAUNCH(true, 4) : USHER_LAUNCH(true, 1);
  return chunked ? USHER_LAUNCH(false, 4) : USHER_LAUNCH(false, 1);
#undef USHER_LAUNCH
}

}  // namespace

extern "C" {

// Every launcher returns the launch's cudaError_t (0 on success) and never
// synchronises.  `device` is the ordinal of the device that holds the tensors
// and owns `stream`; spr != 0 selects B1-spr (the SPR `sub` term).  ref !=
// null selects the fused form (base/nc_base may then be null, and sums_out
// [3, N] int32 receives base, nc_base and node_num_mut); with ref null the
// caller gives base/nc_base and sums_out is not written.  rows, stages, vec,
// lanes and grid are the caller's plan (placement_sparse.py::launch_plan).
// Nothing is launched where there is nothing to write: without rows, or
// without samples unless the row sums are asked for (a fused B1 call with
// B == 0 still writes sums_out); B2 without rows writes the identity parts.

// What a launch plan needs to know of `device`: its SM count, the threads of
// a block, the dynamic shared memory a block may have, and the bytes of it
// that a block keeps beside its ring and reference row.
int usher_launch_limits(int device, int* sms, int* threads, int* smem_max,
                        int* smem_header) {
  *threads = kThreads;
  *smem_header = kHeader;
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

int usher_score_entries_T(const void* st, const void* stp, const void* ref,
                          const void* base, const void* nc_base,
                          const void* slots, const void* qends, long long N,
                          int P, int B, int rows, int stages, int vec,
                          int lanes, int grid, int spr, void* score_t,
                          void* nc_t, void* sums_out, int device,
                          void* stream) {
  if (N <= 0 || (B <= 0 && ref == nullptr)) return (int)cudaSuccess;
  const Plan plan{rows, stages, vec, lanes, grid};
  return (int)score_entries<false>(st, stp, ref, base, nc_base, slots, qends,
                                   N, P, B, plan, spr, 0, 0, score_t, nc_t,
                                   sums_out, device, (cudaStream_t)stream);
}

// B1-3d: score3/nc3 are [ceil(B / tb), n_pad, tb] int32 with n_pad >= N.
int usher_score_entries_3d(const void* st, const void* stp, const void* ref,
                           const void* base, const void* nc_base,
                           const void* slots, const void* qends, long long N,
                           int P, int B, int rows, int stages, int vec,
                           int lanes, int grid, int spr, int tb,
                           long long n_pad, void* score3, void* nc3,
                           void* sums_out, int device, void* stream) {
  if (N <= 0 || (B <= 0 && ref == nullptr)) return (int)cudaSuccess;
  if (tb <= 0 || n_pad < N) return (int)cudaErrorInvalidValue;
  const Plan plan{rows, stages, vec, lanes, grid};
  return (int)score_entries<true>(st, stp, ref, base, nc_base, slots, qends,
                                  N, P, B, plan, spr, tb, n_pad, score3, nc3,
                                  sums_out, device, (cudaStream_t)stream);
}

// B2: parts is [4, grid, B] int32.
int usher_placement_partials(const void* st, const void* stp, const void* ref,
                             const void* base, const void* nc_base,
                             const void* slots, const void* qends, long long N,
                             int P, int B, int rows, int stages, int vec,
                             int lanes, int grid, const void* nodemeta,
                             void* parts, int device, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N < 0) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const bool fused = ref != nullptr;
  if (!fused && (base == nullptr || nc_base == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan plan{rows, stages, vec, lanes, grid};
  Ring ring;
  size_t smem;
  cudaError_t err = make_ring(st, stp, N, P, plan, fused, &ring, &smem);
  if (err != cudaSuccess) return (int)err;
  const bool chunked = rows % 4 == 0;
  err = chunked ? set_smem(placement_partials_kernel<4>, smem)
                : set_smem(placement_partials_kernel<1>, smem);
  if (err != cudaSuccess) return (int)err;
#define USHER_LAUNCH(RC)                                                      \
  placement_partials_kernel<RC><<<(unsigned)grid, kThreads, smem,             \
                                  (cudaStream_t)stream>>>(                    \
      (const uint8_t*)st, (const uint8_t*)stp, (const uint8_t*)ref,           \
      (const int32_t*)base, (const int32_t*)nc_base, (const int4*)nodemeta,   \
      (const uint32_t*)slots, (const int32_t*)qends, ring, B, lanes,          \
      (int32_t*)parts)
  if (chunked) {
    USHER_LAUNCH(4);
  } else {
    USHER_LAUNCH(1);
  }
#undef USHER_LAUNCH
  return (int)cudaGetLastError();
}

#ifdef USHER_PROFILE
// out: kProfBlocks x 8 cycle sums of the last B1 launch.
int usher_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, usher_prof, sizeof(usher_prof));
}
#endif

const char* usher_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
