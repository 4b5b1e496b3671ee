// The evaluator's fused pass and the analyzer's segment replay for Hopper
// (sm_90a).
//
// fused_eval replaces the jitted `fused` function that `_build_fused_fn`
// builds (src/repro/core/evaluator.py:97-179): one segment-sum replays the
// batch's float32 contribution stream into B rows of `buf_len` cells, then
// each row's resource times, stage time, first-max bottleneck, GLB-overflow
// penalty, delay and five-way energy come out of the row, in f32 and in the
// order evaluator.py:131-177 computes them.
//
// segment_replay replaces `_jax_replay` (src/repro/core/analyzer.py:60-92):
// segment_sum(vals, idx, n) of an int64 index stream and a float64 value
// stream.  It adds in float64, as the interface's types ask; the reference
// runs float32 under jax's default x32.
//
// What bounds them: every stream entry is read once and added once, and a
// row's cells are read once; there is no reuse to exploit, so both are
// bound by bytes (8 bytes an entry for fused_eval, 16 for segment_replay,
// over the card's HBM rate).  At the batch sizes the search gives (a few
// to a hundred rows of a few hundred cells, streams of 10^3-10^5 entries)
// launch latency is far larger than that bound, so fused_eval is one
// launch that keeps everything between its inputs and its outputs on chip
// (two for the widest rows, below).
//
// fused_eval's design: one block of kThreads threads per row.  The row is
// summed in a fixed order, so the same inputs give the same bits on every
// run (a supervised sweep's shard children must write the records a clean
// run writes).  The block keeps n_copies copies of the row's buf_len cells
// in dynamic shared memory, one for each of its first n_copies warps (16,
// or as many as fit the block's shared memory: one for the widest rows),
// zeroes them, and those warps stream the block's slice [off[b], off[b+1])
// of the row-local index stream in with read-once loads (__ldcs), kUnroll
// entries a lane in flight, warp w taking entries w*32 .. w*32+31 of
// every n_copies*32.  One cell takes up to 4-6 % of a row's entries, and
// the 32 entries of a warp's load hold about six for one cell on average
// (chip_smoke.py's max_cell_share and warp_same_cell_mean), so a warp
// first sums the entries it holds for the same cell (__match_any_sync,
// then a tree over the peers, always in the same lane order) and one lane
// adds the sum to the warp's own copy: no other warp touches that copy, so
// no atomic is needed and each cell takes its adds in the warp's program
// order.  After a barrier every cell sums its copies in warp order into
// copy 0.  512 threads with 4 entries a lane, and the aggregation, come
// from benchmarks/port_kernel_variants.py's fused_eval lines, measured
// when all 16 warps added into one copy with shared-memory atomics (an
// order that changed from launch to launch once several blocks shared an
// SM).  A row too wide for 16 copies (above a sixteenth of the block's
// shared memory: 3,619 cells on an H100) would stream through fewer
// warps; the caller then gives splits = ceil(16 / n_copies) parts: a
// first launch of B * splits blocks sums part k of each row (the k-th
// of splits equal runs of its entries) into the part's slot of a scratch
// buffer, and a second launch of B blocks sums a row's slots in part
// order into shared memory and goes on as below.  The parts depend on
// buf_len and the card only, never on B, so a row's bits do not depend
// on the batch it came in.  Then each thread strides over the row's
// spans (core time, the edges with their amortized part split by the D2D
// mask into NoC and D2D, the DRAM ports with theirs, the GLB footprint
// against capacity, the MACs, the core inputs), keeps four maxima and six
// sums; each warp reduces them with shuffles, warp 0 the warps' partials,
// and thread 0 finishes the row from them and from the row's small inputs
// (read into shared memory while the cells are zeroed).  There is no
// memset and no padding, and no scratch in device memory outside the
// split rows' parts: an empty row
// (off[b] == off[b+1]) is a row of zeros.  An index outside [0, buf_len)
// is skipped (the analyzer never emits one; the CPU plain version raises
// on it).  A row above 48 KB of cells opts in to the larger dynamic shared
// memory; one above the block's limit (fused_eval_max_cells, one copy) is
// refused by the wrapper.  Ties between the four times go to the first
// maximum, as `jnp.argmax` does.  The row sums are taken in another order
// than the reference's, so results agree with it within float32 rounding
// (the reference's parity envelope is 1e-4 relative), never bit for bit;
// run to run they agree to the bit (the order depends only on the row's
// stream, buf_len and the card's shared memory).
//
// segment_replay sums each cell's entries in stream order, so the same
// stream gives the same bits on every run, equal to a serial scatter-add
// (np.bincount's order).  The cells are cut into ranges, one block a range,
// one thread a cell: 512 cells a block, or fewer (down to 32) where 512
// would leave SMs idle (replay_cells_per_block).  A first launch
// (replay_ranges) finds, for every range, the first and last stream
// position holding one of its cells (replay_ranges says how).  A second
// launch (replay_cells) walks only [first, last] of the stream, in tiles
// of 2,048 entries, and sorts each tile's entries of its cells stably in
// shared memory, first by the warp that owns the cell, then, within each
// warp's stretch, by the owning lane; then each lane adds its cell's run
// in order: the 512 cells' dependent chains run side by side, where PR
// 26's design had warp 0 add one packed list 32 entries at a time.  Each
// block leaves its two range entries as it found them (kReplayUnset), so
// a scratch the caller keeps needs no memset between launches.  What
// bounds it is the sorting: every entry of a block's stretch takes part
// in it, and the analyzer's streams run row after row with a row's cells
// in no order, so a block reads its rows whole (a row of 514-952 cells
// once or twice at 512 cells a block).  Per tile, the ballots that rank
// entries and the walks of the runs each took about half the time of the
// tile's work (variants measured on an H100, PERF.md), and the tile's work
// outweighs its loads several times over.  index_add_ takes 2.5-4x less at
// the analyzer's streams by adding with atomics in no fixed order, which
// a replay that must repeat its bits cannot.  An index outside
// [0, n_cells) is skipped.  The adds are float64, as the interface's types
// ask.
//
// The spans, the D2D mask and the constants (bandwidths, GLB capacity,
// unit energies) are fixed per evaluator: the caller uploads them once.

#include <cuda_runtime.h>

namespace {

// accumulation targets, in the analyzer's layout order (analyzer.py T_*)
enum {
  T_CORE_MACS, T_EDGE, T_EDGE_AM, T_DRAM, T_DRAM_AM, T_GLB, T_CORE_IN,
  T_CORE_OUT, T_CORE_TIME, T_GLB_RW, N_TARGETS
};
// slots of the constants array (fused_eval.py CONSTS)
enum {
  C_NOC_BW, C_D2D_BW, C_DRAM_PORT_BW, C_DRAM_BW, C_GLB_CAP, C_GLB_TOTAL,
  C_E_MAC, C_E_GLB, C_E_NOC, C_E_D2D, C_E_DRAM, N_CONSTS
};
// rows of the output (fused_eval.py OUT_ROWS)
enum {
  O_DELAY, O_ENERGY, O_STAGE, O_OVERFLOW, O_E_MAC, O_E_GLB, O_E_NOC,
  O_E_D2D, O_E_DRAM
};
// per-thread partials: four maxima, then six sums
enum {
  A_COMP, A_NOC, A_D2D, A_DRAM, S_NOC, S_D2D, S_DRAM, S_MACS, S_IN, S_OVER,
  N_ACC
};

constexpr int kThreads = 512;    // fused_eval's block: one row
constexpr int kUnroll = 4;       // stream entries a lane has in flight
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;   // dynamic smem without opt-in
constexpr int kMaxDevices = 64;

constexpr int kReplayThreads = 512;
constexpr int kReplayWarps = kReplayThreads / 32;
constexpr int kReplayPer = 4;         // entries a thread takes a tile
constexpr int kReplayTile = kReplayThreads * kReplayPer;
constexpr int kReplaySlots = kReplayPer * kReplayWarps;  // (round, warp)
// the most cells a block (cell c is lane c / 16 of warp c % 16's) and the
// fewest: a launch takes the most that still gives every SM a block
constexpr int kReplayCells = 512;
constexpr int kReplayMinCells = 32;
static_assert(kReplayCells <= kReplayThreads, "one thread a cell");
static_assert(kReplaySlots == 64, "the scan takes two slots a lane");
// a range with no entry: below any position (0x80 in every byte)
constexpr int kReplayUnset = static_cast<int>(0x80808080u);

constexpr int kRangeThreads = 256;
constexpr int kRangePer = 2;          // entries a thread
constexpr int kRangeTile = kRangeThreads * kRangePer;
constexpr int kRangeWindow = 32;      // ranges a block keeps in shared memory

// ranges[2k] = max over range k's entries of -position, ranges[2k+1] = max
// of position (both start at kReplayUnset, below any of them; a range with
// no entry keeps it).  A block takes kRangeTile consecutive entries, round
// r of thread t entry r * kRangeThreads + t: each warp's 32 consecutive
// entries of one range give their first and last lane at once
// (__match_any_sync); the block keeps the maxima of the kRangeWindow
// ranges from its least one on in shared memory and adds them to the
// global ones at the end, one atomic pair a range (a range's entries sit
// in one stretch of the analyzer's streams, so a block sees a few ranges
// and the global atomics stay few); an entry of a range past the window
// takes the global atomics itself.  Integer maxima: the result does not
// depend on their order.
__global__ void __launch_bounds__(kRangeThreads)
replay_ranges(const long long* __restrict__ idx, int n, long long n_cells,
              int cells, int* __restrict__ ranges) {
  __shared__ int s_first[kRangeWindow], s_last[kRangeWindow];
  __shared__ int s_k0;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kRangeTile;
  int k[kRangePer];
  int kmin = 0x7fffffff;
#pragma unroll
  for (int r = 0; r < kRangePer; ++r) {
    const long long p = base + r * kRangeThreads + tid;
    const long long c = p < n ? __ldg(idx + p) : -1;
    k[r] = (c >= 0 && c < n_cells) ? static_cast<int>(c / cells) : -1;
    if (k[r] >= 0) kmin = min(kmin, k[r]);
  }
  if (tid < kRangeWindow) s_first[tid] = s_last[tid] = kReplayUnset;
  if (tid == 0) s_k0 = 0x7fffffff;
  __syncthreads();
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  if (lane == 0) atomicMin(&s_k0, kmin);
  __syncthreads();
  const int k0 = s_k0;
#pragma unroll
  for (int r = 0; r < kRangePer; ++r) {
    const int key = k[r] >= 0 ? k[r] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key < 0 || lane != __ffs(peers) - 1) continue;
    // positions < n fit an int
    const int at = static_cast<int>(base + r * kRangeThreads + tid);
    const int first = at, last = at + (31 - __clz(peers)) - lane;
    if (key - k0 < kRangeWindow) {
      atomicMax(s_first + (key - k0), -first);
      atomicMax(s_last + (key - k0), last);
    } else {
      atomicMax(ranges + 2 * key, -first);
      atomicMax(ranges + 2 * key + 1, last);
    }
  }
  __syncthreads();
  if (tid < kRangeWindow && s_last[tid] != kReplayUnset) {
    atomicMax(ranges + 2 * (k0 + tid), s_first[tid]);
    atomicMax(ranges + 2 * (k0 + tid) + 1, s_last[tid]);
  }
}

// Block k owns cells k * cells .. + cells - 1 (local cell c to lane c / 16
// of warp c % 16) and walks [first, last] of its range in tiles of
// kReplayTile entries: thread t takes entries t, t + 512, t + 1024 and
// t + 1536 of a tile (round r, warp and lane give the stream order).  Per
// tile the block sorts the kept entries by owner warp (c % 16), stably: in
// each round each warp ranks its entries of an owner by lane (five
// ballots: the owner's four bits and whether the entry is kept) and the
// first such lane writes their count to counts[owner][16 r + warp]; a
// block scan of the counts, owner-major, gives each entry its place in its
// owner's stretch of the list.  Each warp then sorts its stretch by owner
// lane (c / 16) the same way, 32 entries at a time (six ballots give each
// lane its cell's entries and each entry its rank among them; the lanes'
// counts first, then the places), and each lane adds its cell's run in
// order into its running sum.  Each block resets its two range entries to
// kReplayUnset once every thread has read them, for the next launch.
__global__ void __launch_bounds__(kReplayThreads)
replay_cells(const long long* __restrict__ idx,
             const double* __restrict__ vals, long long n_cells, int cells,
             int* __restrict__ ranges, double* __restrict__ out) {
  // two tiles' counts (a warp zeroes its row of one tile's while the next
  // tile's are written), then, in place, the owners' places
  // (a row padded by one int, so that a warp's leaders, each of its own
  // owner, write to different banks)
  __shared__ int counts[2][kReplayWarps][kReplaySlots + 1];
  __shared__ short list_c[kReplayTile];         // local cells < 512
  __shared__ double list_v[kReplayTile];
  __shared__ double run_v[kReplayTile];        // each lane's run in order
  __shared__ int warp_tot[kReplayWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * cells;
  const long long left = n_cells - c0;
  const int nc = left < cells ? static_cast<int>(left) : cells;
  const int lo = -ranges[2 * blockIdx.x];
  const int hi = ranges[2 * blockIdx.x + 1];     // < 0: no entry
  for (int e = tid; e < 2 * kReplayWarps * (kReplaySlots + 1);
       e += kReplayThreads)
    (&counts[0][0][0])[e] = 0;
  __syncthreads();                    // every thread has read the range
  if (tid == 0) {
    ranges[2 * blockIdx.x] = kReplayUnset;
    ranges[2 * blockIdx.x + 1] = kReplayUnset;
  }
  // this thread's entries of a tile (cells local to the block)
  long long c[kReplayPer];
  double v[kReplayPer];
  auto load = [&](long long base) {
#pragma unroll
    for (int r = 0; r < kReplayPer; ++r) {
      const long long p = base + r * kReplayThreads + tid;
      c[r] = -1;
      v[r] = 0.0;
      if (p <= hi) {
        c[r] = __ldg(idx + p) - c0;
        v[r] = __ldg(vals + p);
      }
    }
  };
  if (hi >= 0) load(lo);
  double acc = 0.0;                   // the sum of cell 16 lane + warp
  int buf = 0;
  for (long long base = lo; hi >= 0 && base <= hi;
       base += kReplayTile, buf ^= 1) {
    int cell[kReplayPer], rank[kReplayPer];
    double val[kReplayPer];
#pragma unroll
    for (int r = 0; r < kReplayPer; ++r) {
      cell[r] = (c[r] >= 0 && c[r] < nc) ? static_cast<int>(c[r]) : -1;
      val[r] = v[r];
    }
    load(base + kReplayTile);         // the next tile, in flight
    int(*cnt)[kReplaySlots + 1] = counts[buf];
#pragma unroll
    for (int r = 0; r < kReplayPer; ++r) {
      const bool kept = cell[r] >= 0;
      unsigned peers = __ballot_sync(0xffffffffu, kept);
#pragma unroll
      for (int bit = 0; bit < 4; ++bit) {
        const bool on = kept && ((cell[r] >> bit) & 1);
        const unsigned b = __ballot_sync(0xffffffffu, on);
        peers &= on ? b : ~b;
      }
      rank[r] = __popc(peers & ((1u << lane) - 1u));
      if (kept && rank[r] == 0)
        cnt[cell[r] & 15][r * kReplayWarps + warp] = __popc(peers);
    }
    __syncthreads();
    // warp w scans owner w's 64 slots, two a lane; then the owners' totals
    int* row = cnt[warp];
    const int a0 = row[2 * lane], a1 = row[2 * lane + 1];
    int incl = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0) warp_tot[warp] = total;
    __syncthreads();
    int wt = lane < kReplayWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wt, o);
      if (lane >= o) wt += t;
    }
    const int prev = __shfl_sync(0xffffffffu, wt, (warp + 31) & 31);
    const int start = warp > 0 ? prev : 0;    // owner warp's stretch
    row[2 * lane] = start + incl - a0 - a1;
    row[2 * lane + 1] = start + incl - a1;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kReplayPer; ++r)
      if (cell[r] >= 0) {             // its place in its owner's stretch
        const int at = cnt[cell[r] & 15][r * kReplayWarps + warp] + rank[r];
        list_c[at] = static_cast<short>(cell[r]);
        list_v[at] = val[r];
      }
    __syncthreads();
    row[2 * lane] = row[2 * lane + 1] = 0;   // for the tile after next
    // the warp sorts its stretch by owner lane (cell / 16), stably, 32
    // entries at a time (five ballots give each lane the entries of its
    // cell and each entry its rank among them), counting first, then
    // placing; then each lane adds its run in order
    const int end = start + total;
    auto owners = [&](int k, int& o, unsigned& mine_mask,
                      unsigned& same_mask) {
      o = k + lane < end ? list_c[k + lane] >> 4 : -1;
      unsigned valid = __ballot_sync(0xffffffffu, o >= 0);
      mine_mask = same_mask = valid;
#pragma unroll
      for (int bit = 0; bit < 5; ++bit) {
        const bool on = o >= 0 && (o >> bit) & 1;
        const unsigned b = __ballot_sync(0xffffffffu, on);
        mine_mask &= (lane >> bit) & 1 ? b : ~b;
        same_mask &= on ? b : ~b;
      }
    };
    int count = 0;
    for (int k = start; k < end; k += 32) {
      int o;
      unsigned mine_mask, same_mask;
      owners(k, o, mine_mask, same_mask);
      count += __popc(mine_mask);
    }
    int before = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += t;
    }
    const int first = start + before - count;   // this lane's run
    int placed = first;
    for (int k = start; k < end; k += 32) {
      int o;
      unsigned mine_mask, same_mask;
      owners(k, o, mine_mask, same_mask);
      const int at = __shfl_sync(0xffffffffu, placed, o >= 0 ? o : lane) +
                     __popc(same_mask & ((1u << lane) - 1u));
      if (o >= 0) run_v[at] = list_v[k + lane];
      placed += __popc(mine_mask);
    }
    __syncwarp();
    for (int k = first; k < first + count; ++k) acc += run_v[k];
  }
  const int mine = 16 * lane + warp;
  if (mine < nc) out[c0 + mine] = acc;
}

__device__ __forceinline__ bool is_max(int a) { return a < S_NOC; }

// Add v into cells[c] once for each distinct c among the warp's lanes
// (c < 0: nothing to add); `cells` is this warp's own copy.  Every lane of
// the warp calls it.  The lanes that hold the same cell first sum their
// values in a tree, log2 of their count rounds (the lowest lane ends with
// the sum), and that lane adds it; the closing __syncwarp orders the
// warp's adds to one cell from one call to the next.
__device__ __forceinline__ void add_peers(float* cells, int c, float v,
                                          int lane) {
  unsigned peers = __match_any_sync(0xffffffffu, c);
  const int first = __ffs(peers) - 1;
  int rel = __popc(peers & ((1u << lane) - 1u));   // peers below this lane
  peers &= ~((2u << lane) - 1u);                   // peers above it
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);                 // 0: none left
    const float t = __shfl_sync(0xffffffffu, v, (next - 1) & 31);
    if (next) v += t;
    peers &= ~__ballot_sync(0xffffffffu, rel & 1);
    rel >>= 1;
  }
  if (c >= 0 && lane == first) cells[c] += v;
  __syncwarp();
}

// One row's entry i, or (a key no other lane holds, 0) past the row's end
// or off its cells.
__device__ __forceinline__ void load_entry(const int* __restrict__ idx,
                                           const float* __restrict__ vals,
                                           long long i, long long hi,
                                           int buf_len, int lane, int& c,
                                           float& v) {
  c = -1 - lane;
  v = 0.f;
  if (i < hi) {
    const int k = __ldcs(idx + i);
    v = __ldcs(vals + i);
    if (static_cast<unsigned>(k) < static_cast<unsigned>(buf_len)) c = k;
  }
}

// What one launch of fused_rows does: a whole row a block (ROW), part
// `blockIdx.x % splits` of row `blockIdx.x / splits` into that part's
// slot of `partial` (PART), or a row from its parts' slots (FINISH).
enum { ROW, PART, FINISH };

__global__ void __launch_bounds__(kThreads)
fused_rows(const int* __restrict__ off, const int* __restrict__ idx,
           const float* __restrict__ vals, long long n, int buf_len,
           const int* __restrict__ spans, const float* __restrict__ d2d_mask,
           const float* __restrict__ consts, int has_d2d,
           const int* __restrict__ npass, const int* __restrict__ depth,
           const float* __restrict__ wts, int B, int n_copies, int splits,
           int mode, float* __restrict__ partial,
           float* __restrict__ out, int* __restrict__ bottleneck) {
  extern __shared__ float row[];      // n_copies copies of buf_len cells
  __shared__ int sp[2 * N_TARGETS];
  __shared__ float sc[N_CONSTS];
  __shared__ float s_wts;
  __shared__ int s_npass, s_depth;
  __shared__ float part[kWarps][N_ACC];
  const int b = mode == PART ? blockIdx.x / splits : blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the row's small inputs, each from its own warp, in flight while the
  // block zeroes its cells
  if (tid < 2 * N_TARGETS) {
    sp[tid] = spans[tid];
  } else if (tid >= 32 && tid < 32 + N_CONSTS) {
    sc[tid - 32] = consts[tid - 32];
  } else if (tid == 64) {
    s_npass = npass[b];
    s_depth = depth[b];
    s_wts = wts[b];
  }
  long long lo = off[b], hi = off[b + 1];
  lo = lo < 0 ? 0 : lo;
  hi = hi > n ? n : hi;
  if (mode == PART) {                 // this part's share of the entries
    const long long per = (hi - lo + splits - 1) / splits;
    const long long start = lo + (blockIdx.x % splits) * per;
    lo = start < hi ? start : hi;
    hi = lo + per < hi ? lo + per : hi;
  }
  if (mode == FINISH) {               // the parts' sums, in part order
    const float* p = partial + static_cast<long long>(b) * splits * buf_len;
    for (int i = tid; i < buf_len; i += kThreads) {
      float t = __ldcg(p + i);
      for (int k = 1; k < splits; ++k)
        t += __ldcg(p + static_cast<long long>(k) * buf_len + i);
      row[i] = t;
    }
  } else {
    const int n_cells = n_copies * buf_len;
    for (int i = tid; i < n_cells; i += kThreads) row[i] = 0.f;
  }
  __syncthreads();
  // this thread's first edge's D2D flag, read while the stream streams
  const int e0 = sp[2 * T_EDGE], ea = sp[2 * T_EDGE_AM];
  const int ne = sp[2 * T_EDGE + 1] - e0;
  const float mask0 = tid < ne ? d2d_mask[tid] : 0.f;

  // the row's stream, kUnroll entries a lane in flight, into this warp's
  // copy; the loop bounds are the same for the 32 lanes of a warp
  const int warp = tid >> 5;
  if (mode != FINISH && warp < n_copies) {
    float* mine = row + warp * buf_len;
    const int span = 32 * n_copies;
    for (long long base = lo + 32 * warp; base < hi;
         base += kUnroll * span) {
      int c[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_entry(idx, vals, base + u * span + lane, hi, buf_len, lane,
                   c[u], v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * span < hi) add_peers(mine, c[u], v[u], lane);
    }
  }
  __syncthreads();
  // the copies, summed in warp order into copy 0 (a part's sum goes to
  // its slot instead)
  if (mode == PART) {
    float* p = partial + static_cast<long long>(blockIdx.x) * buf_len;
    for (int i = tid; i < buf_len; i += kThreads) {
      float t = row[i];
      for (int w = 1; w < n_copies; ++w) t += row[w * buf_len + i];
      __stcg(p + i, t);
    }
    return;
  }
  if (mode == ROW && n_copies > 1) {
    for (int i = tid; i < buf_len; i += kThreads) {
      float t = row[i];
      for (int w = 1; w < n_copies; ++w) t += row[w * buf_len + i];
      row[i] = t;
    }
    __syncthreads();
  }

  float acc[N_ACC];
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) acc[a] = 0.f;   // max with initial 0.0

  for (int i = sp[2 * T_CORE_TIME] + tid; i < sp[2 * T_CORE_TIME + 1];
       i += kThreads)
    acc[A_COMP] = fmaxf(acc[A_COMP], row[i]);
  for (int j = tid; j < ne; j += kThreads) {
    const float tot = row[e0 + j] + row[ea + j];
    const bool d2d = (j == tid ? mask0 : d2d_mask[j]) != 0.f;
    const float noc = d2d ? 0.f : tot;
    const float dd = d2d ? tot : 0.f;
    acc[A_NOC] = fmaxf(acc[A_NOC], noc);
    acc[A_D2D] = fmaxf(acc[A_D2D], dd);
    acc[S_NOC] += noc;
    acc[S_D2D] += dd;
  }
  const int d0 = sp[2 * T_DRAM], da = sp[2 * T_DRAM_AM];
  const int nd = sp[2 * T_DRAM + 1] - d0;
  for (int j = tid; j < nd; j += kThreads) {
    acc[A_DRAM] = fmaxf(acc[A_DRAM], row[d0 + j] + row[da + j]);
    acc[S_DRAM] += row[d0 + j];
  }
  const float glb_cap = sc[C_GLB_CAP];
  for (int i = sp[2 * T_GLB] + tid; i < sp[2 * T_GLB + 1]; i += kThreads)
    acc[S_OVER] += fmaxf(row[i] - glb_cap, 0.f);
  for (int i = sp[2 * T_CORE_MACS] + tid; i < sp[2 * T_CORE_MACS + 1];
       i += kThreads)
    acc[S_MACS] += row[i];
  for (int i = sp[2 * T_CORE_IN] + tid; i < sp[2 * T_CORE_IN + 1];
       i += kThreads)
    acc[S_IN] += row[i];

  // each warp's partials, then warp 0 over the warps' partials
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) {
    float v = acc[a];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max(a) ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) part[tid >> 5][a] = v;
  }
  __syncthreads();
  if (tid >= 32) return;
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) {
    float v = lane < kWarps ? part[lane][a] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max(a) ? fmaxf(v, w) : v + w;
    }
    acc[a] = v;
  }
  if (tid != 0) return;

  // evaluator.py:143-177, in its order
  const float t_comp = acc[A_COMP];
  const float t_noc = acc[A_NOC] / sc[C_NOC_BW];
  const float t_d2d = has_d2d ? acc[A_D2D] / sc[C_D2D_BW] : 0.f;
  const float t_dram = acc[A_DRAM] / sc[C_DRAM_PORT_BW];
  const float times[4] = {t_comp, t_noc, t_d2d, t_dram};
  int bi = 0;
  float bv = times[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (times[k] > bv) {            // first maximum, as jnp.argmax
      bi = k;
      bv = times[k];
    }
  float stage = fmaxf(bv, 1e-12f);
  const float overflow = acc[S_OVER];
  const float spill = overflow * 2.f;
  stage = stage * (1.f + overflow / sc[C_GLB_TOTAL]);
  stage = stage + spill / sc[C_DRAM_BW];
  const float np_f = static_cast<float>(s_npass);
  const float delay = stage * (np_f + static_cast<float>(s_depth) - 1.f);

  const float noc_bytes = acc[S_NOC] * np_f;
  const float d2d_bytes = acc[S_D2D] * np_f;
  const float dram_b = acc[S_DRAM] * np_f + s_wts + spill * np_f;
  const float macs = acc[S_MACS] * np_f;
  const int rw = sp[2 * T_GLB_RW];
  const float e_mac = macs * sc[C_E_MAC];
  const float e_glb =
      (row[rw] + row[rw + 1] + acc[S_IN]) * np_f * sc[C_E_GLB];
  const float e_noc = (noc_bytes + d2d_bytes) * sc[C_E_NOC];
  const float e_d2d = d2d_bytes * sc[C_E_D2D];
  const float e_dram = dram_b * sc[C_E_DRAM];
  const float energy = e_mac + e_glb + e_noc + e_d2d + e_dram;

  out[O_DELAY * B + b] = delay;
  out[O_ENERGY * B + b] = energy;
  out[O_STAGE * B + b] = stage;
  out[O_OVERFLOW * B + b] = overflow;
  out[O_E_MAC * B + b] = e_mac;
  out[O_E_GLB * B + b] = e_glb;
  out[O_E_NOC * B + b] = e_noc;
  out[O_E_D2D * B + b] = e_d2d;
  out[O_E_DRAM * B + b] = e_dram;
  bottleneck[b] = bi;
}

// the dynamic shared memory fused_rows may take on each device so far
int g_smem_set[kMaxDevices] = {0};
// fused_eval_max_cells of each device, once known (0: not yet)
int g_max_cells[kMaxDevices] = {0};

}  // namespace

extern "C" {

// The most cells a fused_eval row may have on `device` (the block's
// opt-in shared memory less fused_rows' static shared memory, in floats),
// or the negated cudaError_t.
int fused_eval_max_cells(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_rows);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (optin - static_cast<int>(attr.sharedSizeBytes)) /
         static_cast<int>(sizeof(float));
}

// Launch on `stream` (a cudaStream_t from the caller) and return the
// launch's cudaError_t: 0 when it was accepted.  Row b's entries are
// idx[off[b]:off[b+1]] (cells 0 .. buf_len-1 of that row) and the same
// slice of vals; n is the streams' length.  `out` is (9, B) f32 in
// OUT_ROWS order and `bottleneck` (B,) int32.  Each block sums its
// entries into n_copies copies of the row (1 .. 16; n_copies * buf_len
// cells must fit fused_eval_max_cells).  splits == 1: one launch of B
// blocks.  splits > 1: B * splits blocks each sum a part of a row's
// entries into `partial` (B * splits * buf_len floats on the card), then
// B blocks sum each row's parts in part order and finish the rows.
int fused_eval_f32(const void* off, const void* idx, const void* vals,
                   long long n, int B, int buf_len, const void* npass,
                   const void* depth, const void* wts, const void* spans,
                   const void* d2d_mask, const void* consts, int has_d2d,
                   int n_copies, int splits, void* partial, void* out,
                   void* bottleneck, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices || B < 1 || buf_len < 1 ||
      n_copies < 1 || n_copies > kWarps || splits < 1 ||
      static_cast<long long>(B) * splits > 0x7fffffffLL ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_max_cells[device] == 0) {
    const int cells = fused_eval_max_cells(device);
    if (cells < 0) return -cells;
    g_max_cells[device] = cells;
  }
  if (static_cast<long long>(n_copies) * buf_len > g_max_cells[device])
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = n_copies * buf_len * static_cast<int>(sizeof(float));
  if (smem > kDefaultSmem && smem > g_smem_set[device]) {
    err = cudaFuncSetAttribute(
        fused_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[device] = smem;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ioff = static_cast<const int*>(off);
  const int* iidx = static_cast<const int*>(idx);
  const float* fvals = static_cast<const float*>(vals);
  const int* isp = static_cast<const int*>(spans);
  const float* fmask = static_cast<const float*>(d2d_mask);
  const float* fc = static_cast<const float*>(consts);
  const int* inp = static_cast<const int*>(npass);
  const int* idp = static_cast<const int*>(depth);
  const float* fw = static_cast<const float*>(wts);
  float* fp = static_cast<float*>(partial);
  float* fo = static_cast<float*>(out);
  int* ibn = static_cast<int*>(bottleneck);
  if (splits == 1) {
    fused_rows<<<B, kThreads, smem, st>>>(
        ioff, iidx, fvals, n, buf_len, isp, fmask, fc, has_d2d, inp, idp,
        fw, B, n_copies, 1, ROW, fp, fo, ibn);
    return static_cast<int>(cudaGetLastError());
  }
  fused_rows<<<B * splits, kThreads, smem, st>>>(
      ioff, iidx, fvals, n, buf_len, isp, fmask, fc, has_d2d, inp, idp, fw,
      B, n_copies, splits, PART, fp, fo, ibn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_rows<<<B, kThreads, buf_len * sizeof(float), st>>>(
      ioff, iidx, fvals, n, buf_len, isp, fmask, fc, has_d2d, inp, idp, fw,
      B, 1, splits, FINISH, fp, fo, ibn);
  return static_cast<int>(cudaGetLastError());
}

// The cells one block of segment_replay owns at n_cells on `device`: the
// most, 32 to 512 (a power of two), that still give every SM a block (0 on
// a bad device).
int replay_cells_per_block(long long n_cells, int device) {
  int sms = 0;
  if (device < 0 || device >= kMaxDevices ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || sms < 1)
    return 0;
  int cells = kReplayCells;
  while (cells > kReplayMinCells && (n_cells + cells - 1) / cells < sms)
    cells /= 2;
  return cells;
}

// out (n_cells,) float64 = segment_sum(vals, idx, n_cells), each cell's
// entries added in stream order.  `ranges` is scratch of at least 2 *
// ceil(n_cells / 32) ints on the card, each kReplayUnset: `init` != 0
// sets them first (a fresh scratch); every launch leaves them so.
// n < 2^31 entries.
int segment_replay_f64(const void* idx, const void* vals, long long n,
                       void* out, long long n_cells, void* ranges, int init,
                       int device, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || n_cells < 1 || ranges == nullptr ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = replay_cells_per_block(n_cells, device);
  if (cells < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const long long blocks = (n_cells + cells - 1) / cells;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (init) {
    err = cudaMemsetAsync(ranges, 0x80,
                          2 * ((n_cells + kReplayMinCells - 1) /
                               kReplayMinCells) * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long* iidx = static_cast<const long long*>(idx);
  int* rg = static_cast<int*>(ranges);
  if (n > 0) {
    const unsigned grid =
        static_cast<unsigned>((n + kRangeTile - 1) / kRangeTile);
    replay_ranges<<<grid, kRangeThreads, 0, st>>>(iidx, static_cast<int>(n),
                                                  n_cells, cells, rg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  replay_cells<<<static_cast<int>(blocks), kReplayThreads, 0, st>>>(
      iidx, static_cast<const double*>(vals), n_cells, cells, rg,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
