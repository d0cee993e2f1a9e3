// The MemGraph insert's claim step for one chunk of vertex keys: the
// deduplication and every claim round of core/memgraph.py's insert, in one
// cooperative launch after one sort.
//
// Replaces no TPU kernel: the JAX package runs these rounds as jnp under
// lax.while_loop (src/repro/core/memgraph.py::_find_or_insert_rows), after
// jnp.unique.  The plain version (kernels/hash_claim.py::claim_rows_ref)
// runs them as torch ops in a host loop: every round reads resolved.all()
// and indexes five tensors by boolean masks, each a nonzero that waits for
// the device, about 30 host round trips and 120 launches a chunk on a card.
//
// Deduplication: from the keys sorted (s) and the sort's permutation
// (perm), a key that starts a run of equal keys takes the next unique
// index; ukeys[run] = s[i], inv[perm[i]] = run, and ukeys is padded with
// INVALID_VID: torch.unique(sorted=True, return_inverse=True), padded, with
// no output size to learn.
//
// The claim rule, kept round for round (rows must equal the reference slot
// for slot): an open key probes slot (hash(key) + probe) % hcap of the
// table as it stood when the round began.  Its own key there resolves it
// (hit); an empty slot makes it a claimant; a foreign key advances its
// probe.  Among the claimants of a slot the smallest unique index wins;
// winners take rows n_rows, n_rows + 1, ... in unique-index order; losers
// advance.  Rounds run while any key is open, at most kMaxRounds.
//
// What bounds it on an H100.  65,536 keys x about 5 rounds of random 4-byte
// probes into an 8 MB table (L2-resident), plus copying the two tables into
// the outputs (the MemGraph is functional: published states keep the old
// tables) and filling the owner scratch: 3 x 8 MB written, 2 x 8 MB read,
// about 12 us at 3.35 TB/s.  In practice the grid-wide barriers: two for
// the deduplication and two a round.  Design:
//   - one cooperative launch, its grid sized by occupancy to be
//     co-resident, grid-stride over the keys so that any chunk size works;
//     a block owns a contiguous range of positions and unique indices, so
//     a block scan plus the totals of the blocks before it ranks run starts
//     and winners in order;
//   - the owner scratch (one int a slot) is filled once, with the table
//     copies, and each claimant resets its own slot after the winner has
//     been read, never the whole 2^21 slots a round;
//   - a round's last phase (rows to the winners, owner reset) shares its
//     barrier with the next round's probe: every slot claimed in a round
//     holds its winner's key from that round's middle phase on, so the
//     next probes read it as taken and never claim a slot being reset, and
//     a row written there is read only by its own (resolved) key;
//   - data other blocks wrote during the launch is read with ld.global.cg
//     (L2), never from a possibly stale L1 line or the read-only path.
// Nothing reaches the host: ukeys, inv, n_rows, row, is_new, ok and the
// round count stay in device memory, and the caller reads ok and the
// rounds together at the one wait it already has.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 64;          // hash_claim.py MAX_PROBE_ROUNDS
constexpr int kMaxGrid = 2048;          // blocks; hash_claim.py _MAX_GRID
constexpr int32_t kInvalid = INT32_MAX; // an empty slot, a padding key
constexpr int32_t kNoOwner = INT32_MAX;
constexpr uint32_t kHashMult = 2654435761u;

struct Args {
  const int32_t* sorted;     // [u] the chunk's keys, sorted
  const int64_t* perm;       // [u] the sort's permutation
  int32_t* ukeys;            // [u] unique keys, INVALID_VID padding
  int64_t* inv;              // [u] unique index of each key
  const int32_t* key_in;     // [hcap]
  const int32_t* row_in;     // [hcap]
  const int32_t* n_rows_in;  // []
  int32_t* key_out;          // [hcap]
  int32_t* row_out;          // [hcap]
  int32_t* n_rows_out;       // []
  int32_t* row;              // [u] row of each key, -1 if none
  bool* is_new;              // [u]
  bool* ok;                  // [] every key resolved
  int32_t* rounds;           // [] rounds run
  int32_t* scratch;          // owner[hcap] probe[u] claim[u] rank[u]
                             // totals[kMaxGrid] flags[2]
  int u;
  int hcap;
  int tiles;                 // tiles of kThreads keys a block owns
};

// The block's exclusive count of `flag` before this thread, in thread
// order, plus `carry`; `carry` grows by the block's count.  Every thread of
// the block calls it.
__device__ __forceinline__ int32_t block_rank(bool flag, int32_t& carry,
                                              int32_t* warp_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  int32_t off = carry, tile = 0;
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? warp_cnt[w] : 0;
    tile += warp_cnt[w];
  }
  __syncthreads();   // warp_cnt is reused
  carry += tile;
  return off + __popc(ballot & ((1u << lane) - 1u));
}

__device__ __forceinline__ int32_t load_l2(const int32_t* p) {
  return __ldcg(p);
}

// (before, all): the sum of totals[0:blockIdx.x] and of totals[0:gridDim.x],
// for every thread of the block.
__device__ __forceinline__ void block_offsets(const int32_t* totals,
                                              int32_t (*red)[kWarps],
                                              int32_t& before, int32_t& all) {
  int32_t b = 0, a = 0;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += kThreads) {
    const int32_t t = load_l2(totals + k);
    a += t;
    b += k < static_cast<int>(blockIdx.x) ? t : 0;
  }
  for (int d = 16; d > 0; d >>= 1) {
    b += __shfl_down_sync(0xffffffffu, b, d);
    a += __shfl_down_sync(0xffffffffu, a, d);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = b;
    red[1][threadIdx.x >> 5] = a;
  }
  __syncthreads();
  before = 0;
  all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += red[0][w];
    all += red[1][w];
  }
  __syncthreads();   // red is reused
}

__global__ void __launch_bounds__(kThreads) hash_claim_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t warp_cnt[kWarps];
  __shared__ int32_t red[2][kWarps];
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t gs = static_cast<int64_t>(gridDim.x) * kThreads;
  int32_t* owner = a.scratch;
  int32_t* probe = owner + a.hcap;   // -1: resolved
  int32_t* claim = probe + a.u;      // slot claimed this round, or -1
  int32_t* rank = claim + a.u;       // rank among the block's winners, or -1
  int32_t* totals = rank + a.u;      // winners of each block this round
  int32_t* flags = totals + kMaxGrid;
  volatile int32_t* vflags = flags;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * a.tiles * kThreads;
  const uint32_t hcap = static_cast<uint32_t>(a.hcap);

  for (int64_t i = gt; i < a.hcap; i += gs) {
    a.key_out[i] = __ldg(a.key_in + i);
    a.row_out[i] = __ldg(a.row_in + i);
    owner[i] = kNoOwner;
  }
  // Deduplication: the block counts the runs that start in its positions
  // (rank holds each position's inclusive count) ...
  int32_t carry = 0;
  for (int j = 0; j < a.tiles; ++j) {
    const int64_t i = first + static_cast<int64_t>(j) * kThreads +
                      threadIdx.x;
    const bool start = i < a.u &&
        (i == 0 || __ldg(a.sorted + i) != __ldg(a.sorted + i - 1));
    const int32_t before = block_rank(start, carry, warp_cnt);
    if (i < a.u) rank[i] = before + start;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
  if (gt == 0) vflags[0] = 0;
  const int32_t n_rows_in = __ldg(a.n_rows_in);
  grid.sync();
  // ... then each position learns its run, every key its open state.
  {
    int32_t before, n_unique;
    block_offsets(totals, red, before, n_unique);
    for (int j = 0; j < a.tiles; ++j) {
      const int64_t i = first + static_cast<int64_t>(j) * kThreads +
                        threadIdx.x;
      if (i >= a.u) continue;
      const int32_t run = before + rank[i] - 1;
      const int32_t key = __ldg(a.sorted + i);
      a.inv[__ldg(a.perm + i)] = run;
      if (i == 0 || key != __ldg(a.sorted + i - 1)) {
        a.ukeys[run] = key;
        probe[run] = key == kInvalid ? -1 : 0;
        claim[run] = -1;
        a.row[run] = -1;
        a.is_new[run] = false;
      }
      if (i >= n_unique) {
        a.ukeys[i] = kInvalid;
        probe[i] = -1;
        claim[i] = -1;
        a.row[i] = -1;
        a.is_new[i] = false;
      }
    }
  }
  int32_t n_rows = n_rows_in;
  grid.sync();

  int r = 0;
  for (;; ++r) {
    // The last round's rows (its winners are ranked within their block,
    // the blocks' totals are all written) and the owner reset ...
    if (r > 0) {
      int32_t before, all;
      block_offsets(totals, red, before, all);
      for (int j = 0; j < a.tiles; ++j) {
        const int64_t i = first + static_cast<int64_t>(j) * kThreads +
                          threadIdx.x;
        if (i >= a.u) continue;
        const int32_t c = claim[i];
        if (c < 0) continue;
        if (rank[i] >= 0) {
          const int32_t rw = n_rows + before + rank[i];
          a.row[i] = rw;
          a.is_new[i] = true;
          a.row_out[c] = rw;
        }
        owner[c] = kNoOwner;
        claim[i] = -1;
      }
      n_rows += all;
    }
    // ... then this round's probe.  flags[(r + 1) & 1] was last read
    // before the previous round's second barrier.
    if (gt == 0) vflags[(r + 1) & 1] = 0;
    bool open = false;
    for (int j = 0; j < a.tiles; ++j) {
      const int64_t i = first + static_cast<int64_t>(j) * kThreads +
                        threadIdx.x;
      if (i >= a.u) continue;
      const int32_t p = probe[i];
      if (p < 0) continue;
      open = true;
      if (r == kMaxRounds) continue;
      const int32_t key = load_l2(a.ukeys + i);
      const uint32_t pos =
          (static_cast<uint32_t>(key) * kHashMult % hcap +
           static_cast<uint32_t>(p)) % hcap;
      const int32_t k = load_l2(a.key_out + pos);
      if (k == key) {
        a.row[i] = load_l2(a.row_out + pos);
        probe[i] = -1;
      } else if (k == kInvalid) {
        atomicMin(owner + pos, static_cast<int32_t>(i));
        claim[i] = static_cast<int32_t>(pos);
      } else {
        probe[i] = p + 1;
      }
    }
    if (open) vflags[r & 1] = 1;
    grid.sync();
    if (vflags[r & 1] == 0 || r == kMaxRounds) break;

    // Winners take their slot's key; losers advance; the block ranks its
    // winners in unique-index order.
    carry = 0;
    for (int j = 0; j < a.tiles; ++j) {
      const int64_t i = first + static_cast<int64_t>(j) * kThreads +
                        threadIdx.x;
      const int32_t c = i < a.u ? claim[i] : -1;
      bool win = false;
      if (c >= 0) {
        win = load_l2(owner + c) == static_cast<int32_t>(i);
        if (win) {
          a.key_out[c] = load_l2(a.ukeys + i);
          probe[i] = -1;
        } else {
          probe[i] += 1;
        }
      }
      const int32_t at = block_rank(win, carry, warp_cnt);
      if (c >= 0) rank[i] = win ? at : -1;
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = carry;
    grid.sync();
  }
  if (gt == 0) {
    *a.n_rows_out = n_rows;
    *a.rounds = r;
    *a.ok = vflags[r & 1] == 0;
  }
}

struct Grid {
  int sms = 0;
  int blocks = 0;   // co-resident blocks, capped at kMaxGrid
};

cudaError_t grid_of_current_device(Grid* out) {
  static Grid cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cache[dev].blocks > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  Grid g;
  err = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hash_claim_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  g.blocks = per_sm * g.sms < kMaxGrid ? per_sm * g.sms : kMaxGrid;
  if (g.blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < 64) cache[dev] = g;
  *out = g;
  return cudaSuccess;
}

}  // namespace

// One launch on `stream`, after the chunk's u keys were sorted (sorted,
// int32) with their permutation (perm, int64): ukeys/inv become
// torch.unique(keys, sorted=True, return_inverse=True) with ukeys padded by
// INVALID_VID, and key_out/row_out become key_in/row_in with every key of
// ukeys found or inserted; see the rules above.  scratch holds at least
// hcap + 3 u + kMaxGrid + 2 int32 words (owner, probe, claim, rank,
// totals, flags), with no initial value.
extern "C" int hash_claim_launch(
    const void* sorted, const void* perm, void* ukeys, void* inv,
    const void* key_in, const void* row_in, const void* n_rows_in,
    void* key_out, void* row_out, void* n_rows_out, void* row, void* is_new,
    void* ok, void* rounds, void* scratch, int u, int hcap,
    long long scratch_words, void* stream) {
  if (u < 0 || hcap < 1 ||
      scratch_words < static_cast<long long>(hcap) + 3LL * u + kMaxGrid + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid g;
  cudaError_t err = grid_of_current_device(&g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int key_tiles = (u + kThreads - 1) / kThreads;
  int blocks = key_tiles > g.sms ? key_tiles : g.sms;
  blocks = blocks < g.blocks ? blocks : g.blocks;
  Args a;
  a.sorted = static_cast<const int32_t*>(sorted);
  a.perm = static_cast<const int64_t*>(perm);
  a.ukeys = static_cast<int32_t*>(ukeys);
  a.inv = static_cast<int64_t*>(inv);
  a.key_in = static_cast<const int32_t*>(key_in);
  a.row_in = static_cast<const int32_t*>(row_in);
  a.n_rows_in = static_cast<const int32_t*>(n_rows_in);
  a.key_out = static_cast<int32_t*>(key_out);
  a.row_out = static_cast<int32_t*>(row_out);
  a.n_rows_out = static_cast<int32_t*>(n_rows_out);
  a.row = static_cast<int32_t*>(row);
  a.is_new = static_cast<bool*>(is_new);
  a.ok = static_cast<bool*>(ok);
  a.rounds = static_cast<int32_t*>(rounds);
  a.scratch = static_cast<int32_t*>(scratch);
  a.u = u;
  a.hcap = hcap;
  a.tiles = (key_tiles + blocks - 1) / blocks;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hash_claim_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
