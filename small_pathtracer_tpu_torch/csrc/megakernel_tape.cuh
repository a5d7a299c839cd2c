// The per-lane tape of the two adjoint kernels (megakernel_vjp.cuh,
// megakernel_geom.cu): the pipeline that traces each sample once and sweeps
// its bounces back from a tape in local memory, the checkpoint segments of
// paths longer than the tape, and the warp-grouped, fixed-order gradient
// accumulation both kernels share.
//
// A lane runs two stages in each iteration of its warp's loop:
//   - the producer traces: pass A of a sample (the path to its end, which
//     latches the sample's radiance LA and depth D), or the replay of one
//     segment of it from a checkpoint. Each bounce j writes its tape entry
//     to slot (j - 1) % kSeg of the producer's buffer;
//   - the sweeper takes a finished segment and sweeps its entries from the
//     highest bounce down, one each iteration.
// Two buffers of kSeg entries alternate between the stages, so a lane sweeps
// one segment while it traces the next. Segment i holds bounces
// i·kSeg + 1 .. (i + 1)·kSeg. Pass A leaves the sample's last segment in its
// buffer; then, for each earlier segment from the last back to the first,
// the producer restores the state before the segment (the spawn for the
// first; the checkpoint pass A wrote before bounce i·kSeg + 1 for segment
// i <= kCkpt; the last checkpoint for a deeper one, replaying on from it)
// and replays the segment into the other buffer. A path of depth D > kSeg
// replays fewer than D bounces up to depth (kCkpt + 1)·kSeg, and beyond it
// about E²/(2·kSeg) more for the E bounces past the last checkpoint, so
// every max_bounces is taken. The library's --fmad=false build makes a
// replay retrace pass A bit for bit.
//
// Storage a lane (local memory): 2·kSeg entries and kCkpt states. A
// path of depth D writes and reads D entries once each; the checkpoints only
// paths longer than kSeg touch.

#pragma once

#include "megakernel_common.cuh"

namespace {

constexpr int kSeg = 16;   // bounces a tape buffer holds: one segment
constexpr int kCkpt = 8;   // checkpoints: before bounces i·kSeg + 1, i = 1..kCkpt
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The path state before a bounce.
struct PathState {
  V3 o, d;
  V3 T;  // throughput
  V3 A;  // the emission picked up so far
};

__device__ __forceinline__ int tape_slot(int j) { return (j - 1) % kSeg; }

// Where a lane's two stages stand. The producer's path state lives in the
// kernel (it is the bounce's input); this is the schedule.
struct TapeCtl {
  // Producer.
  uint32_t s;      // its sample
  int depth;       // bounces traced in this pass
  int d_stop;      // a replay's last bounce; 0 in pass A
  int seg;         // the segment in flight
  int pbuf;        // the buffer it writes
  bool tracing;    // a pass is in flight
  bool held;       // a finished segment waits for the sweeper
  bool done;       // no samples left
  V3 LA;           // its sample's radiance, from pass A
  // Sweeper.
  int j, j_lo;     // next bounce to sweep (descending), the segment's first
  int sbuf;        // the buffer it reads
  bool sweeping;
  bool fresh;      // the segment is a sample's last (its sweep starts)
  uint32_t s_sw;   // its sample
  V3 LA_sw;
};

__device__ __forceinline__ void tape_start(TapeCtl* c, uint32_t s, bool any) {
  c->s = s;
  c->depth = 0;
  c->d_stop = 0;
  c->seg = 0;
  c->pbuf = 0;
  c->tracing = any;
  c->held = false;
  c->done = !any;
  c->LA = v3(0.0f, 0.0f, 0.0f);
  c->j = c->j_lo = 0;
  c->sbuf = 1;
  c->sweeping = false;
  c->fresh = false;
  c->s_sw = 0;
  c->LA_sw = c->LA;
}

__device__ __forceinline__ bool tape_active(const TapeCtl& c) {
  return !c.done || c.held || c.sweeping;
}

// pass A's bounce j carried state `st` (before it): keeps it as a
// checkpoint when it opens a segment 1..kCkpt. State: PathState, or a
// kernel's own state that holds more than it.
template <class State>
__device__ __forceinline__ void tape_checkpoint(State* ck, int j,
                                                const State& st) {
  const int i = (j - 1) / kSeg;
  if (j > 1 && tape_slot(j) == 0 && i <= kCkpt) ck[i - 1] = st;
}

// The producer's bounce `depth` ended pass A (the path died or reached
// max_bounces) with radiance LA: its last segment is in the buffer.
__device__ __forceinline__ void tape_end_pass_a(TapeCtl* c, V3 LA) {
  c->LA = LA;
  c->seg = (c->depth - 1) / kSeg;
  c->tracing = false;
  c->held = true;
}

// The producer's replay reached its segment's last bounce.
__device__ __forceinline__ void tape_end_replay(TapeCtl* c) {
  c->tracing = false;
  c->held = true;
}

// Sets the producer on the state before the replay of segment c->seg - 1
// (its depth is the bounces before that state): the spawn for segment 0,
// else checkpoint min(seg, kCkpt). Returns false for segment 0, where the
// caller spawns.
template <class State>
__device__ __forceinline__ bool tape_restore(TapeCtl* c, const State* ck,
                                             State* st) {
  const int sg = c->seg - 1;
  c->seg = sg;
  c->d_stop = (sg + 1) * kSeg;
  c->tracing = true;
  if (sg == 0) {
    c->depth = 0;
    return false;
  }
  const int i = sg < kCkpt ? sg : kCkpt;
  *st = ck[i - 1];
  c->depth = i * kSeg;
  return true;
}

// After both stages' steps: hands a held segment to an idle sweeper. Then
// the producer is free for its next job, which it returns: 0 none (all
// samples done), 1 replay the segment below (call tape_restore), 2 spawn
// sample c->s (pass A).
__device__ __forceinline__ int tape_handover(TapeCtl* c, uint32_t s_stop) {
  if (!c->held || c->sweeping) return 0;
  const bool pass_a = c->d_stop == 0;
  c->sweeping = true;
  c->fresh = pass_a;
  c->j = pass_a ? c->depth : c->d_stop;
  c->j_lo = c->seg * kSeg + 1;
  c->sbuf = c->pbuf;
  c->s_sw = c->s;
  c->LA_sw = c->LA;
  c->pbuf ^= 1;
  c->held = false;
  if (c->seg > 0) return 1;
  c->s += 1;
  if (c->s < s_stop) {
    c->depth = 0;
    c->d_stop = 0;
    c->tracing = true;
    return 2;
  }
  c->done = true;
  return 0;
}

// The sweeper's step is done: the next bounce down, or the segment's end.
__device__ __forceinline__ void tape_swept(TapeCtl* c) {
  c->fresh = false;
  c->j -= 1;
  if (c->j < c->j_lo) c->sweeping = false;
}

// One sweep step's contributions to one object's slots: albedo rgb,
// emission rgb, and for a sphere (center, radius).
struct Contrib {
  int key;  // the object's global id, -1 for none
  float v[10];
};

// All 32 lanes of the warp call it. Each slot of the warp's row gets at most
// one add a key: a lane alone with its key adds its own values (its xor
// tree would add only zeros to them); the lanes of a shared key are summed
// by a fixed xor tree, one key at a time in the order of their lowest lane,
// and lane 0 adds the sums. Row layout: albedo at 3·id, emission at
// 3K + 3·id, sphere s at 6K + 4s (ids >= n_rects are spheres).
__device__ __forceinline__ void warp_accumulate(const Contrib& ct, float* row,
                                                int n_rects, int k_obj) {
  const unsigned peers = __match_any_sync(kFull, ct.key);
  const bool alone = ct.key >= 0 && __popc(peers) == 1;
  if (alone) {
    for (int c = 0; c < 3; ++c) {
      row[3 * ct.key + c] += ct.v[c];
      row[3 * k_obj + 3 * ct.key + c] += ct.v[3 + c];
    }
    if (ct.key >= n_rects) {
      float* gs = row + 6 * k_obj + 4 * (ct.key - n_rects);
      for (int j = 0; j < 4; ++j) gs[j] += ct.v[6 + j];
    }
  }
  unsigned pending = __ballot_sync(kFull, ct.key >= 0 && !alone);
  while (pending) {
    const int src = __ffs(pending) - 1;
    const int k0 = __shfl_sync(kFull, ct.key, src);
    const bool mine = ct.key == k0;
    const int nv = k0 >= n_rects ? 10 : 6;
    float s[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      s[i] = 0.0f;
      if (i < nv) {
        float x = mine ? ct.v[i] : 0.0f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          x += __shfl_xor_sync(kFull, x, off);
        }
        s[i] = x;
      }
    }
    if ((threadIdx.x & 31) == 0) {
      for (int c = 0; c < 3; ++c) {
        row[3 * k0 + c] += s[c];
        row[3 * k_obj + 3 * k0 + c] += s[3 + c];
      }
      if (nv == 10) {
        float* gs = row + 6 * k_obj + 4 * (k0 - n_rects);
        for (int j = 0; j < 4; ++j) gs[j] += s[6 + j];
      }
    }
    pending &= ~__ballot_sync(kFull, mine);
  }
  __syncwarp();
}

// The block's partial sums: its warps' rows (n_slots floats each, in
// shared memory) summed in a fixed order into its row of `partials`, which
// reduce_partials sums over the blocks. Every thread of the block calls it.
__device__ __forceinline__ void block_partials(const float* rows, int n_slots,
                                               float* __restrict__ partials) {
  __syncthreads();
  for (int sl = threadIdx.x; sl < n_slots; sl += kBlock) {
    float v = rows[sl];
    for (int w = 1; w < kWarps; ++w) v += rows[w * n_slots + sl];
    partials[static_cast<size_t>(blockIdx.x) * n_slots + sl] = v;
  }
}

}  // namespace
