// P1: the packet walk of the 8-wide BVH stripped of its payload, with an
// exact iteration count per packet and the ablations of the TPU probe.
//
// Replaces benchmarks/probe_carry.py, make_stripped_trace (kernel body
// :56-217, pallas_call at :242): sfvp_tpu's K3 packet walk (one packet of
// 8 x 128 rays on one SMEM stack) reduced to (t, u, v) and a counter of
// pops, so that an iteration's cost and its parts can be read off. Here it
// sits between the port's per-ray K3 (bvh_trace.cu) and K6
// (packet_trace2.cu, the same packet walk plus a leaf queue): run on K6's
// waves it splits K6's time into the union walk, the leaf queue and the
// parts of one iteration. The twin is kernels/stripped_trace.py
// stripped_trace_plain; both pop the same codes in the same order.
//
// One block owns one packet of 1024 consecutive rays of the (N,) wave, one
// thread a ray. Thread 0 owns the stack in shared memory, which starts as
// the root. An iteration pops one code:
//   - a node: every thread slab-tests its ray against the 8 children in
//     its own [t_min, min(best t, tmax)] (wide_bvh.cuh enters); a barrier;
//     thread 0 pushes the children some ray enters (every child with a tag
//     under PUSH_ALL), keyed by the least entry distance over the rays that
//     enter it (by the center ray's, ray 4 * 128 + 64, under CENTER_KEY: K6's
//     key), orders them far to near through the 19-comparator network
//     (none under !SORTNET), pushes them in slot order and pops the next
//     code; a barrier;
//   - a leaf row: thread 0 pops the next code, every thread tests its ray
//     against the row's 8 triangles (strict t < best; no test under !LEAF,
//     where the row is read and t stays inf), a barrier.
// The popped code is double-buffered in shared memory (iteration k reads
// slot k & 1, its turn writes the other), so a leaf pop needs one barrier
// and a node pop two: the vote's and thread 0's turn's.
//
// The packet's vote, two ways as the TPU probe's two push rules: a warp OR
// (__reduce_or_sync) and one shared atomicOr a warp of the bit mask of
// children entered (stripped, no_sortnet, no_leaf, as K6 votes), or, under
// PACKED (packed_push), the count of rays entering children 2p and 2p + 1
// packed as one int, c_2p + c_2p+1 << 16 (1024 rays fit 16 bits), summed by
// __reduce_add_sync and one shared atomicAdd a warp and pair: the TPU's
// int32 packing (probe_carry.py:119-126, 145-149). Both push exactly the
// children some ray enters, so results and counts equal stripped's.
// The child key is a block minimum: __reduce_min_sync over the bits of the
// entry distances, then one shared atomicMin a warp and child. An entry
// distance is at least t_min > 0 (the wrapper refuses t_min <= 0), so the
// bits of positive floats order as the floats, and a minimum does not
// depend on the order it is taken in: kernel and twin agree bit for bit.
//
// What bounds it on an H100: as K6, the serial chain of an iteration (the
// barriers, thread 0's turn while 1023 threads wait) and the union walk of
// divergent packets; not bytes. It computes K3's function, so its bound is
// K3's on the same rays (chip_smoke.py). What the simple design does about
// it: nothing; it is the measurement that a redesign of K6 starts from.
#include "wide_bvh.cuh"

namespace sfvp {

constexpr int kStripRays = 1024;
constexpr int kStripCenter = 4 * 128 + 64;
constexpr unsigned kInfBits = 0x7f800000u;

// Thread 0's walk state, in shared memory.
struct StripWalk {
  int stack[kMaxStack];
  int code[2];          // the code iteration k pops: code[k & 1], 0 = done
  int sp;
  unsigned vote;        // bit c: some ray of the packet enters child c
  unsigned packed[4];   // PACKED: rays into child 2p + (into 2p+1) << 16
  unsigned kmin[8];     // bits of child c's least entry distance, inf = none
  Ray center;
};

// Thread 0's turn after the vote on node row ``row`` of iteration ``k``:
// push the children, pop the code of iteration k + 1, reset the vote.
template <bool PACKED, bool PUSH_ALL, bool CENTER_KEY, bool SORTNET>
__device__ __forceinline__ void strip_turn(const Wide& w, StripWalk& s,
                                           const float* row, int k) {
  float key[8];
  int cc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int code_c = child_code(row, c);
    bool push = code_c != 0;
    if (!PUSH_ALL) {
      push = push && (PACKED ? ((s.packed[c >> 1] >> (16 * (c & 1))) &
                                0xffffu) != 0u
                             : ((s.vote >> c) & 1u) != 0u);
    }
    float kc;
    if (CENTER_KEY) {
      enters(row, c, s.center, w.t_min, 0.0f, kc);  // the key alone
    } else {
      kc = __uint_as_float(s.kmin[c]);
    }
    key[c] = push ? kc : __int_as_float(0xff800000);  // -inf
    cc[c] = push ? code_c : 0;
  }
  if (SORTNET) sort_desc(key, cc);
  int sp = s.sp;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (cc[c] != 0) s.stack[sp++] = cc[c];
  }
  s.code[(k + 1) & 1] = sp > 0 ? s.stack[--sp] : 0;
  s.sp = sp;
  s.vote = 0u;
#pragma unroll
  for (int p = 0; p < 4; ++p) s.packed[p] = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) s.kmin[c] = kInfBits;
}

template <bool PACKED, bool PUSH_ALL, bool CENTER_KEY, bool SORTNET,
          bool LEAF>
__global__ void __launch_bounds__(kStripRays, 1)
stripped_trace_kernel(const Wide w, const float* __restrict__ rays, int n,
                      float* __restrict__ out, int* __restrict__ counts) {
  __shared__ StripWalk s;
  const int tid = threadIdx.x;
  const size_t m = n;
  const size_t base = (size_t)blockIdx.x * kStripRays;
  const size_t i = base + tid;
  const bool real = i < m;
  // padding rays, as the TPU probe's: o = d = 0, tmax = -inf
  const Ray r = real ? make_ray(rays[i], rays[m + i], rays[2 * m + i],
                                rays[3 * m + i], rays[4 * m + i],
                                rays[5 * m + i])
                     : make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  const float tmax = real ? rays[6 * m + i] : __int_as_float(0xff800000);
  float bt = __int_as_float(0x7f800000), bu = 0.0f, bv = 0.0f;
  if (tid == 0) {
    const size_t c = base + kStripCenter;
    s.center = c < m ? make_ray(rays[c], rays[m + c], rays[2 * m + c],
                                rays[3 * m + c], rays[4 * m + c],
                                rays[5 * m + c])
                     : make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
    s.code[0] = 1;  // the root, internal node 0, popped by iteration 0
    s.sp = 0;
    s.vote = 0u;
    for (int p = 0; p < 4; ++p) s.packed[p] = 0u;
    for (int c = 0; c < 8; ++c) s.kmin[c] = kInfBits;
  }
  __syncthreads();
  int k = 0;
  for (;; ++k) {
    const int code = s.code[k & 1];
    if (code == 0) break;  // the same value in every thread
    if (code > 0) {
      const float* row = w.nodes + (size_t)(code - 1) * kRowLanes;
      if (!(PUSH_ALL && CENTER_KEY)) {
        const float limit = fminf(bt, tmax);
        bool hit[8];
        float tnear[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          hit[c] = enters(row, c, r, w.t_min, limit, tnear[c]);
        }
        const bool lane0 = (tid & 31) == 0;
        if (!PUSH_ALL) {
          if (PACKED) {
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const unsigned cnt = __reduce_add_sync(
                  0xffffffffu, (unsigned)hit[2 * p] +
                                   ((unsigned)hit[2 * p + 1] << 16));
              if (lane0 && cnt != 0u) atomicAdd(&s.packed[p], cnt);
            }
          } else {
            unsigned mask = 0u;
#pragma unroll
            for (int c = 0; c < 8; ++c) mask |= (unsigned)hit[c] << c;
            mask = __reduce_or_sync(0xffffffffu, mask);
            if (lane0 && mask != 0u) atomicOr(&s.vote, mask);
          }
        }
        if (!CENTER_KEY) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const unsigned bits = __reduce_min_sync(
                0xffffffffu, hit[c] ? __float_as_uint(tnear[c]) : kInfBits);
            if (lane0 && bits != kInfBits) atomicMin(&s.kmin[c], bits);
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        strip_turn<PACKED, PUSH_ALL, CENTER_KEY, SORTNET>(w, s, row, k);
      }
      __syncthreads();
    } else {
      if (tid == 0) {
        s.code[(k + 1) & 1] = s.sp > 0 ? s.stack[--s.sp] : 0;
      }
      const float* row = w.tris + (size_t)(-code - 1) * kRowLanes;
      if (LEAF) {
        for (int j = 0; j < 8; ++j) {
          float t, u, v;
          if (slot_test(row + 16 * j, r, w.det_eps, t, u, v) &&
              t > w.t_min && t < tmax && t < bt) {
            bt = t;
            bu = u;
            bv = v;
          }
        }
      } else {
        bt = bt + 0.0f * __ldg(row);  // the row read, as the TPU probe's
      }
      __syncthreads();
    }
  }
  if (real) {
    out[i] = bt;
    out[m + i] = bu;
    out[2 * m + i] = bv;
  }
  if (tid == 0) counts[blockIdx.x] = k;  // the packet's pops
}

template <bool PACKED, bool PUSH_ALL, bool CENTER_KEY, bool SORTNET,
          bool LEAF>
int launch_stripped(const Wide& w, const float* rays, int n, float* out,
                    int* counts, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)(((size_t)n + kStripRays - 1) / kStripRays);
  stripped_trace_kernel<PACKED, PUSH_ALL, CENTER_KEY, SORTNET, LEAF>
      <<<blocks, kStripRays, 0, stream>>>(w, rays, n, out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sfvp

// rays: (7, n) planes ox oy oz dx dy dz tmax; counts: (ceil(n / 1024),)
// pops per packet; out: (3, n) planes t u v. variant: the index in
// kernels/stripped_trace.py VARIANTS (stripped, packed, packed_center,
// pushall_center, no_sortnet, no_leaf). n below 2**31, max_stack within
// kMaxStack and t_min > 0 (kernels/stripped_trace.py checks). Returns
// cudaGetLastError() of the launch on ``stream``, or cudaErrorInvalidValue
// for an unknown variant.
extern "C" int sfvp_stripped_trace(const sfvp::Wide* w, const float* rays,
                                   int n, int variant, int* counts,
                                   float* out, void* stream) {
  using namespace sfvp;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch_stripped<false, false, false, true, true>(*w, rays, n,
                                                              out, counts, st);
    case 1:
      return launch_stripped<true, false, false, true, true>(*w, rays, n,
                                                             out, counts, st);
    case 2:
      return launch_stripped<true, false, true, true, true>(*w, rays, n, out,
                                                            counts, st);
    case 3:
      return launch_stripped<false, true, true, true, true>(*w, rays, n, out,
                                                            counts, st);
    case 4:
      return launch_stripped<false, false, false, false, true>(
          *w, rays, n, out, counts, st);
    case 5:
      return launch_stripped<false, false, false, true, false>(
          *w, rays, n, out, counts, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
