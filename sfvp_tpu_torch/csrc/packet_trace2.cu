// K6: closest hit plus shading payload over the 8-wide BVH, traced per
// packet of 1024 rays with a leaf queue, for one wave of rays.
//
// Replaces sfvp_tpu/kernels/bvh_packet2.py, make_packet_trace2 (kernel body
// from :94, pallas_call at :512): the wavefront loop's per-bounce trace,
// and its shadow-ray trace, on the scenes sfvp_tpu streams (stream_tris,
// kernels/bvh_packet2.py). One block owns one packet of 1024 consecutive
// rays of the (N,) wave, one thread per ray, and walks the tree as the TPU
// kernel walks it, so both visit the same nodes in the same order and break
// exact ties in t alike (the twin is kernels/bvh_packet2.py
// packet_trace2_plain):
//   - thread 0 owns the packet's node stack and FIFO leaf queue in shared
//     memory; it pops, orders and pushes, and every other step is per ray;
//   - a node pop: every thread slab-tests its ray against the 8 children
//     in its own [t_min, min(best, tmax)] (wide_bvh.cuh enters), and a
//     warp OR and a shared atomicOr vote which children ANY ray enters;
//     thread 0 keys those by the center ray's (ray 576) entry distance,
//     orders them far to near (sort_desc), and pushes internal codes to
//     the stack and leaf rows to the queue, or to the stack as a negative
//     code when the queue is full (re-enqueued when popped, if there is
//     room; put back otherwise);
//   - a leaf pop, after every node pop: every thread tests its ray against
//     the 8 triangles of the queue's head row (slot_test, strict t < best).
// Node and leaf rows are read straight from device memory: the 32 threads
// of a warp load the same address, one broadcast load that L1 serves to
// the other 31 warps. Two block barriers an iteration: after the vote, and
// after thread 0's turn.
//
// What bounds it on an H100: the serial chain of an iteration, and the
// union walk of divergent packets; not bytes. An iteration is a vote, a
// barrier, thread 0 alone keying 8 boxes for the center ray and running
// the network and the pushes (a few hundred cycles while 1023 threads
// wait), a barrier, and the leaf tests. A packet pops every node that any
// of its rays enters, so on a bounce wave, whose rays go every way, each
// ray pays for the union of 1024 walks (K3, one ray per thread, pays only
// for its own). The wide tree of the 500k sphere is 57.8 MB (nodes and
// leaf rows, accel/wide.py), beyond the 50 MB L2, so its leaf rows come
// from HBM; one row read serves the whole packet. What the simple design
// does about it: one ray per thread and broadcast row loads. Left for later
// work: the TPU's leaf prefetch as a cp.async ring (a row copied into a
// shared slot at enqueue, waited at consumption), a smaller packet or the
// per-ray walk for bounce waves.
#include "wide_bvh.cuh"

namespace sfvp {

constexpr int kPacketRays = 1024;
// the center ray of a packet: row 4, lane 64 of the TPU's 8 x 128 tile
constexpr int kCenterRay = 4 * 128 + 64;
// the packet stack holds max_stack + leaf_q codes, the queue leaf_q rows
// (kernels/build.py MAX_PACKET_STACK, MAX_LEAF_Q)
constexpr int kPacketStack = 512;
constexpr int kMaxLeafQ = 256;

// Thread 0's walk state, shared so that it holds no registers of the rays.
struct PacketWalk {
  int stack[kPacketStack];
  int queue[kMaxLeafQ];
  int sp, lh, lt;  // stack pointer; queue head and tail (masked on use)
  int code;        // the code popped for the next node phase, 0 for none
  int lrow;        // the leaf row of this iteration's leaf phase, -1 none
  int done;        // the walk ends after this iteration's leaf phase
  unsigned vote;   // bit c: some ray of the packet enters child c
  Ray center;
};

// Thread 0's turn after the vote on node ``code``: push the children some
// ray enters, far to near by the center ray's entry distance, or deal
// with a spilled leaf; take the queue's head for the leaf phase; pop the
// next code.
__device__ __forceinline__ void packet_turn(const Wide& w, PacketWalk& s,
                                            int code, int leaf_q) {
  const int qmask = leaf_q - 1;
  int sp = s.sp, lh = s.lh, lt = s.lt;
  if (code > 0) {
    const float* row = w.nodes + (size_t)(code - 1) * kRowLanes;
    const unsigned vote = s.vote;
    float key[8];
    int cc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float k;
      enters(row, c, s.center, w.t_min, 0.0f, k);  // the key alone
      const int code_c = child_code(row, c);
      const bool push = code_c != 0 && ((vote >> c) & 1u);
      key[c] = push ? k : __int_as_float(0xff800000);  // -inf
      cc[c] = push ? code_c : 0;
    }
    sort_desc(key, cc);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (cc[c] < 0 && lt - lh < leaf_q) {
        s.queue[lt++ & qmask] = -cc[c] - 1;
      } else if (cc[c] != 0) {
        s.stack[sp++] = cc[c];
      }
    }
  } else if (code < 0) {
    if (lt - lh < leaf_q) {
      s.queue[lt++ & qmask] = -code - 1;
    } else {
      s.stack[sp++] = code;
    }
  }
  s.lrow = lt > lh ? s.queue[lh++ & qmask] : -1;
  s.done = sp + lt - lh == 0;
  s.code = sp > 0 ? s.stack[--sp] : 0;
  s.vote = 0u;
  s.sp = sp;
  s.lh = lh;
  s.lt = lt;
}

__global__ void __launch_bounds__(kPacketRays, 1)
packet_trace2_kernel(const Wide w, const float* __restrict__ rays, int n,
                     int leaf_q, float* __restrict__ out) {
  __shared__ PacketWalk s;
  const int tid = threadIdx.x;
  // plane offsets in size_t: 19 planes of a wave past 113M rays pass 2**31
  const size_t m = n;
  const size_t base = (size_t)blockIdx.x * kPacketRays;
  const size_t i = base + tid;
  const bool real = i < m;
  // padding rays, as the TPU kernel's: o = d = 0, tmax = -inf
  const Ray r = real ? make_ray(rays[i], rays[m + i], rays[2 * m + i],
                                rays[3 * m + i], rays[4 * m + i],
                                rays[5 * m + i])
                     : make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  const float tmax = real ? rays[6 * m + i] : __int_as_float(0xff800000);
  float bt = __int_as_float(0x7f800000), bu = 0.0f, bv = 0.0f;
  int brow = -1, bslot = -1;
  if (tid == 0) {
    const size_t c = base + kCenterRay;
    s.center = c < m ? make_ray(rays[c], rays[m + c], rays[2 * m + c],
                                rays[3 * m + c], rays[4 * m + c],
                                rays[5 * m + c])
                     : make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
    s.sp = s.lh = s.lt = 0;
    s.code = 1;  // the root, internal node 0, popped by the first iteration
    s.vote = 0u;
  }
  __syncthreads();
  bool done = false;
  while (!done) {
    const int code = s.code;
    if (code > 0) {
      const float* row = w.nodes + (size_t)(code - 1) * kRowLanes;
      const float limit = fminf(bt, tmax);
      unsigned mask = 0u;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float tnear;
        if (enters(row, c, r, w.t_min, limit, tnear)) mask |= 1u << c;
      }
      mask = __reduce_or_sync(0xffffffffu, mask);
      if ((tid & 31) == 0 && mask != 0u) atomicOr(&s.vote, mask);
    }
    __syncthreads();
    if (tid == 0) packet_turn(w, s, code, leaf_q);
    __syncthreads();
    const int lrow = s.lrow;
    done = s.done != 0;
    if (lrow >= 0) {
      // every ray against the head row's 8 slots, strict t < best
      const float* row = w.tris + (size_t)lrow * kRowLanes;
      for (int k = 0; k < 8; ++k) {
        float t, u, v;
        if (slot_test(row + 16 * k, r, w.det_eps, t, u, v) && t > w.t_min &&
            t < tmax && t < bt) {
          bt = t;
          bu = u;
          bv = v;
          brow = lrow;
          bslot = k;
        }
      }
    }
  }
  if (real) write_payload(w, out, m, i, bt, bu, bv, brow, bslot);
}

}  // namespace sfvp

// rays: (7, n) planes ox oy oz dx dy dz tmax; out: (19, n) planes, (22, n)
// with w->aux (the texture planes, as K3's); n is
// below 2**31, max_stack + leaf_q <= kPacketStack and leaf_q a power of two
// <= kMaxLeafQ (kernels/build.py checks). Returns cudaGetLastError() of the
// launch on ``stream``.
extern "C" int sfvp_packet_trace2(const sfvp::Wide* w, const float* rays,
                                  int n, int leaf_q, float* out,
                                  void* stream) {
  const unsigned blocks = (unsigned)(((size_t)n + sfvp::kPacketRays - 1) /
                                     sfvp::kPacketRays);
  sfvp::packet_trace2_kernel<<<blocks, sfvp::kPacketRays, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      *w, rays, n, leaf_q, out);
  return static_cast<int>(cudaGetLastError());
}
