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
// Two block barriers an iteration: after the vote, and after thread 0's
// turn.
//
// Rows come from shared memory, copied there by the TMA's bulk copies
// (cp.async.bulk, one mbarrier per buffer), as the TPU kernel copies them
// into VMEM ahead of use (start_leaf_dma, sfvp_tpu/kernels/bvh_packet2.py:
// 114-127):
//   - a ring of leaf_q slots of 512 bytes, one per queue entry: when thread
//     0 enqueues a leaf row (a pushed leaf child, or a spilled leaf that is
//     re-enqueued), it starts the row's copy into slot (tail & (leaf_q-1));
//     the leaf phase that pops it, up to leaf_q iterations later, waits on
//     that slot's barrier for its fill (head / leaf_q) & 1;
//   - a node buffer of 256 bytes (lanes 0-63: boxes, refs, tags): when
//     thread 0 pops an internal code at the end of its turn it starts that
//     row's copy, which runs during the leaf phase; the next node phase
//     waits on it, and thread 0 keys and decodes the children from it too.
// A slot is refilled only after a block barrier that follows every read of
// its last fill (the queue holds at most leaf_q rows, so the slot written
// in a turn is never the slot of an earlier row still queued), and thread
// 0 fences the generic proxy's reads against the async proxy's writes
// before each turn's copies. The walk ends only with the stack and the
// queue empty, so no copy is in flight when the block exits.
//
// What bounds it on an H100: the serial chain of an iteration, and the
// union walk of divergent packets; not bytes. An iteration is a vote, a
// barrier, thread 0 alone keying 8 boxes for the center ray and running
// the network and the pushes (a few hundred cycles while 1023 threads
// wait), a barrier, and the leaf tests. A packet pops every node that any
// of its rays enters, so on a bounce wave, whose rays go every way, each
// ray pays for the union of 1024 walks (K3, one ray per thread, pays only
// for its own). The wide tree of the 500k sphere is 51.7 MB (nodes and
// leaf rows, accel/wide.py), beyond the 50 MB L2, so many of its rows come
// from HBM. What the design does about it: one ray per thread, and every
// row in shared memory before the threads read it, fetched while the block
// does other work (a leaf row from its enqueue, up to leaf_q iterations
// ahead; a node row during the leaf phase before it), so the tests read
// shared memory instead of waiting on a chain of dependent loads from L2
// or HBM. Left for later work: a smaller packet or the per-ray walk for
// bounce waves, whose cost is the union walk (ROADMAP A.19).
#include "wide_bvh.cuh"

namespace sfvp {

constexpr int kPacketRays = 1024;
// the center ray of a packet: row 4, lane 64 of the TPU's 8 x 128 tile
constexpr int kCenterRay = 4 * 128 + 64;
// the packet stack holds max_stack + leaf_q codes, the queue leaf_q rows
// (kernels/build.py MAX_PACKET_STACK, MAX_LEAF_Q)
constexpr int kPacketStack = 512;
constexpr int kMaxLeafQ = 256;
// bytes of a leaf row in a ring slot, and of the node row's first 64 lanes
// in the node buffer (kernels/build.py ROW_BYTES, NODE_ROW_BYTES)
constexpr unsigned kLeafBytes = kRowLanes * 4;
constexpr unsigned kNodeBytes = 64 * 4;

// Thread 0's walk state, shared so that it holds no registers of the rays.
struct PacketWalk {
  int stack[kPacketStack];
  int queue[kMaxLeafQ];
  int sp, lh, lt;  // stack pointer; queue head and tail (masked on use)
  int code;        // the code popped for the next node phase, 0 for none
  int lrow;        // the leaf row of this iteration's leaf phase, -1 none
  int lslot;       // its ring slot
  unsigned lpar;   // the parity of that slot's fill the leaf phase waits on
  int done;        // the walk ends after this iteration's leaf phase
  unsigned vote;   // bit c: some ray of the packet enters child c
  Ray center;
};
// kernels/build.py PACKET_WALK_BYTES counts it at this bound
static_assert(sizeof(PacketWalk) <= 4096, "PacketWalk outgrew its plan");

// The dynamic shared memory of a leaf queue of leaf_q rows: the ring, the
// node buffer, then an mbarrier per slot and one for the node buffer
// (kernels/build.py packet_smem_plan mirrors it).
__host__ __device__ constexpr size_t packet_smem_bytes(int leaf_q) {
  return (size_t)leaf_q * kLeafBytes + kNodeBytes + (leaf_q + 1) * 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Start the bulk copy of ``bytes`` from device memory into shared memory,
// completing on ``bar``: its one arrival (with the bytes it expects) is
// this thread's, the bytes the copy's.
__device__ __forceinline__ void bulk_copy(void* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the phase of ``bar`` with parity ``parity`` has completed:
// the copy of that fill has landed and is visible to this thread.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The shared buffers of one block (the dynamic shared memory's layout).
struct PacketRows {
  float* ring;                // leaf_q rows of 128 lanes
  float* node;                // lanes 0-63 of the node row of s.code
  unsigned long long* lbar;   // one per ring slot
  unsigned long long* nbar;   // the node buffer's
};

// Thread 0's turn after the vote on node ``code``: push the children some
// ray enters, far to near by the center ray's entry distance, or deal
// with a spilled leaf; take the queue's head for the leaf phase; pop the
// next code. Every leaf row enqueued starts its copy into its ring slot,
// and an internal code popped its node row's into the node buffer.
__device__ __forceinline__ void packet_turn(const Wide& w, PacketWalk& s,
                                            const PacketRows& b, int code,
                                            int leaf_q) {
  const int qmask = leaf_q - 1;
  int sp = s.sp, lh = s.lh, lt = s.lt;
  // append a leaf row to the queue and start its copy into its ring slot
  auto enqueue = [&](int row) {
    const int q = lt++ & qmask;
    s.queue[q] = row;
    bulk_copy(b.ring + q * kRowLanes, w.tris + (size_t)row * kRowLanes,
              kLeafBytes, b.lbar + q);
  };
  float key[8];
  int cc[8];
  if (code > 0) {
    const unsigned vote = s.vote;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float k;
      enters<SharedRow>(b.node, c, s.center, w.t_min, 0.0f, k);  // the key
      const int code_c = child_code<SharedRow>(b.node, c);
      const bool push = code_c != 0 && ((vote >> c) & 1u);
      key[c] = push ? k : __int_as_float(0xff800000);  // -inf
      cc[c] = push ? code_c : 0;
    }
  }
  // the reads of the node buffer and of the ring slots refilled below (this
  // thread's, and the others' before the vote barrier) come before the
  // async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (code > 0) {
    sort_desc(key, cc);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (cc[c] < 0 && lt - lh < leaf_q) {
        enqueue(-cc[c] - 1);
      } else if (cc[c] != 0) {
        s.stack[sp++] = cc[c];
      }
    }
  } else if (code < 0) {
    if (lt - lh < leaf_q) {
      enqueue(-code - 1);
    } else {
      s.stack[sp++] = code;
    }
  }
  if (lt > lh) {
    s.lslot = lh & qmask;
    s.lpar = (unsigned)(lh / leaf_q) & 1u;  // the fill of that slot
    s.lrow = s.queue[lh++ & qmask];
  } else {
    s.lrow = -1;
  }
  s.done = sp + lt - lh == 0;
  const int next = sp > 0 ? s.stack[--sp] : 0;
  if (next > 0)
    bulk_copy(b.node, w.nodes + (size_t)(next - 1) * kRowLanes, kNodeBytes,
              b.nbar);
  s.code = next;
  s.vote = 0u;
  s.sp = sp;
  s.lh = lh;
  s.lt = lt;
}

__global__ void __launch_bounds__(kPacketRays, 1)
packet_trace2_kernel(const Wide w, const float* __restrict__ rays, int n,
                     int leaf_q, float* __restrict__ out) {
  __shared__ PacketWalk s;
  extern __shared__ __align__(128) unsigned char dyn[];
  unsigned char* const node = dyn + (size_t)leaf_q * kLeafBytes;
  unsigned long long* const bars =
      reinterpret_cast<unsigned long long*>(node + kNodeBytes);
  const PacketRows b{reinterpret_cast<float*>(dyn),
                     reinterpret_cast<float*>(node), bars, bars + leaf_q};
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
    for (int q = 0; q <= leaf_q; ++q) mbar_init(b.lbar + q);  // and nbar
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_copy(b.node, w.nodes, kNodeBytes, b.nbar);
  }
  __syncthreads();
  unsigned nfill = 0u;  // the node buffer's fills consumed
  bool done = false;
  while (!done) {
    const int code = s.code;
    if (code > 0) {
      mbar_wait(b.nbar, nfill & 1u);
      ++nfill;
      const float limit = fminf(bt, tmax);
      unsigned mask = 0u;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float tnear;
        if (enters<SharedRow>(b.node, c, r, w.t_min, limit, tnear))
          mask |= 1u << c;
      }
      mask = __reduce_or_sync(0xffffffffu, mask);
      if ((tid & 31) == 0 && mask != 0u) atomicOr(&s.vote, mask);
    }
    __syncthreads();
    if (tid == 0) packet_turn(w, s, b, code, leaf_q);
    __syncthreads();
    const int lrow = s.lrow;
    done = s.done != 0;
    if (lrow >= 0) {
      // every ray against the head row's 8 slots, strict t < best
      const int q = s.lslot;
      mbar_wait(b.lbar + q, s.lpar);
      const float* row = b.ring + q * kRowLanes;
      for (int k = 0; k < 8; ++k) {
        float t, u, v;
        if (slot_test<SharedRow>(row + 16 * k, r, w.det_eps, t, u, v) &&
            t > w.t_min && t < tmax && t < bt) {
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
// with w->aux (the texture planes, as K3's); n is below 2**31, max_stack +
// leaf_q <= kPacketStack, leaf_q a power of two <= kMaxLeafQ, the tables'
// rows 16-byte aligned, and smem the dynamic shared memory of leaf_q
// (packet_smem_bytes; kernels/build.py checks each). Returns
// cudaErrorInvalidValue for a smaller smem, else the error of the
// attribute call or cudaGetLastError() of the launch on ``stream``.
extern "C" int sfvp_packet_trace2(const sfvp::Wide* w, const float* rays,
                                  int n, int leaf_q, int smem, float* out,
                                  void* stream) {
  if (smem < 0 || (size_t)smem < sfvp::packet_smem_bytes(leaf_q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      sfvp::packet_trace2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)(((size_t)n + sfvp::kPacketRays - 1) /
                                     sfvp::kPacketRays);
  sfvp::packet_trace2_kernel<<<blocks, sfvp::kPacketRays, (size_t)smem,
                               static_cast<cudaStream_t>(stream)>>>(
      *w, rays, n, leaf_q, out);
  return static_cast<int>(cudaGetLastError());
}
