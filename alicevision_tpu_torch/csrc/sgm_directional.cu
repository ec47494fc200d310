// SGM directional sweeps on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel alicevision_tpu/ops/sgm_pallas.py
// (sgm_directional_pass, body _sgm_kernel_const). One launch runs B*N
// independent chains of S steps. Chain (b, n) at step s reads the D costs
// C_s at cost + b*c_b + n*c_n + s*c_s (D innermost, stride 1) and the
// scalar P2_s at p2 + b*p_b + n*p_n + s*p_s, with a constant P1:
//
//   L_0 = C_0
//   L_s = (C_s + min(L_{s-1}, min(L_{s-1}[d-1], L_{s-1}[d+1]) + P1,
//                    min_d L_{s-1} + P2_s)) - min_d L_{s-1}      (s >= 1)
//
// with the d-neighbours edge-replicated, in the arithmetic order of the
// plain version (alicevision_tpu_torch/mvs/plane_sweep.py::_directional_pass),
// so the two agree bit for bit. L_s goes to out (which shares cost's
// strides), or is added to what out holds (`accumulate`: out = out + L_s,
// the order of sgm_aggregate's running sum). A negative step stride walks a
// chain backwards, so the opposite-direction sweeps of sgm_aggregate need
// no flipped copy (ops/sgm_kernel.py computes the strides).
//
// What bounds it on an H100: bytes. Each cost value is read once, each
// result written once (read and written when accumulating), P2 read once:
// (2 or 3)*B*S*N*D*4 + B*S*N*4 bytes against ~7 float operations an
// element. A (640, 960, 96) sweep moves 474 MB, 0.142 ms at 3.35 TB/s.
//
// What held the first design back: latency. One warp owned one
// chain and prefetched one step ahead into registers; each step waited on
// a five-level shuffle min and then on its loads. It reached 35-44 % of the
// bound at D = 96 (a quarter of the lanes idle), 65-75 % at D = 256-512,
// and 37 % with the shared-memory carry, which had no prefetch at all.
//
// This design:
// * An asynchronous ring in shared memory, per warp: each step's cost row
//   (with the running total's row when accumulating, and P2) is copied
//   with cp.async (16-byte pieces when D % 4 == 0 and the rows are
//   16-byte aligned, 4-byte ones otherwise), one commit group a step,
//   K steps ahead (K = 8 up to D = 192, 6 at 256, 3 at 512: 3-6 KB of cost
//   rows a warp, 3-5 MB across a launch of 960 chains).
// * The carry L_{s-1} in registers for D <= 512: lane l holds d = l + 32 j
//   (j < VPL), so D = 96 fills all 32 lanes with 3 values. VPL is
//   ceil(D / 32) rounded up to a rung of 1, 2, 3, 4, 6, 8, 12, 16 (the
//   values past D hold +inf), so 32 instantiations cover D <= 512.
//   One chain a warp (32 x 3, not two chains of 16 x 6) keeps each warp's
//   stores whole 128-byte lines and lets min_d be one redux.sync over
//   order-preserving integer keys (the step's only serial reduction). The
//   neighbours d +- 1 (one shuffle a value), the next copies and the next
//   step's loads from the ring are issued while that reduction is in flight.
// * Past D = 512 the carry lives in shared memory, one row a warp updated
//   in place (each lane reads and writes only its own float4 of each
//   128-wide chunk; the neighbours come by shuffles), and the ring holds
//   128-wide chunks rather than whole steps: 16 chunks in flight a warp
//   whatever D is, so D up to 29056 (kMaxD) still fits one block.
//
// Measured on an H100 80GB HBM3 at 700 W (scripts/sgm_kernel_variants.py
// and scripts/profile_dense_torch.py, PERF.md): 72-80 % of the bound at
// D = 96 to 512, 77 % at 1500. What still holds it back: with no copies at
// all a (640, 960, 96) sweep still takes 0.098 ms, 69 % of its bound: the
// loop issues ~108 instructions a step and ~7 warps share an SM's four
// schedulers. With the copies it reaches ~2.7 TB/s; ring depths 4, 8 and
// 16 take the same time, so the copies are no longer short of bytes in
// flight.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxVpl = 16;             // register carry: D <= 512
constexpr int kChunk = 128;             // D values in a ring slot of the smem carry
constexpr int kChunkRing = 16;          // its ring depth, in chunks
constexpr int kSmemStatic = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kSmemMax = 232448;        // opt-in limit of an H100 block
constexpr int kMaxD = 29056;

// One launch: B*N chains of S steps; strides in floats. out shares cost's
// strides; p2 has its own.
struct Sweep {
  const float* cost;
  const float* p2;
  float* out;
  long long c_b, c_n, c_s;
  long long p_b, p_n, p_s;
  int B, S, N, D;
  float p1;
  int accumulate;
  int vec;  // 16-byte copies: D % 4 == 0, every row 16-byte aligned
};

// Ring depth (steps) of the register-carry kernel: 8 up to D = 192, then
// fewer as rows grow, 3 at D = 512 (~6 KB of cost rows a warp).
__host__ __device__ constexpr int ring_depth(int vpl) {
  return 48 / vpl < 3 ? 3 : (48 / vpl > 8 ? 8 : 48 / vpl);
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// min over the warp's 32 lanes in one redux.sync: floats map to unsigned
// keys in the same order (positive: sign bit set; negative: all bits
// flipped), and back.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float(k ^ (~static_cast<unsigned>(static_cast<int>(k) >> 31) | 0x80000000u));
}

__device__ __forceinline__ unsigned warp_min_key(float v) {
  return __reduce_min_sync(kFull, order_key(v));
}

// Where a warp's chain starts; false for the warps past the last chain.
struct Chain {
  const float* c;
  const float* q;
  float* o;
};

__device__ __forceinline__ bool chain_of(const Sweep& w, long long chain, Chain& ch) {
  if (chain >= static_cast<long long>(w.B) * w.N) return false;
  const long long b = chain / w.N, n = chain % w.N;
  ch.c = w.cost + b * w.c_b + n * w.c_n;
  ch.q = w.p2 + b * w.p_b + n * w.p_n;
  ch.o = w.out + b * w.c_b + n * w.c_n;
  return true;
}

// ---------------------------------------------------------------------------
// D <= 512: the carry in registers, lane l holding d = l + 32 j (j < VPL).
// Ring slot of one step: cost[D4] | total[D4] (ACC) | p2 (4 floats).
// ---------------------------------------------------------------------------

template <int VPL, bool VEC, bool ACC>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock) sgm_sweep_reg_kernel(const Sweep w) {
  constexpr int K = ring_depth(VPL);
  constexpr int kPieces = (VPL * kWarp / 4 + kWarp - 1) / kWarp;  // 16-byte copies a lane
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  Chain ch;
  if (!chain_of(w, static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp, ch))
    return;  // whole warps leave together; no block-wide barrier below
  const int D = w.D;
  const int D4 = (D + 3) & ~3;
  const int slot_f = (ACC ? 2 * D4 : D4) + 4;
  float* const ring = reinterpret_cast<float*>(smem4) + static_cast<size_t>(warp) * K * slot_f;

  // The copies: step s_in goes to slot s_in % K, one commit group a step
  // (empty past S, so the group count stays uniform).
  int s_in = 0, slot_in = 0;
  const float* c_in = ch.c;
  const float* o_in = ch.o;
  const float* q_in = ch.q;
  auto issue = [&]() {
    if (s_in < w.S) {
      float* slot = ring + slot_in * slot_f;
      if (VEC) {
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          const int i = 4 * (lane + kWarp * k);
          if (i < D) {
            cp_async16(slot + i, c_in + i);
            if (ACC) cp_async16(slot + D4 + i, o_in + i);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int d = lane + kWarp * j;
          if (d < D) {
            cp_async4(slot + d, c_in + d);
            if (ACC) cp_async4(slot + D4 + d, o_in + d);
          }
        }
      }
      if (lane == 0) cp_async4(slot + slot_f - 4, q_in);
      c_in += w.c_s;
      o_in += w.c_s;
      q_in += w.p_s;
      ++s_in;
      slot_in = slot_in + 1 == K ? 0 : slot_in + 1;
    }
    cp_async_commit();
  };

  const float inf = inf_f();
  float C[VPL], q;  // this step's costs and P2, read from the ring
  int slot_cur = 0;
  auto read_slot = [&]() {
    const float* slot = ring + slot_cur * slot_f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + kWarp * j;
      C[j] = d < D ? slot[d] : inf;  // padding lanes stay +inf
    }
    q = slot[slot_f - 4];
  };

  for (int i = 0; i < K; ++i) issue();  // steps 0 .. K-1 in flight
  cp_async_wait<K - 1>();
  __syncwarp();
  read_slot();

  // L_{s-1}, its neighbours d - 1 and d + 1 (edge-replicated) and its min
  float L[VPL], up[VPL], dn[VPL];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) L[j] = up[j] = dn[j] = inf;
  float* o_s = ch.o;
  for (int s = 0; s < w.S; ++s) {
    const float* slot = ring + slot_cur * slot_f;
    const float mp2 = m + q;
    float lmin = inf;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + kWarp * j;
      const float best = fminf(fminf(L[j], fminf(up[j], dn[j]) + w.p1), mp2);
      const float nl = s == 0 ? C[j] : (C[j] + best) - m;  // +inf stays +inf
      if (d < D) o_s[d] = ACC ? slot[D4 + d] + nl : nl;
      L[j] = nl;
      lmin = fminf(lmin, nl);
    }
    const unsigned m_key = warp_min_key(lmin);  // the step's one serial reduction
    // Work that does not wait for it: the next step's neighbours, the next
    // copies, and the next step's inputs.
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + kWarp * j;
      // d - 1: lane - 1's value j, or lane 31's value j - 1 for lane 0
      const float up_src = (lane == kWarp - 1 && j > 0) ? L[j > 0 ? j - 1 : 0] : L[j];
      // d + 1: lane + 1's value j, or lane 0's value j + 1 for lane 31
      const float dn_src = (lane == 0 && j + 1 < VPL) ? L[j + 1 < VPL ? j + 1 : j] : L[j];
      const float u = __shfl_sync(kFull, up_src, (lane + kWarp - 1) & (kWarp - 1));
      const float v = __shfl_sync(kFull, dn_src, (lane + 1) & (kWarp - 1));
      up[j] = d == 0 ? L[j] : u;
      dn[j] = d == D - 1 ? L[j] : v;
    }
    __syncwarp();  // every lane is done with this step's slot
    issue();       // step s + K into it
    cp_async_wait<K - 1>();  // this lane's copies of step s + 1 have landed
    __syncwarp();            // ... and every lane's
    slot_cur = slot_cur + 1 == K ? 0 : slot_cur + 1;
    read_slot();  // (past the last step: stale values, never used)
    o_s += w.c_s;
    m = from_order_key(m_key);
  }
  cp_async_wait<0>();  // nothing left in flight when the warp ends
}

// ---------------------------------------------------------------------------
// D > 512: the carry in shared memory (NC chunks of 128, one row a warp,
// updated in place), lane l owning d = 128 c + 4 l + (0..3) of chunk c.
// Ring slot of one chunk: cost[128] | total[128] (ACC) | p2 (4 floats,
// filled for chunk 0 of a step).
// ---------------------------------------------------------------------------

template <bool VEC, bool ACC>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    sgm_sweep_smem_kernel(const Sweep w, int warps_per_block) {
  constexpr int kSlot = (ACC ? 2 * kChunk : kChunk) + 4;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  Chain ch;
  // warps past warps_per_block have no shared memory; they and those past
  // the last chain leave together, and no block-wide barrier follows
  if (warp >= warps_per_block ||
      !chain_of(w, static_cast<long long>(blockIdx.x) * warps_per_block + warp, ch))
    return;
  const int D = w.D;
  const int nc = (D + kChunk - 1) / kChunk;
  float* const base = reinterpret_cast<float*>(smem4) +
                      static_cast<size_t>(warp) * (nc * kChunk + kChunkRing * kSlot);
  float4* const carry = reinterpret_cast<float4*>(base);  // nc * 32 float4
  float* const ring = base + nc * kChunk;

  // The copies: chunk c_in of step s_in goes to slot slot_in.
  int s_in = 0, c_in = 0, slot_in = 0;
  const float* cs_in = ch.c;
  const float* os_in = ch.o;
  auto issue = [&]() {
    if (s_in < w.S) {
      float* slot = ring + slot_in * kSlot + 4 * lane;
      const int d0 = c_in * kChunk + 4 * lane;
      if (VEC) {
        if (d0 < D) {
          cp_async16(slot, cs_in + d0);
          if (ACC) cp_async16(slot + kChunk, os_in + d0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (d0 + j < D) {
            cp_async4(slot + j, cs_in + d0 + j);
            if (ACC) cp_async4(slot + kChunk + j, os_in + d0 + j);
          }
        }
      }
      if (c_in == 0 && lane == 0)
        cp_async4(ring + slot_in * kSlot + kSlot - 4, ch.q + s_in * w.p_s);
      slot_in = slot_in + 1 == kChunkRing ? 0 : slot_in + 1;
      if (++c_in == nc) {
        c_in = 0;
        ++s_in;
        cs_in += w.c_s;
        os_in += w.c_s;
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < kChunkRing - 1; ++i) issue();

  const float inf = inf_f();
  const float4 inf4 = make_float4(inf, inf, inf, inf);
  float m = 0.f;  // min_d L_{s-1}
  int slot_cur = 0;
  float* o_s = ch.o;
  for (int s = 0; s < w.S; ++s, o_s += w.c_s) {
    float lmin = inf, mp2 = 0.f;
    float4 nxt = s > 0 ? carry[lane] : inf4;
    float prev_w = inf;  // this lane's old value 4 l + 3 of the chunk before
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kChunkRing - 2>();
      __syncwarp();  // chunk (s, c) has landed; the slot before it is free
      issue();
      const float* slot = ring + slot_cur * kSlot;
      slot_cur = slot_cur + 1 == kChunkRing ? 0 : slot_cur + 1;
      const int d0 = c * kChunk + 4 * lane;
      const float4 c4 = reinterpret_cast<const float4*>(slot)[lane];
      const float Cv[4] = {d0 < D ? c4.x : inf, d0 + 1 < D ? c4.y : inf, d0 + 2 < D ? c4.z : inf,
                           d0 + 3 < D ? c4.w : inf};
      float nl[4];
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) nl[j] = Cv[j];
      } else {
        if (c == 0) mp2 = m + slot[kSlot - 4];
        const float4 old = nxt;
        if (c + 1 < nc) nxt = carry[(c + 1) * (kChunk / 4) + lane];
        const float Lv[4] = {old.x, old.y, old.z, old.w};
        // d0 - 1 from lane - 1, or from lane 31 of the chunk before
        float left = __shfl_up_sync(kFull, old.w, 1);
        const float left0 = __shfl_sync(kFull, prev_w, kWarp - 1);
        if (lane == 0) left = left0;
        // d0 + 4 from lane + 1, or from lane 0 of the next chunk
        float right = __shfl_down_sync(kFull, old.x, 1);
        const float right31 = __shfl_sync(kFull, nxt.x, 0);
        if (lane == kWarp - 1) right = right31;
        prev_w = old.w;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + j;
          float up = j > 0 ? Lv[j > 0 ? j - 1 : 0] : left;
          float dn = j < 3 ? Lv[j < 3 ? j + 1 : 3] : right;
          if (d == 0) up = Lv[j];
          if (d == D - 1) dn = Lv[j];
          const float best = fminf(fminf(Lv[j], fminf(up, dn) + w.p1), mp2);
          nl[j] = (Cv[j] + best) - m;  // +inf stays +inf past D
        }
      }
      carry[c * (kChunk / 4) + lane] = make_float4(nl[0], nl[1], nl[2], nl[3]);
      float v[4] = {nl[0], nl[1], nl[2], nl[3]};
      if (ACC) {
        const float4 t4 = reinterpret_cast<const float4*>(slot + kChunk)[lane];
        v[0] = t4.x + nl[0];
        v[1] = t4.y + nl[1];
        v[2] = t4.z + nl[2];
        v[3] = t4.w + nl[3];
      }
      if (VEC) {
        if (d0 < D) *reinterpret_cast<float4*>(o_s + d0) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d0 + j < D) o_s[d0 + j] = v[j];
      }
      lmin = fminf(lmin, fminf(fminf(nl[0], nl[1]), fminf(nl[2], nl[3])));
    }
    m = from_order_key(warp_min_key(lmin));
  }
  cp_async_wait<0>();
}

template <typename Kernel>
cudaError_t set_smem(Kernel* fn, int bytes) {
  if (bytes <= kSmemStatic) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int VPL, bool VEC, bool ACC>
cudaError_t launch_reg(const Sweep& w, cudaStream_t stream) {
  const int D4 = (w.D + 3) & ~3;
  const int slot_f = (ACC ? 2 * D4 : D4) + 4;
  const int bytes = kWarpsPerBlock * ring_depth(VPL) * slot_f * static_cast<int>(sizeof(float));
  const cudaError_t e = set_smem(sgm_sweep_reg_kernel<VPL, VEC, ACC>, bytes);
  if (e != cudaSuccess) return e;
  const long long chains = static_cast<long long>(w.B) * w.N;
  const dim3 grid(static_cast<unsigned>((chains + kWarpsPerBlock - 1) / kWarpsPerBlock));
  sgm_sweep_reg_kernel<VPL, VEC, ACC><<<grid, kWarp * kWarpsPerBlock, bytes, stream>>>(w);
  return cudaSuccess;
}

template <int VPL>
cudaError_t dispatch_reg(const Sweep& w, cudaStream_t stream) {
  if (w.vec)
    return w.accumulate ? launch_reg<VPL, true, true>(w, stream)
                        : launch_reg<VPL, true, false>(w, stream);
  return w.accumulate ? launch_reg<VPL, false, true>(w, stream)
                      : launch_reg<VPL, false, false>(w, stream);
}

template <bool VEC, bool ACC>
cudaError_t launch_smem(const Sweep& w, cudaStream_t stream) {
  constexpr int kSlot = (ACC ? 2 * kChunk : kChunk) + 4;
  const int nc = (w.D + kChunk - 1) / kChunk;
  const int per_warp = (nc * kChunk + kChunkRing * kSlot) * static_cast<int>(sizeof(float));
  int wpb = kSmemMax / per_warp;
  wpb = wpb < 1 ? 1 : (wpb > kWarpsPerBlock ? kWarpsPerBlock : wpb);
  const int bytes = wpb * per_warp;
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t e = set_smem(sgm_sweep_smem_kernel<VEC, ACC>, bytes);
  if (e != cudaSuccess) return e;
  const long long chains = static_cast<long long>(w.B) * w.N;
  const dim3 grid(static_cast<unsigned>((chains + wpb - 1) / wpb));
  sgm_sweep_smem_kernel<VEC, ACC><<<grid, kWarp * kWarpsPerBlock, bytes, stream>>>(w, wpb);
  return cudaSuccess;
}

cudaError_t dispatch_smem(const Sweep& w, cudaStream_t stream) {
  if (w.vec)
    return w.accumulate ? launch_smem<true, true>(w, stream) : launch_smem<true, false>(w, stream);
  return w.accumulate ? launch_smem<false, true>(w, stream) : launch_smem<false, false>(w, stream);
}

// The register widths compiled, in rising order up to kMaxVpl: D needing
// `vpl` values a lane runs on the first rung >= vpl (its extra values are
// d >= D and hold +inf, as in any ragged D); past the last rung the carry
// goes to shared memory.
template <int V, int... Rest>
cudaError_t dispatch_rungs(int vpl, const Sweep& w, cudaStream_t stream) {
  if (vpl <= V) return dispatch_reg<V>(w, stream);
  if constexpr (sizeof...(Rest) > 0) {
    return dispatch_rungs<Rest...>(vpl, w, stream);
  } else {
    static_assert(V == kMaxVpl, "the last rung is kMaxVpl");
    return dispatch_smem(w, stream);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry for ctypes: one sweep of B*N chains of S steps (see the
// note above; strides in floats, cost and out sharing theirs). Launches on
// `stream` without synchronizing and returns cudaGetLastError() (0 on
// success), or the error of a refused launch setting.
extern "C" int sgm_sweep_f32(const void* cost, const void* p2, void* out, int B, int S, int N,
                             int D, long long c_b, long long c_n, long long c_s, long long p_b,
                             long long p_n, long long p_s, float p1, int accumulate, int device,
                             void* stream) {
  if (B < 1 || S < 1 || N < 1 || D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Sweep w;
  w.cost = static_cast<const float*>(cost);
  w.p2 = static_cast<const float*>(p2);
  w.out = static_cast<float*>(out);
  w.c_b = c_b;
  w.c_n = c_n;
  w.c_s = c_s;
  w.p_b = p_b;
  w.p_n = p_n;
  w.p_s = p_s;
  w.B = B;
  w.S = S;
  w.N = N;
  w.D = D;
  w.p1 = p1;
  w.accumulate = accumulate != 0;
  w.vec = D % 4 == 0 && c_b % 4 == 0 && c_n % 4 == 0 && c_s % 4 == 0 && aligned16(cost) &&
          aligned16(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dispatch_rungs<1, 2, 3, 4, 6, 8, 12, 16>((D + kWarp - 1) / kWarp, w, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
