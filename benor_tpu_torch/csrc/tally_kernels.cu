// The dense-path tally kernel, for Hopper (sm_90a).
//
// It replaces the Pallas TPU kernel of benor_tpu/ops/pallas_tally.py:
//   dense_counts_kernel <- _tally_kernel (dense_counts_pallas)
// and computes, from an explicit delivery mask,
//   counts[t, r, c] = #{s : mask[t, r, s] and alive[t, s] and sent[t, s] == c}
// for c = 0, 1, 2 (mask bool [T, R, S], sent int8 [T, S], alive bool [T, S]
// -> int32 [T, R, 3]).  Its plain torch version lives beside the wrapper
// in ops/dense.py.
//
// What bounds it.  One byte read and three integer adds per edge: at
// T = 32, R = S = 2048 the mask is 134 MB (0.040 ms at 3.35 TB/s) against
// 0.4 G integer operations (0.006 ms at 67 Tops/s): bytes.  So the design
// spends nothing on arithmetic units and everything on streaming the mask
// once, in wide loads, with enough of them in flight:
//   * The TPU kernel's matrix product (classes padded to 128 columns, the
//     trial's row picked by a one-hot reduce, an f32 [T, R, 128] output
//     sliced afterwards) has no counterpart here; a tensor core would
//     spend 125 of 128 columns on zeros.
//   * Per block, the senders' classes are staged once in shared memory as
//     three byte planes, plane[c][s] = alive[t, s] && sent[t, s] == c (a
//     value of sent outside {0, 1, 2} sets no plane and counts nowhere).
//     A bool is one byte of 0 or 1, so for four mask bytes in a word,
//     popc(mask_word & plane_word) is their count of class c.
//   * One warp per (t, r) row, four rows a warp, 32 rows a block.  Where a
//     row starts on a 16-byte boundary its lanes read it in 16-byte loads
//     (consecutive lanes, consecutive vectors; four in flight a lane at
//     S = 2048) against 16-byte shared loads of the planes; the tail of
//     such a row, and every byte of a row that does not start on a
//     boundary (S not a multiple of 16), goes byte by byte.  A warp sum
//     (__reduce_add_sync) and lane 0 writes the three int32 counts
//     straight into [T, R, 3].
//   * S of any size: the planes hold kTile senders at a time and the
//     per-row counters live in registers across the tiles.
// Integer arithmetic throughout, so the counts equal the plain version's
// exactly, whatever the launch geometry.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = (kThreads / 32) * kRowsPerWarp;
// Senders staged in shared memory at a time (3 planes x kTile bytes); a
// multiple of 16, so a tile starts on a 16-byte boundary iff its row does.
constexpr int kTile = 8192;

__global__ void __launch_bounds__(kThreads)
dense_counts_kernel(const uint8_t* __restrict__ mask,
                    const int8_t* __restrict__ sent,
                    const uint8_t* __restrict__ alive, int* __restrict__ out,
                    int R, int S, int blocks_per_trial) {
  __shared__ __align__(16) uint8_t plane[3][kTile];
  const int t = blockIdx.x / blocks_per_trial;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x - t * blocks_per_trial) * kRowsPerBlock +
                   warp * kRowsPerWarp;
  const int8_t* sent_t = sent + (size_t)t * S;
  const uint8_t* alive_t = alive + (size_t)t * S;

  int cnt[kRowsPerWarp][3];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) cnt[j][0] = cnt[j][1] = cnt[j][2] = 0;

  for (int c0 = 0; c0 < S; c0 += kTile) {
    const int len = min(kTile, S - c0);
    if (c0) __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int v = alive_t[c0 + i] ? (int)sent_t[c0 + i] : 3;
      plane[0][i] = (uint8_t)(v == 0);
      plane[1][i] = (uint8_t)(v == 1);
      plane[2][i] = (uint8_t)(v == 2);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int row = row0 + j;
      if (row < R) {  // uniform over the warp
        const uint8_t* p = mask + ((size_t)t * R + row) * (size_t)S + c0;
        const int nvec = (((uintptr_t)p & 15) == 0) ? (len >> 4) : 0;
        const uint4* pv = reinterpret_cast<const uint4*>(p);
        const uint4* q0 = reinterpret_cast<const uint4*>(plane[0]);
        const uint4* q1 = reinterpret_cast<const uint4*>(plane[1]);
        const uint4* q2 = reinterpret_cast<const uint4*>(plane[2]);
        int a0 = 0, a1 = 0, a2 = 0;
#pragma unroll 4
        for (int v = lane; v < nvec; v += 32) {
          const uint4 m = __ldg(pv + v);
          const uint4 b0 = q0[v];
          const uint4 b1 = q1[v];
          const uint4 b2 = q2[v];
          a0 += __popc(m.x & b0.x) + __popc(m.y & b0.y) + __popc(m.z & b0.z) +
                __popc(m.w & b0.w);
          a1 += __popc(m.x & b1.x) + __popc(m.y & b1.y) + __popc(m.z & b1.z) +
                __popc(m.w & b1.w);
          a2 += __popc(m.x & b2.x) + __popc(m.y & b2.y) + __popc(m.z & b2.z) +
                __popc(m.w & b2.w);
        }
        for (int s = (nvec << 4) + lane; s < len; s += 32) {
          const int mb = p[s];  // 0 or 1
          a0 += mb & plane[0][s];
          a1 += mb & plane[1][s];
          a2 += mb & plane[2][s];
        }
        cnt[j][0] += a0;
        cnt[j][1] += a1;
        cnt[j][2] += a2;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = row0 + j;
    if (row < R) {
      const int s0 = __reduce_add_sync(0xffffffffu, cnt[j][0]);
      const int s1 = __reduce_add_sync(0xffffffffu, cnt[j][1]);
      const int s2 = __reduce_add_sync(0xffffffffu, cnt[j][2]);
      if (lane == 0) {
        int* o = out + ((size_t)t * R + row) * 3;
        o[0] = s0;
        o[1] = s1;
        o[2] = s2;
      }
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 = launched); an empty output launches nothing, and S = 0
// writes zero counts.

extern "C" int benor_dense_counts(const uint8_t* mask, const int8_t* sent,
                                  const uint8_t* alive, int* out, int T,
                                  int R, int S, cudaStream_t stream) {
  if (T <= 0 || R <= 0) return 0;
  const int blocks_per_trial = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t blocks = (size_t)T * (size_t)blocks_per_trial;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  dense_counts_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      mask, sent, alive, out, R, S, blocks_per_trial);
  return (int)cudaGetLastError();
}
