// The grouped matmul's work list, shared by its forward (moe_gmm.cu) and
// its backward (moe_gmm_bwd.cu).  Rows are sorted by expert; the E group
// sizes are read on the device, each counted as at least 0 and each end cut
// at T, and the rows past the last group (sum(group_sizes) < T) form one
// more group, E.  Each group's rows are cut into row tiles of BT, and a
// work unit is (group, row tile, column tile): a block takes the sizes'
// prefix sums in shared memory (scan_groups, one warp, a shuffle scan 32
// groups at a time) and finds a unit's group by a binary search
// (find_unit).
#pragma once

#include <cuda_runtime.h>

namespace repro {
namespace gmm {

using ll = long long;

constexpr int MAX_E = 512;     // experts a call may have (MAX_EXPERTS in
                               // kernels/moe_gmm/kernel.py)

// group g's end row and the row tiles of groups 0..g; group E is the rows
// past the last expert's
struct Groups {
  int row_end[MAX_E + 1];
  int tile_end[MAX_E + 1];
};

template <int BT>
__device__ void scan_groups(Groups& s, const int* __restrict__ group_sizes,
                            int T, int E, int lane) {
  ll row_carry = 0;
  int tile_carry = 0, prev_end = 0;
  for (int base = 0; base <= E; base += 32) {
    const int g = base + lane;
    // a size counts as at least 0; the group of the rest takes all of T,
    // and every end is cut at T
    ll v = g < E ? (ll)max(group_sizes[g], 0) : (g == E ? (ll)T : 0);
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const ll n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    const int end = (int)min(row_carry + v, (ll)T);
    int start = __shfl_up_sync(0xffffffffu, end, 1);
    if (lane == 0) start = prev_end;
    int tv = (end - start + BT - 1) / BT;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int n = __shfl_up_sync(0xffffffffu, tv, off);
      if (lane >= off) tv += n;
    }
    if (g <= E) {
      s.row_end[g] = end;
      s.tile_end[g] = tile_carry + tv;
    }
    row_carry += __shfl_sync(0xffffffffu, v, 31);
    prev_end = __shfl_sync(0xffffffffu, end, 31);
    tile_carry += __shfl_sync(0xffffffffu, tv, 31);
  }
}

struct Unit {
  int g;        // expert, or E for the rows past the last group
  int r0;       // first row
  int nrows;    // rows of the expert in this tile, 1..BT
  int n0;       // first output column
};

// Unit u of the list: row tile u / n_col_tiles, column tile u % n_col_tiles.
template <int BT, int BN>
__device__ __forceinline__ Unit find_unit(const Groups& s, int u,
                                          int n_col_tiles, int E) {
  const int tile = u / n_col_tiles;
  int lo = 0, hi = E;                              // first g: tile_end > tile
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s.tile_end[mid] > tile) hi = mid;
    else lo = mid + 1;
  }
  Unit t;
  t.g = lo;
  const int g_row0 = lo == 0 ? 0 : s.row_end[lo - 1];
  const int g_tile0 = lo == 0 ? 0 : s.tile_end[lo - 1];
  t.r0 = g_row0 + (tile - g_tile0) * BT;
  t.nrows = min(BT, s.row_end[lo] - t.r0);
  t.n0 = (u % n_col_tiles) * BN;
  return t;
}

}  // namespace gmm
}  // namespace repro
