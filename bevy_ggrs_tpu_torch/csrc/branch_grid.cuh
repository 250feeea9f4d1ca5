// The branch axis of the force kernels' grids. gridDim.y holds at most
// 65,535 blocks, so a launch over more branches folds the excess into
// gridDim.z: branch b = blockIdx.y + gridDim.y * blockIdx.z, and a block
// whose b is past the last branch leaves at once (every block of a
// cluster shares its y and z, so a cluster leaves whole). Each branch's
// blocks run as in an unbatched launch, so each branch stays bitwise its
// unbatched launch's.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxGridY = 65535;

inline dim3 ggrs_branch_grid(unsigned x, long long branches) {
  const long long y = branches < kMaxGridY ? branches : kMaxGridY;
  const long long z = (branches + kMaxGridY - 1) / kMaxGridY;
  return dim3(x, (unsigned)y, (unsigned)z);
}
