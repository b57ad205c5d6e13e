// The geometry a kernel's launcher chooses on the host, as its C query
// reports it (repro_torch.analysis.geometry): the launchers take a
// LaunchGeo* and, given one, fill it in and return before the launch, so
// that the query and the launch run the same host code.
#pragma once

struct LaunchGeo {
  long long grid;     // blocks (a 1-D grid)
  long long threads;  // threads a block
  long long smem;     // dynamic shared memory a block, bytes
  long long variant;  // which kernel instance (per source, see its query)
};

inline int put_geo(LaunchGeo value, LaunchGeo* geo) {
  *geo = value;
  return 0;
}
