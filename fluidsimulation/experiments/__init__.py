"""Engineering experiments kept apart from the product tree.  Everything
here is functional and equality-tested but lost its A/B against the
shipped path when it was first measured; kept, with its tests, for the
GPU benchmark to re-judge (PERF.md).

- wavefront: global ray-pool exact renderer — lost to the scan-tiled
  renderer's whole-tile early exits.
"""
