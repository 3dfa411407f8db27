// K17g — the link probe: a trivial device loop whose small-k wall time
// is the host<->device round trip of one dispatch and a 4-byte pull.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/devloop.py:406 _probe_loop
// (a lax.fori_loop adding x[i % 8, i % 8] into a uint32): one thread of
// one block runs the same `steps` integer adds over the 8 x 8 uint8
// tensor and writes the uint32 sum.  What bounds it: nothing on the card
// (a few adds); the launch and the pull are the measured quantity
// (ops/devloop.py measure_link_rtt times it on the host, as the
// reference does).
#include "common.cuh"

namespace {

__global__ void probe_loop_kernel(const uint8_t* __restrict__ x, unsigned* out, int steps) {
  unsigned acc = 0;
  for (int i = 0; i < steps; ++i) acc += x[(i % 8) * 8 + i % 8];
  *out = acc;
}

}  // namespace

extern "C" int probe_loop_launch(const uint8_t* x, unsigned* out, int steps,
                                 cudaStream_t stream) {
  if (steps < 0) return cudaErrorInvalidValue;
  probe_loop_kernel<<<1, 1, 0, stream>>>(x, out, steps);
  return dngd_last_error();
}
