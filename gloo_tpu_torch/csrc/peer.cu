// Peer-mapped device memory across processes (CUDA IPC), with a plain C
// interface: the layer under tpu/peer.py's PeerWorkspace and the
// cross-process instances of the ring kernels (ring.cu's
// gtt_ring_peer_*).
//
// Replaces no TPU kernel. The reference reaches another host's chips
// through jax.distributed and remote DMAs inside its Pallas ring kernels
// (gloo_tpu/tpu/multihost.py, gloo_tpu/ops/pallas_ring.py); here each
// process allocates one workspace with cudaMalloc, exports an IPC handle
// for it, and opens every peer's handle with
// cudaIpcMemLazyEnablePeerAccess: on the same card the mapping is the
// peer's own memory, on another card of the host it is reached over
// NVLink. The kernels then load and store through those pointers and
// signal through flags at system scope.
//
// gtt_peer_pingpong is the probe of the hand-off between processes: one
// block in each of two processes bounces a counter through two flags in
// peer-mapped memory, each side spinning (bounded, ~2 s, then __trap) on
// an acquire load at system scope. On one card the processes' contexts
// time-slice, so every hand-off waits until the card switches to the
// other context: the round trips per second measure that switch.
//
// What bounds the probe: neither bytes nor operations (two ints per
// round trip); the time to switch contexts on one card, or the link's
// latency between cards.

#include <cuda_runtime.h>

#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

// Round i (from 1): the pinger stores i into the ponger's flag and waits
// for its own to reach i; the ponger waits for i, then stores i back.
// One thread.
__global__ void pingpong_kernel(int* mine, int* peer, int ping, int rounds) {
  for (int i = 1; i <= rounds; ++i) {
    if (ping) {
      store_release<Scope::kSys>(peer, i);
      wait_flag<Scope::kSys>(mine, i);
    } else {
      wait_flag<Scope::kSys>(mine, i);
      store_release<Scope::kSys>(peer, i);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of one IPC handle (cudaIpcMemHandle_t).
int gtt_peer_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// A zeroed allocation of `bytes` on the current device, in *ptr.
int gtt_peer_alloc(long long bytes, void** ptr) {
  *ptr = nullptr;
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

int gtt_peer_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// The handle of the allocation that starts at `base` into `handle`
// (gtt_peer_handle_bytes() bytes), and the byte offset of `ptr` inside it.
int gtt_peer_export(void* base, const void* ptr, void* handle,
                    long long* offset) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, base);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(handle, &h, sizeof(h));
  *offset = static_cast<const char*>(ptr) - static_cast<const char*>(base);
  return 0;
}

// Maps a peer process's allocation by its handle: the base in *ptr.
int gtt_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  *ptr = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int gtt_peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// The probe: `rounds` round trips with a peer through `mine` (this
// process's flag, written by the peer) and `peer` (the peer's flag,
// mapped here); ping = 1 on the side that starts. Both flags start at 0.
int gtt_peer_pingpong(int* mine, int* peer, int ping, int rounds,
                      void* stream) {
  pingpong_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      mine, peer, ping, rounds);
  return static_cast<int>(cudaGetLastError());
}

const char* gtt_peer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
