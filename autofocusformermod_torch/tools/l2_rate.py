"""The card's L2 read rate, measured: a small CUDA kernel reads a buffer that
stays resident in L2 several times over, 16 bytes a lane with loads that
skip L1 (``ld.global.cg``), and the bytes over the card's time give the rate.
``chip_smoke.py`` reads it to state the least time in which L2 can serve a
kernel's gathered rows (the msdetrpc forward's value rows).

    python3 -m autofocusformermod_torch.tools.l2_rate

The kernel is not one of the port's: it is built on first use with nvcc
into ``build/tools/`` (git-ignored), beside the kernel library.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(512)
l2_read(const float4* __restrict__ buf, long long n4, int reps, float* __restrict__ sink) {
  float acc = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    for (long long i = (long long)blockIdx.x * 512 + threadIdx.x; i < n4;
         i += (long long)gridDim.x * 512) {
      const float4 v = __ldcg(buf + i);
      acc += v.x + v.y + v.z + v.w;
    }
  }
  if (acc == 12345.678f) sink[0] = acc;    // keeps the loads; never true for the probe's data
}

extern "C" int aff_l2_read(const float* buf, long long n4, int reps, float* sink, int blocks,
                           void* stream) {
  l2_read<<<blocks, 512, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(buf), n4, reps, sink);
  return static_cast<int>(cudaGetLastError());
}
"""


@functools.cache
def _probe() -> ctypes.CDLL:
    from ..ops.build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the L2 probe cannot be built")
    out = BUILD_DIR.parent / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "l2_read.cu", out / "libl2_read.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.aff_l2_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p]
    so.aff_l2_read.restype = ctypes.c_int
    return so


def l2_read_rate(mib: int = 24, reps: int = 16, iters: int = 20) -> float:
    """Bytes per second read from L2: `mib` MiB (well inside the H100's 50
    MB) read `reps` times per launch by 4 blocks per SM, `iters` launches back
    to back after a warm one, timed with CUDA events."""
    import torch

    so = _probe()
    buf = torch.rand(mib * 2 ** 18, device="cuda")
    sink = torch.zeros(1, device="cuda")
    blocks = 4 * torch.cuda.get_device_properties(buf.device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = so.aff_l2_read(buf.data_ptr(), buf.numel() // 4, reps, sink.data_ptr(), blocks,
                             stream)
        if err:
            raise RuntimeError(f"aff_l2_read: CUDA error {err}")

    launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    return buf.numel() * 4 * reps * iters / (start.elapsed_time(end) * 1e-3)


def main() -> None:
    import torch

    print(f"{torch.cuda.get_device_name(0)}: L2 read rate {l2_read_rate() / 1e12:.3f} TB/s")


if __name__ == "__main__":
    main()
