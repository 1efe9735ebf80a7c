"""The nearest-cell read (K11: ``ops/point_sample.py point_sample_nearest``)
of several checkouts, timed on the card on the same operands in one
process, and the split of the first design's time into its parts.

    python3 nearest_ab.py --trees build/parent . . build/parent [--out FILE]

The operands: seeded masks and uniform candidates (37,632 a mask) at the
point ranking's i.i.d. shapes: a MaskFiner-Mini batch-4 step's 16², 32² and
64² masks, the 96² ones of a 384x384 AFF-Mini batch-2 step, Swin-B's 160²
at batch 2, a batch-8 AFF step's 128² (stratification off) and 256² (the
direct route).  For each checkout, in the order given (its package imported
under an alias of its own, as ``interleaved_ab.py`` does, so that its own
wrapper and kernel library run): ms per call (``chip_smoke.cuda_ms``) and
on the card alone (``chip_smoke.queued_ms``); this checkout's kernel also
with the direct route forced; one ``torch.gather`` on the precomputed cell
index; the plain version.  Every result must equal the plain version's bit
for bit.  The split: probe kernels built with nvcc into ``build/tools/``
(git-ignored) -- the first design (one thread per point, the mask's number
by a 64-bit division, the cell read where the mask lies), the same without
the mask read, on a 2-D grid of (points, mask) without the division, both,
and a copy of the same coordinates and outputs 16 bytes a thread, with
evict-first loads and streaming stores.  Prints one JSON line with the
card's name and power limit, also appended to ``--out``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs
from interleaved_ab import PACKAGE, tree_ops

POINTS = 3 * 12544
# (label, masks, side)
SHAPES = (("maskfiner_16", 1200, 16), ("maskfiner_32", 1200, 32), ("maskfiner_64", 1600, 64),
          ("aff_384_96", 2000, 96), ("swin_160", 2000, 160), ("aff_b8_128", 8000, 128),
          ("direct_256", 2000, 256))
PROBES = ("first_design", "no_mask_read", "grid_2d", "grid_2d_no_mask_read", "stream_copy")

SOURCE = r"""
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 256;
__device__ __forceinline__ int cell_of(float c, int size) {
  return min(max((int)__fmul_rn(c, (float)size), 0), size - 1);
}
__global__ void __launch_bounds__(kThreads)
first_design(const float* __restrict__ img, const float2* __restrict__ coords,
             float* __restrict__ out, long long total, int P, int H, int W) {
  const long long pt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pt >= total) return;
  const float2 c = coords[pt];
  out[pt] = img[(pt / P) * (long long)H * W + (long long)cell_of(c.y, H) * W + cell_of(c.x, W)];
}
__global__ void __launch_bounds__(kThreads)
no_mask_read(const float2* __restrict__ coords, float* __restrict__ out, long long total, int P,
             int H, int W) {
  const long long pt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pt >= total) return;
  const float2 c = coords[pt];
  out[pt] = (float)((pt / P) * (long long)H * W + (long long)cell_of(c.y, H) * W + cell_of(c.x, W));
}
__global__ void __launch_bounds__(kThreads)
grid_2d(const float* __restrict__ img, const float2* __restrict__ coords,
        float* __restrict__ out, int P, int H, int W) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const long long m = blockIdx.y;
  const float2 c = coords[m * P + i];
  out[m * P + i] = img[m * H * W + cell_of(c.y, H) * W + cell_of(c.x, W)];
}
__global__ void __launch_bounds__(kThreads)
grid_2d_no_mask_read(const float2* __restrict__ coords, float* __restrict__ out, int P, int H,
                     int W) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const long long m = blockIdx.y;
  const float2 c = coords[m * P + i];
  out[m * P + i] = (float)(cell_of(c.y, H) * W + cell_of(c.x, W));
}
__global__ void __launch_bounds__(kThreads)
stream_copy(const float4* __restrict__ coords, float4* __restrict__ out, long long quads, int H,
            int W) {
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < quads;
       q += (long long)gridDim.x * kThreads) {
    const float4 a = __ldcs(coords + 2 * q), b = __ldcs(coords + 2 * q + 1);
    float4 o;
    o.x = (float)(cell_of(a.y, H) * W + cell_of(a.x, W));
    o.y = (float)(cell_of(a.w, H) * W + cell_of(a.z, W));
    o.z = (float)(cell_of(b.y, H) * W + cell_of(b.x, W));
    o.w = (float)(cell_of(b.w, H) * W + cell_of(b.z, W));
    __stcs(out + q, o);
  }
}
}  // namespace

// which: the index of the probe in PROBES; p a multiple of 4
extern "C" int aff_nearest_probe(int which, const float* img, const float* coords, float* out,
                                 int n, int p, int h, int w, int sms, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const long long total = (long long)n * p;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const dim3 grid((p + kThreads - 1) / kThreads, n);
  const float2* c2 = reinterpret_cast<const float2*>(coords);
  switch (which) {
    case 0: first_design<<<blocks, kThreads, 0, s>>>(img, c2, out, total, p, h, w); break;
    case 1: no_mask_read<<<blocks, kThreads, 0, s>>>(c2, out, total, p, h, w); break;
    case 2: grid_2d<<<grid, kThreads, 0, s>>>(img, c2, out, p, h, w); break;
    case 3: grid_2d_no_mask_read<<<grid, kThreads, 0, s>>>(c2, out, p, h, w); break;
    case 4: stream_copy<<<sms * 8, kThreads, 0, s>>>(reinterpret_cast<const float4*>(coords),
                                                    reinterpret_cast<float4*>(out), total / 4, h,
                                                    w); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


@functools.cache
def _probe() -> ctypes.CDLL:
    from autofocusformermod_torch.ops.build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the probe kernels cannot be built")
    out = BUILD_DIR.parent / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "nearest_probe.cu", out / "libnearest_probe.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.aff_nearest_probe.argtypes = [I, P, P, P, I, I, I, I, I, P]
    so.aff_nearest_probe.restype = ctypes.c_int
    return so


def split(masks, coords):
    """{probe: ms per call} of the probe kernels on (masks, coords); the
    first design's output is checked against the plain version."""
    import torch

    from autofocusformermod_torch.ops.point_sample import point_sample_nearest_plain

    so, (n, h, w), p = _probe(), masks.shape, coords.shape[1]
    out = torch.empty((n, p), device=masks.device)
    sms = torch.cuda.get_device_properties(masks.device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def launch(which):
        err = so.aff_nearest_probe(which, masks.data_ptr(), coords.data_ptr(), out.data_ptr(), n,
                                   p, h, w, sms, stream)
        if err:
            raise RuntimeError(f"aff_nearest_probe {PROBES[which]}: CUDA error {err}")

    launch(0)
    if not torch.equal(out, point_sample_nearest_plain(masks, coords)):
        raise SystemExit("the first design's probe disagrees with the plain version")
    return {name: cs.cuda_ms(lambda k=k: launch(k)) for k, name in enumerate(PROBES)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", default=["."],
                        help="checkouts, timed in this order (one may come more than once)")
    parser.add_argument("--out", help="a file to append the JSON line to")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("nearest_ab: needs a CUDA device")
    from autofocusformermod_torch.ops import point_sample as ps
    from autofocusformermod_torch.ops.dispatch import plain_versions

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    roots = list(dict.fromkeys(args.trees))
    ops = {root: tree_ops(root, f"{PACKAGE}_ab{i}", "ops.point_sample")
           for i, root in enumerate(roots)}
    build = [importlib.import_module(m.__name__.rsplit(".", 1)[0] + ".build") for m in ops.values()]
    with ThreadPoolExecutor(len(build)) as pool:
        list(pool.map(lambda b: b.build_library(), build))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    res = {}
    for label, n, side in SHAPES:
        masks = torch.randn((n, side, side), generator=gen, device=dev) * 3
        coords = torch.rand((n, POINTS, 2), generator=gen, device=dev)
        with plain_versions():
            want = ps.point_sample_nearest(masks, coords)
            plain_ms = cs.cuda_ms(lambda: ps.point_sample_nearest(masks, coords), iters=3,
                                  warmup=1)
        cells = ((coords[..., 1] * side).int().clamp(0, side - 1) * side
                 + (coords[..., 0] * side).int().clamp(0, side - 1)).long()
        flat = masks.reshape(n, -1)
        forms = [(f"{i}:{root}", lambda f=ops[root].point_sample_nearest_forward: f(masks, coords))
                 for i, root in enumerate(args.trees)]
        forms += [("direct", lambda: ps.point_sample_nearest_forward(masks, coords, "direct")),
                  ("torch.gather", lambda: torch.gather(flat, 1, cells))]
        rec = {"masks": [n, side, side], "points": POINTS,
               "route": ps.point_sample_nearest_route(side, side), "plain_ms": plain_ms,
               "bound_ms": n * (side * side + 3 * POINTS) * 4 / cs.PEAK_BYTES_S * 1e3}
        for name, fn in forms:
            if not torch.equal(fn().reshape(n, POINTS), want):
                raise SystemExit(f"{label} {name}: differs from the plain version")
            rec[name] = {"ms": cs.cuda_ms(fn), "device_ms": cs.queued_ms(fn)}
        rec["split_ms"] = split(masks, coords)
        res[label] = rec
        cs.log(f"{label} {json.dumps(rec)}")
        del masks, coords, want, cells, flat
        torch.cuda.empty_cache()
    line = json.dumps({"card": card, "trees": args.trees, "res": res})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
