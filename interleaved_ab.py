"""The interleaved sampling op (K6: ``ops/clusten.py`` ``msdetrpc_forward``
and ``msdetrpc_backward``) of several checkouts, timed on the card on the
same operands in one process.

    python3 interleaved_ab.py --trees build/parent . . build/parent [--fold] [--out FILE]

The operands: K6's 18 calls, with the gradient each call's backward got,
from a seeded batch-8 training step under ``USE_STACKED_GLUE = False`` at
AFF-Mini 384x384 (decoder levels 144, 576, 2304) and at AFF-Mini-1/5 512x512
(3276, 655, 131), captured with this checkout's
``chip_smoke.path_layout_operands``, and the uniform draw at the 384x384
shapes (``chip_smoke.sampling_uniform_calls``).  Every other checkout's
package is imported under an alias of its own, so that its wrappers drive
its own kernel library (built under its ``build/``, all checkouts at once).
For each checkout, in the order given, and each operand set: device ms
summed over the calls (``chip_smoke.queued_ms``), forward and backward; the
worst error against this checkout's plain version (forward absolute, each
gradient relative to its largest entry, at least 1); whether two backward
calls gave the same bits.  A checkout whose kernel computes part of the
function (a scratch copy with a pass cut out) is timed all the same: its
errors show it.  ``--fold`` adds this checkout's stacked kernels with one
level, the attention folded into the weights and the folded gradient split
by PyTorch (the TPU wrapper's arrangement).  Prints one JSON line with the
card's name and power limit, also appended to ``--out``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
PACKAGE = "autofocusformermod_torch"


def tree_ops(root: str, alias: str, module: str = "ops.clusten"):
    """The checkout's `module` (default ops/clusten.py), its package imported
    as `alias` (this checkout's as itself)."""
    pkg = Path(root).resolve() / PACKAGE
    if pkg.parent == HERE:
        return importlib.import_module(f"{PACKAGE}.{module}")
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                      submodule_search_locations=[str(pkg)])
        package = importlib.util.module_from_spec(spec)
        sys.modules[alias] = package
        spec.loader.exec_module(package)
    return importlib.import_module(f"{alias}.{module}")


def fold_forms():
    """This checkout's stacked kernels with the attention folded in by
    PyTorch: (forward, backward) on the interleaved operands."""
    from autofocusformermod_torch.ops import msdetrpc as md

    def fwd(idx, w, attn, val):
        return md.msdetrpc_forward(*cs.stacked_form("interleaved", (idx, w, attn), val, None))

    def bwd(idx, w, attn, val, g):
        idx_s, w_s, _, sizes = cs.stacked_form("interleaved", (idx, w, attn), val, None)
        d_val, d_ws = md.msdetrpc_levels_s_backward(idx_s, w_s, val, g, sizes)
        d_ws = d_ws.reshape(w.shape)
        return d_ws * attn[..., None], (d_ws * w).sum(-1), d_val

    return fwd, bwd


def time_set(forms, calls):
    """{form: ms, worst error, bit-identical backward} over `calls` [(ops,
    val, sizes, g, times)], each call's time counted `times` times."""
    import torch

    from autofocusformermod_torch.ops import clusten
    from autofocusformermod_torch.ops.dispatch import plain_versions

    res = {name: {"fwd_ms": 0.0, "bwd_ms": 0.0, "max_err": 0.0, "bit_identical": True}
           for name, _ in forms}
    for (idx, w, attn), val, _, g, times in calls:
        leaves = [x.clone().requires_grad_() for x in (w, attn, val)]
        with plain_versions():
            ref = clusten.msdetrpc_plain(idx, *leaves)
        want = torch.autograd.grad(ref, leaves, g)
        ref = ref.detach()
        for name, (fwd, bwd) in forms:
            r = res[name]
            r["fwd_ms"] += times * cs.queued_ms(lambda: fwd(idx, w, attn, val))
            r["bwd_ms"] += times * cs.queued_ms(lambda: bwd(idx, w, attn, val, g))
            got, again = bwd(idx, w, attn, val, g), bwd(idx, w, attn, val, g)
            errs = [(fwd(idx, w, attn, val) - ref).abs().max().item()]
            errs += [((a - b).abs().max() / b.abs().max().clamp(min=1)).item()
                     for a, b in zip(got, want)]
            r["max_err"] = max(r["max_err"], *errs)
            r["bit_identical"] &= all(torch.equal(a, b) for a, b in zip(got, again))
        del ref, want, leaves
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", default=["."],
                        help="checkouts, timed in this order (one may come more than once)")
    parser.add_argument("--fold", action="store_true")
    parser.add_argument("--out", help="a file to append the JSON line to")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("interleaved_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    roots = list(dict.fromkeys(args.trees))
    ops = {root: tree_ops(root, f"{PACKAGE}_ab{i}") for i, root in enumerate(roots)}
    build = [importlib.import_module(m.__name__.rsplit(".", 1)[0] + ".build") for m in ops.values()]
    with ThreadPoolExecutor(len(build)) as pool:
        list(pool.map(lambda b: b.build_library(), build))
    forms = [(f"{i}:{root}", (ops[root].msdetrpc_forward, ops[root].msdetrpc_backward))
             for i, root in enumerate(args.trees)]
    if args.fold:
        forms.append(("fold", fold_forms()))

    cases = {f"b8_path_{size}": (preset, size)
             for preset, size in (("aff_mini", cs.ODD_SIZE), (cs.MINI15, cs.SIZE))}
    res = {}
    for case, (preset, size) in cases.items():
        calls = cs.path_layout_operands(dev, "msdetrpc_interleaved", preset, size)
        res[case] = time_set(forms, calls)
        cs.log(f"{case} {json.dumps(res[case])}")
        del calls
        torch.cuda.empty_cache()
    uniform = cs.sampling_uniform_calls(torch.Generator().manual_seed(cs.SEED), dev, "interleaved",
                                        cs.TRAIN_BATCH)
    res["b8_uniform_384"] = time_set(forms, uniform)
    line = json.dumps({"card": card, "trees": args.trees, "res": res})
    cs.log(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
