#!/usr/bin/env python3
"""Time the bf16 Conformer conv module kernels (B6: forward and backward)
of one checkout on one NVIDIA GPU, or compare two checkouts on the same
card in turns.

    python3 scripts_torch/bench_conv.py [--root DIR]
    python3 scripts_torch/bench_conv.py --compare PARENT_DIR

With ``--root`` (default: this checkout) the package is imported from DIR
and its kernels are built there. It prints the card's name and power
limit, then ``ptxas``'s registers and spills of every kernel in the two
conv libraries, the bf16 launches' dynamic shared memory and CTAs an SM at
D 256 and 512 (k 31; from the kernels' C entries, where the checkout has
them), and at Conformer-M's shape (B 64, T 250, D 256, k 31, the lengths
``chip_smoke.py`` draws, bf16): the device milliseconds of the forward
and of the backward by ``chip_smoke.py``'s back-to-back method, each
call's split by kernel (the mean device time of each launch over a
``torch.profiler`` trace of ten calls), their bounds
(``conv_bound_ms``, ``conv_bwd_bound_ms``), the backward's workspace in
bytes, and the module's unfused torch chain (``_ConvModule``, forward and
forward plus backward under autograd), the yardstick. The last line is a
JSON object of all of it.

``--compare`` runs PARENT_DIR, this checkout, this checkout, PARENT_DIR,
one process each, so that both designs are timed on one card in one
call, and prints each process's JSON line, then one with the runs. It
needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts_torch"))
from bench_relpos import _chip_smoke  # noqa: E402
from profile_eval import device_intervals  # noqa: E402

# name, B, T, D, k: Conformer-M's conv module
SHAPE = (64, 250, 256, 31)
LIBS = ("conformer_conv_fwd", "conformer_conv_bwd")


def kernel_resources(build, cc) -> dict:
    """ptxas's registers and spills of every kernel of the two libraries,
    and the bf16 launches' shared memory and CTAs an SM at D 256 and 512,
    k 31, where the checkout reports them (``fwd_resources``,
    ``bwd_resources``)."""
    out = {}
    for lib in LIBS:
        log = build.library_path(lib).with_suffix(".log").read_text()
        out[lib] = [{"entry": entry, "registers": int(regs),
                     "spill_bytes": int(stores) + int(loads)}
                    for entry, stores, loads, regs in re.findall(
                        r"Compiling entry function '(\S+)'.*?(\d+) bytes "
                        r"spill stores, (\d+) bytes spill loads.*?Used "
                        r"(\d+) registers", log, re.S)]
    if hasattr(cc, "fwd_resources"):
        for D in (256, 512):
            out["fwd_D{}".format(D)] = dict(zip(
                ("tile", "smem", "ctas_per_sm"), cc.fwd_resources(D, 31)))
            out["bwd_D{}".format(D)] = [
                dict(zip(("tile", "smem", "ctas_per_sm"), r))
                for r in cc.bwd_resources(D, 31)]
    return out


def split_ms(fn, calls: int = 10) -> dict:
    """The mean device ms of each kernel a call of ``fn`` launches, by
    name, from one ``torch.profiler`` trace of ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        intervals = device_intervals(path)
    if not intervals:
        raise SystemExit("bench_conv: the trace holds no device activity")
    ms, count = collections.Counter(), collections.Counter()
    for s, e, name in intervals:
        # the name less its parameter list ("(anonymous namespace)" kept)
        key = re.sub(r"\([^()]*\)$", "", name)[:80]
        ms[key] += (e - s) / 1e3 / calls
        count[key] += 1
    return {k: {"ms": v, "launches": count[k] / calls}
            for k, v in ms.most_common()}


def run_one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from openseq2seq_tpu_torch.encoders.conformer_encoder import _ConvModule
    from openseq2seq_tpu_torch.kernels import build
    from openseq2seq_tpu_torch.ops import conformer_conv as cc
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for lib in LIBS:
        build.load(lib)
    dev = torch.device("cuda")
    B, T, D, k = SHAPE
    x, lengths, weights = cs.conv_case(B, T, D, k, 60, dev)
    dy = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    args = (x.bfloat16(), lengths) + weights
    bwd = args + (dy.bfloat16(),)
    if hasattr(cc, "bwd_workspace"):
        workspace = cc.bwd_workspace(B, T, D, k)
    else:
        workspace = cc._kernel("workspace")(B, T, D, k)
    module = _ConvModule(D, k, torch.bfloat16, False,
                         torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        for p, w in zip(module.parameters(), weights):
            p.copy_(w)
    xg = args[0].detach().requires_grad_()

    def unfused_fwd_bwd():
        module(xg, lengths).backward(bwd[-1])
    with torch.no_grad():
        fwd_ms = cs.cuda_ms(lambda: cc.conformer_conv_module_cuda(*args),
                            50)
        unfused_ms = cs.cuda_ms(lambda: module(args[0], lengths), 20)
    result = {
        "root": os.path.abspath(root), "card": card,
        "kernels": kernel_resources(build, cc),
        "fwd_ms": fwd_ms,
        "bwd_ms": cs.cuda_ms(lambda: cc.conformer_conv_module_cuda_bwd(*bwd),
                             20),
        "fwd_split": split_ms(lambda: cc.conformer_conv_module_cuda(*args)),
        "bwd_split": split_ms(
            lambda: cc.conformer_conv_module_cuda_bwd(*bwd)),
        "fwd_bound_ms": cs.conv_bound_ms(args[0], weights)[0],
        "bwd_bound_ms": cs.conv_bwd_bound_ms(args[0], weights)[0],
        "workspace_bytes": workspace,
        "unfused_fwd_ms": unfused_ms,
        "unfused_fwd_bwd_ms": cs.cuda_ms(unfused_fwd_bwd, 20)}
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--compare", default=None)
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv: no CUDA device")
    if opts.compare is None:
        result = run_one(opts.root)
        print(result["card"], flush=True)
        for lib, recs in result["kernels"].items():
            print("[resources] {}: {}".format(lib, recs), flush=True)
        for way in ("fwd", "bwd"):
            print("[{}] {:.4f} ms (bound {:.4f}); by kernel: {}".format(
                way, result[way + "_ms"], result[way + "_bound_ms"],
                "; ".join("{} {:.4f} ms x {:g}".format(k, v["ms"],
                                                       v["launches"])
                          for k, v in result[way + "_split"].items())),
                flush=True)
        print("[bwd] workspace {} bytes; the unfused chain: forward {:.4f} "
              "ms, forward plus backward {:.4f} ms".format(
                  result["workspace_bytes"], result["unfused_fwd_ms"],
                  result["unfused_fwd_bwd_ms"]), flush=True)
        print(json.dumps(result), flush=True)
        return
    lines = []
    for root in (opts.compare, REPO, REPO, opts.compare):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--root", root], capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit("bench_conv: {} failed:\n{}".format(
                root, proc.stdout[-4000:]))
        print(proc.stdout, end="", flush=True)
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"runs": lines}), flush=True)


if __name__ == "__main__":
    main()
