#!/usr/bin/env python3
"""Time the CTC kernels (B1a: the forward; B1b: the backward) of one
checkout on one NVIDIA GPU, or compare two checkouts on the same card in
turns.

    python3 scripts_torch/bench_ctc.py [--root DIR]
    python3 scripts_torch/bench_ctc.py --compare PARENT_DIR

With ``--root`` (default: this checkout) the package is imported from DIR
and its kernels are built there. It prints the card's name and power
limit, then ``ptxas``'s registers and spills of every kernel in the two
CTC libraries and the kernels' resources at L 160 and 600, V 29
(``ctc_resources``, where the checkout has it), and at the Jasper train
shape (B 32, T 500) and Conformer-M's (B 64, T 250), both L 160, V 29,
fp32, on ``chip_smoke.py``'s cases: the device milliseconds, by
``chip_smoke.py``'s back-to-back method, of the forward without the
lattice (eval) and with it, of the backward alone (each launch's share
from a ``torch.profiler`` trace of ten calls) and of forward plus
backward; ``F.ctc_loss`` forward and forward plus backward on the same
inputs, the yardstick; the kernels' bounds (``ctc_bound_ms``); and the
per-frame floor: ``ctc_alpha_floor``'s time (the forward's recursion with
its emissions in registers and no lattice) over the longest row's frames
less one, in microseconds, where the checkout has it. The last line is
a JSON object of all of it.

``--compare`` runs PARENT_DIR, this checkout, this checkout, PARENT_DIR,
one process each, so that both designs are timed on one card in one
call, and prints each process's JSON line, then one with the runs. It
needs a CUDA device.

    python3 scripts_torch/bench_ctc.py --rounding

runs on the CPU, without a card: why the kernels keep the plain
version's arithmetic bit for bit. At the Jasper train shape it runs the
plain ``ctc_nll_grad`` twice, once as it is and once with the log term of
every logaddexp moved by one ulp on a seeded half of the elements (what
another rounding of the logaddexp, a fast exp or log say, does), and
prints the largest relative change of the NLL and the largest absolute
change of d log-probs, against the card checks' tolerances (1e-5 both).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts_torch"))
from bench_conv import split_ms  # noqa: E402
from bench_relpos import _chip_smoke  # noqa: E402

# name, B, T, L, V
SHAPES = (("jasper", 32, 500, 160, 29), ("conformer-m", 64, 250, 160, 29))
LIBS = ("ctc_alpha_fwd", "ctc_beta_bwd")


def kernel_resources(build, cc) -> dict:
    """ptxas's registers and spills of every kernel of the two libraries,
    and ``ctc_resources`` at L 160 and 600, V 29, where the checkout has
    it."""
    out = {}
    for lib in LIBS:
        log = build.library_path(lib).with_suffix(".log").read_text()
        out[lib] = [{"entry": entry, "registers": int(regs),
                     "spill_bytes": int(stores) + int(loads)}
                    for entry, stores, loads, regs in re.findall(
                        r"Compiling entry function '(\S+)'.*?(\d+) bytes "
                        r"spill stores, (\d+) bytes spill loads.*?Used "
                        r"(\d+) registers", log, re.S)]
    if hasattr(cc, "ctc_resources"):
        for L in (160, 600):
            out["L{}".format(L)] = cc.ctc_resources(L, 29)
    return out


def time_shape(cs, cc, ctc, B, T, L, V) -> dict:
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    logits, lens, labels, label_lens = cs.ctc_case(B, T, L, V, T + 1, dev)
    lp = ctc.log_probs(logits).contiguous()
    args = (lp, lens, labels, label_lens, V - 1)
    nll, lattice = cc.alpha_fwd(*args, True)

    def fwd_bwd():
        n, lat = cc.alpha_fwd(*args, True)
        cc.beta_bwd(*args, n, lat)

    lib_lp = lp.transpose(0, 1).detach()
    lib_grad = lib_lp.clone().requires_grad_()

    def lib_fwd():
        F.ctc_loss(lib_lp, labels, lens, label_lens, blank=V - 1,
                   reduction="none", zero_infinity=True)

    def lib_fwd_bwd():
        F.ctc_loss(lib_grad, labels, lens, label_lens, blank=V - 1,
                   reduction="sum", zero_infinity=True).backward()

    out = {
        "fwd_eval_ms": cs.cuda_ms(lambda: cc.alpha_fwd(*args, False), 50),
        "fwd_lattice_ms": cs.cuda_ms(lambda: cc.alpha_fwd(*args, True), 50),
        "bwd_ms": cs.cuda_ms(lambda: cc.beta_bwd(*args, nll, lattice), 50),
        "fwd_bwd_ms": cs.cuda_ms(fwd_bwd, 50),
        "bwd_split": split_ms(lambda: cc.beta_bwd(*args, nll, lattice)),
        "library_fwd_ms": cs.cuda_ms(lib_fwd, 50),
        "library_fwd_bwd_ms": cs.cuda_ms(lib_fwd_bwd, 50),
        "fwd_bound_ms": cs.ctc_bound_ms(B, T, L, V, T + 1, False)[0],
        "fwd_bwd_bound_ms": cs.ctc_bound_ms(B, T, L, V, T + 1, True)[0],
        "floor_us_per_frame": None}
    if hasattr(cc, "alpha_floor"):
        frames = int(lens.max()) - 1
        out["floor_us_per_frame"] = 1e3 * cs.cuda_ms(
            lambda: cc.alpha_floor(*args), 50) / frames
        out["fwd_eval_us_per_frame"] = 1e3 * out["fwd_eval_ms"] / frames
    return out


def run_one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from openseq2seq_tpu_torch.kernels import build
    from openseq2seq_tpu_torch.ops import ctc
    from openseq2seq_tpu_torch.ops import ctc_cuda as cc
    cs = _chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for lib in LIBS:
        build.load(lib)
    result = {"root": os.path.abspath(root), "card": card,
              "kernels": kernel_resources(build, cc)}
    for name, B, T, L, V in SHAPES:
        result[name] = time_shape(cs, cc, ctc, B, T, L, V)
    torch.cuda.synchronize()
    return result


def rounding() -> dict:
    """The plain backward at the Jasper train shape on the CPU, against
    itself with each logaddexp's log term moved by one ulp on a seeded
    half of the elements."""
    import torch
    sys.path.insert(0, REPO)
    from openseq2seq_tpu_torch.ops import ctc
    cs = _chip_smoke()
    logits, lens, labels, label_lens = cs.ctc_case(32, 500, 160, 29, 501,
                                                   torch.device("cpu"))
    args = (ctc.log_probs(logits), lens, labels, label_lens, 28)
    nll, dlp = ctc.ctc_nll_grad(*args)
    exact = ctc._logaddexp
    gen = torch.Generator().manual_seed(0)

    def moved(a, b):
        mx = torch.clamp(torch.maximum(a, b), min=ctc.NEG)
        term = torch.log1p(torch.exp(torch.minimum(a, b) - mx))
        up = torch.rand(term.shape, generator=gen) < 0.5
        return mx + torch.where(up, torch.nextafter(
            term, torch.full_like(term, 10.0)), term)

    ctc._logaddexp = moved
    try:
        nll2, dlp2 = ctc.ctc_nll_grad(*args)
    finally:
        ctc._logaddexp = exact
    feasible = ctc.feasible_rows(lens, labels, label_lens)
    return {"shape": [32, 500, 160, 29],
            "nll_max_rel_change": float(((nll2 - nll).abs() / nll.abs())[
                feasible].max()),
            "dlp_max_abs_change": float((dlp2 - dlp).abs().max()),
            "tolerances": {"nll_rel": 1e-5, "dlp_abs": 1e-5}}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--compare", default=None)
    parser.add_argument("--rounding", action="store_true")
    opts = parser.parse_args()
    if opts.rounding:
        print(json.dumps(rounding()), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_ctc: no CUDA device")
    if opts.compare is None:
        result = run_one(opts.root)
        print(result["card"], flush=True)
        for lib, recs in result["kernels"].items():
            print("[resources] {}: {}".format(lib, recs), flush=True)
        for name, *_ in SHAPES:
            r = result[name]
            print("[{}] fwd eval {:.4f} ms, fwd with lattice {:.4f} ms, bwd "
                  "{:.4f} ms, fwd+bwd {:.4f} ms (bounds {:.5f}, {:.5f}); "
                  "F.ctc_loss fwd {:.4f} ms, fwd+bwd {:.4f} ms; floor {} us "
                  "a frame; bwd by kernel: {}".format(
                      name, r["fwd_eval_ms"], r["fwd_lattice_ms"],
                      r["bwd_ms"], r["fwd_bwd_ms"], r["fwd_bound_ms"],
                      r["fwd_bwd_bound_ms"], r["library_fwd_ms"],
                      r["library_fwd_bwd_ms"], r["floor_us_per_frame"],
                      "; ".join("{} {:.4f} ms x {:g}".format(
                          k, v["ms"], v["launches"])
                          for k, v in r["bwd_split"].items())), flush=True)
        print(json.dumps(result), flush=True)
        return
    lines = []
    for root in (opts.compare, REPO, REPO, opts.compare):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--root", root], capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit("bench_ctc: {} failed:\n{}".format(
                root, proc.stdout[-4000:]))
        print(proc.stdout, end="", flush=True)
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"runs": lines}), flush=True)


if __name__ == "__main__":
    main()
