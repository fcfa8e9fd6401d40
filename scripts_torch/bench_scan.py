#!/usr/bin/env python3
"""Time the bf16 GRU and LSTM scan kernels (B4, B3: forward and backward)
of one checkout on one NVIDIA GPU, or compare two checkouts on the same
card in turns.

    python3 scripts_torch/bench_scan.py [--root DIR]
    python3 scripts_torch/bench_scan.py --compare PARENT_DIR
    python3 scripts_torch/bench_scan.py --carry-seeds 3

With ``--root`` (default: this checkout) the package is imported from DIR
and its kernels are built there. It prints the card's name and power
limit, then for each bf16 scan kernel at the main paths' widths (the
GRU's 8 units a CTA at H = 1024, the LSTM's 4 at H = 512 and 8 at
H = 1024) ``ptxas``'s
registers and spills, its dynamic shared memory and the CTAs an SM holds
(from the kernels' C entries, where the checkout has them), and the
device milliseconds, by ``chip_smoke.py``'s back-to-back method, of: the
forward without and with its residuals and the backward, and the plain
versions' forward and backward,
at the main shapes (DS2-medium's GRU, B 32, T 500, H 1024; lstm_small's
LSTM, B 32, T 500, H 512; the LSTM language model's, B 224, T 96,
H 1024, seven tiles of 32 rows a step; every row at full length, as the
synthetic batches have them), each with its time a step; the per-step
floors, forward and backward, at B 8, T 500, H 128 (one unit a CTA: the
step's latency with next to no product); and cuDNN's ``torch.nn.GRU`` /
``torch.nn.LSTM`` (one layer) with the layer's input width (2H for the
bidirectional speech layers, H for the LM's), forward (with its input
GEMM timed beside it, and the forward less it: the recurrence alone) and
forward plus backward (timed only, the yardstick). The last line is a
JSON object of all of it.

With ``--carry-seeds N`` it times nothing: it prints, for N seeds, the
bf16 LSTM backward's bound readings and planted-fault readings at the
language model's shape (B 224, T 96, H 1024, ``chip_smoke.py`` 4f's
lengths: T, 1, T / 2 and uniform), forward and reverse, the bound at
the kernel's summation depth (``scan_bounds.sum_depth``); the first
seed is 4f's own. It fails unless every bound reading is at most 1 and
every fault ("bf16 carry" among them) reads above 1.

``--compare`` runs PARENT_DIR, this checkout, this checkout, PARENT_DIR,
one process each, so that both designs are timed on one card in one
call, and prints each process's JSON line, then one with the runs. It
needs a CUDA device.
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
from bench_relpos import _chip_smoke  # noqa: E402

# name: (cell, G, B, T, H, the layer's input width) at the main paths'
# shapes: DS2-medium's GRU, lstm_small's LSTM, the LSTM language model's
MAIN = {"gru": ("gru", 3, 32, 500, 1024, 2048),
        "lstm": ("lstm", 4, 32, 500, 512, 1024),
        "lstm-lm": ("lstm", 4, 224, 96, 1024, 1024)}
FLOOR = (8, 500, 128)


def kernel_resources(build):
    """ptxas's registers and spills of the bf16 scan kernels at the main
    widths, and their shared memory and CTAs an SM from the kernels' own
    C entries (``ops.rnn_scan.resources``; null in a checkout without
    them)."""
    from openseq2seq_tpu_torch.ops import rnn_scan
    out = {}
    for name, (cell, G, _, _, H, _) in MAIN.items():
        U = H // 128
        for way in ("fwd", "bwd"):
            lib = "{}_scan_{}".format(cell, way)
            log = build.library_path(lib).with_suffix(".log").read_text()
            entries = re.findall(r"Compiling entry function '(\S+)'.*?"
                                 r"(\d+) bytes spill stores, (\d+) bytes "
                                 r"spill loads.*?Used (\d+) registers", log,
                                 re.S)
            names = ("scan_{}_mma_kernelILi{}ELi{}E".format(way, G, U),
                     "scan_{}_kernelI13__nv_bfloat16Li{}ELi{}E".format(
                         way, G, U))
            smem, ctas = rnn_scan.resources(lib, H)[:2] if hasattr(
                rnn_scan, "resources") else (None, None)
            for entry, stores, loads, regs in entries:
                if any(n in entry for n in names):
                    out["{}_{}".format(name, way)] = {
                        "entry": entry, "registers": int(regs),
                        "spill_bytes": int(stores) + int(loads),
                        "smem": smem, "ctas_per_sm": ctas}
    return out


def run_one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from openseq2seq_tpu_torch.kernels import build
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for lib in ("gru_scan_fwd", "lstm_scan_fwd", "gru_scan_bwd",
                "lstm_scan_bwd"):
        build.load(lib)
    result = {"root": os.path.abspath(root), "card": card,
              "kernels": kernel_resources(build)}
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def with_cotangents(case, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        B, T, _ = case["x_proj"].shape
        H = case["h0"].shape[1]
        return dict(case, dys=torch.randn((B, T, H), generator=g, device=dev),
                    dh=torch.randn((B, H), generator=g, device=dev),
                    dc=torch.randn((B, H), generator=g, device=dev))

    for name, (cell, G, B, T, H, width) in MAIN.items():
        full = with_cotangents(cs.scan_case(cell, B, T, H, 70, dev,
                                            full=True), 80)
        floor = with_cotangents(cs.scan_case(cell, *FLOOR, 90, dev,
                                             full=True), 91)
        mod = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(
            width, H, batch_first=True).to(dev, bf)
        mod.flatten_parameters()
        x = torch.randn((B, T, width), device=dev, dtype=bf,
                        requires_grad=True)
        dy = full["dys"].to(bf)

        def cudnn_fwd_bwd():
            mod(x)[0].backward(dy)
        w_ih = mod.weight_ih_l0
        with torch.no_grad():
            fwd_ms = cs.cuda_ms(lambda: cs.scan_call(cell, full, bf, False,
                                                     False), 10)
            cudnn_fwd_ms = cs.cuda_ms(lambda: mod(x), 10)
            cudnn_gemm_ms = cs.cuda_ms(lambda: x.view(-1, width) @ w_ih.t(),
                                       20)
            floor_fwd_ms = cs.cuda_ms(lambda: cs.scan_call(
                cell, floor, bf, False, False), 10)
        t = {"fwd_ms": fwd_ms,
             "fwd_residuals_ms": cs.cuda_ms(lambda: cs.scan_call(
                 cell, full, bf, False, True), 10),
             "bwd_ms": cs.cuda_ms(cs.scan_bwd_fn(cell, full, bf, False), 10),
             "plain_fwd_ms": cs.cuda_ms(lambda: cs.scan_call(
                 cell, full, bf, False, False, plain=True), 2),
             "plain_bwd_ms": cs.cuda_ms(cs.scan_bwd_fn(cell, full, bf, False,
                                                       plain=True), 2),
             "cudnn_fwd_ms": cudnn_fwd_ms,
             "cudnn_gemm_ms": cudnn_gemm_ms,
             "cudnn_fwd_less_gemm_ms": cudnn_fwd_ms - cudnn_gemm_ms,
             "cudnn_fwd_bwd_ms": cs.cuda_ms(cudnn_fwd_bwd, 5),
             "floor_fwd_us_per_step": 1e3 * floor_fwd_ms / FLOOR[1],
             "floor_bwd_us_per_step": 1e3 * cs.cuda_ms(
                 cs.scan_bwd_fn(cell, floor, bf, False), 10) / FLOOR[1],
             "fwd_bound_ms": cs.scan_bound_ms(cell, full)[0],
             "bwd_bound_ms": cs.scan_bwd_bound_ms(cell, full)[0]}
        t["fwd_us_per_step"] = 1e3 * t["fwd_ms"] / T
        t["bwd_us_per_step"] = 1e3 * t["bwd_ms"] / T
        t["tiles_per_step"] = -(-B // cs.SCAN_TILE_ROWS)
        result[name] = t
    return result


def carry_readings(seeds: int) -> dict:
    """The LM-shape bf16 LSTM backward's readings at ``seeds`` seeds,
    forward and reverse, by ``chip_smoke.py``'s ``scan_bwd_readings``."""
    sys.path.insert(0, REPO)
    import torch
    cs = _chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    bf = torch.bfloat16
    cell, _, B, T, H, _ = MAIN["lstm-lm"]
    runs = []
    for k in range(seeds):
        # 4f's own seeds first (its third case: 52, cotangents 62)
        seed = 52 + 100 * k
        case = cs.scan_case(cell, B, T, H, seed, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 10)
        case.update(dys=torch.randn((B, T, H), generator=g, device=dev),
                    dh=torch.randn((B, H), generator=g, device=dev),
                    dc=torch.randn((B, H), generator=g, device=dev))
        for reverse in (False, True):
            got = cs.scan_bwd_fn(cell, case, bf, reverse)()
            readings, faults = cs.scan_bwd_readings(cell, case, bf, reverse,
                                                    got)
            cs.print_readings("carry seed {} {} ({})".format(
                seed, "reverse" if reverse else "forward", card), readings,
                faults)
            runs.append({"seed": seed, "reverse": reverse,
                         "readings": readings, "faults": faults})
    return {"card": card, "runs": runs}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--compare", default=None)
    parser.add_argument("--carry-seeds", type=int, default=0)
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_scan: no CUDA device")
    if opts.carry_seeds:
        print(json.dumps(carry_readings(opts.carry_seeds)), flush=True)
        return
    if opts.compare is None:
        result = run_one(opts.root)
        print(result["card"], flush=True)
        for kind, rec in result["kernels"].items():
            print("[resources] {}: {}".format(kind, rec), flush=True)
        for name in MAIN:
            print("[{}] {}".format(name, result[name]), flush=True)
        print(json.dumps(result), flush=True)
        return
    lines = []
    for root in (opts.compare, REPO, REPO, opts.compare):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--root", root], capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit("bench_scan: {} failed:\n{}".format(
                root, proc.stdout[-4000:]))
        print(proc.stdout, end="", flush=True)
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"runs": lines}), flush=True)


if __name__ == "__main__":
    main()
