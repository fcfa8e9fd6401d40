#!/usr/bin/env python3
"""Time the bf16 rel-pos flash attention kernels (B5: forward, dq, dkv) and
the flash attention forward (B7) of one checkout on one NVIDIA GPU, or
compare two checkouts on the same card in turns.

    python3 scripts_torch/bench_relpos.py [--root DIR]
    python3 scripts_torch/bench_relpos.py --compare PARENT_DIR

With ``--root`` (default: this checkout) the package is imported from DIR
and its kernels are built there. It prints the card's name and power
limit, then for each kernel ``ptxas``'s registers and spills of the bf16
instantiations at Dh = 64, their dynamic shared memory at Conformer-M's
and Conformer-L's widths (D 256 and 512) and the CTAs an SM holds
(computed from registers, threads and shared memory; where the checkout
has it, also ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and the
device milliseconds, by ``chip_smoke.py``'s back-to-back method, of:
B5's forward, its dq and dkv kernels alone and the whole backward at
Conformer-M (B 64, H 4, T 250, Dh 64, D 256; once with the lengths
``chip_smoke.py`` draws, once with every row at full length, as the
Conformer-M configs' synthetic batches have them), SDPA forward and
forward plus backward on the materialised q~, k~ (timed only, the
yardstick), and B7's forward at the
transformer-big shapes of ``chip_smoke.py``'s FLASH_CASES and at Tk =
1000. The last line is a JSON object of all of it.

``--compare`` runs PARENT_DIR, this checkout, this checkout, PARENT_DIR,
one process each, so that both designs are timed on one card in one
call, and prints each process's JSON line. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an SM's registers, shared memory (with 1 KB reserved a CTA), threads
SM_REGS, SM_SMEM, SM_THREADS, SM_CTAS = 65536, 233472, 2048, 32


def _chip_smoke():
    """This checkout's chip_smoke.py, for its cases and its timer."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bench", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ctas_from_resources(regs: int, threads: int, smem: int) -> int:
    """CTAs an H100 SM holds for a kernel of ``regs`` registers a thread
    (allocated 256 a warp at a time), ``threads`` threads and ``smem``
    bytes of dynamic shared memory."""
    warp_regs = -(-regs * 32 // 256) * 256
    by_regs = SM_REGS // (warp_regs * (threads // 32))
    return min(by_regs, SM_SMEM // (smem + 1024), SM_THREADS // threads,
               SM_CTAS)


def kernel_resources(build, fr):
    """ptxas's registers and spills of each bf16 B5 kernel at Dh = 64,
    its shared memory at D 256 and 512, and its CTAs an SM."""
    out = {}
    for lib, kinds in (("flash_relpos_fwd", (("fwd", 128),)),
                       ("flash_relpos_bwd", (("dq", 256), ("dkv", 128)))):
        # the threads of each kernel: 128 (forward, dkv) or 256 (dq; 192
        # for the dq instantiation of at most five chunks where the
        # checkout has ``dq_row_groups``)
        log = build.library_path(lib).with_suffix(".log").read_text()
        src = (build.CSRC_DIR / (lib + ".cu")).read_text()
        entries = re.findall(r"Compiling entry function '(\S+)'.*?"
                             r"(\d+) bytes spill stores, (\d+) bytes spill "
                             r"loads.*?Used (\d+) registers", log, re.S)
        for kind, threads in kinds:
            name = "flash_relpos_{}_mma_kernelILi64E".format(
                "fwd" if kind == "fwd" else "bwd_" + kind)
            smem_fn = fr._kernel("{}_smem".format(
                "flash_relpos_fwd" if kind == "fwd"
                else "flash_relpos_bwd_" + kind))
            for entry, stores, loads, regs in entries:
                if name not in entry:
                    continue
                nt = 192 if kind == "dq" and "ELi5EE" in entry and \
                    "dq_row_groups" in src else threads
                rec = {"entry": entry, "registers": int(regs),
                       "spill_bytes": int(stores) + int(loads),
                       "threads": nt}
                for D in (256, 512):
                    smem = int(smem_fn(64, D, 1))
                    rec["smem_D{}".format(D)] = smem
                    rec["ctas_D{}".format(D)] = ctas_from_resources(
                        int(regs), nt, smem)
                out.setdefault(kind, []).append(rec)
            if hasattr(fr, "ctas_per_sm"):
                for D in (256, 512):
                    out[kind + "_occupancy_D{}".format(D)] = \
                        fr.ctas_per_sm(kind, 64, D)
    return out


def relpos_times(cs, fr, inputs, lens, scale) -> dict:
    """Device ms of B5's bf16 kernels and of SDPA on the materialised q~,
    k~ at one set of lengths, with the bounds of this data's work."""
    import torch
    import torch.nn.functional as F
    qu, qp, k, kp, v = (x.bfloat16() for x in inputs)
    B, T, H, Dh = k.shape
    D = kp.shape[-1]
    dev = k.device
    args = (qu, qp, k, kp, v, lens)
    o, lse = fr.relpos_attention_cuda(*args, scale, return_lse=True)
    do = torch.randn(o.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0)
                     ).bfloat16()
    bwd = args + (o, lse, do, scale)
    q_aug = torch.cat([qu.transpose(1, 2), qp], dim=-1)
    k_aug = torch.cat([k.transpose(1, 2), kp.expand(B, H, T, D)], dim=-1)
    v_t = v.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] <
            lens.clamp(min=1)[:, None])[:, None, None, :]
    leaves = [x.detach().requires_grad_() for x in (q_aug, k_aug, v_t)]
    do_t = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                       scale=scale).backward(do_t)
    return {
        "fwd_ms": cs.cuda_ms(lambda: fr.relpos_attention_cuda(*args, scale),
                             50),
        "dq_ms": cs._relpos_bwd_kernel_ms("dq", *bwd, 20),
        "dkv_ms": cs._relpos_bwd_kernel_ms("dkv", *bwd, 20),
        "bwd_ms": cs.cuda_ms(lambda: fr.relpos_attention_bwd_cuda(*bwd), 20),
        "sdpa_fwd_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            q_aug, k_aug, v_t, attn_mask=mask, scale=scale), 50),
        "sdpa_fwd_bwd_ms": cs.cuda_ms(sdpa_fwd_bwd, 20),
        "fwd_bound_ms": cs.relpos_bound_ms(qu, qp, kp, lens)[0],
        "dq_bound_ms": cs.relpos_bwd_bound_ms(qu, qp, kp, lens, "dq")[0],
        "dkv_bound_ms": cs.relpos_bwd_bound_ms(qu, qp, kp, lens, "dkv")[0],
        "bwd_bound_ms": cs.relpos_bwd_bound_ms(qu, qp, kp, lens, "all")[0]}


def run_one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from openseq2seq_tpu_torch.kernels import build
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for lib in ("flash_relpos_fwd", "flash_relpos_bwd", "flash_attn_fwd"):
        build.load(lib)
    result = {"root": os.path.abspath(root), "card": card,
              "kernels": kernel_resources(build, fr)}
    dev = torch.device("cuda")
    name, B, H, T, Dh, D = cs.RELPOS_CASES[0]
    case = cs.relpos_case(B, H, T, Dh, D, 40, dev)
    result["relpos"] = {
        "drawn": relpos_times(cs, fr, case[:5], case[5], Dh ** -0.5),
        "full": relpos_times(cs, fr, case[:5], torch.full_like(case[5], T),
                             Dh ** -0.5)}
    flash = {}
    cases = [c for c in cs.FLASH_CASES if c[0] in
             ("encoder", "decoder causal", "cross", "Tk=1000")]
    for i, (cname, B, Tq, Tk, H, Dd, causal, padded) in enumerate(cases):
        q, kk, vv, valid = cs.flash_case(B, Tq, Tk, H, Dd, padded, i, dev)
        qb, kb, vb = (x.bfloat16() for x in (q, kk, vv))
        flash[cname] = cs.cuda_ms(
            lambda: fa.flash_attention_cuda(qb, kb, vb, valid, causal), 50)
    result["flash_fwd_ms"] = flash
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--compare", default=None)
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_relpos: no CUDA device")
    if opts.compare is None:
        result = run_one(opts.root)
        print(result["card"], flush=True)
        for kind, recs in result["kernels"].items():
            print("[resources] {}: {}".format(kind, recs), flush=True)
        print("[relpos] {}".format(result["relpos"]), flush=True)
        print("[flash fwd] {}".format(result["flash_fwd_ms"]), flush=True)
        print(json.dumps(result), flush=True)
        return
    lines = []
    for root in (opts.compare, REPO, REPO, opts.compare):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--root", root], capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit("bench_relpos: {} failed:\n{}".format(
                root, proc.stdout[-4000:]))
        print(proc.stdout, end="", flush=True)
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"runs": lines}), flush=True)


if __name__ == "__main__":
    main()
