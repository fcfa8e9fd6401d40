#!/usr/bin/env python3
"""Serving throughput on one NVIDIA GPU, bf16 against int8 activations:
the port's twin of ``scripts/bench_serving.py``.

    python3 scripts_torch/bench_serving.py

Workload: transformer-base teacher-forced scoring
(``example_configs_torch/text2text/transformer_base_serving_synthetic.py``:
the JAX bench's keys, d_model 512, 6 + 6 layers, B 64, T 64, V 32768,
"mixed", with the flash attention kernel), served with ``train=True`` and
every dropout rate 0, which gives the logits without the beam decode. The
int8 path calibrates every dense layer's input range on 2 sentences of the
batch, as the JAX bench does, and runs them as int8 x int8 -> int32
products (``openseq2seq_tpu_torch/serving/int8_exec.py``). Each rate is
tokens (B x 2 x T a batch) over the host's clock around 30 synchronised
batches after 2 warm ones: for the live model in this process, and for
the fp and int8-activation artifacts exported with ``torch.export`` and
reloaded in a fresh interpreter that imports only
``openseq2seq_tpu_torch.serving``, as a server would load them.

Prints ONE JSON line with the JAX bench's keys (``value``, ``int8_value``,
``int8_speedup``, ``int8_argmax_agreement``, ``calibrated_layers``, ...)
and the artifacts' rates, the card's name and its power limit. Sweep:
BENCH_SERVE_BS / BENCH_SERVE_SEQ / BENCH_SERVE_DMODEL /
BENCH_SERVE_LAYERS, as the JAX bench.

    python3 scripts_torch/bench_serving.py --jasper-beam-export

exports Jasper-10x5's eval forward (``jasper10x5_synthetic.py`` as it is:
B 32, 1,000 input frames) with the on-device prefix beam of width 4,
which the export unrolls over the encoder's 500 output frames, reloads
it, checks its ids and lengths against eager and prints the export's and
the load's seconds. Both need a CUDA device.

``chip_smoke.py``'s serving group measures with this file's helpers
(:func:`calibration_batch`, :func:`rate`, :func:`export_artifacts`,
:func:`serve_fresh`) and adds its own checks.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "example_configs_torch", "text2text",
                      "transformer_base_serving_synthetic.py")
JASPER = os.path.join(REPO, "example_configs_torch", "speech2text",
                      "jasper10x5_synthetic.py")
STEPS = 30
ARTIFACTS = ("fp", "int8w", "int8act")

# what the fresh interpreter of serve_fresh runs: each artifact loaded
# with openseq2seq_tpu_torch.serving alone, its B7 launches and its
# _int_mm nodes, its rate over `steps` batches, its logits saved
SERVE_ONLY = r"""
import json, sys, time
import numpy as np
import torch
from openseq2seq_tpu_torch import serving
from openseq2seq_tpu_torch.ops import flash_attention as fa
out_dir, steps = sys.argv[1], int(sys.argv[2])
z = np.load(out_dir + "/batch.npz")
batch = serving.export.serving_batch(
    {"source_tensors": [z["s0"], z["s1"]],
     "target_tensors": [z["t0"], z["t1"]], "source_ids": z["ids"]}, "cuda")
tokens = 2 * z["s0"].size
result = {}
for name in sys.argv[3:]:
    serve = serving.load_exported(out_dir + "/" + name + ".pt2")
    int_mm = sum(n.target is torch.ops.aten._int_mm.default
                 for m in serve.program.modules()
                 if isinstance(m, torch.fx.GraphModule)
                 for n in m.graph.nodes)
    for _ in range(2):
        serve(batch)
    torch.cuda.synchronize()
    before = fa.LAUNCHES
    logits = serve(batch)["decoder_output"]["logits"]
    torch.cuda.synchronize()
    launches = fa.LAUNCHES - before
    np.save(out_dir + "/" + name + ".npy", logits.float().cpu().numpy())
    t0 = time.perf_counter()
    for _ in range(steps):
        serve(batch)
    torch.cuda.synchronize()
    result[name] = {"launches": launches, "int_mm_nodes": int_mm,
                    "tokens_per_s": steps * tokens /
                    (time.perf_counter() - t0)}
result["launches"] = fa.LAUNCHES
result["model_modules"] = sorted(m for m in sys.modules if m.startswith(
    ("openseq2seq_tpu_torch.models", "openseq2seq_tpu_torch.encoders",
     "openseq2seq_tpu_torch.decoders")))
print(json.dumps(result))
"""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _params():
    """The config's params with the JAX bench's environment overrides."""
    config = runpy.run_path(CONFIG)
    params = copy.deepcopy(config["base_params"])
    bs = os.environ.get("BENCH_SERVE_BS")
    if bs:
        params["batch_size_per_gpu"] = int(bs)
    seq = os.environ.get("BENCH_SERVE_SEQ")
    if seq:
        params["data_layer_params"].update(src_length=int(seq),
                                           tgt_length=int(seq))
    d = os.environ.get("BENCH_SERVE_DMODEL")
    layers = os.environ.get("BENCH_SERVE_LAYERS")
    for side, key in (("encoder_params", "encoder_layers"),
                      ("decoder_params", "num_hidden_layers")):
        if d:
            params[side].update(hidden_size=int(d), num_heads=int(d) // 64,
                                filter_size=4 * int(d))
        if layers:
            params[side][key] = int(layers)
    return config["base_model"], params


def calibration_batch(batch, n: int = 2):
    """The first ``n`` sentences of ``batch``: the JAX bench calibrates
    the int8 ranges on 2."""
    return {k: ([a[:n] for a in v] if isinstance(v, list) else
                v[:n] if getattr(v, "ndim", 0) else v)
            for k, v in batch.items()}


def rate(fn, batch, tokens, steps: int = STEPS) -> float:
    """tokens/s of ``fn(batch)`` over ``steps`` calls after two warm
    ones, on the host's clock around synchronised work."""
    import torch
    for _ in range(2):
        fn(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(batch)
    torch.cuda.synchronize()
    return steps * tokens / (time.perf_counter() - t0)


def export_artifacts(model, state, batch, ranges, out_dir):
    """The scoring forward (``train=True``) exported into ``out_dir`` as
    ``fp.pt2``, ``int8w.pt2`` (int8 weights) and ``int8act.pt2`` (int8
    weights and, on ``ranges``, int8 activations), with ``batch.npz`` for
    :func:`serve_fresh`. Returns ({name: export seconds}, {name: bytes},
    the weight quantization's report)."""
    import numpy as np
    from openseq2seq_tpu_torch import serving
    seconds = {}
    for name in ARTIFACTS:
        path = os.path.join(out_dir, name + ".pt2")
        t0 = time.time()
        if name == "fp":
            serving.export_inference_fn(model, state, batch, path=path,
                                        train=True)
        else:
            _, report = serving.export_inference_fn_int8(
                model, state, batch, path=path, train=True,
                act_ranges=ranges if name == "int8act" else None)
        seconds[name] = time.time() - t0
    sizes = {n: os.path.getsize(os.path.join(out_dir, n + ".pt2"))
             for n in ARTIFACTS}
    np.savez(os.path.join(out_dir, "batch.npz"),
             s0=batch["source_tensors"][0], s1=batch["source_tensors"][1],
             t0=batch["target_tensors"][0], t1=batch["target_tensors"][1],
             ids=batch["source_ids"])
    return seconds, sizes, report


def serve_fresh(out_dir, steps: int = STEPS, names=ARTIFACTS):
    """Each artifact of ``out_dir`` loaded and served in one fresh
    interpreter (``SERVE_ONLY``). Returns its JSON: per artifact the B7
    launches of one batch, the ``_int_mm`` nodes of the program and the
    tokens/s over ``steps`` batches; the interpreter's B7 launches in all
    and the model modules it imported. Each artifact's logits are left in
    ``out_dir`` as ``<name>.npy``."""
    proc = subprocess.run([sys.executable, "-c", SERVE_ONLY, out_dir,
                           str(steps)] + list(names), cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError("the fresh interpreter failed:\n" +
                           proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def bench_scoring() -> dict:
    import numpy as np
    import torch
    from openseq2seq_tpu_torch import serving
    base_model, params = _params()
    model = base_model(params, mode="eval", device="cuda")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    bs, seq = batch["source_tensors"][0].shape
    tokens = bs * 2 * seq
    ranges = serving.calibrate_dense_inputs(
        model, state, [calibration_batch(batch)], train=True)

    def fp_serve(b):
        with torch.no_grad():
            return state.module(b, train=True)["decoder_output"]["logits"]

    int8_live = serving.int8_apply_fn(model, state, ranges, train=True)

    def int8_serve(b):
        return int8_live(b)["decoder_output"]["logits"]

    # the batch on the card once, for every path alike
    device_batch = serving.export.serving_batch(batch, "cuda")
    fp_tps = rate(fp_serve, device_batch, tokens)
    i8_tps = rate(int8_serve, device_batch, tokens)
    l_fp = fp_serve(device_batch).float().cpu().numpy()
    l_i8 = int8_serve(device_batch).float().cpu().numpy()
    agree = float(np.mean(l_fp.argmax(-1) == l_i8.argmax(-1)))
    with tempfile.TemporaryDirectory() as tmp:
        export_artifacts(model, state, batch, ranges, tmp)
        fresh = serve_fresh(tmp, names=("fp", "int8act"))
    art_tps = fresh["fp"]["tokens_per_s"]
    art_i8_tps = fresh["int8act"]["tokens_per_s"]
    return {
        "metric": "transformer_scoring_serve_tokens_per_sec_per_chip",
        "batch_per_chip": int(bs), "seq_len": int(seq),
        "d_model": params["encoder_params"]["hidden_size"],
        "value": round(fp_tps, 1), "int8_value": round(i8_tps, 1),
        "int8_speedup": round(i8_tps / fp_tps, 3),
        "int8_argmax_agreement": round(agree, 4),
        "calibrated_layers": len(ranges),
        "artifact_value": round(art_tps, 1),
        "artifact_int8_value": round(art_i8_tps, 1),
        "artifact_int8_speedup": round(art_i8_tps / art_tps, 3),
        "unit": "tokens/s/chip"}


def bench_jasper_beam_export() -> dict:
    import torch
    from openseq2seq_tpu_torch import serving
    config = runpy.run_path(JASPER)
    params = copy.deepcopy(config["base_params"])
    params["decoder_params"]["on_device_beam_width"] = 4
    model = config["base_model"](params, mode="eval", device="cuda")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    with torch.no_grad():
        eager = state.module(serving.export.serving_batch(batch, "cuda"),
                             train=False)["decoder_output"]
    t0 = time.time()
    blob = serving.export_inference_fn(model, state, batch)
    seconds = time.time() - t0
    shape = eager["logits"].shape
    print("exported in {:.1f} s at B {} x T' {}".format(seconds, shape[0],
                                                        shape[1]),
          flush=True)
    t0 = time.time()
    serve = serving.load_exported(blob)
    load_seconds = time.time() - t0
    out = serve(batch)["decoder_output"]
    same = all(torch.equal(a, b) for a, b in zip(out["outputs"][:2],
                                                 eager["outputs"][:2]))
    return {"metric": "jasper10x5_beam4_export_seconds",
            "value": round(seconds, 1), "load_seconds": round(load_seconds, 1),
            "frames": int(shape[1]), "batch": int(shape[0]),
            "artifact_bytes": len(blob), "ids_and_lengths_equal": same,
            "unit": "s"}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--jasper-beam-export", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_serving: no CUDA device; this bench runs on "
                         "a GPU only")
    sys.path.insert(0, REPO)
    result = bench_jasper_beam_export() if args.jasper_beam_export \
        else bench_scoring()
    result["card"] = card()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
