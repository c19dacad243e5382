"""Greedy tokens of the main paths of two checkouts, compared on one card.

    python3 scripts/ab_tokens.py parent=/path/to/parent change=. \\
        [--out build/ab_tokens]

Each checkout runs in a fresh process that imports its own ``repro_torch``
(so each builds its own kernels) and generates, with seed 0, 8 requests x
32 new tokens on 4 slots (max_seq 256), on nine paths (``--paths`` picks
some, by name):
  * full-width llama2-7b GQSA W4 S50 G16 through the serve CLI in bf16
    compute, as ``chip_smoke.py`` drives it: plain decode (``--compress
    gqsa``), tree speculation (``--spec-tree 4,2,2 --draft-profile
    w4l25``) and adaptive tree speculation (``--spec-tree 4,2,2
    --spec-adaptive --draft-profile w4s75``);
  * the same model through the engine in f32 compute, as ``chip_smoke.py``'s
    speculation check drives it: plain decode, tree speculation (4,2,2)
    with draft w4l25 (its 8 layers through ``w4_matmul``), and plain
    decode on the int8 KV pool;
  * the dense-W4 G16 baseline of the same model through the engine in f32
    compute (every projection through ``w4_matmul``);
  * DeepSeek-V2 at full width and ``chip_smoke.DS_LAYERS`` layers, GQSA W4
    S50 G16, through the engine in f32 compute (the latent mode and the
    GQSA expert axis);
  * deepseek-moe-16b at full width and depth, GQSA W4 S50 G16, through the
    engine in f32 compute (the GQSA expert axis on the K/V pool's model).
It writes each request's tokens to ``<out>/<name>.json``. Then the last
named checkout, for every request whose tokens differ from the first's,
finds the first differing token and measures the top-2 logit margin there
on its own kernel path, teacher-forced on the common prefix
(``chip_smoke.greedy_margin``, in the path's compute dtype). An f32 path is
held to ``chip_smoke.SPEC_MARGIN_REL`` x max |logit|. A bf16 path's logits
are rounded to bf16 (steps of 1/32 at |logit| 4-8), so it is held to the
bf16 logits bar ``chip_smoke.LOGITS_TOL_BF16`` x max |logit| and its
margin is also printed in bf16 steps. Prints one ``TOKENS`` line a path and
one ``DIFF`` line a differing request; exits 1 if a request differs at a
margin above its path's bound.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BASE = ["--full", "--compress", "gqsa", "--slots", "4", "--requests", "8",
        "--max-new", "32", "--max-seq", "256", "--seed", "0"]
SERVE = {"gqsa bf16 serve": [],
         "tree bf16 serve": ["--spec-tree", "4,2,2", "--draft-profile",
                             "w4l25"],
         "adaptive bf16 serve": ["--spec-tree", "4,2,2", "--spec-adaptive",
                                 "--draft-profile", "w4s75"]}
# path: (model, config changes, engine keywords)
ENGINE = {"gqsa f32 engine": ("llama", {}, {}),
          "tree f32 engine": ("llama", {}, {"spec_fanout": (4, 2, 2)}),
          "int8 f32 engine": ("llama", {"kv_cache_dtype": "int8"}, {}),
          "w4 f32 engine": ("w4", {}, {}),
          "deepseek f32 engine": ("deepseek", {}, {}),
          "deepseek-moe f32 engine": ("moe", {}, {})}


def _import(root: str):
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as cs
    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}")
    return cs


def _f32_config(model: str, **changes):
    import dataclasses
    from repro_torch.configs.registry import get_config
    import chip_smoke as cs
    if model == "deepseek":
        return dataclasses.replace(get_config("deepseek_v2_236b"),
                                   n_layers=cs.DS_LAYERS, dtype="float32",
                                   **changes)
    if model == "moe":
        return dataclasses.replace(get_config("deepseek_moe_16b"),
                                   dtype="float32", **changes)
    return dataclasses.replace(get_config("llama2_7b"), dtype="float32",
                               **changes)


def _f32_params(model: str):
    """(params, draft) of an f32 engine model, drawn from seed 0."""
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import transformer as tf
    cfg = _f32_config(model)
    if model in ("deepseek", "moe"):
        return tf.init_params(0, cfg, "cuda", compress=GQSAConfig()), None
    if model == "w4":
        return tf.init_params(0, cfg, "cuda",
                              compress=QuantConfig(bits=4, group_size=16)), \
            None
    return tf.init_params_and_draft(0, cfg, "w4l25", "cuda",
                                    compress=GQSAConfig())


def serve_tokens(name: str, root: str, out: str, paths) -> None:
    import contextlib
    import io
    import torch
    cs = _import(root)
    from repro_torch.core.model_compress import draft_layers
    from repro_torch.launch import serve
    tokens = {}
    for path, extra in SERVE.items():
        if path not in paths:
            continue
        with contextlib.redirect_stdout(io.StringIO()):
            res = serve.main(BASE + extra)
        by = sorted(res["results"], key=lambda r: r["rid"])
        tokens[path] = [[int(x) for x in r["tokens"]] for r in by]
        print(f"TOKENS {name} {path}: {len(by)} requests", flush=True)
    for model in ("llama", "w4", "deepseek", "moe"):
        mine = [p for p, (m, _, _) in ENGINE.items()
                if m == model and p in paths]
        if not mine:
            continue
        params, draft = _f32_params(model)
        for path in mine:
            _, changes, spec = ENGINE[path]
            cfg = _f32_config(model, **changes)
            kw = dict(spec, spec_draft_layers=draft_layers(cfg, "w4l25")) \
                if spec else {}
            _, toks, _, _, _ = cs._engine_run(cfg, params,
                                              draft if spec else None, **kw)
            tokens[path] = [[int(x) for x in t] for t in toks]
            print(f"TOKENS {name} {path}: {len(toks)} requests", flush=True)
        del params, draft
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(tokens, f)


def compare(first: str, name: str, root: str, out: str) -> int:
    import argparse as ap
    import numpy as np
    cs = _import(root)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    with open(os.path.join(out, f"{first}.json")) as f:
        ref = json.load(f)
    with open(os.path.join(out, f"{name}.json")) as f:
        got = json.load(f)
    models = {}

    def model(key):
        if key not in models:
            models.clear()
            if key == "bf16":
                cfg = get_config("llama2_7b", reduced=False)
                models[key] = serve.compressed_params(
                    cfg, ap.Namespace(compress="gqsa", group_size=16,
                                      sparsity=0.5, seed=0,
                                      draft_profile="w4s75"), "cuda")[0]
            else:
                models[key] = _f32_params(key)[0]
        return models[key]

    bad = 0
    for path in [p for p in list(SERVE) + list(ENGINE) if p in got]:
        f32 = path in ENGINE
        if f32:
            key, changes, _ = ENGINE[path]
            cfg = _f32_config(key, **changes)
        else:
            key, cfg = "bf16", get_config("llama2_7b", reduced=False)
        prompts = serve.make_requests(8, cfg.vocab, np.random.default_rng(0))
        same = sum(a == b for a, b in zip(ref[path], got[path]))
        print(f"TOKENS {path}: {same} of {len(got[path])} requests equal "
              f"({first} vs {name})", flush=True)
        for i, (a, b) in enumerate(zip(ref[path], got[path])):
            if a == b:
                continue
            at = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            margin, scale = cs.greedy_margin(model(key), cfg, prompts[i],
                                             np.asarray(b), at)
            bound = (cs.SPEC_MARGIN_REL if f32 else cs.LOGITS_TOL_BF16)
            ok = margin <= bound * scale
            bad += not ok
            steps = ("" if f32 else
                     f", {margin * 32:.0f} bf16 steps of 1/32")
            print(f"DIFF {path} request {i} first differs at token {at}: "
                  f"top-2 margin {margin:.4e} (max |logit| {scale:.3f}, "
                  f"rel {margin / scale:.2e}{steps}; bound {bound:.0e} x "
                  f"max |logit|; SPEC_MARGIN_REL {cs.SPEC_MARGIN_REL:.0e}) "
                  f"{'within' if ok else 'ABOVE'}", flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("trees", nargs="+", metavar="NAME=PATH")
    p.add_argument("--out", default="build/ab_tokens")
    p.add_argument("--paths", default=",".join(list(SERVE) + list(ENGINE)),
                   help="comma list of the paths to run")
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    p.add_argument("--compare", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    out = os.path.abspath(args.out)
    if args.one is not None:
        serve_tokens(args.one, trees[args.one], out, args.paths.split(","))
        return 0
    if args.compare is not None:
        return compare(list(trees)[0], args.compare, trees[args.compare],
                       out)
    os.makedirs(out, exist_ok=True)
    me = os.path.abspath(__file__)
    for name in trees:
        subprocess.run([sys.executable, me, *args.trees, "--out", out,
                        "--paths", args.paths, "--one", name], check=True)
    return subprocess.run([sys.executable, me, *args.trees, "--out", out,
                           "--paths", args.paths,
                           "--compare", list(trees)[-1]]).returncode


if __name__ == "__main__":
    sys.exit(main())
