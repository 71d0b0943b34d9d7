#!/usr/bin/env python
"""Train the default CALC descriptor weights with the torch port, on the card.

The counterpart of ``scripts/train_calc_default.py`` with its flags and
defaults: a mixed-resolution corpus of real-parallax (anchor, revisit) view
pairs (240x376 at fx 320 and 120x188 at fx 160, half the places each) from
procedural city scenes, ``train_encoder_pairs`` with ``margin_pos=0.97`` and
``weight_decay=3e-4``, the best encoder by a held-out probe (seed 777, every
500 steps), and its operating point at the shipped thresholds (0.94 / 0.92)
on held-out scenes (seed 999) at both geometries and on the training band.
It also scores ``tests/test_descriptor_precision.py``'s set (seed 555,
120x188) against that test's five bars, beside the shipped weights on the
same sets.

The weights are written only to ``--out`` (the flat float16 npz both
packages load), never into a package: the shipped default stays
``stereoslam_tpu/models/calc_weights.npz``.  ``--record`` writes the JSON it
prints (history, operating points, corpus and training wall time, the card's
name and power limit).  ``--init`` starts from a pickle of Flax variables
``{"enc": ..., "dec": ...}`` (``train_calc.save_params``), e.g. the JAX
package's own init carried across.

Usage:
  python scripts/torch_train_calc_default.py [--steps 6000] [--places 2048] [--scenes 64]
      [--batch 64] [--seed 0] [--out weights.npz] [--record CALC_TRAIN_TORCH.json]
      [--device cuda] [--init init.pkl] [--commit REV]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

THRESH_HIGH, THRESH_LOW = 0.94, 0.92  # KITTI00-02.yaml:79-80
# tests/test_descriptor_precision.py's bars on its held-out set (seed 555).
BARS = {"pos_median": (">=", 0.94), "pos_ge_high": (">=", 0.6), "neg_median": ("<", 0.6),
        "neg_ge_low": ("<", 0.01), "suspects_le3": (">=", 0.95)}


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    name, limit = (f.strip() for f in out.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power.limit": limit}


def commit() -> str:
    out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True, cwd=REPO)
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def encode(model_fn, imgs, chunk: int = 64):
    """(N, 1064) descriptors of an (N, H, W) tensor, ``chunk`` images a call."""
    import torch

    with torch.no_grad():
        return torch.cat([model_fn(imgs[lo:lo + chunk]) for lo in range(0, len(imgs), chunk)])


def similarity_stats(za, zb) -> dict:
    """Revisit (diagonal) and different-place (off-diagonal) similarity
    statistics at the shipped thresholds, and the share of anchors with at
    most 3 different places above the low one (the suspect veto)."""
    S = (za @ zb.T).cpu().numpy().astype(np.float64)
    pos = np.diag(S)
    off = ~np.eye(len(S), dtype=bool)
    neg = S[off]
    suspects = ((S >= THRESH_LOW) & off).sum(axis=1)
    return {
        "pos_median": float(np.median(pos)),
        "pos_p10": float(np.percentile(pos, 10)),
        "pos_ge_high": float((pos >= THRESH_HIGH).mean()),
        "neg_median": float(np.median(neg)),
        "neg_p99": float(np.percentile(neg, 99)),
        "neg_ge_low": float((neg >= THRESH_LOW).mean()),
        "suspects_le3": float((suspects <= 3).mean()),
        "pos_mean": float(pos.mean()),
        "neg_mean": float(neg.mean()),
        "n_pairs": int(len(pos)),
    }


def evaluate_operating_point(model_fn, n_places=96, seed=999, h=240, w=376, fx=320.0,
                             n_scenes=4, device="cuda"):
    """Held-out scenes: revisit against hard-negative similarity
    distributions of ``model_fn`` ((N, H, W) images -> (N, 1064))."""
    from stereoslam_tpu_torch.models.train_calc import render_corpus_pairs

    A, B = render_corpus_pairs(n_places=n_places, n_scenes=n_scenes, seed=seed, h=h, w=w, fx=fx,
                               device=device)
    return similarity_stats(encode(model_fn, A), encode(model_fn, B))


def bars_missed(op: dict) -> list:
    """The bars of tests/test_descriptor_precision.py that ``op`` misses."""
    ok = {">=": lambda x, b: x >= b, "<": lambda x, b: x < b}
    return [f"{k} {op[k]:.4f} (needs {rel} {bar})" for k, (rel, bar) in BARS.items()
            if not ok[rel](op[k], bar)]


def make_probe(device, scores=None):
    """The held-out early-stopping probe (seed 777, 48 places at 120x188):
    median revisit similarity minus 5x the share of different places at or
    above 0.92.  ``scores`` collects every score."""
    from stereoslam_tpu_torch.models import calc
    from stereoslam_tpu_torch.models.train_calc import render_corpus_pairs

    A, B = render_corpus_pairs(n_places=48, n_scenes=4, h=120, w=188, fx=160.0, seed=777,
                               device=device)
    pa, pb = calc.preprocess(A), calc.preprocess(B)

    def probe_fn(enc):
        st = similarity_stats(enc(pa), enc(pb))
        score = st["pos_median"] - 5.0 * st["neg_ge_low"]
        if scores is not None:
            scores.append(score)
        return score

    return probe_fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--places", type=int, default=2048)
    ap.add_argument("--scenes", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", default="")
    ap.add_argument("--init", default="")
    ap.add_argument("--commit", default=None)
    args = ap.parse_args()

    out = os.path.abspath(args.out) if args.out else ""
    for pkg in ("stereoslam_tpu", "stereoslam_tpu_torch"):
        if out and os.path.commonpath([out, os.path.join(REPO, pkg)]) == os.path.join(REPO, pkg):
            sys.exit(f"--out {args.out} lies inside {pkg}/: the shipped weights are not replaced")

    import torch

    import stereoslam_tpu_torch  # noqa: F401  (pins float32 matmuls)
    from stereoslam_tpu_torch.models import calc
    from stereoslam_tpu_torch.models.train_calc import (
        load_params,
        render_corpus_pairs,
        train_encoder_pairs,
    )

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    A_hi, B_hi = render_corpus_pairs(n_places=args.places // 2, n_scenes=args.scenes // 2,
                                     seed=args.seed, h=240, w=376, fx=320.0, device=dev)
    A_lo, B_lo = render_corpus_pairs(n_places=args.places // 2, n_scenes=args.scenes // 2,
                                     seed=args.seed + 1, h=120, w=188, fx=160.0, device=dev)
    sync()
    corpus_s = time.perf_counter() - t0
    print(f"# corpus: {len(A_hi)}+{len(A_lo)} pairs in {corpus_s:.1f}s", file=sys.stderr)

    scores = []
    probe_fn = make_probe(dev, scores)
    t0 = time.perf_counter()
    params, history = train_encoder_pairs(
        [A_hi, A_lo], [B_hi, B_lo], steps=args.steps, batch=args.batch, seed=args.seed,
        verbose=True, margin_pos=0.97, weight_decay=3e-4, probe_fn=probe_fn, probe_every=500,
        device=dev, init=load_params(args.init) if args.init else None)
    sync()
    train_s = time.perf_counter() - t0
    print(f"# trained {args.steps} steps in {train_s:.1f}s", file=sys.stderr)
    del A_hi, B_hi, A_lo, B_lo

    t0 = time.perf_counter()
    rec = {"history_tail": history[-3:]}
    for name, model in (("", calc.DescriptorModel(params)),
                        ("shipped_", calc.DescriptorModel.default())):
        fn = model.__call__
        rec[f"{name}operating_point_heldout_240x376"] = evaluate_operating_point(
            fn, seed=999, h=240, w=376, fx=320.0, device=dev)
        rec[f"{name}operating_point_heldout_120x188"] = evaluate_operating_point(
            fn, seed=999, h=120, w=188, fx=160.0, device=dev)
        ci = evaluate_operating_point(fn, n_places=48, seed=555, h=120, w=188, fx=160.0,
                                      device=dev)
        ci["bars_missed"] = bars_missed(ci)
        rec[f"{name}operating_point_ci_555_120x188"] = ci
        if not name:
            rec["operating_point_trainband"] = evaluate_operating_point(fn, seed=args.seed,
                                                                        device=dev)
    sync()
    rec.update({
        "probe_scores": scores,
        "best_probe": max(scores) if scores else None,
        "history": history,
        "corpus_s": corpus_s,
        "train_s": train_s,
        "ms_per_step": train_s / max(args.steps, 1) * 1e3,
        "eval_s": time.perf_counter() - t0,
        "config": {k: getattr(args, k) for k in ("steps", "places", "scenes", "batch", "seed")},
        "init": "jax (" + os.path.basename(args.init) + ")" if args.init else "flax lecun_normal, seed",
        "device": str(dev),
        "card": card() if dev.type == "cuda" else None,
        "device_name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "commit": args.commit or commit(),
        "weights": out or None,
    })
    print(json.dumps(rec))
    if args.record:
        with open(args.record, "w") as f:
            json.dump(rec, f, indent=1)
    if out:
        calc.save_params_npz(out, params)
        print(f"# wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)", file=sys.stderr)


if __name__ == "__main__":
    main()
