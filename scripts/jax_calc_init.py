#!/usr/bin/env python
"""Write the JAX package's own initial CALC training parameters as a pickle.

``train_encoder`` and ``train_encoder_pairs`` start from ``CalcEncoder().init``
and ``_Decoder(hog_dim).init`` with ``jax.random.PRNGKey(seed)``.  This script
writes those two Flax variables dicts as ``{"enc": ..., "dec": ...}`` through
the JAX package's ``train_calc.save_params`` (nested numpy), which the port's
``scripts/torch_train_calc_default.py --init PATH`` loads, so that a run on
the card can start from JAX's init rather than the port's draw of it.

Usage:  python scripts/jax_calc_init.py --out init.pkl [--seed 0]
(runs on a CPU; about 10 s)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import stereoslam_tpu  # noqa: F401  (pins float32 matmul precision)
    from stereoslam_tpu.models import calc, train_calc

    key = jax.random.PRNGKey(args.seed)
    dummy = jnp.zeros(calc.INPUT_HW, jnp.float32)
    enc = calc.CalcEncoder()
    hog_dim = calc.hog_features(dummy).shape[0]
    enc_params = enc.init(key, dummy)
    dec_params = train_calc._Decoder(hog_dim=hog_dim).init(key, enc.apply(enc_params, dummy))
    train_calc.save_params(args.out, {"enc": enc_params, "dec": dec_params})
    print(f"wrote {args.out}: JAX init at seed {args.seed}")


if __name__ == "__main__":
    main()
