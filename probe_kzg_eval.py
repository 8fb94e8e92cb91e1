#!/usr/bin/env python3
"""KZG evaluation probe: ``lh_kzg_eval`` at six blobs of 4096 on one
NVIDIA GPU, for one or more trees in turns.

    python3 probe_kzg_eval.py [--rounds N] [TREE ...]

Each TREE (default: this checkout) holds a ``lighthouse_tpu_torch``
package, for example the parent unpacked with ``git archive`` into a
directory that ``.gitignore`` lists. Each tree runs in a process of its
own, in the order given (list parent, change, change, parent to compare
two), and builds its own ``csrc/kzg_fr.cu``. A run checks blob 0's value
against the host oracle, then times ``eval_kernel_call`` on phase 16(a)'s
shape with CUDA events, ``--rounds`` rounds of the median of 20 warm
calls, and prints one line ``PROBE {...}``. A package without
``kzg.device.mont_words`` takes z and the roots as canonical words.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

BLOBS, WIDTH, CALLS = 6, 4096, 20


def one(tree: str, rounds: int) -> None:
    sys.path.insert(0, tree)
    import random

    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_kzg_eval.py needs an NVIDIA GPU")
    from lighthouse_tpu_torch import device as DEV
    from lighthouse_tpu_torch.kzg import device as D
    from lighthouse_tpu_torch.kzg import fr
    from lighthouse_tpu_torch.kzg import kzg as K
    from lighthouse_tpu_torch.kzg.trusted_setup import verification_setup

    n = fr.BLS_MODULUS
    setup = verification_setup(WIDTH)
    rng = random.Random(0)
    polys = [[rng.randrange(n) for _ in range(WIDTH)] for _ in range(BLOBS)]
    zs = [rng.randrange(n) for _ in range(BLOBS)]
    words = getattr(D, "mont_words", D.ints_words)
    DEV.set_default_device("cuda")
    f = DEV.to_device(D.blob_words([K.polynomial_to_blob(p) for p in polys],
                                   WIDTH))
    z = DEV.to_device(words(zs))
    roots = DEV.to_device(words(setup.roots))
    got = D.words_ints(DEV.to_host(D.eval_kernel_call(f, z, roots)))
    if got[0] != fr.evaluate_polynomial_in_evaluation_form(polys[0], zs[0],
                                                           setup.roots):
        sys.exit(f"{tree}: lh_kzg_eval != the host oracle on blob 0")
    medians = []
    for _ in range(rounds):
        times = []
        for _ in range(CALLS + 2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            D.eval_kernel_call(f, z, roots)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        medians.append(statistics.median(times[2:]))
    print("PROBE " + json.dumps({"tree": tree, "shape": [BLOBS, WIDTH],
                                 "median_ms": medians}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees] or [
        os.path.dirname(os.path.abspath(__file__))]
    if args.one:
        one(trees[0], args.rounds)
        return
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        sys.exit("probe_kzg_eval.py needs an NVIDIA GPU (no nvidia-smi)")
    print(card, flush=True)
    for tree in trees:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", "--rounds", str(args.rounds),
                             tree]).returncode
        if rc != 0:
            sys.exit(rc)


if __name__ == "__main__":
    main()
