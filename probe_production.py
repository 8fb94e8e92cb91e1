#!/usr/bin/env python3
"""Production probe: block production at 2^20 validators on one NVIDIA GPU.

    python3 probe_production.py [--tree DIR] [--label NAME] [--reps N]

It builds the kernels and phase 13(b)'s context of ``chip_smoke.py`` (the
2^20-validator MAINNET Capella anchor, its block's 128 real aggregates and
the derived keys, from its seed), then runs ``chip_smoke``'s phase 15(b),
``phase_produce_mainnet``, ``--reps`` times: each run produces the block
on the adopted and the serial route through
``InProcessBeaconNode.produce_block``, checks them byte-equal, against
CELF and against the host oracle's root, and imports the signed block.
Each run prints one line ``PROBE {...}`` with both routes' walls, state
split and spans, the pack's rounds, the warm rounds and CELF on the
production CSR (where the tree's phase times them) and the import.

``--tree`` runs the ``chip_smoke.py`` and package of another checkout
(for example the parent unpacked with ``git archive`` into a directory
that ``.gitignore`` lists), so two trees are compared from one copy of
this script, in turns on one card: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_production.py needs an NVIDIA GPU")

    import chip_smoke as cs
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.crypto import curve as C
    from lighthouse_tpu_torch.crypto import fields as F
    from lighthouse_tpu_torch.crypto import pairing_kernel as pk
    from lighthouse_tpu_torch.ops import cuda_build
    from lighthouse_tpu_torch.ops import merkle_kernel as mk

    device.set_default_device("cuda")
    hw = cs.phase_build(torch, mk, pk, cuda_build)
    keys = cs.derive_g1_keys(F, C, cs.GEN_SK0, cs.GEN_SK_STEP,
                             1 << cs.IMPORT_LOG2_VALIDATORS)
    _, ctx = cs.phase_import_mainnet(torch, hw, keys, {})
    del keys
    for i in range(args.reps):
        p = cs.phase_produce_mainnet(torch, hw, ctx)
        row = {"label": args.label, "rep": i, "card": hw["card"]}
        for route in ("adopted", "serial"):
            r = p[route]
            row[route] = {"wall_ms": r["wall_ms"],
                          # the state's copy and advance (older trees:
                          # the adopt step's time)
                          "state": r.get("state_ms", r.get("adopt_ms")),
                          "spans_ms": r["spans_ms"],
                          "select_rounds_ms": r["pack"]["select_rounds_ms"]}
        for k in ("rounds_warm_ms", "rounds_warm_ms_runs", "celf_ms",
                  "celf_ms_runs", "pack_bound_ms", "import_ms"):
            row[k] = p.get(k)
        print("PROBE " + json.dumps(row), flush=True)
    print(f"PROBE {args.label} done in {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
