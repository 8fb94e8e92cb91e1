#!/usr/bin/env python3
"""Cold-push probe: the registry's cold build and the state's
materialization at 2^20 validators on one NVIDIA GPU.

    python3 probe_materialize.py [--reps N]

It builds the MAINNET Capella state of ``chip_smoke.py`` (2^20 validators,
from its seed) and times, with the device synchronised around each call:

- ``materialize_state`` on a freshly built state (the registry's raw
  columns, every packed column and every tree level go up once);
- ``DeviceRegistryMirror.materialize`` on that state's registry;
- ``registry_cold_device`` (the host-cached cold build's device half).

Each is called once to warm the kernels and the caching allocator (reported
apart as ``first_ms``), then ``--reps`` times.  Where the tree has the
chunk stager, the stager's split of each call (``LAST_COLD_TIMINGS``) is
printed beside it.  The last line is one JSON object with every sample.

The script reads only entry points that every tree of the port since the
registry mirror has, so two trees are compared by copying it into each and
running it from each in turn on one card (parent, change, change,
parent, ...).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import numpy as np

from chip_smoke import LOG2_VALIDATORS, SEED, build_state, smi


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_materialize: no CUDA device")
    from lighthouse_tpu_torch.types import ForkName, MAINNET, spec_types
    from lighthouse_tpu_torch.types import validators as tv
    from lighthouse_tpu_torch.types.device_state import materialize_state

    card = smi("name,power.limit")
    n = 1 << LOG2_VALIDATORS
    rng = np.random.default_rng(SEED)
    T = spec_types(MAINNET)
    stager = getattr(tv, "LAST_COLD_TIMINGS", None)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split = dict(stager) if stager is not None else None
        return out, (time.perf_counter() - t0) * 1e3, split

    def fresh():
        return build_state(T, ForkName, tv.ValidatorRegistry, n, rng)

    out = {"card": card, "n": n, "reps": args.reps,
           "stager": stager is not None}
    for name, call in (
            ("materialize_state", lambda s: materialize_state(s)),
            ("mirror_materialize",
             lambda s: tv.DeviceRegistryMirror.materialize(s.validators)),
            ("registry_cold_device",
             lambda s: tv.registry_cold_device(s.validators))):
        samples, splits = [], []
        for rep in range(args.reps + 1):
            state = fresh()
            res, ms, split = timed(lambda: call(state))
            del res, state
            gc.collect()
            if rep == 0:
                out[f"{name}_first_ms"] = ms
                continue
            samples.append(ms)
            splits.append(split)
        out[name] = {"ms": samples, "median_ms": statistics.median(samples),
                     "splits": splits}
        print(f"{name}: ms {[round(x, 2) for x in samples]} (median "
              f"{statistics.median(samples):.2f}, first "
              f"{out[f'{name}_first_ms']:.1f})"
              + (f"; stager {splits[-1]}" if splits[-1] else "")
              + f" [{card}]", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
