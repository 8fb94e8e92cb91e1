"""Per-stage device profile of the BLS verify pipeline's kernels.

Port of ``lighthouse_tpu/crypto/profiling.py``.  Each stage is one kernel
call at the C-chunk (C·128-lane) shape, queued ``n`` times between two
CUDA events: the device time per call, with no host sync inside the
window.  The inputs are synthetic limb planes from a numpy seed (the
kernels' correctness is held elsewhere); the stages are the unfused
``miller`` and ``product_fold`` (``product_chunks``) beside the fused
``miller_fold_fused`` the verify path runs, and hash-to-curve, prepare
and the final exponentiation.  GPU only: a profile of the plain versions
on the CPU would not be a device time.
"""

from __future__ import annotations

from typing import Dict

# The most recent :func:`profile_stages` output.
LAST_STAGE_PROFILE: Dict[str, float] = {}


def profile_stages(n: int = 10, C: int = 2) -> Dict[str, float]:
    """ms per call of each pipeline stage at the C-chunk shape (C even:
    the product fold takes 256-lane chunks, the finalize a power of two
    ≥ 128 lanes)."""
    import numpy as np
    import torch

    from . import htc_kernel as HK
    from . import pairing_kernel as PK
    from .. import device as D

    dev = D.get_device()
    if dev.type != "cuda":
        raise RuntimeError(f"profile_stages times the GPU; device is {dev}")
    S = PK.PREP_S
    rng = np.random.default_rng(0)

    def planes(rows, cols):
        return torch.from_numpy(rng.integers(0, 2 ** 16, (rows, cols))
                                .astype(np.int32)).to(dev)

    pk = planes(64, C * S)
    kmask = torch.ones((1, C * S), dtype=torch.int32, device=dev)
    lo = torch.ones((1, C * S), dtype=torch.int32, device=dev)
    hi = torch.zeros((1, C * S), dtype=torch.int32, device=dev)
    g2 = planes(128, C * S)
    lm = torch.ones((1, C * S), dtype=torch.int32, device=dev)
    msgs = [(i // S, i % S, b"stage-msg-%03d" % (i % 64))
            for i in range(C * S)]
    ud = torch.from_numpy(HK.u_planes_for_messages(msgs, C).view(np.int32)
                          ).to(dev)

    g1_aff, _flags = PK.prepare_kernel_call(pk, kmask, lo, hi, 1)
    f = PK.miller_kernel_call(g1_aff, g2)
    prod = PK.product_chunks_kernel_call(f, lm)
    stages = {
        "hash_to_curve": lambda: HK.hash_g2_kernel_call(ud),
        "prepare_gather_rlc": lambda: PK.prepare_kernel_call(
            pk, kmask, lo, hi, 1),
        "miller": lambda: PK.miller_kernel_call(g1_aff, g2),
        "product_fold": lambda: PK.product_chunks_kernel_call(f, lm),
        "miller_fold_fused": lambda: PK.miller_fold_kernel_call(
            g1_aff, g2, lm),
        "final_exp": lambda: PK.finalize_kernel_call(prod),
    }
    out: Dict[str, float] = {}
    for name, fn in stages.items():
        fn()                                          # first-use set-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out[f"stage_{name}_ms"] = start.elapsed_time(end) / n
    out["stage_shape"] = f"C={C} ({C * S} lanes), K=1"
    out["device"] = torch.cuda.get_device_name(dev)
    LAST_STAGE_PROFILE.clear()
    LAST_STAGE_PROFILE.update(out)
    return out
